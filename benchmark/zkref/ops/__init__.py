"""Part of the zktls_tpu_torch port (see the package docstring)."""
