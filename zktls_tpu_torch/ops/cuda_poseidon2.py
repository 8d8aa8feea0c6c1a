"""Wrapper of the hand-written Hopper Poseidon2 kernel (csrc/poseidon2.cu).

Replaces zktls_tpu/ops/pallas_poseidon2.py::_kernel_factory (the Pallas
TPU kernel).  The kernel is built at first use with nvcc for sm_90a into
build/kernels/ (keyed by the source's hash), loaded with ctypes and
launched on torch's current stream.  What bounds it and how its design
answers that is noted at the top of the source.

Nothing here falls back: a tensor the kernel does not take raises.  The
plain torch version of the same function is
zktls_tpu_torch.ops.poseidon2.permute_batch_plain.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from . import babybear as bb
from .poseidon2 import get_params

__all__ = ["permute_batch", "build", "bound", "launches", "SOURCE"]

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "poseidon2.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: kernel launches made through `permute_batch` in this process
launches = 0

#: H100 SXM: HBM3 rate (NVIDIA data sheet) and 32-bit integer multiplies
#: per clock per SM (CUDA C++ Programming Guide, compute capability 9.0)
HBM_BYTES_PER_S = 3.35e12
INT_MULS_PER_CLOCK_PER_SM = 64

_lib = None
_constants_on: set[int] = set()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the Poseidon2 kernel cannot be built")


def build() -> tuple[Path, str]:
    """Compile the kernel library unless a build of this exact source and
    flag set exists.  Returns (library path, the compiler's report — empty
    when the cached build was used)."""
    src = SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"poseidon2_{key}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr


def _load():
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        lib.zk_poseidon2_set_constants.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p]
        lib.zk_poseidon2_set_constants.restype = ctypes.c_int
        lib.zk_poseidon2_permute.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_void_p]
        lib.zk_poseidon2_permute.restype = ctypes.c_int
        _lib = lib
    return _lib


def _ensure_constants(lib, device: int) -> None:
    """Round constants in Montgomery form, converted exactly as the
    reference's _kernel_factory does, copied to the card once per
    device."""
    if device in _constants_on:
        return
    for width in (16, 24):
        p = get_params(width)
        erc = np.ascontiguousarray(
            bb.np_to_mont(np.array(p.external_rc, dtype=np.uint32)))
        irc = np.ascontiguousarray(
            bb.np_to_mont(np.array(p.internal_rc, dtype=np.uint32)))
        diag = np.ascontiguousarray(
            bb.np_to_mont(np.array(p.diag, dtype=np.uint32)))
        err = lib.zk_poseidon2_set_constants(
            device, width, erc.ctypes.data, irc.ctypes.data,
            diag.ctypes.data)
        if err:
            raise RuntimeError(f"Poseidon2 constant upload failed: CUDA "
                               f"error {err}")
    _constants_on.add(device)


def permute_batch(states: torch.Tensor) -> torch.Tensor:
    """Poseidon2 over (N, width) Montgomery states held as int32 (the
    uint32 bit patterns; every field value is < p < 2^31), width 16 or 24,
    on a CUDA device.  Returns a new (N, width) int32 tensor."""
    global launches
    if not states.is_cuda:
        raise ValueError("the Poseidon2 kernel takes CUDA tensors only")
    if states.dtype != torch.int32:
        raise TypeError(f"states must be int32, got {states.dtype}")
    if states.ndim != 2 or states.shape[1] not in (16, 24):
        raise ValueError(f"states must be (N, 16|24), got "
                         f"{tuple(states.shape)}")
    if not states.is_contiguous() or states.data_ptr() % 16:
        raise ValueError("states must be contiguous and 16-byte aligned")
    lib = _load()
    device = states.device.index
    _ensure_constants(lib, device)
    out = torch.empty_like(states)
    n, width = states.shape
    stream = torch.cuda.current_stream(states.device).cuda_stream
    err = lib.zk_poseidon2_permute(device, width, states.data_ptr(),
                                   out.data_ptr(), n, stream)
    if err:
        raise RuntimeError(f"Poseidon2 kernel launch failed: CUDA error "
                           f"{err}")
    if n:
        launches += 1
    return out


def bound(states: dict[int, int], sms: int, clock_mhz: float) -> dict:
    """The least time the card could take to permute `states` ({width:
    count}): the larger of integer-multiply issue (each Montgomery product
    is 4 multiplies; 8·w·4 S-box products in the external rounds, RP·(4+w)
    in the internal ones) and HBM traffic (each state read and written
    once).  Seconds, with the counts they come from."""
    muls = sum(n * (8 * w * 4 + get_params(w).rp * (4 + w)) * 4
               for w, n in states.items())
    nbytes = sum(n * w * 4 * 2 for w, n in states.items())
    ops_s = muls / (INT_MULS_PER_CLOCK_PER_SM * sms * clock_mhz * 1e6)
    bytes_s = nbytes / HBM_BYTES_PER_S
    return {"multiplies": muls, "bytes": nbytes, "ops_s": ops_s,
            "bytes_s": bytes_s, "bound_s": max(ops_s, bytes_s),
            "bound_by": "operations" if ops_s >= bytes_s else "bytes"}
