"""Device mesh for multi-device proving: the port's counterpart of
zktls_tpu.parallel.mesh.

The reference's parallelism axes (SURVEY.md §2.4) map onto a 2-D mesh:
  * 'seg'  — segment/shard data-parallelism (independent proof units, the
             analogue of SP1 shards / RISC0 segments);
  * 'ntt'  — intra-proof model-parallelism: NTT rows sharded across
             devices, the four-step's transpose exchanged between them.

One process holds the whole mesh, as one JAX controller does: a mesh is a
grid of `torch.device`s and the exchange is peer copies
(`tensor.to(device)`), not `torch.distributed`.  An entry may repeat
(`["cpu"] * 8`, or `["cuda:0"] * 2` on a host with one card): each entry
is one logical shard, so the sharded code runs the same whatever the
number of physical devices.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["Mesh", "make_mesh"]


@dataclass(eq=False)
class Mesh:
    """A ('seg', 'ntt') grid of devices, named after jax.sharding.Mesh."""

    #: (n_seg, n_ntt) object array of torch.device
    devices: np.ndarray
    axis_names: tuple = ("seg", "ntt")

    @property
    def shape(self) -> dict:
        """{axis name: size}, as jax.sharding.Mesh.shape."""
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str) -> list[torch.device]:
        """The devices along `axis` at index 0 of the other axis: where a
        computation sharded over `axis` (and replicated over the other)
        runs."""
        i = self.axis_names.index(axis)
        return list(self.devices[(0, slice(None)) if i else
                                 (slice(None), 0)])


def make_mesh(n_seg: int | None = None, n_ntt: int | None = None,
              devices=None) -> Mesh:
    """Build a ('seg', 'ntt') mesh over `devices` (default: every CUDA
    card; raises without one).  With no sizes the split is the
    reference's: the ntt axis takes the largest power of two up to 4 that
    divides the count.  With one device both axes are 1."""
    from ..stark.machine import _resolve_device

    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass devices=['cpu'] * k for a "
                "mesh of CPU shards")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [_resolve_device(d) for d in devices]
    n = len(devices)
    if n_seg is None and n_ntt is None:
        n_ntt = 1
        while n % 2 == 0 and n_ntt < 4:
            n //= 2
            n_ntt *= 2
        n_seg = len(devices) // n_ntt
    elif n_seg is None:
        n_seg = n // n_ntt
    elif n_ntt is None:
        n_ntt = n // n_seg
    if n_seg * n_ntt != len(devices):
        raise ValueError(
            f"mesh {n_seg}x{n_ntt} does not cover {len(devices)} devices")
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(n_seg, n_ntt))
