"""Wrappers of the hand-written Hopper Poseidon2 kernels
(csrc/poseidon2.cu): three entry points over one device-side permutation.

  * `permute_batch`  (N, 16|24) states -> permuted states; replaces the
    Pallas TPU kernel zktls_tpu/ops/pallas_poseidon2.py:107;
  * `hash_rows`      (N, W) matrix -> (N, 8) leaf digests, one launch;
  * `merkle_levels`  leaf digests -> every tree level in one buffer, one
    launch per nine levels; with `hash_rows` it replaces the jitted
    zktls_tpu/ops/merkle.py:134 `_tree_fn`.

The library is built at first use with nvcc for sm_90a into build/kernels/
(keyed by the source's hash), loaded with ctypes and launched on torch's
current stream of the tensor's card; each C entry point selects that card
and gives the caller's current device back, so a launch on a second card
leaves torch's current device as it was.  What bounds the kernels and how
their design answers that is noted at the top of the source.

Nothing here falls back: a tensor a kernel does not take raises.  The
plain torch versions of the same functions are
zktls_tpu_torch.ops.poseidon2.permute_batch_plain and
zktls_tpu_torch.ops.merkle.hash_rows_plain / tree_levels_plain.
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

__all__ = ["permute_batch", "hash_rows", "merkle_levels", "build", "bound",
           "hash_rows_bound", "merkle_levels_bound", "launches",
           "reset_launches", "SOURCE"]

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "poseidon2.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

DIGEST_WIDTH = 8

#: kernel launches made in this process, per entry point
launches = {"permute": 0, "hash_rows": 0, "merkle_levels": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


#: H100 SXM: HBM3 rate (NVIDIA data sheet) and 32-bit integer multiplies
#: per clock per SM (CUDA C++ Programming Guide, compute capability 9.0)
HBM_BYTES_PER_S = 3.35e12
INT_MULS_PER_CLOCK_PER_SM = 64
#: 32-bit multiplies a Montgomery product needs
MULS_PER_PRODUCT = 3

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


_PTR, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: the library's C interface: argument types by function (all return int)
_INTERFACE = {
    "zk_poseidon2_set_constants": [_I32, _I32, _PTR, _PTR, _PTR],
    "zk_poseidon2_permute": [_I32, _I32, _PTR, _PTR, _I64, _PTR],
    "zk_poseidon2_hash_rows": [_I32, _PTR, _I64, _I32, _PTR, _PTR],
    "zk_poseidon2_merkle_levels": [_I32, _PTR, _I64, _PTR,
                                   ctypes.POINTER(_I32)],
}


def _bind(path: Path):
    """Load the built library and declare its C interface."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _INTERFACE.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _I32
    return lib


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


def _ready(t: torch.Tensor):
    """The loaded library with its constants on `t`'s card, the card's
    index and torch's current stream there; raises for a tensor that is
    not on a card."""
    global _lib
    if not t.is_cuda:
        raise ValueError(f"the Poseidon2 kernels take CUDA tensors only, got "
                         f"one on {t.device}")
    if _lib is None:
        _lib = _bind(build()[0])
    device = t.device.index
    _ensure_constants(_lib, device)
    return _lib, device, torch.cuda.current_stream(t.device).cuda_stream


def _check(t: torch.Tensor, what: str, dtype: torch.dtype) -> None:
    """Raise unless `t` is a 2-D contiguous 16-byte-aligned tensor of
    `dtype` (`_ready` then refuses one that is not on a card)."""
    if t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {t.dtype}")
    if t.ndim != 2:
        raise ValueError(f"{what} must be 2-D, got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{what} must be contiguous and 16-byte aligned")


def _raise_on(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"Poseidon2 {what} launch failed: CUDA error "
                           f"{err}")


def permute_batch(states: torch.Tensor) -> torch.Tensor:
    """Poseidon2 over (N, width) Montgomery states held as int32 (the
    uint32 bit patterns; every field value is < p < 2^31), width 16 or 24,
    on a CUDA device.  Returns a new (N, width) int32 tensor."""
    _check(states, "states", torch.int32)
    if states.shape[1] not in (16, 24):
        raise ValueError(f"states must be (N, 16|24), got "
                         f"{tuple(states.shape)}")
    lib, device, stream = _ready(states)
    out = torch.empty_like(states)
    n, width = states.shape
    _raise_on(lib.zk_poseidon2_permute(device, width, states.data_ptr(),
                                       out.data_ptr(), n, stream), "permute")
    if n:
        launches["permute"] += 1
    return out


def hash_rows(rows: torch.Tensor) -> torch.Tensor:
    """Sponge-hash each row of a row-major (N, W) int64 matrix of
    Montgomery values on a CUDA device to an (N, 8) int64 digest, in one
    launch."""
    _check(rows, "rows", torch.int64)
    n, w = rows.shape
    if w < 1:
        raise ValueError("rows must have at least one column")
    lib, device, stream = _ready(rows)
    out = torch.empty((n, DIGEST_WIDTH), dtype=torch.int64,
                      device=rows.device)
    _raise_on(lib.zk_poseidon2_hash_rows(device, rows.data_ptr(), n, w,
                                         out.data_ptr(), stream),
              "hash_rows")
    if n:
        launches["hash_rows"] += 1
    return out


def merkle_levels(buf: torch.Tensor) -> torch.Tensor:
    """Fill a Merkle tree in place: `buf` is a (2N − 1, 8) int64 matrix on a
    CUDA device whose first N rows (N a power of two) hold the leaf
    digests; every level above them is written behind them, N/2 parents,
    N/4 grandparents, …, the root last.  One launch per nine levels.
    Returns `buf`."""
    _check(buf, "buf", torch.int64)
    n = (buf.shape[0] + 1) // 2
    if buf.shape != (2 * n - 1, DIGEST_WIDTH) or n & (n - 1):
        raise ValueError(f"buf must be (2N − 1, {DIGEST_WIDTH}) for a power "
                         f"of two N, got {tuple(buf.shape)}")
    lib, device, stream = _ready(buf)
    made = ctypes.c_int(0)
    err = lib.zk_poseidon2_merkle_levels(device, buf.data_ptr(), n, stream,
                                         ctypes.byref(made))
    launches["merkle_levels"] += made.value
    _raise_on(err, "merkle_levels")
    return buf


def _products(width: int) -> int:
    """Montgomery products of one permutation: 8·w·4 S-box products in the
    external rounds, RP·(4 + w) in the internal ones."""
    return 8 * width * 4 + get_params(width).rp * (4 + width)


def bound(states: dict[int, int], sms: int, clock_mhz: float,
          nbytes: int | None = None) -> dict:
    """The least time the card could take to permute `states` ({width:
    count}): the larger of integer-multiply issue (each Montgomery product
    counted as the 3 multiplies it needs: a·b, the low word times p⁻¹, the
    high word of m·p) and HBM traffic: `nbytes`, or each state read
    and written once as uint32 when that is not given (the fused entry
    points move other bytes: a matrix in, digests out).  Seconds, with the
    counts they come from."""
    muls = sum(n * _products(w) * MULS_PER_PRODUCT for w, n in states.items())
    if nbytes is None:
        nbytes = sum(n * w * 4 * 2 for w, n in states.items())
    ops_s = muls / (INT_MULS_PER_CLOCK_PER_SM * sms * clock_mhz * 1e6)
    bytes_s = nbytes / HBM_BYTES_PER_S
    return {"multiplies": muls, "bytes": nbytes, "ops_s": ops_s,
            "bytes_s": bytes_s, "bound_s": max(ops_s, bytes_s),
            "bound_by": "operations" if ops_s >= bytes_s else "bytes"}


def hash_rows_bound(n: int, w: int, sms: int, clock_mhz: float) -> dict:
    """`bound` for hashing an (n, w) int64 matrix to (n, 8) int64."""
    return bound({24: n * -(-w // 16)}, sms, clock_mhz,
                 nbytes=8 * n * (w + DIGEST_WIDTH))


def merkle_levels_bound(n: int, sms: int, clock_mhz: float) -> dict:
    """`bound` for the n − 1 compressions above n leaf digests (int64: the
    leaves read once, every node above them written once)."""
    return bound({16: n - 1}, sms, clock_mhz,
                 nbytes=8 * DIGEST_WIDTH * (n + n - 1))
