"""Host Poseidon2 in C (csrc/poseidon2_host.c), bound with ctypes.

Port of the Poseidon2 part of zktls_tpu.utils.native (`permute_batch`,
`hash_rows`, `compress_pairs`); its MiMC and BN254 parts are not ported.
Instances: 0 = width 16 (node compression, challenger), 1 = width 24
(rate-16 Merkle leaf sponge).  Values are plain-form field elements (< P).

The library is built at first use with the system C compiler (`cc`, else
`gcc`; `-O3 -shared -fPIC`) into build/native/, keyed by the hash of the
source and flags, and its parameters are injected from
`ops.poseidon2.get_params`.  Unlike the reference, a missing compiler or a
failed build or load raises with the compiler's message: nothing falls back
to the pure-Python permutation quietly.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from ..ops.field_ref import P

__all__ = ["SOURCE", "build", "library", "permute_batch", "permute_ints",
           "hash_rows", "compress_pairs"]

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "poseidon2_host.c"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CFLAGS = ["-O3", "-shared", "-fPIC"]

_WIDTH_TO_INST = {16: 0, 24: 1}
_U32P = ctypes.POINTER(ctypes.c_uint32)
_lib = None


def _compiler() -> str:
    for cc in ("cc", "gcc"):
        found = shutil.which(cc)
        if found:
            return found
    raise RuntimeError("no C compiler (cc or gcc) found: the host Poseidon2 "
                       "library cannot be built")


def build(source: Path = SOURCE, build_dir: Path = BUILD_DIR
          ) -> tuple[Path, str]:
    """Compile the library unless a build of this exact source and flag set
    exists.  Returns (library path, the compiler's report — empty when the
    cached build was used).  Raises RuntimeError with the compiler's output
    when the build fails."""
    src = Path(source).read_bytes()
    key = hashlib.sha256(src + " ".join(CFLAGS).encode()).hexdigest()[:16]
    lib = Path(build_dir) / f"poseidon2_host_{key}.so"
    if lib.exists():
        return lib, ""
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_compiler(), *CFLAGS, str(source), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {source} failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr


def _bind(path: Path):
    """Load the built library, declare its C interface and inject the
    parameters of both instances."""
    from ..ops.poseidon2 import get_params

    lib = ctypes.CDLL(str(path))
    u32, sz = ctypes.c_uint32, ctypes.c_size_t
    lib.p2_set_params.argtypes = [u32] * 4 + [_U32P] * 3
    lib.p2_set_params.restype = ctypes.c_int
    lib.p2_permute_batch.argtypes = [u32, _U32P, sz]
    lib.p2_permute_batch.restype = None
    lib.p2_hash_rows.argtypes = [u32, _U32P, sz, sz, _U32P]
    lib.p2_hash_rows.restype = None
    lib.p2_compress_pairs.argtypes = [u32, _U32P, sz, _U32P]
    lib.p2_compress_pairs.restype = None
    for width, inst in _WIDTH_TO_INST.items():
        p = get_params(width)
        ext = np.ascontiguousarray(p.external_rc, dtype=np.uint32)
        irc = np.ascontiguousarray(p.internal_rc, dtype=np.uint32)
        diag = np.ascontiguousarray(p.diag, dtype=np.uint32)
        if lib.p2_set_params(inst, width, p.rf, p.rp,
                             ext.ctypes.data_as(_U32P),
                             irc.ctypes.data_as(_U32P),
                             diag.ctypes.data_as(_U32P)) != 0:
            raise RuntimeError(f"p2_set_params refused width {width}")
    return lib


def library():
    """The loaded library, built on first use (raises on any failure)."""
    global _lib
    if _lib is None:
        _lib = _bind(build()[0])
    return _lib


def _u32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.uint32)


def permute_batch(states: np.ndarray, width: int = 16) -> np.ndarray:
    """(N, width) plain states -> the permuted states (a new array)."""
    out = _u32(states).copy()
    if out.ndim != 2 or out.shape[1] != width:
        raise ValueError(f"states must be (N, {width})")
    library().p2_permute_batch(_WIDTH_TO_INST[width],
                               out.ctypes.data_as(_U32P), out.shape[0])
    return out


def permute_ints(state: list[int]) -> list[int]:
    """One state of 16 or 24 ints (any non-negative values; reduced mod P
    first) -> the permuted state, as plain ints."""
    width = len(state)
    buf = (ctypes.c_uint32 * width)(*[x % P for x in state])
    library().p2_permute_batch(_WIDTH_TO_INST[width], buf, 1)
    return list(buf)


def hash_rows(rows: np.ndarray, width: int = 24) -> np.ndarray:
    """Sponge-hash each row (rate width − 8, zero-padded last block) into an
    (N, 8) digest."""
    rows = _u32(rows)
    n, w = rows.shape
    out = np.zeros((n, 8), dtype=np.uint32)
    library().p2_hash_rows(_WIDTH_TO_INST[width], rows.ctypes.data_as(_U32P),
                           n, w, out.ctypes.data_as(_U32P))
    return out


def compress_pairs(pairs: np.ndarray) -> np.ndarray:
    """(N, 16) sibling pairs -> (N, 8) parents with the width-16 instance."""
    pairs = _u32(pairs)
    n = pairs.shape[0]
    out = np.zeros((n, 8), dtype=np.uint32)
    library().p2_compress_pairs(0, pairs.ctypes.data_as(_U32P), n,
                                out.ctypes.data_as(_U32P))
    return out
