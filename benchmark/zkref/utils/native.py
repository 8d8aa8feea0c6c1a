"""Host code in C, bound with ctypes: Poseidon2 over Baby-Bear
(csrc/poseidon2_host.c), MP-MiMC over the BN254 scalar field
(csrc/mimc_bn254_host.c) and the BN254 multi-scalar multiplication of
Groth16 (csrc/bn254_msm_host.c).

Port of zktls_tpu.utils.native: its Poseidon2 part (`permute_batch`,
`hash_rows`, `compress_pairs`), its MiMC part (`mimc_hash_rows`,
`mimc_compress_pairs`, the round constants injected from
`snark.wrap.MIMC_ROUND_CONSTANTS`) and its MSM part (`bn254_msm_g1`,
`bn254_g1_mul_batch`, `bn254_msm_g2`, `bn254_g2_mul_batch`, the same
array layouts).  Poseidon2 instances: 0 = width 16 (node compression,
challenger), 1 = width 24 (rate-16 Merkle leaf sponge); values are
plain-form field elements (< P).  MiMC values are plain BN254 scalars as
little-endian u64 limbs (4 per element); so are the MSM's coordinates
(base field) and scalars.

Each library is built at first use with the system C compiler (`cc`, else
`gcc`) into build/native/, keyed by the hash of its source and flags:
Poseidon2 with `-O3 -shared -fPIC`, MiMC and the MSM with `-fopenmp` as
well, since a full-width shrink hashes ~3e8 MiMC permutations and a
Groth16 setup multiplies ~10^5 fixed-base points.  Unlike the reference,
a missing compiler, a compiler without OpenMP, or a failed build or load
raises with the compiler's message: nothing falls back to the pure-Python
hashes or MSM, or to a single-threaded MiMC, quietly.
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
           "hash_rows", "compress_pairs", "MIMC_SOURCE", "build_mimc",
           "mimc_library", "mimc_hash_rows", "mimc_compress_pairs",
           "set_mimc_threads", "mimc_threads", "MSM_SOURCE", "build_msm",
           "msm_library", "bn254_msm_g1", "bn254_g1_mul_batch",
           "bn254_msm_g2", "bn254_g2_mul_batch"]

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "poseidon2_host.c"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CFLAGS = ["-O3", "-shared", "-fPIC"]
MIMC_SOURCE = SOURCE.parent / "mimc_bn254_host.c"
MIMC_CFLAGS = [*CFLAGS, "-fopenmp"]
MSM_SOURCE = SOURCE.parent / "bn254_msm_host.c"
MSM_CFLAGS = MIMC_CFLAGS

_WIDTH_TO_INST = {16: 0, 24: 1}
_U32P = ctypes.POINTER(ctypes.c_uint32)
_U64P = ctypes.POINTER(ctypes.c_uint64)
_lib = None
_mimc_lib = None
_msm_lib = None


def _compiler() -> str:
    for cc in ("cc", "gcc"):
        found = shutil.which(cc)
        if found:
            return found
    raise RuntimeError("no C compiler (cc or gcc) found: the host hash "
                       "libraries cannot be built")


def _build(source: Path, build_dir: Path, cflags: list[str]
           ) -> tuple[Path, str]:
    """Compile `source` with `cflags` into build_dir unless a build of this
    exact source and flag set exists (named after the source's stem and
    their hash).  Returns (library path, the compiler's report — empty when
    the cached build was used).  Raises RuntimeError with the compiler's
    output when the build fails."""
    src = Path(source).read_bytes()
    key = hashlib.sha256(src + " ".join(cflags).encode()).hexdigest()[:16]
    lib = Path(build_dir) / f"{Path(source).stem}_{key}.so"
    if lib.exists():
        return lib, ""
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_compiler(), *cflags, str(source), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {source} failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr


def build(source: Path = SOURCE, build_dir: Path = BUILD_DIR
          ) -> tuple[Path, str]:
    """Build the host Poseidon2 library (see `_build`)."""
    return _build(source, build_dir, CFLAGS)


def build_mimc(source: Path = MIMC_SOURCE, build_dir: Path = BUILD_DIR
               ) -> tuple[Path, str]:
    """Build the host MiMC library with OpenMP (see `_build`); the source
    refuses to compile without it."""
    return _build(source, build_dir, MIMC_CFLAGS)


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


# ---------------------------------------------------------------------------
# MP-MiMC over the BN254 scalar field (the shrink layer's commitment hash)
# ---------------------------------------------------------------------------


def _bind_mimc(path: Path):
    """Load the built MiMC library, declare its C interface and inject the
    round constants."""
    from ..snark.wrap import MIMC_ROUND_CONSTANTS

    lib = ctypes.CDLL(str(path))
    sz, c_int = ctypes.c_size_t, ctypes.c_int
    lib.mimc_set_rc.argtypes = [_U64P]
    lib.mimc_set_rc.restype = c_int
    lib.mimc_hash_rows.argtypes = [_U64P, sz, sz, _U64P]
    lib.mimc_hash_rows.restype = None
    lib.mimc_compress_pairs.argtypes = [_U64P, sz, _U64P]
    lib.mimc_compress_pairs.restype = None
    lib.mimc_set_threads.argtypes = [c_int]
    lib.mimc_set_threads.restype = c_int
    lib.mimc_threads.argtypes = []
    lib.mimc_threads.restype = c_int
    lib.mimc_set_vector.argtypes = [c_int]
    lib.mimc_set_vector.restype = c_int
    rc = np.array([[(c >> (64 * j)) & 0xFFFFFFFFFFFFFFFF for j in range(4)]
                   for c in MIMC_ROUND_CONSTANTS], dtype=np.uint64)
    lib.mimc_set_rc(rc.ctypes.data_as(_U64P))
    return lib


def mimc_library():
    """The loaded MiMC library, built on first use (raises on any
    failure)."""
    global _mimc_lib
    if _mimc_lib is None:
        _mimc_lib = _bind_mimc(build_mimc()[0])
    return _mimc_lib


def _u64(a, ndim: int, last: int) -> np.ndarray:
    a = np.ascontiguousarray(a, dtype=np.uint64)
    if a.ndim != ndim or a.shape[-1] != last:
        raise ValueError(f"expected a {ndim}-d array of u64 limbs with last "
                         f"dimension {last}, got {a.shape}")
    return a


def mimc_hash_rows(elems: np.ndarray) -> np.ndarray:
    """(n, k, 4) plain u64 limb rows → (n, 4) digests: the MP-MiMC chain
    over each row's k elements (`snark.wrap.mimc_hash`; any limb values,
    reduced mod r)."""
    elems = _u64(elems, 3, 4)
    n, k, _ = elems.shape
    out = np.zeros((n, 4), dtype=np.uint64)
    mimc_library().mimc_hash_rows(elems.ctypes.data_as(_U64P), n, k,
                                  out.ctypes.data_as(_U64P))
    return out


def mimc_compress_pairs(pairs: np.ndarray) -> np.ndarray:
    """(n, 2, 4) plain u64 limb pairs → (n, 4) parent digests."""
    pairs = _u64(pairs, 3, 4)
    if pairs.shape[1] != 2:
        raise ValueError(f"pairs must be (n, 2, 4), got {pairs.shape}")
    out = np.zeros((pairs.shape[0], 4), dtype=np.uint64)
    mimc_library().mimc_compress_pairs(pairs.ctypes.data_as(_U64P),
                                       pairs.shape[0],
                                       out.ctypes.data_as(_U64P))
    return out


def set_mimc_threads(n: int) -> int:
    """Run the MiMC library on n OpenMP threads (n <= 0: OpenMP's default,
    one per core); returns the count now in use.  Process-wide."""
    return mimc_library().mimc_set_threads(int(n))


def mimc_threads() -> int:
    """The OpenMP threads the MiMC library runs on."""
    return mimc_library().mimc_threads()


def _set_mimc_vector(on: bool) -> bool:
    """Test hook: let the MiMC library take its AVX-512 IFMA path where
    the CPU has it (the default), or keep it to the scalar reference code,
    so that both paths can be held to the same digests; returns whether
    the vector path is now taken.  Process-wide."""
    return bool(mimc_library().mimc_set_vector(int(bool(on))))


# ---------------------------------------------------------------------------
# BN254 multi-scalar multiplication (the Groth16 prover's hot loop)
# ---------------------------------------------------------------------------


def build_msm(source: Path = MSM_SOURCE, build_dir: Path = BUILD_DIR
              ) -> tuple[Path, str]:
    """Build the host MSM library with OpenMP (see `_build`)."""
    return _build(source, build_dir, MSM_CFLAGS)


def _bind_msm(path: Path):
    """Load the built MSM library and declare its C interface."""
    lib = ctypes.CDLL(str(path))
    for name in ("bn254_msm_g1", "bn254_g1_mul_batch", "bn254_msm_g2",
                 "bn254_g2_mul_batch"):
        fn = getattr(lib, name)
        fn.argtypes = [_U64P, _U64P, ctypes.c_size_t, _U64P]
        fn.restype = None
    return lib


def msm_library():
    """The loaded MSM library, built on first use (raises on any
    failure)."""
    global _msm_lib
    if _msm_lib is None:
        _msm_lib = _bind_msm(build_msm()[0])
    return _msm_lib


def _msm_call(name: str, first: np.ndarray, scalars: np.ndarray,
              out_shape: tuple) -> np.ndarray:
    """Run one MSM entry point on validated u64 limb arrays: `first` (the
    points, or the base point of a batch) and `scalars`, (n, 4)."""
    out = np.zeros(out_shape, dtype=np.uint64)
    getattr(msm_library(), name)(first.ctypes.data_as(_U64P),
                                 scalars.ctypes.data_as(_U64P),
                                 scalars.shape[0], out.ctypes.data_as(_U64P))
    return out


def _points_and_scalars(points, scalars, width: int):
    points, scalars = _u64(points, 2, width), _u64(scalars, 2, 4)
    if points.shape[0] != scalars.shape[0]:
        raise ValueError(f"{points.shape[0]} points, {scalars.shape[0]} "
                         "scalars")
    return points, scalars


def bn254_msm_g1(points: np.ndarray, scalars: np.ndarray) -> np.ndarray:
    """points (n, 8) plain u64 limbs (x‖y; x = y = 0 is infinity),
    scalars (n, 4) → (3, 4) Jacobian (X, Y, Z) plain limbs; Z = 0 means
    infinity."""
    points, scalars = _points_and_scalars(points, scalars, 8)
    return _msm_call("bn254_msm_g1", points, scalars, (3, 4))


def bn254_g1_mul_batch(base: np.ndarray, scalars: np.ndarray) -> np.ndarray:
    """base (8,), scalars (n, 4) → (n, 3, 4) Jacobian points, k·base."""
    scalars = _u64(scalars, 2, 4)
    return _msm_call("bn254_g1_mul_batch", _u64(base, 1, 8), scalars,
                     (scalars.shape[0], 3, 4))


def bn254_msm_g2(points: np.ndarray, scalars: np.ndarray) -> np.ndarray:
    """points (n, 16) (x.re‖x.im‖y.re‖y.im limbs), scalars (n, 4) →
    (6, 4) Jacobian over Fp2 (X.re X.im Y.re Y.im Z.re Z.im)."""
    points, scalars = _points_and_scalars(points, scalars, 16)
    return _msm_call("bn254_msm_g2", points, scalars, (6, 4))


def bn254_g2_mul_batch(base: np.ndarray, scalars: np.ndarray) -> np.ndarray:
    """base (16,), scalars (n, 4) → (n, 6, 4) Jacobian-Fp2 points."""
    scalars = _u64(scalars, 2, 4)
    return _msm_call("bn254_g2_mul_batch", _u64(base, 1, 16), scalars,
                     (scalars.shape[0], 6, 4))
