"""Baby-Bear field arithmetic as torch tensor ops.

Counterpart of zktls_tpu.ops.babybear.  Elements live in **Montgomery
form** (x·2^32 mod p) like the reference, so every function returns the
same canonical values in [0, p) as its JAX twin.  The storage type is
different: tensors are `torch.int64`.  torch has no add, sub or shift for
uint32 on the CPU, and an int64 lane holds a product of two elements
(< 2^62) exactly, so a Montgomery product is two exact remainders
(a·b mod p, then ·R⁻¹ mod p) instead of the reference's 16-bit limb
schedule.  Field values cross to and from numpy as uint32 arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from .field_ref import P as _P_INT

__all__ = [
    "P", "MONT_R", "MONT_R2", "DTYPE", "from_numpy", "to_numpy", "to_mont",
    "from_mont", "add", "sub", "neg", "mul", "pow_const", "inv", "sum_mod",
    "dot_mod", "matmul_mod", "matmul_mod_rt", "np_to_mont", "np_from_mont",
    "to_plain_numpy", "CPU_BLOCK_BYTES",
]

P = _P_INT
NPRIME = (-pow(_P_INT, -1, 1 << 32)) % (1 << 32)  # -p^-1 mod 2^32
MONT_R = (1 << 32) % _P_INT
MONT_R2 = (MONT_R * MONT_R) % _P_INT
MONT_RINV = pow(MONT_R, -1, _P_INT)
#: storage type of every field tensor in the port
DTYPE = torch.int64
#: on the CPU, `ntt.coset_lde` and the constraint VM work in blocks of at
#: most this many bytes (output columns, register-file rows): temporaries
#: that small are served again from the allocator's heap, where larger
#: ones are fresh zeroed pages every time (the blocks cut a CPU shrink of a
#: 2^17-row VmAir by about 30 %; the values do not depend on the blocking)
CPU_BLOCK_BYTES = 1 << 22


def from_numpy(x, device=None) -> torch.Tensor:
    """uint32 (or any integer) numpy values in [0, p) -> int64 tensor."""
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int64)).to(
        device)


def to_numpy(x: torch.Tensor) -> np.ndarray:
    """Field tensor -> uint32 numpy (same values)."""
    return x.detach().cpu().numpy().astype(np.uint32)


def add(a, b):
    s = a + b                                      # < 2p
    return torch.where(s >= P, s - P, s)


def sub(a, b):
    d = a - b
    return torch.where(d < 0, d + P, d)


def neg(a):
    return torch.where(a == 0, a, P - a)


def mul(a, b):
    """Montgomery product: mont(a)·mont(b) -> mont(a·b)."""
    return (a * b) % P * MONT_RINV % P


def to_mont(x):
    """Plain values (< p) -> Montgomery form."""
    return x * MONT_R % P


def from_mont(x):
    """Montgomery form -> plain values."""
    return x * MONT_RINV % P


def pow_const(x, e: int):
    """x^e for a fixed exponent (square-and-multiply); x in Montgomery
    form."""
    result = torch.full_like(x, MONT_R)            # mont(1)
    base = x
    while e:
        if e & 1:
            result = mul(result, base)
        base = mul(base, base)
        e >>= 1
    return result


def inv(x):
    """Field inverse via Fermat (x^(p-2)); x in Montgomery form, inv(0)=0."""
    return pow_const(x, _P_INT - 2)


def sum_mod(x, dim=None):
    """Sum of field elements along a dim, reduced mod p (the int64
    accumulator is exact for up to 2^32 terms)."""
    s = x.sum() if dim is None else x.sum(dim)
    return s % P


def dot_mod(a, b, dim=-1):
    """Field inner product along a dim (Montgomery operands)."""
    return sum_mod(mul(a, b), dim=dim)


def _digit_matmul(v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact Σ_k v[:, k]·w[k, :] mod p for v (N, k), w (k, m), both with
    values in [0, p), through int8 products — the reference's base-128
    digit scheme (5 digits of 7 bits per operand, the 25 digit products
    summed on 9 diagonals T_s = Σ_{i+j=s} D_i·E_j, exact in int32 while
    5·k·127² < 2³¹).  The 25 products run as ONE `torch._int_mm` of the
    digit-stacked v, (N, 5k), against a block matrix holding E_{s−i} at
    block (i, s), (5k, 9m).  Padded to what the CUDA int8 GEMM takes:
    more than 16 rows, inner and output widths multiples of 8."""
    n, k = v.shape
    m = w.shape[1]
    if 5 * k * 127 * 127 >= (1 << 31):
        raise ValueError("matmul_mod: k too large for exact int32 matmul")
    dev = v.device
    kp = -(-5 * k // 8) * 8
    mp = -(-9 * m // 8) * 8
    rows = max(n, 17)
    a = torch.zeros((rows, kp), dtype=torch.int8, device=dev)
    for i in range(5):
        a[:n, i * k : (i + 1) * k] = (v >> (7 * i)) & 127
    b = torch.zeros((kp, mp), dtype=torch.int8, device=dev)
    for j in range(5):
        dig = (w >> (7 * j)) & 127
        for i in range(5):
            b[i * k : (i + 1) * k, (i + j) * m : (i + j + 1) * m] = dig
    t = torch._int_mm(a, b)[:n, : 9 * m].to(torch.int64)   # each T_s ≥ 0
    out = None
    for s in range(9):
        term = t[:, s * m : (s + 1) * m] % P * pow(128, s, P) % P
        out = term if out is None else add(out, term)
    return out


def matmul_mod(v: torch.Tensor, w_np) -> torch.Tensor:
    """Exact Baby-Bear matrix product: (N, k) field values × (k, m) plain
    integer constants -> (N, m) mod p, in the input's representation (the
    map is linear, so Montgomery inputs give Montgomery outputs)."""
    w = torch.as_tensor(np.asarray(w_np, dtype=np.int64) % P,
                        device=v.device)
    return _digit_matmul(v, w)


def matmul_mod_rt(v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """matmul_mod with runtime plain weights (a (k, m) field tensor) —
    the constraint-VM fold, whose α-power matrix changes every proof."""
    return _digit_matmul(v, w)


# ---------------------------------------------------------------------------
# host-side helpers
# ---------------------------------------------------------------------------


def np_to_mont(x: np.ndarray) -> np.ndarray:
    """Numpy-side conversion (exact)."""
    return ((x.astype(np.uint64) * np.uint64(MONT_R)) % np.uint64(_P_INT)).astype(
        np.uint32
    )


def np_from_mont(x: np.ndarray) -> np.ndarray:
    return ((x.astype(np.uint64) * np.uint64(MONT_RINV)) % np.uint64(_P_INT)
            ).astype(np.uint32)


def to_plain_numpy(x: torch.Tensor, block_rows: int) -> np.ndarray:
    """Montgomery field tensor -> plain uint32 numpy, converted where the
    tensor is, `block_rows` rows at a time (their temporaries stay small
    beside a large matrix); every value is < 2^31, so half the bytes cross
    to the host as int32."""
    out = np.empty(tuple(x.shape), dtype=np.uint32)
    for r0 in range(0, x.shape[0], block_rows):
        blk = from_mont(x[r0 : r0 + block_rows]).to(torch.int32)
        out[r0 : r0 + blk.shape[0]] = blk.cpu().numpy().view(np.uint32)
    return out
