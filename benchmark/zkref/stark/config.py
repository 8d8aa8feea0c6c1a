"""STARK configuration and the commitment-coset selector tables (port copy
of zktls_tpu.stark.config; the tables are the same values, computed with
vectorized numpy instead of Python ints)."""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from ..ops.field_ref import GENERATOR, P, two_adic_root
from ..ops.ntt import eval_domain, np_batch_inverse

__all__ = ["StarkConfig", "DEFAULT_CONFIG", "selector_arrays"]


@dataclass(frozen=True)
class StarkConfig:
    #: log2 LDE blowup; rate = 2^-log_blowup.  Blowup 4 supports constraint
    #: degree ≤ 3 (plus a degree-1 selector) without widening the quotient.
    log_blowup: int = 2
    #: FRI query count: each query contributes ~log_blowup bits of soundness.
    num_queries: int = 36
    #: grinding bits added to the query phase (0 = disabled).
    pow_bits: int = 0
    #: coset shift for the commitment domain (the field generator — its
    #: powers stay clear of every 2-adic subgroup used by trace domains).
    shift: int = GENERATOR
    #: FRI stops folding when the layer has at most this many values.
    fri_final_size: int = 64

    @property
    def blowup(self) -> int:
        return 1 << self.log_blowup


DEFAULT_CONFIG = StarkConfig()


@lru_cache(maxsize=None)
def selector_arrays(log_n: int, log_blowup: int, shift: int):
    """Evaluations over the commitment coset (size N = n·2^log_blowup,
    points x_i = shift·w_N^i) of the Lagrange selectors of the trace domain
    H = H_n (shift 1, generator g = w_n):

      Z_H(x)       = x^n − 1
      is_first(x)  = Z_H(x)/(x − 1)
      is_last(x)   = Z_H(x)/(x − g^{n−1})
      is_trans(x)  = x − g^{n−1}
      inv_Z_H(x)

    Returned as plain-form uint32 numpy arrays (host-precomputed, cached).
    """
    n = 1 << log_n
    N = n << log_blowup
    p = np.uint64(P)
    xs = eval_domain(log_n + log_blowup, shift).astype(np.uint64)
    g_last = pow(two_adic_root(log_n), n - 1, P)
    # x_{i+B}^n = x_i^n · w_N^{B·n} = x_i^n for B = 2^log_blowup: Z_H takes
    # B values, repeated
    zh_b = np.array([(pow(int(x), n, P) - 1) % P
                     for x in xs[: 1 << log_blowup]], dtype=np.uint64)
    zh = np.tile(zh_b, n)
    x_mg = (xs + p - np.uint64(g_last)) % p
    inv_zh = np.tile(np_batch_inverse(zh_b), n)
    out = {
        "x": xs.astype(np.uint32),
        "z_h": zh.astype(np.uint32),
        "inv_z_h": inv_zh.astype(np.uint32),
        "is_first_row": (zh * np_batch_inverse((xs + p - np.uint64(1)) % p)
                         % p).astype(np.uint32),
        "is_last_row": (zh * np_batch_inverse(x_mg) % p).astype(np.uint32),
        "is_transition": x_mg.astype(np.uint32),
    }
    assert len(out["x"]) == N
    return out
