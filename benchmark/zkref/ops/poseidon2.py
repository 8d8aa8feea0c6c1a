"""Poseidon2 permutation over Baby-Bear (width 16 and 24) — the STARK's
algebraic hash for Merkle commitments and the Fiat-Shamir challenger.

Counterpart of zktls_tpu.ops.poseidon2, with the same parameters
(regenerated here from the same SHA-256 counter stream):

  * external (full) rounds: add round constants, x^7 S-box on every lane,
    multiply by M_E = circ(2·M4, M4, …, M4);
  * internal (partial) rounds: constant + S-box on lane 0 only, multiply
    by M_I = J + diag(d);
  * RF = 8, RP = 13 (width 16) / 21 (width 24).

Four implementations of one function:
  * `Poseidon2.permute_ints` — host scalar (plain ints), for the
    challenger and the verifier: the C library of utils/native.py
    (csrc/poseidon2_host.c), as the reference routes it through
    native/poseidon2.c; `Poseidon2(width, native=False)` takes the
    pure-Python `permute_ints_plain` instead;
  * `permute_batch_plain` — plain torch over (N, width) Montgomery
    tensors, the reference the hand-written kernel is held against;
  * `permute_batch` — the entry point: on a CUDA tensor it launches the
    hand-written kernel (ops/cuda_poseidon2.py), on a CPU tensor it runs
    the plain version.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from functools import lru_cache

import torch

from . import babybear as bb
from .field_ref import P

__all__ = ["Poseidon2", "get_params", "permute_batch", "permute_batch_plain",
           "M4"]

M4 = [
    [2, 3, 1, 1],
    [1, 2, 3, 1],
    [1, 1, 2, 3],
    [3, 1, 1, 2],
]

_SEED_FMT = "zktls-tpu poseidon2 babybear w{width} v1"

#: calls of the plain batched version (a run on the card should leave it 0)
plain_calls = 0


def _constant_stream(seed: str):
    """Deterministic field elements via SHA-256(counter) with rejection
    sampling (each 4-byte BE word accepted iff < p)."""
    counter = 0
    while True:
        block = hashlib.sha256(f"{seed}/{counter}".encode()).digest()
        counter += 1
        for i in range(0, 32, 4):
            v = int.from_bytes(block[i : i + 4], "big")
            if v < P:
                yield v


@dataclass(frozen=True)
class Poseidon2Params:
    width: int
    rf: int          # external rounds (split rf/2 begin, rf/2 end)
    rp: int          # internal rounds
    external_rc: tuple  # (rf, width)
    internal_rc: tuple  # (rp,)
    diag: tuple      # (width,) internal diagonal


@lru_cache(maxsize=None)
def get_params(width: int) -> Poseidon2Params:
    if width not in (16, 24):
        raise ValueError("supported widths: 16, 24")
    rf = 8
    rp = 13 if width == 16 else 21
    stream = _constant_stream(_SEED_FMT.format(width=width))
    external = tuple(
        tuple(next(stream) for _ in range(width)) for _ in range(rf)
    )
    internal = tuple(next(stream) for _ in range(rp))
    # M_I = J + diag(d) is invertible iff every d_i != 0 and
    # 1 + Σ 1/d_i != 0: rejection-sample until both hold
    while True:
        diag = tuple(next(stream) for _ in range(width))
        if any(d == 0 for d in diag):
            continue
        s = sum(pow(d, P - 2, P) for d in diag) % P
        if (1 + s) % P != 0:
            break
    return Poseidon2Params(width, rf, rp, external, internal, diag)


# ---------------------------------------------------------------------------
# host-side scalar reference
# ---------------------------------------------------------------------------


def _external_matrix(s: list[int]) -> list[int]:
    """M_E·s: M4 on every 4-lane block, then each lane adds the sum of its
    position across blocks.  The map is linear, so the lanes are reduced
    once, at the end (inputs may be any non-negative ints)."""
    y: list[int] = []
    for i in range(0, len(s), 4):
        x0, x1, x2, x3 = s[i : i + 4]
        a = x0 + x1 + x2 + x3
        y += (a + x0 + 2 * x1, a + x1 + 2 * x2, a + x2 + 2 * x3,
              a + x3 + 2 * x0)
    t = [sum(y[j::4]) for j in range(4)]
    return [(v + t[i & 3]) % P for i, v in enumerate(y)]


class Poseidon2:
    """Host-side scalar Poseidon2 over plain-form ints: the C library
    (built at first use; a failed build raises) unless `native=False`,
    which takes the pure-Python plain version."""

    def __init__(self, width: int = 16, native: bool = True):
        self.params = get_params(width)
        self.native = native

    def permute_ints(self, state: list[int]) -> list[int]:
        if not self.native:
            return self.permute_ints_plain(state)
        if len(state) != self.params.width:
            raise ValueError(f"state width must be {self.params.width}")
        from ..utils import native

        return native.permute_ints(state)

    def permute_ints_plain(self, state: list[int]) -> list[int]:
        """The permutation in pure Python (the S-box is `pow(x, 7, P)`)."""
        p = self.params
        if len(state) != p.width:
            raise ValueError(f"state width must be {p.width}")
        half = p.rf // 2
        s = _external_matrix(state)  # initial linear layer
        for rc in p.external_rc[:half]:
            s = _external_matrix([pow(x + c, 7, P) for x, c in zip(s, rc)])
        for c in p.internal_rc:
            s[0] = pow(s[0] + c, 7, P)
            tot = sum(s)
            s = [(tot + d * x) % P for x, d in zip(s, p.diag)]
        for rc in p.external_rc[half:]:
            s = _external_matrix([pow(x + c, 7, P) for x, c in zip(s, rc)])
        return s


# ---------------------------------------------------------------------------
# batched: plain torch version + dispatch to the hand-written kernel
# ---------------------------------------------------------------------------


def _sbox_t(x):
    x2 = x * x % P
    x4 = x2 * x2 % P
    return x4 * x2 % P * x % P


def _external_matrix_t(s):
    """(N, t) plain values -> M_E·s: M4 on every 4-lane block, then each
    lane adds the sum of its position across blocks."""
    n, t = s.shape
    v = s.reshape(n, t // 4, 4)
    x0, x1, x2, x3 = v.unbind(-1)
    t0123 = x0 + x1 + x2 + x3
    y = torch.stack([t0123 + x0 + 2 * x1, t0123 + x1 + 2 * x2,
                     t0123 + x2 + 2 * x3, t0123 + x3 + 2 * x0],
                    dim=-1) % P                       # (N, t/4, 4)
    return ((y + y.sum(dim=1, keepdim=True)) % P).reshape(n, t)


def permute_batch_plain(states: torch.Tensor) -> torch.Tensor:
    """Poseidon2 over (N, width) Montgomery field tensors with plain torch
    ops, on any device.  Works in the plain domain (the permutation is a
    field function, so mont(π(x)) = π applied to mont(x) with Montgomery
    constants)."""
    global plain_calls
    plain_calls += 1
    n, width = states.shape
    p = get_params(width)
    dev = states.device
    erc = torch.tensor(p.external_rc, dtype=bb.DTYPE, device=dev)
    diag = torch.tensor(p.diag, dtype=bb.DTYPE, device=dev)
    half = p.rf // 2
    s = _external_matrix_t(bb.from_mont(states))
    for r in range(half):
        s = _external_matrix_t(_sbox_t((s + erc[r]) % P))
    for r in range(p.rp):
        lane0 = _sbox_t((s[:, 0] + p.internal_rc[r]) % P)
        s = torch.cat([lane0[:, None], s[:, 1:]], dim=1)
        s = (s.sum(dim=1, keepdim=True) % P + s * diag) % P
    for r in range(half, p.rf):
        s = _external_matrix_t(_sbox_t((s + erc[r]) % P))
    return bb.to_mont(s)


def permute_batch(states: torch.Tensor) -> torch.Tensor:
    """Poseidon2 over (N, width) Montgomery field tensors: the hand-written
    kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if states.ndim != 2 or states.shape[1] not in (16, 24):
        raise ValueError("states must be (N, 16|24)")
    if states.is_cuda:
        from . import cuda_poseidon2

        out = cuda_poseidon2.permute_batch(
            states.to(torch.int32).contiguous())
        return out.to(bb.DTYPE)
    if states.device.type == "cpu":
        return permute_batch_plain(states)
    raise ValueError(f"no Poseidon2 path for device {states.device}")
