"""Fiat-Shamir challenger: a duplex sponge over the width-16 Poseidon2
permutation (host-side — the transcript is tiny and strictly sequential).

Port copy of zktls_tpu.stark.challenger (on the port's host Poseidon2:
the C library, or the pure-Python plain version with `native=False`).  Duplex discipline:

  * observe(x): buffer base elements; when RATE=8 are buffered (or a sample
    is requested), absorb by overwriting the rate lanes and permute;
  * sample(): squeeze one base element from the rate lanes, permuting when
    the squeeze buffer is exhausted; any observe invalidates pending
    squeeze output;
  * sample_ext(): 4 base samples -> Fp4; sample_bits(k): one sample
    truncated to k < 27 bits (uniform enough from a ~2^31 field element —
    bias ≤ 2^-4 per draw, standard).

Prover and verifier must interleave observe/sample identically; any
divergence changes every subsequent challenge.
"""

from __future__ import annotations

from ..ops.field_ref import P, Fp4
from ..ops.poseidon2 import Poseidon2

__all__ = ["Challenger"]

RATE = 8
WIDTH = 16


class Challenger:
    def __init__(self, domain_tag: str = "zktls-tpu-stark-v1",
                 native: bool = True):
        self._perm = Poseidon2(WIDTH, native=native)
        self.state = [0] * WIDTH
        self.input_buf: list[int] = []
        self.output_buf: list[int] = []
        # domain separation: absorb the tag bytes as field elements
        for b in domain_tag.encode():
            self.observe(b)

    # ------------------------------------------------------------------

    def _duplex(self) -> None:
        for i, v in enumerate(self.input_buf):
            self.state[i] = v % P
        self.input_buf = []
        self.state = self._perm.permute_ints(self.state)
        self.output_buf = list(self.state[:RATE])

    def observe(self, value: int) -> None:
        if not 0 <= value < P:
            raise ValueError(f"observation out of field range: {value}")
        self.output_buf = []  # pending squeezes are invalidated
        self.input_buf.append(value)
        if len(self.input_buf) == RATE:
            self._duplex()

    def observe_many(self, values) -> None:
        for v in values:
            self.observe(int(v))

    def observe_ext(self, value: Fp4) -> None:
        self.observe_many(value.c)

    def observe_bytes(self, data: bytes) -> None:
        """Absorb arbitrary bytes 31 bits at a time (4-byte chunks reduced
        would bias; use 3-byte chunks < 2^24 < p for injectivity, prefixed
        with the length)."""
        self.observe(len(data) % P)
        for i in range(0, len(data), 3):
            self.observe(int.from_bytes(data[i : i + 3], "big"))

    # ------------------------------------------------------------------

    def sample(self) -> int:
        if self.input_buf or not self.output_buf:
            self._duplex()
        return self.output_buf.pop()

    def sample_ext(self) -> Fp4:
        return Fp4(self.sample(), self.sample(), self.sample(), self.sample())

    def sample_bits(self, bits: int) -> int:
        if bits > 27:
            raise ValueError("sample_bits supports at most 27 bits")
        return self.sample() & ((1 << bits) - 1)

    def check_witness(self, pow_bits: int, witness: int) -> bool:
        """Proof-of-work grinding check: observing `witness` must leave the
        next sample with `pow_bits` trailing zero bits."""
        clone = self.clone()
        clone.observe(witness)
        ok = clone.sample_bits(pow_bits) == 0 if pow_bits else True
        # adopt the clone's state so prover/verifier transcripts stay aligned
        self.state = clone.state
        self.input_buf = clone.input_buf
        self.output_buf = clone.output_buf
        return ok

    def clone(self) -> "Challenger":
        c = Challenger.__new__(Challenger)
        c._perm = self._perm
        c.state = list(self.state)
        c.input_buf = list(self.input_buf)
        c.output_buf = list(self.output_buf)
        return c
