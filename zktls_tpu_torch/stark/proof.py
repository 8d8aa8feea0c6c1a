"""Proof containers + byte-serialization (CBOR, via the framework codec).
Port copy of zktls_tpu.stark.proof.

The shape mirrors what the reference provers emit per segment (a STARK
"seal": commitments, out-of-domain evaluations, FRI layers, query openings —
risc0-zkp seal / Plonky3 uni-stark proof, SURVEY.md §2.2)."""

from __future__ import annotations

from dataclasses import dataclass

from ..ops.field_ref import Fp4

__all__ = ["FriStep"]

Digest = list[int]  # 8 base elements


@dataclass
class FriStep:
    pair: tuple[Fp4, Fp4]    # (f(x), f(−x)) at the queried leaf
    path: list[Digest]
