"""Proof containers + byte-serialization (CBOR, via the framework codec).
Port copy of zktls_tpu.stark.proof: the same fields and the same bytes.

The shape mirrors what the reference provers emit per segment (a STARK
"seal": commitments, out-of-domain evaluations, FRI layers, query openings —
risc0-zkp seal / Plonky3 uni-stark proof, SURVEY.md §2.2)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

from ..core import cbor
from ..ops.field_ref import Fp4

__all__ = ["FriStep", "QueryProof", "StarkProof"]

Digest = list[int]  # 8 base elements


class FriStep(NamedTuple):
    pair: tuple[Fp4, Fp4]    # (f(x), f(−x)) at the queried leaf
    path: list               # the layer tree's sibling path


@dataclass
class QueryProof:
    index: int
    trace_row: list[int]        # plain base values, all trace columns
    trace_path: list[Digest]
    quotient_row: list[int]     # plain base values, blowup·4 columns
    quotient_path: list[Digest]
    fri_steps: list[FriStep]
    perm_row: list[int] = field(default_factory=list)
    perm_path: list[Digest] = field(default_factory=list)


@dataclass
class StarkProof:
    air_name: str
    log_n: int
    public_values: list[int]
    trace_root: Digest
    quotient_root: Digest
    trace_local_evals: list[Fp4]
    trace_next_evals: list[Fp4]
    quotient_evals: list[Fp4]   # blowup·4 committed-column evals at ζ
    fri_roots: list[Digest]
    fri_final: list[Fp4]
    pow_witness: int
    queries: list[QueryProof] = field(default_factory=list)
    # LogUp second commitment round (empty when the AIR has no lookups)
    perm_root: Digest | None = None
    perm_local_evals: list[Fp4] = field(default_factory=list)
    perm_next_evals: list[Fp4] = field(default_factory=list)

    # ------------------------------------------------------------------

    def to_bytes(self) -> bytes:
        def e(v: Fp4):
            return list(v.c)

        obj = {
            "air": self.air_name,
            "log_n": self.log_n,
            "public": self.public_values,
            "trace_root": self.trace_root,
            "quotient_root": self.quotient_root,
            "tl": [e(v) for v in self.trace_local_evals],
            "tn": [e(v) for v in self.trace_next_evals],
            "perm_root": self.perm_root,
            "pl": [e(v) for v in self.perm_local_evals],
            "pn": [e(v) for v in self.perm_next_evals],
            "qe": [e(v) for v in self.quotient_evals],
            "fri_roots": self.fri_roots,
            "fri_final": [e(v) for v in self.fri_final],
            "pow": self.pow_witness,
            "queries": [
                {
                    "i": q.index,
                    "tr": q.trace_row,
                    "tp": q.trace_path,
                    "qr": q.quotient_row,
                    "qp": q.quotient_path,
                    "pr": q.perm_row,
                    "pp": q.perm_path,
                    "fs": [
                        {"p": [e(s.pair[0]), e(s.pair[1])], "mp": s.path}
                        for s in q.fri_steps
                    ],
                }
                for q in self.queries
            ],
        }
        return cbor.dumps(obj)

    @classmethod
    def from_bytes(cls, data: bytes) -> "StarkProof":
        obj = cbor.loads(data)

        def d(v) -> Fp4:
            return Fp4(*v)

        return cls(
            air_name=obj["air"],
            log_n=obj["log_n"],
            public_values=obj["public"],
            trace_root=obj["trace_root"],
            quotient_root=obj["quotient_root"],
            trace_local_evals=[d(v) for v in obj["tl"]],
            trace_next_evals=[d(v) for v in obj["tn"]],
            perm_root=obj.get("perm_root"),
            perm_local_evals=[d(v) for v in obj.get("pl", [])],
            perm_next_evals=[d(v) for v in obj.get("pn", [])],
            quotient_evals=[d(v) for v in obj["qe"]],
            fri_roots=obj["fri_roots"],
            fri_final=[d(v) for v in obj["fri_final"]],
            pow_witness=obj["pow"],
            queries=[
                QueryProof(
                    index=q["i"],
                    trace_row=q["tr"],
                    trace_path=q["tp"],
                    quotient_row=q["qr"],
                    quotient_path=q["qp"],
                    perm_row=q.get("pr", []),
                    perm_path=q.get("pp", []),
                    fri_steps=[
                        FriStep(pair=(d(s["p"][0]), d(s["p"][1])), path=s["mp"])
                        for s in q["fs"]
                    ],
                )
                for q in obj["queries"]
            ],
        )
