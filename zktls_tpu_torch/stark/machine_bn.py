"""The machine STARK with BN254-friendly (MP-MiMC) commitments — the
shrink layer.

The reference's proof chain ends in a layer whose verifier is cheap
inside a BN254 SNARK circuit (SP1: shrink → wrap over BN254 via gnark;
risc0: identity_p254 → circom/rapidsnark — SURVEY.md §2.2.B/C).  This
module is that layer: the SAME machine STARK as stark/machine.py
(Baby-Bear field, chips, LogUp bus, mixed-height batch FRI) but every
commitment and every Fiat-Shamir step runs over MP-MiMC in the BN254
scalar field (stark/commit_bn.py), so a Groth16 wrap circuit pays ~330
constraints per hash instead of tens of thousands.

It holds the MiMC `Commitment` (MIMC), the BN proof types and the entry
points; the stages and the verifier are machine.py's, run under MIMC.
Port of zktls_tpu.stark.machine_bn: the proof format, the transcript and
every observation are the reference's, so `MachineProofBN.to_bytes()`
equals the reference's byte for byte on the same input and each
package's `verify_machine_bn` accepts the other's proofs.  Port choices:
the tensor work runs on the caller's device, as `prove_machine`'s does —
the CUDA card unless told otherwise — and every matrix is converted out
of Montgomery form on its device and hashed on the host through the C
MiMC (`MimcTree`); `timings=` gets the stages of `machine.STAGES`, the
seconds inside `MimcTree` (`mimc_s`) and the reference's `prove_bn_s`.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from ..core import cbor
from ..ops import babybear as bb
from ..ops.field_ref import Fp4
from .air import Air
from .commit_bn import FrChallenger, MimcTree, grind_bn, leaf_digest, \
    verify_path_bn
from .config import DEFAULT_CONFIG, StarkConfig
from .machine import (
    ChipInstance,
    Commitment,
    _preprocessed_root,
    _prove_machine,
    _verify_machine,
)

__all__ = ["ChipProofBN", "ChipOpeningBN", "MachineQueryBN",
           "MachineProofBN", "MIMC", "prove_machine_bn", "verify_machine_bn",
           "preprocessed_root_bn", "BN_DOMAIN_TAG"]

BN_DOMAIN_TAG = b"zktls-tpu-machine-bn-v1"
#: rows per block of a matrix converted out of Montgomery form on its
#: device and copied to the host for hashing
_HOST_ROWS = 1 << 22


@dataclass
class ChipProofBN:
    name: str
    log_n: int
    publics: list[int]
    bus_sum: list[int]
    trace_root: int
    quotient_root: int
    perm_root: int | None
    tl: list[Fp4]
    tn: list[Fp4]
    pl: list[Fp4]
    pn: list[Fp4]
    qe: list[Fp4]
    el: list[Fp4] = field(default_factory=list)
    en: list[Fp4] = field(default_factory=list)


@dataclass
class ChipOpeningBN:
    trace_row: list[int]
    trace_path: list[int]
    quotient_row: list[int]
    quotient_path: list[int]
    perm_row: list[int] = field(default_factory=list)
    perm_path: list[int] = field(default_factory=list)
    pre_row: list[int] = field(default_factory=list)
    pre_path: list[int] = field(default_factory=list)


@dataclass
class MachineQueryBN:
    index: int
    openings: list[ChipOpeningBN]
    fri_steps: list[tuple]       # FriSteps ((Fp4, Fp4), path: list[int])


@dataclass
class MachineProofBN:
    chips: list[ChipProofBN]
    fri_roots: list[int]
    fri_final: list[Fp4]
    pow_witness: int
    queries: list[MachineQueryBN]

    def to_bytes(self) -> bytes:
        def e(v: Fp4):
            return list(v.c)

        def fr(x):
            return int(x).to_bytes(32, "big")

        return cbor.dumps({
            "v": 1,
            "chips": [{
                "name": c.name, "log_n": c.log_n, "public": c.publics,
                "bus": c.bus_sum, "tr": fr(c.trace_root),
                "qr": fr(c.quotient_root),
                "pr": fr(c.perm_root) if c.perm_root is not None else None,
                "tl": [e(v) for v in c.tl], "tn": [e(v) for v in c.tn],
                "pl": [e(v) for v in c.pl], "pn": [e(v) for v in c.pn],
                "qe": [e(v) for v in c.qe], "el": [e(v) for v in c.el],
                "en": [e(v) for v in c.en],
            } for c in self.chips],
            "fri_roots": [fr(r) for r in self.fri_roots],
            "fri_final": [e(v) for v in self.fri_final],
            "pow": self.pow_witness,
            "queries": [{
                "i": q.index,
                "ops": [{
                    "tr": o.trace_row, "tp": [fr(h) for h in o.trace_path],
                    "qr": o.quotient_row,
                    "qp": [fr(h) for h in o.quotient_path],
                    "pr": o.perm_row, "pp": [fr(h) for h in o.perm_path],
                    "er": o.pre_row, "ep": [fr(h) for h in o.pre_path],
                } for o in q.openings],
                "fs": [{"p": [e(s[0][0]), e(s[0][1])],
                        "mp": [fr(h) for h in s[1]]}
                       for s in q.fri_steps],
            } for q in self.queries],
        })

    @classmethod
    def from_bytes(cls, data: bytes) -> "MachineProofBN":
        obj = cbor.loads(data)

        def d(v) -> Fp4:
            return Fp4(*v)

        def fr(b_):
            return int.from_bytes(b_, "big")

        return cls(
            chips=[ChipProofBN(
                name=c["name"], log_n=c["log_n"], publics=c["public"],
                bus_sum=c["bus"], trace_root=fr(c["tr"]),
                quotient_root=fr(c["qr"]),
                perm_root=fr(c["pr"]) if c["pr"] is not None else None,
                tl=[d(v) for v in c["tl"]], tn=[d(v) for v in c["tn"]],
                pl=[d(v) for v in c["pl"]], pn=[d(v) for v in c["pn"]],
                qe=[d(v) for v in c["qe"]],
                el=[d(v) for v in c.get("el", [])],
                en=[d(v) for v in c.get("en", [])],
            ) for c in obj["chips"]],
            fri_roots=[fr(r) for r in obj["fri_roots"]],
            fri_final=[d(v) for v in obj["fri_final"]],
            pow_witness=obj["pow"],
            queries=[MachineQueryBN(
                index=q["i"],
                openings=[ChipOpeningBN(
                    trace_row=o["tr"], trace_path=[fr(h) for h in o["tp"]],
                    quotient_row=o["qr"],
                    quotient_path=[fr(h) for h in o["qp"]],
                    perm_row=o.get("pr", []),
                    perm_path=[fr(h) for h in o.get("pp", [])],
                    pre_row=o.get("er", []),
                    pre_path=[fr(h) for h in o.get("ep", [])],
                ) for o in q["ops"]],
                fri_steps=[((d(s["p"][0]), d(s["p"][1])),
                            [fr(h) for h in s["mp"]]) for s in q["fs"]],
            ) for q in obj["queries"]],
        )


#: host seconds inside MimcTree, summed over every MIMC commit
_mimc_seconds = [0.0]


def _mimc_commit(matrix, defer: bool) -> MimcTree:
    """The MiMC tree of a Montgomery matrix: out of Montgomery form on its
    device in _HOST_ROWS blocks, then hashed on the host (nothing is left
    to defer)."""
    host = bb.to_plain_numpy(matrix, _HOST_ROWS)
    t = time.perf_counter()
    tree = MimcTree(host)
    _mimc_seconds[0] += time.perf_counter() - t
    return tree


def _observe_pre_root(ch: FrChallenger, root) -> None:
    if root is not None:
        ch.observe_fr(root)


MIMC = Commitment(
    tag=BN_DOMAIN_TAG, challenger=FrChallenger, commit=_mimc_commit,
    root=lambda tree: tree.root, observe_root=FrChallenger.observe_fr,
    observe_pre_root=_observe_pre_root, open=MimcTree.open,
    grind=lambda ch, pow_bits, device: grind_bn(ch, pow_bits),
    leaf_digest=leaf_digest, verify_path=verify_path_bn,
    proof=MachineProofBN, chip_proof=ChipProofBN, opening=ChipOpeningBN,
    query=MachineQueryBN)


def preprocessed_root_bn(air: Air, preprocessed: np.ndarray,
                         log_n_max: int, log_n: int,
                         config: StarkConfig = DEFAULT_CONFIG,
                         device=None) -> int:
    """The BN vk commitment of a chip's fixed matrix (MiMC tree over its
    machine-coset LDE).  device: where the LDE runs (`prove_machine_bn`'s
    rule)."""
    return _preprocessed_root(MIMC, preprocessed, log_n_max, log_n, config,
                              device)


def prove_machine_bn(chips: list[ChipInstance], binding: bytes,
                     config: StarkConfig = DEFAULT_CONFIG,
                     timings: dict | None = None,
                     device=None,
                     vk_roots: dict | None = None) -> MachineProofBN:
    """Prove the chip set with BN254/MiMC commitments: `prove_machine`'s
    stages under MIMC.

    device: where the tensor work runs — the CUDA card by default (raises
    without one), "cpu" for the plain torch versions.  timings: if given,
    receives the seconds of each stage of `machine.STAGES` (the device is
    synchronised at each stage boundary), `mimc_s` (inside `MimcTree`, on
    the host) and `prove_bn_s` (the whole prove).  vk_roots: if given,
    receives each preprocessed chip's root by name, the value
    `preprocessed_root_bn` gives for it, from the tree this prove commits
    anyway."""
    t0 = time.perf_counter()
    mimc0 = _mimc_seconds[0]
    proof = _prove_machine(MIMC, chips, binding, config, device, timings,
                           vk_roots=vk_roots)
    if timings is not None:
        timings["mimc_s"] = (timings.get("mimc_s", 0.0)
                             + _mimc_seconds[0] - mimc0)
        timings["prove_bn_s"] = round(time.perf_counter() - t0, 3)
    return proof


def verify_machine_bn(airs: list[Air], proof: MachineProofBN,
                      binding: bytes,
                      public_messages: list[tuple] | None = None,
                      config: StarkConfig = DEFAULT_CONFIG,
                      preprocessed_roots: dict[str, int] | None = None,
                      ) -> bool:
    """Verify a BN-committed machine proof: `verify_machine`'s checks
    under MIMC, the computation the Groth16 wrap circuit arithmetizes
    (snark/stark_wrap.py)."""
    return _verify_machine(MIMC, airs, proof, binding, public_messages,
                           config, preprocessed_roots)
