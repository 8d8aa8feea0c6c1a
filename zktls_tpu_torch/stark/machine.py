"""The machine STARK: every chip of a workload proven in ONE proof.

Port of zktls_tpu.stark.machine.  The proof format, the transcript and
every Fiat-Shamir observation are the reference's, so the port's
`MachineProof.to_bytes()` equals the reference's byte for byte on the same
input, and each package's verifier accepts the other's proofs.

Transcript order (prover/verifier mirror exactly):
  header(binding, chip names/sizes/publics[, preprocessed roots]) → trace
  roots → γ, δ → perm roots + bus sums → α → quotient roots → ζ → OOD
  evals → β → FRI roots/folds → final layer → grinding → query indices.

Features, all the reference's:
  * preprocessed (fixed) columns: committed before the transcript starts,
    their root bound into the header and checked by the verifier against
    the root it is given (`preprocessed_root`, vk material);
  * serial commits on one device: each chip's tree and root are finished
    before the next chip's LDE starts, so the reference's serial-commit
    guard holds with no option;
  * several devices (`devices=`, `mesh=`; parallel/): chips are placed
    round-robin over the device list in machine order and every chip's
    LDE and tree are dispatched before the first root is read, so the
    devices work at once; with a mesh whose `ntt` axis has more than one
    device, the chips of the largest height get their trace LDE as a
    four-step sharded over that axis (parallel.ntt), gathered back to the
    chip's device; host spill is off; each chip's DEEP term moves to the
    first device, where FRI, grinding and the query draws run.  One
    process drives every device (peer copies, no torch.distributed), and
    a device may repeat in the list;
  * host spill (`spill_bytes=`): a chip whose committed extensions pass
    the limit keeps them on the host as int32 (pinned for a card) and
    streams row blocks back for the quotient, DEEP and the openings;
  * chunked DEEP (`chunked_deep_bytes=`): a large chip's DEEP matvecs run
    per source matrix and row block instead of over one concatenation.
  Every setting gives the same proof bytes.

FRI is the host-driven fold loop (prover._fri_commit), which gives the
same bytes as the reference's fused device program (its
ZKTLS_FUSED_FRI); the quotient is the reference's default, the
constraint VM (not its ZKTLS_QUOTIENT=xla direct evaluation).

One stage sequence and one verifier serve two commitment schemes, each a
`Commitment`: POSEIDON2 here (Poseidon2 Merkle trees on the device, the
Baby-Bear duplex challenger) and machine_bn.MIMC (the shrink layer:
MP-MiMC trees hashed on the host, the BN254 challenger).  The scheme
decides the commitments, the transcript's domain tag and root
observations, grinding and the proof types; every other step is the same
code for both.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from ..core import cbor
from ..ops import babybear as bb
from ..ops import ext as ex
from ..ops.field_ref import Fp4, P, two_adic_root
from ..ops.merkle import MerkleTree, hash_row_ints, verify_path
from ..ops.ntt import coeffs_to_coset_evals, coset_coeffs, coset_lde, intt
from ..utils.spans import Stages, span
from . import prover
from .air import Air
from .bus import MAX_PAYLOAD, bus_term, delta_powers
from .challenger import Challenger
from .config import DEFAULT_CONFIG, StarkConfig, selector_arrays
from .lookup import np_ext_mul, np_ext_powers
from .lowering import eval_quotient_vm, lower_air, row_block
from .proof import FriStep
from .prover import (
    _deep_fn,
    _ext_evals_at,
    _fri_commit,
    _fri_steps,
    _grind_and_sample,
    _mont,
    _open_path,
    _zeta_powers,
)
from .verifier import (
    _EXT_BASIS,
    VerificationError,
    _eval_periodic,
    _final_low_degree,
)

__all__ = [
    "ChipInstance", "ChipProof", "ChipOpening", "MachineQuery",
    "MachineProof", "Commitment", "POSEIDON2", "prove_machine",
    "verify_machine", "preprocessed_root", "MACHINE_DOMAIN_TAG", "STAGES",
    "SPILL_BYTES", "CHUNKED_DEEP_BYTES", "perm_trace_paths",
    "reset_perm_trace_paths",
]

MACHINE_DOMAIN_TAG = b"zktls-tpu-machine-v2"

#: the prover's stages, in order, as keys of its `timings` dict
STAGES = ("lde_commit", "perm_commit", "quotient", "ood_openings", "deep",
          "fri", "queries")

#: default host-spill limit: a chip's committed extensions (trace,
#: preprocessed, perm and quotient LDEs, int64 on the device) above this
#: many bytes move to the host.  A fifth of an 80 GB card: the
#: eight-session batch (largest chip 2.9 GB) stays resident (PERF.md §5).
SPILL_BYTES = 16e9
#: default chunked-DEEP limit: a chip whose DEEP source matrices (both
#: opening groups) pass this many bytes runs DEEP per matrix and row block
#: instead of over their concatenation, which would double its resident
#: matrices at the DEEP peak (PERF.md §5).
CHUNKED_DEEP_BYTES = 2e9
#: rows per block of a chunked or streamed DEEP matvec: blocks of at most
#: this many matrix entries
_DEEP_BLOCK_ENTRIES = 1 << 25

#: chips whose perm trace stage 2 computed on their device (an AIR class
#: that overrides Air.perm_trace_m) or on the host, counted per chip and
#: prove since the last reset_perm_trace_paths()
perm_trace_paths = {"device": 0, "host": 0}


def reset_perm_trace_paths() -> None:
    for path in perm_trace_paths:
        perm_trace_paths[path] = 0


@dataclass
class ChipInstance:
    """One chip's contribution to a machine proof."""

    air: Air
    trace: np.ndarray        # (n, air.width) plain uint32
    publics: list[int]       # main public values (bus sum appended later)
    #: fixed columns (n, air.preprocessed_width) for preprocessed chips —
    #: a deterministic function of the statement, NOT prover-chosen; its
    #: commitment root belongs in the verifying key
    preprocessed: np.ndarray | None = None


@dataclass
class ChipProof:
    name: str
    log_n: int
    publics: list[int]
    bus_sum: list[int]       # 4 base limbs of the chip's cumulative bus sum
    trace_root: list[int]
    quotient_root: list[int]
    perm_root: list[int] | None
    tl: list[Fp4]
    tn: list[Fp4]
    pl: list[Fp4]
    pn: list[Fp4]
    qe: list[Fp4]
    #: preprocessed-column openings at ζ / g·ζ (empty unless the chip has
    #: preprocessed columns; the ROOT they commit to lives in the vk)
    el: list[Fp4] = field(default_factory=list)
    en: list[Fp4] = field(default_factory=list)


@dataclass
class ChipOpening:
    trace_row: list[int]
    trace_path: list[list[int]]
    quotient_row: list[int]
    quotient_path: list[list[int]]
    perm_row: list[int] = field(default_factory=list)
    perm_path: list[list[int]] = field(default_factory=list)
    pre_row: list[int] = field(default_factory=list)
    pre_path: list[list[int]] = field(default_factory=list)


@dataclass
class MachineQuery:
    index: int
    openings: list[ChipOpening]     # one per chip, machine order
    fri_steps: list[FriStep]


@dataclass
class MachineProof:
    chips: list[ChipProof]
    fri_roots: list[list[int]]
    fri_final: list[Fp4]
    pow_witness: int
    queries: list[MachineQuery]

    def to_bytes(self) -> bytes:
        def e(v: Fp4):
            return list(v.c)

        return cbor.dumps({
            "v": 2,
            "chips": [{
                "name": c.name, "log_n": c.log_n, "public": c.publics,
                "bus": c.bus_sum, "tr": c.trace_root, "qr": c.quotient_root,
                "pr": c.perm_root, "tl": [e(v) for v in c.tl],
                "tn": [e(v) for v in c.tn], "pl": [e(v) for v in c.pl],
                "pn": [e(v) for v in c.pn], "qe": [e(v) for v in c.qe],
                "el": [e(v) for v in c.el], "en": [e(v) for v in c.en],
            } for c in self.chips],
            "fri_roots": self.fri_roots,
            "fri_final": [e(v) for v in self.fri_final],
            "pow": self.pow_witness,
            "queries": [{
                "i": q.index,
                "ops": [{
                    "tr": o.trace_row, "tp": o.trace_path,
                    "qr": o.quotient_row, "qp": o.quotient_path,
                    "pr": o.perm_row, "pp": o.perm_path,
                    "er": o.pre_row, "ep": o.pre_path,
                } for o in q.openings],
                "fs": [{"p": [e(s.pair[0]), e(s.pair[1])], "mp": s.path}
                       for s in q.fri_steps],
            } for q in self.queries],
        })

    @classmethod
    def from_bytes(cls, data: bytes) -> "MachineProof":
        obj = cbor.loads(data)

        def d(v) -> Fp4:
            return Fp4(*v)

        return cls(
            chips=[ChipProof(
                name=c["name"], log_n=c["log_n"], publics=c["public"],
                bus_sum=c["bus"], trace_root=c["tr"], quotient_root=c["qr"],
                perm_root=c["pr"], tl=[d(v) for v in c["tl"]],
                tn=[d(v) for v in c["tn"]], pl=[d(v) for v in c["pl"]],
                pn=[d(v) for v in c["pn"]], qe=[d(v) for v in c["qe"]],
                el=[d(v) for v in c.get("el", [])],
                en=[d(v) for v in c.get("en", [])],
            ) for c in obj["chips"]],
            fri_roots=obj["fri_roots"],
            fri_final=[d(v) for v in obj["fri_final"]],
            pow_witness=obj["pow"],
            queries=[MachineQuery(
                index=q["i"],
                openings=[ChipOpening(
                    trace_row=o["tr"], trace_path=o["tp"],
                    quotient_row=o["qr"], quotient_path=o["qp"],
                    perm_row=o.get("pr", []), perm_path=o.get("pp", []),
                    pre_row=o.get("er", []), pre_path=o.get("ep", []),
                ) for o in q["ops"]],
                fri_steps=[FriStep(pair=(d(s["p"][0]), d(s["p"][1])),
                                   path=s["mp"]) for s in q["fs"]],
            ) for q in obj["queries"]],
        )


# ---------------------------------------------------------------------------
# commitment schemes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Commitment:
    """What a machine proof's commitment scheme decides, and nothing else.
    Two instances: POSEIDON2 below and machine_bn.MIMC."""

    #: the transcript's domain tag, observed first
    tag: bytes
    #: () -> a fresh Fiat-Shamir challenger
    challenger: Callable
    #: (Montgomery matrix (N, w), defer) -> tree over its rows; defer:
    #: only enqueue device work, read back at the first root or opening
    commit: Callable
    #: tree -> its root, as the proof carries it
    root: Callable
    #: (challenger, root)
    observe_root: Callable
    #: (challenger, a chip's vk preprocessed root or None), in the header
    observe_pre_root: Callable
    #: (tree, leaf index) -> sibling path
    open: Callable
    #: (challenger, pow_bits, device) -> proof-of-work witness
    grind: Callable
    #: plain row ints -> leaf digest (verifier)
    leaf_digest: Callable
    #: (leaf digest, index, path, root) -> bool (verifier)
    verify_path: Callable
    #: the proof types: MachineProof, ChipProof, ChipOpening, MachineQuery
    #: or their machine_bn twins
    proof: type
    chip_proof: type
    opening: type
    query: type


def _merkle_commit(matrix: torch.Tensor, defer: bool) -> MerkleTree:
    return MerkleTree(matrix, defer=defer)


def _observe_pre_root(ch: Challenger, root) -> None:
    if root:
        ch.observe_many(root)


def _grind(ch: Challenger, pow_bits: int, device) -> int:
    # looked up at call time, where tests put a spy on it
    return prover._grind_device(ch, pow_bits, device)


POSEIDON2 = Commitment(
    tag=MACHINE_DOMAIN_TAG, challenger=Challenger, commit=_merkle_commit,
    root=lambda tree: [int(x) for x in tree.root],
    observe_root=Challenger.observe_many, observe_pre_root=_observe_pre_root,
    open=_open_path, grind=_grind, leaf_digest=hash_row_ints,
    verify_path=verify_path, proof=MachineProof, chip_proof=ChipProof,
    opening=ChipOpening, query=MachineQuery)


# ---------------------------------------------------------------------------
# shared transcript header
# ---------------------------------------------------------------------------


def _machine_order(items, log_n_of, name_of):
    """Canonical chip order: largest commitment domain first (FRI joins
    smaller chips at later layers), ties by name."""
    return sorted(items, key=lambda it: (-log_n_of(it), name_of(it)))


def _observe_header(commitment: Commitment, ch, binding: bytes,
                    entries) -> None:
    """entries: (name, log_n, publics, preprocessed_root or None) per chip
    — a chip's vk-committed preprocessed root is bound into the transcript
    before anything is sampled."""
    ch.observe_bytes(commitment.tag)
    ch.observe_bytes(binding)
    ch.observe(len(entries))
    for name, log_n, publics, pre_root in entries:
        ch.observe_bytes(name.encode())
        ch.observe(log_n)
        ch.observe(len(publics))
        ch.observe_many(publics)
        commitment.observe_pre_root(ch, pre_root)


def _sample_challenges(ch) -> list[Fp4]:
    gamma = ch.sample_ext()
    delta = ch.sample_ext()
    return [gamma] + delta_powers(delta, MAX_PAYLOAD)


# ---------------------------------------------------------------------------
# prover
# ---------------------------------------------------------------------------


def _resolve_device(device) -> torch.device:
    """The device the prover runs on: the CUDA card unless the caller names
    another.  Never falls back to the CPU silently — with no card and no
    explicit device this raises."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain torch versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is "
                               "not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


def _spill(d: dict, keys, limit: float, dev: torch.device) -> None:
    """Host spill: once the chip's matrices under `keys` pass `limit` bytes
    (int64 on the device), move them to the host as int32 — every value is
    < p < 2^31 — pinned when the prover runs on a card.  Later stages read
    them back in row blocks (`lowering.row_block`)."""
    mats = [k for k in keys if k in d]
    if sum(d[k].numel() * 8 for k in mats) <= limit:
        return
    for k in mats:
        if d[k].dtype != torch.int32:
            host = d[k].to("cpu", torch.int32)
            d[k] = host.pin_memory() if dev.type == "cuda" else host
    d["spilled"] = True


def _deep_numer(parts, bpow_m: torch.Tensor, off: int, N: int,
                dev: torch.device) -> torch.Tensor:
    """Σ over `parts` of Σ_j β^j (V_j(x) − v_j): each part (matrix, its
    Montgomery evals (w, 4)) takes the next w β powers from `off`.  Each
    matrix — resident or spilled — is read in row blocks, so neither a
    concatenation nor a full-size product is ever resident."""
    comb = torch.zeros((N, 4), dtype=bb.DTYPE, device=dev)
    const = torch.zeros((4,), dtype=bb.DTYPE, device=dev)
    for mat, evals in parts:
        w = int(mat.shape[1])
        if w == 0:
            continue
        betas = bpow_m[off : off + w]
        off += w
        const = bb.add(const, bb.sum_mod(ex.ext_mul(betas, evals), dim=0))
        B = max(1, min(N, _DEEP_BLOCK_ENTRIES // w))
        for r0 in range(0, N, B):
            blk = row_block(mat, r0, min(B, N - r0), dev)
            part = torch.stack([bb.dot_mod(blk, betas[None, :, ell], dim=1)
                                for ell in range(4)], dim=-1)
            comb[r0 : r0 + blk.shape[0]] = bb.add(
                comb[r0 : r0 + blk.shape[0]], part)
    return ex.ext_sub(comb, const[None, :])


def _deep_chunked(parts_z, parts_gz, bpow_m: torch.Tensor, w_z: int,
                  inv_x_zeta: torch.Tensor, inv_x_gzeta: torch.Tensor
                  ) -> torch.Tensor:
    """DEEP composition without concatenating the source matrices: the same
    value as `prover._deep_fn` over [trace ‖ pre ‖ perm ‖ quotient] and
    [trace ‖ pre ‖ perm], summed per source matrix and row block (port of
    the reference's `_deep_chunked`).  bpow_m holds the ζ-group's β powers,
    then the g·ζ-group's."""
    N, dev = inv_x_zeta.shape[0], inv_x_zeta.device
    numer_z = _deep_numer(parts_z, bpow_m, 0, N, dev)
    numer_gz = _deep_numer(parts_gz, bpow_m, w_z, N, dev)
    return ex.ext_add(ex.ext_mul(numer_z, inv_x_zeta),
                      ex.ext_mul(numer_gz, inv_x_gzeta))


def prove_machine(chips: list[ChipInstance], binding: bytes,
                  config: StarkConfig = DEFAULT_CONFIG, device=None,
                  timings: dict | None = None,
                  spill_bytes: float = SPILL_BYTES,
                  chunked_deep_bytes: float = CHUNKED_DEEP_BYTES,
                  devices: list | None = None, mesh=None,
                  ntt_axis: str = "ntt",
                  vk_roots: dict | None = None) -> MachineProof:
    """Prove `chips` as one machine STARK bound to `binding`, with
    Poseidon2 commitments.

    device: where the tensor work runs — the CUDA card by default (raises
    without one), "cpu" for the plain torch versions.  timings: if given,
    receives the seconds of each stage in STAGES (every device used is
    synchronised at each stage boundary).  Under torch.profiler each
    stage, perm trace and constraint-VM run is a named host span
    (utils/spans.py).  spill_bytes, chunked_deep_bytes:
    per-chip byte limits of host spill and chunked DEEP (module docstring;
    0 turns each on for every chip, `float("inf")` off); they change where
    matrices live, never the proof bytes.

    devices: a device list instead of `device` (not both): chips go
    round-robin over it in machine order and FRI runs on devices[0].
    mesh: a parallel.mesh.Mesh; when its `ntt_axis` has more than one
    device, the largest chips' trace LDEs run sharded over that axis.
    Either turns host spill off.  The proof bytes are the single-device
    proof's for any device list and mesh.

    vk_roots: if given, receives each preprocessed chip's root by name,
    the value `preprocessed_root` gives for it, from the tree this prove
    commits anyway."""
    return _prove_machine(POSEIDON2, chips, binding, config, device,
                          timings, spill_bytes, chunked_deep_bytes, devices,
                          mesh, ntt_axis, vk_roots)


def _prove_machine(commitment: Commitment, chips: list[ChipInstance],
                   binding: bytes, config: StarkConfig = DEFAULT_CONFIG,
                   device=None, timings: dict | None = None,
                   spill_bytes: float = SPILL_BYTES,
                   chunked_deep_bytes: float = CHUNKED_DEEP_BYTES,
                   devices: list | None = None, mesh=None,
                   ntt_axis: str = "ntt", vk_roots: dict | None = None):
    """The machine STARK's stages under `commitment`; the other arguments
    are `prove_machine`'s."""
    if devices is not None and device is not None:
        raise ValueError("pass device= or devices=, not both")
    if devices is not None and not devices:
        raise ValueError("devices= must name at least one device")
    devs = [_resolve_device(d) for d in (devices or [device])]
    dev = devs[0]
    lde_sharded = None
    if devices is not None or mesh is not None:
        spill_bytes = float("inf")
    if mesh is not None and mesh.shape.get(ntt_axis, 1) > 1:
        from ..parallel.ntt import make_coset_lde_sharded

        lde_sharded = make_coset_lde_sharded(mesh, ntt_axis)
    # with a device list every chip's tree is dispatched before the first
    # root is read, which would otherwise hold the host on one device
    # while the others idle
    defer = len(devs) > 1
    if not chips:
        raise ValueError("machine proof needs at least one chip")
    names = [c.air.name for c in chips]
    if len(set(names)) != len(names):
        raise ValueError("duplicate chip names in machine proof")

    with Stages(timings, "lde_commit",
                set(devs + (list(mesh.devices.flat) if mesh else []))
                ) as stages:
        # per-chip geometry
        metas = []
        for inst in chips:
            n, w = inst.trace.shape
            log_n = n.bit_length() - 1
            if 1 << log_n != n:
                raise ValueError("trace height must be a power of two")
            if w != inst.air.width:
                raise ValueError(
                    f"{inst.air.name}: trace width {w} != air width "
                    f"{inst.air.width}")
            if inst.air.max_constraint_degree + 1 > config.blowup:
                raise ValueError(
                    f"{inst.air.name}: constraint degree too high")
            pre_w = getattr(inst.air, "preprocessed_width", 0)
            if pre_w:
                if inst.preprocessed is None or \
                        inst.preprocessed.shape != (n, pre_w):
                    raise ValueError(
                        f"{inst.air.name}: preprocessed trace must be "
                        f"({n}, {pre_w})")
            elif inst.preprocessed is not None:
                raise ValueError(
                    f"{inst.air.name}: unexpected preprocessed trace")
            metas.append((inst, log_n))
        metas = _machine_order(metas, lambda m: m[1], lambda m: m[0].air.name)
        log_N_max = metas[0][1] + config.log_blowup
        if (1 << (metas[-1][1] + config.log_blowup)) <= config.fri_final_size:
            raise ValueError(
                "smallest chip domain must exceed fri_final_size; lower "
                "fri_final_size or raise the chip's min trace height")

        # per-chip coset shift: s^(2^k) so the chip's domain coincides with the
        # FRI layer of matching size
        shifts = {}
        for inst, log_n in metas:
            k = log_N_max - (log_n + config.log_blowup)
            shifts[inst.air.name] = pow(config.shift, 1 << k, P)

        # 0. preprocessed commits — fixed columns, committed before the
        # transcript starts; their roots are vk material bound into the header
        # (the verifier checks the openings against the roots it is given).
        # Each chip's work runs on its device, round-robin in machine order.
        per = {}
        for idx, (inst, log_n) in enumerate(metas):
            d = per[inst.air.name] = {"log_n": log_n,
                                      "s": shifts[inst.air.name],
                                      "dev": devs[idx % len(devs)]}
            if inst.preprocessed is not None:
                pre_m = _mont(inst.preprocessed, d["dev"])
                d["pre_m"] = pre_m
                d["pre_lde"] = coset_lde(pre_m, config.log_blowup, d["s"])
                d["pre_tree"] = commitment.commit(d["pre_lde"], defer)
        for inst, log_n in metas:
            d = per[inst.air.name]
            if "pre_tree" in d:
                d["pre_root"] = commitment.root(d["pre_tree"])
                if vk_roots is not None:
                    vk_roots[inst.air.name] = d["pre_root"]

        ch = commitment.challenger()
        _observe_header(
            commitment, ch, binding,
            [(inst.air.name, log_n, [int(v) % P for v in inst.publics],
              per[inst.air.name].get("pre_root"))
             for inst, log_n in metas])

        # 1. main-trace commits; on one device each chip's tree and root are
        # done before the next chip's LDE (serial commits)
        for inst, log_n in metas:
            d = per[inst.air.name]
            trace_m = _mont(inst.trace, d["dev"])
            if lde_sharded is not None and log_n == metas[0][1]:
                lde = lde_sharded(trace_m, config.log_blowup, d["s"])
            else:
                lde = coset_lde(trace_m, config.log_blowup, d["s"])
            d.update(trace_m=trace_m, lde=lde,
                     trace_tree=commitment.commit(lde, defer))
        for inst, log_n in metas:
            d = per[inst.air.name]
            d["trace_root"] = commitment.root(d["trace_tree"])
            commitment.observe_root(ch, d["trace_root"])
            _spill(d, ("lde", "pre_lde"), spill_bytes, d["dev"])
        stages.next("perm_commit")

        # 2. machine challenges + perm commits + bus sums
        challenges = _sample_challenges(ch)
        for inst, log_n in metas:
            d = per[inst.air.name]
            air = inst.air
            n = 1 << log_n
            if air.perm_width:
                kw = ({"preprocessed": inst.preprocessed}
                      if inst.preprocessed is not None else {})
                with span(f"zktls.perm_trace:{air.name}"):
                    perm_m = air.perm_trace_m(
                        inst.trace, d["trace_m"],
                        [int(v) % P for v in inst.publics], challenges, **kw)
                if tuple(perm_m.shape) != (n, air.perm_width):
                    raise ValueError(f"{air.name}: bad perm trace shape")
                perm_trace_paths[
                    "host" if type(air).perm_trace_m is Air.perm_trace_m
                    else "device"] += 1
                perm_lde = coset_lde(perm_m, config.log_blowup, d["s"])
                perm_tree = commitment.commit(perm_lde, defer)
            else:
                perm_m = torch.zeros((n, 0), dtype=bb.DTYPE, device=d["dev"])
                perm_lde = torch.zeros((n << config.log_blowup, 0),
                                       dtype=bb.DTYPE, device=d["dev"])
                perm_tree = None
            d.update(perm_m=perm_m, perm_lde=perm_lde, perm_tree=perm_tree,
                     perm_root=None, bus_sum=[0, 0, 0, 0])
        for inst, log_n in metas:
            d = per[inst.air.name]
            if inst.air.perm_width:
                d["perm_root"] = commitment.root(d["perm_tree"])
                # the accumulator is the LAST extension element of the perm
                # trace; its final row is the chip's cumulative bus sum
                if inst.air.has_bus:
                    d["bus_sum"] = [int(v) for v in bb.np_from_mont(
                        bb.to_numpy(d["perm_m"][-1, -4:]))]
                commitment.observe_root(ch, d["perm_root"])
                ch.observe_many(d["bus_sum"])
            _spill(d, ("lde", "pre_lde", "perm_lde"), spill_bytes, d["dev"])
        stages.next("quotient")

        # 3. quotients
        alpha = ch.sample_ext()
        for inst, log_n in metas:
            d = per[inst.air.name]
            air = inst.air
            n = 1 << log_n
            N = n << config.log_blowup
            s_i = d["s"]
            publics_full = [int(v) % P for v in inst.publics] + d["bus_sum"]
            n_constraints = lower_air(
                air, len(publics_full), len(challenges)).n_constraints
            apow = np_ext_powers(
                alpha, max(n_constraints, 1)).astype(np.uint32)

            sels_np = selector_arrays(log_n, config.log_blowup, s_i)
            sels_m = {k: _mont(sels_np[k], d["dev"])
                      for k in ("is_first_row", "is_last_row",
                                "is_transition")}
            inv_zh_m = _mont(sels_np["inv_z_h"], d["dev"])
            d["sels_np"] = sels_np

            periodic_cols = []
            for pattern in air.periodic_columns():
                s_m = pow(s_i, n // len(pattern), P)
                vals = coset_lde(_mont(np.asarray(pattern, dtype=np.uint32),
                                       d["dev"]), config.log_blowup, s_m)
                periodic_cols.append(vals.repeat(N // vals.shape[0]))
            periodic_stack = (
                torch.stack(periodic_cols, dim=0) if periodic_cols
                else torch.zeros((0, N), dtype=bb.DTYPE, device=d["dev"]))

            with span(f"zktls.constraint_vm:{air.name}"):
                quotient_vals = eval_quotient_vm(
                    air, d["lde"], d["perm_lde"], challenges, publics_full,
                    apow, sels_m, inv_zh_m, periodic_stack, config.log_blowup,
                    pre_lde=d.get("pre_lde"))

            q_coeffs = coset_coeffs(quotient_vals, s_i)
            chunks = [q_coeffs[k * n : (k + 1) * n]
                      for k in range(config.blowup)]
            q_cols = torch.cat(
                [coeffs_to_coset_evals(c, config.log_blowup, s_i)
                 for c in chunks], dim=1)
            d.update(q_cols=q_cols, q_chunks=chunks,
                     q_tree=commitment.commit(q_cols, defer))
        for inst, log_n in metas:
            d = per[inst.air.name]
            d["q_root"] = commitment.root(d["q_tree"])
            commitment.observe_root(ch, d["q_root"])
            _spill(d, ("lde", "pre_lde", "perm_lde", "q_cols"), spill_bytes,
                   d["dev"])
        stages.next("ood_openings")

        # 4. out-of-domain openings
        zeta = ch.sample_ext()
        empty = np.zeros((0, 4), dtype=np.uint32)
        for inst, log_n in metas:
            d = per[inst.air.name]
            n = 1 << log_n
            g_zeta = zeta * two_adic_root(log_n)
            zpows = _zeta_powers(zeta, n, d["dev"])
            gzpows = _zeta_powers(g_zeta, n, d["dev"])
            evals_np = {}
            for key_l, key_n, src in (("tl", "tn", "trace_m"),
                                      ("pl", "pn", "perm_m"),
                                      ("el", "en", "pre_m")):
                if src in d and d[src].shape[1]:
                    coeffs = intt(d[src])
                    evals_np[key_l] = _ext_evals_at(coeffs, zpows)
                    evals_np[key_n] = _ext_evals_at(coeffs, gzpows)
                else:
                    evals_np[key_l] = evals_np[key_n] = empty
            evals_np["qe"] = np.concatenate(
                [_ext_evals_at(c, zpows) for c in d["q_chunks"]], axis=0)
            d["evals"] = {k: [Fp4(*[int(x) for x in row]) for row in arr]
                          for k, arr in evals_np.items()}
            d["evals_np"] = evals_np
            d["g_zeta"] = g_zeta
            for k in ("tl", "tn", "pl", "pn", "qe", "el", "en"):
                for v in d["evals"][k]:
                    ch.observe_ext(v)
            # free what later stages do not read
            for k in ("trace_m", "perm_m", "pre_m", "q_chunks"):
                d.pop(k, None)
        stages.next("deep")

        # 5. DEEP composition per chip, grouped by domain size.  β-power
        # budget, per chip: ζ-group [trace ‖ pre ‖ perm ‖ quotient] then
        # g·ζ-group [trace ‖ pre ‖ perm]
        beta = ch.sample_ext()
        total_terms = 0
        for inst, log_n in metas:
            d = per[inst.air.name]
            w = (inst.air.width + getattr(inst.air, "preprocessed_width", 0)
                 + inst.air.perm_width)
            d["w_z"] = w + int(d["q_cols"].shape[1])
            d["w_gz"] = w
            d["beta_off"] = total_terms
            total_terms += d["w_z"] + d["w_gz"]
        bpow_all = bb.np_to_mont(np_ext_powers(beta, total_terms).astype(
            np.uint32))

        deep_by_log: dict[int, torch.Tensor] = {}
        for inst, log_n in metas:
            d = per[inst.air.name]
            log_N = log_n + config.log_blowup
            N = 1 << log_N
            cdev = d["dev"]
            x_ext = ex.ext_from_base(_mont(d["sels_np"]["x"], cdev))
            zeta_arr = bb.from_numpy(ex.from_fp4(zeta), cdev).expand(N, 4)
            gzeta_arr = bb.from_numpy(
                ex.from_fp4(d["g_zeta"]), cdev).expand(N, 4)
            inv_x_zeta = ex.ext_inv(ex.ext_sub(x_ext, zeta_arr))
            inv_x_gzeta = ex.ext_inv(ex.ext_sub(x_ext, gzeta_arr))
            env = {k: bb.from_numpy(bb.np_to_mont(v), cdev)
                   for k, v in d["evals_np"].items()}
            bslice = bb.from_numpy(
                bpow_all[d["beta_off"] : d["beta_off"] + d["w_z"] + d["w_gz"]],
                cdev)
            pre_lde = d.get("pre_lde",
                            torch.zeros((N, 0), dtype=bb.DTYPE, device=cdev))
            srcs = [(d["lde"], "tl", "tn"), (pre_lde, "el", "en"),
                    (d["perm_lde"], "pl", "pn")]
            if d.get("spilled") or \
                    N * 8 * (d["w_z"] + d["w_gz"]) > chunked_deep_bytes:
                deep = _deep_chunked(
                    [(m, env[z]) for m, z, _ in srcs]
                    + [(d["q_cols"], env["qe"])],
                    [(m, env[gz]) for m, _, gz in srcs],
                    bslice, d["w_z"], inv_x_zeta, inv_x_gzeta)
            else:
                mats = [m for m, _, _ in srcs]
                mat_z = torch.cat(mats + [d["q_cols"]], dim=1)
                mat_gz = torch.cat(mats, dim=1)
                ev_z = torch.cat([env[z] for _, z, _ in srcs] + [env["qe"]])
                ev_gz = torch.cat([env[gz] for _, _, gz in srcs])
                deep = _deep_fn(mat_z, mat_gz, bslice, ev_z, ev_gz, inv_x_zeta,
                                inv_x_gzeta)
                del mat_z, mat_gz
            # the sums and FRI run on the first device
            deep = deep.to(dev)
            if log_N in deep_by_log:
                deep_by_log[log_N] = ex.ext_add(deep_by_log[log_N], deep)
            else:
                deep_by_log[log_N] = deep
        stages.next("fri")

        # 6. mixed-height FRI (host-driven fold loop)
        fri_roots, fri_trees, fri_layers, fri_final = _fri_commit(
            ch, deep_by_log, config, log_N_max, commitment)
        stages.next("queries")

        # 7. grinding + queries
        pow_witness, q_indices = _grind_and_sample(ch, config, log_N_max, dev,
                                                   commitment)

        # gather queried rows per chip (index = q mod N_i), on the device that
        # holds each matrix (the host for a spilled one)
        rows_by_chip = {}
        for inst, log_n in metas:
            d = per[inst.air.name]
            N_i = 1 << (log_n + config.log_blowup)
            idx_np = np.array([q % N_i for q in q_indices], dtype=np.int64)

            def _rows(mat):
                idx = torch.from_numpy(idx_np).to(mat.device)
                return bb.np_from_mont(bb.to_numpy(mat[idx]))

            rows_by_chip[inst.air.name] = {
                "idx": [int(j) for j in idx_np],
                "trace": _rows(d["lde"]),
                "quot": _rows(d["q_cols"]),
                "perm": _rows(d["perm_lde"]) if inst.air.perm_width else None,
                "pre": _rows(d["pre_lde"]) if "pre_lde" in d else None,
            }

        fri_steps = _fri_steps(fri_layers, fri_trees, q_indices, log_N_max,
                               commitment)

        def _opened(rows, tree, qi_pos, j):
            if rows is None:
                return [], []
            return [int(x) for x in rows[qi_pos]], commitment.open(tree, j)

        queries = []
        for qi_pos, q in enumerate(q_indices):
            openings = []
            for inst, log_n in metas:
                d = per[inst.air.name]
                rc = rows_by_chip[inst.air.name]
                j = rc["idx"][qi_pos]
                perm_row, perm_path = _opened(rc["perm"], d["perm_tree"],
                                              qi_pos, j)
                pre_row, pre_path = _opened(rc["pre"], d.get("pre_tree"),
                                            qi_pos, j)
                openings.append(commitment.opening(
                    trace_row=[int(x) for x in rc["trace"][qi_pos]],
                    trace_path=commitment.open(d["trace_tree"], j),
                    quotient_row=[int(x) for x in rc["quot"][qi_pos]],
                    quotient_path=commitment.open(d["q_tree"], j),
                    perm_row=perm_row, perm_path=perm_path,
                    pre_row=pre_row, pre_path=pre_path,
                ))
            queries.append(commitment.query(index=q, openings=openings,
                                            fri_steps=fri_steps[qi_pos]))

    return commitment.proof(
        chips=[commitment.chip_proof(
            name=inst.air.name, log_n=log_n,
            publics=[int(v) % P for v in inst.publics],
            bus_sum=per[inst.air.name]["bus_sum"],
            trace_root=per[inst.air.name]["trace_root"],
            quotient_root=per[inst.air.name]["q_root"],
            perm_root=per[inst.air.name]["perm_root"],
            **per[inst.air.name]["evals"],
        ) for inst, log_n in metas],
        fri_roots=fri_roots,
        fri_final=fri_final,
        pow_witness=pow_witness,
        queries=queries,
    )


def preprocessed_root(air: Air, preprocessed: np.ndarray, log_n_max: int,
                      log_n: int, config: StarkConfig = DEFAULT_CONFIG,
                      device=None) -> list[int]:
    """The vk commitment of a chip's preprocessed matrix: LDE on the chip's
    machine coset (set by its height relative to the machine's largest)
    and Merkle root.  Deterministic — computed once at setup and
    distributed with the verifying key.  device: as `prove_machine`'s."""
    return _preprocessed_root(POSEIDON2, preprocessed, log_n_max, log_n,
                              config, device)


def _preprocessed_root(commitment: Commitment, preprocessed: np.ndarray,
                       log_n_max: int, log_n: int, config: StarkConfig,
                       device):
    dev = _resolve_device(device)
    s_i = pow(config.shift, 1 << (log_n_max - log_n), P)
    pre_lde = coset_lde(_mont(preprocessed, dev), config.log_blowup, s_i)
    return commitment.root(commitment.commit(pre_lde, False))


# ---------------------------------------------------------------------------
# verifier (pure host Python, mirrors the transcript exactly)
# ---------------------------------------------------------------------------


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise VerificationError(what)


def _opens(commitment: Commitment, row: list[int], j: int, path,
           root) -> bool:
    """Whether `path` opens the plain `row` at leaf j under `root`."""
    return commitment.verify_path(
        commitment.leaf_digest([v % P for v in row]), j, path, root)


def verify_machine(airs: list[Air], proof: MachineProof, binding: bytes,
                   public_messages: list[tuple] | None = None,
                   config: StarkConfig = DEFAULT_CONFIG,
                   preprocessed_roots: dict[str, list[int]] | None = None,
                   ) -> bool:
    """Verify a machine proof (host only; no device work).

    public_messages: the verifier-side bus messages, each (tag, payload)
    or (tag, payload, mult).  mult = −1 (default) means the verifier
    RECEIVES the message (a chip must have sent it — e.g. a digest the SHA
    chip published); mult = +1 means the verifier SENDS it.  The global bus
    balance Σ chip bus sums + Σ mult/(γ−fp(msg)) must be zero; any
    missing, extra or altered message breaks it.

    preprocessed_roots: vk material — chip name → Merkle root of the
    chip's FIXED column matrix (`preprocessed_root`).  Required for every
    chip whose air has preprocessed_width > 0; the proof's preprocessed
    openings are checked against these trusted roots, never against
    prover-supplied ones.
    Raises VerificationError on failure; returns True on success.
    """
    return _verify_machine(POSEIDON2, airs, proof, binding, public_messages,
                           config, preprocessed_roots)


def _verify_machine(commitment: Commitment, airs: list[Air], proof,
                    binding: bytes, public_messages: list[tuple] | None,
                    config: StarkConfig, preprocessed_roots: dict | None
                    ) -> bool:
    """The machine verifier under `commitment`; the other arguments are
    `verify_machine`'s."""
    public_messages = public_messages or []
    preprocessed_roots = preprocessed_roots or {}
    air_by_name = {a.name: a for a in airs}
    _check(len(air_by_name) == len(airs), "duplicate airs")
    # multiset equality: a proof must contain EVERY air exactly once
    _check(sorted(c.name for c in proof.chips) == sorted(air_by_name),
           "chip name multiset != air set")
    expect_order = _machine_order(
        proof.chips, lambda c: c.log_n + config.log_blowup,
        lambda c: c.name)
    _check([c.name for c in proof.chips] ==
           [c.name for c in expect_order], "chip order not canonical")

    log_N_max = proof.chips[0].log_n + config.log_blowup
    N_max = 1 << log_N_max
    s = config.shift

    # geometry + shifts
    geo = []
    for cp in proof.chips:
        air = air_by_name[cp.name]
        log_N = cp.log_n + config.log_blowup
        # a chip whose commitment domain does not exceed fri_final_size
        # would never join the FRI walk: reject outright
        _check((1 << log_N) > config.fri_final_size,
               f"{cp.name}: commitment domain (2^{log_N}) must exceed "
               "fri_final_size")
        k = log_N_max - log_N
        s_i = pow(s, 1 << k, P)
        n = 1 << cp.log_n
        _check(len(cp.publics) == air.num_public,
               f"{cp.name}: bad public count")
        _check(len(cp.tl) == air.width and len(cp.tn) == air.width,
               f"{cp.name}: bad trace eval count")
        _check(len(cp.pl) == air.perm_width and
               len(cp.pn) == air.perm_width,
               f"{cp.name}: bad perm eval count")
        _check(len(cp.qe) == 4 * config.blowup,
               f"{cp.name}: bad quotient eval count")
        _check((cp.perm_root is not None) == bool(air.perm_width),
               f"{cp.name}: perm root mismatch")
        _check(len(cp.bus_sum) == 4, f"{cp.name}: bad bus sum")
        if not getattr(air, "has_bus", False):
            _check(cp.bus_sum == [0, 0, 0, 0],
                   f"{cp.name}: non-zero bus sum on busless chip")
        ew = getattr(air, "preprocessed_width", 0)
        _check(len(cp.el) == ew and len(cp.en) == ew,
               f"{cp.name}: bad preprocessed eval count")
        if ew:
            _check(cp.name in preprocessed_roots,
                   f"{cp.name}: verifying key missing preprocessed root")
        geo.append((cp, air, n, log_N, s_i))

    # --- transcript replay -------------------------------------------------
    ch = commitment.challenger()
    _observe_header(commitment, ch, binding,
                    [(cp.name, cp.log_n, cp.publics,
                      preprocessed_roots.get(cp.name))
                     for cp in proof.chips])
    for cp in proof.chips:
        commitment.observe_root(ch, cp.trace_root)
    challenges = _sample_challenges(ch)
    for cp, air, *_ in geo:
        if air.perm_width:
            commitment.observe_root(ch, cp.perm_root)
            ch.observe_many(cp.bus_sum)
    alpha = ch.sample_ext()
    for cp in proof.chips:
        commitment.observe_root(ch, cp.quotient_root)
    zeta = ch.sample_ext()
    for cp in proof.chips:
        for v in (cp.tl + cp.tn + cp.pl + cp.pn + cp.qe + cp.el + cp.en):
            ch.observe_ext(v)
    beta = ch.sample_ext()
    fold_betas = []
    n_layers = 0
    size = N_max
    while size > config.fri_final_size:
        size //= 2
        n_layers += 1
    _check(len(proof.fri_roots) == n_layers, "bad FRI layer count")
    _check(len(proof.fri_final) == size, "bad FRI final size")
    for root in proof.fri_roots:
        commitment.observe_root(ch, root)
        fold_betas.append(ch.sample_ext())
    for v in proof.fri_final:
        ch.observe_ext(v)
    _check(ch.check_witness(config.pow_bits, proof.pow_witness),
           "grinding check failed")
    _check(len(proof.queries) == config.num_queries, "bad query count")
    query_indices = [ch.sample_bits(log_N_max)
                     for _ in range(config.num_queries)]

    # --- global bus balance --------------------------------------------------
    total = Fp4(0)
    for cp in proof.chips:
        total = total + Fp4(*cp.bus_sum)
    for entry in public_messages:
        tag, payload = entry[0], entry[1]
        mult = entry[2] if len(entry) > 2 else -1
        total = total + mult * bus_term(challenges, tag, payload)
    _check(total == Fp4(0), "global bus imbalance")

    # --- per-chip DEEP-ALI constraint identity at ζ -------------------------
    for cp, air, n, log_N, s_i in geo:
        g = two_adic_root(cp.log_n)
        z_h = zeta**n - 1
        g_last = pow(g, n - 1, P)
        sels = {
            "is_first_row": z_h / (zeta - 1),
            "is_last_row": z_h / (zeta - g_last),
            "is_transition": zeta - g_last,
        }
        periodic_at_zeta = [
            _eval_periodic(pattern, zeta, n)
            for pattern in air.periodic_columns()]
        publics_full = list(cp.publics) + list(cp.bus_sum)
        folded = air.fold_constraints_scalar(
            cp.tl, cp.tn, publics_full, sels, alpha,
            periodic=periodic_at_zeta, perm_local=cp.pl, perm_next=cp.pn,
            challenges=challenges, pre_local=cp.el, pre_next=cp.en)
        zeta_n = zeta**n
        q_at_zeta = Fp4(0)
        zpow = Fp4(1)
        for k in range(config.blowup):
            chunk = Fp4(0)
            for ell in range(4):
                chunk = chunk + _EXT_BASIS[ell] * cp.qe[4 * k + ell]
            q_at_zeta = q_at_zeta + zpow * chunk
            zpow = zpow * zeta_n
        _check(folded == z_h * q_at_zeta,
               f"{cp.name}: constraint identity failed at zeta")

    # --- per-query checks ----------------------------------------------------
    # vectorized DEEP prep: global β powers + per-chip eval vectors
    total_terms = 0
    deep_prep = {}
    for cp, air, n, log_N, s_i in geo:
        ew = getattr(air, "preprocessed_width", 0)
        w_z = air.width + ew + air.perm_width + 4 * config.blowup
        w_gz = air.width + ew + air.perm_width
        ev_z = np.array(
            [list(v.c) for v in (cp.tl + cp.el + cp.pl + cp.qe)],
            dtype=np.uint64)
        ev_gz = np.array([list(v.c) for v in (cp.tn + cp.en + cp.pn)],
                         dtype=np.uint64)
        deep_prep[cp.name] = (total_terms, w_z, w_gz, ev_z, ev_gz)
        total_terms += w_z + w_gz
    bpow_np = np_ext_powers(beta, max(total_terms, 1))

    for mq, expect_index in zip(proof.queries, query_indices):
        _check(mq.index == expect_index, "query index mismatch")
        q = mq.index
        _check(len(mq.openings) == len(geo), "bad opening count")
        # Merkle checks + per-chip reduced openings r_i(x) with GLOBAL
        # β-power offsets
        scaled: dict[int, Fp4] = {}
        for (cp, air, n, log_N, s_i), op in zip(geo, mq.openings):
            N_i = 1 << log_N
            j = q % N_i
            pw = air.perm_width
            ew = getattr(air, "preprocessed_width", 0)
            _check(len(op.trace_row) == air.width,
                   f"{cp.name}: bad trace row")
            _check(len(op.quotient_row) == 4 * config.blowup,
                   f"{cp.name}: bad quotient row")
            _check(len(op.perm_row) == pw, f"{cp.name}: bad perm row")
            # a chip without fixed columns opens neither a row nor a path
            _check(len(op.pre_row) == ew and (ew or not op.pre_path),
                   f"{cp.name}: bad preprocessed row")
            _check(_opens(commitment, op.trace_row, j, op.trace_path,
                          cp.trace_root),
                   f"{cp.name}: trace Merkle path failed")
            _check(_opens(commitment, op.quotient_row, j, op.quotient_path,
                          cp.quotient_root),
                   f"{cp.name}: quotient Merkle path failed")
            if pw:
                _check(_opens(commitment, op.perm_row, j, op.perm_path,
                              cp.perm_root),
                       f"{cp.name}: perm Merkle path failed")
            if ew:
                _check(_opens(commitment, op.pre_row, j, op.pre_path,
                              preprocessed_roots[cp.name]),
                       f"{cp.name}: preprocessed Merkle path failed "
                       "(vk root)")
            x = Fp4(s_i * pow(two_adic_root(log_N), j, P) % P)
            g_zeta = zeta * two_adic_root(cp.log_n)
            off, w_z, w_gz, ev_z, ev_gz = deep_prep[cp.name]
            row_z = np.array(
                [v % P for v in (list(op.trace_row) + list(op.pre_row)
                                 + list(op.perm_row)
                                 + list(op.quotient_row))],
                dtype=np.uint64)
            diff_z = (P - ev_z) % P
            diff_z[:, 0] = (diff_z[:, 0] + row_z) % P
            terms = np_ext_mul(bpow_np[off : off + w_z], diff_z)
            num_z = Fp4(*[int(v) for v in terms.sum(axis=0) % P])
            diff_gz = (P - ev_gz) % P
            diff_gz[:, 0] = (diff_gz[:, 0] + row_z[:w_gz]) % P
            terms = np_ext_mul(bpow_np[off + w_z : off + w_z + w_gz],
                               diff_gz)
            num_gz = Fp4(*[int(v) for v in terms.sum(axis=0) % P])
            r = num_z / (x - zeta) + num_gz / (x - g_zeta)
            scaled[log_N] = scaled.get(log_N, Fp4(0)) + r
        # FRI walk with joiners
        v = Fp4(0)
        qq = q
        cur_shift = s
        for ell, (pair, path) in enumerate(mq.fri_steps):
            log_l = log_N_max - ell
            if log_l in scaled:
                v = v + scaled[log_l]
            half = (1 << log_l) // 2
            j = qq % half
            row = [c for val in pair for c in val.c]
            _check(_opens(commitment, row, j, path, proof.fri_roots[ell]),
                   f"FRI layer {ell} Merkle path failed")
            mine = pair[0] if qq < half else pair[1]
            _check(mine == v, f"FRI layer {ell} value mismatch")
            x_j = Fp4(cur_shift * pow(two_adic_root(log_l), j, P) % P)
            a, b_ = pair
            v = (a + b_) / 2 + fold_betas[ell] * (a - b_) / (2 * x_j)
            cur_shift = cur_shift * cur_shift % P
            qq = j
        _check(v == proof.fri_final[qq], "FRI final value mismatch")

    _final_low_degree(proof.fri_final, config, log_N_max, n_layers)
    return True
