"""The machine STARK with BN254-friendly (MP-MiMC) commitments — the
shrink layer.

The reference's proof chain ends in a layer whose verifier is cheap
inside a BN254 SNARK circuit (SP1: shrink → wrap over BN254 via gnark;
risc0: identity_p254 → circom/rapidsnark — SURVEY.md §2.2.B/C).  This
module is that layer: the SAME machine STARK semantics as
stark/machine.py (Baby-Bear field, chips, LogUp bus, mixed-height batch
FRI) but every commitment and every Fiat-Shamir step runs over MP-MiMC in
the BN254 scalar field (stark/commit_bn.py), so a Groth16 wrap circuit
pays ~330 constraints per hash instead of tens of thousands.

Port of zktls_tpu.stark.machine_bn: the proof format, the transcript and
every observation are the reference's, so `MachineProofBN.to_bytes()`
equals the reference's byte for byte on the same input and each
package's `verify_machine_bn` accepts the other's proofs.  Port choices:
`prove_machine_bn` runs its tensor work (coset LDEs, the constraint-VM
quotient, OOD evaluations, DEEP, FRI folds) on the caller's device
through the port's own ops, as `prove_machine` does — the CUDA card
unless told otherwise — and hashes every matrix on the host through the
C MiMC (`MimcTree`), converted out of Montgomery form on the device
first; `timings=` gets the stages of `machine.STAGES`, the seconds inside
`MimcTree` (`mimc_s`) and the reference's `prove_bn_s`.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core import cbor
from ..ops import babybear as bb
from ..ops import ext as ex
from ..ops.field_ref import Fp4, P, two_adic_root
from ..ops.ntt import coeffs_to_coset_evals, coset_coeffs, coset_lde, intt
from ..utils.spans import Stages
from .air import Air
from .bus import MAX_PAYLOAD, bus_term, delta_powers
from .commit_bn import FrChallenger, MimcTree, grind_bn, leaf_digest, \
    verify_path_bn
from .config import DEFAULT_CONFIG, StarkConfig, selector_arrays
from .lookup import np_ext_mul, np_ext_powers
from .lowering import eval_quotient_vm, lower_air
from .machine import ChipInstance, _machine_order, _mont, _resolve_device
from .prover import _deep_fn, _ext_evals_at, _fold_layer, _inv_2x, \
    _pair_rows, _zeta_powers
from .verifier import VerificationError, _eval_periodic, _final_low_degree

__all__ = ["ChipProofBN", "ChipOpeningBN", "MachineQueryBN",
           "MachineProofBN", "prove_machine_bn", "verify_machine_bn",
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
    fri_steps: list[tuple]       # ((Fp4, Fp4), path: list[int])


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


_EXT_BASIS = [Fp4(1), Fp4(0, 1), Fp4(0, 0, 1), Fp4(0, 0, 0, 1)]


def _observe_header_bn(ch: FrChallenger, binding: bytes, entries) -> None:
    ch.observe_bytes(BN_DOMAIN_TAG)
    ch.observe_bytes(binding)
    ch.observe(len(entries))
    for entry in entries:
        name, log_n, publics = entry[0], entry[1], entry[2]
        pre_root = entry[3] if len(entry) > 3 else None
        ch.observe_bytes(name.encode())
        ch.observe(log_n)
        ch.observe(len(publics))
        ch.observe_many(publics)
        if pre_root is not None:
            ch.observe_fr(pre_root)


def _sample_challenges_bn(ch: FrChallenger) -> list[Fp4]:
    gamma = ch.sample_ext()
    delta = ch.sample_ext()
    return [gamma] + delta_powers(delta, MAX_PAYLOAD)


def preprocessed_root_bn(air: Air, preprocessed: np.ndarray,
                         log_n_max: int, log_n: int,
                         config: StarkConfig = DEFAULT_CONFIG,
                         device=None) -> int:
    """The BN vk commitment of a chip's fixed matrix (MiMC tree over its
    machine-coset LDE).  device: where the LDE runs (`prove_machine_bn`'s
    rule)."""
    dev = _resolve_device(device)
    k = log_n_max - log_n
    s_i = pow(config.shift, 1 << k, P)
    lde = coset_lde(_mont(preprocessed, dev), config.log_blowup, s_i)
    return MimcTree(bb.to_plain_numpy(lde, _HOST_ROWS)).root


def prove_machine_bn(chips: list[ChipInstance], binding: bytes,
                     config: StarkConfig = DEFAULT_CONFIG,
                     timings: dict | None = None,
                     device=None,
                     vk_roots: dict | None = None) -> MachineProofBN:
    """Prove the chip set with BN254/MiMC commitments.  Semantics mirror
    prove_machine (stark/machine.py) step for step; only the commitment
    scheme and the challenger differ.

    device: where the tensor work runs — the CUDA card by default (raises
    without one), "cpu" for the plain torch versions.  timings: if given,
    receives the seconds of each stage of `machine.STAGES` (the device is
    synchronised at each stage boundary), `mimc_s` (inside `MimcTree`, on
    the host) and `prove_bn_s` (the whole prove).  vk_roots: if given,
    receives each preprocessed chip's root by name, the value
    `preprocessed_root_bn` gives for it, from the tree this prove commits
    anyway."""
    dev = _resolve_device(device)
    t0 = time.perf_counter()
    with Stages(timings, "lde_commit", [dev]) as stages:
        mimc_s = [0.0]

        def _tree(mat: torch.Tensor) -> tuple[np.ndarray, MimcTree]:
            """(the plain host matrix, its MiMC tree)."""
            host = bb.to_plain_numpy(mat, _HOST_ROWS)
            t = time.perf_counter()
            tree = MimcTree(host)
            mimc_s[0] += time.perf_counter() - t
            return host, tree

        metas = []
        for inst in chips:
            n, w = inst.trace.shape
            log_n = n.bit_length() - 1
            if 1 << log_n != n or w != inst.air.width:
                raise ValueError(f"{inst.air.name}: bad trace shape")
            pre_w = getattr(inst.air, "preprocessed_width", 0)
            if pre_w and (inst.preprocessed is None
                          or inst.preprocessed.shape != (n, pre_w)):
                raise ValueError(f"{inst.air.name}: bad preprocessed shape")
            metas.append((inst, log_n))
        metas = _machine_order(metas, lambda m: m[1], lambda m: m[0].air.name)
        log_N_max = metas[0][1] + config.log_blowup
        shifts = {}
        for inst, log_n in metas:
            k = log_N_max - (log_n + config.log_blowup)
            shifts[inst.air.name] = pow(config.shift, 1 << k, P)

        # preprocessed commits (vk material)
        per: dict[str, dict] = {}
        for inst, log_n in metas:
            name = inst.air.name
            d = {"inst": inst, "log_n": log_n, "s": shifts[name]}
            if getattr(inst.air, "preprocessed_width", 0):
                d["pre_m"] = _mont(inst.preprocessed, dev)
                d["pre_lde_dev"] = coset_lde(d["pre_m"], config.log_blowup,
                                             shifts[name])
                d["pre_lde"], d["pre_tree"] = _tree(d["pre_lde_dev"])
                if vk_roots is not None:
                    vk_roots[name] = d["pre_tree"].root
            per[name] = d

        ch = FrChallenger()
        _observe_header_bn(
            ch, binding,
            [(inst.air.name, log_n, [int(v) % P for v in inst.publics],
              per[inst.air.name].get("pre_tree") and
              per[inst.air.name]["pre_tree"].root)
             for inst, log_n in metas])

        # 1. trace commits
        for inst, log_n in metas:
            d = per[inst.air.name]
            d["trace_m"] = _mont(inst.trace, dev)
            d["lde_dev"] = coset_lde(d["trace_m"], config.log_blowup, d["s"])
            d["lde"], d["trace_tree"] = _tree(d["lde_dev"])
        for inst, log_n in metas:
            ch.observe_fr(per[inst.air.name]["trace_tree"].root)
        stages.next("perm_commit")

        # 2. machine challenges + perm commits + bus sums
        challenges = _sample_challenges_bn(ch)
        for inst, log_n in metas:
            d = per[inst.air.name]
            air = inst.air
            n = 1 << log_n
            if air.perm_width:
                kw = ({"preprocessed": inst.preprocessed}
                      if inst.preprocessed is not None else {})
                perm_np = air.generate_perm_trace(
                    inst.trace, [int(v) % P for v in inst.publics],
                    challenges, **kw)
                d["perm_m"] = _mont(perm_np, dev)
                d["perm_lde_dev"] = coset_lde(d["perm_m"], config.log_blowup,
                                              d["s"])
                d["perm_lde"], d["perm_tree"] = _tree(d["perm_lde_dev"])
                bus_sum = ([int(v) for v in perm_np[-1, -4:]]
                           if getattr(air, "has_bus", False) else [0, 0, 0, 0])
            else:
                d["perm_m"] = torch.zeros((n, 0), dtype=bb.DTYPE, device=dev)
                d["perm_lde_dev"] = torch.zeros((n << config.log_blowup, 0),
                                                dtype=bb.DTYPE, device=dev)
                d["perm_lde"] = np.zeros((n << config.log_blowup, 0),
                                         np.uint32)
                d["perm_tree"] = None
                bus_sum = [0, 0, 0, 0]
            d["bus_sum"] = bus_sum
        for inst, log_n in metas:
            d = per[inst.air.name]
            if inst.air.perm_width:
                ch.observe_fr(d["perm_tree"].root)
                ch.observe_many(d["bus_sum"])
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
            sels_m = {k: _mont(sels_np[k], dev)
                      for k in ("is_first_row", "is_last_row",
                                "is_transition")}
            inv_zh_m = _mont(sels_np["inv_z_h"], dev)
            d["sels_np"] = sels_np
            periodic_cols = []
            for pattern in air.periodic_columns():
                s_m = pow(s_i, n // len(pattern), P)
                vals = coset_lde(_mont(np.asarray(pattern, dtype=np.uint32),
                                       dev), config.log_blowup, s_m)
                periodic_cols.append(vals.repeat(N // vals.shape[0]))
            periodic_stack = (
                torch.stack(periodic_cols, dim=0) if periodic_cols
                else torch.zeros((0, N), dtype=bb.DTYPE, device=dev))
            quotient_vals = eval_quotient_vm(
                air, d["lde_dev"], d["perm_lde_dev"], challenges, publics_full,
                apow, sels_m, inv_zh_m, periodic_stack, config.log_blowup,
                pre_lde=d.get("pre_lde_dev"))
            q_coeffs = coset_coeffs(quotient_vals, s_i)
            chunks = [q_coeffs[k * n : (k + 1) * n]
                      for k in range(config.blowup)]
            d["q_cols_dev"] = torch.cat(
                [coeffs_to_coset_evals(c, config.log_blowup, s_i)
                 for c in chunks], dim=1)
            d["q_chunks"] = chunks
            d["q_cols"], d["q_tree"] = _tree(d["q_cols_dev"])
        for inst, log_n in metas:
            ch.observe_fr(per[inst.air.name]["q_tree"].root)
        stages.next("ood_openings")

        # 4. OOD openings
        zeta = ch.sample_ext()
        empty = np.zeros((0, 4), dtype=np.uint32)
        for inst, log_n in metas:
            d = per[inst.air.name]
            n = 1 << log_n
            g_zeta = zeta * two_adic_root(log_n)
            zpows = _zeta_powers(zeta, n, dev)
            gzpows = _zeta_powers(g_zeta, n, dev)
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

        # 5. DEEP: per chip, ζ-group [trace ‖ pre ‖ perm ‖ quotient] then
        # g·ζ-group [trace ‖ pre ‖ perm]
        beta = ch.sample_ext()
        total_terms = 0
        for inst, log_n in metas:
            d = per[inst.air.name]
            ew = getattr(inst.air, "preprocessed_width", 0)
            d["w_z"] = (inst.air.width + ew + inst.air.perm_width
                        + int(d["q_cols"].shape[1]))
            d["w_gz"] = inst.air.width + ew + inst.air.perm_width
            d["beta_off"] = total_terms
            total_terms += d["w_z"] + d["w_gz"]
        bpow_all = bb.np_to_mont(np_ext_powers(beta, total_terms).astype(
            np.uint32))
        deep_by_log: dict[int, torch.Tensor] = {}
        for inst, log_n in metas:
            d = per[inst.air.name]
            log_N = log_n + config.log_blowup
            N = 1 << log_N
            x_ext = ex.ext_from_base(_mont(d["sels_np"]["x"], dev))
            zeta_arr = bb.from_numpy(ex.from_fp4(zeta), dev).expand(N, 4)
            gzeta_arr = bb.from_numpy(
                ex.from_fp4(d["g_zeta"]), dev).expand(N, 4)
            inv_x_zeta = ex.ext_inv(ex.ext_sub(x_ext, zeta_arr))
            inv_x_gzeta = ex.ext_inv(ex.ext_sub(x_ext, gzeta_arr))
            pre_dev = d.get("pre_lde_dev",
                            torch.zeros((N, 0), dtype=bb.DTYPE, device=dev))
            mats = [d["lde_dev"], pre_dev, d["perm_lde_dev"]]
            mat_z = torch.cat(mats + [d["q_cols_dev"]], dim=1)
            mat_gz = torch.cat(mats, dim=1)
            env = d["evals_np"]
            ev_z = bb.from_numpy(bb.np_to_mont(np.concatenate(
                [env["tl"], env["el"], env["pl"], env["qe"]],
                axis=0).astype(np.uint32)), dev)
            ev_gz = bb.from_numpy(bb.np_to_mont(np.concatenate(
                [env["tn"], env["en"], env["pn"]], axis=0).astype(np.uint32)),
                dev)
            bslice = bb.from_numpy(
                bpow_all[d["beta_off"] : d["beta_off"] + d["w_z"] + d["w_gz"]],
                dev)
            deep = _deep_fn(mat_z, mat_gz, bslice, ev_z, ev_gz, inv_x_zeta,
                            inv_x_gzeta)
            del mat_z, mat_gz
            if log_N in deep_by_log:
                deep_by_log[log_N] = ex.ext_add(deep_by_log[log_N], deep)
            else:
                deep_by_log[log_N] = deep
        stages.next("fri")

        # 6. FRI (host challenger, MiMC layer trees)
        fri_roots: list[int] = []
        fri_trees: list[MimcTree] = []
        fri_layers: list[np.ndarray] = []
        cur = deep_by_log[log_N_max]
        cur_shift = config.shift
        cur_log = log_N_max
        while (1 << cur_log) > config.fri_final_size:
            rows, tree = _tree(_pair_rows(cur))
            fri_trees.append(tree)
            fri_roots.append(tree.root)
            fri_layers.append(rows)
            ch.observe_fr(tree.root)
            beta_l = ch.sample_ext()
            cur = _fold_layer(cur, beta_l, _inv_2x(cur_log, cur_shift))
            cur_shift = cur_shift * cur_shift % P
            cur_log -= 1
            if cur_log in deep_by_log:
                cur = ex.ext_add(cur, deep_by_log[cur_log])
        final_plain = bb.to_plain_numpy(cur, _HOST_ROWS)
        fri_final = [Fp4(*[int(x) for x in row]) for row in final_plain]
        for v in fri_final:
            ch.observe_ext(v)
        stages.next("queries")

        # 7. grinding + queries
        pow_witness = 0
        if config.pow_bits:
            pow_witness = grind_bn(ch, config.pow_bits)
        ch.check_witness(config.pow_bits, pow_witness)
        q_indices = [ch.sample_bits(log_N_max)
                     for _ in range(config.num_queries)]

        queries = []
        for q in q_indices:
            openings = []
            for inst, log_n in metas:
                d = per[inst.air.name]
                N_i = 1 << (log_n + config.log_blowup)
                j = q % N_i
                openings.append(ChipOpeningBN(
                    trace_row=[int(x) for x in d["lde"][j]],
                    trace_path=d["trace_tree"].open(j),
                    quotient_row=[int(x) for x in d["q_cols"][j]],
                    quotient_path=d["q_tree"].open(j),
                    perm_row=([int(x) for x in d["perm_lde"][j]]
                              if inst.air.perm_width else []),
                    perm_path=(d["perm_tree"].open(j)
                               if d["perm_tree"] is not None else []),
                    pre_row=([int(x) for x in d["pre_lde"][j]]
                             if "pre_lde" in d else []),
                    pre_path=(d["pre_tree"].open(j)
                              if "pre_tree" in d else []),
                ))
            steps = []
            qq = q
            for ell, rows in enumerate(fri_layers):
                half = rows.shape[0]
                j = qq % half
                pair = (Fp4(*[int(x) for x in rows[j][:4]]),
                        Fp4(*[int(x) for x in rows[j][4:]]))
                steps.append((pair, fri_trees[ell].open(j)))
                qq = j
            queries.append(MachineQueryBN(index=q, openings=openings,
                                          fri_steps=steps))
    if timings is not None:
        timings["mimc_s"] = timings.get("mimc_s", 0.0) + mimc_s[0]
        timings["prove_bn_s"] = round(time.perf_counter() - t0, 3)

    return MachineProofBN(
        chips=[ChipProofBN(
            name=inst.air.name, log_n=log_n,
            publics=[int(v) % P for v in inst.publics],
            bus_sum=per[inst.air.name]["bus_sum"],
            trace_root=per[inst.air.name]["trace_tree"].root,
            quotient_root=per[inst.air.name]["q_tree"].root,
            perm_root=(per[inst.air.name]["perm_tree"].root
                       if per[inst.air.name]["perm_tree"] is not None
                       else None),
            **per[inst.air.name]["evals"],
        ) for inst, log_n in metas],
        fri_roots=fri_roots,
        fri_final=fri_final,
        pow_witness=pow_witness,
        queries=queries,
    )


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise VerificationError(what)


def verify_machine_bn(airs: list[Air], proof: MachineProofBN,
                      binding: bytes,
                      public_messages: list[tuple] | None = None,
                      config: StarkConfig = DEFAULT_CONFIG,
                      preprocessed_roots: dict[str, int] | None = None,
                      ) -> bool:
    """Verify a BN-committed machine proof — the computation the Groth16
    wrap circuit arithmetizes (snark/stark_wrap.py mirrors this function
    gate for gate)."""
    public_messages = public_messages or []
    preprocessed_roots = preprocessed_roots or {}
    air_by_name = {a.name: a for a in airs}
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
    geo = []
    for cp in proof.chips:
        air = air_by_name[cp.name]
        log_N = cp.log_n + config.log_blowup
        _check((1 << log_N) > config.fri_final_size,
               f"{cp.name}: domain below fri_final_size")
        k = log_N_max - log_N
        s_i = pow(s, 1 << k, P)
        n = 1 << cp.log_n
        ew = getattr(air, "preprocessed_width", 0)
        _check(len(cp.publics) == air.num_public and
               len(cp.tl) == air.width and len(cp.tn) == air.width and
               len(cp.pl) == air.perm_width and
               len(cp.pn) == air.perm_width and
               len(cp.qe) == 4 * config.blowup and
               len(cp.el) == ew and len(cp.en) == ew and
               (cp.perm_root is not None) == bool(air.perm_width) and
               len(cp.bus_sum) == 4, f"{cp.name}: bad proof shape")
        if ew:
            _check(cp.name in preprocessed_roots,
                   f"{cp.name}: vk missing preprocessed root")
        if not getattr(air, "has_bus", False):
            _check(cp.bus_sum == [0, 0, 0, 0],
                   f"{cp.name}: bus sum on busless chip")
        geo.append((cp, air, n, log_N, s_i))

    ch = FrChallenger()
    _observe_header_bn(ch, binding,
                       [(cp.name, cp.log_n, cp.publics,
                         preprocessed_roots.get(cp.name))
                        for cp in proof.chips])
    for cp in proof.chips:
        ch.observe_fr(cp.trace_root)
    challenges = _sample_challenges_bn(ch)
    for cp, air, *_ in geo:
        if air.perm_width:
            ch.observe_fr(cp.perm_root)
            ch.observe_many(cp.bus_sum)
    alpha = ch.sample_ext()
    for cp in proof.chips:
        ch.observe_fr(cp.quotient_root)
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
        ch.observe_fr(root)
        fold_betas.append(ch.sample_ext())
    for v in proof.fri_final:
        ch.observe_ext(v)
    _check(ch.check_witness(config.pow_bits, proof.pow_witness),
           "grinding check failed")
    _check(len(proof.queries) == config.num_queries, "bad query count")
    query_indices = [ch.sample_bits(log_N_max)
                     for _ in range(config.num_queries)]

    # global bus balance
    total = Fp4(0)
    for cp in proof.chips:
        total = total + Fp4(*cp.bus_sum)
    for entry in public_messages:
        tag, payload = entry[0], entry[1]
        mult = entry[2] if len(entry) > 2 else -1
        total = total + mult * bus_term(challenges, tag, payload)
    _check(total == Fp4(0), "global bus imbalance")

    # DEEP-ALI identity at ζ
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
        scaled: dict[int, Fp4] = {}
        for (cp, air, n, log_N, s_i), op in zip(geo, mq.openings):
            N_i = 1 << log_N
            j = q % N_i
            w = air.width
            pw = air.perm_width
            ew = getattr(air, "preprocessed_width", 0)
            _check(len(op.trace_row) == w and
                   len(op.quotient_row) == 4 * config.blowup and
                   len(op.perm_row) == pw and len(op.pre_row) == ew,
                   f"{cp.name}: bad opened row")
            _check(verify_path_bn(
                leaf_digest([v % P for v in op.trace_row]), j,
                op.trace_path, cp.trace_root),
                f"{cp.name}: trace path failed")
            _check(verify_path_bn(
                leaf_digest([v % P for v in op.quotient_row]), j,
                op.quotient_path, cp.quotient_root),
                f"{cp.name}: quotient path failed")
            if pw:
                _check(verify_path_bn(
                    leaf_digest([v % P for v in op.perm_row]), j,
                    op.perm_path, cp.perm_root),
                    f"{cp.name}: perm path failed")
            if ew:
                _check(verify_path_bn(
                    leaf_digest([v % P for v in op.pre_row]), j,
                    op.pre_path, preprocessed_roots[cp.name]),
                    f"{cp.name}: preprocessed path failed (vk root)")
            x = Fp4(s_i * pow(two_adic_root(log_N), j, P) % P)
            g = two_adic_root(cp.log_n)
            g_zeta = zeta * g
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
            row_gz = row_z[: w_gz]
            diff_gz = (P - ev_gz) % P
            diff_gz[:, 0] = (diff_gz[:, 0] + row_gz) % P
            terms = np_ext_mul(bpow_np[off + w_z : off + w_z + w_gz],
                               diff_gz)
            num_gz = Fp4(*[int(v) for v in terms.sum(axis=0) % P])
            r = num_z / (x - zeta) + num_gz / (x - g_zeta)
            scaled[log_N] = scaled.get(log_N, Fp4(0)) + r
        v = Fp4(0)
        qq = q
        cur_shift = s
        for ell, (pair, path) in enumerate(mq.fri_steps):
            log_l = log_N_max - ell
            size_l = 1 << log_l
            if log_l in scaled:
                v = v + scaled[log_l]
            half = size_l // 2
            j = qq % half
            row = [c for val in pair for c in val.c]
            _check(verify_path_bn(leaf_digest(row), j, path,
                                  proof.fri_roots[ell]),
                   f"FRI layer {ell} path failed")
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
