"""The uni-STARK prover: trace -> proof, with all field-parallel work on
the device (the CUDA card unless the caller asks for the CPU).

Port of zktls_tpu.stark.prover.  Pipeline (replacing the reference's
per-shard core STARK, SURVEY.md §3.2/§3.3 "trace gen → Merkle commit →
quotient → FRI"):

  1. LDE-commit the trace on the coset shift·H_N (Poseidon2 Merkle);
  2. fold all AIR constraints with powers of α (sampled by the Poseidon2
     duplex challenger) and divide by Z_H pointwise → quotient, through
     the constraint VM (stark/lowering.py);
  3. split the quotient into `blowup` degree-<n chunks, commit;
  4. open everything at the out-of-domain point ζ (and g·ζ for next-row
     values) via coefficient-form evaluation;
  5. build the DEEP composition polynomial and run FRI (fold-by-2 with
     pair-leaf Merkle commitments per layer) down to a small final layer;
  6. grind the optional proof-of-work and answer Fiat-Shamir queries with
     Merkle openings.

The helpers below (out-of-domain evaluation, the DEEP composition, the FRI
fold loop, grinding and the query draws, the FRI openings) serve the
machine prover (stark/machine.py) too.  Field
tensors are Montgomery form (ops/babybear.py); host values are plain ints
and Fp4.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import babybear as bb
from ..ops import ext as ex
from ..ops.field_ref import Fp4, P, two_adic_root
from ..ops.merkle import MerkleTree
from ..ops.ntt import (
    coeffs_to_coset_evals,
    coset_coeffs,
    coset_lde,
    eval_domain,
    intt,
    np_batch_inverse,
)
from ..ops.poseidon2 import permute_batch
from ..utils.spans import Stages
from .air import Air
from .challenger import Challenger
from .config import DEFAULT_CONFIG, StarkConfig, selector_arrays
from .lookup import np_ext_powers
from .proof import FriStep, QueryProof, StarkProof

__all__ = ["prove"]


def _ext_evals_at(coeffs: torch.Tensor, zpows: torch.Tensor) -> np.ndarray:
    """Evaluate base-coefficient polynomials at an extension point.
    coeffs (n, C) Montgomery, zpows (n, 4) Montgomery powers of the point.
    Returns (C, 4) plain-form numpy."""
    out = torch.stack([bb.dot_mod(coeffs, zpows[:, ell : ell + 1], dim=0)
                       for ell in range(4)], dim=-1)
    return bb.np_from_mont(bb.to_numpy(out))


def _zeta_powers(zeta: Fp4, n: int, device) -> torch.Tensor:
    """(n, 4) Montgomery powers [1, ζ, …, ζ^{n−1}] on `device`."""
    return bb.from_numpy(bb.np_to_mont(np_ext_powers(zeta, n).astype(
        np.uint32)), device)


def _pair_rows(values: torch.Tensor) -> torch.Tensor:
    """FRI layer values (N, 4) -> Merkle rows (N/2, 8): leaf j holds
    (f[j], f[j+N/2])."""
    half = values.shape[0] // 2
    return torch.cat([values[:half], values[half:]], dim=1)


_INV2_M = pow(2, P - 2, P) * bb.MONT_R % P


def _fold(values: torch.Tensor, beta_m: torch.Tensor,
          inv_2x_m: torch.Tensor) -> torch.Tensor:
    """One FRI fold on tensors: f'(x²) = (f(x)+f(−x))/2 + β·(f(x)−f(−x))/(2x),
    β a (4,) and 1/(2x) an (N/2,) Montgomery tensor."""
    half = values.shape[0] // 2
    a, b = values[:half], values[half:]
    even = ex.ext_scale(ex.ext_add(a, b), _INV2_M)
    odd = ex.ext_scale(ex.ext_sub(a, b), inv_2x_m)
    return ex.ext_add(even, ex.ext_mul(beta_m.expand(half, 4), odd))


def _fold_layer(values: torch.Tensor, beta: Fp4, inv_2x: np.ndarray
                ) -> torch.Tensor:
    """`_fold` with β an Fp4 and 1/(2x) a Montgomery numpy array."""
    dev = values.device
    return _fold(values, bb.from_numpy(ex.from_fp4(beta), dev),
                 bb.from_numpy(inv_2x, dev))


def _deep_fn(mat_z: torch.Tensor, mat_gz: torch.Tensor,
             bpow_m: torch.Tensor, ev_z: torch.Tensor, ev_gz: torch.Tensor,
             inv_x_zeta: torch.Tensor, inv_x_gzeta: torch.Tensor
             ) -> torch.Tensor:
    """DEEP composition in matvec form:

      Σ_j β^j (V_j(x) − v_j)  =  (Σ_j β^j V_j(x))  −  (Σ_j β^j v_j)

    so each opening group costs 4 modular matvecs (one per extension limb)
    plus a broadcast constant.  The ζ-group matrix is [trace ‖ perm ‖
    quotient] columns, the g·ζ-group is [trace ‖ perm].  bpow_m holds the
    ζ-group's β powers, then the g·ζ-group's."""
    w_z = mat_z.shape[1]

    def group_numer(mat, betas, evals):
        comb = torch.stack([bb.dot_mod(mat, betas[None, :, ell], dim=1)
                            for ell in range(4)], dim=-1)      # (N, 4)
        const = bb.sum_mod(ex.ext_mul(betas, evals), dim=0)    # (4,)
        return ex.ext_sub(comb, const[None, :])

    numer_z = group_numer(mat_z, bpow_m[:w_z], ev_z)
    numer_gz = group_numer(mat_gz, bpow_m[w_z:], ev_gz)
    return ex.ext_add(ex.ext_mul(numer_z, inv_x_zeta),
                      ex.ext_mul(numer_gz, inv_x_gzeta))


def _grind_device(ch: Challenger, pow_bits: int, device) -> int:
    """Proof-of-work grinding, batched: try candidate witnesses in one
    permutation batch instead of a sequential host loop.  Mirrors
    Challenger.observe(w); sample_bits(pow_bits) == 0: the candidate joins
    the pending input buffer, the duplex permutes, and the check reads rate
    lane 7 (the first popped output).  Returns the first passing candidate
    in batch order."""
    base = np.array(ch.state, dtype=np.uint32)
    buf = [v % P for v in ch.input_buf]
    if len(buf) >= 8:
        raise AssertionError("challenger buffer cannot be full here")
    batch = 1 << min(pow_bits + 3, 18)
    mask = (1 << pow_bits) - 1
    offset = 0
    # Expected tries ≈ 2^pow_bits; needing more than 2^(pow_bits+16) has
    # probability ~e^-65536 — treat it as a bug, not luck.
    max_offset = 1 << (pow_bits + 16)
    while offset < max_offset:
        states = np.tile(base, (batch, 1))
        if buf:
            states[:, : len(buf)] = np.array(buf, dtype=np.uint32)
        cands = (np.arange(batch, dtype=np.uint64) + offset) % P
        states[:, len(buf)] = cands.astype(np.uint32)
        out = bb.np_from_mont(bb.to_numpy(permute_batch(
            bb.from_numpy(bb.np_to_mont(states), device))))
        hits = np.nonzero((out[:, 7] & mask) == 0)[0]
        if hits.size:
            return int(cands[hits[0]])
        offset += batch
    raise AssertionError(
        f"grinding found no witness in 2^{pow_bits + 16} tries — "
        "challenger/permute mismatch, not bad luck")


def _inv_2x(log_size: int, shift: int) -> np.ndarray:
    """Montgomery (N/2,) array of 1/(2·x_j) for the layer domain."""
    xs = eval_domain(log_size, shift)[: (1 << log_size) // 2]
    invs = np_batch_inverse(2 * xs.astype(np.uint64) % P)
    return bb.np_to_mont(invs.astype(np.uint32))


def _mont(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Plain uint32 numpy -> Montgomery field tensor on `dev`."""
    return bb.to_mont(bb.from_numpy(arr, dev))


def _fp4_rows(arr: np.ndarray) -> list[Fp4]:
    return [Fp4(*[int(x) for x in row]) for row in arr]


def _fri_commit(ch, deep_by_log: dict, config: StarkConfig, log_N: int,
                commitment):
    """The FRI commit phase, driven from the host: commit each layer (pair
    leaves) under `commitment` (a machine.Commitment), absorb its root,
    sample β, fold; the DEEP polynomial of a shorter height
    (`deep_by_log[log]`, a mixed-height machine's) joins the chain where
    the fold reaches it.  Absorbs the final layer.
    Returns (roots, trees, layers, final values as Fp4)."""
    roots = []
    trees = []
    layers: list[torch.Tensor] = []
    cur = deep_by_log[log_N]
    cur_shift = config.shift
    cur_log = log_N
    while (1 << cur_log) > config.fri_final_size:
        tree = commitment.commit(_pair_rows(cur), False)
        root = commitment.root(tree)
        trees.append(tree)
        roots.append(root)
        layers.append(cur)
        commitment.observe_root(ch, root)
        beta_l = ch.sample_ext()
        cur = _fold_layer(cur, beta_l, _inv_2x(cur_log, cur_shift))
        cur_shift = cur_shift * cur_shift % P
        cur_log -= 1
        if cur_log in deep_by_log:
            cur = ex.ext_add(cur, deep_by_log[cur_log])
    final = _fp4_rows(bb.np_from_mont(bb.to_numpy(cur)))
    for v in final:
        ch.observe_ext(v)
    return roots, trees, layers, final


def _grind_and_sample(ch, config: StarkConfig, log_N: int, device,
                      commitment) -> tuple[int, list[int]]:
    """Grind the proof-of-work witness (`commitment.grind`), then draw the
    query indices (all of them before any row is gathered).  Returns
    (witness, indices)."""
    pow_witness = 0
    if config.pow_bits:
        pow_witness = commitment.grind(ch, config.pow_bits, device)
    ch.check_witness(config.pow_bits, pow_witness)
    return pow_witness, [ch.sample_bits(log_N)
                         for _ in range(config.num_queries)]


def _open_path(tree: MerkleTree, j: int) -> list[list[int]]:
    return [[int(x) for x in d] for d in tree.open(j)]


def _fri_steps(layers: list[torch.Tensor], trees: list, q_indices: list[int],
               log_N: int, commitment) -> list[list[FriStep]]:
    """Each query's FRI openings: one indexed read per layer for all
    queries, then the pair and its path (`commitment.open`) per query and
    layer."""
    pairs: list[np.ndarray] = []
    qq_per_layer: list[list[int]] = []
    cur_qs = list(q_indices)
    for ell, layer_vals in enumerate(layers):
        half = (1 << (log_N - ell)) // 2
        js = [q % half for q in cur_qs]
        idx = torch.tensor(js + [j + half for j in js], dtype=torch.int64,
                           device=layer_vals.device)
        pairs.append(bb.np_from_mont(bb.to_numpy(layer_vals[idx])))
        qq_per_layer.append(js)
        cur_qs = js
    nq = len(q_indices)
    return [[FriStep(pair=(Fp4(*[int(x) for x in pairs[ell][pos]]),
                           Fp4(*[int(x) for x in pairs[ell][nq + pos]])),
                     path=commitment.open(tree, qq_per_layer[ell][pos]))
             for ell, tree in enumerate(trees)]
            for pos in range(nq)]


def prove(air: Air, trace: np.ndarray, public_values: list[int] | None = None,
          config: StarkConfig = DEFAULT_CONFIG,
          timings: dict | None = None, device=None) -> StarkProof:
    """Prove one AIR's trace (plain uint32 (n, air.width)) as a StarkProof
    with the reference's transcript and bytes.

    device: where the tensor work runs — the CUDA card by default (raises
    without one), "cpu" for the plain torch versions.  timings: if given, receives the seconds of each
    stage (lde_commit, quotient, ood_openings, deep, fri, queries; the
    device is synchronised at each stage boundary)."""
    from .lowering import eval_quotient_vm, lower_air
    from .machine import POSEIDON2, _resolve_device

    dev = _resolve_device(device)
    with Stages(timings, "lde_commit", [dev]) as stages:

        public_values = [int(v) % P for v in (public_values or [])]
        n, w = trace.shape
        log_n = n.bit_length() - 1
        if 1 << log_n != n:
            raise ValueError("trace height must be a power of two")
        if w != air.width:
            raise ValueError(f"trace width {w} != air width {air.width}")
        if air.max_constraint_degree + 1 > config.blowup:
            raise ValueError(
                f"constraint degree {air.max_constraint_degree} needs blowup "
                f"> {air.max_constraint_degree}"
            )
        N = n << config.log_blowup
        s = config.shift
        g = two_adic_root(log_n)

        # 1. trace LDE + commit --------------------------------------------
        trace_m = _mont(trace, dev)
        lde = coset_lde(trace_m, config.log_blowup, s)           # (N, w)
        trace_tree = MerkleTree(lde)
        trace_root = [int(x) for x in trace_tree.root]
        stages.next("quotient")

        ch = Challenger()
        ch.observe_bytes(air.name.encode())
        ch.observe(log_n)
        ch.observe_many(public_values)
        ch.observe_many(trace_root)

        # 1b. LogUp permutation trace (second commitment round) ------------
        challenges: list[Fp4] = []
        perm_root: list[int] | None = None
        perm_tree = None
        if air.perm_width:
            challenges = [ch.sample_ext()
                          for _ in range(air.num_perm_challenges)]
            perm_np = air.generate_perm_trace(trace, public_values, challenges)
            if perm_np.shape != (n, air.perm_width):
                raise ValueError("generate_perm_trace returned wrong shape")
            perm_m = _mont(perm_np, dev)
            perm_lde = coset_lde(perm_m, config.log_blowup, s)
            perm_tree = MerkleTree(perm_lde)
            perm_root = [int(x) for x in perm_tree.root]
            ch.observe_many(perm_root)
        else:
            perm_m = torch.zeros((n, 0), dtype=bb.DTYPE, device=dev)
            perm_lde = torch.zeros((N, 0), dtype=bb.DTYPE, device=dev)

        # 2. quotient ------------------------------------------------------
        alpha = ch.sample_ext()
        n_constraints = lower_air(
            air, len(public_values), len(challenges)).n_constraints
        apow = np_ext_powers(alpha, max(n_constraints, 1)).astype(np.uint32)

        sels_np = selector_arrays(log_n, config.log_blowup, s)
        sels_m = {k: _mont(sels_np[k], dev)
                  for k in ("is_first_row", "is_last_row", "is_transition")}
        inv_zh_m = _mont(sels_np["inv_z_h"], dev)

        # periodic columns: evaluate each period-m pattern on the commit coset
        # (period becomes m·blowup there) and tile — no commitment needed
        periodic_cols = []
        for pattern in air.periodic_columns():
            s_m = pow(s, n // len(pattern), P)
            vals = coset_lde(_mont(np.asarray(pattern, dtype=np.uint32), dev),
                             config.log_blowup, s_m)
            periodic_cols.append(vals.repeat(N // vals.shape[0]))
        periodic_stack = (torch.stack(periodic_cols, dim=0) if periodic_cols
                          else torch.zeros((0, N), dtype=bb.DTYPE, device=dev))

        quotient_vals = eval_quotient_vm(
            air, lde, perm_lde, challenges, public_values, apow, sels_m,
            inv_zh_m, periodic_stack, config.log_blowup)         # (N, 4)

        # 3. split + commit quotient ------------------------------------------
        q_coeffs = coset_coeffs(quotient_vals, s)                 # (N, 4)
        chunks = [q_coeffs[k * n : (k + 1) * n] for k in range(config.blowup)]
        q_cols = torch.cat(
            [coeffs_to_coset_evals(c, config.log_blowup, s) for c in chunks],
            dim=1)                                            # (N, blowup*4)
        quotient_tree = MerkleTree(q_cols)
        quotient_root = [int(x) for x in quotient_tree.root]
        ch.observe_many(quotient_root)
        stages.next("ood_openings")

        # 4. out-of-domain openings -------------------------------------------
        zeta = ch.sample_ext()
        g_zeta = zeta * g
        zpows = _zeta_powers(zeta, n, dev)
        gzpows = _zeta_powers(g_zeta, n, dev)
        trace_coeffs = intt(trace_m)                               # (n, w)
        tl = _ext_evals_at(trace_coeffs, zpows)                    # (w, 4)
        tn = _ext_evals_at(trace_coeffs, gzpows)
        qe = np.concatenate([_ext_evals_at(c, zpows) for c in chunks], axis=0)
        if air.perm_width:
            perm_coeffs = intt(perm_m)
            pl = _ext_evals_at(perm_coeffs, zpows)                 # (pw, 4)
            pn = _ext_evals_at(perm_coeffs, gzpows)
        else:
            pl = pn = np.zeros((0, 4), dtype=np.uint32)
        trace_local_evals, trace_next_evals = _fp4_rows(tl), _fp4_rows(tn)
        perm_local_evals, perm_next_evals = _fp4_rows(pl), _fp4_rows(pn)
        quotient_evals = _fp4_rows(qe)
        for v in (trace_local_evals + trace_next_evals + perm_local_evals
                  + perm_next_evals + quotient_evals):
            ch.observe_ext(v)
        stages.next("deep")

        # 5. DEEP composition ----------------------------------------------
        # β-power ordering: ζ-group [trace ‖ perm ‖ quotient], then g·ζ-group
        # [trace ‖ perm] (the verifier mirrors this exactly)
        beta = ch.sample_ext()
        pw = air.perm_width
        w_z = w + pw + q_cols.shape[1]
        w_gz = w + pw
        bpow_m = _mont(np_ext_powers(beta, w_z + w_gz).astype(np.uint32), dev)

        x_ext = ex.ext_from_base(_mont(sels_np["x"], dev))         # (N, 4)
        zeta_arr = bb.from_numpy(ex.from_fp4(zeta), dev).expand(N, 4)
        gzeta_arr = bb.from_numpy(ex.from_fp4(g_zeta), dev).expand(N, 4)
        inv_x_zeta = ex.ext_inv(ex.ext_sub(x_ext, zeta_arr))
        inv_x_gzeta = ex.ext_inv(ex.ext_sub(x_ext, gzeta_arr))
        ev_z = _mont(np.concatenate([tl, pl, qe], axis=0).astype(np.uint32),
                     dev)
        ev_gz = _mont(np.concatenate([tn, pn], axis=0).astype(np.uint32), dev)
        deep = _deep_fn(torch.cat([lde, perm_lde, q_cols], dim=1),
                        torch.cat([lde, perm_lde], dim=1), bpow_m, ev_z, ev_gz,
                        inv_x_zeta, inv_x_gzeta)                   # (N, 4)
        stages.next("fri")

        # 6. FRI -----------------------------------------------------------
        log_N = log_n + config.log_blowup
        fri_roots, fri_trees, fri_layers, fri_final = _fri_commit(
            ch, {log_N: deep}, config, log_N, POSEIDON2)
        stages.next("queries")

        # 7. grinding + queries --------------------------------------------
        pow_witness, q_indices = _grind_and_sample(ch, config, log_N, dev,
                                                   POSEIDON2)
        qi = torch.tensor(q_indices, dtype=torch.int64, device=dev)

        def _rows(mat):
            return bb.np_from_mont(bb.to_numpy(mat[qi]))

        trace_rows, quot_rows = _rows(lde), _rows(q_cols)
        perm_rows = _rows(perm_lde) if pw else None
        fri_steps = _fri_steps(fri_layers, fri_trees, q_indices, log_N,
                               POSEIDON2)
        queries = []
        for qi_pos, q in enumerate(q_indices):
            queries.append(QueryProof(
                index=q,
                trace_row=[int(x) for x in trace_rows[qi_pos]],
                trace_path=_open_path(trace_tree, q),
                quotient_row=[int(x) for x in quot_rows[qi_pos]],
                quotient_path=_open_path(quotient_tree, q),
                fri_steps=fri_steps[qi_pos],
                perm_row=([int(x) for x in perm_rows[qi_pos]]
                          if perm_rows is not None else []),
                perm_path=(_open_path(perm_tree, q) if perm_tree is not None
                           else []),
            ))
    return StarkProof(
        air_name=air.name,
        log_n=log_n,
        public_values=public_values,
        trace_root=trace_root,
        quotient_root=quotient_root,
        trace_local_evals=trace_local_evals,
        trace_next_evals=trace_next_evals,
        quotient_evals=quotient_evals,
        fri_roots=fri_roots,
        fri_final=fri_final,
        pow_witness=pow_witness,
        queries=queries,
        perm_root=perm_root,
        perm_local_evals=perm_local_evals,
        perm_next_evals=perm_next_evals,
    )
