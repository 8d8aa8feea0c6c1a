"""Poseidon2 sponge AIR chips — the hash workhorse of the recursion
machine (stark/recursion.py).

The reference proves inner STARK verification with a recursion circuit
whose dominant cost is Poseidon2 permutations (sp1-recursion-core /
risc0-circuit-recursion, SURVEY.md §2.2.B/C).  Here each chip row proves
ONE full Poseidon2 permutation (width 16 or 24 — the framework's
challenger/compress and Merkle-leaf sponges, ops/poseidon2.py) with every
round's S-box cubes and output states materialized as columns, plus the
sponge plumbing:

  * state_prev: the incoming duplex state — zero on fresh rows, else
    received over the chain bus (BUS_SP_CHAIN + width tag: sid, seq,
    state) from the previous row of the same sponge instance;
  * absorb: per-lane flags f and values a; the permutation input is
    s_in = f·a + (1−f)·state_prev lane-wise (overwrite semantics,
    exactly the host Challenger's duplex);  absorbed values arrive as
    (BUS_HASH_ABS, sid, seq, lane, value) messages from the VM chip;
  * outputs: lanes 0..7 of the permutation output are sent as
    (BUS_HASH_OUT, sid, seq, lane, value) with per-lane multiplicities
    (the VM receives sampled challenges / digest lanes).

The x^7 S-box is split as x3 = t³ (committed), u = x3²·t — both degree 3
— so the whole permutation fits the blowup-4 constraint budget with one
committed state per round.

Port copy of zktls_tpu.stark.chips.sponge (same names and values; host
code in numpy, the host permutation through the port's C library).
"""

from __future__ import annotations

import numpy as np

from ...ops.field_ref import P
from ...ops.poseidon2 import get_params
from ..air import Air, AirBuilder
from ..bus import (
    BUS_HASH_ABS,
    BUS_HASH_ABS24,
    BUS_HASH_OUT,
    BUS_HASH_OUT24,
    BUS_SP16_CHAIN,
    BUS_SP24_CHAIN,
    np_bus_inverse_terms,
)
from ..ext_val import ExtVal

__all__ = ["SpongeAir", "Sponge16Air", "Sponge24Air", "sponge_trace",
           "SpongeRow", "N_OUT"]

#: output lanes exposed on the bus (digest width / challenger rate)
N_OUT = 8


class _Layout:
    def __init__(self):
        self._n = 0
        self.slices: dict[str, slice] = {}

    def add(self, name: str, count: int) -> None:
        self.slices[name] = slice(self._n, self._n + count)
        self._n += count

    @property
    def width(self) -> int:
        return self._n

    def __getitem__(self, name: str) -> slice:
        return self.slices[name]


def _build_layout(w: int, rf: int, rp: int) -> _Layout:
    L = _Layout()
    L.add("live", 1)
    L.add("sid", 1)
    L.add("seq", 1)
    L.add("fresh", 1)
    L.add("am", 1)         # absorb mode: 0 = overwrite (challenger duplex),
    #                        1 = additive (Merkle leaf sponge)
    L.add("f", w)          # absorb flags
    L.add("a", w)          # absorb values
    L.add("sp", w)         # state_prev
    L.add("sin", w)        # permutation input = f·a + (1−f)·sp (committed
    #                        so the first round's cube stays degree 3)
    for r in range(rf // 2):
        L.add(f"x3e{r}", w)    # first-half full-round cubes
        L.add(f"se{r}", w)     # round output state
    L.add("x3i", rp)           # partial-round lane-0 cubes
    for r in range(rp):
        L.add(f"si{r}", w)
    for r in range(rf // 2):
        L.add(f"x3l{r}", w)
        L.add(f"sl{r}", w)
    L.add("m", N_OUT)          # output-lane send multiplicities
    L.add("nc", 1)             # chain-send multiplicity (next row exists)
    return L


def _m4_mat() -> np.ndarray:
    from ...ops.poseidon2 import M4

    return np.array(M4, dtype=np.int64)


def _ext_matrix(w: int) -> np.ndarray:
    """M_E = circ(2·M4, M4, …): out = block-diag(M4)·x + tile of block
    sums.  Returns the dense (w, w) integer matrix."""
    m4 = _m4_mat()
    blocks = w // 4
    M = np.zeros((w, w), dtype=np.int64)
    for bi in range(blocks):
        for bj in range(blocks):
            M[4 * bi : 4 * bi + 4, 4 * bj : 4 * bj + 4] += m4
        M[4 * bi : 4 * bi + 4, 4 * bi : 4 * bi + 4] += m4
    return M % P


class SpongeAir(Air):
    """One Poseidon2 permutation per row, with duplex plumbing."""

    num_public = 0
    max_constraint_degree = 3
    num_perm_challenges = 2
    has_bus = True

    def __init__(self, w: int):
        p = get_params(w)
        self.w = w
        self.rf = p.rf
        self.rp = p.rp
        self.ext_rc = [list(rc) for rc in p.external_rc]
        self.int_rc = list(p.internal_rc)
        self.diag = list(p.diag)
        self.ME = _ext_matrix(w)
        self.L = _build_layout(w, p.rf, p.rp)
        self.width = self.L.width
        self.chain_tag = BUS_SP16_CHAIN if w == 16 else BUS_SP24_CHAIN
        # width-specific hash-bus tags: each chip enforces (sid, seq)
        # uniqueness only within its own trace, so the two widths must
        # live in disjoint bus namespaces (a shared tag would let a
        # width-24 row serve a width-16 absorb/output)
        self.abs_tag = BUS_HASH_ABS if w == 16 else BUS_HASH_ABS24
        self.out_tag = BUS_HASH_OUT if w == 16 else BUS_HASH_OUT24
        #: chain recv ‖ chain send ‖ w absorb recvs ‖ 8 out sends ‖ u ‖ acc
        self.perm_width = 4 * (2 + w + N_OUT + 2)
        self.name = f"Sponge{w}Air"

    # ------------------------------------------------------------------

    def eval(self, b: AirBuilder) -> None:
        L = self.L
        w = self.w
        half = self.rf // 2

        def g(name):
            return b.local_group(L[name])

        def col(name, i=0):
            return b.local[L[name].start + i]

        live, fresh, am = col("live"), col("fresh"), col("am")
        F, A, SP = g("f"), g("a"), g("sp")
        b.assert_bool(live)
        b.assert_bool(fresh)
        b.assert_bool(am)
        # nc boolean: a chain message is sent AT MOST ONCE — nc = 2 would
        # fork a chain into two branches (one absorbing, one not),
        # detaching Fiat-Shamir challenges from the absorbed commitments
        b.assert_bool(col("nc"))
        b.assert_zero_vec(F * (F - 1), w)
        b.assert_zero(fresh * (1 - live))
        # fresh ⇒ seq = 0: only a chain START may skip the chain receive;
        # a mid-chain "fresh" row could soak up absorbs into a zero state
        b.assert_zero(fresh * col("seq"))
        # fresh rows start from the zero state
        b.assert_zero_vec(SP * fresh, w)
        # (sid, seq) uniqueness discipline — without it a prover could run
        # a PARALLEL chain with the same sid, partition the program's
        # absorbs between the branches and pick which branch serves each
        # challenge.  Trace order: live rows form a prefix; sid is
        # non-decreasing, stepping by exactly 1 at chain boundaries; seq
        # increments by 1 within a chain.  Dead rows continue the pattern
        # (sid held, seq incrementing) so no live-gating is needed and
        # every constraint stays within the degree budget.
        sid, seq = col("sid"), col("seq")
        sid_n = b.next[L["sid"].start]
        seq_n = b.next[L["seq"].start]
        live_n = b.next[L["live"].start]
        b.when_transition((1 - live) * live_n)
        d_sid = sid_n - sid
        b.when_transition(d_sid * (d_sid - 1))
        b.when_transition((d_sid - 1) * (seq_n - seq - 1))

        # s_in = f·(a + am·sp) + (1−f)·sp  (committed: keeps round-1 at
        # degree 3; am = 1 adds into the state, am = 0 overwrites)
        s_in = g("sin")
        b.assert_zero_vec(s_in - (F * A + F * (am * SP)
                                  + (1 - F) * SP), w)

        # --- permutation: init linear layer then rounds ---
        def mat_me(vec):
            return b.mat_const(vec, self.ME.T.tolist())

        def mat_mi(vec, u0):
            # M_I = J + diag(d): out_j = Σ u + d_j·u_j, with u_0 = the
            # sboxed lane and u_k = s_k otherwise — caller passes the full
            # u vector
            return None  # handled inline below

        state = mat_me(s_in)     # initial external matrix (paper §3)

        def full_round(state, r, x3_grp, s_out_grp, rc):
            # t = state + rc; x3 = t³; u = x3²·t; s_out = M_E·u
            t = state + b.const_vec(rc)
            b.assert_zero_vec(x3_grp - t * t * t, w)
            u = x3_grp * x3_grp * t
            b.assert_zero_vec(s_out_grp - mat_me(u), w)
            return s_out_grp

        for r in range(half):
            state = full_round(state, r, g(f"x3e{r}"), g(f"se{r}"),
                               self.ext_rc[r])
        # partial rounds: lane 0 sboxes, then M_I = J + diag(d)
        for r in range(self.rp):
            t0 = state[0] + self.int_rc[r]
            x3 = col("x3i", r)
            b.assert_zero(x3 - t0 * t0 * t0)
            u0 = x3 * x3 * t0
            s_out = g(f"si{r}")
            # total = u0 + Σ_{k>0} s_k ;  out_j = total + d_j·u_j
            tot = u0
            for k in range(1, w):
                tot = tot + state[k]
            b.assert_zero(s_out[0] - (tot + self.diag[0] * u0))
            for j in range(1, w):
                b.assert_zero(s_out[j] - (tot + self.diag[j] * state[j]))
            state = s_out
        for r in range(half):
            state = full_round(state, r, g(f"x3l{r}"), g(f"sl{r}"),
                               self.ext_rc[half + r])
        s_out = state     # the committed last-round output group

        # --- bus ---
        gamma = b.challenges[0]

        def dpow(i):
            return b.challenges[1 + i]

        sid, seq = col("sid"), col("seq")
        fp_crecv = (ExtVal.from_base(self.chain_tag) + dpow(0) * sid
                    + dpow(1) * seq)
        fp_csend = (ExtVal.from_base(self.chain_tag) + dpow(0) * sid
                    + dpow(1) * (seq + 1))
        for i in range(w):
            fp_crecv = fp_crecv + dpow(2 + i) * SP[i]
            fp_csend = fp_csend + dpow(2 + i) * s_out[i]
        iv_cr = b.perm_ext(0)
        iv_cs = b.perm_ext(1)
        b.assert_ext_zero(iv_cr * (gamma - fp_crecv) - 1)
        b.assert_ext_zero(iv_cs * (gamma - fp_csend) - 1)
        u_def = (iv_cs * (col("nc") * live)
                 - iv_cr * (live * (1 - fresh)))
        for i in range(w):
            fp_abs = (ExtVal.from_base(self.abs_tag) + dpow(0) * sid
                      + dpow(1) * seq + dpow(2) * i + dpow(3) * A[i]
                      + dpow(4) * am)
            iv = b.perm_ext(2 + i)
            b.assert_ext_zero(iv * (gamma - fp_abs) - 1)
            u_def = u_def - iv * (F[i] * live)
        for k in range(N_OUT):
            fp_out = (ExtVal.from_base(self.out_tag) + dpow(0) * sid
                      + dpow(1) * seq + dpow(2) * k
                      + dpow(3) * s_out[k])
            iv = b.perm_ext(2 + w + k)
            b.assert_ext_zero(iv * (gamma - fp_out) - 1)
            u_def = u_def + iv * (col("m", k) * live)
        u = b.perm_ext(2 + w + N_OUT)
        acc = b.perm_ext(3 + w + N_OUT)
        u_n = b.perm_ext(2 + w + N_OUT, nxt=True)
        acc_n = b.perm_ext(3 + w + N_OUT, nxt=True)
        b.assert_ext_zero(u - u_def)
        b.assert_ext_zero((acc - u) * b.is_first_row)
        b.assert_ext_zero((acc_n - acc - u_n) * b.is_transition)
        for ell in range(4):
            b.when_last_row(acc.c[ell] - b.public[ell])

    # ------------------------------------------------------------------

    def _permute_rows(self, s_in: np.ndarray):
        """Vectorized witness permutation over uint64 (M_E entries are
        tiny, so 16-term dot products stay < 2^40): returns round
        snapshot arrays mirroring the column layout, plus the output."""
        half = self.rf // 2
        ME = self.ME.astype(np.uint64)   # entries < 16

        def matmul(x):
            return (x @ ME.T) % P        # sums < 16·16·P < 2^40

        def sbox7(x):
            x3 = x * x % P * x % P
            return x3, x3 * x3 % P * x % P

        state = matmul(s_in.astype(np.uint64) % P)
        snaps = []
        for r in range(half):
            t = (state + np.array(self.ext_rc[r], dtype=np.uint64)) % P
            x3, u = sbox7(t)
            state = matmul(u)
            snaps.append(("x3", x3))
            snaps.append(("s", state))
        for r in range(self.rp):
            t0 = (state[:, 0] + self.int_rc[r]) % P
            x3, u0 = sbox7(t0)
            tot = (u0 + state[:, 1:].sum(axis=1) % P) % P
            out = np.empty_like(state)
            d = self.diag
            out[:, 0] = (tot + d[0] * u0 % P) % P
            for j in range(1, self.w):
                out[:, j] = (tot + d[j] * state[:, j] % P) % P
            snaps.append(("x3i", x3))
            snaps.append(("s", out))
            state = out
        for r in range(half):
            t = (state + np.array(self.ext_rc[half + r],
                                  dtype=np.uint64)) % P
            x3, u = sbox7(t)
            state = matmul(u)
            snaps.append(("x3", x3))
            snaps.append(("s", state))
        return snaps, state

    def generate_perm_trace(self, main, publics, challenges):
        L = self.L
        w = self.w
        n = main.shape[0]

        def cols(name):
            return main[:, L[name]].astype(np.uint64)

        def col1(name, i=0):
            return main[:, L[name].start + i].astype(np.uint64)

        sid, seq = col1("sid"), col1("seq")
        live, fresh, nc = col1("live"), col1("fresh"), col1("nc")
        am = col1("am")
        sp, a, f = cols("sp"), cols("a"), cols("f")
        s_out = self._final_state_cols(main)
        crecv = np_bus_inverse_terms(
            challenges, self.chain_tag,
            np.concatenate([sid[:, None], seq[:, None], sp], axis=1))
        csend = np_bus_inverse_terms(
            challenges, self.chain_tag,
            np.concatenate([sid[:, None], ((seq + 1) % P)[:, None],
                            s_out], axis=1))
        parts = [crecv, csend]
        u = ((csend.astype(np.uint64) * (nc * live)[:, None]) % P
             + P - (crecv.astype(np.uint64)
                    * (live * (1 - fresh))[:, None]) % P) % P
        for i in range(w):
            pl = np.stack([sid, seq, np.full(n, i, dtype=np.uint64),
                           a[:, i], am], axis=1)
            iv = np_bus_inverse_terms(challenges, self.abs_tag, pl)
            parts.append(iv)
            u = (u + P - (iv.astype(np.uint64)
                          * (f[:, i] * live)[:, None]) % P) % P
        mm = cols("m")
        for k in range(N_OUT):
            pl = np.stack([sid, seq, np.full(n, k, dtype=np.uint64),
                           s_out[:, k]], axis=1)
            iv = np_bus_inverse_terms(challenges, self.out_tag, pl)
            parts.append(iv)
            u = (u + (iv.astype(np.uint64)
                      * (mm[:, k] * live)[:, None])) % P
        acc = np.cumsum(u, axis=0) % P
        parts += [u, acc]
        return np.concatenate(parts, axis=1).astype(np.uint32)

    def _final_state_cols(self, main) -> np.ndarray:
        half = self.rf // 2
        return main[:, self.L[f"sl{half - 1}"]].astype(np.uint64)


class Sponge16Air(SpongeAir):
    name = "Sponge16Air"

    def __init__(self):
        super().__init__(16)


class Sponge24Air(SpongeAir):
    name = "Sponge24Air"

    def __init__(self):
        super().__init__(24)


# ---------------------------------------------------------------------------
# witness generation
# ---------------------------------------------------------------------------


class SpongeRow:
    """One duplex of a sponge instance: absorb (lane, value) pairs over
    the previous state, expose output lanes with multiplicities."""

    __slots__ = ("sid", "seq", "absorbs", "out_mults", "has_next",
                 "additive", "fresh_state")

    def __init__(self, sid: int, seq: int, absorbs: dict[int, int],
                 out_mults: dict[int, int], has_next: bool,
                 additive: bool = False, fresh_state=None):
        self.sid = sid
        self.seq = seq
        self.absorbs = absorbs
        self.out_mults = out_mults
        self.has_next = has_next
        self.additive = additive
        #: for seq > 0 rows whose chain state comes from a VERIFIER-sent
        #: public message (the precomputed transcript header state), the
        #: incoming state is supplied here instead of chain bookkeeping
        self.fresh_state = fresh_state


def sponge_trace(air: SpongeAir, rows: list[SpongeRow],
                 min_log_n: int = 4):
    """Build the chip trace.  Rows must follow the chip's chain
    discipline (enforced in-circuit): sids dense and increasing by 1 at
    chain boundaries, seq incrementing within a chain, each sid in one
    contiguous run.  Returns (trace, [], states) where states[i] is row
    i's output state (for building VM receives).

    Pass 1 walks the chains with the fast host Poseidon2 (native C) to
    resolve every row's incoming state; pass 2 recomputes all round
    snapshots vectorized for the column fill."""
    from ...ops.poseidon2 import Poseidon2

    w = air.w
    L = air.L
    n_real = max(len(rows), 1)
    log_n = max(min_log_n, (n_real - 1).bit_length())
    n = 1 << log_n
    trace = np.zeros((n, L.width), dtype=np.uint32)
    perm = Poseidon2(w)
    cur_state: dict[int, list[int]] = {}
    s_in_all = np.zeros((n, w), dtype=np.uint64)
    states: list[list[int]] = []
    # host-side discipline check: fail loudly at build time rather than
    # producing a trace the chip constraints reject
    prev_sid = None
    prev_seq = None
    for row in rows:
        if prev_sid is None:
            pass
        elif row.sid == prev_sid:
            if row.seq != prev_seq + 1:
                raise ValueError(
                    f"sponge chain discipline: sid {row.sid} seq "
                    f"{row.seq} after seq {prev_seq}")
        elif row.sid != prev_sid + 1:
            raise ValueError(
                f"sponge chain discipline: sid {row.sid} after "
                f"sid {prev_sid} (must be dense, increasing)")
        prev_sid, prev_seq = row.sid, row.seq
    for i, row in enumerate(rows):
        trace[i, L["live"].start] = 1
        trace[i, L["sid"].start] = row.sid % P
        trace[i, L["seq"].start] = row.seq % P
        fresh = row.seq == 0
        trace[i, L["fresh"].start] = 1 if fresh else 0
        trace[i, L["am"].start] = 1 if row.additive else 0
        trace[i, L["nc"].start] = 1 if row.has_next else 0
        if fresh:
            prev = [0] * w
        elif row.fresh_state is not None:
            prev = list(row.fresh_state)
        else:
            prev = cur_state[row.sid]
        trace[i, L["sp"]] = np.array(prev, dtype=np.uint32)
        s_in = list(prev)
        for lane, val in row.absorbs.items():
            trace[i, L["f"].start + lane] = 1
            trace[i, L["a"].start + lane] = val % P
            s_in[lane] = ((s_in[lane] + val) % P if row.additive
                          else val % P)
        for lane, mult in row.out_mults.items():
            trace[i, L["m"].start + lane] = mult
        s_in_all[i] = np.array(s_in, dtype=np.uint64)
        out = perm.permute_ints(s_in)
        cur_state[row.sid] = out
        states.append(out)
    # dead rows continue the (sid, seq) pattern — the uniqueness
    # transition constraints are not live-gated (degree budget), so the
    # padding must satisfy sid-held / seq+1 itself
    m = len(rows)
    if m < n:
        last_sid = rows[-1].sid % P if rows else 0
        last_seq = rows[-1].seq if rows else -1
        trace[m:, L["sid"].start] = last_sid
        trace[m:, L["seq"].start] = (
            last_seq + 1 + np.arange(n - m, dtype=np.int64)) % P
    trace[:, L["sin"]] = s_in_all.astype(np.uint32)
    snaps, final = air._permute_rows(s_in_all)
    half = air.rf // 2
    it = iter(snaps)
    for r in range(half):
        _, x3 = next(it)
        _, s = next(it)
        trace[:, L[f"x3e{r}"]] = x3.astype(np.uint32)
        trace[:, L[f"se{r}"]] = s.astype(np.uint32)
    for r in range(air.rp):
        _, x3 = next(it)
        _, s = next(it)
        trace[:, L["x3i"].start + r] = x3.astype(np.uint32)
        trace[:, L[f"si{r}"]] = s.astype(np.uint32)
    for r in range(half):
        _, x3 = next(it)
        _, s = next(it)
        trace[:, L[f"x3l{r}"]] = x3.astype(np.uint32)
        trace[:, L[f"sl{r}"]] = s.astype(np.uint32)
    for i, row in enumerate(rows):
        assert [int(v) for v in final[i]] == states[i], \
            "snapshot permutation disagrees with host Poseidon2"
    return trace, [], states
