"""SHA-256 compression AIR chip (port copy of zktls_tpu.stark.chips.sha256)
— the first real workload chip of the zkTLS proving system: it proves the
transcript-hash computation of the recorded session.

Layout: one row per SHA-256 round, 64 rows per compression, compressions
stacked (padding blocks first, the digest-binding compression last).
32-bit words are represented as two 16-bit limbs (Baby-Bear p < 2^32) and
bit-decomposed where rotations/boolean functions need them.

Column groups (564 total):
  a,b,c,e,f,g       6×32 bit columns (LSB first)
  d,h               2×2 limb columns
  s0,s1,maj,ch      4×32 bit columns — Σ0(a), Σ1(e), Maj(a,b,c), Ch(e,f,g),
                    materialized so downstream sums stay degree 1
  w_win             16×2 limb columns: message-schedule window w[t..t+15]
  w1,w14            2×32 bit columns (bits of w[t+1], w[t+14])
  sig0,sig1         2×32 bit columns — σ0(w[t+1]), σ1(w[t+14])
  sc                2+2 carry bits (schedule addition)
  ce,ca             3+3 each carry bits (e'/a' round additions)
  h_state           8×2 limb columns: the block's input state (constant
                    within each 64-row group)
  hc                8×(3+3) carry bits (Davies-Meyer output addition on the
                    final row)

Periodic columns (no commitment; verifier evaluates them itself):
  k_lo, k_hi (round constants), is_last_round (t=63), is_round0 (t=0).

Chaining & publication (round-2, the machine bus — SURVEY.md §2.2.B
"multi-table STARK glued by LogUp-style lookups"):

  obj,seq,fresh,nc,tag   per-group metadata columns (constant in the group)
  dig                    16 limb columns: the group's Davies-Meyer output
                         (row-local would-be value off the last row)

Every compression group participates in the global bus (stark/bus.py):
a non-fresh group RECEIVES (BUS_SHA_STATE, obj, seq, state_in); every
group SENDS (BUS_SHA_STATE, obj, seq+1, dig) with multiplicity nc (its
number of consumer compressions — hash objects form a tree under copy());
fresh groups instead pin state_in = IV.  Since seq is range-checked and
strictly increases along a chain, every digest is grounded in a chain from
the IV — a fabricated mid-state cannot close the multiset.  A group with
has_tag = 1 additionally SENDS (BUS_SHA_RESULT, tag, dig), which the
machine verifier consumes with journal-derived digests (e.g. the journal
hash itself): by SHA-256 collision resistance the chain's blocks then ARE
the journal bytes.

Public values: none (the chip's bus sum is appended by the machine).
"""

from __future__ import annotations

import numpy as np

from ...guest.crypto.sha256 import _IV, _K  # spec constants
from ...ops.field_ref import P
from ..air import Air, AirBuilder
from ..bus import (BUS_SHA_BLOCK, BUS_SHA_HOP, BUS_SHA_RESULT,
                   BUS_SHA_STATE, np_bus_inverse_terms)
from ..ext_val import ExtVal

__all__ = ["Sha256Air", "sha256_trace", "ROWS_PER_BLOCK"]

ROWS_PER_BLOCK = 64
SEQ_BITS = 16
NC_BITS = 5


# ---------------------------------------------------------------------------
# column layout
# ---------------------------------------------------------------------------


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


def _build_layout() -> _Layout:
    L = _Layout()
    for v in ("a", "b", "c", "e", "f", "g"):
        L.add(v, 32)
    L.add("dh", 4)            # d_lo, d_hi, h_lo, h_hi
    for v in ("s0", "s1", "maj", "ch"):
        L.add(v, 32)
    L.add("w_win", 32)        # 16 words × (lo, hi)
    L.add("w1", 32)
    L.add("w14", 32)
    L.add("sig0", 32)
    L.add("sig1", 32)
    L.add("sc", 4)            # schedule carries: lo 2 bits, hi 2 bits
    L.add("ce", 6)            # e' carries: lo 3 bits, hi 3 bits
    L.add("ca", 6)            # a' carries
    L.add("h_state", 16)      # H0..H7 × (lo, hi)
    L.add("hc", 48)           # 8 words × (lo 3 bits, hi 3 bits)
    # --- chaining / bus metadata (constant within each 64-row group) ---
    L.add("obj", 1)           # hash-object id (free field element)
    L.add("seq", SEQ_BITS)    # chain depth, bit-decomposed (range check)
    L.add("fresh", 1)         # 1 ⇒ state_in = IV (chain root)
    L.add("nc", NC_BITS)      # consumer count of this group's output, bits
    L.add("has_tag", 1)       # 1 ⇒ publish digest with result tag
    L.add("tag", 1)           # result tag (0 unless has_tag)
    L.add("xb", 1)            # expose-block flag: 1 ⇒ this chain's message
    #                           blocks are sent on the bus (BUS_SHA_BLOCK)
    #                           for the stream-parser chip; chain-invariant
    #                           because it rides the chain fingerprints
    L.add("dig", 16)          # Davies-Meyer output limbs (canonical on the
    #                           group's last row; bus messages read these)
    L.add("blk", 32)          # group-constant copy of the message block
    #                           limbs (= w_win on the round-0 row) so the
    #                           LAST row can publish the atomic hop
    #                           statement (in, block, out) on BUS_SHA_HOP
    L.add("nh", 1)            # hop-consumer multiplicity (free witness —
    #                           the payload is the row's own proven event)
    return L


LAYOUT = _build_layout()


def _xor3(x, y, z):
    """xor of three booleans as a polynomial (degree 3)."""
    return x + y + z - 2 * (x * y + y * z + x * z) + 4 * (x * y * z)


def _xor2(x, y):
    return x + y - 2 * (x * y)


class Sha256Air(Air):
    width = LAYOUT.width
    num_public = 0
    max_constraint_degree = 3
    #: inv_recv ‖ inv_send ‖ inv_res ‖ inv_b0 ‖ inv_b1 ‖ inv_hop ‖ u ‖ acc
    perm_width = 32
    num_perm_challenges = 2   # machine supplies the full challenge vector
    has_bus = True

    def periodic_columns(self) -> list:
        k = np.array(_K, dtype=np.uint64)
        k_lo = (k & 0xFFFF).astype(np.uint32)
        k_hi = (k >> 16).astype(np.uint32)
        is_last = np.zeros(64, dtype=np.uint32)
        is_last[63] = 1
        is_r0 = np.zeros(64, dtype=np.uint32)
        is_r0[0] = 1
        return [k_lo, k_hi, is_last, is_r0]

    # ------------------------------------------------------------------

    def eval(self, b: AirBuilder) -> None:
        """Constraints in vectorized-group form: whole 32-lane families are
        asserted as one group expression, which the constraint-VM lowering
        batches into a few wide ops per family."""
        L = LAYOUT
        k_lo, k_hi, is_last, is_r0 = b.periodic
        not_last = 1 - is_last

        POW16 = [1 << i for i in range(16)]

        def g(name):
            return b.local_group(L[name])

        def ng(name):
            return b.next_group(L[name])

        def col(name, i=0):
            return b.local[L[name].start + i]

        def ncol(name, i=0):
            return b.next[L[name].start + i]

        def pack(grp, lo=True):
            return b.dot_const(grp[0:16] if lo else grp[16:32], POW16)

        def carry_val(name, off, nb):
            sl = slice(L[name].start + off, L[name].start + off + nb)
            return b.dot_const(b.local_group(sl), [1 << i for i in range(nb)])

        def xor3v(x, y, z):
            return x + y + z - 2 * (x * y + y * z + x * z) + 4 * (x * y * z)

        A, B_, C = g("a"), g("b"), g("c")
        E, F, G_ = g("e"), g("f"), g("g")
        S0, S1, MAJ, CH = g("s0"), g("s1"), g("maj"), g("ch")
        W1, W14 = g("w1"), g("w14")
        SIG0, SIG1 = g("sig0"), g("sig1")

        # --- booleanity (free-witness bits only) ---
        for grp, k in ((A, 32), (B_, 32), (C, 32), (E, 32), (F, 32),
                       (G_, 32), (W1, 32), (W14, 32),
                       (g("sc"), 4), (g("ce"), 6), (g("ca"), 6),
                       (g("hc"), 48), (g("seq"), SEQ_BITS),
                       (g("nc"), NC_BITS)):
            b.assert_zero_vec(grp * (grp - 1), k)
        for c in (col("fresh"), col("has_tag")):
            b.assert_bool(c)

        # --- boolean-function definitions (degree ≤ 3, every row) ---
        # roll(-r)[k] = bits[(k+r) % 32] = rotr by r;  shr via zero mask
        b.assert_zero_vec(
            S1 - xor3v(E.roll(-6), E.roll(-11), E.roll(-25)), 32)
        b.assert_zero_vec(
            S0 - xor3v(A.roll(-2), A.roll(-13), A.roll(-22)), 32)
        b.assert_zero_vec(CH - (E * F + G_ - E * G_), 32)
        b.assert_zero_vec(
            MAJ - (A * B_ + A * C + B_ * C - 2 * (A * B_ * C)), 32)
        shr3 = W1.roll(-3) * b.const_vec([1] * 29 + [0] * 3)
        b.assert_zero_vec(
            SIG0 - xor3v(W1.roll(-7), W1.roll(-18), shr3), 32)
        shr10 = W14.roll(-10) * b.const_vec([1] * 22 + [0] * 10)
        b.assert_zero_vec(
            SIG1 - xor3v(W14.roll(-17), W14.roll(-19), shr10), 32)

        # --- w1/w14 bits pack to window words 1 and 14 ---
        b.assert_zero(pack(W1, True) - col("w_win", 2))
        b.assert_zero(pack(W1, False) - col("w_win", 3))
        b.assert_zero(pack(W14, True) - col("w_win", 28))
        b.assert_zero(pack(W14, False) - col("w_win", 29))

        # --- round-0 rows: working vars equal the block input state ---
        var_lo_hi = [
            (pack(A, True), pack(A, False)),
            (pack(B_, True), pack(B_, False)),
            (pack(C, True), pack(C, False)),
            (col("dh", 0), col("dh", 1)),
            (pack(E, True), pack(E, False)),
            (pack(F, True), pack(F, False)),
            (pack(G_, True), pack(G_, False)),
            (col("dh", 2), col("dh", 3)),
        ]
        for i in range(8):
            b.assert_zero(is_r0 * (var_lo_hi[i][0] - col("h_state", 2 * i)))
            b.assert_zero(is_r0 * (var_lo_hi[i][1] - col("h_state", 2 * i + 1)))

        # --- round additions (transition, not across block boundary) ---
        s1v_lo, s1v_hi = pack(S1, True), pack(S1, False)
        s0v_lo, s0v_hi = pack(S0, True), pack(S0, False)
        chv_lo, chv_hi = pack(CH, True), pack(CH, False)
        majv_lo, majv_hi = pack(MAJ, True), pack(MAJ, False)
        w0_lo, w0_hi = col("w_win", 0), col("w_win", 1)
        h_lo, h_hi = col("dh", 2), col("dh", 3)
        d_lo, d_hi = col("dh", 0), col("dh", 1)
        # t1 = h + Σ1 + ch + K + w
        t1_lo = h_lo + s1v_lo + chv_lo + k_lo + w0_lo
        t1_hi = h_hi + s1v_hi + chv_hi + k_hi + w0_hi
        # e' = d + t1
        NE, NA = ng("e"), ng("a")
        ce_lo = carry_val("ce", 0, 3)
        ce_hi = carry_val("ce", 3, 3)
        b.assert_zero(not_last * (d_lo + t1_lo - pack(NE, True)
                                  - ce_lo * (1 << 16)))
        b.assert_zero(not_last * (d_hi + t1_hi + ce_lo - pack(NE, False)
                                  - ce_hi * (1 << 16)))
        # a' = t1 + t2,  t2 = Σ0 + maj
        ca_lo = carry_val("ca", 0, 3)
        ca_hi = carry_val("ca", 3, 3)
        b.assert_zero(not_last * (t1_lo + s0v_lo + majv_lo - pack(NA, True)
                                  - ca_lo * (1 << 16)))
        b.assert_zero(not_last * (t1_hi + s0v_hi + majv_hi + ca_lo
                                  - pack(NA, False) - ca_hi * (1 << 16)))
        # shifts: b'=a, c'=b, f'=e, g'=f (bitwise), d'=c, h'=g (limbwise)
        b.assert_zero_vec(not_last * (ng("b") - A), 32)
        b.assert_zero_vec(not_last * (ng("c") - B_), 32)
        b.assert_zero_vec(not_last * (ng("f") - E), 32)
        b.assert_zero_vec(not_last * (ng("g") - F), 32)
        b.assert_zero(not_last * (ncol("dh", 0) - pack(C, True)))
        b.assert_zero(not_last * (ncol("dh", 1) - pack(C, False)))
        b.assert_zero(not_last * (ncol("dh", 2) - pack(G_, True)))
        b.assert_zero(not_last * (ncol("dh", 3) - pack(G_, False)))

        # --- message schedule (transition, same gating) ---
        WWIN, NWWIN = g("w_win"), ng("w_win")
        b.assert_zero_vec(not_last * (NWWIN[0:30] - WWIN[2:32]), 30)
        # w[t+16] = σ1(w[t+14]) + w[t+9] + σ0(w[t+1]) + w[t]
        sg0_lo, sg0_hi = pack(SIG0, True), pack(SIG0, False)
        sg1_lo, sg1_hi = pack(SIG1, True), pack(SIG1, False)
        sc_lo = carry_val("sc", 0, 2)
        sc_hi = carry_val("sc", 2, 2)
        b.assert_zero(not_last * (
            sg1_lo + col("w_win", 18) + sg0_lo + w0_lo
            - ncol("w_win", 30) - sc_lo * (1 << 16)))
        b.assert_zero(not_last * (
            sg1_hi + col("w_win", 19) + sg0_hi + w0_hi + sc_lo
            - ncol("w_win", 31) - sc_hi * (1 << 16)))

        # --- block input state persists within the block ---
        b.assert_zero_vec(not_last * (ng("h_state") - g("h_state")), 16)

        # --- dig columns hold the row-local Davies-Meyer output (canonical
        # on each group's last row, where the bus messages read them) ---
        after = [
            (t1_lo + s0v_lo + majv_lo, t1_hi + s0v_hi + majv_hi),  # a*
            (pack(A, True), pack(A, False)),                        # b* = a
            (pack(B_, True), pack(B_, False)),                      # c* = b
            (pack(C, True), pack(C, False)),                        # d* = c
            (d_lo + t1_lo, d_hi + t1_hi),                           # e* = d+t1
            (pack(E, True), pack(E, False)),                        # f* = e
            (pack(F, True), pack(F, False)),                        # g* = f
            (pack(G_, True), pack(G_, False)),                      # h* = g
        ]
        for i in range(8):
            hc_lo = carry_val("hc", 6 * i, 3)
            hc_hi = carry_val("hc", 6 * i + 3, 3)
            b.assert_zero(
                col("h_state", 2 * i) + after[i][0]
                - col("dig", 2 * i) - hc_lo * (1 << 16))
            b.assert_zero(
                col("h_state", 2 * i + 1) + after[i][1] + hc_lo
                - col("dig", 2 * i + 1) - hc_hi * (1 << 16))

        # --- group-constant chaining metadata ---
        for nm in ("obj", "fresh", "has_tag", "tag", "xb", "nh"):
            b.assert_zero(not_last * (ncol(nm) - col(nm)))
        # blk: group-constant, pinned to the block (w_win) on round 0
        b.assert_zero_vec(not_last * (ng("blk") - g("blk")), 32)
        b.assert_zero_vec(is_r0 * (g("blk") - g("w_win")), 32)
        b.assert_bool(col("xb"))
        b.assert_zero_vec(not_last * (ng("seq") - g("seq")), SEQ_BITS)
        b.assert_zero_vec(not_last * (ng("nc") - g("nc")), NC_BITS)
        b.assert_zero(col("tag") * (1 - col("has_tag")))
        # a chain root starts at the IV; everything else must receive its
        # input state over the bus
        fresh = col("fresh")
        for i in range(8):
            lo, hi = _IV[i] & 0xFFFF, _IV[i] >> 16
            b.assert_zero(is_r0 * fresh * (col("h_state", 2 * i) - lo))
            b.assert_zero(is_r0 * fresh * (col("h_state", 2 * i + 1) - hi))

        # --- global bus: chain receive/sends + tagged result publication ---
        gamma = b.challenges[0]

        def dpow(i):
            return b.challenges[1 + i]

        obj_c = col("obj")
        seq_val = b.dot_const(g("seq"), [1 << i for i in range(SEQ_BITS)])
        nc_val = b.dot_const(g("nc"), [1 << i for i in range(NC_BITS)])
        xb = col("xb")
        # xb rides the chain fingerprints (recv at seq, send at seq+1), so
        # a chain is expose-flagged as a whole; the verifier pins the
        # stream chain's flag through the tagged-result payload
        fp_recv = (ExtVal.from_base(BUS_SHA_STATE) + dpow(0) * obj_c
                   + dpow(1) * seq_val + dpow(2) * xb)
        fp_send = (ExtVal.from_base(BUS_SHA_STATE) + dpow(0) * obj_c
                   + dpow(1) * (seq_val + 1) + dpow(2) * xb)
        fp_res = (ExtVal.from_base(BUS_SHA_RESULT) + dpow(0) * col("tag")
                  + dpow(17) * xb)
        for i in range(16):
            fp_recv = fp_recv + dpow(3 + i) * col("h_state", i)
            fp_send = fp_send + dpow(3 + i) * col("dig", i)
            fp_res = fp_res + dpow(1 + i) * col("dig", i)
        # message-block halves (valid on round-0 rows, where the schedule
        # window w_win holds w[0..16) = the block words)
        fp_b0 = (ExtVal.from_base(BUS_SHA_BLOCK) + dpow(0) * obj_c
                 + dpow(1) * seq_val)
        fp_b1 = (ExtVal.from_base(BUS_SHA_BLOCK) + dpow(0) * obj_c
                 + dpow(1) * seq_val + dpow(2) * 1)
        for i in range(16):
            fp_b0 = fp_b0 + dpow(3 + i) * col("w_win", i)
            fp_b1 = fp_b1 + dpow(3 + i) * col("w_win", 16 + i)
        # atomic hop statement: compress(in, block) = out — value-level,
        # chain-coordinate-free (see stark/bus.py BUS_SHA_HOP)
        fp_hop = ExtVal.from_base(BUS_SHA_HOP)
        for i in range(16):
            fp_hop = fp_hop + dpow(i) * col("h_state", i)
            fp_hop = fp_hop + dpow(48 + i) * col("dig", i)
        for i in range(32):
            fp_hop = fp_hop + dpow(16 + i) * col("blk", i)
        inv_recv = b.perm_ext(0)
        inv_send = b.perm_ext(1)
        inv_res = b.perm_ext(2)
        inv_b0 = b.perm_ext(3)
        inv_b1 = b.perm_ext(4)
        inv_hop = b.perm_ext(5)
        u = b.perm_ext(6)
        acc = b.perm_ext(7)
        u_n = b.perm_ext(6, nxt=True)
        acc_n = b.perm_ext(7, nxt=True)
        b.assert_ext_zero(inv_recv * (gamma - fp_recv) - 1)
        b.assert_ext_zero(inv_send * (gamma - fp_send) - 1)
        b.assert_ext_zero(inv_res * (gamma - fp_res) - 1)
        b.assert_ext_zero(inv_b0 * (gamma - fp_b0) - 1)
        b.assert_ext_zero(inv_b1 * (gamma - fp_b1) - 1)
        b.assert_ext_zero(inv_hop * (gamma - fp_hop) - 1)
        u_def = (inv_send * nc_val + inv_res * col("has_tag")
                 + inv_hop * col("nh")) * is_last \
            + (inv_b0 + inv_b1) * (is_r0 * xb) \
            - inv_recv * ((1 - fresh) * is_r0)
        b.assert_ext_zero(u - u_def)
        b.assert_ext_zero((acc - u) * b.is_first_row)
        b.assert_ext_zero((acc_n - acc - u_n) * b.is_transition)
        for ell in range(4):
            b.when_last_row(acc.c[ell] - b.public[ell])

    # ------------------------------------------------------------------

    def generate_perm_trace(self, main, publics, challenges):
        L = LAYOUT
        n = main.shape[0]
        obj = main[:, L["obj"].start].astype(np.uint64)
        seq = np.zeros(n, np.uint64)
        for k in range(SEQ_BITS):
            seq += main[:, L["seq"].start + k].astype(np.uint64) << k
        nc = np.zeros(n, np.uint64)
        for k in range(NC_BITS):
            nc += main[:, L["nc"].start + k].astype(np.uint64) << k
        fresh = main[:, L["fresh"].start].astype(np.uint64)
        has_tag = main[:, L["has_tag"].start].astype(np.uint64)
        tag = main[:, L["tag"].start].astype(np.uint64)
        xb = main[:, L["xb"].start].astype(np.uint64)
        hs = main[:, L["h_state"]].astype(np.uint64)
        dg = main[:, L["dig"]].astype(np.uint64)
        wwin = main[:, L["w_win"]].astype(np.uint64)
        recv_pl = np.concatenate([obj[:, None], seq[:, None], xb[:, None],
                                  hs], axis=1)
        send_pl = np.concatenate([obj[:, None], ((seq + 1) % P)[:, None],
                                  xb[:, None], dg], axis=1)
        res_pl = np.concatenate([tag[:, None], dg, xb[:, None]], axis=1)
        b0_pl = np.concatenate([obj[:, None], seq[:, None],
                                np.zeros((n, 1), dtype=np.uint64),
                                wwin[:, :16]], axis=1)
        b1_pl = np.concatenate([obj[:, None], seq[:, None],
                                np.ones((n, 1), dtype=np.uint64),
                                wwin[:, 16:]], axis=1)
        inv_recv = np_bus_inverse_terms(challenges, BUS_SHA_STATE, recv_pl)
        inv_send = np_bus_inverse_terms(challenges, BUS_SHA_STATE, send_pl)
        inv_res = np_bus_inverse_terms(challenges, BUS_SHA_RESULT, res_pl)
        inv_b0 = np_bus_inverse_terms(challenges, BUS_SHA_BLOCK, b0_pl)
        inv_b1 = np_bus_inverse_terms(challenges, BUS_SHA_BLOCK, b1_pl)
        nh = main[:, L["nh"].start].astype(np.uint64)
        blk = main[:, L["blk"]].astype(np.uint64)
        hop_pl = np.concatenate([hs, blk, dg], axis=1)
        inv_hop = np_bus_inverse_terms(challenges, BUS_SHA_HOP, hop_pl)
        t = np.arange(n) % ROWS_PER_BLOCK
        is_r0 = (t == 0).astype(np.uint64)[:, None]
        is_last = (t == ROWS_PER_BLOCK - 1).astype(np.uint64)[:, None]
        pos = (is_last * ((nc[:, None] * inv_send
                           + has_tag[:, None] * inv_res
                           + nh[:, None] * inv_hop) % P)
               + is_r0 * xb[:, None]
               * ((inv_b0.astype(np.uint64)
                   + inv_b1.astype(np.uint64)) % P)) % P
        neg = (is_r0 * ((1 - fresh)[:, None]) * inv_recv) % P
        u = (pos + P - neg) % P
        acc = np.cumsum(u, axis=0) % P
        return np.concatenate(
            [inv_recv, inv_send, inv_res, inv_b0, inv_b1, inv_hop, u,
             acc], axis=1).astype(np.uint32)


# ---------------------------------------------------------------------------
# witness generation (vectorized across blocks)
# ---------------------------------------------------------------------------


def _rotr(x, n):
    return ((x >> n) | (x << (32 - n))) & 0xFFFFFFFF


def _children_counts(events) -> list[int]:
    """Post-pass: how many later compressions consume each event's output
    ((obj, seq+1, state_out) received by children with matching state_in).
    Identical producers split the consumer count arbitrarily."""
    consumers: dict[tuple, int] = {}
    for e in events:
        if e.seq > 0:
            key = (e.obj, e.seq, e.state_in)
            consumers[key] = consumers.get(key, 0) + 1
    out = []
    for e in events:
        key = (e.obj, e.seq + 1, e.state_out)
        take = min(consumers.get(key, 0), (1 << NC_BITS) - 1)
        consumers[key] = consumers.get(key, 0) - take
        out.append(take)
    if any(v > 0 for v in consumers.values()):
        raise ValueError(
            "SHA event stream inconsistent: a compression's input state "
            "has no producer (or one producer exceeds the child limit)")
    return out


def sha256_trace(events, min_log_n: int = 6, hop_counts=None):
    """Build the chip trace from CompressionEvents (with obj/seq/result_tag
    chaining metadata).  The trace is padded at the FRONT with fresh
    IV-rooted zero-block compressions (nc = 0) to a power-of-two height.
    Returns (trace (n, width) uint32, public_values [] — the machine
    appends the bus sum).

    hop_counts: {(state_in, block): count} — BUS_SHA_HOP consumption
    counts from composition chips (the key-schedule chip); each tuple's
    count is assigned to its first matching event (leftovers raise)."""
    from ...guest.crypto.sha256 import CompressionEvent

    if not events:
        raise ValueError("need at least one compression")
    events = list(events)
    nh_real = [0] * len(events)
    if hop_counts:
        remaining = dict(hop_counts)
        for i, e in enumerate(events):
            key = (tuple(e.state_in), bytes(e.block))
            if key in remaining:
                nh_real[i] = remaining.pop(key)
        if any(remaining.values()):
            raise ValueError("consumed SHA hop has no recorded event")
    nc_real = _children_counts(events)
    n_real = len(events)
    n_rows = n_real * ROWS_PER_BLOCK
    log_n = max(min_log_n, (n_rows - 1).bit_length())
    n = 1 << log_n
    n_blocks = n // ROWS_PER_BLOCK
    pad = n_blocks - n_real
    pad_ev = CompressionEvent(block=b"\x00" * 64, state_in=_IV,
                              state_out=_IV, obj=0, seq=0)
    all_events = [pad_ev] * pad + events
    nc_all = [0] * pad + nc_real
    blocks = [(e.block, e.state_in) for e in all_events]

    B = n_blocks
    # message schedule w[0..80) per block
    w = np.zeros((B, 80), dtype=np.uint64)
    for bidx, (blk, _st) in enumerate(blocks):
        w[bidx, :16] = np.frombuffer(blk, dtype=">u4").astype(np.uint64)
    for t in range(16, 80):
        s0 = _rotr(w[:, t - 15], 7) ^ _rotr(w[:, t - 15], 18) ^ (w[:, t - 15] >> 3)
        s1 = _rotr(w[:, t - 2], 17) ^ _rotr(w[:, t - 2], 19) ^ (w[:, t - 2] >> 10)
        w[:, t] = (w[:, t - 16] + s0 + w[:, t - 7] + s1) & 0xFFFFFFFF

    # round evolution: vars[t] = (a..h) before round t, for t = 0..64
    vars_ = np.zeros((B, 65, 8), dtype=np.uint64)
    state_in = np.array([st for _b, st in blocks], dtype=np.uint64)
    vars_[:, 0, :] = state_in
    K = np.array(_K, dtype=np.uint64)
    for t in range(64):
        a, bb_, c, d, e, f, g, h = (vars_[:, t, i] for i in range(8))
        S1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g) & 0xFFFFFFFF
        t1 = (h + S1 + ch + K[t] + w[:, t]) & 0xFFFFFFFF
        S0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & bb_) ^ (a & c) ^ (bb_ & c)
        t2 = (S0 + maj) & 0xFFFFFFFF
        vars_[:, t + 1] = np.stack(
            [(t1 + t2) & 0xFFFFFFFF, a, bb_, c, (d + t1) & 0xFFFFFFFF,
             e, f, g], axis=1)

    digest = (state_in + vars_[:, 64]) & 0xFFFFFFFF

    # --- fill columns ---
    L = LAYOUT
    trace = np.zeros((n, L.width), dtype=np.uint32)
    t_idx = np.tile(np.arange(64), B)
    b_idx = np.repeat(np.arange(B), 64)

    def setbits(name, words):
        sl = L[name]
        for k in range(32):
            trace[:, sl.start + k] = ((words >> k) & 1).astype(np.uint32)

    va = vars_[b_idx, t_idx]  # (n, 8) current-round vars
    setbits("a", va[:, 0])
    setbits("b", va[:, 1])
    setbits("c", va[:, 2])
    setbits("e", va[:, 4])
    setbits("f", va[:, 5])
    setbits("g", va[:, 6])
    trace[:, L["dh"].start + 0] = (va[:, 3] & 0xFFFF).astype(np.uint32)
    trace[:, L["dh"].start + 1] = (va[:, 3] >> 16).astype(np.uint32)
    trace[:, L["dh"].start + 2] = (va[:, 7] & 0xFFFF).astype(np.uint32)
    trace[:, L["dh"].start + 3] = (va[:, 7] >> 16).astype(np.uint32)

    e_, f_, g_ = va[:, 4], va[:, 5], va[:, 6]
    a_, b2_, c_ = va[:, 0], va[:, 1], va[:, 2]
    S1w = _rotr(e_, 6) ^ _rotr(e_, 11) ^ _rotr(e_, 25)
    chw = (e_ & f_) ^ (~e_ & g_) & 0xFFFFFFFF
    S0w = _rotr(a_, 2) ^ _rotr(a_, 13) ^ _rotr(a_, 22)
    majw = (a_ & b2_) ^ (a_ & c_) ^ (b2_ & c_)
    setbits("s1", S1w)
    setbits("ch", chw)
    setbits("s0", S0w)
    setbits("maj", majw)

    # window + schedule bits
    for j in range(16):
        wj = w[b_idx, t_idx + j]
        trace[:, L["w_win"].start + 2 * j] = (wj & 0xFFFF).astype(np.uint32)
        trace[:, L["w_win"].start + 2 * j + 1] = (wj >> 16).astype(np.uint32)
    w1w = w[b_idx, t_idx + 1]
    w14w = w[b_idx, t_idx + 14]
    setbits("w1", w1w)
    setbits("w14", w14w)
    sg0 = _rotr(w1w, 7) ^ _rotr(w1w, 18) ^ (w1w >> 3)
    sg1 = _rotr(w14w, 17) ^ _rotr(w14w, 19) ^ (w14w >> 10)
    setbits("sig0", sg0)
    setbits("sig1", sg1)

    def setcarry(name, off, nb, vals):
        sl = L[name]
        for i in range(nb):
            trace[:, sl.start + off + i] = ((vals >> i) & 1).astype(np.uint32)

    # schedule carries: w[t+16] addition
    wnew = w[b_idx, t_idx + 16]
    lo_sum = (sg1 & 0xFFFF) + (w[b_idx, t_idx + 9] & 0xFFFF) + \
        (sg0 & 0xFFFF) + (w[b_idx, t_idx] & 0xFFFF)
    sc_lo = (lo_sum - (wnew & 0xFFFF)) >> 16
    hi_sum = (sg1 >> 16) + (w[b_idx, t_idx + 9] >> 16) + (sg0 >> 16) + \
        (w[b_idx, t_idx] >> 16) + sc_lo
    sc_hi = (hi_sum - (wnew >> 16)) >> 16
    setcarry("sc", 0, 2, sc_lo)
    setcarry("sc", 2, 2, sc_hi)

    # round carries: e' and a'
    d_, h_ = va[:, 3], va[:, 7]
    Kt = K[t_idx]
    t1_lo = (h_ & 0xFFFF) + (S1w & 0xFFFF) + (chw & 0xFFFF) + \
        (Kt & 0xFFFF) + (w[b_idx, t_idx] & 0xFFFF)
    t1_hi = (h_ >> 16) + (S1w >> 16) + (chw >> 16) + (Kt >> 16) + \
        (w[b_idx, t_idx] >> 16)
    nxt = vars_[b_idx, t_idx + 1]  # post-round vars
    ne_, na_ = nxt[:, 4], nxt[:, 0]
    ce_lo = ((d_ & 0xFFFF) + t1_lo - (ne_ & 0xFFFF)) >> 16
    ce_hi = ((d_ >> 16) + t1_hi + ce_lo - (ne_ >> 16)) >> 16
    setcarry("ce", 0, 3, ce_lo)
    setcarry("ce", 3, 3, ce_hi)
    ca_lo = (t1_lo + (S0w & 0xFFFF) + (majw & 0xFFFF) - (na_ & 0xFFFF)) >> 16
    ca_hi = (t1_hi + (S0w >> 16) + (majw >> 16) + ca_lo - (na_ >> 16)) >> 16
    setcarry("ca", 0, 3, ca_lo)
    setcarry("ca", 3, 3, ca_hi)

    # block input state
    for i in range(8):
        trace[:, L["h_state"].start + 2 * i] = \
            (state_in[b_idx, i] & 0xFFFF).astype(np.uint32)
        trace[:, L["h_state"].start + 2 * i + 1] = \
            (state_in[b_idx, i] >> 16).astype(np.uint32)

    # Davies-Meyer carries (constrained only on the global last row, but
    # filled everywhere with the row-local would-be values)
    after_lo = np.empty((n, 8), dtype=np.uint64)
    after_hi = np.empty((n, 8), dtype=np.uint64)
    after_lo[:, 0] = t1_lo + (S0w & 0xFFFF) + (majw & 0xFFFF)
    after_hi[:, 0] = t1_hi + (S0w >> 16) + (majw >> 16)
    after_lo[:, 4] = (d_ & 0xFFFF) + t1_lo
    after_hi[:, 4] = (d_ >> 16) + t1_hi
    for i, src in ((1, a_), (2, b2_), (3, c_), (5, e_), (6, f_), (7, g_)):
        after_lo[:, i] = src & 0xFFFF
        after_hi[:, i] = src >> 16
    # carries + dig columns, kept mutually consistent on every row (the
    # dig value is canonical — the true digest limb — on last rows, where
    # the carry arithmetic is exact)
    dig = digest[b_idx]  # (n, 8): digest of the row's own block
    for i in range(8):
        hlo = (state_in[b_idx, i] & 0xFFFF).astype(np.int64)
        hhi = (state_in[b_idx, i] >> 16).astype(np.int64)
        alo = after_lo[:, i].astype(np.int64)
        ahi = after_hi[:, i].astype(np.int64)
        dlo = (dig[:, i] & 0xFFFF).astype(np.int64)
        dhi = (dig[:, i] >> 16).astype(np.int64)
        hc_lo = ((hlo + alo - dlo) >> 16) & 7
        hc_hi = ((hhi + ahi + hc_lo - dhi) >> 16) & 7
        setcarry("hc", 6 * i, 3, hc_lo)
        setcarry("hc", 6 * i + 3, 3, hc_hi)
        trace[:, L["dig"].start + 2 * i] = \
            ((hlo + alo - (hc_lo << 16)) % P).astype(np.uint32)
        trace[:, L["dig"].start + 2 * i + 1] = \
            ((hhi + ahi + hc_lo - (hc_hi << 16)) % P).astype(np.uint32)

    # chaining / bus metadata (group-constant)
    obj_b = np.array([e.obj for e in all_events], dtype=np.int64)
    seq_b = np.array([e.seq for e in all_events], dtype=np.int64)
    if (seq_b >= 1 << SEQ_BITS).any():
        raise ValueError("compression chain too deep for SEQ_BITS")
    nc_b = np.array(nc_all, dtype=np.int64)
    tag_b = np.array([e.result_tag for e in all_events], dtype=np.int64)
    trace[:, L["obj"].start] = (obj_b % P)[b_idx].astype(np.uint32)
    for k in range(SEQ_BITS):
        trace[:, L["seq"].start + k] = \
            ((seq_b[b_idx] >> k) & 1).astype(np.uint32)
    trace[:, L["fresh"].start] = (seq_b == 0)[b_idx].astype(np.uint32)
    for k in range(NC_BITS):
        trace[:, L["nc"].start + k] = \
            ((nc_b[b_idx] >> k) & 1).astype(np.uint32)
    trace[:, L["has_tag"].start] = (tag_b != 0)[b_idx].astype(np.uint32)
    trace[:, L["tag"].start] = (tag_b % P)[b_idx].astype(np.uint32)
    xb_b = np.array([getattr(e, "expose_block", 0) for e in all_events],
                    dtype=np.int64)
    trace[:, L["xb"].start] = (xb_b != 0)[b_idx].astype(np.uint32)
    # hop multiplicities + the group-constant block-limb copy
    nh_b = np.array([0] * pad + nh_real, dtype=np.int64)
    trace[:, L["nh"].start] = (nh_b % P)[b_idx].astype(np.uint32)
    blk16 = np.zeros((B, 32), dtype=np.uint32)
    for i in range(16):
        blk16[:, 2 * i] = (w[:, i] & 0xFFFF).astype(np.uint32)
        blk16[:, 2 * i + 1] = (w[:, i] >> 16).astype(np.uint32)
    trace[:, L["blk"]] = blk16[b_idx]
    return trace, []
