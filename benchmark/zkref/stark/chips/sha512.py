"""SHA-512 compression AIR chip — the 64-bit sibling of Sha256Air, proving
the SHA-384 suites' transcript/PRF/HKDF compressions (0xC030, 0xC02C,
0x1302 — offered by the reference client, request.rs:25-27; the guest's
rustls-rustcrypto sha2 covers the whole family, SURVEY.md §2.2.A).

Layout: one row per SHA-512 round; since 80 rounds don't divide a
power-of-two trace, blocks occupy 128-row groups — rounds on rows 0..79,
rows 80..127 idle (no constraints touch the working variables there; the
committed digest `dig` is group-constant and pinned to the Davies-Meyer
sum on row 79, so the bus messages on the group's last row read the true
digest).  64-bit words are four 16-bit limbs; rotation/boolean operands
are bit-decomposed.  Chaining/publication mirrors Sha256Air exactly
(IV-rooted (obj, seq) chains over BUS_SHA512_STATE, tagged results over
BUS_SHA512_RESULT), with one addition: chains may root at the SHA-384 IV
(iv384 flag, carried in the chain fingerprints so a chain's hash family
is pinned end-to-end).

Port copy of zktls_tpu.stark.chips.sha512 (same names and values; host code
in numpy).
"""

from __future__ import annotations

import numpy as np

from ...guest.crypto.sha512 import _IV384, _IV512, _K512
from ...ops.field_ref import P
from ..air import Air, AirBuilder
from ..bus import BUS_SHA512_RESULT, BUS_SHA512_STATE, np_bus_inverse_terms
from ..ext_val import ExtVal

__all__ = ["Sha512Air", "sha512_trace", "GROUP_ROWS", "N_ROUNDS"]

GROUP_ROWS = 128
N_ROUNDS = 80
SEQ_BITS = 16
NC_BITS = 5
_M64 = (1 << 64) - 1


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
        L.add(v, 64)
    L.add("dh", 8)            # d, h as 4 limbs each
    for v in ("s0", "s1", "maj", "ch"):
        L.add(v, 64)
    L.add("w_win", 64)        # 16 words × 4 limbs
    L.add("w1", 64)
    L.add("w14", 64)
    L.add("sig0", 64)
    L.add("sig1", 64)
    L.add("sc", 8)            # schedule carries: 4 limbs × 2 bits
    L.add("ce", 12)           # e' carries: 4 limbs × 3 bits
    L.add("ca", 12)           # a' carries
    L.add("h_state", 32)      # H0..H7 × 4 limbs (group-constant)
    L.add("hc", 96)           # 8 words × 4 limbs × 3 carry bits (row 79)
    L.add("obj", 1)
    L.add("seq", SEQ_BITS)
    L.add("fresh", 1)
    L.add("iv384", 1)         # chain rooted at the SHA-384 IV
    L.add("nc", NC_BITS)
    L.add("has_tag", 1)
    L.add("tag", 1)
    L.add("dig", 32)          # Davies-Meyer output limbs (group-constant)
    return L


LAYOUT = _build_layout()


class Sha512Air(Air):
    width = LAYOUT.width
    num_public = 0
    max_constraint_degree = 3
    #: inv_recv ‖ inv_send ‖ inv_res ‖ u ‖ acc
    perm_width = 20
    num_perm_challenges = 2
    has_bus = True

    def periodic_columns(self) -> list:
        k = np.zeros(GROUP_ROWS, dtype=np.uint64)
        k[:N_ROUNDS] = np.array(_K512, dtype=np.uint64)
        cols = [((k >> np.uint64(16 * i)) & np.uint64(0xFFFF)
                 ).astype(np.uint32) for i in range(4)]
        z = np.zeros(GROUP_ROWS, dtype=np.uint32)
        is_last = z.copy(); is_last[GROUP_ROWS - 1] = 1
        is_r0 = z.copy(); is_r0[0] = 1
        p_r79 = z.copy(); p_r79[N_ROUNDS - 1] = 1
        p_round = z.copy(); p_round[: N_ROUNDS - 1] = 1   # rows 0..78
        return cols + [is_last, is_r0, p_r79, p_round]

    # ------------------------------------------------------------------

    def eval(self, b: AirBuilder) -> None:
        L = LAYOUT
        k0, k1, k2, k3 = b.periodic[:4]
        is_last, is_r0, p_r79, p_round = b.periodic[4:8]
        not_last = 1 - is_last
        k_limb = [k0, k1, k2, k3]
        tr = b.is_transition

        POW16 = [1 << i for i in range(16)]

        def g(name):
            return b.local_group(L[name])

        def ng(name):
            return b.next_group(L[name])

        def col(name, i=0):
            return b.local[L[name].start + i]

        def ncol(name, i=0):
            return b.next[L[name].start + i]

        def pack(grp, part):
            return b.dot_const(grp[16 * part:16 * part + 16], POW16)

        def carry_val(name, off, nb):
            sl = slice(L[name].start + off, L[name].start + off + nb)
            return b.dot_const(b.local_group(sl),
                               [1 << i for i in range(nb)])

        def xor3v(x, y, z):
            return x + y + z - 2 * (x * y + y * z + x * z) + 4 * (x * y * z)

        A, B_, C = g("a"), g("b"), g("c")
        E, F, G_ = g("e"), g("f"), g("g")
        S0, S1, MAJ, CH = g("s0"), g("s1"), g("maj"), g("ch")
        W1, W14 = g("w1"), g("w14")
        SIG0, SIG1 = g("sig0"), g("sig1")

        # --- booleanity ---
        for grp, k in ((A, 64), (B_, 64), (C, 64), (E, 64), (F, 64),
                       (G_, 64), (W1, 64), (W14, 64),
                       (g("sc"), 8), (g("ce"), 12), (g("ca"), 12),
                       (g("hc"), 96), (g("seq"), SEQ_BITS),
                       (g("nc"), NC_BITS)):
            b.assert_zero_vec(grp * (grp - 1), k)
        for c in (col("fresh"), col("has_tag"), col("iv384")):
            b.assert_bool(c)

        # --- boolean functions (FIPS 180-4 §4.1.3), every row ---
        b.assert_zero_vec(
            S1 - xor3v(E.roll(-14), E.roll(-18), E.roll(-41)), 64)
        b.assert_zero_vec(
            S0 - xor3v(A.roll(-28), A.roll(-34), A.roll(-39)), 64)
        b.assert_zero_vec(CH - (E * F + G_ - E * G_), 64)
        b.assert_zero_vec(
            MAJ - (A * B_ + A * C + B_ * C - 2 * (A * B_ * C)), 64)
        shr7 = W1.roll(-7) * b.const_vec([1] * 57 + [0] * 7)
        b.assert_zero_vec(
            SIG0 - xor3v(W1.roll(-1), W1.roll(-8), shr7), 64)
        shr6 = W14.roll(-6) * b.const_vec([1] * 58 + [0] * 6)
        b.assert_zero_vec(
            SIG1 - xor3v(W14.roll(-19), W14.roll(-61), shr6), 64)

        # --- w1/w14 bits pack to window words 1 and 14, every row ---
        for part in range(4):
            b.assert_zero(pack(W1, part) - col("w_win", 4 + part))
            b.assert_zero(pack(W14, part) - col("w_win", 56 + part))

        # --- round-0 rows: working vars equal the block input state ---
        def var_limb(i, part):
            if i == 3:
                return col("dh", part)
            if i == 7:
                return col("dh", 4 + part)
            grp = (A, B_, C, None, E, F, G_, None)[i]
            return pack(grp, part)

        for i in range(8):
            for part in range(4):
                b.assert_zero(is_r0 * (var_limb(i, part)
                                       - col("h_state", 4 * i + part)))

        # --- round additions (rows 0..78 transitions only) ---
        NE, NA = ng("e"), ng("a")

        def add_chain(terms_by_limb, out_limb, cname, nbits):
            carry = 0
            for part in range(4):
                cv = carry_val(cname, nbits * part, nbits)
                s = carry
                for t in terms_by_limb[part]:
                    s = s + t
                b.assert_zero(tr * p_round * (s - out_limb(part)
                                              - cv * (1 << 16)))
                carry = cv

        # e' = d + h + Σ1 + ch + K + w
        add_chain(
            [[col("dh", part), col("dh", 4 + part), pack(S1, part),
              pack(CH, part), k_limb[part], col("w_win", part)]
             for part in range(4)],
            lambda part: pack(NE, part), "ce", 3)
        # a' = h + Σ1 + ch + K + w + Σ0 + maj
        add_chain(
            [[col("dh", 4 + part), pack(S1, part), pack(CH, part),
              k_limb[part], col("w_win", part), pack(S0, part),
              pack(MAJ, part)]
             for part in range(4)],
            lambda part: pack(NA, part), "ca", 3)
        # shifts
        b.assert_zero_vec(tr * p_round * (ng("b") - A), 64)
        b.assert_zero_vec(tr * p_round * (ng("c") - B_), 64)
        b.assert_zero_vec(tr * p_round * (ng("f") - E), 64)
        b.assert_zero_vec(tr * p_round * (ng("g") - F), 64)
        for part in range(4):
            b.assert_zero(tr * p_round * (ncol("dh", part)
                                          - pack(C, part)))
            b.assert_zero(tr * p_round * (ncol("dh", 4 + part)
                                          - pack(G_, part)))

        # --- message schedule (rows 0..78 transitions) ---
        WWIN, NWWIN = g("w_win"), ng("w_win")
        b.assert_zero_vec(tr * p_round * (NWWIN[0:60] - WWIN[4:64]), 60)
        carry = 0
        for part in range(4):
            cv = carry_val("sc", 2 * part, 2)
            s = (pack(SIG1, part) + col("w_win", 36 + part)
                 + pack(SIG0, part) + col("w_win", part) + carry)
            b.assert_zero(tr * p_round * (s - ncol("w_win", 60 + part)
                                          - cv * (1 << 16)))
            carry = cv

        # --- group-constant columns ---
        b.assert_zero_vec(tr * not_last * (ng("h_state") - g("h_state")),
                          32)
        b.assert_zero_vec(tr * not_last * (ng("dig") - g("dig")), 32)
        for nm in ("obj", "fresh", "has_tag", "tag", "iv384"):
            b.assert_zero(tr * not_last * (ncol(nm) - col(nm)))
        b.assert_zero_vec(tr * not_last * (ng("seq") - g("seq")), SEQ_BITS)
        b.assert_zero_vec(tr * not_last * (ng("nc") - g("nc")), NC_BITS)
        b.assert_zero(col("tag") * (1 - col("has_tag")))

        # --- Davies-Meyer pin on row 79 ---
        def after_limb(i, part):
            if i == 0:   # a* = t1 + t2
                return (col("dh", 4 + part) + pack(S1, part)
                        + pack(CH, part) + k_limb[part]
                        + col("w_win", part) + pack(S0, part)
                        + pack(MAJ, part))
            if i == 4:   # e* = d + t1
                return (col("dh", part) + col("dh", 4 + part)
                        + pack(S1, part) + pack(CH, part) + k_limb[part]
                        + col("w_win", part))
            src = (None, A, B_, C, None, E, F, G_)[i]
            return pack(src, part)

        for i in range(8):
            carry = 0
            for part in range(4):
                cv = carry_val("hc", 12 * i + 3 * part, 3)
                b.assert_zero(p_r79 * (
                    col("h_state", 4 * i + part) + after_limb(i, part)
                    + carry - col("dig", 4 * i + part) - cv * (1 << 16)))
                carry = cv

        # --- chain roots pin the IV (SHA-512 or SHA-384 per iv384) ---
        fresh, iv384 = col("fresh"), col("iv384")
        for i in range(8):
            for part in range(4):
                lo512 = (_IV512[i] >> (16 * part)) & 0xFFFF
                lo384 = (_IV384[i] >> (16 * part)) & 0xFFFF
                b.assert_zero(is_r0 * fresh * (
                    col("h_state", 4 * i + part) - lo512
                    - iv384 * (lo384 - lo512)))

        # --- global bus ---
        gamma = b.challenges[0]

        def dpow(i):
            return b.challenges[1 + i]

        obj_c = col("obj")
        seq_val = b.dot_const(g("seq"), [1 << i for i in range(SEQ_BITS)])
        nc_val = b.dot_const(g("nc"), [1 << i for i in range(NC_BITS)])
        fp_recv = (ExtVal.from_base(BUS_SHA512_STATE) + dpow(0) * obj_c
                   + dpow(1) * seq_val + dpow(2) * iv384)
        fp_send = (ExtVal.from_base(BUS_SHA512_STATE) + dpow(0) * obj_c
                   + dpow(1) * (seq_val + 1) + dpow(2) * iv384)
        fp_res = (ExtVal.from_base(BUS_SHA512_RESULT)
                  + dpow(0) * col("tag"))
        for i in range(32):
            fp_recv = fp_recv + dpow(3 + i) * col("h_state", i)
            fp_send = fp_send + dpow(3 + i) * col("dig", i)
            fp_res = fp_res + dpow(1 + i) * col("dig", i)
        inv_recv = b.perm_ext(0)
        inv_send = b.perm_ext(1)
        inv_res = b.perm_ext(2)
        u = b.perm_ext(3)
        acc = b.perm_ext(4)
        u_n = b.perm_ext(3, nxt=True)
        acc_n = b.perm_ext(4, nxt=True)
        b.assert_ext_zero(inv_recv * (gamma - fp_recv) - 1)
        b.assert_ext_zero(inv_send * (gamma - fp_send) - 1)
        b.assert_ext_zero(inv_res * (gamma - fp_res) - 1)
        u_def = (inv_send * nc_val + inv_res * col("has_tag")) * is_last \
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
            seq += main[:, L["seq"].start + k].astype(np.uint64) << np.uint64(k)
        nc = np.zeros(n, np.uint64)
        for k in range(NC_BITS):
            nc += main[:, L["nc"].start + k].astype(np.uint64) << np.uint64(k)
        fresh = main[:, L["fresh"].start].astype(np.uint64)
        iv384 = main[:, L["iv384"].start].astype(np.uint64)
        has_tag = main[:, L["has_tag"].start].astype(np.uint64)
        tag = main[:, L["tag"].start].astype(np.uint64)
        hs = main[:, L["h_state"]].astype(np.uint64)
        dg = main[:, L["dig"]].astype(np.uint64)
        recv_pl = np.concatenate([obj[:, None], seq[:, None],
                                  iv384[:, None], hs], axis=1)
        send_pl = np.concatenate([obj[:, None], ((seq + 1) % P)[:, None],
                                  iv384[:, None], dg], axis=1)
        res_pl = np.concatenate([tag[:, None], dg], axis=1)
        inv_recv = np_bus_inverse_terms(challenges, BUS_SHA512_STATE,
                                        recv_pl)
        inv_send = np_bus_inverse_terms(challenges, BUS_SHA512_STATE,
                                        send_pl)
        inv_res = np_bus_inverse_terms(challenges, BUS_SHA512_RESULT,
                                       res_pl)
        t = np.arange(n) % GROUP_ROWS
        is_r0 = (t == 0).astype(np.uint64)[:, None]
        is_last = (t == GROUP_ROWS - 1).astype(np.uint64)[:, None]
        pos = (is_last * ((nc[:, None] * inv_send
                           + has_tag[:, None] * inv_res) % P)) % P
        neg = (is_r0 * ((1 - fresh)[:, None]) * inv_recv) % P
        u = (pos + P - neg) % P
        acc = np.cumsum(u, axis=0) % P
        return np.concatenate(
            [inv_recv, inv_send, inv_res, u, acc], axis=1
        ).astype(np.uint32)


# ---------------------------------------------------------------------------
# witness generation (vectorized across blocks)
# ---------------------------------------------------------------------------


def _rotr64(x, n):
    return (x >> np.uint64(n)) | (x << np.uint64(64 - n))


def _children_counts(events) -> list[int]:
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
            "SHA-512 event stream inconsistent: a compression's input "
            "state has no producer")
    return out


def sha512_trace(events, min_log_n: int = 7):
    """Build the chip trace from Compression512Events.  Front-padded with
    fresh SHA-512-IV zero-block compressions (nc = 0) to a power-of-two
    height.  Returns (trace, [])."""
    from ...guest.crypto.sha512 import Compression512Event

    if not events:
        raise ValueError("need at least one compression")
    events = list(events)
    nc_real = _children_counts(events)
    n_real = len(events)
    n_rows = n_real * GROUP_ROWS
    log_n = max(min_log_n, (n_rows - 1).bit_length())
    n = 1 << log_n
    n_blocks = n // GROUP_ROWS
    pad = n_blocks - n_real
    pad_ev = Compression512Event(block=b"\x00" * 128, state_in=_IV512,
                                 state_out=None, obj=0, seq=0)
    from ...guest.crypto.sha512 import compress512

    pad_ev.state_out = compress512(_IV512, pad_ev.block)
    all_events = [pad_ev] * pad + events
    nc_all = [0] * pad + nc_real

    B = n_blocks
    w = np.zeros((B, 96), dtype=np.uint64)
    for bidx, e in enumerate(all_events):
        w[bidx, :16] = np.frombuffer(e.block, dtype=">u8").astype(np.uint64)
    for tt in range(16, 96):
        x15 = w[:, tt - 15]
        x2 = w[:, tt - 2]
        s0 = _rotr64(x15, 1) ^ _rotr64(x15, 8) ^ (x15 >> np.uint64(7))
        s1 = _rotr64(x2, 19) ^ _rotr64(x2, 61) ^ (x2 >> np.uint64(6))
        w[:, tt] = w[:, tt - 16] + s0 + w[:, tt - 7] + s1   # uint64 wraps

    vars_ = np.zeros((B, N_ROUNDS + 1, 8), dtype=np.uint64)
    state_in = np.array([e.state_in for e in all_events], dtype=np.uint64)
    vars_[:, 0, :] = state_in
    K = np.array(_K512, dtype=np.uint64)
    old = np.seterr(over="ignore")
    for tt in range(N_ROUNDS):
        a, bb_, c, d, e, f, gg, h = (vars_[:, tt, i] for i in range(8))
        S1 = _rotr64(e, 14) ^ _rotr64(e, 18) ^ _rotr64(e, 41)
        ch = (e & f) ^ (~e & gg)
        t1 = h + S1 + ch + K[tt] + w[:, tt]
        S0 = _rotr64(a, 28) ^ _rotr64(a, 34) ^ _rotr64(a, 39)
        maj = (a & bb_) ^ (a & c) ^ (bb_ & c)
        vars_[:, tt + 1] = np.stack(
            [t1 + S0 + maj, a, bb_, c, d + t1, e, f, gg], axis=1)
    digest = state_in + vars_[:, N_ROUNDS]
    np.seterr(**old)

    # --- fill columns ---
    L = LAYOUT
    trace = np.zeros((n, L.width), dtype=np.uint32)
    rowm = np.arange(n) % GROUP_ROWS
    b_all = np.arange(n) // GROUP_ROWS
    live = rowm < N_ROUNDS               # round rows
    t_idx = np.where(live, rowm, 0)      # round index (0 on idle rows)
    b_idx = b_all

    def limb(words, part):
        return ((words >> np.uint64(16 * part))
                & np.uint64(0xFFFF)).astype(np.uint32)

    def setbits64(name, words):
        sl = L[name]
        for k in range(64):
            trace[:, sl.start + k] = ((words >> np.uint64(k))
                                      & np.uint64(1)).astype(np.uint32)

    lv = live.astype(np.uint64)
    va = vars_[b_idx, t_idx] * lv[:, None]   # zero on idle rows
    setbits64("a", va[:, 0])
    setbits64("b", va[:, 1])
    setbits64("c", va[:, 2])
    setbits64("e", va[:, 4])
    setbits64("f", va[:, 5])
    setbits64("g", va[:, 6])
    for part in range(4):
        trace[:, L["dh"].start + part] = limb(va[:, 3], part)
        trace[:, L["dh"].start + 4 + part] = limb(va[:, 7], part)

    a_, b2_, c_ = va[:, 0], va[:, 1], va[:, 2]
    e_, f_, g_ = va[:, 4], va[:, 5], va[:, 6]
    S1w = _rotr64(e_, 14) ^ _rotr64(e_, 18) ^ _rotr64(e_, 41)
    chw = (e_ & f_) ^ (~e_ & g_)
    S0w = _rotr64(a_, 28) ^ _rotr64(a_, 34) ^ _rotr64(a_, 39)
    majw = (a_ & b2_) ^ (a_ & c_) ^ (b2_ & c_)
    # idle rows: vars are zero → S1/S0/maj = 0, ch = 0 (consistent)
    S1w = S1w * lv
    chw = chw * lv
    S0w = S0w * lv
    majw = majw * lv
    setbits64("s1", S1w)
    setbits64("ch", chw)
    setbits64("s0", S0w)
    setbits64("maj", majw)

    wrow = w[b_idx[:, None], (t_idx[:, None]
                              + np.arange(16)[None, :])] * lv[:, None]
    for j in range(16):
        for part in range(4):
            trace[:, L["w_win"].start + 4 * j + part] = limb(wrow[:, j],
                                                             part)
    w1w = wrow[:, 1]
    w14w = wrow[:, 14]
    setbits64("w1", w1w)
    setbits64("w14", w14w)
    sg0 = (_rotr64(w1w, 1) ^ _rotr64(w1w, 8) ^ (w1w >> np.uint64(7))) * lv
    sg1 = (_rotr64(w14w, 19) ^ _rotr64(w14w, 61)
           ^ (w14w >> np.uint64(6))) * lv
    setbits64("sig0", sg0)
    setbits64("sig1", sg1)

    def setcarry(name, off, nb, vals):
        sl = L[name]
        for i in range(nb):
            trace[:, sl.start + off + i] = ((vals >> i) & 1).astype(
                np.uint32)

    # schedule carries (valid on round rows; idle rows all-zero sums)
    wnew = w[b_idx, t_idx + 16] * lv
    w9 = wrow[:, 9]
    carry = np.zeros(n, dtype=np.int64)
    for part in range(4):
        s = (limb(sg1, part).astype(np.int64)
             + limb(w9, part).astype(np.int64)
             + limb(sg0, part).astype(np.int64)
             + limb(wrow[:, 0], part).astype(np.int64) + carry)
        out = limb(wnew, part).astype(np.int64)
        carry = (s - out) >> 16
        setcarry("sc", 2 * part, 2, carry)

    # round carries: e' and a' (next-row targets; idle rows zero)
    nxt_l = (rowm < N_ROUNDS - 1).astype(np.uint64)
    nx = vars_[b_idx, np.where(rowm < N_ROUNDS - 1, t_idx + 1, 0)] \
        * nxt_l[:, None]
    Kt = K[t_idx] * lv
    d_, h_ = va[:, 3], va[:, 7]
    carry = np.zeros(n, dtype=np.int64)
    for part in range(4):
        s = (limb(d_, part).astype(np.int64)
             + limb(h_, part).astype(np.int64)
             + limb(S1w, part).astype(np.int64)
             + limb(chw, part).astype(np.int64)
             + limb(Kt, part).astype(np.int64)
             + limb(wrow[:, 0], part).astype(np.int64) + carry)
        out = limb(nx[:, 4], part).astype(np.int64)
        carry = np.where(nxt_l > 0, (s - out) >> 16, 0)
        setcarry("ce", 3 * part, 3, carry)
    carry = np.zeros(n, dtype=np.int64)
    for part in range(4):
        s = (limb(h_, part).astype(np.int64)
             + limb(S1w, part).astype(np.int64)
             + limb(chw, part).astype(np.int64)
             + limb(Kt, part).astype(np.int64)
             + limb(wrow[:, 0], part).astype(np.int64)
             + limb(S0w, part).astype(np.int64)
             + limb(majw, part).astype(np.int64) + carry)
        out = limb(nx[:, 0], part).astype(np.int64)
        carry = np.where(nxt_l > 0, (s - out) >> 16, 0)
        setcarry("ca", 3 * part, 3, carry)

    # group constants: h_state, dig
    for i in range(8):
        for part in range(4):
            trace[:, L["h_state"].start + 4 * i + part] = \
                limb(state_in[b_idx, i], part)
            trace[:, L["dig"].start + 4 * i + part] = \
                limb(digest[b_idx, i], part)

    # Davies-Meyer carries on row 79
    r79 = (rowm == N_ROUNDS - 1)
    old = np.seterr(over="ignore")
    after = np.zeros((n, 8), dtype=np.uint64)
    after[:, 0] = h_ + S1w + chw + Kt + wrow[:, 0] + S0w + majw
    after[:, 4] = d_ + h_ + S1w + chw + Kt + wrow[:, 0]
    np.seterr(**old)
    for i, src in ((1, a_), (2, b2_), (3, c_), (5, e_), (6, f_), (7, g_)):
        after[:, i] = src
    # after[0]/after[4] above wrapped mod 2^64, but the AIR sums limbs
    # exactly — recompute limb sums in int64 for the carry chain
    for i in range(8):
        carry = np.zeros(n, dtype=np.int64)
        for part in range(4):
            if i == 0:
                s = (limb(h_, part).astype(np.int64)
                     + limb(S1w, part).astype(np.int64)
                     + limb(chw, part).astype(np.int64)
                     + limb(Kt, part).astype(np.int64)
                     + limb(wrow[:, 0], part).astype(np.int64)
                     + limb(S0w, part).astype(np.int64)
                     + limb(majw, part).astype(np.int64))
            elif i == 4:
                s = (limb(d_, part).astype(np.int64)
                     + limb(h_, part).astype(np.int64)
                     + limb(S1w, part).astype(np.int64)
                     + limb(chw, part).astype(np.int64)
                     + limb(Kt, part).astype(np.int64)
                     + limb(wrow[:, 0], part).astype(np.int64))
            else:
                s = limb(after[:, i], part).astype(np.int64)
            s = s + limb(state_in[b_idx, i], part).astype(np.int64) + carry
            out = limb(digest[b_idx, i], part).astype(np.int64)
            carry = np.where(r79, (s - out) >> 16, 0)
            setcarry("hc", 12 * i + 3 * part, 3, carry)

    # chaining metadata
    obj_b = np.array([e.obj for e in all_events], dtype=np.int64)
    seq_b = np.array([e.seq for e in all_events], dtype=np.int64)
    if (seq_b >= 1 << SEQ_BITS).any():
        raise ValueError("compression chain too deep for SEQ_BITS")
    nc_b = np.array(nc_all, dtype=np.int64)
    tag_b = np.array([e.result_tag for e in all_events], dtype=np.int64)
    iv_b = np.array([e.iv384 for e in all_events], dtype=np.int64)
    trace[:, L["obj"].start] = (obj_b % P)[b_idx].astype(np.uint32)
    for k in range(SEQ_BITS):
        trace[:, L["seq"].start + k] = \
            ((seq_b[b_idx] >> k) & 1).astype(np.uint32)
    trace[:, L["fresh"].start] = (seq_b == 0)[b_idx].astype(np.uint32)
    trace[:, L["iv384"].start] = (iv_b != 0)[b_idx].astype(np.uint32)
    for k in range(NC_BITS):
        trace[:, L["nc"].start + k] = \
            ((nc_b[b_idx] >> k) & 1).astype(np.uint32)
    trace[:, L["has_tag"].start] = (tag_b != 0)[b_idx].astype(np.uint32)
    trace[:, L["tag"].start] = (tag_b % P)[b_idx].astype(np.uint32)
    return trace, []
