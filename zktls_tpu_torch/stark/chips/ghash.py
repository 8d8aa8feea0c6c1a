"""GHASH AIR chip — proves the GF(2^128) authentication-tag polynomial of
the guest's AES-GCM record decryptions (NIST SP 800-38D; the workload the
reference proves inside its AES-GCM precompiles, SURVEY.md §3.4).

GHASH(h, B_1..B_m):  y_0 = 0;  y_i = (y_{i-1} ⊕ B_i) · h  over GF(2^128)
with the GCM reduction polynomial x^128 + x^7 + x^2 + x + 1 (bit-reversed
convention, mirroring `guest/crypto/gcm.py:_ghash_mul`).  The final y_m is
the pre-whitening tag value S; tag = S ⊕ E_K(J0), where E_K(J0) is an AES
block the AES-128 chip proves.

Layout: one row per multiplier bit — 128 rows per block group.  Each group
performs one shift-and-add multiplication z = x·v:

  row i holds (acc, v, x): acc accumulates Σ x_top·v, v is the h-multiple
  (one GCM "xtime" per row: v' = (v >> 1) ⊕ v_0·(0xE1 << 120)), and x
  shifts left one bit per row so its top bit (column 127) is the bit
  consumed this row.  `t = acc ⊕ x_127·v` is materialized per row to keep
  every constraint at degree ≤ 3; the group's product is t on its last row.

Group chaining: at a group boundary the next group restarts acc = 0 and
v = h, and carries h forward unless the next group starts a new GHASH
computation (its row-0 `es` flag is 1, which frees h — each recorded GCM
event contributes one event).  The next group's multiplicand x_row0 is the
witnessed y_prev ⊕ B_i; the data block B_i is recoverable as
x_row0 ⊕ t_prev_last (binding B_i to the transcript bytes crosses chips
via LogUp buses, same round-1 scope note as the SHA-256/AES chips).

Bit convention: column k of a 128-bit group is the coefficient of 2^k of
the big-endian integer (so byte j of the 16-byte string is columns
[8·(15−j), 8·(15−j)+8)).  The global last row binds the final event's S
as 16 public-value bytes.

Port copy of zktls_tpu.stark.chips.ghash (same names and values; host code
in numpy).
"""

from __future__ import annotations

import numpy as np

from ..air import Air, AirBuilder
from ..bus import (
    BUS_GCM_AAD,
    BUS_GCM_CT,
    BUS_GCM_H,
    BUS_GCM_LEN,
    BUS_GCM_MASK,
    BUS_GCM_TAG,
    np_bus_inverse_terms,
)
from ..ext_val import ExtVal

__all__ = ["GhashAir", "ghash_trace", "ROWS_PER_BLOCK"]

P = 2013265921

ROWS_PER_BLOCK = 128

# 0xE1 << 120: the feedback bits of the GCM reduction (integer bit indices)
_E1_BITS = frozenset({127, 126, 125, 120})
POW8 = [1 << i for i in range(8)]


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
    L.add("acc", 128)   # running product accumulator
    L.add("v", 128)     # current h-multiple (shifted per row)
    L.add("x", 128)     # remaining multiplicand bits (shifts left per row)
    L.add("t", 128)     # acc ⊕ x_127·v (materialized; degree control)
    L.add("h", 128)     # the event's hash key, carried through the event
    L.add("es", 1)      # event-start flag (read at group row 0)
    # --- bus metadata ---
    L.add("eid", 1)     # GCM event id (constant through the event)
    L.add("live", 1)    # 1 for real event groups, 0 for padding
    L.add("mask", 128)  # E_K(J0) bits (bound at the event end by the bus)
    L.add("m_start", 1)  # = is_r0·es·live (receive H here)
    L.add("m_end", 1)    # = is_glast·es_next·live (mask recv + tag send)
    # --- round-3 block-binding metadata ---
    L.add("nlb", 1)      # 1 iff this group is the event's LAST block (the
    #                      GHASH length block); group-constant
    L.add("cbi", 1)      # group index within the event (0 = AAD block,
    #                      1..m = ciphertext blocks, m+1 = length block)
    L.add("q", 1)        # boundary-row product (1−es_next)·(1−nlb_next)
    L.add("q2", 1)       # boundary-row product (1−es_next)·nlb_next
    L.add("m_ct", 1)     # = is_glast·q·live  (receive a ct block here)
    L.add("m_len", 1)    # = is_glast·q2·live (receive the length block)
    return L


LAYOUT = _build_layout()


class GhashAir(Air):
    width = LAYOUT.width
    num_public = 0
    max_constraint_degree = 3
    #: inv_h ‖ inv_mask ‖ inv_tag ‖ inv_aad ‖ inv_ct ‖ inv_len ‖ u ‖ acc
    perm_width = 32
    num_perm_challenges = 2
    has_bus = True

    def periodic_columns(self) -> list:
        is_glast = np.zeros(ROWS_PER_BLOCK, dtype=np.uint32)
        is_glast[ROWS_PER_BLOCK - 1] = 1
        is_r0 = np.zeros(ROWS_PER_BLOCK, dtype=np.uint32)
        is_r0[0] = 1
        return [is_glast, is_r0]

    def eval(self, b: AirBuilder) -> None:
        L = LAYOUT
        is_glast, is_r0 = b.periodic[0], b.periodic[1]
        within = 1 - is_glast  # rows 0..126 of each group transition inward

        def loc(name, i):
            return b.local[L[name].start + i]

        def nxt(name, i):
            return b.next[L[name].start + i]

        ACC = b.local_group(L["acc"])
        V = b.local_group(L["v"])
        X = b.local_group(L["x"])
        T = b.local_group(L["t"])
        H = b.local_group(L["h"])
        es = loc("es", 0)
        es_next = b.next[L["es"].start]

        # --- booleanity ---
        for grp in (ACC, V, X, T, H):
            b.assert_zero_vec(grp * (grp - 1), 128)
        b.assert_bool(es)

        # --- t = acc ⊕ (x_127 · v): xor with one operand gated by a bit —
        # a + b·v − 2·a·b·v, degree 3, defined on every row ---
        bit = loc("x", 127)
        b.assert_zero_vec(T - (ACC + bit * V - 2 * (ACC * (bit * V))), 128)

        # --- within-group transitions (gate: 1 − is_glast; the global last
        # row is a group-last row, so the wrap row is excluded) ---
        NACC = b.next_group(L["acc"])
        NX = b.next_group(L["x"])
        NV = b.next_group(L["v"])
        NH = b.next_group(L["h"])

        # acc' = t
        b.assert_zero_vec(within * (NACC - T), 128)
        # x' = x << 1  (column k of x' = column k−1 of x; column 0 = 0)
        x_shift = X.roll(1)  # out[k] = x[k-1]; out[0] = x[127] (masked below)
        mask = b.const_vec([0] + [1] * 127)
        b.assert_zero_vec(within * (NX - mask * x_shift), 128)
        # v' = (v >> 1) ⊕ v_0·E1:  column k of v>>1 is v[k+1] (v[128] = 0)
        v0 = loc("v", 0)
        for k in range(128):
            vshift = loc("v", k + 1) if k < 127 else None
            if k in _E1_BITS:
                if vshift is None:
                    expr = nxt("v", k) - v0
                else:
                    expr = nxt("v", k) - (vshift + v0 - 2 * (vshift * v0))
            else:
                expr = nxt("v", k) - (vshift if vshift is not None else 0)
            b.assert_zero(within * expr)
        # h carries within the group
        b.assert_zero_vec(within * (NH - H), 128)

        # --- group boundary (gate: is_glast · is_transition) ---
        G = is_glast * b.is_transition
        b.assert_zero_vec(G * NACC, 128)           # next acc = 0
        b.assert_zero_vec(G * (NV - NH), 128)      # next v = next h
        # h continuity across groups of one event: free only when the next
        # group starts a new event.  At the wrap row next = row 0, whose
        # es = 1 (first group always starts an event), so no is_transition
        # gate is needed to keep degree ≤ 3.
        b.assert_zero_vec(is_glast * (1 - es_next) * (NH - H), 128)

        # --- first row: first group starts an event with acc = 0, v = h ---
        b.assert_zero_vec(b.is_first_row * ACC, 128)
        b.assert_zero_vec(b.is_first_row * (V - H), 128)
        b.when_first_row(es - 1)

        # --- bus metadata constraints ---
        eid = loc("eid", 0)
        live = loc("live", 0)
        m_start = loc("m_start", 0)
        m_end = loc("m_end", 0)
        MASK = b.local_group(L["mask"])
        NMASK = b.next_group(L["mask"])
        for c in (live, m_start, m_end):
            b.assert_bool(c)
        b.assert_zero_vec(MASK * (MASK - 1), 128)
        # group-constant: eid/live/mask within the group; eid/live carry
        # across group boundaries of the same event
        b.assert_zero(within * (nxt("eid", 0) - eid))
        b.assert_zero(within * (nxt("live", 0) - live))
        b.assert_zero_vec(within * (NMASK - MASK), 128)
        b.assert_zero(is_glast * (1 - es_next) * (nxt("eid", 0) - eid))
        b.assert_zero(is_glast * (1 - es_next) * (nxt("live", 0) - live))
        # receive/send gating: H at the event start, mask+tag at the event
        # end (the wrap row sees es_next = 1 from the constrained first row)
        b.assert_zero(m_start - is_r0 * es * live)
        b.assert_zero(m_end - is_glast * es_next * live)

        # --- block-kind metadata (round 3: every processed block is
        # bus-bound — AAD from the control chip, ciphertext blocks from
        # the GCM data chip, the length block from the control chip) ---
        nlb, cbi = loc("nlb", 0), loc("cbi", 0)
        nlb_next = b.next[L["nlb"].start]
        cbi_next = b.next[L["cbi"].start]
        q, q2 = loc("q", 0), loc("q2", 0)
        m_ct, m_len = loc("m_ct", 0), loc("m_len", 0)
        b.assert_bool(nlb)
        # group-constant; nlb pinned at boundaries by the next group's es
        b.assert_zero(within * (b.next[L["nlb"].start] - nlb))
        b.assert_zero(within * (cbi_next - cbi))
        b.assert_zero(is_glast * live * (nlb - es_next))
        b.assert_zero(is_r0 * es * cbi)
        b.assert_zero(is_glast * (1 - es_next) * (cbi_next - cbi - 1))
        # boundary products, pinned only on group-last rows (elsewhere q,
        # q2 are junk but every use carries an is_glast factor); on the
        # wrap row next = row 0 with es = 1, forcing q = q2 = 0
        b.assert_zero(is_glast * (q - (1 - es_next) * (1 - nlb_next)))
        b.assert_zero(is_glast * (q2 - (1 - es_next) * nlb_next))
        b.assert_zero(m_ct - is_glast * q * live)
        b.assert_zero(m_len - is_glast * q2 * live)

        # --- bus messages (limbs are big-endian 16-bit pairs; bit k of
        # byte j of the 16-byte value sits at column 8·(15−j)+k) ---
        gamma = b.challenges[0]

        def dpow(i):
            return b.challenges[1 + i]

        def limb16(name, j):
            v = None
            for byte_off, scale in ((2 * j, 256), (2 * j + 1, 1)):
                sl = L[name].start + 8 * (15 - byte_off)
                part = b.dot_const(b.local_group(slice(sl, sl + 8)),
                                   [scale << k for k in range(8)])
                v = part if v is None else v + part
            return v

        def tag_limb(j):
            """limb j of t ⊕ mask (the event's authentication tag)."""
            v = None
            for byte_off, scale in ((2 * j, 256), (2 * j + 1, 1)):
                base_col = 8 * (15 - byte_off)
                for k in range(8):
                    tb = loc("t", base_col + k)
                    mb = loc("mask", base_col + k)
                    term = (tb + mb - 2 * (tb * mb)) * (scale << k)
                    v = term if v is None else v + term
            return v

        def blk_limb(j):
            """limb j of the NEXT group's data block B = next.x ⊕ local.t
            (y_prev), evaluated at group-boundary rows."""
            v = None
            for byte_off, scale in ((2 * j, 256), (2 * j + 1, 1)):
                base_col = 8 * (15 - byte_off)
                for k in range(8):
                    nx = b.next[L["x"].start + base_col + k]
                    tb = loc("t", base_col + k)
                    term = (nx + tb - 2 * (nx * tb)) * (scale << k)
                    v = term if v is None else v + term
            return v

        fp_h = ExtVal.from_base(BUS_GCM_H) + dpow(0) * eid
        fp_mask = ExtVal.from_base(BUS_GCM_MASK) + dpow(0) * eid
        fp_tag = ExtVal.from_base(BUS_GCM_TAG) + dpow(0) * eid
        # AAD block: the event's first multiplicand x_row0 (y_prev = 0)
        fp_aad = ExtVal.from_base(BUS_GCM_AAD) + dpow(0) * eid
        # ct / length blocks: received at the boundary INTO their group
        # with the eid shared across the boundary (es_next = 0 there)
        fp_ct = (ExtVal.from_base(BUS_GCM_CT) + dpow(0) * eid
                 + dpow(1) * cbi_next)
        fp_len = ExtVal.from_base(BUS_GCM_LEN) + dpow(0) * eid
        for j in range(8):
            fp_h = fp_h + dpow(1 + j) * limb16("h", j)
            fp_mask = fp_mask + dpow(1 + j) * limb16("mask", j)
            fp_tag = fp_tag + dpow(1 + j) * tag_limb(j)
            fp_aad = fp_aad + dpow(1 + j) * limb16("x", j)
            fp_ct = fp_ct + dpow(2 + j) * blk_limb(j)
            fp_len = fp_len + dpow(1 + j) * blk_limb(j)
        inv_h = b.perm_ext(0)
        inv_mask = b.perm_ext(1)
        inv_tag = b.perm_ext(2)
        inv_aad = b.perm_ext(3)
        inv_ct = b.perm_ext(4)
        inv_len = b.perm_ext(5)
        u = b.perm_ext(6)
        acc = b.perm_ext(7)
        u_n = b.perm_ext(6, nxt=True)
        acc_n = b.perm_ext(7, nxt=True)
        b.assert_ext_zero(inv_h * (gamma - fp_h) - 1)
        b.assert_ext_zero(inv_mask * (gamma - fp_mask) - 1)
        b.assert_ext_zero(inv_tag * (gamma - fp_tag) - 1)
        b.assert_ext_zero(inv_aad * (gamma - fp_aad) - 1)
        b.assert_ext_zero(inv_ct * (gamma - fp_ct) - 1)
        b.assert_ext_zero(inv_len * (gamma - fp_len) - 1)
        u_def = ((inv_tag - inv_mask) * m_end - inv_h * m_start
                 - inv_aad * m_start - inv_ct * m_ct - inv_len * m_len)
        b.assert_ext_zero(u - u_def)
        b.assert_ext_zero((acc - u) * b.is_first_row)
        b.assert_ext_zero((acc_n - acc - u_n) * b.is_transition)
        for ell in range(4):
            b.when_last_row(acc.c[ell] - b.public[ell])

    # ------------------------------------------------------------------

    def generate_perm_trace(self, main, publics, challenges):
        L = LAYOUT
        n = main.shape[0]

        def limbs_of(name):
            out = np.zeros((n, 8), dtype=np.uint64)
            bits = main[:, L[name]].astype(np.uint64)
            for j in range(8):
                for byte_off, scale in ((2 * j, 256), (2 * j + 1, 1)):
                    base_col = 8 * (15 - byte_off)
                    for k in range(8):
                        out[:, j] += bits[:, base_col + k] * (scale << k)
            return out

        eid = main[:, L["eid"].start].astype(np.uint64)[:, None]
        h_l = limbs_of("h")
        mask_l = limbs_of("mask")
        t_bits = main[:, L["t"]].astype(np.uint64)
        m_bits = main[:, L["mask"]].astype(np.uint64)
        x_bits = t_bits ^ m_bits
        tag_l = np.zeros((n, 8), dtype=np.uint64)
        for j in range(8):
            for byte_off, scale in ((2 * j, 256), (2 * j + 1, 1)):
                base_col = 8 * (15 - byte_off)
                for k in range(8):
                    tag_l[:, j] += x_bits[:, base_col + k] * (scale << k)
        inv_h = np_bus_inverse_terms(
            challenges, BUS_GCM_H, np.concatenate([eid, h_l], axis=1))
        inv_mask = np_bus_inverse_terms(
            challenges, BUS_GCM_MASK, np.concatenate([eid, mask_l], axis=1))
        inv_tag = np_bus_inverse_terms(
            challenges, BUS_GCM_TAG, np.concatenate([eid, tag_l], axis=1))
        # x limbs (row-local) for the AAD receive; B = next.x ⊕ t limbs
        # for the ct/length receives at boundary rows
        x_l = limbs_of("x")
        nx_bits = np.roll(main[:, L["x"]].astype(np.uint64), -1, axis=0)
        b_bits = nx_bits ^ t_bits
        b_l = np.zeros((n, 8), dtype=np.uint64)
        for j in range(8):
            for byte_off, scale in ((2 * j, 256), (2 * j + 1, 1)):
                base_col = 8 * (15 - byte_off)
                for k in range(8):
                    b_l[:, j] += b_bits[:, base_col + k] * (scale << k)
        cbi_next = np.roll(main[:, L["cbi"].start].astype(np.uint64), -1)
        inv_aad = np_bus_inverse_terms(
            challenges, BUS_GCM_AAD, np.concatenate([eid, x_l], axis=1))
        inv_ct = np_bus_inverse_terms(
            challenges, BUS_GCM_CT,
            np.concatenate([eid, cbi_next[:, None], b_l], axis=1))
        inv_len = np_bus_inverse_terms(
            challenges, BUS_GCM_LEN, np.concatenate([eid, b_l], axis=1))
        m_start = main[:, L["m_start"].start].astype(np.uint64)[:, None]
        m_end = main[:, L["m_end"].start].astype(np.uint64)[:, None]
        m_ct = main[:, L["m_ct"].start].astype(np.uint64)[:, None]
        m_len = main[:, L["m_len"].start].astype(np.uint64)[:, None]
        u = (m_end * ((inv_tag.astype(np.uint64) + P
                       - inv_mask.astype(np.uint64)) % P)
             + 4 * P
             - m_start * ((inv_h.astype(np.uint64)
                           + inv_aad.astype(np.uint64)) % P)
             - m_ct * inv_ct.astype(np.uint64) % P
             - m_len * inv_len.astype(np.uint64) % P) % P
        acc = np.cumsum(u, axis=0) % P
        return np.concatenate(
            [inv_h, inv_mask, inv_tag, inv_aad, inv_ct, inv_len, u, acc],
            axis=1).astype(np.uint32)


# ---------------------------------------------------------------------------
# witness generation
# ---------------------------------------------------------------------------


def _ints_to_bits(values) -> np.ndarray:
    """(len, 128) uint8 bit columns of 128-bit ints: column k holds the
    coefficient of 2^k."""
    data = b"".join(v.to_bytes(16, "little") for v in values)
    return np.unpackbits(np.frombuffer(data, dtype=np.uint8).reshape(-1, 16),
                         axis=1, bitorder="little")


def _h_multiples(h: int) -> list[int]:
    """The v column of a group keyed by h, row by row: one GCM xtime per
    row, v' = (v >> 1) ⊕ v_0·(0xE1 << 120)."""
    e1 = 0xE1 << 120
    vs = [h]
    for _ in range(ROWS_PER_BLOCK - 1):
        v = vs[-1]
        vs.append((v >> 1) ^ (e1 if v & 1 else 0))
    return vs


# row r of a group holds x << r: column k reads x's bit k − r, or the
# zero column 128 where k < r
_SHIFT = np.arange(128)[None, :] - np.arange(ROWS_PER_BLOCK)[:, None]
_SHIFT = np.where(_SHIFT >= 0, _SHIFT, 128)


def ghash_trace(events: list[tuple[int, int, list[int], int]],
                min_log_n: int = 7):
    """Build the chip trace from (event_id, h, [block ints], mask) events —
    each one GHASH computation over its block sequence, with the event's
    tag-whitening mask E_K(J0).  The bus binds h and mask to the GCM
    control chip (which gets them from the AES chip) and publishes
    tag = S ⊕ mask (which the control chip matches against the journal's
    record header).  Front-padded with silent all-zero event groups.

    Returns (trace (n, width) uint32, []).
    """
    if not events or not any(blks for _e, _h, blks, _m in events):
        raise ValueError("need at least one event with one block")
    # one group per block: (eid, h, x_in, es, mask, nlb, cbi); an event's
    # last block is its length block, where the event ends
    groups: list[tuple] = []
    for eid, h, blocks, mask in events:
        y = 0
        for gi_, blk in enumerate(blocks):
            last = 1 if gi_ == len(blocks) - 1 else 0
            groups.append((eid, h, y ^ blk, 1 if gi_ == 0 else 0, mask,
                           last, gi_))
            y = _ghash_mul_ref(y ^ blk, h)

    n_rows = len(groups) * ROWS_PER_BLOCK
    log_n = max(min_log_n, (n_rows - 1).bit_length())
    n = 1 << log_n
    pad = n // ROWS_PER_BLOCK - len(groups)
    # padding: dead events that start and end at once, all else zero
    groups = [(0, 0, 0, 1, 0, 1, 0)] * pad + groups
    L = LAYOUT
    trace = np.zeros((n, L.width), dtype=np.uint32)
    grp = trace.reshape(-1, ROWS_PER_BLOCK, L.width)  # (group, row, col)

    eid, es, nlb, cbi = np.array([(g[0], g[3], g[5], g[6]) for g in groups],
                                 dtype=np.uint32).T
    live = (np.arange(len(groups)) >= pad).astype(np.uint32)
    es_next, nlb_next = np.roll(es, -1), np.roll(nlb, -1)
    q, q2 = (1 - es_next) * (1 - nlb_next), (1 - es_next) * nlb_next
    every, first, last = slice(None), slice(0, 1), slice(-1, None)
    for name, at, col in (
            ("eid", every, eid), ("live", every, live), ("cbi", every, cbi),
            ("nlb", every, nlb), ("es", first, es),
            ("m_start", first, es * live), ("m_end", last, nlb * live),
            ("q", last, q), ("q2", last, q2), ("m_ct", last, q * live),
            ("m_len", last, q2 * live)):
        grp[:, at, L[name].start] = col[:, None]

    # the real groups' multiplications z = x·v, every row at once: x
    # shifts left a bit a row, the row consumes its top bit, t = acc ⊕
    # x_127·v accumulates and acc is the previous row's t
    real = groups[pad:]
    hs = {h: i for i, h in enumerate(dict.fromkeys(g[1] for g in real))}
    v_of_h = _ints_to_bits(
        [v for h in hs for v in _h_multiples(h)]).reshape(len(hs), -1, 128)
    v = v_of_h[[hs[g[1]] for g in real]]
    x = np.pad(_ints_to_bits([g[2] for g in real]), ((0, 0), (0, 1)))
    x = x[:, _SHIFT]
    t = np.bitwise_xor.accumulate(v * x[:, :, 127:], axis=1)
    acc = np.zeros_like(t)
    acc[:, 1:] = t[:, :-1]
    mask = _ints_to_bits([g[4] for g in real])[:, None]
    for name, bits in (("acc", acc), ("v", v), ("x", x), ("t", t),
                       ("h", v[:, :1]), ("mask", mask)):
        grp[pad:, :, L[name]] = bits
    return trace, []


def _ghash_mul_ref(x: int, h: int) -> int:
    from ...guest.crypto.gcm import _ghash_mul

    return _ghash_mul(x, h)


def gcm_event_ghash(ev) -> tuple[int, list[int]]:
    """The (h, blocks) GHASH computation of one recorded GCMEvent: blocks
    over AAD ‖ CT (zero-padded 16-byte blocks) ‖ the 128-bit length block.
    Reproduces `guest/crypto/gcm.py:AESGCM._ghash` exactly."""
    from ...guest.crypto.aes import AES

    h = int.from_bytes(AES(ev.key).encrypt_block(b"\x00" * 16), "big")
    blocks: list[int] = []
    for data in (ev.aad, ev.ciphertext):
        for i in range(0, len(data), 16):
            blocks.append(int.from_bytes(
                data[i : i + 16].ljust(16, b"\x00"), "big"))
    lens = (len(ev.aad) * 8).to_bytes(8, "big") \
        + (len(ev.ciphertext) * 8).to_bytes(8, "big")
    blocks.append(int.from_bytes(lens, "big"))
    return h, blocks
