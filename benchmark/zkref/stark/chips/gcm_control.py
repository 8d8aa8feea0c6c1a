"""GCM control AIR chip — the per-record accounting table that glues the
AES-128, GHASH, stream-parser and GCM-data chips to the journal's record
headers.

The reference proves AES-GCM record decryption as straight-line guest code
whose control flow is part of the proven execution (SURVEY.md §3.4); here
the equivalent wiring is explicit bus messages (stark/bus.py):

  row types per GCM event (one decrypted record):
    header row (rt0): RECEIVES the journal's record header
        (BUS_GCM_RECORD: eid, nonce, tag, n_blocks, ct_len, v13, is_resp —
        sent by the VERIFIER from public journal data), the parser's view
        of the same record (BUS_PARSE_REC: eid, seqno, rectype, ct_len,
        v13, is_resp — proving a record with this metadata sits in the
        committed stream), the parser's explicit-nonce bytes
        (BUS_NONCE_BYTE ×8, TLS 1.2 — pinning nonce[4:12] to stream
        bytes), the parser's tag bytes (BUS_TAG_BYTE ×16 — pinning the
        journal tag to stream bytes), the AES encryption of the zero
        block (BUS_AES_ENC with input 0 → output H), and the tag the
        GHASH chip computed (BUS_GCM_TAG).  It SENDS the GHASH key H
        (BUS_GCM_H), the AAD block it reconstructs from
        (seqno, rectype, ct_len, v13) per RFC 5246 §6.2.3.3 / RFC 8446
        §5.2 (BUS_GCM_AAD), and the GHASH length block
        aad_bits ‖ ct_bits (BUS_GCM_LEN).
    J0 row (rt1): RECEIVES E_K(J0) (BUS_AES_ENC, input = nonce‖1) and
        SENDS it as the tag-whitening mask (BUS_GCM_MASK) to GHASH.
    counter rows: RECEIVE one keystream block each (BUS_AES_ENC with
        input = the 32-bit-incremented counter — increment constrained
        in-chip), counted against the header's n_blocks =
        ceil(ct_len/16), and SEND it to the GCM data chip (BUS_GCM_KS)
        for the plaintext xor.

So the journal pins (nonce, tag, n_blocks, ct_len, flags) per record; the
parser pins the same record's location and bytes inside the committed
stream; the AES chip pins key/input/output of every block encryption;
GHASH pins the tag over exactly (AAD ‖ located ciphertext ‖ length).
Tampering any of it breaks the global bus balance.

Remaining 1.3 gap (documented): the per-record nonce = static_iv ⊕ seq
derivation is journal-pinned but not yet tied to the key schedule.

Port copy of zktls_tpu.stark.chips.gcm_control (same names and values; host
code in numpy).
"""

from __future__ import annotations

import numpy as np

from ..air import Air, AirBuilder
from ..bus import (
    BUS_AES_ENC,
    BUS_SESSION_KEY,
    BUS_GCM_AAD,
    BUS_GCM_H,
    BUS_GCM_KS,
    BUS_GCM_LEN,
    BUS_GCM_MASK,
    BUS_GCM_RECORD,
    BUS_GCM_TAG,
    BUS_NONCE_BYTE,
    BUS_PARSE_REC,
    BUS_TAG_BYTE,
    np_bus_inverse_terms,
)
from ..ext_val import ExtVal

__all__ = ["GcmControlAir", "gcm_control_trace", "pack_gcm_records",
           "parse_gcm_records", "GCM_RECORD_SIZE"]

P = 2013265921

#: journal wire format of one record header: u16 eid ‖ 12-byte nonce ‖
#: 16-byte tag ‖ u16 n_blocks ‖ u16 ct_len ‖ u8 flags (bit0 = TLS 1.3,
#: bit1 = is_resp) ‖ u8 pad
GCM_RECORD_SIZE = 36


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
    L.add("rt0", 1)      # header row flag
    L.add("rt1", 1)      # J0 row flag
    L.add("live", 1)     # 1 on real event rows, 0 on padding
    L.add("eid", 1)      # event id (constant through the event)
    L.add("key", 8)      # AES key low limbs (event-constant)
    L.add("key2", 8)     # AES-256 key high limbs (0 for AES-128)
    L.add("kv", 1)       # key variant: 0 = AES-128, 1 = AES-256
    L.add("ctr", 8)      # this row's AES input block limbs
    L.add("out", 8)      # this row's AES output block limbs
    L.add("tag", 8)      # record tag limbs (event-constant)
    L.add("nonce", 6)    # record nonce limbs (event-constant)
    L.add("nblocks", 1)  # record keystream block count (event-constant)
    L.add("cnt", 1)      # running counter-row count
    L.add("c0", 1)       # inc32 carry bits (into this row's ctr)
    L.add("c1", 1)
    # --- round-3 record metadata (event-constant) ---
    L.add("seqv", 1)     # per-direction AEAD record sequence (from parser)
    L.add("rtyp", 1)     # outer record type (from parser)
    L.add("v13", 1)      # TLS 1.3 flag (journal + parser agree)
    L.add("isr", 1)      # is_resp flag (journal + parser agree)
    L.add("ctlen", 1)    # ciphertext length
    L.add("clb", 16)     # ctlen bits
    L.add("l13b", 16)    # (ctlen + 16) bits — the 1.3 AAD length field
    L.add("rpad", 4)     # 16·nblocks − ctlen ∈ [0, 16)
    L.add("nbb", 8)      # nblocks bits
    L.add("nb", 64)      # explicit-nonce byte bits (8 bytes × 8)
    L.add("tb", 128)     # tag byte bits (16 bytes × 8)
    # materialized gates (degree control)
    L.add("g_hdr", 1)    # rt0·live
    L.add("g_nv", 1)     # rt0·live·(1−v13)
    L.add("g_j0", 1)     # rt1·live
    L.add("g_ctr", 1)    # (1−rt0−rt1)·live
    # round-5 key-schedule binding
    L.add("obj", 1)      # session stream-object id (event-constant)
    L.add("dirb", 1)     # record direction (1 = server→client).  Free
    #                      witness, self-enforcing: the key-schedule chip
    #                      publishes each direction's key under its dir,
    #                      and only the true key satisfies the record's
    #                      AES/GHASH tag constraints
    L.add("g_kr", 1)     # g_nv·(1−kv): header rows of TLS 1.2 AES-128
    #                      records MUST consume the derived session key
    #                      (BUS_SESSION_KEY) — key + nonce salt pinned to
    #                      the key-schedule chip's PRF outputs
    return L


LAYOUT = _build_layout()


class GcmControlAir(Air):
    width = LAYOUT.width
    num_public = 0
    max_constraint_degree = 3
    #: inv_aes ‖ inv_h ‖ inv_mask ‖ inv_rec ‖ inv_tag ‖ inv_prec ‖ inv_aad
    #: ‖ inv_len ‖ inv_ks ‖ inv_nb×8 ‖ inv_tb×16 ‖ inv_skey ‖ u ‖ acc
    perm_width = 4 * (9 + 8 + 16 + 3)
    num_perm_challenges = 2
    has_bus = True

    def eval(self, b: AirBuilder) -> None:
        L = LAYOUT

        def loc(name, i=0):
            return b.local[L[name].start + i]

        def nxt(name, i=0):
            return b.next[L[name].start + i]

        rt0, rt1, live = loc("rt0"), loc("rt1"), loc("live")
        nrt0, nrt1 = nxt("rt0"), nxt("rt1")
        for c in (rt0, rt1, live, loc("c0"), loc("c1"), loc("v13"),
                  loc("isr"), loc("kv"), loc("dirb")):
            b.assert_bool(c)
        for name, k in (("clb", 16), ("l13b", 16), ("rpad", 4), ("nbb", 8),
                        ("nb", 64), ("tb", 128)):
            grp = b.local_group(L[name])
            b.assert_zero_vec(grp * (grp - 1), k)
        b.assert_zero(rt0 * rt1)
        # row sequencing: header → J0; J0 only after a header
        b.when_transition(rt0 * (1 - nrt1))
        b.when_transition((1 - rt0) * nrt1)
        b.when_first_row(rt1)

        # event-constant columns (free only across a header boundary);
        # degree 3: is_transition · (1 − rt0') · Δ
        ev_const = [("eid", 1), ("obj", 1), ("dirb", 1), ("key", 8),
                    ("key2", 8), ("kv", 1),
                    ("tag", 8), ("nonce", 6),
                    ("nblocks", 1), ("live", 1), ("seqv", 1), ("rtyp", 1),
                    ("v13", 1), ("isr", 1), ("ctlen", 1), ("clb", 16),
                    ("l13b", 16), ("rpad", 4), ("nbb", 8), ("nb", 64),
                    ("tb", 128)]
        for name, k in ev_const:
            grp = b.local_group(L[name])
            ngrp = b.next_group(L[name])
            b.assert_zero_vec(b.is_transition * ((1 - nrt0) * (ngrp - grp)),
                              k)

        # materialized gates
        b.assert_zero(loc("g_hdr") - rt0 * live)
        b.assert_zero(loc("g_nv") - loc("g_hdr") * (1 - loc("v13")))
        b.assert_zero(loc("g_j0") - rt1 * live)
        b.assert_zero(loc("g_ctr") - (1 - rt0 - rt1) * live)
        b.assert_zero(loc("g_kr") - loc("g_nv") * (1 - loc("kv")))
        g_hdr, g_nv, g_j0, g_ctr = (loc("g_hdr"), loc("g_nv"),
                                    loc("g_j0"), loc("g_ctr"))

        # header row: AES input is the zero block
        for j in range(8):
            b.assert_zero(rt0 * loc("ctr", j))
        # J0 row: ctr = nonce ‖ 0x0000 ‖ 0x0001
        for j in range(6):
            b.assert_zero(rt1 * (loc("ctr", j) - loc("nonce", j)))
        b.assert_zero(rt1 * loc("ctr", 6))
        b.assert_zero(rt1 * (loc("ctr", 7) - 1))

        # counter rows: inc32 from the previous row's ctr (covers J0 → ctr0
        # and ctr_i → ctr_{i+1}); the low 32 bits live in limbs 6 (hi), 7 (lo)
        g_inc = (1 - nrt0 - nrt1)  # next row is a counter row
        c0n, c1n = nxt("c0"), nxt("c1")
        b.when_transition(
            g_inc * (nxt("ctr", 7) - loc("ctr", 7) - 1 + c0n * 65536))
        b.when_transition(
            g_inc * (nxt("ctr", 6) - loc("ctr", 6) - c0n + c1n * 65536))
        for j in range(6):
            b.when_transition(g_inc * (nxt("ctr", j) - loc("ctr", j)))
        # block counting against the journal's n_blocks
        b.assert_zero(rt1 * loc("cnt"))
        b.when_transition(g_inc * (nxt("cnt") - loc("cnt") - 1))
        b.when_transition(nrt0 * (loc("cnt") - loc("nblocks")))
        b.when_last_row(loc("cnt") - loc("nblocks"))

        # --- record-metadata consistency (header rows) ---
        POW = [1 << i for i in range(16)]
        ctlen = loc("ctlen")
        clen_v = b.dot_const(b.local_group(L["clb"]), POW)
        l13_v = b.dot_const(b.local_group(L["l13b"]), POW)
        rpad_v = b.dot_const(b.local_group(L["rpad"]), POW[:4])
        nbb_v = b.dot_const(b.local_group(L["nbb"]), POW[:8])
        b.assert_zero(rt0 * (ctlen - clen_v))
        b.assert_zero(rt0 * (l13_v - ctlen - 16))
        b.assert_zero(rt0 * (16 * loc("nblocks") - ctlen - rpad_v))
        b.assert_zero(rt0 * (loc("nblocks") - nbb_v))

        def nbyte(j):
            sl = slice(L["nb"].start + 8 * j, L["nb"].start + 8 * j + 8)
            return b.dot_const(b.local_group(sl), POW[:8])

        def tbyte(j):
            sl = slice(L["tb"].start + 8 * j, L["tb"].start + 8 * j + 8)
            return b.dot_const(b.local_group(sl), POW[:8])

        # explicit nonce bytes = journal nonce[4:12] (TLS 1.2 only)
        for q in range(4):
            b.assert_zero(g_nv * (loc("nonce", 2 + q)
                                  - 256 * nbyte(2 * q) - nbyte(2 * q + 1)))
        # tag bytes = journal tag limbs
        for q in range(8):
            b.assert_zero(rt0 * (loc("tag", q)
                                 - 256 * tbyte(2 * q) - tbyte(2 * q + 1)))

        # --- bus messages ---
        gamma = b.challenges[0]

        def dpow(i):
            return b.challenges[1 + i]

        eid = loc("eid")
        v13 = loc("v13")
        fp_aes = (ExtVal.from_base(BUS_AES_ENC) + dpow(0) * eid
                  + dpow(1) * loc("kv"))
        fp_h = ExtVal.from_base(BUS_GCM_H) + dpow(0) * eid
        fp_mask = ExtVal.from_base(BUS_GCM_MASK) + dpow(0) * eid
        fp_tag = ExtVal.from_base(BUS_GCM_TAG) + dpow(0) * eid
        fp_rec = ExtVal.from_base(BUS_GCM_RECORD) + dpow(0) * eid
        for j in range(8):
            fp_aes = fp_aes + dpow(2 + j) * loc("key", j) \
                + dpow(10 + j) * loc("key2", j) \
                + dpow(18 + j) * loc("ctr", j) + dpow(26 + j) * loc("out", j)
            fp_h = fp_h + dpow(1 + j) * loc("out", j)
            fp_mask = fp_mask + dpow(1 + j) * loc("out", j)
            fp_tag = fp_tag + dpow(1 + j) * loc("tag", j)
            fp_rec = fp_rec + dpow(7 + j) * loc("tag", j)
        for j in range(6):
            fp_rec = fp_rec + dpow(1 + j) * loc("nonce", j)
        fp_rec = fp_rec + dpow(15) * loc("nblocks") + dpow(16) * ctlen \
            + dpow(17) * v13 + dpow(18) * loc("isr")
        fp_prec = (ExtVal.from_base(BUS_PARSE_REC) + dpow(0) * eid
                   + dpow(1) * loc("seqv") + dpow(2) * loc("rtyp")
                   + dpow(3) * ctlen + dpow(4) * v13 + dpow(5) * loc("isr"))
        # AAD block reconstruction (RFC 5246 §6.2.3.3 / RFC 8446 §5.2)
        lh12 = b.dot_const(
            b.local_group(slice(L["clb"].start + 8, L["clb"].start + 16)),
            POW[:8])
        ll12 = b.dot_const(
            b.local_group(slice(L["clb"].start, L["clb"].start + 8)),
            POW[:8])
        lh13 = b.dot_const(
            b.local_group(slice(L["l13b"].start + 8, L["l13b"].start + 16)),
            POW[:8])
        ll13 = b.dot_const(
            b.local_group(slice(L["l13b"].start, L["l13b"].start + 8)),
            POW[:8])
        aad = [
            v13 * 0x1703,
            v13 * (768 + lh13),
            v13 * 256 * ll13,
            (1 - v13) * loc("seqv"),
            (1 - v13) * (256 * loc("rtyp") + 3),
            (1 - v13) * (768 + lh12),
            (1 - v13) * 256 * ll12,
        ]
        fp_aad = ExtVal.from_base(BUS_GCM_AAD) + dpow(0) * eid
        for j, limb in enumerate(aad):
            fp_aad = fp_aad + dpow(1 + j) * limb
        # GHASH length block: aad_bits (104 / 40) ‖ ct_bits (ctlen·8)
        len6 = b.dot_const(
            b.local_group(slice(L["clb"].start + 13, L["clb"].start + 16)),
            [1, 2, 4])
        len7 = b.dot_const(
            b.local_group(slice(L["clb"].start, L["clb"].start + 13)),
            [8 << i for i in range(13)])
        fp_len = (ExtVal.from_base(BUS_GCM_LEN) + dpow(0) * eid
                  + dpow(4) * (104 - 64 * v13)
                  + dpow(7) * len6 + dpow(8) * len7)
        fp_ks = (ExtVal.from_base(BUS_GCM_KS) + dpow(0) * eid
                 + dpow(1) * loc("cnt"))
        for j in range(8):
            fp_ks = fp_ks + dpow(2 + j) * loc("out", j)

        # session-key receive: key limbs AND the TLS 1.2 nonce salt
        # (nonce[0:4] = the key block's fixed IV) in one payload
        fp_skey = (ExtVal.from_base(BUS_SESSION_KEY)
                   + dpow(0) * loc("obj") + dpow(1) * loc("dirb")
                   + dpow(2) * loc("kv")
                   + dpow(19) * loc("nonce", 0) + dpow(20) * loc("nonce", 1))
        for j in range(8):
            fp_skey = fp_skey + dpow(3 + j) * loc("key", j) \
                + dpow(11 + j) * loc("key2", j)
        inv_aes = b.perm_ext(0)
        inv_h = b.perm_ext(1)
        inv_mask = b.perm_ext(2)
        inv_rec = b.perm_ext(3)
        inv_tag = b.perm_ext(4)
        inv_prec = b.perm_ext(5)
        inv_aad = b.perm_ext(6)
        inv_len = b.perm_ext(7)
        inv_ks = b.perm_ext(8)
        b.assert_ext_zero(inv_aes * (gamma - fp_aes) - 1)
        b.assert_ext_zero(inv_h * (gamma - fp_h) - 1)
        b.assert_ext_zero(inv_mask * (gamma - fp_mask) - 1)
        b.assert_ext_zero(inv_rec * (gamma - fp_rec) - 1)
        b.assert_ext_zero(inv_tag * (gamma - fp_tag) - 1)
        b.assert_ext_zero(inv_prec * (gamma - fp_prec) - 1)
        b.assert_ext_zero(inv_aad * (gamma - fp_aad) - 1)
        b.assert_ext_zero(inv_len * (gamma - fp_len) - 1)
        b.assert_ext_zero(inv_ks * (gamma - fp_ks) - 1)
        inv_nb = []
        inv_tb = []
        for j in range(8):
            iv = b.perm_ext(9 + j)
            fp = (ExtVal.from_base(BUS_NONCE_BYTE) + dpow(0) * eid
                  + dpow(1) * (7 - j) + dpow(2) * nbyte(j))
            b.assert_ext_zero(iv * (gamma - fp) - 1)
            inv_nb.append(iv)
        for j in range(16):
            iv = b.perm_ext(17 + j)
            fp = (ExtVal.from_base(BUS_TAG_BYTE) + dpow(0) * eid
                  + dpow(1) * (15 - j) + dpow(2) * tbyte(j))
            b.assert_ext_zero(iv * (gamma - fp) - 1)
            inv_tb.append(iv)

        inv_skey = b.perm_ext(33)
        b.assert_ext_zero(inv_skey * (gamma - fp_skey) - 1)
        u = b.perm_ext(34)
        acc = b.perm_ext(35)
        u_n = b.perm_ext(34, nxt=True)
        acc_n = b.perm_ext(35, nxt=True)
        # header: sends H/AAD/LEN, receives journal record + GHASH tag +
        # parser record + parser tag bytes (+ nonce bytes when TLS 1.2);
        # J0 row: sends mask; counter rows: send keystream; every live
        # row receives its AES block
        u_def = ((inv_h + inv_aad + inv_len - inv_rec - inv_tag - inv_prec)
                 * g_hdr + inv_mask * g_j0 + inv_ks * g_ctr
                 - inv_aes * live)
        for iv in inv_tb:
            u_def = u_def - iv * g_hdr
        for iv in inv_nb:
            u_def = u_def - iv * g_nv
        u_def = u_def - inv_skey * loc("g_kr")
        b.assert_ext_zero(u - u_def)
        b.assert_ext_zero((acc - u) * b.is_first_row)
        b.assert_ext_zero((acc_n - acc - u_n) * b.is_transition)
        for ell in range(4):
            b.when_last_row(acc.c[ell] - b.public[ell])

    # ------------------------------------------------------------------

    def generate_perm_trace(self, main, publics, challenges):
        L = LAYOUT
        n = main.shape[0]

        def cols(name):
            return main[:, L[name]].astype(np.uint64)

        def col1(name):
            return main[:, L[name].start].astype(np.uint64)

        eid = cols("eid")
        key, ctr, out = cols("key"), cols("ctr"), cols("out")
        key2, kv = cols("key2"), cols("kv")
        tag, nonce, nblocks = cols("tag"), cols("nonce"), cols("nblocks")
        seqv, rtyp = col1("seqv"), col1("rtyp")
        v13, isr, ctlen = col1("v13"), col1("isr"), col1("ctlen")
        cnt = col1("cnt")
        clb, l13b = cols("clb"), cols("l13b")
        nbits, tbits = cols("nb"), cols("tb")
        inv_aes = np_bus_inverse_terms(
            challenges, BUS_AES_ENC,
            np.concatenate([eid, kv, key, key2, ctr, out], axis=1))
        inv_h = np_bus_inverse_terms(
            challenges, BUS_GCM_H, np.concatenate([eid, out], axis=1))
        inv_mask = np_bus_inverse_terms(
            challenges, BUS_GCM_MASK, np.concatenate([eid, out], axis=1))
        rec_pl = np.concatenate(
            [eid, nonce, tag, nblocks, ctlen[:, None], v13[:, None],
             isr[:, None]], axis=1)
        inv_rec = np_bus_inverse_terms(challenges, BUS_GCM_RECORD, rec_pl)
        inv_tag = np_bus_inverse_terms(
            challenges, BUS_GCM_TAG, np.concatenate([eid, tag], axis=1))
        inv_prec = np_bus_inverse_terms(
            challenges, BUS_PARSE_REC, np.stack(
                [eid[:, 0], seqv, rtyp, ctlen, v13, isr], axis=1))
        POW = np.array([1 << i for i in range(16)], dtype=np.uint64)
        lh12 = (clb[:, 8:16] * POW[:8]).sum(axis=1) % P
        ll12 = (clb[:, 0:8] * POW[:8]).sum(axis=1) % P
        lh13 = (l13b[:, 8:16] * POW[:8]).sum(axis=1) % P
        ll13 = (l13b[:, 0:8] * POW[:8]).sum(axis=1) % P
        zero = np.zeros(n, dtype=np.uint64)
        aad = np.stack([
            v13 * 0x1703,
            v13 * (768 + lh13) % P,
            v13 * 256 * ll13 % P,
            (1 - v13) * seqv % P,
            (1 - v13) * (256 * rtyp + 3) % P,
            (1 - v13) * (768 + lh12) % P,
            (1 - v13) * 256 * ll12 % P,
        ], axis=1)
        inv_aad = np_bus_inverse_terms(
            challenges, BUS_GCM_AAD, np.concatenate([eid, aad], axis=1))
        len6 = (clb[:, 13:16] * POW[:3]).sum(axis=1) % P
        len7 = (clb[:, 0:13] * (POW[:13] * 8)).sum(axis=1) % P
        len_pl = np.stack([eid[:, 0], zero, zero, zero,
                           (104 - 64 * v13) % P, zero, zero, len6, len7],
                          axis=1)
        inv_len = np_bus_inverse_terms(challenges, BUS_GCM_LEN, len_pl)
        inv_ks = np_bus_inverse_terms(
            challenges, BUS_GCM_KS,
            np.concatenate([eid, cnt[:, None], out], axis=1))
        nb_list, tb_list = [], []
        for j in range(8):
            byte = (nbits[:, 8 * j : 8 * j + 8] * POW[:8]).sum(axis=1) % P
            nb_list.append(np_bus_inverse_terms(
                challenges, BUS_NONCE_BYTE, np.stack(
                    [eid[:, 0], np.full(n, 7 - j, dtype=np.uint64), byte],
                    axis=1)))
        for j in range(16):
            byte = (tbits[:, 8 * j : 8 * j + 8] * POW[:8]).sum(axis=1) % P
            tb_list.append(np_bus_inverse_terms(
                challenges, BUS_TAG_BYTE, np.stack(
                    [eid[:, 0], np.full(n, 15 - j, dtype=np.uint64), byte],
                    axis=1)))
        obj = col1("obj")
        dirb = col1("dirb")
        skey_pl = np.concatenate(
            [obj[:, None], dirb[:, None], kv[:, 0:1], key, key2,
             nonce[:, 0:2],
             np.zeros((n, 4), dtype=np.uint64)], axis=1)
        inv_skey = np_bus_inverse_terms(challenges, BUS_SESSION_KEY,
                                        skey_pl)
        rt0 = cols("rt0")
        rt1 = cols("rt1")
        live = cols("live")
        g_hdr = rt0 * live
        g_nv = g_hdr * (1 - v13[:, None])
        g_j0 = rt1 * live
        g_kr = g_nv * (1 - kv[:, 0:1])
        g_ctr = (1 - rt0 - rt1) * live
        pos = ((inv_h.astype(np.uint64) + inv_aad.astype(np.uint64)
                + inv_len.astype(np.uint64)) % P * g_hdr
               + inv_mask.astype(np.uint64) * g_j0
               + inv_ks.astype(np.uint64) * g_ctr) % P
        neg = ((inv_rec.astype(np.uint64) + inv_tag.astype(np.uint64)
                + inv_prec.astype(np.uint64)) % P * g_hdr
               + inv_aes.astype(np.uint64) * live) % P
        for iv in tb_list:
            neg = (neg + iv.astype(np.uint64) * g_hdr) % P
        for iv in nb_list:
            neg = (neg + iv.astype(np.uint64) * g_nv) % P
        neg = (neg + inv_skey.astype(np.uint64) * g_kr) % P
        u = (pos + P - neg) % P
        acc = np.cumsum(u, axis=0) % P
        return np.concatenate(
            [inv_aes, inv_h, inv_mask, inv_rec, inv_tag, inv_prec,
             inv_aad, inv_len, inv_ks] + nb_list + tb_list
            + [inv_skey, u, acc], axis=1).astype(np.uint32)


# ---------------------------------------------------------------------------
# witness generation + journal record packing
# ---------------------------------------------------------------------------


def _limbs(data: bytes) -> list[int]:
    return [int.from_bytes(data[i : i + 2], "big")
            for i in range(0, len(data), 2)]


def pack_gcm_records(events, metas=None, v13: bool = False) -> bytes:
    """Journal wire format of the record headers: 36 bytes per event
    (u16 eid ‖ nonce ‖ tag ‖ u16 n_blocks ‖ u16 ct_len ‖ u8 flags ‖ pad).
    metas: GcmRecordMeta list (record_walk) supplying is_resp per eid;
    without it flags carry only the version bit.  ChaCha20-Poly1305
    events (no counter_blocks attribute) pack with flags bit 2 set and
    n_blocks = ceil(ct_len/16) — the data-chip block granularity."""
    resp, mv13 = {}, {}
    if metas is not None:
        for m in metas:
            resp[m.eid] = m.is_resp
            mv13[m.eid] = getattr(m, "v13", 1 if v13 else 0)
    out = bytearray()
    for eid, ev in enumerate(events):
        if hasattr(ev, "otk"):      # ChaChaEvent
            n_blocks, cha = (len(ev.ciphertext) + 15) // 16, 1
        else:
            n_blocks, cha = len(ev.counter_blocks), 0
        flags = (mv13.get(eid, 1 if v13 else 0)) \
            | (2 if resp.get(eid) else 0) | (4 * cha)
        out += eid.to_bytes(2, "big") + ev.nonce + ev.tag \
            + n_blocks.to_bytes(2, "big") \
            + len(ev.ciphertext).to_bytes(2, "big") \
            + bytes([flags, 0])
    return bytes(out)


def parse_gcm_records(data: bytes) -> list[dict]:
    if len(data) % GCM_RECORD_SIZE:
        raise ValueError("bad gcm_records length")
    out = []
    for i in range(0, len(data), GCM_RECORD_SIZE):
        rec = data[i : i + GCM_RECORD_SIZE]
        out.append({
            "eid": int.from_bytes(rec[0:2], "big"),
            "nonce": rec[2:14],
            "tag": rec[14:30],
            "n_blocks": int.from_bytes(rec[30:32], "big"),
            "ct_len": int.from_bytes(rec[32:34], "big"),
            "v13": rec[34] & 1,
            "is_resp": (rec[34] >> 1) & 1,
            "cha": (rec[34] >> 2) & 1,
        })
    return out


def gcm_control_trace(events, metas=None, v13: bool = False,
                      min_log_n: int = 6):
    """Build the control trace from recorded GCMEvents (eid = list index)
    and the parser-side record metadata (GcmRecordMeta list).
    Returns (trace (n, width) uint32, [])."""
    if not events:
        raise ValueError("need at least one event")
    L = LAYOUT
    meta_by_eid = {}
    if metas is not None:
        for m in metas:
            meta_by_eid[m.eid] = m
    rows: list[dict] = []
    for eid, ev in enumerate(events):
        if len(ev.key) == 32:
            key_l = _limbs(ev.key[:16])
            key2_l = _limbs(ev.key[16:])
            kv = 1
        else:
            key_l = _limbs(ev.key)
            key2_l = [0] * 8
            kv = 0
        tag_l = _limbs(ev.tag)
        nonce_l = _limbs(ev.nonce)
        nb = len(ev.counter_blocks)
        m = meta_by_eid.get(eid)
        base = dict(eid=eid, obj=getattr(m, "obj", 1) if m else 1,
                    dirb=1 if (m and getattr(m, "dir", "c") == "s") else 0,
                    key=key_l, key2=key2_l, kv=kv, tag=tag_l,
                    nonce=nonce_l,
                    nblocks=nb, live=1,
                    seqv=m.seqno if m else 0,
                    rtyp=m.rectype if m else 0,
                    v13=getattr(m, "v13", 1 if v13 else 0) if m
                        else (1 if v13 else 0),
                    isr=m.is_resp if m else 0,
                    ctlen=len(ev.ciphertext),
                    nonce_bytes=ev.nonce[4:12],
                    tag_bytes=ev.tag)
        rows.append(dict(base, rt0=1, rt1=0, cnt=0,
                         ctr=[0] * 8, out=_limbs(ev.h_block)))
        j0 = ev.nonce + b"\x00\x00\x00\x01"
        rows.append(dict(base, rt0=0, rt1=1, cnt=0,
                         ctr=_limbs(j0), out=_limbs(ev.j0_mask)))
        for i, (cb, ks) in enumerate(zip(ev.counter_blocks, ev.keystream)):
            rows.append(dict(base, rt0=0, rt1=0, cnt=i + 1,
                             ctr=_limbs(cb), out=_limbs(ks)))

    n_real = len(rows)
    log_n = max(min_log_n, (n_real - 1).bit_length())
    n = 1 << log_n
    pad = n - n_real
    # padding rows are silent counter rows with ctr = 0,1,2,… and
    # nblocks = cnt(last pad) so the end-check at the first header passes
    pad_rows = []
    for i in range(pad):
        ctr_l = [0] * 6 + [i >> 16, i & 0xFFFF]
        c0 = 1 if i and (i - 1) & 0xFFFF == 0xFFFF else 0
        nbl = max(pad - 1, 0)
        pad_rows.append(dict(eid=0, obj=0, dirb=0, key=[0] * 8,
                             key2=[0] * 8, kv=0,
                             tag=[0] * 8,
                             nonce=[0] * 6, nblocks=nbl,
                             live=0, rt0=0, rt1=0, cnt=i,
                             ctr=ctr_l, out=[0] * 8, c0=c0, c1=0,
                             seqv=0, rtyp=0, v13=0, isr=0, ctlen=0,
                             nonce_bytes=b"\x00" * 8,
                             tag_bytes=b"\x00" * 16))
    rows = pad_rows + rows

    trace = np.zeros((n, L.width), dtype=np.uint32)
    for r, row in enumerate(rows):
        for nm in ("rt0", "rt1", "live", "eid", "obj", "dirb", "nblocks",
                   "cnt", "seqv", "rtyp", "v13", "isr", "ctlen", "kv"):
            trace[r, L[nm].start] = row[nm]
        for j in range(8):
            trace[r, L["key"].start + j] = row["key"][j]
            trace[r, L["key2"].start + j] = row["key2"][j]
            trace[r, L["ctr"].start + j] = row["ctr"][j]
            trace[r, L["out"].start + j] = row["out"][j]
            trace[r, L["tag"].start + j] = row["tag"][j]
        for j in range(6):
            trace[r, L["nonce"].start + j] = row["nonce"][j]
        ctlen = row["ctlen"]
        l13 = ctlen + 16
        rpad = 16 * row["nblocks"] - ctlen
        if not (0 <= rpad < 16) and row["live"]:
            raise ValueError("n_blocks != ceil(ct_len/16)")
        for k in range(16):
            trace[r, L["clb"].start + k] = (ctlen >> k) & 1
            trace[r, L["l13b"].start + k] = (l13 >> k) & 1
        for k in range(4):
            trace[r, L["rpad"].start + k] = (max(rpad, 0) >> k) & 1
        for k in range(8):
            trace[r, L["nbb"].start + k] = (row["nblocks"] >> k) & 1
        for j, byte in enumerate(row["nonce_bytes"]):
            for k in range(8):
                trace[r, L["nb"].start + 8 * j + k] = (byte >> k) & 1
        for j, byte in enumerate(row["tag_bytes"]):
            for k in range(8):
                trace[r, L["tb"].start + 8 * j + k] = (byte >> k) & 1
        trace[r, L["g_hdr"].start] = row["rt0"] * row["live"]
        trace[r, L["g_nv"].start] = (row["rt0"] * row["live"]
                                     * (1 - row["v13"]))
        trace[r, L["g_j0"].start] = row["rt1"] * row["live"]
        trace[r, L["g_ctr"].start] = ((1 - row["rt0"] - row["rt1"])
                                      * row["live"])
        trace[r, L["g_kr"].start] = (row["rt0"] * row["live"]
                                     * (1 - row["v13"])
                                     * (1 - row["kv"]))
        # inc32 carries into this row (meaningful only on counter rows
        # that follow another row; harmless elsewhere)
        if "c0" in row:
            trace[r, L["c0"].start] = row["c0"]
            trace[r, L["c1"].start] = row["c1"]
        elif r > 0 and row["rt0"] == 0 and row["rt1"] == 0:
            prev = rows[r - 1]
            lo_prev = prev["ctr"][7]
            c0 = 1 if lo_prev == 0xFFFF else 0
            c1 = 1 if c0 and prev["ctr"][6] == 0xFFFF else 0
            trace[r, L["c0"].start] = c0
            trace[r, L["c1"].start] = c1
    return trace, []
