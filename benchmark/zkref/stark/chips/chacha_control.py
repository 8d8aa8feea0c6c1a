"""ChaCha20-Poly1305 record-control AIR chip — the per-record accounting
table that glues the ChaCha20, ModMul (Poly1305), stream-parser and
ChaCha-data chips to the journal's record headers.

Mirrors GcmControlAir for the 0x1303 suite (TLS_CHACHA20_POLY1305_SHA256,
offered by the reference client, request.rs:25-27; rustls-rustcrypto
chacha20poly1305 is the behavioral contract, SURVEY.md §2.2.A).  The
reference proves record decryption as straight-line guest code inside the
zkVM (SURVEY.md §3.4); here the control flow is explicit bus messages:

  row types per ChaCha record (one decrypted TLS 1.3 record):
    header row (h): RECEIVES the journal's record header
        (BUS_GCM_RECORD with the cha=1 cipher flag — sent by the
        VERIFIER from public journal data), the parser's view of the
        same record (BUS_PARSE_REC), the parser's tag bytes
        (BUS_TAG_BYTE ×16 — the journal tag IS stream bytes), and the
        Poly1305 one-time-key half from the ChaCha20 chip
        (BUS_CHACHA_BLOCK at ctr = 0, half = 0 → r_raw ‖ s).  The r
        clamp (RFC 8439 §2.5: r &= 0x0ffffffc0ffffffc0ffffffc0fffffff)
        is proven in-chip via full bit decomposition of the clamped
        limbs.  The nonce bytes appear in BOTH the journal-header and
        keystream fingerprints, binding every keystream block to the
        journal-pinned nonce.
    keystream rows (k): each RECEIVES one 32-byte keystream half
        (BUS_CHACHA_BLOCK, ctr ≥ 1) under the event-constant key/nonce
        and SENDS its two 16-byte slices to the data chip
        (BUS_CHACHA_KS at bidx = 4·(ctr−1) + 2·half + 1, +2).
    Poly1305 rows (pa/pc/pl): one row per 16-byte MAC-data block of
        pad16(aad) ‖ pad16(ct) ‖ le64(aad_len) ‖ le64(ct_len)
        (RFC 8439 §2.8).  The aad block (pa) and length block (pl) are
        reconstructed in-chip from the record metadata; ciphertext
        blocks (pc) are RECEIVED from the data chip (BUS_POLY_CT),
        which got the bytes from the stream parser.  Every row RECEIVES
        one proven accumulator statement from the ModMul chip
        (BUS_MODMUL over 2^130 − 5): acc' = (acc + blk + 2^128)·r, the
        operand reduction proven limb-wise in-chip.  The final row
        checks tag = (acc + s) mod 2^128 against the parser-pinned tag
        bytes — so a proof exists only if the Poly1305 tag verifies over
        exactly (aad ‖ located ciphertext ‖ lengths) under the one-time
        key derived from the record's keystream block 0.

Forging the plaintext therefore requires a (key, nonce) pair whose
Poly1305 tag over the real ciphertext equals the real recorded tag — a
MAC forgery, the same assumption the reference guest's AEAD open relies
on.  TLS 1.2 ChaCha records (0xCCA8) bind through the same rows: the
stream parser's nonce-less walk (cnl region register — RFC 7905 records
carry no explicit nonce) locates them, and the aad row reconstructs the
1.2 AAD be64(seq) ‖ type ‖ version ‖ be16(ctlen) from the parser-proven
record metadata.

Port copy of zktls_tpu.stark.chips.chacha_control (same names and values;
host code in numpy).
"""

from __future__ import annotations

import numpy as np

from ..air import Air, AirBuilder
from ..bus import (
    BUS_CHACHA_BLOCK,
    BUS_CHACHA_KS,
    BUS_GCM_RECORD,
    BUS_MODMUL,
    BUS_PARSE_REC,
    BUS_POLY_CT,
    BUS_TAG_BYTE,
    np_bus_inverse_terms,
)
from ..ext_val import ExtVal
from .modmul import MODULI_256, P1305

__all__ = ["ChaChaControlAir", "chacha_control_trace"]

P = 2013265921
#: BUS_MODMUL one-hot class of the Poly1305 prime on the 256-bit chip
MCLASS = MODULI_256.index(P1305)
#: u16 little-endian limbs of 2^130 − 5
P1305_LIMBS = [(P1305 >> (16 * j)) & 0xFFFF for j in range(9)]


class _Layout:
    def __init__(self):
        self._n = 0
        self.slices: dict[str, slice] = {}

    def add(self, name: str, count: int = 1) -> None:
        self.slices[name] = slice(self._n, self._n + count)
        self._n += count

    @property
    def width(self) -> int:
        return self._n

    def __getitem__(self, name: str) -> slice:
        return self.slices[name]


def _build_layout() -> _Layout:
    L = _Layout()
    for f in ("h", "k", "pa", "pc", "pl"):
        L.add(f)           # row-type flags (exclusive; all 0 = padding)
    # --- event-constant metadata ---
    L.add("eid")
    L.add("ctlen")
    L.add("nblocks")
    L.add("v13")
    L.add("isr")
    L.add("seqv")
    L.add("rtyp")
    L.add("clb", 16)       # ctlen bits
    L.add("l13b", 16)      # (ctlen + 16) bits — the 1.3 AAD length field
    L.add("rpad", 4)       # 16·nblocks − ctlen ∈ [0, 16)
    L.add("nbb", 8)        # nblocks bits
    L.add("key", 16)       # ChaCha key limbs (LE-u32 lo/hi pairs)
    L.add("nb", 12)        # nonce byte columns
    L.add("tb", 16)        # tag byte columns
    L.add("r", 8)          # clamped Poly1305 r limbs (LE u16)
    L.add("s", 8)          # Poly1305 s limbs (LE u16)
    # --- header-local ---
    L.add("rb", 112)       # raw otk limbs 1..7 as 16 bits each
    # --- aad-row-local (TLS 1.2) ---
    L.add("sqb", 16)       # record sequence bits (1.2 AAD seq field)
    # --- keystream rows ---
    L.add("ctr")           # ChaCha block counter (lo; hi forced 0)
    L.add("half")
    L.add("ksl", 16)       # received keystream half limbs
    L.add("m1")            # BUS_CHACHA_KS send multiplicities
    L.add("m2")
    # --- Poly1305 rows ---
    L.add("bidx")          # 0 on aad row, 1.. on ct rows (= data bidx)
    L.add("acc_in", 9)     # accumulator entering this row (LE u16)
    L.add("acc_out", 9)    # accumulator leaving (the ModMul result)
    L.add("blk", 8)        # 16-byte MAC-data block (LE u16 pairs)
    L.add("al", 9)         # canonical ModMul `a` operand limbs
    L.add("ac", 8)         # carries of the a-limb reduction identity
    L.add("red")           # 1 iff acc + blk + 2^128 ≥ 2^130 − 5
    L.add("tc", 8)         # tag-addition carries (pl row)
    return L


LAYOUT = _build_layout()


class ChaChaControlAir(Air):
    width = LAYOUT.width
    num_public = 0
    max_constraint_degree = 3
    #: inv_hdrblk ‖ inv_ksblk ‖ inv_ks1 ‖ inv_ks2 ‖ inv_rec ‖ inv_prec ‖
    #: inv_tb×16 ‖ inv_pct ‖ inv_mm ‖ u ‖ acc
    perm_width = 4 * 26
    num_perm_challenges = 2
    has_bus = True

    def eval(self, b: AirBuilder) -> None:
        L = LAYOUT

        def c(name, i=0):
            return b.local[L[name].start + i]

        def n(name, i=0):
            return b.next[L[name].start + i]

        tr = b.is_transition
        h, k, pa, pc, pl = (c("h"), c("k"), c("pa"), c("pc"), c("pl"))
        hn, kn, pan, pcn, pln = (n("h"), n("k"), n("pa"), n("pc"), n("pl"))
        live = h + k + pa + pc + pl
        for f in ("h", "k", "pa", "pc", "pl", "v13", "isr", "half", "red"):
            b.assert_bool(c(f))
        b.assert_bool(live)
        for name, cnt in (("clb", 16), ("l13b", 16), ("rpad", 4),
                          ("nbb", 8), ("rb", 112), ("sqb", 16), ("tc", 8)):
            grp = b.local_group(L[name])
            b.assert_zero_vec(grp * (grp - 1), cnt)
        # a-limb chain carries can borrow when red = 1: ternary {−1, 0, 1}
        acg = b.local_group(L["ac"])
        b.assert_zero_vec(acg * (acg - 1) * (acg + 1), 8)

        # --- row sequencing: h → k+ → pa → pc+ → pl → (h | padding) ---
        b.when_first_row(k + pa + pc + pl)
        nxt_mid = kn + pan + pcn + pln
        b.when_transition(h * (1 - kn))
        b.when_transition(k * (1 - kn - pan))
        b.when_transition(pa * (1 - pcn))
        b.when_transition(pc * (1 - pcn - pln))
        b.when_transition((1 - h - k - pa - pc) * nxt_mid)
        b.when_last_row(h + k + pa + pc)

        # --- event-constant columns (free only across a header boundary) ---
        ev_const = [("eid", 1), ("ctlen", 1), ("nblocks", 1), ("v13", 1),
                    ("isr", 1), ("seqv", 1), ("rtyp", 1), ("clb", 16),
                    ("l13b", 16), ("rpad", 4), ("nbb", 8), ("key", 16),
                    ("nb", 12), ("tb", 16), ("r", 8), ("s", 8)]
        for name, cnt in ev_const:
            grp = b.local_group(L[name])
            ngrp = b.next_group(L[name])
            b.assert_zero_vec(tr * ((1 - hn) * (ngrp - grp)), cnt)

        # --- header row: metadata well-formedness + r clamp ---
        POW = [1 << i for i in range(16)]
        clen_v = b.dot_const(b.local_group(L["clb"]), POW)
        l13_v = b.dot_const(b.local_group(L["l13b"]), POW)
        rpad_v = b.dot_const(b.local_group(L["rpad"]), POW[:4])
        nbb_v = b.dot_const(b.local_group(L["nbb"]), POW[:8])
        b.assert_zero(h * (c("ctlen") - clen_v))
        b.assert_zero(h * (l13_v - c("ctlen") - 16))
        b.assert_zero(h * (16 * c("nblocks") - c("ctlen") - rpad_v))
        b.assert_zero(h * (c("nblocks") - nbb_v))

        def rawbits(limb, lo, hi):
            sl = slice(L["rb"].start + 16 * (limb - 1) + lo,
                       L["rb"].start + 16 * (limb - 1) + hi)
            return b.dot_const(b.local_group(sl), POW[lo:hi])

        # r clamp: odd limbs (word hi16) keep bits 0..11; even limbs 2/4/6
        # (word lo16, words 1-3) keep bits 2..15; limb 0 is unmasked.
        for limb in (1, 3, 5, 7):
            b.assert_zero(h * (c("r", limb) - rawbits(limb, 0, 12)))
        for limb in (2, 4, 6):
            b.assert_zero(h * (c("r", limb) - rawbits(limb, 2, 16)))

        # --- keystream rows: counter/bidx linkage ---
        b.assert_zero(k * (c("bidx") - 4 * c("ctr") + 4 - 2 * c("half") - 1))

        # --- Poly1305 rows ---
        b.assert_zero(pa * c("bidx"))
        for j in range(9):
            b.assert_zero(pa * c("acc_in", j))
        b.when_transition(pcn * (n("bidx") - c("bidx") - 1))
        b.when_transition(pln * (c("bidx") - c("nblocks")))
        for j in range(9):
            b.when_transition((pcn + pln) * (n("acc_in", j)
                                             - c("acc_out", j)))
        # aad block (pa), version-switched (RFC 8446 §5.2 / RFC 5246
        # §6.2.3.3 with RFC 7905's implicit nonce — no explicit bytes):
        #   1.3: 23 ‖ 03 03 ‖ be16(ctlen+16) ‖ zeros
        #   1.2: be64(seq) ‖ rtyp ‖ 03 03 ‖ be16(ctlen) ‖ zeros
        l13hi = b.dot_const(
            b.local_group(slice(L["l13b"].start + 8, L["l13b"].start + 16)),
            POW[:8])
        l13lo = b.dot_const(
            b.local_group(slice(L["l13b"].start, L["l13b"].start + 8)),
            POW[:8])
        lh12 = b.dot_const(
            b.local_group(slice(L["clb"].start + 8, L["clb"].start + 16)),
            POW[:8])
        ll12 = b.dot_const(
            b.local_group(slice(L["clb"].start, L["clb"].start + 8)),
            POW[:8])
        sq_lo = b.dot_const(
            b.local_group(slice(L["sqb"].start, L["sqb"].start + 8)),
            POW[:8])
        sq_hi = b.dot_const(
            b.local_group(slice(L["sqb"].start + 8, L["sqb"].start + 16)),
            POW[:8])
        v13 = c("v13")
        b.assert_zero(pa * (c("seqv") - sq_lo - 256 * sq_hi))
        b.assert_zero(pa * (c("blk", 0) - v13 * (23 + 256 * 3)))
        b.assert_zero(pa * (c("blk", 1) - v13 * (3 + 256 * l13hi)))
        b.assert_zero(pa * (c("blk", 2) - v13 * l13lo))
        b.assert_zero(pa * (c("blk", 3)
                            - (1 - v13) * (sq_hi + 256 * sq_lo)))
        b.assert_zero(pa * (c("blk", 4) - (1 - v13) * (c("rtyp") + 768)))
        b.assert_zero(pa * (c("blk", 5) - (1 - v13) * (3 + 256 * lh12)))
        b.assert_zero(pa * (c("blk", 6) - (1 - v13) * ll12))
        b.assert_zero(pa * c("blk", 7))
        # length block (pl): le64(aad_len = 13 − 8·v13) ‖ le64(ctlen)
        b.assert_zero(pl * (c("blk", 0) - 13 + 8 * v13))
        for j in (1, 2, 3, 5, 6, 7):
            b.assert_zero(pl * c("blk", j))
        b.assert_zero(pl * (c("blk", 4) - c("ctlen")))
        # a-operand reduction: acc_in + blk + 2^128 = al + red·(2^130−5),
        # proven limb-wise (all limbs bus-pinned u16, carries boolean)
        pp = pa + pc + pl
        for j in range(9):
            lhs = c("acc_in", j) + (c("blk", j) if j < 8 else 1) \
                + (c("ac", j - 1) if j > 0 else 0)
            rhs = c("al", j) + c("red") * P1305_LIMBS[j] \
                + ((65536 * c("ac", j)) if j < 8 else 0)
            b.assert_zero(pp * (lhs - rhs))
        # tag check (pl): acc_out + s ≡ tag (mod 2^128), tag = parser bytes
        for j in range(8):
            tagle = c("tb", 2 * j) + 256 * c("tb", 2 * j + 1)
            lhs = c("acc_out", j) + c("s", j) + (c("tc", j - 1) if j else 0)
            b.assert_zero(pl * (lhs - tagle - 65536 * c("tc", j)))

        # --- bus fingerprints ---
        gamma = b.challenges[0]

        def dpow(i):
            return b.challenges[1 + i]

        eid = c("eid")
        # ChaCha block receives: header (otk: ctr 0, half 0, out = raw‖s)
        # and keystream rows (ctr, half, out = ksl); nonce limbs are the
        # SAME nb byte columns the journal header pins.
        raw = [c("r", 0)] + [rawbits(limb, 0, 16) for limb in range(1, 8)]
        fp_hdrblk = ExtVal.from_base(BUS_CHACHA_BLOCK) + dpow(0) * eid
        fp_ksblk = (ExtVal.from_base(BUS_CHACHA_BLOCK) + dpow(0) * eid
                    + dpow(1) * c("ctr") + dpow(3) * c("half"))
        for i in range(16):
            fp_hdrblk = fp_hdrblk + dpow(4 + i) * c("key", i)
            fp_ksblk = fp_ksblk + dpow(4 + i) * c("key", i)
            fp_ksblk = fp_ksblk + dpow(20 + i) * c("ksl", i)
        for j in range(8):
            fp_hdrblk = fp_hdrblk + dpow(20 + j) * raw[j]
            fp_hdrblk = fp_hdrblk + dpow(28 + j) * c("s", j)
        for i in range(6):
            nle = c("nb", 2 * i) + 256 * c("nb", 2 * i + 1)
            fp_hdrblk = fp_hdrblk + dpow(36 + i) * nle
            fp_ksblk = fp_ksblk + dpow(36 + i) * nle
        # journal record header (cha = 1 discriminates from GCM records)
        fp_rec = (ExtVal.from_base(BUS_GCM_RECORD) + dpow(0) * eid
                  + dpow(15) * c("nblocks") + dpow(16) * c("ctlen")
                  + dpow(17) * c("v13") + dpow(18) * c("isr")
                  + dpow(19) * 1)
        for i in range(6):
            fp_rec = fp_rec + dpow(1 + i) * (256 * c("nb", 2 * i)
                                             + c("nb", 2 * i + 1))
        for j in range(8):
            fp_rec = fp_rec + dpow(7 + j) * (256 * c("tb", 2 * j)
                                             + c("tb", 2 * j + 1))
        fp_prec = (ExtVal.from_base(BUS_PARSE_REC) + dpow(0) * eid
                   + dpow(1) * c("seqv") + dpow(2) * c("rtyp")
                   + dpow(3) * c("ctlen") + dpow(4) * c("v13")
                   + dpow(5) * c("isr"))
        # keystream slice sends to the data chip
        fp_ks1 = (ExtVal.from_base(BUS_CHACHA_KS) + dpow(0) * eid
                  + dpow(1) * c("bidx"))
        fp_ks2 = (ExtVal.from_base(BUS_CHACHA_KS) + dpow(0) * eid
                  + dpow(1) * (c("bidx") + 1))
        for j in range(8):
            fp_ks1 = fp_ks1 + dpow(2 + j) * c("ksl", j)
            fp_ks2 = fp_ks2 + dpow(2 + j) * c("ksl", 8 + j)
        # ciphertext block receive from the data chip
        fp_pct = (ExtVal.from_base(BUS_POLY_CT) + dpow(0) * eid
                  + dpow(1) * c("bidx"))
        for j in range(8):
            fp_pct = fp_pct + dpow(2 + j) * c("blk", j)
        # Poly1305 accumulator statement from the ModMul chip:
        # (MCLASS, a = al‖0, b = r‖0, r = acc_out‖0) as u16 limbs
        fp_mm = ExtVal.from_base(BUS_MODMUL) + dpow(0) * MCLASS
        for j in range(9):
            fp_mm = fp_mm + dpow(1 + j) * c("al", j)
            fp_mm = fp_mm + dpow(33 + j) * c("acc_out", j)
        for j in range(8):
            fp_mm = fp_mm + dpow(17 + j) * c("r", j)

        inv_hdrblk = b.perm_ext(0)
        inv_ksblk = b.perm_ext(1)
        inv_ks1 = b.perm_ext(2)
        inv_ks2 = b.perm_ext(3)
        inv_rec = b.perm_ext(4)
        inv_prec = b.perm_ext(5)
        inv_tb = [b.perm_ext(6 + j) for j in range(16)]
        inv_pct = b.perm_ext(22)
        inv_mm = b.perm_ext(23)
        u = b.perm_ext(24)
        acc = b.perm_ext(25)
        u_n = b.perm_ext(24, nxt=True)
        acc_n = b.perm_ext(25, nxt=True)
        b.assert_ext_zero(inv_hdrblk * (gamma - fp_hdrblk) - 1)
        b.assert_ext_zero(inv_ksblk * (gamma - fp_ksblk) - 1)
        b.assert_ext_zero(inv_ks1 * (gamma - fp_ks1) - 1)
        b.assert_ext_zero(inv_ks2 * (gamma - fp_ks2) - 1)
        b.assert_ext_zero(inv_rec * (gamma - fp_rec) - 1)
        b.assert_ext_zero(inv_prec * (gamma - fp_prec) - 1)
        for j in range(16):
            fp = (ExtVal.from_base(BUS_TAG_BYTE) + dpow(0) * eid
                  + dpow(1) * (15 - j) + dpow(2) * c("tb", j))
            b.assert_ext_zero(inv_tb[j] * (gamma - fp) - 1)
        b.assert_ext_zero(inv_pct * (gamma - fp_pct) - 1)
        b.assert_ext_zero(inv_mm * (gamma - fp_mm) - 1)

        u_def = (inv_ks1 * (c("m1") * k) + inv_ks2 * (c("m2") * k)
                 - (inv_hdrblk + inv_rec + inv_prec) * h
                 - inv_ksblk * k - inv_pct * pc - inv_mm * pp)
        for iv in inv_tb:
            u_def = u_def - iv * h
        b.assert_ext_zero(u - u_def)
        b.assert_ext_zero((acc - u) * b.is_first_row)
        b.assert_ext_zero((acc_n - acc - u_n) * b.is_transition)
        for ell in range(4):
            b.when_last_row(acc.c[ell] - b.public[ell])

    # ------------------------------------------------------------------

    def generate_perm_trace(self, main, publics, challenges):
        L = LAYOUT
        nrows = main.shape[0]

        def cols(name):
            return main[:, L[name]].astype(np.uint64)

        def col1(name, i=0):
            return main[:, L[name].start + i].astype(np.uint64)

        eid = col1("eid")
        key = cols("key")
        nb = cols("nb")
        tb = cols("tb")
        rl = cols("r")
        sl = cols("s")
        rb = cols("rb")
        ksl = cols("ksl")
        blk = cols("blk")
        al = cols("al")
        acc_out = cols("acc_out")
        POW = np.array([1 << i for i in range(16)], dtype=np.uint64)
        raw = [rl[:, 0]] + [
            (rb[:, 16 * (limb - 1) : 16 * limb] * POW).sum(axis=1) % P
            for limb in range(1, 8)]
        nle = np.stack([nb[:, 2 * i] + 256 * nb[:, 2 * i + 1]
                        for i in range(6)], axis=1)
        nbe = np.stack([256 * nb[:, 2 * i] + nb[:, 2 * i + 1]
                        for i in range(6)], axis=1)
        tbe = np.stack([256 * tb[:, 2 * j] + tb[:, 2 * j + 1]
                        for j in range(8)], axis=1)
        zero = np.zeros(nrows, dtype=np.uint64)
        inv_hdrblk = np_bus_inverse_terms(
            challenges, BUS_CHACHA_BLOCK,
            np.concatenate(
                [eid[:, None], zero[:, None], zero[:, None], zero[:, None],
                 key, np.stack(raw, axis=1), sl, nle], axis=1))
        inv_ksblk = np_bus_inverse_terms(
            challenges, BUS_CHACHA_BLOCK,
            np.concatenate(
                [eid[:, None], col1("ctr")[:, None], zero[:, None],
                 col1("half")[:, None], key, ksl, nle], axis=1))
        bidx = col1("bidx")
        inv_ks1 = np_bus_inverse_terms(
            challenges, BUS_CHACHA_KS,
            np.concatenate([eid[:, None], bidx[:, None], ksl[:, :8]],
                           axis=1))
        inv_ks2 = np_bus_inverse_terms(
            challenges, BUS_CHACHA_KS,
            np.concatenate([eid[:, None], (bidx + 1)[:, None], ksl[:, 8:]],
                           axis=1))
        inv_rec = np_bus_inverse_terms(
            challenges, BUS_GCM_RECORD,
            np.concatenate(
                [eid[:, None], nbe, tbe, col1("nblocks")[:, None],
                 col1("ctlen")[:, None], col1("v13")[:, None],
                 col1("isr")[:, None], np.ones((nrows, 1), np.uint64)],
                axis=1))
        inv_prec = np_bus_inverse_terms(
            challenges, BUS_PARSE_REC, np.stack(
                [eid, col1("seqv"), col1("rtyp"), col1("ctlen"),
                 col1("v13"), col1("isr")], axis=1))
        tb_list = [np_bus_inverse_terms(
            challenges, BUS_TAG_BYTE, np.stack(
                [eid, np.full(nrows, 15 - j, dtype=np.uint64), tb[:, j]],
                axis=1)) for j in range(16)]
        inv_pct = np_bus_inverse_terms(
            challenges, BUS_POLY_CT,
            np.concatenate([eid[:, None], bidx[:, None], blk], axis=1))
        mm_pl = np.concatenate(
            [np.full((nrows, 1), MCLASS, dtype=np.uint64), al,
             np.zeros((nrows, 7), np.uint64), rl,
             np.zeros((nrows, 8), np.uint64), acc_out,
             np.zeros((nrows, 7), np.uint64)], axis=1)
        inv_mm = np_bus_inverse_terms(challenges, BUS_MODMUL, mm_pl)

        h = col1("h")[:, None]
        k = col1("k")[:, None]
        pa, pc, pl = (col1("pa")[:, None], col1("pc")[:, None],
                      col1("pl")[:, None])
        pp = pa + pc + pl
        m1, m2 = col1("m1")[:, None], col1("m2")[:, None]
        pos = (inv_ks1.astype(np.uint64) * (m1 * k)
               + inv_ks2.astype(np.uint64) * (m2 * k)) % P
        neg = ((inv_hdrblk.astype(np.uint64) + inv_rec.astype(np.uint64)
                + inv_prec.astype(np.uint64)) % P * h
               + inv_ksblk.astype(np.uint64) * k
               + inv_pct.astype(np.uint64) * pc
               + inv_mm.astype(np.uint64) * pp) % P
        for iv in tb_list:
            neg = (neg + iv.astype(np.uint64) * h) % P
        u = (pos + P - neg) % P
        acc = np.cumsum(u, axis=0) % P
        return np.concatenate(
            [inv_hdrblk, inv_ksblk, inv_ks1, inv_ks2, inv_rec, inv_prec]
            + tb_list + [inv_pct, inv_mm, u, acc], axis=1).astype(np.uint32)


# ---------------------------------------------------------------------------
# witness generation
# ---------------------------------------------------------------------------

R_MASK = 0x0FFFFFFC0FFFFFFC0FFFFFFC0FFFFFFF


def _le16(data: bytes) -> list[int]:
    return [data[i] + 256 * data[i + 1] for i in range(0, len(data), 2)]


def _limbs9(v: int) -> list[int]:
    return [(v >> (16 * j)) & 0xFFFF for j in range(9)]


def chacha_control_trace(events, metas, min_log_n: int = 6):
    """Build the control trace from recorded ChaChaEvents (eid = list
    index) and the parser-side record metadata (GcmRecordMeta list,
    record_walk with nonce_len = 0).  Returns (trace, [], sends,
    consumed): `sends` is the {(a, b, r, m): count} BUS_MODMUL
    consumption map for modmul_instances; `consumed` the
    {(eid, ctr, half): mult} map for chacha_trace."""
    L = LAYOUT
    meta_by_eid = {m.eid: m for m in (metas or [])}
    rows: list[dict] = []
    sends: dict[tuple, int] = {}
    consumed: dict[tuple, int] = {}
    for eid, ev in enumerate(events):
        m = meta_by_eid.get(eid)
        if m is None:
            raise ValueError(f"no record meta for ChaCha event {eid}")
        v13 = getattr(m, "v13", 0)
        ct = ev.ciphertext
        ctlen = len(ct)
        nblocks = (ctlen + 15) // 16
        raw_l = _le16(ev.otk[:16])
        r_int = int.from_bytes(ev.otk[:16], "little") & R_MASK
        r_l = [(r_int >> (16 * j)) & 0xFFFF for j in range(8)]
        s_int = int.from_bytes(ev.otk[16:32], "little")
        s_l = _le16(ev.otk[16:32])
        base = dict(eid=eid, ctlen=ctlen, nblocks=nblocks, v13=v13,
                    isr=m.is_resp, seqv=m.seqno, rtyp=m.rectype,
                    key=_le16(ev.key), nb=list(ev.nonce),
                    tb=list(ev.tag), r=r_l, s=s_l)
        rb = []
        for limb in range(1, 8):
            rb.extend((raw_l[limb] >> i) & 1 for i in range(16))
        rows.append(dict(base, h=1, rb=rb))
        consumed[(eid, 0, 0)] = consumed.get((eid, 0, 0), 0) + 1
        # keystream supply rows
        ks = b"".join(ev.keystream)
        for hidx in range((nblocks + 1) // 2):
            ctr, half = 1 + hidx // 2, hidx % 2
            bidx = 4 * (ctr - 1) + 2 * half + 1
            sl32 = ks[32 * hidx : 32 * hidx + 32]
            rows.append(dict(base, k=1, ctr=ctr, half=half, bidx=bidx,
                             ksl=_le16(sl32),
                             m1=1 if bidx <= nblocks else 0,
                             m2=1 if bidx + 1 <= nblocks else 0))
            consumed[(eid, ctr, half)] = \
                consumed.get((eid, ctr, half), 0) + 1
        # Poly1305 accumulation rows: aad, ct blocks, lengths
        if v13:
            aad = bytes([23, 3, 3]) + (ctlen + 16).to_bytes(2, "big")
        else:
            assert m.seqno < (1 << 16)
            aad = m.seqno.to_bytes(8, "big") + bytes([m.rectype, 3, 3]) \
                + ctlen.to_bytes(2, "big")
        mac_blocks = [aad + b"\x00" * (16 - len(aad))]
        padded_ct = ct + b"\x00" * (-ctlen % 16)
        mac_blocks += [padded_ct[i : i + 16]
                       for i in range(0, len(padded_ct), 16)]
        import struct

        mac_blocks.append(struct.pack("<QQ", len(aad), ctlen))
        acc = 0
        for i, block in enumerate(mac_blocks):
            nval = int.from_bytes(block, "little") + (1 << 128)
            tot = acc + nval
            red = 1 if tot >= P1305 else 0
            a_can = tot - red * P1305
            acc_next = a_can * r_int % P1305
            sends[(a_can, r_int, acc_next, P1305)] = \
                sends.get((a_can, r_int, acc_next, P1305), 0) + 1
            acc_l = _limbs9(acc)
            al = _limbs9(a_can)
            blk_l = _le16(block)
            # carries of acc_in[j] + blk[j] (+1 at 8) + c = al[j] +
            # red·p[j] + 65536·c'
            ac = []
            carry = 0
            for j in range(8):
                lhs = acc_l[j] + blk_l[j] + carry
                carry = (lhs - al[j] - red * P1305_LIMBS[j]) >> 16
                assert carry in (-1, 0, 1)
                ac.append(carry % P)
            assert acc_l[8] + 1 + carry == al[8] + red * P1305_LIMBS[8]
            row = dict(base, acc_in=acc_l, acc_out=_limbs9(acc_next),
                       al=al, blk=blk_l, ac=ac, red=red)
            if i == 0:
                row["pa"] = 1
                row["sqb"] = [(m.seqno >> j) & 1 for j in range(16)]
            elif i == len(mac_blocks) - 1:
                row["pl"] = 1
                row["bidx"] = 0
                # tag = (acc_next + s) mod 2^128 against the tag bytes
                tagv = (acc_next + s_int) & ((1 << 128) - 1)
                assert tagv.to_bytes(16, "little") == bytes(ev.tag), \
                    "Poly1305 tag mismatch in witness"
                tc = []
                carry = 0
                aon = _limbs9(acc_next)
                for j in range(8):
                    tagle = ev.tag[2 * j] + 256 * ev.tag[2 * j + 1]
                    carry = (aon[j] + s_l[j] + carry - tagle) >> 16
                    tc.append(carry)
                row["tc"] = tc
            else:
                row["pc"] = 1
                row["bidx"] = i
            rows.append(row)
            acc = acc_next

    n_real = len(rows)
    log_n = max(min_log_n, (n_real - 1).bit_length())
    nrows = 1 << log_n
    pad = nrows - n_real

    trace = np.zeros((nrows, L.width), dtype=np.uint32)
    for ri, row in enumerate(rows):
        rr = pad + ri
        for nm in ("h", "k", "pa", "pc", "pl", "eid", "ctlen", "nblocks",
                   "v13", "isr", "seqv", "rtyp", "ctr", "half", "m1",
                   "m2", "bidx", "red"):
            trace[rr, L[nm].start] = row.get(nm, 0)
        ctlen = row["ctlen"]
        l13 = ctlen + 16
        rpad_v = 16 * row["nblocks"] - ctlen
        for i in range(16):
            trace[rr, L["clb"].start + i] = (ctlen >> i) & 1
            trace[rr, L["l13b"].start + i] = (l13 >> i) & 1
        for i in range(4):
            trace[rr, L["rpad"].start + i] = (rpad_v >> i) & 1
        for i in range(8):
            trace[rr, L["nbb"].start + i] = (row["nblocks"] >> i) & 1
        for nm, cnt in (("key", 16), ("nb", 12), ("tb", 16), ("r", 8),
                        ("s", 8)):
            for i in range(cnt):
                trace[rr, L[nm].start + i] = row[nm][i]
        for nm, cnt in (("rb", 112), ("sqb", 16), ("ksl", 16),
                        ("acc_in", 9),
                        ("acc_out", 9), ("blk", 8), ("al", 9), ("ac", 8),
                        ("tc", 8)):
            vals = row.get(nm)
            if vals:
                for i in range(cnt):
                    trace[rr, L[nm].start + i] = vals[i]
    return trace, [], sends, consumed
