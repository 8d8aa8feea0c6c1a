"""Stream-parser AIR chip: binds the committed TLS stream tape to the
AES-GCM record workload and the journal's response claims.

The reference guest gets this binding for free: rustls replays the raw
tape inside the zkVM, so every ciphertext byte the AEAD decrypts IS a tape
byte by construction (SURVEY.md §3.4, crates/input-builder framing §2.3).
Here the machine proof must establish the same fact across chips, and this
chip is the keystone:

  row = one byte of the SHA-padded stream tape (regions back-to-back for
  batches, dead rows after).  Per row the chip

  1. RECEIVES its bytes from the SHA-256 chip: every 32 rows pack into 16
     u16 limbs and consume one (BUS_SHA_BLOCK, obj, seq, half, limbs)
     message — sent only by expose-flagged (xb) SHA chains, and the chain
     publishing the journal's stream_sha256 is constrained xb = 1.  By
     collision resistance the byte column IS the committed tape.
  2. Parses the recorder framing (u8 direction ‖ u32_be length ‖ bytes,
     core/tape.py) with an in-AIR DFA, reassembling the two directed byte
     streams across interleaved segments.
  3. Parses the TLS record layer of each direction (type ‖ version ‖
     len ‖ body) with per-direction register files that persist across
     segment switches, tracking per-direction AEAD sequence numbers and
     the TLS 1.2 CCS encryption boundary.
  4. For every encrypted (GCM) record, SENDS on the bus: the record's
     public metadata (BUS_PARSE_REC: eid, seqno, rectype, ct_len, v13,
     is_resp — consumed by the GCM control chip against the journal's
     record headers), its TLS 1.2 explicit-nonce bytes (BUS_NONCE_BYTE),
     its tag bytes (BUS_TAG_BYTE), and every ciphertext byte
     (BUS_CT_BYTE: eid, remaining-count, byte, response-position,
     is_resp, v13, obj — consumed by the GCM data chip which packs blocks
     for GHASH and recovers plaintext).
  5. Verifies the tape's SHA padding (0x80 ‖ zeros ‖ 64-bit bit-length)
     so the parsed region provably covers the WHOLE tape — truncating the
     parse to hide trailing records breaks the length check.

Soundness of the cross-chip composition is argued in the module docstrings
of gcm_data.py and gcm_control.py; the per-record tag bytes being both
stream bytes (here) and the GHASH-computed tag (control chip ← journal)
closes the loop.

Port copy of zktls_tpu.stark.chips.stream_parser (same names and values;
host code in numpy).
"""

from __future__ import annotations

import numpy as np

from ..air import Air, AirBuilder
from ..bus import (
    BUS_CT_BYTE,
    BUS_NONCE_BYTE,
    BUS_PARSE_REC,
    BUS_SHA_BLOCK,
    BUS_TAG_BYTE,
    np_bus_inverse_terms,
)
from ..ext_val import ExtVal

__all__ = ["StreamParserAir", "parser_trace", "parser_sessions_from_replay",
           "RPOS_SENTINEL"]

P = 2013265921

#: response-position value carried by non-response ciphertext bytes — no
#: real response position can reach it (positions are < 2^32 << P−1)
RPOS_SENTINEL = P - 1


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
    # --- global / per-region ---
    L.add("live")      # 1 on region rows (tape + SHA padding)
    L.add("rs")        # region-start flag (64-aligned)
    L.add("obj")       # region's SHA hash-object id (register)
    L.add("v13")       # region's TLS-1.3 flag (register)
    L.add("cnl")       # region's nonce-less-AEAD flag (register):
    #                    1 for ChaCha20-Poly1305 sessions — TLS 1.2
    #                    records carry no explicit nonce (RFC 7905), so
    #                    the nonce sub-region length is 0 and the record
    #                    body is ct ‖ tag (ctlen = rrem − 16)
    L.add("seqr")      # SHA block counter within region
    L.add("byb", 8)    # byte bits (LSB first); byte value = Σ 2^i·b_i
    L.add("lmb", 16)   # half-block limb accumulators (u16, word-major)
    L.add("plive")     # 1 on tape bytes (0 on SHA padding / dead)
    # segment framing DFA (per-row flags)
    L.add("h0"); L.add("h1"); L.add("h2"); L.add("h3"); L.add("h4")
    L.add("dd")        # payload row
    L.add("dirc")      # current segment direction flag (1 = client→server)
    L.add("rem")       # segment payload remaining AFTER this row
    L.add("remz"); L.add("reminv")   # iszero(rem) gadget
    L.add("segend")    # (h4+dd)·remz — segment completes at this row
    # SHA padding checks
    L.add("padz")      # (1−plive)·(1−lflag)·live
    L.add("lflag")     # length-field row marker (8 per region)
    L.add("lcnt")      # running lflag count (region-reset)
    L.add("lenacc")    # big-endian composition of lflag bytes
    L.add("bcnt")      # running plive count (= tape length, region-reset)
    # --- per-direction record-layer register files ---
    for d in ("c", "s"):
        L.add(f"K0{d}"); L.add(f"K1{d}"); L.add(f"K2{d}")
        L.add(f"K3{d}"); L.add(f"K4{d}"); L.add(f"KB{d}")
        L.add(f"rrem{d}"); L.add(f"rz{d}"); L.add(f"rinv{d}")
        L.add(f"nrem{d}"); L.add(f"nz{d}"); L.add(f"ninv{d}")
        L.add(f"crem{d}"); L.add(f"cz{d}"); L.add(f"cinv{d}")
        L.add(f"trem{d}"); L.add(f"tz{d}"); L.add(f"tinv{d}")
        L.add(f"ict{d}"); L.add(f"itag{d}")
        L.add(f"isg{d}"); L.add(f"isg13{d}"); L.add(f"isr{d}")
        L.add(f"m23{d}")
        L.add(f"eid{d}"); L.add(f"ctlen{d}"); L.add(f"rtyp{d}")
        L.add(f"seqv{d}"); L.add(f"cnt{d}"); L.add(f"enc{d}")
        L.add(f"z20{d}"); L.add(f"z20i{d}")
        L.add(f"z23{d}"); L.add(f"z23i{d}")
        L.add(f"rbase{d}"); L.add(f"dtot{d}"); L.add(f"isrb{d}")
        L.add(f"rinc{d}")
        L.add(f"e0{d}"); L.add(f"e4{d}"); L.add(f"e12{d}"); L.add(f"eend{d}")
        L.add(f"fn{d}"); L.add(f"fc{d}"); L.add(f"ft{d}"); L.add(f"fp{d}")
        L.add(f"ac{d}")
    return L


LAYOUT = _build_layout()

#: per-direction register/flag names that are 0 at a region start
_DIR_RESET = ["K1", "K2", "K3", "K4", "KB", "rrem", "nrem", "crem", "trem",
              "cnt", "enc", "dtot"]


class StreamParserAir(Air):
    width = LAYOUT.width
    num_public = 0
    max_constraint_degree = 3
    #: inv_blk ‖ per-dir (inv_nonce, inv_ct, inv_tag, inv_prec) ‖ u ‖ acc
    perm_width = 4 * (1 + 8 + 2)
    num_perm_challenges = 2
    has_bus = True

    def periodic_columns(self) -> list:
        # period 32: half-block row flags + limb one-hot weights
        p_h31 = np.zeros(32, dtype=np.uint32); p_h31[31] = 1
        p_r32 = np.zeros(32, dtype=np.uint32); p_r32[0] = 1
        psel = np.zeros((16, 32), dtype=np.uint32)
        for r in range(32):
            j, m = r >> 2, r & 3
            k = 2 * j + 1 if m < 2 else 2 * j
            psel[k, r] = 256 if m % 2 == 0 else 1
        # period 64: block-end flag, half parity, block-start flag
        p_b63 = np.zeros(64, dtype=np.uint32); p_b63[63] = 1
        p_half = np.zeros(64, dtype=np.uint32); p_half[32:] = 1
        p_b0 = np.zeros(64, dtype=np.uint32); p_b0[0] = 1
        # next-row variants (pattern[(r+1) % period]) for register updates
        psel_next = np.roll(psel, -1, axis=1)
        return ([p_h31, p_r32, p_b63, p_half, p_b0] + list(psel)
                + list(psel_next))

    # ------------------------------------------------------------------

    def eval(self, b: AirBuilder) -> None:
        L = LAYOUT
        p_h31, p_r32, p_b63, p_half, p_b0 = b.periodic[:5]
        psel = b.periodic[5:21]
        pselN = b.periodic[21:37]

        def c(name, i=0):
            return b.local[L[name].start + i]

        def n(name, i=0):
            return b.next[L[name].start + i]

        tr = b.is_transition
        byv = sum(c("byb", i) * (1 << i) for i in range(8))
        byv_n = sum(n("byb", i) * (1 << i) for i in range(8))

        live, live_n = c("live"), n("live")
        rs, rs_n = c("rs"), n("rs")
        plive, plive_n = c("plive"), n("plive")

        # --- booleanity ---
        for nm in ("live", "rs", "plive", "h0", "h1", "h2", "h3", "h4",
                   "dd", "dirc", "lflag"):
            b.assert_bool(c(nm))
        for i in range(8):
            b.assert_bool(c("byb", i))
        for d in ("c", "s"):
            for nm in ("K0", "K1", "K2", "K3", "K4", "KB", "isg", "isr",
                       "enc"):
                b.assert_bool(c(nm + d))

        # --- region / liveness structure ---
        b.when_first_row(rs - 1)
        b.when_first_row(live - 1)
        b.assert_zero(rs * (1 - live))
        b.assert_zero(rs * (1 - p_b0))           # region starts 64-aligned
        b.assert_zero(tr * (live - live_n) * (1 - p_b63))  # drop at block end
        b.assert_zero(tr * live_n * (1 - live))  # live is a prefix
        b.assert_zero(rs * (1 - plive))
        # plive may rise only at a region start
        b.assert_zero(tr * plive_n * (1 - plive) * (1 - rs_n))
        b.assert_zero(plive * (1 - live))

        # --- SHA block limb accumulation + receive ---
        # reset at each 32-row half boundary: p_r32(next) == p_h31(local)
        for k in range(16):
            b.when_first_row(c("lmb", k) - byv * psel[k])
            b.assert_zero(tr * (n("lmb", k) - c("lmb", k) * (1 - p_h31)
                                - byv_n * pselN[k]))
        # seqr: block counter, region-reset
        b.when_first_row(c("seqr"))
        b.assert_zero(
            tr * (n("seqr") - (1 - rs_n) * (c("seqr") + p_b63)))
        # obj / v13 / cnl are region registers
        b.assert_zero(tr * (1 - rs_n) * (n("obj") - c("obj")))
        b.assert_zero(tr * (1 - rs_n) * (n("v13") - c("v13")))
        b.assert_bool(c("v13"))
        b.assert_zero(tr * (1 - rs_n) * (n("cnl") - c("cnl")))
        b.assert_bool(c("cnl"))

        # --- segment framing DFA ---
        h0, h1, h2, h3, h4, dd = (c("h0"), c("h1"), c("h2"), c("h3"),
                                  c("h4"), c("dd"))
        b.assert_zero(h0 + h1 + h2 + h3 + h4 + dd - plive)
        b.assert_zero(rs * (1 - h0))
        G = plive * plive_n
        b.assert_zero(tr * G * (n("h1") - h0))
        b.assert_zero(tr * G * (n("h2") - h1))
        b.assert_zero(tr * G * (n("h3") - h2))
        b.assert_zero(tr * G * (n("h4") - h3))
        remz = c("remz")
        b.assert_zero(tr * G * (n("dd") - (h4 + dd) * (1 - remz)))
        b.assert_zero(tr * G * (n("h0") - (h4 + dd) * remz))
        # rem register (value = remaining payload AFTER this row)
        rem = c("rem")
        b.when_first_row(rem)
        b.assert_zero(tr * (
            n("rem") - n("h1") * byv_n
            - (n("h2") + n("h3") + n("h4")) * (rem * 256 + byv_n)
            - n("dd") * (rem - 1)))
        b.assert_zero(remz * rem)
        b.assert_zero(remz - 1 + rem * c("reminv"))
        b.assert_zero(c("segend") - (h4 + dd) * remz)
        # direction byte + register
        b.assert_zero(h0 * (byv - 1) * (byv - 2))
        b.assert_zero(tr * (n("dirc") - n("h0") * (byv_n - 1)
                            - (1 - n("h0")) * c("dirc")))
        # a clean parse must end at a segment boundary
        b.assert_zero(tr * plive * (1 - plive_n) * (1 - c("segend")))

        # --- SHA padding checks ---
        lflag = c("lflag")
        b.assert_zero(lflag * plive)
        b.assert_zero(lflag * (1 - live))
        b.assert_zero(c("padz") - (1 - plive) * (1 - lflag) * live)
        # first padding byte is 0x80; later non-length padding bytes are 0
        b.assert_zero(tr * plive * (1 - plive_n) * (byv_n - 0x80))
        b.assert_zero(tr * (1 - plive) * n("padz") * byv_n)
        # counters (region-reset)
        b.when_first_row(c("lcnt"))
        b.when_first_row(c("bcnt") - plive)
        b.when_first_row(c("lenacc"))
        b.assert_zero(tr * (n("lcnt") - (1 - rs_n) * (c("lcnt") + n("lflag"))))
        b.assert_zero(tr * (n("bcnt") - (1 - rs_n) * (c("bcnt") + plive_n)))
        b.assert_zero(tr * (
            n("lenacc") - (1 - rs_n) * (c("lenacc") * (1 + 255 * n("lflag"))
                                        + byv_n * n("lflag"))))
        # region end: length field == 8·tape-length, exactly 8 length rows
        for expr in (c("lenacc") - 8 * c("bcnt"), c("lcnt") - 8):
            b.assert_zero(tr * live * rs_n * expr)
            b.assert_zero(tr * live * (live - live_n) * expr)
            b.when_last_row(live * expr)

        # --- per-direction record layer ---
        for d, dsel_n in (("c", n("dirc")), ("s", 1 - n("dirc"))):
            K0, K1, K2 = c("K0" + d), c("K1" + d), c("K2" + d)
            K3, K4, KB = c("K3" + d), c("K4" + d), c("KB" + d)
            a_n = n("ac" + d)
            b.assert_zero(n("ac" + d) - n("dd") * dsel_n)
            b.assert_zero(
                K0 + K1 + K2 + K3 + K4 + KB - 1)
            b.when_first_row(K0 - 1)
            rz_n, nz, cz = n("rz" + d), c("nz" + d), c("cz" + d)
            # kind steps (hold when inactive)
            b.assert_zero(tr * (n("K1" + d) - (1 - a_n) * K1 - a_n * K0))
            b.assert_zero(tr * (n("K2" + d) - (1 - a_n) * K2 - a_n * K1))
            b.assert_zero(tr * (n("K3" + d) - (1 - a_n) * K3 - a_n * K2))
            b.assert_zero(tr * (n("K4" + d) - (1 - a_n) * K4 - a_n * K3))
            b.assert_zero(tr * (n("KB" + d) - (1 - a_n) * KB
                                - a_n * (K4 + KB) * (1 - rz_n)))
            b.assert_zero(tr * (n("K0" + d) - (1 - a_n) * K0
                                - a_n * (K4 + KB) * rz_n))
            # record body remaining
            rrem = c("rrem" + d)
            b.assert_zero(tr * (
                n("rrem" + d) - (1 - a_n) * rrem
                - a_n * (K3 * byv_n + K4 * (rrem * 256 + byv_n)
                         + KB * (rrem - 1))))
            for reg, zc, ic in (("rrem", "rz", "rinv"), ("nrem", "nz", "ninv"),
                                ("crem", "cz", "cinv"), ("trem", "tz", "tinv")):
                b.assert_zero(c(zc + d) * c(reg + d))
                b.assert_zero(c(zc + d) - 1 + c(reg + d) * c(ic + d))
            # event flags
            b.when_first_row(c("e0" + d))
            b.when_first_row(c("e4" + d))
            b.when_first_row(c("e12" + d))
            b.when_first_row(c("eend" + d))
            b.assert_zero(tr * (n("e0" + d) - a_n * K0))
            b.assert_zero(tr * (n("e4" + d) - a_n * K4))
            b.assert_zero(tr * (n("e12" + d) - a_n * (K1 + K2)))
            b.assert_zero(tr * (n("eend" + d) - a_n * (K4 + KB) * rz_n))
            e0_n, e4_n = n("e0" + d), n("e4" + d)
            eend_n = n("eend" + d)
            # sub-region state products
            b.assert_zero(c("ict" + d) - nz * (1 - cz))
            b.assert_zero(c("itag" + d) - nz * cz * c("isg" + d))
            # isg13 gates the 8-byte explicit nonce: present only on
            # TLS 1.2 records of nonce-carrying ciphers (GCM, not ChaCha)
            b.assert_zero(c("isg13" + d)
                          - c("isg" + d) * (1 - c("v13")) * (1 - c("cnl")))
            b.assert_zero(c("m23" + d) - c("isg" + d) * c("z23" + d))
            # isrb: response-byte marker — like isr but excluding the
            # final ciphertext byte of a TLS 1.3 record (the inner
            # content-type byte, which is not response content)
            b.assert_zero(c("isrb" + d)
                          - c("isr" + d) * (1 - c("v13") * c("cz" + d)))
            # record-constant columns: rtyp/seqv/rbase/isg change only at
            # e0; eid/ctlen/isr are resolved when the header length is
            # known, so they may also change at e4 (they are 0 between e0
            # and e4, and every message using them is sent after e4)
            # e0/e4/rs rows are pairwise exclusive, so the "may change
            # here" gates stay linear
            for nm in ("isg", "rtyp", "seqv", "rbase"):
                b.assert_zero(tr * (1 - e0_n - rs_n)
                              * (n(nm + d) - c(nm + d)))
            for nm in ("eid", "ctlen", "isr"):
                b.assert_zero(tr * (1 - e0_n - rs_n - e4_n)
                              * (n(nm + d) - c(nm + d)))
                b.assert_zero(e0_n * n(nm + d))
            for nm in ("isg", "isr", "eid", "ctlen", "rtyp", "seqv",
                       "rbase"):
                b.assert_zero(rs_n * n(nm + d))
            b.assert_zero(e0_n * (n("rtyp" + d) - byv_n))
            b.assert_zero(e0_n * (n("seqv" + d) - c("cnt" + d)))
            b.assert_zero(e0_n * (n("rbase" + d) - c("dtot" + d)))
            # record type gadgets
            b.assert_zero(c("z20" + d) * (c("rtyp" + d) - 20))
            b.assert_zero(c("z20" + d) - 1
                          + (c("rtyp" + d) - 20) * c("z20i" + d))
            b.assert_zero(c("z23" + d) * (c("rtyp" + d) - 23))
            b.assert_zero(c("z23" + d) - 1
                          + (c("rtyp" + d) - 23) * c("z23i" + d))
            # encrypted-record rule: 1.2 by CCS boundary, 1.3 by outer type
            b.assert_zero(e0_n * (1 - c("v13"))
                          * (n("isg" + d) - c("enc" + d)))
            b.assert_zero(e0_n * c("v13") * (n("isg" + d) - n("z23" + d)))
            # counters (rs resets; e0/eend are forced 0 on rs rows since
            # a region-start row is a segment header, so the increment
            # terms need no rs factor)
            b.assert_zero(tr * (n("cnt" + d) - (1 - rs_n) * c("cnt" + d)
                                - e0_n * n("isg" + d)))
            b.assert_zero(tr * (n("enc" + d) - (1 - rs_n) * c("enc" + d)
                                - n("eend" + d) * n("z20" + d)
                                * (1 - c("enc" + d))))
            # isr = "contributes to this direction's application stream"
            # (server: response bytes; client: request bytes — round-3
            # keccak binding).  1.2: exactly (encrypted ∧ type 23),
            # checked when resolved at e4; both versions bounded by it.
            b.assert_zero(c("isr" + d) * (1 - c("m23" + d)))
            b.assert_zero((1 - c("v13")) * e4_n
                          * (n("isr" + d) - n("m23" + d)))
            # rinc materializes eend·isr so the dtot update stays deg 3
            b.assert_zero(c("rinc" + d) - c("eend" + d) * c("isr" + d))
            b.assert_zero(tr * (
                n("dtot" + d) - (1 - rs_n) * c("dtot" + d)
                - n("rinc" + d) * (n("ctlen" + d) - c("v13"))))
            # ct_len relation + sub-region initialisation
            b.assert_zero(e4_n * (
                n("isg" + d) * (n("rrem" + d) - n("ctlen" + d) - 24)
                + 8 * (n("isg" + d) - n("isg13" + d))))
            b.assert_zero((1 - c("isg" + d)) * c("ctlen" + d))
            b.assert_zero(tr * (n("nrem" + d) - c("nrem" + d) + n("fn" + d)
                                - e4_n * 8 * n("isg13" + d)))
            b.assert_zero(tr * (n("crem" + d) - c("crem" + d) + n("fc" + d)
                                - e4_n * n("ctlen" + d)))
            b.assert_zero(tr * (n("trem" + d) - c("trem" + d) + n("ft" + d)
                                - e4_n * 16 * n("isg" + d)))
            # per-row sub-kind flags
            b.when_first_row(c("fn" + d))
            b.when_first_row(c("fc" + d))
            b.when_first_row(c("ft" + d))
            b.assert_zero(tr * (n("fn" + d) - a_n * KB * (1 - nz)))
            b.assert_zero(tr * (n("fc" + d) - a_n * KB * c("ict" + d)))
            b.assert_zero(tr * (n("ft" + d) - a_n * KB * c("itag" + d)))
            b.assert_zero(c("fp" + d) - c("eend" + d) * c("isg" + d))
            # record end of a GCM record: tag fully consumed
            b.assert_zero(eend_n * n("isg" + d) * (1 - n("tz" + d)))
            # encrypted records carry legacy version 0x0303
            b.assert_zero(n("e12" + d) * n("isg" + d) * (byv_n - 3))
            # region start resets
            for nm in _DIR_RESET:
                b.assert_zero(rs_n * n(nm + d) * 1)
            b.assert_zero(rs_n * (1 - n("K0" + d)))
            # a region must not end mid-record
            b.assert_zero(tr * plive * (1 - plive_n) * (1 - n("K0" + d)))

        # --- bus messages ---
        gamma = b.challenges[0]

        def dpow(i):
            return b.challenges[1 + i]

        # receive: SHA half-block
        fp_blk = (ExtVal.from_base(BUS_SHA_BLOCK) + dpow(0) * c("obj")
                  + dpow(1) * c("seqr") + dpow(2) * p_half)
        for k in range(16):
            fp_blk = fp_blk + dpow(3 + k) * c("lmb", k)
        inv_blk = b.perm_ext(0)
        b.assert_ext_zero(inv_blk * (gamma - fp_blk) - 1)
        u_def = ExtVal.from_base(0) - inv_blk * (live * p_h31)

        idx = 1
        for d, dsv in (("c", 0), ("s", 1)):
            eid = c("eid" + d)
            fp_nonce = (ExtVal.from_base(BUS_NONCE_BYTE) + dpow(0) * eid
                        + dpow(1) * c("nrem" + d) + dpow(2) * byv)
            # crem here is the POST-row value (ctlen−1−j for 0-based byte
            # j), so the byte's app-stream position is rbase+ctlen−1−crem
            rposv = (c("isrb" + d) * (c("rbase" + d) + c("ctlen" + d)
                                      - 1 - c("crem" + d))
                     + (1 - c("isrb" + d)) * RPOS_SENTINEL)
            fp_ct = (ExtVal.from_base(BUS_CT_BYTE) + dpow(0) * eid
                     + dpow(1) * c("crem" + d) + dpow(2) * byv
                     + dpow(3) * rposv + dpow(4) * c("isr" + d)
                     + dpow(5) * c("v13") + dpow(6) * c("obj")
                     + dpow(7) * dsv + dpow(8) * c("isrb" + d))
            fp_tag = (ExtVal.from_base(BUS_TAG_BYTE) + dpow(0) * eid
                      + dpow(1) * c("trem" + d) + dpow(2) * byv)
            fp_prec = (ExtVal.from_base(BUS_PARSE_REC) + dpow(0) * eid
                       + dpow(1) * c("seqv" + d) + dpow(2) * c("rtyp" + d)
                       + dpow(3) * c("ctlen" + d) + dpow(4) * c("v13")
                       + dpow(5) * (c("isr" + d) * dsv))
            iv_n = b.perm_ext(idx)
            iv_c = b.perm_ext(idx + 1)
            iv_t = b.perm_ext(idx + 2)
            iv_p = b.perm_ext(idx + 3)
            idx += 4
            b.assert_ext_zero(iv_n * (gamma - fp_nonce) - 1)
            b.assert_ext_zero(iv_c * (gamma - fp_ct) - 1)
            b.assert_ext_zero(iv_t * (gamma - fp_tag) - 1)
            b.assert_ext_zero(iv_p * (gamma - fp_prec) - 1)
            u_def = (u_def + iv_n * c("fn" + d) + iv_c * c("fc" + d)
                     + iv_t * c("ft" + d) + iv_p * c("fp" + d))

        u = b.perm_ext(idx)
        acc = b.perm_ext(idx + 1)
        u_n = b.perm_ext(idx, nxt=True)
        acc_n = b.perm_ext(idx + 1, nxt=True)
        b.assert_ext_zero(u - u_def)
        b.assert_ext_zero((acc - u) * b.is_first_row)
        b.assert_ext_zero((acc_n - acc - u_n) * b.is_transition)
        for ell in range(4):
            b.when_last_row(acc.c[ell] - b.public[ell])

    # ------------------------------------------------------------------

    def generate_perm_trace(self, main, publics, challenges):
        L = LAYOUT
        nrows = main.shape[0]

        def col(name, i=0):
            return main[:, L[name].start + i].astype(np.uint64)

        byv = np.zeros(nrows, dtype=np.uint64)
        for i in range(8):
            byv += col("byb", i) << i
        r = np.arange(nrows)
        p_h31 = ((r % 32) == 31).astype(np.uint64)
        p_half = ((r % 64) >= 32).astype(np.uint64)
        lmb = main[:, L["lmb"]].astype(np.uint64)
        blk_pl = np.concatenate(
            [col("obj")[:, None], col("seqr")[:, None], p_half[:, None],
             lmb], axis=1)
        inv_blk = np_bus_inverse_terms(challenges, BUS_SHA_BLOCK, blk_pl)
        u = (P - (inv_blk.astype(np.uint64)
                  * (col("live") * p_h31)[:, None]) % P) % P
        parts = [inv_blk]
        for d, dsv in (("c", 0), ("s", 1)):
            eid = col("eid" + d)[:, None]
            nonce_pl = np.concatenate(
                [eid, col("nrem" + d)[:, None], byv[:, None]], axis=1)
            isr = col("isr" + d)
            isrb = (isr * (1 - col("v13") * col("cz" + d))) % P
            rposv = (isrb * ((col("rbase" + d) + col("ctlen" + d)
                              + 2 * P - 1 - col("crem" + d)) % P)
                     + (1 - isrb) * RPOS_SENTINEL) % P
            dsc = np.full_like(isr, dsv)
            ct_pl = np.concatenate(
                [eid, col("crem" + d)[:, None], byv[:, None],
                 rposv[:, None], isr[:, None], col("v13")[:, None],
                 col("obj")[:, None], dsc[:, None], isrb[:, None]], axis=1)
            tag_pl = np.concatenate(
                [eid, col("trem" + d)[:, None], byv[:, None]], axis=1)
            prec_pl = np.concatenate(
                [eid, col("seqv" + d)[:, None], col("rtyp" + d)[:, None],
                 col("ctlen" + d)[:, None], col("v13")[:, None],
                 (isr * dsv)[:, None]], axis=1)
            iv_n = np_bus_inverse_terms(challenges, BUS_NONCE_BYTE, nonce_pl)
            iv_c = np_bus_inverse_terms(challenges, BUS_CT_BYTE, ct_pl)
            iv_t = np_bus_inverse_terms(challenges, BUS_TAG_BYTE, tag_pl)
            iv_p = np_bus_inverse_terms(challenges, BUS_PARSE_REC, prec_pl)
            u = (u + iv_n.astype(np.uint64) * col("fn" + d)[:, None]
                 + iv_c.astype(np.uint64) * col("fc" + d)[:, None]
                 + iv_t.astype(np.uint64) * col("ft" + d)[:, None]
                 + iv_p.astype(np.uint64) * col("fp" + d)[:, None]) % P
            parts += [iv_n, iv_c, iv_t, iv_p]
        acc = np.cumsum(u, axis=0) % P
        parts += [u, acc]
        return np.concatenate(parts, axis=1).astype(np.uint32)


# ---------------------------------------------------------------------------
# witness generation: simulate the DFA over the real tape(s)
# ---------------------------------------------------------------------------


class _DirState:
    def __init__(self):
        self.kind = "K0"
        self.rrem = 0
        self.nrem = 0
        self.crem = 0
        self.trem = 0
        self.isg = 0
        self.isr = 0
        self.eid = 0
        self.ctlen = 0
        self.rtyp = 0
        self.seqv = 0
        self.cnt = 0
        self.enc = 0
        self.rbase = 0
        self.dtot = 0


def _sha_pad(data: bytes) -> bytes:
    bit_len = len(data) * 8
    pad = b"\x80" + b"\x00" * ((-len(data) - 9) % 64)
    return data + pad + bit_len.to_bytes(8, "big")


def parser_sessions_from_replay(stream: bytes, gcm_events: list,
                                v13: bool, obj: int = 1,
                                eid_off: int = 0) -> dict:
    """One session spec for parser_trace: matches stream records to GCM
    events by tag bytes.  eid_off renumbers events for batch proofs."""
    tag_to_eid = {}
    for eid, ev in enumerate(gcm_events):
        tag_to_eid[bytes(ev.tag)] = eid_off + eid
    resp_flags = {}
    for eid, ev in enumerate(gcm_events):
        # 1.3: inner content type is the last plaintext byte; the walk
        # additionally requires the server direction.  1.2: derived from
        # (dir, outer type) during the walk.
        resp_flags[eid_off + eid] = (len(ev.plaintext) > 0
                                     and ev.plaintext[-1] == 23) \
            if v13 else None
    # ChaCha20-Poly1305 events (identified by their Poly1305 one-time
    # key) make the session nonce-less: its TLS 1.2 records carry no
    # explicit nonce bytes (RFC 7905)
    cnl = 1 if (gcm_events and hasattr(gcm_events[0], "otk")) else 0
    return {"stream": bytes(stream), "events": gcm_events,
            "tag_to_eid": tag_to_eid, "resp_flags": resp_flags,
            "v13": 1 if v13 else 0, "cnl": cnl, "obj": obj}


def parser_trace(sessions: list[dict], min_log_n: int = 6):
    """Build the parser trace from session specs (parser_sessions_from_replay).
    Simulates exactly the constrained DFA; returns (trace, [])."""
    L = LAYOUT
    rows: list[np.ndarray] = []

    for sess in sessions:
        tape = sess["stream"]
        v13 = sess["v13"]
        cnl = sess.get("cnl", 0)
        obj = sess["obj"]
        tag_to_eid = sess["tag_to_eid"]
        resp_flags = sess["resp_flags"]
        padded = _sha_pad(tape)
        tape_len = len(tape)
        n_rows = len(padded)
        assert n_rows % 64 == 0
        region = np.zeros((n_rows, L.width), dtype=np.uint32)

        # global registers
        seg_kind = "h0"
        rem = 0
        dirc = 0
        lcnt = 0
        lenacc = 0
        bcnt = 0
        dirs = {"c": _DirState(), "s": _DirState()}
        # pre-scan: locate each GCM record's tag bytes to resolve eids.
        # We walk lazily: when a record header completes we know (dir,
        # rlen); the record's tag is its last 16 body bytes, which we can
        # read ahead from the reassembled direction stream.
        dstreams = {"c": bytearray(), "s": bytearray()}
        from ...core.tape import decode_stream

        for seg in decode_stream(tape):
            key = "c" if seg.direction == 2 else "s"
            dstreams[key] += seg.data
        dpos = {"c": 0, "s": 0}

        for r in range(n_rows):
            by = padded[r]
            row = region[r]
            row[L["live"].start] = 1
            row[L["obj"].start] = obj % P
            row[L["v13"].start] = v13
            row[L["cnl"].start] = cnl
            row[L["seqr"].start] = r // 64
            for i in range(8):
                row[L["byb"].start + i] = (by >> i) & 1
            # limb accumulators
            if r % 32 == 0:
                limbs = [0] * 16
            j, m = (r % 32) >> 2, r % 4
            k = 2 * j + 1 if m < 2 else 2 * j
            limbs[k] += by * (256 if m % 2 == 0 else 1)
            for kk in range(16):
                row[L["lmb"].start + kk] = limbs[kk]
            if r == 0:
                row[L["rs"].start] = 1

            in_tape = r < tape_len
            row[L["plive"].start] = 1 if in_tape else 0
            if in_tape:
                bcnt += 1
                # segment DFA: row kind decided by current state
                kmap = {"h0": "h0", "h1": "h1", "h2": "h2", "h3": "h3",
                        "h4": "h4", "dd": "dd"}
                row[L[kmap[seg_kind]].start] = 1
                is_dd = seg_kind == "dd"
                is_h4 = seg_kind == "h4"
                if seg_kind == "h0":
                    dirc = by - 1
                    rem = 0
                    seg_kind = "h1"
                elif seg_kind == "h1":
                    rem = by
                    seg_kind = "h2"
                elif seg_kind in ("h2", "h3"):
                    rem = rem * 256 + by
                    seg_kind = "h3" if seg_kind == "h2" else "h4"
                elif seg_kind == "h4":
                    rem = rem * 256 + by
                    seg_kind = "dd" if rem > 0 else "h0"
                elif seg_kind == "dd":
                    rem -= 1
                    if rem == 0:
                        seg_kind = "h0"
                row[L["segend"].start] = (
                    1 if (is_dd or is_h4) and rem == 0 else 0)

                # record layer for the active direction
                if is_dd:
                    dk = "c" if dirc == 1 else "s"
                    st = dirs[dk]
                    dpos[dk] += 1
                    suffix = dk
                    if st.kind == "K0":
                        st.rtyp = by
                        st.seqv = st.cnt
                        st.rbase = st.dtot
                        if v13:
                            st.isg = 1 if by == 23 else 0
                        else:
                            st.isg = st.enc
                        st.isr = 0
                        st.eid = 0
                        st.ctlen = 0
                        st.cnt += st.isg
                        region[r, L["e0" + suffix].start] = 1
                        st.kind = "K1"
                    elif st.kind == "K1":
                        region[r, L["e12" + suffix].start] = 1
                        st.kind = "K2"
                    elif st.kind == "K2":
                        region[r, L["e12" + suffix].start] = 1
                        st.kind = "K3"
                    elif st.kind == "K3":
                        st.rrem = by
                        st.kind = "K4"
                    elif st.kind == "K4":
                        region[r, L["e4" + suffix].start] = 1
                        st.rrem = st.rrem * 256 + by
                        if st.isg:
                            nlen = 0 if (v13 or cnl) else 8
                            st.ctlen = st.rrem - 16 - nlen
                            st.nrem = st.isg * nlen
                            st.crem = st.ctlen
                            st.trem = 16
                            # resolve eid from the record's tag bytes
                            dsn = dstreams[dk]
                            body_start = dpos[dk]
                            tag = bytes(
                                dsn[body_start + st.rrem - 16
                                    : body_start + st.rrem])
                            if tag not in tag_to_eid:
                                raise ValueError(
                                    "GCM record tag not found in events")
                            st.eid = tag_to_eid[tag]
                            if v13:
                                st.isr = 1 if resp_flags[st.eid] else 0
                            else:
                                st.isr = 1 if st.rtyp == 23 else 0
                        if st.rrem > 0:
                            st.kind = "KB"
                        else:
                            region[r, L["eend" + suffix].start] = 1
                            st.kind = "K0"
                    elif st.kind == "KB":
                        # sub-kind of THIS byte from pre-state
                        if st.isg and st.nrem > 0:
                            region[r, L["fn" + suffix].start] = 1
                            st.nrem -= 1
                        elif st.isg and st.crem > 0:
                            region[r, L["fc" + suffix].start] = 1
                            st.crem -= 1
                        elif st.isg and st.trem > 0:
                            region[r, L["ft" + suffix].start] = 1
                            st.trem -= 1
                        st.rrem -= 1
                        if st.rrem == 0:
                            region[r, L["eend" + suffix].start] = 1
                            if st.isg:
                                region[r, L["fp" + suffix].start] = 1
                            if st.rtyp == 20 and not st.enc:
                                st.enc = 1
                            if st.isr:
                                region[r, L["rinc" + suffix].start] = 1
                                st.dtot += st.ctlen - v13
                            st.kind = "K0"
                    row[L["ac" + suffix].start] = 1
            else:
                # padding region
                if r >= n_rows - 8:
                    row[L["lflag"].start] = 1
                    lcnt += 1
                    lenacc = (lenacc * 256 + by) % P
                row[L["padz"].start] = (
                    1 if not row[L["lflag"].start] else 0)
            row[L["dirc"].start] = dirc
            row[L["rem"].start] = rem % P
            if rem % P == 0:
                row[L["remz"].start] = 1
            else:
                row[L["reminv"].start] = pow(rem % P, P - 2, P)
            row[L["lcnt"].start] = lcnt
            row[L["lenacc"].start] = lenacc
            row[L["bcnt"].start] = bcnt
            # per-direction register snapshot (state AFTER this row)
            for dk in ("c", "s"):
                st = dirs[dk]
                row[L["K0" + dk].start] = 1 if st.kind == "K0" else 0
                row[L["K1" + dk].start] = 1 if st.kind == "K1" else 0
                row[L["K2" + dk].start] = 1 if st.kind == "K2" else 0
                row[L["K3" + dk].start] = 1 if st.kind == "K3" else 0
                row[L["K4" + dk].start] = 1 if st.kind == "K4" else 0
                row[L["KB" + dk].start] = 1 if st.kind == "KB" else 0
                for reg, zc, ic in (
                        ("rrem", "rz", "rinv"), ("nrem", "nz", "ninv"),
                        ("crem", "cz", "cinv"), ("trem", "tz", "tinv")):
                    v = getattr(st, reg)
                    row[L[reg + dk].start] = v % P
                    if v % P == 0:
                        row[L[zc + dk].start] = 1
                    else:
                        row[L[ic + dk].start] = pow(v % P, P - 2, P)
                nzv = row[L["nz" + dk].start]
                czv = row[L["cz" + dk].start]
                row[L["ict" + dk].start] = nzv * (1 - czv)
                row[L["itag" + dk].start] = nzv * czv * st.isg
                row[L["isg" + dk].start] = st.isg
                row[L["isg13" + dk].start] = (st.isg * (1 - v13)
                                              * (1 - cnl))
                row[L["isr" + dk].start] = st.isr
                row[L["eid" + dk].start] = st.eid
                row[L["ctlen" + dk].start] = st.ctlen % P
                row[L["rtyp" + dk].start] = st.rtyp
                row[L["seqv" + dk].start] = st.seqv
                row[L["cnt" + dk].start] = st.cnt
                row[L["enc" + dk].start] = st.enc
                rt20 = (st.rtyp - 20) % P
                if rt20 == 0:
                    row[L["z20" + dk].start] = 1
                else:
                    row[L["z20i" + dk].start] = pow(rt20, P - 2, P)
                rt23 = (st.rtyp - 23) % P
                if rt23 == 0:
                    row[L["z23" + dk].start] = 1
                else:
                    row[L["z23i" + dk].start] = pow(rt23, P - 2, P)
                row[L["m23" + dk].start] = (
                    st.isg * row[L["z23" + dk].start])
                row[L["rbase" + dk].start] = st.rbase % P
                row[L["dtot" + dk].start] = st.dtot % P
                row[L["isrb" + dk].start] = (
                    st.isr * (1 - v13 * (1 if st.crem % P == 0 else 0)))
        rows.append(region)

    full = np.concatenate(rows, axis=0)
    n_real = full.shape[0]
    log_n = max(min_log_n, (n_real - 1).bit_length())
    n = 1 << log_n
    if n > n_real:
        # back-pad with dead rows; segment/record registers hold their
        # final values (all updates gated by live/plive flags)
        pad = np.tile(full[-1:], (n - n_real, 1))
        dead_cols = ["live", "rs", "plive", "h0", "h1", "h2", "h3", "h4",
                     "dd", "lflag", "padz", "segend", "rincc", "rincs"]
        for nm in dead_cols:
            pad[:, L[nm]] = 0
        # limb accumulators / flags recompute as zero-byte rows
        for dk in ("c", "s"):
            for nm in ("e0", "e4", "e12", "eend", "fn", "fc", "ft", "fp",
                       "ac"):
                pad[:, L[nm + dk]] = 0
        r0 = np.arange(n_real, n)
        for kk in range(16):
            pad[:, L["lmb"].start + kk] = 0
        # byv = 0 on dead rows
        pad[:, L["byb"]] = 0
        # lcnt/lenacc/bcnt hold; seqr keeps counting per its update rule
        seqr_last = int(full[-1, L["seqr"].start])
        incs = np.cumsum(((r0 - 1) % 64 == 63).astype(np.uint64))
        pad[:, L["seqr"].start] = (seqr_last + incs) % P
        # limb accumulation on dead rows: zeros accumulate to zero ✓
        full = np.concatenate([full, pad], axis=0)
    return full, []
