"""GCM data AIR chip: ciphertext-block assembly, keystream XOR, and
response-content binding.

Sits between the stream parser, the GCM control chip, the GHASH chip and
the xor table (the wiring the reference gets from straight-line guest code
around its AES-GCM precompile calls, SURVEY.md §3.4):

  16 rows per ciphertext block (an event's blocks need not be contiguous —
  every cross-block fact travels by bus message).  Each block

  * RECEIVES its ciphertext bytes from the stream parser
    (BUS_CT_BYTE: eid, remaining, byte, rpos, is_resp, v13, obj — one per
    live row), so the block content IS located ciphertext in the
    committed tape;
  * RECEIVES its keystream block from the control chip
    (BUS_GCM_KS: eid, blk_idx, limbs) — E_K(counter), AES-chip-proven;
  * proves plaintext = ciphertext ⊕ keystream per byte with two nibble
    lookups against the xor table (BUS_XOR) — which also range-checks all
    nibbles;
  * SENDS the zero-padded 16-byte block to the GHASH chip
    (BUS_GCM_CT: eid, blk_idx, limbs), closing ct ↔ tag;
  * RECEIVES the journal's filtered-response bytes (BUS_FILTERED: obj,
    pos, byte — sent by the VERIFIER from public journal data) at rows
    whose bus-bound response position matches, with a multiplicity column
    for overlapping ranges.  A journal claiming any filtered byte that is
    not the actual decrypted response plaintext at that position leaves
    an unconsumed message and breaks the global balance.

Uniqueness/completeness need no in-chip cross-block constraints: a block
claiming a wrong (eid, blk_idx) double- or under-consumes some
control-chip keystream send, and a wrong live-row count double- or
under-consumes parser ciphertext-byte sends.

TLS 1.3 inner-content-type check (closes the round-3 is_resp hole): for
every v13 event the LAST plaintext byte is the inner content type
(rustls replay semantics, no-padding profile — see below), and the chip
enforces  isr = 1 ⟺ that byte == 23 (ApplicationData).  A prover can
therefore neither under-claim is_resp = 0 on a true application record
(hiding its bytes from the response keccak / filtered matching) nor
over-claim is_resp = 1 on a handshake record (injecting non-application
bytes into the hashes): the parser's per-byte isr claim is bus-matched to
this chip's column, and the decrypted type byte refutes a false flag.
No-padding profile: a record whose sender appended RFC 8446 zero padding
after the content type would fail to prove (the guest replay and
record_walk's is_app detection already assume the unpadded layout);
this is a documented completeness restriction, not a soundness gap —
the tape is committed, so the padding bytes are not prover-choosable.

Port copy of zktls_tpu.stark.chips.gcm_data (same names and values; host
code in numpy).
"""

from __future__ import annotations

import numpy as np

from ..air import Air, AirBuilder
from ..bus import (
    BUS_CHACHA_KS,
    BUS_CT_BYTE,
    BUS_FILTERED,
    BUS_GCM_CT,
    BUS_GCM_KS,
    BUS_HASH_BYTE,
    BUS_POLY_CT,
    BUS_XOR,
    np_bus_inverse_terms,
)
from ..ext_val import ExtVal
from .stream_parser import RPOS_SENTINEL

__all__ = ["GcmDataAir", "ChaChaDataAir", "gcm_data_trace",
           "ROWS_PER_BLOCK"]

P = 2013265921
ROWS_PER_BLOCK = 16


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
    L.add("blklive")   # 1 on real blocks (block-constant)
    L.add("eid")       # event id (block-constant)
    L.add("bidx")      # 1-based ct block index within event (block-const)
    L.add("ctlen")     # event ciphertext length (block-constant)
    L.add("v13")       # (block-constant)
    L.add("isr")       # app-stream record flag (block-constant)
    L.add("obj")       # session stream object id (block-constant)
    L.add("dirs")      # direction: 0 = client/request, 1 = server/response
    L.add("live")      # 1 iff this row holds a real ciphertext byte
    L.add("rp")        # this byte's app-stream position (or sentinel)
    L.add("hbf")       # 1 iff this row is an app-stream plaintext byte
    L.add("cthi"); L.add("ctlo")   # ciphertext nibbles
    L.add("kshi"); L.add("kslo")   # keystream nibbles
    L.add("pthi"); L.add("ptlo")   # plaintext nibbles
    L.add("f")         # filtered-byte receive multiplicity
    # TLS 1.3 inner-content-type gadget (last-ct-byte row detection)
    L.add("czz")       # 1 iff crem == 0 (this row is the event's last byte)
    L.add("czi")       # inverse witness for crem ≠ 0
    L.add("lst")       # live · v13 · czz — the inner-type byte row
    L.add("i23")       # inverse witness for ptby ≠ 23
    L.add("ne23")      # 1 iff ptby ≠ 23 (materialized (ptby−23)·i23)
    L.add("ksl", 8)    # keystream block limbs (block-constant)
    L.add("ctl", 8)    # zero-padded ciphertext block limbs (block-const)
    return L


LAYOUT = _build_layout()


class GcmDataAir(Air):
    width = LAYOUT.width
    num_public = 0
    max_constraint_degree = 3
    #: inv_ct ‖ inv_ks ‖ inv_xhi/xlo ‖ inv_blk ‖ inv_filt ‖ inv_hb ‖ u ‖ acc
    perm_width = 36
    num_perm_challenges = 2
    has_bus = True
    #: cipher wiring (overridden by ChaChaDataAir): which buses supply the
    #: keystream / consume the assembled ct blocks, and the byte order of
    #: the ksl/ctl limb packing (0 = big-endian pairs for GHASH, 1 =
    #: little-endian pairs for the ChaCha/Poly1305 path)
    KS_BUS = BUS_GCM_KS
    BLK_BUS = BUS_GCM_CT
    LE_PAIRS = 0

    def periodic_columns(self) -> list:
        p0 = np.zeros(ROWS_PER_BLOCK, dtype=np.uint32); p0[0] = 1
        p15 = np.zeros(ROWS_PER_BLOCK, dtype=np.uint32); p15[15] = 1
        prow = np.arange(ROWS_PER_BLOCK, dtype=np.uint32)
        even = [np.zeros(ROWS_PER_BLOCK, dtype=np.uint32) for _ in range(8)]
        for j in range(8):
            even[j][2 * j] = 1
        return [p0, p15, prow] + even

    def eval(self, b: AirBuilder) -> None:
        L = LAYOUT
        p0, p15, prow = b.periodic[:3]
        even = b.periodic[3:11]

        def c(name, i=0):
            return b.local[L[name].start + i]

        def n(name, i=0):
            return b.next[L[name].start + i]

        tr = b.is_transition
        blklive, live = c("blklive"), c("live")
        for nm in ("blklive", "live", "v13", "isr", "dirs", "hbf"):
            b.assert_bool(c(nm))
        b.assert_zero(c("hbf") * (1 - live))
        # block-constant columns
        for nm in ("blklive", "eid", "bidx", "ctlen", "v13", "isr", "obj",
                   "dirs"):
            b.assert_zero(tr * (1 - p15) * (n(nm) - c(nm)))
        for k in range(8):
            b.assert_zero(tr * (1 - p15) * (n("ksl", k) - c("ksl", k)))
            b.assert_zero(tr * (1 - p15) * (n("ctl", k) - c("ctl", k)))
        # live structure
        b.assert_zero(live * (1 - blklive))
        b.assert_zero(p0 * (live - blklive))
        b.assert_zero(tr * (1 - p15) * n("live") * (1 - live))
        # dead-row ciphertext nibbles are zero (GHASH zero padding)
        b.assert_zero(blklive * (1 - live) * c("cthi"))
        b.assert_zero(blklive * (1 - live) * c("ctlo"))
        # byte packing into limbs at even rows
        ctby = c("cthi") * 16 + c("ctlo")
        ksby = c("kshi") * 16 + c("kslo")
        ptby = c("pthi") * 16 + c("ptlo")
        ctby_n = n("cthi") * 16 + n("ctlo")
        ksby_n = n("kshi") * 16 + n("kslo")
        for j in range(8):
            if self.LE_PAIRS:
                b.assert_zero(tr * even[j]
                              * (c("ctl", j) - ctby - 256 * ctby_n))
                b.assert_zero(tr * even[j]
                              * (c("ksl", j) - ksby - 256 * ksby_n))
            else:
                b.assert_zero(tr * even[j]
                              * (c("ctl", j) - 256 * ctby - ctby_n))
                b.assert_zero(tr * even[j]
                              * (c("ksl", j) - 256 * ksby - ksby_n))
        # filtered multiplicity only on live rows
        b.assert_zero(c("f") * (1 - live))

        # --- TLS 1.3 inner content type ⟺ isr claim ---
        # crem = ctlen − 1 − pos: zero exactly on the event's last ct byte
        pos_e = (c("bidx") - 1) * 16 + prow
        crem_e = c("ctlen") - 1 - pos_e
        b.assert_zero(crem_e * c("czz"))                   # czz ⟹ crem = 0
        b.assert_zero(c("czz") - 1 + crem_e * c("czi"))    # crem ≠ 0 ⟹ czz = 0
        b.assert_zero(c("lst") - live * c("v13") * c("czz"))
        # the last byte of a v13 record is the inner content type:
        # isr = 1 ⟹ type == 23; isr = 0 ⟹ type ≠ 23 (via materialized
        # nonzero witness ne23 = (ptby−23)·i23, which can only be 1 when
        # ptby ≠ 23)
        b.assert_zero(c("ne23") - (ptby - 23) * c("i23"))
        b.assert_zero(c("lst") * c("isr") * (ptby - 23))
        b.assert_zero(c("lst") * (1 - c("isr")) * (1 - c("ne23")))

        # --- bus ---
        gamma = b.challenges[0]

        def dpow(i):
            return b.challenges[1 + i]

        pos = (c("bidx") - 1) * 16 + prow
        fp_ct = (ExtVal.from_base(BUS_CT_BYTE) + dpow(0) * c("eid")
                 + dpow(1) * (c("ctlen") - 1 - pos) + dpow(2) * ctby
                 + dpow(3) * c("rp") + dpow(4) * c("isr")
                 + dpow(5) * c("v13") + dpow(6) * c("obj")
                 + dpow(7) * c("dirs") + dpow(8) * c("hbf"))
        fp_ks = (ExtVal.from_base(self.KS_BUS) + dpow(0) * c("eid")
                 + dpow(1) * c("bidx"))
        fp_blk = (ExtVal.from_base(self.BLK_BUS) + dpow(0) * c("eid")
                  + dpow(1) * c("bidx"))
        for k in range(8):
            fp_ks = fp_ks + dpow(2 + k) * c("ksl", k)
            fp_blk = fp_blk + dpow(2 + k) * c("ctl", k)
        fp_xhi = (ExtVal.from_base(BUS_XOR) + dpow(0) * c("cthi")
                  + dpow(1) * c("kshi") + dpow(2) * c("pthi"))
        fp_xlo = (ExtVal.from_base(BUS_XOR) + dpow(0) * c("ctlo")
                  + dpow(1) * c("kslo") + dpow(2) * c("ptlo"))
        fp_filt = (ExtVal.from_base(BUS_FILTERED) + dpow(0) * c("obj")
                   + dpow(1) * c("dirs") + dpow(2) * c("rp")
                   + dpow(3) * ptby)
        fp_hb = (ExtVal.from_base(BUS_HASH_BYTE) + dpow(0) * c("obj")
                 + dpow(1) * c("dirs") + dpow(2) * c("rp")
                 + dpow(3) * ptby)
        inv_ct = b.perm_ext(0)
        inv_ks = b.perm_ext(1)
        inv_xhi = b.perm_ext(2)
        inv_xlo = b.perm_ext(3)
        inv_blk = b.perm_ext(4)
        inv_filt = b.perm_ext(5)
        inv_hb = b.perm_ext(6)
        u = b.perm_ext(7)
        acc = b.perm_ext(8)
        u_n = b.perm_ext(7, nxt=True)
        acc_n = b.perm_ext(8, nxt=True)
        b.assert_ext_zero(inv_hb * (gamma - fp_hb) - 1)
        b.assert_ext_zero(inv_ct * (gamma - fp_ct) - 1)
        b.assert_ext_zero(inv_ks * (gamma - fp_ks) - 1)
        b.assert_ext_zero(inv_xhi * (gamma - fp_xhi) - 1)
        b.assert_ext_zero(inv_xlo * (gamma - fp_xlo) - 1)
        b.assert_ext_zero(inv_blk * (gamma - fp_blk) - 1)
        b.assert_ext_zero(inv_filt * (gamma - fp_filt) - 1)
        u_def = (inv_blk * (p15 * blklive) + inv_hb * c("hbf")
                 - inv_ct * live - inv_ks * (p0 * blklive)
                 - inv_xhi * live - inv_xlo * live - inv_filt * c("f"))
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

        r = np.arange(nrows)
        p0 = ((r % 16) == 0).astype(np.uint64)
        p15 = ((r % 16) == 15).astype(np.uint64)
        prow = (r % 16).astype(np.uint64)
        ctby = col("cthi") * 16 + col("ctlo")
        ksby = col("kshi") * 16 + col("kslo")
        ptby = col("pthi") * 16 + col("ptlo")
        pos = (col("bidx") * 16 % P + prow + P - 16) % P
        crem = (col("ctlen") + 2 * P - 1 - pos) % P
        ksl = main[:, L["ksl"]].astype(np.uint64)
        ctl = main[:, L["ctl"]].astype(np.uint64)
        inv_ct = np_bus_inverse_terms(challenges, BUS_CT_BYTE, np.stack(
            [col("eid"), crem, ctby, col("rp"), col("isr"), col("v13"),
             col("obj"), col("dirs"), col("hbf")], axis=1))
        inv_ks = np_bus_inverse_terms(challenges, self.KS_BUS, np.concatenate(
            [col("eid")[:, None], col("bidx")[:, None], ksl], axis=1))
        inv_xhi = np_bus_inverse_terms(challenges, BUS_XOR, np.stack(
            [col("cthi"), col("kshi"), col("pthi")], axis=1))
        inv_xlo = np_bus_inverse_terms(challenges, BUS_XOR, np.stack(
            [col("ctlo"), col("kslo"), col("ptlo")], axis=1))
        inv_blk = np_bus_inverse_terms(challenges, self.BLK_BUS,
                                       np.concatenate(
            [col("eid")[:, None], col("bidx")[:, None], ctl], axis=1))
        inv_filt = np_bus_inverse_terms(challenges, BUS_FILTERED, np.stack(
            [col("obj"), col("dirs"), col("rp"), ptby], axis=1))
        inv_hb = np_bus_inverse_terms(challenges, BUS_HASH_BYTE, np.stack(
            [col("obj"), col("dirs"), col("rp"), ptby], axis=1))
        live = col("live")[:, None]
        blklive = col("blklive")[:, None]
        u = (inv_blk.astype(np.uint64) * (p15[:, None] * blklive)
             + inv_hb.astype(np.uint64) * col("hbf")[:, None]
             + 5 * P * np.ones_like(inv_ct, dtype=np.uint64)
             - inv_ct.astype(np.uint64) * live
             - inv_ks.astype(np.uint64) * (p0[:, None] * blklive)
             - inv_xhi.astype(np.uint64) * live
             - inv_xlo.astype(np.uint64) * live
             - inv_filt.astype(np.uint64) * col("f")[:, None] % P) % P
        acc = np.cumsum(u, axis=0) % P
        return np.concatenate(
            [inv_ct, inv_ks, inv_xhi, inv_xlo, inv_blk, inv_filt, inv_hb,
             u, acc], axis=1).astype(np.uint32)


class ChaChaDataAir(GcmDataAir):
    """The data chip for ChaCha20-Poly1305 records: identical parser /
    xor / filtered / hash-byte / inner-content-type wiring, but the
    keystream arrives from the ChaCha record-control chip
    (BUS_CHACHA_KS) and the assembled zero-padded ciphertext blocks are
    consumed by the control chip's Poly1305 accumulation rows
    (BUS_POLY_CT) instead of GHASH.  Both limb packings are
    little-endian byte pairs — the ChaCha chip's native limb order and
    the Poly1305 little-endian block interpretation — so no byteswap
    gadget exists anywhere on the path."""

    name = "ChaChaDataAir"
    KS_BUS = BUS_CHACHA_KS
    BLK_BUS = BUS_POLY_CT
    LE_PAIRS = 1


# ---------------------------------------------------------------------------
# witness generation
# ---------------------------------------------------------------------------


def gcm_data_trace(records, gcm_events, v13: int = 0, obj: int = 1,
                   filtered: list | None = None,
                   min_log_n: int = 5, le_pairs: int = 0):
    """records: GcmRecordMeta list (record_walk.walk_stream_records) —
    per-record v13/obj fields override the defaults (batch sessions);
    filtered: [(pos, count)] or [(obj, pos, count)] multiplicities for the
    journal's filtered-byte messages.  Returns (trace, [], xor_pairs) where
    xor_pairs feeds the xor-table multiplicity counts."""
    L = LAYOUT
    filt_mult = {}
    for ent in (filtered or []):
        if len(ent) == 2:
            filt_mult[(obj, ent[0])] = ent[1]
        else:
            filt_mult[(ent[0], ent[1])] = ent[2]
    rows = []
    xor_pairs: list[tuple[int, int]] = []
    for meta in records:
        m_v13 = getattr(meta, "v13", v13)
        m_obj = getattr(meta, "obj", obj)
        ev = gcm_events[meta.eid]
        ks = b"".join(ev.keystream)
        ct = meta.ct
        pt = bytes(cb ^ kb for cb, kb in zip(ct, ks))
        n_blocks = (len(ct) + 15) // 16
        for bi in range(n_blocks):
            blk = np.zeros((ROWS_PER_BLOCK, L.width), dtype=np.uint32)
            blk[:, L["blklive"].start] = 1
            blk[:, L["eid"].start] = meta.eid
            blk[:, L["bidx"].start] = bi + 1
            blk[:, L["ctlen"].start] = len(ct)
            blk[:, L["v13"].start] = m_v13
            blk[:, L["isr"].start] = meta.is_app
            blk[:, L["obj"].start] = m_obj % P
            blk[:, L["dirs"].start] = 1 if meta.dir == "s" else 0
            ct_blk = ct[16 * bi : 16 * bi + 16]
            ks_blk = ks[16 * bi : 16 * bi + 16]
            for j in range(8):
                cpair = ct_blk[2 * j : 2 * j + 2].ljust(2, b"\x00")
                kpair = ks_blk[2 * j : 2 * j + 2]
                if le_pairs:
                    blk[:, L["ctl"].start + j] = cpair[0] + 256 * cpair[1]
                    blk[:, L["ksl"].start + j] = kpair[0] + 256 * kpair[1]
                else:
                    blk[:, L["ctl"].start + j] = cpair[0] * 256 + cpair[1]
                    blk[:, L["ksl"].start + j] = kpair[0] * 256 + kpair[1]
            for rr in range(ROWS_PER_BLOCK):
                pos = 16 * bi + rr
                kb = ks_blk[rr]
                blk[rr, L["kshi"].start] = kb >> 4
                blk[rr, L["kslo"].start] = kb & 15
                if pos < len(ct):
                    cb, pb = ct[pos], pt[pos]
                    blk[rr, L["live"].start] = 1
                    blk[rr, L["cthi"].start] = cb >> 4
                    blk[rr, L["ctlo"].start] = cb & 15
                    blk[rr, L["pthi"].start] = pb >> 4
                    blk[rr, L["ptlo"].start] = pb & 15
                    xor_pairs.append((cb >> 4, kb >> 4))
                    xor_pairs.append((cb & 15, kb & 15))
                    if meta.is_app and not (m_v13 and pos == len(ct) - 1):
                        rp = meta.rbase + pos
                        blk[rr, L["rp"].start] = rp
                        blk[rr, L["hbf"].start] = 1
                        if meta.dir == "s":
                            blk[rr, L["f"].start] = filt_mult.get(
                                (m_obj, rp), 0)
                    else:
                        blk[rr, L["rp"].start] = RPOS_SENTINEL
            rows.append(blk)
    if not rows:
        raise ValueError("need at least one GCM record")
    full = np.concatenate(rows, axis=0)
    n_real = full.shape[0]
    log_n = max(min_log_n, (n_real - 1).bit_length())
    n = 1 << log_n
    if n > n_real:
        full = np.concatenate(
            [full, np.zeros((n - n_real, L.width), dtype=np.uint32)],
            axis=0)
    # inner-content-type gadget columns (vectorized over the whole trace,
    # dead rows included — czz/czi satisfy their iszero identities
    # everywhere)
    prow = np.arange(full.shape[0], dtype=np.int64) % 16
    bidx = full[:, L["bidx"].start].astype(np.int64)
    ctlen = full[:, L["ctlen"].start].astype(np.int64)
    crem = (ctlen - 1 - ((bidx - 1) * 16 + prow)) % P
    full[:, L["czz"].start] = (crem == 0).astype(np.uint32)
    full[:, L["czi"].start] = _np_inv_or_zero(crem.astype(np.uint64))
    full[:, L["lst"].start] = (full[:, L["live"].start]
                               * full[:, L["v13"].start]
                               * full[:, L["czz"].start])
    ptby = (full[:, L["pthi"].start].astype(np.int64) * 16
            + full[:, L["ptlo"].start].astype(np.int64))
    d23 = (ptby - 23) % P
    full[:, L["i23"].start] = _np_inv_or_zero(d23.astype(np.uint64))
    full[:, L["ne23"].start] = (d23 != 0).astype(np.uint32)
    return full, [], xor_pairs


def _np_inv_or_zero(a: np.ndarray) -> np.ndarray:
    """Vectorized Baby-Bear Fermat inverse; 0 ↦ 0.  uint64 in, uint32 out."""
    inv = np.ones_like(a)
    base = a % P
    e = P - 2
    while e:
        if e & 1:
            inv = (inv * base) % P
        base = (base * base) % P
        e >>= 1
    return np.where(a % P == 0, 0, inv).astype(np.uint32)
