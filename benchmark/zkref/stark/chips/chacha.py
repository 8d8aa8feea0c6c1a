"""ChaCha20 block-function AIR chip (RFC 8439) — proves the keystream
blocks of ChaCha20-Poly1305 sessions (0xCCA8/0xCCA9/0x1303, offered by
the reference client, request.rs:25-27; the guest's rustls-rustcrypto
chacha20poly1305 is the behavioral contract, SURVEY.md §2.2.A).

Layout: 32-row groups, one group per 64-byte block.  Row r (0..19) holds
the state entering round r as 512 bit columns; each round applies four
quarter-rounds in parallel — column wiring on even rows, diagonal wiring
on odd rows, selected by periodic parity flags.  The ARX quarter-round
decomposes into materialized intermediates a1/d1/c1/b1 per QR: additions
are proven limb-wise over 16-bit halves (sums stay ≪ p, so the packed
relation is sound over Baby-Bear — full 32-bit packing would admit ±p
forgeries), xors bitwise at degree 2, rotations by re-indexing.  Row 20
holds the final working state; the committed output limbs are pinned
there by the feed-forward addition out = state0 + state20, with the
initial state reconstructed from the group-constant key/counter/nonce
metadata and the σ constants.  Rows 21..31 idle.

Bus: each real group's last row publishes the keystream block in two
halves (BUS_CHACHA_BLOCK: eid, ctr, half, key, 32 bytes, nonce) with
per-half witnessed multiplicity columns.  The ChaCha record-control chip
(stark/chips/chacha_control.py — the Poly1305/parser glue mirroring
GcmControlAir) consumes the Poly1305 one-time-key half (ctr = 0, half 0)
and every data-keystream half; the nonce limbs in the payload bind each
consumed block to the journal-pinned record nonce.  The Poly1305
tag-polynomial multiplications ride the ModMul chip (guest/crypto/
chacha.py records them over 2^130 − 5) and the control chip composes
them into the tag check.

Port copy of zktls_tpu.stark.chips.chacha (same names and values; host code
in numpy).
"""

from __future__ import annotations

import numpy as np

from ..air import Air, AirBuilder
from ..bus import BUS_CHACHA_BLOCK, np_bus_inverse_terms
from ..ext_val import ExtVal

__all__ = ["ChaCha20Air", "chacha_trace", "GROUP_ROWS"]

GROUP_ROWS = 32
N_ROUNDS = 20
SIGMA = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)

#: quarter-round word wiring: [parity][q] = (a, b, c, d) state word indices
WIRING = [
    [(q, q + 4, q + 8, q + 12) for q in range(4)],                  # even
    [(q, 4 + (q + 1) % 4, 8 + (q + 2) % 4, 12 + (q + 3) % 4)        # odd
     for q in range(4)],
]


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
    L.add("st", 512)      # 16 words × 32 bits (LSB-first)
    L.add("a1", 128)      # per-QR intermediates (4 × 32)
    L.add("d1", 128)
    L.add("c1", 128)
    L.add("b1", 128)
    L.add("car", 32)      # 4 QRs × 4 adds × 2 limb carries
    # --- group-constant metadata ---
    L.add("eid", 1)
    L.add("keyl", 16)     # key as 16 u16 limbs (LE-u32 words, lo/hi)
    L.add("nonl", 6)      # nonce limbs
    L.add("ctrl", 2)      # counter lo/hi limbs
    L.add("ms", 2)        # per-half send multiplicities (lo, hi)
    L.add("out", 32)      # output block limbs (lo/hi per word)
    L.add("oc", 32)       # feed-forward add carries (row 20)
    return L


LAYOUT = _build_layout()


class ChaCha20Air(Air):
    width = LAYOUT.width
    num_public = 0
    max_constraint_degree = 3
    #: send-lo inv ‖ send-hi inv ‖ u ‖ acc
    perm_width = 16
    num_perm_challenges = 2
    has_bus = True

    def periodic_columns(self) -> list:
        z = np.zeros(GROUP_ROWS, dtype=np.uint32)
        is_r0 = z.copy(); is_r0[0] = 1
        p_even = z.copy(); p_even[0:N_ROUNDS:2] = 1
        p_odd = z.copy(); p_odd[1:N_ROUNDS:2] = 1
        p_r20 = z.copy(); p_r20[N_ROUNDS] = 1
        is_glast = z.copy(); is_glast[GROUP_ROWS - 1] = 1
        return [is_r0, p_even, p_odd, p_r20, is_glast]

    # ------------------------------------------------------------------

    def eval(self, b: AirBuilder) -> None:
        L = LAYOUT
        is_r0, p_even, p_odd, p_r20, is_glast = b.periodic
        POW16 = [1 << i for i in range(16)]

        def col(name, i=0):
            return b.local[L[name].start + i]

        def stbit(w, k, nxt=False):
            src = b.next if nxt else b.local
            return src[L["st"].start + 32 * w + k]

        def qbit(name, q, k):
            return b.local[L[name].start + 32 * q + k]

        def pack_st(w, hi, nxt=False):
            src = b.next_group if nxt else b.local_group
            base = L["st"].start + 32 * w + (16 if hi else 0)
            return b.dot_const(src(slice(base, base + 16)), POW16)

        def pack_q(name, q, hi):
            base = L[name].start + 32 * q + (16 if hi else 0)
            return b.dot_const(b.local_group(slice(base, base + 16)),
                               POW16)

        def xor2(x, y):
            return x + y - 2 * (x * y)

        # --- booleanity ---
        for nm, k in (("st", 512), ("a1", 128), ("d1", 128), ("c1", 128),
                      ("b1", 128), ("car", 32), ("oc", 32)):
            grp = b.local_group(L[nm])
            b.assert_zero_vec(grp * (grp - 1), k)
        b.assert_bool(col("ms", 0))
        b.assert_bool(col("ms", 1))

        # --- group-constant metadata ---
        not_glast = 1 - is_glast
        for nm, k in (("eid", 1), ("keyl", 16), ("nonl", 6), ("ctrl", 2),
                      ("ms", 2), ("out", 32)):
            grp = b.local_group(L[nm])
            ngrp = b.next_group(L[nm])
            b.assert_zero_vec(not_glast * (ngrp - grp), k)

        # --- row-0 state = σ ‖ key ‖ counter ‖ nonce ---
        def init_limb(w, hi):
            if w < 4:
                return (SIGMA[w] >> 16) & 0xFFFF if hi else SIGMA[w] & 0xFFFF
            if w < 12:
                return col("keyl", 2 * (w - 4) + (1 if hi else 0))
            if w == 12:
                return col("ctrl", 1 if hi else 0)
            return col("nonl", 2 * (w - 13) + (1 if hi else 0))

        for w in range(16):
            for hi in (0, 1):
                b.assert_zero(is_r0 * (pack_st(w, hi) - init_limb(w, hi)))

        # --- quarter rounds, by parity ---
        def add16(gate, x_lo, x_hi, y_lo, y_hi, z_lo, z_hi, clo, chi):
            b.assert_zero(gate * (x_lo + y_lo - z_lo - clo * (1 << 16)))
            b.assert_zero(gate * (x_hi + y_hi + clo - z_hi
                                  - chi * (1 << 16)))

        for parity, gate in ((0, p_even), (1, p_odd)):
            for q, (A, B_, C, D) in enumerate(WIRING[parity]):
                car = [col("car", 8 * q + i) for i in range(8)]
                # a1 = a + b
                add16(gate, pack_st(A, 0), pack_st(A, 1),
                      pack_st(B_, 0), pack_st(B_, 1),
                      pack_q("a1", q, 0), pack_q("a1", q, 1),
                      car[0], car[1])
                # d1 = rotl(d ^ a1, 16)
                for k in range(32):
                    b.assert_zero(gate * (
                        qbit("d1", q, (k + 16) % 32)
                        - xor2(stbit(D, k), qbit("a1", q, k))))
                # c1 = c + d1
                add16(gate, pack_st(C, 0), pack_st(C, 1),
                      pack_q("d1", q, 0), pack_q("d1", q, 1),
                      pack_q("c1", q, 0), pack_q("c1", q, 1),
                      car[2], car[3])
                # b1 = rotl(b ^ c1, 12)
                for k in range(32):
                    b.assert_zero(gate * (
                        qbit("b1", q, (k + 12) % 32)
                        - xor2(stbit(B_, k), qbit("c1", q, k))))
                # a2 = a1 + b1  (a2 = next-row word A)
                add16(gate, pack_q("a1", q, 0), pack_q("a1", q, 1),
                      pack_q("b1", q, 0), pack_q("b1", q, 1),
                      pack_st(A, 0, nxt=True), pack_st(A, 1, nxt=True),
                      car[4], car[5])
                # d2 = rotl(d1 ^ a2, 8)  (d2 = next-row word D)
                for k in range(32):
                    b.assert_zero(gate * (
                        stbit(D, (k + 8) % 32, nxt=True)
                        - xor2(qbit("d1", q, k), stbit(A, k, nxt=True))))
                # c2 = c1 + d2  (next-row word C)
                add16(gate, pack_q("c1", q, 0), pack_q("c1", q, 1),
                      pack_st(D, 0, nxt=True), pack_st(D, 1, nxt=True),
                      pack_st(C, 0, nxt=True), pack_st(C, 1, nxt=True),
                      car[6], car[7])
                # b2 = rotl(b1 ^ c2, 7)  (next-row word B)
                for k in range(32):
                    b.assert_zero(gate * (
                        stbit(B_, (k + 7) % 32, nxt=True)
                        - xor2(qbit("b1", q, k), stbit(C, k, nxt=True))))

        # --- feed-forward output at row 20: out = state0 + state20 ---
        for w in range(16):
            clo = col("oc", 2 * w)
            chi = col("oc", 2 * w + 1)
            init_lo, init_hi = init_limb(w, 0), init_limb(w, 1)
            b.assert_zero(p_r20 * (pack_st(w, 0) + init_lo
                                   - col("out", 2 * w)
                                   - clo * (1 << 16)))
            # the final 2^32 carry is discarded (mod 2^32 addition)
            b.assert_zero(p_r20 * (pack_st(w, 1) + init_hi + clo
                                   - col("out", 2 * w + 1)
                                   - chi * (1 << 16)))

        # --- bus: two keystream-half sends on the group's last row ---
        gamma = b.challenges[0]

        def dpow(i):
            return b.challenges[1 + i]

        fp = [None, None]
        for half in (0, 1):
            f = (ExtVal.from_base(BUS_CHACHA_BLOCK) + dpow(0) * col("eid")
                 + dpow(1) * col("ctrl", 0) + dpow(2) * col("ctrl", 1)
                 + dpow(3) * half)
            for i in range(16):
                f = f + dpow(4 + i) * col("keyl", i)
                f = f + dpow(20 + i) * col("out", 16 * half + i)
            for i in range(6):
                f = f + dpow(36 + i) * col("nonl", i)
            fp[half] = f
        inv_lo = b.perm_ext(0)
        inv_hi = b.perm_ext(1)
        u = b.perm_ext(2)
        acc = b.perm_ext(3)
        u_n = b.perm_ext(2, nxt=True)
        acc_n = b.perm_ext(3, nxt=True)
        b.assert_ext_zero(inv_lo * (gamma - fp[0]) - 1)
        b.assert_ext_zero(inv_hi * (gamma - fp[1]) - 1)
        b.assert_ext_zero(
            u - (inv_lo * col("ms", 0) + inv_hi * col("ms", 1)) * is_glast)
        b.assert_ext_zero((acc - u) * b.is_first_row)
        b.assert_ext_zero((acc_n - acc - u_n) * b.is_transition)
        for ell in range(4):
            b.when_last_row(acc.c[ell] - b.public[ell])

    # ------------------------------------------------------------------

    def generate_perm_trace(self, main, publics, challenges):
        L = LAYOUT
        n = main.shape[0]
        eid = main[:, L["eid"].start].astype(np.uint64)
        keyl = main[:, L["keyl"]].astype(np.uint64)
        nonl = main[:, L["nonl"]].astype(np.uint64)
        ctrl = main[:, L["ctrl"]].astype(np.uint64)
        out = main[:, L["out"]].astype(np.uint64)
        ms0 = main[:, L["ms"].start].astype(np.uint64)
        ms1 = main[:, L["ms"].start + 1].astype(np.uint64)
        P = 2013265921
        invs = []
        for half in (0, 1):
            pl = np.concatenate(
                [eid[:, None], ctrl[:, :1], ctrl[:, 1:],
                 np.full((n, 1), half, dtype=np.uint64), keyl,
                 out[:, 16 * half : 16 * half + 16], nonl], axis=1)
            invs.append(np_bus_inverse_terms(challenges, BUS_CHACHA_BLOCK,
                                             pl))
        rowm = np.arange(n) % GROUP_ROWS
        glast = (rowm == GROUP_ROWS - 1).astype(np.uint64)
        u = ((invs[0].astype(np.uint64) * ms0[:, None]
              + invs[1].astype(np.uint64) * ms1[:, None])
             * glast[:, None]) % P
        acc = np.cumsum(u, axis=0) % P
        return np.concatenate(invs + [u, acc], axis=1).astype(np.uint32)


# ---------------------------------------------------------------------------
# witness generation
# ---------------------------------------------------------------------------


def _quarter_trace(s, a, b, c, d):
    """Apply one quarter round, returning (a1, d1, c1, b1) intermediates."""
    M = 0xFFFFFFFF

    def rotl(x, k):
        return ((x << k) | (x >> (32 - k))) & M

    a1 = (s[a] + s[b]) & M
    d1 = rotl(s[d] ^ a1, 16)
    c1 = (s[c] + d1) & M
    b1 = rotl(s[b] ^ c1, 12)
    a2 = (a1 + b1) & M
    d2 = rotl(d1 ^ a2, 8)
    c2 = (c1 + d2) & M
    b2 = rotl(b1 ^ c2, 7)
    s[a], s[b], s[c], s[d] = a2, b2, c2, d2
    return a1, d1, c1, b1


def chacha_trace(blocks: list[tuple[int, bytes, bytes, int]],
                 min_log_n: int = 6,
                 consumed: dict | None = None):
    """blocks: (eid, 32-byte key, 12-byte nonce, counter) per keystream
    block (the ChaChaEvent otk block is counter 0, data blocks 1..).
    Padded at the FRONT with silent zero-key groups.

    consumed: {(eid, ctr, half): mult} — BUS_CHACHA_BLOCK per-half send
    multiplicities (the record-control chip's receives); default 0."""
    import struct

    if not blocks:
        raise ValueError("need at least one block")
    consumed = consumed or {}
    n_real = len(blocks)
    n_rows = n_real * GROUP_ROWS
    log_n = max(min_log_n, (n_rows - 1).bit_length())
    n = 1 << log_n
    pad = n // GROUP_ROWS - n_real
    all_blocks = [(0, b"\x00" * 32, b"\x00" * 12, 0)] * pad + list(blocks)

    L = LAYOUT
    trace = np.zeros((n, L.width), dtype=np.uint32)

    def set_word_bits(row, w, val):
        base = L["st"].start + 32 * w
        for k in range(32):
            trace[row, base + k] = (val >> k) & 1

    for gidx, (eid, key, nonce, ctr) in enumerate(all_blocks):
        base = gidx * GROUP_ROWS
        rows = slice(base, base + GROUP_ROWS)
        is_pad = gidx < pad
        trace[rows, L["eid"].start] = eid
        if not is_pad:
            trace[rows, L["ms"].start] = consumed.get((eid, ctr, 0), 0)
            trace[rows, L["ms"].start + 1] = consumed.get((eid, ctr, 1), 0)
        kw = struct.unpack("<8I", key)
        nw = struct.unpack("<3I", nonce)
        for j in range(8):
            trace[rows, L["keyl"].start + 2 * j] = kw[j] & 0xFFFF
            trace[rows, L["keyl"].start + 2 * j + 1] = kw[j] >> 16
        for j in range(3):
            trace[rows, L["nonl"].start + 2 * j] = nw[j] & 0xFFFF
            trace[rows, L["nonl"].start + 2 * j + 1] = nw[j] >> 16
        trace[rows, L["ctrl"].start] = ctr & 0xFFFF
        trace[rows, L["ctrl"].start + 1] = (ctr >> 16) & 0xFFFF

        init = list(SIGMA) + list(kw) + [ctr & 0xFFFFFFFF] + list(nw)
        s = list(init)
        for r in range(N_ROUNDS):
            row = base + r
            for w in range(16):
                set_word_bits(row, w, s[w])
            parity = r % 2
            for q, (A, B_, C, D) in enumerate(WIRING[parity]):
                sa, sb, sc, sd = s[A], s[B_], s[C], s[D]
                a1, d1, c1, b1 = _quarter_trace(s, A, B_, C, D)
                a2, b2, c2, d2 = s[A], s[B_], s[C], s[D]
                for nm, val in (("a1", a1), ("d1", d1), ("c1", c1),
                                ("b1", b1)):
                    qb = L[nm].start + 32 * q
                    for k in range(32):
                        trace[row, qb + k] = (val >> k) & 1

                def carries(x, y, z):
                    clo = ((x & 0xFFFF) + (y & 0xFFFF) - (z & 0xFFFF)) >> 16
                    chi = (((x >> 16) + (y >> 16) + clo - (z >> 16))
                           >> 16) & 1
                    return clo, chi

                car = L["car"].start + 8 * q
                for i, (x, y, z) in enumerate(
                        ((sa, sb, a1), (sc, d1, c1), (a1, b1, a2),
                         (c1, d2, c2))):
                    clo, chi = carries(x, y, z)
                    trace[row, car + 2 * i] = clo
                    trace[row, car + 2 * i + 1] = chi
        # row 20: final working state + output
        row20 = base + N_ROUNDS
        for w in range(16):
            set_word_bits(row20, w, s[w])
        for w in range(16):
            o = (s[w] + init[w]) & 0xFFFFFFFF
            trace[rows, L["out"].start + 2 * w] = o & 0xFFFF
            trace[rows, L["out"].start + 2 * w + 1] = o >> 16
            clo = ((s[w] & 0xFFFF) + (init[w] & 0xFFFF) - (o & 0xFFFF)) >> 16
            chi = (((s[w] >> 16) + (init[w] >> 16) + clo - (o >> 16))
                   >> 16) & 1
            trace[row20, L["oc"].start + 2 * w] = clo
            trace[row20, L["oc"].start + 2 * w + 1] = chi
    return trace, []


def chacha_event_blocks(events) -> list[tuple[int, bytes, bytes, int]]:
    """(eid, key, nonce, ctr) for every block of the recorded ChaCha
    events: the Poly1305 one-time-key block (ctr 0) + data blocks."""
    out = []
    for eid, ev in enumerate(events):
        out.append((eid, ev.key, ev.nonce, 0))
        for i in range(len(ev.keystream)):
            out.append((eid, ev.key, ev.nonce, 1 + i))
    return out
