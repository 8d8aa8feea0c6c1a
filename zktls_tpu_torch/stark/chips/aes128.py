"""AES-128 keystream AIR chip — proves the counter-mode block encryptions
of the guest's AES-GCM record decryptions (the second-largest workload of
the TLS replay after SHA-256; witness events recorded as GCMEvent
counter/keystream blocks, SURVEY.md §3.4).

One row per AES round; 16 rows per block group (10 active rounds + 6 idle
rows gated off by periodic flags).  Bytes are bit-decomposed.  The S-box —
non-algebraic over a prime field — is proven with the LogUp lookup
argument against the periodic table (i, SBOX[i]): every row looks up its
16 state-byte substitutions plus the 4 key-schedule SubWord bytes as
γ-δ-compressed tuples x + δ·y (this is exactly how the reference's chips
consume their byte tables, SURVEY.md §2.2.B).  ShiftRows, MixColumns and
AddRoundKey are GF(2)-linear, expressed over bits with materialized xor3
stages to keep every constraint at degree ≤ 3.

Row r of a block group holds the state entering round r+1 (st = state
after AddRoundKey[r]; row 0 = plaintext ⊕ cipher key) and the round key
rk[r] added AT round r; the next row's rk is produced by the key-schedule
transition constraints.  Rows 10..15 are idle: they carry the block's
output forward so the global last row binds the final keystream block as
public values.

Scope note (round-1, same as the SHA-256 chip): each group is proven to be
a correct AES-128 encryption of *some* witnessed (key, block); binding
keys/counters to the TLS session crosses chips via LogUp buses (planned).

Port copy of zktls_tpu.stark.chips.aes128 (same names and values; host code
in numpy).
"""

from __future__ import annotations

import numpy as np

from ...guest.crypto.aes import SBOX
from ..air import Air, AirBuilder
from ..bus import BUS_AES_ENC, np_bus_inverse_terms
from ..ext_val import ExtVal
from ..lookup import fp4_batch_inverse

__all__ = ["Aes128Air", "aes128_trace", "ROWS_PER_BLOCK"]

ROWS_PER_BLOCK = 16
N_ROUNDS = 10
N_LOOKUPS = 20  # 16 state S-boxes + 4 key-schedule S-boxes per row

_RCON = [0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36]
ROT = [13, 14, 15, 12]  # RotWord byte sources within rk


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
    L.add("st", 128)      # state bits entering this row's round
    L.add("rk", 128)      # round key added at this row's round (rk[r])
    L.add("sb", 128)      # SubBytes(st) output bits (bound via lookups)
    L.add("m1", 128)      # MixColumns xor stages
    L.add("m2", 128)
    L.add("m3", 128)
    L.add("ks_sb", 32)    # SubWord(RotWord(w3)) output bits
    L.add("ks1", 32)      # w0 ^ SubWord(RotWord(w3))  (pre-rcon)
    L.add("mult", 1)      # lookup multiplicities (rows 0..255)
    # --- bus metadata (constant within each 16-row group) ---
    L.add("eid", 1)       # GCM event id this block belongs to
    L.add("key", 8)       # cipher key, 16-bit BE limbs (bound at row 0)
    L.add("inb", 8)       # input block limbs (bound at row 0: st0 ^ rk0)
    L.add("ms", 1)        # send multiplicity (1 real block, 0 padding)
    return L


LAYOUT = _build_layout()

# ShiftRows: output byte i (column-major 4*col+row) reads input byte
# SHIFT_SRC[i] (FIPS 197 row r shifts left by r).
SHIFT_SRC = [4 * ((i // 4 + i % 4) % 4) + i % 4 for i in range(16)]

_XT_FEEDBACK = (0, 1, 3, 4)  # bits receiving x^7·0x1b feedback in xtime
POW8 = [1 << i for i in range(8)]


def _xor3(x, y, z):
    return x + y + z - 2 * (x * y + y * z + x * z) + 4 * (x * y * z)


def _xor2(x, y):
    return x + y - 2 * (x * y)


def _mix_terms(sb_bit, j: int, k: int) -> list:
    """The xor terms of MixColumns output byte j, bit k, over shifted
    SubBytes output bits (sb_bit(byte_index, bit) accessor)."""
    col, row = divmod(j, 4)
    a_i = SHIFT_SRC[4 * col + row]
    b_i = SHIFT_SRC[4 * col + (row + 1) % 4]
    c_i = SHIFT_SRC[4 * col + (row + 2) % 4]
    d_i = SHIFT_SRC[4 * col + (row + 3) % 4]
    terms = []
    if k >= 1:
        terms.append(sb_bit(a_i, k - 1))
    if k in _XT_FEEDBACK:
        terms.append(sb_bit(a_i, 7))
    if k >= 1:
        terms.append(sb_bit(b_i, k - 1))
    if k in _XT_FEEDBACK:
        terms.append(sb_bit(b_i, 7))
    terms.append(sb_bit(b_i, k))
    terms.append(sb_bit(c_i, k))
    terms.append(sb_bit(d_i, k))
    return terms


def _stage_values(terms):
    """(m1, m2, m3) xor-stage values/expressions for a term list —
    identical branching for witness (ints) and constraints (algebra)."""
    m1 = _xor3(terms[0], terms[1], terms[2])
    rest = terms[3:]
    if len(rest) >= 2:
        m2 = _xor3(m1, rest[0], rest[1])
        rest = rest[2:]
    elif rest:
        m2 = _xor2(m1, rest[0])
        rest = []
    else:
        m2 = m1
    if len(rest) == 2:
        m3 = _xor3(m2, rest[0], rest[1])
    elif len(rest) == 1:
        m3 = _xor2(m2, rest[0])
    else:
        m3 = m2
    return m1, m2, m3


class Aes128Air(Air):
    width = LAYOUT.width
    num_public = 0
    max_constraint_degree = 3
    #: 20 looked-up tuples (inv_v) + table inverse + bus send inverse + u
    #: (materialized row term) + acc (lookup terms AND bus sends)
    perm_width = 4 * (N_LOOKUPS + 4)
    num_perm_challenges = 2  # γ (lookup), δ (tuple compression)
    has_bus = True

    def periodic_columns(self) -> list:
        is_r0 = np.zeros(ROWS_PER_BLOCK, dtype=np.uint32)
        is_r0[0] = 1
        is_active = np.zeros(ROWS_PER_BLOCK, dtype=np.uint32)
        is_active[:N_ROUNDS] = 1
        is_last_active = np.zeros(ROWS_PER_BLOCK, dtype=np.uint32)
        is_last_active[N_ROUNDS - 1] = 1
        rcon_bits = [
            np.array([(_RCON[r] >> k) & 1 if r < N_ROUNDS else 0
                      for r in range(ROWS_PER_BLOCK)], dtype=np.uint32)
            for k in range(8)
        ]
        # rows 10..14 carry the output state to the next row (NOT row 15,
        # whose successor is the next block group)
        is_idle_carry = np.zeros(ROWS_PER_BLOCK, dtype=np.uint32)
        is_idle_carry[N_ROUNDS : ROWS_PER_BLOCK - 1] = 1
        tbl_in = np.arange(256, dtype=np.uint32)
        tbl_out = np.array(SBOX, dtype=np.uint32)
        is_glast = np.zeros(ROWS_PER_BLOCK, dtype=np.uint32)
        is_glast[ROWS_PER_BLOCK - 1] = 1
        return [is_r0, is_active, is_last_active] + rcon_bits \
            + [tbl_in, tbl_out, is_idle_carry, is_glast]

    # ------------------------------------------------------------------

    def _lookup_pairs(self, loc_fn, dot_fn):
        """The 20 (input, output) byte-value pairs each row looks up, as
        (x_expr, y_expr) using the given accessor/packing functions."""
        L = LAYOUT
        pairs = []
        for i in range(16):
            x = dot_fn("st", 8 * i)
            y = dot_fn("sb", 8 * i)
            pairs.append((x, y))
        for t in range(4):
            x = dot_fn("rk", 8 * ROT[t])
            y = dot_fn("ks_sb", 8 * t)
            pairs.append((x, y))
        return pairs

    def eval(self, b: AirBuilder) -> None:
        L = LAYOUT
        is_r0, is_active, is_last_active = b.periodic[0:3]
        rcon_bits = b.periodic[3:11]
        tbl_in, tbl_out = b.periodic[11], b.periodic[12]
        is_idle_carry = b.periodic[13]
        is_glast = b.periodic[14]
        not_last_active = is_active * (1 - is_last_active)  # rounds 0..8
        gamma, delta = b.challenges[0], b.challenges[1]

        def loc(name, i):
            return b.local[L[name].start + i]

        def nxt(name, i):
            return b.next[L[name].start + i]

        def dot(name, start):
            sl = slice(L[name].start + start, L[name].start + start + 8)
            return b.dot_const(b.local_group(sl), POW8)

        ST = b.local_group(L["st"])
        RK = b.local_group(L["rk"])
        SB = b.local_group(L["sb"])
        KSB = b.local_group(L["ks_sb"])

        # --- booleanity of the witness bit groups ---
        for grp, k in ((ST, 128), (RK, 128), (SB, 128), (KSB, 32)):
            b.assert_zero_vec(grp * (grp - 1), k)

        # --- S-box lookups: every (x, y) pair is in the (i, SBOX[i]) table
        # as the compressed value x + δ·y against challenge γ ---
        pairs = self._lookup_pairs(loc, dot)
        for j, (x, y) in enumerate(pairs):
            iv = b.perm_ext(j)
            val = ExtVal.from_base(x) + delta * y
            b.assert_ext_zero(iv * (gamma - val) - 1)
        inv_t = b.perm_ext(N_LOOKUPS)
        tval = ExtVal.from_base(tbl_in) + delta * tbl_out
        b.assert_ext_zero(inv_t * (gamma - tval) - 1)

        # --- bus metadata: group-constant eid/key/inb/ms; key and input
        # bound to the round-0 state/round-key bits ---
        def dpow(i):
            return b.challenges[1 + i]

        LIMB_W = [256 << k for k in range(8)] + [1 << k for k in range(8)]

        def limb16(name, j):
            """16-bit BE limb j of the 16-byte bit-decomposed value:
            limb = byte(2j)·256 + byte(2j+1) (bytes are LSB-first bits)."""
            sl0 = L[name].start + 16 * j
            return b.dot_const(b.local_group(slice(sl0, sl0 + 16)), LIMB_W)

        eid = loc("eid", 0)
        ms = loc("ms", 0)
        b.assert_bool(ms)
        not_glast = 1 - is_glast
        for nm in ("eid", "ms"):
            b.assert_zero(not_glast * (b.next[L[nm].start] - loc(nm, 0)))
        b.assert_zero_vec(
            not_glast * (b.next_group(L["key"]) - b.local_group(L["key"])), 8)
        b.assert_zero_vec(
            not_glast * (b.next_group(L["inb"]) - b.local_group(L["inb"])), 8)
        for j in range(8):
            b.assert_zero(is_r0 * (loc("key", j) - limb16("rk", j)))
            # input block = st(row 0) ^ rk(row 0), packed to the limb
            xor_pack = None
            for k in range(16):
                x_ = b.local[L["st"].start + 16 * j + k]
                y_ = b.local[L["rk"].start + 16 * j + k]
                t_ = (x_ + y_ - 2 * (x_ * y_)) * LIMB_W[k]
                xor_pack = t_ if xor_pack is None else xor_pack + t_
            b.assert_zero(is_r0 * (loc("inb", j) - xor_pack))

        # --- bus send: (AES_ENC, eid, kv=0, key_lo, key_hi=0, input,
        # output) on each real group's last row, consumed by the GCM
        # control chip (the kv/key_hi payload positions are shared with
        # the AES-256 chip and contribute 0 here) ---
        fp_send = ExtVal.from_base(BUS_AES_ENC) + dpow(0) * eid
        for j in range(8):
            fp_send = fp_send + dpow(2 + j) * loc("key", j)
            fp_send = fp_send + dpow(18 + j) * loc("inb", j)
            fp_send = fp_send + dpow(26 + j) * limb16("st", j)
        inv_send = b.perm_ext(N_LOOKUPS + 1)
        b.assert_ext_zero(inv_send * (gamma - fp_send) - 1)

        # --- accumulator: in-chip S-box lookup terms + gated bus send ---
        u = b.perm_ext(N_LOOKUPS + 2)
        u_n = b.perm_ext(N_LOOKUPS + 2, nxt=True)
        acc = b.perm_ext(N_LOOKUPS + 3)
        acc_n = b.perm_ext(N_LOOKUPS + 3, nxt=True)
        mult = loc("mult", 0)
        lk = None
        for j in range(N_LOOKUPS):
            term = b.perm_ext(j)
            lk = term if lk is None else lk + term
        u_def = lk - mult * b.perm_ext(N_LOOKUPS) + inv_send * (ms * is_glast)
        b.assert_ext_zero(u - u_def)
        b.assert_ext_zero((acc - u) * b.is_first_row)
        b.assert_ext_zero((acc_n - acc - u_n) * b.is_transition)
        for ell in range(4):
            b.when_last_row(acc.c[ell] - b.public[ell])

        # --- MixColumns xor stages (definitions, every row) + round
        # transition st' = MixColumns(ShiftRows(sb)) ^ rk' (rounds 0..8) ---
        def sb_bit(byte_idx, k):
            return loc("sb", 8 * byte_idx + k)

        for j in range(16):
            for k in range(8):
                terms = _mix_terms(sb_bit, j, k)
                m1, m2, m3 = (loc(nm, 8 * j + k) for nm in ("m1", "m2", "m3"))
                e1, e2, e3 = _stage_values(terms)
                # e2/e3 are expressed in terms of the *materialized* prior
                # stage columns, not the raw expressions:
                e1v = e1
                rest = terms[3:]
                if len(rest) >= 2:
                    e2v = _xor3(m1, rest[0], rest[1])
                    rest2 = rest[2:]
                elif rest:
                    e2v = _xor2(m1, rest[0])
                    rest2 = []
                else:
                    e2v = m1
                    rest2 = []
                if len(rest2) == 2:
                    e3v = _xor3(m2, rest2[0], rest2[1])
                elif len(rest2) == 1:
                    e3v = _xor2(m2, rest2[0])
                else:
                    e3v = m2
                b.assert_zero(m1 - e1v)
                b.assert_zero(m2 - e2v)
                b.assert_zero(m3 - e3v)
                b.assert_zero(not_last_active
                              * (nxt("st", 8 * j + k)
                                 - _xor2(m3, nxt("rk", 8 * j + k))))

        # --- final round (row 9): no MixColumns ---
        for j in range(16):
            src = SHIFT_SRC[j]
            for k in range(8):
                b.assert_zero(is_last_active
                              * (nxt("st", 8 * j + k)
                                 - _xor2(loc("sb", 8 * src + k),
                                         nxt("rk", 8 * j + k))))

        # --- key schedule: rk' = expand(rk), active rows 0..9 ---
        for t in range(4):
            for k in range(8):
                b.assert_zero(is_active * (loc("ks1", 8 * t + k)
                                           - _xor2(loc("rk", 8 * t + k),
                                                   loc("ks_sb", 8 * t + k))))
        for t in range(4):      # word 0: w0' = ks1 ^ rcon (byte 0 only)
            for k in range(8):
                ks1 = loc("ks1", 8 * t + k)
                nw0 = nxt("rk", 8 * t + k)
                if t == 0:
                    rc = rcon_bits[k]
                    b.assert_zero(is_active
                                  * (nw0 - (ks1 + rc - 2 * (ks1 * rc))))
                else:
                    b.assert_zero(is_active * (nw0 - ks1))
        for w in range(1, 4):   # words 1..3: wi' = wi ^ w{i-1}'
            for byte in range(4):
                i = 4 * w + byte
                pi = 4 * (w - 1) + byte
                for k in range(8):
                    b.assert_zero(is_active
                                  * (nxt("rk", 8 * i + k)
                                     - _xor2(loc("rk", 8 * i + k),
                                             nxt("rk", 8 * pi + k))))

        # --- idle rows 10..14 carry the output state to the global last
        # row (the group-final row 15 has no constrained successor) ---
        for k in range(128):
            b.assert_zero(is_idle_carry * (nxt("st", k) - loc("st", k)))


    # ------------------------------------------------------------------

    def generate_perm_trace(self, main, public_values, challenges):
        from ..lookup import np_ext_mul, np_logup_terms

        gamma, delta = challenges[0], challenges[1]
        n = main.shape[0]
        L = LAYOUT
        P_ = 2013265921

        def bytes_col(name, start):
            sl = L[name].start + start
            bits = main[:, sl : sl + 8].astype(np.uint64)
            return (bits * np.array(POW8, dtype=np.uint64)[None, :]).sum(axis=1)

        xs, ys = [], []
        for i in range(16):
            xs.append(bytes_col("st", 8 * i))
            ys.append(bytes_col("sb", 8 * i))
        for t in range(4):
            xs.append(bytes_col("rk", 8 * ROT[t]))
            ys.append(bytes_col("ks_sb", 8 * t))
        xs_flat = np.stack(xs, axis=1).reshape(-1)       # (n·20,)
        ys_flat = np.stack(ys, axis=1).reshape(-1)
        inv_v = np_logup_terms(gamma, xs_flat, None, ys_flat, delta)
        inv_v = inv_v.reshape(n, N_LOOKUPS, 4)
        t_in = (np.arange(n, dtype=np.uint64) % 256)
        t_out = np.array(SBOX, dtype=np.uint64)[t_in.astype(np.int64)]
        inv_t = np_logup_terms(gamma, t_in, None, t_out, delta)  # (n, 4)

        mult = main[:, L["mult"].start].astype(np.uint64)
        # term = Σ_j inv_v_j − m·inv_t + ms·is_glast·inv_send; acc = prefix
        term = inv_v.sum(axis=1) % P_
        m_it = (inv_t.astype(np.uint64) * mult[:, None]) % P_
        term = (term + P_ - m_it) % P_

        eid = main[:, L["eid"].start].astype(np.uint64)
        key = main[:, L["key"]].astype(np.uint64)
        inb = main[:, L["inb"]].astype(np.uint64)
        ms = main[:, L["ms"].start].astype(np.uint64)
        limb_w = np.array([256 << k for k in range(8)]
                          + [1 << k for k in range(8)], dtype=np.uint64)
        out_l = np.zeros((n, 8), dtype=np.uint64)
        for j in range(8):
            sl = L["st"].start + 16 * j
            bits = main[:, sl : sl + 16].astype(np.uint64)
            out_l[:, j] = (bits * limb_w[None, :]).sum(axis=1)
        zeros8 = np.zeros((n, 8), dtype=np.uint64)
        send_pl = np.concatenate([eid[:, None], zeros8[:, :1], key, zeros8,
                                  inb, out_l], axis=1)
        inv_send = np_bus_inverse_terms(challenges, BUS_AES_ENC, send_pl)
        t_idx = np.arange(n) % ROWS_PER_BLOCK
        glast = (t_idx == ROWS_PER_BLOCK - 1).astype(np.uint64)
        u = (term + (ms * glast)[:, None] * inv_send.astype(np.uint64)) % P_
        s = np.cumsum(u.astype(object), axis=0) % P_  # exact big-int sum

        out = np.zeros((n, self.perm_width), dtype=np.uint32)
        out[:, : 4 * N_LOOKUPS] = inv_v.reshape(n, -1)
        out[:, 4 * N_LOOKUPS : 4 * N_LOOKUPS + 4] = inv_t
        out[:, 4 * (N_LOOKUPS + 1) : 4 * (N_LOOKUPS + 2)] = inv_send
        out[:, 4 * (N_LOOKUPS + 2) : 4 * (N_LOOKUPS + 3)] = u.astype(np.uint64)
        out[:, 4 * (N_LOOKUPS + 3) :] = s.astype(np.uint64)
        return out

# ---------------------------------------------------------------------------
# witness generation
# ---------------------------------------------------------------------------


SBOX_U8 = np.array(SBOX, dtype=np.uint8)


def byte_bits(byte_rows: np.ndarray) -> np.ndarray:
    """(n, 8·w) bit columns of (n, w) uint8 rows: column 8·i + k holds bit
    k of byte i, the chips' bit order."""
    return np.unpackbits(byte_rows, axis=1, bitorder="little")


def be16_limbs(byte_rows: np.ndarray) -> np.ndarray:
    """(n, w/2) big-endian 16-bit limbs of (n, w) uint8 rows."""
    return (byte_rows[:, 0::2].astype(np.uint32) << 8) | byte_rows[:, 1::2]


def _mix_term_index() -> np.ndarray:
    """(128, 7): the sb bit index of each xor term of MixColumns output bit
    8·j + k, in `_mix_terms` order; a bit with five terms points its last
    two at column 128, which is always zero."""
    idx = np.full((128, 7), 128, dtype=np.int64)
    for j in range(16):
        for k in range(8):
            terms = _mix_terms(lambda bi, kk: 8 * bi + kk, j, k)
            idx[8 * j + k, : len(terms)] = terms
    return idx


_MIX_TERM_INDEX = _mix_term_index()


def fill_round_columns(trace, L, st, rk, ks_in, ks_xor) -> None:
    """Write the columns every AES chip's rows share, for all rows at once:
    st, rk, sb = SBOX[st], the MixColumns stages m1/m2/m3 over sb, ks_sb =
    SBOX[ks_in] and ks1 = ks_xor ^ ks_sb.  Arguments are (n, 16) or (n, 4)
    uint8 byte rows.  Zero terms leave an xor stage unchanged, so the
    seven-term `_stage_values` gives every bit its own stages."""
    sb = SBOX_U8[st]
    trace[:, L["st"]] = byte_bits(st)
    trace[:, L["rk"]] = byte_bits(rk)
    sb_bits = byte_bits(sb)
    trace[:, L["sb"]] = sb_bits
    terms = np.pad(sb_bits, ((0, 0), (0, 1))).astype(np.int32)
    terms = terms[:, _MIX_TERM_INDEX]
    stages = _stage_values([terms[:, :, i] for i in range(7)])
    for name, m in zip(("m1", "m2", "m3"), stages):
        trace[:, L[name]] = m
    ks_sb = SBOX_U8[ks_in]
    trace[:, L["ks_sb"]] = byte_bits(ks_sb)
    trace[:, L["ks1"]] = byte_bits(ks_xor ^ ks_sb)


def sbox_multiplicities(looked_up: np.ndarray, n: int) -> np.ndarray:
    """The (n,) mult column: how often each byte of `looked_up` (every
    S-box input of the trace) occurs, spread over the table's n/256
    repeats — row rep·256 + x holds count(x) // reps, plus one for the
    first count(x) % reps repeats."""
    counts = np.bincount(looked_up.reshape(-1), minlength=256)
    reps = n // 256
    rep = np.arange(reps)[:, None]
    return (counts // reps + (rep < counts % reps)).reshape(-1)


def group_rows(n_real: int, pad: int) -> np.ndarray:
    """Row sources of a trace built from one padding group (rows 0..15)
    and the real groups after it: `pad` copies of the padding group,
    then the real rows in order."""
    return np.concatenate([
        np.tile(np.arange(ROWS_PER_BLOCK), pad),
        np.arange(ROWS_PER_BLOCK, ROWS_PER_BLOCK * (n_real + 1))])


def aes128_trace(blocks: list[tuple[int, bytes, bytes]], min_log_n: int = 8):
    """Build the chip trace from (event_id, key, input_block) triples —
    every block encryption a GCM event performs: E_K(0) = H, E_K(J0) =
    tag mask, and the CTR keystream blocks.  Each real group publishes
    (AES_ENC, eid, key, input, output) on the bus for the GCM control
    chip.  Padded at the FRONT with silent zero groups (min 256 rows so
    the S-box table fits).  Returns (trace, [])."""
    from ...guest.crypto.aes import AES

    if not blocks:
        raise ValueError("need at least one block")
    n_real = len(blocks)
    n_rows = n_real * ROWS_PER_BLOCK
    log_n = max(min_log_n, (n_rows - 1).bit_length())
    n = 1 << log_n
    pad = n // ROWS_PER_BLOCK - n_real
    # group 0: the zero-key padding group, built once
    groups = [(0, b"\x00" * 16, b"\x00" * 16)] + list(blocks)
    n_idle = ROWS_PER_BLOCK - N_ROUNDS
    st, rk = [], []
    for _eid, key, pt in groups:
        aes = AES(key)
        _ct, states = aes.encrypt_block_trace(pt)
        # rows 0..9 enter rounds 1..10, rows 10..15 carry the output;
        # rk[10] sits on row 10, the idle rows after it hold zero keys
        st.append(b"".join(states[:N_ROUNDS]) + states[N_ROUNDS] * n_idle)
        rk.append(b"".join(aes.round_keys) + bytes(16 * (n_idle - 1)))
    st = np.frombuffer(b"".join(st), dtype=np.uint8).reshape(-1, 16)
    rk = np.frombuffer(b"".join(rk), dtype=np.uint8).reshape(-1, 16)

    L = LAYOUT
    built = np.zeros((len(st), L.width), dtype=np.uint32)
    fill_round_columns(built, L, st, rk, rk[:, ROT], rk[:, :4])
    g = np.repeat(np.arange(len(groups)), ROWS_PER_BLOCK)
    built[:, L["eid"].start] = np.array([b[0] for b in groups])[g]
    built[ROWS_PER_BLOCK:, L["ms"].start] = 1
    for name, at in (("key", 1), ("inb", 2)):
        data = b"".join(b[at] for b in groups)
        built[:, L[name]] = be16_limbs(
            np.frombuffer(data, dtype=np.uint8).reshape(-1, 16))[g]

    rows = group_rows(n_real, pad)
    trace = built[rows]
    # lookup multiplicities: every state byte and key-schedule input
    trace[:, L["mult"].start] = sbox_multiplicities(
        np.concatenate([st[rows], rk[rows][:, ROT]], axis=1), n)
    return trace, []
