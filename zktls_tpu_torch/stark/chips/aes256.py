"""AES-256 keystream AIR chip — the 14-round sibling of Aes128Air, proving
the block encryptions of AES-256-GCM sessions (0xC030/0xC02C/0x1302, the
SHA-384 suites the reference client offers, request.rs:25-27).

Same row discipline as the AES-128 chip (one row per round, 16-row
groups: 14 active rounds + 2 idle; S-box via LogUp against the periodic
table; MixColumns through materialized xor stages), with the AES-256 key
schedule proven in-circuit:

  rk[0] = key_lo, rk[1] = key_hi (bound to the bus key limbs), and for
  r ≥ 1 the transition rk[r] → rk[r+1] applies the Nk = 8 recurrence
  w[i] = w[i−8] ^ f(w[i−1]): the w[i−8] words live two rows back, carried
  by the rk_prev shadow columns (rk_prev' = rk chained down the group);
  f alternates by row parity — odd rows apply SubWord∘RotWord + rcon
  (i ≡ 0 mod 8), even rows plain SubWord (i ≡ 4 mod 8) — selected by
  periodic flags so the same four S-box lookups serve both cases.

Bus: each real group's last row sends (BUS_AES_ENC, eid, kv = 1, key_lo,
key_hi, input, output); the GCM control chip consumes it with the same
fingerprint, so an AES-256 keystream can never satisfy an AES-128
receive (the kv flag and key_hi limbs are inside the fingerprint).

Port copy of zktls_tpu.stark.chips.aes256 (same names and values; host code
in numpy).
"""

from __future__ import annotations

import numpy as np

from ...guest.crypto.aes import SBOX
from ..air import Air, AirBuilder
from ..bus import BUS_AES_ENC, np_bus_inverse_terms
from ..ext_val import ExtVal
from .aes128 import (
    POW8,
    ROT,
    SHIFT_SRC,
    _mix_terms,
    _xor2,
    _xor3,
    be16_limbs,
    byte_bits,
    fill_round_columns,
    group_rows,
    sbox_multiplicities,
)

__all__ = ["Aes256Air", "aes256_trace", "ROWS_PER_BLOCK"]

ROWS_PER_BLOCK = 16
N_ROUNDS = 14
N_LOOKUPS = 20
_RCON = [0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40]


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
    L.add("rk", 128)      # round key rk[r]
    L.add("rkp", 128)     # rk[r−1] shadow (the w[i−8] source)
    L.add("sb", 128)      # SubBytes(st)
    L.add("m1", 128)      # MixColumns xor stages
    L.add("m2", 128)
    L.add("m3", 128)
    L.add("ks_sb", 32)    # SubWord((Rot?)w3) output bits
    L.add("ks1", 32)      # rkp_w0 ^ ks_sb (pre-rcon)
    L.add("mult", 1)      # S-box table multiplicities
    L.add("eid", 1)
    L.add("key", 8)       # key_lo limbs (bound at row 0)
    L.add("key2", 8)      # key_hi limbs (bound at row 1)
    L.add("inb", 8)       # input block limbs
    L.add("ms", 1)        # send multiplicity
    return L


LAYOUT = _build_layout()


class Aes256Air(Air):
    width = LAYOUT.width
    num_public = 0
    max_constraint_degree = 3
    perm_width = 4 * (N_LOOKUPS + 4)
    num_perm_challenges = 2
    has_bus = True

    def periodic_columns(self) -> list:
        z = np.zeros(ROWS_PER_BLOCK, dtype=np.uint32)
        is_r0 = z.copy(); is_r0[0] = 1
        is_r1 = z.copy(); is_r1[1] = 1
        is_active = z.copy(); is_active[:N_ROUNDS] = 1
        is_last_active = z.copy(); is_last_active[N_ROUNDS - 1] = 1
        p_ks = z.copy(); p_ks[1:N_ROUNDS] = 1          # rows 1..13
        p_chain = z.copy(); p_chain[0:N_ROUNDS - 1] = 1  # rows 0..12
        p_odd = z.copy()
        for r in range(1, N_ROUNDS, 2):
            p_odd[r] = 1
        rcon_bits = []
        for k in range(8):
            pat = z.copy()
            for r in range(1, N_ROUNDS, 2):
                pat[r] = (_RCON[(r + 1) // 2 - 1] >> k) & 1
            rcon_bits.append(pat)
        is_idle_carry = z.copy()
        is_idle_carry[N_ROUNDS : ROWS_PER_BLOCK - 1] = 1
        tbl_in = np.arange(256, dtype=np.uint32)
        tbl_out = np.array(SBOX, dtype=np.uint32)
        is_glast = z.copy(); is_glast[ROWS_PER_BLOCK - 1] = 1
        return ([is_r0, is_r1, is_active, is_last_active, p_ks, p_chain,
                 p_odd] + rcon_bits + [tbl_in, tbl_out, is_idle_carry,
                                       is_glast])

    # ------------------------------------------------------------------

    def eval(self, b: AirBuilder) -> None:
        L = LAYOUT
        (is_r0, is_r1, is_active, is_last_active, p_ks, p_chain,
         p_odd) = b.periodic[0:7]
        rcon_bits = b.periodic[7:15]
        tbl_in, tbl_out = b.periodic[15], b.periodic[16]
        is_idle_carry = b.periodic[17]
        is_glast = b.periodic[18]
        not_last_active = is_active * (1 - is_last_active)  # rounds 0..12
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
        RKP = b.local_group(L["rkp"])
        SB = b.local_group(L["sb"])
        KSB = b.local_group(L["ks_sb"])

        for grp, k in ((ST, 128), (RK, 128), (RKP, 128), (SB, 128),
                       (KSB, 32)):
            b.assert_zero_vec(grp * (grp - 1), k)

        # --- S-box lookups: 16 state + 4 key-schedule (parity-selected
        # input byte: odd rows RotWord, even rows plain) ---
        for i in range(16):
            iv = b.perm_ext(i)
            val = ExtVal.from_base(dot("st", 8 * i)) + delta * dot("sb",
                                                                   8 * i)
            b.assert_ext_zero(iv * (gamma - val) - 1)
        for t in range(4):
            x = (p_odd * dot("rk", 8 * ROT[t])
                 + (1 - p_odd) * dot("rk", 8 * (12 + t)))
            iv = b.perm_ext(16 + t)
            val = ExtVal.from_base(x) + delta * dot("ks_sb", 8 * t)
            b.assert_ext_zero(iv * (gamma - val) - 1)
        inv_t = b.perm_ext(N_LOOKUPS)
        tval = ExtVal.from_base(tbl_in) + delta * tbl_out
        b.assert_ext_zero(inv_t * (gamma - tval) - 1)

        # --- bus metadata ---
        def dpow(i):
            return b.challenges[1 + i]

        LIMB_W = [256 << k for k in range(8)] + [1 << k for k in range(8)]

        def limb16(name, j):
            sl0 = L[name].start + 16 * j
            return b.dot_const(b.local_group(slice(sl0, sl0 + 16)), LIMB_W)

        eid = loc("eid", 0)
        ms = loc("ms", 0)
        b.assert_bool(ms)
        not_glast = 1 - is_glast
        for nm in ("eid", "ms"):
            b.assert_zero(not_glast * (b.next[L[nm].start] - loc(nm, 0)))
        for nm in ("key", "key2", "inb"):
            b.assert_zero_vec(
                not_glast * (b.next_group(L[nm]) - b.local_group(L[nm])),
                8)
        for j in range(8):
            b.assert_zero(is_r0 * (loc("key", j) - limb16("rk", j)))
            b.assert_zero(is_r1 * (loc("key2", j) - limb16("rk", j)))
            xor_pack = None
            for k in range(16):
                x_ = b.local[L["st"].start + 16 * j + k]
                y_ = b.local[L["rk"].start + 16 * j + k]
                t_ = (x_ + y_ - 2 * (x_ * y_)) * LIMB_W[k]
                xor_pack = t_ if xor_pack is None else xor_pack + t_
            b.assert_zero(is_r0 * (loc("inb", j) - xor_pack))

        # --- bus send with kv = 1 ---
        fp_send = (ExtVal.from_base(BUS_AES_ENC) + dpow(0) * eid
                   + dpow(1) * 1)
        for j in range(8):
            fp_send = fp_send + dpow(2 + j) * loc("key", j)
            fp_send = fp_send + dpow(10 + j) * loc("key2", j)
            fp_send = fp_send + dpow(18 + j) * loc("inb", j)
            fp_send = fp_send + dpow(26 + j) * limb16("st", j)
        inv_send = b.perm_ext(N_LOOKUPS + 1)
        b.assert_ext_zero(inv_send * (gamma - fp_send) - 1)

        u = b.perm_ext(N_LOOKUPS + 2)
        u_n = b.perm_ext(N_LOOKUPS + 2, nxt=True)
        acc = b.perm_ext(N_LOOKUPS + 3)
        acc_n = b.perm_ext(N_LOOKUPS + 3, nxt=True)
        mult = loc("mult", 0)
        lk = None
        for j in range(N_LOOKUPS):
            term = b.perm_ext(j)
            lk = term if lk is None else lk + term
        u_def = lk - mult * b.perm_ext(N_LOOKUPS) \
            + inv_send * (ms * is_glast)
        b.assert_ext_zero(u - u_def)
        b.assert_ext_zero((acc - u) * b.is_first_row)
        b.assert_ext_zero((acc_n - acc - u_n) * b.is_transition)
        for ell in range(4):
            b.when_last_row(acc.c[ell] - b.public[ell])

        # --- MixColumns stages + round transition (rounds 0..12) ---
        def sb_bit(byte_idx, k):
            return loc("sb", 8 * byte_idx + k)

        for j in range(16):
            for k in range(8):
                terms = _mix_terms(sb_bit, j, k)
                m1, m2, m3 = (loc(nm, 8 * j + k)
                              for nm in ("m1", "m2", "m3"))
                rest = terms[3:]
                e1v = _xor3(terms[0], terms[1], terms[2])
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

        # --- final round (row 13): no MixColumns ---
        for j in range(16):
            src = SHIFT_SRC[j]
            for k in range(8):
                b.assert_zero(is_last_active
                              * (nxt("st", 8 * j + k)
                                 - _xor2(loc("sb", 8 * src + k),
                                         nxt("rk", 8 * j + k))))

        # --- key schedule ---
        # rk_prev chain: rkp' = rk on rows 0..12 transitions
        b.assert_zero_vec(p_chain * (b.next_group(L["rkp"]) - RK), 128)
        # ks1 = rkp word 0 ^ ks_sb (definition, every row)
        for t in range(4):
            for k in range(8):
                b.assert_zero(loc("ks1", 8 * t + k)
                              - _xor2(loc("rkp", 8 * t + k),
                                      loc("ks_sb", 8 * t + k)))
        # word 0 of rk[r+1]: ks1 ^ rcon (rcon nonzero only on odd rows,
        # byte 0 — baked into the periodic patterns)
        for t in range(4):
            for k in range(8):
                ks1 = loc("ks1", 8 * t + k)
                nw0 = nxt("rk", 8 * t + k)
                if t == 0:
                    rc = rcon_bits[k]
                    b.assert_zero(p_ks * (nw0 - (ks1 + rc
                                                 - 2 * (ks1 * rc))))
                else:
                    b.assert_zero(p_ks * (nw0 - ks1))
        # words 1..3: w_j' = rkp_wj ^ w_{j-1}'
        for w in range(1, 4):
            for byte in range(4):
                i = 4 * w + byte
                pi = 4 * (w - 1) + byte
                for k in range(8):
                    b.assert_zero(p_ks * (nxt("rk", 8 * i + k)
                                          - _xor2(loc("rkp", 8 * i + k),
                                                  nxt("rk", 8 * pi + k))))

        # --- idle carry (row 14 → 15) ---
        for k in range(128):
            b.assert_zero(is_idle_carry * (nxt("st", k) - loc("st", k)))

    # ------------------------------------------------------------------

    def generate_perm_trace(self, main, public_values, challenges):
        from ..lookup import np_logup_terms

        gamma, delta = challenges[0], challenges[1]
        n = main.shape[0]
        L = LAYOUT
        P_ = 2013265921

        def bytes_col(name, start):
            sl = L[name].start + start
            bits = main[:, sl : sl + 8].astype(np.uint64)
            return (bits * np.array(POW8, dtype=np.uint64)[None, :]
                    ).sum(axis=1)

        rowm = np.arange(n) % ROWS_PER_BLOCK
        odd = ((rowm % 2 == 1) & (rowm < N_ROUNDS)).astype(np.uint64)
        xs, ys = [], []
        for i in range(16):
            xs.append(bytes_col("st", 8 * i))
            ys.append(bytes_col("sb", 8 * i))
        for t in range(4):
            xs.append(odd * bytes_col("rk", 8 * ROT[t])
                      + (1 - odd) * bytes_col("rk", 8 * (12 + t)))
            ys.append(bytes_col("ks_sb", 8 * t))
        xs_flat = np.stack(xs, axis=1).reshape(-1)
        ys_flat = np.stack(ys, axis=1).reshape(-1)
        inv_v = np_logup_terms(gamma, xs_flat, None, ys_flat, delta)
        inv_v = inv_v.reshape(n, N_LOOKUPS, 4)
        t_in = (np.arange(n, dtype=np.uint64) % 256)
        t_out = np.array(SBOX, dtype=np.uint64)[t_in.astype(np.int64)]
        inv_t = np_logup_terms(gamma, t_in, None, t_out, delta)

        mult = main[:, L["mult"].start].astype(np.uint64)
        term = inv_v.sum(axis=1) % P_
        m_it = (inv_t.astype(np.uint64) * mult[:, None]) % P_
        term = (term + P_ - m_it) % P_

        eid = main[:, L["eid"].start].astype(np.uint64)
        key = main[:, L["key"]].astype(np.uint64)
        key2 = main[:, L["key2"]].astype(np.uint64)
        inb = main[:, L["inb"]].astype(np.uint64)
        ms = main[:, L["ms"].start].astype(np.uint64)
        limb_w = np.array([256 << k for k in range(8)]
                          + [1 << k for k in range(8)], dtype=np.uint64)
        out_l = np.zeros((n, 8), dtype=np.uint64)
        for j in range(8):
            sl = L["st"].start + 16 * j
            bits = main[:, sl : sl + 16].astype(np.uint64)
            out_l[:, j] = (bits * limb_w[None, :]).sum(axis=1)
        ones = np.ones((n, 1), dtype=np.uint64)
        send_pl = np.concatenate([eid[:, None], ones, key, key2, inb,
                                  out_l], axis=1)
        inv_send = np_bus_inverse_terms(challenges, BUS_AES_ENC, send_pl)
        glast = (rowm == ROWS_PER_BLOCK - 1).astype(np.uint64)
        u = (term + (ms * glast)[:, None]
             * inv_send.astype(np.uint64)) % P_
        s = np.cumsum(u.astype(object), axis=0) % P_

        out = np.zeros((n, self.perm_width), dtype=np.uint32)
        out[:, : 4 * N_LOOKUPS] = inv_v.reshape(n, -1)
        out[:, 4 * N_LOOKUPS : 4 * N_LOOKUPS + 4] = inv_t
        out[:, 4 * (N_LOOKUPS + 1) : 4 * (N_LOOKUPS + 2)] = inv_send
        out[:, 4 * (N_LOOKUPS + 2) : 4 * (N_LOOKUPS + 3)] = \
            u.astype(np.uint64)
        out[:, 4 * (N_LOOKUPS + 3) :] = s.astype(np.uint64)
        return out


# ---------------------------------------------------------------------------
# witness generation
# ---------------------------------------------------------------------------


def aes256_trace(blocks: list[tuple[int, bytes, bytes]],
                 min_log_n: int = 8):
    """Build the chip trace from (event_id, 32-byte key, input_block)
    triples.  Padded at the FRONT with silent zero-key groups (min 256
    rows for the S-box table)."""
    from ...guest.crypto.aes import AES

    if not blocks:
        raise ValueError("need at least one block")
    n_real = len(blocks)
    n_rows = n_real * ROWS_PER_BLOCK
    log_n = max(min_log_n, (n_rows - 1).bit_length())
    n = 1 << log_n
    pad = n // ROWS_PER_BLOCK - n_real
    # group 0: the zero-key padding group, built once
    groups = [(0, b"\x00" * 32, b"\x00" * 16)] + list(blocks)
    zero = bytes(16)
    st, rk, rkp = [], [], []
    for _eid, key, pt in groups:
        aes = AES(key)
        rks = aes.round_keys  # 15 × 16 bytes
        _ct, states = aes.encrypt_block_trace(pt)
        # rows 0..13 enter rounds 1..14, rows 14..15 carry the output;
        # rk[14] sits on row 14 with its shadow rk[13], row 15 is zero
        st.append(b"".join(states[:N_ROUNDS]) + states[N_ROUNDS] * 2)
        rk.append(b"".join(rks) + zero)
        rkp.append(zero + b"".join(rks[:N_ROUNDS]) + zero)
    st, rk, rkp = (np.frombuffer(b"".join(x), dtype=np.uint8).reshape(-1, 16)
                   for x in (st, rk, rkp))
    # odd active rows apply SubWord∘RotWord, the others plain SubWord
    r = np.arange(len(st)) % ROWS_PER_BLOCK
    odd = ((r % 2 == 1) & (r < N_ROUNDS))[:, None]
    ks_in = np.where(odd, rk[:, ROT], rk[:, 12:16])

    L = LAYOUT
    built = np.zeros((len(st), L.width), dtype=np.uint32)
    fill_round_columns(built, L, st, rk, ks_in, rkp[:, :4])
    built[:, L["rkp"]] = byte_bits(rkp)
    g = np.repeat(np.arange(len(groups)), ROWS_PER_BLOCK)
    built[:, L["eid"].start] = np.array([b[0] for b in groups])[g]
    built[ROWS_PER_BLOCK:, L["ms"].start] = 1
    keys = np.frombuffer(b"".join(b[1] for b in groups),
                         dtype=np.uint8).reshape(-1, 32)
    inb = np.frombuffer(b"".join(b[2] for b in groups),
                        dtype=np.uint8).reshape(-1, 16)
    built[:, L["key"]] = be16_limbs(keys[:, :16])[g]
    built[:, L["key2"]] = be16_limbs(keys[:, 16:])[g]
    built[:, L["inb"]] = be16_limbs(inb)[g]

    rows = group_rows(n_real, pad)
    trace = built[rows]
    trace[:, L["mult"].start] = sbox_multiplicities(
        np.concatenate([st[rows], ks_in[rows]], axis=1), n)
    return trace, []
