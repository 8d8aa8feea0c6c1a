"""ModMul AIR chip family — proves batches of W-bit modular multiplications
a · b ≡ r (mod m), the witness stream of every big-integer operation the
guest performs: EC group law (ECDHE, ECDSA certificate / ServerKeyExchange
verification, secp256k1 origin recovery), x25519/ed25519, and RSA
signature verification — the workload of the reference's `sp1-curves`
bigint/EC precompile chips (SURVEY.md §2.2.B; events recorded by
`guest/crypto/modmul.py`).

One event per row.  Operands are witnessed as 8-bit limbs (little-endian).
The modulus is either selected from a fixed per-chip set by boolean
one-hot flags (curve field/scalar moduli — its limbs are then constraint
*constants*), or witnessed as limb columns (RSA, whose modulus comes from
the certificate; binding it to the chain crosses chips via the bus,
round-3 scope note).

**Identity in point-evaluation form.**  With limb polynomials
a(x) = Σ aᵢxⁱ etc. and the carry polynomial c(x) = Σ cₖxᵏ (deg ≤ 2L−3,
cₖ the signed carry of coefficient k), correctness is the polynomial
identity

    a(x)·b(x) − q(x)·m(x) − r(x) = (256 − x)·c(x)

(q the witnessed quotient).  Both sides have degree ≤ 2L−2, so agreement
at the 2L−1 points x = 1..2L−1 forces coefficient-wise equality
tₖ = 256·cₖ − cₖ₋₁ over Baby-Bear; byte range checks bound |tₖ| and |cₖ|
so each congruence is an integer equality (sum of magnitudes < P — the
carry encoding grows a 2-bit top limb at the RSA widths exactly so this
stays true), and evaluating at x = 256 telescopes to a·b = q·m + r
exactly — i.e. r ≡ a·b (mod m) with a, b, q, r < 2^(8L).  (r < m
canonicity is asserted separately: the prover witnesses d = m − 1 − r
limb-wise, range-checked, with Σ(dᵢ + rᵢ)·xⁱ ≡ Σ mᵢxⁱ − 1 at the same
points — so r < m whenever the flags select a real modulus.)

Carries are offset-encoded as bytes (cₖ + OFFSET = lo + 256·mid
[+ 65536·top]).  Every limb and carry byte is range-checked against the
periodic byte table with one LogUp argument; committed inverse columns
are **paired** — w = 1/((γ−v₁)(γ−v₂)) with the degree-3 check
w·(γ−v₁)·(γ−v₂) = 1 and the degree-2 running-sum term (2γ−v₁−v₂)·w —
halving the permutation width.  All pair checks evaluate as ONE wide
ExtVal expression over strided perm-column groups.

The global last row binds its result r as public-value bytes; rows are
front-padded with 0·0 ≡ 0 (mod M₀) events.  Binding each event's operands
to the consuming chip crosses chips via the bus (round-3 scope note).

Port copy of zktls_tpu.stark.chips.modmul (same names and values; host code
in numpy).  The machine prover takes the perm trace from `perm_trace_m`,
the same values as `generate_perm_trace` computed by torch ops on the
chip's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ...guest.crypto.ec import P256, P384, SECP256K1
from ...ops import babybear as bb
from ...ops import ext as ex
from ...ops.field_ref import Fp4, P
from ..air import Air, AirBuilder
from ..ext_val import ExtVal

__all__ = ["ModMulAir", "modmul_air_256", "modmul_air_384",
           "modmul_air_rsa", "MODULI_256", "MODULI_384", "ModMul256Air",
           "modmul_trace", "modmul_class", "modmul_send_payload",
           "u16le_limbs"]

#: curve moduli proven at the 256-bit width: P-256 and secp256k1 base and
#: scalar fields, plus the curve25519 field and the ed25519 group order
P25519 = (1 << 255) - 19
ED25519_L = (1 << 252) + 27742317777372353535851937790883648493
#: Poly1305 prime: the ChaCha suites' tag-polynomial multiplications are
#: recorded as mulmod events over it (guest/crypto/chacha.py)
P1305 = (1 << 130) - 5
MODULI_256: list[int] = [P256.p, P256.n, SECP256K1.p, SECP256K1.n,
                         P25519, ED25519_L, P1305]
MODULI_384: list[int] = [P384.p, P384.n]


class ModMulAir(Air):
    """One width class of the ModMul family.

    limbs: operand size in bytes (32 → 256-bit, 48 → 384-bit, 256 → 2048).
    moduli: fixed one-hot modulus set, or None for a witnessed modulus.
    """

    max_constraint_degree = 3
    num_perm_challenges = 1  # γ (plain byte range lookup)

    def __init__(self, limbs: int, moduli: list[int] | None,
                 name: str, class_offset: int = 0) -> None:
        self.limbs = limbs
        self.moduli = list(moduli) if moduli is not None else None
        self.name = name
        self.class_offset = class_offset
        L = limbs
        self.n_coeff = 2 * L - 1
        self.n_carry = self.n_coeff - 1
        # carry magnitude ≤ ~L·255; the offset encoding must cover it and
        # 256·|c|max must stay ≪ P for the per-point integer argument
        if L <= 64:
            self.carry_top_bits = 0
            self.offset = 1 << 15
        else:
            self.carry_top_bits = 2
            self.offset = 1 << 17
        self.eval_points = list(range(1, self.n_coeff + 1))

        sl = {}
        pos = 0

        def add(nm, k):
            nonlocal pos
            sl[nm] = slice(pos, pos + k)
            pos += k

        add("a", L)
        add("b", L)
        add("r", L)
        add("q", L)
        add("d", L)                 # m − 1 − r (canonicity witness)
        if self.moduli is None:
            add("m", L)             # witnessed modulus limbs
        add("c_lo", self.n_carry)
        add("c_mid", self.n_carry)
        # byte-checked columns end here; top bits are boolean-checked
        self.n_lookup_values = pos
        if self.carry_top_bits:
            add("c_top", self.n_carry * self.carry_top_bits)
        add("e", L - 1)             # canonicity borrow bits (boolean)
        if self.moduli is not None:
            add("f", len(self.moduli))
            add("ms", 1)            # bus send multiplicity (free witness)
        add("mult", 1)
        self.slices = sl
        self.width = pos
        if self.n_lookup_values % 2:
            raise AssertionError("lookup column count must be even")
        self.n_pairs = self.n_lookup_values // 2
        # fixed-moduli chips publish every row's proven (mclass, a, b, r)
        # on the global bus (BUS_MODMUL) with a witnessed multiplicity —
        # the operand-level composition primitive consumed by the EC
        # schedule and Poly1305 accounting chips.  Perm layout:
        # [pair inverses | table inv | internal sum | send inv | bus acc]
        self.has_bus = self.moduli is not None
        self.perm_width = 4 * (self.n_pairs + 2
                               + (2 if self.has_bus else 0))
        self.num_public = L

        # constant weight matrices of the point-evaluation identity,
        # precomputed mod P: column t = eval point x_t
        pts = self.eval_points
        m_pts = len(pts)
        w_full = np.array(
            [[pow(x, i, P) for x in pts]
             for i in range(max(L, self.n_carry))], dtype=np.uint32)
        self._w_lim = w_full[:L]                   # (L, m)
        self._w_car = w_full[: self.n_carry]       # (n_carry, m)
        self._c_offset_at = [
            self.offset * sum(pow(x, k, P) for k in range(self.n_carry)) % P
            for x in pts]
        self._factor_at = [(256 - x) % P for x in pts]
        if self.moduli is not None:
            mod_limbs = [[(m >> (8 * i)) & 0xFF for i in range(L)]
                         for m in self.moduli]
            # (nf, m): modulus polynomial evaluated at each point
            self._w_mod = np.array(
                [[sum(ml[i] * pow(x, i, P) for i in range(L)) % P
                  for x in pts] for ml in mod_limbs], dtype=np.uint32)
        assert m_pts == self.n_coeff

    def periodic_columns(self) -> list:
        return [np.arange(256, dtype=np.uint32)]

    # ------------------------------------------------------------------

    def eval(self, b: AirBuilder) -> None:
        sl = self.slices
        L = self.limbs
        gamma = b.challenges[0]

        A = b.local_group(sl["a"])
        B = b.local_group(sl["b"])
        R = b.local_group(sl["r"])
        Q = b.local_group(sl["q"])
        D = b.local_group(sl["d"])
        CLO = b.local_group(sl["c_lo"])
        CMID = b.local_group(sl["c_mid"])
        if self.carry_top_bits:
            CTOP = b.local_group(sl["c_top"])
            b.assert_zero_vec(CTOP * (CTOP - 1),
                              self.n_carry * self.carry_top_bits)
        E = b.local_group(sl["e"])
        b.assert_zero_vec(E * (E - 1), L - 1)

        if self.moduli is not None:
            F = b.local_group(sl["f"])
            nf = len(self.moduli)
            b.assert_zero_vec(F * (F - 1), nf)
            b.assert_zero(b.dot_const(F, [1] * nf) - 1)

        # --- the point-evaluated limb identity + canonicity r < m, all
        # eval points at once: each operand's point-row is ONE exact
        # Baby-Bear matmul (builder.mat_const) ---
        m_pts = self.n_coeff
        A_p = b.mat_const(A, self._w_lim)
        B_p = b.mat_const(B, self._w_lim)
        Q_p = b.mat_const(Q, self._w_lim)
        R_p = b.mat_const(R, self._w_lim)
        D_p = b.mat_const(D, self._w_lim)
        if self.moduli is not None:
            M_p = b.mat_const(F, self._w_mod)
        else:
            M_p = b.mat_const(b.local_group(sl["m"]), self._w_lim)
        C_p = b.mat_const(CLO, self._w_car) \
            + 256 * b.mat_const(CMID, self._w_car)
        if self.carry_top_bits:
            tb = self.carry_top_bits
            for j in range(tb):
                part = b.mat_const(
                    b.local_group(slice(sl["c_top"].start + j,
                                        sl["c_top"].stop, tb)),
                    self._w_car)
                C_p = C_p + ((65536 << j) % P) * part
        C_p = C_p - b.const_vec(self._c_offset_at)
        factor = b.const_vec(self._factor_at)
        b.assert_zero_vec(A_p * B_p - Q_p * M_p - R_p - factor * C_p,
                          m_pts)
        # canonicity r < m: r(x) + d(x) + 1 − m(x) = (256−x)·e(x) with
        # byte-checked d and boolean borrow bits e — an integer identity
        # telescoping to r + d + 1 = m, so r ≤ m − 1.
        E_p = b.mat_const(E, self._w_lim[: L - 1])
        b.assert_zero_vec(R_p + D_p + 1 - M_p - factor * E_p, m_pts)

        # --- public binding: global last row's r ---
        for j in range(L):
            b.when_last_row(R[j] - b.public[j])

        # --- LogUp byte range check: ONE wide expression over all pairs ---
        V = b.local_group(slice(0, self.n_lookup_values))
        V1, V2 = V[0::2], V[1::2]
        W = b.perm_ext_group(self.n_pairs)
        G1 = gamma - ExtVal.from_base(V1)
        G2 = gamma - ExtVal.from_base(V2)
        pair_check = W * (G1 * G2) - 1
        for limb in pair_check.limbs():
            b.assert_zero_vec(limb, self.n_pairs)

        t_col = b.periodic[0]
        mult = b.local[sl["mult"].start]
        mult_next = b.next[sl["mult"].start]
        inv_t = b.perm_ext(self.n_pairs)
        inv_t_n = b.perm_ext(self.n_pairs, nxt=True)
        s = b.perm_ext(self.n_pairs + 1)
        s_next = b.perm_ext(self.n_pairs + 1, nxt=True)
        b.assert_ext_zero(inv_t * (gamma - ExtVal.from_base(t_col)) - 1)

        def row_term(V1v, V2v, Wv, mult_v, table_inv):
            prod = (gamma * 2 - ExtVal.from_base(V1v + V2v)) * Wv
            total = ExtVal(*[b.dot_const(limb, [1] * self.n_pairs)
                             for limb in prod.limbs()])
            return total - mult_v * table_inv

        term_first = row_term(V1, V2, W, mult, inv_t)
        b.assert_ext_zero((s - term_first) * b.is_first_row)
        Vn = b.next_group(slice(0, self.n_lookup_values))
        Wn = b.perm_ext_group(self.n_pairs, nxt=True)
        term_next = row_term(Vn[0::2], Vn[1::2], Wn, mult_next, inv_t_n)
        b.assert_ext_zero((s_next - s - term_next) * b.is_transition)
        b.assert_ext_zero(s * b.is_last_row)

        # --- global-bus send: every row publishes its proven statement
        # (mclass, a, b, r) as u16 limbs on BUS_MODMUL with the witnessed
        # multiplicity ms.  ms needs no range check: the payload is the
        # row's own AIR-proven event, so any net-positive send of a value
        # implies a row proving it (see stark/bus.py).
        if self.has_bus and len(b.challenges) >= 2 + 3 * (L // 2):
            # (standalone uni-STARK use passes only γ — the chip then
            # runs busless, mirrored by generate_perm_trace; the machine
            # always passes the full [γ, δ…] vector)
            from ..bus import BUS_MODMUL

            ms = b.local[sl["ms"].start]
            ms_n = b.next[sl["ms"].start]
            nf = len(self.moduli)
            mclass = b.dot_const(
                F, [self.class_offset + i for i in range(nf)])
            fp = ExtVal.from_base(BUS_MODMUL) + b.challenges[1] * mclass
            k2 = L // 2
            for gi, G in enumerate((A, B, R)):
                for j in range(k2):
                    limb = G[2 * j] + 256 * G[2 * j + 1]
                    fp = fp + b.challenges[2 + k2 * gi + j] * limb
            inv_send = b.perm_ext(self.n_pairs + 2)
            acc = b.perm_ext(self.n_pairs + 3)
            inv_send_n = b.perm_ext(self.n_pairs + 2, nxt=True)
            acc_n = b.perm_ext(self.n_pairs + 3, nxt=True)
            b.assert_ext_zero(inv_send * (gamma - fp) - 1)
            b.assert_ext_zero((acc - ms * inv_send) * b.is_first_row)
            b.assert_ext_zero(
                (acc_n - acc - ms_n * inv_send_n) * b.is_transition)
            for ell in range(4):
                b.when_last_row(acc.c[ell] - b.public[L + ell])

    # ------------------------------------------------------------------

    def generate_perm_trace(self, main, public_values, challenges):
        from ..lookup import np_ext_inverse, np_ext_mul, np_logup_terms

        gamma = challenges[0]
        n = main.shape[0]
        nv = self.n_lookup_values

        # invert the PAIRED products directly — w = 1/((γ−v₁)(γ−v₂)) —
        # instead of 2·n_pairs single inverses; the per-row LogUp term
        # Σ 1/(γ−vᵢ) equals Σ_pairs (2γ−v₁−v₂)·w, so single inverses are
        # never needed (halves the dominant host cost of this chip)
        vals = main[:, :nv].astype(np.uint64)
        g = np.array(gamma.c, dtype=np.uint64)
        gv = np.zeros((n * nv, 4), dtype=np.uint64)
        gv[:] = g[None, :]
        gv[:, 0] = (gv[:, 0] + P - (vals.reshape(-1) % P)) % P
        gv = gv.reshape(n, nv, 4)
        prod = np_ext_mul(gv[:, 0::2, :].reshape(-1, 4),
                          gv[:, 1::2, :].reshape(-1, 4))
        w = np_ext_inverse(prod).reshape(n, self.n_pairs, 4)
        two_g = np.zeros((n, self.n_pairs, 4), dtype=np.uint64)
        two_g[:] = (2 * g % P)[None, None, :]
        two_g[:, :, 0] = (two_g[:, :, 0] + 2 * P
                          - vals[:, 0::2] % P - vals[:, 1::2] % P) % P
        pair_terms = np_ext_mul(two_g.reshape(-1, 4),
                                w.reshape(-1, 4).astype(np.uint64))
        term = pair_terms.reshape(n, self.n_pairs, 4).sum(axis=1) % P

        t_in = np.arange(n, dtype=np.uint64) % 256
        inv_t = np_logup_terms(gamma, t_in, None, None, None)

        mult = main[:, self.slices["mult"].start].astype(np.uint64)
        m_it = (inv_t.astype(np.uint64) * mult[:, None]) % P
        term = (term + P - m_it) % P
        s = np.cumsum(term.astype(object), axis=0) % P

        out = np.zeros((n, self.perm_width), dtype=np.uint32)
        out[:, : 4 * self.n_pairs] = w.reshape(n, -1)
        out[:, 4 * self.n_pairs : 4 * self.n_pairs + 4] = inv_t
        out[:, 4 * (self.n_pairs + 1) : 4 * (self.n_pairs + 2)] = \
            s.astype(np.uint64)
        if self.has_bus and len(challenges) >= 2 + 3 * (self.limbs // 2):
            from ..bus import BUS_MODMUL, np_bus_inverse_terms

            inv_send = np_bus_inverse_terms(
                challenges, BUS_MODMUL, self._send_payloads(main))
            ms = main[:, self.slices["ms"].start].astype(np.uint64)
            acc = np.cumsum(
                (inv_send.astype(np.uint64) * ms[:, None]) % P,
                axis=0) % P
            out[:, 4 * (self.n_pairs + 2) : 4 * (self.n_pairs + 3)] = \
                inv_send
            out[:, 4 * (self.n_pairs + 3):] = acc
        return out

    def perm_trace_m(self, main, main_m, public_values, challenges, **kw):
        """generate_perm_trace's values in Montgomery form, computed by
        torch ops on main_m's device from the Montgomery main trace: the
        same algorithm, its pair inverses one row block at a time (at most
        _PERM_BLOCK_PAIRS pairs a block, so its temporaries stay small).
        The running sums are int64 cumsums, exact while n·p < 2^63, and
        Montgomery form is linear, so they are the Montgomery sums."""
        n = main_m.shape[0]
        sl = self.slices
        npairs = self.n_pairs
        gamma = _ext_const(challenges[0], main_m.device)
        two_g = bb.add(gamma, gamma)
        out = torch.zeros((n, self.perm_width), dtype=bb.DTYPE,
                          device=main_m.device)
        term = torch.empty((n, 4), dtype=bb.DTYPE, device=main_m.device)
        rows = max(1, _PERM_BLOCK_PAIRS // npairs)
        for r0 in range(0, n, rows):
            v = main_m[r0 : r0 + rows, : self.n_lookup_values]
            v1, v2 = v[:, 0::2], v[:, 1::2]
            w = ex.ext_inv(ex.ext_mul(_ext_minus_base(gamma, v1),
                                      _ext_minus_base(gamma, v2)))
            out[r0 : r0 + rows, : 4 * npairs] = w.reshape(-1, 4 * npairs)
            pair_terms = ex.ext_mul(
                _ext_minus_base(two_g, bb.add(v1, v2)), w)
            term[r0 : r0 + rows] = bb.sum_mod(pair_terms, dim=1)

        t_m = bb.to_mont(torch.arange(256, dtype=bb.DTYPE,
                                      device=main_m.device))
        inv_tab = ex.ext_inv(_ext_minus_base(gamma, t_m))
        inv_t = inv_tab[torch.arange(n, device=main_m.device) % 256]
        mult = main_m[:, sl["mult"].start]
        term = bb.sub(term, ex.ext_scale(inv_t, mult))
        out[:, 4 * npairs : 4 * npairs + 4] = inv_t
        out[:, 4 * (npairs + 1) : 4 * (npairs + 2)] = \
            torch.cumsum(term, dim=0) % P
        if self.has_bus and len(challenges) >= 2 + 3 * (self.limbs // 2):
            from ..bus import BUS_MODMUL

            payload = self._send_payloads_m(main_m)
            k = payload.shape[1]
            deltas = torch.stack([_ext_const(c, main_m.device)
                                  for c in challenges[1 : 1 + k]])
            fp = bb.sum_mod(bb.mul(payload[:, :, None], deltas[None]), dim=1)
            g_tag = _ext_const(challenges[0] - Fp4(BUS_MODMUL), main_m.device)
            inv_send = ex.ext_inv(bb.sub(g_tag, fp))
            ms = main_m[:, sl["ms"].start]
            out[:, 4 * (npairs + 2) : 4 * (npairs + 3)] = inv_send
            out[:, 4 * (npairs + 3):] = \
                torch.cumsum(ex.ext_scale(inv_send, ms), dim=0) % P
        return out

    def _send_payloads_m(self, main_m):
        """_send_payloads from the Montgomery main trace, in Montgomery
        form: each payload is a combination of trace values with integer
        weights, which commutes with the Montgomery map."""
        sl = self.slices
        weights = torch.arange(len(self.moduli), dtype=bb.DTYPE,
                               device=main_m.device) + self.class_offset
        parts = [(main_m[:, sl["f"]] * weights).sum(dim=1, keepdim=True)
                 % P]
        for nm in ("a", "b", "r"):
            byt = main_m[:, sl[nm]]
            parts.append((byt[:, 0::2] + 256 * byt[:, 1::2]) % P)
        return torch.cat(parts, dim=1)

    def _send_payloads(self, main: np.ndarray) -> np.ndarray:
        """(n, 1 + 3·L/2) BUS_MODMUL payload rows from the main trace."""
        sl = self.slices
        n = main.shape[0]
        f = main[:, sl["f"]].astype(np.uint64)
        weights = np.arange(len(self.moduli), dtype=np.uint64) \
            + self.class_offset
        mclass = (f * weights[None, :]).sum(axis=1)
        parts = [mclass[:, None]]
        for nm in ("a", "b", "r"):
            byt = main[:, sl[nm]].astype(np.uint64)
            parts.append(byt[:, 0::2] + 256 * byt[:, 1::2])
        return np.concatenate(parts, axis=1)

    # ------------------------------------------------------------------
    # witness generation

    def trace(self, events, min_log_n: int = 8, sends=None):
        """Build the chip trace from ModMulEvents (a, b, r, m).  Front-
        padded with 0·0 ≡ 0 (mod M₀) rows; the LAST event's r binds as
        public values.  Returns (trace, public_values list[int]).

        sends: bus send multiplicities — either a per-event int list, or
        a dict {(a, b, r, m): count} of consumptions to distribute (each
        tuple's full count is assigned to its FIRST event row; leftover
        counts raise — a consumer would be receiving an unproven
        statement)."""
        events = list(events)
        if not events:
            raise ValueError("need at least one event")
        L = self.limbs
        sl = self.slices
        if self.moduli is not None:
            mod_index = {m: i for i, m in enumerate(self.moduli)}
            pad_mod = self.moduli[0]
        else:
            pad_mod = (1 << (8 * L)) - 159  # any odd pad modulus
        for ev in events:
            if self.moduli is not None and ev.m not in mod_index:
                raise ValueError(f"modulus not in chip set: {hex(ev.m)}")
            if ev.m % 2 == 0 or ev.m.bit_length() > 8 * L:
                raise ValueError("modulus must be odd and fit the width")
            if not (0 <= ev.a < ev.m and 0 <= ev.b < ev.m
                    and 0 <= ev.r < ev.m):
                raise ValueError("operands out of range")

        # the byte range-check table is materialized over rows i mod 256,
        # so the trace must cover at least one full table period
        n = 1 << max(min_log_n, 8, (len(events) - 1).bit_length())
        pad = n - len(events)

        def limbs(v):
            return np.frombuffer(int(v).to_bytes(L, "little"),
                                 dtype=np.uint8)

        trace = np.zeros((n, self.width), dtype=np.uint32)
        a_l = np.zeros((n, L), dtype=np.int64)
        b_l = np.zeros((n, L), dtype=np.int64)
        r_l = np.zeros((n, L), dtype=np.int64)
        q_l = np.zeros((n, L), dtype=np.int64)
        m_l = np.zeros((n, L), dtype=np.int64)
        m_l[:pad] = limbs(pad_mod).astype(np.int64)
        if self.moduli is not None:
            trace[:pad, sl["f"].start] = 1

        if sends is not None and self.moduli is None:
            raise ValueError("witnessed-modulus chips have no bus sends")
        if isinstance(sends, dict):
            remaining = dict(sends)
            per_event = []
            for ev in events:
                key = (ev.a, ev.b, ev.r, ev.m)
                per_event.append(remaining.pop(key, 0))
            if any(remaining.values()):
                bad = [k for k, v in remaining.items() if v]
                raise ValueError(
                    f"{len(bad)} consumed modmul statements have no "
                    "recorded event")
        elif sends is not None:
            per_event = list(sends)
            if len(per_event) != len(events):
                raise ValueError("sends list length != event count")
        else:
            per_event = None

        for idx, ev in enumerate(events):
            row = pad + idx
            q, r_chk = divmod(ev.a * ev.b, ev.m)
            if r_chk != ev.r:
                raise ValueError("inconsistent event: a·b mod m != r")
            if per_event is not None:
                trace[row, sl["ms"].start] = per_event[idx]
            a_l[row] = limbs(ev.a).astype(np.int64)
            b_l[row] = limbs(ev.b).astype(np.int64)
            r_l[row] = limbs(ev.r).astype(np.int64)
            q_l[row] = limbs(q).astype(np.int64)
            m_l[row] = limbs(ev.m).astype(np.int64)
            if self.moduli is not None:
                trace[row, sl["f"].start + mod_index[ev.m]] = 1

        trace[:, sl["a"]] = a_l
        trace[:, sl["b"]] = b_l
        trace[:, sl["r"]] = r_l
        trace[:, sl["q"]] = q_l
        # canonicity witness d = m − 1 − r with explicit borrow bits
        d_l = m_l - r_l
        d_l[:, 0] -= 1
        e_l = np.zeros((n, L - 1), dtype=np.int64)
        for k in range(L - 1):
            neg = d_l[:, k] < 0
            e_l[neg, k] = 1
            d_l[neg, k] += 256
            d_l[neg, k + 1] -= 1
        if (d_l < 0).any() or (d_l > 255).any():
            raise ValueError("canonicity witness out of range (r >= m?)")
        trace[:, sl["d"]] = d_l
        trace[:, sl["e"]] = e_l
        if self.moduli is None:
            trace[:, sl["m"]] = m_l

        # carries via per-row convolutions
        conv_ab = _batch_conv(a_l, b_l, L)
        conv_qm = _batch_conv(q_l, m_l, L)
        t = conv_ab - conv_qm
        t[:, :L] -= r_l
        carries = np.zeros((n, self.n_carry), dtype=np.int64)
        c_prev = np.zeros(n, dtype=np.int64)
        for k in range(self.n_coeff):
            d = t[:, k] + c_prev
            assert (d % 256 == 0).all(), "carry chain broke (bad witness)"
            c_prev = d // 256
            if k < self.n_carry:
                carries[:, k] = c_prev
        assert (c_prev == 0).all(), "final carry nonzero (bad witness)"
        assert (np.abs(carries) < self.offset).all(), \
            "carry out of encoding range"
        enc = carries + self.offset
        trace[:, sl["c_lo"]] = (enc & 0xFF).astype(np.uint32)
        trace[:, sl["c_mid"]] = ((enc >> 8) & 0xFF).astype(np.uint32)
        if self.carry_top_bits:
            tb = self.carry_top_bits
            for j in range(tb):
                trace[:, sl["c_top"].start + j : sl["c_top"].stop : tb] = \
                    ((enc >> (16 + j)) & 1).astype(np.uint32)

        lookup_vals = trace[:, : self.n_lookup_values].reshape(-1)
        counts = np.bincount(lookup_vals, minlength=256)
        trace[:256, sl["mult"].start] = counts[:256].astype(np.uint32)

        public = [int(v) for v in r_l[n - 1]]
        return trace, public


def u16le_limbs(v: int, k: int) -> list[int]:
    """Little-endian 16-bit limbs of an integer (the BUS_MODMUL payload
    convention — matches the chip's little-endian byte-limb pairing)."""
    return [(v >> (16 * j)) & 0xFFFF for j in range(k)]


def _batch_conv(x: np.ndarray, y: np.ndarray, L: int) -> np.ndarray:
    """Row-wise full convolution of (n, L) int64 arrays → (n, 2L−1)."""
    n = x.shape[0]
    out = np.zeros((n, 2 * L - 1), dtype=np.int64)
    for i in range(L):
        out[:, i : i + L] += x[:, i : i + 1] * y
    return out


#: pairs of lookup values per row block of ModMulAir.perm_trace_m: its
#: Fp4 temporaries then stay near 2^21 · 32 B = 64 MiB each.  A session's
#: ModMul chips (8192 × 142 and 256 × 1278 pairs) take one block each, so
#: their launches are fewest; larger chips (batches) are cut.
_PERM_BLOCK_PAIRS = 1 << 21


def _ext_const(v, device):
    """A host Fp4 as a (4,) Montgomery tensor on `device`."""
    return bb.from_numpy(ex.from_fp4(v), device)


def _ext_minus_base(e, x):
    """e − x as (..., 4) ext values, for an ext constant e (4,) and base
    values x (...), both in Montgomery form."""
    return torch.stack([bb.sub(e[0], x)] + [e[i].expand_as(x)
                                            for i in (1, 2, 3)], dim=-1)


# --- width-class singletons -------------------------------------------------

_AIR_256 = None
_AIR_384 = None
_AIR_RSA: dict[int, ModMulAir] = {}


def modmul_air_256() -> ModMulAir:
    global _AIR_256
    if _AIR_256 is None:
        _AIR_256 = ModMulAir(32, MODULI_256, "ModMul256Air")
    return _AIR_256


def modmul_air_384() -> ModMulAir:
    from ..bus import MODMUL_CLASS_384

    global _AIR_384
    if _AIR_384 is None:
        _AIR_384 = ModMulAir(48, MODULI_384, "ModMul384Air",
                             class_offset=MODMUL_CLASS_384)
    return _AIR_384


def modmul_air_rsa(bits: int = 2048) -> ModMulAir:
    """Witnessed-modulus width class for RSA (2048/4096)."""
    if bits not in (1024, 2048, 4096):
        raise ValueError("unsupported RSA width")
    if bits not in _AIR_RSA:
        _AIR_RSA[bits] = ModMulAir(bits // 8, None, f"ModMulRsa{bits}Air")
    return _AIR_RSA[bits]


def modmul_class(m: int) -> int:
    """The BUS_MODMUL mclass of a fixed-set modulus (chip-local index,
    384-bit classes offset)."""
    from ..bus import MODMUL_CLASS_384

    if m in MODULI_256:
        return MODULI_256.index(m)
    if m in MODULI_384:
        return MODMUL_CLASS_384 + MODULI_384.index(m)
    raise ValueError(f"modulus not in any fixed chip set: {hex(m)}")


def modmul_send_payload(a: int, b: int, r: int, m: int) -> list[int]:
    """The BUS_MODMUL payload of one statement a·b ≡ r (mod m)."""
    k = 16 if m.bit_length() <= 256 else 24
    return ([modmul_class(m)] + u16le_limbs(a, k) + u16le_limbs(b, k)
            + u16le_limbs(r, k))


# backward-compatible aliases (round-1 API)
def ModMul256Air() -> ModMulAir:  # noqa: N802 — kept as a constructor shim
    return modmul_air_256()


def modmul_trace(events, min_log_n: int = 8):
    return modmul_air_256().trace(events, min_log_n=min_log_n)
