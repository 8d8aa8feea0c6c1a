"""EC schedule AIR chip — composes the recorded modular multiplications
into proven short-Weierstrass scalar-multiplication ladders.

The reference proves EC arithmetic with the sp1-curves precompile chips
whose events the CPU chip consumes via lookups (SURVEY.md §2.2.B,
`Cargo.lock:5895`); here the equivalent composition is the global bus:
the ModMul width chips publish every proven statement a·b ≡ r (mod m)
(BUS_MODMUL, stark/chips/modmul.py), and this chip's ladder rows consume
exactly the statements of the double-and-add group law — turning "a pile
of isolated mulmods" into "result = d·base on this curve".

Row structure (mirrors guest/crypto/ec.py Curve.mul, LSB-first
double-and-add — witness generation re-runs the same code, so the
consumed multiset matches the replay's recorded events exactly):

  one row per scalar bit; consecutive rows of a ladder are ADJACENT
  (state chains through transition constraints, not bus messages).
  Each row holds up to TWO lanes sharing the same bit column — the
  dual-lane form proves the ECDHE pair (d·G, d·S) with the SAME secret
  scalar structurally, with no scalar-equality argument needed.

  Per lane and row:  R' = bit ? (R + A) : R   and   A' = 2·A,
  where the adds/doublings consume the recorded mulmod statements
  (slope inversions a·a⁻¹ ≡ 1, slope products, m², m·(x1−x3)) and the
  modular additions/subtractions between them are proven in-row by
  linear limb gadgets with byte-checked carries.  No limb of any
  coordinate needs an in-chip range check: every value is either pinned
  by a BUS_MODMUL receive to the ModMul chip's byte-checked canonical
  limbs, or flows into one on a later row; the final result's limbs are
  range-pinned by its consumer (the key-schedule chip's byte
  decomposition or the verifier's public receive).

  Start rows set R = infinity; a public base (G) is pinned by consuming
  the verifier-sent BUS_EC_BASE declaration; a witness base (the
  server's key-exchange point S) stays free — binding S to the
  handshake transcript is the documented transcript-locator gap.  Final
  rows publish (rid, cls, n_bits, x, y) on BUS_EC_RESULT with a
  witnessed multiplicity for external consumers.

Infinity handling: R carries an `inf` flag (coords zero); A is never
infinity on prime-order curves (P-256, secp256k1 — and R = ±A is
impossible for partial scalars < 2^i, so the general-add branch is
total; the consumed slope-inversion statement proves x_A ≠ x_R).

Port copy of zktls_tpu.stark.chips.ec (same names and values; host code in
numpy).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ...guest.crypto.ec import P256, SECP256K1, Curve, Point
from ...ops.field_ref import P
from ..air import Air, AirBuilder
from ..bus import BUS_EC_BASE, BUS_EC_RESULT, BUS_MODMUL
from ..ext_val import ExtVal

__all__ = ["EcScheduleAir", "LadderJob", "ec_schedule_trace",
           "ec_base_message", "ec_result_payload", "EC_CURVES",
           "ec_curve_class"]

#: supported curves (one-hot cf columns, in this order) and their
#: BUS_MODMUL field-modulus classes (index in modmul.MODULI_256)
EC_CURVES: list[Curve] = [P256, SECP256K1]
_MOD_CLASS = [0, 2]          # MODULI_256.index(curve.p)
CAR_OFF = 16                 # carry offset: stored byte = carry + 16
NL = 16                      # u16 limbs per coordinate


def ec_curve_class(curve: Curve) -> int:
    return _MOD_CLASS[EC_CURVES.index(curve)]


def _u16(v: int) -> list[int]:
    return [(int(v) >> (16 * j)) & 0xFFFF for j in range(NL)]


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


#: the ten linear gadgets per lane: name → (output limb vector name).
#: identities (mod p, with byte-checked carries; see eval):
#:   num  = 3·xsq + a − k_num·p        dy  = 2·yA − w_dy·p
#:   xA2  = msq − 2·xA + k_xA2·p       tA  = xA − xA2 + w_tA·p
#:   yA2  = uA − yA + w_yA2·p          sx  = xA − xR + w_sx·p
#:   sy   = yA − yR + w_sy·p           xR2 = msqR − xR − xA + k_xR2·p
#:   tR   = xR − xR2 + w_tR·p          yR2 = uR − yR + w_yR2·p
_GADGETS = ["num", "dy", "xA2", "tA", "yA2", "sx", "sy", "xR2", "tR",
            "yR2"]

_LANE_VECS = ["xR", "yR", "xA", "yA", "xsq", "num", "dy", "inv", "m",
              "msq", "xA2", "tA", "uA", "yA2", "sx", "sy", "invd", "mR",
              "msqR", "xR2", "tR", "uR", "yR2"]
_LANE_BITS = ["infR", "infRo", "k_num0", "k_num1", "w_dy", "k_xA20",
              "k_xA21", "w_tA", "w_yA2", "w_sx", "w_sy", "k_xR20",
              "k_xR21", "w_tR", "w_yR2", "pb", "gb", "ga", "gd"]
_LANE_META = ["bid", "rid", "mres"]


#: gadget-INPUT limb vectors whose byte decomposition is range-checked at
#: use (gate: gd for yA, ga for xR/yR).  Every other vector is bounded by
#: a BUS_MODMUL receive (operands match the ModMul chip's byte-checked
#: canonical limbs) or by the next row's such receive via continuity —
#: without these three, a malicious prover could shift limbs by ±P and
#: break the linear gadgets' integer-identity argument.
_RANGE_VECS = [("yA", "gd"), ("xR", "ga"), ("yR", "ga")]


def _build_layout() -> _Layout:
    L = _Layout()
    # byte-checked columns FIRST (paired byte-table lookup, like ModMul)
    for lane in (1, 2):
        L.add(f"car{lane}", len(_GADGETS) * NL)
    for lane in (1, 2):
        for nm, _gate in _RANGE_VECS:
            L.add(f"b_{nm}{lane}", 2 * NL)
    # shared row metadata
    for nm in ("st", "fin", "live", "du", "nd", "b", "stp"):
        L.add(nm, 1)
    L.add("cf", len(EC_CURVES))
    L.add("mult", 1)                      # byte-table multiplicity
    for lane in (1, 2):
        for nm in _LANE_VECS:
            L.add(f"{nm}{lane}", NL)
        for nm in _LANE_BITS + _LANE_META:
            L.add(f"{nm}{lane}", 1)
    return L


LAYOUT = _build_layout()
N_LOOKUP = 2 * (len(_GADGETS) + len(_RANGE_VECS) * 2) * NL   # 512
N_PAIRS = N_LOOKUP // 2
#: perm ext elements: byte pairs ‖ inv_t ‖ s ‖ per-lane bus inverses
#: (5 dbl + 4 add + base + result = 11 each) ‖ u ‖ acc
N_BUS_INV = 11
PERM_EXTS = N_PAIRS + 2 + 2 * N_BUS_INV + 2


class EcScheduleAir(Air):
    width = LAYOUT.width
    num_public = 0
    max_constraint_degree = 3
    perm_width = 4 * PERM_EXTS
    num_perm_challenges = 2
    has_bus = True

    def periodic_columns(self) -> list:
        return [np.arange(256, dtype=np.uint32)]

    # ------------------------------------------------------------------

    def eval(self, b: AirBuilder) -> None:
        L = LAYOUT

        def col(name, nxt=False):
            src = b.next if nxt else b.local
            return src[L[name].start]

        def vec(name, nxt=False):
            return (b.next_group if nxt else b.local_group)(L[name])

        st, fin, live, du, nd = (col("st"), col("fin"), col("live"),
                                 col("du"), col("nd"))
        bit, stp = col("b"), col("stp")
        CF = b.local_group(L["cf"])
        ncur = len(EC_CURVES)
        b.assert_zero_vec(CF * (CF - 1), ncur)
        for c in (st, fin, live, du, nd, bit):
            b.assert_bool(c)
        # live = Σ cf (pad rows have no curve); dual lane only on live rows
        b.assert_zero(b.dot_const(CF, [1] * ncur) - live)
        b.assert_zero(du * (1 - live))
        b.assert_zero(nd * (1 - fin))      # no-double only on final rows
        b.assert_zero(fin * (1 - live))

        # ladder structure: continuation rows follow a live non-final row
        live_n, st_n = col("live", nxt=True), col("st", nxt=True)
        cont = live_n * (1 - st_n)         # next row continues a ladder
        b.when_first_row(live * (1 - st))  # a chain cannot begin mid-air
        b.when_transition(cont * (1 - live))
        b.when_transition(cont * fin)
        b.when_transition(live * (1 - fin) * (1 - live_n))
        b.when_last_row(live * (1 - fin))
        b.when_transition(cont * (col("stp", nxt=True) - stp - 1))
        b.when_transition(cont * (col("du", nxt=True) - du))
        CF_n = b.next_group(L["cf"])
        b.assert_zero_vec(cont * (CF_n - CF), ncur)
        b.assert_zero(st * stp)

        # curve constants selected by cf
        p_limbs = [[(c.p >> (16 * j)) & 0xFFFF for j in range(NL)]
                   for c in EC_CURVES]
        a_limbs = [[(c.a >> (16 * j)) & 0xFFFF for j in range(NL)]
                   for c in EC_CURVES]
        gx_limbs = [[(c.gx >> (16 * j)) & 0xFFFF for j in range(NL)]
                    for c in EC_CURVES]
        gy_limbs = [[(c.gy >> (16 * j)) & 0xFFFF for j in range(NL)]
                    for c in EC_CURVES]
        P_SEL = b.mat_const(CF, p_limbs)
        A_SEL = b.mat_const(CF, a_limbs)
        GX_SEL = b.mat_const(CF, gx_limbs)
        GY_SEL = b.mat_const(CF, gy_limbs)
        cls_expr = b.dot_const(CF, _MOD_CLASS)

        POW16 = 1 << 16

        for lane in (1, 2):
            ll = live if lane == 1 else du

            def v(nm, nxt=False):
                return vec(f"{nm}{lane}", nxt)

            def c1(nm, nxt=False):
                return col(f"{nm}{lane}", nxt)

            infR, infRo = c1("infR"), c1("infRo")
            for nm in _LANE_BITS:
                b.assert_bool(c1(nm))
            ga, gd = c1("ga"), c1("gd")
            b.assert_zero(ga - bit * (1 - infR) * ll)
            b.assert_zero(gd - ll * (1 - nd))
            # start state: R = infinity with zero coords, off-lane rows
            # carry no flags
            b.assert_zero(st * ll * (1 - infR))
            b.assert_zero(infR * (1 - ll))
            b.assert_zero_vec((st * ll) * v("xR"), NL)
            b.assert_zero_vec((st * ll) * v("yR"), NL)
            # generator-base pinning: gb carries along the ladder and, on
            # the start row, forces the addend to the curve's G — letting
            # consumers of the result trust "base was the generator"
            # without any verifier-side base declaration
            gb = c1("gb")
            b.assert_zero(gb * (1 - ll))
            b.assert_zero_vec((st * gb) * (v("xA") - GX_SEL), NL)
            b.assert_zero_vec((st * gb) * (v("yA") - GY_SEL), NL)
            # R output selection: copy / take A / real add
            b.assert_zero(infRo - (1 - bit) * infR)
            b.assert_zero(fin * infRo)
            b.assert_zero_vec((1 - bit) * (v("xR2") - v("xR")), NL)
            b.assert_zero_vec((1 - bit) * (v("yR2") - v("yR")), NL)
            b.assert_zero_vec((bit * infR) * (v("xR2") - v("xA")), NL)
            b.assert_zero_vec((bit * infR) * (v("yR2") - v("yA")), NL)

            # state continuity (adjacent rows of a ladder)
            cont_l = cont if lane == 1 else col("du", nxt=True) * (1 - st_n)
            b.assert_zero(cont_l * (c1("gb", nxt=True) - gb))
            b.assert_zero_vec(cont_l * (v("xR", nxt=True) - v("xR2")), NL)
            b.assert_zero_vec(cont_l * (v("yR", nxt=True) - v("yR2")), NL)
            b.assert_zero(cont_l * (c1("infR", nxt=True) - infRo))
            b.assert_zero_vec(cont_l * (v("xA", nxt=True) - v("xA2")), NL)
            b.assert_zero_vec(cont_l * (v("yA", nxt=True) - v("yA2")), NL)

            # ---- linear gadgets: out = terms (mod p), carries byte -----
            k_num = c1("k_num0") + 2 * c1("k_num1")
            k_xA2 = c1("k_xA20") + c1("k_xA21")
            k_xR2 = c1("k_xR20") + c1("k_xR21")
            gadget_terms = {
                "num": (gd, 3 * v("xsq") + A_SEL - k_num * P_SEL),
                "dy": (gd, 2 * v("yA") - c1("w_dy") * P_SEL),
                "xA2": (gd, v("msq") - 2 * v("xA") + k_xA2 * P_SEL),
                "tA": (gd, v("xA") - v("xA2") + c1("w_tA") * P_SEL),
                "yA2": (gd, v("uA") - v("yA") + c1("w_yA2") * P_SEL),
                "sx": (ga, v("xA") - v("xR") + c1("w_sx") * P_SEL),
                "sy": (ga, v("yA") - v("yR") + c1("w_sy") * P_SEL),
                "xR2": (ga, v("msqR") - v("xR") - v("xA")
                        + k_xR2 * P_SEL),
                "tR": (ga, v("xR") - v("xR2") + c1("w_tR") * P_SEL),
                "yR2": (ga, v("uR") - v("yR") + c1("w_yR2") * P_SEL),
            }
            # gadget-input range checks: gated byte decomposition against
            # the table-checked b_* columns (see _RANGE_VECS)
            for nm, gate_nm in _RANGE_VECS:
                gate = gd if gate_nm == "gd" else ga
                bs = L[f"b_{nm}{lane}"]
                lo = b.local_group(slice(bs.start, bs.stop, 2))
                hi = b.local_group(slice(bs.start + 1, bs.stop, 2))
                b.assert_zero_vec(gate * (v(nm) - lo - 256 * hi), NL)

            car_base = L[f"car{lane}"].start
            for gi, gname in enumerate(_GADGETS):
                gate, terms = gadget_terms[gname]
                out = v(gname)
                car = b.local_group(
                    slice(car_base + gi * NL, car_base + (gi + 1) * NL))
                c_here = car - CAR_OFF
                # limb 0 (no incoming carry)
                b.assert_zero(gate * (terms[0] - out[0]
                                      - POW16 * c_here[0]))
                # limbs 1..15
                c_prev = b.local_group(
                    slice(car_base + gi * NL, car_base + gi * NL + NL - 1)
                ) - CAR_OFF
                b.assert_zero_vec(
                    gate * (terms[slice(1, NL)] - out[slice(1, NL)]
                            + c_prev - POW16 * c_here[slice(1, NL)]),
                    NL - 1)
                # top carry must close the integer identity
                b.assert_zero(gate * c_here[NL - 1])

        # ---- byte-table LogUp over the carry columns (paired) ----------
        gamma = b.challenges[0]
        V = b.local_group(slice(0, N_LOOKUP))
        V1, V2 = V[0::2], V[1::2]
        W = b.perm_ext_group(N_PAIRS)
        G1 = gamma - ExtVal.from_base(V1)
        G2 = gamma - ExtVal.from_base(V2)
        pair_check = W * (G1 * G2) - 1
        for limb in pair_check.limbs():
            b.assert_zero_vec(limb, N_PAIRS)
        t_col = b.periodic[0]
        mult = col("mult")
        mult_n = col("mult", nxt=True)
        inv_t = b.perm_ext(N_PAIRS)
        inv_t_n = b.perm_ext(N_PAIRS, nxt=True)
        s = b.perm_ext(N_PAIRS + 1)
        s_n = b.perm_ext(N_PAIRS + 1, nxt=True)
        b.assert_ext_zero(inv_t * (gamma - ExtVal.from_base(t_col)) - 1)

        def row_term(V1v, V2v, Wv, mult_v, table_inv):
            prod = (gamma * 2 - ExtVal.from_base(V1v + V2v)) * Wv
            total = ExtVal(*[b.dot_const(limb, [1] * N_PAIRS)
                             for limb in prod.limbs()])
            return total - mult_v * table_inv

        b.assert_ext_zero((s - row_term(V1, V2, W, mult, inv_t))
                          * b.is_first_row)
        Vn = b.next_group(slice(0, N_LOOKUP))
        Wn = b.perm_ext_group(N_PAIRS, nxt=True)
        b.assert_ext_zero(
            (s_n - s - row_term(Vn[0::2], Vn[1::2], Wn, mult_n, inv_t_n))
            * b.is_transition)
        b.assert_ext_zero(s * b.is_last_row)

        # ---- bus: modmul receives + base receive + result send ---------
        def dpow(i):
            return b.challenges[1 + i]

        # memoized Σ δ^{off+j}·value_j partial sums (operand positions in
        # the BUS_MODMUL payload: a → 2.., b → 18.., r → 34..)
        memo: dict[tuple, ExtVal] = {}

        def psum(name_or_vec, off, lane=None):
            key = (name_or_vec, off, lane)
            if key not in memo:
                vcols = (vec(f"{name_or_vec}{lane}")
                         if isinstance(name_or_vec, str) else name_or_vec)
                acc = None
                for j in range(NL):
                    t = dpow(off + j) * vcols[j]
                    acc = t if acc is None else acc + t
                memo[key] = acc
            return memo[key]

        ONE_R = dpow(33)  # r = 1 payload: Σ δ^{34+j}·[1,0,…] = δ^34

        pe = [N_PAIRS + 2]  # next free perm ext index

        def next_inv():
            i = pe[0]
            pe[0] += 1
            return b.perm_ext(i), i

        u_terms = []
        base_mm = ExtVal.from_base(BUS_MODMUL) + dpow(0) * cls_expr
        for lane in (1, 2):
            def v(nm):
                return vec(f"{nm}{lane}")

            def c1(nm):
                return col(f"{nm}{lane}")

            ga, gd = c1("ga"), c1("gd")
            events = [
                # doubling: xsq, inv, slope, msq, u — payload element i
                # rides δ^{i+1} = dpow(i): a_j → dpow(1+j), b_j →
                # dpow(17+j), r_j → dpow(33+j)
                (gd, base_mm + psum("xA", 1, lane) + psum("xA", 17, lane)
                 + psum("xsq", 33, lane)),
                (gd, base_mm + psum("dy", 1, lane) + psum("inv", 17, lane)
                 + ONE_R),
                (gd, base_mm + psum("num", 1, lane)
                 + psum("inv", 17, lane) + psum("m", 33, lane)),
                (gd, base_mm + psum("m", 1, lane) + psum("m", 17, lane)
                 + psum("msq", 33, lane)),
                (gd, base_mm + psum("m", 1, lane) + psum("tA", 17, lane)
                 + psum("uA", 33, lane)),
                # add: inv, slope, msq, u
                (ga, base_mm + psum("sx", 1, lane)
                 + psum("invd", 17, lane) + ONE_R),
                (ga, base_mm + psum("sy", 1, lane)
                 + psum("invd", 17, lane) + psum("mR", 33, lane)),
                (ga, base_mm + psum("mR", 1, lane) + psum("mR", 17, lane)
                 + psum("msqR", 33, lane)),
                (ga, base_mm + psum("mR", 1, lane) + psum("tR", 17, lane)
                 + psum("uR", 33, lane)),
            ]
            for gate, fp in events:
                inv_e, _ = next_inv()
                b.assert_ext_zero(inv_e * (gamma - fp) - 1)
                u_terms.append(-gate * inv_e)
            # base declaration receive (public base, start rows only)
            pb = c1("pb")
            b.assert_zero(pb * (1 - st))
            b.assert_zero(pb * (1 - (live if lane == 1 else du)))
            fp_base = (ExtVal.from_base(BUS_EC_BASE) + dpow(0) * c1("bid")
                       + dpow(1) * cls_expr)
            for j in range(NL):
                fp_base = fp_base + dpow(2 + j) * v("xA")[j]
                fp_base = fp_base + dpow(18 + j) * v("yA")[j]
            inv_b, _ = next_inv()
            b.assert_ext_zero(inv_b * (gamma - fp_base) - 1)
            u_terms.append(-pb * inv_b)
            # result publication (final rows only: mres is pinned to zero
            # elsewhere, so a junk-lane or mid-ladder row cannot publish)
            mres = c1("mres")
            b.assert_zero(mres * (1 - fin))
            b.assert_zero(mres * (1 - (live if lane == 1 else du)))
            fp_res = (ExtVal.from_base(BUS_EC_RESULT) + dpow(0) * c1("rid")
                      + dpow(1) * cls_expr + dpow(2) * (stp + 1)
                      + dpow(3) * c1("gb"))
            for j in range(NL):
                fp_res = fp_res + dpow(4 + j) * v("xR2")[j]
                fp_res = fp_res + dpow(20 + j) * v("yR2")[j]
            inv_r, _ = next_inv()
            b.assert_ext_zero(inv_r * (gamma - fp_res) - 1)
            u_terms.append(mres * inv_r)

        u = b.perm_ext(pe[0])
        acc = b.perm_ext(pe[0] + 1)
        u_n = b.perm_ext(pe[0], nxt=True)
        acc_n = b.perm_ext(pe[0] + 1, nxt=True)
        u_def = u_terms[0]
        for t in u_terms[1:]:
            u_def = u_def + t
        b.assert_ext_zero(u - u_def)
        b.assert_ext_zero((acc - u) * b.is_first_row)
        b.assert_ext_zero((acc_n - acc - u_n) * b.is_transition)
        for ell in range(4):
            b.when_last_row(acc.c[ell] - b.public[ell])

    # ------------------------------------------------------------------

    def generate_perm_trace(self, main, publics, challenges):
        from ..bus import np_bus_inverse_terms
        from ..lookup import np_ext_inverse, np_ext_mul, np_logup_terms

        L = LAYOUT
        n = main.shape[0]
        gamma = challenges[0]

        # byte-pair inverses over the carry columns
        vals = main[:, :N_LOOKUP].astype(np.uint64)
        g = np.array(gamma.c, dtype=np.uint64)
        gv = np.zeros((n * N_LOOKUP, 4), dtype=np.uint64)
        gv[:] = g[None, :]
        gv[:, 0] = (gv[:, 0] + P - (vals.reshape(-1) % P)) % P
        gv = gv.reshape(n, N_LOOKUP, 4)
        prod = np_ext_mul(gv[:, 0::2, :].reshape(-1, 4),
                          gv[:, 1::2, :].reshape(-1, 4))
        w = np_ext_inverse(prod).reshape(n, N_PAIRS, 4)
        two_g = np.zeros((n, N_PAIRS, 4), dtype=np.uint64)
        two_g[:] = (2 * g % P)[None, None, :]
        two_g[:, :, 0] = (two_g[:, :, 0] + 2 * P
                          - vals[:, 0::2] % P - vals[:, 1::2] % P) % P
        pair_terms = np_ext_mul(two_g.reshape(-1, 4),
                                w.reshape(-1, 4).astype(np.uint64))
        term = pair_terms.reshape(n, N_PAIRS, 4).sum(axis=1) % P
        t_in = np.arange(n, dtype=np.uint64) % 256
        inv_t = np_logup_terms(gamma, t_in, None, None, None)
        mult = main[:, L["mult"].start].astype(np.uint64)
        m_it = (inv_t.astype(np.uint64) * mult[:, None]) % P
        s = np.cumsum((term + P - m_it) % P, axis=0) % P

        # bus inverses
        def cvec(nm):
            return main[:, L[nm]].astype(np.uint64)

        def c1(nm):
            return main[:, L[nm].start].astype(np.uint64)

        cf = cvec("cf")
        cls = (cf * np.array(_MOD_CLASS, dtype=np.uint64)[None, :]).sum(
            axis=1)
        one_r = np.zeros((n, NL), dtype=np.uint64)
        one_r[:, 0] = 1
        parts = []
        u_acc = np.zeros((n, 4), dtype=np.uint64)
        for lane in (1, 2):
            def lv(nm, _l=lane):
                return cvec(f"{nm}{_l}")

            ga = c1(f"ga{lane}")
            gd = c1(f"gd{lane}")
            events = [
                (gd, lv("xA"), lv("xA"), lv("xsq")),
                (gd, lv("dy"), lv("inv"), one_r),
                (gd, lv("num"), lv("inv"), lv("m")),
                (gd, lv("m"), lv("m"), lv("msq")),
                (gd, lv("m"), lv("tA"), lv("uA")),
                (ga, lv("sx"), lv("invd"), one_r),
                (ga, lv("sy"), lv("invd"), lv("mR")),
                (ga, lv("mR"), lv("mR"), lv("msqR")),
                (ga, lv("mR"), lv("tR"), lv("uR")),
            ]
            for gate, a, bb_, r in events:
                pl = np.concatenate([cls[:, None], a, bb_, r], axis=1)
                inv_e = np_bus_inverse_terms(challenges, BUS_MODMUL, pl)
                parts.append(inv_e)
                u_acc = (u_acc + P
                         - (inv_e.astype(np.uint64) * gate[:, None]) % P
                         ) % P
            pb = c1(f"pb{lane}")
            pl_b = np.concatenate(
                [c1(f"bid{lane}")[:, None], cls[:, None],
                 lv("xA"), lv("yA")], axis=1)
            inv_b = np_bus_inverse_terms(challenges, BUS_EC_BASE, pl_b)
            parts.append(inv_b)
            u_acc = (u_acc + P
                     - (inv_b.astype(np.uint64) * pb[:, None]) % P) % P
            pl_r = np.concatenate(
                [c1(f"rid{lane}")[:, None], cls[:, None],
                 (c1("stp") + 1)[:, None], c1(f"gb{lane}")[:, None],
                 lv("xR2"), lv("yR2")], axis=1)
            inv_r = np_bus_inverse_terms(challenges, BUS_EC_RESULT, pl_r)
            parts.append(inv_r)
            fm = c1(f"mres{lane}") % P
            u_acc = (u_acc
                     + (inv_r.astype(np.uint64) * fm[:, None]) % P) % P
        acc = np.cumsum(u_acc, axis=0) % P

        out = np.zeros((n, self.perm_width), dtype=np.uint32)
        out[:, : 4 * N_PAIRS] = w.reshape(n, -1)
        out[:, 4 * N_PAIRS : 4 * N_PAIRS + 4] = inv_t
        out[:, 4 * (N_PAIRS + 1) : 4 * (N_PAIRS + 2)] = s.astype(np.uint64)
        off = 4 * (N_PAIRS + 2)
        for inv_e in parts:
            out[:, off : off + 4] = inv_e
            off += 4
        out[:, off : off + 4] = u_acc
        out[:, off + 4 : off + 8] = acc
        return out


# ---------------------------------------------------------------------------
# witness generation
# ---------------------------------------------------------------------------


@dataclass
class LadderJob:
    """One scalar multiplication (or a dual pair sharing the scalar)."""

    curve: Curve
    scalar: int
    base1: Point
    base2: Point | None = None
    pb1: bool = True          # base1 pinned by a verifier BUS_EC_BASE send
    pb2: bool = False
    gb1: bool = False         # base1 pinned in-chip to the curve generator
    gb2: bool = False
    bid1: int = 0
    bid2: int = 0
    rid1: int = 0
    rid2: int = 0
    mres1: int = 0            # result consumer counts
    mres2: int = 0


def ec_base_message(bid: int, curve: Curve, pt: Point) -> tuple:
    """Verifier-side BUS_EC_BASE send (mult +1) declaring a public base."""
    return (BUS_EC_BASE,
            [bid, ec_curve_class(curve)] + _u16(pt[0]) + _u16(pt[1]), 1)


def ec_result_payload(rid: int, curve: Curve, n_bits: int,
                      pt: Point, gbase: bool = False) -> list[int]:
    return ([rid, ec_curve_class(curve), n_bits, 1 if gbase else 0]
            + _u16(pt[0]) + _u16(pt[1]))


def _gadget_carries(term_limbs: list[int], out: int) -> list[int]:
    """Carries c_j for Σ_j term_limbs[j]·2^16j = out + (telescoped), i.e.
    per-limb: term_j + c_{j-1} − 2^16·c_j = out_j.  term_limbs are the
    SIGNED per-limb sums of the identity's left side."""
    carries = []
    c = 0
    for j in range(NL):
        d = term_limbs[j] + c - ((out >> (16 * j)) & 0xFFFF)
        assert d % (1 << 16) == 0, "gadget carry chain broke"
        c = d >> 16
        carries.append(c)
    assert c == 0, "gadget top carry nonzero"
    return carries


def _limb(v: int, j: int) -> int:
    return (v >> (16 * j)) & 0xFFFF


def _bytes32(v: int) -> list[int]:
    """Little-endian bytes (lo/hi interleaved per u16 limb)."""
    return [(int(v) >> (8 * i)) & 0xFF for i in range(2 * NL)]


def ec_schedule_trace(jobs: list[LadderJob], min_log_n: int = 8):
    """Build the EC schedule trace by re-running Curve.mul's double-and-
    add exactly (guest/crypto/ec.py), capturing per-row values and the
    consumed mulmod statements.

    Returns (trace, consumed) where consumed is the {(a, b, r, m): count}
    dict to pass to the ModMul chips' `sends`."""
    from collections import Counter

    rows: list[dict] = []
    consumed: Counter = Counter()

    for job in jobs:
        p = job.curve.p
        a_cur = job.curve.a
        k = job.scalar % job.curve.n
        if k == 0:
            raise ValueError("zero scalar has no ladder")
        nbits = k.bit_length()
        lanes = [dict(R=None, A=job.base1)]
        if job.base2 is not None:
            lanes.append(dict(R=None, A=job.base2))
        for i in range(nbits):
            bit = (k >> i) & 1
            row = dict(st=1 if i == 0 else 0,
                       fin=1 if i == nbits - 1 else 0,
                       live=1, du=1 if len(lanes) == 2 else 0, nd=0,
                       b=bit, stp=i,
                       cf=[1 if job.curve is c else 0 for c in EC_CURVES])
            for ln, lane in enumerate(lanes, start=1):
                d = _lane_step(job, lane, bit, p, a_cur, consumed)
                for nm, val in d.items():
                    row[f"{nm}{ln}"] = val
                gb = job.gb1 if ln == 1 else job.gb2
                if gb:
                    base = job.base1 if ln == 1 else job.base2
                    if base != job.curve.g:
                        raise ValueError("gb set but base is not G")
                    row[f"gb{ln}"] = 1
                if i == 0:
                    row[f"pb{ln}"] = 1 if (job.pb1 if ln == 1
                                           else job.pb2) else 0
                    row[f"bid{ln}"] = job.bid1 if ln == 1 else job.bid2
                if i == nbits - 1:
                    row[f"rid{ln}"] = job.rid1 if ln == 1 else job.rid2
                    row[f"mres{ln}"] = job.mres1 if ln == 1 else job.mres2
            rows.append(row)
        # sanity: ladder result matches Curve.mul
        for ln, lane in enumerate(lanes, start=1):
            base = job.base1 if ln == 1 else job.base2
            assert lane["R"] == job.curve.mul(job.scalar, base)

    n_real = len(rows)
    log_n = max(min_log_n, 8, (n_real - 1).bit_length())
    n = 1 << log_n
    trace = np.zeros((n, LAYOUT.width), dtype=np.uint32)
    car_vals = []
    for r, row in enumerate(rows):
        for nm, val in row.items():
            if nm == "cf":
                for c, fv in enumerate(val):
                    trace[r, LAYOUT["cf"].start + c] = fv
            elif nm.startswith("car"):
                sl = LAYOUT[nm]
                arr = np.asarray(val, dtype=np.int64) + CAR_OFF
                if (arr < 0).any() or (arr > 255).any():
                    raise ValueError("carry out of byte range")
                trace[r, sl] = arr.astype(np.uint32)
            elif isinstance(val, list):
                trace[r, LAYOUT[nm]] = np.asarray(val, dtype=np.uint32)
            else:
                trace[r, LAYOUT[nm].start] = int(val) % P
    # pad rows keep zero carries → stored value CAR_OFF?  No: gadget
    # gates are zero there, and zero bytes are valid table entries, so
    # leave them zero.
    lookup_vals = trace[:, :N_LOOKUP].reshape(-1)
    counts = np.bincount(lookup_vals, minlength=256)
    trace[:256, LAYOUT["mult"].start] = counts[:256].astype(np.uint32)
    return trace, dict(consumed)


def _lane_step(job, lane, bit, p, a_cur, consumed):
    """One (conditional add + double) step of one lane; mutates lane
    R/A, records consumed statements, returns the row's lane columns."""
    R, A = lane["R"], lane["A"]
    xA, yA = A
    d: dict = {"infR": 0 if R is not None else 1,
               "xA": _u16(xA), "yA": _u16(yA)}
    if R is not None:
        d["xR"], d["yR"] = _u16(R[0]), _u16(R[1])
    else:
        d["xR"], d["yR"] = _u16(0), _u16(0)

    # conditional add part
    if bit and R is not None:
        xR, yR = R
        if xR == xA:
            raise ValueError("degenerate add in ladder (non-prime order?)")
        sx = (xA - xR) % p
        invd = pow(sx, -1, p)
        sy = (yA - yR) % p
        mR = sy * invd % p
        msqR = mR * mR % p
        xR2 = (msqR - xR - xA) % p
        tR = (xR - xR2) % p
        uR = mR * tR % p
        yR2 = (uR - yR) % p
        consumed[(sx, invd, 1, p)] += 1
        consumed[(sy, invd, mR, p)] += 1
        consumed[(mR, mR, msqR, p)] += 1
        consumed[(mR, tR, uR, p)] += 1
        # gadget witnesses
        w_sx = 1 if xA - xR < 0 else 0
        w_sy = 1 if yA - yR < 0 else 0
        k_xR2 = (xR2 - (msqR - xR - xA)) // p
        w_tR = 1 if xR - xR2 < 0 else 0
        w_yR2 = 1 if uR - yR < 0 else 0
        d.update(sx=_u16(sx), sy=_u16(sy), invd=_u16(invd), mR=_u16(mR),
                 msqR=_u16(msqR), xR2=_u16(xR2), tR=_u16(tR), uR=_u16(uR),
                 yR2=_u16(yR2), w_sx=w_sx, w_sy=w_sy, w_tR=w_tR,
                 w_yR2=w_yR2, k_xR20=min(k_xR2, 1),
                 k_xR21=max(k_xR2 - 1, 0), ga=1,
                 b_xR=_bytes32(xR), b_yR=_bytes32(yR))
        car_add = {
            "sx": [_limb(xA, j) - _limb(xR, j) + w_sx * _limb(p, j)
                   for j in range(NL)],
            "sy": [_limb(yA, j) - _limb(yR, j) + w_sy * _limb(p, j)
                   for j in range(NL)],
            "xR2": [_limb(msqR, j) - _limb(xR, j) - _limb(xA, j)
                    + k_xR2 * _limb(p, j) for j in range(NL)],
            "tR": [_limb(xR, j) - _limb(xR2, j) + w_tR * _limb(p, j)
                   for j in range(NL)],
            "yR2": [_limb(uR, j) - _limb(yR, j) + w_yR2 * _limb(p, j)
                    for j in range(NL)],
        }
        gadget_outs_add = {"sx": sx, "sy": sy, "xR2": xR2, "tR": tR,
                           "yR2": yR2}
        R_new = (xR2, yR2)
    else:
        d.update(ga=0)
        d["xR2"], d["yR2"] = (d["xA"], d["yA"]) if bit else (d["xR"],
                                                             d["yR"])
        car_add = {nm: [0] * NL for nm in ("sx", "sy", "xR2", "tR",
                                           "yR2")}
        gadget_outs_add = None
        R_new = A if bit else R
    d["infRo"] = 0 if (bit or R is not None) else 1
    if not bit and R is None:
        R_new = None

    # doubling part (always, matching Curve.mul)
    xsq = xA * xA % p
    num_i = 3 * xsq + a_cur
    num = num_i % p
    dy_i = 2 * yA
    dy = dy_i % p
    inv = pow(dy, -1, p)
    m = num * inv % p
    msq = m * m % p
    xA2 = (msq - 2 * xA) % p
    tA = (xA - xA2) % p
    uA = m * tA % p
    yA2 = (uA - yA) % p
    consumed[(xA, xA, xsq, p)] += 1
    consumed[(dy, inv, 1, p)] += 1
    consumed[(num, inv, m, p)] += 1
    consumed[(m, m, msq, p)] += 1
    consumed[(m, tA, uA, p)] += 1
    k_num = (num - num_i) // -p if num_i >= num else 0
    k_num = (num_i - num) // p
    w_dy = (dy_i - dy) // p
    k_xA2 = (xA2 - (msq - 2 * xA)) // p
    w_tA = 1 if xA - xA2 < 0 else 0
    w_yA2 = 1 if uA - yA < 0 else 0
    d.update(xsq=_u16(xsq), num=_u16(num), dy=_u16(dy), inv=_u16(inv),
             m=_u16(m), msq=_u16(msq), xA2=_u16(xA2), tA=_u16(tA),
             uA=_u16(uA), yA2=_u16(yA2),
             k_num0=k_num & 1, k_num1=(k_num >> 1) & 1,  # k = k0 + 2·k1
             w_dy=w_dy, k_xA20=min(k_xA2, 1), k_xA21=max(k_xA2 - 1, 0),
             w_tA=w_tA, w_yA2=w_yA2, gd=1, b_yA=_bytes32(yA))
    car_dbl = {
        "num": [3 * _limb(xsq, j) + _limb(a_cur, j) - k_num * _limb(p, j)
                for j in range(NL)],
        "dy": [2 * _limb(yA, j) - w_dy * _limb(p, j) for j in range(NL)],
        "xA2": [_limb(msq, j) - 2 * _limb(xA, j) + k_xA2 * _limb(p, j)
                for j in range(NL)],
        "tA": [_limb(xA, j) - _limb(xA2, j) + w_tA * _limb(p, j)
               for j in range(NL)],
        "yA2": [_limb(uA, j) - _limb(yA, j) + w_yA2 * _limb(p, j)
                for j in range(NL)],
    }
    gadget_outs = {"num": num, "dy": dy, "xA2": xA2, "tA": tA,
                   "yA2": yA2}
    car = []
    for gname in _GADGETS:
        if gname in car_dbl:
            car.extend(_gadget_carries(car_dbl[gname],
                                       gadget_outs[gname]))
        elif gadget_outs_add is not None:
            car.extend(_gadget_carries(car_add[gname],
                                       gadget_outs_add[gname]))
        else:
            car.extend([0] * NL)
    d["car"] = car

    lane["R"] = R_new
    lane["A"] = (xA2, yA2)
    return d
