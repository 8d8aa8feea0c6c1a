"""Groth16 wrap of the BN-committed machine STARK: the machine verifier
under stark/machine_bn.py's MiMC scheme arithmetized into R1CS over the
BN254 scalar field.

The circuit re-runs the verifier body of stark/machine.py under MIMC
(verify_machine_bn) gate for gate (MiMC transcript +
Merkle paths natively; Baby-Bear algebra emulated with lazy-reduction
integer tracking), so a Groth16 proof exists ONLY if a valid shrink-layer
STARK exists behind the public statement digest.  Combined with the
recursion chain (machine → compress → shrink), the on-chain seal carries
full session soundness instead of journal knowledge.

Cost discipline:
  * Baby-Bear values ride as bound-tracked integers; reductions mod P
    (bit decompositions) happen only at protocol comparison points;
  * α/β folds use a 32-entry power table + chunked Horner, so the number
    of in-circuit modular reductions is #constraints/32, not
    #constraints;
  * every Fiat-Shamir sample pays one strict 254-bit decomposition
    (canonical — otherwise a prover could grind two bit patterns per
    sample);
  * MiMC permutations are 3 constraints per round (x², x⁴, x⁵).

The public input is ONE field element: the MP-MiMC digest of the
statement (binding bytes ‖ session bus-message values ‖ vk roots),
computed host-side by statement_digest_fr — the circuit hashes the SAME
witness wires its transcript and bus checks consume, so the proof binds
the exact session.

Port copy of zktls_tpu.snark.stark_wrap (same names, constraints and
assignment): it runs over the port's MachineProofBN, commit_bn and AIRs,
and gives the reference's R1CS constraint for constraint on the same
proof.  Host Python, as in the reference.
"""

from __future__ import annotations

from ..ops.field_ref import P, W_EXT, two_adic_root
from ..stark.commit_bn import PACK_RATE
from ..stark.config import StarkConfig
from ..stark.machine_bn import BN_DOMAIN_TAG, MachineProofBN
from ..stark.machine import _machine_order
from .bn254 import R
from .r1cs import R1CS
from .wrap import MIMC_ROUND_CONSTANTS

__all__ = ["build_stark_wrap_circuit", "statement_digest_fr"]

_MASK64 = (1 << 64) - 1


# ---------------------------------------------------------------------------
# wire-backed values
# ---------------------------------------------------------------------------


class W:
    """A linear combination over R1CS wires with its exact integer value
    and bit bound.  Baby-Bear emulation: `val` is the true non-negative
    integer (< 2^bound ≤ 2^252, so no Fr wraparound); residues mod P are
    what the protocol means."""

    __slots__ = ("lc", "val", "bound")

    def __init__(self, lc, val, bound):
        self.lc = lc
        self.val = int(val)
        self.bound = bound


class Fr:
    """A full-field value (MiMC state / digests): mod-R semantics, never
    bit-decomposed except via strict decomposition."""

    __slots__ = ("lc", "val")

    def __init__(self, lc, val):
        self.lc = lc
        self.val = int(val) % R


def _lc_add(a: dict, b: dict) -> dict:
    out = dict(a)
    for k, v in b.items():
        out[k] = (out.get(k, 0) + v) % R
    return out


def _lc_scale(a: dict, c: int) -> dict:
    c %= R
    return {k: v * c % R for k, v in a.items()}


class Ctx:
    def __init__(self, cs: R1CS):
        self.cs = cs
        self.n_reduce = 0

    # -- generic ---------------------------------------------------------

    def const(self, c: int) -> W:
        c = int(c)
        return W({0: c % R}, c, max(c.bit_length(), 1))

    def fr_const(self, c: int) -> Fr:
        return Fr({0: int(c) % R}, c)

    def add(self, *ws) -> W:
        lc = {}
        val = 0
        bound = 0
        for w_ in ws:
            lc = _lc_add(lc, w_.lc)
            val += w_.val
            bound = max(bound, w_.bound)
        return W(lc, val, bound + max(len(ws).bit_length() - 1, 1))

    def scale(self, a: W, c: int) -> W:
        return W(_lc_scale(a.lc, c), a.val * c,
                 a.bound + int(c).bit_length())

    def mul(self, a: W, b: W) -> W:
        idx = self.cs.mul(a.lc, b.lc)
        return W({idx: 1}, a.val * b.val, a.bound + b.bound)

    def fr_add(self, a: Fr, b: Fr) -> Fr:
        return Fr(_lc_add(a.lc, b.lc), a.val + b.val)

    def fr_mul(self, a: Fr, b: Fr) -> Fr:
        idx = self.cs.mul(a.lc, b.lc)
        return Fr({idx: 1}, a.val * b.val % R)

    def fr_eq(self, a: Fr, b: Fr) -> None:
        assert a.val == b.val, "fr_eq witness mismatch"
        self.cs.enforce_eq(a.lc, b.lc)

    # -- bit decomposition ----------------------------------------------

    def bits(self, a: W, n: int) -> list[W]:
        """n bool wires with Σ 2^i·b_i == a (a.val must fit)."""
        assert a.val < (1 << n), (a.val.bit_length(), n)
        out = []
        comp = {}
        for i in range(n):
            bv = (a.val >> i) & 1
            idx = self.cs.witness(bv)
            self.cs.constrain({idx: 1}, {idx: 1, 0: R - 1}, {})
            comp[idx] = 1 << i
            out.append(W({idx: 1}, bv, 1))
        self.cs.enforce_eq(comp, a.lc)
        return out

    def from_bits(self, bits: list[W], scale: int = 1) -> W:
        lc = {}
        val = 0
        for i, b_ in enumerate(bits):
            lc = _lc_add(lc, _lc_scale(b_.lc, scale << i))
            val += b_.val << i
        return W(lc, val * scale, len(bits) + int(scale).bit_length())

    def fr_bits_strict(self, a: Fr) -> list[W]:
        """Canonical 254-bit decomposition of a full-field value: bits
        recompose to a AND encode an integer < R (otherwise a prover
        could pick a+R's bits and fork the Fiat-Shamir stream)."""
        out = []
        comp = {}
        for i in range(254):
            bv = (a.val >> i) & 1
            idx = self.cs.witness(bv)
            self.cs.constrain({idx: 1}, {idx: 1, 0: R - 1}, {})
            comp[idx] = 1 << i
            out.append(W({idx: 1}, bv, 1))
        self.cs.enforce_eq(comp, a.lc)
        # value < R: scan from the top bit of R; maintain "all equal so
        # far" flag; at R's zero-bits, eq∧bit ⇒ value larger — forbid
        eq = self.const(1)
        for i in range(253, -1, -1):
            rbit = (R >> i) & 1
            b_ = out[i]
            if rbit:
                # eq' = eq·b (stays on R's prefix only if bit set)
                eq = self.mul(eq, b_)
            else:
                # if still on the prefix, this bit must be 0
                t = self.mul(eq, b_)
                self.cs.enforce_eq(t.lc, {})
        return out

    # -- Baby-Bear reduction --------------------------------------------

    def reduce(self, a: W) -> W:
        """a → r with r ≡ a (mod P), r < 2^31 (canonical witness)."""
        if a.bound <= 31:
            return a
        self.n_reduce += 1
        q, r = divmod(a.val, P)
        qb = max(a.bound - 30, 1)
        qw = W({self.cs.witness(q % R): 1}, q, qb)
        self.bits(qw, qb)
        rw = W({self.cs.witness(r): 1}, r, 31)
        self.bits(rw, 31)
        self.cs.enforce_eq(
            _lc_add(_lc_scale(qw.lc, P), rw.lc), a.lc)
        return W(rw.lc, r, 31)

    def assert_zero_mod(self, a: W) -> None:
        assert a.val % P == 0, "assert_zero_mod witness nonzero"
        q = a.val // P
        qb = max(a.bound - 30, 1)
        qw = W({self.cs.witness(q % R): 1}, q, qb)
        self.bits(qw, qb)
        self.cs.enforce_eq(_lc_scale(qw.lc, P), a.lc)

    def assert_eq_mod(self, a: W, b: W) -> None:
        # a − b + K·P ≥ 0 with K·P ≥ 2^b.bound
        k = (1 << max(b.bound - 30, 1)) + 1
        diff = W(_lc_add(a.lc, _lc_scale(b.lc, R - 1)),
                 a.val - b.val + k * P, 0)
        diff.lc = _lc_add(diff.lc, {0: (k * P) % R})
        diff.bound = max(a.bound, b.bound) + 33
        self.assert_zero_mod(diff)

    # -- extension field --------------------------------------------------

    def ext_mul(self, a: list[W], b: list[W]) -> list[W]:
        prod = [None] * 7
        for i in range(4):
            for j in range(4):
                t = self.mul(a[i], b[j])
                prod[i + j] = t if prod[i + j] is None \
                    else self.add(prod[i + j], t)
        out = []
        for k in range(4):
            v = prod[k]
            if k + 4 <= 6 and prod[k + 4] is not None:
                v = self.add(v, self.scale(prod[k + 4], W_EXT))
            out.append(v)
        return out

    def ext_add(self, a, b):
        return [self.add(a[i], b[i]) for i in range(4)]

    def ext_sub(self, a, b):
        # a − b + K·P lane-wise (keep values non-negative)
        out = []
        for i in range(4):
            k = (1 << max(b[i].bound - 30, 1)) + 1
            lc = _lc_add(a[i].lc, _lc_scale(b[i].lc, R - 1))
            lc = _lc_add(lc, {0: (k * P) % R})
            out.append(W(lc, a[i].val - b[i].val + k * P,
                         max(a[i].bound, b[i].bound) + 33))
        return out

    def ext_scale_int(self, a, c: int):
        return [self.scale(a[i], c) for i in range(4)]

    def ext_reduce(self, a):
        return [self.reduce(x) for x in a]

    def ext_assert_eq_mod(self, a, b) -> None:
        for i in range(4):
            self.assert_eq_mod(a[i], b[i])

    def ext_const(self, fp4) -> list[W]:
        return [self.const(int(x)) for x in fp4.c]

    def ext_inv_witness(self, a) -> list[W]:
        """Witness 1/a and constrain a·w ≡ 1 (mod P) limb-wise."""
        from ..ops.field_ref import Fp4

        av = Fp4(*[x.val % P for x in a])
        wv = av.inv()
        wit = [W({self.cs.witness(int(x)): 1}, int(x), 31) for x in wv.c]
        for x in wit:
            self.bits(x, 31)
        prod = self.ext_mul(a, wit)
        one = [self.const(1), self.const(0), self.const(0), self.const(0)]
        self.ext_assert_eq_mod(prod, one)
        return wit

    # -- MiMC --------------------------------------------------------------

    def mimc_perm(self, m: Fr, k: Fr) -> Fr:
        x = m
        for c in MIMC_ROUND_CONSTANTS:
            t = Fr(_lc_add(_lc_add(x.lc, k.lc), {0: c}),
                   x.val + k.val + c)
            x2 = self.fr_mul(t, t)
            x4 = self.fr_mul(x2, x2)
            x = self.fr_mul(x4, t)
        return x

    def mp_step(self, h: Fr, m: Fr) -> Fr:
        p = self.mimc_perm(m, h)
        return Fr(_lc_add(_lc_add(p.lc, h.lc), m.lc),
                  p.val + h.val + m.val)


# ---------------------------------------------------------------------------
# in-circuit challenger (mirrors stark.commit_bn.FrChallenger)
# ---------------------------------------------------------------------------


class ChC:
    def __init__(self, ctx: Ctx):
        self.ctx = ctx
        self.h = ctx.fr_const(0)
        self.buf: list[W] = []

    def _step(self, e: Fr) -> None:
        self.h = self.ctx.mp_step(self.h, e)

    def flush(self) -> None:
        if self.buf:
            lc = {}
            val = 0
            for i, w_ in enumerate(self.buf):
                r = self.ctx.reduce(w_) if w_.bound > 31 else w_
                lc = _lc_add(lc, _lc_scale(r.lc, 1 << (32 * i)))
                val += (r.val % P if r.bound > 31 else r.val) << (32 * i)
            # reduced values are < 2^31 < 2^32: packing is exact
            self._step(Fr(lc, val))
            self.buf = []

    def observe(self, w_: W) -> None:
        # canonical residue in the transcript (host packs v % P)
        r = self.ctx.reduce(w_)
        self.buf.append(W(r.lc, r.val % P if r.bound > 31 else r.val, 31))
        if len(self.buf) == PACK_RATE:
            self.flush()

    def observe_many(self, ws) -> None:
        for w_ in ws:
            self.observe(w_)

    def observe_fr(self, x: Fr) -> None:
        self.flush()
        self._step(x)

    def observe_const_bytes(self, data: bytes) -> None:
        self.flush()
        self._step(self.ctx.fr_const(len(data)))
        for i in range(0, len(data), 28):
            self._step(self.ctx.fr_const(
                int.from_bytes(data[i : i + 28], "big")))

    def sample_fr(self) -> Fr:
        self.flush()
        self._step(self.ctx.fr_const((1 << 248) + 1))
        return self.h

    def sample_ext(self) -> list[W]:
        y = self.sample_fr()
        bits = self.ctx.fr_bits_strict(y)
        return [self.ctx.from_bits(bits[62 * i : 62 * i + 62])
                for i in range(4)]

    def sample_index_bits(self, k: int) -> list[W]:
        y = self.sample_fr()
        bits = self.ctx.fr_bits_strict(y)
        return bits[:k]

    def check_witness_zero(self, pow_bits: int, w_: W) -> None:
        self.observe(w_)
        if pow_bits:
            y = self.sample_fr()
            bits = self.ctx.fr_bits_strict(y)
            lc = {}
            val = 0
            for b_ in bits[:pow_bits]:
                lc = _lc_add(lc, b_.lc)
                val += b_.val
            assert val == 0, "grinding check fails in witness"
            self.ctx.cs.enforce_eq(lc, {})


# ---------------------------------------------------------------------------
# Merkle / packing
# ---------------------------------------------------------------------------


def _leaf_digest_c(ctx: Ctx, row: list[W]) -> Fr:
    h = ctx.fr_const(0)
    for j in range(0, len(row), PACK_RATE):
        lc = {}
        val = 0
        for i, w_ in enumerate(row[j : j + PACK_RATE]):
            lc = _lc_add(lc, _lc_scale(w_.lc, 1 << (32 * i)))
            val += w_.val << (32 * i)
        h = ctx.mp_step(h, Fr(lc, val))
    return h


def _verify_path_c(ctx: Ctx, leaf: Fr, index_bits: list[W],
                   path: list[Fr], root: Fr) -> None:
    node = leaf
    for level, sib in enumerate(path):
        bit = index_bits[level]
        # l = sel(bit, sib, node); r = sel(bit, node, sib)
        # sel(b, x, y) = y + b·(x−y)
        d_ln = Fr(_lc_add(sib.lc, _lc_scale(node.lc, R - 1)),
                  sib.val - node.val)
        t = ctx.cs.mul(bit.lc, d_ln.lc)
        left = Fr(_lc_add(node.lc, {t: 1}),
                  (node.val + bit.val * (sib.val - node.val)) % R)
        d_rn = Fr(_lc_add(node.lc, _lc_scale(sib.lc, R - 1)),
                  node.val - sib.val)
        t2 = ctx.cs.mul(bit.lc, d_rn.lc)
        right = Fr(_lc_add(sib.lc, {t2: 1}),
                   (sib.val + bit.val * (node.val - sib.val)) % R)
        h = ctx.fr_const(0)
        h = ctx.mp_step(h, left)
        h = ctx.mp_step(h, right)
        node = h
    ctx.fr_eq(node, root)


# ---------------------------------------------------------------------------
# chunked-Horner fold over a power table
# ---------------------------------------------------------------------------


class PowerFold:
    """Σ αⁱ·eᵢ with a 32-entry power table: terms are grouped in chunks
    of 32, each chunk folded with table powers (plain ext muls, no
    reductions), chunks combined by Horner in α³² (one reduction per
    chunk).  Reduction count: #terms/32 + 32, instead of #terms."""

    CHUNK = 32

    def __init__(self, ctx: Ctx, alpha: list[W]):
        self.ctx = ctx
        a = ctx.ext_reduce(alpha)
        self.table = [[ctx.const(1), ctx.const(0), ctx.const(0),
                       ctx.const(0)]]
        for _ in range(self.CHUNK):
            nxt = ctx.ext_reduce(ctx.ext_mul(self.table[-1], a))
            self.table.append(nxt)
        self.alpha_chunk = self.table[self.CHUNK]   # α^32, reduced
        self.chunks: list[list] = [[]]

    def feed(self, e: list[W]) -> None:
        if len(self.chunks[-1]) == self.CHUNK:
            self.chunks.append([])
        self.chunks[-1].append(e)

    def result(self) -> list[W]:
        ctx = self.ctx
        acc = None
        # Horner over chunks from the LAST chunk down
        for chunk in reversed(self.chunks):
            part = None
            for i, e in enumerate(chunk):
                term = ctx.ext_mul(self.table[i], e)
                part = term if part is None else ctx.ext_add(part, term)
            if part is None:
                part = [ctx.const(0)] * 4
            if acc is None:
                acc = part
            else:
                acc = ctx.ext_add(
                    ctx.ext_mul(ctx.ext_reduce(acc), self.alpha_chunk),
                    part)
        return acc if acc is not None else [ctx.const(0)] * 4


# ---------------------------------------------------------------------------
# the wrap circuit
# ---------------------------------------------------------------------------


def statement_digest_fr(binding: bytes, public_messages: list[tuple],
                        vk_roots: dict[str, int]) -> int:
    """Host-side statement digest: MP-MiMC over binding chunks, every
    session message value, and the vk roots — exactly the chain the
    circuit recomputes over its witness wires."""
    from .wrap import _perm

    def step(h, m):
        m %= R
        return (_perm(m, h) + h + m) % R

    h = 0
    h = step(h, len(binding))
    for i in range(0, len(binding), 28):
        h = step(h, int.from_bytes(binding[i : i + 28], "big"))
    h = step(h, len(public_messages))
    for entry in public_messages:
        tag, payload = entry[0], entry[1]
        mult = entry[2] if len(entry) > 2 else -1
        h = step(h, (tag << 8) + (mult % 256))
        for block in range(0, len(payload), PACK_RATE):
            e = 0
            for i, v in enumerate(payload[block : block + PACK_RATE]):
                e |= (int(v) % P) << (32 * i)
            h = step(h, e)
    for name in sorted(vk_roots):
        h = step(h, vk_roots[name])
    return h


def build_stark_wrap_circuit(airs, proof: MachineProofBN, binding: bytes,
                             public_messages: list[tuple],
                             config: StarkConfig,
                             preprocessed_roots: dict[str, int],
                             ) -> R1CS:
    """R1CS with ONE public input (the statement digest) that is
    satisfiable iff verify_machine_bn(airs, proof, binding,
    public_messages, config, preprocessed_roots) accepts.  Structure
    (chip set, sizes, message structure, vk roots) is baked into the
    circuit; session values (binding bytes, message payloads, the whole
    proof) are witness."""
    public_messages = public_messages or []
    cs = R1CS()
    ctx = Ctx(cs)
    stmt = cs.public_input(
        statement_digest_fr(binding, public_messages, preprocessed_roots))

    # --- witness the statement pieces & recompute the digest -------------
    bind_elems: list[Fr] = []
    for i in range(0, len(binding), 28):
        v = int.from_bytes(binding[i : i + 28], "big")
        bind_elems.append(Fr({cs.witness(v): 1}, v))
    msg_vals: list[list[W]] = []
    for entry in public_messages:
        payload = entry[1]
        row = []
        for v in payload:
            vv = int(v) % P
            w_ = W({cs.witness(vv): 1}, vv, 31)
            ctx.bits(w_, 31)
            row.append(w_)
        msg_vals.append(row)
    h = ctx.fr_const(0)
    h = ctx.mp_step(h, ctx.fr_const(len(binding)))
    for e in bind_elems:
        h = ctx.mp_step(h, e)
    h = ctx.mp_step(h, ctx.fr_const(len(public_messages)))
    for entry, row in zip(public_messages, msg_vals):
        tag = entry[0]
        mult = entry[2] if len(entry) > 2 else -1
        h = ctx.mp_step(h, ctx.fr_const((tag << 8) + (mult % 256)))
        for block in range(0, len(row), PACK_RATE):
            lc = {}
            val = 0
            for i, w_ in enumerate(row[block : block + PACK_RATE]):
                lc = _lc_add(lc, _lc_scale(w_.lc, 1 << (32 * i)))
                val += w_.val << (32 * i)
            h = ctx.mp_step(h, Fr(lc, val))
    for name in sorted(preprocessed_roots):
        h = ctx.mp_step(h, ctx.fr_const(preprocessed_roots[name]))
    ctx.fr_eq(h, Fr({stmt: 1}, statement_digest_fr(
        binding, public_messages, preprocessed_roots)))

    # --- geometry (static) ----------------------------------------------
    air_by_name = {a.name: a for a in airs}
    assert sorted(c.name for c in proof.chips) == sorted(air_by_name)
    expect = _machine_order(proof.chips,
                            lambda c: c.log_n + config.log_blowup,
                            lambda c: c.name)
    assert [c.name for c in proof.chips] == [c.name for c in expect]
    log_N_max = proof.chips[0].log_n + config.log_blowup
    geo = []
    for cp in proof.chips:
        air = air_by_name[cp.name]
        log_N = cp.log_n + config.log_blowup
        k = log_N_max - log_N
        s_i = pow(config.shift, 1 << k, P)
        geo.append((cp, air, 1 << cp.log_n, log_N, s_i))

    def wit_bb(v: int) -> W:
        vv = int(v) % P
        w_ = W({cs.witness(vv): 1}, vv, 31)
        ctx.bits(w_, 31)
        return w_

    def wit_ext(fp4) -> list[W]:
        return [wit_bb(int(x)) for x in fp4.c]

    def wit_fr(x: int) -> Fr:
        return Fr({cs.witness(int(x) % R): 1}, x)

    # --- transcript -------------------------------------------------------
    ch = ChC(ctx)
    ch.flush()
    ch._step(ctx.fr_const(len(BN_DOMAIN_TAG)))
    for i in range(0, len(BN_DOMAIN_TAG), 28):
        ch._step(ctx.fr_const(
            int.from_bytes(BN_DOMAIN_TAG[i : i + 28], "big")))
    ch._step(ctx.fr_const(len(binding)))
    for e in bind_elems:
        ch._step(e)
    ch.observe(ctx.const(len(proof.chips)))
    for cp, air, *_ in geo:
        ch.observe_const_bytes(cp.name.encode())
        ch.observe(ctx.const(cp.log_n))
        ch.observe(ctx.const(len(cp.publics)))
        ch.observe_many(ctx.const(int(v) % P) for v in cp.publics)
        if getattr(air, "preprocessed_width", 0):
            ch.observe_fr(ctx.fr_const(preprocessed_roots[cp.name]))
    troots = {}
    for cp in proof.chips:
        troots[cp.name] = wit_fr(cp.trace_root)
        ch.observe_fr(troots[cp.name])
    gamma = ch.sample_ext()
    delta = ch.sample_ext()
    from ..stark.bus import MAX_PAYLOAD

    dpows = [ctx.ext_reduce(delta)]
    for _ in range(1, MAX_PAYLOAD):
        dpows.append(ctx.ext_reduce(ctx.ext_mul(dpows[-1], dpows[0])))
    perm_roots = {}
    bus_sums = {}
    for cp, air, *_ in geo:
        if air.perm_width:
            perm_roots[cp.name] = wit_fr(cp.perm_root)
            ch.observe_fr(perm_roots[cp.name])
            bus_sums[cp.name] = [wit_bb(v) for v in cp.bus_sum]
            ch.observe_many(bus_sums[cp.name])
    alpha = ch.sample_ext()
    qroots = {}
    for cp in proof.chips:
        qroots[cp.name] = wit_fr(cp.quotient_root)
        ch.observe_fr(qroots[cp.name])
    zeta = ctx.ext_reduce(ch.sample_ext())
    evals = {}
    for cp, air, *_ in geo:
        ev = {}
        for key in ("tl", "tn", "pl", "pn", "qe", "el", "en"):
            rows = [wit_ext(v) for v in getattr(cp, key)]
            for r_ in rows:
                ch.observe_many(r_)
            ev[key] = rows
        evals[cp.name] = ev
    beta = ch.sample_ext()
    fold_betas = []
    n_layers = 0
    size = 1 << log_N_max
    while size > config.fri_final_size:
        size //= 2
        n_layers += 1
    assert len(proof.fri_roots) == n_layers
    assert len(proof.fri_final) == size
    fri_root_w = []
    for root in proof.fri_roots:
        rw = wit_fr(root)
        fri_root_w.append(rw)
        ch.observe_fr(rw)
        fold_betas.append(ctx.ext_reduce(ch.sample_ext()))
    final_w = []
    for v in proof.fri_final:
        e = wit_ext(v)
        ch.observe_many(e)
        final_w.append(e)
    pow_w = wit_bb(proof.pow_witness)
    ch.check_witness_zero(config.pow_bits, pow_w)
    q_bits = [ch.sample_index_bits(log_N_max)
              for _ in range(config.num_queries)]

    # --- global bus balance ----------------------------------------------
    total = [ctx.const(0)] * 4
    for cp in proof.chips:
        if cp.name in bus_sums:
            bs = bus_sums[cp.name]
            total = ctx.ext_add(total, bs)
    gam_r = ctx.ext_reduce(gamma)
    for entry, row in zip(public_messages, msg_vals):
        tag = entry[0]
        mult = entry[2] if len(entry) > 2 else -1
        fp = [ctx.const(tag), ctx.const(0), ctx.const(0), ctx.const(0)]
        for i, w_ in enumerate(row):
            fp = ctx.ext_add(fp, [ctx.mul(dpows[i][ell], w_)
                                  for ell in range(4)])
        denom = ctx.ext_sub(gam_r, ctx.ext_reduce(fp))
        term = ctx.ext_inv_witness(denom)
        if mult == 1:
            total = ctx.ext_add(total, term)
        elif mult == -1:
            total = ctx.ext_sub(total, term)
        else:
            total = ctx.ext_add(total, ctx.ext_scale_int(term, mult % P))
    for x in total:
        ctx.assert_zero_mod(x)

    # --- DEEP-ALI identity at ζ per chip ---------------------------------
    zeta_pow_cache: dict[int, list[W]] = {1: zeta}

    def zeta_pow(k: int) -> list[W]:
        if k not in zeta_pow_cache:
            half = zeta_pow(k // 2)
            sq = ctx.ext_reduce(ctx.ext_mul(half, half))
            zeta_pow_cache[k] = (
                ctx.ext_reduce(ctx.ext_mul(sq, zeta)) if k % 2 else sq)
        return zeta_pow_cache[k]

    one_e = [ctx.const(1), ctx.const(0), ctx.const(0), ctx.const(0)]
    g_zetas = {}
    for cp, air, n, log_N, s_i in geo:
        g = two_adic_root(cp.log_n)
        z_h = ctx.ext_sub(zeta_pow(n), one_e)
        g_last = pow(g, n - 1, P)
        den_first = ctx.ext_sub(zeta, one_e)
        den_last = ctx.ext_sub(zeta, ctx.ext_scale_int(one_e, g_last))
        inv_first = ctx.ext_inv_witness(den_first)
        inv_last = ctx.ext_inv_witness(den_last)
        sels = {
            "is_first_row": ctx.ext_reduce(ctx.ext_mul(z_h, inv_first)),
            "is_last_row": ctx.ext_reduce(ctx.ext_mul(z_h, inv_last)),
            "is_transition": ctx.ext_reduce(den_last),
        }
        periodic_at_zeta = []
        from ..ops.field_ref import Fp4 as _F

        for pattern in air.periodic_columns():
            m = len(pattern)
            # interpolant coefficients are constants; evaluate by Horner
            # in y = ζ^{n/m}
            w_r = two_adic_root(m.bit_length() - 1)
            w_inv = pow(w_r, P - 2, P)
            m_inv = pow(m, P - 2, P)
            coeffs = []
            for kk in range(m):
                step = pow(w_inv, kk, P)
                acc0 = 0
                wk = 1
                for j in range(m):
                    acc0 = (acc0 + int(pattern[j]) * wk) % P
                    wk = wk * step % P
                coeffs.append(acc0 * m_inv % P)
            y = zeta_pow(n // m)
            out = [ctx.const(coeffs[-1]), ctx.const(0), ctx.const(0),
                   ctx.const(0)]
            for c in reversed(coeffs[:-1]):
                out = ctx.ext_reduce(ctx.ext_mul(out, y))
                out = ctx.ext_add(out, [ctx.const(c), ctx.const(0),
                                        ctx.const(0), ctx.const(0)])
            periodic_at_zeta.append(out)
        ev = evals[cp.name]
        publics_full = ([ctx.const(int(v) % P) for v in cp.publics]
                        + bus_sums.get(cp.name, [ctx.const(0)] * 4))
        folded = _fold_constraints_r1cs(
            ctx, air, ev, publics_full, sels, alpha, periodic_at_zeta,
            dpows, gamma)
        zeta_n = zeta_pow(n)
        q_at = [ctx.const(0)] * 4
        zpow = one_e
        _EXT_BASIS = [_F(1), _F(0, 1), _F(0, 0, 1), _F(0, 0, 0, 1)]
        for k in range(config.blowup):
            chunk = [ctx.const(0)] * 4
            for ell in range(4):
                contrib = _ext_mul_const(ctx, ev["qe"][4 * k + ell],
                                         _EXT_BASIS[ell])
                chunk = ctx.ext_add(chunk, contrib)
            q_at = ctx.ext_add(q_at, ctx.ext_mul(zpow,
                                                 ctx.ext_reduce(chunk)))
            zpow = ctx.ext_reduce(ctx.ext_mul(zpow, zeta_n))
        rhs = ctx.ext_mul(ctx.ext_reduce(z_h), ctx.ext_reduce(q_at))
        ctx.ext_assert_eq_mod(folded, rhs)
        g_zetas[cp.name] = ctx.ext_reduce(
            ctx.ext_scale_int(zeta, two_adic_root(cp.log_n)))

    # --- per-query checks -------------------------------------------------
    bfold = PowerFold(ctx, beta)
    bpow_table = bfold.table       # β^0..32 reduced
    beta32 = bfold.alpha_chunk

    def _beta_sum(vals: list[list[W]]) -> list[W]:
        chunks = [vals[i : i + 32] for i in range(0, len(vals), 32)]
        acc = None
        for chunk in reversed(chunks):
            part = None
            for i, e in enumerate(chunk):
                term = ctx.ext_mul(bpow_table[i], e)
                part = term if part is None else ctx.ext_add(part, term)
            acc = part if acc is None else ctx.ext_add(
                ctx.ext_mul(ctx.ext_reduce(acc), beta32), part)
        return acc if acc is not None else [ctx.const(0)] * 4

    def to_ext(w_: W) -> list[W]:
        return [w_, ctx.const(0), ctx.const(0), ctx.const(0)]

    # per-chip eval-side β sums (query independent)
    ev_sums = {}
    for cp, air, n, log_N, s_i in geo:
        ev = evals[cp.name]
        ez = _beta_sum(ev["tl"] + ev["el"] + ev["pl"] + ev["qe"])
        egz = _beta_sum(ev["tn"] + ev["en"] + ev["pn"])
        ev_sums[cp.name] = (ez, egz)

    for qi, (mq, bits) in enumerate(zip(proof.queries, q_bits)):
        scaled: dict[int, list[W]] = {}
        row_concat_all: dict[str, list[W]] = {}
        for (cp, air, n, log_N, s_i), op in zip(geo, mq.openings):
            jbits = bits[:log_N]
            trow = [wit_bb(v) for v in op.trace_row]
            erow = [wit_bb(v) for v in op.pre_row]
            prow = [wit_bb(v) for v in op.perm_row]
            qrow = [wit_bb(v) for v in op.quotient_row]
            _verify_path_c(ctx, _leaf_digest_c(ctx, trow), jbits,
                           [wit_fr(h_) for h_ in op.trace_path],
                           troots[cp.name])
            _verify_path_c(ctx, _leaf_digest_c(ctx, qrow), jbits,
                           [wit_fr(h_) for h_ in op.quotient_path],
                           qroots[cp.name])
            if prow:
                _verify_path_c(ctx, _leaf_digest_c(ctx, prow), jbits,
                               [wit_fr(h_) for h_ in op.perm_path],
                               perm_roots[cp.name])
            if erow:
                _verify_path_c(ctx, _leaf_digest_c(ctx, erow), jbits,
                               [wit_fr(h_) for h_ in op.pre_path],
                               ctx.fr_const(preprocessed_roots[cp.name]))
            # DEEP: numerators via β sums over (row − eval)
            ez, egz = ev_sums[cp.name]
            row_z = trow + erow + prow + qrow
            row_gz = trow + erow + prow
            vz = _beta_sum([to_ext(w_) for w_ in row_z])
            vgz = _beta_sum([to_ext(w_) for w_ in row_gz])
            num_z = ctx.ext_sub(vz, ez)
            num_gz = ctx.ext_sub(vgz, egz)
            # x = s_i · g^j from index bits
            g_N = two_adic_root(log_N)
            x = to_ext(ctx.const(s_i))
            gp = g_N
            for b_ in jbits:
                # factor = 1 + b·(g^{2^i} − 1)
                f = ctx.add(ctx.const(1),
                            ctx.scale(b_, (gp - 1) % P))
                x = [ctx.mul(xx, f) for xx in x]
                x = ctx.ext_reduce(x)
                gp = gp * gp % P
            inv_xz = ctx.ext_inv_witness(ctx.ext_sub(x, zeta))
            inv_xgz = ctx.ext_inv_witness(
                ctx.ext_sub(x, g_zetas[cp.name]))
            # the g·ζ group's β powers continue at offset w_z within the
            # chip's slice (machine.py's global β budget), so scale
            # num_gz by β^{w_z}
            ew_c = getattr(air, "preprocessed_width", 0)
            w_z_c = air.width + ew_c + air.perm_width + 4 * config.blowup
            gz_shift = _beta_power_const(ctx, bpow_table, beta32, w_z_c)
            num_gz_s = ctx.ext_mul(ctx.ext_reduce(num_gz), gz_shift)
            r_ = ctx.ext_add(
                ctx.ext_mul(ctx.ext_reduce(num_z), inv_xz),
                ctx.ext_mul(ctx.ext_reduce(num_gz_s), inv_xgz))
            # global β offset: multiply by β^{offset}: offsets are the
            # running totals; fold into scaled accumulation per log_N
            off_pow = _beta_power_const(ctx, bpow_table, beta32,
                                        _beta_offsets(geo, config,
                                                      cp.name))
            r_ = ctx.ext_mul(ctx.ext_reduce(r_), off_pow)
            scaled[log_N] = (ctx.ext_add(scaled[log_N], r_)
                             if log_N in scaled else r_)
        # FRI walk
        v = [ctx.const(0)] * 4
        cur_bits = bits
        cur_shift = config.shift
        for ell, (pair, path) in enumerate(mq.fri_steps):
            log_l = log_N_max - ell
            if log_l in scaled:
                v = ctx.ext_add(v, scaled[log_l])
            a_w = wit_ext(pair[0])
            b_w = wit_ext(pair[1])
            leaf = _leaf_digest_c(ctx, a_w + b_w)
            jbits = cur_bits[: log_l - 1]
            _verify_path_c(ctx, leaf, jbits,
                           [wit_fr(h_) for h_ in path],
                           fri_root_w[ell])
            top = cur_bits[log_l - 1]
            # mine = sel(top, b, a)
            mine = [ctx.add(a_w[i],
                            ctx.mul(top, ctx.ext_sub(b_w, a_w)[i]))
                    for i in range(4)]
            ctx.ext_assert_eq_mod(mine, v)
            # x_j
            x_j = ctx.const(cur_shift)
            gp = two_adic_root(log_l)
            for b_ in jbits:
                f = ctx.add(ctx.const(1), ctx.scale(b_, (gp - 1) % P))
                x_j = ctx.reduce(ctx.mul(x_j, f))
                gp = gp * gp % P
            inv2 = pow(2, P - 2, P)
            half_sum = ctx.ext_scale_int(ctx.ext_add(a_w, b_w), inv2)
            diff = ctx.ext_scale_int(ctx.ext_sub(a_w, b_w), inv2)
            inv_xj = ctx.ext_inv_witness(to_ext(x_j))
            v = ctx.ext_add(
                half_sum,
                ctx.ext_mul(fold_betas[ell],
                            ctx.ext_reduce(
                                ctx.ext_mul(ctx.ext_reduce(diff),
                                            inv_xj))))
            cur_shift = cur_shift * cur_shift % P
            cur_bits = jbits
        # v == fri_final[qq] (select by remaining bits)
        fv = _select_tree_c(ctx, final_w, cur_bits)
        ctx.ext_assert_eq_mod(v, fv)

    # --- final-layer low-degree check ------------------------------------
    size = len(final_w)
    log_size = size.bit_length() - 1
    shift = config.shift
    for _ in range(n_layers):
        shift = shift * shift % P
    w_f = two_adic_root(log_size)
    w_inv = pow(w_f, P - 2, P)
    max_deg = size // config.blowup
    for k in range(max_deg, size):
        step = pow(w_inv, k, P)
        acc = [ctx.const(0)] * 4
        wk = 1
        for i in range(size):
            acc = ctx.ext_add(acc, ctx.ext_scale_int(final_w[i], wk))
            wk = wk * step % P
        for x in acc:
            ctx.assert_zero_mod(x)

    assert cs.check(), "wrap circuit assignment inconsistent"
    return cs


def _beta_offsets(geo, config, name: str) -> int:
    off = 0
    for cp, air, n, log_N, s_i in geo:
        ew = getattr(air, "preprocessed_width", 0)
        w_z = air.width + ew + air.perm_width + 4 * config.blowup
        w_gz = air.width + ew + air.perm_width
        if cp.name == name:
            return off
        off += w_z + w_gz
    raise KeyError(name)


def _beta_power_const(ctx: Ctx, table, beta32, k: int) -> list[W]:
    """β^k from the 32-power table: β^(k%32) · (β³²)^(k//32)."""
    out = table[k % 32]
    hi = k // 32
    cur = beta32
    while hi:
        if hi & 1:
            out = ctx.ext_reduce(ctx.ext_mul(out, cur))
        hi >>= 1
        if hi:
            cur = ctx.ext_reduce(ctx.ext_mul(cur, cur))
    return out


def _select_tree_c(ctx: Ctx, vals, bits):
    cur = list(vals)
    for b_ in bits:
        nxt = []
        for t in range(len(cur) // 2):
            lo, hi = cur[2 * t], cur[2 * t + 1]
            d = ctx.ext_sub(hi, lo)
            nxt.append([ctx.add(lo[i], ctx.mul(b_, d[i]))
                        for i in range(4)])
        cur = nxt
        if len(cur) == 1:
            break
    return cur[0]


def _ext_mul_const(ctx: Ctx, a: list[W], c) -> list[W]:
    """a · c for a CONSTANT Fp4 c (basis vectors etc.)."""
    cc = [int(x) for x in c.c]
    prod = [None] * 7
    for i in range(4):
        for j in range(4):
            if cc[j] == 0:
                continue
            t = ctx.scale(a[i], cc[j])
            prod[i + j] = t if prod[i + j] is None \
                else ctx.add(prod[i + j], t)
    out = []
    for k in range(4):
        v = prod[k] if prod[k] is not None else ctx.const(0)
        if k + 4 <= 6 and prod[k + 4] is not None:
            v = ctx.add(v, ctx.scale(prod[k + 4], W_EXT))
        out.append(v)
    return out


def _fold_constraints_r1cs(ctx: Ctx, air, ev, publics_full, sels, alpha,
                           periodic_at_zeta, dpows, gamma):
    """air.eval over R1CS ext values, folded with the chunked-Horner α
    machinery.  Every algebra value handed to the AirBuilder is ONE type
    (V: an ext quadruple of bound-tracked wires), mirroring how the
    recursion VM runs chips over its Val handles."""
    from ..stark.air import AirBuilder, scalar_vec_hooks

    fold = PowerFold(ctx, alpha)
    V = make_v_class(ctx)

    def tofold(expr):
        if isinstance(expr, int):
            e = [ctx.const(expr % P), ctx.const(0), ctx.const(0),
                 ctx.const(0)]
        else:
            e = expr.e
        if max(x.bound for x in e) > 150:
            e = ctx.ext_reduce(e)
        fold.feed(e)

    builder = AirBuilder(
        local=[V(e) for e in ev["tl"]],
        next=[V(e) for e in ev["tn"]],
        public=[V(e) for e in publics_full_to_ext(ctx, publics_full)],
        is_first_row=V(sels["is_first_row"]),
        is_last_row=V(sels["is_last_row"]),
        is_transition=V(sels["is_transition"]),
        _fold=tofold,
        periodic=[V(e) for e in periodic_at_zeta],
        perm_local=[V(e) for e in ev["pl"]],
        perm_next=[V(e) for e in ev["pn"]],
        challenges=_challenge_extvals(ctx, V, gamma, dpows),
        pre_local=[V(e) for e in ev["el"]],
        pre_next=[V(e) for e in ev["en"]],
        **scalar_vec_hooks(tofold, lambda v: V([
            ctx.const(int(v) % P), ctx.const(0), ctx.const(0),
            ctx.const(0)])),
    )
    air.eval(builder)
    return fold.result()


def publics_full_to_ext(ctx: Ctx, publics_full):
    out = []
    for p_ in publics_full:
        if isinstance(p_, W):
            out.append([p_, ctx.const(0), ctx.const(0), ctx.const(0)])
        else:
            out.append(p_)
    return out


def make_v_class(ctx: Ctx):
    """The R1CS constraint algebra: ONE value type (an extension
    quadruple of bound-tracked wires) for builder locals, challenges'
    limbs, publics and selectors — mirroring how the recursion VM uses a
    single Val type, so chips' ExtVal fingerprint arithmetic works
    unchanged."""

    class V:
        __slots__ = ("e",)

        def __init__(self, e):
            self.e = e

        @staticmethod
        def _lift(o):
            if isinstance(o, V):
                return o.e
            if isinstance(o, int):
                return [ctx.const(o % P), ctx.const(0), ctx.const(0),
                        ctx.const(0)]
            return None

        def __add__(self, o):
            oe = self._lift(o)
            if oe is None:
                return NotImplemented
            return V(ctx.ext_add(self.e, oe))
        __radd__ = __add__

        def __sub__(self, o):
            oe = self._lift(o)
            if oe is None:
                return NotImplemented
            return V(ctx.ext_sub(self.e, oe))

        def __rsub__(self, o):
            oe = self._lift(o)
            if oe is None:
                return NotImplemented
            return V(ctx.ext_sub(oe, self.e))

        def __mul__(self, o):
            oe = self._lift(o)
            if oe is None:
                return NotImplemented
            a, b = self.e, oe
            if max(x.bound for x in a) > 100:
                a = ctx.ext_reduce(a)
            if max(x.bound for x in b) > 100:
                b = ctx.ext_reduce(b)
            return V(ctx.ext_mul(a, b))
        __rmul__ = __mul__

        def __neg__(self):
            return V(ctx.ext_sub([ctx.const(0)] * 4, self.e))

    return V


def _challenge_extvals(ctx: Ctx, V, gamma, dpows):
    from ..stark.ext_val import ExtVal

    def base(w_: W):
        return V([w_, ctx.const(0), ctx.const(0), ctx.const(0)])

    out = [ExtVal(*[base(x) for x in ctx.ext_reduce(gamma)])]
    for dp in dpows:
        out.append(ExtVal(*[base(x) for x in dp]))
    return out
