"""The port's Groth16 layer (snark/bn254.py, r1cs.py, groth16.py, the
journal circuit of wrap.py, csrc/bn254_msm_host.c) against the JAX
package's.

The curve: group law, G1 / G2 membership (the twist's subgroup check
included), the pairing's bilinearity and the pairing-product identity,
each value equal to the reference's on seeded scalars.  The MSMs and
fixed-base batches: the C library, the pure-Python plain version and the
JAX package's on the same points and scalars; a failed build or load of
the library raises on every native path, with no fallback.  Groth16: on a
small R1CS and on one large enough to route through the C library, the
port's keys and proof bytes equal the reference's under the same seed and
randomness, each package's `verify` accepts the other's proof and both
reject the reference's soundness tampers.  The journal circuit: counts,
constraints and assignment equal the reference's at several journal
lengths up to 1,457 bytes, and both refuse a longer journal.  Exact
equality throughout."""

import random

import pytest

from zktls_tpu.snark import bn254 as jbn
from zktls_tpu.snark import groth16 as jg16
from zktls_tpu.snark import wrap as jwrap
from zktls_tpu.snark.r1cs import R1CS as JR1CS
from zktls_tpu_torch.snark import bn254 as bn
from zktls_tpu_torch.snark import groth16 as g16
from zktls_tpu_torch.snark import wrap
from zktls_tpu_torch.snark.r1cs import R1CS
from zktls_tpu_torch.utils import native

from .torch_threads import (  # noqa: F401
    mimc_threads_per_worker,
    torch_threads_per_worker,
)

R = bn.R


def _scalars(n: int, seed: int) -> list[int]:
    """Seeded scalars with 0, 1 and r − 1 among them (and r, which every
    entry point reduces)."""
    rng = random.Random(seed)
    out = [rng.randrange(R) for _ in range(n)]
    out[:4] = [0, 1, R - 1, R][:n]
    return out


# ---------------------------------------------------------------------------
# the curve
# ---------------------------------------------------------------------------


def test_constants_equal_the_reference():
    assert (bn.P, bn.R, bn.G1, bn.G2, bn.ATE_LOOP, bn.B2) == \
        (jbn.P, jbn.R, jbn.G1, jbn.G2, jbn.ATE_LOOP, jbn.B2)
    assert bn._FROB_COEFF == jbn._FROB_COEFF


def test_group_law_equals_the_reference():
    for k in _scalars(6, 1):
        p1, q2 = bn.g1_mul(bn.G1, k), bn.g2_mul(bn.G2, k)
        assert p1 == jbn.g1_mul(jbn.G1, k) and q2 == jbn.g2_mul(jbn.G2, k)
        assert bn.g1_add(p1, bn.G1) == jbn.g1_add(p1, jbn.G1)
        assert bn.g1_add(p1, p1) == jbn.g1_add(p1, p1)
        assert bn.g2_add(q2, bn.G2) == jbn.g2_add(q2, jbn.G2)
        assert bn.g2_add(q2, q2) == jbn.g2_add(q2, q2)
        assert bn.g1_neg(p1) == jbn.g1_neg(p1)
        assert bn.g2_neg(q2) == jbn.g2_neg(q2)
        assert bn.g1_add(p1, bn.g1_neg(p1)) is None
        assert bn.g2_add(q2, bn.g2_neg(q2)) is None
        assert bn.g1_base_mul(k) == p1 and bn.g2_base_mul(k) == q2
    assert bn.g1_mul(bn.G1, R) is None and bn.g2_mul(bn.G2, R) is None


def _g2_mul_unreduced(q, k: int):
    """k·Q by double-and-add, k not reduced mod r."""
    out = None
    while k:
        if k & 1:
            out = bn.g2_add(out, q)
        q = bn.g2_add(q, q)
        k >>= 1
    return out


def test_membership_equals_the_reference():
    """On-curve points, points moved off the curve and a twist point
    outside the order-r subgroup (the first x = 1, 2, ... that lifts onto
    the twist; BN254's cofactor leaves it outside G2).  The reference's
    in_g2_subgroup multiplies by r through g2_mul, which reduces its scalar
    mod r first, so it accepts every point on the twist (ROADMAP Queue 3);
    the port gives the reference's verdicts."""
    rng = random.Random(2)
    pts1 = [bn.g1_mul(bn.G1, rng.randrange(1, R)) for _ in range(4)]
    pts2 = [bn.g2_mul(bn.G2, rng.randrange(1, R)) for _ in range(3)]
    off1 = [(x, (y + 1) % bn.P) for x, y in pts1]
    off2 = [(x, bn.f2_add(y, (1, 0))) for x, y in pts2]
    for p in pts1 + off1 + [None]:
        assert bn.is_on_g1(p) == jbn.is_on_g1(p) == (p not in off1)
    for q in pts2 + off2 + [None]:
        assert bn.is_on_g2(q) == jbn.is_on_g2(q) == (q not in off2)
    y, x0 = None, 0
    while y is None:
        x0 += 1
        x = (x0, 0)
        y = _f2_sqrt(bn.f2_add(bn.f2_mul(bn.f2_sqr(x), x), bn.B2))
    outside = (x, y)
    assert bn.is_on_g2(outside) and jbn.is_on_g2(outside)
    assert _g2_mul_unreduced(outside, R) is not None
    assert _g2_mul_unreduced(pts2[0], R) is None
    for q in (outside, pts2[0], off2[0]):
        assert bn.in_g2_subgroup(q) == jbn.in_g2_subgroup(q) == \
            (q is not off2[0])


def _f2_sqrt(a):
    """A square root in Fp2 (p ≡ 3 mod 4) by the complex method, or None
    when a is not a square."""
    p = bn.P
    a0, a1 = a
    norm = (a0 * a0 + a1 * a1) % p
    n = pow(norm, (p + 1) // 4, p)
    if n * n % p != norm:
        return None
    for s in (n, p - n):
        t = (a0 + s) * pow(2, p - 2, p) % p
        x0 = pow(t, (p + 1) // 4, p)
        if x0 * x0 % p == t and x0:
            x1 = a1 * pow(2 * x0, p - 2, p) % p
            if bn.f2_sqr((x0, x1)) == (a0 % p, a1 % p):
                return (x0, x1)
    return None


def test_pairing_bilinear_and_equal_to_the_reference():
    e = bn.pairing(bn.G1, bn.G2)
    assert e != bn.fp12_one() and e == jbn.pairing(jbn.G1, jbn.G2)
    a, b = 31337, 271828182845
    pa, qb = bn.g1_mul(bn.G1, a), bn.g2_mul(bn.G2, b)
    assert bn.pairing(pa, qb) == bn.f12_pow(e, a * b) == jbn.pairing(pa, qb)
    assert bn.pairing(pa, bn.G2) == bn.pairing(bn.G1, bn.g2_mul(bn.G2, a))


def test_pairing_product_identity_equals_the_reference():
    p77 = bn.g1_mul(bn.G1, 77)
    good = [(p77, bn.G2), (bn.g1_neg(p77), bn.G2)]
    bad = [(p77, bn.G2), (bn.g1_neg(bn.g1_mul(bn.G1, 78)), bn.G2)]
    assert bn.pairing_product(good) and jbn.pairing_product(good)
    assert not bn.pairing_product(bad) and not jbn.pairing_product(bad)
    assert bn.pairing_product([(None, bn.G2), (bn.G1, None)])


# ---------------------------------------------------------------------------
# MSM and fixed-base batches: C, plain, reference
# ---------------------------------------------------------------------------


def _points(group: str, n: int, seed: int) -> list:
    """n seeded points of G1 or G2 (through the plain fixed-base table),
    with infinity and a repeated point among them."""
    base = bn.g1_base_mul_batch if group == "g1" else bn.g2_base_mul_batch
    pts = base([k or 1 for k in _scalars(n, seed)], native=False)
    pts[1] = None
    pts[2] = pts[3]
    return pts


@pytest.mark.parametrize("group,n", [("g1", 80), ("g2", 70)])
def test_msm_c_equals_plain_and_the_reference(group, n):
    """From 64 points up both packages take their C library (the
    reference's size switch); the plain version is the Python Pippenger."""
    pts, scs = _points(group, n, seed=n), _scalars(n, seed=100 + n)
    msm, jmsm = ((bn.msm_g1, jbn.msm_g1) if group == "g1"
                 else (bn.msm_g2, jbn.msm_g2))
    assert msm(pts, scs) == msm(pts, scs, native=False) == jmsm(pts, scs)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_msm_below_64_points_equals_the_reference(group):
    """Below 64 points both packages take the Python Pippenger; it equals
    the sum of the single multiplications."""
    pts, scs = _points(group, 9, seed=9), _scalars(9, seed=109)
    msm, jmsm, mul, add = (
        (bn.msm_g1, jbn.msm_g1, bn.g1_mul, bn.g1_add) if group == "g1"
        else (bn.msm_g2, jbn.msm_g2, bn.g2_mul, bn.g2_add))
    want = None
    for pt, s in zip(pts, scs):
        want = add(want, None if pt is None else mul(pt, s))
    assert msm(pts, scs) == jmsm(pts, scs) == want


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_base_mul_batch_c_equals_plain_and_the_reference(group):
    scs = _scalars(70, seed=7)
    batch, jbatch = ((bn.g1_base_mul_batch, jbn.g1_base_mul_batch)
                     if group == "g1" else
                     (bn.g2_base_mul_batch, jbn.g2_base_mul_batch))
    got = batch(scs)
    assert got == batch(scs, native=False) == jbatch(scs)
    assert got[0] is None and got[3] is None      # 0 and r
    assert batch(scs[:10]) == got[:10]            # Python below 64


def test_msm_library_is_built_with_openmp_from_the_port_source():
    path, _ = native.build_msm()
    assert native.MSM_SOURCE.name == "bn254_msm_host.c"
    assert "-fopenmp" in native.MSM_CFLAGS
    assert path.parent == native.BUILD_DIR and path.exists()
    assert native.build_msm() == (path, "")


def test_msm_broken_source_and_missing_compiler_raise(tmp_path, monkeypatch):
    bad = tmp_path / "msm_broken.c"
    bad.write_text(native.MSM_SOURCE.read_text().replace(
        "static void jac_dbl(", "oops static void jac_dbl("))
    with pytest.raises(RuntimeError, match="oops"):
        native.build_msm(source=bad, build_dir=tmp_path)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no C compiler"):
        native.build_msm(build_dir=tmp_path / "fresh")


@pytest.mark.parametrize("failure", ["build", "load"])
def test_every_native_path_raises_without_the_library(failure, tmp_path,
                                                      monkeypatch):
    """With the library unbuilt (a failed build) or unloadable, every MSM
    and fixed-base batch with native=True raises; none computes the
    result in Python instead."""
    if failure == "build":
        def build_msm():
            raise RuntimeError("building bn254_msm_host.c failed")
        match = "building"
    else:
        junk = tmp_path / "not_a_library.so"
        junk.write_bytes(b"junk")

        def build_msm():
            return junk, ""
        match = "not_a_library"
    monkeypatch.setattr(native, "_msm_lib", None)
    monkeypatch.setattr(native, "build_msm", build_msm)
    pts1, pts2 = [bn.G1] * 64, [bn.G2] * 64
    scs = list(range(1, 65))
    errors = (RuntimeError, OSError)
    for call in (lambda: bn.msm_g1(pts1, scs), lambda: bn.msm_g2(pts2, scs),
                 lambda: bn.g1_base_mul_batch(scs),
                 lambda: bn.g2_base_mul_batch(scs)):
        with pytest.raises(errors, match=match):
            call()
    assert bn.msm_g1(pts1[:63], scs[:63]) == bn.g1_mul(
        bn.G1, sum(scs[:63]))                     # below 64: Python


# ---------------------------------------------------------------------------
# Groth16
# ---------------------------------------------------------------------------


def _toy(cls):
    """The reference's toy circuit (tests/test_snark.py): public
    p1 = x·y, p2 = (x+3)²·y."""
    cs = cls()
    x_val, y_val = 1234567890123456789, 98765432109876543210
    p1 = cs.public_input(x_val * y_val % R)
    p2 = cs.public_input((x_val + 3) ** 2 * y_val % R)
    x = cs.witness(x_val)
    y = cs.witness(y_val)
    xy = cs.mul({x: 1}, {y: 1})
    cs.enforce_eq({xy: 1}, {p1: 1})
    x3sq = cs.mul({x: 1, 0: 3}, {x: 1, 0: 3})
    out = cs.mul({x3sq: 1}, {y: 1})
    cs.enforce_eq({out: 1}, {p2: 1})
    assert cs.check()
    return cs


def _chain(cls):
    """A circuit of 120 squarings: more than 64 variables, so setup's
    fixed-base batches and prove's MSMs run through the C library."""
    cs = cls()
    v = 3
    p = cs.public_input(v)
    w = cs.witness(v)
    cs.enforce_eq({w: 1}, {p: 1})
    for i in range(120):
        w = cs.mul({w: 1, 0: i}, {w: 1, 0: i})
    assert cs.check()
    return cs


@pytest.fixture(scope="module", params=[_toy, _chain],
                ids=["toy", "chain"])
def groth16_pair(request):
    """Both packages' circuit, keys and proof (seed b"torch-test",
    randomness b"fixed") of the toy circuit and of the chain."""
    cs, jcs = request.param(R1CS), request.param(JR1CS)
    keys = g16.setup(cs, seed=b"torch-test")
    jkeys = jg16.setup(jcs, seed=b"torch-test")
    return (cs, jcs, keys, jkeys, g16.prove(keys, cs, randomness=b"fixed"),
            jg16.prove(jkeys, jcs, randomness=b"fixed"))


def test_groth16_equals_the_reference_and_cross_verifies(groth16_pair):
    cs, jcs, keys, jkeys, proof, jproof = groth16_pair
    assert cs.constraints == jcs.constraints
    assert cs.assignment() == jcs.assignment()
    assert keys.vk() == jkeys.vk()
    for field in ("beta1", "delta1", "a_query", "b1_query", "b2_query",
                  "k_query", "h_query"):
        assert getattr(keys, field) == getattr(jkeys, field), field
    blob = proof.to_bytes()
    assert len(blob) == 256 and blob == jproof.to_bytes()
    pubs = cs.assignment()[1 : cs.n_public + 1]
    for verify, parse in ((g16.verify, g16.Groth16Proof.from_bytes),
                          (jg16.verify, jg16.Groth16Proof.from_bytes)):
        assert verify(jkeys.vk(), pubs, parse(blob))
        assert verify(keys.vk(), pubs, parse(jproof.to_bytes()))


def test_groth16_soundness_tampers_rejected_by_both(groth16_pair):
    cs, _, keys, _, proof, _ = groth16_pair
    pubs = cs.assignment()[1 : cs.n_public + 1]
    bad_c = g16.Groth16Proof.from_bytes(proof.to_bytes())
    bad_c.c = bn.g1_add(bad_c.c, bn.G1)
    for verify, parse in ((g16.verify, g16.Groth16Proof.from_bytes),
                          (jg16.verify, jg16.Groth16Proof.from_bytes)):
        assert not verify(keys.vk(), [pubs[0] + 1, *pubs[1:]],
                          parse(proof.to_bytes()))
        assert not verify(keys.vk(), pubs, parse(bad_c.to_bytes()))
        with pytest.raises(ValueError, match="count"):
            verify(keys.vk(), pubs + [1], parse(proof.to_bytes()))
    # a non-canonical coordinate (x + p) is refused, not reduced
    raw = bytearray(proof.to_bytes())
    raw[:32] = (proof.a[0] + bn.P).to_bytes(32, "big")
    for parse in (g16.Groth16Proof.from_bytes,
                  jg16.Groth16Proof.from_bytes):
        with pytest.raises(ValueError, match="non-canonical"):
            parse(bytes(raw))


def test_groth16_fresh_randomness_and_unsatisfied_assignment():
    """Without `randomness` each proof draws its own blinding (another
    proof, still accepted); an assignment that breaks a constraint is
    refused by both provers; the NTT equals the reference's."""
    cs, jcs = _chain(R1CS), _chain(JR1CS)
    keys = g16.setup(cs)
    pubs = cs.assignment()[1 : cs.n_public + 1]
    one, two = g16.prove(keys, cs), g16.prove(keys, cs)
    assert one.to_bytes() != two.to_bytes()
    assert g16.verify(keys.vk(), pubs, one)
    assert g16.verify(keys.vk(), pubs, two)
    for c, prove in ((cs, g16.prove), (jcs, jg16.prove)):
        c.set_value(c.n_public + 2, 5)
        with pytest.raises(ValueError, match="does not satisfy"):
            prove(keys, c)
    vals = [random.Random(3).randrange(R) for _ in range(16)]
    assert g16._ntt(vals) == jg16._ntt(vals)
    assert g16._ntt(g16._ntt(vals), invert=True) == vals


# ---------------------------------------------------------------------------
# the journal circuit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("length", [0, 1, 31, 32, 93, 1056, 1248, 1457])
def test_journal_circuit_equals_the_reference(length):
    journal = random.Random(length).randbytes(length)
    cs, jcs = wrap.build_wrap_circuit(journal), jwrap.build_wrap_circuit(
        journal)
    assert (len(cs.constraints), cs.n_vars, cs.n_public) == \
        (len(jcs.constraints), jcs.n_vars, jcs.n_public) == (15889, 15938, 1)
    assert cs.constraints == jcs.constraints
    assert cs.assignment() == jcs.assignment()
    assert wrap.journal_chunks(journal) == jwrap.journal_chunks(journal)
    assert cs.assignment()[1] == wrap.journal_digest_fr(journal) == \
        jwrap.journal_digest_fr(journal)


def test_journal_longer_than_the_circuit_is_refused_by_both():
    journal = bytes(1458)
    for build in (wrap.build_wrap_circuit, jwrap.build_wrap_circuit,
                  wrap.journal_digest_fr, jwrap.journal_digest_fr):
        with pytest.raises(ValueError, match="too long"):
            build(journal)
    assert (wrap.CHUNK_BYTES, wrap.MAX_CHUNKS) == (jwrap.CHUNK_BYTES,
                                                   jwrap.MAX_CHUNKS)
    assert wrap.wrap_circuit_params() == jwrap.wrap_circuit_params()
