"""The port's certificate handling (guest/der.py, roots.py, x509.py), which
reads DER itself, against the JAX package's, which hands the structure to
`cryptography`: every root of the store, the recorded session's chain at and
around its pinned time, host-name matching, and signature checks under
RSA-2048, P-256, P-384 and Ed25519 keys built here — the same results, and
the same SHA-256/SHA-512 compressions and modular multiplications recorded
in the same order."""

import dataclasses
import datetime
import hashlib
import warnings

import pytest
from cryptography import x509 as cx509
from cryptography.hazmat.primitives import hashes, serialization
from cryptography.hazmat.primitives.asymmetric import ec, ed25519, padding, rsa
from cryptography.x509.oid import NameOID

from zktls_tpu.core.types import GuestInput as JGuestInput
from zktls_tpu.guest import roots as jroots
from zktls_tpu.guest import x509 as jx509
from zktls_tpu.guest.crypto import modmul as jmodmul
from zktls_tpu.guest.crypto.sha256 import SHA256Recorder as JSHA256Recorder
from zktls_tpu.guest.crypto.sha512 import SHA512Recorder as JSHA512Recorder
from zktls_tpu.guest.replay import replay_session as jreplay_session
from zktls_tpu_torch.core.tape import parse_time
from zktls_tpu_torch.guest import der, roots, x509
from zktls_tpu_torch.guest.crypto import modmul
from zktls_tpu_torch.guest.crypto.sha256 import SHA256Recorder
from zktls_tpu_torch.guest.crypto.sha512 import SHA512Recorder
from zktls_tpu_torch.workload import SESSION_GUEST_INPUT

from .torch_threads import torch_threads_per_worker  # noqa: F401

S = x509.SignatureScheme
DATA = b"server key exchange params: " + bytes(range(200))


def _root_pairs():
    """(cryptography's certificate, the port's X509) of every PEM block."""
    pairs = []
    for block in der.pem_blocks(roots._PEM_PATH.read_bytes()):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # a root with a negative serial
            ref = cx509.load_pem_x509_certificate(block)
        pairs.append((ref, der.parse_certificate(der.pem_to_der(block))))
    return pairs


@pytest.fixture(scope="module")
def root_pairs():
    return _root_pairs()


def _spki_der(cert) -> bytes:
    return cert.public_key().public_bytes(
        serialization.Encoding.DER,
        serialization.PublicFormat.SubjectPublicKeyInfo)


def _ref_key(cert):
    key = cert.public_key()
    if isinstance(key, rsa.RSAPublicKey):
        n = key.public_numbers()
        return der.RsaKey(n.n, n.e)
    if isinstance(key, ec.EllipticCurvePublicKey):
        n = key.public_numbers()
        return der.EcKey(key.curve.name, n.x, n.y)
    if isinstance(key, ed25519.Ed25519PublicKey):
        return der.Ed25519Key(key.public_bytes(serialization.Encoding.Raw,
                                               serialization.PublicFormat.Raw))
    raise AssertionError(f"unexpected key type {type(key)}")


#: the reference's value of each field the port reads
ROOT_FIELDS = {
    "subject": (lambda c: c.subject.public_bytes(), lambda m: m.subject),
    "issuer": (lambda c: c.issuer.public_bytes(), lambda m: m.issuer),
    "spki_sha256": (lambda c: hashlib.sha256(_spki_der(c)).digest(),
                    lambda m: hashlib.sha256(m.spki).digest()),
    "tbs": (lambda c: c.tbs_certificate_bytes, lambda m: m.tbs),
    "signature": (lambda c: (c.signature, c.signature_algorithm_oid._name),
                  lambda m: (m.signature, m.signature_name)),
    "validity": (lambda c: (int(c.not_valid_before_utc.timestamp()),
                            int(c.not_valid_after_utc.timestamp())),
                 lambda m: (m.not_before, m.not_after)),
    "public_key": (_ref_key, lambda m: m.public_key()),
}


@pytest.mark.parametrize("field", sorted(ROOT_FIELDS))
def test_der_reader_equals_cryptography_on_every_root(root_pairs, field):
    ref_of, mine_of = ROOT_FIELDS[field]
    assert len(root_pairs) == 136
    for ref, mine in root_pairs:
        assert mine_of(mine) == ref_of(ref), (field, ref.subject)


def test_trust_store_equals_reference():
    assert roots.anchor_spki_hashes() == jroots.anchor_spki_hashes()
    assert len(roots.anchor_spki_hashes()) == 136
    mine, ref = roots.trust_anchors(), jroots.trust_anchors()
    assert mine.keys() == ref.keys()
    for subject, certs in ref.items():
        assert [c.der for c in mine[subject]] == \
            [c.public_bytes(serialization.Encoding.DER) for c in certs]
        assert roots.find_anchor_by_subject(subject) is mine[subject]
    assert roots.find_anchor_by_subject(b"\x30\x00") == []


def test_der_reader_refuses_malformed_input():
    good = roots.trust_anchors()[next(iter(roots.trust_anchors()))][0].der
    cuts = [good[:n] for n in range(0, len(good), 7)]
    for bad in cuts + [good + b"\x00", b"\x04" + good[1:]]:
        with pytest.raises(ValueError):
            der.parse_certificate(bad)
    assert der.decode_oid(bytes([0x2A, 0x86, 0x48, 0x86, 0xF7, 0x0D, 0x01,
                                 0x01, 0x0B])) == "1.2.840.113549.1.1.11"


def test_parse_time_forms():
    utc = der.read_tlv(b"\x17\x0d" + b"491231235959Z")
    gen = der.read_tlv(b"\x18\x0f" + b"20500101000000Z")
    old = der.read_tlv(b"\x17\x0d" + b"500101000000Z")
    assert der.parse_time(utc) == 2524607999           # 2049-12-31
    assert der.parse_time(gen) == 2524608000           # 2050-01-01
    assert der.parse_time(old) == -631152000           # 1950-01-01


# ---------------------------------------------------------------------------
# the recorded session's chain
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def session_chain():
    """(the session's DER chain, host name, pinned seconds)."""
    gi = JGuestInput.from_cbor(SESSION_GUEST_INPUT.read_bytes())
    rep = jreplay_session(gi.response)
    sec, _ = parse_time(gi.response.time)
    return rep.certificate_chain, gi.request.request_info.server_name, sec


@pytest.mark.parametrize("when", ["recorded", "before", "after"])
def test_verify_chain_equals_reference(session_chain, when):
    chain, host, sec = session_chain
    leaf = x509.Certificate.parse(chain[0])._cert
    t = {"recorded": sec, "before": leaf.not_before - 1,
         "after": leaf.not_after + 1}[when]
    mine = x509.verify_chain(chain, host, t)
    assert mine == jx509.verify_chain(chain, host, t)
    assert mine["validity"] == (when == "recorded")
    assert mine["hostname_match"] and mine["signatures"]
    assert not mine["anchored"]
    assert mine["root_spki_sha256"] == hashlib.sha256(leaf.spki).hexdigest()
    assert x509.verify_chain(chain, "example.com", t)["hostname_match"] \
        is jx509.verify_chain(chain, "example.com", t)["hostname_match"] \
        is False


# ---------------------------------------------------------------------------
# certificates built here
# ---------------------------------------------------------------------------

KEYS = {
    "rsa2048": lambda: rsa.generate_private_key(public_exponent=65537,
                                                key_size=2048),
    "p256": lambda: ec.generate_private_key(ec.SECP256R1()),
    "p384": lambda: ec.generate_private_key(ec.SECP384R1()),
    "ed25519": ed25519.Ed25519PrivateKey.generate,
}


def _cert(name, key, issuer_name, issuer_key, sig_hash, sans=None):
    now = datetime.datetime(2026, 1, 1, tzinfo=datetime.timezone.utc)
    b = (cx509.CertificateBuilder()
         .subject_name(cx509.Name([cx509.NameAttribute(NameOID.COMMON_NAME,
                                                       name)]))
         .issuer_name(cx509.Name([cx509.NameAttribute(NameOID.COMMON_NAME,
                                                      issuer_name)]))
         .public_key(key.public_key())
         .serial_number(cx509.random_serial_number())
         .not_valid_before(now)
         .not_valid_after(now + datetime.timedelta(days=90)))
    if sans is not None:
        b = b.add_extension(cx509.SubjectAlternativeName(
            [cx509.DNSName(s) for s in sans]), critical=False)
    return b.sign(issuer_key, sig_hash).public_bytes(
        serialization.Encoding.DER)


@pytest.fixture(scope="module")
def pki():
    """One CA per key type, and a leaf signed by each CA with SHA-256 and
    with SHA-384 (Ed25519 signs without a separate hash)."""
    cas = {k: make() for k, make in KEYS.items()}
    leaf_key = ec.generate_private_key(ec.SECP256R1())
    ca_der = {k: _cert(f"ca-{k}", key, f"ca-{k}", key,
                       None if k == "ed25519" else hashes.SHA256())
              for k, key in cas.items()}
    leaves = {}
    for k, key in cas.items():
        for h in ((None,) if k == "ed25519"
                  else (hashes.SHA256(), hashes.SHA384())):
            leaves[(k, h and h.name)] = _cert(
                "leaf", leaf_key, f"ca-{k}", key, h,
                sans=["example.com", "*.wild.example.com"])
    return {"cas": cas, "ca_der": ca_der, "leaves": leaves}


def _run(pkg, fn):
    """fn(pkg's x509) under fresh SHA and ModMul recorders of that package:
    (outcome, SHA-256 events, SHA-512 events, ModMul events) as plain
    tuples; an exception's type name stands for the outcome."""
    x, rec_mod, r256, r512 = (
        (x509, modmul, SHA256Recorder(), SHA512Recorder()) if pkg == "port"
        else (jx509, jmodmul, JSHA256Recorder(), JSHA512Recorder()))
    with rec_mod.recording() as mm, x.hash_recording(r256, r512):
        try:
            outcome = fn(x)
        except Exception as e:            # compared, not hidden
            outcome = type(e).__name__
    return (outcome,
            [dataclasses.astuple(e) for e in r256.events],
            [dataclasses.astuple(e) for e in r512.events],
            [(e.a, e.b, e.r, e.m) for e in mm.events])


def _same(fn):
    mine, ref = _run("port", fn), _run("ref", fn)
    assert mine == ref
    return mine[0]


@pytest.mark.parametrize("case", [
    ("rsa2048", "sha256"), ("rsa2048", "sha384"), ("p256", "sha256"),
    ("p256", "sha384"), ("p384", "sha256"), ("p384", "sha384"),
    ("ed25519", None)], ids=lambda c: f"{c[0]}-{c[1]}")
def test_verify_signed_by_equals_reference(pki, case):
    leaf = pki["leaves"][case]
    ca = pki["ca_der"][case[0]]
    assert _same(lambda x: x.Certificate.parse(leaf).verify_signed_by(
        x.Certificate.parse(ca))) is True
    other = pki["ca_der"]["p256" if case[0] != "p256" else "p384"]
    _same(lambda x: x.Certificate.parse(leaf).verify_signed_by(
        x.Certificate.parse(other)))
    # a self-signed CA under its own key, and a three-certificate chain
    assert _same(lambda x: x.Certificate.parse(ca).verify_signed_by(
        x.Certificate.parse(ca))) is True
    res = _same(lambda x: x.verify_chain([leaf, ca], "a.wild.example.com",
                                         1767225600 + 86400))
    assert res["signatures"] and res["validity"] and res["hostname_match"]


def _signature(key, scheme: int, data: bytes) -> bytes:
    h = {0x0401: hashes.SHA256, 0x0501: hashes.SHA384, 0x0601: hashes.SHA512,
         0x0804: hashes.SHA256, 0x0805: hashes.SHA384, 0x0806: hashes.SHA512,
         0x0403: hashes.SHA256, 0x0503: hashes.SHA384}.get(scheme)
    if isinstance(key, rsa.RSAPrivateKey):
        pad = (padding.PKCS1v15() if scheme in (0x0401, 0x0501, 0x0601)
               else padding.PSS(mgf=padding.MGF1(h()),
                                salt_length=h().digest_size))
        return key.sign(data, pad, h())
    if isinstance(key, ec.EllipticCurvePrivateKey):
        return key.sign(data, ec.ECDSA(h()))
    return key.sign(data)


SCHEMES = {
    "rsa2048": [S.RSA_PKCS1_SHA256, S.RSA_PKCS1_SHA384, S.RSA_PKCS1_SHA512,
                S.RSA_PSS_SHA256, S.RSA_PSS_SHA384, S.RSA_PSS_SHA512],
    "p256": [S.ECDSA_P256_SHA256],
    "p384": [S.ECDSA_P384_SHA384],
    "ed25519": [S.ED25519],
}


@pytest.mark.parametrize("kind", sorted(SCHEMES))
def test_public_key_verify_equals_reference(pki, kind):
    key, cert = pki["cas"][kind], pki["ca_der"][kind]
    for scheme in SCHEMES[kind]:
        sig = _signature(key, scheme, DATA)
        ok, sha256_events, sha512_events, modmuls = _run(
            "port", lambda x: x.Certificate.parse(cert).public_key_verify(
                scheme, DATA, sig))
        assert ok is True and modmuls
        # the signed data's digest went through the witnessed SHA paths
        # (Ed25519 hashes inside its own verifier)
        assert bool(sha256_events or sha512_events) == (kind != "ed25519")
        assert _same(lambda x: x.Certificate.parse(cert).public_key_verify(
            scheme, DATA, sig)) is True
        assert _same(lambda x: x.Certificate.parse(cert).public_key_verify(
            scheme, DATA + b"!", sig)) is False
        wrong = S.ECDSA_P384_SHA384 if scheme == S.ECDSA_P256_SHA256 \
            else S.ECDSA_P256_SHA256
        _same(lambda x: x.Certificate.parse(cert).public_key_verify(
            wrong, DATA, sig))


@pytest.mark.parametrize("host,want", [
    ("example.com", True), ("EXAMPLE.com.", True),
    ("a.wild.example.com", True), ("a.b.wild.example.com", False),
    ("wild.example.com", False), ("example.org", False),
    ("www.example.com", False)])
def test_matches_hostname_equals_reference(pki, host, want):
    leaf = pki["leaves"][("p256", "sha256")]
    assert x509.Certificate.parse(leaf).matches_hostname(host) is want
    assert jx509.Certificate.parse(leaf).matches_hostname(host) is want


def test_matches_hostname_without_san(pki):
    ca = pki["ca_der"]["rsa2048"]     # built with no subjectAltName
    assert x509.Certificate.parse(ca).matches_hostname("ca-rsa2048") is False
    assert jx509.Certificate.parse(ca).matches_hostname("ca-rsa2048") is False
