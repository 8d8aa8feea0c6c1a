"""The port's guest program (guest/program.py::run_guest, the TLS replay, the
origin recovery and the journal codec) against the JAX package's: the same
GuestInput CBOR bytes, read by each package's own GuestInput.from_cbor, give
the same GuestOutput in every field — journal, chain report, keys, randoms,
plaintexts, and the SHA-256, SHA-512, ModMul, GCM and ChaCha event streams
in the same order.  On the committed session and on loopback sessions of
TLS 1.3 0x1301, 0x1302 (SHA-384) and 0x1303 (ChaCha20-Poly1305), all over
x25519, and TLS 1.2 0xC030 (SHA-384) and 0xCCA8 (ChaCha20-Poly1305)
recorded here.  (tests/test_torch_suites.py holds the chips of the SHA-384
and ChaCha20-Poly1305 sessions equal to the reference's.)"""

import dataclasses

import numpy as np
import pytest

from zktls_tpu.core.types import GuestInput as JGuestInput
from zktls_tpu.core.types import RequestOrigin as JRequestOrigin
from zktls_tpu.core.types import RequestTarget as JRequestTarget
from zktls_tpu.guest import journal as jjournal
from zktls_tpu.guest.origin import sign_origin
from zktls_tpu.guest.program import run_guest as jrun_guest
from zktls_tpu.guest.replay import ReplayError as JReplayError
from zktls_tpu.provers import stark as jstark
from zktls_tpu_torch.convert import events_from_reference
from zktls_tpu_torch.core.types import GuestInput, Request
from zktls_tpu_torch.guest import journal
from zktls_tpu_torch.guest.crypto.ec import SECP256K1
from zktls_tpu_torch.guest.crypto.keccak import keccak256
from zktls_tpu_torch.guest.origin import recover_origin_signer
from zktls_tpu_torch.guest.program import run_guest
from zktls_tpu_torch.guest.replay import ReplayError
from zktls_tpu_torch.provers import stark as tstark
from zktls_tpu_torch.workload import SESSION_GUEST_INPUT

from .test_suites import _record_session, cert_pair  # noqa: F401
from .torch_threads import torch_threads_per_worker  # noqa: F401

#: the committed session's chain report (one self-signed certificate)
SESSION_CHAIN = {
    "hostname_match": True, "validity": True, "signatures": True,
    "anchored": False, "root_spki_sha256":
    "90b0c5f1760d339a3d12a1abf60ccd08760d542d1c38259654c95efb485ed45c"}


def _plain(x):
    """Any replay object → plain data, with the type's name and every field
    (dataclass fields or instance attributes), so the two packages' objects
    compare field by field."""
    if isinstance(x, (bytes, bytearray, str, int, float, bool, type(None))):
        return x
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, np.ndarray):
        return x.tolist()
    if dataclasses.is_dataclass(x):
        return (type(x).__name__, {f.name: _plain(getattr(x, f.name))
                                   for f in dataclasses.fields(x)})
    return (type(x).__name__, _plain(vars(x)))


def _both(gi_bytes: bytes, **kw):
    """(the port's GuestOutput, the reference's) of one GuestInput."""
    return (run_guest(GuestInput.from_cbor(gi_bytes), **kw),
            jrun_guest(JGuestInput.from_cbor(gi_bytes), **kw))


@pytest.fixture(scope="module")
def committed():
    gi_bytes = SESSION_GUEST_INPUT.read_bytes()
    out, ref = _both(gi_bytes, require_trust_anchor=False)
    return {"gi": gi_bytes, "out": out, "ref": ref}


def test_guest_input_codecs_equal_reference(committed):
    """The port's data model reads and writes the reference's bytes: CBOR
    round-trips, and the JSON forms (GuestInput, Request, with an origin
    and a target) are the same text."""
    gi_bytes = committed["gi"]
    gi, jgi = GuestInput.from_cbor(gi_bytes), JGuestInput.from_cbor(gi_bytes)
    assert gi.to_cbor() == jgi.to_cbor() == gi_bytes
    assert gi.to_json() == jgi.to_json()
    assert GuestInput.from_json(jgi.to_json()).to_cbor() == gi_bytes
    jgi.request.origin = JRequestOrigin(type="secp256k1",
                                        signature=bytes(range(65)), nonce=9)
    jgi.request.target = JRequestTarget(client=bytes(range(20)),
                                        prover_id=bytes(range(32)),
                                        submit_network_id=5)
    text = jgi.request.to_json()
    req = Request.from_json(text)
    assert req.to_json() == text and req.to_cbor() == jgi.request.to_cbor()
    assert GuestInput.from_cbor(jgi.to_cbor()).to_json() == jgi.to_json()


def test_run_guest_equals_reference_in_every_field(committed):
    out, ref = committed["out"], committed["ref"]
    assert _plain(out) == _plain(ref)
    assert out.journal == ref.journal and len(out.journal) == 1056
    assert out.chain == ref.chain == SESSION_CHAIN
    assert out.replay.cipher_suite.id == 0xC02F
    assert out.replay.curve_name == ref.replay.curve_name == "secp256r1"
    assert out.replay.sha512_recorder is ref.replay.sha512_recorder is None


def test_event_streams_equal_reference_in_order(committed):
    """The chips' inputs: SHA-256 compressions (obj, seq, result tag and
    exposed blocks included), ModMul statements, GCM records and the
    per-record stream metadata."""
    out, ref = committed["out"], committed["ref"]
    assert out.replay.sha256_recorder.events == \
        events_from_reference(ref.replay.sha256_recorder.events)
    assert len(out.replay.sha256_recorder.events) == 187
    assert [(e.a, e.b, e.r, e.m) for e in out.modmul_events] == \
        [(e.a, e.b, e.r, e.m) for e in ref.modmul_events]
    assert len(out.modmul_events) == 5896
    assert _plain(out.replay.gcm_events) == _plain(ref.replay.gcm_events)
    assert len(out.replay.gcm_events) == 5
    assert _plain(out.gcm_metas) == _plain(ref.gcm_metas)


def test_keys_randoms_and_plaintexts_equal_reference(committed):
    rep, ref = committed["out"].replay, committed["ref"].replay
    for name in ("client_random", "server_random", "premaster_secret",
                 "master_secret", "session_hash", "client_write_key",
                 "server_write_key", "client_iv", "server_iv",
                 "request_plaintext", "response_plaintext",
                 "certificate_chain", "handshake_transcript"):
        assert getattr(rep, name) == getattr(ref, name), name
    curve, scalar, point = rep.ecdhe_weierstrass
    assert (curve.name, scalar, point) == (
        ref.ecdhe_weierstrass[0].name, *ref.ecdhe_weierstrass[1:])
    assert rep.checks == ref.checks and all(rep.checks.values())


def test_run_guest_requires_a_trust_anchor_by_default(committed):
    with pytest.raises(ReplayError, match="does not anchor"):
        run_guest(GuestInput.from_cbor(committed["gi"]))
    with pytest.raises(JReplayError, match="does not anchor"):
        jrun_guest(JGuestInput.from_cbor(committed["gi"]))


def test_flipped_stream_byte_raises_in_both(committed):
    gi = GuestInput.from_cbor(committed["gi"])
    stream = bytearray(gi.response.stream)
    stream[-30] ^= 1                      # inside the last record
    gi.response.stream = bytes(stream)
    bad = gi.to_cbor()
    with pytest.raises(ReplayError):
        run_guest(GuestInput.from_cbor(bad), require_trust_anchor=False)
    with pytest.raises(JReplayError):
        jrun_guest(JGuestInput.from_cbor(bad), require_trust_anchor=False)


def test_origin_signer_equals_reference(committed):
    """A request signed with the reference's sign_origin: the port recovers
    the same signer, and both journals publish it."""
    priv = 0x1D2C3B4A5F6E7D8C9B0A1F2E3D4C5B6A79881726354453627181920A0B0C0D0E
    jgi = JGuestInput.from_cbor(committed["gi"])
    jgi.request.origin = JRequestOrigin(type="secp256k1",
                                        signature=b"\x00" * 65, nonce=7)
    jgi.request.origin.signature = sign_origin(jgi.request, priv)
    pub = SECP256K1.mul(priv, SECP256K1.g)
    want = keccak256(pub[0].to_bytes(32, "big")
                     + pub[1].to_bytes(32, "big"))[12:]
    gi_bytes = jgi.to_cbor()
    assert recover_origin_signer(GuestInput.from_cbor(gi_bytes).request) \
        == want
    out, ref = _both(gi_bytes, require_trust_anchor=False)
    assert _plain(out) == _plain(ref)
    assert journal.decode_journal(out.journal)["origin_signer"] == want
    assert len(out.modmul_events) > len(committed["out"].modmul_events)


def test_journal_codec_equals_reference(committed):
    j = committed["out"].journal
    assert journal.decode_journal(j) == jjournal.decode_journal(j)
    gi, jgi = (GuestInput.from_cbor(committed["gi"]),
               JGuestInput.from_cbor(committed["gi"]))
    kw = dict(response_plaintext=b"HTTP/1.1 200 OK\r\n\r\nbody",
              root_spki_sha256=bytes(range(32)),
              origin_signer=bytes(range(20)),
              stream_sha256=bytes(range(32, 64)), gcm_records=b"\x01" * 37)
    mine = journal.encode_journal(gi, **kw)
    assert mine == jjournal.encode_journal(jgi, **kw)
    assert journal.decode_journal(mine)["gcm_records"] == b"\x01" * 37
    items = [("uint64", 5), ("bytes32", bytes(32)), ("string", "héllo"),
             ("address", bytes(20)), ("uint64[]", [1, 2, 3]),
             ("bytes[]", [b"", b"x" * 33]), ("bytes", b"abc")]
    assert journal.abi_encode(items) == jjournal.abi_encode(items)


# ---------------------------------------------------------------------------
# loopback sessions of the other suites
# ---------------------------------------------------------------------------

SUITES = {
    0x1301: dict(offered=[0x1301]),
    0x1302: dict(offered=[0x1302]),
    0x1303: dict(offered=[0x1303]),
    0xC030: dict(tls12_ciphers="ECDHE-RSA-AES256-GCM-SHA384"),
    0xCCA8: dict(tls12_ciphers="ECDHE-RSA-CHACHA20-POLY1305"),
}


@pytest.fixture(scope="module")
def loopback(cert_pair):  # noqa: F811
    """suite → (the port's GuestOutput, the reference's) of one recorded
    session."""
    return {suite: _both(_record_session(cert_pair, **kw).to_cbor(),
                         require_trust_anchor=False)
            for suite, kw in SUITES.items()}


@pytest.mark.parametrize("suite", sorted(SUITES), ids=lambda s: f"{s:04x}")
def test_loopback_run_guest_equals_reference(loopback, suite):
    out, ref = loopback[suite]
    assert out.replay.cipher_suite.id == suite
    assert _plain(out) == _plain(ref)
    assert out.replay.sha256_recorder.events == \
        events_from_reference(ref.replay.sha256_recorder.events)
    has_512 = suite in (0xC030, 0x1302)
    assert (out.replay.sha512_recorder is not None) == has_512
    assert bool(out.replay.chacha_events) == (suite in (0xCCA8, 0x1303))
    assert out.v13 == (suite >> 8 == 0x13)


def test_loopback_tls13_chips_equal_reference(loopback):
    """0x1301 (AES-128-GCM, SHA-256) is a suite the port's chips cover: its
    chip set equals the reference's, chip for chip."""
    out, ref = loopback[0x1301]
    mine, want = tstark.build_chip_instances(out), \
        jstark.build_chip_instances(ref)
    assert [c.air.name for c in mine] == [c.air.name for c in want]
    for m, w in zip(mine, want):
        np.testing.assert_array_equal(m.trace, np.asarray(w.trace))
        assert m.publics == [int(v) for v in w.publics]
