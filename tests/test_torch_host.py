"""The port's live recorder (host/recorder.py), its input builder and the
CLI's live `prove`, against the JAX package's.

Sessions are recorded on the loopback against a one-connection Python
`ssl` server with the committed test certificate
(`workload.loopback_server`), on five suites; every tape must replay in
both packages' run_guest with equal journals, and a tape of the JAX
package's recorder in the port's."""

import json
import re
import socket

import numpy as np
import pytest

from zktls_tpu.core.types import GuestInput as JGuestInput
from zktls_tpu.core.types import OffsetTemplate as JOffsetTemplate
from zktls_tpu.core.types import PrefixTemplate as JPrefixTemplate
from zktls_tpu.core.types import RegexTemplate as JRegexTemplate
from zktls_tpu.core.types import Request as JRequest
from zktls_tpu.guest.program import run_guest as jrun_guest
from zktls_tpu.host import input_builder as jinput_builder
from zktls_tpu.host import recorder as jrecorder
from zktls_tpu_torch.cli import main
from zktls_tpu_torch.core.tape import stream_halves
from zktls_tpu_torch.core.types import (
    GuestInput,
    OffsetTemplate,
    PrefixTemplate,
    RegexTemplate,
)
from zktls_tpu_torch.guest import roots
from zktls_tpu_torch.guest.crypto.ec import P256
from zktls_tpu_torch.guest.crypto.x25519 import x25519_base
from zktls_tpu_torch.guest.program import run_guest
from zktls_tpu_torch.guest.tls import (
    ClientHello,
    HandshakeType,
    iter_handshake_messages,
    parse_records,
)
from zktls_tpu_torch.host import input_builder, recorder
from zktls_tpu_torch.host.input_builder import TLSInputBuilder
from zktls_tpu_torch.workload import (
    LOOPBACK_TLS12,
    loopback_request,
    loopback_server,
    record_loopback,
)

from .torch_threads import torch_threads_per_worker  # noqa: F401

SUITES = (0xC02F, 0x1301, 0x1302, 0x1303, 0xCCA8)


def _seeded_rng(seed: int):
    rng = np.random.default_rng(seed)
    draws = []

    def draw(n: int) -> bytes:
        draws.append(rng.bytes(n))
        return draws[-1]

    return draw, draws


def _replays(gi_bytes: bytes):
    mine = run_guest(GuestInput.from_cbor(gi_bytes),
                     require_trust_anchor=False)
    ref = jrun_guest(JGuestInput.from_cbor(gi_bytes),
                     require_trust_anchor=False)
    return mine, ref


@pytest.mark.parametrize("suite", SUITES, ids=[f"{s:04x}" for s in SUITES])
def test_port_tape_replays_in_both_packages(suite):
    gi = record_loopback(suite)
    mine, ref = _replays(gi.to_cbor())
    assert mine.replay.cipher_suite.id == ref.replay.cipher_suite.id == suite
    assert mine.journal == ref.journal
    assert len(mine.journal) == (1056 if suite in LOOPBACK_TLS12 else 1248)
    assert gi.response.filtered_responses == [
        gi.response.response[gi.response.filtered_responses_begin[0]:][:10]]


@pytest.mark.parametrize("suite", [0xC02F, 0x1303], ids=["c02f", "1303"])
def test_reference_tape_replays_in_the_port(suite, monkeypatch):
    """A tape of the JAX package's recorder gives the port's run_guest the
    reference's journal."""
    if suite not in LOOPBACK_TLS12:
        monkeypatch.setattr(jrecorder, "_OFFERED_SUITES", [suite])
    with loopback_server(suite) as port:
        req = JRequest.from_json(loopback_request(port).to_json())
        gi = jinput_builder.TLSInputBuilder().build_input(req)
    mine, ref = _replays(gi.to_cbor())
    assert mine.replay.cipher_suite.id == suite
    assert mine.journal == ref.journal


def _client_handshake(gi) -> list:
    """The client's plaintext handshake messages (before its first
    ChangeCipherSpec)."""
    c2s, _ = stream_halves(gi.response.stream)
    out = []
    for r in parse_records(c2s):
        if r.typ != 22:
            break
        out += iter_handshake_messages(r.payload)
    return out


@pytest.mark.parametrize("suite", [0xC02F, 0x1303], ids=["c02f", "1303"])
def test_fixed_rng_draws_are_the_tape_random(suite):
    """With a seeded rng the tape's `random` is exactly the client's draws,
    in the documented layout: [0:32] the x25519 key-share scalar, [32:64]
    the session id, [64:96] the client random, [96:98] the reserved draw,
    then (TLS 1.2) the P-256 ECDHE scalar; a second recording with the same
    seed draws the same bytes."""
    rng, draws = _seeded_rng(11)
    gi = record_loopback(suite, rng=rng)
    random = gi.response.random
    assert random == b"".join(draws)
    assert [len(d) for d in draws] == [32, 32, 32, 2] + (
        [32] if suite in LOOPBACK_TLS12 else [])
    hello = _client_handshake(gi)[0]
    assert hello.typ == HandshakeType.CLIENT_HELLO
    ch = ClientHello.parse(hello.body)
    assert ch.key_shares() == {29: x25519_base(random[0:32])}
    assert ch.session_id == random[32:64]
    assert ch.client_random == random[64:96]
    if suite in LOOPBACK_TLS12:
        ckx = next(m for m in _client_handshake(gi)
                   if m.typ == HandshakeType.CLIENT_KEY_EXCHANGE)
        scalar = int.from_bytes(random[98:130], "big")
        assert ckx.body[1:] == P256.encode_point(P256.mul(scalar, P256.g))
    again = record_loopback(suite, rng=_seeded_rng(11)[0])
    assert again.response.random == random
    assert run_guest(again, require_trust_anchor=False).replay \
        .cipher_suite.id == suite


def test_rng_of_the_wrong_length_is_refused():
    with pytest.raises(recorder.RecordingError, match="rng gave"):
        record_loopback(0xC02F, rng=lambda n: b"\0" * (n - 1))


def _templates(rng, response: bytes):
    """Seeded offset, prefix and regex templates over `response` (each in
    both packages' types), and the error cases."""
    b = int(rng.integers(0, len(response) - 40))
    n = int(rng.integers(1, 30))
    pre_at = int(rng.integers(0, len(response) - 60))
    prefix = response[pre_at : pre_at + 5]
    ok = [("offset", b, n), ("prefix", prefix, n), ("regex", rb"[0-9]{3,}")]
    bad = [("offset", len(response) - 3, 4), ("prefix", b"\xff\xfe", 1),
           ("prefix", b"#end", 2), ("regex", rb"zz[0-9]{40}")]
    return ok, bad


def _mk(kind, *a, ref=False):
    t = {"offset": (JOffsetTemplate if ref else OffsetTemplate),
         "prefix": (JPrefixTemplate if ref else PrefixTemplate),
         "regex": (JRegexTemplate if ref else RegexTemplate)}[kind]
    if kind == "offset":
        return t(begin=a[0], length=a[1])
    if kind == "prefix":
        return t(prefix=a[0], length=a[1])
    return t(regex=a[0].decode())


@pytest.mark.parametrize("seed", range(4))
def test_apply_templates_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    response = b"HTTP/1.1 200 OK\r\n\r\n" + bytes(
        rng.choice(list(b"abcdefghij0123456789 :{}\""), 400)) + b"#end"
    ok, bad = _templates(rng, response)
    mine = input_builder.apply_templates(response, [_mk(*t) for t in ok])
    ref = jinput_builder.apply_templates(
        response, [_mk(*t, ref=True) for t in ok])
    assert [(f.begin, f.length, f.bytes) for f in mine] == \
        [(f.begin, f.length, f.bytes) for f in ref]
    assert mine[2].bytes == re.search(rb"[0-9]{3,}", response).group()
    for t in bad:
        with pytest.raises(ValueError) as e_mine:
            input_builder.apply_templates(response, [_mk(*t)])
        with pytest.raises(ValueError) as e_ref:
            jinput_builder.apply_templates(response, [_mk(*t, ref=True)])
        assert str(e_mine.value) == str(e_ref.value)
    with pytest.raises(TypeError):
        input_builder.apply_templates(response, [object()])


def test_input_builder_records_the_request():
    """TLSInputBuilder.build_input: the request it was given, the filtered
    price bytes of the template, a tape the port replays."""
    with loopback_server(0xC02F) as port:
        req = loopback_request(port)
        gi = TLSInputBuilder(timeout=10).build_input(req)
    assert gi.request.to_json() == req.to_json()
    body = gi.response.response
    at = body.index(b'"price":"') + 9
    assert gi.response.filtered_responses_begin == [at]
    assert gi.response.filtered_responses == [body[at : at + 10]]
    assert run_guest(gi, require_trust_anchor=False).journal


def test_cli_prove_records_live(tmp_path, monkeypatch, capsys):
    """`prove --mock` without --fixture records the request's server live
    and prints the journal of the tape it recorded (the loopback leaf
    joined to the trust store, as for the committed sessions)."""
    probe = record_loopback(0xC02F)
    leaf = bytes.fromhex(run_guest(probe, require_trust_anchor=False)
                         .chain["root_spki_sha256"])
    store = roots.anchor_spki_hashes() | {leaf}
    monkeypatch.setattr(roots, "anchor_spki_hashes", lambda: store)
    recorded = []
    build = TLSInputBuilder.build_input

    def spy(self, request):
        recorded.append(build(self, request))
        return recorded[-1]

    monkeypatch.setattr(TLSInputBuilder, "build_input", spy)
    with loopback_server(0xC02F) as port:
        req = tmp_path / "request.json"
        req.write_text(loopback_request(port).to_json())
        out = tmp_path / "out.json"
        assert main(["prove", "-i", str(req), "--mock", "-o",
                     str(out)]) == 0
    assert len(recorded) == 1
    journal = run_guest(recorded[0]).journal
    assert capsys.readouterr().out.splitlines() == [
        f"output: 0x{journal.hex()}", "proof: 0x"]
    assert json.loads(out.read_text())["journal"] == "0x" + journal.hex()


def test_cli_live_recording_error_exits_1(tmp_path, capsys):
    """A server that refuses the connection: exit 1 with the error, and no
    other input is taken."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    req = tmp_path / "request.json"
    req.write_text(loopback_request(port).to_json())
    assert main(["prove", "-i", str(req), "--mock"]) == 1
    assert "error:" in capsys.readouterr().err
