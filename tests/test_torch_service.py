"""The port's prover service (provers/service.py), its client and the CLI's
`prove --network` and `serve`, against the JAX package's.

In-process services with MockProver on the loopback: each package's client
against the other's service (the wire protocol is the reference's), the
remote journal against the local MockProver's on the committed sessions,
the error statuses, and a stark service on a host without a card, which
must answer 500 and prove nothing on the CPU."""

import http.client
import json
import pathlib
import socket
import subprocess
import sys
import time

import pytest
import torch

from zktls_tpu.core.types import GuestInput as JGuestInput
from zktls_tpu.guest import roots as jroots
from zktls_tpu.provers.mock import MockProver as JMockProver
from zktls_tpu.provers import service as jservice
from zktls_tpu_torch.cli import main
from zktls_tpu_torch.core import cbor
from zktls_tpu_torch.core.types import GuestInput
from zktls_tpu_torch.guest import roots
from zktls_tpu_torch.provers import service
from zktls_tpu_torch.provers import stark as tstark
from zktls_tpu_torch.provers.mock import MockProver
from zktls_tpu_torch.workload import SESSIONS

from .torch_threads import torch_threads_per_worker  # noqa: F401

NAMES = ("1303", "c02f")
PACKAGES = {"port": (service, MockProver), "jax": (jservice, JMockProver)}


@pytest.fixture
def anchored(monkeypatch):
    """Both packages' trust stores with the committed sessions' leaves."""
    leaves = {bytes.fromhex(SESSIONS[n].chain["root_spki_sha256"])
              for n in NAMES}
    for mod in (roots, jroots):
        store = mod.anchor_spki_hashes() | leaves
        monkeypatch.setattr(mod, "anchor_spki_hashes", lambda s=store: s)


@pytest.fixture
def services():
    """A running MockProver service of each package."""
    running = {k: mod.ProverService(prover()).start()
               for k, (mod, prover) in PACKAGES.items()}
    yield running
    for svc in running.values():
        svc.stop()


def _gi_bytes(name: str) -> bytes:
    return SESSIONS[name].guest_input.read_bytes()


@pytest.mark.parametrize("client", sorted(PACKAGES))
@pytest.mark.parametrize("server", sorted(PACKAGES))
def test_each_client_proves_on_each_service(anchored, services, client,
                                            server):
    """The remote journal equals the local MockProver's on the committed
    0x1303 and c02f sessions, whichever package serves or asks; health
    names the prover."""
    mod = PACKAGES[client][0]
    remote = mod.RemoteGuestProver(services[server].url)
    assert remote.health() == {"status": "ok", "prover":
                               PACKAGES[server][1].__name__}
    for name in NAMES:
        gi = (GuestInput if client == "port" else JGuestInput).from_cbor(
            _gi_bytes(name))
        journal, proof = remote.prove(gi)
        assert (journal, proof) == MockProver().prove(
            GuestInput.from_cbor(_gi_bytes(name)))
        assert len(journal) == SESSIONS[name].journal_bytes


def test_tampered_tape_is_500(anchored, services):
    gi = GuestInput.from_cbor(_gi_bytes("1303"))
    stream = bytearray(gi.response.stream)
    stream[-30] ^= 1
    gi.response.stream = bytes(stream)
    for url in (services["port"].url, services["jax"].url):
        with pytest.raises(RuntimeError,
                           match="remote prove failed: HTTP Error 500"):
            service.RemoteGuestProver(url).prove(gi)


def _post(url: str, body: bytes, length: str | None = None):
    """(status, CBOR reply, whether the server then closed the
    connection — checked only when `length` overrides Content-Length)."""
    host, port = url.removeprefix("http://").split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    conn.putrequest("POST", "/v1/prove")
    conn.putheader("Content-Length", length or str(len(body)))
    conn.endheaders(body)
    resp = conn.getresponse()
    status, obj = resp.status, dict(cbor.loads(resp.read()))
    closed = length is not None and conn.sock.recv(1) == b""
    conn.close()
    return status, obj, closed


@pytest.mark.parametrize("case", ["bad cbor", "truncated", "zero length",
                                  "over 64 MiB"])
def test_bad_bodies_are_400_in_both(services, case):
    """A body that is no GuestInput, a truncated one, and a bad
    Content-Length (the body unread: the connection is dropped) get 400,
    from either package's service."""
    good = _gi_bytes("1303")
    body, length = {"bad cbor": (b"\xff\x00not cbor", None),
                    "truncated": (good[: len(good) // 2], None),
                    "zero length": (b"", "0"),
                    "over 64 MiB": (b"", str((64 << 20) + 1))}[case]
    for svc in services.values():
        status, obj, closed = _post(svc.url, body, length)
        assert status == 400 and obj["error"]
        if length is not None:
            assert obj == {"error": "bad Content-Length"} and closed
    assert _post(services["port"].url, good)[0] == 500   # unanchored


def test_stark_service_without_a_card_answers_500(monkeypatch):
    """serve("stark") starts on a host without a card; each prove gets 500
    with the prover's "no CUDA device" error, and nothing is proved on the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    proved = []
    monkeypatch.setattr(tstark.StarkGuestProver, "prove",
                        lambda self, gi, timings=None: proved.append(gi))
    svc = service.serve("stark", "127.0.0.1", 0).start()
    try:
        remote = service.RemoteGuestProver(svc.url)
        assert remote.health() == {"status": "ok",
                                   "prover": "StarkGuestProver"}
        for _ in range(2):
            with pytest.raises(RuntimeError, match="500.*no CUDA device"):
                remote.prove(GuestInput.from_cbor(_gi_bytes("1303")))
    finally:
        svc.stop()
    assert proved == []


def test_cli_network_proves_through_a_service(anchored, services, tmp_path,
                                              capsys):
    """`prove --network --server URL`: the lines and JSON of a local
    `--mock` prove, from either package's service; without --server, exit
    2 as in the reference."""
    gi = GuestInput.from_cbor(_gi_bytes("1303"))
    req = tmp_path / "request.json"
    req.write_text(gi.request.to_json())
    args = ["prove", "-i", str(req), "--fixture",
            str(SESSIONS["1303"].guest_input)]
    assert main(args + ["--mock", "-o", str(tmp_path / "mock.json")]) == 0
    local = capsys.readouterr().out
    for svc in services.values():
        out = tmp_path / "net.json"
        assert main(args + ["--network", "--server", svc.url, "-o",
                            str(out)]) == 0
        assert capsys.readouterr().out == local
        assert json.loads(out.read_text()) == json.loads(
            (tmp_path / "mock.json").read_text())
    assert main(args + ["--network"]) == 2
    assert "--network needs --server" in capsys.readouterr().err


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_cli_serve_answers_the_reference_client(anchored):
    """`python -m zktls_tpu_torch.cli serve -p mock --port P` in a process
    of its own: health, then the JAX package's client gets a 400 for a bad
    body and a 500 for the unanchored session (the trust-store patch does
    not reach the child)."""
    port = _free_port()
    root = pathlib.Path(__file__).resolve().parents[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "zktls_tpu_torch.cli", "serve", "-p", "mock",
         "--port", str(port)], cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE)
    url = f"http://127.0.0.1:{port}"
    try:
        remote = jservice.RemoteGuestProver(url)
        deadline = time.monotonic() + 120
        while True:
            try:
                health = remote.health()
                break
            except OSError:
                assert proc.poll() is None and time.monotonic() < deadline
                time.sleep(0.2)
        assert health == {"status": "ok", "prover": "MockProver"}
        assert _post(url, b"\xff")[0] == 400
        with pytest.raises(RuntimeError, match="500.*does not anchor"):
            remote.prove(JGuestInput.from_cbor(_gi_bytes("1303")))
    finally:
        proc.terminate()
        proc.communicate(timeout=30)


def test_service_and_recorder_without_jax_or_cryptography():
    """In a process of its own: a live loopback recording with the
    committed test certificate (`workload.record_loopback`), proved through
    an in-process mock service by the port's client, and the modules of
    the single-AIR prover — with no module of jax, zktls_tpu or
    cryptography imported."""
    code = (
        "import sys\n"
        "from unittest import mock\n"
        "from zktls_tpu_torch.guest import roots\n"
        "from zktls_tpu_torch.guest.program import run_guest\n"
        "from zktls_tpu_torch.provers.mock import MockProver\n"
        "from zktls_tpu_torch.provers.service import ProverService, "
        "RemoteGuestProver\n"
        "from zktls_tpu_torch.stark import prover, verifier\n"
        "from zktls_tpu_torch.workload import record_loopback\n"
        "gi = record_loopback(0x1303)\n"
        "out = run_guest(gi, require_trust_anchor=False)\n"
        "leaf = bytes.fromhex(out.chain['root_spki_sha256'])\n"
        "store = roots.anchor_spki_hashes() | {leaf}\n"
        "svc = ProverService(MockProver()).start()\n"
        "with mock.patch.object(roots, 'anchor_spki_hashes', "
        "lambda: store):\n"
        "    journal, _ = RemoteGuestProver(svc.url).prove(gi)\n"
        "svc.stop()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'zktls_tpu', 'cryptography'))\n"
        "print(journal == out.journal, len(journal), bad)\n")
    root = pathlib.Path(__file__).resolve().parents[1]
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert res.stdout.strip() == "True 1248 []", res.stdout + res.stderr
