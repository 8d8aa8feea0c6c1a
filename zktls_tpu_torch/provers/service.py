"""Prover service: remote proving over HTTP, replacing the reference's two
network proving paths — SP1's "moongate" GPU container (a twirp RPC service,
`crates/guest-prover-sp1/src/sp1.rs:87-96`, `SP1_MOONGATE_SERVER`) and
RISC0's Bonsai cloud (`crates/guest-prover-r0/src/prover.rs:26`,
`RISC0_PROVER=bonsai`).

Port copy of zktls_tpu.provers.service, with the same wire protocol, so
each package's client talks to the other's service.  The prover host owns
the card: a client records the TLS session locally (the tape must be
recorded where the request originates) and ships the `GuestInput` CBOR to
it; the service runs the guest replay and the STARK prover on the card and
returns `(journal, proof)`.

Wire protocol (all bodies CBOR, mirroring the reference's CBOR-everywhere
convention, SURVEY.md §2.3):

  POST /v1/prove      body: GuestInput CBOR
                      200: {"journal": bytes, "proof": bytes}
                      4xx/5xx: {"error": str}
  GET  /v1/health     200: {"status": "ok", "prover": "<class name>"}

The server URL is an argument (`RemoteGuestProver(server)`, the CLI's
`--server`); the port reads no environment variable for it.

Proves run one at a time, whatever the backend: a service fronts one
card, and the mock backend, which stands in for the card's prover in tests,
queues its requests the same way.  Each POST gets a request id (1, 2, …
per service); the service logs one INFO line per prove request that
reaches the prover, failed or not: `request <id>: waited <s> s, proved
<s> s`.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.request import Request as UrlRequest, urlopen

from ..core import cbor
from ..core.types import GuestInput

__all__ = ["ProverService", "RemoteGuestProver", "serve"]

log = logging.getLogger(__name__)

_MAX_BODY = 64 << 20  # 64 MiB cap on uploaded GuestInput


def _make_handler(service: "ProverService"):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # route into logging, not stderr
            log.debug("%s - %s", self.address_string(), fmt % args)

        def _reply(self, code: int, obj) -> None:
            body = cbor.dumps(obj)
            self.send_response(code)
            self.send_header("Content-Type", "application/cbor")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/v1/health":
                self._reply(200, {"status": "ok",
                                  "prover": service.prover_name})
            else:
                self._reply(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path != "/v1/prove":
                self._reply(404, {"error": f"no route {self.path}"})
                return
            rid = next(service.request_ids)
            length = int(self.headers.get("Content-Length", "0"))
            if length <= 0 or length > _MAX_BODY:
                # the body was never read: drop the connection rather than
                # let keep-alive parse the unread bytes as the next request
                self.close_connection = True
                self._reply(400, {"error": "bad Content-Length"})
                return
            data = self.rfile.read(length)
            try:
                guest_input = GuestInput.from_cbor(data)
            except Exception as e:
                self._reply(400, {"error": f"bad GuestInput CBOR: {e}"})
                return
            try:
                journal, proof = service.prove(rid, guest_input)
            except Exception as e:  # mirror upstream print-not-propagate
                log.exception("prove failed")
                self._reply(500, {"error": str(e)})
                return
            self._reply(200, {"journal": journal, "proof": proof})

    return Handler


class ProverService:
    """An HTTP prover service wrapping any ZkProver.  `start()` runs the
    server on a daemon thread (tests / embedding); `serve_forever()` blocks
    (the CLI `serve` command).  prover_name: what health reports (the
    prover's class name when None).  Proves run one at a time, for every
    backend (the module's docstring says why)."""

    def __init__(self, prover, host: str = "127.0.0.1", port: int = 0,
                 prover_name: str | None = None):
        self.prover = prover
        self.prover_name = prover_name or type(prover).__name__
        self.request_ids = itertools.count(1)
        self._prove_lock = threading.Lock()
        self._httpd = ThreadingHTTPServer((host, port), _make_handler(self))
        self._thread: threading.Thread | None = None

    def prove(self, rid: int, guest_input: GuestInput
              ) -> tuple[bytes, bytes]:
        """Request `rid`'s prove, once the prover is free; logs the
        request's seconds waited and proved."""
        t0 = time.perf_counter()
        self._prove_lock.acquire()
        t1 = time.perf_counter()
        try:
            return self.prover.prove(guest_input)
        finally:
            self._prove_lock.release()
            log.info("request %d: waited %.3f s, proved %.3f s", rid,
                     t1 - t0, time.perf_counter() - t1)

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "ProverService":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        log.info("prover service (%s) listening on %s",
                 self.prover_name, self.url)
        return self

    def serve_forever(self) -> None:
        log.info("prover service (%s) listening on %s",
                 self.prover_name, self.url)
        self._httpd.serve_forever()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)


class RemoteGuestProver:
    """ZkProver that delegates to a ProverService — the framework's
    `--network` mode (Bonsai / moongate-client analogue)."""

    def __init__(self, server: str, timeout: float = 3600.0):
        self.server = server.rstrip("/")
        self.timeout = timeout

    def health(self) -> dict:
        with urlopen(f"{self.server}/v1/health",
                     timeout=min(self.timeout, 30.0)) as resp:
            return dict(cbor.loads(resp.read()))

    def prove(self, guest_input: GuestInput) -> tuple[bytes, bytes]:
        req = UrlRequest(
            f"{self.server}/v1/prove",
            data=guest_input.to_cbor(),
            headers={"Content-Type": "application/cbor"},
            method="POST",
        )
        try:
            with urlopen(req, timeout=self.timeout) as resp:
                obj = dict(cbor.loads(resp.read()))
        except Exception as e:
            body = getattr(e, "read", lambda: b"")()
            try:
                detail = dict(cbor.loads(body)).get("error", "")
            except Exception:
                detail = body.decode("utf-8", "replace")[:200]
            raise RuntimeError(
                f"remote prove failed: {e}"
                + (f" ({detail})" if detail else "")) from e
        return bytes(obj["journal"]), bytes(obj["proof"])


class _StarkOnFirstProve:
    """`StarkGuestProver()`, built at the first prove request and kept: a
    service starts on a host without a card and answers each prove there
    with the prover's "no CUDA device" error (500), never on the CPU.
    Its service calls it one request at a time."""

    def __init__(self):
        self._prover = None

    def prove(self, guest_input: GuestInput) -> tuple[bytes, bytes]:
        if self._prover is None:
            from .stark import StarkGuestProver

            self._prover = StarkGuestProver()
        return self._prover.prove(guest_input)


def serve(prover_kind: str, host: str, port: int) -> ProverService:
    """Build the service for a CLI-selected prover backend."""
    if prover_kind == "mock":
        from .mock import MockProver

        return ProverService(MockProver(), host=host, port=port)
    return ProverService(_StarkOnFirstProve(), host=host, port=port,
                         prover_name="StarkGuestProver")
