"""The benchmark's one traffic generator: live TLS sessions recorded from a
seed against a loopback server.

A traffic mix (`traffic/<name>.json`) gives the response's body size, the
number of application-data records the server writes it in, the filter
the request applies and how many sessions a run records.  A configuration
(`configs/<name>.json`) gives the suite, the protocol version, the key
exchange group, the certificate and the time the recordings pin.

`Loopback` is a TLS server on 127.0.0.1 (Python's `ssl`, the committed
self-signed RSA-2048 test pair in `data/`) that serves its connections in
order, one at a time, each with the response queued for it.  `record`
drives it with the frozen recording client (`zkref.host`): session i of a
run gets a body and client randomness drawn from (seed, i), so a seed fixes
everything but the server's own draws, and the chips every session of a
cell builds have the same shapes.
"""

from __future__ import annotations

import hashlib
import json
import socket
import ssl
import threading
from dataclasses import dataclass
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ALPHABET = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz0123456789",
                         dtype=np.uint8)
REQUEST_PATH = b"/v1/price?symbol=ETHUSD"
SERVER_NAME = "localhost"


def load_json(kind: str, name: str) -> dict:
    """`configs/<name>.json` or `traffic/<name>.json`."""
    return json.loads((HERE / kind / f"{name}.json").read_text())


def session_rng(seed: int, index: int) -> np.random.Generator:
    """The generator of session `index` of a run with `seed` (any integer)."""
    return np.random.default_rng(
        np.random.SeedSequence([abs(seed), int(seed < 0), index]))


def response_records(mix: dict, rng: np.random.Generator) -> list[bytes]:
    """The HTTP response of one session, as the records the server writes:
    a JSON body of `body_bytes` (a 10-digit-style filtered field after the
    filter's prefix, then seeded letters and digits) split into `records`
    equal parts, the header in front of the first."""
    prefix = mix["filter"]["prefix"].encode()
    value = "".join(str(d) for d in rng.integers(
        0, 10, mix["filter"]["length"])).encode()
    head = b'{"symbol":"ETHUSD",' + prefix + value + b'","data":"'
    tail = b'"}'
    n = mix["body_bytes"]
    pad = ALPHABET[rng.integers(0, len(ALPHABET),
                                n - len(head) - len(tail))].tobytes()
    body = head + pad + tail
    header = (b"HTTP/1.1 200 OK\r\nContent-Type: application/json\r\n"
              b"Content-Length: " + str(n).encode() + b"\r\n\r\n")
    k = mix["records"]
    if n % k:
        raise ValueError(f"{n} body bytes do not split into {k} records")
    step = n // k
    parts = [body[i * step:(i + 1) * step] for i in range(k)]
    parts[0] = header + parts[0]
    return parts


def request_bytes() -> bytes:
    return (b"GET " + REQUEST_PATH + b" HTTP/1.1\r\nHost: "
            + SERVER_NAME.encode() + b"\r\nConnection: close\r\n\r\n")


@dataclass
class Sent:
    """What the benchmark knows of a session without the program: the
    request, the response the server wrote and the filtered bytes in it."""

    request: bytes
    response: bytes
    filtered_begin: int
    filtered: bytes


class Loopback:
    """A TLS server on 127.0.0.1 for one configuration: serves connections
    one at a time, in order, each with the next queued response (a list of
    records, one write each).  Use as a context manager; `port` once
    entered."""

    def __init__(self, config: dict):
        tls = config["tls"]
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        version = {"1.2": ssl.TLSVersion.TLSv1_2,
                   "1.3": ssl.TLSVersion.TLSv1_3}[tls["version"]]
        ctx.minimum_version = ctx.maximum_version = version
        if tls["version"] == "1.2":
            ctx.set_ciphers(tls["server_ciphers"])
            ctx.set_ecdh_curve(tls["server_curve"])
        cert = config["certificate"]
        ctx.load_cert_chain(HERE / cert["cert"], HERE / cert["key"])
        self.ctx = ctx
        self.queue: list[list[bytes]] = []
        self.lock = threading.Lock()
        self.ready = threading.Condition(self.lock)
        self.closed = False

    def __enter__(self) -> "Loopback":
        self.srv = socket.socket()
        self.srv.bind(("127.0.0.1", 0))
        self.srv.listen(1)
        self.port = self.srv.getsockname()[1]
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()
        return self

    def __exit__(self, *exc) -> None:
        with self.lock:
            self.closed = True
            self.ready.notify_all()
        self.srv.close()
        self.thread.join(timeout=30)
        if self.thread.is_alive():
            raise RuntimeError("loopback server did not stop")

    def push(self, records: list[bytes]) -> None:
        with self.lock:
            self.queue.append(records)
            self.ready.notify_all()

    def _serve(self) -> None:
        while True:
            with self.lock:
                while not self.queue and not self.closed:
                    self.ready.wait()
                if self.closed:
                    return
                records = self.queue.pop(0)
            try:
                conn, _ = self.srv.accept()
            except OSError:
                return                      # closed
            try:
                tls = self.ctx.wrap_socket(conn, server_side=True)
                got = b""
                while b"\r\n\r\n" not in got:
                    chunk = tls.recv(4096)
                    if not chunk:
                        raise OSError("client closed before its request")
                    got += chunk
                for rec in records:
                    tls.sendall(rec)
                tls.unwrap()
            except (OSError, ssl.SSLError):
                pass  # the client closes without a close_notify; a session
                # that went wrong fails in the recorder
            finally:
                conn.close()


def record(config: dict, mix: dict, seed: int, indices) -> list:
    """Record sessions `indices` of a run with `seed`: [(GuestInput CBOR
    bytes, Sent)], in order.  The GuestInput is the frozen recorder's; the
    program decodes its own copy from the bytes."""
    from zkref.core.types import PrefixTemplate, Request, RequestInfo
    from zkref.host.input_builder import TLSInputBuilder

    tls = config["tls"]
    suites = None if tls["version"] == "1.2" else [int(tls["suite"], 16)]
    out = []
    with Loopback(config) as server:
        for i in indices:
            rng = session_rng(seed, i)
            records = response_records(mix, rng)
            client = np.random.default_rng(rng.integers(0, 2**63))
            server.push(records)
            req = Request(
                version=1,
                request_info=RequestInfo(
                    request=request_bytes(),
                    remote_addr=f"127.0.0.1:{server.port}",
                    server_name=SERVER_NAME),
                response_template=[PrefixTemplate(
                    prefix=mix["filter"]["prefix"].encode(),
                    length=mix["filter"]["length"])])
            gi = TLSInputBuilder(
                rng=lambda n, c=client: c.bytes(n), suites=suites,
                now=config["recorded_at"]).build_input(req)
            response = b"".join(records)
            begin = (response.index(mix["filter"]["prefix"].encode())
                     + len(mix["filter"]["prefix"]))
            out.append((gi.to_cbor(), Sent(
                request=req.request_info.request, response=response,
                filtered_begin=begin,
                filtered=response[begin:begin + mix["filter"]["length"]])))
    return out


def leaf_spki_sha256(config: dict) -> bytes:
    """SHA-256 of the test certificate's SubjectPublicKeyInfo: the root a
    journal of this configuration names (the chain is the one self-signed
    leaf)."""
    from zkref.guest.der import pem_blocks, pem_to_der
    from zkref.guest.x509 import Certificate

    pem = (HERE / config["certificate"]["cert"]).read_bytes()
    cert = Certificate.parse(pem_to_der(next(iter(pem_blocks(pem)))))
    return hashlib.sha256(cert._cert.spki).digest()
