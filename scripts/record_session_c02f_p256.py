"""Record the TLS sessions that the PyTorch port proves.

Each is a loopback session against a local OpenSSL server (Python's `ssl`)
with a self-signed 2048-bit RSA certificate and a response body of 512
seeded ASCII bytes (a JSON answer, one field of which the request's
template filters).  `--suite` picks the session:

* `c02f` (the default): TLS 1.2 ECDHE-RSA-AES128-GCM-SHA256, the server
  limited to the P-256 group;
* `1302`: TLS 1.3 with the recorder's default suite list, which a default
  OpenSSL server answers with TLS_AES_256_GCM_SHA384 (0x1302), over x25519;
* `1303`: TLS 1.3 with TLS_CHACHA20_POLY1305_SHA256 (0x1303) as the one
  suite offered, over x25519.

TLS 1.3 sessions leave the server's groups alone: the recorder offers only
an x25519 key share.  The recording is made by the JAX package's recorder
(`zktls_tpu.host.input_builder.TLSInputBuilder`), so this script needs the
`cryptography` package and is run once, off the card machine:

    JAX_PLATFORMS=cpu python scripts/record_session_c02f_p256.py [--suite 1302]

It writes `zktls_tpu_torch/data/<session>.guest_input.cbor` (the file
`zktls_tpu_torch.workload.SESSIONS` names), the recorded GuestInput, which
the port replays with its own `run_guest`.  A new recording changes every
digest of that session's proof (`proof_sha256` and `chain` in
`workload.SESSIONS`, which chip_smoke.py holds the card to).

    python scripts/record_session_c02f_p256.py --make-cert

instead writes the self-signed test certificate and key for `localhost`
that the port's loopback server uses (`workload.LOOPBACK_CERT`,
`LOOPBACK_KEY`: tests and chip_smoke.py only), so that a host without
`cryptography` can run that server.  A new pair changes the live
recordings' leaf SPKI hash, nothing committed.
"""

from __future__ import annotations

import argparse
import datetime
import pathlib
import socket
import ssl
import sys
import tempfile
import threading

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from zktls_tpu_torch.workload import (  # noqa: E402
    LOOPBACK_CERT,
    LOOPBACK_KEY,
    loopback_request,
    loopback_response,
)

DATA = ROOT / "zktls_tpu_torch" / "data"
#: suite → (the GuestInput file, the TLS 1.3 suites offered: None for the
#: TLS 1.2 session, () for the recorder's default list)
SUITES = {
    "c02f": ("session_c02f_p256.guest_input.cbor", None),
    "1302": ("session_1302_x25519.guest_input.cbor", ()),
    "1303": ("session_1303_x25519.guest_input.cbor", (0x1303,)),
}
def _self_signed(tmp: pathlib.Path) -> tuple[pathlib.Path, pathlib.Path]:
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    from cryptography.x509.oid import NameOID

    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, "localhost")])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (x509.CertificateBuilder().subject_name(name).issuer_name(name)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(days=1))
            .not_valid_after(now + datetime.timedelta(days=3650))
            .add_extension(x509.SubjectAlternativeName(
                [x509.DNSName("localhost")]), critical=False)
            .sign(key, hashes.SHA256()))
    certfile, keyfile = tmp / LOOPBACK_CERT.name, tmp / LOOPBACK_KEY.name
    certfile.write_bytes(cert.public_bytes(serialization.Encoding.PEM))
    keyfile.write_bytes(key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.TraditionalOpenSSL,
        serialization.NoEncryption()))
    return certfile, keyfile


def record(tls13_offered: tuple[int, ...] | None) -> bytes:
    """Record one session on the loopback; returns the GuestInput CBOR.
    tls13_offered: None for the TLS 1.2 0xC02F/P-256 session, else a TLS
    1.3 session offering these suites (the recorder's default list if
    empty)."""
    import zktls_tpu.host.recorder as recorder
    from zktls_tpu.core.types import Request
    from zktls_tpu.host.input_builder import TLSInputBuilder

    response = loopback_response()
    with tempfile.TemporaryDirectory() as tmp:
        certfile, keyfile = _self_signed(pathlib.Path(tmp))
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        if tls13_offered is None:
            ctx.minimum_version = ssl.TLSVersion.TLSv1_2
            ctx.maximum_version = ssl.TLSVersion.TLSv1_2
            ctx.set_ciphers("ECDHE-RSA-AES128-GCM-SHA256")
            ctx.set_ecdh_curve("prime256v1")
        else:
            ctx.minimum_version = ssl.TLSVersion.TLSv1_3
            ctx.maximum_version = ssl.TLSVersion.TLSv1_3
        ctx.load_cert_chain(certfile, keyfile)
        srv = socket.socket()
        srv.bind(("127.0.0.1", 0))
        srv.listen(1)
        port = srv.getsockname()[1]

        def serve():
            conn, _ = srv.accept()
            try:
                tls = ctx.wrap_socket(conn, server_side=True)
                while b"\r\n\r\n" not in tls.recv(4096):
                    pass
                tls.sendall(response)
                tls.unwrap()
            except (OSError, ssl.SSLError):
                pass  # the client closes without a close_notify
            finally:
                conn.close()

        t = threading.Thread(target=serve, daemon=True)
        t.start()
        req = Request.from_json(loopback_request(port).to_json())
        saved = recorder._OFFERED_SUITES
        if tls13_offered:
            recorder._OFFERED_SUITES = list(tls13_offered)
        try:
            gi = TLSInputBuilder().build_input(req)
        finally:
            recorder._OFFERED_SUITES = saved
        t.join(timeout=10)
        srv.close()
    return gi.to_cbor()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--suite", choices=sorted(SUITES), default="c02f",
                    help="the session to record (default c02f)")
    ap.add_argument("--make-cert", action="store_true",
                    help="write the loopback test certificate and key "
                    "instead")
    args = ap.parse_args()
    if args.make_cert:
        certfile, keyfile = _self_signed(LOOPBACK_CERT.parent)
        print(f"wrote {certfile} and {keyfile}")
        return
    name, offered = SUITES[args.suite]
    DATA.mkdir(exist_ok=True)
    gi_bytes = record(offered)
    from zktls_tpu.core.types import GuestInput
    from zktls_tpu.guest.program import run_guest

    suite = run_guest(GuestInput.from_cbor(gi_bytes),
                      require_trust_anchor=False).replay.cipher_suite.id
    if suite != int(args.suite, 16):
        raise SystemExit(f"the server negotiated 0x{suite:04X}, not "
                         f"0x{args.suite.upper()}")
    (DATA / name).write_bytes(gi_bytes)
    print(f"{name}: {len(gi_bytes)} bytes, suite 0x{suite:04X}")


if __name__ == "__main__":
    main()
