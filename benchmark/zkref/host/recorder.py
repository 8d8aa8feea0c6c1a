"""The recordable TLS client: performs a real TLS 1.2 session while logging
(a) every TCP byte with direction framing, (b) every byte of randomness
consumed, and (c) the wall clock — the `(stream, random, time)` triple that
makes the session deterministically replayable by the guest.

Reimplements the external `zktls-recordable-tls-provider` +
rustls-rustcrypto client used by the reference's input builder
(crates/input-builder/src/request.rs:20-70, SURVEY.md §2.2.A), as a
pure-Python TLS client built on the same crypto primitives the guest
replays — so recording and replay are exact mirrors:

  RNG draw schedule (matches the recovered tape layout, SURVEY.md §2.3):
    [0:32]   x25519 private scalar for the TLS 1.3 key_share offer
    [32:64]  legacy session_id
    [64:96]  client_random
    [96:98]  2-byte draw (reserved; the recorded rustls drew it too)
    [98:..]  key-exchange scalar for the negotiated ECDHE curve

Negotiates TLS 1.2 ECDHE or TLS 1.3 (the 1.3 branch follows the server's
selected key share and cipher suite), with AES-GCM or ChaCha20-Poly1305
record protection.

Port copy of zktls_tpu.host.recorder (same names, draw schedule and tape
layout; host code).  The client's randomness comes from `os.urandom`
unless the caller passes `rng`, a callable n -> n bytes (a test fixes the
draws with it); either way every drawn byte is logged to the tape.  The
ClientHello offers `_OFFERED_SUITES` unless the caller passes `suites`.
"""

from __future__ import annotations

import os
import socket
import struct
import time as time_mod
from dataclasses import dataclass
from typing import Callable, Sequence

from ..core.tape import (
    DIR_CLIENT_TO_SERVER,
    DIR_SERVER_TO_CLIENT,
    StreamSegment,
    encode_stream,
    format_time,
)
from ..guest.crypto.ec import P256, P384
from ..guest.crypto.gcm import AESGCM
from ..guest.crypto.chacha import ChaCha20Poly1305
from ..guest.crypto.prf import prf_sha256
from ..guest.crypto.sha256 import SHA256
from ..guest.crypto.x25519 import x25519, x25519_base
from ..guest.tls import (
    CIPHER_SUITES,
    CertificateChain,
    ContentType,
    HandshakeType,
    Record,
    ServerHello,
    ServerKeyExchange,
    iter_handshake_messages,
)

__all__ = ["RecordedSession", "record_tls_call", "RecordingError"]


class RecordingError(Exception):
    pass


@dataclass
class RecordedSession:
    time: str
    stream: bytes
    random: bytes
    response: bytes


class _RecordingRng:
    def __init__(self, source: Callable[[int], bytes] = os.urandom) -> None:
        self.source = source
        self.log = bytearray()

    def draw(self, n: int) -> bytes:
        out = bytes(self.source(n))
        if len(out) != n:
            raise RecordingError(f"rng gave {len(out)} bytes, not {n}")
        self.log += out
        return out


class _RecordingSocket:
    """Tees every read/write into direction-framed segments."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.segments: list[StreamSegment] = []
        self._rbuf = b""

    def write(self, data: bytes) -> None:
        self.sock.sendall(data)
        self.segments.append(StreamSegment(DIR_CLIENT_TO_SERVER, bytes(data)))

    def read_exact(self, n: int) -> bytes:
        while len(self._rbuf) < n:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise RecordingError("connection closed mid-read")
            self.segments.append(StreamSegment(DIR_SERVER_TO_CLIENT, chunk))
            self._rbuf += chunk
        out, self._rbuf = self._rbuf[:n], self._rbuf[n:]
        return out

    def read_until_close(self) -> bytes:
        out = self._rbuf
        self._rbuf = b""
        while True:
            try:
                chunk = self.sock.recv(65536)
            except (ConnectionResetError, TimeoutError):
                break
            if not chunk:
                break
            self.segments.append(StreamSegment(DIR_SERVER_TO_CLIENT, chunk))
            out += chunk
        return out

    def tape(self) -> bytes:
        return encode_stream(self.segments)


# ---------------------------------------------------------------------------
# ClientHello construction
# ---------------------------------------------------------------------------

# The recorded rustls offers this same suite list; since round 4 the
# client omits them until the SHA-384 schedule lands — a client must not
# recorder completes SHA-384 suites too (prf_sha384 + SHA-384
# transcript), so the full rustls set is offered.
_OFFERED_SUITES = [0xC02B, 0xC02C, 0xCCA9, 0xC02F, 0xC030, 0xCCA8,
                   0x1301, 0x1302, 0x1303]
_SIG_ALGS = [0x0403, 0x0503, 0x0807, 0x0804, 0x0805, 0x0806,
             0x0401, 0x0501, 0x0601]
_GROUPS = [29, 23, 24]  # x25519, P-256, P-384


def _ext(etype: int, body: bytes) -> bytes:
    return struct.pack(">HH", etype, len(body)) + body


def _build_client_hello(server_name: str, client_random: bytes,
                        session_id: bytes, x25519_pub: bytes,
                        offered: Sequence[int]) -> bytes:
    suites = b"".join(struct.pack(">H", s) for s in offered)
    exts = b""
    sn = server_name.encode()
    exts += _ext(0, struct.pack(">HBH", len(sn) + 3, 0, len(sn)) + sn)
    exts += _ext(11, b"\x01\x00")  # ec_point_formats: uncompressed
    groups = b"".join(struct.pack(">H", g) for g in _GROUPS)
    exts += _ext(10, struct.pack(">H", len(groups)) + groups)
    sig = b"".join(struct.pack(">H", s) for s in _SIG_ALGS)
    exts += _ext(13, struct.pack(">H", len(sig)) + sig)
    exts += _ext(35, b"")          # session_ticket
    exts += _ext(23, b"")          # extended_master_secret
    exts += _ext(0xFF01, b"\x00")  # renegotiation_info
    exts += _ext(43, b"\x04\x03\x04\x03\x03")  # supported_versions: 1.3, 1.2
    ks = struct.pack(">HH", 29, len(x25519_pub)) + x25519_pub
    exts += _ext(51, struct.pack(">H", len(ks)) + ks)
    exts += _ext(45, b"\x01\x01")  # psk_key_exchange_modes: psk_dhe_ke
    body = (
        b"\x03\x03" + client_random
        + bytes([len(session_id)]) + session_id
        + struct.pack(">H", len(suites)) + suites
        + b"\x01\x00"  # compression: null
        + struct.pack(">H", len(exts)) + exts
    )
    return bytes([HandshakeType.CLIENT_HELLO]) + len(body).to_bytes(3, "big") + body


def _record(typ: int, payload: bytes, version: bytes = b"\x03\x03") -> bytes:
    return bytes([typ]) + version + struct.pack(">H", len(payload)) + payload


# ---------------------------------------------------------------------------
# the recorded call
# ---------------------------------------------------------------------------


def record_tls_call(remote_addr: str, server_name: str, request_bytes: bytes,
                    cafile: str | None = None, timeout: float = 30.0,
                    rng: Callable[[int], bytes] | None = None,
                    suites: Sequence[int] | None = None,
                    now: float | None = None,
                    ) -> RecordedSession:
    """Record one TLS call.  rng: the client's source of random bytes
    (`os.urandom` when None); suites: the cipher suites the ClientHello
    offers (`_OFFERED_SUITES` when None); now: the pinned time in seconds
    since the epoch (the wall clock when None)."""
    host, _, port_s = remote_addr.rpartition(":")
    port = int(port_s or "443")
    rng = _RecordingRng() if rng is None else _RecordingRng(rng)

    raw = socket.create_connection((host, port), timeout=timeout)
    raw.settimeout(timeout)
    sock = _RecordingSocket(raw)
    t = time_mod.time() if now is None else now
    pinned_time = format_time(int(t), int((t % 1) * 1e9))

    try:
        return _handshake_and_exchange(
            sock, rng, server_name, request_bytes, pinned_time,
            _OFFERED_SUITES if suites is None else suites)
    finally:
        raw.close()


def _read_record(sock: _RecordingSocket) -> Record:
    hdr = sock.read_exact(5)
    typ, ver, ln = hdr[0], hdr[1:3], struct.unpack(">H", hdr[3:5])[0]
    return Record(typ, ver, sock.read_exact(ln))


def _handshake_and_exchange(sock: _RecordingSocket, rng: _RecordingRng,
                            server_name: str, request_bytes: bytes,
                            pinned_time: str, offered: Sequence[int]
                            ) -> RecordedSession:
    x25519_priv = rng.draw(32)
    session_id = rng.draw(32)
    client_random = rng.draw(32)
    rng.draw(2)  # reserved draw, mirrors the recorded rustls schedule

    ch = _build_client_hello(server_name, client_random, session_id,
                             x25519_base(x25519_priv), offered)
    sock.write(_record(ContentType.HANDSHAKE, ch, b"\x03\x01"))
    transcript = [ch]

    # --- server flight through ServerHelloDone (or TLS 1.3 branch) ---
    hs_buf = b""
    sh: ServerHello | None = None
    msgs = []
    while True:
        r = _read_record(sock)
        if r.typ == ContentType.ALERT:
            raise RecordingError(f"server alert: {r.payload.hex()}")
        if r.typ != ContentType.HANDSHAKE:
            raise RecordingError(f"unexpected record type {r.typ}")
        hs_buf += r.payload
        msgs = iter_handshake_messages(hs_buf) if _complete(hs_buf) else []
        if msgs and sh is None and msgs[0].typ == HandshakeType.SERVER_HELLO:
            sh = ServerHello.parse(msgs[0].body)
            if sh.selected_version == 0x0304:
                return _handshake13(sock, sh, msgs[0].raw, ch, x25519_priv,
                                    request_bytes, pinned_time, rng)
        if any(m.typ == HandshakeType.SERVER_HELLO_DONE for m in msgs):
            break
    if sh is None:
        raise RecordingError("no ServerHello")
    suite = CIPHER_SUITES.get(sh.cipher_suite)
    if suite is None or suite.tls13:
        raise RecordingError(f"unsupported suite {sh.cipher_suite:#06x}")
    if not sh.has_extended_master_secret:
        raise RecordingError("server lacks extended_master_secret (RFC 7627)")
    if suite.hash == "sha384":
        from ..guest.crypto.prf import prf_sha384 as _prf
        from ..guest.crypto.sha512 import SHA384 as _Hash
    else:
        _prf, _Hash = prf_sha256, SHA256

    shd_idx = next(i for i, m in enumerate(msgs)
                   if m.typ == HandshakeType.SERVER_HELLO_DONE)
    server_flight = msgs[: shd_idx + 1]
    transcript += [m.raw for m in server_flight]
    cert_msg = next(m for m in server_flight
                    if m.typ == HandshakeType.CERTIFICATE)
    skx_msg = next(m for m in server_flight
                   if m.typ == HandshakeType.SERVER_KEY_EXCHANGE)
    chain = CertificateChain.parse(cert_msg.body)
    skx = ServerKeyExchange.parse(skx_msg.body)

    # --- ECDHE ---
    if skx.curve_id in (23, 24):
        curve = P256 if skx.curve_id == 23 else P384
        scalar = int.from_bytes(rng.draw(curve.byte_len), "big")
        pub = curve.encode_point(curve.mul(scalar, curve.g))
        server_pt = curve.decode_point(skx.public_point)
        shared = curve.mul(scalar, server_pt)
        premaster = shared[0].to_bytes(curve.byte_len, "big")
    elif skx.curve_id == 29:
        priv = rng.draw(32)
        pub = x25519_base(priv)
        premaster = x25519(priv, skx.public_point)
    else:
        raise RecordingError(f"unsupported curve {skx.curve_id}")

    ckx_body = bytes([len(pub)]) + pub
    ckx = (bytes([HandshakeType.CLIENT_KEY_EXCHANGE])
           + len(ckx_body).to_bytes(3, "big") + ckx_body)
    sock.write(_record(ContentType.HANDSHAKE, ckx))
    transcript.append(ckx)

    # --- key schedule (RFC 7627 extended master secret) ---
    h = _Hash()
    for m in transcript:
        h.update(m)
    session_hash = h.digest()
    master = _prf(premaster, b"extended master secret", session_hash, 48)
    key_block = _prf(
        master, b"key expansion", sh.server_random + client_random,
        2 * suite.key_len + 2 * suite.fixed_iv_len)
    off = 0
    ckey = key_block[off : off + suite.key_len]; off += suite.key_len
    skey = key_block[off : off + suite.key_len]; off += suite.key_len
    civ = key_block[off : off + suite.fixed_iv_len]; off += suite.fixed_iv_len
    siv = key_block[off : off + suite.fixed_iv_len]

    client_aead = AESGCM(ckey) if suite.aead == "aes-gcm" else ChaCha20Poly1305(ckey)
    server_aead = AESGCM(skey) if suite.aead == "aes-gcm" else ChaCha20Poly1305(skey)

    def encrypt(typ: int, plaintext: bytes, seq: int) -> bytes:
        aad = seq.to_bytes(8, "big") + bytes([typ]) + b"\x03\x03" + \
            struct.pack(">H", len(plaintext))
        if suite.aead == "aes-gcm":
            explicit = struct.pack(">Q", seq)
            nonce = civ + explicit
            return explicit + client_aead.encrypt(nonce, plaintext, aad)
        nonce = bytes(a ^ b for a, b in zip(civ, seq.to_bytes(12, "big")))
        return client_aead.encrypt(nonce, plaintext, aad)

    def decrypt(r: Record, seq: int) -> bytes:
        if suite.aead == "aes-gcm":
            explicit, body = r.payload[:8], r.payload[8:]
            nonce = siv + explicit
        else:
            body = r.payload
            nonce = bytes(a ^ b for a, b in zip(siv, seq.to_bytes(12, "big")))
        aad = seq.to_bytes(8, "big") + bytes([r.typ]) + r.version + \
            struct.pack(">H", len(body) - 16)
        return server_aead.decrypt(nonce, body, aad)

    # --- client CCS + Finished ---
    h = _Hash()
    for m in transcript:
        h.update(m)
    verify_data = _prf(master, b"client finished", h.digest(), 12)
    fin = (bytes([HandshakeType.FINISHED]) + len(verify_data).to_bytes(3, "big")
           + verify_data)
    sock.write(_record(ContentType.CHANGE_CIPHER_SPEC, b"\x01"))
    sock.write(_record(ContentType.HANDSHAKE, encrypt(ContentType.HANDSHAKE,
                                                      fin, 0)))
    transcript.append(fin)

    # --- server NST / CCS / Finished ---
    seen_ccs = False
    server_seq = 0
    while True:
        r = _read_record(sock)
        if r.typ == ContentType.CHANGE_CIPHER_SPEC:
            seen_ccs = True
            continue
        if r.typ == ContentType.HANDSHAKE and not seen_ccs:
            for m in iter_handshake_messages(r.payload):
                if m.typ == HandshakeType.NEW_SESSION_TICKET:
                    transcript.append(m.raw)
            continue
        if r.typ == ContentType.HANDSHAKE and seen_ccs:
            plain = decrypt(r, server_seq)
            server_seq += 1
            fin_msgs = iter_handshake_messages(plain)
            if fin_msgs[0].typ != HandshakeType.FINISHED:
                raise RecordingError("expected server Finished")
            h = _Hash()
            for m in transcript:
                h.update(m)
            expect = _prf(master, b"server finished", h.digest(), 12)
            if fin_msgs[0].body != expect:
                raise RecordingError("server Finished verify_data mismatch")
            break
        if r.typ == ContentType.ALERT:
            raise RecordingError(f"server alert during handshake: "
                                 f"{r.payload.hex()}")

    # --- application data ---
    sock.write(_record(ContentType.APPLICATION_DATA,
                       encrypt(ContentType.APPLICATION_DATA, request_bytes, 1)))
    response = bytearray()
    while True:
        try:
            r = _read_record(sock)
        except RecordingError:
            break  # connection closed
        plain = decrypt(r, server_seq)
        server_seq += 1
        if r.typ == ContentType.APPLICATION_DATA:
            response += plain
        elif r.typ == ContentType.ALERT:
            break  # close_notify

    _ = chain  # chain verification happens in the guest replay
    return RecordedSession(
        time=pinned_time,
        stream=sock.tape(),
        random=bytes(rng.log),
        response=bytes(response),
    )


def _complete(hs_buf: bytes) -> bool:
    """True if hs_buf currently ends on a handshake-message boundary."""
    pos = 0
    while pos + 4 <= len(hs_buf):
        ln = int.from_bytes(hs_buf[pos + 1 : pos + 4], "big")
        pos += 4 + ln
    return pos == len(hs_buf)


def _handshake13(sock: _RecordingSocket, sh: ServerHello, sh_raw: bytes,
                 ch_raw: bytes, x25519_priv: bytes, request_bytes: bytes,
                 pinned_time: str, rng: _RecordingRng) -> RecordedSession:
    """TLS 1.3 client (RFC 8446): x25519 key exchange from the recorded
    scalar, HKDF schedule, encrypted flight verification, then the request."""
    from ..guest.crypto.x25519 import x25519 as _x25519
    from ..guest.tls13 import (
        Tls13KeySchedule,
        Tls13RecordCrypto,
        strip_inner_plaintext,
    )

    suite = CIPHER_SUITES.get(sh.cipher_suite)
    if suite is None or not suite.tls13:
        raise RecordingError(f"unsupported 1.3 suite {sh.cipher_suite:#06x}")
    ks_data = sh.extensions.get(51)
    if ks_data is None:
        raise RecordingError("ServerHello missing key_share (HRR unsupported)")
    group = int.from_bytes(ks_data[0:2], "big")
    server_share = ks_data[4:]
    if group != 29:
        raise RecordingError(f"server picked group {group}; only the x25519 "
                             "share is offered")
    shared = _x25519(x25519_priv, server_share)

    sched = Tls13KeySchedule(suite)
    sched.start(shared)
    transcript = [ch_raw, sh_raw]

    if suite.hash == "sha384":
        from ..guest.crypto.sha512 import SHA384 as _Hash13
    else:
        _Hash13 = SHA256

    def thash() -> bytes:
        h = _Hash13()
        for m in transcript:
            h.update(m)
        return h.digest()

    sched.handshake_traffic(thash())
    server_crypto = Tls13RecordCrypto(suite, sched.server_hs_secret)
    client_crypto = Tls13RecordCrypto(suite, sched.client_hs_secret)

    # --- encrypted server flight through Finished ---
    hs_buf = b""
    finished = False
    while not finished:
        r = _read_record(sock)
        if r.typ == ContentType.CHANGE_CIPHER_SPEC:
            continue
        if r.typ == ContentType.ALERT:
            raise RecordingError(f"server alert: {r.payload.hex()}")
        if r.typ != ContentType.APPLICATION_DATA:
            raise RecordingError(f"unexpected record type {r.typ}")
        inner_type, content = strip_inner_plaintext(server_crypto.decrypt(r))
        if inner_type == ContentType.ALERT:
            raise RecordingError(f"server alert: {content.hex()}")
        if inner_type != ContentType.HANDSHAKE:
            raise RecordingError("unexpected early application data")
        hs_buf += content
        while len(hs_buf) >= 4:
            ln = int.from_bytes(hs_buf[1:4], "big")
            if 4 + ln > len(hs_buf):
                break
            raw, hs_buf = hs_buf[: 4 + ln], hs_buf[4 + ln :]
            typ = raw[0]
            if typ == HandshakeType.FINISHED:
                expect = sched.finished_verify(sched.server_hs_secret, thash())
                if raw[4:] != expect:
                    raise RecordingError("server Finished mismatch")
                transcript.append(raw)
                finished = True
                break
            transcript.append(raw)

    app_hash = thash()
    sched.application_traffic(app_hash)
    server_app = Tls13RecordCrypto(suite, sched.server_app_secret)
    client_app = Tls13RecordCrypto(suite, sched.client_app_secret)

    # --- client CCS (middlebox compat) + Finished ---
    verify = sched.finished_verify(sched.client_hs_secret, thash())
    fin = bytes([HandshakeType.FINISHED]) + len(verify).to_bytes(3, "big") \
        + verify
    sock.write(_record(ContentType.CHANGE_CIPHER_SPEC, b"\x01"))
    inner = fin + bytes([ContentType.HANDSHAKE])
    sock.write(_record(ContentType.APPLICATION_DATA,
                       client_crypto.encrypt(inner)))

    # --- application data ---
    inner = request_bytes + bytes([ContentType.APPLICATION_DATA])
    sock.write(_record(ContentType.APPLICATION_DATA,
                       client_app.encrypt(inner)))
    response = bytearray()
    while True:
        try:
            r = _read_record(sock)
        except RecordingError:
            break
        if r.typ == ContentType.CHANGE_CIPHER_SPEC:
            continue
        if r.typ != ContentType.APPLICATION_DATA:
            break
        inner_type, content = strip_inner_plaintext(server_app.decrypt(r))
        if inner_type == ContentType.APPLICATION_DATA:
            response += content
        elif inner_type == ContentType.ALERT:
            break
        # NewSessionTicket and other post-handshake messages: recorded on
        # the tape, skipped here

    return RecordedSession(
        time=pinned_time,
        stream=sock.tape(),
        random=bytes(rng.log),
        response=bytes(response),
    )
