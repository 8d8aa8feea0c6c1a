"""TLS wire-format parsing: records, handshake messages, extensions.

The replay engine re-parses the recorded byte streams exactly as the
reference guest's rustls does when replaying the tape
(SURVEY.md §3.4).  TLS 1.2 (RFC 5246) structures plus the TLS 1.3
(RFC 8446) ones the recorded ClientHello offers.

Port copy of zktls_tpu.guest.tls (same names and values).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

__all__ = [
    "ContentType", "HandshakeType", "Record", "parse_records",
    "HandshakeMessage", "iter_handshake_messages", "ClientHello",
    "ServerHello", "ServerKeyExchange", "CertificateChain",
    "CIPHER_SUITES", "CipherSuite",
]


class ContentType:
    CHANGE_CIPHER_SPEC = 20
    ALERT = 21
    HANDSHAKE = 22
    APPLICATION_DATA = 23


class HandshakeType:
    CLIENT_HELLO = 1
    SERVER_HELLO = 2
    NEW_SESSION_TICKET = 4
    ENCRYPTED_EXTENSIONS = 8
    CERTIFICATE = 11
    SERVER_KEY_EXCHANGE = 12
    CERTIFICATE_REQUEST = 13
    SERVER_HELLO_DONE = 14
    CERTIFICATE_VERIFY = 15
    CLIENT_KEY_EXCHANGE = 16
    FINISHED = 20


@dataclass
class Record:
    typ: int
    version: bytes  # 2 bytes as on the wire
    payload: bytes

    def header(self) -> bytes:
        return bytes([self.typ]) + self.version + struct.pack(">H", len(self.payload))


def parse_records(data: bytes) -> list[Record]:
    out = []
    pos = 0
    while pos < len(data):
        if pos + 5 > len(data):
            raise ValueError(f"truncated TLS record header at {pos}")
        typ = data[pos]
        ver = data[pos + 1 : pos + 3]
        (ln,) = struct.unpack_from(">H", data, pos + 3)
        pos += 5
        if pos + ln > len(data):
            raise ValueError(f"truncated TLS record body at {pos}")
        out.append(Record(typ, ver, data[pos : pos + ln]))
        pos += ln
    return out


@dataclass
class HandshakeMessage:
    typ: int
    body: bytes
    raw: bytes  # header + body — what transcript hashing consumes


def iter_handshake_messages(payload: bytes) -> list[HandshakeMessage]:
    out = []
    pos = 0
    while pos < len(payload):
        if pos + 4 > len(payload):
            raise ValueError("truncated handshake header")
        typ = payload[pos]
        ln = int.from_bytes(payload[pos + 1 : pos + 4], "big")
        raw = payload[pos : pos + 4 + ln]
        if len(raw) != 4 + ln:
            raise ValueError("truncated handshake body")
        out.append(HandshakeMessage(typ, raw[4:], raw))
        pos += 4 + ln
    return out


def _parse_extensions(data: bytes) -> dict[int, bytes]:
    exts: dict[int, bytes] = {}
    if not data:
        return exts
    (total,) = struct.unpack_from(">H", data, 0)
    pos = 2
    end = 2 + total
    while pos < end:
        et, el = struct.unpack_from(">HH", data, pos)
        exts[et] = data[pos + 4 : pos + 4 + el]
        pos += 4 + el
    return exts


class ExtensionType:
    SERVER_NAME = 0
    EC_POINT_FORMATS = 11
    SUPPORTED_GROUPS = 10
    SIGNATURE_ALGORITHMS = 13
    SESSION_TICKET = 35
    EXTENDED_MASTER_SECRET = 23
    SUPPORTED_VERSIONS = 43
    KEY_SHARE = 51
    RENEGOTIATION_INFO = 0xFF01


@dataclass
class ClientHello:
    client_random: bytes
    session_id: bytes
    cipher_suites: list[int]
    extensions: dict[int, bytes]

    @classmethod
    def parse(cls, body: bytes) -> "ClientHello":
        pos = 2  # legacy_version
        client_random = body[pos : pos + 32]
        pos += 32
        sid_len = body[pos]
        session_id = body[pos + 1 : pos + 1 + sid_len]
        pos += 1 + sid_len
        (cs_len,) = struct.unpack_from(">H", body, pos)
        pos += 2
        suites = [
            int.from_bytes(body[pos + i : pos + i + 2], "big")
            for i in range(0, cs_len, 2)
        ]
        pos += cs_len
        comp_len = body[pos]
        pos += 1 + comp_len
        return cls(client_random, session_id, suites, _parse_extensions(body[pos:]))

    def key_shares(self) -> dict[int, bytes]:
        """TLS 1.3 key_share extension: {group: public key bytes}."""
        data = self.extensions.get(ExtensionType.KEY_SHARE)
        if data is None:
            return {}
        (total,) = struct.unpack_from(">H", data, 0)
        pos = 2
        out = {}
        while pos < 2 + total:
            grp, ln = struct.unpack_from(">HH", data, pos)
            out[grp] = data[pos + 4 : pos + 4 + ln]
            pos += 4 + ln
        return out


@dataclass
class ServerHello:
    version: int
    server_random: bytes
    session_id: bytes
    cipher_suite: int
    extensions: dict[int, bytes]

    @classmethod
    def parse(cls, body: bytes) -> "ServerHello":
        (version,) = struct.unpack_from(">H", body, 0)
        server_random = body[2:34]
        sid_len = body[34]
        session_id = body[35 : 35 + sid_len]
        pos = 35 + sid_len
        (suite,) = struct.unpack_from(">H", body, pos)
        pos += 3  # suite + compression
        return cls(version, server_random, session_id, suite,
                   _parse_extensions(body[pos:]))

    @property
    def has_extended_master_secret(self) -> bool:
        return ExtensionType.EXTENDED_MASTER_SECRET in self.extensions

    @property
    def selected_version(self) -> int:
        """Actual protocol version: TLS 1.3 hides 0x0304 in supported_versions."""
        sv = self.extensions.get(ExtensionType.SUPPORTED_VERSIONS)
        if sv is not None and len(sv) == 2:
            return int.from_bytes(sv, "big")
        return self.version


@dataclass
class ServerKeyExchange:
    """ECDHE params (RFC 4492 §5.4): named curve + point + signature over
    client_random ‖ server_random ‖ params."""

    curve_id: int
    public_point: bytes
    signature_scheme: int
    signature: bytes
    params_raw: bytes  # the signed ServerECDHParams bytes

    @classmethod
    def parse(cls, body: bytes) -> "ServerKeyExchange":
        if body[0] != 3:  # named_curve
            raise ValueError(f"unsupported ECCurveType {body[0]}")
        (curve_id,) = struct.unpack_from(">H", body, 1)
        plen = body[3]
        point = body[4 : 4 + plen]
        pos = 4 + plen
        params_raw = body[:pos]
        (scheme,) = struct.unpack_from(">H", body, pos)
        (sig_len,) = struct.unpack_from(">H", body, pos + 2)
        sig = body[pos + 4 : pos + 4 + sig_len]
        return cls(curve_id, point, scheme, sig, params_raw)


@dataclass
class CertificateChain:
    der_certs: list[bytes]

    @classmethod
    def parse(cls, body: bytes) -> "CertificateChain":
        total = int.from_bytes(body[0:3], "big")
        pos = 3
        certs = []
        while pos < 3 + total:
            ln = int.from_bytes(body[pos : pos + 3], "big")
            certs.append(body[pos + 3 : pos + 3 + ln])
            pos += 3 + ln
        return cls(certs)

    @classmethod
    def parse13(cls, body: bytes) -> "CertificateChain":
        """TLS 1.3 Certificate (RFC 8446 §4.4.2): request context +
        CertificateEntry list (each cert ‖ extensions)."""
        ctx_len = body[0]
        pos = 1 + ctx_len
        total = int.from_bytes(body[pos : pos + 3], "big")
        pos += 3
        end = pos + total
        certs = []
        while pos < end:
            ln = int.from_bytes(body[pos : pos + 3], "big")
            certs.append(body[pos + 3 : pos + 3 + ln])
            pos += 3 + ln
            ext_len = int.from_bytes(body[pos : pos + 2], "big")
            pos += 2 + ext_len
        return cls(certs)


@dataclass(frozen=True)
class CipherSuite:
    id: int
    name: str
    aead: str          # "aes-gcm" | "chacha20-poly1305"
    key_len: int
    fixed_iv_len: int  # TLS 1.2: implicit IV bytes from the key block
    hash: str          # PRF / transcript hash
    tls13: bool = False


CIPHER_SUITES = {
    s.id: s
    for s in [
        CipherSuite(0xC02B, "ECDHE-ECDSA-AES128-GCM-SHA256", "aes-gcm", 16, 4, "sha256"),
        CipherSuite(0xC02C, "ECDHE-ECDSA-AES256-GCM-SHA384", "aes-gcm", 32, 4, "sha384"),
        CipherSuite(0xC02F, "ECDHE-RSA-AES128-GCM-SHA256", "aes-gcm", 16, 4, "sha256"),
        CipherSuite(0xC030, "ECDHE-RSA-AES256-GCM-SHA384", "aes-gcm", 32, 4, "sha384"),
        CipherSuite(0xCCA8, "ECDHE-RSA-CHACHA20-POLY1305", "chacha20-poly1305", 32, 12, "sha256"),
        CipherSuite(0xCCA9, "ECDHE-ECDSA-CHACHA20-POLY1305", "chacha20-poly1305", 32, 12, "sha256"),
        CipherSuite(0x1301, "TLS13-AES128-GCM-SHA256", "aes-gcm", 16, 12, "sha256", True),
        CipherSuite(0x1302, "TLS13-AES256-GCM-SHA384", "aes-gcm", 32, 12, "sha384", True),
        CipherSuite(0x1303, "TLS13-CHACHA20-POLY1305-SHA256", "chacha20-poly1305", 32, 12, "sha256", True),
    ]
}


NAMED_GROUPS = {
    23: "secp256r1",
    24: "secp384r1",
    29: "x25519",
}
