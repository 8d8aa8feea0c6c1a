"""A small DER reader for X.509 certificates (RFC 5280), the port's own.

The reference package hands certificate structure to the `cryptography`
package; the port reads the raw DER itself, so it needs nothing beyond the
standard library.  Every field is taken as the raw slice of the encoding
(the TBSCertificate, the issuer and subject Names, the
SubjectPublicKeyInfo), which is what the reference's re-encodings give for
DER input: digests of those slices (SPKI hashes, the TBS bytes the SHA
chips hash) are the reference's.

    Certificate  ::= SEQUENCE { tbsCertificate, signatureAlgorithm,
                                signatureValue BIT STRING }
    TBSCertificate ::= SEQUENCE { [0] version OPTIONAL, serialNumber,
                                  signature, issuer, validity, subject,
                                  subjectPublicKeyInfo, [1] [2] OPTIONAL,
                                  [3] extensions OPTIONAL }

Object identifiers are dotted strings; the names below are the ones the
reference keys on (`x509.py`'s signature-hash map, its curve choice).
The serial number is not read, so a non-positive serial (one root in
roots.pem has one) does not stop a certificate from loading.
"""

from __future__ import annotations

import base64
import calendar
from dataclasses import dataclass

__all__ = ["Tlv", "read_tlv", "children", "decode_oid", "X509",
           "parse_certificate", "RsaKey", "EcKey", "Ed25519Key", "OtherKey",
           "parse_spki", "parse_time", "san_dns_names", "pem_blocks",
           "pem_to_der", "SIG_ALG_NAMES", "CURVE_NAMES", "OID_SAN"]

#: signature algorithm OIDs → the names the reference's certificate
#: verifier keys on (sha1 and the rest are read but verify to False)
SIG_ALG_NAMES = {
    "1.2.840.113549.1.1.5": "sha1WithRSAEncryption",
    "1.2.840.113549.1.1.11": "sha256WithRSAEncryption",
    "1.2.840.113549.1.1.12": "sha384WithRSAEncryption",
    "1.2.840.113549.1.1.13": "sha512WithRSAEncryption",
    "1.2.840.10045.4.3.2": "ecdsa-with-SHA256",
    "1.2.840.10045.4.3.3": "ecdsa-with-SHA384",
    "1.2.840.10045.4.3.4": "ecdsa-with-SHA512",
    "1.3.101.112": "ed25519",
}
#: named-curve OIDs of id-ecPublicKey keys
CURVE_NAMES = {
    "1.2.840.10045.3.1.7": "secp256r1",
    "1.3.132.0.34": "secp384r1",
    "1.3.132.0.35": "secp521r1",
    "1.3.132.0.10": "secp256k1",
}
OID_RSA = "1.2.840.113549.1.1.1"
OID_EC = "1.2.840.10045.2.1"
OID_ED25519 = "1.3.101.112"
OID_SAN = "2.5.29.17"

TAG_INTEGER, TAG_BIT_STRING, TAG_OCTET_STRING = 0x02, 0x03, 0x04
TAG_OID, TAG_UTC_TIME, TAG_GENERALIZED_TIME = 0x06, 0x17, 0x18
TAG_SEQUENCE = 0x30


@dataclass(frozen=True)
class Tlv:
    """One DER element of `data`: tag byte, the content's bounds, and
    `raw`, the whole element (header included)."""

    data: bytes
    tag: int
    start: int      # first header byte
    body: int       # first content byte
    end: int        # one past the last content byte

    @property
    def content(self) -> bytes:
        return self.data[self.body : self.end]

    @property
    def raw(self) -> bytes:
        return self.data[self.start : self.end]


def read_tlv(data: bytes, pos: int = 0, limit: int | None = None) -> Tlv:
    """The element at `pos` (single-byte tags; short and long definite
    lengths).  Raises ValueError if it runs past `limit` (default: the end
    of `data`)."""
    limit = len(data) if limit is None else limit
    if pos + 2 > limit:
        raise ValueError("DER: truncated header")
    tag, ln = data[pos], data[pos + 1]
    if tag & 0x1F == 0x1F:
        raise ValueError("DER: multi-byte tags are not supported")
    body = pos + 2
    if ln & 0x80:
        n = ln & 0x7F
        if n == 0 or n > 4 or body + n > limit:
            raise ValueError("DER: bad length")
        ln = int.from_bytes(data[body : body + n], "big")
        body += n
    if body + ln > limit:
        raise ValueError("DER: element runs past its parent")
    return Tlv(data, tag, pos, body, body + ln)


def children(tlv: Tlv) -> list[Tlv]:
    """The elements inside a constructed element, in order."""
    out, pos = [], tlv.body
    while pos < tlv.end:
        child = read_tlv(tlv.data, pos, tlv.end)
        out.append(child)
        pos = child.end
    return out


def _nth(items: list[Tlv], i: int, what: str) -> Tlv:
    if not -len(items) <= i < len(items):
        raise ValueError(f"DER: {what} is missing")
    return items[i]


def _expect(tlv: Tlv, tag: int, what: str) -> Tlv:
    if tlv.tag != tag:
        raise ValueError(f"DER: {what}: tag 0x{tlv.tag:02x}, want "
                         f"0x{tag:02x}")
    return tlv


def decode_oid(content: bytes) -> str:
    """OBJECT IDENTIFIER content → dotted string."""
    if not content:
        raise ValueError("DER: empty OID")
    arcs, v = [], 0
    for b in content:
        v = (v << 7) | (b & 0x7F)
        if not b & 0x80:
            arcs.append(v)
            v = 0
    if content[-1] & 0x80:
        raise ValueError("DER: truncated OID")
    first = arcs[0]
    head = [min(first // 40, 2), first - 40 * min(first // 40, 2)]
    return ".".join(str(a) for a in head + arcs[1:])


def _integer(tlv: Tlv) -> int:
    return int.from_bytes(_expect(tlv, TAG_INTEGER, "INTEGER").content,
                          "big", signed=True)


def _bit_string(tlv: Tlv) -> bytes:
    """BIT STRING content without its unused-bits byte."""
    c = _expect(tlv, TAG_BIT_STRING, "BIT STRING").content
    if not c or c[0] != 0:
        raise ValueError("DER: BIT STRING with unused bits")
    return c[1:]


def parse_time(tlv: Tlv) -> int:
    """UTCTime (YY < 50 → 20YY) or GeneralizedTime, in 'Z', → UTC unix
    seconds (fractional seconds dropped)."""
    s = tlv.content.decode("ascii")
    if not s.endswith("Z"):
        raise ValueError("DER: time not in UTC")
    if tlv.tag == TAG_UTC_TIME:
        yy = int(s[0:2])
        year, rest = (2000 + yy if yy < 50 else 1900 + yy), s[2:]
    elif tlv.tag == TAG_GENERALIZED_TIME:
        year, rest = int(s[0:4]), s[4:]
    else:
        raise ValueError(f"DER: tag 0x{tlv.tag:02x} is not a time")
    mo, d, h, mi, sec = (int(rest[i : i + 2]) for i in range(0, 10, 2))
    return calendar.timegm((year, mo, d, h, mi, sec, 0, 0, 0))


@dataclass(frozen=True)
class RsaKey:
    n: int
    e: int


@dataclass(frozen=True)
class EcKey:
    curve: str      # CURVE_NAMES value
    x: int
    y: int


@dataclass(frozen=True)
class Ed25519Key:
    raw: bytes      # the 32-byte public key


@dataclass(frozen=True)
class OtherKey:
    """A key algorithm no verifier here handles (DSA, ...)."""

    oid: str


def parse_spki(spki: bytes) -> RsaKey | EcKey | Ed25519Key | OtherKey:
    """SubjectPublicKeyInfo DER → its key.  RSA (n, e); EC on a named curve
    of CURVE_NAMES with an uncompressed point; Ed25519's raw bytes."""
    top = _expect(read_tlv(spki), TAG_SEQUENCE, "SubjectPublicKeyInfo")
    alg, key = children(top)
    alg_parts = children(_expect(alg, TAG_SEQUENCE, "AlgorithmIdentifier"))
    oid = decode_oid(_expect(_nth(alg_parts, 0, "algorithm"), TAG_OID,
                             "algorithm").content)
    bits = _bit_string(key)
    if oid == OID_RSA:
        n, e = children(_expect(read_tlv(bits), TAG_SEQUENCE,
                                "RSAPublicKey"))
        return RsaKey(_integer(n), _integer(e))
    if oid == OID_EC:
        curve_oid = decode_oid(_expect(_nth(alg_parts, 1, "namedCurve"),
                                       TAG_OID, "namedCurve").content)
        if curve_oid not in CURVE_NAMES:
            raise ValueError(f"unsupported curve {curve_oid}")
        size = (len(bits) - 1) // 2
        if bits[:1] != b"\x04" or len(bits) != 2 * size + 1:
            raise ValueError("EC public key is not an uncompressed point")
        return EcKey(CURVE_NAMES[curve_oid],
                     int.from_bytes(bits[1 : 1 + size], "big"),
                     int.from_bytes(bits[1 + size :], "big"))
    if oid == OID_ED25519:
        if len(bits) != 32:
            raise ValueError("Ed25519 public key is not 32 bytes")
        return Ed25519Key(bits)
    return OtherKey(oid)


@dataclass(frozen=True)
class X509:
    """A certificate's fields as raw DER slices."""

    tbs: bytes                  # the TBSCertificate element
    signature_oid: str          # outer signatureAlgorithm
    signature: bytes            # BIT STRING content, unused-bits byte off
    issuer: bytes               # issuer Name element
    subject: bytes              # subject Name element
    not_before: int             # UTC unix seconds
    not_after: int
    spki: bytes                 # SubjectPublicKeyInfo element
    extensions: tuple           # ((oid, value bytes), ...)

    @property
    def signature_name(self) -> str:
        return SIG_ALG_NAMES.get(self.signature_oid, self.signature_oid)

    def public_key(self) -> RsaKey | EcKey | Ed25519Key | OtherKey:
        return parse_spki(self.spki)

    def extension(self, oid: str) -> bytes | None:
        """The value (OCTET STRING content) of extension `oid`, or None."""
        found = [v for o, v in self.extensions if o == oid]
        if len(found) > 1:
            raise ValueError(f"duplicate extension {oid}")
        return found[0] if found else None


def parse_certificate(der: bytes) -> X509:
    """Certificate DER → X509.  Raises ValueError on malformed input."""
    top = _expect(read_tlv(der), TAG_SEQUENCE, "Certificate")
    if top.end != len(der):
        raise ValueError("DER: trailing bytes after the certificate")
    tbs, sig_alg, sig = children(top)
    fields = children(_expect(tbs, TAG_SEQUENCE, "TBSCertificate"))
    if fields and fields[0].tag == 0xA0:        # [0] EXPLICIT version
        fields = fields[1:]
    _serial, _sig, issuer, validity, subject, spki, *rest = fields
    nb, na = children(_expect(validity, TAG_SEQUENCE, "Validity"))
    exts: list = []
    for f in rest:
        if f.tag != 0xA3:                       # [1], [2] unique ids
            continue
        for ext in children(_expect(_nth(children(f), 0, "Extensions"),
                                    TAG_SEQUENCE, "Extensions")):
            # extnID, critical BOOLEAN DEFAULT FALSE, extnValue
            parts = children(_expect(ext, TAG_SEQUENCE, "Extension"))
            exts.append((decode_oid(_expect(_nth(parts, 0, "extnID"),
                                            TAG_OID, "extnID").content),
                         _expect(_nth(parts, -1, "extnValue"),
                                 TAG_OCTET_STRING, "extnValue").content))
    return X509(
        tbs=tbs.raw,
        signature_oid=decode_oid(_expect(
            _nth(children(_expect(sig_alg, TAG_SEQUENCE,
                                  "signatureAlgorithm")), 0, "algorithm"),
            TAG_OID, "algorithm").content),
        signature=_bit_string(sig),
        issuer=_expect(issuer, TAG_SEQUENCE, "issuer").raw,
        subject=_expect(subject, TAG_SEQUENCE, "subject").raw,
        not_before=parse_time(nb),
        not_after=parse_time(na),
        spki=_expect(spki, TAG_SEQUENCE, "subjectPublicKeyInfo").raw,
        extensions=tuple(exts))


def san_dns_names(ext_value: bytes) -> list[str]:
    """The dNSName ([2] IA5String) entries of a subjectAltName value."""
    names = _expect(read_tlv(ext_value), TAG_SEQUENCE, "GeneralNames")
    return [g.content.decode("ascii") for g in children(names)
            if g.tag == 0x82]


def pem_blocks(pem: bytes) -> list[bytes]:
    """Each `-----BEGIN CERTIFICATE-----` … `-----END CERTIFICATE-----`
    block of a PEM bundle, markers included, in order."""
    begin, end = b"-----BEGIN CERTIFICATE-----", b"-----END CERTIFICATE-----"
    out, pos = [], 0
    while (b := pem.find(begin, pos)) >= 0:
        e = pem.find(end, b)
        if e < 0:
            raise ValueError("PEM: unterminated block")
        out.append(pem[b : e + len(end)])
        pos = e + len(end)
    return out


def pem_to_der(block: bytes) -> bytes:
    """One PEM block (as pem_blocks gives it) → its DER bytes."""
    lines = block.split(b"-----")
    if len(lines) != 5:
        raise ValueError("PEM: not one block")
    return base64.b64decode(b"".join(lines[2].split()), validate=True)
