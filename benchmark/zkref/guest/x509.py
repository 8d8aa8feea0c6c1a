"""X.509 certificate handling for the guest replay.

Mirrors what rustls-webpki does inside the reference guest
(SURVEY.md §3.4: cert-chain verify with RSA/ECDSA/Ed25519 at the pinned
clock): every signature check runs through this framework's own
RSA/ECDSA/Ed25519 verifiers — those are the computations the AIR chips
prove, so the witness path must own them.

Port of zktls_tpu.guest.x509 (same names, same results, same order of
recorded digests and modular multiplications).  Where the reference hands
certificate structure to the `cryptography` package, the port reads the DER
itself (guest/der.py): raw slices of the TBSCertificate, Names and
SubjectPublicKeyInfo stand where the reference re-encodes them, which gives
the same bytes for DER input.
"""

from __future__ import annotations

import contextvars
from contextlib import contextmanager
from dataclasses import dataclass

from . import der
from .crypto.ec import P256, P384, ecdsa_verify
from .crypto.ed25519 import ed25519_verify
from .crypto.rsa import rsa_pkcs1v15_verify, rsa_pss_verify

__all__ = ["Certificate", "verify_chain", "SignatureScheme",
           "hash_recording"]

#: active (SHA256Recorder, SHA512Recorder) pair: when set, every digest
#: feeding a signature verification (TBS certificate bytes, SKX /
#: CertificateVerify signed data) is computed through the witnessed SHA
#: paths, so the SHA chips prove the cert-chain hashes (composes with the
#: recorded RSA/ECDSA mulmods).
_hash_recs: contextvars.ContextVar = contextvars.ContextVar(
    "zktls_x509_hash_recorders", default=(None, None))


@contextmanager
def hash_recording(rec256=None, rec512=None):
    token = _hash_recs.set((rec256, rec512))
    try:
        yield
    finally:
        _hash_recs.reset(token)


class SignatureScheme:
    """TLS SignatureScheme registry values (RFC 8446 §4.2.3)."""

    RSA_PKCS1_SHA256 = 0x0401
    RSA_PKCS1_SHA384 = 0x0501
    RSA_PKCS1_SHA512 = 0x0601
    ECDSA_P256_SHA256 = 0x0403
    ECDSA_P384_SHA384 = 0x0503
    RSA_PSS_SHA256 = 0x0804
    RSA_PSS_SHA384 = 0x0805
    RSA_PSS_SHA512 = 0x0806
    ED25519 = 0x0807


def _hash(name: str, data: bytes) -> bytes:
    rec256, rec512 = _hash_recs.get()
    if name == "sha256" and rec256 is not None:
        from .crypto.sha256 import SHA256

        return SHA256(data, recorder=rec256).digest()
    if name in ("sha384", "sha512") and rec512 is not None:
        from .crypto.sha512 import SHA384, SHA512

        cls = SHA384 if name == "sha384" else SHA512
        return cls(data, recorder=rec512).digest()
    import hashlib

    return getattr(hashlib, name)(data).digest()


def _decode_ecdsa_der_sig(sig: bytes) -> tuple[int, int]:
    """Minimal DER SEQUENCE{INTEGER r, INTEGER s} decoder."""
    if sig[0] != 0x30:
        raise ValueError("bad ECDSA signature DER")
    pos = 2
    if sig[1] & 0x80:
        pos += sig[1] & 0x7F

    def read_int(p: int) -> tuple[int, int]:
        if sig[p] != 0x02:
            raise ValueError("bad DER integer")
        ln = sig[p + 1]
        return int.from_bytes(sig[p + 2 : p + 2 + ln], "big"), p + 2 + ln

    r, pos = read_int(pos)
    s, _ = read_int(pos)
    return r, s


#: certificate signature algorithm → its digest (the reference's map; any
#: other algorithm, sha1WithRSAEncryption among them, verifies to False)
_HASH_FOR = {
    "sha256WithRSAEncryption": "sha256",
    "sha384WithRSAEncryption": "sha384",
    "sha512WithRSAEncryption": "sha512",
    "ecdsa-with-SHA256": "sha256",
    "ecdsa-with-SHA384": "sha384",
}


@dataclass
class Certificate:
    der: bytes
    _cert: der.X509

    @classmethod
    def parse(cls, data: bytes) -> "Certificate":
        """Raises ValueError on malformed DER."""
        return cls(der=data, _cert=der.parse_certificate(data))

    # ------------------------------------------------------------------
    # signatures under this certificate's key
    # ------------------------------------------------------------------

    def public_key_verify(self, scheme: int, data: bytes, sig: bytes) -> bool:
        """Verify `sig` over `data` under this certificate's public key with
        the given TLS SignatureScheme (used for ServerKeyExchange /
        CertificateVerify signatures)."""
        key = self._cert.public_key()
        S = SignatureScheme
        if isinstance(key, der.RsaKey):
            if scheme == S.RSA_PKCS1_SHA256:
                return rsa_pkcs1v15_verify(key.n, key.e, "sha256",
                                           _hash("sha256", data), sig)
            if scheme == S.RSA_PKCS1_SHA384:
                return rsa_pkcs1v15_verify(key.n, key.e, "sha384",
                                           _hash("sha384", data), sig)
            if scheme == S.RSA_PKCS1_SHA512:
                return rsa_pkcs1v15_verify(key.n, key.e, "sha512",
                                           _hash("sha512", data), sig)
            if scheme == S.RSA_PSS_SHA256:
                return rsa_pss_verify(key.n, key.e, "sha256",
                                      _hash("sha256", data), sig)
            if scheme == S.RSA_PSS_SHA384:
                return rsa_pss_verify(key.n, key.e, "sha384",
                                      _hash("sha384", data), sig)
            if scheme == S.RSA_PSS_SHA512:
                return rsa_pss_verify(key.n, key.e, "sha512",
                                      _hash("sha512", data), sig)
            return False
        if isinstance(key, der.EcKey):
            r, s = _decode_ecdsa_der_sig(sig)
            if scheme == S.ECDSA_P256_SHA256 and key.curve == "secp256r1":
                return ecdsa_verify(P256, (key.x, key.y),
                                    _hash("sha256", data), r, s)
            if scheme == S.ECDSA_P384_SHA384 and key.curve == "secp384r1":
                return ecdsa_verify(P384, (key.x, key.y),
                                    _hash("sha384", data), r, s)
            return False
        if isinstance(key, der.Ed25519Key):
            return scheme == S.ED25519 and ed25519_verify(key.raw, data, sig)
        return False

    # ------------------------------------------------------------------
    # issuer signature over this certificate
    # ------------------------------------------------------------------

    def verify_signed_by(self, issuer: "Certificate") -> bool:
        """Check this certificate's signature under the issuer's key, running
        the math through the framework's own verifiers."""
        tbs = self._cert.tbs
        sig = self._cert.signature
        hname = _HASH_FOR.get(self._cert.signature_name)
        key = issuer._cert.public_key()
        if isinstance(key, der.RsaKey):
            if hname is None:
                return False
            return rsa_pkcs1v15_verify(key.n, key.e, hname,
                                       _hash(hname, tbs), sig)
        if isinstance(key, der.EcKey):
            if hname is None:
                return False
            # the reference's choice: any curve but P-256 is taken as P-384
            curve = P256 if key.curve == "secp256r1" else P384
            r, s = _decode_ecdsa_der_sig(sig)
            return ecdsa_verify(curve, (key.x, key.y), _hash(hname, tbs),
                                r, s)
        if isinstance(key, der.Ed25519Key):
            return ed25519_verify(key.raw, tbs, sig)
        return False

    # ------------------------------------------------------------------
    # identity + validity
    # ------------------------------------------------------------------

    def matches_hostname(self, hostname: str) -> bool:
        """DNS-ID matching against subjectAltName (wildcard left-label only,
        as rustls-webpki does)."""
        value = self._cert.extension(der.OID_SAN)
        if value is None:
            return False
        names = der.san_dns_names(value)
        host = hostname.lower().rstrip(".")
        for name in names:
            name = name.lower()
            if name == host:
                return True
            if name.startswith("*."):
                suffix = name[1:]  # ".example.com"
                if host.endswith(suffix) and "." not in host[: -len(suffix)]:
                    return True
        return False

    def valid_at(self, unix_seconds: int) -> bool:
        return self._cert.not_before <= unix_seconds <= self._cert.not_after


def verify_chain(der_chain: list[bytes], hostname: str, unix_seconds: int) -> dict:
    """Verify the presented chain: each cert signed by its successor,
    validity windows at the pinned clock, leaf DNS identity, and the chain
    anchored to the embedded root store (guest/roots.pem — the framework
    equivalent of the reference pinning webpki-roots,
    crates/input-builder/src/request.rs:25-27).

    Anchoring: the last presented cert either IS a store anchor (matched
    by SPKI), or its issuer names a store anchor whose key verifies its
    signature — both run through the framework's own witnessed RSA/ECDSA
    verifiers so the anchor check is part of the proven workload.  The
    journal's root_spki_sha256 is the matched ANCHOR's SPKI digest."""
    import hashlib

    # looked up at call time, so a caller can change the store
    from .roots import anchor_spki_hashes, find_anchor_by_subject

    certs = [Certificate.parse(d) for d in der_chain]
    result = {
        "hostname_match": certs[0].matches_hostname(hostname),
        "validity": all(c.valid_at(unix_seconds) for c in certs),
        "signatures": all(
            certs[i].verify_signed_by(certs[i + 1]) for i in range(len(certs) - 1)
        ),
    }

    last = certs[-1]
    last_spki_hash = hashlib.sha256(last._cert.spki).digest()
    anchored = False
    anchor_spki = None
    if last_spki_hash in anchor_spki_hashes():
        # the chain presented a root that is itself in the store
        anchored = True
        anchor_spki = last_spki_hash
    else:
        for anchor_cert in find_anchor_by_subject(last._cert.issuer):
            if last.verify_signed_by(anchor_cert):
                anchored = True
                anchor_spki = hashlib.sha256(anchor_cert._cert.spki).digest()
                break
    result["anchored"] = anchored
    result["root_spki_sha256"] = (
        anchor_spki.hex() if anchor_spki is not None else last_spki_hash.hex())
    return result
