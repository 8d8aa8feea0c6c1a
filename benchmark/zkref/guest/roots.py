"""Embedded trust-anchor store (Mozilla CA bundle snapshot, roots.pem).

The reference host pins `webpki_roots::TLS_SERVER_ROOTS`
(crates/input-builder/src/request.rs:25-27) and the guest verifies the
presented chain to one of those anchors inside the zkVM.  This module is
the framework's equivalent: a vendored snapshot of the Mozilla root
program's CA bundle (the same upstream webpki-roots is generated from),
loaded once and indexed by subject DER and SPKI hash.

Port of zktls_tpu.guest.roots (same names; roots.pem is the same file).
The certificates are read by the port's own DER reader (guest/der.py) and
indexed by their raw subject Name and the SHA-256 of their raw
SubjectPublicKeyInfo; `trust_anchors` and `find_anchor_by_subject` give
x509.Certificate objects.  A block the reader cannot load is skipped.
"""

from __future__ import annotations

import hashlib
import pathlib
from functools import lru_cache

__all__ = ["trust_anchors", "find_anchor_by_subject", "anchor_spki_hashes"]

_PEM_PATH = pathlib.Path(__file__).with_name("roots.pem")


@lru_cache(maxsize=1)
def _store():
    """subject-DER → list of anchor certs; plus the SPKI sha256 set."""
    from .der import pem_blocks, pem_to_der
    from .x509 import Certificate

    by_subject: dict[bytes, list] = {}
    spki_hashes: set[bytes] = set()
    for block in pem_blocks(_PEM_PATH.read_bytes()):
        try:
            cert = Certificate.parse(pem_to_der(block))
            cert._cert.public_key()
        except ValueError:
            continue
        by_subject.setdefault(cert._cert.subject, []).append(cert)
        spki_hashes.add(hashlib.sha256(cert._cert.spki).digest())
    return by_subject, spki_hashes


def trust_anchors() -> dict:
    return _store()[0]


def anchor_spki_hashes() -> set:
    return _store()[1]


def find_anchor_by_subject(subject_der: bytes) -> list:
    """Anchor certificates whose subject equals the given DER name."""
    return _store()[0].get(subject_der, [])
