"""Carry objects across from the reference package into the port's, without
importing the reference, and the session witness codec.

The `*_from_reference` functions are duck-typed: they read only the
attributes named below, so they take zktls_tpu's objects (or anything shaped
like them).

The session witness is a stopgap until the port replays TLS sessions itself
(its `run_guest` is not ported yet): a CBOR file holding exactly the fields
of a replayed `GuestOutput` that `provers.stark.build_chip_instances`,
`_derive_ks_sessions`, `_filtered_multiplicities` and
`journal_public_messages` read.  `decode_witness` turns it into a
`GuestOutput` of the port's own types.  Big integers (RSA and curve values)
are stored as minimal big-endian bytes, so they round-trip exactly.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .core import cbor
from .guest.crypto.ec import P256, P384, SECP256K1
from .guest.crypto.gcm import GCMEvent
from .guest.crypto.modmul import ModMulEvent
from .guest.crypto.sha256 import CompressionEvent, SHA256Recorder
from .stark.chips import AIRS
from .stark.chips.record_walk import GcmRecordMeta
from .stark.machine import ChipInstance

__all__ = ["chip_instance_from_reference", "events_from_reference",
           "CipherSuite", "ReplayResult", "GuestOutput",
           "guest_output_from_reference", "encode_witness", "decode_witness",
           "WITNESS_VERSION"]

WITNESS_VERSION = 1

_CURVES = {c.name: c for c in (P256, P384, SECP256K1)}


def chip_instance_from_reference(inst) -> ChipInstance:
    """A reference ChipInstance -> the port's: the AIR is looked up by
    `inst.air.name` in the port's registry; `trace`, `publics` and
    `preprocessed` are copied."""
    name = inst.air.name
    if name not in AIRS:
        raise KeyError(f"chip {name!r} is not ported")
    pre = inst.preprocessed
    return ChipInstance(
        air=AIRS[name](),
        trace=np.array(inst.trace, dtype=np.uint32),
        publics=[int(v) for v in inst.publics],
        preprocessed=None if pre is None else np.array(pre,
                                                       dtype=np.uint32))


def events_from_reference(events) -> list[CompressionEvent]:
    """Reference SHA-256 CompressionEvents -> the port's."""
    return [CompressionEvent(
        block=bytes(e.block), state_in=tuple(e.state_in),
        state_out=tuple(e.state_out), obj=e.obj, seq=e.seq,
        result_tag=e.result_tag, expose_block=e.expose_block)
        for e in events]


# ---------------------------------------------------------------------------
# the replayed session, as far as the chip builders read it
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CipherSuite:
    """The negotiated suite's fields the key schedule reads (the reference's
    guest/tls.py CipherSuite has more)."""

    id: int
    aead: str          # "aes-gcm" | "chacha20-poly1305"
    key_len: int


@dataclass
class ReplayResult:
    """The fields of the reference's guest/replay.py ReplayResult that the
    chip builders and the key schedule read."""

    version: int
    cipher_suite: CipherSuite
    client_random: bytes
    server_random: bytes
    premaster_secret: bytes
    master_secret: bytes
    session_hash: bytes
    request_plaintext: bytes
    response_plaintext: bytes
    sha256_recorder: SHA256Recorder
    gcm_events: list[GCMEvent] = field(default_factory=list)
    #: (curve, ECDHE scalar, server point) of a short-Weierstrass exchange
    ecdhe_weierstrass: tuple | None = None


@dataclass
class GuestOutput:
    """The reference's guest/program.py GuestOutput without the certificate
    chain report, which no chip reads."""

    journal: bytes
    replay: ReplayResult
    modmul_events: list[ModMulEvent]
    stream: bytes
    v13: bool
    gcm_metas: list[GcmRecordMeta]


def _recorder(events) -> SHA256Recorder:
    rec = SHA256Recorder()
    rec.events = list(events)
    return rec


def guest_output_from_reference(out) -> GuestOutput:
    """A reference GuestOutput (from zktls_tpu's run_guest) -> the port's,
    every event carried into the port's own types."""
    rep = out.replay
    suite = rep.cipher_suite
    ecd = rep.ecdhe_weierstrass
    if ecd is not None:
        curve, scalar, pt = ecd
        ecd = (_CURVES[curve.name], int(scalar),
               None if pt is None else (int(pt[0]), int(pt[1])))
    if getattr(rep, "sha512_recorder", None) is not None or \
            getattr(rep, "chacha_events", None):
        raise NotImplementedError(
            "SHA-384 and ChaCha20 sessions need chips that are not ported")
    return GuestOutput(
        journal=bytes(out.journal),
        replay=ReplayResult(
            version=int(rep.version),
            cipher_suite=CipherSuite(int(suite.id), str(suite.aead),
                                     int(suite.key_len)),
            client_random=bytes(rep.client_random),
            server_random=bytes(rep.server_random),
            premaster_secret=bytes(rep.premaster_secret),
            master_secret=bytes(rep.master_secret),
            session_hash=bytes(rep.session_hash),
            request_plaintext=bytes(rep.request_plaintext),
            response_plaintext=bytes(rep.response_plaintext),
            sha256_recorder=_recorder(events_from_reference(
                rep.sha256_recorder.events)),
            gcm_events=[GCMEvent(
                key=bytes(e.key), nonce=bytes(e.nonce), aad=bytes(e.aad),
                ciphertext=bytes(e.ciphertext), plaintext=bytes(e.plaintext),
                tag=bytes(e.tag),
                counter_blocks=[bytes(b) for b in e.counter_blocks],
                keystream=[bytes(b) for b in e.keystream],
                h_block=bytes(e.h_block), j0_mask=bytes(e.j0_mask))
                for e in rep.gcm_events],
            ecdhe_weierstrass=ecd),
        modmul_events=[ModMulEvent(int(e.a), int(e.b), int(e.r), int(e.m))
                       for e in (out.modmul_events or [])],
        stream=bytes(out.stream),
        v13=bool(out.v13),
        gcm_metas=[GcmRecordMeta(
            dir=m.dir, eid=int(m.eid), seqno=int(m.seqno),
            rectype=int(m.rectype), ct_len=int(m.ct_len),
            is_resp=int(m.is_resp), is_app=int(m.is_app),
            rbase=int(m.rbase), nonce_explicit=bytes(m.nonce_explicit),
            ct=bytes(m.ct), tag=bytes(m.tag), v13=int(m.v13),
            obj=int(m.obj)) for m in (out.gcm_metas or [])],
    )


# ---------------------------------------------------------------------------
# witness codec
# ---------------------------------------------------------------------------


def _ib(v: int) -> bytes:
    """A non-negative integer as minimal big-endian bytes."""
    if v < 0:
        raise ValueError("witness integers are non-negative")
    return v.to_bytes((v.bit_length() + 7) // 8, "big")


def _bi(b: bytes) -> int:
    return int.from_bytes(b, "big")


_META_FIELDS = ("dir", "eid", "seqno", "rectype", "ct_len", "is_resp",
                "is_app", "rbase", "nonce_explicit", "ct", "tag", "v13",
                "obj")
_GCM_FIELDS = ("key", "nonce", "aad", "ciphertext", "plaintext", "tag",
               "counter_blocks", "keystream", "h_block", "j0_mask")
_REPLAY_BYTES = ("client_random", "server_random", "premaster_secret",
                 "master_secret", "session_hash", "request_plaintext",
                 "response_plaintext")


def encode_witness(out: GuestOutput) -> bytes:
    """The port's GuestOutput -> witness CBOR bytes (deterministic)."""
    rep = out.replay
    moduli: list[int] = []
    midx: dict[int, int] = {}
    mm = []
    for e in out.modmul_events:
        if e.m not in midx:
            midx[e.m] = len(moduli)
            moduli.append(e.m)
        mm.append([midx[e.m], _ib(e.a), _ib(e.b), _ib(e.r)])
    ecd = rep.ecdhe_weierstrass
    if ecd is not None:
        curve, scalar, pt = ecd
        ecd = [curve.name, _ib(scalar),
               None if pt is None else [_ib(pt[0]), _ib(pt[1])]]
    suite = rep.cipher_suite
    return cbor.dumps({
        "v": WITNESS_VERSION,
        "journal": out.journal,
        "stream": out.stream,
        "v13": out.v13,
        "gcm_metas": [[getattr(m, f) for f in _META_FIELDS]
                      for m in out.gcm_metas],
        "modmul_moduli": [_ib(m) for m in moduli],
        "modmul_events": mm,
        "replay": {
            "version": rep.version,
            "cipher_suite": [suite.id, suite.aead, suite.key_len],
            **{k: getattr(rep, k) for k in _REPLAY_BYTES},
            "sha256_events": [
                [e.block, list(e.state_in), list(e.state_out), e.obj, e.seq,
                 e.result_tag, e.expose_block]
                for e in rep.sha256_recorder.events],
            "gcm_events": [[getattr(e, f) for f in _GCM_FIELDS]
                           for e in rep.gcm_events],
            "ecdhe_weierstrass": ecd,
        },
    })


def decode_witness(data: bytes) -> GuestOutput:
    """Witness CBOR bytes -> the port's GuestOutput."""
    obj = cbor.loads(data)
    if obj.get("v") != WITNESS_VERSION:
        raise ValueError(f"unsupported witness version {obj.get('v')!r}")
    r = obj["replay"]
    moduli = [_bi(m) for m in obj["modmul_moduli"]]
    ecd = r["ecdhe_weierstrass"]
    if ecd is not None:
        name, scalar, pt = ecd
        ecd = (_CURVES[name], _bi(scalar),
               None if pt is None else (_bi(pt[0]), _bi(pt[1])))
    sid, aead, key_len = r["cipher_suite"]
    return GuestOutput(
        journal=obj["journal"],
        replay=ReplayResult(
            version=r["version"],
            cipher_suite=CipherSuite(sid, aead, key_len),
            **{k: r[k] for k in _REPLAY_BYTES},
            sha256_recorder=_recorder(CompressionEvent(
                block=e[0], state_in=tuple(e[1]), state_out=tuple(e[2]),
                obj=e[3], seq=e[4], result_tag=e[5], expose_block=e[6])
                for e in r["sha256_events"]),
            gcm_events=[GCMEvent(**dict(zip(_GCM_FIELDS, e)))
                        for e in r["gcm_events"]],
            ecdhe_weierstrass=ecd),
        modmul_events=[ModMulEvent(_bi(a), _bi(b), _bi(rr), moduli[i])
                       for i, a, b, rr in obj["modmul_events"]],
        stream=obj["stream"],
        v13=obj["v13"],
        gcm_metas=[GcmRecordMeta(**dict(zip(_META_FIELDS, m)))
                   for m in obj["gcm_metas"]],
    )
