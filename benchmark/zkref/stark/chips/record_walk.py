"""Host-side TLS record walker: the witness-generation counterpart of the
stream-parser AIR's DFA.

Walks the two directed byte streams of a recorded tape and emits, for every
encrypted (GCM) record, the metadata tuple the chips exchange on the bus:
(dir, eid, seqno, rectype, ct_len, is_resp, rbase, nonce_explicit, ct, tag).
Used by the GCM data / control chip trace builders and by tests deriving
expected bus messages.  eids resolve by matching record tag bytes against
the recorded GCMEvents (unique per event; the replay decrypted each record
exactly once).

Port copy of zktls_tpu.stark.chips.record_walk (same names and values; host
code in numpy)."""

from __future__ import annotations

import struct
from dataclasses import dataclass

from ...core.tape import stream_halves

__all__ = ["GcmRecordMeta", "walk_stream_records"]


@dataclass
class GcmRecordMeta:
    dir: str            # "c" or "s"
    eid: int
    seqno: int          # per-direction encrypted-record counter
    rectype: int        # outer record type byte
    ct_len: int
    is_resp: int        # journal semantics: server-direction app record
    is_app: int = 0     # direction-local: contributes to this direction's
    #                     application stream (request or response)
    rbase: int = 0      # app-stream position of the record's first pt byte
    nonce_explicit: bytes = b""   # 8 bytes (TLS 1.2) or b""
    ct: bytes = b""
    tag: bytes = b""
    v13: int = 0        # session TLS-1.3 flag
    obj: int = 1        # session stream hash-object id (batch: i+1)


def walk_stream_records(stream: bytes, gcm_events: list,
                        v13: bool, nonce_len: int = 8
                        ) -> list[GcmRecordMeta]:
    """nonce_len: TLS 1.2 explicit-nonce length — 8 for AES-GCM, 0 for
    ChaCha20-Poly1305 (RFC 7905 derives the nonce from iv ⊕ seq, no
    explicit bytes on the wire).  Ignored for TLS 1.3."""
    tag_to_eid = {bytes(ev.tag): i for i, ev in enumerate(gcm_events)}
    out: list[GcmRecordMeta] = []
    c2s, s2c = stream_halves(stream)
    for dk, data in (("c", c2s), ("s", s2c)):
        enc, cnt, dtot = 0, 0, 0
        pos = 0
        while pos < len(data):
            if pos + 5 > len(data):
                raise ValueError("truncated record header in stream")
            typ = data[pos]
            ln = struct.unpack(">H", data[pos + 3 : pos + 5])[0]
            body = data[pos + 5 : pos + 5 + ln]
            if len(body) != ln:
                raise ValueError("truncated record body in stream")
            isg = (1 if typ == 23 else 0) if v13 else enc
            if isg:
                if v13:
                    nonce, ct, tag = b"", body[:-16], body[-16:]
                else:
                    nonce, ct, tag = (body[:nonce_len],
                                      body[nonce_len:-16], body[-16:])
                if bytes(tag) not in tag_to_eid:
                    raise ValueError("GCM record tag not among events")
                eid = tag_to_eid[bytes(tag)]
                if v13:
                    ev = gcm_events[eid]
                    is_app = 1 if ev.plaintext and \
                        ev.plaintext[-1] == 23 else 0
                else:
                    is_app = 1 if typ == 23 else 0
                is_resp = is_app if dk == "s" else 0
                out.append(GcmRecordMeta(
                    dir=dk, eid=eid, seqno=cnt, rectype=typ,
                    ct_len=len(ct), is_resp=is_resp, is_app=is_app,
                    rbase=dtot, nonce_explicit=bytes(nonce), ct=bytes(ct),
                    tag=bytes(tag), v13=1 if v13 else 0))
                if is_app:
                    dtot += len(ct) - (1 if v13 else 0)
                cnt += 1
            if typ == 20 and not enc:
                enc = 1
            pos += 5 + ln
    return out
