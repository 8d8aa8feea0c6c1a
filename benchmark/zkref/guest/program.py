"""The guest program: replay → verify → commit journal.

Equivalent of the reference's external zkvm-programs guest main
(SURVEY.md §3.4): parse GuestInput, replay the TLS session from the tapes,
verify server identity and response binding, and commit the public journal.
Runs natively here (no RISC-V emulation); every crypto step it performs is
recorded as witness events for the STARK chips.

Port copy of zktls_tpu.guest.program (same names and values).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..core.tape import parse_time
from ..core.types import GuestInput
from .journal import encode_journal
from .replay import ReplayError, ReplayResult, replay_session
from .x509 import verify_chain

__all__ = ["GuestOutput", "run_guest"]


@dataclass
class GuestOutput:
    journal: bytes
    replay: ReplayResult
    chain: dict
    #: every modular mul/inverse of the EC paths (ECDHE, ECDSA cert
    #: signatures, origin recovery) — the ModMul chip's witness stream
    modmul_events: list = None
    #: the raw recorded stream tape (the stream-parser chip's byte rows)
    stream: bytes = b""
    #: session negotiated TLS 1.3
    v13: bool = False
    #: per-GCM-record stream metadata (record_walk.GcmRecordMeta)
    gcm_metas: list = None


def run_guest(guest_input: GuestInput, *, require_cert_validity: bool = True,
              require_trust_anchor: bool = True) -> GuestOutput:
    """Execute the guest semantics.  Raises ReplayError if the recorded
    session is not a valid, self-consistent TLS session bound to the request.
    """
    from .crypto.modmul import recording

    with recording() as modmul_rec:
        return _run_guest_recorded(
            guest_input, modmul_rec,
            require_cert_validity=require_cert_validity,
            require_trust_anchor=require_trust_anchor)


def _run_guest_recorded(guest_input: GuestInput, modmul_rec, *,
                        require_cert_validity: bool,
                        require_trust_anchor: bool) -> GuestOutput:
    resp = guest_input.response
    replay = replay_session(resp)
    if not replay.all_checks_pass():
        failed = [k for k, v in replay.checks.items() if not v]
        raise ReplayError(f"replay checks failed: {failed}")

    server_name = guest_input.request.request_info.server_name
    sec, _ = parse_time(resp.time)
    # cert-chain hashes (TBS bytes, signed data) run through the witness
    # recorders so the SHA chips prove them alongside the recorded
    # RSA/ECDSA mulmods (x509.hash_recording)
    from .x509 import hash_recording

    if replay.sha512_recorder is None:
        from .crypto.sha512 import SHA512Recorder

        replay.sha512_recorder = SHA512Recorder()
    with hash_recording(replay.sha256_recorder, replay.sha512_recorder):
        chain = verify_chain(replay.certificate_chain, server_name, sec)
    if not replay.sha512_recorder.events:
        replay.sha512_recorder = None
    if not chain["hostname_match"]:
        raise ReplayError(f"certificate does not match {server_name!r}")
    if not chain["signatures"]:
        raise ReplayError("certificate chain signatures invalid")
    if require_cert_validity and not chain["validity"]:
        raise ReplayError("certificate chain not valid at pinned time")
    if require_trust_anchor and not chain["anchored"]:
        raise ReplayError(
            "certificate chain does not anchor to the embedded root store "
            "(guest/roots.pem)")

    # the recorded request plaintext must be the request being attested
    expected_request = guest_input.request.request_info.request
    if expected_request and replay.request_plaintext != expected_request:
        raise ReplayError("decrypted request does not match attested request")

    from .origin import recover_origin_signer

    origin_signer = recover_origin_signer(guest_input.request)

    # v2 binding fields: the stream-tape digest is computed through the
    # witnessed SHA-256 path and published on the proof bus
    # (RESULT_TAG_STREAM); the GCM record headers ground the control chip
    from ..stark.bus import RESULT_TAG_JOURNAL, RESULT_TAG_STREAM
    from ..stark.chips.gcm_control import pack_gcm_records
    from ..stark.chips.record_walk import walk_stream_records

    v13 = replay.version == 0x0304
    has_gcm = bool(replay.gcm_events)
    # ChaCha20-Poly1305 sessions (0x1303 and 0xCCA8) carry record
    # headers: the parser's nonce-less walk (cnl register) + the ChaCha
    # control/data chips bind them (stark/chips/chacha_control.py)
    cha_events = getattr(replay, "chacha_events", None) or []
    has_cha = bool(cha_events)
    has_rec = has_gcm or has_cha
    rec_events = replay.gcm_events if has_gcm else \
        (cha_events if has_cha else [])
    # record sessions: the stream hash chain exposes its message blocks on
    # the bus for the stream-parser chip, under the reserved object id 1
    # (batch sessions use i+1; the verifier derives the id) — see
    # stark/chips/stream_parser.py
    stream_sha256 = replay.sha256_recorder.sha256(
        resp.stream, result_tag=RESULT_TAG_STREAM,
        expose_blocks=has_rec, obj=1 if has_rec else None)
    gcm_metas = (walk_stream_records(resp.stream, rec_events, v13,
                                     nonce_len=8 if has_gcm else 0)
                 if has_rec else [])
    gcm_records = pack_gcm_records(rec_events, gcm_metas, v13)

    journal = encode_journal(
        guest_input,
        response_plaintext=replay.response_plaintext,
        root_spki_sha256=bytes.fromhex(chain["root_spki_sha256"]),
        origin_signer=origin_signer,
        stream_sha256=stream_sha256,
        gcm_records=gcm_records,
    )
    # the journal digest itself is the proof's anchor: the SHA chip proves
    # it over the witnessed journal bytes, the verifier recomputes it from
    # the received journal (guest/journal.py, stark/machine.py)
    replay.sha256_recorder.sha256(journal, result_tag=RESULT_TAG_JOURNAL)
    return GuestOutput(journal=journal, replay=replay, chain=chain,
                       modmul_events=modmul_rec.events, stream=resp.stream,
                       v13=v13, gcm_metas=gcm_metas)
