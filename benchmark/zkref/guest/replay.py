"""Deterministic TLS-session replay from the recorded (stream, random, time)
tapes — the guest program of the proving system.

This is the workload the reference proves inside a RISC-V zkVM
(SURVEY.md §3.4: ~22M RV32IM cycles of rustls replay).  Here it runs natively
as the *witness generator*: every cryptographic intermediate (SHA-256
compressions, AES-GCM keystream blocks, EC scalar multiplications, PRF
expansions) is recorded so the STARK AIR chips can prove exactly this
computation without a CPU-emulation circuit (the "Route N" design of
SURVEY.md §7).

Replays TLS 1.2 ECDHE + AEAD sessions (the fixture's shape: TLS 1.2,
0xc02f, P-256, extended master secret) and TLS 1.3 is structured for
follow-on support.

Port copy of zktls_tpu.guest.replay (same names and values).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..core.tape import RandomTape, stream_halves
from ..core.types import GuestInputResponse
from .crypto.ec import P256, P384, Curve
from .crypto.gcm import AESGCM, GCMEvent
from .crypto.chacha import ChaCha20Poly1305
from .crypto.prf import hmac_sha256, prf_sha256
from .crypto.sha256 import SHA256Recorder
from .crypto.x25519 import x25519, x25519_base
from .tls import (
    CIPHER_SUITES,
    CertificateChain,
    ClientHello,
    ContentType,
    HandshakeMessage,
    HandshakeType,
    Record,
    ServerHello,
    ServerKeyExchange,
    CipherSuite,
    iter_handshake_messages,
    parse_records,
)

__all__ = ["ReplayError", "ReplayResult", "replay_session"]


class ReplayError(Exception):
    """The tape does not describe a valid, self-consistent TLS session."""


# The recorded rustls client's RNG draw schedule (verified against the
# fixture, SURVEY.md §2.3): x25519 key-share scalar, legacy session id,
# client random, a 2-byte draw (GREASE-style), then the P-256 ECDHE scalar
# drawn at ClientKeyExchange time for TLS 1.2 sessions.
_DRAW_X25519 = 32
_DRAW_SESSION_ID = 32
_DRAW_CLIENT_RANDOM = 32
_DRAW_MISC = 2


@dataclass
class DecryptedRecord:
    seq: int
    content_type: int
    plaintext: bytes
    from_server: bool


@dataclass
class ReplayResult:
    """Everything the replay established + the witness event streams."""

    version: int
    cipher_suite: CipherSuite
    curve_name: str
    client_random: bytes
    server_random: bytes
    premaster_secret: bytes
    master_secret: bytes
    session_hash: bytes
    client_write_key: bytes
    server_write_key: bytes
    client_iv: bytes
    server_iv: bytes
    client_finished_ok: bool
    server_finished_ok: bool
    skx_signature_ok: bool | None
    certificate_chain: list[bytes]
    request_plaintext: bytes
    response_plaintext: bytes
    records: list[DecryptedRecord]
    handshake_transcript: list[bytes]
    # witness event streams for AIR trace generation
    sha256_recorder: SHA256Recorder = field(repr=False, default_factory=SHA256Recorder)
    gcm_events: list[GCMEvent] = field(repr=False, default_factory=list)
    #: ChaCha20-Poly1305 record events (chacha suites)
    chacha_events: list = field(repr=False, default_factory=list)
    #: SHA-512 recorder for SHA-384 suites (None for SHA-256 suites)
    sha512_recorder: object | None = field(repr=False, default=None)
    #: Weierstrass ECDHE witness (TLS 1.2 P-256/P-384): (curve, scalar,
    #: server_point) — the EC schedule chip proves the d·G / d·S ladder
    #: pair over the recorded mulmod events (stark/chips/ec.py); None for
    #: x25519 sessions (Montgomery-ladder chip 📋)
    ecdhe_weierstrass: tuple | None = field(repr=False, default=None)
    checks: dict[str, bool] = field(default_factory=dict)

    def all_checks_pass(self) -> bool:
        return all(self.checks.values())


def _curve_for(curve_id: int) -> Curve:
    if curve_id == 23:
        return P256
    if curve_id == 24:
        return P384
    raise ReplayError(f"unsupported named curve {curve_id}")


def _verify_skx_signature(skx: ServerKeyExchange, leaf_der: bytes,
                          client_random: bytes, server_random: bytes) -> bool:
    """Verify the ServerKeyExchange signature with the leaf certificate key
    (RFC 5246 §7.4.3: signed data = client_random ‖ server_random ‖ params)."""
    from .x509 import Certificate  # local import to avoid cycle

    signed = client_random + server_random + skx.params_raw
    cert = Certificate.parse(leaf_der)
    return cert.public_key_verify(skx.signature_scheme, signed, skx.signature)


def replay_session(response: GuestInputResponse) -> ReplayResult:
    """Replay the recorded session; raises ReplayError on any inconsistency."""
    rec = SHA256Recorder()
    c2s, s2c = stream_halves(response.stream)
    tape = RandomTape(response.random)

    x25519_priv = tape.draw(_DRAW_X25519)
    session_id = tape.draw(_DRAW_SESSION_ID)
    client_random = tape.draw(_DRAW_CLIENT_RANDOM)
    tape.draw(_DRAW_MISC)

    client_records = parse_records(c2s)
    server_records = parse_records(s2c)

    # --- ClientHello: parse from tape and check it is the one the recorded
    # RNG would produce (key identity checks from the tape draws) ---
    ch_msgs = iter_handshake_messages(client_records[0].payload)
    if ch_msgs[0].typ != HandshakeType.CLIENT_HELLO:
        raise ReplayError("first client message is not ClientHello")
    ch = ClientHello.parse(ch_msgs[0].body)
    checks: dict[str, bool] = {}
    checks["client_random_from_tape"] = ch.client_random == client_random
    checks["session_id_from_tape"] = ch.session_id == session_id
    shares = ch.key_shares()
    if 29 in shares:  # x25519 key share offered for TLS 1.3
        checks["x25519_share_from_tape"] = shares[29] == x25519_base(x25519_priv)

    # --- server flight: handshake messages span record boundaries, so join
    # all plaintext handshake payloads up to the server CCS before parsing ---
    pre_ccs = bytearray()
    for r in server_records:
        if r.typ == ContentType.CHANGE_CIPHER_SPEC:
            break
        if r.typ == ContentType.HANDSHAKE:
            pre_ccs += r.payload
    server_hs = iter_handshake_messages(bytes(pre_ccs))
    if not server_hs or server_hs[0].typ != HandshakeType.SERVER_HELLO:
        raise ReplayError("first server message is not ServerHello")
    sh = ServerHello.parse(server_hs[0].body)

    suite = CIPHER_SUITES.get(sh.cipher_suite)
    if suite is None:
        raise ReplayError(f"unsupported cipher suite {sh.cipher_suite:#06x}")
    checks["suite_offered"] = sh.cipher_suite in ch.cipher_suites

    if sh.selected_version == 0x0304:
        return _replay_tls13(
            response, rec, x25519_priv, ch_msgs[0].raw, ch, sh, suite,
            client_records, server_records, server_hs, checks,
        )
    return _replay_tls12(
        response, rec, tape, ch_msgs[0].raw, ch, sh, suite,
        client_records, server_records, server_hs, checks,
    )


def _replay_tls12(
    response: GuestInputResponse,
    rec: SHA256Recorder,
    tape: RandomTape,
    client_hello_raw: bytes,
    ch: ClientHello,
    sh: ServerHello,
    suite: CipherSuite,
    client_records: list[Record],
    server_records: list[Record],
    server_hs: list,
    checks: dict[str, bool],
) -> ReplayResult:
    if not sh.has_extended_master_secret:
        raise ReplayError(
            "session lacks extended master secret (rustls requires RFC 7627)"
        )
    # hash family: SHA-384 suites (0xC030 etc.) hash transcript + PRF
    # through the SHA-512 recorder so the SHA-512 chip proves them
    if suite.hash == "sha384":
        from .crypto.prf import prf_sha384
        from .crypto.sha512 import SHA512Recorder

        rec512 = SHA512Recorder()
        hash_new = rec512.new384

        def prf(secret, label, seed, n):
            return prf_sha384(secret, label, seed, n, rec512)
    else:
        rec512 = None
        hash_new = rec.new

        def prf(secret, label, seed, n):
            return prf_sha256(secret, label, seed, n, rec)

    # Plaintext server handshake messages through ServerHelloDone (transcript
    # order); anything after SHD on the plaintext stream (e.g.
    # NewSessionTicket) joins the transcript later, in message order.
    try:
        shd_index = next(i for i, m in enumerate(server_hs)
                         if m.typ == HandshakeType.SERVER_HELLO_DONE)
    except StopIteration:
        raise ReplayError("incomplete server handshake flight") from None
    server_plain_hs = server_hs[: shd_index + 1]
    post_shd_plain = server_hs[shd_index + 1 :]

    cert_msg = next(
        (m for m in server_plain_hs if m.typ == HandshakeType.CERTIFICATE), None)
    skx_msg = next(
        (m for m in server_plain_hs if m.typ == HandshakeType.SERVER_KEY_EXCHANGE),
        None)
    if cert_msg is None or skx_msg is None:
        raise ReplayError("incomplete server handshake flight")

    chain = CertificateChain.parse(cert_msg.body)
    skx = ServerKeyExchange.parse(skx_msg.body)

    # --- client key exchange ---
    ckx_record = client_records[1]
    ckx_msgs = iter_handshake_messages(ckx_record.payload)
    if ckx_msgs[0].typ != HandshakeType.CLIENT_KEY_EXCHANGE:
        raise ReplayError("second client record is not ClientKeyExchange")
    ckx_msg = ckx_msgs[0]
    ckx_point = ckx_msg.body[1 : 1 + ckx_msg.body[0]]
    # ECDHE private scalar is the next tape draw (size per negotiated group)
    ecdhe_witness = None
    if skx.curve_id == 29:  # x25519 (RFC 7748)
        priv = tape.draw(32)
        checks["ckx_pubkey_from_tape"] = x25519_base(priv) == ckx_point
        premaster = x25519(priv, skx.public_point)
        curve_name = "x25519"
    else:
        curve = _curve_for(skx.curve_id)
        scalar_bytes = tape.draw(curve.byte_len)
        scalar = int.from_bytes(scalar_bytes, "big")
        our_pub = curve.mul(scalar, curve.g)
        checks["ckx_pubkey_from_tape"] = (
            curve.encode_point(our_pub) == ckx_point
        )
        server_point = curve.decode_point(skx.public_point)
        shared = curve.mul(scalar, server_point)
        if shared is None:
            raise ReplayError("ECDHE produced point at infinity")
        premaster = shared[0].to_bytes(curve.byte_len, "big")
        curve_name = curve.name
        ecdhe_witness = (curve, scalar, server_point)

    # --- extended master secret (RFC 7627): session_hash over transcript
    # through ClientKeyExchange ---
    transcript = [client_hello_raw] + [m.raw for m in server_plain_hs] + [ckx_msg.raw]
    h = hash_new()
    for m in transcript:
        h.update(m)
    session_hash = h.digest()
    master = prf(premaster, b"extended master secret", session_hash, 48)

    # --- key block (RFC 5246 §6.3): for AEAD suites only keys + fixed IVs ---
    key_block = prf(
        master, b"key expansion", sh.server_random + ch.client_random,
        2 * suite.key_len + 2 * suite.fixed_iv_len,
    )
    off = 0
    client_key = key_block[off : off + suite.key_len]; off += suite.key_len
    server_key = key_block[off : off + suite.key_len]; off += suite.key_len
    client_iv = key_block[off : off + suite.fixed_iv_len]; off += suite.fixed_iv_len
    server_iv = key_block[off : off + suite.fixed_iv_len]

    gcm_events: list[GCMEvent] = []
    chacha_events: list = []

    def aead(key: bytes):
        if suite.aead == "aes-gcm":
            return AESGCM(key)
        return ChaCha20Poly1305(key)

    client_aead = aead(client_key)
    server_aead = aead(server_key)

    def decrypt_record(r: Record, seq: int, from_server: bool) -> bytes:
        key_iv = server_iv if from_server else client_iv
        cipher = server_aead if from_server else client_aead
        if suite.aead == "aes-gcm":
            explicit, body = r.payload[:8], r.payload[8:]
            nonce = key_iv + explicit
        else:  # chacha: nonce = iv XOR seq (RFC 7905)
            body = r.payload
            nonce = bytes(
                a ^ b for a, b in zip(key_iv, seq.to_bytes(12, "big"))
            )
        aad = seq.to_bytes(8, "big") + bytes([r.typ]) + r.version + \
            (len(body) - 16).to_bytes(2, "big")
        try:
            if suite.aead == "aes-gcm":
                return cipher.decrypt(nonce, body, aad, gcm_events)
            return cipher.decrypt(nonce, body, aad, chacha_events)
        except ValueError as e:
            raise ReplayError(f"record decryption failed (seq {seq}): {e}") from e

    # --- client Finished ---
    cfin_record = client_records[3]  # [CH, CKX, CCS, Finished, AppData...]
    if client_records[2].typ != ContentType.CHANGE_CIPHER_SPEC:
        raise ReplayError("client CCS missing")
    cfin_plain = decrypt_record(cfin_record, 0, from_server=False)
    cfin_msgs = iter_handshake_messages(cfin_plain)
    if cfin_msgs[0].typ != HandshakeType.FINISHED:
        raise ReplayError("client Finished record does not contain Finished")
    h = hash_new()
    for m in transcript:
        h.update(m)
    client_verify = prf(master, b"client finished", h.digest(), 12)
    client_finished_ok = cfin_msgs[0].body == client_verify
    checks["client_finished"] = client_finished_ok
    transcript.append(cfin_msgs[0].raw)

    # --- server NewSessionTicket / CCS / Finished ---
    for m in post_shd_plain:
        if m.typ == HandshakeType.NEW_SESSION_TICKET:
            transcript.append(m.raw)
    post_ccs_server: list[Record] = []
    seen_ccs = False
    for r in server_records:
        if r.typ == ContentType.CHANGE_CIPHER_SPEC:
            seen_ccs = True
            continue
        if seen_ccs:
            post_ccs_server.append(r)
    if not seen_ccs or not post_ccs_server:
        raise ReplayError("server CCS/Finished missing")

    sfin_plain = decrypt_record(post_ccs_server[0], 0, from_server=True)
    sfin_msgs = iter_handshake_messages(sfin_plain)
    if sfin_msgs[0].typ != HandshakeType.FINISHED:
        raise ReplayError("server Finished record does not contain Finished")
    h = hash_new()
    for m in transcript:
        h.update(m)
    server_verify = prf(master, b"server finished", h.digest(), 12)
    server_finished_ok = sfin_msgs[0].body == server_verify
    checks["server_finished"] = server_finished_ok

    # --- SKX signature (server authentication); the signed-data hash is
    # recorded so the SHA chips prove it (x509.hash_recording) ---
    from .x509 import hash_recording

    try:
        with hash_recording(rec, rec512):
            skx_ok = _verify_skx_signature(
                skx, chain.der_certs[0], ch.client_random, sh.server_random)
    except Exception:
        skx_ok = False
    checks["skx_signature"] = bool(skx_ok)

    # --- application data ---
    decrypted: list[DecryptedRecord] = [
        DecryptedRecord(0, ContentType.HANDSHAKE, cfin_plain, False),
        DecryptedRecord(0, ContentType.HANDSHAKE, sfin_plain, True),
    ]
    request_plain = bytearray()
    seq = 1
    for r in client_records[4:]:
        pt = decrypt_record(r, seq, from_server=False)
        decrypted.append(DecryptedRecord(seq, r.typ, pt, False))
        if r.typ == ContentType.APPLICATION_DATA:
            request_plain += pt
        seq += 1

    response_plain = bytearray()
    seq = 1
    for r in post_ccs_server[1:]:
        pt = decrypt_record(r, seq, from_server=True)
        decrypted.append(DecryptedRecord(seq, r.typ, pt, True))
        if r.typ == ContentType.APPLICATION_DATA:
            response_plain += pt
        seq += 1

    checks["response_matches_tape"] = bytes(response_plain) == response.response
    # template-extracted ranges must be sub-slices of the real plaintext
    for i, (b, ln, content) in enumerate(zip(
        response.filtered_responses_begin,
        response.filtered_responses_length,
        response.filtered_responses,
    )):
        checks[f"filtered_response_{i}"] = (
            bytes(response_plain[b : b + ln]) == content
        )

    return ReplayResult(
        version=0x0303,
        cipher_suite=suite,
        curve_name=curve_name,
        client_random=ch.client_random,
        server_random=sh.server_random,
        premaster_secret=premaster,
        master_secret=master,
        session_hash=session_hash,
        client_write_key=client_key,
        server_write_key=server_key,
        client_iv=client_iv,
        server_iv=server_iv,
        client_finished_ok=client_finished_ok,
        server_finished_ok=server_finished_ok,
        skx_signature_ok=skx_ok,
        certificate_chain=chain.der_certs,
        request_plaintext=bytes(request_plain),
        response_plaintext=bytes(response_plain),
        records=decrypted,
        handshake_transcript=transcript,
        sha256_recorder=rec,
        gcm_events=gcm_events,
        chacha_events=chacha_events,
        sha512_recorder=rec512,
        ecdhe_weierstrass=ecdhe_witness,
        checks=checks,
    )


def _replay_tls13(
    response: GuestInputResponse,
    rec: SHA256Recorder,
    x25519_priv: bytes,
    client_hello_raw: bytes,
    ch: ClientHello,
    sh: ServerHello,
    suite: CipherSuite,
    client_records: list[Record],
    server_records: list[Record],
    server_hs: list,
    checks: dict[str, bool],
) -> ReplayResult:
    """TLS 1.3 replay (RFC 8446): the recorded x25519 key-share scalar
    re-derives the handshake secret; every encrypted handshake and
    application record is re-decrypted and the CertificateVerify /
    Finished transcript proofs re-checked."""
    from .tls13 import Tls13KeySchedule, Tls13RecordCrypto, strip_inner_plaintext

    if suite.hash == "sha384":
        from .crypto.sha512 import SHA512Recorder

        rec512 = SHA512Recorder()
        hash_new = rec512.new384
    else:
        rec512 = None
        hash_new = rec.new
    if len(server_hs) != 1:
        # in 1.3 only ServerHello is plaintext handshake on the server side
        raise ReplayError("unexpected plaintext server handshake after SH")

    ks_data = sh.extensions.get(51)
    if ks_data is None:
        raise ReplayError("ServerHello missing key_share (HRR unsupported)")
    group = int.from_bytes(ks_data[0:2], "big")
    klen = int.from_bytes(ks_data[2:4], "big")
    server_share = ks_data[4 : 4 + klen]
    if group != 29:
        raise ReplayError(f"unsupported 1.3 group {group} (client only "
                          "offers an x25519 share without HRR)")
    shared = x25519(x25519_priv, server_share)
    checks["x25519_share_consistent"] = (
        ch.key_shares().get(29) == x25519_base(x25519_priv)
    )

    sched = Tls13KeySchedule(suite, rec, rec512)
    sched.start(shared)
    transcript = [client_hello_raw, server_hs[0].raw]

    def thash() -> bytes:
        h = hash_new()
        for m in transcript:
            h.update(m)
        return h.digest()

    sched.handshake_traffic(thash())
    gcm_events: list[GCMEvent] = []
    chacha_events: list = []
    server_crypto = Tls13RecordCrypto(suite, sched.server_hs_secret, rec,
                                      rec512)
    client_crypto = Tls13RecordCrypto(suite, sched.client_hs_secret, rec,
                                      rec512)

    def _dec(crypto, r):
        try:
            return crypto.decrypt(r, gcm_events, chacha_events)
        except ValueError as e:
            raise ReplayError(f"1.3 record decryption failed: {e}") from e

    # --- server encrypted handshake flight ---
    decrypted: list[DecryptedRecord] = []
    hs_buf = b""
    ee = cert_msg = cert_verify = server_fin = None
    chain = None
    record_iter = iter(
        [r for r in server_records if r.typ != ContentType.CHANGE_CIPHER_SPEC]
    )
    next(record_iter)  # the ServerHello record (possibly coalesced; handled)
    response_plain = bytearray()
    server_app_crypto = None
    got_server_finished = False
    app_transcript_hash = None

    for r in record_iter:
        if r.typ != ContentType.APPLICATION_DATA:
            raise ReplayError(f"unexpected 1.3 outer record type {r.typ}")
        plain = _dec(server_crypto if not got_server_finished
                     else server_app_crypto, r)
        inner_type, content = strip_inner_plaintext(plain)
        decrypted.append(DecryptedRecord(
            server_crypto.seq if not got_server_finished
            else server_app_crypto.seq, inner_type, content, True))
        if inner_type == ContentType.HANDSHAKE and not got_server_finished:
            hs_buf += content
            msgs, hs_buf = _drain_handshake(hs_buf)
            for m in msgs:
                if m.typ == HandshakeType.ENCRYPTED_EXTENSIONS:
                    ee = m
                elif m.typ == HandshakeType.CERTIFICATE:
                    cert_msg = m
                    chain = CertificateChain.parse13(m.body)
                elif m.typ == HandshakeType.CERTIFICATE_VERIFY:
                    # signature over the transcript through Certificate
                    scheme = int.from_bytes(m.body[0:2], "big")
                    sig_len = int.from_bytes(m.body[2:4], "big")
                    sig = m.body[4 : 4 + sig_len]
                    signed = (b" " * 64
                              + b"TLS 1.3, server CertificateVerify"
                              + b"\x00" + thash())
                    from .x509 import Certificate, hash_recording

                    try:
                        with hash_recording(rec, rec512):
                            ok = Certificate.parse(
                                chain.der_certs[0]
                            ).public_key_verify(scheme, signed, sig)
                    except Exception:
                        ok = False
                    checks["certificate_verify"] = bool(ok)
                    cert_verify = m
                elif m.typ == HandshakeType.FINISHED:
                    expect = sched.finished_verify(
                        sched.server_hs_secret, thash())
                    checks["server_finished"] = m.body == expect
                    server_fin = m
                    transcript.append(m.raw)
                    # application secrets derive from transcript incl. SFin
                    app_transcript_hash = thash()
                    sched.application_traffic(app_transcript_hash)
                    server_app_crypto = Tls13RecordCrypto(
                        suite, sched.server_app_secret, rec, rec512)
                    got_server_finished = True
                    break
                transcript.append(m.raw)
        elif inner_type == ContentType.HANDSHAKE:
            # post-handshake messages (NewSessionTicket, KeyUpdate unsupported)
            for m in iter_handshake_messages(content):
                if m.typ != HandshakeType.NEW_SESSION_TICKET:
                    raise ReplayError(
                        f"unsupported post-handshake message {m.typ}")
        elif inner_type == ContentType.APPLICATION_DATA:
            response_plain += content
        elif inner_type == ContentType.ALERT:
            break
    if ee is None or cert_msg is None or cert_verify is None or \
            server_fin is None:
        raise ReplayError("incomplete 1.3 server flight")

    # --- client Finished ---
    cfin_records = [r for r in client_records[1:]
                    if r.typ == ContentType.APPLICATION_DATA]
    if not cfin_records:
        raise ReplayError("client Finished missing")
    plain = _dec(client_crypto, cfin_records[0])
    inner_type, content = strip_inner_plaintext(plain)
    if inner_type != ContentType.HANDSHAKE:
        raise ReplayError("first client 1.3 record is not handshake")
    cfin = iter_handshake_messages(content)[0]
    expect = sched.finished_verify(sched.client_hs_secret, thash())
    checks["client_finished"] = cfin.body == expect
    decrypted.append(DecryptedRecord(0, inner_type, content, False))

    # --- client application data ---
    client_app_crypto = Tls13RecordCrypto(
        suite, sched.client_app_secret, rec, rec512)
    request_plain = bytearray()
    for r in cfin_records[1:]:
        plain = _dec(client_app_crypto, r)
        inner_type, content = strip_inner_plaintext(plain)
        decrypted.append(DecryptedRecord(
            client_app_crypto.seq, inner_type, content, False))
        if inner_type == ContentType.APPLICATION_DATA:
            request_plain += content

    checks["response_matches_tape"] = bytes(response_plain) == response.response
    for i, (b, ln, content) in enumerate(zip(
        response.filtered_responses_begin,
        response.filtered_responses_length,
        response.filtered_responses,
    )):
        checks[f"filtered_response_{i}"] = (
            bytes(response_plain[b : b + ln]) == content
        )

    return ReplayResult(
        version=0x0304,
        cipher_suite=suite,
        curve_name="x25519",
        client_random=ch.client_random,
        server_random=sh.server_random,
        premaster_secret=shared,
        master_secret=sched.master_secret,
        session_hash=app_transcript_hash or b"",
        client_write_key=client_app_crypto.key,
        server_write_key=(server_app_crypto.key
                          if server_app_crypto else b""),
        client_iv=client_app_crypto.iv,
        server_iv=server_app_crypto.iv if server_app_crypto else b"",
        client_finished_ok=checks.get("client_finished", False),
        server_finished_ok=checks.get("server_finished", False),
        skx_signature_ok=checks.get("certificate_verify"),
        certificate_chain=chain.der_certs,
        request_plaintext=bytes(request_plain),
        response_plaintext=bytes(response_plain),
        records=decrypted,
        handshake_transcript=transcript,
        sha256_recorder=rec,
        gcm_events=gcm_events,
        chacha_events=chacha_events,
        sha512_recorder=rec512,
        checks=checks,
    )


def _drain_handshake(buf: bytes):
    """Split complete handshake messages off the front of buf."""
    msgs = []
    pos = 0
    while pos + 4 <= len(buf):
        ln = int.from_bytes(buf[pos + 1 : pos + 4], "big")
        if pos + 4 + ln > len(buf):
            break
        raw = buf[pos : pos + 4 + ln]
        msgs.append(HandshakeMessage(buf[pos], raw[4:], raw))
        pos += 4 + ln
    return msgs, buf[pos:]
