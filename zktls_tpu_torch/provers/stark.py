"""STARK prover adapter: generates chip traces from a guest witness and
proves them as ONE machine proof; verifies a proof against its journal.

Port copy of the machine half of zktls_tpu.provers.stark (same names and
values).  `StarkGuestProver.prove` runs the port's guest replay
(`guest.program.run_guest`), `build_chip_instances` and `prove_machine` on
the CUDA card (or on the device the caller names).  Every suite the
reference proves has its chips: AES-128/256-GCM with SHA-256 or SHA-384,
and ChaCha20-Poly1305, over TLS 1.2 and TLS 1.3.

The compress rung (`compress` / `verify_compressed`): the session proof
verified inside a recursion proof (stark/recursion.py), its outer machine
proved on the prover's device.

The wrap (`wrap` / `verify_wrapped`): compress, then shrink (the
BN254/MiMC recursion layer, stark/machine_bn.py) on the prover's device,
then the STARK-verifier circuit (snark/stark_wrap.py) and Groth16 on the
host, as in the reference.  The reference's pure-Python R1CS and Groth16
cannot finish this for any recursion chain (the circuit over even the
tiny chain's shrink proof outgrows the host's memory), so the chain's
Groth16 is wired and tested, not run, at full size.

Batches (`prove_batch` / `verify_batch`): several sessions' witnesses
merged into one chip workload (`merge_guest_outputs`) and proved as ONE
machine proof bound to the concatenated journals.  The merge is the
reference's, limits included: it never merges `chacha_events` and builds
the stream-binding inputs only for AES-GCM sessions, so a batch of
ChaCha20-Poly1305 sessions keeps the first session's ChaCha blocks, loses
its stream-binding chips and its bus does not balance — the reference
cannot prove such a batch either.

What `verify(journal, proof)` checks:
  * the proof transcript is bound to THIS journal (binding bytes);
  * the SHA-256 chip published the journal's own digest and the journal's
    stream_sha256 field as IV-rooted chained digests;
  * every journal GCM record header (nonce, tag, n_blocks) is consumed by
    the control chip, whose key/H/mask/tag/counter wiring to the AES and
    GHASH chips is bus-enforced; every filtered response byte is matched
    by the data chip against decrypted plaintext; the Keccak chip publishes
    the journal's request and response hashes;
  * every chip's AIR constraints and the global bus balance hold.
"""

from __future__ import annotations

import time

from ..core.types import GuestInput
from ..guest.program import GuestOutput, run_guest
from ..stark.config import DEFAULT_CONFIG, StarkConfig
from ..stark.machine import (
    CHUNKED_DEEP_BYTES,
    SPILL_BYTES,
    ChipInstance,
    MachineProof,
    _resolve_device,
    prove_machine,
    verify_machine,
)
from ..utils.spans import Stages, span

__all__ = ["StarkGuestProver", "build_chip_instances",
           "journal_public_messages", "journal_airs", "merge_guest_outputs",
           "batch_public_messages"]


def _filtered_multiplicities(journal: bytes, obj: int = 1) -> list[tuple]:
    """(obj, pos, count) multiplicities of the verifier's filtered-byte
    sends implied by a journal's filtered ranges."""
    from ..guest.journal import decode_journal

    j = decode_journal(journal)
    counts: dict[tuple, int] = {}
    for begin, length in zip(j["filtered_begins"], j["filtered_lengths"]):
        for k in range(length):
            key = (obj, begin + k)
            counts[key] = counts.get(key, 0) + 1
    return [(o, pos, cnt) for (o, pos), cnt in counts.items()]


def _derive_ks_sessions(out, obj: int = 1, ec_rid: int | None = 2,
                        sid_base: int = 0x1000) -> list:
    """Key-schedule witness for a session, when its suite is covered
    (TLS 1.2, AES-128-GCM → SHA-256 PRF).  The GCM control chip's header
    rows consume BUS_SESSION_KEY mandatorily for exactly these records,
    so eligibility here must match the chip's g_kr gate."""
    from ..stark.chips.ec import EC_CURVES
    from ..stark.chips.keyschedule import KsSession

    rep = out.replay
    suite = rep.cipher_suite
    if (rep.version != 0x0303 or getattr(suite, "aead", "") != "aes-gcm"
            or getattr(suite, "key_len", 0) != 16):
        return []
    n_client = sum(1 for m in (out.gcm_metas or [])
                   if getattr(m, "dir", "c") == "c")
    n_server = len(out.gcm_metas or []) - n_client
    kw = dict(n_client_records=n_client, n_server_records=n_server,
              obj=obj, sid_base=sid_base)
    ecd = getattr(rep, "ecdhe_weierstrass", None)
    if ecd is not None and ecd[0] in EC_CURVES and ec_rid is not None:
        curve, scalar, spoint = ecd
        pt = curve.mul(scalar, spoint)
        kw.update(ec_rid=ec_rid,
                  ec_nbits=(scalar % curve.n).bit_length(), ec_point=pt)
    # else: free-premaster intake (x25519 / P-384 — documented gap)
    return [KsSession(rep.premaster_secret, rep.master_secret,
                      b"extended master secret" + rep.session_hash,
                      b"key expansion" + rep.server_random
                      + rep.client_random, **kw)]


def _stream_chips(out, events, data_air, ks_xor_pairs: list,
                  le_pairs: int = 0) -> list[ChipInstance]:
    """The stream-binding chips of a session's records (AES-GCM or
    ChaCha20-Poly1305 `events`): the parser locates every record in the
    committed tape; the data chip (`data_air`) xors plaintext and matches
    the journal's filtered ranges; the xor table serves the nibble xors
    (the key schedule's too); the keccak chip publishes the journal's
    request/response hashes over the bus-bound application-stream
    bytes."""
    from ..stark.chips.gcm_data import gcm_data_trace
    from ..stark.chips.keccak import KeccakAir, keccak_trace
    from ..stark.chips.stream_parser import (
        StreamParserAir,
        parser_sessions_from_replay,
        parser_trace,
    )
    from ..stark.chips.xor_table import (
        XorTableAir,
        xor_table_trace,
        xor_use_counts,
    )

    # a batch (merge_guest_outputs) presets the parser sessions, filtered
    # multiplicities and keccak streams of all its sessions
    sessions = getattr(out, "parser_sessions", None)
    if sessions is None:
        sessions = [parser_sessions_from_replay(out.stream, events, out.v13,
                                                obj=1)]
    with span("zktls.build:StreamParserAir"):
        ptrace, _ = parser_trace(sessions)
    filtered = getattr(out, "filtered_mults", None)
    if filtered is None:
        filtered = _filtered_multiplicities(out.journal, obj=1)
    with span(f"zktls.build:{data_air.name}"):
        dtrace, _, xor_pairs = gcm_data_trace(
            out.gcm_metas, events, filtered=filtered, le_pairs=le_pairs)
    with span("zktls.build:XorTableAir"):
        xtrace, _ = xor_table_trace(
            xor_use_counts(list(xor_pairs) + ks_xor_pairs))
    streams = getattr(out, "keccak_streams", None)
    if streams is None:
        streams = [(1, 0, out.replay.request_plaintext),
                   (1, 1, out.replay.response_plaintext)]
    with span("zktls.build:KeccakAir"):
        ktrace, _ = keccak_trace(streams)
    return [ChipInstance(air=StreamParserAir(), trace=ptrace, publics=[]),
            ChipInstance(air=data_air, trace=dtrace, publics=[]),
            ChipInstance(air=XorTableAir(), trace=xtrace, publics=[]),
            ChipInstance(air=KeccakAir(), trace=ktrace, publics=[])]


def build_chip_instances(out) -> list[ChipInstance]:
    """The machine chip set for a guest execution: one session's
    GuestOutput, or a batch's from `merge_guest_outputs` (which presets
    the key-schedule sessions, EC jobs and stream-binding inputs of all
    its sessions)."""
    from ..models.aes128_chip import aes_instances
    from ..models.ghash_chip import gcm_control_instance, ghash_instance
    from ..models.modmul_chip import modmul_instances
    from ..models.sha256_chip import sha256_instance
    from ..stark.chips.chacha import (
        ChaCha20Air,
        chacha_event_blocks,
        chacha_trace,
    )
    from ..stark.chips.chacha_control import (
        ChaChaControlAir,
        chacha_control_trace,
    )
    from ..stark.chips.ec import (
        EC_CURVES,
        EcScheduleAir,
        LadderJob,
        ec_schedule_trace,
    )
    from ..stark.chips.gcm_data import ChaChaDataAir, GcmDataAir
    from ..stark.chips.keyschedule import KeyScheduleAir, keyschedule_trace
    from ..stark.chips.sha512 import Sha512Air, sha512_trace

    # key-schedule witness first: its SHA-hop and xor-table consumption
    # feeds the other chips' multiplicities
    ks_sessions = getattr(out, "ks_sessions", None)
    if ks_sessions is None:
        ks_sessions = _derive_ks_sessions(out)
    ks_trace = None
    hop_counts: dict = {}
    ks_xor_pairs: list = []
    if ks_sessions:
        with span("zktls.build:KeyScheduleAir"):
            ks_trace, hop_counts, ks_xor_pairs = keyschedule_trace(
                ks_sessions)

    with span("zktls.build:Sha256Air"):
        chips = [sha256_instance(out.replay.sha256_recorder.events,
                                 hop_counts=hop_counts)]
    rec512 = getattr(out.replay, "sha512_recorder", None)
    if rec512 is not None and rec512.events:
        # SHA-384 suites: transcript/PRF/HKDF compressions on the SHA-512
        # chip (IV-rooted chains)
        with span("zktls.build:Sha512Air"):
            trace512, p512 = sha512_trace(rec512.events)
        chips.append(ChipInstance(air=Sha512Air(), trace=trace512,
                                  publics=p512))
    if out.replay.gcm_events:
        events = out.replay.gcm_events
        chips.extend(aes_instances(events))
        with span("zktls.build:GhashAir"):
            chips.append(ghash_instance(events))
        with span("zktls.build:GcmControlAir"):
            chips.append(gcm_control_instance(events, metas=out.gcm_metas,
                                              v13=out.v13))
        chips.extend(_stream_chips(out, events, GcmDataAir(), ks_xor_pairs))
    chacha_events = getattr(out.replay, "chacha_events", None)
    cc_sends: dict = {}
    if chacha_events:
        # ChaCha suites: every keystream block (the Poly1305 one-time-key
        # block included) proven by the ChaCha20 chip.  With record
        # metadata the sessions get full record binding: the control chip
        # consumes the journal record headers, the parser locates every
        # record in the committed tape, the data chip xors plaintext, and
        # the Poly1305 tag chain (recorded mulmods over 2^130 − 5 on the
        # ModMul chip) is composed into the in-circuit tag check
        consumed: dict = {}
        if out.gcm_metas and not out.replay.gcm_events:
            with span("zktls.build:ChaChaControlAir"):
                ctl_trace, _, cc_sends, consumed = chacha_control_trace(
                    chacha_events, out.gcm_metas)
            chips.append(ChipInstance(air=ChaChaControlAir(),
                                      trace=ctl_trace, publics=[]))
            chips.extend(_stream_chips(out, chacha_events, ChaChaDataAir(),
                                       ks_xor_pairs, le_pairs=1))
        with span("zktls.build:ChaCha20Air"):
            ctrace, cpub = chacha_trace(chacha_event_blocks(chacha_events),
                                        consumed=consumed)
        chips.append(ChipInstance(air=ChaCha20Air(), trace=ctrace,
                                  publics=cpub))
    # EC schedule: the ECDHE d·G / d·S dual ladder proven over the
    # recorded mulmod statements (BUS_MODMUL sends from the ModMul chips
    # feed the ladder's receives); the d·G lane is generator-pinned
    # in-chip, and the d·S result is the key schedule's premaster
    ec_pairs = getattr(out, "ec_jobs", None)
    if ec_pairs is None:
        ecd = getattr(out.replay, "ecdhe_weierstrass", None)
        ec_pairs = [ecd] if ecd is not None else []
    ks_linked = {s.ec_rid for s in ks_sessions if s.ec_rid is not None}
    jobs = []
    for i, pair in enumerate(ec_pairs):
        curve, scalar, server_point = pair
        if curve not in EC_CURVES:
            continue  # P-384 ladder width class
        rid2 = 2 * i + 2
        jobs.append(LadderJob(curve, scalar, curve.g, server_point,
                              pb1=False, gb1=True,
                              rid1=2 * i + 1, rid2=rid2,
                              mres2=1 if rid2 in ks_linked else 0))
    sends: dict = {}
    if jobs:
        with span("zktls.build:EcScheduleAir"):
            etrace, sends = ec_schedule_trace(jobs)
        chips.append(ChipInstance(air=EcScheduleAir(), trace=etrace,
                                  publics=[]))
    # Poly1305 accumulator statements consumed by the ChaCha control chip
    for key, cnt in cc_sends.items():
        sends[key] = sends.get(key, 0) + cnt
    if ks_trace is not None:
        chips.append(ChipInstance(air=KeyScheduleAir(), trace=ks_trace,
                                  publics=[]))
    if out.modmul_events:
        with span("zktls.build:ModMulAir"):
            chips.extend(modmul_instances(out.modmul_events, sends=sends))
    return chips


def _air_registry() -> dict:
    """Zero-argument AIR constructor by chip name: the ported chips only,
    so a proof naming any other chip is rejected as unknown."""
    from ..stark.chips import AIRS

    return dict(AIRS)


def journal_airs(journal: bytes | list[bytes], proof: MachineProof) -> list:
    """The chip set to verify a proof of this journal (or, for batches,
    list of journals) against.  EVERY journal pins REQUIRED chips (SHA-256
    and the 256-bit ModMul always — every session derives keys, hashes its
    journal, and recovers the origin signer; the GCM triangle whenever the
    journal carries record headers); a batch's requirement is the union.
    The optional wider ModMul widths are taken from the proof itself —
    extra valid chips never weaken the statement, unknown names reject."""
    from ..guest.journal import decode_journal
    from ..stark.chips.gcm_control import parse_gcm_records
    from ..stark.verifier import VerificationError

    registry = _air_registry()
    journals = [journal] if isinstance(journal, (bytes, bytearray)) \
        else list(journal)

    required = {"Sha256Air", "ModMul256Air"}
    need_aes = False
    for jb in journals:
        j = decode_journal(jb)
        if j["gcm_records"]:
            recs = parse_gcm_records(j["gcm_records"])
            if any(r["cha"] for r in recs):
                required |= {"ChaCha20Air", "ChaChaControlAir",
                             "StreamParserAir", "ChaChaDataAir",
                             "XorTableAir", "KeccakAir"}
            if any(not r["cha"] for r in recs):
                required |= {"GhashAir", "GcmControlAir",
                             "StreamParserAir", "GcmDataAir",
                             "XorTableAir", "KeccakAir"}
                need_aes = True
    names = {cp.name for cp in proof.chips}
    missing = required - names
    if need_aes and not ({"Aes128Air", "Aes256Air"} & names):
        missing |= {"Aes128Air|Aes256Air"}
    if missing:
        raise VerificationError(f"proof is missing required chips: "
                                f"{sorted(missing)}")
    airs = []
    for name in names:
        if name not in registry:
            raise VerificationError(f"unknown chip in proof: {name!r}")
        airs.append(registry[name]())
    return airs


def journal_public_messages(journal: bytes, obj: int = 1,
                            eid_off: int = 0) -> list[tuple]:
    """The verifier-side bus messages implied by a journal: it RECEIVES
    (mult −1) the SHA-chip's published digests — recomputing the journal
    digest itself, reading stream_sha256 from the journal — and SENDS
    (mult +1) every GCM record header for the control chip to consume and
    every filtered-response byte for the GCM data chip to match against
    decrypted plaintext.  The stream digest's payload carries the chain's
    expose-blocks flag: GCM journals pin xb = 1, forcing the chain's
    message blocks onto the bus where only the stream-parser chip can
    consume them."""
    import hashlib

    from ..guest.journal import decode_journal
    from ..stark.bus import (
        BUS_FILTERED,
        BUS_GCM_RECORD,
        BUS_HASH_RESULT,
        BUS_SHA_RESULT,
        RESULT_TAG_JOURNAL,
        RESULT_TAG_STREAM,
        digest_limbs,
        u16_limbs,
    )
    from ..stark.chips.gcm_control import parse_gcm_records

    j = decode_journal(journal)
    has_gcm = bool(j["gcm_records"])
    msgs: list[tuple] = [
        (BUS_SHA_RESULT,
         [RESULT_TAG_JOURNAL]
         + digest_limbs(hashlib.sha256(journal).digest()) + [0], -1),
        (BUS_SHA_RESULT,
         [RESULT_TAG_STREAM] + digest_limbs(j["stream_sha256"])
         + [1 if has_gcm else 0], -1),
    ]
    for rec in parse_gcm_records(j["gcm_records"]):
        # the trailing cha field discriminates ChaCha20-Poly1305 records
        # (consumed by ChaChaControlAir) from AES-GCM ones (GcmControlAir,
        # whose fingerprint has no cha term ≡ cha = 0)
        msgs.append((BUS_GCM_RECORD,
                     [eid_off + rec["eid"]] + u16_limbs(rec["nonce"])
                     + u16_limbs(rec["tag"])
                     + [rec["n_blocks"], rec["ct_len"], rec["v13"],
                        rec["is_resp"], rec["cha"]], 1))
    if has_gcm:
        for begin, length, content in zip(
                j["filtered_begins"], j["filtered_lengths"],
                j["filtered_contents"]):
            for k in range(length):
                msgs.append((BUS_FILTERED,
                             [obj, 1, begin + k, content[k]], 1))
        # the keccak chip publishes the journal's request/response hashes
        # over the bus-bound application-stream bytes
        msgs.append((BUS_HASH_RESULT,
                     [obj, 0] + u16_limbs(j["request_hash"]), -1))
        msgs.append((BUS_HASH_RESULT,
                     [obj, 1] + u16_limbs(j["response_hash"]), -1))
    return msgs


def merge_guest_outputs(outs: list[GuestOutput]) -> GuestOutput:
    """Merge several sessions' witnesses into one chip workload (copy of
    the reference's): SHA hash-object ids get per-session offsets so
    chains stay disjoint, except the stream-tape chains, which take the
    session's object id i + 1 (the batch verifier's filtered and bus
    derivation); GCM events concatenate in session order (their event ids
    are the global enumeration, which `batch_public_messages` mirrors);
    ModMul events concatenate; each AES-GCM session contributes its parser
    session, record metas, filtered multiplicities and keccak streams.
    ChaCha events are not merged (the reference's limit, module
    docstring)."""
    import copy

    from ..guest.crypto.sha256 import SHA256Recorder
    from ..guest.crypto.sha512 import SHA512Recorder
    from ..stark.chips.ec import EC_CURVES
    from ..stark.chips.stream_parser import parser_sessions_from_replay

    if len(outs) == 1:
        return outs[0]
    merged = copy.copy(outs[0])
    merged.replay = copy.copy(outs[0].replay)
    sha_events = []
    sha512_events = []
    gcm_events = []
    modmul_events = []
    ec_jobs = []
    ks_sessions = []
    metas = []
    sessions = []
    filtered = []
    kstreams = []
    eid_off = 0
    for i, out in enumerate(outs):
        off = (i + 1) << 20
        for e in out.replay.sha256_recorder.events:
            e2 = copy.copy(e)
            e2.obj = (i + 1) if e.expose_block else e.obj + off
            sha_events.append(e2)
        if out.replay.gcm_events:
            sessions.append(parser_sessions_from_replay(
                out.stream, out.replay.gcm_events, out.v13, obj=i + 1,
                eid_off=eid_off))
            kstreams.append((i + 1, 0, out.replay.request_plaintext))
            kstreams.append((i + 1, 1, out.replay.response_plaintext))
            for m in out.gcm_metas:
                m2 = copy.copy(m)
                m2.eid = m.eid + eid_off
                m2.obj = i + 1
                metas.append(m2)
            filtered.extend(_filtered_multiplicities(out.journal,
                                                     obj=i + 1))
        r512 = getattr(out.replay, "sha512_recorder", None)
        if r512 is not None:
            for e in r512.events:
                e2 = copy.copy(e)
                e2.obj = e.obj + off
                sha512_events.append(e2)
        gcm_events.extend(out.replay.gcm_events)
        eid_off += len(out.replay.gcm_events)
        modmul_events.extend(out.modmul_events)
        ecd = getattr(out.replay, "ecdhe_weierstrass", None)
        ec_rid = None
        if ecd is not None:
            ec_jobs.append(ecd)
            if ecd[0] in EC_CURVES:
                ec_rid = 2 * (len(ec_jobs) - 1) + 2
        ks_sessions.extend(_derive_ks_sessions(
            out, obj=i + 1, ec_rid=ec_rid, sid_base=0x1000 + 0x20 * i))
    rec = SHA256Recorder()
    rec.events = sha_events
    merged.replay.sha256_recorder = rec
    if sha512_events:
        rec512 = SHA512Recorder()
        rec512.events = sha512_events
        merged.replay.sha512_recorder = rec512
    else:
        merged.replay.sha512_recorder = None
    merged.replay.gcm_events = gcm_events
    merged.modmul_events = modmul_events
    merged.ec_jobs = ec_jobs
    merged.ks_sessions = ks_sessions
    merged.gcm_metas = metas
    merged.parser_sessions = sessions
    merged.filtered_mults = filtered
    merged.keccak_streams = kstreams
    return merged


def batch_public_messages(journals: list[bytes]) -> list[tuple]:
    """Verifier-side bus messages for a session batch: per-journal SHA
    results, GCM record headers with event ids renumbered by the global
    session-order enumeration, and filtered bytes under the session's
    stream object id (i + 1)."""
    from ..guest.journal import decode_journal
    from ..stark.chips.gcm_control import GCM_RECORD_SIZE

    msgs: list[tuple] = []
    eid_off = 0
    for i, journal in enumerate(journals):
        msgs += journal_public_messages(journal, obj=i + 1,
                                        eid_off=eid_off)
        j = decode_journal(journal)
        eid_off += len(j["gcm_records"]) // GCM_RECORD_SIZE
    return msgs


def _vk_jsonable(vk: dict) -> dict:
    """Groth16 vk dict → cbor-safe (32-byte big-endian coordinates)."""
    def e1(p):
        return [int(p[0]).to_bytes(32, "big"),
                int(p[1]).to_bytes(32, "big")]

    def e2(p):
        return [e1(p[0]), e1(p[1])]

    return {"alpha1": e1(vk["alpha1"]), "beta2": e2(vk["beta2"]),
            "gamma2": e2(vk["gamma2"]), "delta2": e2(vk["delta2"]),
            "ic": [e1(p) for p in vk["ic"]]}


def _vk_unjsonable(obj: dict) -> dict:
    def d1(p):
        return (int.from_bytes(p[0], "big"), int.from_bytes(p[1], "big"))

    def d2(p):
        return (d1(p[0]), d1(p[1]))

    return {"alpha1": d1(obj["alpha1"]), "beta2": d2(obj["beta2"]),
            "gamma2": d2(obj["gamma2"]), "delta2": d2(obj["delta2"]),
            "ic": [d1(p) for p in obj["ic"]]}


class StarkGuestProver:
    """ZkProver proving the guest witness as one machine STARK proof.

    device: where `prove` runs the tensor work — the CUDA card by default
    (the constructor raises without one), "cpu" for the plain torch
    versions."""

    def __init__(self, config: StarkConfig = DEFAULT_CONFIG, device=None):
        self.config = config
        self.device = _resolve_device(device)

    def prove(self, guest_input: GuestInput,
              timings: dict | None = None) -> tuple[bytes, bytes]:
        """(journal, proof bytes).  timings: if given, receives the seconds
        of `run_guest` and `build_chip_instances` (host) besides
        prove_machine's stages."""
        with Stages(timings, "run_guest") as stages:
            out: GuestOutput = run_guest(guest_input)
            stages.next("build_chip_instances")
            chips = build_chip_instances(out)
        proof = prove_machine(chips, binding=out.journal,
                              config=self.config, device=self.device,
                              timings=timings)
        with span("zktls.encode_proof"):
            blob = proof.to_bytes()
        return out.journal, blob

    def verify(self, journal: bytes, proof: bytes) -> bool:
        """Raises stark.verifier.VerificationError on failure."""
        mp = MachineProof.from_bytes(proof)
        return verify_machine(
            journal_airs(journal, mp), mp, binding=journal,
            public_messages=journal_public_messages(journal),
            config=self.config)

    # -- recursion: the compress rung (stark/recursion.py) ----------------

    def compress(self, journal: bytes, proof: bytes,
                 outer_config: StarkConfig | None = None,
                 timings: dict | None = None,
                 spill_bytes: float = SPILL_BYTES,
                 chunked_deep_bytes: float = CHUNKED_DEEP_BYTES) -> bytes:
        """Wrap a machine proof in a recursion proof on the prover's
        device: the verifier-VM machine (VmAir + sponge chips, program in
        vk-committed preprocessed columns) verifies it in-circuit.
        Returns a self-describing blob {vk, proof}; verify with
        `verify_compressed(journal, blob)`.  timings, spill_bytes,
        chunked_deep_bytes: as `recursion_prove`'s."""
        from ..core import cbor
        from ..stark.recursion import recursion_prove

        mp = MachineProof.from_bytes(proof)
        vk, outer = recursion_prove(
            journal_airs(journal, mp), mp, journal,
            public_messages=journal_public_messages(journal),
            inner_config=self.config,
            outer_config=outer_config or self.config,
            timings=timings, device=self.device, spill_bytes=spill_bytes,
            chunked_deep_bytes=chunked_deep_bytes)
        return cbor.dumps({"vk": vk.to_bytes(),
                           "proof": outer.to_bytes()})

    def verify_compressed(self, journal: bytes, blob: bytes,
                          outer_config: StarkConfig | None = None,
                          cache_dir: str | None = None) -> bool:
        """Verify a compressed (recursion) proof.  The blob's vk is used
        only as a SHAPE carrier: the program root is re-derived locally
        (once per statement geometry, on the prover's device, then cached
        on disk under `cache_dir` — recursion.trusted_vk), so a forged
        program can never smuggle in its own root.  Verification is then
        O(outer proof)."""
        from ..core import cbor
        from ..stark.recursion import (
            RecursionVK,
            recursion_verify,
            trusted_vk,
        )
        from ..stark.verifier import VerificationError

        obj = cbor.loads(blob)
        shape = RecursionVK.from_bytes(obj["vk"]).shape
        # required-chip policy matches the direct path: the shape's chip
        # set must satisfy the journal's requirements
        names = {n for n, _l, _p in shape.chips}
        registry = _air_registry()
        unknown = names - set(registry)
        if unknown:
            raise VerificationError(f"unknown chips in shape: {unknown}")
        airs = [registry[n]() for n in names]

        class _P:
            chips = [type("C", (), {"name": n})() for n in names]

        journal_airs(journal, _P())   # raises if required chips missing
        msgs = journal_public_messages(journal)
        vk = trusted_vk(airs, shape, journal, msgs,
                        inner_config=self.config,
                        outer_config=outer_config or self.config,
                        cache_dir=cache_dir, device=self.device)
        return recursion_verify(
            airs, vk, MachineProof.from_bytes(obj["proof"]), journal,
            public_messages=msgs,
            inner_config=self.config,
            outer_config=outer_config or self.config)

    # -- the full wrap chain: compress → shrink → Groth16 ----------------

    def wrap(self, journal: bytes, proof: bytes,
             groth16_keys=None,
             shrink_config: StarkConfig | None = None,
             timings: dict | None = None,
             spill_bytes: float = SPILL_BYTES,
             chunked_deep_bytes: float = CHUNKED_DEEP_BYTES) -> bytes:
        """machine proof → compress (Poseidon2 recursion) → shrink
        (BN254/MiMC recursion) → Groth16 — the reference's
        core→compress→shrink→wrap pipeline.  The returned blob carries
        {vk_a, vk_b, groth16 proof, g16 vk}; the Groth16 circuit IS the
        shrink-layer verifier, so the seal exists only if a valid machine
        STARK stands behind the journal.  Compress and shrink run on the
        prover's device, the circuit and Groth16 on the host.

        groth16_keys: a Groth16Keys CRS for this statement shape (from a
        previous run); when None, setup runs inline.  timings: the
        reference's keys (compress_s, shrink_s, wrap_circuit_s,
        wrap_constraints, groth16_s — the last counted from the circuit's
        start, as the reference counts it) besides the recursion stages;
        spill_bytes, chunked_deep_bytes: the compress's, as `compress`."""
        from ..core import cbor
        from ..snark.groth16 import prove as g16_prove, setup as g16_setup
        from ..snark.stark_wrap import build_stark_wrap_circuit
        from ..stark.recursion import (
            _session_messages,
            outer_airs,
            recursion_prove,
            recursion_prove_bn,
        )

        mp = MachineProof.from_bytes(proof)
        airs = journal_airs(journal, mp)
        msgs = journal_public_messages(journal)
        t0 = time.perf_counter()
        vk_a, proof_a = recursion_prove(
            airs, mp, journal, public_messages=msgs,
            inner_config=self.config, timings=timings, device=self.device,
            spill_bytes=spill_bytes, chunked_deep_bytes=chunked_deep_bytes)
        if timings is not None:
            timings["compress_s"] = round(time.perf_counter() - t0, 2)
        a_binding = journal + vk_a.shape.to_bytes()
        a_msgs = _session_messages(vk_a.shape, journal, msgs)
        scfg = shrink_config or self.config
        t0 = time.perf_counter()
        vk_b, proof_b = recursion_prove_bn(
            outer_airs(), proof_a, a_binding, public_messages=a_msgs,
            inner_config=self.config, outer_config=scfg,
            inner_preprocessed_roots={
                "VmAir": list(vk_a.program_root)},
            timings=timings, device=self.device)
        if timings is not None:
            timings["shrink_s"] = round(time.perf_counter() - t0, 2)
        b_msgs = _session_messages(
            vk_b.shape, a_binding, a_msgs,
            dict((n, list(r)) for n, r in vk_b.inner_preprocessed_roots))
        b_binding = a_binding + vk_b.shape.to_bytes()
        t0 = time.perf_counter()
        cs = build_stark_wrap_circuit(
            outer_airs(), proof_b, b_binding, b_msgs, scfg,
            {"VmAir": vk_b.program_root})
        if timings is not None:
            timings["wrap_circuit_s"] = round(time.perf_counter() - t0, 2)
            timings["wrap_constraints"] = len(cs.constraints)
        if groth16_keys is None:
            groth16_keys = g16_setup(cs, seed=b"zktls-stark-wrap-v1")
        g16 = g16_prove(groth16_keys, cs)
        if timings is not None:
            timings["groth16_s"] = round(time.perf_counter() - t0, 2)
        return cbor.dumps({
            "vk_a": vk_a.to_bytes(), "vk_b": vk_b.to_bytes(),
            "g16": g16.to_bytes(),
            "g16_vk": cbor.dumps(_vk_jsonable(groth16_keys.vk())),
        })

    def verify_wrapped(self, journal: bytes, blob: bytes) -> bool:
        """Verify the Groth16 seal: recompute the statement digest from
        (journal, chain vks) and run the pairing check.  The Groth16 vk
        identifies the circuit — and the circuit embeds the shrink-layer
        program root, which transitively pins the compress program and
        the zkTLS machine behind it.  The caller must trust the Groth16
        vk for this statement shape (the standard SNARK trust model)."""
        from ..core import cbor
        from ..snark.groth16 import Groth16Proof, verify as g16_verify
        from ..snark.stark_wrap import statement_digest_fr
        from ..stark.recursion import (
            RecursionVK,
            RecursionVKBN,
            _session_messages,
        )

        obj = cbor.loads(blob)
        vk_a = RecursionVK.from_bytes(obj["vk_a"])
        vk_b = RecursionVKBN.from_bytes(obj["vk_b"])
        msgs = journal_public_messages(journal)
        a_binding = journal + vk_a.shape.to_bytes()
        a_msgs = _session_messages(vk_a.shape, journal, msgs)
        b_msgs = _session_messages(
            vk_b.shape, a_binding, a_msgs,
            dict((n, list(r)) for n, r in vk_b.inner_preprocessed_roots))
        b_binding = a_binding + vk_b.shape.to_bytes()
        stmt = statement_digest_fr(b_binding, b_msgs,
                                   {"VmAir": vk_b.program_root})
        g16_vk = _vk_unjsonable(cbor.loads(obj["g16_vk"]))
        return g16_verify(g16_vk, [stmt],
                          Groth16Proof.from_bytes(obj["g16"]))

    # -- multi-session batching ------------------------------------------

    def prove_batch(self, guest_inputs: list[GuestInput],
                    timings: dict | None = None
                    ) -> tuple[list[bytes], bytes]:
        """Prove several sessions as ONE machine proof on the prover's
        device.  Returns (journals, proof); the proof binds the
        concatenation of all journals.  timings: if given, receives the
        seconds of `run_guest` (all sessions) and `build_chip_instances`
        (the merge included) besides prove_machine's stages."""
        with Stages(timings, "run_guest") as stages:
            outs = [run_guest(gi) for gi in guest_inputs]
            stages.next("build_chip_instances")
            chips = build_chip_instances(merge_guest_outputs(outs))
        binding = b"".join(out.journal for out in outs)
        proof = prove_machine(chips, binding=binding, config=self.config,
                              device=self.device, timings=timings)
        with span("zktls.encode_proof"):
            blob = proof.to_bytes()
        return [out.journal for out in outs], blob

    def verify_batch(self, journals: list[bytes], proof: bytes) -> bool:
        """Raises stark.verifier.VerificationError on failure."""
        mp = MachineProof.from_bytes(proof)
        return verify_machine(
            journal_airs(journals, mp), mp,
            binding=b"".join(journals),
            public_messages=batch_public_messages(journals),
            config=self.config)
