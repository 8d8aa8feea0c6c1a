"""The plain reference that decides `correct`: what each proved session must
give, worked out without the program.

For every (journal, proof) the window produced, `judge` checks four
things, each counted over the judged sessions and each held to the limit 0:

* `journal_mismatch`: the journal differs from the one the frozen replay
  (`zkref.guest.program.run_guest`) gives for the same recorded session;
* `answer_mismatch`: the journal does not state what the benchmark's own
  server sent: the request's and the response's Keccak-256, the filtered
  range and bytes, the server name, the pinned time and the test
  certificate's SPKI hash;
* `rejected`: the frozen machine verifier (`zkref.stark.machine.
  verify_machine` with the chip set and bus messages the journal implies,
  as `StarkGuestProver.verify` derives them) rejects the proof under the
  configuration's stated StarkConfig;
* `wrong_chips`: the proof's chips are not the ones the configuration
  states (`chips` in `configs/<name>.json`): a proof that leaves out part
  of the session's maths (the EC ladder, the key schedule, the RSA check)
  while its bus stays balanced would pass the three checks above.

A session whose prove raised, or whose answer never came, counts as
`missing`.  Everything runs on the host (numpy, Python ints, the frozen
host Poseidon2 in C); nothing of the program is imported.
"""

from __future__ import annotations

import hashlib

#: the numbers compared and their limits (a count of sessions each)
LIMITS = {"missing": 0, "journal_mismatch": 0, "answer_mismatch": 0,
          "rejected": 0, "wrong_chips": 0}


def stark_config(config: dict):
    from zkref.stark.config import StarkConfig

    return StarkConfig(**config["stark"])


def _air_registry() -> dict:
    """Copy of provers/stark.py::_air_registry."""
    from zkref.stark.chips import AIRS

    return dict(AIRS)


def journal_airs(journal: bytes, proof) -> list:
    """Copy of provers/stark.py::journal_airs (one journal): the chips a
    proof of this journal must carry, the optional ModMul widths taken
    from the proof; unknown names reject."""
    from zkref.guest.journal import decode_journal
    from zkref.stark.chips.gcm_control import parse_gcm_records
    from zkref.stark.verifier import VerificationError

    registry = _air_registry()
    required = {"Sha256Air", "ModMul256Air"}
    need_aes = False
    j = decode_journal(journal)
    if j["gcm_records"]:
        recs = parse_gcm_records(j["gcm_records"])
        if any(r["cha"] for r in recs):
            required |= {"ChaCha20Air", "ChaChaControlAir",
                         "StreamParserAir", "ChaChaDataAir",
                         "XorTableAir", "KeccakAir"}
        if any(not r["cha"] for r in recs):
            required |= {"GhashAir", "GcmControlAir", "StreamParserAir",
                         "GcmDataAir", "XorTableAir", "KeccakAir"}
            need_aes = True
    names = {cp.name for cp in proof.chips}
    missing = required - names
    if need_aes and not ({"Aes128Air", "Aes256Air"} & names):
        missing |= {"Aes128Air|Aes256Air"}
    if missing:
        raise VerificationError(
            f"proof is missing required chips: {sorted(missing)}")
    airs = []
    for name in names:
        if name not in registry:
            raise VerificationError(f"unknown chip in proof: {name!r}")
        airs.append(registry[name]())
    return airs


def journal_public_messages(journal: bytes, obj: int = 1) -> list[tuple]:
    """Copy of provers/stark.py::journal_public_messages: the bus messages
    the verifier derives from a journal (the SHA results it receives, the
    record headers and filtered bytes it sends, the Keccak results it
    receives)."""
    from zkref.guest.journal import decode_journal
    from zkref.stark.bus import (
        BUS_FILTERED,
        BUS_GCM_RECORD,
        BUS_HASH_RESULT,
        BUS_SHA_RESULT,
        RESULT_TAG_JOURNAL,
        RESULT_TAG_STREAM,
        digest_limbs,
        u16_limbs,
    )
    from zkref.stark.chips.gcm_control import parse_gcm_records

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
        msgs.append((BUS_GCM_RECORD,
                     [rec["eid"]] + u16_limbs(rec["nonce"])
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
        msgs.append((BUS_HASH_RESULT,
                     [obj, 0] + u16_limbs(j["request_hash"]), -1))
        msgs.append((BUS_HASH_RESULT,
                     [obj, 1] + u16_limbs(j["response_hash"]), -1))
    return msgs


def chip_diff(mp, config: dict) -> str | None:
    """None when the parsed proof `mp` carries exactly the chips the
    configuration states, else how its chips differ."""
    names = sorted(cp.name for cp in mp.chips)
    want = sorted(config["chips"])
    if names == want:
        return None
    return (f"lacks {sorted(set(want) - set(names))}, adds "
            f"{sorted(set(names) - set(want))}, carries {names}")[:300]


def verify(journal: bytes, proof: bytes, config: dict):
    """(how the proof's chips differ from the configuration's, why the
    frozen verifier rejects the proof of this journal under the
    configuration's StarkConfig); each None where there is no fault."""
    from zkref.stark.machine import MachineProof, verify_machine
    from zkref.stark.verifier import VerificationError

    try:
        mp = MachineProof.from_bytes(proof)
    except (ValueError, KeyError, IndexError, TypeError) as e:
        why = f"unreadable: {type(e).__name__}: {e}"[:300]
        return why, why
    chips = chip_diff(mp, config)
    try:
        verify_machine(journal_airs(journal, mp), mp, binding=journal,
                       public_messages=journal_public_messages(journal),
                       config=stark_config(config))
    except (VerificationError, ValueError, KeyError, IndexError,
            TypeError) as e:
        return chips, f"{type(e).__name__}: {e}"[:300]
    return chips, None


def expected_answer(sent, config: dict, spki: bytes) -> dict:
    """The journal fields that the session's own bytes fix."""
    from zkref.guest.crypto.keccak import keccak256

    return {"request_hash": keccak256(sent.request),
            "response_hash": keccak256(sent.response),
            "server_name": "localhost",
            "time": config["recorded_at"],
            "root_spki_sha256": spki,
            "filtered_begins": [sent.filtered_begin],
            "filtered_lengths": [len(sent.filtered)],
            "filtered_contents": [sent.filtered]}


def answer_diff(journal: bytes, expected: dict) -> list[str]:
    """The fields in which a journal departs from `expected`."""
    from zkref.guest.journal import decode_journal

    try:
        j = decode_journal(journal)
    except (ValueError, IndexError, UnicodeDecodeError) as e:
        return [f"undecodable: {e}"]
    return [k for k, v in expected.items() if j.get(k) != v]


def replay_journal(gi_cbor: bytes) -> bytes:
    """The journal the frozen replay gives for a recorded session (the
    configuration's trust: the test certificate is its own anchor)."""
    from zkref.core.types import GuestInput
    from zkref.guest.program import run_guest

    return run_guest(GuestInput.from_cbor(gi_cbor),
                     require_trust_anchor=False).journal


def verify_all(pairs: list, config: dict, workers: int) -> list:
    """`verify` of every (journal, proof) of `pairs`, spread over
    `workers` spawned processes (each loads the frozen verifier anew).
    Builds the verifier's host Poseidon2 first, once: on a checkout's
    first run that compiles it, after the window and outside set-up."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from zkref.utils import native

    if not pairs:
        return []
    native.build()
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=min(workers, len(pairs)),
                             mp_context=ctx) as pool:
        futures = [pool.submit(verify, j, p, config) for j, p in pairs]
        return [f.result() for f in futures]


def judge(config: dict, sessions: list, results: list, spki: bytes,
          log=None, workers: int = 6) -> dict:
    """Count the faults of `results` ([(journal, proof) or None], one per
    session of `sessions`, [(GuestInput CBOR, Sent)]), and under `faulty`
    the sessions with any.  log: called with a line for every fault
    found; workers: the verifier's processes."""
    log = log or (lambda msg: None)
    counts = dict.fromkeys(LIMITS, 0)
    bad: set[int] = set()
    done = [(i, r) for i, r in enumerate(results) if r is not None]
    for i, r in enumerate(results):
        if r is None:
            counts["missing"] += 1
            bad.add(i)
    for i, (journal, _) in done:
        gi_cbor, sent = sessions[i]
        if journal != replay_journal(gi_cbor):
            counts["journal_mismatch"] += 1
            bad.add(i)
            log(f"session {i}: journal differs from the replay's")
        diff = answer_diff(journal, expected_answer(sent, config, spki))
        if diff:
            counts["answer_mismatch"] += 1
            bad.add(i)
            log(f"session {i}: journal departs in {diff}")
    for (i, _), (chips, why) in zip(done, verify_all(
            [r for _, r in done], config, workers)):
        if chips is not None:
            counts["wrong_chips"] += 1
            bad.add(i)
            log(f"session {i}: proof's chips differ: {chips}")
        if why is not None:
            counts["rejected"] += 1
            bad.add(i)
            log(f"session {i}: proof rejected: {why}")
    counts["faulty"] = len(bad)
    return counts


def poseidon2_work(proof: bytes, config: dict) -> dict:
    """peaks.poseidon2_work of a proof's chips: rows from the proof, widths
    from the frozen AIRs."""
    from peaks import poseidon2_work as work
    from zkref.stark.chips import AIRS
    from zkref.stark.machine import MachineProof

    chips = []
    for cp in MachineProof.from_bytes(proof).chips:
        air = AIRS[cp.name]()
        chips.append((1 << cp.log_n, air.width, air.perm_width,
                      getattr(air, "preprocessed_width", 0)))
    return work(chips, config["stark"])
