"""The reference that decides `correct`, on the CPU: the frozen verifier
accepts a real proof of the port (the committed 0x1303 session's, made by
the port on the CPU, SHA-256 45f02303…) and rejects it altered, bound to
an altered journal, or judged under a weaker configuration than the one
stated; a proof with other chips than the configuration states is
counted; the judge counts each fault of a run."""

import hashlib
from pathlib import Path

import pytest

import reference
import traffic

DATA = Path(__file__).resolve().parent / "data"
CONFIG = traffic.load_json("configs", "tls13_x25519_chacha20")


@pytest.fixture(scope="module")
def session():
    gi = (DATA / "session_1303.guest_input.cbor").read_bytes()
    proof = (DATA / "session_1303.proof").read_bytes()
    assert hashlib.sha256(proof).hexdigest().startswith("45f02303")
    return reference.replay_journal(gi), proof


def test_frozen_verifier_accepts_the_ports_proof(session):
    journal, proof = session
    assert reference.verify(journal, proof, CONFIG) == (None, None)


def test_frozen_verifier_rejects_an_altered_proof(session):
    journal, proof = session
    bad = bytearray(proof)
    bad[len(bad) // 2] ^= 1
    assert reference.verify(journal, bytes(bad), CONFIG)[1] is not None


def test_frozen_verifier_rejects_an_altered_journal(session):
    journal, proof = session
    bad = bytearray(journal)
    bad[-1] ^= 1
    assert reference.verify(bytes(bad), proof, CONFIG)[1] is not None


def test_a_proof_under_fewer_queries_is_rejected(session):
    """The control's mechanism: a proof with another query count than the
    configuration states fails the stated configuration."""
    journal, proof = session
    weaker = dict(CONFIG, stark=dict(CONFIG["stark"], num_queries=18))
    assert reference.verify(journal, proof, weaker)[1] is not None


@pytest.mark.parametrize("chips", [
    [c for c in CONFIG["chips"] if c != "ModMulRsa2048Air"],
    CONFIG["chips"] + ["EcScheduleAir"]])
def test_a_proof_with_other_chips_than_stated_is_counted(session, chips):
    """The proof carries the configuration's chips; judged against a
    configuration that states one chip fewer or more, its chips differ,
    while the verifier, which takes the chips from the proof, accepts."""
    journal, proof = session
    other = dict(CONFIG, chips=chips)
    wrong, why = reference.verify(journal, proof, other)
    assert why is None
    assert wrong is not None


def test_judge_counts_each_fault():
    """A run whose answers are right but whose proofs are not, one missing,
    one stale and one with an altered answer."""
    mix = traffic.load_json("traffic", "price512")
    sessions = traffic.record(CONFIG, mix, 99, range(4))
    spki = traffic.leaf_spki_sha256(CONFIG)
    journals = [reference.replay_journal(gi) for gi, _ in sessions]
    assert all(reference.answer_diff(j, reference.expected_answer(
        s, CONFIG, spki)) == [] for j, (_, s) in zip(journals, sessions))
    altered = bytearray(journals[3])
    i = altered.index(sessions[3][1].filtered)
    altered[i] ^= 1
    results = [None, (journals[0], b"x"), (journals[2], b"x"),
               (bytes(altered), b"x")]
    counts = reference.judge(CONFIG, sessions, results, spki, workers=2)
    assert counts == {"missing": 1, "journal_mismatch": 2,
                      "answer_mismatch": 2, "rejected": 3,
                      "wrong_chips": 3, "faulty": 4}
