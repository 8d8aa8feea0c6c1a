"""On the card: the control and the faults that `correct` must catch.

    python3 -m pytest benchmark/tests/test_bench_card.py -q -s -m card

Each case drives `run.measure` (the whole run but the look for a card)
at the cell's own sizes, with the prover the window drives replaced:

* the control: the program proving at one FRI query fewer than the
  configuration states (35 for 36), judged under the stated
  configuration, on three seeds;
* the faults: a prove that returns the previous prove's answer unchanged
  (its state not advanced), an answer altered where it is produced
  (one filtered byte of the journal, or one byte of the proof), and a
  proof that leaves one chip of the configuration out (the EC ladder of
  TLS 1.2, the RSA check of TLS 1.3).

Every case must read `correct` false; each prints its readings.
"""

import json
from dataclasses import replace

import pytest

pytestmark = pytest.mark.card

CELLS = ["c02f_price512", "1303_price512"]
CONTROL_SEEDS = [2**31 + 101, 2**31 + 202, 2**31 + 303]


def _measure(cell, seed, factory, seconds=None):
    import manifest
    import run

    seconds = seconds or manifest.load()["run_seconds"]
    res = run.measure(cell, seed, seconds, False, lambda msg: None,
                      prover_factory=factory)
    print(json.dumps({"cell": cell, "seed": seed,
                      "correct": res["correct"],
                      "attempted": res["attempted"],
                      "checks": res["checks"]}))
    return res


def _program(config):
    from zktls_tpu_torch.provers.stark import StarkGuestProver
    from zktls_tpu_torch.stark.config import StarkConfig

    return StarkGuestProver(config=StarkConfig(**config["stark"]),
                            device="cuda")


@pytest.mark.parametrize("cell", CELLS)
def test_control_fewer_queries_is_not_correct(card, cell):
    def control(config):
        prover = _program(config)
        prover.config = replace(prover.config,
                                num_queries=prover.config.num_queries - 1)
        return prover

    for seed in CONTROL_SEEDS:
        res = _measure(cell, seed, control)
        assert not res["correct"]
        assert res["checks"]["rejected"]["value"] == res["attempted"] >= 1


class _Stale:
    """Returns the previous prove's answer: the state never advances."""

    def __init__(self, config):
        self.prover, self.last = _program(config), None

    def prove(self, gi, timings=None):
        if self.last is None:
            self.last = self.prover.prove(gi, timings=timings)
        return self.last


class _Altered:
    """Alters one byte of each answer where it is produced."""

    def __init__(self, config, what):
        self.prover, self.what = _program(config), what

    def prove(self, gi, timings=None):
        journal, proof = self.prover.prove(gi, timings=timings)
        if self.what == "filtered":
            j = bytearray(journal)
            at = j.index(gi.response.filtered_responses[0])
            j[at] ^= 1
            return bytes(j), proof
        p = bytearray(proof)
        p[len(p) // 3] ^= 1
        return journal, bytes(p)


@pytest.mark.parametrize("fault", ["stale", "filtered", "proof"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(card, cell, fault):
    factory = (_Stale if fault == "stale"
               else lambda config: _Altered(config, fault))
    res = _measure(cell, 2**31 + 404, factory, seconds=1)
    assert not res["correct"]
    key = {"stale": "journal_mismatch", "filtered": "answer_mismatch",
           "proof": "rejected"}[fault]
    assert res["checks"][key]["value"] >= 1


class _Dropped:
    """Leaves one chip out of every proof: the maths it proves is never
    proved."""

    def __init__(self, config, chip):
        self.prover, self.chip = _program(config), chip

    def prove(self, gi, timings=None):
        from unittest import mock

        import zktls_tpu_torch.provers.stark as stark

        build = stark.build_chip_instances

        def without(out):
            return [c for c in build(out) if c.air.name != self.chip]

        with mock.patch.object(stark, "build_chip_instances", without):
            return self.prover.prove(gi, timings=timings)


@pytest.mark.parametrize("cell,chip", [("c02f_price512", "EcScheduleAir"),
                                       ("1303_price512", "ModMulRsa2048Air")])
def test_a_proof_without_a_stated_chip_is_not_correct(card, cell, chip):
    res = _measure(cell, 2**31 + 505,
                   lambda config: _Dropped(config, chip), seconds=1)
    assert not res["correct"]
    assert res["checks"]["wrong_chips"]["value"] == res["attempted"] >= 1
