"""On the card: the control and the faults that `correct` must catch in the
cell `1302_price512`.

    python3 -m pytest benchmark/tests/test_bench_card_1302.py -q -s -m card

As `test_bench_card.py` does for the other cells, each case drives
`run.measure` at the cell's own sizes with the prover the window drives
replaced: the control proves at 35 FRI queries for the stated 36 (three
seeds); the `stale` fault returns the previous prove's answer, the
`proof` fault alters one byte of each proof; and a proof leaves Sha512Air
out, so no SHA-384 compression of the session is proved.

Every case must read `correct` false.  For the proof without Sha512Air
each check's count is printed: whether the frozen verifier alone
(`rejected`) catches it, or only `wrong_chips` does.
"""

import pytest
from test_bench_card import (
    CONTROL_SEEDS,
    _Altered,
    _Dropped,
    _measure,
    _program,
    _Stale,
)

pytestmark = pytest.mark.card

CELL = "1302_price512"


def test_control_fewer_queries_is_not_correct(card):
    from dataclasses import replace

    def control(config):
        prover = _program(config)
        prover.config = replace(prover.config,
                                num_queries=prover.config.num_queries - 1)
        return prover

    for seed in CONTROL_SEEDS:
        res = _measure(CELL, seed, control)
        assert not res["correct"]
        assert res["checks"]["rejected"]["value"] == res["attempted"] >= 1


@pytest.mark.parametrize("fault", ["stale", "proof"])
def test_fault_is_not_correct(card, fault):
    factory = (_Stale if fault == "stale"
               else lambda config: _Altered(config, fault))
    res = _measure(CELL, 2**31 + 404, factory, seconds=1)
    assert not res["correct"]
    key = {"stale": "journal_mismatch", "proof": "rejected"}[fault]
    assert res["checks"][key]["value"] >= 1


def test_a_proof_without_sha512air_is_not_correct(card):
    res = _measure(CELL, 2**31 + 505,
                   lambda config: _Dropped(config, "Sha512Air"), seconds=1)
    assert not res["correct"]
    assert res["checks"]["wrong_chips"]["value"] == res["attempted"] >= 1
