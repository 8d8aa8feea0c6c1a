"""The readers of the program's spans (`perm_trace_s`, `constraint_vm_s`,
`encode_proof_s`) on a synthetic trace of two proves whose `zktls.` host
spans nest inside stage spans, and on a program that opens none."""

import pytest

import manifest
from devtrace import Trace
from run import Context

S = 1_000_000_000   # ns


def _prove(t0: int) -> list:
    """One prove's host ranges from t0: stage spans with chip spans and
    torch operators inside; perm traces 0.5 + 0.25 s, the VM 1.0 + 0.5 s,
    the encoding 0.125 s."""
    return [
        (t0, t0 + 2 * S, "zktls.stage:perm_commit"),
        (t0 + S // 10, t0 + 6 * S // 10, "zktls.perm_trace:Sha256Air"),
        (t0 + S // 5, t0 + S // 4, "aten::copy_"),
        (t0 + S, t0 + 5 * S // 4, "zktls.perm_trace:GhashAir"),
        (t0 + 2 * S, t0 + 4 * S, "zktls.stage:quotient"),
        (t0 + 2 * S, t0 + 2 * S + S // 100, "zktls.lower_air:GhashAir"),
        (t0 + 2 * S, t0 + 3 * S, "zktls.constraint_vm:Sha256Air"),
        (t0 + 3 * S, t0 + 7 * S // 2, "zktls.constraint_vm:GhashAir"),
        (t0 + 4 * S, t0 + 4 * S + S // 8, "zktls.encode_proof"),
    ]


def _ctx(host: list, proves: int) -> Context:
    trace = Trace(host=host, proves=[(i * 10 * S, i * 10 * S + 5 * S)
                                     for i in range(proves)])
    return Context(trace=trace, traced=proves, timings=[{}] * proves)


@pytest.mark.parametrize("name, per_prove", [("perm_trace_s", 0.75),
                                             ("constraint_vm_s", 1.5),
                                             ("encode_proof_s", 0.125)])
def test_span_readers_give_seconds_per_prove(name, per_prove):
    ctx = _ctx(_prove(0) + _prove(10 * S), 2)
    assert manifest.reader(name)(ctx) == pytest.approx(per_prove)


@pytest.mark.parametrize("name", ["perm_trace_s", "constraint_vm_s",
                                  "encode_proof_s"])
def test_span_readers_find_nothing_in_a_program_without_spans(name):
    ctx = _ctx([(0, S, "aten::add"), (0, 5 * S, "python_fn")], 1)
    assert manifest.reader(name)(ctx) is None
    assert manifest.reader(name)(_ctx(_prove(0), 0)) is None


def test_manifest_with_the_span_metrics_has_no_problems():
    bench = manifest.load()
    names = {m["name"]: m for m in bench["per_layer"]}
    for name in ("perm_trace_s", "constraint_vm_s", "encode_proof_s"):
        assert names[name]["source"] == "program_span"
        assert names[name]["moves"] == "prove_s"
        assert names[name]["workloads"] == ["c02f_price512", "1303_price512"]
    assert manifest.problems(bench) == []
