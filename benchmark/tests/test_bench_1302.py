"""The `tls13_x25519_aes256gcm` configuration and its cell `1302_price512`
on the CPU: the manifest stays within its rules with them; the readers of
the two SHA-384/AES-256 chips' spans give host seconds per traced prove
and nothing where no such span opened; an answer of the reference's size
builds the same chip heights as price512's in this configuration."""

import pytest

import manifest
import traffic
from devtrace import Trace
from run import Context
from test_bench_traffic import _shapes

S = 1_000_000_000   # ns
NEW = ["aes256_sha512_build_s", "aes256_sha512_perm_trace_s",
       "aes256_sha512_vm_s"]


def test_manifest_with_the_cell_has_no_problems():
    bench = manifest.load()
    assert manifest.problems(bench) == []
    cell = manifest.cell(bench, "1302_price512")
    assert (cell["config"], cell["traffic"], cell["chips"]) == \
        ("tls13_x25519_aes256gcm", "price512", 1)
    layer = {m["name"]: m for m in manifest.metrics_of(
        bench, "1302_price512", "per_layer")}
    assert len(layer) == 13
    for name in NEW:
        assert layer[name]["source"] == "program_span"
        assert layer[name]["moves"] == "prove_s"
        assert layer[name]["workloads"] == ["1302_price512"]


def _prove(t0: int) -> list:
    """One prove's host ranges from t0: the two chips' build, perm-trace
    and VM spans (0.5 + 0.25, 0.125 + 0.0625, 1.0 + 0.5 s) beside the other
    chips' and torch operators."""
    return [
        (t0, t0 + S, "zktls.stage:build_chip_instances"),
        (t0, t0 + S // 10, "zktls.build:Sha256Air"),
        (t0 + S // 10, t0 + 6 * S // 10, "zktls.build:Sha512Air"),
        (t0 + 6 * S // 10, t0 + 17 * S // 20, "zktls.build:Aes256Air"),
        (t0 + 6 * S // 10, t0 + 7 * S // 10, "aten::copy_"),
        (t0 + 17 * S // 20, t0 + S, "zktls.build:Aes128Air"),
        (t0 + S, t0 + 2 * S, "zktls.stage:perm_commit"),
        (t0 + S, t0 + S + S // 8, "zktls.perm_trace:Sha512Air"),
        (t0 + 3 * S // 2, t0 + 3 * S // 2 + S // 16,
         "zktls.perm_trace:Aes256Air"),
        (t0 + 7 * S // 4, t0 + 2 * S, "zktls.perm_trace:GhashAir"),
        (t0 + 2 * S, t0 + 4 * S, "zktls.stage:quotient"),
        (t0 + 2 * S, t0 + 3 * S, "zktls.constraint_vm:Sha512Air"),
        (t0 + 3 * S, t0 + 7 * S // 2, "zktls.constraint_vm:Aes256Air"),
        (t0 + 7 * S // 2, t0 + 4 * S, "zktls.constraint_vm:Sha256Air"),
    ]


def _ctx(host: list, proves: int) -> Context:
    trace = Trace(host=host, proves=[(i * 10 * S, i * 10 * S + 5 * S)
                                     for i in range(proves)])
    return Context(trace=trace, traced=proves, timings=[{}] * proves)


@pytest.mark.parametrize("name, per_prove", zip(NEW, [0.75, 0.1875, 1.5]))
def test_readers_give_the_two_chips_seconds_per_prove(name, per_prove):
    ctx = _ctx(_prove(0) + _prove(10 * S), 2)
    assert manifest.reader(name)(ctx) == pytest.approx(per_prove)


@pytest.mark.parametrize("name", NEW)
def test_readers_find_nothing_without_the_two_chips_spans(name):
    others = [(s, e, n) for s, e, n in _prove(0)
              if "Sha512Air" not in n and "Aes256Air" not in n]
    assert manifest.reader(name)(_ctx(others, 1)) is None
    assert manifest.reader(name)(_ctx([(0, S, "aten::add")], 1)) is None
    assert manifest.reader(name)(_ctx(_prove(0), 0)) is None


def test_an_answer_of_the_references_size_has_price512s_shapes():
    """The reference's ~445-byte answer (a 374-byte body) and price512's
    512-byte body build every chip of this configuration at one height."""
    cfg = traffic.load_json("configs", "tls13_x25519_aes256gcm")
    mix = traffic.load_json("traffic", "price512")
    (gi, sent), = traffic.record(cfg, dict(mix, body_bytes=374), 12345, [1])
    assert len(sent.response) == 446
    (gi512, _), = traffic.record(cfg, mix, 12345, [1])
    shapes = _shapes(gi)
    assert shapes == _shapes(gi512)
    assert [name for name, _, _ in shapes] == cfg["chips"]
