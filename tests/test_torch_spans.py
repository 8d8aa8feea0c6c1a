"""The port's profiler spans (utils/spans.py) and its stage clock, on the
CPU: a small machine prove under `torch.profiler` opens its stage spans in
`STAGES` order, one after another, each as long as its `timings` entry,
with the perm-trace and constraint-VM spans inside their stages; a warm
prove lowers no AIR again; `StarkGuestProver.prove` opens the replay,
build and encode spans; the AES builder's span names the chip it builds
(c02f, 0x1302, and both in one batch); the other provers keep their
`timings` keys; the prover service logs each request and runs one prove
at a time.  No span is a user-scope range, so none has a copy on a
device's timeline."""

import http.client
import logging
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from zktls_tpu_torch.core.types import GuestInput
from zktls_tpu_torch.guest import roots
from zktls_tpu_torch.guest.program import run_guest
from zktls_tpu_torch.provers import service
from zktls_tpu_torch.provers import stark as tstark
from zktls_tpu_torch.stark import lowering, recursion
from zktls_tpu_torch.stark import machine_bn
from zktls_tpu_torch.stark.config import StarkConfig
from zktls_tpu_torch.stark.machine import STAGES, ChipInstance, prove_machine
from zktls_tpu_torch.stark.prover import prove
from zktls_tpu_torch.utils.spans import Stages, span
from zktls_tpu_torch.workload import SESSIONS, SINGLES, single_air

from .torch_threads import torch_threads_per_worker  # noqa: F401

CFG = StarkConfig(**SINGLES["bytes"][0])


def _spans(prof) -> list[tuple[int, int, str]]:
    """The profile's `zktls.` ranges, (start, end, name) in ns, by start."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("zktls."):
            assert e.device_type() == torch.autograd.DeviceType.CPU
            out.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                        e.name()))
    return sorted(out)


def _nest_strictly(spans) -> bool:
    return all(b[1] <= a[0] or a[1] <= b[0]
               or (a[0] <= b[0] and b[1] <= a[1])
               or (b[0] <= a[0] and a[1] <= b[1])
               for i, a in enumerate(spans) for b in spans[i + 1:])


def _chips():
    """A LogUp chip (perm trace) and one without: 256 and 128 rows."""
    return [ChipInstance(*single_air("bytes", 8)),
            ChipInstance(*single_air("fib", 7))]


@pytest.fixture(scope="module")
def traced_proves():
    """Two proves of the same chips under the profiler, the first with an
    empty plan cache: [(spans, timings, proof bytes)] and the untraced
    prove's bytes."""
    chips = _chips()
    plain = prove_machine(chips, b"spans", CFG, device="cpu").to_bytes()
    saved = dict(lowering._PLAN_CACHE)
    lowering._PLAN_CACHE.clear()
    runs = []
    try:
        for _ in range(2):
            tim: dict = {}
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                blob = prove_machine(chips, b"spans", CFG, device="cpu",
                                     timings=tim).to_bytes()
            runs.append((_spans(prof), tim, blob))
    finally:
        lowering._PLAN_CACHE.update(saved)
    return runs, plain


def test_stage_spans_tile_the_prove_in_stage_order(traced_proves):
    runs, plain = traced_proves
    for spans, tim, blob in runs:
        assert blob == plain
        assert list(tim) == list(STAGES)
        stages = [s for s in spans if s[2].startswith("zktls.stage:")]
        assert [n for _, _, n in stages] == \
            [f"zktls.stage:{k}" for k in STAGES]
        for a, b in zip(stages, stages[1:]):
            assert a[1] <= b[0] and b[0] - a[1] < 1e6   # ns
        assert _nest_strictly(spans)


def test_stage_span_lengths_are_the_timings(traced_proves):
    for spans, tim, _ in traced_proves[0]:
        for s, e, n in spans:
            if n.startswith("zktls.stage:"):
                want = tim[n.removeprefix("zktls.stage:")]
                assert abs((e - s) / 1e9 - want) <= 0.05 * want, n


@pytest.mark.parametrize("kind, stage", [("perm_trace", "perm_commit"),
                                         ("constraint_vm", "quotient")])
def test_chip_spans_lie_inside_their_stage(traced_proves, kind, stage):
    want = {"perm_trace": ["ByteRangeAir"],
            "constraint_vm": ["ByteRangeAir", "FibonacciAir"]}[kind]
    for spans, _, _ in traced_proves[0]:
        (s0, e0, _), = [x for x in spans
                        if x[2] == f"zktls.stage:{stage}"]
        inner = [x for x in spans if x[2].startswith(f"zktls.{kind}:")]
        assert sorted(n.split(":")[1] for _, _, n in inner) == want
        assert all(s0 <= s and e <= e0 for s, e, _ in inner)


def test_only_a_cold_prove_lowers_airs(traced_proves):
    (cold, _, _), (warm, _, _) = traced_proves[0]
    lowered = [(s, e, n) for s, e, n in cold
               if n.startswith("zktls.lower_air:")]
    assert sorted(n for _, _, n in lowered) == \
        ["zktls.lower_air:ByteRangeAir", "zktls.lower_air:FibonacciAir"]
    (qs, qe, _), = [x for x in cold if x[2] == "zktls.stage:quotient"]
    assert all(qs <= s and e <= qe for s, e, _ in lowered)
    assert not [n for _, _, n in warm if n.startswith("zktls.lower_air:")]


def test_no_timings_and_no_profiler_means_no_sync_and_no_range(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda d=None: calls.append(("sync", d)))
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        lambda name: calls.append(("range", name)))
    cuda = torch.device("cuda")
    with Stages(None, "a", [cuda]) as stages:
        stages.next("b")
    with span("zktls.x"):
        pass
    assert calls == []

    tim: dict = {}
    with Stages(tim, "a", [cuda, torch.device("cpu")]) as stages:
        stages.next("b")
        stages.next("a")
    assert list(tim) == ["a", "b"] and calls == [("sync", cuda)] * 3


def test_spans_without_timings_sync_nothing(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda d=None: calls.append(d))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with Stages(None, "a", [torch.device("cuda")]) as stages:
            with span("zktls.inner"):
                pass
            stages.next("b")
    assert calls == []
    names = [n for _, _, n in _spans(prof)]
    assert names == ["zktls.stage:a", "zktls.inner", "zktls.stage:b"]


def test_a_stage_left_by_an_exception_closes_its_span_and_adds_nothing(
        monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda d=None: calls.append(d))
    tim: dict = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("zktls.outer"):
            with pytest.raises(ValueError):
                with Stages(tim, "a", [torch.device("cuda")]) as stages:
                    stages.next("b")
                    raise ValueError("no chips")
            with span("zktls.after"):
                pass
    assert list(tim) == ["a"] and len(calls) == 1
    spans = _spans(prof)
    assert [n for _, _, n in spans] == \
        ["zktls.outer", "zktls.stage:a", "zktls.stage:b", "zktls.after"]
    assert _nest_strictly(spans)
    (_, b_end, _), (after, _, _) = spans[2:]
    assert b_end <= after


def test_a_prove_that_raises_leaves_no_stage_open():
    air, trace, publics = single_air("fib", 7)
    bad = [ChipInstance(air, trace[:100], publics)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("zktls.outer"):
            with pytest.raises(ValueError, match="at least one chip"):
                prove_machine([], binding=b"", config=CFG, device="cpu",
                              timings={})
            with pytest.raises(ValueError, match="power of two"):
                prove_machine(bad, binding=b"", config=CFG, device="cpu",
                              timings={})
    spans = _spans(prof)
    assert [n for _, _, n in spans] == \
        ["zktls.outer", "zktls.stage:lde_commit"]
    assert _nest_strictly(spans)


def test_single_air_and_bn_provers_keep_their_timings_keys():
    air, trace, publics = single_air("fib")
    tim: dict = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        prove(air, trace, publics, StarkConfig(**SINGLES["fib"][0]),
              timings=tim, device="cpu")
    keys = ["lde_commit", "quotient", "ood_openings", "deep", "fri",
            "queries"]
    assert list(tim) == keys
    assert [n for _, _, n in _spans(prof) if "stage:" in n] == \
        [f"zktls.stage:{k}" for k in keys]

    tim = {}
    machine_bn.prove_machine_bn([ChipInstance(air, trace, publics)],
                                b"bn", StarkConfig(**SINGLES["fib"][0]),
                                timings=tim, device="cpu")
    assert list(tim) == list(STAGES) + ["mimc_s", "prove_bn_s"]


class _Shape:
    @staticmethod
    def of(proof):
        return _Shape()

    def to_bytes(self):
        return b""


def _fake_rung(monkeypatch, module, name, key):
    def fake(*args, timings=None, vk_roots=None, **kw):
        timings[key] = 0.0
        if vk_roots is not None:
            vk_roots["VmAir"] = [0]
        return "outer"

    monkeypatch.setattr(module, name, fake)


def test_recursion_rungs_keep_their_timings_keys(monkeypatch):
    """The outer prove's own keys come between the rung's host stages."""
    class _Prog:
        instrs, pub_values = [], []

    monkeypatch.setattr(recursion, "MachineShape", _Shape)
    monkeypatch.setattr(recursion, "build_program",
                        lambda *a, **kw: _Prog())
    monkeypatch.setattr(recursion, "_outer_chips", lambda prog: [])
    _fake_rung(monkeypatch, recursion, "prove_machine", "outer")
    _fake_rung(monkeypatch, machine_bn, "prove_machine_bn", "outer_bn")
    tim: dict = {}
    vk, outer = recursion.recursion_prove([], None, b"", timings=tim)
    assert (vk.program_root, outer) == ((0,), "outer")
    assert list(tim) == ["build_program", "outer_chips", "outer"]
    tim = {}
    recursion.recursion_prove_bn([], None, b"", timings=tim)
    assert list(tim) == ["build_program", "outer_chips", "outer_bn"]


@pytest.fixture
def anchored(monkeypatch):
    """The trust store with the committed 0x1303 session's leaf."""
    leaf = bytes.fromhex(SESSIONS["1303"].chain["root_spki_sha256"])
    store = roots.anchor_spki_hashes() | {leaf}
    monkeypatch.setattr(roots, "anchor_spki_hashes", lambda: store)


def test_guest_prover_spans_replay_build_and_encode(anchored, monkeypatch):
    class _Proof:
        def to_bytes(self):
            with span("zktls.inside_encode"):
                return b"proof"

    def fake_prove_machine(chips, binding, config, device, timings):
        seen.extend(c.air.name for c in chips)
        return _Proof()

    seen: list = []
    monkeypatch.setattr(tstark, "prove_machine", fake_prove_machine)
    gi = GuestInput.from_cbor(SESSIONS["1303"].guest_input.read_bytes())
    tim: dict = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, proof = tstark.StarkGuestProver(device="cpu").prove(gi,
                                                               timings=tim)
    assert proof == b"proof" and list(tim) == ["run_guest",
                                               "build_chip_instances"]
    spans = _spans(prof)
    assert _nest_strictly(spans)
    names = [n for _, _, n in spans]
    assert names[:2] == ["zktls.stage:run_guest",
                         "zktls.stage:build_chip_instances"]
    assert names[-2:] == ["zktls.encode_proof", "zktls.inside_encode"]
    (bs, be, _), = [x for x in spans
                    if x[2] == "zktls.stage:build_chip_instances"]
    built = [(s, e, n) for s, e, n in spans if n.startswith("zktls.build:")]
    assert all(bs <= s and e <= be for s, e, _ in built)
    # one span per builder; ModMulAir names every ModMul width's builder
    assert {n.removeprefix("zktls.build:") for _, _, n in built} == \
        {n for n in seen if not n.startswith("ModMul")} | {"ModMulAir"}


#: the c02f build's `zktls.build:` spans, in the order they open
C02F_BUILD_SPANS = ["KeyScheduleAir", "Sha256Air", "Aes128Air", "GhashAir",
                    "GcmControlAir", "StreamParserAir", "GcmDataAir",
                    "XorTableAir", "KeccakAir", "EcScheduleAir", "ModMulAir"]


@pytest.fixture(scope="module")
def replays():
    """The port's replays of the committed c02f and 0x1302 sessions."""
    return {name: run_guest(GuestInput.from_cbor(
        SESSIONS[name].guest_input.read_bytes()), require_trust_anchor=False)
        for name in ("c02f", "1302")}


@pytest.mark.parametrize("sessions, aes", [
    (("c02f",), ["Aes128Air"]), (("1302",), ["Aes256Air"]),
    (("c02f", "1302"), ["Aes128Air", "Aes256Air"])],
    ids=["c02f", "1302", "c02f+1302"])
def test_the_aes_builder_span_names_the_chip_it_builds(replays, sessions,
                                                       aes):
    """16-byte keys build under `zktls.build:Aes128Air`, 32-byte keys under
    `zktls.build:Aes256Air`, a mixed batch opens both; c02f's build spans
    are unchanged."""
    outs = [replays[name] for name in sessions]
    out = outs[0] if len(outs) == 1 else tstark.merge_guest_outputs(outs)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        chips = tstark.build_chip_instances(out)
    built = [n.removeprefix("zktls.build:") for _, _, n in _spans(prof)
             if n.startswith("zktls.build:")]
    assert [n for n in built if n.startswith("Aes")] == aes
    assert [c.air.name for c in chips if c.air.name.startswith("Aes")] == aes
    if sessions == ("c02f",):
        assert built == C02F_BUILD_SPANS
    if "1302" in sessions:
        assert "Sha512Air" in built


class _SlowProver:
    """Counts the proves running at once."""

    def __init__(self):
        self.running = self.most = 0
        self.lock = threading.Lock()

    def prove(self, guest_input):
        with self.lock:
            self.running += 1
            self.most = max(self.most, self.running)
        time.sleep(0.05)
        with self.lock:
            self.running -= 1
        return b"journal", b"proof"


def _post(url: str, body: bytes) -> int:
    host, port = url.removeprefix("http://").split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    try:
        conn.request("POST", "/v1/prove", body=body,
                     headers={"Content-Type": "application/cbor"})
        return conn.getresponse().status
    finally:
        conn.close()


def test_service_logs_each_request_and_proves_one_at_a_time(caplog):
    prover = _SlowProver()
    svc = service.ProverService(prover).start()
    body = SESSIONS["1303"].guest_input.read_bytes()
    status = []
    clients = [threading.Thread(
        target=lambda: status.append(_post(svc.url, body)))
        for _ in range(6)]
    try:
        with caplog.at_level(logging.INFO, logger=service.log.name):
            for c in clients:
                c.start()
            for c in clients:
                c.join(timeout=60)
    finally:
        svc.stop()
    assert not any(c.is_alive() for c in clients)
    assert status == [200] * 6 and prover.most == 1
    lines = [r.getMessage() for r in caplog.records
             if r.getMessage().startswith("request ")]
    assert sorted(int(m.split(":")[0].split()[1]) for m in lines) == \
        list(range(1, 7))
    assert all(" s, proved " in m and m.endswith(" s") for m in lines)
