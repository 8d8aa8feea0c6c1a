"""Benchmark of the PyTorch and CUDA prover (`zktls_tpu_torch`): fresh TLS
sessions recorded from a seed, each proved by `StarkGuestProver.prove` on
the card, one at a time, as a caller of `zktls prove` waits for its proof.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Run from the root of a checkout, on a machine with a CUDA card.  The cell
(`BENCHMARK.json`'s `workloads`) names a configuration (`configs/`) and a
traffic mix (`traffic/`).

Set-up records the mix's sessions plus one against a loopback TLS server
(`traffic.py`), builds the prover from the configuration's stated
StarkConfig, trusts the test certificate as the deployment's own anchor,
and proves the extra session once to warm every shape.  The window then
proves the recorded sessions in order, starting a prove only while fewer
than `--seconds` have passed and letting the last one finish.  With
`--trace 1` each prove also fills a `timings` dict and the window runs
under `torch.profiler`; the result then carries the per-layer metrics
instead of the end-to-end ones.  After the window, with the prover freed,
`reference.judge` holds every proved session to the frozen replay, to what
the server sent, to the configuration's chips and to the frozen verifier.

Prints the numbers compared beside their limits on standard error, then
one JSON line on standard output.  Exits 2 without a card, 3 when JAX or
the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402
from unittest import mock  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level module names the run must not have loaded
FORBIDDEN = ("jax", "jaxlib", "flax", "zktls_tpu")
#: build and kernel caches: fixed directories inside the checkout
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": HERE / "build" / "torch_extensions",
              "TRITON_CACHE_DIR": HERE / "build" / "triton"}


class Context:
    """What the metric readers read (`metrics/<name>.py`)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def stage_mean(self, key: str):
        vals = [t[key] for t in self.timings if key in t]
        return sum(vals) / len(vals) if vals else None


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def setup(cell: dict, seed: int, trace: bool, prover_factory=None):
    """Record the sessions and warm the prover.  Returns (configuration,
    prover, the program's inputs, the recorded sessions); session 0 was
    the warm-up's."""
    import torch

    import traffic
    from zktls_tpu_torch.core.types import GuestInput
    from zktls_tpu_torch.provers.stark import StarkGuestProver
    from zktls_tpu_torch.stark.config import StarkConfig

    config = traffic.load_json("configs", cell["config"])
    mix = traffic.load_json("traffic", cell["traffic"])
    sessions = traffic.record(config, mix, seed, range(mix["sessions"] + 1))
    inputs = [GuestInput.from_cbor(gi) for gi, _ in sessions]
    if prover_factory is None:
        prover = StarkGuestProver(config=StarkConfig(**config["stark"]),
                                  device="cuda")
    else:
        prover = prover_factory(config)
    prover.prove(inputs[0], timings={} if trace else None)
    if trace:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return config, prover, inputs, sessions


def window(prover, inputs, seconds: float, trace: bool, log):
    """Prove inputs[1:] in order while fewer than `seconds` have passed.
    Returns (results, timings, wall seconds, profile or None)."""
    import torch
    from torch.profiler import (
        ProfilerActivity,
        profile,
        record_function,
    )

    from devtrace import PROVE_SPAN

    results, timings, each = [], [], []
    prof_cm = (profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
               if trace else contextlib.nullcontext())
    start = time.perf_counter()
    with prof_cm as prof:
        for gi in inputs[1:]:
            if time.perf_counter() - start >= seconds:
                break
            tim = {} if trace else None
            t = time.perf_counter()
            span = (record_function(PROVE_SPAN) if trace
                    else contextlib.nullcontext())
            try:
                with span:
                    results.append(prover.prove(gi, timings=tim))
            except Exception:           # a prove that fails is judged
                log("prove failed:\n" + traceback.format_exc())
                results.append(None)
            timings.append(tim or {})
            each.append(time.perf_counter() - t)
        torch.cuda.synchronize()
    wall = time.perf_counter() - start
    log("proves " + " ".join(f"{x:.2f}" for x in each) + " s")
    if wall < seconds:
        log(f"the window ran out of sessions after {len(results)}")
    return results, timings, wall, prof


def measure(workload: str, seed: int, seconds: float, trace: bool,
            log, prover_factory=None) -> dict:
    """One run of a cell: the result line's object, its `checks` last.
    prover_factory(config): the prover to drive instead of the program's
    `StarkGuestProver` (the harness's tests break the timed path with
    it)."""
    import torch

    import manifest as mf
    import peaks
    import reference
    import traffic
    from devtrace import Trace
    from zktls_tpu_torch.guest import roots

    bench = mf.load()
    cell = mf.cell(bench, workload)
    card = peaks.read_card(torch)
    spki = traffic.leaf_spki_sha256(
        traffic.load_json("configs", cell["config"]))
    store = roots.anchor_spki_hashes() | {spki}
    with mock.patch.object(roots, "anchor_spki_hashes", lambda: store):
        config, prover, inputs, sessions = setup(cell, seed, trace,
                                                 prover_factory)
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - T0
        results, timings, wall, prof = window(prover, inputs, seconds,
                                              trace, log)
    peak = torch.cuda.max_memory_allocated()
    log(f"setup {setup_s:.2f} s; window {wall:.2f} s, {len(results)} proves")
    t = time.perf_counter()
    tr = Trace.from_profile(prof, timings) if trace else None
    del prover, inputs, prof
    gc.collect()
    torch.cuda.empty_cache()

    if trace:
        log(f"trace read in {time.perf_counter() - t:.2f} s")
    attempted = len(results)
    t = time.perf_counter()
    counts = reference.judge(config, sessions[1:1 + attempted], results,
                             spki, log=log)
    log(f"judged in {time.perf_counter() - t:.2f} s")
    failed = sum(1 for r in results if r is None)
    correct = attempted > 0 and all(
        counts[k] <= lim for k, lim in reference.LIMITS.items())
    completed = attempted - failed
    ctx = Context(window_s=wall, completed=completed, attempted=attempted,
                  peak_bytes=peak, setup_s=setup_s, timings=timings,
                  trace=tr, card=card, traced=completed,
                  works=[reference.poseidon2_work(r[1], config)
                         for r in results if r is not None]
                  if trace and correct else [])
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in mf.metrics_of(bench, cell["name"], kind):
        value = mf.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": card["name"],
              "count": cell["chips"], "memory_peak_bytes": peak,
              "power_limit_w": card["power_limit_w"]}
    result = {"correct": correct, "attempted": attempted,
              "failed": counts["faulty"], "metrics": metrics,
              "device": device}
    if trace:
        device["busy_s"] = tr.busy_ns() / 1e9
        device["window_s"] = tr.window_ns / 1e9
        result["breakdown"] = {"device_ops": tr.top_ops(10),
                               "idle_gaps": tr.idle_gaps(10)}
    result["checks"] = {k: {"value": counts[k], "limit": lim}
                        for k, lim in reference.LIMITS.items()}
    return result


def main(argv=None) -> int:
    args = parse_args(argv)
    log = lambda msg: print(msg, file=sys.stderr, flush=True)  # noqa: E731
    for var, path in CACHE_DIRS.items():
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)
    sys.path.insert(1, str(ROOT))
    import torch

    import manifest as mf

    chips = mf.cell(mf.load(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = measure(args.workload, args.seed, args.seconds,
                     bool(args.trace), log)
    found = forbidden_modules()
    if found:
        log(f"forbidden modules loaded: {found}")
        return 3
    for k, v in result["checks"].items():
        log(f"check {k} {v['value']} limit {v['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
