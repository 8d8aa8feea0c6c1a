#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (zktls_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero
without printing a result:

  1. the card's name and power limit (nvidia-smi);
  2. build the Poseidon2 kernel (K1) from zktls_tpu_torch/csrc/;
  3. hold K1 against its plain torch version on the card (widths 16 and
     24, several batch sizes, rows inside a larger batch) and time both at
     the main path's shape beside the card's bound;
  4. the main path: prove the 32768 × 639 Sha256Air machine (8 messages of
     3,000 bytes, DEFAULT_CONFIG) on the card, with the kernel launch
     counters reset just before and read just after; verify the proof and
     reject one with a tampered digest limb;
  5. the same prove at 256 rows on the card and on the CPU: the proof
     bytes must be identical;
  6. one JSON line describing each kernel;
  7. last line: {"ok": true, "device": {...}}.

Needs one card, nvcc (/usr/local/cuda) and no network.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

SEED = 20261016
#: main-path input: 8 messages × 3,000 bytes = 384 compressions = 24,576
#: rows, padded to 32,768
MAIN_MESSAGES, MAIN_BYTES = 8, 3000


def _nvidia_smi(fields: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(what)


def _time_ms(fn, reps: int, runs: int = 5) -> float:
    """Median over `runs` of the mean time of `reps` calls (CUDA events),
    after a warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / reps)
    return statistics.median(times)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import numpy as np

    from zktls_tpu_torch.ops import babybear as bb
    from zktls_tpu_torch.ops import cuda_poseidon2 as k1
    from zktls_tpu_torch.ops import poseidon2 as p2
    from zktls_tpu_torch.stark.chips.sha256 import Sha256Air
    from zktls_tpu_torch.stark.config import DEFAULT_CONFIG
    from zktls_tpu_torch.stark.machine import (
        STAGES,
        MachineProof,
        prove_machine,
        verify_machine,
    )
    from zktls_tpu_torch.stark.verifier import VerificationError
    from zktls_tpu_torch.workload import sha_machine

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # 1. the card
    print(_nvidia_smi("name,power.limit"))
    clock_mhz = float(_nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    # 2. build K1
    t0 = time.perf_counter()
    _, report = k1.build()
    regs = [line.split("Used")[1].strip() for line in report.splitlines()
            if "Used" in line and "registers" in line]
    print(f"build: poseidon2.cu {time.perf_counter() - t0:.2f} s; "
          f"ptxas: {regs}")

    # 3. K1 against its plain version on the card
    rng = np.random.default_rng(SEED)

    def rand_states(n, width):
        return bb.from_numpy(bb.np_to_mont(
            rng.integers(0, bb.P, (n, width), dtype=np.uint32)), dev)

    max_err = 0
    for width in (16, 24):
        for n in (1, 511, 513, 131072):
            x = rand_states(n, width)
            got = p2.permute_batch(x)
            want = p2.permute_batch_plain(x)
            err = int((got - want).abs().max())
            max_err = max(max_err, err)
            _require(err == 0, f"K1 != plain at width {width}, N={n}")
        big = rand_states(1529, width)
        _require(bool((p2.permute_batch(big[:5].contiguous())
                       == p2.permute_batch(big)[:5]).all()),
                 f"K1 rows depend on their batch at width {width}")
    print(f"kernel: K1 == plain at widths 16/24, N in 1/511/513/131072 "
          f"(max abs err {max_err})")

    n_main, w_main = 131072, 24
    x32 = rand_states(n_main, w_main).to(torch.int32)
    x64 = x32.to(bb.DTYPE)
    k1_ms = _time_ms(lambda: k1.permute_batch(x32), reps=50)
    plain_ms = _time_ms(lambda: p2.permute_batch_plain(x64), reps=3,
                        runs=3)
    b = k1.bound({w_main: n_main}, sms, clock_mhz)
    bound_ms, bound_by = b["bound_s"] * 1e3, b["bound_by"]
    print(f"kernel: K1 {k1_ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}: {b['multiplies']} int32 "
          f"multiplies at {k1.INT_MULS_PER_CLOCK_PER_SM}/clk/SM x {sms} SMs"
          f" x {clock_mhz} MHz; bytes {b['bytes_s'] * 1e3:.4f} ms) at "
          f"({n_main}, {w_main}); no single PyTorch call computes "
          "Poseidon2, library_ms null")

    # 4. the main path, through K1
    inst, msgs = sha_machine(MAIN_MESSAGES, MAIN_BYTES, SEED)
    _require(inst.trace.shape == (32768, 639),
             f"main trace is {inst.trace.shape}, want (32768, 639)")
    binding = b"chip-smoke sha256 machine"
    torch.cuda.reset_peak_memory_stats(dev)
    timings: dict = {}
    k1.launches = 0
    p2.plain_calls = 0
    t0 = time.perf_counter()
    proof = prove_machine([inst], binding, DEFAULT_CONFIG, device=dev,
                          timings=timings)
    torch.cuda.synchronize(dev)
    prove_s = time.perf_counter() - t0
    launches, plain_calls = k1.launches, p2.plain_calls
    _require(launches > 0, "the main path launched K1 no time")
    _require(plain_calls == 0, "the main path ran the plain Poseidon2")
    blob = proof.to_bytes()
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    print("main: Sha256Air 32768x639 DEFAULT_CONFIG prove "
          f"{prove_s:.2f} s; stages " + ", ".join(
              f"{k} {timings[k]:.3f}" for k in STAGES)
          + f"; proof {len(blob)} bytes; K1 launches {launches}, plain "
          f"calls {plain_calls}; peak device memory {peak_gib:.2f} GiB")
    t0 = time.perf_counter()
    _require(verify_machine([Sha256Air()], MachineProof.from_bytes(blob),
                            binding, msgs, DEFAULT_CONFIG),
             "verifier rejected the main proof")
    verify_s = time.perf_counter() - t0
    tag, payload, mult = msgs[0]
    bad = [(tag, payload[:1] + [(payload[1] + 1) % 65536] + payload[2:],
            mult)] + msgs[1:]
    try:
        verify_machine([Sha256Air()], MachineProof.from_bytes(blob), binding,
                       bad, DEFAULT_CONFIG)
    except VerificationError as e:
        print(f"main: verify {verify_s:.2f} s ok; tampered digest limb "
              f"rejected ({e})")
    else:
        raise RuntimeError("verifier accepted a tampered digest limb")

    # 5. card vs CPU at 256 rows
    small, _ = sha_machine(2, 100, SEED)
    _require(small.trace.shape == (256, 639), "small trace shape")
    on_card = prove_machine([small], binding, DEFAULT_CONFIG,
                            device=dev).to_bytes()
    on_cpu = prove_machine([small], binding, DEFAULT_CONFIG,
                           device="cpu").to_bytes()
    _require(on_card == on_cpu, "card and CPU proofs differ at 256 rows")
    print(f"path: 256-row proof identical on card and CPU "
          f"({len(on_card)} bytes); total {time.perf_counter() - t_start:.1f}"
          " s")

    # 6. kernels
    print(json.dumps({"kernels": [{
        "name": "poseidon2_permute",
        "route": "cuda",
        "source": "zktls_tpu_torch/csrc/poseidon2.cu",
        "replaces": "zktls_tpu/ops/pallas_poseidon2.py:107",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k1_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}))
    # 7. result
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
