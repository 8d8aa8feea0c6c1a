"""Where the time of one prove goes, on the card.

    python3 -m zktls_tpu_torch.profile_prove [--workload sha|c02f|1302|1303|
        c02f_x2|c02f_x8|compress_1303|compress_c02f|shrink_1303|wrap_bn|
        wrap_size_fib]
        [--spill-bytes B]
        [--chunked-deep-bytes B] [--profiler torch|cprofile|none]

Proves a machine at DEFAULT_CONFIG three times — `sha` (the default): the
32768 × 639 Sha256Air machine of chip_smoke.py's first path; `c02f` (or
`session`), `1302`, `1303`: the machine of that recorded TLS session in
data/ (`workload.SESSIONS`), bound to its journal; `c02f_x2`, `c02f_x8`:
the merged machine of that batch (`workload.BATCHES`), bound to its
journals — cold (first use: kernel build, constraint lowering, host
tables), warm with per-stage seconds, and warm under torch.profiler, each
with `prove_machine`'s host-spill and chunked-DEEP limits as given
(default: the module's; `--profiler cprofile` profiles the third prove's
host Python with cProfile instead, `none` skips it).  Prints one JSON
line: the card, the cold and
warm wall seconds and peak device memory, the warm stages, the profiled
prove's wall and summed
device seconds (their ratio is the device-busy share: the port runs on one
stream, so device activities do not overlap), device ms and launches of
each Poseidon2 entry point (permute, hash_rows, merkle_levels) and their
sum beside the least time the card could take for the same permutations
(in all, and for the leaf sponges and the tree compressions apart),
device time by kind of activity (torch elementwise kernels, `cat`, copies,
…), and the top activities; with cprofile, the third prove's wall and
the host functions that took the most time in themselves.

`compress_1303`, `compress_c02f` (`workload.COMPRESSES`): the session's
machine proved on the card, then compressed by
`StarkGuestProver.compress` twice — the first with its seconds per stage
(`build_program`, `outer_chips`, the outer prove's stages), peak
device memory and the process's peak resident memory, the outer chips and the blob's size and SHA-256; the second
profiled as above (`cprofile`: its host functions; `none`: no second
compress).

`shrink_1303` (`workload.SHRINKS`): the session's machine proved and
compressed on the card as above, then the compress proof shrunk once by
`recursion_prove_bn` (`workload.shrink_statement`, as the reference's
`StarkGuestProver.wrap` calls it) — under torch.profiler unless
`--profiler none` — printing its seconds per stage (`build_program`,
`outer_chips`, the `prove_machine_bn` stages, `mimc_s`),
the device seconds and busy share, device time by kind, peak device
memory, the process's peak resident memory, the MiMC threads and the
proof's size and SHA-256.

`wrap_bn` (`workload.SNARKS`): the Groth16 STARK-verifier wrap of
tests/test_stark_wrap.py:24-88 — the Fibonacci(5) BN machine proved on the
card (no K1 launch; its bytes must hash to the JAX package's digest), then
on the host `build_stark_wrap_circuit` (its counts and `r1cs_digests`
required), Groth16 `setup` (WRAP_BN_SEED), `prove` (WRAP_BN_RANDOMNESS;
its bytes must hash to the JAX package's digest) and `verify` (accept the
statement digest, reject it ^ 1), with the seconds of each; then every MSM
of that prove (recorded as the prove made it) is held against the
pure-Python plain version on the same points and scalars, split across the
host's cores in worker processes (the plain MSM at these sizes is ~1 hour
of one core).

`wrap_size_fib`: how far `build_stark_wrap_circuit` gets over the tiny
chain's shrink proof (`workload.fib_chain`, shrunk on the card as
`StarkGuestProver.wrap` would), built in a worker process that reports its
constraints, variables and resident memory every 30 s; the worker is
stopped at 30 minutes or when its resident memory reaches the host's
available memory less 10 GiB.  Prints the outcome, the last report and the
caps.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import pstats
import subprocess
import sys
import time

import torch

from .ops import cuda_poseidon2
from .ops.merkle import LEAF_RATE
from .stark.config import DEFAULT_CONFIG
from .stark.machine import (
    CHUNKED_DEEP_BYTES,
    SPILL_BYTES,
    STAGES,
    prove_machine,
)
from .workload import (
    BATCHES,
    COMPRESSES,
    SESSIONS,
    SHRINKS,
    batch_machine,
    session_machine,
    sha_machine,
)

SEED = 20261016


def _poseidon2_work(chips: list[tuple[int, ...]], config,
                    vk_commits: int = 0) -> dict[int, int]:
    """States per Poseidon2 width that one prove of a machine of `chips`
    ((rows, width, perm width[, preprocessed width]) each) hashes: each
    committed matrix (trace, preprocessed, perm, quotient, every FRI
    layer's pair rows) costs ceil(w/16) width-24 leaf absorbs per row and
    rows − 1 width-16 compressions.  vk_commits: how many more times each
    preprocessed matrix is committed for a verifying key (the compress
    commits its program once more)."""
    mats = []
    for n_rows, width, perm_width, *pre in chips:
        big = n_rows << config.log_blowup
        mats += [(big, width), (big, 4 * config.blowup)]
        if perm_width:
            mats.append((big, perm_width))
        if pre and pre[0]:
            mats += [(big, pre[0])] * (1 + vk_commits)
    size = max(c[0] for c in chips) << config.log_blowup
    while size > config.fri_final_size:
        mats.append((size // 2, 8))
        size //= 2
    return {24: sum(r * -(-w // LEAF_RATE) for r, w in mats),
            16: sum(r - 1 for r, _ in mats)}


#: device activity kinds, by a substring of the kernel name (first match)
KINDS = (("k1", "poseidon2_"), ("copy", "Memcpy"), ("copy", "Memset"),
         ("int8_gemm", "gemm"), ("gather_scatter", "index"),
         ("cat", "CatArray"), ("reduce", "reduce_kernel"))


def _by_kind(rows) -> dict:
    """Device ms and activity count per kind; what matches no kind is a
    torch elementwise kernel (the int64 field arithmetic)."""
    out: dict = {}
    for name, count, us in rows:
        kind = next((k for k, sub in KINDS if sub in name), "elementwise")
        agg = out.setdefault(kind, {"ms": 0.0, "count": 0})
        agg["ms"] += us / 1e3
        agg["count"] += count
    return out


#: Poseidon2 entry point by a substring of its kernel's name
ENTRY_POINTS = (("permute", "poseidon2_permute_kernel"),
                ("hash_rows", "poseidon2_hash_rows_kernel"),
                ("merkle_levels", "poseidon2_merkle_kernel"))


def _by_entry_point(rows, launches: dict) -> dict:
    """Device ms and profiled activities per Poseidon2 entry point, beside
    the launches its wrapper counted."""
    return {name: {
        "ms": sum(us for n, _, us in rows if sub in n) / 1e3,
        "activities": sum(c for n, c, _ in rows if sub in n),
        "launches": launches[name],
    } for name, sub in ENTRY_POINTS}


def _device_rows(prof) -> list[tuple[str, int, float]]:
    """(name, count, device µs) of every device activity, largest first."""
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((e.key, e.count, float(us)))
    return sorted(rows, key=lambda r: -r[2])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="sha",
                    choices=("sha", "session", *SESSIONS, *BATCHES,
                             *COMPRESSES, *SHRINKS, "wrap_bn",
                             "wrap_size_fib"))
    ap.add_argument("--spill-bytes", type=float, default=SPILL_BYTES,
                    help="prove_machine's host-spill limit (default "
                         f"{SPILL_BYTES:g})")
    ap.add_argument("--chunked-deep-bytes", type=float,
                    default=CHUNKED_DEEP_BYTES,
                    help="prove_machine's chunked-DEEP limit (default "
                         f"{CHUNKED_DEEP_BYTES:g})")
    ap.add_argument("--profiler", default="torch",
                    choices=("torch", "cprofile", "none"),
                    help="how the third prove is profiled (default torch: "
                         "device time; cprofile: host functions; none: no "
                         "third prove)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_prove: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card, clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().rsplit(",", 1)
    clock_mhz = float(clock.split()[0])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if args.workload in COMPRESSES:
        return compress_main(args, dev, card, sms, clock_mhz)
    if args.workload in SHRINKS:
        return shrink_main(args, dev, card)
    if args.workload == "wrap_bn":
        return wrap_bn_main(dev, card)
    if args.workload == "wrap_size_fib":
        return wrap_size_main(dev, card)
    if args.workload == "sha":
        inst, _ = sha_machine(8, 3000, SEED)
        chips, binding = [inst], b"chip-smoke sha256 machine"
    elif args.workload in BATCHES:
        chips, journals = batch_machine(args.workload)
        binding = b"".join(journals)
    else:
        chips, binding = session_machine(
            "c02f" if args.workload == "session" else args.workload)

    peaks = []

    def prove(timings=None):
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        prove_machine(chips, binding, DEFAULT_CONFIG, device=dev,
                      timings=timings, spill_bytes=args.spill_bytes,
                      chunked_deep_bytes=args.chunked_deep_bytes)
        torch.cuda.synchronize(dev)
        peaks.append(torch.cuda.max_memory_allocated(dev) / 2**30)
        return time.perf_counter() - t0

    cold_s = prove()
    stages: dict = {}
    warm_s = prove(stages)
    result = {
        "card": card,
        "workload": args.workload,
        "traces": {c.air.name: list(c.trace.shape) for c in chips},
        "spill_bytes": args.spill_bytes,
        "chunked_deep_bytes": args.chunked_deep_bytes,
        "cold_prove_s": cold_s,
        "warm_prove_s": warm_s,
        "peak_device_gib": {"cold": peaks[0], "warm": peaks[1]},
        "warm_stages_s": {k: stages[k] for k in STAGES},
    }
    if args.profiler == "none":
        print(json.dumps(result))
        return 0
    if args.profiler == "cprofile":
        print(json.dumps({**result, **_cprofiled(prove)}))
        return 0
    print(json.dumps({**result, **_profiled(
        prove, [(c.trace.shape[0], c.air.width, c.air.perm_width)
                for c in chips], sms, clock_mhz)}))
    return 0


def _cprofiled(prove) -> dict:
    """Run `prove` under cProfile: its wall seconds and the host functions
    that took the most time in themselves."""
    host = cProfile.Profile()
    host.enable()
    profiled_s = prove()
    host.disable()
    top = sorted(pstats.Stats(host).stats.items(),
                 key=lambda kv: -kv[1][2])[:30]
    return {"profiled_prove_s": profiled_s, "host_top_self": [{
        "function": f"{f}:{line}({name})", "calls": calls, "self_s": tt,
        "cum_s": ct} for (f, line, name), (_, calls, tt, ct, _) in top]}


def _profiled(prove, chips, sms: int, clock_mhz: float,
              vk_commits: int = 0) -> dict:
    """Run `prove` under torch.profiler: its wall and device seconds, the
    device-busy share, device time by kind and per Poseidon2 entry point
    beside the bound for a machine of `chips` (as `_poseidon2_work`
    takes them), and the top device activities."""
    cuda_poseidon2.reset_launches()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        profiled_s = prove()
    rows = _device_rows(prof)
    device_us = sum(r[2] for r in rows)
    k1 = _by_entry_point(rows, cuda_poseidon2.launches)
    states = _poseidon2_work(chips, DEFAULT_CONFIG, vk_commits)
    return {
        "profiled_prove_s": profiled_s,
        "device_s": device_us / 1e6,
        "device_busy_share": device_us / 1e6 / profiled_s,
        "device_by_kind": _by_kind(rows),
        "k1_entry_points": k1,
        "k1_launches": sum(v["launches"] for v in k1.values()),
        "k1_device_s": sum(v["ms"] for v in k1.values()) / 1e3,
        "k1_states": states,
        "k1_bound": cuda_poseidon2.bound(states, sms, clock_mhz),
        "k1_bound_by_entry_point": {
            name: cuda_poseidon2.bound({w: states[w]}, sms, clock_mhz)
            for name, w in (("hash_rows", 24), ("merkle_levels", 16))},
        "top_device": [{"name": n[:90], "count": c, "ms": us / 1e3}
                       for n, c, us in rows[:25]],
    }


def compress_main(args, dev, card: str, sms: int, clock_mhz: float) -> int:
    """The compress workloads (module docstring)."""
    import hashlib
    import resource

    from .core import cbor
    from .provers.stark import StarkGuestProver
    from .stark.machine import MachineProof
    from .stark.recursion import outer_airs

    spec = COMPRESSES[args.workload]
    t0 = time.perf_counter()
    chips, journal = session_machine(spec.session)
    session_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    inner = prove_machine(chips, journal, DEFAULT_CONFIG,
                          device=dev).to_bytes()
    torch.cuda.synchronize(dev)
    inner_s = time.perf_counter() - t0
    del chips
    prover = StarkGuestProver(device=dev)
    peaks = []
    outs = []

    def compress(timings=None):
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        outs.append(prover.compress(
            journal, inner, timings=timings, spill_bytes=args.spill_bytes,
            chunked_deep_bytes=args.chunked_deep_bytes))
        torch.cuda.synchronize(dev)
        peaks.append(torch.cuda.max_memory_allocated(dev) / 2**30)
        return time.perf_counter() - t0

    stages: dict = {}
    cold_s = compress(stages)
    blob = outs[0]
    outer = MachineProof.from_bytes(cbor.loads(blob)["proof"])
    result = {
        "card": card,
        "workload": args.workload,
        "inner_session": spec.session,
        "session_machine_s": session_s,
        "inner_prove_s": inner_s,
        "inner_proof_sha256": hashlib.sha256(inner).hexdigest(),
        "outer_chips": {c.name: 1 << c.log_n for c in outer.chips},
        "spill_bytes": args.spill_bytes,
        "chunked_deep_bytes": args.chunked_deep_bytes,
        "compress_s": cold_s,
        "compress_stages_s": stages,
        "peak_device_gib": peaks[0],
        "blob_bytes": len(blob),
        "blob_sha256": hashlib.sha256(blob).hexdigest(),
        "host_peak_rss_gib":
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20,
    }
    if args.profiler == "cprofile":
        result.update(_cprofiled(compress))
    elif args.profiler == "torch":
        airs = {a.name: a for a in outer_airs()}
        result.update(_profiled(
            compress, [(1 << c.log_n, airs[c.name].width,
                        airs[c.name].perm_width,
                        getattr(airs[c.name], "preprocessed_width", 0))
                       for c in outer.chips], sms, clock_mhz, vk_commits=1))
    if args.profiler != "none":
        result["profiled_peak_device_gib"] = peaks[1]
        result["profiled_blob_equal"] = outs[1] == blob
    print(json.dumps(result))
    return 0


def shrink_main(args, dev, card: str) -> int:
    """The shrink workloads (module docstring)."""
    import hashlib
    import os
    import resource

    from .core import cbor
    from .provers.stark import StarkGuestProver, journal_public_messages
    from .stark.machine import MachineProof
    from .stark.recursion import RecursionVK, outer_airs, recursion_prove_bn
    from .utils import native
    from .workload import shrink_statement

    spec = SHRINKS[args.workload]
    cspec = COMPRESSES[spec.compress]
    chips, journal = session_machine(cspec.session)
    inner = prove_machine(chips, journal, DEFAULT_CONFIG,
                          device=dev).to_bytes()
    del chips
    t0 = time.perf_counter()
    blob = StarkGuestProver(device=dev).compress(
        journal, inner, spill_bytes=args.spill_bytes,
        chunked_deep_bytes=args.chunked_deep_bytes)
    compress_s = time.perf_counter() - t0
    obj = cbor.loads(blob)
    vk_a = RecursionVK.from_bytes(obj["vk"])
    outer_a = MachineProof.from_bytes(obj["proof"])
    binding, msgs, roots = shrink_statement(
        vk_a, journal, journal_public_messages(journal))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    stages: dict = {}

    def shrink():
        t0 = time.perf_counter()
        out = recursion_prove_bn(
            outer_airs(), outer_a, binding, msgs, DEFAULT_CONFIG,
            DEFAULT_CONFIG, inner_preprocessed_roots=roots, timings=stages,
            device=dev)
        torch.cuda.synchronize(dev)
        return time.perf_counter() - t0, out

    result = {"card": card, "workload": args.workload,
              "compress_blob_sha256": hashlib.sha256(blob).hexdigest(),
              "compress_s": compress_s}
    if args.profiler == "torch":
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            shrink_s, (vk_b, proof_b) = shrink()
        rows = _device_rows(prof)
        device_s = sum(r[2] for r in rows) / 1e6
        result.update({
            "device_s": device_s, "device_busy_share": device_s / shrink_s,
            "device_by_kind": _by_kind(rows),
            "top_device": [{"name": n[:90], "count": c, "ms": us / 1e3}
                           for n, c, us in rows[:15]]})
    else:
        shrink_s, (vk_b, proof_b) = shrink()
    proof = proof_b.to_bytes()
    result.update({
        "profiler": args.profiler,
        "shrink_s": shrink_s,
        "shrink_stages_s": stages,
        "instructions": vk_b.n_instrs,
        "outer_chips": {c.name: 1 << c.log_n for c in proof_b.chips},
        "peak_device_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
        "host_peak_rss_gib":
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20,
        "host_cores": os.cpu_count(),
        "mimc_threads": native.mimc_threads(),
        "proof_bytes": len(proof),
        "proof_sha256": hashlib.sha256(proof).hexdigest(),
    })
    print(json.dumps(result))
    return 0


def _plain_msm(group: str, points: list, scalars: list):
    """One slice of a plain MSM (a worker process's share)."""
    from .snark import bn254

    fn = bn254.msm_g1 if group == "g1" else bn254.msm_g2
    return fn(points, scalars, native=False)


def wrap_bn_main(dev, card: str) -> int:
    """The `wrap_bn` workload (module docstring)."""
    import hashlib
    import multiprocessing
    import os
    import resource
    from unittest import mock

    from .snark import bn254, groth16
    from .snark.stark_wrap import build_stark_wrap_circuit, \
        statement_digest_fr
    from .stark.config import StarkConfig
    from .stark.machine_bn import prove_machine_bn
    from .workload import (
        SNARKS,
        WRAP_BN_RANDOMNESS,
        WRAP_BN_SEED,
        r1cs_digests,
        wrap_bn_machine,
    )

    spec = SNARKS["wrap_bn"]
    chips, binding, cfg_kw = wrap_bn_machine()
    cfg = StarkConfig(**cfg_kw)
    seconds: dict = {}
    checks: dict = {}
    cuda_poseidon2.reset_launches()
    t0 = time.perf_counter()
    proof = prove_machine_bn(chips, binding, cfg, device=dev)
    torch.cuda.synchronize(dev)
    seconds["bn_prove"] = time.perf_counter() - t0
    launches = dict(cuda_poseidon2.launches)
    blob = proof.to_bytes()
    checks["bn_proof == JAX digest"] = (
        hashlib.sha256(blob).hexdigest() == spec.digests["proof"])
    t0 = time.perf_counter()
    cs = build_stark_wrap_circuit([chips[0].air], proof, binding, [], cfg,
                                  {})
    seconds["circuit"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    checks["cs.check()"] = cs.check()
    seconds["check"] = time.perf_counter() - t0
    counts = (len(cs.constraints), cs.n_vars)
    checks["counts"] = counts == (spec.constraints, spec.variables)
    digests = r1cs_digests(cs)
    for key in ("assignment", "constraints"):
        checks[f"{key} == JAX digest"] = digests[key] == spec.digests[key]
    stmt = statement_digest_fr(binding, [], {})
    t0 = time.perf_counter()
    keys = groth16.setup(cs, seed=WRAP_BN_SEED)
    seconds["setup"] = time.perf_counter() - t0
    calls = []

    def recorded(fn, group):
        def msm(points, scalars):
            out = fn(points, scalars)
            calls.append((group, points, scalars, out))
            return out
        return msm

    t0 = time.perf_counter()
    with mock.patch.object(groth16, "msm_g1",
                           recorded(bn254.msm_g1, "g1")), \
            mock.patch.object(groth16, "msm_g2",
                              recorded(bn254.msm_g2, "g2")):
        g16_proof = groth16.prove(keys, cs, randomness=WRAP_BN_RANDOMNESS)
    seconds["prove"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    checks["verify accepts"] = groth16.verify(keys.vk(), [stmt], g16_proof)
    seconds["verify"] = time.perf_counter() - t0
    checks["verify rejects statement ^ 1"] = not groth16.verify(
        keys.vk(), [stmt ^ 1], g16_proof)
    g16_bytes = g16_proof.to_bytes()
    checks["groth16 == JAX digest"] = (
        hashlib.sha256(g16_bytes).hexdigest() == spec.digests["groth16"])
    # the C MSMs of the prove against the plain version on their inputs
    workers = os.cpu_count() or 1
    t0 = time.perf_counter()
    msm_sizes = []
    with multiprocessing.get_context("spawn").Pool(workers) as pool:
        for group, points, scalars, out in calls:
            step = -(-len(points) // workers)
            parts = pool.starmap(_plain_msm, [
                (group, points[i:i + step], scalars[i:i + step])
                for i in range(0, len(points), step)])
            add = bn254.g1_add if group == "g1" else bn254.g2_add
            plain = None
            for part in parts:
                plain = add(plain, part)
            msm_sizes.append([group, len(points), plain == out])
    seconds["plain_msms"] = time.perf_counter() - t0
    checks["every C MSM == plain"] = all(ok for *_, ok in msm_sizes)
    print(json.dumps({
        "card": card, "workload": "wrap_bn", "seconds": seconds,
        "constraints": counts[0], "variables": counts[1],
        "k1_launches_bn_prove": launches,
        "bn_proof_sha256": hashlib.sha256(blob).hexdigest(),
        "r1cs_digests": digests,
        "groth16_sha256": hashlib.sha256(g16_bytes).hexdigest(),
        "msms": msm_sizes, "plain_workers": workers,
        "host_peak_rss_gib":
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20,
        "checks": checks}))
    ok = all(checks.values()) and sum(launches.values()) == 0
    return 0 if ok else 1


#: the caps of the wrap_size_fib build: its seconds, and the host memory
#: it must leave free
SIZE_CAP_S = 1800.0
SIZE_HEADROOM_GIB = 10.0


def _size_worker(conn, blob: bytes, binding: bytes, msgs: list,
                 cfg_kw: dict, root: int) -> None:
    """Build the chain's wrap circuit, sending (seconds, constraints,
    variables, RSS GiB) every 30 s and ("done", ...) at the end."""
    import os
    import threading

    from .snark import stark_wrap
    from .stark.config import StarkConfig
    from .stark.machine_bn import MachineProofBN
    from .stark.recursion import outer_airs

    built = []

    class Tracked(stark_wrap.R1CS):
        def __init__(self):
            super().__init__()
            built.append(self)

    t0 = time.perf_counter()

    def report(tag):
        cs = built[-1] if built else None
        conn.send((tag, time.perf_counter() - t0,
                   len(cs.constraints) if cs else 0,
                   cs.n_vars if cs else 0, _rss_gib(os.getpid())))

    def every_30_s():
        while True:
            time.sleep(30)
            report("progress")

    stark_wrap.R1CS = Tracked
    threading.Thread(target=every_30_s, daemon=True).start()
    stark_wrap.build_stark_wrap_circuit(
        outer_airs(), MachineProofBN.from_bytes(blob), binding, msgs,
        StarkConfig(**cfg_kw), {"VmAir": root})
    report("done")


def _rss_gib(pid: int) -> float:
    with open(f"/proc/{pid}/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 2**20
    return 0.0


def _available_gib() -> float:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) / 2**20
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def wrap_size_main(dev, card: str) -> int:
    """The `wrap_size_fib` workload (module docstring)."""
    import multiprocessing

    from .stark.config import StarkConfig
    from .stark.recursion import (
        _session_messages,
        outer_airs,
        recursion_prove_bn,
    )
    from .workload import FIB_CHAIN_BINDING, FIB_CHAIN_CONFIG, fib_chain, \
        shrink_statement

    cfg = StarkConfig(**FIB_CHAIN_CONFIG)
    t0 = time.perf_counter()
    _, vk_a, proof_a = fib_chain(dev)
    a_binding, a_msgs, roots = shrink_statement(vk_a, FIB_CHAIN_BINDING, [])
    vk_b, proof_b = recursion_prove_bn(
        outer_airs(), proof_a, a_binding, a_msgs, cfg, cfg,
        inner_preprocessed_roots=roots, device=dev)
    chain_s = time.perf_counter() - t0
    b_msgs = _session_messages(
        vk_b.shape, a_binding, a_msgs,
        dict((n, list(r)) for n, r in vk_b.inner_preprocessed_roots))
    b_binding = a_binding + vk_b.shape.to_bytes()
    cap_s = SIZE_CAP_S
    cap_gib = _available_gib() - SIZE_HEADROOM_GIB
    ctx = multiprocessing.get_context("spawn")
    recv, send = ctx.Pipe(duplex=False)
    worker = ctx.Process(target=_size_worker, args=(
        send, proof_b.to_bytes(), b_binding, b_msgs, FIB_CHAIN_CONFIG,
        vk_b.program_root))
    worker.start()
    t_start = time.perf_counter()
    send.close()
    last, outcome, peak = None, None, 0.0
    try:
        while outcome is None:
            if recv.poll(1.0):
                try:
                    last = recv.recv()
                except EOFError:
                    outcome = f"worker ended (exit code {worker.exitcode})"
                    break
                print(json.dumps({"report": last}), flush=True)
                if last[0] == "done":
                    outcome = "done"
                    break
            if not worker.is_alive():
                outcome = f"worker ended (exit code {worker.exitcode})"
                break
            rss = _rss_gib(worker.pid)
            peak = max(peak, rss)
            if rss > cap_gib:
                outcome = f"stopped at the memory cap ({rss:.1f} GiB)"
            elif time.perf_counter() - t_start > cap_s:
                outcome = "stopped at the time cap"
    finally:
        if worker.is_alive():
            worker.kill()
        worker.join(timeout=60)
    print(json.dumps({
        "card": card, "workload": "wrap_size_fib",
        "chain_on_card_s": chain_s, "shrink_proof_bytes":
            len(proof_b.to_bytes()),
        "outcome": outcome, "last_report":
            dict(zip(("tag", "seconds", "constraints", "variables",
                      "rss_gib"), last)) if last else None,
        "worker_peak_rss_gib": peak, "cap_s": cap_s, "cap_gib": cap_gib}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
