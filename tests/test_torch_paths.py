"""The prover's remaining device paths against the JAX package's, on the
CPU: the single-AIR prove/verify with StarkProof, the FRI fold loop it
shares with the machine prover, and the four-step NTT.

The JAX package's single-AIR proofs are committed in zktls_tpu_torch/data/
(`workload.SINGLES`, pinned by digest here; scripts/session_proof_cpu.py
--single fib|bytes --reference makes them again), so no JAX proof is
compiled here.  The reference's single-AIR prove cannot prove a bus chip
(Sha256Air's perm trace needs the machine's challenge vector), so the
LogUp single-AIR path is held on the byte-range table, with grinding."""

import dataclasses
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zktls_tpu.ops import ntt as jntt
from zktls_tpu.stark.chips.bytes_table import ByteRangeAir as JByteRangeAir
from zktls_tpu.models.fibonacci import FibonacciAir as JFibonacciAir
from zktls_tpu.stark import machine as jmachine
from zktls_tpu.stark.chips.sha256 import Sha256Air as JSha256Air
from zktls_tpu.stark.config import StarkConfig as JStarkConfig
from zktls_tpu.stark.proof import StarkProof as JStarkProof
from zktls_tpu.stark.verifier import VerificationError as JVerificationError
from zktls_tpu.stark.verifier import verify as jverify
from zktls_tpu_torch.models.fibonacci import FibonacciAir
from zktls_tpu_torch.ops import babybear as bb
from zktls_tpu_torch.ops import ntt
from zktls_tpu_torch.ops.field_ref import P
from zktls_tpu_torch.stark.air import Air
from zktls_tpu_torch.stark.config import StarkConfig
from zktls_tpu_torch.stark.machine import (
    ChipInstance,
    prove_machine,
    verify_machine,
)
from zktls_tpu_torch.stark.proof import StarkProof
from zktls_tpu_torch.stark.prover import prove
from zktls_tpu_torch.stark.verifier import VerificationError, verify
from zktls_tpu_torch.workload import (
    SHA_MACHINE_CONFIG,
    SHA_MACHINE_SEED,
    SINGLES,
    sha_machine,
    single_air,
)

from .torch_threads import torch_threads_per_worker  # noqa: F401

SINGLE_SHA256 = {
    "fib": "a677d46d0dbce5026fb8e88d7f90b0cb361d3ee591396d4e771086bc223194eb",
    "bytes":
    "e12833fe8fd3bdf9c95783332dc8a4883b4dea9cb358d99cd0e76b791e170591",
}
JAIRS = {"fib": JFibonacciAir, "bytes": JByteRangeAir}
SHA_CFG = StarkConfig(**SHA_MACHINE_CONFIG)


def _cfg(name):
    return StarkConfig(**SINGLES[name][0])


@pytest.fixture(scope="module", params=sorted(SINGLES))
def single(request):
    """(name, port AIR, trace, publics, committed JAX bytes, port proof)."""
    name = request.param
    data = SINGLES[name][1].read_bytes()
    assert hashlib.sha256(data).hexdigest() == SINGLE_SHA256[name]
    air, trace, publics = single_air(name)
    proof = prove(air, trace, publics, _cfg(name), device="cpu")
    return name, air, trace, publics, data, proof


def test_single_proof_equals_the_reference_bytes(single):
    """prove() gives the JAX package's committed bytes."""
    name, air, trace, publics, data, proof = single
    assert proof.to_bytes() == data


def test_stark_proof_bytes_round_trip(single):
    name, air, _, _, data, proof = single
    again = StarkProof.from_bytes(data)
    assert again.to_bytes() == data
    assert JStarkProof.from_bytes(data).to_bytes() == data
    assert again.air_name == air.name and len(again.queries) == \
        _cfg(name).num_queries
    assert (again.perm_root is not None) == bool(air.perm_width)


def test_each_verifier_accepts_the_other_packages_proof(single):
    name, air, _, _, data, proof = single
    jcfg = JStarkConfig(**SINGLES[name][0])
    assert verify(air, StarkProof.from_bytes(data), _cfg(name))
    assert jverify(JAIRS[name](), JStarkProof.from_bytes(proof.to_bytes()),
                   jcfg)


def _both_reject(name, blob):
    air, jair = single_air(name)[0], JAIRS[name]()
    with pytest.raises(VerificationError):
        verify(air, StarkProof.from_bytes(blob), _cfg(name))
    with pytest.raises(JVerificationError):
        jverify(jair, JStarkProof.from_bytes(blob),
                JStarkConfig(**SINGLES[name][0]))


def test_wrong_publics_and_tampered_trace_rejected():
    """As tests/test_stark.py: a Fibonacci proof made with a wrong public
    value, or over a trace with one changed cell, is rejected by both
    verifiers; so is a byte table holding a value past 255."""
    air, trace, public = single_air("fib")
    bad_public = list(public)
    bad_public[2] = (bad_public[2] + 1) % P
    _both_reject("fib", prove(air, trace, bad_public, _cfg("fib"),
                              device="cpu").to_bytes())
    bad = trace.copy()
    bad[17, 1] = (int(bad[17, 1]) + 1) % P
    _both_reject("fib", prove(air, bad, public, _cfg("fib"),
                              device="cpu").to_bytes())
    air, trace, _ = single_air("bytes")
    bad = trace.copy()
    bad[3, 0] = 300
    _both_reject("bytes", prove(air, bad, [], _cfg("bytes"),
                                device="cpu").to_bytes())


@pytest.mark.parametrize("field", ["trace_root", "ood_eval", "query_row",
                                   "fri_final", "queries", "pow_witness"])
def test_tampered_proof_fields_rejected(single, field):
    name, _, _, _, data, _ = single
    p = JStarkProof.from_bytes(data)
    if field == "trace_root":
        p.trace_root[0] = (p.trace_root[0] + 1) % P
    elif field == "ood_eval":
        p.trace_local_evals[0] = p.trace_local_evals[0] + type(
            p.trace_local_evals[0])(1)
    elif field == "query_row":
        p.queries[0].trace_row[0] = (p.queries[0].trace_row[0] + 1) % P
    elif field == "fri_final":
        p.fri_final[0] = p.fri_final[0] + type(p.fri_final[0])(1)
    elif field == "queries":
        p.queries = p.queries[:-1]
    else:
        p.pow_witness += 1 << 30
    _both_reject(name, p.to_bytes())


def test_degree_check_enforced():
    class TooDeep(Air):
        width = 1
        max_constraint_degree = 5

        def eval(self, b):
            x = b.local[0]
            b.assert_zero(x * x * x * x * x)

    with pytest.raises(ValueError, match="blowup"):
        prove(TooDeep(), np.ones((8, 1), dtype=np.uint32), [],
              _cfg("fib"), device="cpu")


@pytest.mark.parametrize("pow_bits", [0, 3])
def test_mixed_height_machine_through_the_shared_fri(pow_bits):
    """Two chips of different heights (the smaller one's DEEP joins the
    shared fold loop mid-way), with and without grinding: both verifiers
    accept the machine proof."""
    inst, msgs = sha_machine(2, 100, SHA_MACHINE_SEED)
    trace, publics = single_air("fib", 7)[1:]
    chips = [inst, ChipInstance(FibonacciAir(), trace, publics)]
    cfg = dataclasses.replace(SHA_CFG, pow_bits=pow_bits)
    proof = prove_machine(chips, b"mixed", cfg, device="cpu")
    assert verify_machine([inst.air, FibonacciAir()], proof, b"mixed", msgs,
                          cfg)
    assert jmachine.verify_machine(
        [JSha256Air(), JFibonacciAir()],
        jmachine.MachineProof.from_bytes(proof.to_bytes()), b"mixed", msgs,
        JStarkConfig(**dataclasses.asdict(cfg)))


@pytest.mark.parametrize("log_n", range(4, 13))
def test_four_step_ntt_equals_radix2(log_n, monkeypatch):
    """_ntt_four_step == radix-2, forward and inverse, at 1, 3 and 8
    columns; ntt/intt/coset_lde take it from n = 2^_FOUR_STEP_LOG up."""
    rng = np.random.default_rng(log_n)
    for cols in (1, 3, 8):
        x = bb.from_numpy(rng.integers(0, P, (1 << log_n, cols)))
        for inverse in (False, True):
            want = ntt._ntt_radix2(x, inverse)
            assert torch.equal(ntt._ntt_four_step(x, log_n, inverse), want)
            assert torch.equal(ntt.ntt(x, inverse), want)
    lde, inv = ntt.coset_lde(x, 2, 31), ntt.intt(x[:, 0])
    calls = []
    four_step = ntt._ntt_four_step
    monkeypatch.setattr(ntt, "_FOUR_STEP_LOG", log_n)
    monkeypatch.setattr(ntt, "_ntt_four_step",
                        lambda *a: calls.append(a[1:]) or four_step(*a))
    assert torch.equal(ntt.intt(x[:, 0]), inv)
    assert torch.equal(ntt.coset_lde(x, 2, 31), lde)
    assert calls == [(log_n, True), (log_n, True), (log_n + 2, False)]


@pytest.mark.parametrize("log_n,inverse", [(4, False), (7, True),
                                           (9, False), (10, True),
                                           (11, False), (12, False),
                                           (12, True)])
def test_four_step_ntt_equals_the_reference(log_n, inverse):
    rng = np.random.default_rng(100 + log_n)
    x = rng.integers(0, P, (1 << log_n, 3), dtype=np.uint32)
    want = np.asarray(jntt._ntt_four_step(jnp.asarray(x), log_n, inverse))
    got = ntt._ntt_four_step(bb.from_numpy(x), log_n, inverse)
    np.testing.assert_array_equal(bb.to_numpy(got), want)


def test_fib_chain_defaults_to_the_card(monkeypatch):
    """workload.fib_chain() resolves its device like every entry point:
    the card unless "cpu" is asked for, and without one it raises before
    proving anything."""
    from zktls_tpu_torch.stark import machine as tmachine
    from zktls_tpu_torch.workload import fib_chain

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    proved = []
    monkeypatch.setattr(tmachine, "prove_machine",
                        lambda *a, **k: proved.append(k))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fib_chain()
    assert proved == []
