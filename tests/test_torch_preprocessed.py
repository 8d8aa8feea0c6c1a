"""Preprocessed (fixed) columns, host spill and chunked DEEP in the port's
machine prover, against the JAX package: the mirror of
tests/test_preprocessed.py's five cases (the port's `preprocessed_root`
equals the reference's; the port's proof is accepted by both packages'
`verify_machine` with the vk root; a wrong root, a missing root, a
substituted matrix and a violated constraint are rejected by both) and of
tests/test_machine.py::test_spill_and_chunked_deep_byte_identical on the
port's Fibonacci machine.  Every proof here is the port's, on the CPU; the
inputs are seeded; equality is exact."""

import pytest

from zktls_tpu.models.fibonacci import FibonacciAir as JFibonacciAir
from zktls_tpu.stark import machine as jmachine
from zktls_tpu.stark.air import Air as JAir
from zktls_tpu.stark.config import StarkConfig as JStarkConfig
from zktls_tpu.stark.verifier import VerificationError as JVerificationError
from zktls_tpu_torch.models.fibonacci import FibonacciAir, fibonacci_trace
from zktls_tpu_torch.stark.config import StarkConfig
from zktls_tpu_torch.stark.machine import (
    ChipInstance,
    MachineProof,
    preprocessed_root,
    prove_machine,
    verify_machine,
)
from zktls_tpu_torch.stark.verifier import VerificationError
from zktls_tpu_torch.workload import FixedMulAir, preprocessed_machine

from .torch_threads import torch_threads_per_worker  # noqa: F401

CFG_ARGS = dict(log_blowup=2, num_queries=6, pow_bits=0, fri_final_size=8)
CFG, JCFG = StarkConfig(**CFG_ARGS), JStarkConfig(**CFG_ARGS)
BINDING = b"pre-test"
LOG_N = 5


class JFixedMulAir(JAir):
    """The JAX package's side of the port's FixedMulAir."""

    width = 2
    preprocessed_width = 2
    num_public = 0
    max_constraint_degree = 2
    name = "FixedMulAir"
    eval = FixedMulAir.eval


def _chips(trace, pre):
    """The FixedMulAir chip beside a Fibonacci chip of half its height."""
    chips, _ = preprocessed_machine(LOG_N)
    chips[0].trace, chips[0].preprocessed = trace, pre
    return chips


def _both_reject(proof_bytes, roots):
    """Each package's verifier rejects the proof under these vk roots."""
    with pytest.raises(VerificationError):
        verify_machine([FixedMulAir(), FibonacciAir()],
                       MachineProof.from_bytes(proof_bytes), BINDING,
                       config=CFG, preprocessed_roots=roots)
    with pytest.raises(JVerificationError):
        jmachine.verify_machine([JFixedMulAir(), JFibonacciAir()],
                                jmachine.MachineProof.from_bytes(proof_bytes),
                                BINDING, config=JCFG,
                                preprocessed_roots=roots)


@pytest.fixture(scope="module")
def honest():
    chips, pre = preprocessed_machine(LOG_N)
    trace = chips[0].trace
    proof = prove_machine(_chips(trace, pre), BINDING, CFG, device="cpu")
    root = preprocessed_root(FixedMulAir(), pre, LOG_N, LOG_N, CFG,
                             device="cpu")
    return {"trace": trace, "pre": pre, "proof": proof.to_bytes(),
            "vk": {"FixedMulAir": root}}


def test_preprocessed_root_equals_reference(honest):
    pre = honest["pre"]
    assert honest["vk"]["FixedMulAir"] == jmachine.preprocessed_root(
        JFixedMulAir(), pre, LOG_N, LOG_N, JCFG)
    # a chip below the machine's largest commits on another coset
    assert preprocessed_root(FixedMulAir(), pre, LOG_N + 1, LOG_N, CFG,
                             device="cpu") == jmachine.preprocessed_root(
        JFixedMulAir(), pre, LOG_N + 1, LOG_N, JCFG)


def test_proof_accepted_by_both_verifiers(honest):
    proof = MachineProof.from_bytes(honest["proof"])
    assert proof.to_bytes() == honest["proof"]
    assert len(proof.chips[0].el) == len(proof.chips[0].en) == 2
    assert all(len(o.pre_row) == 2 for q in proof.queries
               for o in q.openings[:1])
    assert verify_machine([FixedMulAir(), FibonacciAir()], proof, BINDING,
                          config=CFG, preprocessed_roots=honest["vk"])
    assert jmachine.verify_machine(
        [JFixedMulAir(), JFibonacciAir()],
        jmachine.MachineProof.from_bytes(honest["proof"]), BINDING,
        config=JCFG, preprocessed_roots=honest["vk"])


def test_wrong_vk_root_rejected(honest):
    bad = list(honest["vk"]["FixedMulAir"])
    bad[0] ^= 1
    _both_reject(honest["proof"], {"FixedMulAir": bad})


def test_missing_vk_root_rejected(honest):
    _both_reject(honest["proof"], {})


def test_substituted_matrix_rejected(honest):
    """A prover proving against a DIFFERENT fixed matrix cannot pass the
    honest vk: the openings hash to another root."""
    pre2 = honest["pre"].copy()
    pre2[3, 1] += 1
    trace2 = honest["trace"].copy()
    # the forged matrix still satisfies the constraints
    trace2[3, 1] = (int(pre2[3, 0]) * int(trace2[3, 0]) + int(pre2[3, 1])) \
        % 2013265921
    forged = prove_machine(_chips(trace2, pre2), BINDING, CFG,
                           device="cpu").to_bytes()
    _both_reject(forged, honest["vk"])


def test_constraint_violation_rejected(honest):
    trace = honest["trace"].copy()
    trace[5, 1] ^= 1          # y no longer equals c·x + d
    bad = prove_machine(_chips(trace, honest["pre"]), BINDING, CFG,
                        device="cpu").to_bytes()
    _both_reject(bad, honest["vk"])


def test_prover_checks_the_preprocessed_matrix(honest):
    trace, pre = honest["trace"], honest["pre"]
    with pytest.raises(ValueError, match="preprocessed trace must be"):
        prove_machine(_chips(trace, pre[:, :1]), BINDING, CFG, device="cpu")
    fib, fib_pub = fibonacci_trace(LOG_N)
    with pytest.raises(ValueError, match="unexpected preprocessed trace"):
        prove_machine([ChipInstance(air=FibonacciAir(), trace=fib,
                                    publics=fib_pub, preprocessed=pre)],
                      BINDING, CFG, device="cpu")


@pytest.mark.parametrize("limits", [
    dict(spill_bytes=0, chunked_deep_bytes=0),
    dict(spill_bytes=0),
    dict(chunked_deep_bytes=0),
    dict(spill_bytes=float("inf"), chunked_deep_bytes=float("inf"))],
    ids=["spill+chunked", "spill", "chunked", "neither"])
def test_spill_and_chunked_deep_byte_identical(honest, limits):
    """Host spill and chunked DEEP only move matrices: the preprocessed
    machine's proof bytes are the default's under every setting."""
    proof = prove_machine(_chips(honest["trace"], honest["pre"]), BINDING,
                          CFG, device="cpu", **limits)
    assert proof.to_bytes() == honest["proof"]


def test_fibonacci_spill_and_chunked_deep_byte_identical():
    """The mirror of the reference's test on its Fibonacci machine."""
    cfg = StarkConfig(log_blowup=2, num_queries=3, pow_bits=0,
                      fri_final_size=16)
    trace, pub = fibonacci_trace(5)

    def mk():
        return [ChipInstance(air=FibonacciAir(), trace=trace, publics=pub)]

    base = prove_machine(mk(), b"spill", cfg, device="cpu").to_bytes()
    assert prove_machine(mk(), b"spill", cfg, device="cpu", spill_bytes=0,
                         chunked_deep_bytes=0).to_bytes() == base
    assert jmachine.verify_machine(
        [JFibonacciAir()], jmachine.MachineProof.from_bytes(base), b"spill",
        config=JStarkConfig(log_blowup=2, num_queries=3, pow_bits=0,
                            fri_final_size=16))
