"""The port's machine STARK against the JAX package's on a one-chip
Sha256Air machine (256 × 639 rows, 2 seeded 100-byte messages with result
tags): byte-identical proofs, each package's verifier accepting the other's
proof and rejecting a tampered digest, and the constraint-VM quotient
equal on the chip's LDE.

The JAX package's proof and quotient are its prove_machine and
eval_quotient_vm outputs committed in zktls_tpu_torch/data/
(`workload.SHA_MACHINE_REFERENCE`, `SHA_QUOTIENT_REFERENCE`, pinned by
digest here, made and checked live by scripts/session_proof_cpu.py
--machine sha --reference): computing them here cost ~190 and ~85 s of
XLA compilation per run."""

import hashlib

import numpy as np
import pytest
import torch

from zktls_tpu.guest.crypto.sha256 import SHA256Recorder
from zktls_tpu.ops import babybear as jbb
from zktls_tpu.ops.field_ref import P, Fp4
from zktls_tpu.stark import machine as jmachine
from zktls_tpu.stark.challenger import Challenger as JChallenger
from zktls_tpu.stark.chips.sha256 import Sha256Air as JSha256Air
from zktls_tpu.stark.chips.sha256 import sha256_trace as jsha256_trace
from zktls_tpu.stark.config import StarkConfig as JStarkConfig
from zktls_tpu.stark.prover import _grind_device as jgrind
from zktls_tpu.stark.verifier import VerificationError as JVerificationError
from zktls_tpu_torch.convert import (chip_instance_from_reference,
                                     events_from_reference)
from zktls_tpu_torch.ops import babybear as tbb
from zktls_tpu_torch.ops.field_ref import Fp4 as TFp4
from zktls_tpu_torch.stark import machine as tmachine
from zktls_tpu_torch.stark import prover as tprover
from zktls_tpu_torch.stark.bus import BUS_SHA_RESULT, digest_limbs
from zktls_tpu_torch.stark.chips.sha256 import Sha256Air
from zktls_tpu_torch.stark.chips.sha256 import sha256_trace
from zktls_tpu_torch.stark.config import StarkConfig
from zktls_tpu_torch.stark.verifier import VerificationError
from zktls_tpu_torch.workload import (
    SHA_MACHINE_BINDING,
    SHA_MACHINE_CONFIG,
    SHA_MACHINE_REFERENCE,
    SHA_MACHINE_SEED,
    SHA_QUOTIENT_REFERENCE,
    sha_quotient_inputs,
)

from .torch_threads import torch_threads_per_worker  # noqa: F401

BINDING = SHA_MACHINE_BINDING
CFG = SHA_MACHINE_CONFIG
#: SHA-256 of the committed JAX proof and quotient
SHA_MACHINE_REFERENCE_SHA256 = (
    "2960f41800ea1d9d96f03c7568d431ce46989d39d731491face6f6ea96f04a36")
SHA_QUOTIENT_REFERENCE_SHA256 = (
    "2bade586928432e9bf8a17e7edb92997f6977ac1996355b4585e69e8f4c1461a")


@pytest.fixture(scope="module")
def ref():
    """The JAX package's chip, public messages and (committed) proof
    bytes."""
    rng = np.random.default_rng(SHA_MACHINE_SEED)
    rec = SHA256Recorder()
    digests = [rec.sha256(rng.integers(0, 256, 100, dtype=np.uint8)
                          .tobytes(), result_tag=i + 1) for i in range(2)]
    trace, publics = jsha256_trace(rec.events)
    assert trace.shape == (256, 639)
    inst = jmachine.ChipInstance(air=JSha256Air(), trace=trace,
                                 publics=publics)
    # payload layout of chips/sha256.py: (tag, 16 digest limbs, xb = 0)
    msgs = [(BUS_SHA_RESULT, [i + 1] + digest_limbs(d) + [0], -1)
            for i, d in enumerate(digests)]
    return {"events": rec.events, "inst": inst, "msgs": msgs,
            "proof": SHA_MACHINE_REFERENCE.read_bytes()}


@pytest.fixture(scope="module")
def port_proof(ref):
    inst = chip_instance_from_reference(ref["inst"])
    return tmachine.prove_machine([inst], BINDING, StarkConfig(**CFG),
                                  device="cpu").to_bytes()


def _tampered(msgs):
    tag, payload, mult = msgs[0]
    return [(tag, payload[:1] + [(payload[1] + 1) % 65536] + payload[2:],
             mult)] + msgs[1:]


def test_trace_and_instance_carry_across(ref):
    trace, publics = sha256_trace(events_from_reference(ref["events"]))
    np.testing.assert_array_equal(trace, ref["inst"].trace)
    inst = chip_instance_from_reference(ref["inst"])
    assert isinstance(inst.air, Sha256Air) and inst.publics == publics
    np.testing.assert_array_equal(inst.trace, trace)


def test_proof_bytes_identical(ref, port_proof):
    assert port_proof == ref["proof"]


def test_committed_reference_proof_is_pinned(ref):
    """The committed JAX proof is the one its prove_machine gave (the
    digest the live regeneration printed), of this very chip: its one
    chip is Sha256Air with the chip's publics, and both packages parse and
    re-encode it unchanged."""
    data = ref["proof"]
    assert hashlib.sha256(data).hexdigest() == SHA_MACHINE_REFERENCE_SHA256
    proof = jmachine.MachineProof.from_bytes(data)
    assert [(c.name, c.log_n) for c in proof.chips] == [("Sha256Air", 8)]
    assert proof.chips[0].publics == [int(v) % P
                                      for v in ref["inst"].publics]
    assert proof.to_bytes() == data
    assert tmachine.MachineProof.from_bytes(data).to_bytes() == data


def test_reference_verifier_accepts_port_proof(ref, port_proof):
    proof = jmachine.MachineProof.from_bytes(port_proof)
    assert jmachine.verify_machine([JSha256Air()], proof, BINDING,
                                   ref["msgs"], JStarkConfig(**CFG))
    with pytest.raises(JVerificationError):
        jmachine.verify_machine([JSha256Air()], proof, BINDING,
                                _tampered(ref["msgs"]), JStarkConfig(**CFG))


def test_port_verifier_accepts_reference_proof(ref):
    proof = tmachine.MachineProof.from_bytes(ref["proof"])
    assert tmachine.verify_machine([Sha256Air()], proof, BINDING,
                                   ref["msgs"], StarkConfig(**CFG))
    with pytest.raises(VerificationError):
        tmachine.verify_machine([Sha256Air()], proof, BINDING,
                                _tampered(ref["msgs"]), StarkConfig(**CFG))
    with pytest.raises(VerificationError):
        tmachine.verify_machine([Sha256Air()], proof, b"another binding",
                                ref["msgs"], StarkConfig(**CFG))


def test_quotient_vm_matches(ref):
    """eval_quotient_vm on the chip's LDE with seeded challenges, α powers
    and bus sum equals the JAX package's (its committed values, for the
    same trace and `sha_quotient_inputs`)."""
    from zktls_tpu_torch.ops.ntt import coset_lde
    from zktls_tpu_torch.stark.config import selector_arrays
    from zktls_tpu_torch.stark.lowering import eval_quotient_vm as tvm
    from zktls_tpu_torch.stark.lowering import lower_air

    data = SHA_QUOTIENT_REFERENCE.read_bytes()
    assert hashlib.sha256(data).hexdigest() == SHA_QUOTIENT_REFERENCE_SHA256
    want = np.load(SHA_QUOTIENT_REFERENCE)
    trace = ref["inst"].trace
    log_n, log_blowup, shift = 8, 2, 31
    n_c = lower_air(Sha256Air(), 4, 74).n_constraints
    coeffs, publics, apow = sha_quotient_inputs(n_c)
    challenges = [TFp4(*c) for c in coeffs]
    perm = Sha256Air().generate_perm_trace(trace, [], challenges)
    sels = selector_arrays(log_n, log_blowup, shift)

    def t(x):
        return tbb.from_numpy(np.asarray(x))

    def lde(x, s=shift):
        return coset_lde(tbb.to_mont(t(x)), log_blowup, s)

    periodic = torch.stack([
        lde(pat, pow(shift, (1 << log_n) // len(pat), P)).repeat(
            (1 << log_n) // len(pat))
        for pat in Sha256Air().periodic_columns()])
    sel_keys = ("is_first_row", "is_last_row", "is_transition")
    got = tvm(Sha256Air(), lde(trace), lde(perm), challenges, publics, apow,
              {k: tbb.to_mont(t(sels[k])) for k in sel_keys},
              tbb.to_mont(t(sels["inv_z_h"])), periodic, log_blowup)
    assert want.shape == (4 << log_n, 4)
    np.testing.assert_array_equal(tbb.to_numpy(got), want)


def test_grinding_witness_matches_reference(ref, monkeypatch):
    """A port-only prove with pow_bits=4: its witness is the one the JAX
    package's _grind_device picks from the same challenger state, and both
    verifiers accept the proof."""
    seen = {}
    grind = tprover._grind_device

    def spy(ch, pow_bits, device):
        seen["ch"] = ch.clone()
        return grind(ch, pow_bits, device)

    monkeypatch.setattr(tprover, "_grind_device", spy)
    cfg = dict(CFG, pow_bits=4)
    inst = chip_instance_from_reference(ref["inst"])
    proof = tmachine.prove_machine([inst], BINDING, StarkConfig(**cfg),
                                   device="cpu")
    jch = JChallenger()
    jch.state = list(seen["ch"].state)
    jch.input_buf = list(seen["ch"].input_buf)
    jch.output_buf = list(seen["ch"].output_buf)
    assert jgrind(jch, 4) == proof.pow_witness
    assert tmachine.verify_machine([Sha256Air()], proof, BINDING,
                                   ref["msgs"], StarkConfig(**cfg))
    assert jmachine.verify_machine(
        [JSha256Air()], jmachine.MachineProof.from_bytes(proof.to_bytes()),
        BINDING, ref["msgs"], JStarkConfig(**cfg))


def test_entry_points_need_a_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    inst = tmachine.ChipInstance(
        air=Sha256Air(), trace=np.zeros((256, 639), np.uint32), publics=[])
    with pytest.raises(RuntimeError):
        tmachine.prove_machine([inst], BINDING)
