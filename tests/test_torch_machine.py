"""The port's machine STARK against the JAX package's on a one-chip
Sha256Air machine (256 × 639 rows, 2 seeded 100-byte messages with result
tags): byte-identical proofs, each package's verifier accepting the other's
proof and rejecting a tampered digest, and the constraint-VM quotient
equal on the chip's LDE.

The JAX proof costs ~100 s of XLA compilation on the CPU, so it is built
once for the module."""

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
from zktls_tpu_torch.stark.bus import BUS_SHA_RESULT, digest_limbs
from zktls_tpu_torch.stark.chips.sha256 import Sha256Air
from zktls_tpu_torch.stark.chips.sha256 import sha256_trace
from zktls_tpu_torch.stark.config import StarkConfig
from zktls_tpu_torch.stark.verifier import VerificationError

from .torch_threads import torch_threads_per_worker  # noqa: F401

BINDING = b"zktls-tpu-torch machine test"
CFG = dict(log_blowup=2, num_queries=8, pow_bits=0, fri_final_size=16)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's chip, public messages and proof bytes."""
    rng = np.random.default_rng(4404)
    rec = SHA256Recorder()
    digests = [rec.sha256(rng.integers(0, 256, 100, dtype=np.uint8)
                          .tobytes(), result_tag=i + 1) for i in range(2)]
    trace, publics = jsha256_trace(rec.events)
    assert trace.shape == (256, 639)
    inst = jmachine.ChipInstance(air=JSha256Air(), trace=trace,
                                 publics=publics)
    proof = jmachine.prove_machine([inst], binding=BINDING,
                                   config=JStarkConfig(**CFG))
    # payload layout of chips/sha256.py: (tag, 16 digest limbs, xb = 0)
    msgs = [(BUS_SHA_RESULT, [i + 1] + digest_limbs(d) + [0], -1)
            for i, d in enumerate(digests)]
    return {"events": rec.events, "inst": inst, "msgs": msgs,
            "proof": proof.to_bytes()}


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
    """eval_quotient_vm of both packages on the chip's LDE with seeded
    challenges, α powers and bus sum."""
    import jax.numpy as jnp

    from zktls_tpu.ops import ntt as jntt
    from zktls_tpu.stark.config import selector_arrays as jsel
    from zktls_tpu.stark.lowering import eval_quotient_vm as jvm
    from zktls_tpu_torch.stark.lowering import eval_quotient_vm as tvm
    from zktls_tpu_torch.stark.lowering import lower_air

    rng = np.random.default_rng(4405)
    trace = ref["inst"].trace
    log_n, log_blowup, shift = 8, 2, 31
    challenges = [Fp4(*[int(x) for x in rng.integers(0, P, 4)])
                  for _ in range(74)]
    perm = JSha256Air().generate_perm_trace(trace, [], challenges)
    publics = [int(x) for x in rng.integers(0, P, 4)]
    n_c = lower_air(Sha256Air(), 4, 74).n_constraints
    apow = rng.integers(0, P, (n_c, 4), dtype=np.uint32)
    sels = jsel(log_n, log_blowup, shift)
    lde = jntt.coset_lde(jbb.to_mont(jnp.asarray(trace)), log_blowup, shift)
    perm_lde = jntt.coset_lde(jbb.to_mont(jnp.asarray(perm)), log_blowup,
                              shift)
    periodic = np.stack([np.asarray(jnp.tile(jntt.coset_lde(
        jbb.to_mont(jnp.asarray(pat)), log_blowup,
        pow(shift, (1 << log_n) // len(pat), P)), (1 << log_n) // len(pat)))
        for pat in JSha256Air().periodic_columns()])
    sel_keys = ("is_first_row", "is_last_row", "is_transition")
    want = jvm(JSha256Air(), lde, perm_lde, challenges, publics, apow,
               {k: jbb.to_mont(jnp.asarray(sels[k])) for k in sel_keys},
               jbb.to_mont(jnp.asarray(sels["inv_z_h"])),
               jnp.asarray(periodic), log_blowup)

    def t(x):
        return tbb.from_numpy(np.asarray(x))

    got = tvm(Sha256Air(), t(lde), t(perm_lde),
              [TFp4(*c.c) for c in challenges], publics, apow,
              {k: tbb.to_mont(t(sels[k])) for k in sel_keys},
              tbb.to_mont(t(sels["inv_z_h"])), t(periodic), log_blowup)
    np.testing.assert_array_equal(tbb.to_numpy(got), np.asarray(want))


def test_grinding_witness_matches_reference(ref, monkeypatch):
    """A port-only prove with pow_bits=4: its witness is the one the JAX
    package's _grind_device picks from the same challenger state, and both
    verifiers accept the proof."""
    seen = {}
    grind = tmachine._grind_device

    def spy(ch, pow_bits, device):
        seen["ch"] = ch.clone()
        return grind(ch, pow_bits, device)

    monkeypatch.setattr(tmachine, "_grind_device", spy)
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
