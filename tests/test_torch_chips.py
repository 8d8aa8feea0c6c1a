"""The port's chip AIRs and multi-chip machine against the JAX package's:

  * each of the session's twelve AIRs lowers to the same constraint-VM plan
    in both packages, field by field;
  * a three-chip, two-height machine of ported chips — ModMul256Air
    (512 × 324), ModMulRsa2048Air (256 × 3832) and XorTableAir (256 × 1) —
    proved by the port on the CPU, its bus closed by public messages, is
    accepted by both packages' verify_machine, and a tampered message is
    rejected by both;
  * its two ModMul chips' perm traces run as torch ops (the XorTableAir's
    on the host), and the proof's bytes equal those of the same prove
    with every perm trace on the host;
  * the prover raises without a card unless it is given device="cpu".

Exact equality throughout; no JAX prover runs here."""

import dataclasses
import random

import numpy as np
import pytest
import torch

from zktls_tpu.provers.stark import _air_registry as jair_registry
from zktls_tpu.stark import lowering as jlowering
from zktls_tpu.stark import machine as jmachine
from zktls_tpu.stark.config import StarkConfig as JStarkConfig
from zktls_tpu.stark.verifier import VerificationError as JVerificationError
from zktls_tpu_torch.guest.crypto.modmul import ModMulEvent
from zktls_tpu_torch.models.modmul_chip import modmul_instances
from zktls_tpu_torch.stark import lowering as tlowering
from zktls_tpu_torch.stark import machine as tmachine
from zktls_tpu_torch.stark.air import Air
from zktls_tpu_torch.stark.bus import BUS_MODMUL, BUS_XOR, MAX_PAYLOAD
from zktls_tpu_torch.stark.chips import AIRS
from zktls_tpu_torch.stark.chips.modmul import (
    MODULI_256,
    ModMulAir,
    modmul_send_payload,
)
from zktls_tpu_torch.stark.chips.xor_table import (
    XorTableAir,
    xor_table_trace,
    xor_use_counts,
)
from zktls_tpu_torch.stark.config import StarkConfig
from zktls_tpu_torch.stark.verifier import VerificationError

from .torch_threads import torch_threads_per_worker  # noqa: F401

SESSION_CHIPS = ["Sha256Air", "Aes128Air", "GhashAir", "GcmControlAir",
                 "StreamParserAir", "GcmDataAir", "XorTableAir", "KeccakAir",
                 "EcScheduleAir", "KeyScheduleAir", "ModMul256Air",
                 "ModMulRsa2048Air"]
BINDING = b"zktls-tpu-torch multi-chip test"
CFG = dict(log_blowup=2, num_queries=2, pow_bits=0, fri_final_size=16)
#: the machine's challenge vector: γ, then δ^1..δ^MAX_PAYLOAD
N_CHALLENGES = MAX_PAYLOAD + 1


def _same(a, b, where="plan"):
    """Field-by-field equality of two plans (dataclasses, numpy arrays,
    containers, scalars); the class names must match too."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name),
                  f"{where}.{f.name}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}[{k!r}]")
    else:
        assert type(a) is type(b) and a == b, where


@pytest.mark.parametrize("name", SESSION_CHIPS)
def test_lowered_plan_equals_reference(name):
    """(e) lower_air(air, n_public, n_challenges) gives the reference's
    Plan, at the machine's arity (publics + the 4-limb bus sum)."""
    air = AIRS[name]()
    ref_air = jair_registry()[name]()
    n_public = air.num_public + 4
    assert (air.width, air.num_public, air.perm_width) == \
        (ref_air.width, ref_air.num_public, ref_air.perm_width)
    _same(tlowering.lower_air(air, n_public, N_CHALLENGES),
          jlowering.lower_air(ref_air, n_public, N_CHALLENGES))


@pytest.fixture(scope="module")
def multi():
    """The port's CPU proof of a three-chip, two-height machine and the
    public messages that close its bus."""
    rng = random.Random(20261016)
    events = []
    for _ in range(300):
        m = rng.choice(MODULI_256)
        a, b = rng.randrange(m), rng.randrange(m)
        events.append(ModMulEvent(a, b, a * b % m, m))
    rsa_m = (1 << 2047) | rng.getrandbits(2047) | 1
    for _ in range(2):
        a, b = rng.randrange(rsa_m), rng.randrange(rsa_m)
        events.append(ModMulEvent(a, b, a * b % rsa_m, rsa_m))
    sent = events[2]
    key = (sent.a, sent.b, sent.r, sent.m)
    chips = modmul_instances(events, sends={key: 1})
    pairs = [(rng.randrange(16), rng.randrange(16)) for _ in range(20)]
    xor_trace, _ = xor_table_trace(xor_use_counts(pairs))
    chips.append(tmachine.ChipInstance(air=XorTableAir(), trace=xor_trace,
                                       publics=[]))
    msgs = [(BUS_MODMUL, modmul_send_payload(*key), -1)]
    msgs += [(BUS_XOR, [x, y, x ^ y], -1) for x, y in pairs]
    tmachine.reset_perm_trace_paths()
    proof = tmachine.prove_machine(chips, BINDING, StarkConfig(**CFG),
                                   device="cpu").to_bytes()
    return {"chips": chips, "msgs": msgs, "proof": proof,
            "perm_trace_paths": dict(tmachine.perm_trace_paths)}


def _tampered(msgs):
    tag, payload, mult = msgs[0]
    return [(tag, payload[:1] + [payload[1] ^ 1] + payload[2:], mult)] \
        + msgs[1:]


def test_multi_chip_machine_shape(multi):
    shapes = {c.air.name: c.trace.shape for c in multi["chips"]}
    assert shapes == {"ModMul256Air": (512, 324),
                      "ModMulRsa2048Air": (256, 3832),
                      "XorTableAir": (256, 1)}
    mp = tmachine.MachineProof.from_bytes(multi["proof"])
    # canonical order: the tallest chip first, ties by name
    assert [(c.name, c.log_n) for c in mp.chips] == [
        ("ModMul256Air", 9), ("ModMulRsa2048Air", 8), ("XorTableAir", 8)]


def test_multi_chip_port_verifier(multi):
    """(f) the port's verify_machine accepts the proof and rejects a
    tampered message."""
    airs = [c.air for c in multi["chips"]]
    cfg = StarkConfig(**CFG)
    mp = tmachine.MachineProof.from_bytes(multi["proof"])
    assert tmachine.verify_machine(airs, mp, BINDING, multi["msgs"], cfg)
    with pytest.raises(VerificationError, match="bus imbalance"):
        tmachine.verify_machine(airs, mp, BINDING, _tampered(multi["msgs"]),
                                cfg)


def test_multi_chip_reference_verifier(multi):
    """(f) the JAX package's verify_machine accepts the port's proof and
    rejects a tampered message."""
    registry = jair_registry()
    airs = [registry[c.air.name]() for c in multi["chips"]]
    cfg = JStarkConfig(**CFG)
    mp = jmachine.MachineProof.from_bytes(multi["proof"])
    assert jmachine.verify_machine(airs, mp, BINDING, multi["msgs"], cfg)
    with pytest.raises(JVerificationError, match="bus imbalance"):
        jmachine.verify_machine(airs, mp, BINDING, _tampered(multi["msgs"]),
                                cfg)


def test_multi_chip_perm_trace_paths(multi):
    """(h) the two ModMul chips' perm traces ran as torch ops, the
    XorTableAir's on the host."""
    assert multi["perm_trace_paths"] == {"device": 2, "host": 1}


def test_multi_chip_host_perm_traces_same_bytes(multi, monkeypatch):
    """(h) with ModMulAir's torch perm trace taken away, every chip's perm
    trace runs on the host and the proof's bytes are the same."""
    monkeypatch.setattr(ModMulAir, "perm_trace_m", Air.perm_trace_m)
    tmachine.reset_perm_trace_paths()
    proof = tmachine.prove_machine(multi["chips"], BINDING,
                                   StarkConfig(**CFG), device="cpu")
    assert tmachine.perm_trace_paths == {"device": 0, "host": 3}
    assert proof.to_bytes() == multi["proof"]


def test_prover_needs_a_card_or_cpu(monkeypatch):
    """(g) without a card prove_machine raises unless it is given
    device="cpu" (which the fixture above proves with)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    trace, _ = xor_table_trace()
    inst = tmachine.ChipInstance(air=XorTableAir(), trace=trace, publics=[])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmachine.prove_machine([inst], BINDING, StarkConfig(**CFG))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmachine.prove_machine([inst], BINDING, StarkConfig(**CFG),
                               device="cuda")
