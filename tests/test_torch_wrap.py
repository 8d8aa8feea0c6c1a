"""The port's wraps against the JAX package's: the journal seal
(snark/wrap.py), the exported verifier (verifier_export.py), the
STARK-verifier circuit (snark/stark_wrap.py) and the statement wiring of
`StarkGuestProver.wrap` / `verify_wrapped`.

The journal wrap: the port's `wrap_setup().vk()` equals its bundled
wrap_vk.json (one setup, in a module fixture), and the JAX package's
`wrap_verify` and `simulate_zktls_verify` accept the port's seal of a
committed session's journal and reject it against a changed journal.  The
export: the port's `export_verifier` files equal the JAX package's, and
the bundled vk is used only when its circuit parameters match.  The
STARK-verifier circuit (tests/test_stark_wrap.py:24-88): the port's BN
machine proof of Fibonacci(5) equals the JAX package's committed bytes,
and the circuit built over it has the reference's constraints and
assignment (150,312 constraints, 147,714 variables); both packages'
circuits refuse the reference's tampers.  The chain's seal: a Groth16
proof over a small circuit whose one public input is the statement digest
of the tiny chain (its compress and shrink vks, the JAX package's,
committed in data/fib_chain_vks.jax.cbor) and a session journal, made by
either package, is accepted by both packages' `verify_wrapped` and
rejected against a changed journal; `wrap` with its recursion and circuit
stubbed wires the statement that `verify_wrapped` checks.  The full chain
is not wrapped here: the reference's circuit over even the tiny chain's
shrink proof outgrows the host's memory."""

import hashlib
import json
import random
from pathlib import Path

import pytest

import chip_smoke
from zktls_tpu.provers import stark as jstark
from zktls_tpu.snark import groth16 as jg16
from zktls_tpu.snark import stark_wrap as jsw
from zktls_tpu.snark import wrap as jwrap
from zktls_tpu.snark.r1cs import R1CS as JR1CS
from zktls_tpu.models.fibonacci import FibonacciAir as JFibonacciAir
from zktls_tpu.stark import recursion as jrec
from zktls_tpu.stark.config import StarkConfig as JStarkConfig
from zktls_tpu.stark.machine_bn import MachineProofBN as JMachineProofBN
from zktls_tpu.verifier_export import export_verifier as jexport
from zktls_tpu.verifier_export import simulate_zktls_verify as jsimulate
from zktls_tpu_torch import verifier_export
from zktls_tpu_torch.core import cbor
from zktls_tpu_torch.core.types import GuestInput
from zktls_tpu_torch.guest.program import run_guest
from zktls_tpu_torch.models.fibonacci import FibonacciAir
from zktls_tpu_torch.provers import stark as tstark
from zktls_tpu_torch.snark import groth16 as g16
from zktls_tpu_torch.snark import stark_wrap as sw
from zktls_tpu_torch.snark import wrap
from zktls_tpu_torch.snark.r1cs import R1CS
from zktls_tpu_torch.stark import recursion as rec
from zktls_tpu_torch.stark.config import StarkConfig
from zktls_tpu_torch.stark.machine_bn import MachineProofBN, prove_machine_bn
from zktls_tpu_torch.workload import (
    FIB_CHAIN_VKS_REFERENCE,
    SESSIONS,
    SNARKS,
    WRAP_BN_REFERENCE,
    r1cs_digests,
    wrap_bn_machine,
)

from .torch_threads import (  # noqa: F401
    mimc_threads_per_worker,
    torch_threads_per_worker,
)

#: SHA-256 of the committed JAX vks of the tiny chain
FIB_CHAIN_VKS_SHA256 = (
    "6cc9327b6342c894599413807c36f40dc612e12915781d8c1ff2db90d2e97923")


@pytest.fixture(scope="module")
def journal() -> bytes:
    """The c02f session's journal (the port's replay; 1,056 bytes)."""
    gi = GuestInput.from_cbor(SESSIONS["c02f"].guest_input.read_bytes())
    return run_guest(gi, require_trust_anchor=False).journal


def _changed(journal: bytes) -> bytes:
    """The journal with its first filtered response byte flipped."""
    return chip_smoke._tamper_filtered(journal)[0]


# ---------------------------------------------------------------------------
# the journal wrap and the exported verifier
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def journal_keys():
    return wrap.wrap_setup()


def test_wrap_setup_vk_equals_the_bundled_vk(journal_keys):
    bundled = json.loads((Path(wrap.__file__).parent
                          / "wrap_vk.json").read_text())
    ref = json.loads((Path(jwrap.__file__).parent
                      / "wrap_vk.json").read_text())
    assert bundled == ref
    assert bundled["circuit"] == wrap.wrap_circuit_params()
    vk = json.loads(json.dumps(journal_keys.vk()))
    assert {k: bundled[k] for k in vk} == vk
    assert journal_keys.n_public == 1


def test_journal_seal_is_accepted_by_the_reference(journal_keys, journal):
    vk = journal_keys.vk()
    digest, seal = wrap.wrap_prove(journal_keys, journal)
    assert len(journal) == SESSIONS["c02f"].journal_bytes
    assert len(seal) == 256
    assert digest == jwrap.journal_digest_fr(journal)
    for verify in (wrap.wrap_verify, jwrap.wrap_verify):
        assert verify(vk, digest, seal)
        assert not verify(vk, digest + 1, seal)
    bad = _changed(journal)
    for simulate in (verifier_export.simulate_zktls_verify, jsimulate):
        assert simulate(vk, journal, seal)
        assert not simulate(vk, bad, seal)


@pytest.mark.parametrize("target", ["evm", "solana"])
def test_exported_files_equal_the_reference(target, tmp_path):
    mine = verifier_export.export_verifier(target, tmp_path / "port")
    ref = jexport(target, tmp_path / "ref")
    assert [f.name for f in mine] == [f.name for f in ref]
    for m, r in zip(mine, ref):
        assert m.read_bytes() == r.read_bytes(), m.name


def test_bundled_vk_param_gate(tmp_path, monkeypatch):
    """The bundled wrap_vk.json is used only when its circuit parameters
    match the live circuit; otherwise export runs wrap_setup()."""
    def boom(*a, **k):
        raise AssertionError("wrap_setup must not run when bundle matches")

    monkeypatch.setattr(wrap, "wrap_setup", boom)
    verifier_export.export_verifier("evm", tmp_path)
    raw = json.loads((tmp_path / "vk.json").read_text())
    assert raw["circuit"] == wrap.wrap_circuit_params()
    vk = {"alpha1": tuple(raw["alpha1"]),
          "beta2": (tuple(raw["beta2"][0]), tuple(raw["beta2"][1])),
          "gamma2": (tuple(raw["gamma2"][0]), tuple(raw["gamma2"][1])),
          "delta2": (tuple(raw["delta2"][0]), tuple(raw["delta2"][1])),
          "ic": [tuple(p) for p in raw["ic"]]}
    called = []

    class FakeKeys:
        def vk(self):
            called.append(True)
            return vk

    monkeypatch.setattr(wrap, "wrap_circuit_params",
                        lambda seed=b"zktls-wrap-v1": {"max_chunks": -1})
    monkeypatch.setattr(wrap, "wrap_setup", lambda *a, **k: FakeKeys())
    verifier_export.export_verifier("evm", tmp_path / "stale")
    assert called == [True]


# ---------------------------------------------------------------------------
# the STARK-verifier circuit over a BN machine proof (path a)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def wrap_bn():
    """The port's CPU proof of the wrap_bn machine, the JAX package's
    committed proof, and both packages' circuits over them."""
    chips, binding, cfg_kw = wrap_bn_machine()
    cfg = StarkConfig(**cfg_kw)
    blob = prove_machine_bn(chips, binding, cfg, device="cpu").to_bytes()
    jblob = WRAP_BN_REFERENCE.read_bytes()
    cs = sw.build_stark_wrap_circuit([FibonacciAir()],
                                     MachineProofBN.from_bytes(blob),
                                     binding, [], cfg, {})
    jcs = jsw.build_stark_wrap_circuit([JFibonacciAir()],
                                       JMachineProofBN.from_bytes(jblob),
                                       binding, [], JStarkConfig(**cfg_kw),
                                       {})
    return blob, jblob, cs, jcs


def test_bn_proof_equals_the_committed_reference(wrap_bn):
    blob, jblob, _, _ = wrap_bn
    assert hashlib.sha256(jblob).hexdigest() == \
        SNARKS["wrap_bn"].digests["proof"]
    assert blob == jblob


def test_wrap_bn_circuit_equals_the_reference(wrap_bn):
    _, _, cs, jcs = wrap_bn
    spec = SNARKS["wrap_bn"]
    assert (len(cs.constraints), cs.n_vars, cs.n_public) == \
        (len(jcs.constraints), jcs.n_vars, jcs.n_public) == \
        (spec.constraints, spec.variables, 1)
    assert cs.assignment()[1] == sw.statement_digest_fr(b"fib-wrap", [], {})
    assert cs.assignment() == jcs.assignment()
    assert cs.constraints == jcs.constraints
    assert cs.check()
    digests = r1cs_digests(cs)
    assert digests == {k: spec.digests[k]
                       for k in ("assignment", "constraints")}


def test_wrap_bn_circuit_rejects_tampered_assignment(wrap_bn):
    """Constraint-level soundness probe (tests/test_stark_wrap.py:44-60):
    a changed witness value violates some constraint in both packages'
    circuits."""
    _, _, cs, jcs = wrap_bn
    rng = random.Random(7)
    for _ in range(5):
        idx = rng.randrange(2, cs.n_vars)
        for c in (cs, jcs):
            old = c._assignment[idx]
            c._assignment[idx] = (old + 1) % (2**61)
            try:
                assert not c.check(), f"tampered wire {idx} still satisfies"
            finally:
                c._assignment[idx] = old


def test_wrap_bn_circuit_refuses_a_tampered_proof(wrap_bn):
    """Both builders re-run the verifier over the witness: a changed
    opened value fails their asserts."""
    blob, _, _, _ = wrap_bn
    _, binding, cfg_kw = wrap_bn_machine()
    bad = MachineProofBN.from_bytes(blob)
    bad.queries[0].openings[0].trace_row[0] ^= 1
    with pytest.raises(AssertionError):
        sw.build_stark_wrap_circuit([FibonacciAir()], bad, binding, [],
                                    StarkConfig(**cfg_kw), {})
    jbad = JMachineProofBN.from_bytes(bad.to_bytes())
    with pytest.raises(AssertionError):
        jsw.build_stark_wrap_circuit([JFibonacciAir()], jbad, binding, [],
                                     JStarkConfig(**cfg_kw), {})


# ---------------------------------------------------------------------------
# the chain's seal: StarkGuestProver.wrap / verify_wrapped
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def chain_vks() -> dict:
    raw = FIB_CHAIN_VKS_REFERENCE.read_bytes()
    assert hashlib.sha256(raw).hexdigest() == FIB_CHAIN_VKS_SHA256
    return cbor.loads(raw)


def _reference_statement(journal: bytes, vks: dict) -> int:
    """The JAX package's statement digest of (journal, chain vks), as its
    verify_wrapped recomputes it."""
    vk_a = jrec.RecursionVK.from_bytes(vks["vk_a"])
    vk_b = jrec.RecursionVKBN.from_bytes(vks["vk_b"])
    msgs = jstark.journal_public_messages(journal)
    a_binding = journal + vk_a.shape.to_bytes()
    a_msgs = jrec._session_messages(vk_a.shape, journal, msgs)
    b_msgs = jrec._session_messages(
        vk_b.shape, a_binding, a_msgs,
        dict((n, list(r)) for n, r in vk_b.inner_preprocessed_roots))
    return jsw.statement_digest_fr(a_binding + vk_b.shape.to_bytes(),
                                   b_msgs, {"VmAir": vk_b.program_root})


def _statement_circuit(cls, stmt: int):
    """One public input (stmt), a witness equal to it and 70 squarings:
    enough variables that Groth16 runs through the C library."""
    cs = cls()
    p = cs.public_input(stmt)
    w = cs.witness(stmt)
    cs.enforce_eq({w: 1}, {p: 1})
    for i in range(70):
        w = cs.mul({w: 1, 0: i}, {w: 1, 0: i})
    return cs


def _verdicts(journal: bytes, blob: bytes) -> list[bool]:
    return [tstark.StarkGuestProver(device="cpu").verify_wrapped(journal,
                                                                 blob),
            jstark.StarkGuestProver().verify_wrapped(journal, blob)]


@pytest.mark.parametrize("maker", ["port", "JAX package"])
def test_verify_wrapped_accepts_a_seal_of_the_chain_statement(
        maker, journal, chain_vks):
    stmt = _reference_statement(journal, chain_vks)
    mod, r1cs, jsonable = ((g16, R1CS, tstark._vk_jsonable)
                           if maker == "port" else
                           (jg16, JR1CS, jstark._vk_jsonable))
    cs = _statement_circuit(r1cs, stmt)
    keys = mod.setup(cs, seed=b"zktls-stark-wrap-v1")
    seal = mod.prove(keys, cs, randomness=b"chain seal").to_bytes()
    blob = cbor.dumps({"vk_a": chain_vks["vk_a"], "vk_b": chain_vks["vk_b"],
                       "g16": seal,
                       "g16_vk": cbor.dumps(jsonable(keys.vk()))})
    assert _verdicts(journal, blob) == [True, True]
    assert _verdicts(_changed(journal), blob) == [False, False]


def test_wrap_wires_the_statement_that_verify_wrapped_checks(
        journal, chain_vks, monkeypatch):
    """`wrap` with the recursion rungs returning the chain's vks and the
    circuit builder stubbed (it records its statement and returns a small
    circuit with that statement digest, computed by the JAX package, as
    its public input): the compress gets the session's statement and the
    prover's device, the shrink the compress vk's statement and root, and
    both packages' verify_wrapped accept the blob."""
    vk_a = rec.RecursionVK.from_bytes(chain_vks["vk_a"])
    vk_b = rec.RecursionVKBN.from_bytes(chain_vks["vk_b"])
    seen = {}

    class _Proof:
        @staticmethod
        def from_bytes(data):
            seen["inner"] = data
            return "inner proof"

    def recursion_prove(airs, mp, binding, public_messages, inner_config,
                        timings, device, spill_bytes, chunked_deep_bytes):
        seen["compress"] = (airs, mp, binding, public_messages, device,
                            spill_bytes, chunked_deep_bytes)
        return vk_a, "compress proof"

    def recursion_prove_bn(airs, proof, binding, public_messages,
                           inner_config, outer_config,
                           inner_preprocessed_roots, timings, device):
        seen["shrink"] = (proof, binding, public_messages,
                          inner_preprocessed_roots, device)
        return vk_b, "shrink proof"

    def build_stark_wrap_circuit(airs, proof, binding, msgs, cfg, roots):
        seen["circuit"] = (proof, binding, msgs, roots)
        return _statement_circuit(R1CS, jsw.statement_digest_fr(
            binding, msgs, roots))

    monkeypatch.setattr(tstark, "MachineProof", _Proof)
    monkeypatch.setattr(tstark, "journal_airs", lambda j, mp: ["airs"])
    monkeypatch.setattr(rec, "recursion_prove", recursion_prove)
    monkeypatch.setattr(rec, "recursion_prove_bn", recursion_prove_bn)
    monkeypatch.setattr(sw, "build_stark_wrap_circuit",
                        build_stark_wrap_circuit)
    prover = tstark.StarkGuestProver(device="cpu")
    timings: dict = {}
    blob = prover.wrap(journal, b"machine proof", timings=timings,
                       spill_bytes=1.0, chunked_deep_bytes=2.0)
    msgs = tstark.journal_public_messages(journal)
    assert seen["inner"] == b"machine proof"
    assert seen["compress"] == (["airs"], "inner proof", journal, msgs,
                                prover.device, 1.0, 2.0)
    a_binding = journal + vk_a.shape.to_bytes()
    assert seen["shrink"][:2] == ("compress proof", a_binding)
    assert seen["shrink"][3:] == ({"VmAir": list(vk_a.program_root)},
                                  prover.device)
    assert seen["circuit"][0] == "shrink proof"
    assert seen["circuit"][3] == {"VmAir": vk_b.program_root}
    assert set(timings) == {"compress_s", "shrink_s", "wrap_circuit_s",
                            "wrap_constraints", "groth16_s"}
    obj = cbor.loads(blob)
    assert (obj["vk_a"], obj["vk_b"]) == (chain_vks["vk_a"],
                                          chain_vks["vk_b"])
    assert _verdicts(journal, blob) == [True, True]
    assert _verdicts(_changed(journal), blob) == [False, False]
