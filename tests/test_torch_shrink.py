"""The port's shrink rung (stark/commit_bn.py, stark/machine_bn.py, the
BN254 half of stark/recursion.py) against the JAX package's.

Commitments: `pack_row` and `_pack_matrix_limbs`, `MimcTree` roots and
openings (through the C library and the pure-Python plain version),
`verify_path_bn`, an `FrChallenger` transcript and `grind_bn` equal the
reference's.  The machine: `prove_machine_bn` on the small Fibonacci +
FixedMulAir (preprocessed) machine with 4 grinding bits gives the JAX
package's bytes (committed as `workload.BN_MACHINE_REFERENCE`, pinned by
digest here, made and checked live by scripts/session_proof_cpu.py
--machine bn --reference) and `preprocessed_root_bn` its root; each package's
`verify_machine_bn` accepts the other's proof and both reject a changed
root, public value or opening.  The slice: tests/test_shrink_bn.py's chain
(Fibonacci(5) → compress → shrink, `workload.fib_chain`) shrunk by the
port on the CPU — its program equals the JAX `build_program` instruction
for instruction, its `RecursionVKBN` the JAX vk (root from the JAX
`preprocessed_root_bn`), its proof's SHA-256 the JAX package's digest
pinned in chip_smoke.py (made by scripts/session_proof_cpu.py --shrink
fib); the JAX `recursion_verify_bn` accepts it; both verifiers reject a
changed binding, vk root and opening, and both provers refuse a forged
compress root.  No JAX proof of a VmAir-sized machine is made here.
Seeded inputs, exact equality."""

import hashlib

import numpy as np
import pytest

import chip_smoke
from zktls_tpu.models.fibonacci import FibonacciAir as JFibonacciAir
from zktls_tpu.ops.field_ref import Fp4 as JFp4
from zktls_tpu.stark import commit_bn as jcommit
from zktls_tpu.stark import machine_bn as jmbn
from zktls_tpu.stark import recursion as jrec
from zktls_tpu.stark.chips.vm import VmAir as JVmAir
from zktls_tpu.stark.config import StarkConfig as JStarkConfig
from zktls_tpu.stark.machine import MachineProof as JMachineProof
from zktls_tpu.stark.verifier import VerificationError as JVerificationError
from zktls_tpu_torch.models.fibonacci import FibonacciAir
from zktls_tpu_torch.ops.field_ref import Fp4, P
from zktls_tpu_torch.stark import commit_bn
from zktls_tpu_torch.stark import recursion as rec
from zktls_tpu_torch.stark.chips.vm import vm_preprocessed
from zktls_tpu_torch.stark.config import StarkConfig
from zktls_tpu_torch.stark.machine import (
    preprocessed_root,
    prove_machine,
    verify_machine,
)
from zktls_tpu_torch.stark.machine_bn import (
    MachineProofBN,
    preprocessed_root_bn,
    prove_machine_bn,
    verify_machine_bn,
)
from zktls_tpu_torch.stark.verifier import VerificationError
from zktls_tpu_torch.utils import native
from zktls_tpu_torch.workload import (
    BN_MACHINE_BINDING,
    BN_MACHINE_CONFIG,
    BN_MACHINE_LOG_N,
    BN_MACHINE_REFERENCE,
    FIB_CHAIN_BINDING,
    FIB_CHAIN_CONFIG,
    FixedMulAir,
    fib_chain,
    preprocessed_machine,
    shrink_statement,
)

from .test_torch_preprocessed import JFixedMulAir
from .test_torch_recursion import _assert_same_program
from .torch_threads import (  # noqa: F401
    mimc_threads_per_worker,
    torch_threads_per_worker,
)

CHAIN_CFG, JCHAIN_CFG = (StarkConfig(**FIB_CHAIN_CONFIG),
                         JStarkConfig(**FIB_CHAIN_CONFIG))
CFG, JCFG = (StarkConfig(**BN_MACHINE_CONFIG),
             JStarkConfig(**BN_MACHINE_CONFIG))
BINDING = BN_MACHINE_BINDING
LOG_N = BN_MACHINE_LOG_N
#: SHA-256 of the committed JAX proof (BN_MACHINE_REFERENCE)
BN_MACHINE_REFERENCE_SHA256 = (
    "2d9b6ccc8b185236864eee05bafea4f2dc3054fe3de6ed2a067e81a0bb867bf3")


def _matrix(n: int, w: int, seed: int) -> np.ndarray:
    m = np.random.default_rng(seed).integers(0, P, (n, w), dtype=np.uint32)
    m[0] = 0
    if n > 1:
        m[1] = P - 1
    return m


# ---------------------------------------------------------------------------
# commitments
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("w", [1, 6, 7, 8, 24, 40])
def test_packing_equals_the_reference(w):
    m = _matrix(9, w, seed=w)
    for row in m:
        vals = [int(v) for v in row]
        assert commit_bn.pack_row(vals) == jcommit.pack_row(vals)
    np.testing.assert_array_equal(commit_bn._pack_matrix_limbs(m),
                                  jcommit._pack_matrix_limbs(m))


@pytest.mark.parametrize("n,w", [(2, 3), (16, 9), (32, 24)])
@pytest.mark.parametrize("use_c", [True, False])
def test_mimc_tree_equals_the_reference(n, w, use_c):
    """Roots and openings of the C route and of the pure-Python plain
    version equal the reference's tree (its C library) on the same plain
    matrix; verify_path_bn accepts and rejects as the reference's."""
    m = _matrix(n, w, seed=100 * n + w)
    tree, ref = commit_bn.MimcTree(m, native=use_c), jcommit.MimcTree(m)
    assert tree.root == ref.root
    for j in sorted({0, n // 2, n - 1}):
        path = tree.open(j)
        assert path == ref.open(j)
        leaf = commit_bn.leaf_digest([int(v) for v in m[j]])
        assert leaf == jcommit.leaf_digest([int(v) for v in m[j]])
        assert commit_bn.verify_path_bn(leaf, j, path, tree.root)
        assert jcommit.verify_path_bn(leaf, j, path, tree.root)
        bad = list(path)
        bad[-1] = (bad[-1] + 1) % commit_bn.R_BN
        assert not commit_bn.verify_path_bn(leaf, j, bad, tree.root)
        assert not jcommit.verify_path_bn(leaf, j, bad, tree.root)
        assert not commit_bn.verify_path_bn(leaf, j ^ 1, path, tree.root)


def _transcript(ch, fp4, seed: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for step in range(30):
        ch.observe_many(int(v) for v in rng.integers(0, P, step % 9))
        if step % 3 == 0:
            ch.observe_bytes(rng.bytes(step * 5))
        if step % 4 == 1:
            ch.observe_fr(int.from_bytes(rng.bytes(32), "big"))
        ch.observe_ext(fp4(*[int(v) for v in rng.integers(0, P, 4)]))
        out.append(ch.sample_fr())
        out.append(ch.sample_ext().c)
        out.append(ch.sample_bits(1 + step % 30))
    out.append(ch.check_witness(0, 77))
    out.append(ch.copy().h)
    return out


def test_fr_challenger_transcript_equals_the_reference():
    assert _transcript(commit_bn.FrChallenger(), Fp4, 31) == \
        _transcript(jcommit.FrChallenger(), JFp4, 31)


def test_grind_bn_equals_the_reference():
    ch, jch = commit_bn.FrChallenger(), jcommit.FrChallenger()
    for c in (ch, jch):
        c.observe_bytes(b"grind")
        c.observe_many([1, 2, 3])
    w = commit_bn.grind_bn(ch, 4)
    assert w == jcommit.grind_bn(jch, 4)
    assert ch.copy().check_witness(4, w)
    assert not any(ch.copy().check_witness(4, v) for v in range(w))


# ---------------------------------------------------------------------------
# the BN-committed machine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def machine():
    """The port's and the JAX package's proofs of the same small
    preprocessed machine (the latter the committed bytes of its
    prove_machine_bn), and the FixedMulAir vk root."""
    chips, pre = preprocessed_machine(LOG_N)
    proof = prove_machine_bn(chips, BINDING, CFG, device="cpu")
    root = preprocessed_root_bn(FixedMulAir(), pre, LOG_N, LOG_N, CFG,
                                device="cpu")
    return (proof.to_bytes(), BN_MACHINE_REFERENCE.read_bytes(), pre,
            root)


def test_committed_reference_bn_proof_is_pinned(machine):
    """The committed JAX bytes are the ones its prove_machine_bn gave (the
    digest the live regeneration printed) for this machine's shapes and
    publics, and both packages parse and re-encode them unchanged."""
    _, jblob, pre, _ = machine
    assert hashlib.sha256(jblob).hexdigest() == BN_MACHINE_REFERENCE_SHA256
    jproof = jmbn.MachineProofBN.from_bytes(jblob)
    assert jproof.to_bytes() == jblob
    assert MachineProofBN.from_bytes(jblob).to_bytes() == jblob
    chips, _ = preprocessed_machine(LOG_N)
    assert [(c.name, c.log_n, c.publics) for c in jproof.chips] == [
        (c.air.name, c.trace.shape[0].bit_length() - 1,
         [int(v) for v in c.publics]) for c in chips]
    assert len(jproof.queries) == CFG.num_queries


def test_prove_machine_bn_equals_the_reference(machine):
    blob, jblob, _, _ = machine
    assert blob == jblob
    proof = MachineProofBN.from_bytes(blob)
    assert proof.to_bytes() == blob
    assert [c.name for c in proof.chips] == ["FixedMulAir", "FibonacciAir"]


def test_preprocessed_root_bn_equals_the_reference(machine):
    _, _, pre, root = machine
    assert root == jmbn.preprocessed_root_bn(JFixedMulAir(), pre, LOG_N,
                                             LOG_N, JCFG)
    assert preprocessed_root_bn(FixedMulAir(), pre, LOG_N + 1, LOG_N, CFG,
                                device="cpu") == jmbn.preprocessed_root_bn(
        JFixedMulAir(), pre, LOG_N + 1, LOG_N, JCFG)


def _verify_both(blob: bytes, roots: dict, binding: bytes = BINDING):
    """Each package's verify_machine_bn on the same bytes: (port outcome,
    JAX outcome), each True or the exception's class."""
    out = []
    for verify, parse, airs, cfg in (
            (verify_machine_bn, MachineProofBN.from_bytes,
             [FixedMulAir(), FibonacciAir()], CFG),
            (jmbn.verify_machine_bn, jmbn.MachineProofBN.from_bytes,
             [JFixedMulAir(), JFibonacciAir()], JCFG)):
        try:
            out.append(verify(airs, parse(blob), binding, config=cfg,
                              preprocessed_roots=roots))
        except (VerificationError, JVerificationError) as e:
            out.append(type(e))
    return out


def test_each_verify_machine_bn_accepts_the_other_and_rejects_tampers(
        machine):
    blob, jblob, _, root = machine
    vk = {"FixedMulAir": root}
    assert _verify_both(blob, vk) == [True, True]
    assert _verify_both(jblob, vk) == [True, True]
    rejected = [VerificationError, JVerificationError]
    assert _verify_both(blob, {"FixedMulAir": root ^ 1}) == rejected
    assert _verify_both(blob, {}) == rejected
    assert _verify_both(blob, vk, BINDING + b"!") == rejected
    bad = MachineProofBN.from_bytes(blob)
    bad.chips[1].publics[2] = (bad.chips[1].publics[2] + 1) % P
    assert _verify_both(bad.to_bytes(), vk) == rejected
    bad = MachineProofBN.from_bytes(blob)
    bad.queries[0].openings[0].trace_row[0] ^= 1
    assert _verify_both(bad.to_bytes(), vk) == rejected


@pytest.mark.parametrize("scheme", ["poseidon2", "mimc"])
def test_machine_verifier_rejects_a_duplicated_air_and_a_stray_pre_path(
        machine, scheme):
    """The machine verifier, under either commitment: an air list naming a
    chip twice is refused, and so is a preprocessed path opened on a chip
    without preprocessed columns."""
    if scheme == "mimc":
        blob, _, _, root = machine
        proof, verify = MachineProofBN.from_bytes(blob), verify_machine_bn
    else:
        chips, pre = preprocessed_machine(LOG_N)
        proof = prove_machine(chips, BINDING, CFG, device="cpu")
        root = preprocessed_root(FixedMulAir(), pre, LOG_N, LOG_N, CFG,
                                 device="cpu")
        verify = verify_machine
    airs, vk = [FixedMulAir(), FibonacciAir()], {"FixedMulAir": root}
    assert verify(airs, proof, BINDING, config=CFG, preprocessed_roots=vk)
    with pytest.raises(VerificationError, match="duplicate airs"):
        verify(airs + [FibonacciAir()], proof, BINDING, config=CFG,
               preprocessed_roots=vk)
    names = [c.name for c in proof.chips]
    fixed, fib = (proof.queries[0].openings[names.index(n)]
                  for n in ("FixedMulAir", "FibonacciAir"))
    fib.pre_path = list(fixed.pre_path)
    with pytest.raises(VerificationError, match="bad preprocessed row"):
        verify(airs, proof, BINDING, config=CFG, preprocessed_roots=vk)


# ---------------------------------------------------------------------------
# the slice: tests/test_shrink_bn.py's chain shrunk by the port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def chain():
    """The port's tiny chain on the CPU: compress vk and proof, the shrink
    statement, the shrink vk and proof bytes."""
    _, vk_a, proof_a = fib_chain("cpu")
    a_binding, a_msgs, roots = shrink_statement(vk_a, FIB_CHAIN_BINDING, [])
    vk_b, proof_b = rec.recursion_prove_bn(
        rec.outer_airs(), proof_a, a_binding, a_msgs, CHAIN_CFG, CHAIN_CFG,
        inner_preprocessed_roots=roots, device="cpu")
    return {"vk_a": vk_a, "proof_a": proof_a, "binding": a_binding,
            "msgs": a_msgs, "roots": roots, "vk_b": vk_b,
            "blob": proof_b.to_bytes()}


@pytest.fixture(scope="module")
def programs(chain):
    """Both packages' strict build of the shrink program."""
    shape = rec.MachineShape.of(chain["proof_a"])
    mine = rec.build_program(rec.outer_airs(), shape, chain["binding"],
                             chain["msgs"], CHAIN_CFG, proof=chain["proof_a"],
                             preprocessed_roots=chain["roots"])
    jproof = JMachineProof.from_bytes(chain["proof_a"].to_bytes())
    ref = jrec.build_program(jrec.outer_airs(), jrec.MachineShape.of(jproof),
                             chain["binding"], chain["msgs"], JCHAIN_CFG,
                             proof=jproof, preprocessed_roots=chain["roots"])
    return mine, ref


def test_shrink_program_equals_the_reference(chain, programs):
    mine, ref = programs
    _assert_same_program(mine, ref)
    assert chain["vk_b"].n_instrs == len(mine.instrs) > 100_000
    assert chain["vk_b"].n_pubs == len(mine.pub_values)


class _PortMimc:
    """The port's MiMC library behind the JAX package's `get_native()`
    interface (its two MiMC methods)."""

    mimc_hash_rows = staticmethod(native.mimc_hash_rows)
    mimc_compress_pairs = staticmethod(native.mimc_compress_pairs)


def test_shrink_vk_equals_the_reference(chain, programs, monkeypatch):
    """RecursionVKBN bytes equal a JAX RecursionVKBN whose root the JAX
    preprocessed_root_bn derives from the same program matrix (its LDE,
    packing and tree).  Its MiMC hashes run in the port's library here:
    the reference's scalar C took ~90 s for these 2.6e6 permutations on
    one loaded worker.  So this test alone does not hold the root to an
    independent hash: test_each_recursion_verify_bn_accepts_the_shrink
    does, where the JAX recursion_verify_bn checks the proof's openings
    against this vk's root with the reference's own MiMC, and so does the
    pinned proof digest, made with the reference's library end to end;
    test_torch_native.py holds the two libraries equal."""
    monkeypatch.setattr(jcommit, "get_native", lambda: _PortMimc())
    vk, (mine, _) = chain["vk_b"], programs
    pre = vm_preprocessed(mine.instrs)
    log_n_vm = pre.shape[0].bit_length() - 1
    assert max(c.log_n for c in MachineProofBN.from_bytes(
        chain["blob"]).chips) == log_n_vm
    jvk = jrec.RecursionVKBN(
        shape=jrec.MachineShape.from_bytes(vk.shape.to_bytes()),
        program_root=jmbn.preprocessed_root_bn(JVmAir(), pre, log_n_vm,
                                               log_n_vm, JCHAIN_CFG),
        inner_preprocessed_roots=vk.inner_preprocessed_roots,
        n_instrs=len(mine.instrs), n_pubs=len(mine.pub_values))
    assert vk.to_bytes() == jvk.to_bytes()
    assert rec.RecursionVKBN.from_bytes(vk.to_bytes()) == vk


def test_shrink_proof_is_the_reference_digest(chain):
    """The JAX package's recursion_prove_bn of this chain hashes to
    chip_smoke.SHRINK_PROOF_SHA256 (scripts/session_proof_cpu.py --shrink
    fib); the port's CPU shrink gives the same bytes."""
    blob = chain["blob"]
    assert hashlib.sha256(blob).hexdigest() == chip_smoke.SHRINK_PROOF_SHA256
    assert MachineProofBN.from_bytes(blob).to_bytes() == blob
    assert [c.name for c in MachineProofBN.from_bytes(blob).chips] == [
        "VmAir", "Sponge16Air", "Sponge24Air"]


def test_each_recursion_verify_bn_accepts_the_shrink(chain):
    vk = rec.RecursionVKBN.from_bytes(chain["vk_b"].to_bytes())
    assert rec.recursion_verify_bn(vk, MachineProofBN.from_bytes(
        chain["blob"]), chain["binding"], chain["msgs"], CHAIN_CFG)
    assert jrec.recursion_verify_bn(
        jrec.RecursionVKBN.from_bytes(chain["vk_b"].to_bytes()),
        jmbn.MachineProofBN.from_bytes(chain["blob"]), chain["binding"],
        chain["msgs"], JCHAIN_CFG)


@pytest.mark.parametrize("tamper", ["binding", "root", "opening"])
def test_both_recursion_verify_bn_reject_tampers(chain, tamper):
    """A changed binding byte, vk program root or opened value."""
    vk_bytes, blob, binding = (chain["vk_b"].to_bytes(), chain["blob"],
                               chain["binding"])
    if tamper == "binding":
        binding = binding[:-1] + bytes([binding[-1] ^ 1])
    elif tamper == "root":
        vk = chain["vk_b"]
        vk_bytes = rec.RecursionVKBN(
            shape=vk.shape, program_root=vk.program_root ^ 1,
            inner_preprocessed_roots=vk.inner_preprocessed_roots,
            n_instrs=vk.n_instrs, n_pubs=vk.n_pubs).to_bytes()
    else:
        bad = MachineProofBN.from_bytes(blob)
        bad.queries[0].openings[0].trace_row[0] ^= 1
        blob = bad.to_bytes()
    with pytest.raises(VerificationError):
        rec.recursion_verify_bn(rec.RecursionVKBN.from_bytes(vk_bytes),
                                MachineProofBN.from_bytes(blob), binding,
                                chain["msgs"], CHAIN_CFG)
    with pytest.raises(JVerificationError):
        jrec.recursion_verify_bn(jrec.RecursionVKBN.from_bytes(vk_bytes),
                                 jmbn.MachineProofBN.from_bytes(blob),
                                 binding, chain["msgs"], JCHAIN_CFG)


def test_shrink_rejects_forged_compress_root(chain):
    """A different compress program root as the inner vk: both packages'
    strict build refuse the honest compress proof."""
    bad_root = list(chain["roots"]["VmAir"])
    bad_root[0] ^= 1
    with pytest.raises(VerificationError):
        rec.recursion_prove_bn(
            rec.outer_airs(), chain["proof_a"], chain["binding"],
            chain["msgs"], CHAIN_CFG, CHAIN_CFG,
            inner_preprocessed_roots={"VmAir": bad_root}, device="cpu")
    with pytest.raises(JVerificationError):
        jrec.recursion_prove_bn(
            jrec.outer_airs(),
            JMachineProof.from_bytes(chain["proof_a"].to_bytes()),
            chain["binding"], chain["msgs"], JCHAIN_CFG, JCHAIN_CFG,
            inner_preprocessed_roots={"VmAir": bad_root})
