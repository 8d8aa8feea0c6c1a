"""The port's compress rung (stark/recursion.py with chips/vm.py,
chips/sponge.py) against the JAX package's, on the reference's own inner
machines (tests/test_recursion.py): the Fibonacci inner at its tiny
configs, the multi-chip GCM-data inner of tests/test_gcm_data.py and a
preprocessed inner.  The program (instruction payloads, chain seeds,
public inputs, sponge rows), the VM and sponge traces, their perm traces at
fixed challenges, the vk and the outer proof are equal; each package's
recursion_verify accepts the other's proof and both reject a changed
binding.  The JAX package's vk and outer proof of the Fibonacci inner are
its recursion_prove output committed in zktls_tpu_torch/data/
(`workload.FIB_COMPRESS_REFERENCE`, pinned by digest here, made and
checked live by scripts/session_proof_cpu.py --compress fib --reference),
read instead of compiled in every run; every proof made here is the
port's, on the CPU.  Equality is exact."""

import hashlib

import numpy as np
import pytest
import torch

from zktls_tpu.models.fibonacci import FibonacciAir as JFibonacciAir
from zktls_tpu.ops.field_ref import Fp4 as JFp4
from zktls_tpu.stark import recursion as jrec
from zktls_tpu.stark.chips import bytes_table as jbytes
from zktls_tpu.stark.chips import sponge as jsponge
from zktls_tpu.stark.chips import vm as jvm
from zktls_tpu.stark.config import StarkConfig as JStarkConfig
from zktls_tpu.stark.debug import check_trace as jcheck_trace
from zktls_tpu.stark.machine import MachineProof as JMachineProof
from zktls_tpu.stark.machine import verify_machine as jverify_machine
from zktls_tpu.stark.verifier import VerificationError as JVerificationError
from zktls_tpu_torch.convert import chip_instance_from_reference
from zktls_tpu_torch.core import cbor
from zktls_tpu_torch.models.fibonacci import FibonacciAir, fibonacci_trace
from zktls_tpu_torch.ops.field_ref import Fp4
from zktls_tpu_torch.ops.ntt import coset_lde
from zktls_tpu_torch.ops import babybear as bb
from zktls_tpu_torch.stark import recursion as rec
from zktls_tpu_torch.stark.chips import bytes_table, sponge, vm
from zktls_tpu_torch.stark.config import StarkConfig
from zktls_tpu_torch.stark.debug import check_trace
from zktls_tpu_torch.stark.machine import (
    ChipInstance,
    MachineProof,
    preprocessed_root,
    prove_machine,
    verify_machine,
)
from zktls_tpu_torch.stark.verifier import VerificationError
from zktls_tpu_torch.workload import (
    FIB_COMPRESS_BINDING,
    FIB_COMPRESS_CONFIG,
    FIB_COMPRESS_REFERENCE,
    preprocessed_machine,
)

from .test_torch_preprocessed import JFixedMulAir
from .torch_threads import torch_threads_per_worker  # noqa: F401

CFG_ARGS = FIB_COMPRESS_CONFIG
CFG, JCFG = StarkConfig(**CFG_ARGS), JStarkConfig(**CFG_ARGS)
BINDING = FIB_COMPRESS_BINDING
#: SHA-256 of the committed JAX vk + outer proof of the Fibonacci inner
FIB_COMPRESS_REFERENCE_SHA256 = (
    "0a8cff8d36e937c6bbba2b025f4a7677d81317ce0ccd71366a5f3f67def3e677")
CHALLENGE_INTS = [(3, 1, 4, 1), (2, 7, 1, 8), (5, 9, 2, 6)]


def _challenges(fp4):
    """γ, then δ and its powers (the machine challenge vector), in one
    package's Fp4."""
    gamma, delta = fp4(*CHALLENGE_INTS[0]), fp4(*CHALLENGE_INTS[1])
    return [gamma, delta] + [delta ** k for k in range(2, 37)]


def _payloads(prog, mod):
    return [mod.instr_payload(pc, ins) for pc, ins in enumerate(prog.instrs)]


def _sponge_rows(prog, w):
    return [(r.sid, r.seq, dict(r.absorbs), dict(r.out_mults), r.has_next,
             r.additive, None if r.fresh_state is None
             else list(r.fresh_state), pos)
            for r, pos in prog.sp_rows[w]]


def _assert_same_program(mine, ref):
    assert _payloads(mine, vm) == _payloads(ref, jvm)
    assert mine.chain_seeds == ref.chain_seeds
    assert mine.pub_values == ref.pub_values
    for w in (16, 24):
        assert _sponge_rows(mine, w) == _sponge_rows(ref, w)


@pytest.fixture(scope="module")
def inner():
    """The port's Fibonacci inner proof (tests/test_recursion.py's) and the
    JAX package's parse of its bytes."""
    trace, pub = fibonacci_trace(5)
    proof = prove_machine(
        [ChipInstance(air=FibonacciAir(), trace=trace, publics=pub)],
        binding=BINDING, config=CFG, device="cpu")
    assert verify_machine([FibonacciAir()], proof, BINDING, config=CFG)
    return proof, JMachineProof.from_bytes(proof.to_bytes())


@pytest.fixture(scope="module")
def progs(inner):
    proof, jproof = inner
    mine = rec.build_program([FibonacciAir()], rec.MachineShape.of(proof),
                             BINDING, [], CFG, proof=proof)
    ref = jrec.build_program([JFibonacciAir()], jrec.MachineShape.of(jproof),
                             BINDING, [], JCFG, proof=jproof)
    return mine, ref


@pytest.fixture(scope="module")
def outer(inner):
    """(port vk, port outer proof, JAX vk, JAX outer proof) of the
    Fibonacci inner at the tiny configs; the JAX pair is read from the
    committed bytes of the JAX package's recursion_prove."""
    proof, _ = inner
    vk, out = rec.recursion_prove([FibonacciAir()], proof, BINDING,
                                  inner_config=CFG, outer_config=CFG,
                                  device="cpu")
    ref = cbor.loads(FIB_COMPRESS_REFERENCE.read_bytes())
    return (vk, out, jrec.RecursionVK.from_bytes(ref["vk"]),
            JMachineProof.from_bytes(ref["proof"]))


def test_committed_reference_compress_is_pinned(inner):
    """The committed JAX bytes are the ones its recursion_prove gave (the
    digest the live regeneration printed), for this very inner proof:
    their vk's shape is the inner's, and both packages parse and re-encode
    them unchanged."""
    data = FIB_COMPRESS_REFERENCE.read_bytes()
    assert hashlib.sha256(data).hexdigest() == FIB_COMPRESS_REFERENCE_SHA256
    ref = cbor.loads(data)
    _, jproof = inner
    jvk = jrec.RecursionVK.from_bytes(ref["vk"])
    assert jvk.shape == jrec.MachineShape.of(jproof)
    assert jvk.to_bytes() == ref["vk"]
    assert rec.RecursionVK.from_bytes(ref["vk"]).to_bytes() == ref["vk"]
    assert JMachineProof.from_bytes(ref["proof"]).to_bytes() == ref["proof"]
    assert MachineProof.from_bytes(ref["proof"]).to_bytes() == ref["proof"]


def test_program_equals_the_reference(inner, progs):
    """build_program: the same instruction stream row by row, chain seeds,
    public inputs and sponge rows; the shape-only rebuild gives the same
    stream (the program is a pure function of the shape)."""
    mine, ref = progs
    assert len(mine.instrs) > 100
    _assert_same_program(mine, ref)
    assert {i: v.c for i, v in mine.vals.items()} == \
        {i: v.c for i, v in ref.vals.items()}
    proof, _ = inner
    rebuilt = rec.build_program([FibonacciAir()], rec.MachineShape.of(proof),
                                BINDING, [], CFG, proof=None)
    assert _payloads(rebuilt, vm) == _payloads(mine, vm)
    assert rebuilt.chain_seeds == mine.chain_seeds


def test_vm_and_sponge_traces_equal_the_reference(progs):
    mine, ref = progs
    np.testing.assert_array_equal(vm.vm_preprocessed(mine.instrs),
                                  jvm.vm_preprocessed(ref.instrs))
    values = {i: v.c for i, v in mine.vals.items()}
    jvalues = {i: v.c for i, v in ref.vals.items()}
    np.testing.assert_array_equal(vm.vm_trace(mine.instrs, values)[0],
                                  jvm.vm_trace(ref.instrs, jvalues)[0])
    for w, air, jair in ((16, sponge.Sponge16Air(), jsponge.Sponge16Air()),
                         (24, sponge.Sponge24Air(), jsponge.Sponge24Air())):
        trace, _, states = sponge.sponge_trace(
            air, [r for r, _ in mine.sp_rows[w]])
        jtrace, _, jstates = jsponge.sponge_trace(
            jair, [r for r, _ in ref.sp_rows[w]])
        np.testing.assert_array_equal(trace, jtrace)
        assert states == jstates


def test_perm_traces_equal_the_reference(progs, monkeypatch):
    """VmAir's and both sponge chips' perm traces at fixed challenges (the
    VM's also with its inverse columns split into many row pieces); the
    VM's running sum (uint64 in the port, Python ints in the reference)
    equals the sum of its u column over Python ints."""
    mine, ref = progs
    ch, jch = _challenges(Fp4), _challenges(JFp4)
    pre = vm.vm_preprocessed(mine.instrs)
    trace, _ = vm.vm_trace(mine.instrs,
                           {i: v.c for i, v in mine.vals.items()})
    perm = vm.VmAir().generate_perm_trace(trace, [], ch, preprocessed=pre)
    np.testing.assert_array_equal(
        perm, jvm.VmAir().generate_perm_trace(trace, [], jch,
                                              preprocessed=pre))
    monkeypatch.setattr(vm, "_PERM_ROWS", 1000)
    np.testing.assert_array_equal(
        vm.VmAir().generate_perm_trace(trace, [], ch, preprocessed=pre),
        perm)
    u = perm[:, 32:36].astype(object)
    np.testing.assert_array_equal(perm[:, 36:40].astype(object),
                                  np.cumsum(u, axis=0) % bb.P)
    for w, air, jair in ((16, sponge.Sponge16Air(), jsponge.Sponge16Air()),
                         (24, sponge.Sponge24Air(), jsponge.Sponge24Air())):
        strace, _, _ = sponge.sponge_trace(air,
                                           [r for r, _ in mine.sp_rows[w]])
        np.testing.assert_array_equal(
            air.generate_perm_trace(strace, [], ch),
            jair.generate_perm_trace(strace, [], jch))


def test_vk_and_outer_proof_equal_the_reference(outer):
    vk, out, jvk, jout = outer
    assert [c.name for c in out.chips] == ["VmAir", "Sponge16Air",
                                           "Sponge24Air"]
    assert vk.to_bytes() == jvk.to_bytes()
    assert out.to_bytes() == jout.to_bytes()
    assert rec.RecursionVK.from_bytes(vk.to_bytes()) == vk


def test_each_recursion_verify_accepts_the_others(outer):
    """The JAX recursion_verify accepts the port's (vk, outer) and the
    port's accepts the JAX package's, through the vk fast path and (the
    port) the bare-shape setup path; both reject a changed binding and a
    changed program root."""
    vk, out, jvk, jout = outer
    airs, jairs = [FibonacciAir()], [JFibonacciAir()]
    kw, jkw = dict(inner_config=CFG, outer_config=CFG), \
        dict(inner_config=JCFG, outer_config=JCFG)
    port_vk = jrec.RecursionVK.from_bytes(vk.to_bytes())
    port_out = JMachineProof.from_bytes(out.to_bytes())
    assert jrec.recursion_verify(jairs, port_vk, port_out, BINDING, **jkw)
    ref_vk = rec.RecursionVK.from_bytes(jvk.to_bytes())
    ref_out = MachineProof.from_bytes(jout.to_bytes())
    assert rec.recursion_verify(airs, ref_vk, ref_out, BINDING, **kw)
    assert rec.recursion_verify(airs, vk.shape, ref_out, BINDING,
                                device="cpu", **kw)
    with pytest.raises(JVerificationError):
        jrec.recursion_verify(jairs, port_vk, port_out, b"fib-recursioX",
                              **jkw)
    with pytest.raises(VerificationError):
        rec.recursion_verify(airs, ref_vk, ref_out, b"fib-recursioX", **kw)
    bad_root = (vk.program_root[0] ^ 1, *vk.program_root[1:])
    bad_vk = rec.RecursionVK(shape=vk.shape, program_root=bad_root,
                             n_instrs=vk.n_instrs, n_pubs=vk.n_pubs)
    with pytest.raises(VerificationError):
        rec.recursion_verify(airs, bad_vk, ref_out, BINDING, **kw)
    with pytest.raises(JVerificationError):
        jrec.recursion_verify(
            jairs, jrec.RecursionVK.from_bytes(bad_vk.to_bytes()), port_out,
            BINDING, **jkw)


def test_tampered_inner_proof_rejected(inner):
    """The strict build (the prover's witness generation) refuses an inner
    proof with a flipped trace-root limb."""
    proof, _ = inner
    bad = MachineProof.from_bytes(proof.to_bytes())
    bad.chips[0].trace_root = list(bad.chips[0].trace_root)
    bad.chips[0].trace_root[0] ^= 1
    with pytest.raises(VerificationError):
        rec.build_program([FibonacciAir()], rec.MachineShape.of(bad),
                          BINDING, [], CFG, proof=bad)


def test_forged_vm_witness_rejected_by_both_verifiers(inner, progs):
    """A VM witness value changed after the build: the port proves the
    forged trace, and both packages' verify_machine reject it."""
    proof, _ = inner
    mine, _ = progs
    shape = rec.MachineShape.of(proof)
    chips = rec._outer_chips(mine)
    vtrace = chips[0].trace.copy()
    row = next(i for i, ins in enumerate(mine.instrs) if ins.op == "wit")
    vtrace[row, vm.LAYOUT["o1"].start] ^= 1
    chips[0] = ChipInstance(air=chips[0].air, trace=vtrace, publics=[],
                            preprocessed=chips[0].preprocessed)
    outer_binding = BINDING + shape.to_bytes()
    forged = prove_machine(chips, outer_binding, CFG, device="cpu")
    vk = rec._vk_from_prog(mine, shape, CFG, device="cpu")
    msgs = rec._session_messages(shape, BINDING, [])
    with pytest.raises(VerificationError):
        verify_machine(rec.outer_airs(), forged, outer_binding, msgs, CFG,
                       preprocessed_roots={"VmAir": list(vk.program_root)})
    with pytest.raises(JVerificationError):
        jverify_machine(jrec.outer_airs(),
                        JMachineProof.from_bytes(forged.to_bytes()),
                        outer_binding, msgs, JCFG,
                        preprocessed_roots={"VmAir": list(vk.program_root)})


def test_trusted_vk_cache(inner, tmp_path, monkeypatch):
    """The verifier derives the root itself and caches it: a second lookup
    hits the cache; a corrupt entry and an entry for another shape are
    rebuilt, not trusted.  The default directory is ~/.local/zktlsd/vk, and
    no environment variable moves it."""
    proof, _ = inner
    shape = rec.MachineShape.of(proof)

    def lookup(cache_dir):
        return rec.trusted_vk([FibonacciAir()], shape, BINDING, [],
                              inner_config=CFG, outer_config=CFG,
                              cache_dir=cache_dir, device="cpu")

    vk1 = lookup(str(tmp_path))
    files = list(tmp_path.glob("rvk-*.bin"))
    assert len(files) == 1
    direct = rec.recursion_vk([FibonacciAir()], shape, BINDING, [],
                              inner_config=CFG, outer_config=CFG,
                              device="cpu")
    assert vk1.program_root == direct.program_root
    assert files[0].read_bytes() == vk1.to_bytes()
    planted = rec.RecursionVK(shape=shape, program_root=(7,) * 8,
                              n_instrs=1, n_pubs=1)
    files[0].write_bytes(planted.to_bytes())
    assert lookup(str(tmp_path)) == planted       # a cache hit
    files[0].write_bytes(b"garbage")
    assert lookup(str(tmp_path)) == vk1           # corrupt: rebuilt
    other = rec.MachineShape(chips=shape.chips, fri_roots=shape.fri_roots + 1,
                             fri_final=shape.fri_final)
    files[0].write_bytes(rec.RecursionVK(
        shape=other, program_root=(7,) * 8, n_instrs=1, n_pubs=1).to_bytes())
    assert lookup(str(tmp_path)) == vk1           # shape mismatch: rebuilt
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.setenv("ZKTLS_VK_CACHE", str(tmp_path / "env"))
    assert lookup(None) == vk1
    assert len(list((tmp_path / "home/.local/zktlsd/vk").glob("rvk-*"))) == 1
    assert not (tmp_path / "env").exists()


def test_multichip_inner_program_equals_the_reference():
    """The GCM-data inner of tests/test_gcm_data.py (stream parser, GCM
    data and xor table chips with LogUp buses, periodic columns and public
    messages), proved by the port: both packages build the same program;
    the shape-only rebuild has as many instructions; a changed filtered-byte
    message makes the strict build refuse the proof."""
    from .test_gcm_data import AIRS as JAIRS
    from .test_gcm_data import CFG as JGCM_CFG
    from .test_gcm_data import _setup

    jchips, msgs = _setup()
    chips = [chip_instance_from_reference(c) for c in jchips]
    airs = [c.air for c in chips]
    cfg = StarkConfig(log_blowup=JGCM_CFG.log_blowup,
                      num_queries=JGCM_CFG.num_queries,
                      pow_bits=JGCM_CFG.pow_bits,
                      fri_final_size=JGCM_CFG.fri_final_size)
    proof = prove_machine(chips, b"gcmdata", cfg, device="cpu")
    jproof = JMachineProof.from_bytes(proof.to_bytes())
    assert jverify_machine(JAIRS, jproof, b"gcmdata", msgs, JGCM_CFG)
    mine = rec.build_program(airs, rec.MachineShape.of(proof), b"gcmdata",
                             msgs, cfg, proof=proof)
    ref = jrec.build_program(JAIRS, jrec.MachineShape.of(jproof), b"gcmdata",
                             msgs, JGCM_CFG, proof=jproof)
    assert len(mine.instrs) > 10_000
    _assert_same_program(mine, ref)
    rebuilt = rec.build_program(airs, rec.MachineShape.of(proof), b"gcmdata",
                                msgs, cfg, proof=None)
    assert len(rebuilt.instrs) == len(mine.instrs)
    bad = [(t, list(p), m) for t, p, m in msgs]
    next(e for e in bad if e[0] == 0x113)[1][2] ^= 1    # BUS_FILTERED
    with pytest.raises(VerificationError):
        rec.build_program(airs, rec.MachineShape.of(proof), b"gcmdata", bad,
                          cfg, proof=proof)


def test_preprocessed_inner_through_inner_preprocessed_roots():
    """An inner machine with a preprocessed chip (workload's FixedMulAir
    beside a Fibonacci chip): its vk root enters the program as constants
    (the same program in both packages; no root, or a wrong one, is
    refused), and the port's compress of it is accepted by both packages'
    recursion_verify with the inner root."""
    chips, pre = preprocessed_machine(5)
    airs = [c.air for c in chips]
    jairs = [JFixedMulAir(), JFibonacciAir()]
    proof = prove_machine(chips, BINDING, CFG, device="cpu")
    jproof = JMachineProof.from_bytes(proof.to_bytes())
    roots = {"FixedMulAir": preprocessed_root(chips[0].air, pre, 5, 5, CFG,
                                              device="cpu")}
    shape = rec.MachineShape.of(proof)
    mine = rec.build_program(airs, shape, BINDING, [], CFG, proof=proof,
                             preprocessed_roots=roots)
    ref = jrec.build_program(jairs, jrec.MachineShape.of(jproof), BINDING,
                             [], JCFG, proof=jproof, preprocessed_roots=roots)
    _assert_same_program(mine, ref)
    with pytest.raises(VerificationError, match="missing preprocessed"):
        rec.build_program(airs, shape, BINDING, [], CFG, proof=proof)
    wrong = {"FixedMulAir": [roots["FixedMulAir"][0] ^ 1,
                             *roots["FixedMulAir"][1:]]}
    with pytest.raises(VerificationError):
        rec.build_program(airs, shape, BINDING, [], CFG, proof=proof,
                          preprocessed_roots=wrong)
    vk, out = rec.recursion_prove(airs, proof, BINDING, inner_config=CFG,
                                  outer_config=CFG,
                                  inner_preprocessed_roots=roots,
                                  device="cpu")
    assert rec.recursion_verify(airs, vk, out, BINDING, inner_config=CFG,
                                outer_config=CFG,
                                inner_preprocessed_roots=roots)
    assert jrec.recursion_verify(
        jairs, jrec.RecursionVK.from_bytes(vk.to_bytes()),
        JMachineProof.from_bytes(out.to_bytes()), BINDING,
        inner_config=JCFG, outer_config=JCFG, inner_preprocessed_roots=roots)


def test_byte_range_air_equals_the_reference():
    """ByteRangeAir: the trace, its perm trace at a fixed γ, and both
    packages' check_trace on it (no failure)."""
    rng = np.random.default_rng(11)
    values = [int(v) for v in rng.integers(0, 256, 700)]
    trace = bytes_table.byte_range_trace(values)
    np.testing.assert_array_equal(trace, jbytes.byte_range_trace(values))
    gamma, jgamma = Fp4(*CHALLENGE_INTS[2]), JFp4(*CHALLENGE_INTS[2])
    perm = bytes_table.ByteRangeAir().generate_perm_trace(trace, [], [gamma])
    np.testing.assert_array_equal(
        perm, jbytes.ByteRangeAir().generate_perm_trace(trace, [], [jgamma]))
    assert check_trace(bytes_table.ByteRangeAir(), trace, [],
                       perm_trace=perm, challenges=[gamma]) == []
    assert jcheck_trace(jbytes.ByteRangeAir(), trace, [], perm_trace=perm,
                        challenges=[jgamma]) == []


@pytest.mark.parametrize("log_n,log_blowup,shift", [
    (4, 2, 31), (9, 2, 31), (7, 1, pow(31, 4, bb.P)), (5, 3, 7)])
def test_host_tables_equal_the_reference(log_n, log_blowup, shift):
    """The selector tables and the FRI fold's 1/(2x) table, computed with
    numpy product-tree inverses (`ntt.np_batch_inverse`), equal the
    reference's pure-Python ones; so does the batch inverse itself on
    seeded values of odd and even counts."""
    from zktls_tpu.ops.field_ref import batch_inverse as jbatch_inverse
    from zktls_tpu.stark.config import selector_arrays as jselector_arrays
    from zktls_tpu.stark.prover import _inv_2x as jinv_2x
    from zktls_tpu_torch.ops.ntt import np_batch_inverse
    from zktls_tpu_torch.stark.config import selector_arrays
    from zktls_tpu_torch.stark.prover import _inv_2x

    mine = selector_arrays(log_n, log_blowup, shift)
    ref = jselector_arrays(log_n, log_blowup, shift)
    assert mine.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(mine[k], np.asarray(ref[k]))
        assert mine[k].dtype == np.asarray(ref[k]).dtype
    np.testing.assert_array_equal(_inv_2x(log_n + log_blowup, shift),
                                  jinv_2x(log_n + log_blowup, shift))
    vals = np.random.default_rng(log_n).integers(
        1, bb.P, (1 << log_n) + log_n, dtype=np.uint64)
    assert [int(v) for v in np_batch_inverse(vals)] == \
        jbatch_inverse([int(v) for v in vals])


def test_merkle_tree_moved_to_the_host_in_blocks(monkeypatch):
    """MerkleTree's levels are the same whether they cross to the host in
    one block or in blocks of 5 rows (a tree of 64 leaves is 127 rows)."""
    from zktls_tpu_torch.ops import merkle

    rng = np.random.default_rng(9)
    rows = bb.from_numpy(bb.np_to_mont(
        rng.integers(0, bb.P, (64, 20), dtype=np.uint32)), "cpu")
    whole = merkle.MerkleTree(rows)
    monkeypatch.setattr(merkle, "_HOST_ROWS", 5)
    blocks = merkle.MerkleTree(rows)
    for a, b in zip(whole.levels_np, blocks.levels_np):
        np.testing.assert_array_equal(a, b)
    leaf = merkle.hash_row_ints(
        [int(v) for v in bb.np_from_mont(bb.to_numpy(rows[3]))])
    assert merkle.verify_path(leaf, 3, blocks.open(3), blocks.root)


def test_coset_lde_in_column_blocks_gives_the_same_values(monkeypatch):
    """coset_lde over column blocks (a limit below one column's extension,
    and one of three columns) equals the whole-matrix extension."""
    from zktls_tpu_torch.ops import ntt

    rng = np.random.default_rng(5)
    x = bb.from_numpy(bb.np_to_mont(
        rng.integers(0, bb.P, (64, 7), dtype=np.uint32)), "cpu")
    whole = coset_lde(x, 2, 31)
    for limit in (1, 3 * 8 * 256):
        monkeypatch.setattr(ntt, "LDE_BLOCK_BYTES", limit)
        assert torch.equal(coset_lde(x, 2, 31), whole)
