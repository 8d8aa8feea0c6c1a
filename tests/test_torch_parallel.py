"""The port's multi-device path against the JAX package's, on CPU shards:
`parallel.mesh.make_mesh` (the same split and refusal as
zktls_tpu.parallel.mesh), the sharded four-step NTT, its inverse and the
sharded coset LDE (equal to zktls_tpu.parallel.ntt's on the 8 virtual CPU
devices of tests/conftest.py, and to the port's local ntt/intt/coset_lde),
and `prove_machine(devices=, mesh=)`: the committed JAX proof's bytes on
the 256-row Sha256Air machine, the single-device proof's bytes on a
two-chip preprocessed machine (which the JAX verifier accepts), and no
card needed unless one is asked for.  The port's shards are a list of
`torch.device("cpu")`, one logical shard per entry; inputs are seeded;
equality is exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zktls_tpu.models.fibonacci import FibonacciAir as JFibonacciAir
from zktls_tpu.ops import babybear as jbb
from zktls_tpu.parallel import mesh as jmesh
from zktls_tpu.parallel import ntt as jpntt
from zktls_tpu.stark import machine as jmachine
from zktls_tpu.stark.config import StarkConfig as JStarkConfig
from zktls_tpu_torch.ops import babybear as bb
from zktls_tpu_torch.ops.field_ref import P
from zktls_tpu_torch.ops.ntt import coset_lde, intt, ntt
from zktls_tpu_torch.parallel import ntt as pntt
from zktls_tpu_torch.parallel.mesh import Mesh, make_mesh
from zktls_tpu_torch.stark import machine as tmachine
from zktls_tpu_torch.stark.config import StarkConfig
from zktls_tpu_torch.workload import (
    SHA_MACHINE_BINDING,
    SHA_MACHINE_CONFIG,
    SHA_MACHINE_REFERENCE,
    SHA_MACHINE_SEED,
    preprocessed_machine,
    sha_machine,
)

from .test_torch_preprocessed import JFixedMulAir
from .torch_threads import torch_threads_per_worker  # noqa: F401

CPU8 = [torch.device("cpu")] * 8


def _jax_mesh(n_ntt):
    return jmesh.make_mesh(8 // n_ntt, n_ntt, jax.devices()[:8])


def _seeded(seed, shape):
    """Seeded Montgomery values as numpy uint32."""
    rng = np.random.default_rng(seed)
    return jbb.np_to_mont(rng.integers(0, P, shape, dtype=np.uint32))


@pytest.mark.parametrize("n_dev,n_seg,n_ntt", [
    (1, None, None), (2, None, None), (4, None, None), (8, None, None),
    (6, None, None), (8, 4, None), (8, None, 8), (8, 2, 4), (4, 4, 1)])
def test_make_mesh_matches_the_reference(n_dev, n_seg, n_ntt):
    ref = jmesh.make_mesh(n_seg, n_ntt, jax.devices()[:n_dev])
    got = make_mesh(n_seg, n_ntt, ["cpu"] * n_dev)
    assert isinstance(got, Mesh)
    assert got.axis_names == tuple(ref.axis_names) == ("seg", "ntt")
    assert got.shape == dict(ref.shape)
    assert got.devices.shape == ref.devices.shape
    assert all(d == torch.device("cpu") for d in got.devices.flat)


@pytest.mark.parametrize("n_seg,n_ntt", [(3, None), (None, 3), (3, 3)])
def test_make_mesh_refuses_a_mesh_that_does_not_cover(n_seg, n_ntt):
    with pytest.raises(ValueError) as ref:
        jmesh.make_mesh(n_seg, n_ntt, jax.devices()[:8])
    with pytest.raises(ValueError) as got:
        make_mesh(n_seg, n_ntt, CPU8)
    assert str(got.value) == str(ref.value)


def test_mesh_axis_devices():
    mesh = make_mesh(2, 4, [f"cpu:{i}" for i in range(8)])
    assert mesh.devices.shape == (2, 4)
    assert mesh.axis_devices("ntt") == list(mesh.devices[0])
    assert mesh.axis_devices("seg") == list(mesh.devices[:, 0])


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n_ntt", [2, 4])
@pytest.mark.parametrize("log_n", [10, 11])
def test_ntt_sharded_equals_reference_and_local(log_n, n_ntt, inverse):
    x = _seeded(log_n * 10 + n_ntt, 1 << log_n)
    ref = np.asarray(jpntt.ntt_sharded(jnp.asarray(x), _jax_mesh(n_ntt),
                                       inverse=inverse))
    xt = bb.from_numpy(x)
    got = pntt.ntt_sharded(xt, make_mesh(8 // n_ntt, n_ntt, CPU8),
                           inverse=inverse)
    np.testing.assert_array_equal(bb.to_numpy(got), ref)
    assert torch.equal(got, intt(xt) if inverse else ntt(xt))


@pytest.mark.parametrize("log_n", [1, 2, 3, 5])
@pytest.mark.parametrize("n_ntt", [3, 4])
def test_ntt_sharded_uneven_splits(log_n, n_ntt):
    """More shards than rows, or rows that do not divide: tensor_split's
    uneven blocks, as JAX's uneven sharding."""
    mesh = make_mesh(1, n_ntt, ["cpu"] * n_ntt)
    x = bb.from_numpy(_seeded(log_n, (1 << log_n, 3)))
    assert torch.equal(pntt.ntt_sharded(x, mesh), ntt(x))
    assert torch.equal(pntt.ntt_sharded(x, mesh, inverse=True), intt(x))


@pytest.mark.parametrize("log_blowup", [1, 2])
@pytest.mark.parametrize("n_ntt", [2, 4])
def test_coset_lde_sharded_equals_reference_and_local(log_blowup, n_ntt):
    vals = _seeded(7 + log_blowup, (1 << 8, 5))
    ref = np.asarray(jpntt.make_coset_lde_sharded(_jax_mesh(n_ntt))(
        jnp.asarray(vals), log_blowup, 31))
    got = pntt.make_coset_lde_sharded(make_mesh(8 // n_ntt, n_ntt, CPU8))(
        bb.from_numpy(vals), log_blowup, 31)
    np.testing.assert_array_equal(bb.to_numpy(got), ref)
    assert torch.equal(got, coset_lde(bb.from_numpy(vals), log_blowup, 31))


def test_sha_machine_on_two_shards_gives_the_jax_proof():
    inst, _ = sha_machine(2, 100, SHA_MACHINE_SEED)
    devices = ["cpu"] * 2
    proof = tmachine.prove_machine(
        [inst], SHA_MACHINE_BINDING, StarkConfig(**SHA_MACHINE_CONFIG),
        devices=devices, mesh=make_mesh(1, 2, devices))
    assert proof.to_bytes() == SHA_MACHINE_REFERENCE.read_bytes()


CFG_ARGS = dict(log_blowup=2, num_queries=6, pow_bits=2, fri_final_size=8)
LOG_N = 6


@pytest.fixture(scope="module")
def single_device_proof():
    chips, pre = preprocessed_machine(LOG_N)
    proof = tmachine.prove_machine(chips, b"par", StarkConfig(**CFG_ARGS),
                                   device="cpu")
    return chips, pre, proof.to_bytes()


@pytest.mark.parametrize("n_dev,mesh_shape", [
    (2, (1, 2)), (3, None), (1, (2, 2)), (2, (1, 4))])
def test_preprocessed_machine_on_shards(single_device_proof, n_dev,
                                        mesh_shape, monkeypatch):
    """Two chips round-robin over the shards (FixedMulAir on the first,
    Fibonacci on the second), the largest chip's trace LDE sharded when the
    mesh's ntt axis is wider than one: the single-device bytes, which the
    JAX verifier accepts with the vk root."""
    chips, pre, want = single_device_proof
    calls = []
    make = pntt.make_coset_lde_sharded

    def spy(mesh, axis="ntt"):
        fn = make(mesh, axis)

        def lde(values, log_blowup, shift):
            calls.append((tuple(values.shape), values.device))
            return fn(values, log_blowup, shift)

        return lde

    monkeypatch.setattr(pntt, "make_coset_lde_sharded", spy)
    placed = []
    mont = tmachine._mont
    monkeypatch.setattr(tmachine, "_mont", lambda a, d: (
        placed.append((a.shape, d)), mont(a, d))[1])
    devices = [f"cpu:{i}" for i in range(n_dev)]
    mesh = (make_mesh(*mesh_shape, ["cpu"] * mesh_shape[0] * mesh_shape[1])
            if mesh_shape else None)
    got = tmachine.prove_machine(chips, b"par", StarkConfig(**CFG_ARGS),
                                 devices=devices, mesh=mesh).to_bytes()
    assert got == want
    sharded = mesh_shape is not None and mesh_shape[1] > 1
    assert calls == ([((1 << LOG_N, 2), torch.device("cpu"))]
                     if sharded else [])
    # FixedMulAir's matrices (2^LOG_N rows, extensions 4× that) on
    # devices[0], Fibonacci's (half as many rows) on devices[1]
    d0, d1 = torch.device(devices[0]), torch.device(devices[1 % n_dev])
    want_dev = {1 << LOG_N: d0, 4 << LOG_N: d0, 1 << LOG_N - 1: d1,
                2 << LOG_N: d1}
    assert {shape[0]: dev for shape, dev in placed} == want_dev
    assert all(dev == want_dev[shape[0]] for shape, dev in placed)
    roots = {"FixedMulAir": tmachine.preprocessed_root(
        chips[0].air, pre, LOG_N, LOG_N, StarkConfig(**CFG_ARGS),
        device="cpu")}
    assert jmachine.verify_machine(
        [JFixedMulAir(), JFibonacciAir()],
        jmachine.MachineProof.from_bytes(got), b"par",
        config=JStarkConfig(**CFG_ARGS), preprocessed_roots=roots)


@pytest.mark.parametrize("devices", [None, ["cpu:0", "cpu:1"]])
def test_trees_dispatched_before_the_first_root(single_device_proof,
                                                devices, monkeypatch):
    """With a device list, every chip's tree of a commit stage is built
    before the first of its roots is read (the host copy waits); on one
    device each root is read before the next chip's tree (serial)."""
    chips, _, want = single_device_proof
    events = []
    base = tmachine.MerkleTree

    class Tree(base):
        def __init__(self, rows, defer=False):
            events.append("tree")
            super().__init__(rows, defer=defer)

        @property
        def levels_np(self):
            if self._levels is None:
                events.append("root")
            return base.levels_np.fget(self)

    monkeypatch.setattr(tmachine, "MerkleTree", Tree)
    kw = {"devices": devices} if devices else {"device": "cpu"}
    got = tmachine.prove_machine(chips, b"par", StarkConfig(**CFG_ARGS),
                                 **kw).to_bytes()
    assert got == want
    # preprocessed (1 chip), trace (2), quotient (2); no perm trees
    stages = ["tree", "root"] + ["tree", "tree", "root", "root"] * 2
    if devices is None:
        stages = ["tree", "root"] * 5
    assert events[:10] == stages


def test_device_lists_without_a_card_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    chips, _ = preprocessed_machine(4)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(1, 2, ["cuda:0", "cuda:1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tmachine.prove_machine(chips, b"x", devices=["cuda"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tmachine.prove_machine(chips, b"x", devices=["cpu", "cuda"])
    with pytest.raises(ValueError, match="not both"):
        tmachine.prove_machine(chips, b"x", device="cpu", devices=["cpu"])
    with pytest.raises(ValueError, match="at least one"):
        tmachine.prove_machine(chips, b"x", devices=[])
