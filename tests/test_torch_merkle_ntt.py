"""The port's Merkle trees and NTT/LDE against the JAX package's
(exact)."""

import numpy as np
import pytest
import torch

from zktls_tpu.ops import babybear as jbb
from zktls_tpu.ops import merkle as jmk
from zktls_tpu.ops import ntt as jntt
from zktls_tpu.ops.field_ref import GENERATOR, P
from zktls_tpu_torch.ops import babybear as tbb
from zktls_tpu_torch.ops import cuda_poseidon2
from zktls_tpu_torch.ops import merkle as tmk
from zktls_tpu_torch.ops import ntt as tntt

from .torch_threads import torch_threads_per_worker  # noqa: F401

RNG = np.random.default_rng(3303)


def _mont(shape):
    return jbb.np_to_mont(RNG.integers(0, P, shape, dtype=np.uint32))


@pytest.mark.parametrize("width", [1, 8, 16, 17, 639])
def test_merkle_tree_matches(width):
    rows = _mont((16, width))
    want = jmk.MerkleTree(rows)
    got = tmk.MerkleTree(tbb.from_numpy(rows))
    np.testing.assert_array_equal(got.root, want.root)
    plain_rows = jbb.np_from_mont(rows)
    for i in range(rows.shape[0]):
        path = got.open(i)
        np.testing.assert_array_equal(np.array(path), np.array(want.open(i)))
        leaf = tmk.hash_row_ints([int(x) for x in plain_rows[i]])
        assert tmk.verify_path(leaf, i, path, got.root)
        assert not tmk.verify_path(leaf, i ^ 1, path, got.root)


def test_merkle_host_mirror_matches():
    row = [int(x) for x in RNG.integers(0, P, 40, dtype=np.uint32)]
    assert tmk.hash_row_ints(row) == jmk.hash_row_ints(row)
    assert tmk.hash_row_ints([]) == jmk.hash_row_ints([])
    assert tmk.compress_ints(row[:8], row[8:16]) == \
        jmk.compress_ints(row[:8], row[8:16])


@pytest.mark.parametrize("n", [1, 2, 64])
@pytest.mark.parametrize("width", [1, 8, 16, 17, 639])
def test_hash_rows_plain_matches(width, n):
    """The plain leaf sponge against the JAX package's (XLA on the CPU):
    exact equality of the uint32 values."""
    rows = _mont((n, width))
    got = tbb.to_numpy(tmk.hash_rows_plain(tbb.from_numpy(rows)))
    np.testing.assert_array_equal(got, np.asarray(jmk.hash_rows(rows)))
    # on a CPU tensor the entry point is the plain version
    np.testing.assert_array_equal(
        got, tbb.to_numpy(tmk.hash_rows(tbb.from_numpy(rows))))


@pytest.mark.parametrize("n", [1, 2, 64])
@pytest.mark.parametrize("width", [1, 8, 16, 17, 639])
def test_tree_levels_plain_matches(monkeypatch, width, n):
    """Every level of the plain tree, cut from its one buffer, against the
    JAX package's MerkleTree built level by level (exact; its fused route
    is held against the port's MerkleTree in test_merkle_tree_matches)."""
    monkeypatch.setenv("ZKTLS_FUSED_TREE", "0")
    rows = _mont((n, width))
    want = jmk.MerkleTree(rows).levels_np
    leaves = tmk.hash_rows_plain(tbb.from_numpy(rows))
    buf = tmk.tree_levels_plain(leaves)
    assert buf.shape == (2 * n - 1, tmk.DIGEST_WIDTH)
    nodes = tbb.np_from_mont(tbb.to_numpy(buf))
    bounds = tmk.level_bounds(n)
    assert len(bounds) == len(want)
    for (a, b), level in zip(bounds, want):
        np.testing.assert_array_equal(nodes[a:b], level)
    np.testing.assert_array_equal(
        tbb.to_numpy(tmk.tree_levels(leaves)), tbb.to_numpy(buf))


def test_tree_buffer_layout_opens_every_leaf():
    """The single-buffer layout: leaves first, each level behind the one
    below it, the root in the last row; a path read from it verifies for
    every leaf of a 64-leaf tree and for no other index."""
    n = 64
    assert tmk.level_bounds(n) == [(0, 64), (64, 96), (96, 112), (112, 120),
                                   (120, 124), (124, 126), (126, 127)]
    assert tmk.level_bounds(1) == [(0, 1)]
    rows = _mont((n, 20))
    tree = tmk.MerkleTree(tbb.from_numpy(rows))
    buf = tbb.np_from_mont(tbb.to_numpy(tmk.tree_levels_plain(
        tmk.hash_rows_plain(tbb.from_numpy(rows)))))
    np.testing.assert_array_equal(tree.root, buf[-1])
    assert [len(lv) for lv in tree.levels_np] == [64, 32, 16, 8, 4, 2, 1]
    plain_rows = jbb.np_from_mont(rows)
    for i in range(n):
        path = tree.open(i)
        assert len(path) == 6
        leaf = tmk.hash_row_ints([int(x) for x in plain_rows[i]])
        assert leaf == [int(x) for x in buf[i]]
        assert tmk.verify_path(leaf, i, path, tree.root)
        assert not tmk.verify_path(leaf, (i + 1) % n, path, tree.root)


def test_tree_levels_refuse_bad_leaves():
    with pytest.raises(ValueError):
        tmk.tree_levels(torch.zeros((3, 8), dtype=tbb.DTYPE))
    with pytest.raises(ValueError):
        tmk.tree_levels_plain(torch.zeros((4, 16), dtype=tbb.DTYPE))
    with pytest.raises(ValueError):
        tmk.MerkleTree(torch.zeros((6, 4), dtype=tbb.DTYPE))


def test_fused_wrappers_refuse_what_they_cannot_take():
    """Without a card: the kernel wrappers check type, shape and layout
    first and then refuse a tensor that is not on a CUDA device."""
    rows = torch.zeros((4, 20), dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_poseidon2.hash_rows(rows)                     # not on a card
    with pytest.raises(TypeError):
        cuda_poseidon2.hash_rows(rows.to(torch.int32))     # wrong dtype
    with pytest.raises(ValueError, match="contiguous"):
        cuda_poseidon2.hash_rows(rows[:, ::2])             # strided
    with pytest.raises(ValueError, match="column"):
        cuda_poseidon2.hash_rows(rows[:, :0])              # no columns
    with pytest.raises(ValueError, match="2-D"):
        cuda_poseidon2.hash_rows(rows[0])                  # one row, 1-D
    buf = torch.zeros((7, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_poseidon2.merkle_levels(buf)                  # not on a card
    with pytest.raises(TypeError):
        cuda_poseidon2.merkle_levels(buf.to(torch.int32))  # wrong dtype
    with pytest.raises(ValueError, match="power of two"):
        cuda_poseidon2.merkle_levels(buf[:6])              # 2N − 1 rows
    with pytest.raises(ValueError, match="power of two"):
        cuda_poseidon2.merkle_levels(torch.zeros((7, 16),  # wrong width
                                                 dtype=torch.int64))
    with pytest.raises(ValueError, match="contiguous"):
        cuda_poseidon2.merkle_levels(
            torch.zeros((7, 16), dtype=torch.int64)[:, ::2])


def _eq(got, want):
    np.testing.assert_array_equal(tbb.to_numpy(got), np.asarray(want))


@pytest.mark.parametrize("log_n", range(1, 13))
def test_ntt_and_intt_match(log_n):
    x = _mont((1 << log_n, 3))
    _eq(tntt.ntt(tbb.from_numpy(x)), jntt.ntt(x))
    _eq(tntt.intt(tbb.from_numpy(x)), jntt.intt(x))
    _eq(tntt.ntt(tbb.from_numpy(x[:, 0])), jntt.ntt(x[:, 0]))


@pytest.mark.parametrize("log_n,cols", [(1, 2), (4, 639), (6, 17),
                                        (9, 5)])
def test_coset_transforms_match(log_n, cols):
    x = _mont((1 << log_n, cols))
    shift = pow(GENERATOR, 4, P)
    _eq(tntt.coset_lde(tbb.from_numpy(x), 2, shift),
        jntt.coset_lde(x, 2, shift))
    _eq(tntt.coeffs_to_coset_evals(tbb.from_numpy(x), 1, shift),
        jntt.coeffs_to_coset_evals(x, 1, shift))
    _eq(tntt.coset_coeffs(tbb.from_numpy(x), shift),
        jntt.coset_coeffs(x, shift))


@pytest.mark.parametrize("log_n", [1, 5, 12])
def test_domains_match(log_n):
    np.testing.assert_array_equal(tntt.eval_domain(log_n, GENERATOR),
                                  jntt.eval_domain(log_n, GENERATOR))
    np.testing.assert_array_equal(tntt.bitrev_indices(log_n),
                                  jntt.bitrev_indices(log_n))
