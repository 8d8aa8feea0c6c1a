"""The port's Merkle trees and NTT/LDE against the JAX package's
(exact)."""

import numpy as np
import pytest

from zktls_tpu.ops import babybear as jbb
from zktls_tpu.ops import merkle as jmk
from zktls_tpu.ops import ntt as jntt
from zktls_tpu.ops.field_ref import GENERATOR, P
from zktls_tpu_torch.ops import babybear as tbb
from zktls_tpu_torch.ops import merkle as tmk
from zktls_tpu_torch.ops import ntt as tntt

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
