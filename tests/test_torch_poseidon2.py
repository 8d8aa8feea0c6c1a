"""The port's Poseidon2 against the JAX package's XLA version, its scalar
reference and its Pallas kernel in interpret mode (exact).  On the CPU the
port's entry point runs the plain torch version; the hand-written CUDA
kernel is held against that plain version on the card by chip_smoke.py."""

import dataclasses

import numpy as np
import pytest
import torch

from zktls_tpu.ops import babybear as jbb
from zktls_tpu.ops import poseidon2 as jp2
from zktls_tpu.ops.field_ref import P
from zktls_tpu.ops.pallas_poseidon2 import permute_batch_pallas
from zktls_tpu_torch.ops import babybear as tbb
from zktls_tpu_torch.ops import cuda_poseidon2
from zktls_tpu_torch.ops import poseidon2 as tp2

RNG = np.random.default_rng(2202)


def _mont_states(n, width):
    states = RNG.integers(0, P, (n, width), dtype=np.uint32)
    states[0, :3] = (0, 1, P - 1)
    return jbb.np_to_mont(states)


@pytest.mark.parametrize("width", [16, 24])
def test_params_match(width):
    assert dataclasses.astuple(tp2.get_params(width)) == \
        dataclasses.astuple(jp2.get_params(width))


N_MAX = 1529


@pytest.fixture(scope="module")
def references():
    """Per width: one seeded (N_MAX, width) batch and the JAX package's XLA
    and interpret-mode Pallas outputs for it (each compiled once; rows are
    independent, so a prefix of the output is the output of the prefix)."""
    out = {}
    for width in (16, 24):
        sm = _mont_states(N_MAX, width)
        out[width] = (sm, np.asarray(jp2.permute_batch(sm)),
                      np.asarray(permute_batch_pallas(sm, interpret=True)))
    return out


@pytest.mark.parametrize("width", [16, 24])
@pytest.mark.parametrize("n", [1, 511, 512, 513, N_MAX])
def test_plain_matches_xla_and_pallas(references, width, n):
    sm, xla, pallas = references[width]
    before = tp2.plain_calls
    got = tbb.to_numpy(tp2.permute_batch(tbb.from_numpy(sm[:n])))
    assert tp2.plain_calls == before + 1        # CPU tensor -> plain path
    np.testing.assert_array_equal(got, xla[:n])
    np.testing.assert_array_equal(got, pallas[:n])


@pytest.mark.parametrize("width", [16, 24])
def test_plain_matches_scalar_references(width):
    plain = RNG.integers(0, P, (4, width), dtype=np.uint32)
    got = jbb.np_from_mont(tbb.to_numpy(tp2.permute_batch_plain(
        tbb.from_numpy(jbb.np_to_mont(plain)))))
    for row, out in zip(plain, got):
        ints = [int(x) for x in row]
        want = jp2.Poseidon2(width).permute_ints(ints)
        assert tp2.Poseidon2(width).permute_ints(ints) == want
        assert [int(x) for x in out] == want


@pytest.mark.parametrize("width", [16, 24])
def test_rows_inside_a_larger_batch(width):
    big = tbb.from_numpy(_mont_states(700, width))
    np.testing.assert_array_equal(
        tbb.to_numpy(tp2.permute_batch(big[:5].clone())),
        tbb.to_numpy(tp2.permute_batch(big)[:5]))


def test_kernel_wrapper_refuses_what_it_cannot_take():
    states = torch.zeros((4, 16), dtype=torch.int32)
    with pytest.raises(ValueError):
        cuda_poseidon2.permute_batch(states)          # not on a card
    with pytest.raises(ValueError):
        tp2.permute_batch(torch.zeros((4, 20), dtype=tbb.DTYPE))
