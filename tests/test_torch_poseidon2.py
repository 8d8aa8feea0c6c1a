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

from .torch_threads import torch_threads_per_worker  # noqa: F401

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


def test_permute_wrapper_checks_layout_before_device():
    """Without a card: wrong dtype, width and layout are refused as such;
    a well-formed CPU tensor is refused for not being on a CUDA device."""
    with pytest.raises(TypeError):
        cuda_poseidon2.permute_batch(torch.zeros((4, 16), dtype=torch.int64))
    with pytest.raises(ValueError, match=r"16\|24"):
        cuda_poseidon2.permute_batch(torch.zeros((4, 20), dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        cuda_poseidon2.permute_batch(
            torch.zeros((4, 32), dtype=torch.int32)[:, ::2])
    with pytest.raises(ValueError, match="2-D"):
        cuda_poseidon2.permute_batch(torch.zeros(16, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_poseidon2.permute_batch(torch.zeros((4, 24), dtype=torch.int32))


def test_launch_counters_per_entry_point():
    assert set(cuda_poseidon2.launches) == {"permute", "hash_rows",
                                            "merkle_levels"}
    cuda_poseidon2.launches["hash_rows"] += 3
    cuda_poseidon2.reset_launches()
    assert cuda_poseidon2.launches == {"permute": 0, "hash_rows": 0,
                                       "merkle_levels": 0}


@pytest.mark.parametrize("width", [16, 24])
def test_bound_counts(width):
    """The bound's counts: 3 multiplies per Montgomery product, 8·w·4 + RP·
    (4 + w) products per state; the fused entry points count the same
    permutations over the bytes they move."""
    rp = {16: 13, 24: 21}[width]
    b = cuda_poseidon2.bound({width: 1000}, 132, 1980.0)
    assert b["multiplies"] == 1000 * 3 * (8 * width * 4 + rp * (4 + width))
    assert b["bytes"] == 1000 * width * 8
    assert b["bound_by"] == "operations"
    h = cuda_poseidon2.hash_rows_bound(1000, 639, 132, 1980.0)
    assert h["multiplies"] == 40 * cuda_poseidon2.bound(
        {24: 1000}, 132, 1980.0)["multiplies"]
    assert h["bytes"] == 8 * 1000 * (639 + 8)
    t = cuda_poseidon2.merkle_levels_bound(1024, 132, 1980.0)
    assert t["multiplies"] == cuda_poseidon2.bound(
        {16: 1023}, 132, 1980.0)["multiplies"]
    assert t["bytes"] == 64 * (1024 + 1023)
