"""The port's Baby-Bear and quartic-extension tensor ops against the JAX
package's (exact: field arithmetic, tolerance 0).  Inputs come from a
seeded numpy generator and include 0 and p−1."""

import numpy as np
import pytest
import torch

from zktls_tpu.ops import babybear as jbb
from zktls_tpu.ops import ext as jex
from zktls_tpu.ops.field_ref import P, Fp4
from zktls_tpu_torch.ops import babybear as tbb
from zktls_tpu_torch.ops import ext as tex

from .torch_threads import torch_threads_per_worker  # noqa: F401

RNG = np.random.default_rng(1101)
EDGE = np.array([0, 1, 2, P - 2, P - 1], dtype=np.uint32)


def _field(shape):
    v = RNG.integers(0, P, shape, dtype=np.uint32)
    flat = v.reshape(-1)
    flat[: EDGE.size] = EDGE[: flat.size]
    return v


def _t(x):
    return tbb.from_numpy(np.asarray(x))


def _eq(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(tbb.to_numpy(got), np.asarray(want))


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_binary_ops_match(op):
    a, b = _field((257,)), _field((257,))
    b[:5] = EDGE[::-1]
    _eq(getattr(tbb, op)(_t(a), _t(b)), getattr(jbb, op)(a, b))


def test_unary_ops_and_conversions_match():
    a = _field((300,))
    _eq(tbb.neg(_t(a)), jbb.neg(a))
    _eq(tbb.to_mont(_t(a)), jbb.to_mont(a))
    _eq(tbb.from_mont(_t(a)), jbb.from_mont(a))
    _eq(tbb.inv(_t(a)), jbb.inv(a))
    _eq(tbb.pow_const(_t(a), 12345), jbb.pow_const(a, 12345))
    np.testing.assert_array_equal(tbb.np_to_mont(a), jbb.np_to_mont(a))
    np.testing.assert_array_equal(tbb.np_from_mont(a), jbb.np_from_mont(a))


def test_sums_and_dots_match():
    a, b = _field((37, 23)), _field((37, 23))
    _eq(tbb.sum_mod(_t(a), dim=0), jbb.sum_mod(a, axis=0))
    _eq(tbb.sum_mod(_t(a), dim=1), jbb.sum_mod(a, axis=1))
    _eq(tbb.sum_mod(_t(a)), jbb.sum_mod(a))
    _eq(tbb.dot_mod(_t(a), _t(b), dim=1), jbb.dot_mod(a, b, axis=1))


K_LIMIT = (((1 << 31) - 1) // (5 * 127 * 127))   # largest exact k


@pytest.mark.parametrize("n,k,m", [(1, 1, 1), (5, 3, 1), (33, 639, 4),
                                   (20, 32, 36), (3, K_LIMIT, 2)])
def test_matmul_mod_matches(n, k, m):
    v = _field((n, k))
    w = _field((k, m))
    _eq(tbb.matmul_mod(_t(v), w), jbb.matmul_mod(v, w))
    _eq(tbb.matmul_mod_rt(_t(v), _t(w)), jbb.matmul_mod_rt(v, w))


def test_matmul_mod_refuses_inexact_k():
    v = _field((2, K_LIMIT + 1))
    w = _field((K_LIMIT + 1, 1))
    with pytest.raises(ValueError):
        jbb.matmul_mod(v, w)
    with pytest.raises(ValueError):
        tbb.matmul_mod(_t(v), w)


def test_ext_ops_match():
    a, b = _field((64, 4)), _field((64, 4))
    s = _field((64,))
    _eq(tex.ext_add(_t(a), _t(b)), jex.ext_add(a, b))
    _eq(tex.ext_sub(_t(a), _t(b)), jex.ext_sub(a, b))
    _eq(tex.ext_neg(_t(a)), jex.ext_neg(a))
    _eq(tex.ext_mul(_t(a), _t(b)), jex.ext_mul(a, b))
    _eq(tex.ext_scale(_t(a), _t(s)), jex.ext_scale(a, s))
    a[0] = 1   # keep inv away from the zero element
    _eq(tex.ext_inv(_t(a)), jex.ext_inv(a))
    _eq(tex.ext_pow(_t(a), 77), jex.ext_pow(a, 77))
    _eq(tex.ext_from_base(_t(s)), jex.ext_from_base(s))


def test_fp4_conversions_match():
    v = Fp4(*[int(x) for x in _field((4,))])
    np.testing.assert_array_equal(tex.from_fp4(v), jex.from_fp4(v))
    assert tex.to_fp4(_t(jex.from_fp4(v))).c == v.c
