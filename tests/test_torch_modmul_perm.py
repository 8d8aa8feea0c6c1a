"""ModMulAir.perm_trace_m, the ModMul family's LogUp perm trace computed
by torch ops from the Montgomery main trace, against the host
generate_perm_trace it stands in for: at every width, with and without the
BUS_MODMUL columns, the tensor equals the host trace in Montgomery form
exactly, and so does the bus sum the machine reads from its last row."""

import numpy as np
import pytest

from zktls_tpu_torch.ops import babybear as bb
from zktls_tpu_torch.ops.field_ref import Fp4, P
from zktls_tpu_torch.stark.bus import MAX_PAYLOAD, delta_powers
from zktls_tpu_torch.stark.chips import modmul
from zktls_tpu_torch.stark.chips.modmul import (
    modmul_air_256,
    modmul_air_384,
    modmul_air_rsa,
)

from .torch_threads import torch_threads_per_worker  # noqa: F401


def _main_trace(air, n, rng):
    """A main trace whose lookup columns hold bytes and whose other
    columns hold any field values."""
    main = rng.integers(0, P, size=(n, air.width), dtype=np.uint64)
    main[:, : air.n_lookup_values] = rng.integers(
        0, 256, size=(n, air.n_lookup_values))
    return main.astype(np.uint32)


def _challenges(rng, full):
    """γ alone (the busless layout), or the machine's full vector
    [γ, δ, …, δ^MAX_PAYLOAD]."""
    gamma, delta = (Fp4(*[int(x) for x in rng.integers(0, P, 4)])
                    for _ in range(2))
    return [gamma] + (delta_powers(delta, MAX_PAYLOAD) if full else [])


@pytest.mark.parametrize("make, log_n, full, block_pairs", [
    (modmul_air_256, 8, True, None),
    (modmul_air_256, 13, True, None),
    (modmul_air_256, 8, False, None),
    (modmul_air_384, 8, True, None),
    (modmul_air_rsa, 8, True, None),
    (modmul_air_256, 10, True, 142 * 300),
], ids=["256-full-2^8", "256-full-2^13", "256-gamma-2^8", "384-full-2^8",
        "rsa2048-full-2^8", "256-full-2^10-blocks-of-300-rows"])
def test_perm_trace_m_equals_host(make, log_n, full, block_pairs,
                                  monkeypatch):
    """block_pairs: a smaller row block than the module's, so that the
    pair inverses run in several blocks (the last one short) and the
    running sum spans them."""
    if block_pairs is not None:
        monkeypatch.setattr(modmul, "_PERM_BLOCK_PAIRS", block_pairs)
    air = make()
    rng = np.random.default_rng(1000 * log_n + air.limbs + full
                                + (block_pairs or 0))
    main = _main_trace(air, 1 << log_n, rng)
    ch = _challenges(rng, full)
    want = air.generate_perm_trace(main, [], ch)
    got = air.perm_trace_m(main, bb.to_mont(bb.from_numpy(main, "cpu")),
                           [], ch)
    assert got.device.type == "cpu" and got.dtype == bb.DTYPE
    np.testing.assert_array_equal(bb.to_numpy(got), bb.np_to_mont(want))
    bus_sum = bb.np_from_mont(bb.to_numpy(got[-1, -4:]))
    np.testing.assert_array_equal(bus_sum, want[-1, -4:])
    if air.has_bus and full:
        assert bus_sum.any()
