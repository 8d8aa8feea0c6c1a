"""The port's GCM record-layer trace builders — aes128_trace, aes256_trace
and ghash_trace, which build every row at once with array operations —
against the JAX package's row-by-row builders on seeded random inputs:
the same trace, element for element and dtype, and the same publics.

The cases cover one block, block counts that fill the height exactly (no
padding group) and one past it (padding groups in front), mixed event
ids, all-zero keys and inputs, and for GHASH one-block, AAD-only and
empty events and a zero hash key."""

import random

import numpy as np
import pytest

from zktls_tpu.stark.chips import aes128 as jaes128
from zktls_tpu.stark.chips import aes256 as jaes256
from zktls_tpu.stark.chips import ghash as jghash
from zktls_tpu_torch.stark.chips import aes128, aes256, ghash

from .torch_threads import torch_threads_per_worker  # noqa: F401


def _same(port, ref):
    trace, publics = port
    jtrace, jpublics = ref
    assert trace.dtype == jtrace.dtype == np.uint32
    assert trace.shape == jtrace.shape
    np.testing.assert_array_equal(trace, jtrace)
    assert publics == jpublics


def _blocks(rng, key_len, eids, zero=False):
    """(eid, key, input) triples, one key per event id."""
    keys = {e: bytes(key_len) if zero else rng.randbytes(key_len)
            for e in set(eids)}
    return [(e, keys[e], bytes(16) if zero else rng.randbytes(16))
            for e in eids]


#: (id, event ids of the blocks, all-zero key and input)
AES_CASES = [
    ("one-block", [0], False),
    ("16-blocks-no-pad", [0] * 16, False),
    ("256-blocks-no-pad", [0] * 256, False),
    ("17-blocks-one-pad-group", [0] * 17, False),
    ("mixed-eids", [0, 0, 1, 1, 1, 4, 7, 7, 2, 9], False),
    ("zero-key-and-input", [0] * 5, True),
]
AES256_CASES = AES_CASES + [("33-blocks-odd-groups", [3] * 33, False)]


@pytest.mark.parametrize("eids, zero", [c[1:] for c in AES_CASES],
                         ids=[c[0] for c in AES_CASES])
def test_aes128_trace_equals_jax(eids, zero):
    blocks = _blocks(random.Random(1280 + len(eids)), 16, eids, zero)
    _same(aes128.aes128_trace(blocks), jaes128.aes128_trace(blocks))


@pytest.mark.parametrize("eids, zero", [c[1:] for c in AES256_CASES],
                         ids=[c[0] for c in AES256_CASES])
def test_aes256_trace_equals_jax(eids, zero):
    blocks = _blocks(random.Random(2560 + len(eids)), 32, eids, zero)
    _same(aes256.aes256_trace(blocks), jaes256.aes256_trace(blocks))


def _event(rng, eid, n_blocks, h=None):
    """(eid, h, blocks, mask) laid out as a GCM record's GHASH input: one
    AAD block, n_blocks − 2 ciphertext blocks, then the length block (two
    blocks: AAD only; one: the length block alone)."""
    h = rng.getrandbits(128) if h is None else h
    blocks = [rng.getrandbits(128) for _ in range(n_blocks - 1)]
    if n_blocks:
        aad_bits = 128 if n_blocks > 1 else 0
        blocks.append(aad_bits << 64 | 128 * max(n_blocks - 2, 0))
    return (eid, h, blocks, rng.getrandbits(128))


#: (id, per event: (block count, h or None for a random one))
GHASH_CASES = [
    ("one-one-block-event", [(1, None)]),
    ("aad-only-event", [(2, None)]),
    ("events-fill-power-of-two", [(3, None), (2, None), (1, None),
                                  (2, None)]),
    ("zero-blocks-and-zero-h", [(0, None), (3, 0), (4, None)]),
]


@pytest.mark.parametrize("shape", [c[1] for c in GHASH_CASES],
                         ids=[c[0] for c in GHASH_CASES])
def test_ghash_trace_equals_jax(shape):
    rng = random.Random(128 + 10 * len(shape) + shape[0][0])
    events = [_event(rng, eid, k, h) for eid, (k, h) in enumerate(shape)]
    _same(ghash.ghash_trace(events), jghash.ghash_trace(events))
