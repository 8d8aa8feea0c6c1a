"""Merkle-tree commitment over Poseidon2 (MMCS-style) on torch tensors.

Counterpart of zktls_tpu.ops.merkle, same scheme:

  * leaf = sponge-hash of a matrix row (rate 16, capacity 8, width-24
    permutation; zero-padded final block, digest = first 8 lanes);
  * node = 2-to-1 compression: permute(left ‖ right), first 8 lanes;
  * levels are halved bottom-up with one batched permutation per level.

Every device permutation goes through `poseidon2.permute_batch`, so on the
card through the hand-written kernel.  Device tensors are Montgomery form;
the host-side scalar mirror (`hash_row_ints`, `compress_ints`,
`verify_path`) works on plain ints for the verifier.
"""

from __future__ import annotations

import numpy as np
import torch

from . import babybear as bb
from .field_ref import P
from .poseidon2 import Poseidon2, permute_batch

__all__ = [
    "DIGEST_WIDTH", "LEAF_WIDTH", "LEAF_RATE", "WIDTH", "hash_rows",
    "compress_level", "MerkleTree", "hash_row_ints", "compress_ints",
    "verify_path",
]

DIGEST_WIDTH = 8
#: leaf sponge: width-24 permutation, rate 16, capacity 8
LEAF_WIDTH = 24
LEAF_RATE = 16
#: node compression: width 16
WIDTH = 16


def hash_rows(rows: torch.Tensor) -> torch.Tensor:
    """Hash each row of (N, W) to an (N, 8) digest (Montgomery in/out)."""
    n, w = rows.shape
    state = torch.zeros((n, LEAF_WIDTH), dtype=bb.DTYPE, device=rows.device)
    for i in range(-(-w // LEAF_RATE)):
        chunk = rows[:, i * LEAF_RATE : (i + 1) * LEAF_RATE]
        if chunk.shape[1] < LEAF_RATE:
            chunk = torch.nn.functional.pad(
                chunk, (0, LEAF_RATE - chunk.shape[1]))
        absorbed = bb.add(state[:, :LEAF_RATE], chunk)
        state = permute_batch(torch.cat([absorbed, state[:, LEAF_RATE:]],
                                        dim=1))
    return state[:, :DIGEST_WIDTH]


def compress_level(digests: torch.Tensor) -> torch.Tensor:
    """(2k, 8) sibling digests -> (k, 8) parents (permute(l ‖ r)[:8])."""
    n = digests.shape[0]
    if n % 2:
        raise ValueError("level size must be even")
    pairs = digests.reshape(n // 2, 2 * DIGEST_WIDTH)
    return permute_batch(pairs)[:, :DIGEST_WIDTH]


class MerkleTree:
    """Bottom-up tree over row digests; keeps every level for openings.

    level[0] = leaf digests (natural row order), level[k] halves
    level[k-1] by compressing adjacent pairs (2i, 2i+1).  The finished
    levels are pulled to the host (plain form) once, so root and open()
    cost no device round trips."""

    def __init__(self, rows: torch.Tensor):
        n = rows.shape[0]
        if n & (n - 1):
            raise ValueError("leaf count must be a power of two")
        level = hash_rows(rows)
        levels = [level]
        while level.shape[0] > 1:
            level = compress_level(level)
            levels.append(level)
        self.levels_np = [bb.np_from_mont(bb.to_numpy(lv)) for lv in levels]

    @property
    def root(self) -> np.ndarray:
        """Root digest as plain-form numpy (8,)."""
        return self.levels_np[-1][0]

    def open(self, index: int) -> list[np.ndarray]:
        """Sibling path (plain form) for a leaf index."""
        path = []
        for level in self.levels_np[:-1]:
            path.append(level[index ^ 1])
            index >>= 1
        return path


# ---------------------------------------------------------------------------
# host-side scalar mirror (verifier)
# ---------------------------------------------------------------------------

_PERM16 = Poseidon2(WIDTH)
_PERM24 = Poseidon2(LEAF_WIDTH)


def hash_row_ints(row: list[int]) -> list[int]:
    state = [0] * LEAF_WIDTH
    n_blocks = -(-len(row) // LEAF_RATE) if row else 1
    for i in range(n_blocks):
        chunk = row[i * LEAF_RATE : (i + 1) * LEAF_RATE]
        chunk = list(chunk) + [0] * (LEAF_RATE - len(chunk))
        state = [
            (state[j] + chunk[j]) % P if j < LEAF_RATE else state[j]
            for j in range(LEAF_WIDTH)
        ]
        state = _PERM24.permute_ints(state)
    return state[:DIGEST_WIDTH]


def compress_ints(left: list[int], right: list[int]) -> list[int]:
    return _PERM16.permute_ints(list(left) + list(right))[:DIGEST_WIDTH]


def verify_path(leaf_digest: list[int], index: int, path: list,
                root: list[int]) -> bool:
    node = list(leaf_digest)
    for sibling in path:
        sib = [int(x) for x in sibling]
        if index & 1:
            node = compress_ints(sib, node)
        else:
            node = compress_ints(node, sib)
        index >>= 1
    return node == [int(x) for x in root]
