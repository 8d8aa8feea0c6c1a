"""Merkle-tree commitment over Poseidon2 (MMCS-style) on torch tensors.

Counterpart of zktls_tpu.ops.merkle, same scheme:

  * leaf = sponge-hash of a matrix row (rate 16, capacity 8, width-24
    permutation; zero-padded final block, digest = first 8 lanes);
  * node = 2-to-1 compression: permute(left ‖ right), first 8 lanes;
  * levels are halved bottom-up with one batched permutation per level.

On a CUDA tensor the leaf sponge and the levels run in the hand-written
kernels (`cuda_poseidon2.hash_rows`, one launch per matrix, and
`cuda_poseidon2.merkle_levels`, one launch per nine levels); on a CPU tensor
in the plain versions beside them, loops over `permute_batch_plain`.  Device
tensors are Montgomery form; the host-side scalar mirror (`hash_row_ints`,
`compress_ints`, `verify_path`) works on plain ints for the verifier.
"""

from __future__ import annotations

import numpy as np
import torch

from . import babybear as bb
from .field_ref import P
from .poseidon2 import Poseidon2, permute_batch_plain

__all__ = [
    "DIGEST_WIDTH", "LEAF_WIDTH", "LEAF_RATE", "WIDTH", "hash_rows",
    "hash_rows_plain", "tree_levels", "tree_levels_plain", "level_bounds",
    "MerkleTree", "hash_row_ints", "compress_ints",
    "verify_path",
]

DIGEST_WIDTH = 8
#: leaf sponge: width-24 permutation, rate 16, capacity 8
LEAF_WIDTH = 24
LEAF_RATE = 16
#: node compression: width 16
WIDTH = 16
#: tree rows per block moved to the host
_HOST_ROWS = 1 << 22


def _no_path(t: torch.Tensor):
    return ValueError(f"no Poseidon2 path for device {t.device}")


def hash_rows_plain(rows: torch.Tensor) -> torch.Tensor:
    """`hash_rows` with plain torch ops, on any device: one batched
    permutation per 16 columns."""
    n, w = rows.shape
    state = torch.zeros((n, LEAF_WIDTH), dtype=bb.DTYPE, device=rows.device)
    for i in range(-(-w // LEAF_RATE)):
        chunk = rows[:, i * LEAF_RATE : (i + 1) * LEAF_RATE]
        if chunk.shape[1] < LEAF_RATE:
            chunk = torch.nn.functional.pad(
                chunk, (0, LEAF_RATE - chunk.shape[1]))
        absorbed = bb.add(state[:, :LEAF_RATE], chunk)
        state = permute_batch_plain(
            torch.cat([absorbed, state[:, LEAF_RATE:]], dim=1))
    return state[:, :DIGEST_WIDTH]


def hash_rows(rows: torch.Tensor) -> torch.Tensor:
    """Hash each row of (N, W) to an (N, 8) digest (Montgomery in/out): the
    fused sponge kernel for a CUDA tensor, the plain version for a CPU
    tensor."""
    if rows.is_cuda:
        from . import cuda_poseidon2

        return cuda_poseidon2.hash_rows(rows)
    if rows.device.type == "cpu":
        return hash_rows_plain(rows)
    raise _no_path(rows)


def level_bounds(n_leaves: int) -> list[tuple[int, int]]:
    """(start, stop) rows of every level in the (2N − 1, 8) tree buffer:
    the N leaves first, then N/2 parents, …, the root in the last row."""
    bounds, start, size = [], 0, n_leaves
    while size >= 1:
        bounds.append((start, start + size))
        start += size
        size //= 2
    return bounds


def _check_leaves(leaves: torch.Tensor) -> int:
    n = leaves.shape[0]
    if n < 1 or n & (n - 1) or leaves.shape[1:] != (DIGEST_WIDTH,):
        raise ValueError("leaves must be (N, 8) for a power of two N")
    return n


def tree_levels_plain(leaves: torch.Tensor) -> torch.Tensor:
    """`tree_levels` with plain torch ops, on any device: one batched
    permutation per level."""
    _check_leaves(leaves)
    levels = [leaves]
    while levels[-1].shape[0] > 1:
        pairs = levels[-1].reshape(-1, 2 * DIGEST_WIDTH)
        levels.append(permute_batch_plain(pairs)[:, :DIGEST_WIDTH])
    return torch.cat(levels, dim=0)


def tree_levels(leaves: torch.Tensor) -> torch.Tensor:
    """(N, 8) leaf digests -> the (2N − 1, 8) buffer of every tree level
    (see `level_bounds`), each node permute(left ‖ right)[:8]: the fused
    tree kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if leaves.is_cuda:
        from . import cuda_poseidon2

        n = _check_leaves(leaves)
        buf = torch.empty((2 * n - 1, DIGEST_WIDTH), dtype=bb.DTYPE,
                          device=leaves.device)
        buf[:n] = leaves
        return cuda_poseidon2.merkle_levels(buf)
    if leaves.device.type == "cpu":
        return tree_levels_plain(leaves)
    raise _no_path(leaves)


class MerkleTree:
    """Bottom-up tree over row digests; keeps every level for openings.

    level[0] = leaf digests (natural row order), level[k] halves
    level[k-1] by compressing adjacent pairs (2i, 2i+1).  All levels are
    built in one buffer and pulled to the host (plain form) in one copy,
    so root and open() cost no device round trips.

    defer=True only enqueues the device work: the copy to the host (which
    waits for the device) happens at the first read of `levels_np`, `root`
    or `open()`, so trees on several devices can be built at once."""

    def __init__(self, rows: torch.Tensor, defer: bool = False):
        n = rows.shape[0]
        if n & (n - 1):
            raise ValueError("leaf count must be a power of two")
        self._n = n
        self._buf = tree_levels(hash_rows(rows))
        self._levels = None
        if not defer:
            self.levels_np

    @property
    def levels_np(self) -> list[np.ndarray]:
        """Every level, leaves first, as plain-form numpy (n_level, 8)."""
        if self._levels is None:
            # out of Montgomery form where the tree is, in row blocks
            # beside a 2^26-leaf tree
            nodes = bb.to_plain_numpy(self._buf, _HOST_ROWS)
            self._levels = [nodes[a:b] for a, b in level_bounds(self._n)]
            self._buf = None
        return self._levels

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
