"""The port's host hashes in C (zktls_tpu_torch/utils/native.py).

Poseidon2 (csrc/poseidon2_host.c) against its pure-Python plain version
and the JAX package's `Poseidon2.permute_ints`: the permutation at widths
16 and 24, the batched leaf sponge and node compression against the port's
`hash_row_ints` / `compress_ints`, the challenger's transcript with and
without C, and a failed build raising.  MP-MiMC over BN254
(csrc/mimc_bn254_host.c): the round constants and `mimc_hash` against the
JAX package's, the C rows hash and pair compression (vector and scalar
paths) against `mimc_hash` and the JAX package's C library, the thread
count, and a broken source or a compiler without OpenMP raising.  Seeded
inputs, exact equality."""

import numpy as np
import pytest

from zktls_tpu.ops.merkle import hash_row_ints as jhash_row_ints
from zktls_tpu.ops.poseidon2 import Poseidon2 as JPoseidon2
from zktls_tpu.snark import wrap as jwrap
from zktls_tpu.utils.native import get_native as jget_native
from zktls_tpu_torch.ops import babybear as bb
from zktls_tpu_torch.ops.field_ref import P
from zktls_tpu_torch.ops.merkle import (
    MerkleTree,
    compress_ints,
    hash_row_ints,
    hash_rows_plain,
    verify_path,
)
from zktls_tpu_torch.ops.poseidon2 import Poseidon2
from zktls_tpu_torch.snark import wrap
from zktls_tpu_torch.snark.bn254 import R
from zktls_tpu_torch.stark.commit_bn import _digests_to_int as _ints
from zktls_tpu_torch.stark.commit_bn import _ints_to_limbs as _limbs
from zktls_tpu_torch.stark.challenger import Challenger
from zktls_tpu_torch.utils import native

from .torch_threads import (  # noqa: F401
    mimc_threads_per_worker,
    torch_threads_per_worker,
)


def _states(width: int, count: int, seed: int) -> np.ndarray:
    """Seeded states with the edge values 0 and p − 1 in the first rows."""
    rng = np.random.default_rng(seed)
    states = rng.integers(0, P, (count, width), dtype=np.uint64)
    states[0] = 0
    states[1] = P - 1
    states[2, ::2] = P - 1
    return states.astype(np.uint32)


@pytest.mark.parametrize("width", [16, 24])
def test_permutation_equals_plain_and_reference(width):
    states = _states(width, 48, seed=width)
    c, plain = Poseidon2(width), Poseidon2(width, native=False)
    ref = JPoseidon2(width)
    batch = native.permute_batch(states, width=width)
    for row, out in zip(states, batch):
        s = [int(x) for x in row]
        want = plain.permute_ints(s)
        assert c.permute_ints(s) == want
        assert [int(x) for x in out] == want
        assert ref.permute_ints(s) == want


def test_permute_ints_reduces_its_inputs():
    """Like the pure-Python version, the C route takes any non-negative
    ints and reduces them mod p first."""
    s = [P + 5, 2 * P, 3, (1 << 40) + 7] * 4
    assert Poseidon2(16).permute_ints(s) == \
        Poseidon2(16, native=False).permute_ints(s)
    with pytest.raises(ValueError, match="state width"):
        Poseidon2(16).permute_ints([1] * 24)


@pytest.mark.parametrize("width", [1, 8, 16, 17, 44, 639])
def test_hash_rows_equals_hash_row_ints(width):
    rows = _states(width, 24, seed=100 + width)
    digests = native.hash_rows(rows)
    for row, digest in zip(rows, digests):
        want = hash_row_ints([int(x) for x in row])
        assert [int(x) for x in digest] == want
        assert jhash_row_ints([int(x) for x in row]) == want
    # the plain torch sponge (Montgomery tensors) gives the same digests
    dev = hash_rows_plain(bb.to_mont(bb.from_numpy(rows)))
    np.testing.assert_array_equal(bb.np_from_mont(bb.to_numpy(dev)), digests)


def test_compress_pairs_equals_compress_ints():
    pairs = _states(16, 40, seed=16016)
    out = native.compress_pairs(pairs)
    for pair, parent in zip(pairs, out):
        p = [int(x) for x in pair]
        assert [int(x) for x in parent] == compress_ints(p[:8], p[8:])


def test_merkle_paths_verify_through_c():
    """Paths of a tree built by the plain torch version verify on the
    host through the C compression, and a changed sibling fails."""
    rows = bb.to_mont(bb.from_numpy(_states(5, 32, seed=5)))
    tree = MerkleTree(rows)
    plain_rows = bb.np_from_mont(bb.to_numpy(rows))
    for j in (0, 13, 31):
        leaf = hash_row_ints([int(x) for x in plain_rows[j]])
        path = tree.open(j)
        assert verify_path(leaf, j, path, tree.root)
        bad = [list(h) for h in path]
        bad[2][0] = (int(bad[2][0]) + 1) % P
        assert not verify_path(leaf, j, bad, tree.root)


def _transcript(ch: Challenger, seed: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for step in range(40):
        ch.observe_many(int(v) for v in rng.integers(0, P, step % 11))
        if step % 3 == 0:
            ch.observe_bytes(rng.bytes(step))
        out.append(ch.sample())
        out.append(ch.sample_ext().c)
        out.append(ch.sample_bits(1 + step % 26))
    out.append(ch.check_witness(4, 12345))
    out.append(ch.state)
    return out


def test_challenger_transcript_same_with_and_without_c():
    assert _transcript(Challenger(), 77) == \
        _transcript(Challenger(native=False), 77)


def test_failed_build_raises_with_the_compiler_message(tmp_path):
    bad = tmp_path / "broken.c"
    bad.write_text("int f(void) { return undefined_name; }\n")
    with pytest.raises(RuntimeError, match="undefined_name"):
        native.build(source=bad, build_dir=tmp_path)


def test_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no C compiler"):
        native.build(build_dir=tmp_path)


def test_library_is_built_from_the_port_source():
    path, _ = native.build()
    assert native.SOURCE.name == "poseidon2_host.c"
    assert path.parent == native.BUILD_DIR and path.exists()
    assert native.build() == (path, "")     # cached: no second compile


# ---------------------------------------------------------------------------
# MP-MiMC over the BN254 scalar field (csrc/mimc_bn254_host.c)
# ---------------------------------------------------------------------------


def _fr_rows(n: int, k: int, seed: int) -> list[list[int]]:
    """Seeded rows of k scalars: 0, r − 1, r and 2^256 − 1 among them (the
    library reduces its inputs mod r, as mimc_hash does)."""
    rng = np.random.default_rng(seed)
    rows = [[int.from_bytes(rng.bytes(32), "little") % R for _ in range(k)]
            for _ in range(n)]
    edges = [0, R - 1, R, (1 << 256) - 1]
    for i, v in enumerate(edges[: n * k]):
        rows[i % n][i // n % k] = v
    return rows


def test_mimc_constants_and_hash_equal_the_reference():
    assert wrap.N_ROUNDS == jwrap.N_ROUNDS
    assert wrap.MIMC_ROUND_CONSTANTS == jwrap.MIMC_ROUND_CONSTANTS
    for chunks in ([], [0], [R - 1], [1, 2, 3], [R + 5, 7, 1 << 250]):
        assert wrap.mimc_hash(chunks) == jwrap.mimc_hash(chunks)


@pytest.mark.parametrize("n,k", [(1, 1), (13, 1), (17, 3), (40, 7)])
@pytest.mark.parametrize("vector", [True, False])
def test_mimc_hash_rows_equals_python_and_reference(n, k, vector):
    """The C rows hash (its vector path, where the CPU has one, and its
    scalar reference code) equals mimc_hash over Python ints and the JAX
    package's C library on the same limbs."""
    rows = _fr_rows(n, k, seed=100 * n + k)
    elems = np.stack([_limbs(r) for r in rows])
    native._set_mimc_vector(vector)
    try:
        got = _ints(native.mimc_hash_rows(elems))
    finally:
        native._set_mimc_vector(True)
    assert got == [wrap.mimc_hash(r) for r in rows]
    assert _ints(jget_native().mimc_hash_rows(elems)) == got


@pytest.mark.parametrize("vector", [True, False])
def test_mimc_compress_pairs_equals_python(vector):
    rows = _fr_rows(23, 2, seed=2323)
    pairs = np.stack([_limbs(r) for r in rows])
    native._set_mimc_vector(vector)
    try:
        got = _ints(native.mimc_compress_pairs(pairs))
    finally:
        native._set_mimc_vector(True)
    assert got == [wrap.mimc_hash(r) for r in rows]
    with pytest.raises(ValueError, match="pairs"):
        native.mimc_compress_pairs(np.zeros((4, 3, 4), dtype=np.uint64))


def test_mimc_threads_are_settable():
    before = native.mimc_threads()
    try:
        assert native.set_mimc_threads(3) == 3 == native.mimc_threads()
        rows = np.stack([_limbs(r) for r in _fr_rows(50, 2, seed=5)])
        three = native.mimc_hash_rows(rows)
        assert native.set_mimc_threads(1) == 1
        np.testing.assert_array_equal(native.mimc_hash_rows(rows), three)
    finally:
        native.set_mimc_threads(before)


def test_mimc_library_is_built_with_openmp_from_the_port_source():
    path, _ = native.build_mimc()
    assert native.MIMC_SOURCE.name == "mimc_bn254_host.c"
    assert "-fopenmp" in native.MIMC_CFLAGS
    assert path.parent == native.BUILD_DIR and path.exists()
    assert native.build_mimc() == (path, "")


def test_mimc_broken_source_raises(tmp_path):
    bad = tmp_path / "mimc_broken.c"
    bad.write_text(native.MIMC_SOURCE.read_text().replace(
        "static int threads(void) {", "static int threads(void) { oops;"))
    with pytest.raises(RuntimeError, match="oops"):
        native.build_mimc(source=bad, build_dir=tmp_path)


def test_mimc_compiler_without_openmp_raises(tmp_path, monkeypatch):
    """A compiler that refuses -fopenmp makes the build raise with its
    message; the source itself refuses a build without OpenMP, so no
    single-threaded library is ever made."""
    fake = tmp_path / "cc"
    fake.write_text("#!/bin/sh\nfor a in \"$@\"; do [ \"$a\" = -fopenmp ] && "
                    "{ echo 'unsupported option -fopenmp' >&2; exit 1; }; "
                    "done\nexec gcc \"$@\"\n")
    fake.chmod(0o755)
    monkeypatch.setattr(native, "_compiler", lambda: str(fake))
    with pytest.raises(RuntimeError, match="unsupported option -fopenmp"):
        native.build_mimc(build_dir=tmp_path)
    monkeypatch.setattr(native, "MIMC_CFLAGS", native.CFLAGS)
    with pytest.raises(RuntimeError, match="must be built with OpenMP"):
        native.build_mimc(build_dir=tmp_path)
