"""Packed (ragged) all-pairs engine vs the numpy oracle — exact equality."""

import numpy as np
import pytest

from fastsk_jax import FastSK, KernelConfig
from fastsk_jax.kernel.pairs_engine import PackedPairsEngine
from fastsk_jax.ops.encode import encode_sequences

import oracle
from conftest import random_ragged_seqs


@pytest.fixture
def small_tile():
    orig = PackedPairsEngine.TILE
    PackedPairsEngine.TILE = 64
    yield
    PackedPairsEngine.TILE = orig


@pytest.mark.parametrize(
    "g,m,n,lmin,lmax,alpha",
    [
        (6, 3, 9, 8, 30, 4),
        (5, 2, 12, 6, 60, 3),
        (8, 4, 10, 10, 40, 20),  # protein-sized alphabet
        (6, 5, 14, 7, 25, 30),  # text-sized alphabet
        (12, 6, 8, 18, 40, 4),  # two base-256 digit planes
        (11, 4, 8, 12, 40, 4),  # two base-128 digit planes
        (6, 3, 8, 60, 150, 4),  # sequences straddle several strips
        (6, 3, 6, 100, 200, 4),  # each sequence spans > 1 strip
    ],
)
def test_packed_matches_oracle(rng, small_tile, g, m, n, lmin, lmax, alpha):
    X = random_ragged_seqs(rng, n, lmin, lmax, alphabet=alpha)
    K_o = oracle.exact_counts(X, g, m)
    eng = PackedPairsEngine(encode_sequences(X), g, m, KernelConfig())
    np.testing.assert_array_equal(K_o, eng.exact())


def test_packed_strip_straddling_sequences(rng, small_tile):
    """Sequences longer than a strip split across strips; the P/P^T
    accumulation must count every ordered row pair exactly once."""
    X = random_ragged_seqs(rng, 6, 100, 200, alphabet=4)
    K_o = oracle.exact_counts(X, 6, 3)
    eng = PackedPairsEngine(encode_sequences(X), 6, 3, KernelConfig())
    assert eng.n_strips > 5  # genuinely split
    np.testing.assert_array_equal(K_o, eng.exact())


def test_packed_repetitive_and_mixed(rng, small_tile):
    X = [[1] * 150, [1] * 150, [1, 2, 3, 4] * 40]
    X += random_ragged_seqs(rng, 8, 8, 160, alphabet=4)
    K_o = oracle.exact_counts(X, 5, 2)
    eng = PackedPairsEngine(encode_sequences(X), 5, 2, KernelConfig())
    np.testing.assert_array_equal(K_o, eng.exact())


def test_packed_multi_digit_planes(rng, small_tile):
    """C(g, k) > 255 forces two digit planes."""
    X = random_ragged_seqs(rng, 8, 18, 40, alphabet=4)
    g, m = 12, 6  # C(12,6) = 924 -> 2 digits
    eng = PackedPairsEngine(encode_sequences(X), g, m, KernelConfig())
    assert eng.n_digits == 2
    K_o = oracle.exact_counts(X, g, m)
    np.testing.assert_array_equal(K_o, eng.exact())


def test_api_routes_ragged_to_packed(rng):
    """Heavily ragged data auto-routes to the packed engine and matches
    the theta engine exactly through the public API."""
    X = random_ragged_seqs(rng, 10, 8, 80, alphabet=4)
    fsk = FastSK(g=6, m=2)
    engine = fsk._make_exact_engine(encode_sequences(X))
    assert type(engine).__name__ == "PackedPairsEngine"
    fsk.compute_train(X)
    ref = FastSK(g=6, m=2, config=KernelConfig(exact_engine="theta"))
    ref.compute_train(X)
    np.testing.assert_array_equal(ref.kernel_counts, fsk.kernel_counts)


def test_api_guard_rejected_falls_to_packed(rng):
    """Shapes over the seq-aligned int32 bound (long seqs, big C(g,k))
    now go to the packed engine instead of the slow theta path."""
    X = [rng.integers(1, 5, size=800).tolist() for _ in range(3)]
    fsk = FastSK(g=16, m=10)
    engine = fsk._make_exact_engine(encode_sequences(X))
    assert type(engine).__name__ == "PackedPairsEngine"


def test_digit_base_policy(rng, small_tile):
    """One plane at base 128 when that adds no plane, else base 256:
    C(8,4)=70 -> one base-128 digit; C(11,7)=330 -> two base-128 digits;
    C(10,4)=210 -> one base-256 digit (128 would need two)."""
    X = random_ragged_seqs(rng, 6, 16, 40, alphabet=4)

    def eng(g, m):
        return PackedPairsEngine(encode_sequences(X), g, m, KernelConfig())

    assert (eng(8, 4).digit_base, eng(8, 4).n_digits) == (128, 1)
    assert (eng(11, 4).digit_base, eng(11, 4).n_digits) == (128, 2)
    assert (eng(10, 6).digit_base, eng(10, 6).n_digits) == (256, 1)


def test_planes_to_host_tiles_and_fallback(rng):
    """The tiled upper-triangle transfer path must reproduce the plain
    per-plane combination, including across 512-tile boundaries and on
    the int64 host fallback when the runtime bound exceeds int32."""
    import jax.numpy as jnp

    from fastsk_jax.ops import pairs_packed as pk

    n_pad = 700  # crosses one 512-tile boundary
    base = 16
    a = rng.integers(0, 9, (n_pad, n_pad)).astype(np.int64)
    b = rng.integers(0, 9, (n_pad, n_pad)).astype(np.int64)
    a, b = a + a.T, b + b.T  # symmetric like real digit planes
    planes = (jnp.asarray(a, jnp.int32), jnp.asarray(b, jnp.int32))

    class Shim:
        n = 641
        n_digits = 2
        digit_base = base
    shim = Shim()
    from fastsk_jax.kernel.pairs_engine import PackedPairsEngine

    out = PackedPairsEngine._planes_to_host(shim, planes)
    ref = (a + base * b)[: shim.n, : shim.n]
    np.testing.assert_array_equal(out, ref)

    # force the > int32 bound branch with per-plane spikes
    a2, b2 = a.copy(), b.copy()
    a2[0, 1] = a2[1, 0] = 1 << 30
    b2[2, 3] = b2[3, 2] = 1 << 27
    maxes_bound = (1 << 30) + base * (1 << 27)
    assert maxes_bound >= 2**31  # the fallback branch is the one under test
    planes2 = (jnp.asarray(a2, jnp.int32), jnp.asarray(b2, jnp.int32))
    out2 = PackedPairsEngine._planes_to_host(shim, planes2)
    ref2 = (a2 + base * b2)[: shim.n, : shim.n]
    np.testing.assert_array_equal(out2, ref2)
