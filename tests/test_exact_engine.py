"""Exact-mode engine vs the independent numpy oracle."""

import numpy as np
import pytest

from fastsk_jax.kernel.config import KernelConfig
from fastsk_jax.kernel.engine import DenseGkmEngine, cosine_normalize
from fastsk_jax.ops.encode import encode_sequences

from conftest import random_ragged_seqs
from oracle import exact_counts, exact_kernel


def run_exact(X, g, m, n_train=None, **cfg_kwargs):
    n_train = len(X) if n_train is None else n_train
    enc = encode_sequences(X[:n_train], X[n_train:])
    engine = DenseGkmEngine(enc, g, m, KernelConfig(**cfg_kwargs))
    return engine.exact()


def test_small_fixture_exact(small_train):
    X, Y, _ = small_train
    counts = run_exact(X, g=3, m=1)
    expected = exact_counts(X, 3, 1)
    np.testing.assert_array_equal(counts, expected)


def test_small_fixture_normalized_bitwise(small_train):
    X, _, _ = small_train
    enc = encode_sequences(X)
    engine = DenseGkmEngine(enc, 4, 2)
    ours = cosine_normalize(engine.exact())
    theirs = exact_kernel(X, 4, 2)
    # bit-identical: same integer counts, same float64 normalization order
    assert ours.tobytes() == theirs.tobytes()


@pytest.mark.parametrize(
    "n,lmin,lmax,alphabet,g,m",
    [
        (6, 8, 20, 4, 5, 2),
        (10, 10, 30, 4, 7, 4),
        (7, 12, 25, 20, 6, 3),  # protein-sized alphabet, small k
        (5, 6, 10, 3, 6, 1),  # k=5 odd split
        (5, 8, 12, 4, 4, 3),  # k=1 degenerate second level
    ],
)
def test_random_ragged_exact(rng, n, lmin, lmax, alphabet, g, m):
    X = random_ragged_seqs(rng, n, lmin, lmax, alphabet)
    counts = run_exact(X, g, m)
    expected = exact_counts(X, g, m)
    np.testing.assert_array_equal(counts, expected)


def test_row_chunking_invariance(rng):
    X = random_ragged_seqs(rng, 9, 10, 22, 4)
    counts_a = run_exact(X, 6, 3, row_chunk=8)
    counts_b = run_exact(X, 6, 3, row_chunk=3 * 8)
    np.testing.assert_array_equal(counts_a, counts_b)


def test_theta_batch_invariance(rng):
    X = random_ragged_seqs(rng, 8, 10, 18, 4)
    counts_a = run_exact(X, 7, 3, theta_batch=1)
    counts_b = run_exact(X, 7, 3, theta_batch=16)
    np.testing.assert_array_equal(counts_a, counts_b)


def test_train_test_split_roles(rng):
    """Counts must not depend on where the train/test boundary falls."""
    X = random_ragged_seqs(rng, 8, 10, 18, 4)
    counts_a = run_exact(X, 5, 2, n_train=8)
    counts_b = run_exact(X, 5, 2, n_train=3)
    np.testing.assert_array_equal(counts_a, counts_b)


def test_spill_path(rng):
    """Force frequent host spills; result must be unchanged."""
    X = random_ragged_seqs(rng, 6, 10, 16, 4)
    enc = encode_sequences(X)
    engine = DenseGkmEngine(enc, 6, 3, KernelConfig(theta_batch=4))
    engine.spill_every_thetas = 4
    counts = engine.exact()
    np.testing.assert_array_equal(counts, exact_counts(X, 6, 3))


def test_dense_engine_count_split_long_sequences(rng):
    """Windows/sequence beyond the f32-exact bound (p_max > 4095) use the
    8-bit count-digit split; integers must stay exact, incl. heavy
    repetition (large per-bucket counts)."""
    from fastsk_jax.kernel.config import KernelConfig
    from fastsk_jax.kernel.engine import DenseGkmEngine
    from fastsk_jax.ops.combinatorics import enumerate_combinations
    from fastsk_jax.ops.encode import encode_sequences

    import oracle

    X = [
        ([1, 2] * 2500)[:4600],  # 4596 windows of a repeating motif
        rng.integers(1, 4, size=4300).tolist(),
        rng.integers(1, 4, size=4500).tolist(),
    ]
    g, m = 5, 2
    enc = encode_sequences(X)
    eng = DenseGkmEngine(enc, g, m, KernelConfig())
    assert eng.count_split
    thetas = enumerate_combinations(g, g - m)[:4]
    ours = eng._sum_thetas(thetas)
    want = oracle.counts_for_thetas(X, g, thetas)
    np.testing.assert_array_equal(ours, want)


def test_dense_engine_count_split_approx(rng):
    from fastsk_jax.kernel.config import KernelConfig
    from fastsk_jax.kernel.engine import DenseGkmEngine
    from fastsk_jax.ops.encode import encode_sequences

    X = [([1, 2, 3] * 1600)[:4400], rng.integers(1, 4, size=4200).tolist()]
    enc = encode_sequences(X)
    eng = DenseGkmEngine(enc, 5, 2, KernelConfig())
    assert eng.count_split
    res = eng.approx(max_iters=3, skip_variance=False, seed=1)
    assert res.iters <= 3
    res2 = eng.approx(max_iters=3, skip_variance=True, seed=1)
    assert res2.counts.max() > 0
