"""Sorted/rank engine vs the numpy oracle — exact integer equality."""

import numpy as np
import pytest

from fastsk_jax import FastSK, KernelConfig
from fastsk_jax.kernel.sorted_engine import SortedGkmEngine
from fastsk_jax.ops.encode import encode_sequences

import oracle
from conftest import random_ragged_seqs


@pytest.mark.parametrize(
    "g,m,n,lmin,lmax,alpha,slab",
    [
        (6, 3, 9, 8, 20, 4, 64),  # tiny slab: exercises many boundaries
        (6, 3, 9, 8, 20, 4, 8192),  # one slab
        (8, 2, 10, 9, 24, 25, 128),  # protein-sized alphabet, k=6
        (5, 2, 7, 6, 14, 30, 64),  # text-sized alphabet
        (7, 3, 12, 8, 18, 4, 32),  # slab smaller than runs stress
    ],
)
def test_sorted_exact_matches_oracle(rng, g, m, n, lmin, lmax, alpha, slab):
    X = random_ragged_seqs(rng, n, lmin, lmax, alphabet=alpha)
    K_oracle = oracle.exact_counts(X, g, m)
    eng = SortedGkmEngine(
        encode_sequences(X), g, m, KernelConfig(sorted_slab=slab)
    )
    np.testing.assert_array_equal(K_oracle, eng.exact())


def test_sorted_exact_heavy_runs(rng):
    """Identical/repetitive sequences create runs with many pairs that
    straddle slab boundaries — the cross-slab correction must be exact."""
    X = [[1] * 14, [1] * 14, [1] * 12, [1, 2] * 7, [2, 1] * 7]
    X += random_ragged_seqs(rng, 5, 10, 14, alphabet=2)
    K_oracle = oracle.exact_counts(X, 4, 2)
    eng = SortedGkmEngine(encode_sequences(X), 4, 2, KernelConfig(sorted_slab=4))
    np.testing.assert_array_equal(K_oracle, eng.exact())


def test_sorted_count_split_int8_digits(rng):
    """255 < p_max <= 4095 routes the slab matmuls through the single
    f32-HIGHEST gram ("f32x3" mode, exact below 2^24 per-pass entries);
    the same data forced through the base-128 int8 digit split
    (count_split=True, the p_max > 4095 mode) must agree bit for bit —
    low-complexity long sequences push per-pair counts past 255 so both
    digits are live."""
    rep = [1, 2, 1, 1, 2, 2] * 50  # len 300, highly repetitive
    X = [rep, rep[:-6], [2, 1] * 140]
    X += random_ragged_seqs(rng, 4, 260, 300, alphabet=2)
    g, m = 4, 2
    eng = SortedGkmEngine(encode_sequences(X), g, m, KernelConfig(sorted_slab=256))
    assert eng.p_max > 255
    assert eng._static_kwargs()["count_split"] == "f32x3"
    K_oracle = oracle.exact_counts(X, g, m)
    assert K_oracle.max() // 3 > 255 * 255  # per-pass products exceed lo*lo
    np.testing.assert_array_equal(K_oracle, eng.exact())

    # force the int8 digit mode on the same shapes: bit-identical
    from fastsk_jax.ops.combinatorics import enumerate_combinations
    from fastsk_jax.ops.sorted_theta import sorted_theta_pass

    statics = dict(eng._static_kwargs(), count_split=True)
    th = enumerate_combinations(g, g - m)
    total = None
    for t in th:
        import jax.numpy as jnp

        ks = np.asarray(sorted_theta_pass(
            eng._windows, eng._valid, eng._seq_of,
            jnp.asarray(t, jnp.int32), **statics,
        ), dtype=np.int64)
        total = ks if total is None else total + ks
    np.testing.assert_array_equal(K_oracle, total)


def test_sorted_batch_sum_bitexact(rng):
    """The fused batch-sum (skip_variance fast path) must equal summing
    individual passes."""
    import jax.numpy as jnp

    from fastsk_jax.ops.combinatorics import enumerate_combinations

    X = random_ragged_seqs(rng, 8, 8, 20, alphabet=20)
    eng = SortedGkmEngine(encode_sequences(X), 6, 3, KernelConfig(sorted_slab=64))
    thetas = enumerate_combinations(6, 3)[:5]
    acc = jnp.zeros((eng.n, eng.n), jnp.int32)
    fused = np.asarray(eng._pass_batch_sum(acc, thetas))
    ref = sum(np.asarray(eng._pass(t), dtype=np.int64) for t in thetas)
    np.testing.assert_array_equal(fused, ref)


def test_sorted_long_documents(rng):
    """p_max > 4096 (the round-1 ceiling): repetitive long documents push
    run counts past 4096, so cross-slab corrections produce products above 2^24
    that only the int32 path keeps exact, and the int8 hi digit exceeds
    the old base-256 range."""
    L = 4400
    X = [
        [1] * L,
        [1] * (L - 8),
        list(rng.integers(1, 3, L - 16)),
    ]
    g, m = 4, 1
    eng = SortedGkmEngine(
        encode_sequences(X), g, m, KernelConfig(sorted_slab=512)
    )
    assert eng.p_max > 4096
    K_oracle = oracle.exact_counts(X, g, m)
    assert K_oracle.max() > (1 << 24)  # f32 products would round here
    np.testing.assert_array_equal(K_oracle, eng.exact())


def test_sorted_adaptive_spill_forced(rng):
    """Shrinking the accumulator limit forces the adaptive max-check
    spill path; results must be bit-identical to the unspilled run."""
    X = random_ragged_seqs(rng, 6, 40, 60, alphabet=4)
    g, m = 6, 2
    ref_eng = SortedGkmEngine(encode_sequences(X), g, m, KernelConfig())
    K_ref = ref_eng.exact()

    eng = SortedGkmEngine(encode_sequences(X), g, m, KernelConfig())
    eng._adaptive_spill = True
    eng._acc_limit = eng._per_theta_bound * (eng.theta_batch + 1)
    np.testing.assert_array_equal(K_ref, eng.exact())

    # Welford (variance-tracked) stream with spills: counts + iteration
    # trajectory unchanged
    ref2 = ref_eng.approx(max_iters=9, seed=3)
    res = eng.approx(max_iters=9, seed=3)
    assert res.iters == ref2.iters
    np.testing.assert_array_equal(res.counts, ref2.counts)


def test_sorted_tri_blocked_gram(rng):
    """Upper-block-triangle count-matmuls (the exact/skip-variance matmul
    saving) must reproduce the oracle exactly after the engine's mirror,
    on both the bf16 and the int8 digit-split paths."""
    for alphabet, reps in ((20, 1), (2, 40)):
        X = random_ragged_seqs(rng, 9, 8, 20, alphabet=alphabet)
        if reps > 1:  # repeat content so counts exceed 255 (count_split)
            X = [list(x) * reps for x in X]
        g, m = 5, 2
        eng = SortedGkmEngine(
            encode_sequences(X), g, m, KernelConfig(sorted_slab=64)
        )
        eng._tri_blocks = 3
        K_oracle = oracle.exact_counts(X, g, m)
        np.testing.assert_array_equal(K_oracle, eng.exact())

        res = eng.approx(skip_variance=True, max_iters=4, seed=1)
        thetas = _stream(eng, seed=1)[:4]
        np.testing.assert_array_equal(
            res.counts, oracle.counts_for_thetas(X, g, thetas)
        )


def _stream(eng, seed):
    from fastsk_jax.ops.combinatorics import enumerate_combinations

    rng2 = np.random.default_rng(seed)
    all_t = enumerate_combinations(eng.g, eng.k)
    return all_t[rng2.permutation(len(all_t))]


def test_sorted_multiword_hash(rng):
    """k * log2(base) > 31 forces multi-word lexicographic keys."""
    X = random_ragged_seqs(rng, 8, 16, 24, alphabet=30)
    K_oracle = oracle.exact_counts(X, 14, 4)  # k=10, 30^10 >> 2^31
    eng = SortedGkmEngine(encode_sequences(X), 14, 4, KernelConfig())
    assert eng.n_words >= 2
    np.testing.assert_array_equal(K_oracle, eng.exact())


def test_sorted_approx_counts_match_explicit_thetas(rng):
    """skip_variance approx over a seeded stream must equal the oracle's
    sum over the same explicit subsets."""
    from fastsk_jax.ops.combinatorics import enumerate_combinations

    X = random_ragged_seqs(rng, 8, 10, 16, alphabet=20)
    g, m, seed, iters = 7, 3, 11, 9
    eng = SortedGkmEngine(encode_sequences(X), g, m, KernelConfig(sorted_slab=64))
    res = eng.approx(max_iters=iters, skip_variance=True, seed=seed)
    stream_rng = np.random.default_rng(seed)
    all_thetas = enumerate_combinations(g, g - m)
    stream = all_thetas[stream_rng.permutation(len(all_thetas))][:iters]
    K_expected = oracle.counts_for_thetas(X, g, stream)
    np.testing.assert_array_equal(K_expected, res.counts)


def test_sorted_approx_welford_semantics(rng):
    # small alphabet so sequences share k-mers and the variance is nonzero
    X = random_ragged_seqs(rng, 10, 14, 20, alphabet=3)
    eng = SortedGkmEngine(encode_sequences(X), 8, 4, KernelConfig())
    res = eng.approx(max_iters=6, seed=3)
    assert res.iters == 6
    assert len(res.stdevs) == 6
    assert res.stdevs[0] == pytest.approx(np.sqrt(9999999), rel=1e-5)


def test_api_routes_big_alphabet_to_sorted(rng):
    """Large base**k goes to the sorted engine and still matches the oracle
    through the public API (approx skip_variance full enumeration)."""
    X = random_ragged_seqs(rng, 7, 9, 14, alphabet=28)
    fsk = FastSK(g=6, m=2)  # k=4: 28^4 = 614k > default dense limit
    engine = fsk._make_engine(encode_sequences(X))
    assert type(engine).__name__ == "SortedGkmEngine"
    fsk.compute_train(X)
    K_oracle = oracle.exact_counts(X, 6, 2)
    np.testing.assert_array_equal(K_oracle, fsk.kernel_counts)


def test_sorted_batch_pass_bitexact_vs_single(rng):
    """sorted_theta_pass_batch slices must equal per-theta passes."""
    from fastsk_jax.ops.combinatorics import enumerate_combinations
    from fastsk_jax.ops.sorted_theta import (
        sorted_theta_pass,
        sorted_theta_pass_batch,
    )

    X = random_ragged_seqs(rng, 8, 8, 20, alphabet=20)
    eng = SortedGkmEngine(encode_sequences(X), 6, 3, KernelConfig(sorted_slab=64))
    thetas = enumerate_combinations(6, 3)[:5]
    batch = eng._pass_batch(thetas)
    for j, th in enumerate(thetas):
        np.testing.assert_array_equal(np.asarray(eng._pass(th)), np.asarray(batch[j]))


def test_sorted_sharded_adaptive_spill(rng):
    """Forced adaptive spills on the mesh path (global-max check +
    host_gather mid-stream) must stay bit-identical."""
    import jax

    from fastsk_jax.parallel import make_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    X = random_ragged_seqs(rng, 7, 20, 40, alphabet=6)
    enc = encode_sequences(X)
    ref = SortedGkmEngine(enc, 7, 3, KernelConfig(sorted_slab=128)).exact()
    eng = SortedGkmEngine(
        enc, 7, 3, KernelConfig(sorted_slab=128, mesh=make_mesh(2, 4))
    )
    eng._adaptive_spill = True
    eng._acc_limit = eng._per_theta_bound * (eng.theta_batch + 2)
    np.testing.assert_array_equal(ref, eng.exact())


def test_sorted_sharded_matches_single_device(rng):
    import jax

    from fastsk_jax.parallel import make_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = make_mesh(2, 4)
    X = random_ragged_seqs(rng, 9, 8, 20, alphabet=25)
    enc = encode_sequences(X)
    single = SortedGkmEngine(enc, 8, 3, KernelConfig(sorted_slab=128))
    k1 = single.exact()
    sharded = SortedGkmEngine(
        enc, 8, 3, KernelConfig(sorted_slab=128, mesh=mesh)
    )
    k2 = sharded.exact()
    np.testing.assert_array_equal(k1, k2)
    np.testing.assert_array_equal(k1, oracle.exact_counts(X, 8, 3))


def test_sorted_rowsharded_memory_layout(rng):
    """mesh_state="sharded" (default) keeps an O(N^2/R) row strip per
    device — assert the addressable shard shapes actually shrink with the
    rows axis — and stays integer-identical to mesh_state="replicated"
    and to the single device."""
    import jax

    from fastsk_jax.parallel import make_mesh
    from fastsk_jax.parallel import sharding as shd

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    X = random_ragged_seqs(rng, 10, 8, 20, alphabet=25)
    enc = encode_sequences(X)
    ref = SortedGkmEngine(enc, 8, 3, KernelConfig(sorted_slab=128)).exact()

    mesh = make_mesh(4, 2)  # R=4: strips of ceil(10/4)=3 rows
    eng = SortedGkmEngine(enc, 8, 3, KernelConfig(sorted_slab=128, mesh=mesh))
    assert eng.config.mesh_state == "sharded"

    # capture the sharded accumulator the stream builds
    seen = {}
    orig = shd.sorted_batch_rowsharded

    def spy(k_rows, *a, **kw):
        out = orig(k_rows, *a, **kw)
        seen["shards"] = [s.data.shape for s in out.addressable_shards]
        seen["global"] = out.shape
        return out

    shd.sorted_batch_rowsharded = spy
    try:
        k_sharded = eng.exact()
    finally:
        shd.sorted_batch_rowsharded = orig
    np.testing.assert_array_equal(ref, k_sharded)
    n_pad = -(-10 // 4) * 4
    assert seen["global"] == (n_pad, 10)
    # every addressable shard is one row strip: [n_pad/R, n]
    assert all(s == (n_pad // 4, 10) for s in seen["shards"])

    k_repl = SortedGkmEngine(
        enc, 8, 3,
        KernelConfig(sorted_slab=128, mesh=mesh, mesh_state="replicated"),
    ).exact()
    np.testing.assert_array_equal(ref, k_repl)


def test_sorted_layout_runs_vs_pairs_bitexact(rng):
    """The run-aligned slab layout (the default) and the round-1..3
    pair-aligned layout produce bit-identical integers on every path:
    exact, batched, device-resident, approx."""
    X = random_ragged_seqs(rng, 11, 8, 22, alphabet=25)
    enc = encode_sequences(X)
    assert KernelConfig().sorted_layout == "runs"  # the default
    mk = lambda layout, **kw: SortedGkmEngine(  # noqa: E731
        enc, 7, 3,
        KernelConfig(sorted_layout=layout, sorted_slab=64,
                     sorted_run_width=32, **kw),
    )
    kp = mk("pairs").exact()
    kr = mk("runs").exact()
    np.testing.assert_array_equal(kp, kr)
    # batched [T, n, n] (the Welford unit)
    from fastsk_jax.ops.combinatorics import enumerate_combinations

    th = enumerate_combinations(7, 4)[:3]
    np.testing.assert_array_equal(
        np.asarray(mk("pairs", theta_batch=3)._pass_batch(th)),
        np.asarray(mk("runs", theta_batch=3)._pass_batch(th)),
    )
    # device-resident
    dp = mk("pairs").exact_device().to_host_int64()
    dr = mk("runs").exact_device().to_host_int64()
    np.testing.assert_array_equal(dp, dr)
    # approx stream (same seed => same theta stream => same integers)
    ap = mk("pairs").approx(max_iters=4, seed=3)
    ar = mk("runs").approx(max_iters=4, seed=3)
    np.testing.assert_array_equal(
        np.asarray(ap.counts), np.asarray(ar.counts)
    )
    assert np.allclose(ap.stdevs, ar.stdevs)


def test_sorted_runs_width_boundaries(rng):
    """Run widths that force many run-aligned slab boundaries (and
    multi-chunk slabs) stay exact vs the oracle."""
    X = random_ragged_seqs(rng, 9, 8, 20, alphabet=4)
    K_oracle = oracle.exact_counts(X, 6, 3)
    for width, slab in [(8, 16), (16, 64), (512, 8192)]:
        eng = SortedGkmEngine(
            encode_sequences(X), 6, 3,
            KernelConfig(sorted_layout="runs", sorted_run_width=width,
                         sorted_slab=slab),
        )
        np.testing.assert_array_equal(K_oracle, eng.exact())
