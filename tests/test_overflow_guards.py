"""Regression tests for the round-1 advisor's int32-overflow findings.

Each test pins a bound that, if violated, silently corrupts exact integer
kernels: the packed engine's stage-2 cumsum (ops/pairs_packed.py), the
count-split theta batch (kernel/engine.py), the fused kernel's column
sums (ops/pairs_pallas.py), the checkpoint digest, and the converged flag.
"""

import numpy as np
import pytest

from fastsk_jax import FastSK, KernelConfig
from fastsk_jax.kernel.engine import DenseGkmEngine
from fastsk_jax.kernel.pairs_engine import PackedPairsEngine
from fastsk_jax.ops.encode import encode_sequences

import oracle
from conftest import random_ragged_seqs


def test_packed_tile_not_widened_for_long_sequences(rng):
    """tile=4096 with base 256 would overflow stage-2 cumsum when a single
    sequence contributes > ~2048 rows to a strip — the engine must keep
    the safe tile for long sequences and may widen only for short ones.

    g=10, m=6: C(10,4) = 210 needs two base-128 planes but one base-256
    plane, so the base-128 preference does NOT kick in and the
    digit base stays 256 — the configuration where the cumsum bound
    actually binds."""
    # p_max in (2048, 2901]: digit_base stays 256 and a 4096 tile would
    # break the cumsum bound — the engine must keep tile=2048
    X_long = [rng.integers(1, 5, size=2500).tolist() for _ in range(3)]
    eng = PackedPairsEngine(encode_sequences(X_long), 10, 6, KernelConfig())
    assert eng.digit_base == 256
    assert (
        eng.tile * min(eng.tile, -(-int(max(map(len, X_long))) // 8) * 8)
        * (eng.digit_base - 1)
        < 2**31
    )
    assert eng.tile == PackedPairsEngine.TILE  # not widened

    # short DNA still gets the wide tile
    X_short = [rng.integers(1, 5, size=200).tolist() for _ in range(3)]
    eng2 = PackedPairsEngine(encode_sequences(X_short), 10, 6, KernelConfig())
    assert eng2.tile == 2 * PackedPairsEngine.TILE


def test_packed_digit_base_128_preference(rng):
    """C(g, k) <= 127 keeps one plane at base 128, so the engine picks
    base-128 digits; the cumsum/plane bounds (which only
    loosen with the smaller base) must still hold after any widening."""
    X_long = [rng.integers(1, 5, size=2500).tolist() for _ in range(3)]
    eng = PackedPairsEngine(encode_sequences(X_long), 8, 4, KernelConfig())
    assert eng.digit_base == 128 and eng.n_digits == 1
    p_rows = -(-int(max(map(len, X_long))) // 8) * 8
    assert eng.tile * min(eng.tile, p_rows) * (eng.digit_base - 1) < 2**31
    # base 128 loosens the widening bound: 4096 * 2504 * 127 < 2^31,
    # so the short-sequence wide tile is now legal for long ones too
    assert eng.tile == 2 * PackedPairsEngine.TILE


def test_count_split_theta_batch_capped():
    """p_max > 4095 engages count_split, where theta_batch * p_max^2 must
    stay below 2^31 within a single batch."""
    X = [list(np.random.default_rng(0).integers(1, 5, size=6010)) for _ in range(2)]
    eng = DenseGkmEngine(encode_sequences(X), 6, 2, KernelConfig())
    assert eng.count_split
    assert eng.theta_batch * eng.p_max**2 < 2**31
    assert eng.spill_every_thetas * eng.p_max**2 < 2**31


def test_pallas_interpret_large_binomial_repetitive():
    """g=20, m=10 on all-identical sequences: every window pair matches
    all positions, so each entry is p^2 * C(20,10). The fused kernel's
    int32 falling factorial cannot hold 20!/10!, so its exactness bounds
    refuse the shape and the engine runs XLA strips — which must still
    produce the exact integers."""
    import math

    from fastsk_jax.kernel.pairs_engine import PairsGkmEngine
    from fastsk_jax.ops.pairs_pallas import kernel_fits

    g, m = 20, 10
    k = g - m
    L = 115
    enc = encode_sequences([[1] * L, [1] * L])
    p = L - g + 1  # 96 true windows per sequence
    assert not kernel_fits(g, k, 96)
    eng = PairsGkmEngine(enc, g, m, KernelConfig())
    assert eng.backend == "xla"
    assert eng.p_pad * math.comb(g, k) > 2**24  # f32 sums would round
    K = eng.exact()
    assert (K == p * p * math.comb(g, k)).all()


@pytest.mark.parametrize(
    "g,m,L,bt,grp",
    [
        (18, 12, 200, 64, 1),  # one /k! per 64-row tile
        (25, 20, 64, 16, 2),  # tiles {0, 1} share one /k!, tile 2 alone
    ],
)
def test_pallas_deferred_division_near_bound(g, m, L, bt, grp):
    """The kernel's deferred /k! at a worst case near its error bound:
    all-identical sequences drive the column sum of every full group of
    ``grp`` row tiles to ``grp * bt * C(g, k)``, between 2^20 and the
    2^21 guard, where the one round-multiply per group column must still
    recover the exact integer (interpret mode)."""
    import math

    import jax.numpy as jnp

    from fastsk_jax.ops import pairs
    from fastsk_jax.ops.pairs_pallas import (
        kernel_fits,
        pairs_upper,
        tile_rows,
        tiles_per_division,
    )

    k = g - m
    enc = encode_sequences([[1] * L, [1] * L])
    p = L - g + 1
    p_pad = -(-p // 16) * 16
    ffmax = math.factorial(g) // math.factorial(g - k)
    assert tile_rows(p_pad) == bt and tiles_per_division(g, k, p_pad) == grp
    assert ffmax < 2**24 and grp * bt * ffmax < 2**31
    assert 2**20 < grp * bt * math.comb(g, k) < 2**21  # near the bound
    assert kernel_fits(g, k, p_pad)
    f = g * enc.hash_base
    f_pad = max(32, 1 << (f - 1).bit_length())
    x = pairs.onehot_windows(
        jnp.asarray(enc.ids), jnp.asarray(enc.lengths),
        g=g, alpha=enc.hash_base, code_min=enc.code_min, p_pad=p_pad,
        dtype=jnp.int8,
    ).reshape(2 * p_pad, f)
    x = jnp.pad(x, ((0, 0), (0, f_pad - f)))
    x = jnp.concatenate([x, jnp.zeros((14 * p_pad, f_pad), jnp.int8)])
    upper = np.asarray(pairs_upper(x, g=g, k=k, p_pad=p_pad, sj=16,
                                  interpret=True))
    expect = p * p * math.comb(g, k)
    assert upper[0, 0] == expect
    assert upper[0, 1] == expect
    assert upper[1, 1] == expect
    assert upper[1, 0] == 0 and not upper[2:].any()


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 6, 7, 8, 9])
def test_deferred_division_exact_over_its_range(k):
    """The kernel's deferred ``/k!`` recovers every quotient below
    2^21 exactly (the f32 cast of k!*q and the reciprocal multiply both
    round; the bound keeps the error under 1/2)."""
    import math

    import jax.numpy as jnp

    from fastsk_jax.ops.pairs_pallas import divide_by_kfact

    kf = math.factorial(k)
    q = np.arange(0, 2**21, dtype=np.int64)
    q = q[q * kf < 2**31]
    got = np.asarray(divide_by_kfact(jnp.asarray(q * kf, jnp.int32), k))
    np.testing.assert_array_equal(got, q)


def test_checkpoint_digest_distinguishes_theta_streams(tmp_path, rng):
    """An exact run must not resume a different-ordered (seeded approx)
    run's checkpoint of the same length: digests must differ with order."""
    X = random_ragged_seqs(rng, 6, 10, 20, alphabet=4)
    g, m = 6, 2
    K_o = oracle.exact_counts(X, g, m)

    # seeded shuffled stream, checkpointed every theta
    fsk = FastSK(g=g, m=m, approx=True, skip_variance=True, seed=7,
                 config=KernelConfig(
                     checkpoint_path=str(tmp_path / "k.npz"), checkpoint_every=1,
                     exact_engine="theta"))
    fsk.compute_train(X)
    np.testing.assert_array_equal(fsk.kernel_counts, K_o)

    # exact run over the same problem: same theta count, different order —
    # must compute from scratch and still match the oracle
    fsk2 = FastSK(g=g, m=m, config=KernelConfig(
        checkpoint_path=str(tmp_path / "k.npz"), checkpoint_every=1,
        exact_engine="theta"))
    fsk2.compute_train(X)
    np.testing.assert_array_equal(fsk2.kernel_counts, K_o)

    # and a different seed must also not collide
    fsk3 = FastSK(g=g, m=m, approx=True, skip_variance=True, seed=8,
                  config=KernelConfig(
                      checkpoint_path=str(tmp_path / "k.npz"), checkpoint_every=1,
                      exact_engine="theta"))
    fsk3.compute_train(X)
    np.testing.assert_array_equal(fsk3.kernel_counts, K_o)


def test_converged_false_when_max_iters_hit(rng):
    """Hitting max_iters without statistical convergence must report
    converged=False (the round-1 'or True' bug made it always True)."""
    X = random_ragged_seqs(rng, 8, 12, 24, alphabet=4)
    enc = encode_sequences(X)
    eng = DenseGkmEngine(enc, 8, 4, KernelConfig())
    res = eng.approx(conv_delta=1e-12, max_iters=3)
    assert res.iters == 3
    assert not res.converged
