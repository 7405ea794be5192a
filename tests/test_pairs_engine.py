"""The all-pairs exact engine must be bit-identical to the numpy oracle
(and therefore to the theta engine) on every shape class."""

import numpy as np
import pytest

from fastsk_jax import FastSK, KernelConfig
from fastsk_jax.kernel.pairs_engine import PairsGkmEngine
from fastsk_jax.ops.encode import encode_sequences
from fastsk_jax.ops.pairs import binom_exact

import oracle
from conftest import random_ragged_seqs


@pytest.mark.parametrize(
    "g,m,n,lmin,lmax,alpha",
    [
        (6, 3, 9, 8, 20, 4),  # DNA-like
        (5, 1, 7, 6, 14, 3),
        (8, 4, 12, 10, 22, 4),
        (4, 2, 5, 4, 9, 20),  # protein-sized alphabet
        (6, 5, 8, 7, 15, 30),  # text-sized alphabet, k=1
        (5, 0, 6, 6, 12, 4),  # m=0: exact-match kernel
        (7, 3, 10, 7, 7, 4),  # every sequence exactly length g+... fixed
    ],
)
def test_pairs_matches_oracle(rng, g, m, n, lmin, lmax, alpha):
    X = random_ragged_seqs(rng, n, lmin, lmax, alphabet=alpha)
    K_oracle = oracle.exact_counts(X, g, m)
    eng = PairsGkmEngine(encode_sequences(X), g, m)
    np.testing.assert_array_equal(K_oracle, eng.exact())


def test_pairs_engine_with_duplicate_and_uniform_seqs(rng):
    """Runs of identical windows (repetitive sequences) stress the counting."""
    X = [[1] * 12, [1] * 12, [1, 2] * 6, rng.integers(1, 5, size=12).tolist()]
    K_oracle = oracle.exact_counts(X, 5, 2)
    eng = PairsGkmEngine(encode_sequences(X), 5, 2)
    np.testing.assert_array_equal(K_oracle, eng.exact())


def test_binom_exact_integer_table():
    import math

    import jax.numpy as jnp

    for k in range(1, 11):
        x = jnp.arange(0, 21, dtype=jnp.float32)
        got = np.asarray(binom_exact(x, k))
        want = np.array([math.comb(v, k) for v in range(21)], dtype=np.float64)
        np.testing.assert_array_equal(got, want)


def test_api_routes_exact_to_pairs_engine(rng):
    X = random_ragged_seqs(rng, 10, 9, 16, alphabet=4)
    auto = FastSK(g=6, m=2)
    auto.compute_train(X)
    theta = FastSK(g=6, m=2, config=KernelConfig(exact_engine="theta"))
    theta.compute_train(X)
    forced = FastSK(g=6, m=2, config=KernelConfig(exact_engine="pairs"))
    forced.compute_train(X)
    np.testing.assert_array_equal(auto.kernel_counts, theta.kernel_counts)
    np.testing.assert_array_equal(auto.kernel_counts, forced.kernel_counts)


def test_int32_bound_guard():
    """Shapes whose worst-case per-pair count exceeds int32 must be refused
    by the pairs engine and auto-fall back to the theta engine."""
    X = [[1, 2, 3, 4] * 200 for _ in range(3)]  # len 800 -> huge p_pad
    enc = encode_sequences(X)
    with pytest.raises(ValueError):
        PairsGkmEngine(enc, 16, 10)  # C(16,6) * p_pad^2 >> 2^31
    fsk = FastSK(g=16, m=10)
    engine = fsk._make_exact_engine(enc)
    # the packed engine's digit planes have no per-pair bound
    assert type(engine).__name__ == "PackedPairsEngine"


def _kernel_engine(monkeypatch, X, g, m):
    """A PairsGkmEngine sized for the fused kernel, as on a GPU (the
    platform helper is patched; the kernel itself runs in interpret mode
    through the ``interpret`` keyword, never through a config value)."""
    from fastsk_jax.kernel import config

    monkeypatch.setattr(config, "platform_of", lambda cfg: "gpu")
    eng = PairsGkmEngine(encode_sequences(X), g, m)
    assert eng.backend == "pallas"
    return eng


def test_pallas_kernel_interpret_matches_oracle(rng, monkeypatch):
    """The fused kernel (interpret mode on CPU) must equal the oracle,
    with the padding the engine adds for it: p_pad to 16 rows, columns to
    a power of two, sequences to the column block."""
    from fastsk_jax.ops import pairs_pallas

    X = random_ragged_seqs(rng, 11, 9, 18, alphabet=4)
    K_o = oracle.exact_counts(X, 6, 3)
    eng = _kernel_engine(monkeypatch, X, 6, 3)
    assert eng.p_pad % 16 == 0 and eng.n_pad % eng.sj == 0
    x = eng._build_x()
    assert x.dtype == np.int8 and x.shape == (eng.n_pad * eng.p_pad, 32)
    upper = np.asarray(
        pairs_pallas.pairs_upper(
            x, g=6, k=3, p_pad=eng.p_pad, sj=eng.sj, interpret=True
        )
    )[: eng.n, : eng.n]
    assert not np.tril(upper, -1).any()  # lower triangle left to the caller
    np.testing.assert_array_equal(K_o, upper + np.triu(upper, 1).T)


def test_pairs_full_device_single_dispatch_matches_oracle(rng, monkeypatch):
    """The single device program (kernel + mirror + crop,
    pairs_engine._pairs_full_device_jit) must equal the oracle bit for
    bit."""
    from fastsk_jax.kernel.pairs_engine import _pairs_full_device_jit

    X = random_ragged_seqs(rng, 11, 9, 18, alphabet=4)
    K_o = oracle.exact_counts(X, 6, 3)
    eng = _kernel_engine(monkeypatch, X, 6, 3)
    full = np.asarray(
        _pairs_full_device_jit(
            eng._build_x(), g=6, k=3, p_pad=eng.p_pad, sj=eng.sj, n=eng.n,
            interpret=True,
        )
    )
    np.testing.assert_array_equal(K_o, full)


@pytest.mark.parametrize("length", [24, 40, 75])  # tiles of 16, 32 and 64 rows
def test_pallas_column_blocks_and_tile_rows(rng, length):
    """Several column blocks per row (sj < n_pad) and every tile height
    the p_pad rule produces."""
    import jax.numpy as jnp

    from fastsk_jax.ops import pairs, pairs_pallas

    g, m, n = 6, 3, 32
    X = [rng.integers(1, 5, size=length).tolist() for _ in range(n)]
    K_o = oracle.exact_counts(X, g, m)
    enc = encode_sequences(X)
    p_pad = -(-(enc.max_len - g + 1) // 16) * 16
    x = pairs.onehot_windows(
        jnp.asarray(enc.ids), jnp.asarray(enc.lengths),
        g=g, alpha=enc.hash_base, code_min=enc.code_min, p_pad=p_pad,
        dtype=jnp.int8,
    ).reshape(n * p_pad, g * enc.hash_base)
    x = jnp.pad(x, ((0, 0), (0, 32 - x.shape[1])))
    upper = np.asarray(
        pairs_pallas.pairs_upper(x, g=g, k=g - m, p_pad=p_pad,
                                 sj=16, interpret=True)
    )
    np.testing.assert_array_equal(K_o, upper + np.triu(upper, 1).T)


def test_kernel_route_and_sizing(rng, monkeypatch):
    """Route choice: CPU -> xla; a GPU -> the kernel where its exactness
    bounds hold; an explicit "pallas" off a GPU raises instead of falling
    back (also through the API's engine selection)."""
    from fastsk_jax.kernel import config

    X = random_ragged_seqs(rng, 5, 30, 30, alphabet=4)
    enc = encode_sequences(X)
    assert PairsGkmEngine(enc, 6, 3).backend == "xla"
    with pytest.raises(RuntimeError, match="needs a GPU"):
        PairsGkmEngine(enc, 6, 3, KernelConfig(pairs_backend="pallas"))
    with pytest.raises(RuntimeError, match="needs a GPU"):
        FastSK(g=6, m=3, config=KernelConfig(pairs_backend="pallas")).compute_train(X)
    with pytest.raises(ValueError, match="pairs_backend"):
        KernelConfig(pairs_backend="pallas_interpret")

    monkeypatch.setattr(config, "platform_of", lambda cfg: "gpu")
    eng = PairsGkmEngine(enc, 6, 3)
    assert (eng.backend, eng.p_pad, eng.sj, eng.n_pad) == ("pallas", 32, 16, 16)
    # g=16 m=10 at length 400 (p_pad 400): the kernel's bounds are per
    # tile, so only the per-entry guard limits the length
    mid = PairsGkmEngine(encode_sequences([[1, 2, 3, 4, 1] * 80] * 2), 16, 10)
    assert (mid.backend, mid.p_pad) == ("pallas", 400)
    # g=20 m=10: 20!/10! is not exact in f32 -> XLA strips, and forcing
    # the kernel raises
    long_x = [[1, 2, 3, 4] * 10 for _ in range(3)]
    assert PairsGkmEngine(encode_sequences(long_x), 20, 10).backend == "xla"
    with pytest.raises(RuntimeError, match="exactness bounds"):
        PairsGkmEngine(
            encode_sequences(long_x), 20, 10,
            KernelConfig(pairs_backend="pallas"),
        )


def test_tile_rows_and_kernel_fits_invariants():
    """tile_rows returns the largest power of two <= 64 dividing p_pad;
    kernel_fits admits exactly the shapes whose bounds hold."""
    import math

    from fastsk_jax.ops.pairs_pallas import (
        kernel_fits,
        tile_rows,
        tiles_per_division,
    )

    for p_pad in range(16, 1025, 16):
        bt = tile_rows(p_pad)
        assert p_pad % bt == 0 and bt in (16, 32, 64)
        assert bt == 64 or p_pad % (2 * bt)
    for g in range(1, 21):
        for k in range(0, g + 1):
            for p_pad in (16, 96, 192, 208, 1024):
                ff = math.factorial(g) // math.factorial(g - k)
                c = math.comb(g, k)
                bt = tile_rows(p_pad)
                ok = (k >= 1 and ff < 2**24 and bt * ff < 2**31
                      and bt * c < 2**21)
                assert kernel_fits(g, k, p_pad) == ok
                # the most tiles per /k! that keep both bounds
                grp = tiles_per_division(g, k, p_pad)
                assert grp * bt * ff < 2**31 and grp * bt * c < 2**21
                assert grp == p_pad // bt or (
                    (grp + 1) * bt * ff >= 2**31
                    or (grp + 1) * bt * c >= 2**21
                )
    assert tiles_per_division(13, 6, 192) == tiles_per_division(16, 6, 192) == 3
    assert not kernel_fits(6, 3, 24)  # not a 16-row multiple
    assert kernel_fits(16, 6, 192) and kernel_fits(13, 6, 192)  # KAT2B
    # the bounds are per tile: p_pad is limited only by the engine's
    # per-entry guard p_pad^2 * C(g, k) < 2^31 (about 517 rows at g=16 k=6)
    assert all(kernel_fits(16, 6, p) for p in range(16, 528, 16))
