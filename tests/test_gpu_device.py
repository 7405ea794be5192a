"""Real-device correctness on an NVIDIA GPU: the compiled paths must equal
the numpy oracle bit for bit — interpret-mode coverage in the hermetic
suite does not exercise the Triton-compiled kernel or the GPU's matmul
precision choices, which is where exactness bugs live.

Run on a card with ``JAX_PLATFORMS=cuda python -m pytest
tests/test_gpu_device.py -m gpu``; elsewhere the ``gpu_device`` fixture
skips every test here.
"""

import numpy as np
import pytest

from fastsk_jax import FastSK, KernelConfig
from fastsk_jax.kernel.pairs_engine import PackedPairsEngine, PairsGkmEngine
from fastsk_jax.ops.encode import encode_sequences

import oracle
from conftest import random_ragged_seqs

pytestmark = pytest.mark.gpu


def test_pallas_pairs_on_device(rng, gpu_device):
    X = [rng.integers(1, 6, size=200).tolist() for _ in range(140)]
    K_o = oracle.exact_counts(X, 8, 4)
    eng = PairsGkmEngine(
        encode_sequences(X), 8, 4, KernelConfig(pairs_backend="pallas")
    )
    assert eng.backend == "pallas"
    np.testing.assert_array_equal(K_o, eng.exact())


def test_packed_pairs_on_device(rng, gpu_device):
    X = random_ragged_seqs(rng, 30, 20, 300, alphabet=20)
    K_o = oracle.exact_counts(X, 8, 4)
    eng = PackedPairsEngine(encode_sequences(X), 8, 4, KernelConfig())
    np.testing.assert_array_equal(K_o, eng.exact())


def test_dense_theta_on_device(rng, gpu_device):
    X = random_ragged_seqs(rng, 25, 20, 60, alphabet=4)
    fsk = FastSK(g=8, m=4, config=KernelConfig(exact_engine="theta"))
    fsk.compute_train(X)
    np.testing.assert_array_equal(oracle.exact_counts(X, 8, 4), fsk.kernel_counts)


def test_sorted_on_device(rng, gpu_device):
    from fastsk_jax.kernel.sorted_engine import SortedGkmEngine

    X = random_ragged_seqs(rng, 15, 15, 40, alphabet=25)
    eng = SortedGkmEngine(encode_sequences(X), 8, 2, KernelConfig())
    np.testing.assert_array_equal(oracle.exact_counts(X, 8, 2), eng.exact())


def test_count_dots_exact_past_tf32_on_device(gpu_device):
    """A homopolymer whose k-mers each occur 2,995 times, a count that
    needs 12 significant bits where TF32 holds 11: f32 count dots must
    not run in TF32 (ops/gkm.count_precision)."""
    X = [[1] * 3000, [1, 2, 3] * 20, [4, 3, 2, 1] * 12]
    fsk = FastSK(g=6, m=3, config=KernelConfig(exact_engine="theta"))
    fsk.compute_train(X)
    np.testing.assert_array_equal(oracle.exact_counts(X, 6, 3), fsk.kernel_counts)


def test_device_resident_on_device(rng, gpu_device):
    """Device-resident counts on a GPU equal the numpy oracle bit for bit
    across the fused pairs kernel, packed, and sorted engines, and
    fit/score runs without materializing the host kernel."""
    from fastsk_jax.kernel.sorted_engine import SortedGkmEngine

    # fused pairs kernel (uniform DNA)
    X = [rng.integers(1, 6, size=120).tolist() for _ in range(100)]
    K_o = oracle.exact_counts(X, 8, 4)
    eng = PairsGkmEngine(encode_sequences(X), 8, 4, KernelConfig())
    assert eng.backend == "pallas"
    np.testing.assert_array_equal(K_o, eng.exact_device().to_host_int64())

    # packed (ragged protein)
    Xp = random_ragged_seqs(rng, 24, 20, 200, alphabet=20)
    K_o = oracle.exact_counts(Xp, 8, 4)
    engp = PackedPairsEngine(encode_sequences(Xp), 8, 4, KernelConfig())
    np.testing.assert_array_equal(K_o, engp.exact_device().to_host_int64())

    # sorted (big alphabet)
    Xs = random_ragged_seqs(rng, 15, 15, 40, alphabet=25)
    engs = SortedGkmEngine(encode_sequences(Xs), 8, 2, KernelConfig())
    np.testing.assert_array_equal(
        oracle.exact_counts(Xs, 8, 2), engs.exact_device().to_host_int64()
    )

    # end-to-end fit/score without a host kernel pull
    Y = [i % 2 for i in range(len(X))]
    f = FastSK(g=8, m=4, config=KernelConfig(device_resident=True))
    f.compute_kernel(X[:80], X[80:], Y[:80], Y[80:])
    f.fit(C=1.0, kernel_type="fastsk")
    acc = f.score("accuracy")
    assert f._K is None and f._counts is None  # never pulled
    assert 0.0 <= acc <= 100.0
