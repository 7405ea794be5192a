"""Multi-device mesh tests on the virtual 8-device CPU mesh.

The sharded exact path must produce the *identical integer* kernel as the
single-device path — functional accumulation plus psum is deterministic,
unlike the reference's banded-mutex merge (fastsk_kernel.cpp:285-315).
"""

import jax
import numpy as np
import pytest

from fastsk_jax import FastSK, KernelConfig
from fastsk_jax.parallel import make_mesh, default_mesh_shape

from conftest import random_ragged_seqs


@pytest.fixture(scope="module")
def mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return make_mesh(2, 4)


def test_default_mesh_shape():
    assert default_mesh_shape(8) == (2, 4)
    assert default_mesh_shape(4) == (2, 2)
    assert default_mesh_shape(1) == (1, 1)
    assert default_mesh_shape(6) == (2, 3)


def test_exact_sharded_matches_single_device(rng, mesh8):
    X = random_ragged_seqs(rng, 21, 12, 20, alphabet=4)
    single = FastSK(g=6, m=2)
    single.compute_train(X)
    sharded = FastSK(g=6, m=2, config=KernelConfig(mesh=mesh8))
    sharded.compute_train(X)
    np.testing.assert_array_equal(single.kernel_counts, sharded.kernel_counts)


def test_exact_sharded_train_test_split(rng, mesh8):
    Xtr = random_ragged_seqs(rng, 13, 10, 16, alphabet=3)
    Xte = random_ragged_seqs(rng, 6, 10, 16, alphabet=3)
    single = FastSK(g=5, m=2)
    single.compute_kernel(Xtr, Xte)
    sharded = FastSK(g=5, m=2, config=KernelConfig(mesh=mesh8))
    sharded.compute_kernel(Xtr, Xte)
    np.testing.assert_array_equal(single.kernel_counts, sharded.kernel_counts)
    np.testing.assert_allclose(single.kernel, sharded.kernel)


def test_approx_sharded_matches_single_device(rng):
    """Rows-only mesh: the sequential Monte-Carlo stream must consume the
    same thetas, stop at the same iteration, and sum the same integers."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    mesh = make_mesh(4, 1)
    X = random_ragged_seqs(rng, 18, 14, 20, alphabet=4)
    single = FastSK(g=8, m=4, approx=True, max_iters=17, seed=3)
    single.compute_train(X)
    sharded = FastSK(
        g=8, m=4, approx=True, max_iters=17, seed=3, config=KernelConfig(mesh=mesh)
    )
    sharded.compute_train(X)
    assert single.iterations == sharded.iterations
    np.testing.assert_array_equal(single.kernel_counts, sharded.kernel_counts)
    np.testing.assert_allclose(
        single.get_stdevs(), sharded.get_stdevs(), rtol=1e-4
    )


def test_approx_sharded_convergence_stop(rng):
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 virtual devices")
    mesh = make_mesh(2, 1)
    X = random_ragged_seqs(rng, 16, 14, 20, alphabet=4)
    single = FastSK(g=10, m=6, approx=True, delta=0.5, seed=7)
    single.compute_train(X)
    sharded = FastSK(
        g=10, m=6, approx=True, delta=0.5, seed=7, config=KernelConfig(mesh=mesh)
    )
    sharded.compute_train(X)
    assert single.iterations == sharded.iterations
    np.testing.assert_array_equal(single.kernel_counts, sharded.kernel_counts)


def test_pairs_engine_refuses_mesh(rng, mesh8):
    """The seq-aligned pairs engine is single-device by design (round 4:
    its mesh path replicated the O(N*p*gA) window encoding per device and
    never memory-scaled). A mesh must raise, and the auto route must land
    on the packed ring path with identical integers."""
    from fastsk_jax.kernel.config import KernelConfig
    from fastsk_jax.kernel.pairs_engine import PairsGkmEngine
    from fastsk_jax.ops.encode import encode_sequences

    X = random_ragged_seqs(rng, 27, 12, 20, alphabet=4)
    enc = encode_sequences(X)
    with pytest.raises(ValueError, match="single-device"):
        PairsGkmEngine(enc, 6, 2, KernelConfig(mesh=mesh8))


def test_api_exact_with_mesh_routes_to_packed(rng, mesh8):
    """Auto engine selection under a mesh routes to the packed engine
    (fully input+state sharded) and matches single-device exactly."""
    from fastsk_jax.ops.encode import encode_sequences

    X = random_ragged_seqs(rng, 16, 10, 16, alphabet=4)
    fsk = FastSK(g=6, m=2, config=KernelConfig(mesh=mesh8))
    engine = fsk._make_exact_engine(encode_sequences(X))
    assert type(engine).__name__ == "PackedPairsEngine"
    fsk.compute_train(X)
    ref = FastSK(g=6, m=2)
    ref.compute_train(X)
    np.testing.assert_array_equal(ref.kernel_counts, fsk.kernel_counts)


def test_packed_sharded_matches_single_device(rng, mesh8):
    """Round-robin strip sharding of the packed (ragged) engine: per-device
    plane replicas summed on the host equal the single-device integers."""
    from fastsk_jax.kernel.pairs_engine import PackedPairsEngine
    from fastsk_jax.ops.encode import encode_sequences

    orig = PackedPairsEngine.TILE
    PackedPairsEngine.TILE = 64
    try:
        X = random_ragged_seqs(rng, 18, 10, 60, alphabet=4)
        enc = encode_sequences(X)
        single = PackedPairsEngine(enc, 6, 3, KernelConfig())
        k1 = single.exact()
        sharded = PackedPairsEngine(enc, 6, 3, KernelConfig(mesh=mesh8))
        assert sharded.n_strips > 8  # several rounds
        k2 = sharded.exact()
        np.testing.assert_array_equal(k1, k2)
    finally:
        PackedPairsEngine.TILE = orig


def test_packed_sharded_multi_digit(rng, mesh8):
    from fastsk_jax.kernel.pairs_engine import PackedPairsEngine
    from fastsk_jax.ops.encode import encode_sequences

    orig = PackedPairsEngine.TILE
    PackedPairsEngine.TILE = 64
    try:
        X = random_ragged_seqs(rng, 8, 18, 40, alphabet=4)
        enc = encode_sequences(X)
        single = PackedPairsEngine(enc, 12, 6, KernelConfig())
        assert single.n_digits == 2
        k1 = single.exact()
        sharded = PackedPairsEngine(enc, 12, 6, KernelConfig(mesh=mesh8))
        k2 = sharded.exact()
        np.testing.assert_array_equal(k1, k2)
    finally:
        PackedPairsEngine.TILE = orig


def test_api_routes_ragged_mesh_to_packed(rng, mesh8):
    """With a mesh, heavily ragged data now routes to the sharded packed
    engine (round 1 silently fell back to the slow theta path)."""
    from fastsk_jax.ops.encode import encode_sequences

    X = random_ragged_seqs(rng, 10, 8, 80, alphabet=4)
    fsk = FastSK(g=6, m=2, config=KernelConfig(mesh=mesh8))
    engine = fsk._make_exact_engine(encode_sequences(X))
    assert type(engine).__name__ == "PackedPairsEngine"
    fsk.compute_train(X)
    ref = FastSK(g=6, m=2)
    ref.compute_train(X)
    np.testing.assert_array_equal(ref.kernel_counts, fsk.kernel_counts)


def test_exact_engine_non_power_of_two_mesh(rng):
    """A 2x3 mesh (6 of the 8 virtual devices) produces integer-identical
    exact counts — no hidden power-of-two assumptions in the rows/theta
    sharding or the packed ring."""
    from fastsk_jax.kernel.pairs_engine import PackedPairsEngine
    from fastsk_jax.kernel.config import KernelConfig
    from fastsk_jax.ops.encode import encode_sequences

    X = [
        list(rng.integers(1, 5, size=int(rng.integers(10, 18))))
        for _ in range(14)
    ]
    enc = encode_sequences(X)
    mesh = make_mesh(2, 3)
    orig = PackedPairsEngine.TILE
    PackedPairsEngine.TILE = 64  # several strips on the tiny fixture
    try:
        k_mesh = PackedPairsEngine(enc, 6, 3, KernelConfig(mesh=mesh)).exact()
        k_one = PackedPairsEngine(enc, 6, 3, KernelConfig()).exact()
    finally:
        PackedPairsEngine.TILE = orig
    np.testing.assert_array_equal(k_mesh, k_one)


def test_packed_rowsharded_memory_layout(rng, mesh8):
    """mesh_state="sharded" (default) gives each device a plane ROW BLOCK
    [n_digits, blk, Np] with blk ~ Np/n_dev + halo — assert addressable
    shards shrink and both states match the single device exactly."""
    from fastsk_jax.kernel.pairs_engine import PackedPairsEngine
    from fastsk_jax.ops.encode import encode_sequences
    from fastsk_jax.parallel import sharding as shd

    orig = PackedPairsEngine.TILE
    PackedPairsEngine.TILE = 64
    try:
        X = random_ragged_seqs(rng, 24, 10, 60, alphabet=4)
        enc = encode_sequences(X)
        k1 = PackedPairsEngine(enc, 6, 3, KernelConfig()).exact()

        eng = PackedPairsEngine(enc, 6, 3, KernelConfig(mesh=mesh8))
        assert eng.config.mesh_state == "sharded"
        seen = {}
        orig_fn = shd.packed_ring_rowsharded

        def spy(blocks, *a, **kw):
            out = orig_fn(blocks, *a, **kw)
            seen["shards"] = [s.data.shape for s in out.addressable_shards]
            seen["global"] = out.shape
            return out

        shd.packed_ring_rowsharded = spy
        try:
            k2 = eng.exact()
        finally:
            shd.packed_ring_rowsharded = orig_fn
        np.testing.assert_array_equal(k1, k2)
        n_pad = eng.n + eng.c_pad
        # each shard holds ONE row block: [1, n_digits, blk, n_pad] with
        # blk well below the full plane height
        assert seen["global"][0] == 8 and seen["global"][3] == n_pad
        blk = seen["global"][2]
        assert blk < n_pad
        assert all(s == (1, eng.n_digits, blk, n_pad) for s in seen["shards"])

        k3 = PackedPairsEngine(
            enc, 6, 3, KernelConfig(mesh=mesh8, mesh_state="replicated")
        ).exact()
        np.testing.assert_array_equal(k1, k3)
    finally:
        PackedPairsEngine.TILE = orig
