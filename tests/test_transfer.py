"""Byte-plane tile transfer must reproduce the int32 tiles bit-for-bit
for every width class, including the bucketed-padding gather paths."""

import jax.numpy as jnp
import numpy as np
import pytest

from fastsk_jax.ops.transfer import _bucket, pull_tiles_int32


def test_bucket_is_geometric():
    assert _bucket(1) == 8
    assert _bucket(8) == 8
    assert _bucket(9) == 16
    assert _bucket(1000) == 1024


@pytest.mark.parametrize(
    "hi",
    [
        200,  # all tiles fit 1 byte
        60_000,  # 2 bytes
        10_000_000,  # 3 bytes
        2**31 - 1,  # full int32 range (plane 3, sign-safe)
    ],
)
def test_roundtrip_uniform_width(rng, hi):
    m, th, tw = 13, 8, 16
    tiles_np = rng.integers(0, hi + 1, size=(m, th, tw), dtype=np.int64)
    tiles_np = tiles_np.astype(np.int32)
    tiles = jnp.asarray(tiles_np)
    live = np.arange(m, dtype=np.int64)
    got = pull_tiles_int32(tiles, live)
    np.testing.assert_array_equal(got, tiles_np)


def test_roundtrip_mixed_widths_and_subset(rng):
    """Tiles of different widths in one list; live subset out of order;
    only exceeding tiles ride the upper planes."""
    m, th, tw = 20, 4, 32
    tiles_np = np.zeros((m, th, tw), dtype=np.int32)
    widths = rng.integers(0, 4, size=m)
    for t in range(m):
        hi = (1 << (8 * (widths[t] + 1))) - 1
        hi = min(hi, 2**31 - 1)
        tiles_np[t] = rng.integers(0, hi + 1, size=(th, tw))
    tiles = jnp.asarray(tiles_np)
    live = np.array([7, 3, 19, 0, 11, 12, 5], dtype=np.int64)
    got = pull_tiles_int32(tiles, live)
    np.testing.assert_array_equal(got, tiles_np[live])


def test_boundary_values(rng):
    """Exact powers of 256 sit on the plane-selection boundary."""
    vals = np.array(
        [0, 255, 256, 65535, 65536, 2**24 - 1, 2**24, 2**31 - 1],
        dtype=np.int32,
    )
    tiles_np = np.tile(vals, (3, 8, 1))  # [3, 8, 8]
    tiles = jnp.asarray(tiles_np)
    got = pull_tiles_int32(tiles, np.arange(3))
    np.testing.assert_array_equal(got, tiles_np)


def test_min_offset_narrows_planes(rng):
    """Large but clustered tiles ride plane 0 only (width is set by the
    within-tile range, not the magnitude)."""
    from fastsk_jax.ops import transfer

    m, th, tw = 6, 8, 16
    base = rng.integers(10_000_000, 2**30, size=(m, 1, 1), dtype=np.int64)
    tiles_np = (
        base + rng.integers(0, 200, size=(m, th, tw), dtype=np.int64)
    ).astype(np.int32)
    tiles = jnp.asarray(tiles_np)

    calls = []
    orig = transfer._byte_plane

    def spy(t, idx, mins, *, plane):
        calls.append(plane)
        return orig(t, idx, mins, plane=plane)

    transfer._byte_plane = spy
    try:
        puller = transfer.StreamingTilePuller()
        h = puller.dispatch(tiles, np.arange(m))
        (got,) = puller.pull_all([h])
    finally:
        transfer._byte_plane = orig
    np.testing.assert_array_equal(got, tiles_np)
    # planes 0 and 1 are dispatched eagerly; no plane-2/3 gathers needed
    assert sorted(calls) == [0, 1]


def test_streaming_multiple_bands_with_deferrals(rng):
    """Several bands in flight; the rare wide tiles ride per-band
    bucketed plane-1/2 gathers that correct the batched pull in place."""
    from fastsk_jax.ops.transfer import StreamingTilePuller

    bands = []
    for b in range(3):
        tiles_np = rng.integers(0, 200, size=(10, 4, 8)).astype(np.int32)
        tiles_np[b] += 1 << 20  # one wide tile per band -> plane 1+2 tails
        bands.append(tiles_np)
    puller = StreamingTilePuller()
    handles = [puller.dispatch(jnp.asarray(t), np.arange(10)) for t in bands]
    outs = puller.pull_all(handles)
    for t, o in zip(bands, outs):
        np.testing.assert_array_equal(o, t)


def test_pull_all_mixed_band_sizes(rng):
    """Bands of different live counts concatenate correctly; a whole
    plane 1 is pulled when most tiles are wide, per-band plane-2 tails
    correct only their own band's slots."""
    from fastsk_jax.ops.transfer import StreamingTilePuller

    puller = StreamingTilePuller()
    bands, handles = [], []
    for b, (m, wide) in enumerate([(5, True), (12, True), (3, False)]):
        tiles_np = rng.integers(0, 70_000, size=(m, 4, 8)).astype(np.int32)
        if not wide:
            tiles_np %= 200
        if b == 1:
            tiles_np[4] += 1 << 22  # a plane-2 tail inside band 1
        bands.append(tiles_np)
        handles.append(puller.dispatch(jnp.asarray(tiles_np), np.arange(m)))
    outs = puller.pull_all(handles)
    for t, o in zip(bands, outs):
        np.testing.assert_array_equal(o, t)


def test_pull_array_chunked_matches_whole(rng):
    """Chunked pulls concatenate back to the exact array for sizes
    around the chunk boundary (including non-divisible row counts)."""
    from fastsk_jax.ops import transfer

    orig = transfer.CHUNK_BYTES
    transfer.CHUNK_BYTES = 1 << 10  # 1 KB chunks to force many requests
    try:
        for rows in (1, 7, 64, 129):
            a = rng.integers(-(2**31), 2**31 - 1, size=(rows, 37),
                             dtype=np.int64).astype(np.int32)
            got = transfer.pull_array(jnp.asarray(a))
            np.testing.assert_array_equal(got, a)
    finally:
        transfer.CHUNK_BYTES = orig
