"""Byte-plane tile transfer: minimal-width device->host kernel pulls.

Moves an int32 kernel to the host in fewer bytes than 4 per count. Two
structural facts make the counts far more compressible than a global byte
width can express:

- they are heavily skewed: off-diagonal tiles of unrelated sequences carry
  tiny values while diagonal / near-duplicate tiles carry the big ones;
- within one tile they cluster: a [th, tw] block of sequence pairs shares
  sequence lengths and composition, so (max - min) per tile is much
  smaller than max.

The transfer is therefore organized per TILE as an int32 min OFFSET (a
[L]-vector, negligible) plus little-endian byte PLANES of the offset
residual:

    value = min_t + b0 + 256*b1 + 65536*b2 + 16777216*b3

- plane 0 is pulled for every live tile (1 byte/entry),
- plane p >= 1 is pulled whole when at least half the tiles need it,
  else only for tiles whose (max - min) reaches 256^p, gathered with a
  geometrically-bucketed index list so the jitted gather compiles for
  O(log n_tiles) shapes, not per run.

Adding a plane is exact even for tiles that don't need it (their residual
bytes are zero), which lets a whole already-computed plane move as one
pull instead of a queued gather. The byte planes are plain gathers +
bitcasts — pure XLA (no Pallas), testable on CPU, bit-identical to
pulling the int32s whole. Counts are >= 0 < 2^31 so plane 3 of the
residual never carries a sign bit.

Used by kernel/pairs_engine.py for the packed ragged engine's host pull
(the counts are the countAndUpdateTri accumulations of the reference's
shared.cpp:268-333, bit-identical). Whether this beats a plain
``jax.device_get`` on a GPU host has not been measured.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@jax.jit
def _tile_minmax(tiles: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """[2, L] int32 — per-selected-tile (min, max)."""
    sel = tiles[idx]
    return jnp.stack(
        [jnp.min(sel, axis=(1, 2)), jnp.max(sel, axis=(1, 2))]
    )


@functools.partial(jax.jit, static_argnames=("plane",))
def _byte_plane(
    tiles: jnp.ndarray,  # [M, th, tw] int32
    idx: jnp.ndarray,  # [L] int32
    mins: jnp.ndarray,  # [L] int32 — per-selected-tile offset
    *,
    plane: int,
):
    """[L, th, tw] int8 — little-endian byte ``plane`` of the offset
    residuals ``tiles[idx] - mins``."""
    resid = tiles[idx] - mins[:, None, None]
    return jax.lax.bitcast_convert_type(resid, jnp.int8)[..., plane]


def _bucket(n: int) -> int:
    """Geometric padding bucket: bounds the number of compiled gather
    shapes per tile-list size to O(log)."""
    b = 8
    while b < n:
        b *= 2
    return b


def _pad_idx(idx: np.ndarray, b: int) -> np.ndarray:
    return np.concatenate([idx, np.full(b - idx.size, idx[0])]).astype(
        np.int32
    )


def _decode(raw: np.ndarray, shift: int) -> np.ndarray:
    return raw.view(np.uint8).astype(np.int32) << shift


# size of one device->host request of a chunked pull (not tuned on a GPU)
CHUNK_BYTES = 6 << 20


def _chunk_slices(dev) -> list:
    """Slice a device array into ~CHUNK_BYTES pieces along axis 0. The
    slice programs are enqueued HERE — callers that need the pieces to
    sit directly behind a specific producer in the FIFO queue (band
    overlap) must call this right after enqueueing that producer."""
    nbytes = dev.size * dev.dtype.itemsize
    if nbytes <= CHUNK_BYTES + (CHUNK_BYTES >> 1):
        return [dev]
    rows = dev.shape[0]
    per = max(1, (rows * CHUNK_BYTES) // nbytes)
    return [dev[o : o + per] for o in range(0, rows, per)]


def pull_array(dev) -> np.ndarray:
    """Chunked device->host pull: one request per ~CHUNK_BYTES along
    axis 0. Exact — pure slicing."""
    return _pull_chunks(_chunk_slices(dev))


def _pull_chunks(chunks: list) -> np.ndarray:
    if len(chunks) == 1:
        return np.asarray(chunks[0])
    return np.concatenate([np.asarray(c) for c in chunks])


class StreamingTilePuller:
    """Per-part tile pulls that overlap with later parts' compute.

    A device executes enqueued programs in order, so a device op
    dispatched after part i+1's kernel cannot run until that kernel
    finishes — a naive "compute everything, then encode and pull" loop
    serializes the whole pipeline behind the last part. The protocol:

    1. ``dispatch(tiles, live_idx)`` right after enqueueing a part's
       producer: it enqueues only that part's per-tile min/max and its
       residual byte-plane-0/1 extractions, so they run as soon as the
       part's kernel retires.
    2. ``pull_all(handles)`` walks parts in dispatch order; each part's
       min/max pull is the only synchronization on its kernel, and its
       plane pulls (chunked, see CHUNK_BYTES) overlap later parts'
       compute. Any plane needed
       by at least half the part's tiles is pulled WHOLE (exact either
       way — unneeded tiles contribute zero residual bytes): on
       wide-span data (DNA kernels, where every tile's range tops 2^16)
       this is plain 3-byte packing
       with zero gather overhead, while clustered data rides 1-2
       planes. Narrow tails become bucketed gathers that land at the
       queue tail; their pulls drain after every part's bulk planes.
    """

    def dispatch(self, tiles: jnp.ndarray, live_idx: np.ndarray):
        live_idx = np.asarray(live_idx, dtype=np.int32)
        live_dev = jnp.asarray(live_idx)
        minmax = _tile_minmax(tiles, live_dev)
        # pre-slice the planes into chunk requests NOW so the slice
        # programs queue directly behind this part's producer and their
        # pulls overlap later parts' compute
        p0 = _chunk_slices(_byte_plane(tiles, live_dev, minmax[0], plane=0))
        p1 = _chunk_slices(_byte_plane(tiles, live_dev, minmax[0], plane=1))
        return (tiles, live_idx, minmax, p0, p1)

    def pull_all(self, handles) -> list:
        """One exact int32 array per handle, in dispatch order."""
        outs, deferred = [], []
        for tiles, live_idx, minmax_dev, p0, p1 in handles:
            mins, maxes = np.asarray(minmax_dev)
            span = maxes - mins
            out = mins[:, None, None] + _decode(_pull_chunks(p0), 0)
            for p in range(1, 4):
                sel = np.flatnonzero(span >= (1 << (8 * p)))
                if sel.size == 0:
                    break
                if 2 * sel.size >= live_idx.size:
                    # whole plane: already extracted for p=1, one
                    # full-width gather+bitcast for p>=2 — no padding,
                    # no host scatter-add
                    if p == 1:
                        out += _decode(_pull_chunks(p1), 8)
                    else:
                        dev = _byte_plane(
                            tiles,
                            jnp.asarray(live_idx),
                            jnp.asarray(mins),
                            plane=p,
                        )
                        deferred.append((out, None, dev, 8 * p))
                    continue
                idx_pad = _pad_idx(live_idx[sel], _bucket(sel.size))
                mins_pad = _pad_idx(mins[sel], idx_pad.size)
                dev = _byte_plane(
                    tiles, jnp.asarray(idx_pad), jnp.asarray(mins_pad),
                    plane=p,
                )
                deferred.append((out, sel, dev, 8 * p))
            outs.append(out)
        for out, sel, dev, shift in deferred:
            if sel is None:
                out += _decode(pull_array(dev), shift)
            else:
                out[sel] += _decode(pull_array(dev)[: sel.size], shift)
        return outs


def pull_tiles_int32(
    tiles: jnp.ndarray,  # [M, th, tw] int32 on device
    live_idx: np.ndarray,  # [L] — tiles to pull, in pull order
) -> np.ndarray:
    """Pull ``tiles[live_idx]`` to the host as exact int32 (single-part
    case: the producer has already been enqueued)."""
    puller = StreamingTilePuller()
    return puller.pull_all([puller.dispatch(tiles, live_idx)])[0]
