"""Packed (ragged-aware) all-pairs exact kernel.

The seq-aligned pairs path (ops/pairs.py) pads every sequence to the
longest one's window count — on ragged protein/text data that wastes up
to ~35x of the D-matmul work (SCOP lengths span 16..905). Here windows
pack back to back (each sequence rounded to 8 rows), sequences sorted by
descending length, and the strip machinery works on row tiles that may
split sequences:

- ``D = X_a X_b^T`` over fixed [T, T] row tiles (0/1 bf16 operands,
  exact f32 match counts),
- binomial weights split into 8-bit digit planes so every matmul operand
  stays bf16-exact,
- stage 1 (rows -> i-sequences) is a 0/1 G-matmul built from the packed
  ``seq_of_row`` table,
- stage 2 (columns -> j-sequences) is an int32 cumsum + boundary
  gather (running sums stay < T^2 * 255 < 2^31),
- per-digit int32 kernel planes accumulate on device and combine into
  int64 on the host — there is NO per-pair int32 bound, so shapes the
  seq-aligned engine must refuse (AImed at g=11, 3.25 at g=15) run here.

Symmetry: strip pairs (a, b) with a < b accumulate both P and P^T, the
diagonal pair accumulates its full block once — every ordered row pair
is counted exactly once, including sequences straddling strip borders.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


def pack_windows(lengths: np.ndarray, g: int, tile: int) -> dict:
    """Row layout for the packed table (host side).

    Sequences are assumed pre-sorted by the caller (descending length).
    Each sequence s gets ``ceil(p_s / 8) * 8`` rows starting at
    ``row0[s]``; the total rounds up to a multiple of ``tile``
    (padding strips carry all-zero rows and contribute nothing).
    """
    p = np.maximum(lengths - g + 1, 0).astype(np.int64)
    rows = ((p + 7) // 8) * 8
    row0 = np.concatenate([[0], np.cumsum(rows)])
    total = int(row0[-1])
    total_pad = ((total + tile - 1) // tile) * tile
    n_strips = total_pad // tile

    # per-row sequence id (-1 padding) and window position
    seq_of = np.full(total_pad, -1, dtype=np.int32)
    win_of = np.zeros(total_pad, dtype=np.int32)
    for s in range(len(lengths)):
        a, b = int(row0[s]), int(row0[s] + p[s])
        seq_of[a:b] = s
        win_of[a:b] = np.arange(p[s], dtype=np.int32)

    # per-strip: local sequence span + per-local-seq end-row boundaries
    # (vectorized — the naive per-cell scan is O(strips * c_max * tile),
    # seconds of host time on large ragged sets)
    grid = seq_of.reshape(n_strips, tile)
    any_valid = (grid >= 0).any(axis=1)
    first_seq = np.where(
        any_valid, np.where(grid >= 0, grid, np.iinfo(np.int32).max).min(axis=1),
        len(lengths),
    ).astype(np.int32)
    last_seq = np.where(any_valid, grid.max(axis=1), -1)
    c_strip = np.where(any_valid, last_seq - first_seq + 1, 0).astype(np.int32)
    c_max = int(max(c_strip.max(initial=1), 1))
    # bounds[t, c]: 1 + last row index (within the strip) of local seq c —
    # cumsum gathered at bounds-1 gives per-seq prefix totals; past the
    # strip's last sequence the boundary carries forward (same prefix)
    rows = np.arange(total_pad, dtype=np.int64)
    t_of = rows // tile
    valid = seq_of >= 0
    local = seq_of.astype(np.int64) - first_seq[t_of]
    flat = np.zeros(n_strips * c_max, dtype=np.int32)
    np.maximum.at(
        flat,
        (t_of[valid] * c_max + local[valid]).astype(np.int64),
        (rows[valid] % tile + 1).astype(np.int32),
    )
    bounds = np.maximum.accumulate(
        flat.reshape(n_strips, c_max), axis=1
    ).astype(np.int32)
    return dict(
        p=p,
        rows=rows,
        row0=row0[:-1],
        total_pad=total_pad,
        n_strips=n_strips,
        seq_of=seq_of,
        win_of=win_of,
        first_seq=first_seq,
        c_max=c_max,
        bounds=bounds,
    )


def build_packed_x(
    ids: jnp.ndarray,  # [N, L] int32
    seq_of: jnp.ndarray,  # [R] int32 (-1 padding)
    win_of: jnp.ndarray,  # [R] int32
    *,
    g: int,
    alpha: int,
    code_min: int,
    dtype=jnp.bfloat16,
) -> jnp.ndarray:
    """One-hot packed window table ``[R, g * alpha]`` (0/1 in ``dtype``).

    Layout note: the obvious ``codes[..., None] == iota`` builds a
    [R, g, alpha] intermediate whose minor ``alpha`` dim is lane-padded
    to 128 and then reshaped to [R, g*alpha] — a full relayout copy that
    measured ~200 ms for a 100 MB table (~10x the memory bound). Instead
    the codes spread to the FINAL [R, g*alpha] layout with a tiny
    selection matmul (``sel[j, f] = 1`` iff ``f // alpha == j``; one-hot
    rows, so the f32 product is exactly ``codes[r, f // alpha]``) and
    compare against the static ``f % alpha`` lane pattern — every op
    runs in the output layout. Pad rows (seq_of < 0) are poisoned to -1
    before the spread, so the comparison never fires for them."""
    safe_seq = jnp.maximum(seq_of, 0)
    # gather each row's g codes: ids[seq, win + j]
    cols = win_of[:, None] + jnp.arange(g, dtype=jnp.int32)[None, :]
    codes = ids[safe_seq[:, None], cols]  # [R, g]
    codes = jnp.where((seq_of >= 0)[:, None], codes - code_min, -1)
    sel = jnp.repeat(jnp.eye(g, dtype=jnp.float32), alpha, axis=1)
    codes_f = jax.lax.dot_general(
        codes.astype(jnp.float32),
        sel,
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        # HIGHEST: default precision may run f32 operands as bf16 or TF32,
        # which is only exact for codes <= 256 / 2048 — force true-f32 products
        # so any code value < 2^24 spreads exactly (ADVICE r4)
        precision=jax.lax.Precision.HIGHEST,
    )  # [R, g * alpha]
    cmp = jnp.tile(jnp.arange(alpha, dtype=jnp.float32), g)
    return (codes_f == cmp[None, :]).astype(dtype)


def strip_planes_update(
    planes: Tuple[jnp.ndarray, ...],  # n_digits x [Np, Np] int32
    x: jnp.ndarray,  # [R, gA] bf16
    seq_of: jnp.ndarray,  # [R] int32
    first_seq: jnp.ndarray,  # [n_strips] int32
    bounds: jnp.ndarray,  # [n_strips, c_max] int32
    a_strip: jnp.ndarray,  # scalar int32
    *,
    g: int,
    k: int,
    tile: int,
    c_max: int,
    n_strips: int,
    n_digits: int,
    digit_base: int = 256,
):
    """Accumulate digit planes for strip a against all strips b >= a.

    Plane matrices must be padded to ``N + c_max`` so block scatters never
    clamp (the engine guarantees this).
    """
    xa, ga = _strip_a_operands(
        x, seq_of, first_seq, a_strip, tile=tile, c_max=c_max
    )
    fa = first_seq[a_strip]

    def body(b, planes):
        fb = first_seq[b]
        not_same = (b != a_strip).astype(jnp.int32)
        xb = jax.lax.dynamic_slice_in_dim(x, b * tile, tile, axis=0)
        parts = _pair_parts_xla(
            xa, xb, ga, bounds[b],
            g=g, k=k, tile=tile, c_max=c_max, n_digits=n_digits,
            digit_base=digit_base,
        )  # [n_digits, c_max, c_max] int32

        out_planes = []
        for dig in range(n_digits):
            part = parts[dig]
            # add P at (fa, fb); for a != b also P^T at (fb, fa) so every
            # ordered row pair counts exactly once (incl. strip-straddling
            # sequences). The second read sees the first write, so
            # overlapping regions (adjacent strips sharing a sequence)
            # compose correctly.
            plane = planes[dig]
            blk = jax.lax.dynamic_slice(plane, (fa, fb), (c_max, c_max))
            plane = jax.lax.dynamic_update_slice(plane, blk + part, (fa, fb))
            blk_t = jax.lax.dynamic_slice(plane, (fb, fa), (c_max, c_max))
            plane = jax.lax.dynamic_update_slice(
                plane, blk_t + part.T * not_same, (fb, fa)
            )
            out_planes.append(plane)
        return tuple(out_planes)

    return jax.lax.fori_loop(a_strip, n_strips, body, tuple(planes))


def _strip_a_operands(x, seq_of, first_seq, a_strip, *, tile, c_max):
    """Slice strip a's window rows and build its one-hot row->local-seq
    map G_a [c_max, tile] (padding rows match none)."""
    xa = jax.lax.dynamic_slice_in_dim(x, a_strip * tile, tile, axis=0)
    seq_a = jax.lax.dynamic_slice_in_dim(seq_of, a_strip * tile, tile, axis=0)
    fa = first_seq[a_strip]
    local_a = jnp.where(seq_a >= 0, seq_a - fa, -1)
    ga = (
        local_a[None, :] == jnp.arange(c_max, dtype=jnp.int32)[:, None]
    ).astype(jnp.bfloat16)
    return xa, ga


packed_strip_update = functools.partial(
    jax.jit,
    static_argnames=(
        "g", "k", "tile", "c_max", "n_strips", "n_digits", "digit_base",
    ),
)(strip_planes_update)


# ----------------------------------------------------------------- transfer
# Helpers for the host pull of the digit planes: combine them into one
# int32 matrix on device (runtime-bounded), gather only the upper-triangle
# tiles of the symmetric result, and let the caller bitcast each count to
# 3 bytes when everything fits 24 bits (ops/transfer.py).


@jax.jit
def plane_maxes(planes: Tuple[jnp.ndarray, ...]) -> jnp.ndarray:
    """[n_digits] int32 — per-plane max entry (planes are non-negative)."""
    return jnp.stack([jnp.max(p) for p in planes])


@functools.partial(jax.jit, static_argnames=("digit_base",))
def combine_planes_int32(
    planes: Tuple[jnp.ndarray, ...], *, digit_base: int
) -> jnp.ndarray:
    """``sum_d base^d * plane_d`` in int32.

    Caller must have verified ``sum_d base^d * max_d < 2^31`` (the digit
    decomposition exists precisely because a per-pair kernel entry can
    exceed int32 in the worst case; on real data it never does, and the
    caller falls back to per-plane int64 host combination when the
    runtime bound says otherwise)."""
    acc = planes[0]
    for d in range(1, len(planes)):
        acc = acc + (digit_base**d) * planes[d]
    return acc


@jax.jit
def split_diagonal(k32: jnp.ndarray):
    """``(diag, k32 with a zeroed diagonal)`` — the diagonal dominates the
    within-tile value range (K[i,i] >> K[i,j] off-diagonal), so pulling it
    as a separate [n] vector lets the byte-plane tile transfer pick widths
    from the off-diagonal range alone."""
    i = jnp.arange(k32.shape[0])
    return k32[i, i], k32.at[i, i].set(0)


@functools.partial(jax.jit, static_argnames=("tile",))
def upper_tiles(k32: jnp.ndarray, *, tile: int) -> jnp.ndarray:
    """``[M, tile, tile]`` gather of the upper-triangle tile list of a
    symmetric [n_pad, n_pad] matrix (zero-padded up to a tile multiple).

    M = nt*(nt+1)/2 with nt = ceil(n_pad / tile); the strictly-lower
    tiles — almost half the matrix — are never materialized on the host
    path, and the tile list is a single gather (one compile per shape,
    no per-band programs)."""
    n_pad = k32.shape[0]
    npt = -(-n_pad // tile)
    full = npt * tile
    if full > n_pad:
        k32 = jnp.pad(k32, ((0, full - n_pad), (0, full - n_pad)))
    t = k32.reshape(npt, tile, npt, tile).transpose(0, 2, 1, 3)
    idx = jnp.asarray(
        [i * npt + j for i in range(npt) for j in range(npt) if j >= i],
        dtype=jnp.int32,
    )
    return jnp.take(t.reshape(npt * npt, tile, tile), idx, axis=0)


def strip_block_shard_update(
    block: jnp.ndarray,  # [n_digits, blk, Np] int32: this device's rows
    x_own: jnp.ndarray,  # [spd * tile, gA] bf16: OWN strips' window rows
    seq_own: jnp.ndarray,  # [spd * tile] int32: own rows' sequence ids
    x_visit: jnp.ndarray,  # [spd * tile, gA] bf16: visiting shard's rows
    first_seq: jnp.ndarray,  # [n_strips] int32 (replicated, tiny)
    bounds: jnp.ndarray,  # [n_strips, c_max] int32 (replicated, tiny)
    a_base: jnp.ndarray,  # scalar int32: global id of own strip 0
    b_base: jnp.ndarray,  # scalar int32: global id of visiting strip 0
    row0: jnp.ndarray,  # scalar int32: global plane row of block[:, 0, :]
    *,
    spd: int,
    g: int,
    k: int,
    tile: int,
    c_max: int,
    n_strips: int,
    n_digits: int,
    digit_base: int = 256,
) -> jnp.ndarray:
    """Ring-step unit of the operand-sharded packed sweep: every own
    strip a against every strip b of the VISITING shard (ordered pairs,
    writes only rows (fa - row0, fb) of the caller's block). Dead strips
    (global id >= n_strips) contribute exactly zero: their padded window
    rows are all-zero one-hots, so D = 0 and C(0, k) = 0 for k >= 1; a
    dead a additionally masks via ``live``. Metadata indices clamp, so no
    padding of first_seq/bounds is needed."""

    def a_loop(ai, block):
        a = a_base + ai
        live = (a < n_strips).astype(jnp.int32)
        a_c = jnp.minimum(a, n_strips - 1)
        xa = jax.lax.dynamic_slice_in_dim(x_own, ai * tile, tile, axis=0)
        seq_a = jax.lax.dynamic_slice_in_dim(seq_own, ai * tile, tile, axis=0)
        fa = first_seq[a_c]
        local_a = jnp.where(seq_a >= 0, seq_a - fa, -1)
        ga = (
            local_a[None, :] == jnp.arange(c_max, dtype=jnp.int32)[:, None]
        ).astype(jnp.bfloat16)
        fa_local = fa - row0

        def b_loop(bi, block):
            b = b_base + bi
            b_c = jnp.minimum(b, n_strips - 1)
            xb = jax.lax.dynamic_slice_in_dim(
                x_visit, bi * tile, tile, axis=0
            )
            parts = _pair_parts_xla(
                xa, xb, ga, bounds[b_c],
                g=g, k=k, tile=tile, c_max=c_max,
                n_digits=n_digits, digit_base=digit_base,
            ) * live
            fb = first_seq[b_c]
            cur = jax.lax.dynamic_slice(
                block, (0, fa_local, fb), (n_digits, c_max, c_max)
            )
            return jax.lax.dynamic_update_slice(
                block, cur + parts, (0, fa_local, fb)
            )

        return jax.lax.fori_loop(0, spd, b_loop, block)

    return jax.lax.fori_loop(0, spd, a_loop, block)


def _pair_parts_xla(
    xa, xb, ga, bnd,
    *, g, k, tile, c_max, n_digits, digit_base,
):
    """Digit-plane contributions of ordered strip pair (a, b):
    ``[n_digits, c_max, c_max]`` int32 — counts between the sequences of
    strip a (rows) and strip b (columns), from pre-sliced operands. Used
    by the triangular single-device sweep (b >= a, with the transpose
    written at (fb, fa)) and the rows-sharded ring (all ordered b)."""
    from .pairs import binom_exact

    d = jax.lax.dot_general(
        xa, xb, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    rem = binom_exact(d, k)
    s1_list = []
    for dig in range(n_digits):
        if dig + 1 < n_digits:
            q = jnp.floor(rem * (1.0 / digit_base))
            digit = rem - q * float(digit_base)
            rem = q
        else:
            digit = rem
        # stage 1: rows -> i sequences (digit <= 255: bf16-exact matmul;
        # sums <= tile * 255 < 2^24: f32-exact)
        s1_list.append(
            jax.lax.dot_general(
                ga, digit.astype(jnp.bfloat16),
                (((1,), (0,)), ((), ())),
                preferred_element_type=jnp.float32,
            )
        )
    s1_all = jnp.stack(s1_list)
    # stage 2: columns -> j sequences via int32 cumsum + boundary
    # gather (running sums <= tile^2 * 255 < 2^31: int32-exact)
    cum = jnp.cumsum(s1_all.astype(jnp.int32), axis=2)
    at_bounds = jnp.take(cum, jnp.clip(bnd - 1, 0, tile - 1), axis=2)
    at_bounds = jnp.where((bnd > 0)[None, None, :], at_bounds, 0)
    prev = jnp.concatenate(
        [jnp.zeros((n_digits, c_max, 1), jnp.int32), at_bounds[:, :, :-1]],
        axis=2,
    )
    return at_bounds - prev
