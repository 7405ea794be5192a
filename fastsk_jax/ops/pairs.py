"""All-pairs formulation of the exact gapped k-mer kernel.

The reference (and the theta engine here) computes the exact kernel as
C(g, m) independent counting passes, one per position subset
(fastsk_kernel.cpp:145-322). On a systolic-array machine the far better
shape collapses *all* passes into one flash-attention-like computation via
the identity

    K[i, j] = sum_{p, q} C(matches(w_ip, w_jq), k)

where ``matches`` is the number of agreeing positions between two g-mers
and C is the binomial coefficient: a position subset theta contributes to
the (p, q) window pair iff all k kept positions agree, and there are
exactly C(#agreeing, k) such subsets. (Same counting semantics as
countAndUpdateTri summed over every subset — singleton runs included.)

Pipeline per tile pair: one 0/1 matmul ``D = X_i @ X_j^T`` over the
position-one-hot encoding (so D = #matching positions, exact small
integers), an integer-exact degree-k polynomial C(D, k), and a
window->sequence reduction that is a pure reshape-sum because window rows
are sequence-aligned. The matmul does ~all the work; there is no |alphabet|^k
bucket space, so large-alphabet protein/text workloads cost the same as
DNA.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def binom_exact(x: jnp.ndarray, k: int) -> jnp.ndarray:
    """C(x, k) for small integer-valued f32 x — exact in float32.

    Stepwise ``c_{j+1} = c_j * (x - j) / (j + 1)``: every intermediate is
    (j+1) * C(x, j+1) <= C(20, 10) * 20 < 2^24, and each division's true
    quotient is an integer, so f32 arithmetic is exact end to end. Integer
    x < k hits a zero factor, so out-of-range windows (and padding, which
    produces matches == 0) get weight 0 with no masking.
    """
    c = jnp.ones_like(x)
    for j in range(k):
        c = c * (x - j) / float(j + 1)
    return c


def onehot_windows(
    ids: jnp.ndarray,  # [N, L] int32
    lengths: jnp.ndarray,  # [N]
    *,
    g: int,
    alpha: int,  # hash alphabet size (code_max - code_min + 1)
    code_min: int,
    p_pad: int,
    dtype=jnp.bfloat16,
) -> jnp.ndarray:
    """Per-window one-hot position encoding ``X [N, p_pad, g * alpha]``.

    Row (n, p) holds the concatenated one-hots of the g codes of window p of
    sequence n; invalid windows (p > len - g) are all-zero, so their match
    count against anything is 0 and their binomial weight vanishes.
    ``dtype``: bf16 for the XLA matmul paths, int8 for the fused kernel
    (ops/pairs_pallas.py) — 0/1 values are exact in either.
    """
    n, length = ids.shape
    p = length - g + 1
    cols = [jax.lax.slice_in_dim(ids, j, j + p, axis=1) for j in range(g)]
    win = jnp.stack(cols, axis=-1)  # [N, P, g]
    pos = jnp.arange(p, dtype=jnp.int32)
    valid = pos[None, :] <= (lengths[:, None] - g)  # [N, P]
    # Relayout-free one-hot (see ops/pairs_packed.build_packed_x): the
    # naive win[..., None] == iota builds an [N, P, g, alpha] intermediate
    # whose minor alpha dim is lane-padded to 128 and then reshaped — a
    # full relayout copy. Spread the codes to the final [N, P, g*alpha]
    # layout with a one-hot-row selection matmul (exact in f32) and
    # compare against the static f % alpha lane pattern; invalid windows
    # are poisoned to -1 so the comparison never fires.
    win = jnp.where(valid[:, :, None], win - code_min, -1)
    sel = jnp.repeat(jnp.eye(g, dtype=jnp.float32), alpha, axis=1)
    win_f = jax.lax.dot_general(
        win.astype(jnp.float32),
        sel,
        dimension_numbers=(((2,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        # HIGHEST: default precision may run f32 operands as bf16 or TF32,
        # which is only exact for codes <= 256 / 2048 — force true-f32 products
        # so any code value < 2^24 spreads exactly (ADVICE r4). The sel
        # operand is [g, g*alpha]: negligible next to the D matmuls.
        precision=jax.lax.Precision.HIGHEST,
    )  # [N, P, g * alpha]
    cmp = jnp.tile(jnp.arange(alpha, dtype=jnp.float32), g)
    oh = (win_f == cmp[None, None, :]).astype(dtype)
    if p_pad > p:
        oh = jnp.pad(oh, ((0, 0), (0, p_pad - p), (0, 0)))
    return oh


def strip_rows(
    x: jnp.ndarray,  # [Ns * p_pad, gA] bf16, sequence-aligned rows
    i_strip: jnp.ndarray,  # scalar int32
    *,
    k: int,
    c_i: int,
    c_j: int,
    p_pad: int,
    n_strips_j: int,
) -> jnp.ndarray:
    """K rows ``[c_i, Ns]`` for one i strip against all j strips >= its own
    (block upper triangle only; callers symmetrize). Strips past the end
    (padding in sharded execution) produce zeros."""
    n_rows = x.shape[0]
    r_i = c_i * p_pad
    r_j = c_j * p_pad
    n_strips_i = n_rows // r_i
    live = i_strip < n_strips_i
    i_eff = jnp.minimum(i_strip, n_strips_i - 1)
    xi = jax.lax.dynamic_slice_in_dim(x, i_eff * r_i, r_i, axis=0)

    j_lo = (i_eff * c_i) // c_j
    # + 0 * i_strip: inherit i_strip's varying-axes under shard_map so the
    # fori carry types line up when each device runs a different strip
    rows0 = jnp.zeros((c_i, n_rows // p_pad), jnp.int32) + 0 * i_strip

    def body(j, rows):
        xj = jax.lax.dynamic_slice_in_dim(x, j * r_j, r_j, axis=0)
        d = jnp.matmul(xi, xj.T, preferred_element_type=jnp.float32)
        # weights are exact f32 integers <= C(20, 10) < 2^24; all summation
        # runs in int32 (exact to 2^31 — the engine guards the bound)
        w = binom_exact(d, k).astype(jnp.int32)
        # windows -> sequences: rows/cols are sequence-aligned, so the
        # group reduction is a reshape-sum (no G matmul needed)
        w = w.reshape(c_i, p_pad, c_j, p_pad)
        part = jnp.sum(w, axis=(1, 3))  # [c_i, c_j] int32
        return jax.lax.dynamic_update_slice(rows, part, (0, j * c_j))

    rows = jax.lax.fori_loop(j_lo, n_strips_j, body, rows0)
    return jnp.where(live, rows, 0)


@functools.partial(
    jax.jit,
    static_argnames=("k", "c_i", "c_j", "p_pad", "n_strips_j"),
)
def pairs_strip_update(
    k_acc: jnp.ndarray,  # [Ns, Ns] int32
    x: jnp.ndarray,  # [Ns * p_pad, gA] bf16, sequence-aligned rows
    i_strip: jnp.ndarray,  # scalar int32 — which i strip
    *,
    k: int,
    c_i: int,
    c_j: int,
    p_pad: int,
    n_strips_j: int,
):
    """Write K rows for one i strip into the accumulator (upper triangle)."""
    rows = strip_rows(
        x, i_strip, k=k, c_i=c_i, c_j=c_j, p_pad=p_pad, n_strips_j=n_strips_j
    )
    return jax.lax.dynamic_update_slice(k_acc, rows, (i_strip * c_i, 0))
