"""Fused exact all-pairs sweep for NVIDIA Hopper (Pallas through Triton).

Fuses the three stages of ops/pairs.py — the match-count matmul
``D = X_i X_j^T``, the exact binomial weight ``C(D, k)`` and the
window->sequence reduction — so that D never leaves the SM: only the 0/1
one-hot windows come in and only int32 kernel entries go out. The plain
XLA path (ops/pairs.py) writes every D strip to device memory and reads
it back for the weight chain and the reshape-sum.

Layout. Windows are sequence-aligned: sequence ``s`` owns rows
``[s * p_pad, (s + 1) * p_pad)`` of X. Triton wants power-of-two blocks
and ``p_pad`` is a multiple of 16, not of a power of two (192 at length
200), so X is cut into ``bt``-row tiles with ``bt`` the largest power of
two (<= 64) dividing ``p_pad``; sequence ``s`` is then ``n_sub = p_pad /
bt`` whole tiles. A ``[bt, bt]`` D tile belongs to exactly one sequence
pair, so its weights reduce to one scalar.

Grid. Program ``(a, J)`` owns row ``a`` of K and the ``sj`` columns of
column block ``J``. It keeps sequence ``a``'s ``n_sub`` tiles in
registers and walks the column tiles of sequences ``b >= a`` only, so the
sweep does exactly the upper triangle; entries with ``b < a`` are written
as zeros and the caller mirrors. Blocks run in any order; nothing carries
between them.

Weight chain: int8 0/1 operands give exact int32 match counts D; the
falling factorial ``ff = d(d-1)...(d-k+1) = k! * C(d, k)`` runs in int32
(exact: ``g!/(g-k)! < 2^24``). The ``ff`` of ``grp`` row tiles are summed
elementwise and their column sums taken in int32
(``grp * bt * g!/(g-k)! < 2^31``); then one deferred ``/k!`` per column
and group — the f32 cast and reciprocal multiply err by under
``S * 2^-22`` for a quotient ``S <= grp * bt * C(g, k) < 2^21``, so
rounding recovers it exactly. ``grp`` is the largest count of tiles, up
to a whole sequence's ``n_sub``, that keeps both bounds
(``tiles_per_division``); since they hold per group, they do not limit
``p_pad``. On an H100 one division per tile (``grp = 1``) made the KAT2B
sweep 1.57x slower than one per sequence, and an f32 chain (bf16
operands, per-element rounding) ran 1.7x slower than this one.

Per-entry totals are bounded by ``p_pad^2 * C(g, k) < 2^31``, which the
engine guards before it picks this route.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton


def tile_rows(p_pad: int) -> int:
    """Rows per D tile: the largest power of two <= 64 dividing p_pad."""
    bt = 64
    while p_pad % bt:
        bt //= 2
    return bt


def tiles_per_division(g: int, k: int, p_pad: int) -> int:
    """Row tiles whose weights share one ``/k!``: the most, up to
    ``p_pad / bt``, that keep the bounds in the module docstring (0 when
    not even one tile does)."""
    bt = tile_rows(p_pad)
    ffmax = math.factorial(g) // math.factorial(g - k)
    return min(
        p_pad // bt,
        ((1 << 31) - 1) // (bt * ffmax),
        ((1 << 21) - 1) // (bt * math.comb(g, k)),
    )


def kernel_fits(g: int, k: int, p_pad: int) -> bool:
    """Whether the fused kernel is exact for this shape.

    Needs 16-row tiles (the tensor-core minimum), k >= 1 (padding rows
    then weigh C(0, k) = 0), and the bounds in the module docstring.
    """
    return (
        k >= 1
        and p_pad % 16 == 0
        and math.factorial(g) // math.factorial(g - k) < (1 << 24)
        and tiles_per_division(g, k, p_pad) >= 1
    )


def ffact_pairing(d: jnp.ndarray, k: int) -> jnp.ndarray:
    """Falling factorial d(d-1)...(d-k+1) with balanced factor pairing:
    (d-i)(d-(k-1-i)) = t + i(k-1-i) with t = d^2 - (k-1)d, so it costs
    about k/2 multiplies. Exact in int32 while the result fits."""
    if k == 1:
        return d
    t = d * (d - (k - 1))
    prod = t
    for i in range(1, k // 2):
        prod = prod * (t + i * (k - 1 - i))
    if k % 2:
        prod = prod * (d - (k - 1) // 2)
    return prod


def divide_by_kfact(s: jnp.ndarray, k: int) -> jnp.ndarray:
    """Exact ``s / k!`` for int32 ``s`` that k! divides, while the
    quotient is below 2^21: one f32 cast, a reciprocal multiply and a
    round (their errors stay under ``q * 2^-22 < 0.5``)."""
    inv = 1.0 / float(math.factorial(k))
    return jnp.floor(s.astype(jnp.float32) * inv + 0.5).astype(jnp.int32)


def _pairs_kernel(x_ref, o_ref, *, k: int, n_sub: int, grp: int, sj: int):
    a = pl.program_id(0)
    b0 = pl.program_id(1) * sj
    xi = [x_ref[a * n_sub + r] for r in range(n_sub)]  # [bt, f] each

    def body(t, acc):
        xj = x_ref[b0 * n_sub + t]  # [bt, f]
        col = ff = None
        for r in range(n_sub):
            d = jax.lax.dot_general(
                xi[r], xj, (((1,), (1,)), ((), ())),
                preferred_element_type=jnp.int32,
            )  # [bt, bt] match counts
            w = ffact_pairing(d, k)
            ff = w if ff is None else ff + w
            if (r + 1) % grp == 0 or r + 1 == n_sub:
                # [bt] column sums of the group's tiles, divided by k!
                c = divide_by_kfact(jnp.sum(ff, axis=0), k)
                col = c if col is None else col + c
                ff = None
        lane = jax.lax.broadcasted_iota(jnp.int32, (sj,), 0)
        return acc + jnp.where(lane == t // n_sub, jnp.sum(col), 0)

    t_lo = jnp.clip(a - b0, 0, sj) * n_sub
    o_ref[...] = jax.lax.fori_loop(
        t_lo, sj * n_sub, body, jnp.zeros((sj,), jnp.int32)
    )


@functools.partial(
    jax.jit, static_argnames=("g", "k", "p_pad", "sj", "interpret")
)
def pairs_upper(
    x: jnp.ndarray,  # [n_pad * p_pad, f] int8 0/1
    *,
    g: int,
    k: int,
    p_pad: int,
    sj: int,
    interpret: bool = False,
) -> jnp.ndarray:
    """Exact K entries ``[n_pad, n_pad]`` int32 on and above the diagonal,
    zeros below. ``f`` must be a power of two >= 32 (zero columns are
    free: they add nothing to D), ``sj`` must divide ``n_pad``, and
    ``kernel_fits(g, k, p_pad)`` must hold."""
    n_rows, f = x.shape
    n_pad = n_rows // p_pad
    bt = tile_rows(p_pad)
    n_sub = p_pad // bt
    if (
        x.dtype != jnp.int8
        or n_pad * p_pad != n_rows
        or n_pad % sj
        or f & (f - 1)
        or f < 32
        or not kernel_fits(g, k, p_pad)
    ):
        raise ValueError(
            f"bad pairs kernel operand: x {x.dtype}{x.shape}, "
            f"g={g}, k={k}, p_pad={p_pad}, sj={sj}"
        )
    kernel = functools.partial(
        _pairs_kernel, k=k, n_sub=n_sub,
        grp=tiles_per_division(g, k, p_pad), sj=sj,
    )
    return pl.pallas_call(
        kernel,
        grid=(n_pad, n_pad // sj),
        out_specs=pl.BlockSpec((None, sj), lambda a, jb: (a, jb)),
        out_shape=jax.ShapeDtypeStruct((n_pad, n_pad), jnp.int32),
        compiler_params=pltriton.CompilerParams(num_warps=4, num_stages=3),
        backend="triton",
        interpret=interpret,
        name="fastsk_pairs_upper",
    )(x.reshape(n_pad * n_sub, bt, f))
