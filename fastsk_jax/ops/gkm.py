"""Core device compute for the gapped k-mer kernel (dense-bucket path).

Algorithmic shape
-----------------
For one position subset theta (k kept positions out of g), the reference
pipeline is project -> LSD counting sort -> run detection -> per-sequence
outer products (shared.cpp:156-333). That is sort-centric and a poor fit
for matrix hardware. The identity used here instead:

    K_theta = C_theta @ C_theta.T

where ``C_theta[n, b]`` counts occurrences of projected k-mer value ``b`` in
sequence ``n``. Every run of equal k-mers — singletons included — contributes
the outer product of its per-sequence counts, which is exactly the reference's
countAndUpdateTri accumulation summed over runs. The partial kernel is a
count-matmul, and the histogram itself is built with one-hot matmuls, so
the whole pass is matrix math with static shapes.

The k-mer value is split into two factors ``b = h1 * B2 + h2`` with
``B1 = ds^ceil(k/2)``, ``B2 = ds^floor(k/2)`` so the histogram becomes the
per-(t, n) outer-product contraction

    C[t, n, h1, h2] = sum_p onehot(H1[t,n,p])[h1] * onehot(H2[t,n,p])[h2]

— small [P, B1] x [P, B2] matmuls instead of a scatter.

Exactness: one-hot entries are 0/1 (exact in bf16); per-window counts are
bounded by the window count P, so C is exact in bf16 when P <= 256 and in
f32 otherwise (f32 count dots run at HIGHEST precision: ``count_precision``);
matmuls accumulate in f32 and per-batch partial kernels stay below 2^24,
so casting to int32 and accumulating on-device is bit-exact integer
arithmetic end to end.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


def window_matrix(ids: jnp.ndarray, g: int) -> jnp.ndarray:
    """Sliding g-windows: ``[N, L]`` -> ``[N, P, g]`` with ``P = L - g + 1``.

    Dense equivalent of the reference's flat g-mer table
    (shared.cpp:17-53) — the (n, p) pair plays the role of (group, feature
    row), and invalid windows are masked downstream rather than compacted.
    """
    n, length = ids.shape
    p = length - g + 1
    cols = [jax.lax.slice_in_dim(ids, j, j + p, axis=1) for j in range(g)]
    return jnp.stack(cols, axis=-1)


def split_k(k: int) -> Tuple[int, int]:
    """Split k positions into the two hash levels (k1 >= k2)."""
    k2 = k // 2
    k1 = k - k2
    return k1, k2


def theta_hashes(
    windows: jnp.ndarray,  # [N, P, g] int32
    thetas: jnp.ndarray,  # [T, k] int32 position subsets
    base: int,
    code_min: int,
    k1: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Positional hashes of the projected k-mers in base ``base`` over
    digits ``code - code_min`` (injective on the observed code range and
    tighter than the reference's dict_size base: DNA hashes in base 4/5,
    not 6).

    Returns ``(H1, H2)`` of shape ``[T, N, P]`` int32 where the projected
    k-mer value is ``H1 * ds^k2 + H2``. Equivalent to the reference's
    mismatch-column removal (fastsk_kernel.cpp:224-227) followed by
    lexicographic sorting — the hash linearizes the lexicographic order so no
    sort is needed.
    """
    k = thetas.shape[1]
    k2 = k - k1
    # gathered[t, n, p, j] = windows[n, p, thetas[t, j]]
    gathered = jnp.take(windows, thetas, axis=2)  # [N, P, T, k]
    gathered = jnp.transpose(gathered, (2, 0, 1, 3))  # [T, N, P, k]
    gathered = gathered - code_min
    w1 = base ** jnp.arange(k1, dtype=jnp.int32)
    h1 = jnp.sum(gathered[..., :k1] * w1, axis=-1, dtype=jnp.int32)
    if k2 > 0:
        w2 = base ** jnp.arange(k2, dtype=jnp.int32)
        h2 = jnp.sum(gathered[..., k1:] * w2, axis=-1, dtype=jnp.int32)
    else:
        h2 = jnp.zeros_like(h1)
    return h1, h2


def histogram_counts(
    h1: jnp.ndarray,  # [T, N, P] int32
    h2: jnp.ndarray,  # [T, N, P] int32
    valid: jnp.ndarray,  # [N, P] bool — window inside sequence bounds
    b1: int,
    b2: int,
    count_dtype: jnp.dtype,
) -> jnp.ndarray:
    """Per-sequence k-mer count matrices ``C`` of shape ``[T, N, b1 * b2]``.

    The two one-hot factors are contracted over the window axis as one
    batched matmul.
    Invalid (padding) windows are zeroed on the first factor so they add no
    counts, reproducing ragged extraction exactly.
    """
    iota1 = jnp.arange(b1, dtype=jnp.int32)
    iota2 = jnp.arange(b2, dtype=jnp.int32)
    # 0/1 operands are exact in bf16 whatever count_dtype holds the sums
    one1 = (h1[..., None] == iota1) & valid[None, :, :, None]
    one1 = one1.astype(jnp.bfloat16)
    one2 = (h2[..., None] == iota2).astype(jnp.bfloat16)
    counts = jnp.einsum(
        "tnpa,tnpb->tnab", one1, one2, preferred_element_type=jnp.float32
    )
    t, n = counts.shape[:2]
    # store back in the compact dtype (exact: counts <= P <= 256 for bf16)
    return counts.reshape(t, n, b1 * b2).astype(count_dtype)


def _counts_for_batch(
    ids: jnp.ndarray,
    lengths: jnp.ndarray,
    thetas: jnp.ndarray,
    *,
    g: int,
    base: int,
    code_min: int,
    k1: int,
    b1: int,
    b2: int,
    count_dtype,
    row_chunk: int,
) -> jnp.ndarray:
    """Counts ``[T, N, B]`` for a theta batch, chunked over sequence rows.

    Row chunking bounds the one-hot intermediates (the dominant memory term,
    ~ row_chunk * P * (b1 + b2) * T elements) independent of N.
    """
    n, length = ids.shape
    p = length - g + 1
    windows = window_matrix(ids, g)
    pos = jnp.arange(p, dtype=jnp.int32)
    valid_full = pos[None, :] <= (lengths[:, None] - g)

    n_chunks = -(-n // row_chunk)
    pad_n = n_chunks * row_chunk - n
    if pad_n:
        windows = jnp.pad(windows, ((0, pad_n), (0, 0), (0, 0)))
        valid_full = jnp.pad(valid_full, ((0, pad_n), (0, 0)))

    windows = windows.reshape(n_chunks, row_chunk, p, g)
    valid_full = valid_full.reshape(n_chunks, row_chunk, p)

    def chunk_counts(args):
        w_chunk, v_chunk = args
        h1, h2 = theta_hashes(w_chunk, thetas, base, code_min, k1)
        return histogram_counts(h1, h2, v_chunk, b1, b2, count_dtype)

    counts = jax.lax.map(chunk_counts, (windows, valid_full))
    # [n_chunks, T, row_chunk, B] -> [T, N, B]
    counts = jnp.transpose(counts, (1, 0, 2, 3))
    counts = counts.reshape(thetas.shape[0], n_chunks * row_chunk, b1 * b2)
    return counts[:, :n, :]



def count_precision(operand: jnp.ndarray):
    """Dot precision for count operands: f32 counts above 2048 are not
    exact in TF32 (which a GPU may use for a default-precision f32 dot),
    so f32 operands ask for HIGHEST; bf16 operands hold exact counts
    <= 256 and run at the default."""
    if operand.dtype == jnp.float32:
        return jax.lax.Precision.HIGHEST
    return None


def _cross_gram_int32_split(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Exact int32 ``A @ B^T`` for count matrices beyond the f32 range.

    Counts split into 8-bit digits, which are exact bf16 operands."""
    a = a.astype(jnp.float32)
    b = b.astype(jnp.float32)
    a_hi = jnp.floor(a * (1.0 / 256.0)); a_lo = a - a_hi * 256.0
    b_hi = jnp.floor(b * (1.0 / 256.0)); b_lo = b - b_hi * 256.0
    a_hi, a_lo, b_hi, b_lo = (
        v.astype(jnp.bfloat16) for v in (a_hi, a_lo, b_hi, b_lo)
    )
    hh = jnp.matmul(a_hi, b_hi.T, preferred_element_type=jnp.float32)
    hl = jnp.matmul(a_hi, b_lo.T, preferred_element_type=jnp.float32)
    lh = jnp.matmul(a_lo, b_hi.T, preferred_element_type=jnp.float32)
    ll = jnp.matmul(a_lo, b_lo.T, preferred_element_type=jnp.float32)
    return (
        hh.astype(jnp.int32) * 65536
        + (hl + lh).astype(jnp.int32) * 256
        + ll.astype(jnp.int32)
    )


def count_gram_int32(counts: jnp.ndarray, count_split: bool) -> jnp.ndarray:
    """Exact int32 ``sum_t C_t @ C_t^T`` for a [T, N, B] f32/bf16 count batch.

    Plain path: per-batch products stay below 2^24, one f32 einsum is
    exact. Split path (windows-per-sequence > 4095): counts split into
    8-bit digits and the three digit-product matmuls accumulate per theta
    in int32, exact to 2^31 regardless of count magnitude.
    """
    if not count_split:
        k_batch = jnp.einsum(
            "tnb,tmb->nm", counts, counts, preferred_element_type=jnp.float32,
            precision=count_precision(counts),
        )
        return k_batch.astype(jnp.int32)

    return jnp.sum(
        jax.lax.map(lambda c: _cross_gram_int32_split(c, c), counts), axis=0
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "g",
        "base",
        "code_min",
        "k1",
        "b1",
        "b2",
        "count_dtype",
        "row_chunk",
        "matmul_dtype",
        "count_split",
    ),
)
def exact_batch_update(
    k_acc: jnp.ndarray,  # [N, N] int32 accumulator
    ids: jnp.ndarray,
    lengths: jnp.ndarray,
    thetas: jnp.ndarray,  # [T, k]
    *,
    g: int,
    base: int,
    code_min: int,
    k1: int,
    b1: int,
    b2: int,
    count_dtype,
    row_chunk: int,
    matmul_dtype,
    count_split: bool = False,
) -> jnp.ndarray:
    """k_acc += sum_t C_t @ C_t.T for one theta batch (exact integers)."""
    counts = _counts_for_batch(
        ids,
        lengths,
        thetas,
        g=g,
        base=base,
        code_min=code_min,
        k1=k1,
        b1=b1,
        b2=b2,
        count_dtype=count_dtype,
        row_chunk=row_chunk,
    ).astype(matmul_dtype)
    return k_acc + count_gram_int32(counts, count_split)


@functools.partial(
    jax.jit,
    static_argnames=(
        "g",
        "base",
        "code_min",
        "k1",
        "b1",
        "b2",
        "count_dtype",
        "row_chunk",
        "matmul_dtype",
        "n_train",
        "check_variance",
        "count_split",
    ),
)
def approx_batch_update(
    state: Tuple[jnp.ndarray, ...],
    ids: jnp.ndarray,
    lengths: jnp.ndarray,
    thetas: jnp.ndarray,  # [T, k]
    *,
    g: int,
    base: int,
    code_min: int,
    k1: int,
    b1: int,
    b2: int,
    count_dtype,
    row_chunk: int,
    matmul_dtype,
    n_train: int,
    check_variance: bool,
    conv_delta: float,
    max_iters: int,
    count_split: bool = False,
):
    """One theta batch of Monte-Carlo sampling with the reference stop rule.

    State is ``(k_sum int32 [N,N], mean f32 [N,N], iter int32, done bool)``.
    Per sampled theta (sequential scan within the batch, so statistics match
    a strictly per-iteration reference run):

    - ``k_sum += Ks`` (exact integer sum — the final kernel uses this, so the
      approx kernel mean is exact and deterministic given the theta stream)
    - Welford mean update and the reference's convergence statistic
      (fastsk_kernel.cpp:108-143, 243-262): sd = sqrt(mean_over_train_pairs(
      delta * delta2) / (iter - 1) / iter), stop when conv_delta / sd > 1.96.
    - Once done, remaining thetas in the batch are masked no-ops, so the
      consumed-iteration count is identical to a batch-size-1 run.

    Returns (state, sds) where sds[t] is the per-iteration sd trace (NaN for
    masked iterations).
    """
    counts = _counts_for_batch(
        ids,
        lengths,
        thetas,
        g=g,
        base=base,
        code_min=code_min,
        k1=k1,
        b1=b1,
        b2=b2,
        count_dtype=count_dtype,
        row_chunk=row_chunk,
    ).astype(matmul_dtype)

    tri_count = n_train * (n_train + 1) / 2.0

    def step(carry, c_t):
        k_sum, mean, it, done = carry
        if count_split:
            ks_int = _cross_gram_int32_split(c_t, c_t)
            ks = ks_int.astype(jnp.float32)  # Welford stats only
        else:
            ks = jnp.matmul(
                c_t, c_t.T, preferred_element_type=jnp.float32,
                precision=count_precision(c_t),
            )
            ks_int = ks.astype(jnp.int32)
        it_new = it + 1

        new_sum = k_sum + ks_int

        if check_variance:
            delta = ks - mean
            new_mean = mean + delta / it_new.astype(jnp.float32)
            delta2 = ks - new_mean
            prod = (delta * delta2)[:n_train, :n_train]
            # average over the packed triangular train pairs (diag included),
            # matching the reference's n_train_pairs loop bound
            tri_sum = (jnp.sum(prod) + jnp.sum(jnp.diagonal(prod))) / 2.0
            avg_var = tri_sum / tri_count
            avg_var = jnp.where(it_new == 1, 9999999.0, avg_var / jnp.maximum(it_new - 1, 1))
            sd = jnp.sqrt(avg_var / it_new)
            converged = conv_delta / sd > 1.96
        else:
            new_mean = mean
            sd = jnp.float32(jnp.nan)
            converged = jnp.bool_(False)

        hit_max = (max_iters != -1) & (it_new >= max_iters)
        new_done = done | converged | hit_max

        # masked update: once done, this theta never happened
        k_sum = jnp.where(done, k_sum, new_sum)
        mean = jnp.where(done, mean, new_mean)
        it = jnp.where(done, it, it_new)
        sd = jnp.where(done, jnp.float32(jnp.nan), sd)
        return (k_sum, mean, it, new_done), sd

    (k_sum, mean, it, done), sds = jax.lax.scan(step, state, counts)
    return (k_sum, mean, it, done), sds
