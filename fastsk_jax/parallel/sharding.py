"""Multi-device execution of the gkm kernel over a ``jax.sharding.Mesh``.

The reference's only parallelism is a single-host pthread pool over the
C(g, m) counting passes with a banded-mutex merge (fastsk_kernel.cpp:53-93,
285-315). Here two axes of the computation shard over a device mesh and
merge with XLA collectives instead of locks:

- ``rows``: sequences (kernel-matrix row blocks) — data parallelism. Each
  device builds the count matrices ``C_theta`` for its row block, all-gathers
  the column copies from its peers (over NVLink, all to all, on a
  multi-GPU host), and produces its row block of
  ``K = sum_theta C_theta @ C_theta^T`` locally.
- ``theta``: the work queue of position subsets — the axis the reference
  threads over. Partial kernels from different theta shards merge with a
  single ``psum``.

Exact mode shards ``rows x theta``. Approx (Monte-Carlo) mode is a
sequential statistical procedure — the Welford convergence state must see
thetas in order — so it shards ``rows`` only and keeps the per-theta scan,
with the convergence statistic reduced across row shards by ``psum``.

Everything here is deterministic: no lock ordering, no time seeding
(fastsk_kernel.cpp:37), and integer-exact accumulation identical to the
single-device path.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import gkm

ROWS_AXIS = "rows"
THETA_AXIS = "theta"


def make_mesh(n_rows: int, n_theta: int, devices=None) -> Mesh:
    """Create a ``(rows, theta)`` mesh from the first ``n_rows * n_theta``
    local devices (or an explicit device list)."""
    if devices is None:
        devices = jax.devices()
    need = n_rows * n_theta
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    arr = np.asarray(devices[:need]).reshape(n_rows, n_theta)
    return Mesh(arr, (ROWS_AXIS, THETA_AXIS))


def default_mesh_shape(n_devices: int) -> Tuple[int, int]:
    """Split n_devices into (rows, theta) favoring a balanced 2-D mesh."""
    rows = 1
    for cand in range(int(np.sqrt(n_devices)), 0, -1):
        if n_devices % cand == 0:
            rows = cand
            break
    return rows, n_devices // rows


def host_gather(arr: jnp.ndarray, dtype=np.int64) -> np.ndarray:
    """Fetch a (possibly cross-process) sharded array to the host.

    Single-process meshes transfer directly; under ``jax.distributed``
    the shards on other hosts are not addressable, so the global value is
    assembled with an all-gather over DCN first.
    """
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        arr = multihost_utils.process_allgather(arr, tiled=True)
    return np.asarray(arr, dtype=dtype)


def pad_to_multiple(x: np.ndarray, axis: int, multiple: int) -> np.ndarray:
    size = x.shape[axis]
    target = ((size + multiple - 1) // multiple) * multiple
    if target == size:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, target - size)
    return np.pad(x, widths)


def shard_rows(mesh: Mesh, ids: np.ndarray, lengths: np.ndarray):
    """Pad the sequence axis to the rows-axis size and place sharded arrays.

    Padded rows have length 0, so every window is masked invalid and they
    contribute exactly zero counts — the kernel rows/cols come out zero and
    are sliced off by the caller.
    """
    n_rows = mesh.shape[ROWS_AXIS]
    ids_p = pad_to_multiple(ids, 0, n_rows)
    lengths_p = pad_to_multiple(lengths, 0, n_rows)
    ids_s = jax.device_put(ids_p, NamedSharding(mesh, P(ROWS_AXIS, None)))
    lengths_s = jax.device_put(lengths_p, NamedSharding(mesh, P(ROWS_AXIS)))
    return ids_s, lengths_s, ids_p.shape[0]


def pad_theta_batch(thetas: np.ndarray, n_theta: int):
    """Pad a theta batch to the theta-axis size; returns (thetas, mask)."""
    t = thetas.shape[0]
    thetas_p = pad_to_multiple(thetas, 0, n_theta)
    mask = np.zeros(thetas_p.shape[0], dtype=np.float32)
    mask[:t] = 1.0
    return thetas_p, mask


@functools.partial(
    jax.jit,
    static_argnames=(
        "mesh",
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
def exact_batch_update_sharded(
    k_acc: jnp.ndarray,  # [Np, Np] int32, rows-sharded
    ids: jnp.ndarray,  # [Np, L] rows-sharded
    lengths: jnp.ndarray,  # [Np] rows-sharded
    thetas: jnp.ndarray,  # [Tp, k] theta-sharded
    theta_mask: jnp.ndarray,  # [Tp] f32 theta-sharded, 0 for padding
    *,
    mesh: Mesh,
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
    """``k_acc += sum_theta C_theta @ C_theta^T`` over a (rows, theta) mesh."""

    def local(k_l, ids_l, len_l, th_l, mask_l):
        counts = gkm._counts_for_batch(
            ids_l,
            len_l,
            th_l,
            g=g,
            base=base,
            code_min=code_min,
            k1=k1,
            b1=b1,
            b2=b2,
            count_dtype=count_dtype,
            row_chunk=row_chunk,
        )
        counts = counts * mask_l[:, None, None].astype(counts.dtype)
        counts = counts.astype(matmul_dtype)
        # column copies of the count matrices travel once per batch
        counts_all = jax.lax.all_gather(counts, ROWS_AXIS, axis=1, tiled=True)
        if count_split:
            k_part = jnp.sum(
                jax.lax.map(
                    lambda cc: gkm._cross_gram_int32_split(cc[0], cc[1]),
                    (counts, counts_all),
                ),
                axis=0,
            )
        else:
            k_part = jnp.einsum(
                "tnb,tmb->nm", counts, counts_all,
                preferred_element_type=jnp.float32,
                precision=gkm.count_precision(counts),
            ).astype(jnp.int32)
        k_part = jax.lax.psum(k_part, THETA_AXIS)
        return k_l + k_part

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P(ROWS_AXIS, None),
            P(ROWS_AXIS, None),
            P(ROWS_AXIS),
            P(THETA_AXIS, None),
            P(THETA_AXIS),
        ),
        out_specs=P(ROWS_AXIS, None),
    )(k_acc, ids, lengths, thetas, theta_mask)


@functools.partial(
    jax.jit,
    static_argnames=(
        "mesh",
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
def approx_batch_update_sharded(
    state: Tuple[jnp.ndarray, ...],  # (k_sum [Np,Np], mean [Np,Np], it, done)
    ids: jnp.ndarray,
    lengths: jnp.ndarray,
    thetas: jnp.ndarray,  # [T, k] replicated — order is the sample stream
    *,
    mesh: Mesh,
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
    """Rows-sharded Monte-Carlo batch with the reference stop rule.

    Semantically identical to ``gkm.approx_batch_update`` (single-device):
    thetas are consumed strictly in order and the convergence statistic —
    the mean Welford variance over the packed train-pair triangle
    (fastsk_kernel.cpp:108-143) — is reduced over row shards with ``psum``
    each iteration.
    """
    n_rows_axis = mesh.shape[ROWS_AXIS]
    n_total = ids.shape[0]
    n_local = n_total // n_rows_axis
    tri_count = n_train * (n_train + 1) / 2.0

    def local(state_l, ids_l, len_l, th):
        k_sum_l, mean_l, it, done = state_l
        counts = gkm._counts_for_batch(
            ids_l,
            len_l,
            th,
            g=g,
            base=base,
            code_min=code_min,
            k1=k1,
            b1=b1,
            b2=b2,
            count_dtype=count_dtype,
            row_chunk=row_chunk,
        ).astype(matmul_dtype)
        counts_all = jax.lax.all_gather(counts, ROWS_AXIS, axis=1, tiled=True)

        row0 = jax.lax.axis_index(ROWS_AXIS) * n_local
        grow = row0 + jnp.arange(n_local)[:, None]  # global row ids [n_local,1]
        gcol = jnp.arange(n_total)[None, :]
        train_pair = (grow < n_train) & (gcol < n_train)
        on_diag = grow == gcol

        def step(carry, c_pair):
            k_sum, mean, it, done = carry
            c_l, c_all = c_pair
            if count_split:
                ks_int = gkm._cross_gram_int32_split(c_l, c_all)
                ks = ks_int.astype(jnp.float32)
            else:
                ks = jnp.matmul(
                    c_l, c_all.T, preferred_element_type=jnp.float32,
                    precision=gkm.count_precision(c_l),
                )
                ks_int = ks.astype(jnp.int32)
            it_new = it + 1
            new_sum = k_sum + ks_int

            if check_variance:
                delta = ks - mean
                new_mean = mean + delta / it_new.astype(jnp.float32)
                delta2 = ks - new_mean
                prod = jnp.where(train_pair, delta * delta2, 0.0)
                local_tri = (
                    jnp.sum(prod) + jnp.sum(jnp.where(on_diag, prod, 0.0))
                ) / 2.0
                tri_sum = jax.lax.psum(local_tri, ROWS_AXIS)
                avg_var = tri_sum / tri_count
                avg_var = jnp.where(
                    it_new == 1, 9999999.0, avg_var / jnp.maximum(it_new - 1, 1)
                )
                sd = jnp.sqrt(avg_var / it_new)
                converged = conv_delta / sd > 1.96
            else:
                new_mean = mean
                sd = jnp.float32(jnp.nan)
                converged = jnp.bool_(False)

            hit_max = (max_iters != -1) & (it_new >= max_iters)
            new_done = done | converged | hit_max
            k_sum = jnp.where(done, k_sum, new_sum)
            mean = jnp.where(done, mean, new_mean)
            it = jnp.where(done, it, it_new)
            sd = jnp.where(done, jnp.float32(jnp.nan), sd)
            return (k_sum, mean, it, new_done), sd

        # scan over the theta axis of the batch, in stream order
        (k_sum_l, mean_l, it, done), sds = jax.lax.scan(
            step, (k_sum_l, mean_l, it, done), (counts, counts_all)
        )
        return (k_sum_l, mean_l, it, done), sds

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(
            (P(ROWS_AXIS, None), P(ROWS_AXIS, None), P(), P()),
            P(ROWS_AXIS, None),
            P(ROWS_AXIS),
            P(),
        ),
        out_specs=((P(ROWS_AXIS, None), P(ROWS_AXIS, None), P(), P()), P()),
    )(state, ids, lengths, thetas)


@functools.partial(
    jax.jit,
    static_argnames=(
        "mesh", "g", "base", "code_min", "n", "p", "slab", "dpw",
        "n_words", "count_split", "static_slabs", "tri_blocks",
        "layout", "run_width",
    ),
)
def sorted_batch_sharded(
    k_dev: jnp.ndarray,  # [n_dev, n, n] int32, device-sharded on axis 0
    windows: jnp.ndarray,  # [nfeat, g] int32, replicated
    valid: jnp.ndarray,  # [nfeat] bool, replicated
    seq_of: jnp.ndarray,  # [nfeat] int32, replicated
    thetas: jnp.ndarray,  # [n_dev, T, k] int32, device-sharded
    live: jnp.ndarray,  # [n_dev, T] int32, device-sharded
    *,
    mesh: Mesh,
    **static,
):
    """Theta-sharded batched sorted passes: each device runs its own
    batched sort pipeline (ops/sorted_theta.py) over its theta sub-batch
    and accumulates into its private kernel replica — the theta axis of
    the reference's thread pool (fastsk_kernel.cpp:53-93), with the merge
    deferred to a host sum of replicas instead of mutexes."""
    from ..ops.sorted_theta import sorted_theta_pass_batch

    def local(k_l, w, v, s, th, lv):
        ks = sorted_theta_pass_batch(w, v, s, th[0], **static)
        ks = ks * lv[0][:, None, None]
        return k_l + jnp.sum(ks, axis=0)[None]

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P((ROWS_AXIS, THETA_AXIS), None, None),
            P(), P(), P(),
            P((ROWS_AXIS, THETA_AXIS), None, None),
            P((ROWS_AXIS, THETA_AXIS), None),
        ),
        out_specs=P((ROWS_AXIS, THETA_AXIS), None, None),
    )(k_dev, windows, valid, seq_of, thetas, live)


@functools.partial(
    jax.jit,
    static_argnames=(
        "mesh", "g", "base", "code_min", "n", "n_pad", "n_rows", "p",
        "slab", "dpw", "n_words", "count_split", "layout", "run_width",
    ),
)
def sorted_batch_rowsharded(
    k_rows: jnp.ndarray,  # [R * n_rows, n] int32, rows-sharded on axis 0
    windows: jnp.ndarray,  # [nfeat, g] int32, replicated
    valid: jnp.ndarray,  # [nfeat] bool, replicated
    seq_of: jnp.ndarray,  # [nfeat] int32, replicated
    thetas: jnp.ndarray,  # [T_axis * Tb, k] int32, theta-sharded
    live: jnp.ndarray,  # [T_axis * Tb] int32, theta-sharded
    *,
    mesh: Mesh,
    n_pad: int,
    n_rows: int,
    **static,
):
    """Rows x theta sharded batched sorted passes with O(N^2 / R)
    per-device state (KernelConfig.mesh_state="sharded").

    Device (r, t) runs theta shard t's sort pipeline but accumulates only
    kernel row strip r ([n_rows, n], ops/sorted_theta.py:
    sorted_theta_pass_batch_sum_rows); theta shards merge with one psum
    per batch, exactly the dense engine's structure
    (exact_batch_update_sharded). The sort phase is duplicated across the
    rows axis — the price of never materializing [n, n] anywhere; pick
    mesh shape (R, T) to trade memory scaling (R) against throughput (T).
    Integer-identical to the single-device batch sum.
    """
    from ..ops.sorted_theta import sorted_theta_pass_batch_sum_rows

    def local(k_l, w, v, s, th, lv):
        row0 = jax.lax.axis_index(ROWS_AXIS) * n_rows
        part = sorted_theta_pass_batch_sum_rows(
            jnp.zeros_like(k_l), w, v, s, th, lv, row0,
            n_pad=n_pad, n_rows=n_rows, **static,
        )
        part = jax.lax.psum(part, THETA_AXIS)
        return k_l + part

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P(ROWS_AXIS, None),
            P(), P(), P(),
            P(THETA_AXIS, None),
            P(THETA_AXIS),
        ),
        out_specs=P(ROWS_AXIS, None),
    )(k_rows, windows, valid, seq_of, thetas, live)


@functools.partial(
    jax.jit,
    static_argnames=(
        "mesh", "g", "k", "tile", "c_max", "n_strips", "n_digits",
        "digit_base",
    ),
)
def packed_round_sharded(
    planes_dev: jnp.ndarray,  # [n_dev, n_digits, Np, Np] int32, dev-sharded
    x: jnp.ndarray,  # [R, gA] bf16, replicated
    seq_of: jnp.ndarray,  # [R] int32, replicated
    first_seq: jnp.ndarray,  # [n_strips] int32, replicated
    bounds: jnp.ndarray,  # [n_strips, c_max] int32, replicated
    round_idx: jnp.ndarray,  # scalar int32
    *,
    mesh: Mesh,
    g: int,
    k: int,
    tile: int,
    c_max: int,
    n_strips: int,
    n_digits: int,
    digit_base: int,
):
    """One round-robin round of the packed (ragged) all-pairs engine.

    Each device runs strip ``a = round_idx * n_dev + device`` against all
    strips b >= a, accumulating into its PRIVATE digit-plane replica —
    every (a, b) pair is handled by exactly one device, so the final merge
    is an elementwise sum of the per-device planes (done host-side by the
    engine). Round-robin assignment balances the triangular b loop.
    """
    from ..ops import pairs_packed

    n_dev = mesh.shape[ROWS_AXIS] * mesh.shape[THETA_AXIS]

    def local(planes_l, x_r, seq_r, fs_r, bd_r, ridx):
        dev = (
            jax.lax.axis_index(ROWS_AXIS) * mesh.shape[THETA_AXIS]
            + jax.lax.axis_index(THETA_AXIS)
        )
        a_strip = ridx * n_dev + dev  # >= n_strips -> empty fori, no-op
        planes_t = tuple(planes_l[0][d] for d in range(n_digits))
        out = pairs_packed.strip_planes_update(
            planes_t, x_r, seq_r, fs_r, bd_r, a_strip,
            g=g, k=k, tile=tile, c_max=c_max, n_strips=n_strips,
            n_digits=n_digits, digit_base=digit_base,
        )
        return jnp.stack(out)[None]

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P((ROWS_AXIS, THETA_AXIS), None, None, None),
            P(), P(), P(), P(), P(),
        ),
        out_specs=P((ROWS_AXIS, THETA_AXIS), None, None, None),
    )(planes_dev, x, seq_of, first_seq, bounds, round_idx)


@functools.partial(
    jax.jit,
    static_argnames=(
        "mesh", "g", "k", "tile", "c_max", "n_strips", "n_digits",
        "digit_base", "spd",
    ),
)
def packed_ring_rowsharded(
    blocks_dev: jnp.ndarray,  # [n_dev, n_digits, blk, Np] int32, dev-sharded
    x_dev: jnp.ndarray,  # [n_dev, spd*tile, gA] bf16, dev-sharded strips
    seq_dev: jnp.ndarray,  # [n_dev, spd*tile] int32, dev-sharded
    first_seq: jnp.ndarray,  # [n_strips_pad] int32, replicated (tiny)
    bounds: jnp.ndarray,  # [n_strips_pad, c_max] int32, replicated (tiny)
    row0_dev: jnp.ndarray,  # [n_dev] int32, dev-sharded
    *,
    mesh: Mesh,
    spd: int,
    g: int,
    k: int,
    tile: int,
    c_max: int,
    n_strips: int,
    n_digits: int,
    digit_base: int,
):
    """Operand-sharded packed sweep (one dispatch for the WHOLE kernel):
    the window table is strip-sharded to match each device's plane row
    block, and shards travel the ring once — at step s device d holds
    the shard of device (d + s) mod D, computes ALL its own strips
    against ALL visiting strips (ops/pairs_packed.py:
    strip_block_shard_update), then ppermutes the shard to its lower
    neighbor. Total operand traffic per device = (D-1)/D of one
    broadcast; persistent per-device memory = O(N^2/D) block +
    O(rows/D) shard — nothing is replicated but the tiny strip
    metadata. Integer-identical to the replicated sweeps (int adds
    commute)."""
    from ..ops import pairs_packed

    n_dev = mesh.devices.size
    axes = (ROWS_AXIS, THETA_AXIS)
    perm = [(i, (i - 1) % n_dev) for i in range(n_dev)]

    def local(blocks_l, x_l, seq_l, fs_r, bd_r, r0s):
        d = (
            jax.lax.axis_index(ROWS_AXIS) * mesh.shape[THETA_AXIS]
            + jax.lax.axis_index(THETA_AXIS)
        )
        a_base = d * spd
        x_own = x_l[0]
        block = blocks_l[0]

        def ring_step(s, carry):
            block, x_vis = carry
            b_base = ((d + s) % n_dev) * spd
            block = pairs_packed.strip_block_shard_update(
                block, x_own, seq_l[0], x_vis, fs_r, bd_r,
                a_base, b_base, r0s[0],
                spd=spd, g=g, k=k, tile=tile, c_max=c_max,
                n_strips=n_strips, n_digits=n_digits,
                digit_base=digit_base,
            )
            x_vis = jax.lax.ppermute(x_vis, axes, perm)
            return block, x_vis

        block, _ = jax.lax.fori_loop(0, n_dev, ring_step, (block, x_own))
        return block[None]

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P((ROWS_AXIS, THETA_AXIS), None, None, None),
            P((ROWS_AXIS, THETA_AXIS), None, None),
            P((ROWS_AXIS, THETA_AXIS), None),
            P(), P(),
            P((ROWS_AXIS, THETA_AXIS)),
        ),
        out_specs=P((ROWS_AXIS, THETA_AXIS), None, None, None),
    )(blocks_dev, x_dev, seq_dev, first_seq, bounds, row0_dev)


