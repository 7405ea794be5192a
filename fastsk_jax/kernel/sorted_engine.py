"""Sorted/rank engine for huge k-mer spaces (large-alphabet protein/text).

When ``base**k`` is too large to histogram densely (DenseGkmEngine) and the
all-pairs engine's int32 bound is exceeded, each counting pass runs the
sort/rank pipeline of ops/sorted_theta.py — the device equivalent of the
reference's LSD counting sort + run walk (shared.cpp:156-333), with the
per-run outer products becoming slab-blocked count-matmuls.

Same driver semantics as DenseGkmEngine: ``exact()`` enumerates all
C(g, m) subsets with device int32 accumulation and host int64 spill;
``approx()`` samples a seeded shuffled stream with the reference's Welford
convergence rule (fastsk_kernel.cpp:108-143, 243-262), one theta at a time
(the sort pipeline is the per-iteration unit of work).
"""

from __future__ import annotations

import functools
import math
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.combinatorics import enumerate_combinations
from ..ops.encode import EncodedSeqs
from ..ops.sorted_theta import (
    hash_plan,
    sorted_theta_pass,
    sorted_theta_pass_batch,
    sorted_theta_pass_batch_sum,
)
from .config import KernelConfig
from .engine import ApproxResult


@jax.jit
def _acc_max(k_acc: jnp.ndarray) -> jnp.ndarray:
    """Max accumulator entry (counts are non-negative)."""
    return jnp.max(k_acc)


@functools.partial(jax.jit, static_argnames=("n_train",))
def _welford_step(state, ks_int, *, n_train, conv_delta, max_iters):
    """One Monte-Carlo iteration of the reference convergence rule."""
    k_sum, mean, it, done = state
    ks = ks_int.astype(jnp.float32)
    it_new = it + 1
    new_sum = k_sum + ks_int

    delta = ks - mean
    new_mean = mean + delta / it_new.astype(jnp.float32)
    delta2 = ks - new_mean
    prod = (delta * delta2)[:n_train, :n_train]
    tri_count = n_train * (n_train + 1) / 2.0
    tri_sum = (jnp.sum(prod) + jnp.sum(jnp.diagonal(prod))) / 2.0
    avg_var = tri_sum / tri_count
    avg_var = jnp.where(it_new == 1, 9999999.0, avg_var / jnp.maximum(it_new - 1, 1))
    sd = jnp.sqrt(avg_var / it_new)
    converged = conv_delta / sd > 1.96
    hit_max = (max_iters != -1) & (it_new >= max_iters)
    new_done = done | converged | hit_max

    k_sum = jnp.where(done, k_sum, new_sum)
    mean = jnp.where(done, mean, new_mean)
    it = jnp.where(done, it, it_new)
    sd = jnp.where(done, jnp.float32(jnp.nan), sd)
    return (k_sum, mean, it, new_done), sd


class SortedGkmEngine:
    def __init__(
        self,
        enc: EncodedSeqs,
        g: int,
        m: int,
        config: Optional[KernelConfig] = None,
    ):
        self.enc = enc
        self.g = g
        self.m = m
        self.k = g - m
        self.config = config or KernelConfig()
        self.base = enc.hash_base
        self.code_min = enc.code_min
        self.n = enc.n
        self.p = enc.max_len - g + 1
        self.p_max = int(enc.num_windows(g).max())
        if self.p_max >= 16384:
            raise ValueError(
                f"sorted engine requires < 16384 windows per sequence "
                f"(got {self.p_max}): the base-128 int8 digit split needs "
                f"window counts >> 7 to fit in signed int8"
            )
        self.dpw, self.n_words = hash_plan(self.base, self.k)
        self.slab = self.config.sorted_slab

        # flattened window table (the reference's feature table,
        # shared.cpp:17-91), host-compacted to the valid windows only —
        # ragged sequence lengths would otherwise inflate every device sort
        # by the padding factor (4-5x on the NLP sets)
        ids = np.asarray(enc.ids)
        n, length = ids.shape
        windows = np.lib.stride_tricks.sliding_window_view(ids, self.g, axis=1)
        windows = windows.reshape(n * self.p, self.g).astype(np.int32)
        pos = np.arange(self.p, dtype=np.int32)
        valid = (pos[None, :] <= (enc.lengths[:, None] - self.g)).reshape(-1)
        seq_of = np.repeat(np.arange(n, dtype=np.int32), self.p)
        keep = np.flatnonzero(valid)
        nfeat_pad = ((len(keep) + 127) // 128) * 128
        pad = nfeat_pad - len(keep)
        windows = np.concatenate(
            [windows[keep], np.zeros((pad, self.g), np.int32)]
        )
        valid = np.concatenate(
            [np.ones(len(keep), bool), np.zeros(pad, bool)]
        )
        seq_of = np.concatenate([seq_of[keep], np.zeros(pad, np.int32)])

        dev = self.config.device
        self._windows = jax.device_put(jnp.asarray(windows), dev)
        self._valid = jax.device_put(jnp.asarray(valid), dev)
        self._seq_of = jax.device_put(jnp.asarray(seq_of), dev)

        # per-pass kernel entries are bounded by p_i * p_j <= p_max^2
        self._acc_limit = (1 << 31) - 1
        self._per_theta_bound = max(self.p_max**2, 1)
        self.spill_every = max(1, self._acc_limit // self._per_theta_bound // 2)
        # Long documents (p_max in the thousands) make the worst-case
        # bound spill every few thetas, but real counts sit far below
        # p_max^2: switch to an adaptive schedule that checks the actual
        # device-side accumulator max (one scalar pull per batch, cheap
        # next to the batch's sort) and spills only when the NEXT batch
        # could overflow int32.
        self._adaptive_spill = self.spill_every < 32
        self.mesh = self.config.mesh
        # thetas per batched pass: per-pass streaming on one device (the
        # pass is dominated by its slab count-matmuls, so batching the
        # sorts is not expected to pay; not measured on a GPU); the
        # sharded path keeps batches as its per-device work unit.
        if self.config.theta_batch:
            tb = self.config.theta_batch
        elif self.mesh is None:
            tb = 1
        else:
            tb = max(1, min(8, (256 << 20) // max(self.n * self.n * 4, 1)))
        batch_cap = (
            self._acc_limit // self._per_theta_bound
            if self._adaptive_spill
            else self.spill_every
        )
        self.theta_batch = max(1, min(tb, batch_cap))
        # upper-block-triangle count-matmuls (ops/sorted_theta.py:_sym_gram)
        # for the streams that only need the symmetric sum; welford passes
        # keep the full matrix (its variance statistics read both halves)
        b = min(8, self.n // 768)
        self._tri_blocks = b if b >= 2 else 0

    def _static_kwargs(self, tri: bool = False) -> dict:
        return dict(
            g=self.g,
            base=self.base,
            code_min=self.code_min,
            n=self.n,
            p=self.p,
            slab=self.slab,
            dpw=self.dpw,
            n_words=self.n_words,
            # three-way count-op mode (ops/sorted_theta.py:_count_ops):
            # bf16 inputs are exact to 255; one f32 matmul at HIGHEST
            # precision is exact while per-pass entries stay below 2^24
            # (p_max <= 4095) and avoids the int8 digit trio's [n, n]
            # recombine planes; the base-128 int8 split covers the rest
            count_split=(
                True if self.p_max > 4095
                else ("f32x3" if self.p_max > 255 else False)
            ),
            tri_blocks=self._tri_blocks if tri else 0,
            layout=self.config.sorted_layout,
            run_width=self.config.sorted_run_width,
        )

    def _pass(self, theta: np.ndarray, tri: bool = False) -> jnp.ndarray:
        return sorted_theta_pass(
            self._windows,
            self._valid,
            self._seq_of,
            jnp.asarray(theta, dtype=jnp.int32),
            **self._static_kwargs(tri),
        )

    def _pass_batch(self, thetas: np.ndarray) -> jnp.ndarray:
        """[T, n, n] int32, each slice bit-identical to _pass(theta)."""
        return sorted_theta_pass_batch(
            self._windows,
            self._valid,
            self._seq_of,
            jnp.asarray(thetas, dtype=jnp.int32),
            **self._static_kwargs(),
        )

    def _pass_batch_sum(self, acc: jnp.ndarray, thetas: np.ndarray) -> jnp.ndarray:
        """acc + sum of the batch's passes, fused (no [T, n, n] output)."""
        return sorted_theta_pass_batch_sum(
            acc,
            self._windows,
            self._valid,
            self._seq_of,
            jnp.asarray(thetas, dtype=jnp.int32),
            **self._static_kwargs(tri=True),
        )

    # ------------------------------------------------------------- exact

    def _must_spill(self, k_acc: jnp.ndarray, next_t: int) -> bool:
        """True when adding ``next_t`` worst-case thetas could overflow.

        Uses the actual accumulator max (counts are non-negative), so long
        documents whose worst-case bound p_max^2 is pessimistic spill only
        when genuinely near the int32 ceiling — normally never."""
        cur = int(jax.device_get(_acc_max(k_acc)))
        return cur > self._acc_limit - next_t * self._per_theta_bound

    def _sum_stream(self, thetas: np.ndarray) -> np.ndarray:
        """Exact integer sum over a theta stream, batched, int64 on host."""
        if self.mesh is not None:
            if self.config.mesh_state == "sharded":
                return self._sum_stream_rowsharded(thetas)
            return self._sum_stream_sharded(thetas)
        host = np.zeros((self.n, self.n), dtype=np.int64)
        k_acc = jnp.zeros((self.n, self.n), jnp.int32)
        since = 0
        i = 0
        total = len(thetas)
        while i < total:
            t = min(self.theta_batch, total - i)
            if not self._adaptive_spill:
                t = min(t, self.spill_every - since)
            if t == self.theta_batch and t > 1:
                k_acc = self._pass_batch_sum(k_acc, thetas[i : i + t])
            else:
                k_acc = k_acc + self._pass(thetas[i], tri=True)
                t = 1
            i += t
            since += t
            if self._adaptive_spill:
                nxt = min(self.theta_batch, total - i)
                spill = i < total and self._must_spill(k_acc, nxt)
            else:
                spill = since >= self.spill_every
            if spill:
                host += np.asarray(k_acc, dtype=np.int64)
                k_acc = jnp.zeros_like(k_acc)
                since = 0
        host += np.asarray(k_acc, dtype=np.int64)
        # the tri-blocked grams left strictly-lower blocks zero; the upper
        # triangle is complete and the counts are symmetric — mirror (a
        # no-op rearrangement when tri_blocks was 0)
        return np.triu(host) + np.triu(host, 1).T

    def _sum_stream_device(self, thetas: np.ndarray):
        """Exact integer sum over a theta stream, device-resident
        (kernel/device_counts.py): spills carry completed 2**30-units
        into an on-device ``hi`` plane instead of pulling to host int64.
        The existing spill margin (spill_every = acc_limit/bound/2, or
        the adaptive device-max check) leaves exactly the < 2**30 lo
        residue a carry spill retains, so the int32 invariant holds."""
        from .device_counts import DeviceCounts, _carry_spill

        if self.mesh is not None:
            raise ValueError("device-resident accumulation is single-device")
        lo = jnp.zeros((self.n, self.n), jnp.int32)
        hi = jnp.zeros((self.n, self.n), jnp.int32)
        spilled = False
        since = 0
        i = 0
        total = len(thetas)
        # a carry spill leaves a < 2^30 residue in lo (the host path
        # zeroes it), so every batch must fit the remaining headroom:
        # residue + t * bound <= acc_limit. The adaptive batch_cap is
        # acc_limit // bound (no margin), so cap t here; always >= 1
        # because the engine admits p_max < 16384 => bound < 2^28.
        t_cap = max(
            1, (self._acc_limit - (1 << 30)) // self._per_theta_bound
        )
        tb = min(self.theta_batch, t_cap)
        while i < total:
            t = min(tb, total - i)
            if not self._adaptive_spill:
                t = min(t, self.spill_every - since)
            if t == tb and t > 1:
                lo = self._pass_batch_sum(lo, thetas[i : i + t])
            else:
                lo = lo + self._pass(thetas[i], tri=True)
                t = 1
            i += t
            since += t
            if self._adaptive_spill:
                nxt = min(self.theta_batch, total - i)
                spill = i < total and self._must_spill(lo, nxt)
            else:
                spill = since >= self.spill_every
            if spill:
                lo, hi = _carry_spill(lo, hi)
                spilled = True
                since = 0
        # mirror the upper block triangle (mirroring lo and hi separately
        # is exact: triu is linear and total = lo + 2^30 hi)
        lo = jnp.triu(lo) + jnp.triu(lo, 1).T
        if spilled:
            hi = jnp.triu(hi) + jnp.triu(hi, 1).T
        return DeviceCounts(lo, hi if spilled else None)

    def exact_device(self):
        """Exact unnormalized kernel as device-resident ``DeviceCounts``."""
        thetas = enumerate_combinations(self.g, self.k)
        return self._sum_stream_device(thetas)

    def _sum_stream_rowsharded(self, thetas: np.ndarray) -> np.ndarray:
        """Rows x theta sharded exact sum with O(N^2 / R) per-device
        state (KernelConfig.mesh_state="sharded", the default): device
        (r, t) accumulates kernel row strip r over theta shard t; theta
        shards merge with one psum per batch
        (parallel/sharding.py:sorted_batch_rowsharded). Integer-identical
        to the single-device stream."""
        from ..parallel import sharding as shd

        mesh = self.mesh
        n_rows_axis = mesh.shape[shd.ROWS_AXIS]
        n_theta_axis = mesh.shape[shd.THETA_AXIS]
        n_rows = -(-self.n // n_rows_axis)
        n_pad = n_rows_axis * n_rows
        rows_sharding = jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec(shd.ROWS_AXIS, None)
        )
        rep = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
        windows = jax.device_put(self._windows, rep)
        valid = jax.device_put(self._valid, rep)
        seq_of = jax.device_put(self._seq_of, rep)
        statics = self._static_kwargs()
        statics.pop("tri_blocks")  # rows strips are always full-width

        host = np.zeros((self.n, self.n), dtype=np.int64)
        k_rows = jnp.zeros((n_pad, self.n), jnp.int32, device=rows_sharding)
        # a chunk lands n_theta_axis * tb thetas on EVERY strip (psum),
        # so the int32 headroom bound applies to the whole chunk
        chunk_cap = max(
            1, (self._acc_limit // self._per_theta_bound) // n_theta_axis
        )
        per_step = n_theta_axis * min(self.theta_batch, chunk_cap)
        total = len(thetas)
        since = 0
        for i in range(0, total, per_step):
            # spill BEFORE the add when the chunk would exceed the int32
            # headroom: the psum lands the whole chunk on every strip, so
            # a post-add check could overshoot by per_step (the
            # single-device path instead caps t to the remaining budget)
            if not self._adaptive_spill and since + per_step > self.spill_every:
                host += shd.host_gather(k_rows)[: self.n]
                k_rows = jnp.zeros(
                    (n_pad, self.n), jnp.int32, device=rows_sharding
                )
                since = 0
            chunk = thetas[i : i + per_step]
            live = np.zeros(per_step, dtype=np.int32)
            live[: len(chunk)] = 1
            if len(chunk) < per_step:
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[:1], per_step - len(chunk), 0)]
                )
            k_rows = shd.sorted_batch_rowsharded(
                k_rows,
                windows,
                valid,
                seq_of,
                jnp.asarray(chunk, dtype=jnp.int32),
                jnp.asarray(live),
                mesh=mesh,
                n_pad=n_pad,
                n_rows=n_rows,
                **statics,
            )
            # after the psum every row strip holds ALL of the chunk's
            # thetas (unlike the replicated path, where each device only
            # accumulates its own shard)
            since += per_step
            if self._adaptive_spill:
                spill = i + per_step < total and self._must_spill(
                    k_rows, per_step
                )
            else:
                spill = False  # handled pre-add above
            if spill:
                host += shd.host_gather(k_rows)[: self.n]
                k_rows = jnp.zeros(
                    (n_pad, self.n), jnp.int32, device=rows_sharding
                )
                since = 0
        host += shd.host_gather(k_rows)[: self.n]
        # strips are full rows (both triangles computed): no mirror needed
        return host

    def _sum_stream_sharded(self, thetas: np.ndarray) -> np.ndarray:
        """Theta-sharded exact sum: each device runs whole batched passes
        into a private replica; the host sums replicas
        (KernelConfig.mesh_state="replicated": lowest wall-clock on small
        meshes, per-device memory does not shrink with device count)."""
        from ..parallel import sharding as shd

        mesh = self.mesh
        n_dev = mesh.devices.size
        dev_sharding = jax.sharding.NamedSharding(
            mesh,
            jax.sharding.PartitionSpec(
                (shd.ROWS_AXIS, shd.THETA_AXIS), None, None
            ),
        )
        host = np.zeros((self.n, self.n), dtype=np.int64)
        k_dev = jnp.zeros(
            (n_dev, self.n, self.n), jnp.int32, device=dev_sharding
        )
        per_step = n_dev * self.theta_batch
        total = len(thetas)
        since = 0
        for i in range(0, total, per_step):
            chunk = thetas[i : i + per_step]
            t_pad = -(-len(chunk) // n_dev) * n_dev
            live = np.zeros(t_pad, dtype=np.int32)
            live[: len(chunk)] = 1
            if t_pad > len(chunk):
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[:1], t_pad - len(chunk), 0)]
                )
            k_dev = shd.sorted_batch_sharded(
                k_dev,
                self._windows,
                self._valid,
                self._seq_of,
                jnp.asarray(chunk.reshape(n_dev, -1, self.k)),
                jnp.asarray(live.reshape(n_dev, -1)),
                mesh=mesh,
                **self._static_kwargs(tri=True),
            )
            since += t_pad // n_dev
            if self._adaptive_spill:
                # global max over all replicas (conservative for each)
                spill = i + per_step < total and self._must_spill(
                    k_dev, self.theta_batch
                )
            else:
                spill = since >= self.spill_every
            if spill:
                host += shd.host_gather(k_dev).sum(axis=0)
                k_dev = jnp.zeros(
                    (n_dev, self.n, self.n), jnp.int32, device=dev_sharding
                )
                since = 0
        host += shd.host_gather(k_dev).sum(axis=0)
        return np.triu(host) + np.triu(host, 1).T

    def exact(self) -> np.ndarray:
        thetas = enumerate_combinations(self.g, self.k)
        return self._sum_stream(thetas)

    # ------------------------------------------------------------- approx

    def approx(
        self,
        conv_delta: float = 0.025,
        max_iters: int = -1,
        skip_variance: bool = False,
        seed: int = 0,
        device_out: bool = False,
    ) -> ApproxResult:
        if device_out and self.mesh is not None:
            raise ValueError("device_out requires a single device")
        rng = np.random.default_rng(seed)
        all_thetas = enumerate_combinations(self.g, self.k)
        stream = all_thetas[rng.permutation(len(all_thetas))]
        total = len(stream)

        if skip_variance:
            limit = total if max_iters == -1 else min(max_iters, total)
            if device_out:
                counts = self._sum_stream_device(stream[:limit])
            else:
                counts = self._sum_stream(stream[:limit])
            return ApproxResult(counts=counts, iters=limit, stdevs=[], converged=False)

        n = self.n
        state = (
            jnp.zeros((n, n), jnp.int32),
            jnp.zeros((n, n), jnp.float32),
            jnp.int32(0),
            jnp.bool_(False),
        )
        sd_buf: List[jnp.ndarray] = []
        # batch the passes (one wide sort) and scan the Welford steps over
        # the batch in stream order — identical statistics, and the done
        # flag syncs to the host once per batch instead of per pass
        # (overshot passes are no-ops under the done mask)
        bsz = max(self.theta_batch, 1)
        host64 = np.zeros((self.n, self.n), dtype=np.int64)
        hi = None  # device carries, allocated on first device_out spill
        spilled = False
        if device_out:
            # carry spills leave a < 2^30 lo residue (the host spill
            # zeroes it): cap the batch so residue + bsz * bound fits
            # int32 (same argument as _sum_stream_device)
            bsz = min(
                bsz,
                max(
                    1,
                    (self._acc_limit - (1 << 30)) // self._per_theta_bound,
                ),
            )
        since = 0
        for start in range(0, total, bsz):
            batch = stream[start : start + bsz]
            if len(batch) == bsz and bsz > 1:
                ks_all = self._pass_batch(batch)
            else:
                ks_all = jnp.stack([self._pass(t) for t in batch])
            for j in range(len(batch)):
                state, sd = _welford_step(
                    state,
                    ks_all[j],
                    n_train=self.enc.n_train,
                    conv_delta=conv_delta,
                    max_iters=max_iters,
                )
                sd_buf.append(sd)
            if bool(state[3]):
                break
            # the int32 count sum spills to host int64 exactly like the
            # exact stream (the Welford mean/var stay f32 on device) —
            # without this a long run on worst-case data could overflow
            # after acc_limit / p_max^2 iterations
            since += len(batch)
            if self._adaptive_spill:
                spill = self._must_spill(state[0], bsz)
            else:
                spill = since >= self.spill_every
            if spill:
                if device_out:
                    from .device_counts import _carry_spill

                    if hi is None:
                        hi = jnp.zeros((n, n), jnp.int32)
                    new_lo, hi = _carry_spill(state[0], hi)
                    state = (new_lo,) + state[1:]
                    spilled = True
                else:
                    host64 += np.asarray(state[0], dtype=np.int64)
                    state = (jnp.zeros_like(state[0]),) + state[1:]
                since = 0
        stdevs = [
            float(s) for s in np.asarray(sd_buf) if not math.isnan(float(s))
        ]
        it_done = int(state[2])
        if device_out:
            from .device_counts import DeviceCounts

            counts = DeviceCounts(state[0], hi if spilled else None)
        else:
            counts = host64 + np.asarray(state[0], dtype=np.int64)
        return ApproxResult(
            counts=counts,
            iters=it_done,
            stdevs=stdevs,
            converged=bool(state[3]),
        )
