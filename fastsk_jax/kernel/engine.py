"""Driver for exact and Monte-Carlo gapped k-mer kernel computation.

The driver owns the theta work queue (the ``C(g, m)`` position subsets), cuts
it into device-sized batches, and accumulates exact integer count matrices on
device. It replaces the reference's pthread pool + banded-mutex merge
(fastsk_kernel.cpp:53-93, 285-315) with functional accumulation: no locks, and
— unlike the time-seeded reference — fully deterministic in approx mode.

Integer-exactness policy: per-batch partial kernels are exact f32 integers
(bounded by theta_batch * P^2 < 2^24), accumulated in an int32 device buffer,
and spilled to a host int64 accumulator before the int32 range could
overflow. The final unnormalized kernel is therefore the exact same integer
matrix the reference computes.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import gkm
from ..ops.combinatorics import enumerate_combinations
from ..ops.encode import EncodedSeqs
from ..utils.observe import Progress, profiler_trace, timed
from .config import KernelConfig


@dataclass
class ApproxResult:
    counts: np.ndarray  # int64 [N, N] summed sampled partial kernels
    iters: int  # number of thetas consumed
    stdevs: List[float]  # per-iteration convergence sd trace
    converged: bool


def _next_multiple(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class DenseGkmEngine:
    """Dense-bucket engine: valid when ``dict_size ** k`` is materializable.

    Covers every DNA workload and the small-k protein/NLP configs; the
    sorted/rank path (``fastsk_jax.kernel.sorted_engine``) covers the rest.
    """

    def __init__(self, enc: EncodedSeqs, g: int, m: int, config: Optional[KernelConfig] = None):
        self.enc = enc
        self.g = g
        self.m = m
        self.k = g - m
        self.config = config or KernelConfig()
        self.dict_size = enc.dict_size
        self.base = enc.hash_base
        self.code_min = enc.code_min

        self.b_total = self.base**self.k
        if self.b_total > self.config.b_max_dense:
            raise ValueError(
                f"bucket space base**k = {self.b_total} exceeds dense "
                f"limit {self.config.b_max_dense}; use the sorted path"
            )
        self.k1, self.k2 = gkm.split_k(self.k)
        self.b1 = self.base**self.k1
        self.b2 = self.base**self.k2

        self.n = enc.n
        self.p = enc.max_len - g + 1
        self.p_max = int(enc.num_windows(g).max())
        # counts fit bf16 exactly iff every count <= 256
        self.count_dtype = jnp.bfloat16 if self.p_max <= 256 else jnp.float32
        self.matmul_dtype = self.count_dtype

        cfg = self.config
        self.progress = Progress(quiet=cfg.quiet)
        self.theta_batch = cfg.theta_batch or self._auto_theta_batch()
        self.row_chunk = cfg.row_chunk or self._auto_row_chunk()

        self.mesh = cfg.mesh
        if self.mesh is not None:
            from ..parallel import sharding as shd

            self._ids, self._lengths, self.n_padded = shd.shard_rows(
                self.mesh, enc.ids, enc.lengths
            )
            self._rows_sharding = jax.sharding.NamedSharding(
                self.mesh, jax.sharding.PartitionSpec(shd.ROWS_AXIS, None)
            )
        else:
            dev = cfg.device
            self._ids = jax.device_put(jnp.asarray(enc.ids), dev)
            self._lengths = jax.device_put(jnp.asarray(enc.lengths), dev)
            self.n_padded = self.n

        # Batches must keep sum_t Ks_t < 2^24 for exact f32 accumulation;
        # beyond 4095 windows/sequence the count-digit-split path takes over
        # (per-theta int32 grams, no batch bound).
        self.count_split = self.p_max > 4095
        if not self.count_split:
            f32_exact_cap = max(1, (1 << 24) // max(self.p_max**2, 1))
            self.theta_batch = max(1, min(self.theta_batch, f32_exact_cap))
        # Spill the int32 device accumulator to a host int64 buffer before
        # int32 could overflow: any run of thetas accumulated on device
        # must keep sum_t Ks_t <= thetas * p_max^2 < 2^31 (with margin 2).
        int32_safe = max(1, ((1 << 31) - 1) // max(self.p_max**2, 1) // 2)
        if self.count_split:
            # count_split sums per-theta int32 grams inside a single batch,
            # so the batch itself must respect the int32 bound
            self.theta_batch = max(1, min(self.theta_batch, int32_safe))
        self.spill_every_thetas = max(self.theta_batch, int32_safe)

    # ---------------------------------------------------------- sizing

    def _auto_theta_batch(self) -> int:
        cfg = self.config
        bytes_per_theta = self.n * self.b_total * np.dtype(np.float32).itemsize
        t = max(1, cfg.counts_budget_bytes // max(bytes_per_theta, 1))
        return int(min(t, cfg.max_theta_batch))

    def _auto_row_chunk(self) -> int:
        cfg = self.config
        itemsize = 2 if self.count_dtype == jnp.bfloat16 else 4
        per_row = self.p * (self.b1 + self.b2) * itemsize * max(self.theta_batch, 1)
        rows = max(8, cfg.onehot_budget_bytes // max(per_row, 1))
        return int(min(_next_multiple(min(rows, self.n), 8), _next_multiple(self.n, 8)))

    def _static_kwargs(self) -> dict:
        return dict(
            g=self.g,
            base=self.base,
            code_min=self.code_min,
            k1=self.k1,
            b1=self.b1,
            b2=self.b2,
            count_dtype=self.count_dtype,
            row_chunk=self.row_chunk,
            matmul_dtype=self.matmul_dtype,
            count_split=self.count_split,
        )

    # ---------------------------------------------------------- exact

    def _checkpoint(self, tag: str):
        """Optional KernelCheckpoint for this problem (None if disabled)."""
        if self.config.checkpoint_path is None:
            return None
        from ..utils.checkpoint import KernelCheckpoint, problem_digest

        digest = problem_digest(
            np.asarray(self.enc.ids), np.asarray(self.enc.lengths),
            self.g, self.m, extra=tag,
        )
        return KernelCheckpoint(self.config.checkpoint_path, digest)

    def _sum_thetas(self, thetas: np.ndarray) -> np.ndarray:
        """Exact integer sum of K_theta over an explicit theta list."""
        if self.mesh is not None:
            return self._sum_thetas_sharded(thetas)
        n = self.n
        host_acc = np.zeros((n, n), dtype=np.int64)
        k_acc = jnp.zeros((n, n), dtype=jnp.int32)
        if self.config.device is not None:
            k_acc = jax.device_put(k_acc, self.config.device)
        kwargs = self._static_kwargs()

        # the digest must pin the exact theta stream (content AND order):
        # approx runs with different seeds, or an exact run of the same
        # length, must never resume from each other's checkpoints
        import hashlib

        theta_tag = hashlib.sha256(
            np.ascontiguousarray(thetas, dtype=np.int64).tobytes()
        ).hexdigest()[:16]
        ckpt = self._checkpoint(f"sum:{len(thetas)}:{theta_tag}")
        since_ckpt = 0
        since_spill = 0
        i = 0
        total = len(thetas)
        if ckpt is not None and (saved := ckpt.load()) is not None:
            host_acc = saved["host_acc"].copy()
            i = int(saved["next_theta"])
        while i < total:
            t = min(self.theta_batch, total - i)
            batch = jnp.asarray(thetas[i : i + t], dtype=jnp.int32)
            k_acc = gkm.exact_batch_update(
                k_acc, self._ids, self._lengths, batch, **kwargs
            )
            i += t
            since_spill += t
            since_ckpt += t
            if since_spill >= self.spill_every_thetas:
                host_acc += np.asarray(k_acc, dtype=np.int64)
                k_acc = jnp.zeros_like(k_acc)
                since_spill = 0
            if ckpt is not None and since_ckpt >= self.config.checkpoint_every:
                host_acc += np.asarray(k_acc, dtype=np.int64)
                k_acc = jnp.zeros_like(k_acc)
                since_spill = 0
                since_ckpt = 0
                ckpt.save(host_acc=host_acc, next_theta=np.int64(i))
        host_acc += np.asarray(k_acc, dtype=np.int64)
        return host_acc

    def _sum_thetas_device(self, thetas: np.ndarray):
        """Exact integer sum of K_theta, kept resident on device.

        Same batching/spill cadence as ``_sum_thetas``, but spills carry
        completed 2**30-units into a second on-device int32 accumulator
        (kernel/device_counts.py) instead of pulling to a host int64 —
        exact below 2**61 total counts, with no O(N^2) transfer on the
        happy path. Checkpointing is supported: the opt-in snapshot every
        ``checkpoint_every`` thetas pulls the lo/hi planes (resumability
        inherently costs host persistence), but the RESULT stays on
        device.
        """
        import hashlib

        from .device_counts import DeviceCounts, _carry_spill

        if self.mesh is not None:
            raise ValueError("device-resident accumulation is single-device")
        n = self.n
        lo = jnp.zeros((n, n), dtype=jnp.int32)
        hi = jnp.zeros((n, n), dtype=jnp.int32)
        if self.config.device is not None:
            lo = jax.device_put(lo, self.config.device)
            hi = jax.device_put(hi, self.config.device)
        kwargs = self._static_kwargs()
        theta_tag = hashlib.sha256(
            np.ascontiguousarray(thetas, dtype=np.int64).tobytes()
        ).hexdigest()[:16]
        ckpt = self._checkpoint(f"sum_dev:{len(thetas)}:{theta_tag}")
        spilled = False
        since_spill = 0
        since_ckpt = 0
        i = 0
        total = len(thetas)
        if ckpt is not None and (saved := ckpt.load()) is not None:
            lo = jnp.asarray(saved["lo"])
            hi = jnp.asarray(saved["hi"])
            spilled = bool(saved["spilled"])
            i = int(saved["next_theta"])
            if self.config.device is not None:
                lo = jax.device_put(lo, self.config.device)
                hi = jax.device_put(hi, self.config.device)
        while i < total:
            t = min(self.theta_batch, total - i)
            batch = jnp.asarray(thetas[i : i + t], dtype=jnp.int32)
            lo = gkm.exact_batch_update(
                lo, self._ids, self._lengths, batch, **kwargs
            )
            i += t
            since_spill += t
            since_ckpt += t
            if since_spill >= self.spill_every_thetas and i < total:
                lo, hi = _carry_spill(lo, hi)
                spilled = True
                since_spill = 0
            if ckpt is not None and since_ckpt >= self.config.checkpoint_every:
                # carry first so the saved lo honors the spill invariant
                lo, hi = _carry_spill(lo, hi)
                spilled = True
                since_spill = 0
                since_ckpt = 0
                ckpt.save(
                    lo=np.asarray(lo, np.int32),
                    hi=np.asarray(hi, np.int32),
                    spilled=np.bool_(True),
                    next_theta=np.int64(i),
                )
        return DeviceCounts(lo, hi if spilled else None)

    def _sharded_batch_sz(self, n_theta: int) -> int:
        """Per-step theta count under a mesh, clamped to the int32 headroom.

        One sharded step psums ``per_dev * n_theta`` thetas onto every row
        block at once, so the *batch itself* must respect the spill bound —
        the pre-add spill can only protect accumulated history, never the
        incoming batch. With so many theta-axis devices that even one theta
        per device exceeds the margin-2 headroom, no spill cadence helps:
        refuse loudly rather than overflow silently.
        """
        per_dev = min(
            max(self.theta_batch, 1),
            max(1, self.spill_every_thetas // n_theta),
        )
        batch_sz = per_dev * n_theta
        if batch_sz > 2 * self.spill_every_thetas:
            raise ValueError(
                f"theta mesh axis too wide for int32 accumulation: one "
                f"theta per device lands {n_theta} thetas x p_max^2="
                f"{self.p_max ** 2} counts per step, above the int32 "
                f"headroom of {2 * self.spill_every_thetas} thetas; "
                f"shrink the theta axis or the windows-per-sequence bound"
            )
        return batch_sz

    def _sum_thetas_sharded_device(self, thetas: np.ndarray):
        """Mesh device-resident exact sum: lo/hi stay ROWS-SHARDED
        (kernel row blocks per device, the dense engine's layout) and the
        final ``DeviceCounts`` holds the sharded planes — downstream
        normalization/Gram run under jit, where GSPMD inserts the
        collectives; nothing is pulled to the host."""
        from ..parallel import sharding as shd
        from .device_counts import DeviceCounts, _carry_spill

        mesh = self.mesh
        n_theta = mesh.shape[shd.THETA_AXIS]
        np_pad = self.n_padded
        batch_sz = self._sharded_batch_sz(n_theta)
        kwargs = self._static_kwargs()
        lo = jnp.zeros(
            (np_pad, np_pad), dtype=jnp.int32, device=self._rows_sharding
        )
        hi = jnp.zeros_like(lo)
        spilled = False
        since_spill = 0
        i = 0
        total = len(thetas)
        while i < total:
            t = min(batch_sz, total - i)
            # carry BEFORE the add when this batch would exceed the int32
            # headroom: the psum lands batch_sz = theta_batch * n_theta
            # thetas on every row block at once, so the single-device
            # margin (sized for one theta_batch of overshoot) does not
            # cover a post-add check here
            if since_spill + t > self.spill_every_thetas:
                lo, hi = _carry_spill(lo, hi)
                spilled = True
                since_spill = 0
            batch, mask = shd.pad_theta_batch(
                np.asarray(thetas[i : i + t], dtype=np.int32), n_theta
            )
            lo = shd.exact_batch_update_sharded(
                lo,
                self._ids,
                self._lengths,
                jnp.asarray(batch),
                jnp.asarray(mask),
                mesh=mesh,
                **kwargs,
            )
            i += t
            since_spill += t
        # padded rows/cols carry zero counts; slice the live block (the
        # slice of a sharded array stays sharded)
        lo = lo[: self.n, : self.n]
        hi = hi[: self.n, : self.n] if spilled else None
        return DeviceCounts(lo, hi)

    def exact_device(self):
        """Exact unnormalized kernel as device-resident ``DeviceCounts``
        (single device, or rows-sharded under a mesh)."""
        thetas = enumerate_combinations(self.g, self.k)
        self.progress.log(
            f"dense exact (device-resident): {len(thetas)} passes over "
            f"{self.n} sequences"
        )
        with profiler_trace(self.config.profile_dir):
            if self.mesh is not None:
                return self._sum_thetas_sharded_device(thetas)
            return self._sum_thetas_device(thetas)

    def _sum_thetas_sharded(self, thetas: np.ndarray) -> np.ndarray:
        """Mesh-parallel exact sum: rows x theta sharding, psum merge.

        Checkpointing mirrors the single-device path: the host int64
        accumulator plus the work-queue cursor persist under a digest that
        pins the exact theta stream, so a multi-chip run interrupted
        mid-queue resumes without recomputation.
        """
        import hashlib

        from ..parallel import sharding as shd

        mesh = self.mesh
        n_theta = mesh.shape[shd.THETA_AXIS]
        np_pad = self.n_padded
        # per-device theta quota keeps the (rows x theta) step the same size
        # as a single-device theta batch, clamped to the int32 headroom
        batch_sz = self._sharded_batch_sz(n_theta)
        kwargs = self._static_kwargs()

        theta_tag = hashlib.sha256(
            np.ascontiguousarray(thetas, dtype=np.int64).tobytes()
        ).hexdigest()[:16]
        ckpt = self._checkpoint(f"sum_sharded:{len(thetas)}:{theta_tag}")
        since_ckpt = 0

        host_acc = np.zeros((np_pad, np_pad), dtype=np.int64)
        k_acc = jnp.zeros((np_pad, np_pad), dtype=jnp.int32, device=self._rows_sharding)
        since_spill = 0
        i = 0
        total = len(thetas)
        if ckpt is not None and (saved := ckpt.load()) is not None:
            host_acc = saved["host_acc"].copy()
            i = int(saved["next_theta"])
        while i < total:
            t = min(batch_sz, total - i)
            # spill BEFORE the add: batch_sz = theta_batch * n_theta
            # thetas land on every row block per step, more than the
            # single-device overshoot margin covers (see the device
            # variant below)
            if since_spill + t > self.spill_every_thetas:
                host_acc += shd.host_gather(k_acc)
                k_acc = jnp.zeros(
                    (np_pad, np_pad), dtype=jnp.int32, device=self._rows_sharding
                )
                since_spill = 0
            batch, mask = shd.pad_theta_batch(
                np.asarray(thetas[i : i + t], dtype=np.int32), n_theta
            )
            k_acc = shd.exact_batch_update_sharded(
                k_acc,
                self._ids,
                self._lengths,
                jnp.asarray(batch),
                jnp.asarray(mask),
                mesh=mesh,
                **kwargs,
            )
            i += t
            since_spill += t
            since_ckpt += t
            if ckpt is not None and since_ckpt >= self.config.checkpoint_every:
                host_acc += shd.host_gather(k_acc)
                k_acc = jnp.zeros(
                    (np_pad, np_pad), dtype=jnp.int32, device=self._rows_sharding
                )
                since_spill = 0
                since_ckpt = 0
                ckpt.save(host_acc=host_acc, next_theta=np.int64(i))
        host_acc += shd.host_gather(k_acc)
        return host_acc[: self.n, : self.n]

    def exact(self) -> np.ndarray:
        """Exact unnormalized kernel (int64 [N, N]) over all C(g, m) subsets."""
        thetas = enumerate_combinations(self.g, self.k)
        self.progress.log(
            f"dense exact: {len(thetas)} passes over {self.n} sequences "
            f"(B={self.b_total}, batch={self.theta_batch})"
        )
        pairs_total = self.n * (self.n + 1) / 2 * len(thetas)
        with profiler_trace(self.config.profile_dir), timed(
            self.progress, "dense exact kernel", pairs_total, "pairs"
        ):
            return self._sum_thetas(thetas)

    # ---------------------------------------------------------- approx

    def approx(
        self,
        conv_delta: float = 0.025,
        max_iters: int = -1,
        skip_variance: bool = False,
        seed: int = 0,
        device_out: bool = False,
    ) -> ApproxResult:
        """Monte-Carlo sampling of position subsets without replacement.

        Matches the reference single-thread semantics
        (fastsk_kernel.cpp:188-262): iterate a shuffled enumeration of all
        subsets; with variance tracking, stop when the 95% CI half-width
        drops below ``conv_delta``; honor ``max_iters``; with
        ``skip_variance`` just accumulate raw counts for ``max_iters``
        samples. Deterministic given ``seed`` (the reference seeds with
        time(0) — reproducibility here is intentional).

        ``device_out`` returns the counts as device-resident
        ``DeviceCounts`` instead of pulling the O(N^2) matrix to the host
        (single-device, non-checkpointed runs only).
        """
        if device_out and (
            self.mesh is not None or self.config.checkpoint_path is not None
        ):
            raise ValueError(
                "device_out requires a single device without checkpointing"
            )
        rng = np.random.default_rng(seed)
        all_thetas = enumerate_combinations(self.g, self.k)
        order = rng.permutation(len(all_thetas))
        stream = all_thetas[order]
        total = len(stream)

        if skip_variance:
            limit = total if max_iters == -1 else min(max_iters, total)
            if device_out:
                counts = self._sum_thetas_device(stream[:limit])
            else:
                counts = self._sum_thetas(stream[:limit])
            return ApproxResult(
                counts=counts, iters=limit, stdevs=[], converged=False
            )

        n = self.n
        kwargs = self._static_kwargs()
        kwargs_approx = dict(
            kwargs,
            n_train=self.enc.n_train,
            check_variance=True,
        )
        if self.mesh is not None:
            from ..parallel import sharding as shd

            np_pad = self.n_padded
            state = (
                jnp.zeros((np_pad, np_pad), jnp.int32, device=self._rows_sharding),
                jnp.zeros((np_pad, np_pad), jnp.float32, device=self._rows_sharding),
                jnp.int32(0),
                jnp.bool_(False),
            )
            update = functools.partial(
                shd.approx_batch_update_sharded, mesh=self.mesh
            )
        else:
            dev = self.config.device
            state = (
                jax.device_put(jnp.zeros((n, n), jnp.int32), dev),
                jax.device_put(jnp.zeros((n, n), jnp.float32), dev),
                jnp.int32(0),
                jnp.bool_(False),
            )
            update = gkm.approx_batch_update
        stdevs: List[float] = []
        i = 0
        done = False
        ckpt = self._checkpoint(f"approx:{seed}:{conv_delta}:{max_iters}")
        since_ckpt = 0
        if ckpt is not None and (saved := ckpt.load()) is not None:
            state = (
                jnp.asarray(saved["k_sum"]),
                jnp.asarray(saved["mean"]),
                jnp.int32(saved["it"]),
                jnp.bool_(saved["done"]),
            )
            i = int(saved["next_theta"])
            stdevs = [float(s) for s in saved["stdevs"]]
            done = bool(saved["done"])
        while i < total and not done:
            t = min(self.theta_batch, total - i)
            batch = jnp.asarray(stream[i : i + t], dtype=jnp.int32)
            state, sds = update(
                state,
                self._ids,
                self._lengths,
                batch,
                conv_delta=conv_delta,
                max_iters=max_iters,
                **kwargs_approx,
            )
            i += t
            since_ckpt += t
            sds_np = np.asarray(sds)
            stdevs.extend(float(s) for s in sds_np if not math.isnan(s))
            done = bool(state[3])
            if ckpt is not None and since_ckpt >= self.config.checkpoint_every:
                since_ckpt = 0
                ckpt.save(
                    k_sum=np.asarray(state[0]),
                    mean=np.asarray(state[1]),
                    it=np.int32(state[2]),
                    done=np.bool_(state[3]),
                    next_theta=np.int64(i),
                    stdevs=np.asarray(stdevs, dtype=np.float64),
                )

        k_sum, _, it, done_flag = state
        iters = int(it)
        self.progress.log(
            f"approx: {'converged' if bool(done_flag) else 'stopped'} after "
            f"{iters} iterations"
        )
        if device_out:
            from .device_counts import DeviceCounts

            # the variance-tracked loop accumulates k_sum in int32 on
            # device with no spill (same bound as the host path), so lo
            # alone is exact here
            counts = DeviceCounts(k_sum)
        elif self.mesh is not None:
            from ..parallel import sharding as shd

            counts = shd.host_gather(k_sum)[: self.n, : self.n]
        else:
            counts = np.asarray(k_sum, dtype=np.int64)[: self.n, : self.n]
        return ApproxResult(
            counts=counts,
            iters=iters,
            stdevs=stdevs,
            converged=bool(done_flag) and (max_iters == -1 or iters < max_iters),
        )


def cosine_normalize(counts: np.ndarray) -> np.ndarray:
    """float64 cosine normalization, bit-matching the reference's double math
    (fastsk_kernel.cpp:96-103)."""
    k = counts.astype(np.float64)
    diag = np.diag(k).copy()
    # sqrt of the product (not product of sqrts): the reference computes
    # sqrt(K[i][i] * K[j][j]) per entry, and the two differ in the last ulp.
    return k / np.sqrt(np.multiply.outer(diag, diag))
