"""All-pairs exact-kernel engines (the fast paths for exact mode).

Computes the full exact gapped k-mer kernel in ONE pass over window pairs
via ``K[i,j] = sum_{p,q} C(matches(w_ip, w_jq), k)`` (see ops/pairs.py),
instead of the C(g, m) counting passes of the theta engine — the
position-subset loop the reference threads over (fastsk_kernel.cpp:145-322)
disappears entirely: a dense 0/1 matmul, an exact integer weight chain and
a window->sequence reduction replace 8008 histogram passes at g=16, m=10.

Exactness: bit-identical integer counts to the reference/theta engine.
Guard: every K entry must stay < 2^31 (int32 accumulation); the engine
checks the worst-case bound ``p_pad^2 * C(g, k)`` and refuses shapes where
a single sequence pair could overflow — those fall back to the packed
engine upstream.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import pairs, pairs_pallas
from ..ops.encode import EncodedSeqs
from ..utils.observe import Progress, profiler_trace, timed
from .config import KernelConfig, pairs_route


def _next_multiple(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


@functools.partial(
    jax.jit,
    static_argnames=("g", "alpha", "code_min", "p_pad", "f_pad", "dtype"),
)
def _build_x_jit(ids, lengths, *, g, alpha, code_min, p_pad, f_pad, dtype):
    """Sequence-aligned one-hot windows ``[n_pad * p_pad, f_pad]``
    (columns past ``g * alpha`` are zero and add nothing to D)."""
    x = pairs.onehot_windows(
        ids, lengths, g=g, alpha=alpha, code_min=code_min, p_pad=p_pad,
        dtype=dtype,
    )
    x = x.reshape(-1, g * alpha)
    return jnp.pad(x, ((0, 0), (0, f_pad - g * alpha)))


@functools.partial(
    jax.jit, static_argnames=("g", "k", "p_pad", "sj", "n", "interpret")
)
def _pairs_full_device_jit(x, *, g, k, p_pad, sj, n, interpret=False):
    """The fused kernel's upper triangle mirrored to the full symmetric
    ``[n, n]`` int32 matrix, in one device program."""
    upper = pairs_pallas.pairs_upper(
        x, g=g, k=k, p_pad=p_pad, sj=sj, interpret=interpret
    )
    return (upper + jnp.triu(upper, 1).T)[:n, :n]


class PairsGkmEngine:
    """Exact-mode engine over the all-pairs binomial identity.

    Two routes compute the same integers (``KernelConfig.pairs_backend``,
    resolved by ``config.pairs_route``): the fused Pallas kernel on a GPU
    (ops/pairs_pallas.py) and blocked XLA strips (ops/pairs.py)
    elsewhere. Both leave the full symmetric int32 matrix on device.
    """

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
        self.alpha = enc.hash_base
        self.code_min = enc.code_min
        self.n = enc.n

        if self.config.mesh is not None:
            # Mesh exact runs are the packed engine's job: its ring path
            # shards input AND state (parallel/sharding.py:
            # packed_ring_rowsharded); the auto engine selection routes
            # there when this raises (api.py:_make_exact_engine).
            raise ValueError(
                "the seq-aligned pairs engine is single-device; mesh "
                "exact kernels run on the packed engine (fully "
                "input+state sharded) — use exact_engine='packed' or "
                "'auto'"
            )
        self.p = enc.max_len - g + 1
        self.p_pad = _next_multiple(self.p, 8)
        if self.p_pad**2 * math.comb(g, self.k) >= 2**31:
            raise ValueError(
                "per-pair count bound exceeds int32; use the theta engine "
                f"(p_pad={self.p_pad}, C(g,k)={math.comb(g, self.k)})"
            )
        # the kernel tiles windows in 16-row multiples (ops/pairs_pallas)
        p_pad16 = _next_multiple(self.p, 16)
        self.backend = pairs_route(
            self.config,
            kernel_fits=(
                p_pad16**2 * math.comb(g, self.k) < 2**31
                and pairs_pallas.kernel_fits(g, self.k, p_pad16)
            ),
        )
        if self.backend == "pallas":
            self.p_pad = p_pad16
            # columns per program: 128, or fewer for tiny inputs
            self.sj = min(128, max(16, _next_pow2(self.n)))
            self.n_pad = _next_multiple(self.n, self.sj)
            self.f_pad = max(32, _next_pow2(g * self.alpha))
        else:
            # strip sizing: i strips ~2048 window rows, j strips 8x wider;
            # prefer multiples that keep the D-tile lane dim 128-aligned
            align = 128 // math.gcd(self.p_pad, 128)
            c_i = max(1, 2048 // self.p_pad)
            if c_i >= align:
                c_i -= c_i % align
            self.c_i = c_i
            self.c_j = c_i * 8
            self.n_pad = _next_multiple(self.n, self.c_j)
            self.n_strips_i = self.n_pad // self.c_i
            self.n_strips_j = self.n_pad // self.c_j
            self.f_pad = g * self.alpha

        ids = np.asarray(enc.ids)
        lengths = np.asarray(enc.lengths)
        if self.n_pad > self.n:
            ids = np.pad(ids, ((0, self.n_pad - self.n), (0, 0)))
            lengths = np.pad(lengths, (0, self.n_pad - self.n))
        dev = self.config.device
        self._ids = jax.device_put(jnp.asarray(ids), dev)
        self._lengths = jax.device_put(jnp.asarray(lengths), dev)

    def _build_x(self) -> jnp.ndarray:
        """One-hot windows: int8 for the kernel, bf16 for XLA strips."""
        return _build_x_jit(
            self._ids,
            self._lengths,
            g=self.g,
            alpha=self.alpha,
            code_min=self.code_min,
            p_pad=self.p_pad,
            f_pad=self.f_pad,
            dtype=jnp.int8 if self.backend == "pallas" else jnp.bfloat16,
        )

    def exact(self) -> np.ndarray:
        """Exact unnormalized kernel, int64 [N, N] — all C(g, m) subsets:
        one device program, then one pull of the int32 matrix."""
        progress = Progress(quiet=self.config.quiet)
        progress.log(
            f"pairs exact ({self.backend}): {self.n} sequences, "
            f"p_pad={self.p_pad}"
        )
        pairs_total = self.n * (self.n + 1) / 2 * math.comb(self.g, self.k)
        with profiler_trace(self.config.profile_dir), timed(
            progress, "pairs exact kernel", pairs_total, "pairs"
        ):
            full = self._full_device()
            return np.asarray(full).astype(np.int64)

    def exact_device(self):
        """Exact unnormalized kernel as device-resident ``DeviceCounts``
        (kernel/device_counts.py): no O(N^2) host transfer happens — the
        fit/score path consumes the counts where they are.

        Per-pair totals are int32-exact by the constructor guard
        (p_pad**2 * C(g,k) < 2**31), so ``lo`` alone carries the counts.
        """
        from .device_counts import DeviceCounts

        return DeviceCounts(self._full_device())

    def _full_device(self) -> jnp.ndarray:
        """The full symmetric [n, n] int32 counts, on device."""
        if self.backend == "pallas":
            return _pairs_full_device_jit(
                self._build_x(),
                g=self.g, k=self.k, p_pad=self.p_pad, sj=self.sj, n=self.n,
            )
        upper = self._exact_xla_device(self._build_x())
        return (jnp.triu(upper) + jnp.triu(upper, 1).T)[: self.n, : self.n]

    def _exact_xla_device(self, x) -> jnp.ndarray:
        k_acc = jnp.zeros((self.n_pad, self.n_pad), dtype=jnp.int32)
        if self.config.device is not None:
            k_acc = jax.device_put(k_acc, self.config.device)
        for i in range(self.n_strips_i):
            k_acc = pairs.pairs_strip_update(
                k_acc,
                x,
                jnp.int32(i),
                k=self.k,
                c_i=self.c_i,
                c_j=self.c_j,
                p_pad=self.p_pad,
                n_strips_j=self.n_strips_j,
            )
        return k_acc


from ..ops import pairs_packed as _pairs_packed

_build_packed_x_jit = jax.jit(
    _pairs_packed.build_packed_x,
    static_argnames=("g", "alpha", "code_min", "dtype"),
)


class PackedPairsEngine:
    """Ragged-aware all-pairs exact engine (ops/pairs_packed.py).

    Sequences sorted by descending length pack back to back (rows rounded
    to 8), so D-matmul work tracks the true window count instead of
    N * max_windows — up to ~35x less on SCOP/NLP data — and digit-plane
    accumulation removes the seq-aligned engine's int32 per-pair bound.
    """

    TILE = 2048

    def __init__(
        self,
        enc: EncodedSeqs,
        g: int,
        m: int,
        config: Optional[KernelConfig] = None,
    ):
        from ..ops import pairs_packed

        self.enc = enc
        self.g = g
        self.m = m
        self.k = g - m
        self.config = config or KernelConfig()
        self.alpha = enc.hash_base
        self.code_min = enc.code_min
        self.n = enc.n

        # digit base: small enough that a per-plane kernel entry
        # (p_i * p_j * (base-1)) stays int32-exact even for very long
        # sequences (the reference caps lengths at 15000, shared.h:4)
        p_max = int(enc.num_windows(g).max())
        base = 256
        while base > 2 and p_max**2 * (base - 1) >= 2**31:
            base //= 2
        if p_max**2 * (base - 1) >= 2**31:
            raise ValueError(
                f"windows per sequence too large for int32 digit planes "
                f"(p_max={p_max})"
            )
        c_total = math.comb(g, self.k)

        def _nd(b):
            return max(1, math.ceil(math.log(c_total + 1, b)))

        # prefer base 128 when it doesn't add a plane: every int32 bound
        # only loosens with the smaller base
        if base == 256 and _nd(128) == _nd(256):
            base = 128
        self.digit_base = base
        self.n_digits = _nd(base)

        order = np.argsort(-np.asarray(enc.lengths), kind="stable")
        self.order = order
        lengths_sorted = np.asarray(enc.lengths)[order]
        ids_sorted = np.asarray(enc.ids)[order]
        # adaptive tile: small alphabets make the per-tile D matmul cheap,
        # so widen tiles to amortize loop overhead over more work.
        # Widening must preserve the stage-2 int32 cumsum invariant of
        # packed_strip_update: running sums are bounded by
        # tile * min(tile, rows-per-sequence) * (digit_base - 1), which for
        # the default tile=2048/base=256 is always < 2^31 but for a doubled
        # tile only when sequences are short enough.
        self.tile = self.TILE
        p_rows_max = int(-(-p_max // 8) * 8)
        wide = 2 * self.TILE
        if (
            self.TILE >= 2048
            and g * self.alpha <= 64
            and wide * min(wide, p_rows_max) * (base - 1) < 2**31
        ):
            self.tile = wide
        self.mesh = self.config.mesh

        self.pack = pairs_packed.pack_windows(lengths_sorted, g, self.tile)
        self.n_strips = self.pack["n_strips"]
        self.c_max = self.pack["c_max"]
        self.c_pad = -(-self.c_max // 16) * 16
        self.total_rows = self.pack["total_pad"]

        dev = self.config.device
        self._ids = jax.device_put(jnp.asarray(ids_sorted), dev)
        self._seq_of = jax.device_put(jnp.asarray(self.pack["seq_of"]), dev)
        self._win_of = jax.device_put(jnp.asarray(self.pack["win_of"]), dev)
        self._first_seq = jax.device_put(jnp.asarray(self.pack["first_seq"]), dev)
        self._bounds = jax.device_put(jnp.asarray(self.pack["bounds"]), dev)

    def exact(self) -> np.ndarray:
        from ..ops import pairs_packed
        from ..utils.observe import Progress, timed

        progress = Progress(quiet=self.config.quiet)
        progress.log(
            f"packed pairs exact: {self.n} sequences, "
            f"{self.total_rows} window rows, strips={self.n_strips}, "
            f"c_max={self.c_max}, digits={self.n_digits}"
        )
        n_pad = self.n + self.c_pad
        with timed(
            progress, "packed pairs kernel",
            self.n * (self.n + 1) / 2 * math.comb(self.g, self.k), "pairs",
        ):
            x = self._build_x()
            if self.mesh is not None:
                if self.config.mesh_state == "sharded":
                    k_sorted = self._exact_sharded_planes_rows(x, n_pad)
                else:
                    k_sorted = self._exact_sharded_planes(x, n_pad)
            else:
                k_sorted = self._planes_to_host(self._compute_planes(x, n_pad))
        # undo the length sort
        pos = np.empty(self.n, dtype=np.int64)
        pos[self.order] = np.arange(self.n)
        return k_sorted[np.ix_(pos, pos)].astype(np.int64, copy=False)

    def _build_x(self) -> jnp.ndarray:
        return _build_packed_x_jit(
            self._ids, self._seq_of, self._win_of,
            g=self.g, alpha=self.alpha, code_min=self.code_min,
            dtype=jnp.bfloat16,
        )

    def _compute_planes(self, x, n_pad: int):
        """Digit planes on one device: the blocked XLA strip sweep."""
        from ..ops import pairs_packed

        planes = tuple(
            jnp.zeros((n_pad, n_pad), jnp.int32)
            for _ in range(self.n_digits)
        )
        for a in range(self.n_strips):
            planes = pairs_packed.packed_strip_update(
                planes,
                x,
                self._seq_of,
                self._first_seq,
                self._bounds,
                jnp.int32(a),
                g=self.g,
                k=self.k,
                tile=self.tile,
                c_max=self.c_max,
                n_strips=self.n_strips,
                n_digits=self.n_digits,
                digit_base=self.digit_base,
            )
        return planes

    def exact_device(self):
        """Exact unnormalized kernel as device-resident ``DeviceCounts``
        (kernel/device_counts.py), skipping the digit-plane transfer
        machinery entirely: planes combine to one int32 matrix on device,
        the upper triangle mirrors on device, and the length-sort
        un-permutation is a device gather.

        The int32 combination needs the runtime plane-max bound
        ``sum(max_d * base^d) < 2^31`` (holds on all real data —
        see ``_planes_to_host``); pathological inputs fall back to the
        exact host per-plane int64 combination and return a numpy array,
        which callers must accept (FastSK._compute handles both).
        """
        from ..ops import pairs_packed
        from .device_counts import DeviceCounts

        if self.mesh is not None:
            raise ValueError("device-resident exact is single-device")
        n_pad = self.n + self.c_pad
        planes = self._compute_planes(self._build_x(), n_pad)
        pos = np.empty(self.n, dtype=np.int64)
        pos[self.order] = np.arange(self.n)
        maxes = np.asarray(pairs_packed.plane_maxes(tuple(planes)))
        bound = sum(
            int(mx) * self.digit_base**d for d, mx in enumerate(maxes)
        )
        if bound >= 2**31:
            k_sorted = np.zeros((self.n, self.n), dtype=np.int64)
            for dig in range(self.n_digits):
                k_sorted += (self.digit_base**dig) * np.asarray(
                    planes[dig], dtype=np.int64
                )[: self.n, : self.n]
            return k_sorted[np.ix_(pos, pos)]
        k32 = pairs_packed.combine_planes_int32(
            tuple(planes), digit_base=self.digit_base
        )
        full = jnp.triu(k32) + jnp.triu(k32, 1).T
        full = full[: self.n, : self.n]
        full = jnp.take(jnp.take(full, pos, axis=0), pos, axis=1)
        return DeviceCounts(full)

    def _planes_to_host(self, planes) -> np.ndarray:
        """Digit planes -> int64 [n, n] counts, transfer-optimized.

        When the runtime per-plane maxes bound the
        combined entry below 2^31 (always, on real data), the planes
        collapse to one int32 matrix on device, the diagonal — the
        dominant within-tile outlier — pulls separately as a [n] vector,
        and only the upper-triangle 128-tiles of the rest transfer as
        min-offset byte planes (ops/transfer.py), ~1-2 bytes/count on
        real data. Worst-case data falls back to exact per-plane int64
        combination on the host."""
        from ..ops import pairs_packed
        from ..ops.transfer import pull_tiles_int32

        n_pad = int(planes[0].shape[0])
        maxes = np.asarray(pairs_packed.plane_maxes(tuple(planes)))
        bound = sum(
            int(m) * self.digit_base**d for d, m in enumerate(maxes)
        )
        if bound >= 2**31:
            k_sorted = np.zeros((self.n, self.n), dtype=np.int64)
            for dig in range(self.n_digits):
                k_sorted += (self.digit_base**dig) * np.asarray(
                    planes[dig], dtype=np.int64
                )[: self.n, : self.n]
            return k_sorted

        ts = 128
        k32 = pairs_packed.combine_planes_int32(
            tuple(planes), digit_base=self.digit_base
        )
        diag_dev, k32 = pairs_packed.split_diagonal(k32)
        tiles = pairs_packed.upper_tiles(k32, tile=ts)
        npt = -(-n_pad // ts)
        tiles_h = pull_tiles_int32(
            tiles, np.arange(npt * (npt + 1) // 2)
        )
        diag = np.asarray(diag_dev)
        # int32 assembly (entries < 2^31 by the bound; the mirror never
        # adds two non-zeros) — half the host memory traffic of int64
        k_full = np.zeros((npt * ts, npt * ts), dtype=np.int32)
        ti = 0
        for i in range(npt):
            for j in range(i, npt):
                k_full[i * ts : (i + 1) * ts, j * ts : (j + 1) * ts] = (
                    tiles_h[ti]
                )
                ti += 1
        k_full = np.triu(k_full, 1) + np.triu(k_full, 1).T
        diag_pad = np.zeros(k_full.shape[0], dtype=np.int32)
        diag_pad[:n_pad] = diag
        np.fill_diagonal(k_full, diag_pad)
        return k_full[: self.n, : self.n]

    def _exact_sharded_planes_rows(self, x, n_pad: int) -> np.ndarray:
        """Ring-sharded mesh planes (KernelConfig.mesh_state="sharded",
        the default): the window table is strip-sharded to match each
        device's plane row block and travels the ring ONCE while every
        device sweeps its own strips against each visiting shard
        (parallel/sharding.py:packed_ring_rowsharded) — per-device
        memory is O(N^2/n_dev) block + O(rows/n_dev) operands, nothing
        replicated but the tiny strip metadata, one dispatch for the
        whole kernel. Overlapping halo extents add on host assembly.
        Integer-identical to the replicated path and the single device.
        """
        from ..parallel import sharding as shd

        mesh = self.mesh
        n_dev = mesh.devices.size
        spd = -(-self.n_strips // n_dev)  # own strips per device
        fs = np.asarray(self.pack["first_seq"])
        row0 = np.zeros(n_dev, np.int32)
        blk = self.c_max
        for d in range(n_dev):
            s0 = d * spd
            s1 = min(s0 + spd, self.n_strips)
            if s0 < self.n_strips:
                row0[d] = fs[s0]
                blk = max(blk, int(fs[s1 - 1]) + self.c_max - int(fs[s0]))

        # pad the window table to n_dev * spd strips (dead strips carry
        # all-zero one-hot rows: D = 0 and C(0, k) = 0, so they
        # contribute exactly nothing)
        rows_pad = n_dev * spd * self.tile
        f = x.shape[1]
        x_p = jnp.pad(x, ((0, rows_pad - x.shape[0]), (0, 0)))
        seq_p = np.pad(
            np.asarray(self.pack["seq_of"]),
            (0, rows_pad - x.shape[0]),
            constant_values=-1,
        )

        dev_sharding = jax.sharding.NamedSharding(
            mesh,
            jax.sharding.PartitionSpec(
                (shd.ROWS_AXIS, shd.THETA_AXIS), None, None, None
            ),
        )
        dev3 = jax.sharding.NamedSharding(
            mesh,
            jax.sharding.PartitionSpec(
                (shd.ROWS_AXIS, shd.THETA_AXIS), None, None
            ),
        )
        dev2 = jax.sharding.NamedSharding(
            mesh,
            jax.sharding.PartitionSpec((shd.ROWS_AXIS, shd.THETA_AXIS), None),
        )
        dev1 = jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec((shd.ROWS_AXIS, shd.THETA_AXIS))
        )
        rep = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
        blocks = jnp.zeros(
            (n_dev, self.n_digits, blk, n_pad), jnp.int32, device=dev_sharding
        )
        x_dev = jax.device_put(
            np.asarray(x_p).reshape(n_dev, spd * self.tile, f), dev3
        )
        seq_dev = jax.device_put(
            seq_p.reshape(n_dev, spd * self.tile).astype(np.int32), dev2
        )
        first_seq = jax.device_put(self._first_seq, rep)
        bounds = jax.device_put(self._bounds, rep)
        r0_dev = jax.device_put(row0, dev1)
        blocks = shd.packed_ring_rowsharded(
            blocks, x_dev, seq_dev, first_seq, bounds, r0_dev,
            mesh=mesh, spd=spd, g=self.g, k=self.k, tile=self.tile,
            c_max=self.c_max, n_strips=self.n_strips,
            n_digits=self.n_digits, digit_base=self.digit_base,
        )
        blocks_host = shd.host_gather(blocks)
        rows_total = max(int(row0.max()) + blk, n_pad)
        planes = np.zeros((self.n_digits, rows_total, n_pad), np.int64)
        for d in range(n_dev):
            planes[:, row0[d] : row0[d] + blk] += blocks_host[d]
        k_sorted = np.zeros((self.n, self.n), dtype=np.int64)
        for dig in range(self.n_digits):
            k_sorted += (self.digit_base**dig) * planes[dig][
                : self.n, : self.n
            ]
        return k_sorted

    def _exact_sharded_planes(self, x, n_pad: int) -> np.ndarray:
        """Mesh-parallel strips, round-robin: each device accumulates its
        strips' contributions into a private digit-plane replica; the host
        sums replicas (each (a, b) pair lands on exactly one device)
        (KernelConfig.mesh_state="replicated")."""
        from ..parallel import sharding as shd

        mesh = self.mesh
        n_dev = mesh.devices.size
        dev_sharding = jax.sharding.NamedSharding(
            mesh,
            jax.sharding.PartitionSpec(
                (shd.ROWS_AXIS, shd.THETA_AXIS), None, None, None
            ),
        )
        rep = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
        planes_dev = jnp.zeros(
            (n_dev, self.n_digits, n_pad, n_pad), jnp.int32,
            device=dev_sharding,
        )
        x = jax.device_put(x, rep)
        seq_of = jax.device_put(self._seq_of, rep)
        first_seq = jax.device_put(self._first_seq, rep)
        bounds = jax.device_put(self._bounds, rep)
        spd = -(-self.n_strips // n_dev)  # rounds
        for ridx in range(spd):
            planes_dev = shd.packed_round_sharded(
                planes_dev, x, seq_of, first_seq, bounds, jnp.int32(ridx),
                mesh=mesh, g=self.g, k=self.k, tile=self.tile,
                c_max=self.c_max, n_strips=self.n_strips,
                n_digits=self.n_digits, digit_base=self.digit_base,
            )
        planes_host = shd.host_gather(planes_dev).sum(axis=0)
        k_sorted = np.zeros((self.n, self.n), dtype=np.int64)
        for dig in range(self.n_digits):
            k_sorted += (self.digit_base**dig) * planes_host[dig][
                : self.n, : self.n
            ]
        return k_sorted
