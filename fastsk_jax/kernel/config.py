"""Configuration for the gapped k-mer kernel engine."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import jax

PAIRS_BACKENDS = ("auto", "xla", "pallas")


@dataclass
class KernelConfig:
    """Tuning knobs for the kernel engine.

    Everything is overridable. ``mesh`` enables multi-device execution
    with the theta (work-queue) axis sharded across devices.
    """

    # Largest dense bucket space B = dict_size**k handled by the dense
    # count-matmul path; beyond this the sorted/rank path takes over.
    b_max_dense: int = 1 << 17

    # Approximate HBM budget (bytes) for the count tensor C [T, N, B] of one
    # theta batch; sets the theta batch size.
    counts_budget_bytes: int = 2 << 30

    # Approximate HBM budget for one row-chunk's one-hot intermediates.
    onehot_budget_bytes: int = 1 << 30

    # Upper bound on thetas per device step.
    max_theta_batch: int = 64

    # Optional fixed overrides (None = auto).
    theta_batch: Optional[int] = None
    row_chunk: Optional[int] = None

    # Multi-device execution: a jax Mesh whose axes include "theta" (the
    # work-queue data-parallel axis). None = single local device.
    mesh: Optional[jax.sharding.Mesh] = None

    # Device to place single-device work on (None = default backend device).
    device: Optional[jax.Device] = None

    # Mesh memory layout for the packed and sorted engines' exact paths:
    # "sharded" keeps only a kernel row block (sorted: [N/R, N]; packed:
    # row-block digit planes) per device, so per-device memory is
    # O(N^2 / n_dev) — the large-N layout matching the dense engine
    # (parallel/sharding.py:exact_batch_update_sharded). "replicated"
    # keeps private full-size replicas per device (round-2 layout:
    # lowest wall-clock on small meshes, memory does not shrink with
    # device count). The dense engine is always row-sharded.
    mesh_state: str = "sharded"

    # Exact-mode engine selection: "auto" prefers the all-pairs engine
    # (kernel/pairs_engine.py) and falls back to the theta engine when the
    # int32 count bound rules it out; "pairs" / "theta" force one.
    exact_engine: str = "auto"

    # Seq-aligned all-pairs route (see ``pairs_route``): "auto" runs the
    # fused Pallas kernel (ops/pairs_pallas.py) where the platform and
    # shape allow it and blocked XLA strips otherwise; "pallas" / "xla"
    # force one. The packed (ragged) engine always runs XLA.
    pairs_backend: str = "auto"

    # Sorted/rank engine: pairs per count-matmul slab ("pairs" layout) /
    # pairs per scatter chunk ("runs" layout).
    sorted_slab: int = 8192

    # Sorted/rank engine slab decomposition: "runs" (run-aligned slabs —
    # fully dense gram columns, no cross-slab corrections, one fewer sort;
    # ~3-4x faster per pass on the NLP suite) or "pairs" (the round-1..3
    # pair-aligned layout). Integer-identical results.
    sorted_layout: str = "runs"

    # Runs per slab for sorted_layout="runs" (the gram width).
    sorted_run_width: int = 2048

    # Mid-computation checkpointing (utils/checkpoint.py): persist the
    # accumulator + work-queue cursor every `checkpoint_every` thetas so a
    # long exact/approx run can resume after interruption.
    checkpoint_path: Optional[str] = None
    checkpoint_every: int = 512

    # Keep kernel counts resident on device (kernel/device_counts.py):
    # fit/score then run end to end on device and the O(N^2) host pull
    # happens only if the host matrix is explicitly accessed.
    # Single-device engines only; mesh and checkpointed runs use the
    # host-accumulating paths regardless.
    device_resident: bool = False

    # Write a jax.profiler device trace of kernel computation here.
    profile_dir: Optional[str] = None

    quiet: bool = True

    def __post_init__(self):
        if self.pairs_backend not in PAIRS_BACKENDS:
            raise ValueError(
                f"pairs_backend must be one of {PAIRS_BACKENDS}; got "
                f"{self.pairs_backend!r}"
            )
        if self.mesh_state not in ("sharded", "replicated"):
            raise ValueError(
                "mesh_state must be 'sharded' or 'replicated'; got "
                f"{self.mesh_state!r}"
            )
        if self.sorted_layout not in ("runs", "pairs"):
            raise ValueError(
                "sorted_layout must be 'runs' or 'pairs'; got "
                f"{self.sorted_layout!r}"
            )


def platform_of(config: KernelConfig) -> str:
    """Platform (``"gpu"``, ``"cpu"``, ...) of the devices an engine built
    with ``config`` runs on: the mesh's, the pinned device's, or the
    default backend's."""
    if config.mesh is not None:
        return config.mesh.devices.flat[0].platform
    if config.device is not None:
        return config.device.platform
    return jax.devices()[0].platform


def pairs_route(config: KernelConfig, kernel_fits: bool) -> str:
    """The seq-aligned all-pairs route, ``"pallas"`` or ``"xla"``.

    The fused kernel is compiled for NVIDIA GPUs only (Pallas through
    Triton); ``kernel_fits`` says whether its exactness bounds admit the
    shape. ``auto`` takes the kernel wherever both hold. An explicit
    ``"pallas"`` that cannot run raises ``RuntimeError`` (which the exact
    engine selection does not catch) — it never falls back and never
    interprets.
    """
    backend = config.pairs_backend
    runs = platform_of(config) == "gpu"
    if backend == "auto":
        return "pallas" if runs and kernel_fits else "xla"
    if backend == "pallas":
        if not runs:
            raise RuntimeError(
                "pairs_backend='pallas' needs a GPU; this engine runs on "
                f"{platform_of(config)!r} (use 'auto' or 'xla')"
            )
        if not kernel_fits:
            raise RuntimeError(
                "pairs_backend='pallas': the fused kernel's exactness "
                "bounds do not admit this (g, m, length); use 'auto' or "
                "'xla'"
            )
    return backend
