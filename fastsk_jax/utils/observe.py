"""Observability: progress logging, timing, profiler traces, throughput.

The reference's only observability is printf gated by a quiet flag
(fastsk_kernel.cpp:85, :252) and wall-clock deltas in the harness. Here:

- ``Progress``: structured stderr logging gated by ``KernelConfig.quiet``,
  with elapsed-time stamps;
- ``timed``: context manager measuring a span and reporting a rate
  (e.g. sequence-pairs/s, the efficiency metric in BASELINE.md);
- ``profiler_trace``: wraps ``jax.profiler.trace`` so any engine run can
  emit a TensorBoard-loadable device trace.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import Iterator, Optional


class Progress:
    def __init__(self, quiet: bool = True, stream=None):
        self.quiet = quiet
        self.stream = stream or sys.stderr
        self._t0 = time.perf_counter()

    def log(self, msg: str) -> None:
        if self.quiet:
            return
        dt = time.perf_counter() - self._t0
        print(f"[fastsk +{dt:8.2f}s] {msg}", file=self.stream, flush=True)


@contextlib.contextmanager
def timed(
    progress: Progress, label: str, work_items: Optional[float] = None,
    unit: str = "items",
) -> Iterator[dict]:
    """Measure a span; on exit logs wall time and, when ``work_items`` is
    given, the achieved rate. Yields a dict the caller may inspect."""
    out = {"label": label}
    t0 = time.perf_counter()
    try:
        yield out
    finally:
        wall = time.perf_counter() - t0
        out["wall_s"] = wall
        if work_items:
            out["rate"] = work_items / max(wall, 1e-12)
            progress.log(
                f"{label}: {wall:.2f} s ({out['rate']:.3e} {unit}/s)"
            )
        else:
            progress.log(f"{label}: {wall:.2f} s")


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]) -> Iterator[None]:
    """Emit a jax.profiler device trace into ``log_dir`` (no-op if None)."""
    if not log_dir:
        yield
        return
    import jax

    with jax.profiler.trace(log_dir):
        yield


# the checkout this package sits in (fastsk_jax/utils/observe.py -> root)
_CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def compilation_cache_dir() -> str:
    """Where compiled programs persist: ``JAX_COMPILATION_CACHE_DIR`` when
    it is set (JAX reads it itself), else ``.jax_cache`` in the checkout —
    a fixed path, because the path is part of the cache key."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        _CHECKOUT, ".jax_cache"
    )


def enable_compilation_cache() -> str:
    """Enable JAX's persistent compilation cache (idempotent); returns its
    directory. Sets a directory only when ``JAX_COMPILATION_CACHE_DIR``
    does not name one."""
    import jax

    path = compilation_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
