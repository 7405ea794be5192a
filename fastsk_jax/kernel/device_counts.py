"""Device-resident exact kernel counts.

The reference workflow always materializes the kernel matrix on the host
(fastsk.cpp:190-217 copies the packed triangular K into dense Python
lists), while the SVM solver that consumes the kernel here is itself a
jitted device program operating on an f32 Gram.

``DeviceCounts`` keeps the exact integer counts on device and defers any
host materialization until a caller actually asks for the host matrix.
The fit/score path (normalize -> Gram -> SMO -> decision values) then
runs end to end on device, pulling only O(n) scalars.

Exactness: counts are held as ``lo + 2**30 * hi`` int32 pairs (``hi`` is
usually all zeros and elided). Totals are exact below 2**61 — far beyond
any supported workload (the engines' own spill cadence bounds each lo
accumulation below 2**31). ``normalized_f32`` rounds the exact integers
to f32 once, which is the same rounding the host fit path applies when
it casts the f64-normalized kernel to f32 for the SMO solver.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

_CARRY_BASE = 1 << 30


@jax.jit
def _carry_spill(lo: jnp.ndarray, hi: jnp.ndarray):
    """Move completed 2**30-units from lo into hi (values nonnegative)."""
    carry = lo // _CARRY_BASE
    return lo - carry * _CARRY_BASE, hi + carry


@jax.jit
def _combine_f32(lo: jnp.ndarray, hi: jnp.ndarray) -> jnp.ndarray:
    return hi.astype(jnp.float32) * float(_CARRY_BASE) + lo.astype(jnp.float32)


@jax.jit
def _normalize_f32(counts: jnp.ndarray) -> jnp.ndarray:
    """Cosine normalization on device: K / sqrt(diag x diag), f32.

    Mirrors ``engine.cosine_normalize`` (fastsk_kernel.cpp:96-103) with f32
    arithmetic — the same values the SMO solver sees on the host path after
    its f32 cast, up to one rounding of the sqrt/divide.
    """
    k = counts.astype(jnp.float32)
    diag = jnp.diagonal(k)
    return k / jnp.sqrt(diag[:, None] * diag[None, :])


class DeviceCounts:
    """Exact integer kernel counts resident on device.

    ``lo`` is int32 [n, n]; ``hi`` (optional, int32 [n, n]) holds
    2**30-unit carries for totals beyond int32.
    """

    def __init__(self, lo: jnp.ndarray, hi: Optional[jnp.ndarray] = None):
        self.lo = lo
        self.hi = hi

    @property
    def n(self) -> int:
        return self.lo.shape[0]

    def to_f32(self) -> jnp.ndarray:
        if self.hi is None:
            return self.lo.astype(jnp.float32)
        return _combine_f32(self.lo, self.hi)

    def normalized_f32(self) -> jnp.ndarray:
        """Cosine-normalized kernel, f32, on device."""
        return _normalize_f32(self.to_f32())

    def to_host_int64(self) -> np.ndarray:
        """Pull the exact integer counts to the host (the slow transfer the
        device-resident path exists to avoid; only for explicit access)."""
        out = np.asarray(self.lo, dtype=np.int64)
        if self.hi is not None:
            out += np.asarray(self.hi, dtype=np.int64) * _CARRY_BASE
        return out
