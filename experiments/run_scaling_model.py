#!/usr/bin/env python
"""Scaling evidence without multi-chip hardware (docs/scaling.md data).

Virtual CPU devices share host cores, so CPU-mesh wall-clock measures
host contention, not engine scaling (the round-2 EP300_chips.csv
mistake). What CAN be measured honestly on a virtual mesh, and is
reported here per engine and device count:

- per-device PERSISTENT memory (addressable shard bytes of the kernel
  accumulator state) — the large-N constraint;
- per-device WORK assignment (theta passes / strip pairs / row blocks)
  — balance is structural, the counters prove it;
- the ANALYTIC per-device communication volume of one step, from the
  collective pattern (all_gather/psum payload sizes), which is
  hardware-independent.

Writes one CSV row per (engine, n_devices). Run hermetically:
    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python experiments/run_scaling_model.py
"""

from __future__ import annotations

import csv
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def dense_row(enc, g, m, mesh, n_dev):
    """Dense theta engine (exact_batch_update_sharded): rows x theta."""
    import math

    from fastsk_jax.kernel.config import KernelConfig
    from fastsk_jax.kernel.engine import DenseGkmEngine
    from fastsk_jax.parallel import sharding as shd

    import jax
    import jax.numpy as jnp

    eng = DenseGkmEngine(enc, g, m, KernelConfig(mesh=mesh))
    R = mesh.shape[shd.ROWS_AXIS]
    T = mesh.shape[shd.THETA_AXIS]
    np_pad = eng.n_padded
    n_local = np_pad // R
    # MEASURED per-device state: the actual accumulator under the
    # engine's sharding (VERDICT r4 item 9 — model vs measured)
    acc = jnp.zeros((np_pad, np_pad), jnp.int32, device=eng._rows_sharding)
    measured = max(s.data.nbytes for s in acc.addressable_shards)
    assert measured == n_local * np_pad * 4, (measured, n_local, np_pad)
    b = eng.b1 * eng.b2
    tb = eng.theta_batch
    # one batch: all_gather of counts [tb, n_local, B] over rows
    # (receive (R-1) shards), then psum of [n_local, np_pad] over theta
    ag = (R - 1) * tb * n_local * b * 4
    ps = 2 * (T - 1) / T * n_local * np_pad * 4  # reduce-scatter+gather form
    batches = -(-math.comb(g, g - m) // (T * tb))
    return dict(
        engine="dense_theta",
        state_bytes_per_dev=n_local * np_pad * 4,
        state_bytes_measured=measured,
        work_units_per_dev=f"{tb} thetas/batch x {batches} batches",
        comm_bytes_per_dev_step=int(ag + ps),
        steps=batches,
        n=enc.n,
    )


def sorted_rows(enc, g, m, mesh, n_dev):
    from fastsk_jax.kernel.config import KernelConfig
    from fastsk_jax.kernel.sorted_engine import SortedGkmEngine
    from fastsk_jax.parallel import sharding as shd

    import jax
    import jax.numpy as jnp

    eng = SortedGkmEngine(enc, g, m, KernelConfig(mesh=mesh, sorted_slab=256))
    R = mesh.shape[shd.ROWS_AXIS]
    T = mesh.shape[shd.THETA_AXIS]
    n_rows = -(-eng.n // R)
    # MEASURED: the row-strip accumulator exactly as
    # _sum_stream_rowsharded builds it
    rows_sharding = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(shd.ROWS_AXIS, None)
    )
    k_rows = jnp.zeros((R * n_rows, eng.n), jnp.int32, device=rows_sharding)
    measured = max(s.data.nbytes for s in k_rows.addressable_shards)
    assert measured == n_rows * eng.n * 4, (measured, n_rows, eng.n)
    import math

    total = math.comb(g, g - m)
    per_step = T * eng.theta_batch
    steps = -(-total // per_step)
    # windows/valid/seq_of replicated once; per batch one psum of the
    # [n_rows, n] strip over the theta axis
    ps = 2 * (T - 1) / T * n_rows * eng.n * 4
    return dict(
        engine="sorted_rows",
        state_bytes_per_dev=n_rows * eng.n * 4,
        state_bytes_measured=measured,
        work_units_per_dev=f"{eng.theta_batch} thetas/batch x {steps} batches"
        f" (sort duplicated x{R})",
        comm_bytes_per_dev_step=int(ps),
        steps=steps,
        n=enc.n,
    )


def packed_rows(enc, g, m, mesh, n_dev):
    from fastsk_jax.kernel.config import KernelConfig
    from fastsk_jax.kernel.pairs_engine import PackedPairsEngine

    from fastsk_jax.parallel import sharding as _shd_mod

    orig = PackedPairsEngine.TILE
    PackedPairsEngine.TILE = 64
    orig_ring = _shd_mod.packed_ring_rowsharded
    measured = {}

    def spy(blocks_dev, x_dev, *a, **kw):
        # MEASURED per-device persistent state: the plane row block plus
        # the ring-traveling operand shard, exactly as dispatched
        measured["plane"] = max(
            s.data.nbytes for s in blocks_dev.addressable_shards
        )
        measured["operand"] = max(
            s.data.nbytes for s in x_dev.addressable_shards
        )
        return orig_ring(blocks_dev, x_dev, *a, **kw)

    try:
        _shd_mod.packed_ring_rowsharded = spy
        eng = PackedPairsEngine(enc, g, m, KernelConfig(mesh=mesh))
        ns = eng.n_strips
        spd = -(-ns // n_dev)
        fs = np.asarray(eng.pack["first_seq"])
        n_pad = eng.n + eng.c_pad
        blk = eng.c_max
        for d in range(n_dev):
            s0, s1 = d * spd, min((d + 1) * spd, ns)
            if s0 < ns:
                blk = max(blk, int(fs[s1 - 1]) + eng.c_max - int(fs[s0]))
        f = eng.g * eng.alpha
        rows = eng.total_rows
        shard_rows = -(-ns // n_dev) * eng.tile
        if n_dev > 1:
            eng.exact()  # fires the spy (mesh_state="sharded" default)
            assert measured["plane"] == eng.n_digits * blk * n_pad * 4, (
                measured, eng.n_digits, blk, n_pad
            )
            assert measured["operand"] == shard_rows * f * 2, (
                measured, shard_rows, f
            )
        return dict(
            engine="packed_ring",
            state_bytes_per_dev=(
                eng.n_digits * blk * n_pad * 4 + shard_rows * f * 2
            ),
            state_bytes_measured=(
                measured["plane"] + measured["operand"] if measured else ""
            ),
            work_units_per_dev=f"{spd}^2 x {n_dev} ring steps (ordered)",
            # each shard visits every peer once: (D-1) ppermute hops of
            # the [shard_rows, F] bf16 block
            comm_bytes_per_dev_step=int((n_dev - 1) * shard_rows * f * 2),
            steps=n_dev,
            n=enc.n,
        )
    finally:
        PackedPairsEngine.TILE = orig
        _shd_mod.packed_ring_rowsharded = orig_ring


def main():
    from fastsk_jax.ops.encode import encode_sequences
    from fastsk_jax.parallel import default_mesh_shape, make_mesh

    rng = np.random.default_rng(0)
    X = [
        rng.integers(1, 5, size=int(rng.integers(40, 120))).tolist()
        for _ in range(256)
    ]
    enc = encode_sequences(X)
    Xp = [
        rng.integers(1, 21, size=int(rng.integers(30, 120))).tolist()
        for _ in range(256)
    ]
    enc_p = encode_sequences(Xp)

    rows = []
    for n_dev in (1, 2, 4, 8, 16, 32):
        if n_dev > len(jax.devices()):
            log(f"n_dev={n_dev}: skipped (only {len(jax.devices())} devices)")
            continue
        shapes = {default_mesh_shape(n_dev), (n_dev, 1)}
        for shape in sorted(shapes):
            mesh = make_mesh(*shape)
            tag = f"{shape[0]}x{shape[1]}"
            rows.append(dict(n_devices=n_dev, mesh=tag,
                             **dense_row(enc, 8, 4, mesh, n_dev)))
            rows.append(dict(n_devices=n_dev, mesh=tag,
                             **sorted_rows(enc_p, 8, 3, mesh, n_dev)))
            rows.append(dict(n_devices=n_dev, mesh=tag,
                             **packed_rows(enc, 8, 4, mesh, n_dev)))
        log(f"n_dev={n_dev} done")

    out = "experiments/results_EP300/mesh_balance.csv"
    with open(out, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    for r in rows:
        print(r)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
