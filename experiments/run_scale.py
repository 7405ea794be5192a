#!/usr/bin/env python
"""Large-N scale demonstration on one chip (VERDICT r3 item 1).

The blueprint's distributed story is large N (BASELINE.json north
star: kernel-matrix row blocks sharded data-parallel), but through round
3 nothing had ever run above N=7,230. This driver runs the full
device-resident e2e workflow — exact pairs-engine kernel -> SMO
fit (Platt probability) -> AUC — at N up to the single-chip HBM limit,
and records wall-vs-N plus HBM-vs-N tables.

Corpus: synthetic length-200 DNA with a planted, point-mutated 12-mer
motif in the positive class (seeded, reproducible), so the task carries
real signal and the AUC is meaningful at every N; N=7230 additionally
cross-checks against the real EP300_47848 suite shape.

Modes:
  --e2e             wall/HBM vs N table (default Ns: 7230 15000 25000 30000)
  --checkpoint      interrupt/resume the checkpointed dense-theta stream
                    at N=25000 and verify identical integers on resume
  --ns 7230 25000   override the N list

Outputs: experiments/results_scale/scale_e2e.csv (phase column per row)
and scale_checkpoint.json.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)) + "/..")

OUTDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "results_scale")
MOTIF = [1, 3, 4, 4, 1, 2, 1, 1, 3, 2, 4, 2]  # GATTACAAGTCT-ish, codes 1..4


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def synth_corpus(n: int, seed: int = 7, length: int = 200):
    """Seeded length-200 DNA (codes 1..4, 0 reserved = unknown, matching
    FastaUtility's vocabulary convention, reference utils.py:11-14).
    Positives carry the planted motif with 2 random point mutations at a
    random offset; negatives are uniform. 90/10 train/test split."""
    rng = np.random.default_rng(seed)
    X = rng.integers(1, 5, size=(n, length))
    y = (np.arange(n) % 2).astype(np.int64)  # balanced, deterministic
    pos = np.flatnonzero(y == 1)
    offs = rng.integers(0, length - len(MOTIF), size=len(pos))
    motif = np.asarray(MOTIF)
    for i, o in zip(pos, offs):
        mut = motif.copy()
        for j in rng.integers(0, len(MOTIF), size=2):
            mut[j] = rng.integers(1, 5)
        X[i, o : o + len(MOTIF)] = mut
    n_test = max(1, n // 10)
    xtr = [list(map(int, r)) for r in X[: n - n_test]]
    xte = [list(map(int, r)) for r in X[n - n_test :]]
    return xtr, list(y[: n - n_test]), xte, list(y[n - n_test :])


def hbm_stats():
    """Device memory in use. Where memory_stats() is unavailable, fall
    back to summing live jax arrays — the
    device-resident footprint this table is about (transient XLA scratch
    inside one program is additionally bounded by the fitted programs
    actually running, which OOM loudly if they don't)."""
    import jax

    try:
        s = jax.local_devices()[0].memory_stats()
        if s and s.get("bytes_in_use"):
            return {
                "hbm_in_use_gib": round(s["bytes_in_use"] / 2**30, 3),
                "hbm_peak_gib": round(
                    s.get("peak_bytes_in_use", 0) / 2**30, 3
                ),
            }
    except Exception:
        pass
    try:
        live = sum(
            x.nbytes for x in jax.live_arrays() if x.committed or True
        )
        return {"hbm_in_use_gib": round(live / 2**30, 3), "hbm_peak_gib": None}
    except Exception:
        return {"hbm_in_use_gib": None, "hbm_peak_gib": None}


def run_e2e(ns, g, m, kernel_type_large="fastsk"):
    import jax

    from fastsk_jax import FastSK
    from fastsk_jax.kernel.config import KernelConfig

    os.makedirs(OUTDIR, exist_ok=True)
    path = os.path.join(OUTDIR, "scale_e2e.csv")
    rows = []
    dev = jax.devices()[0]
    for n in ns:
        xtr, ytr, xte, yte = synth_corpus(n)
        # the reference EKM (linear) gram costs an extra N^2 f32 copy;
        # beyond ~25k rows the precomputed-kernel SVM ("fastsk") is the
        # single-chip-feasible configuration — both are first-class modes
        kernel_type = "linear" if n <= 25_000 else kernel_type_large
        cfg = KernelConfig(device_resident=True)
        fsk = FastSK(g, m, config=cfg)
        t0 = time.perf_counter()
        fsk.compute_kernel(xtr, xte, ytr, yte)
        np.asarray(fsk._counts_dev.lo[:1, :1])  # force
        t_cold = time.perf_counter() - t0
        # steady kernel rep (the compile is paid once per shape)
        t0 = time.perf_counter()
        fsk.compute_kernel(xtr, xte, ytr, yte)
        np.asarray(fsk._counts_dev.lo[:1, :1])
        t_kernel = time.perf_counter() - t0
        mem_k = hbm_stats()
        t0 = time.perf_counter()
        # free the integer counts before fit: the fit/score path consumes
        # only the normalized f32 kernel, and at N=30k the extra N^2 int32
        # plane is the difference between fitting and OOM on one chip
        fsk._counts_dev = None
        fsk.fit(C=1.0, kernel_type=kernel_type)
        t_fit = time.perf_counter() - t0
        t0 = time.perf_counter()
        auc = fsk.score("auc")
        t_score = time.perf_counter() - t0
        mem = hbm_stats()
        pairs = n * (n + 1) / 2 * __import__("math").comb(g, g - m)
        row = dict(
            n=n, g=g, m=m, kernel_type=kernel_type,
            wall_kernel_cold_s=round(t_cold, 2),
            wall_kernel_steady_s=round(t_kernel, 2),
            wall_fit_cold_s=round(t_fit, 2),
            wall_score_cold_s=round(t_score, 2), auc=round(auc, 6),
            pairs_per_s=f"{pairs / t_kernel:.3e}",
            hbm_after_kernel_gib=mem_k["hbm_in_use_gib"],
            hbm_at_score_gib=mem["hbm_in_use_gib"],
        )
        rows.append(row)
        log(f"N={n}: kernel {t_cold:.2f}s cold / {t_kernel:.2f}s steady, "
            f"fit {t_fit:.2f}s score {t_score:.2f}s AUC {auc:.4f} "
            f"hbm {mem_k['hbm_in_use_gib']} GiB")
        del fsk
        import gc

        gc.collect()
    import csv

    # merge with prior invocations (keyed by n) so partial runs compose
    merged = {}
    if os.path.exists(path):
        with open(path) as f:
            for r in csv.DictReader(f):
                merged[int(r["n"])] = r
    for r in rows:
        merged[int(r["n"])] = r
    out = [merged[k] for k in sorted(merged)]
    keys = []
    for r in out:
        for c in r:
            if c not in keys:
                keys.append(c)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        w.writerows(out)
    log(f"wrote {path}")


def run_checkpoint(n, g, m):
    """Interrupt the checkpointed dense-theta device stream mid-queue at
    scale N, resume in a fresh model, verify identical integers on a
    sampled row block (pulling the full N^2 int64 proves nothing more)."""
    from fastsk_jax import FastSK
    from fastsk_jax.kernel import engine as engine_mod
    from fastsk_jax.kernel.config import KernelConfig

    os.makedirs(OUTDIR, exist_ok=True)
    xtr, ytr, xte, yte = synth_corpus(n)
    ck = os.path.join(OUTDIR, "scale_ck.npz")
    if os.path.exists(ck):
        os.remove(ck)
    # a bounded skip-variance stream (48 of the C(g,k) thetas) keeps the
    # demo's wall sane; the checkpoint/spill machinery is identical to
    # the full stream's
    mk = lambda: FastSK(  # noqa: E731
        g, m, approx=True, skip_variance=True, max_iters=48,
        config=KernelConfig(
            device_resident=True, checkpoint_path=ck, checkpoint_every=16,
            theta_batch=8, exact_engine="theta",
        ),
    )

    class Stop(Exception):
        pass

    orig = engine_mod.gkm.exact_batch_update
    calls = {"n": 0}

    def wrapped(*a, **kw):
        calls["n"] += 1
        if calls["n"] > 3:
            raise Stop()
        return orig(*a, **kw)

    t0 = time.perf_counter()
    fsk1 = mk()
    engine_mod.gkm.exact_batch_update = wrapped
    interrupted = False
    try:
        fsk1.compute_kernel(xtr, xte, ytr, yte)
    except Stop:
        interrupted = True
    finally:
        engine_mod.gkm.exact_batch_update = orig
    t_int = time.perf_counter() - t0
    assert interrupted and os.path.exists(ck), "interrupt did not checkpoint"
    del fsk1

    def counts_block(fsk):
        # with checkpoint_path set the engine runs the host-accumulating
        # (checkpointable) path — api.py:160-168 — so the exact integers
        # live in _counts (int64 host), not _counts_dev
        if fsk._counts_dev is not None:
            return np.asarray(fsk._counts_dev.lo[:64, :256])
        return np.asarray(fsk._counts[:64, :256])

    t0 = time.perf_counter()
    fsk2 = mk()
    fsk2.compute_kernel(xtr, xte, ytr, yte)
    t_resume = time.perf_counter() - t0
    resumed_block = counts_block(fsk2)
    del fsk2
    if os.path.exists(ck):
        os.remove(ck)

    t0 = time.perf_counter()
    fsk3 = mk()
    fsk3.compute_kernel(xtr, xte, ytr, yte)
    t_fresh = time.perf_counter() - t0
    fresh_block = counts_block(fsk3)
    identical = bool(np.array_equal(resumed_block, fresh_block))
    out = dict(
        n=n, g=g, m=m, thetas=48, interrupted_after_batches=3,
        wall_interrupted_s=round(t_int, 2),
        wall_resume_s=round(t_resume, 2),
        wall_fresh_s=round(t_fresh, 2),
        resumed_equals_fresh=identical,
        sampled_block="[:64, :256]",
        block_sum=int(fresh_block.sum()),
    )
    path = os.path.join(OUTDIR, "scale_checkpoint.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    log(json.dumps(out))
    assert identical, "resumed counts differ from fresh counts"
    log(f"wrote {path}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--e2e", action="store_true")
    ap.add_argument("--checkpoint", action="store_true")
    ap.add_argument("--ns", type=int, nargs="+",
                    default=[7230, 15000, 25000, 30000])
    ap.add_argument("--g", type=int, default=16)
    ap.add_argument("--m", type=int, default=10)
    ap.add_argument("--ckpt-n", type=int, default=25000)
    args = ap.parse_args()
    from fastsk_jax.utils.observe import enable_compilation_cache

    enable_compilation_cache()
    if args.e2e:
        run_e2e(args.ns, args.g, args.m)
    if args.checkpoint:
        run_checkpoint(args.ckpt_n, args.g, args.m)
    if not (args.e2e or args.checkpoint):
        log("pick --e2e and/or --checkpoint")


if __name__ == "__main__":
    main()
