#!/usr/bin/env python
"""Experiment suite — the JAX analogue of results/run_experiments.py.

Flag-driven sub-experiments writing one CSV each (consumed by plot.py):

  --g-time      kernel time vs g at fixed k=6           (:326-473)
  --m-time      kernel time vs m at g=16                (:172-308)
  --I-auc       AUC vs number of sampled iterations     (:647-679)
  --delta-auc   AUC vs convergence delta                (:698-736)
  --stdev-I     per-iteration sd trajectories, 5 seeds  (:1098-1195)
  --g-auc       AUC vs g (exact vs approx)              (:475-645)
  --chips       pairs/s vs simulated device count — the thread-scaling
                analogue (:114-163); uses a host-device mesh on CPU or
                real devices when available

Each timing point uses the reference's timeout convention (kill at
--timeout seconds, record the cap).
"""

from __future__ import annotations

import argparse
import csv
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

DATA = ("/root/reference/data", "data")


def _writer(path, fields):
    f = open(path, "w", newline="")
    w = csv.DictWriter(f, fieldnames=fields)
    w.writeheader()
    return f, w


def g_time(prefix, out, timeout):
    from fastsk_jax.harness import time_fastsk

    f, w = _writer(out, ["g", "m", "k", "compile_s", "steady_s", "timed_out"])
    with f:
        for g in range(6, 21, 2):
            m = g - 6
            try:
                first, steady, killed = time_fastsk(
                    g=g, m=m, prefix=prefix, timeout=timeout, detail=True
                )
            except RuntimeError as e:
                # per-point failures (e.g. g exceeds the dataset's
                # shortest sequence, the reference's own hard limit,
                # shared.cpp:400-412) skip the point, not the sweep
                print(f"g={g} m={m}: skipped ({e})", flush=True)
                continue
            w.writerow({"g": g, "m": m, "k": 6,
                        "compile_s": round(first, 3),
                        "steady_s": round(steady, 3),
                        "timed_out": int(killed)})
            f.flush()
            print(f"g={g} m={m}: first={first:.2f}s steady={steady:.2f}s"
                  f"{' TIMEOUT' if killed else ''}", flush=True)


def m_time(prefix, out, timeout):
    from fastsk_jax.harness import time_fastsk

    f, w = _writer(out, ["g", "m", "compile_s", "steady_s", "timed_out"])
    with f:
        for m in range(0, 15, 2):
            first, steady, killed = time_fastsk(
                g=16, m=m, prefix=prefix, timeout=timeout, detail=True
            )
            w.writerow({"g": 16, "m": m,
                        "compile_s": round(first, 3),
                        "steady_s": round(steady, 3),
                        "timed_out": int(killed)})
            f.flush()
            print(f"m={m}: first={first:.2f}s steady={steady:.2f}s"
                  f"{' TIMEOUT' if killed else ''}", flush=True)


def i_auc(prefix, out):
    from fastsk_jax.harness import FastskRunner

    runner = FastskRunner(prefix, data_locations=DATA)
    f, w = _writer(out, ["I", "auc", "acc"])
    with f:
        for I in (1, 2, 5, 10, 25, 50, 100, 200):
            res = runner.train_and_test(
                g=10, m=6, approx=True, I=I, skip_variance=True
            )
            w.writerow({"I": I, "auc": round(res["auc"], 6),
                        "acc": round(res["acc"], 6)})
            print(f"I={I}: auc={res['auc']:.4f}", flush=True)


def delta_auc(prefix, out):
    from fastsk_jax.harness import FastskRunner

    runner = FastskRunner(prefix, data_locations=DATA)
    f, w = _writer(out, ["delta", "auc", "iters"])
    with f:
        for delta in (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5):
            res = runner.train_and_test(g=10, m=6, approx=True, delta=delta)
            w.writerow({"delta": delta, "auc": round(res["auc"], 6),
                        "iters": res["iters"]})
            print(f"delta={delta}: auc={res['auc']:.4f} iters={res['iters']}",
                  flush=True)


def stdev_vs_i(prefix, out, seeds=5):
    from fastsk_jax.api import FastSK
    from fastsk_jax.harness import FastskRunner

    runner = FastskRunner(prefix, data_locations=DATA)
    f, w = _writer(out, ["seed", "iteration", "stdev"])
    with f:
        for seed in range(seeds):
            fsk = FastSK(g=10, m=6, approx=True, max_iters=100, seed=seed)
            fsk.compute_kernel(runner.train_seq, runner.test_seq)
            for i, sd in enumerate(fsk.get_stdevs()):
                w.writerow({"seed": seed, "iteration": i + 1,
                            "stdev": round(sd, 8)})
            print(f"seed={seed}: {fsk.iterations} iterations", flush=True)


def g_auc(prefix, out):
    from fastsk_jax.harness import FastskRunner

    runner = FastskRunner(prefix, data_locations=DATA)
    min_len = min(len(s) for s in runner.train_seq + runner.test_seq)
    f, w = _writer(out, ["g", "m", "mode", "auc"])
    with f:
        for g in range(4, min(16, min_len + 1), 2):
            m = g // 2
            for mode, approx in (("exact", False), ("approx", True)):
                res = runner.train_and_test(g=g, m=m, approx=approx, I=50)
                w.writerow({"g": g, "m": m, "mode": mode,
                            "auc": round(res["auc"], 6)})
                print(f"g={g} {mode}: auc={res['auc']:.4f}", flush=True)


def chips(prefix, out):
    """Kernel throughput vs device count: the thread-scaling analogue.

    On a single-host environment, uses XLA's virtual host devices; on a
    real multi-chip slice, shards over the physical mesh.
    """
    import jax

    from fastsk_jax.harness import FastskRunner
    from fastsk_jax.kernel.config import KernelConfig
    from fastsk_jax.parallel import default_mesh_shape, make_mesh

    runner = FastskRunner(prefix, data_locations=DATA)
    n_dev = len(jax.devices())
    platform = jax.devices()[0].platform
    f, w = _writer(out, ["devices", "platform", "time_s", "speedup"])
    base_t = None
    with f:
        d = 1
        while d <= n_dev:
            rows, theta = default_mesh_shape(d)
            cfg = KernelConfig(mesh=make_mesh(rows, theta)) if d > 1 else None
            t0 = time.time()
            runner.compute_kernel(g=10, m=4, config=cfg)
            t = time.time() - t0
            base_t = base_t or t
            w.writerow({"devices": d, "platform": platform,
                        "time_s": round(t, 3),
                        "speedup": round(base_t / t, 3)})
            print(f"devices={d}: {t:.2f}s", flush=True)
            d *= 2


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="EP300")
    ap.add_argument("--outdir", default="experiment_results")
    ap.add_argument("--timeout", type=float, default=1800)
    for flag in ("g-time", "m-time", "I-auc", "delta-auc", "stdev-I",
                 "g-auc", "chips"):
        ap.add_argument(f"--{flag}", action="store_true")
    args = ap.parse_args(argv)

    os.makedirs(args.outdir, exist_ok=True)
    pre = args.dataset

    def out(name):
        return os.path.join(args.outdir, f"{pre}_{name}.csv")

    if args.g_time:
        g_time(pre, out("g_time"), args.timeout)
    if args.m_time:
        m_time(pre, out("m_time"), args.timeout)
    if args.I_auc:
        i_auc(pre, out("I_auc"))
    if args.delta_auc:
        delta_auc(pre, out("delta_auc"))
    if args.stdev_I:
        stdev_vs_i(pre, out("stdev_I"))
    if args.g_auc:
        g_auc(pre, out("g_auc"))
    if args.chips:
        chips(pre, out("chips"))


if __name__ == "__main__":
    main()
