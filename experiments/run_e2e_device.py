#!/usr/bin/env python
"""End-to-end workflow timing: host-pull vs device-resident kernel path.

The reference workflow (test/run_check.py) is read -> kernel -> SVM fit ->
AUC. The O(N^2) kernel pull plus the host-side EKM Gram matmul plus the
per-fold Q pushes can dominate that workflow; the
device-resident path (KernelConfig.device_resident) keeps the kernel, the
Gram, and the SMO solves on device and pulls only O(n) decision values.

Writes one CSV row per (mode, rep): kernel wall, fit wall, score wall,
end-to-end wall, AUC, and a cold/steady ``phase`` label (rep 0 carries
each mode's compiles). Modes run interleaved (host, device, host, ...)
so drift in the host link hits both fairly.

Usage:
  python experiments/run_e2e_device.py [--dataset EP300] [--g 10] [--m 6]
      [--approx] [--kernel-type linear] [--reps 2] [--out CSV]
"""

from __future__ import annotations

import argparse
import csv
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

DATA = "/root/reference/data"


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def run_once(args, device_resident: bool) -> dict:
    from fastsk_jax import FastSK, FastaUtility
    from fastsk_jax.kernel.config import KernelConfig

    reader = FastaUtility()
    Xtr, Ytr = reader.read_data(f"{DATA}/{args.dataset}.train.fasta")
    Xte, Yte = reader.read_data(f"{DATA}/{args.dataset}.test.fasta")

    cfg = KernelConfig(device_resident=device_resident)
    fsk = FastSK(
        g=args.g, m=args.m, approx=args.approx, max_iters=args.max_iters,
        config=cfg,
    )
    t0 = time.perf_counter()
    fsk.compute_kernel(Xtr, Xte, Ytr, Yte)
    t_kernel = time.perf_counter() - t0

    if args.pipeline == "calibrated":
        # the PUBLISHED pipeline (test/utils.py:435-437): calibrated
        # balanced LinearSVC on kernel rows — what every published AUC
        # was produced with. The kernel-row pull is part of the fit
        # phase (this pipeline is host-side by construction).
        import numpy as np

        from fastsk_jax.metrics import roc_auc
        from fastsk_jax.svm.linear import CalibratedLinearSVC

        t0 = time.perf_counter()
        Ktr = np.asarray(fsk.get_train_kernel())
        clf = CalibratedLinearSVC(C=args.C, class_weight="balanced").fit(
            Ktr, np.asarray(Ytr)
        )
        t_fit = time.perf_counter() - t0
        t0 = time.perf_counter()
        Kte = np.asarray(fsk.get_test_kernel())
        probs = clf.predict_proba(Kte)[:, 1]
        auc = float(roc_auc(np.asarray(Yte), probs))
        t_score = time.perf_counter() - t0
    else:
        t0 = time.perf_counter()
        fsk.fit(C=args.C, kernel_type=args.kernel_type)
        t_fit = time.perf_counter() - t0

        t0 = time.perf_counter()
        auc = fsk.score("auc")
        t_score = time.perf_counter() - t0

    return dict(
        mode="device" if device_resident else "host",
        kernel_s=round(t_kernel, 2),
        fit_s=round(t_fit, 2),
        score_s=round(t_score, 2),
        e2e_s=round(t_kernel + t_fit + t_score, 2),
        auc=round(auc, 6),
        iters=fsk.iterations,
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="EP300")
    ap.add_argument("--g", type=int, default=10)
    ap.add_argument("--m", type=int, default=6)
    ap.add_argument("--approx", action="store_true")
    ap.add_argument("--max-iters", type=int, default=-1)
    ap.add_argument("--C", type=float, default=1.0)
    ap.add_argument("--kernel-type", default="linear",
                    choices=["linear", "fastsk", "rbf"])
    ap.add_argument("--pipeline", default="fit",
                    choices=["fit", "calibrated"],
                    help="'fit' = FastSK.fit/score (LIBSVM-parity SMO); "
                         "'calibrated' = the published calibrated "
                         "balanced-LinearSVC EKM pipeline")
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--modes", default="host,device",
                    help="comma list of host,device")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    modes = [m.strip() for m in args.modes.split(",") if m.strip()]
    bad = [m for m in modes if m not in ("host", "device")]
    if bad or not modes:
        ap.error(f"--modes must list host/device; got {args.modes!r}")

    kind = (
        "calibrated" if args.pipeline == "calibrated" else args.kernel_type
    )
    out = args.out or (
        f"experiments/results_e2e/{args.dataset}_g{args.g}_m{args.m}"
        f"_{'approx' if args.approx else 'exact'}_{kind}_e2e.csv"
    )
    os.makedirs(os.path.dirname(out), exist_ok=True)

    rows = []
    for rep in range(args.reps):
        for device_resident in (m == "device" for m in modes):
            r = run_once(args, device_resident)
            r["rep"] = rep
            # rep 0 pays each mode's compiles; later reps are steady.
            # An explicit column makes the committed CSVs self-describing
            # (VERDICT r3 weak #7) instead of relying on convention.
            r["phase"] = "cold" if rep == 0 else "steady"
            log(f"{args.dataset} g={args.g} m={args.m} rep{rep} {r['mode']}: "
                f"kernel {r['kernel_s']}s fit {r['fit_s']}s score "
                f"{r['score_s']}s e2e {r['e2e_s']}s auc {r['auc']}")
            rows.append(r)

    with open(out, "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
    log(f"wrote {out}")

    # steady-state summary (rep 0 carries the compiles for each mode)
    best = {}
    for r in rows:
        if r["rep"] > 0:
            best.setdefault(r["mode"], r)
    if "host" in best and "device" in best:
        h, d = best["host"], best["device"]
        log(
            f"steady e2e: host {h['e2e_s']}s -> device {d['e2e_s']}s "
            f"({h['e2e_s'] / max(d['e2e_s'], 1e-9):.2f}x); "
            f"auc host {h['auc']} device {d['auc']}"
        )


if __name__ == "__main__":
    main()
