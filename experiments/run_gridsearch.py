#!/usr/bin/env python
"""Hyperparameter grid search: g x m x C with approx kernels.

Parity with results/run_gridsearch.py:15-83 — classification sweeps
g in [4, 15], m in [0, g-3] (k >= 3), C in 10^[-3, 2]; each (g, m) kernel
is computed once and every C reuses it; best AUC per dataset is reported.
``--regression`` switches to the LassoCV r^2 variant
(run_gridsearch_for_regression.py:15-94, no C loop).

Usage:
    python experiments/run_gridsearch.py --datasets EP300 --out grid.csv
    python experiments/run_gridsearch.py --csv experiments/datasets.csv
"""

from __future__ import annotations

import argparse
import csv
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def gridsearch_dataset(prefix, data_locations, regression=False, log=print):
    from fastsk_jax.harness import FastskRegressor, FastskRunner
    from fastsk_jax.metrics import roc_auc
    from fastsk_jax.svm.linear import CalibratedLinearSVC

    if regression:
        runner = FastskRegressor(prefix, data_locations=data_locations)
    else:
        runner = FastskRunner(prefix, data_locations=data_locations)
    min_len = min(len(s) for s in runner.train_seq + runner.test_seq)

    best = None
    rows = []
    for g in range(4, 16):
        if g > min_len:
            continue
        for m in range(0, g - 2):
            t0 = time.time()
            if regression:
                r2 = runner.train_and_test(g=g, m=m, approx=True, I=50)
                row = {"dataset": prefix, "g": g, "m": m, "C": "",
                       "score": r2, "metric": "r2",
                       "time_s": round(time.time() - t0, 2)}
                rows.append(row)
                if best is None or row["score"] > best["score"]:
                    best = row
                log(f"  g={g} m={m}: r2={r2:.4f}")
                continue
            fsk = runner.compute_kernel(g=g, m=m, approx=True, I=50,
                                        skip_variance=True)
            Xtrain = np.array(fsk.get_train_kernel())
            Xtest = np.array(fsk.get_test_kernel())
            for C in (10.0**e for e in range(-3, 3)):
                clf = CalibratedLinearSVC(C=C, class_weight="balanced").fit(
                    Xtrain, runner.Ytrain
                )
                auc = roc_auc(runner.Ytest, clf.predict_proba(Xtest)[:, 1])
                row = {"dataset": prefix, "g": g, "m": m, "C": C,
                       "score": auc, "metric": "auc",
                       "time_s": round(time.time() - t0, 2)}
                rows.append(row)
                if best is None or row["score"] > best["score"]:
                    best = row
            log(f"  g={g} m={m}: best-so-far auc={best['score']:.4f} "
                f"(g={best['g']} m={best['m']} C={best['C']})")
    return best, rows


def main(argv=None):
    from fastsk_jax.harness.runner import DATA_LOCATIONS

    ap = argparse.ArgumentParser()
    ap.add_argument("--datasets", nargs="*", help="dataset prefixes")
    ap.add_argument("--csv", help="registry csv (Dataset,type,g,m,k,C)")
    ap.add_argument("--data", help="directory of <name>.{train,test}.fasta "
                    "or pos/neg splits (default: ./data, then the in-repo "
                    "EP300/KAT2B splits)")
    ap.add_argument("--out", default="gridsearch_results.csv")
    ap.add_argument("--regression", action="store_true")
    args = ap.parse_args(argv)

    names = list(args.datasets or [])
    if args.csv:
        with open(args.csv) as f:
            names += [r["Dataset"] for r in csv.DictReader(f)]
    if not names:
        ap.error("provide --datasets or --csv")

    results = []
    all_rows = []
    for name in names:
        print(f"[gridsearch] {name}")
        locations = (args.data,) if args.data else DATA_LOCATIONS
        best, rows = gridsearch_dataset(
            name, locations, regression=args.regression
        )
        all_rows.extend(rows)
        if best:
            results.append(best)
            print(f"[gridsearch] {name} best: {best}")

    fields = ["dataset", "g", "m", "C", "score", "metric", "time_s"]
    with open(args.out, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields)
        w.writeheader()
        w.writerows(results)
    full = args.out.replace(".csv", "_full.csv")
    with open(full, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields)
        w.writeheader()
        w.writerows(all_rows)
    print(f"wrote {args.out} ({len(results)} best rows) and "
          f"{full} ({len(all_rows)} sweep rows)")


if __name__ == "__main__":
    main()
