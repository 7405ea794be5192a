#!/usr/bin/env python
"""AUC-parity validation against the reference's published results.

Runs the configurations from results/spreadsheets/performance_results_summary.csv
(quoted in BASELINE.md) through the published-numbers workflow (EKM +
calibrated linear SVM) and prints ours vs theirs. Used to produce
RESULTS.md.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# (dataset, g, m, C, published exact AUC, published approx-conv AUC)
PUBLISHED = [
    # (dataset, g, m, C, published exact AUC, published approx-conv AUC)
    # from results/spreadsheets/performance_results_summary.csv
    ("1.1", 8, 4, 0.01, 0.853097, 0.850143),
    ("1.34", 6, 2, 0.001, 1.0, 1.0),
    ("2.19", 8, 4, 0.01, 0.895062, 0.886309),
    ("2.31", 15, 10, 0.01, 0.999791, 0.998011),
    ("2.34", 6, 0, 10.0, 0.971297, 0.971297),
    ("2.41", 10, 6, 100.0, 0.920995, 0.865897),
    ("2.8", 12, 8, 100.0, 0.886170, 0.870735),
    ("3.19", 9, 2, 0.001, 0.988975, 0.660207),
    ("3.25", 15, 9, 100.0, 0.962927, 0.890481),
    ("3.33", 5, 1, 1.0, 0.995590, 0.995590),
    ("CTCF", 13, 7, 1.0, 0.969578, 0.969645),
    ("EP300", 10, 4, 1.0, 0.990724, 0.990707),
    ("EP300_47848", 11, 5, 1.0, 0.953283, 0.952817),
    ("JUND", 10, 3, 1.0, 0.968722, 0.967836),
    ("KAT2B", 13, 7, 1.0, 0.921632, 0.921437),
    ("Pbde", 5, 1, 0.001, 0.834853, 0.834853),
    ("RAD21", 14, 8, 100.0, 0.974168, 0.974141),
    ("SIN3A", 8, 2, 1.0, 0.911383, 0.911383),
    ("TP53", 7, 2, 0.1, 0.823993, 0.823993),
    ("ZZZ3", 10, 4, 0.1, 0.962853, 0.962860),
    ("AImed", 11, 4, 100.0, 0.716697, 0.713640),
    ("BioInfer", 5, 4, 10.0, 0.713228, 0.712796),
    ("CC1-LLL", 5, 2, 0.001, 0.681164, 0.681164),
    ("CC2-IEPA", 5, 3, 0.001, 0.711200, 0.711197),
    ("CC3-HPRD50", 7, 4, 0.001, 0.647285, 0.647285),
    ("DrugBank", 10, 2, 10.0, 0.998594, 0.620121),
    ("MedLine", 5, 2, 1.0, 0.722526, 0.723046),
]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--datasets", nargs="*", default=None)
    ap.add_argument("--mode", choices=["exact", "approx", "both"], default="both")
    ap.add_argument("--out", default="parity_results.json")
    args = ap.parse_args(argv)

    from fastsk_jax.harness import FastskRunner

    rows = []
    for name, g, m, C, pub_exact, pub_approx in PUBLISHED:
        if args.datasets and name not in args.datasets:
            continue
        print(f"[parity] {name} g={g} m={m} C={C}", flush=True)
        runner = FastskRunner(name)
        entry = {"dataset": name, "g": g, "m": m, "C": C,
                 "published_exact": pub_exact, "published_approx": pub_approx}
        if args.mode in ("exact", "both"):
            t0 = time.time()
            res = runner.train_and_test(g=g, m=m, approx=False, C=C)
            entry["exact_auc"] = round(res["auc"], 6)
            entry["exact_acc"] = round(res["acc"], 6)
            entry["exact_time_s"] = round(time.time() - t0, 2)
            print(f"  exact: auc={res['auc']:.6f} (published {pub_exact}) "
                  f"in {entry['exact_time_s']}s", flush=True)
        if args.mode in ("approx", "both"):
            t0 = time.time()
            res = runner.train_and_test(g=g, m=m, approx=True, C=C)
            entry["approx_auc"] = round(res["auc"], 6)
            entry["approx_iters"] = res["iters"]
            entry["approx_time_s"] = round(time.time() - t0, 2)
            print(f"  approx: auc={res['auc']:.6f} iters={res['iters']} "
                  f"(published {pub_approx}) in {entry['approx_time_s']}s",
                  flush=True)
        rows.append(entry)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=2)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
