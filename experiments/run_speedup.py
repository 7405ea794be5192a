#!/usr/bin/env python
"""Per-dataset kernel speedup vs the reference C++ engine (single thread).

For each dataset/config: time a few reference skip-variance passes with
the compiled unmodified reference engine (tools/reference_oracle/
bench_main) and extrapolate to the full C(g, m) exact pass count (the
BASELINE_MEASURED.json protocol), then time our exact kernel steady-state
(compile excluded). Writes ``<out>_speedup.csv`` for plot.py's speedup
barchart.

    python run_speedup.py --out results_speedup/suite_speedup.csv
"""

from __future__ import annotations

import argparse
import csv
import math
import os
import re
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

ORACLE = os.path.join(os.path.dirname(__file__), "..", "tools", "reference_oracle")
DATA = "/root/reference/data"

# dataset, g, m (tuned params from performance_results_summary.csv)
SUITE = [
    ("EP300", 10, 4),
    ("EP300_47848", 11, 5),
    ("CTCF", 13, 7),
    ("ZZZ3", 10, 4),
    ("1.1", 8, 4),
    ("2.19", 8, 4),
    ("2.31", 15, 5),
    ("AImed", 11, 4),
    ("CC1-LLL", 5, 2),
]


def reference_per_pass(train, test, g, m, passes=3) -> float:
    binary = os.path.join(ORACLE, "bench_main")
    if not os.path.exists(binary):
        subprocess.run(["sh", os.path.join(ORACLE, "build.sh")], check=True)
    res = subprocess.run(
        [binary, train, test, str(g), str(m), str(passes)],
        check=True, capture_output=True, text=True, timeout=3600,
    )
    m_ = re.search(r"per_pass=([0-9.]+)", res.stdout)
    return float(m_.group(1))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--out",
        default=os.path.join(
            os.path.dirname(os.path.abspath(__file__)),
            "results_speedup", "suite_speedup.csv",
        ),  # anchored to the script, not the caller's cwd
    )
    ap.add_argument("--datasets", nargs="*", help="subset of suite names")
    ap.add_argument("--ref-passes", type=int, default=3)
    args = ap.parse_args()

    from fastsk_jax.harness import time_fastsk

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    rows = []
    suite = [s for s in SUITE if not args.datasets or s[0] in args.datasets]
    with open(args.out, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=[
            "dataset", "g", "m", "passes", "ref_per_pass_s",
            "ref_exact_s", "ours_steady_s", "speedup",
        ])
        w.writeheader()
        for name, g, m in suite:
            train = f"{DATA}/{name}.train.fasta"
            test = f"{DATA}/{name}.test.fasta"
            n_pass = math.comb(g, m)
            print(f"{name} g={g} m={m} ({n_pass} passes): reference...",
                  flush=True)
            per_pass = reference_per_pass(train, test, g, m, args.ref_passes)
            ref_total = per_pass * n_pass
            print(f"  ref {per_pass:.3f} s/pass -> {ref_total:.1f} s; ours...",
                  flush=True)
            first, steady, killed = time_fastsk(
                g=g, m=m, prefix=name, detail=True, steady_runs=3
            )
            row = dict(
                dataset=name, g=g, m=m, passes=n_pass,
                ref_per_pass_s=round(per_pass, 4),
                ref_exact_s=round(ref_total, 1),
                ours_steady_s=round(steady, 3),
                speedup=round(ref_total / steady, 1),
            )
            rows.append(row)
            w.writerow(row)
            f.flush()
            print(f"  ours {steady:.2f} s -> {row['speedup']}x", flush=True)
    print(f"wrote {args.out} ({len(rows)} rows)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
