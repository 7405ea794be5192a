"""Sorted-engine approx throughput on AImed (VERDICT r1 item 9).

Measures the Monte-Carlo (skip_variance) stream of SortedGkmEngine on the
real AImed corpus (protein-text, g=11 m=4 per experiments/datasets.csv)
across theta_batch configurations (tb=1 streams one multi-word
lax.sort + slab count-matmuls per sampled theta; tb>1 runs a vmapped
batch per dispatch with a fused batch sum). tb=1 is the engine default;
which wins on a GPU is not measured yet.

All configs must produce bit-identical integer counts (same seed =>
same shuffled theta stream; int32 adds commute). Timing convention: the
first call includes compilation, the second is steady
state; steady wall is what the pass/s rate is computed from.

Writes ``experiments/results_sorted_approx/aimed_sorted_approx.csv``.

Reference semantics being accelerated: the per-iteration counting pass of
fastsk_kernel.cpp:108-143 (sample without replacement, partial kernel
accumulation) over shared.cpp:156-333's sort pipeline.
"""

from __future__ import annotations

import argparse
import csv
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from fastsk_jax.io.fasta import FastaUtility
from fastsk_jax.kernel.config import KernelConfig
from fastsk_jax.kernel.sorted_engine import SortedGkmEngine
from fastsk_jax.ops.encode import encode_sequences

DATA = os.environ.get("FASTSK_DATA", "/root/reference/data")


def timed_approx(eng: SortedGkmEngine, iters: int, seed: int):
    t0 = time.perf_counter()
    res = eng.approx(skip_variance=True, max_iters=iters, seed=seed)
    return time.perf_counter() - t0, res.counts


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="AImed")
    ap.add_argument("--g", type=int, default=11)
    ap.add_argument("--m", type=int, default=4)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument(
        "--sweep",
        default=None,
        help="comma list of theta_batch values to sweep instead of the "
        "default per-pass-vs-batched comparison",
    )
    ap.add_argument(
        "--out",
        default=os.path.join(
            os.path.dirname(__file__),
            "results_sorted_approx",
            "aimed_sorted_approx.csv",
        ),
    )
    args = ap.parse_args()

    reader = FastaUtility()
    Xtr, _ = reader.read_data(f"{DATA}/{args.dataset}.train.fasta")
    Xte, _ = reader.read_data(f"{DATA}/{args.dataset}.test.fasta")
    enc = encode_sequences(Xtr, Xte)
    print(
        f"{args.dataset}: n={enc.n} lmax={enc.max_len} base={enc.hash_base} "
        f"g={args.g} m={args.m} I={args.iters}",
        flush=True,
    )

    sweep = args.sweep or "1,4,8"
    configs = [(f"tb{v}", int(v)) for v in sweep.split(",")]
    rows = []
    counts = {}
    for label, tb in configs:
        eng = SortedGkmEngine(
            enc, args.g, args.m, KernelConfig(theta_batch=tb)
        )
        first, c1 = timed_approx(eng, args.iters, args.seed)
        steady, c2 = timed_approx(eng, args.iters, args.seed)
        assert np.array_equal(c1, c2), "non-deterministic counts"
        counts[label] = c1
        rows.append(
            {
                "config": label,
                "theta_batch": eng.theta_batch,
                "iters": args.iters,
                "first_s": round(first, 3),
                "steady_s": round(steady, 3),
                "passes_per_s": round(args.iters / steady, 3),
            }
        )
        print(rows[-1], flush=True)

    first_label = configs[0][0]
    for label, _ in configs[1:]:
        assert np.array_equal(
            counts[first_label], counts[label]
        ), f"{label} changed the integer counts"
    for r in rows:
        r["speedup_vs_first"] = round(rows[0]["steady_s"] / r["steady_s"], 3)
    print(
        f"steady speedup {rows[-1]['config']} vs {first_label}: "
        f"{rows[0]['steady_s'] / rows[-1]['steady_s']:.2f}x",
        flush=True,
    )

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
    print(f"wrote {args.out}", flush=True)


if __name__ == "__main__":
    main()
