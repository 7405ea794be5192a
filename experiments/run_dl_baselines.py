#!/usr/bin/env python
"""CharCNN / LSTM baseline runner (results/neural_nets/run_cnn.py,
run_rnn.py parity): multi-seed repeats and train-size fractions, CSV out.

    python experiments/run_dl_baselines.py --dataset EP300 --model cnn \
        --epochs 10 --seeds 5 --fractions 0.25 0.5 1.0
"""

from __future__ import annotations

import argparse
import csv
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="EP300")
    ap.add_argument("--data", default="/root/reference/data")
    ap.add_argument("--model", choices=["cnn", "lstm"], default="cnn")
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--fractions", type=float, nargs="*", default=[1.0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from fastsk_jax.models.train import run_repeats

    rows = run_repeats(
        args.model,
        os.path.join(args.data, f"{args.dataset}.train.fasta"),
        os.path.join(args.data, f"{args.dataset}.test.fasta"),
        seeds=args.seeds,
        train_fractions=tuple(args.fractions),
        epochs=args.epochs,
        batch_size=args.batch_size,
        lr=args.lr,
    )
    out = args.out or f"{args.dataset}_{args.model}_baseline.csv"
    with open(out, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    import numpy as np

    for frac in args.fractions:
        sub = [r for r in rows if r["fraction"] == frac]
        print(
            f"fraction={frac}: auc {np.mean([r['auc'] for r in sub]):.4f} "
            f"+- {np.std([r['auc'] for r in sub]):.4f} over {len(sub)} seeds"
        )
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
