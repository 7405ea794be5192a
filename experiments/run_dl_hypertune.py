#!/usr/bin/env python
"""DL hyperparameter-tuning sweep (cnn_hyperTrTune.py parity).

The reference tunes its CharCNN over optimizer x learning rate x
train-size (results/neural_nets/cnn_hyperTrTune.py:40-62: opt in
{sgd, adam}, lr in {1e-2, 3e-2, 8e-3}, trn_size in {0.2..1.0}) and
records per-config test acc/AUC. This driver runs the same family for
the flax models: a grid over optimizer x lr x batch size, multi-seed,
one CSV row per (config, seed) plus a best-config summary line.

    python experiments/run_dl_hypertune.py --dataset EP300 --model cnn \
        --epochs 5 --seeds 2
"""

from __future__ import annotations

import argparse
import csv
import itertools
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

DATA = "/root/reference/data"


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="EP300")
    ap.add_argument("--data", default=DATA)
    ap.add_argument("--model", choices=["cnn", "lstm"], default="cnn")
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--seeds", type=int, default=2)
    ap.add_argument(
        "--opts", nargs="*", default=["adam", "sgd"],
        help="optimizers (reference grid: sgd, adam)",
    )
    ap.add_argument(
        "--lrs", type=float, nargs="*",
        default=[1e-2, 3e-2, 8e-3, 1e-3],
        help="learning rates: the reference grid (cnn_hyperTrTune.py:60) "
             "plus 1e-3, the adam-scale point the sgd-oriented reference "
             "grid lacks",
    )
    ap.add_argument("--batches", type=int, nargs="*", default=[64, 128])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from fastsk_jax.models.train import train_model

    rows = []
    grid = list(itertools.product(args.opts, args.lrs, args.batches))
    for gi, (opt, lr, batch) in enumerate(grid):
        for seed in range(args.seeds):
            t0 = time.perf_counter()
            res = train_model(
                args.model,
                os.path.join(args.data, f"{args.dataset}.train.fasta"),
                os.path.join(args.data, f"{args.dataset}.test.fasta"),
                epochs=args.epochs,
                batch_size=batch,
                lr=lr,
                optimizer=opt,
                seed=seed,
            )
            row = dict(
                model=args.model, opt=opt, lr=lr, batch=batch, seed=seed,
                epochs=args.epochs, acc=round(res.acc, 4),
                auc=round(res.auc, 4),
                wall_s=round(time.perf_counter() - t0, 1),
            )
            rows.append(row)
            log(f"[{gi + 1}/{len(grid)}] {row}")

    out = args.out or (
        f"experiments/results_dl/{args.dataset}_{args.model}_hypertune.csv"
    )
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)

    import numpy as np

    best, best_auc = None, -1.0
    for opt, lr, batch in grid:
        sub = [
            r["auc"] for r in rows
            if (r["opt"], r["lr"], r["batch"]) == (opt, lr, batch)
        ]
        mean = float(np.mean(sub))
        if mean > best_auc:
            best, best_auc = (opt, lr, batch), mean
    print(
        f"best config for {args.dataset}/{args.model}: opt={best[0]} "
        f"lr={best[1]} batch={best[2]} mean_auc={best_auc:.4f}"
    )
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
