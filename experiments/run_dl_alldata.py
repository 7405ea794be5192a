#!/usr/bin/env python
"""All-dataset DL baseline sweep — the run_cnn_allData.py analogue.

The reference trains its CharCNN over every dataset of the published
suite (results/neural_nets/run_cnn_allData.py) to fill the CharCNN/LSTM
columns of performance_results_summary.csv. This sweeps the full
registry (experiments/datasets.csv — the 27 published datasets) with the
flax CharCNN and LSTM, multi-seed, and writes one summary CSV with
mean/max AUC per (dataset, model).

Budget note (documented, deliberate): the reference used 5 seeds x
GPU-scale epochs; this sweep defaults to 2 seeds x 8 epochs, which
reproduces the published ORDERING (gkm-SVM >= CharCNN > LSTM on most
rows) at a fraction of the compute. Raise --seeds/--epochs for the
full-budget repro; per-dataset hypertuned runs live in
run_dl_hypertune.py.

    python experiments/run_dl_alldata.py [--models cnn lstm] [--seeds 2]
"""

from __future__ import annotations

import argparse
import csv
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

DATA = "/root/reference/data"
HERE = os.path.dirname(os.path.abspath(__file__))


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--models", nargs="*", default=["cnn", "lstm"])
    ap.add_argument("--seeds", type=int, default=2)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=64)
    # reference-recipe knobs (run_rnn.py: plain SGD lr 0.01, class-
    # weighted CE, -em 32 --hidden 64) for the targeted LSTM refresh
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--optimizer", default="adam", choices=["adam", "sgd", "adagrad"])
    ap.add_argument("--momentum", type=float, default=0.9,
                    help="sgd momentum; 0 = the reference's plain SGD")
    ap.add_argument("--class-weight", default=None,
                    choices=[None, "balanced"])
    ap.add_argument("--embed", type=int, default=None)
    ap.add_argument("--hidden", type=int, default=None)
    ap.add_argument("--bidir", action="store_true",
                    help="bidirectional LSTM (run_rnn.py --bidir)")
    ap.add_argument("--datasets", nargs="*", default=None)
    ap.add_argument("--force", action="store_true",
                    help="rerun selected rows even if present (e.g. a "
                         "higher-budget refresh; each row records its "
                         "own seeds/epochs)")
    ap.add_argument("--out", default=os.path.join(
        HERE, "results_dl", "alldata_dl_summary.csv"))
    args = ap.parse_args()

    from fastsk_jax.models.train import run_repeats

    with open(os.path.join(HERE, "datasets.csv")) as f:
        registry = list(csv.DictReader(f))
    if args.datasets:
        registry = [r for r in registry if r["Dataset"] in args.datasets]

    # merge with prior partial runs (keyed by dataset+model)
    done = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            for r in csv.DictReader(f):
                done[(r["dataset"], r["model"])] = r

    import numpy as np

    for reg in registry:
        ds = reg["Dataset"]
        tr = os.path.join(DATA, f"{ds}.train.fasta")
        te = os.path.join(DATA, f"{ds}.test.fasta")
        if not (os.path.exists(tr) and os.path.exists(te)):
            log(f"{ds}: fasta pair missing, skipped")
            continue
        for model in args.models:
            if (ds, model) in done and not args.force:
                continue
            t0 = time.perf_counter()
            try:
                rows = run_repeats(
                    model, tr, te, seeds=args.seeds,
                    epochs=args.epochs, batch_size=args.batch_size,
                    lr=args.lr, optimizer=args.optimizer,
                    momentum=args.momentum or None,
                    class_weight=args.class_weight,
                    embedding_size=args.embed, hidden_size=args.hidden,
                    bidir=args.bidir,
                )
            except Exception as e:
                log(f"{ds} {model}: ERROR {type(e).__name__}: {e}")
                done[(ds, model)] = dict(
                    dataset=ds, type=reg["type"], model=model,
                    seeds=args.seeds, epochs=args.epochs,
                    auc_mean="ERROR", auc_max="", acc_mean="", wall_s="",
                )
                continue
            aucs = [r["auc"] for r in rows]
            accs = [r["acc"] for r in rows]
            cfg = (f"{args.optimizer} lr={args.lr} bs={args.batch_size}"
                   f"{' bidir' if args.bidir else ''}"
                   f"{' cw=' + args.class_weight if args.class_weight else ''}")
            done[(ds, model)] = dict(
                dataset=ds, type=reg["type"], model=model,
                seeds=args.seeds, epochs=args.epochs, config=cfg,
                auc_mean=round(float(np.mean(aucs)), 6),
                auc_max=round(float(np.max(aucs)), 6),
                acc_mean=round(float(np.mean(accs)), 6),
                wall_s=round(time.perf_counter() - t0, 1),
            )
            log(f"{ds} {model}: auc mean {done[(ds, model)]['auc_mean']} "
                f"max {done[(ds, model)]['auc_max']} "
                f"({done[(ds, model)]['wall_s']}s)")
            # write after every cell so interrupts keep progress
            os.makedirs(os.path.dirname(args.out), exist_ok=True)
            keys = ["dataset", "type", "model", "seeds", "epochs",
                    "auc_mean", "auc_max", "acc_mean", "wall_s", "config"]
            with open(args.out, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=keys)
                w.writeheader()
                for key in sorted(done):
                    w.writerow(done[key])
    log(f"wrote {args.out}")


if __name__ == "__main__":
    main()
