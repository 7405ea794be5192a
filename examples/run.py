#!/usr/bin/env python
"""End-to-end example: gkm kernel + calibrated linear SVM on a dataset pair.

The equivalent of the reference's examples/run.py: choose train/test fasta
files, compute the kernel (exact or approx), train the published-workflow
classifier, report accuracy and AUC.

    python examples/run.py --trn data/EP300.train.fasta \
        --tst data/EP300.test.fasta -g 10 -m 6 -a
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--trn", required=True, help="training fasta")
    ap.add_argument("--tst", required=True, help="test fasta")
    ap.add_argument("-g", type=int, default=10)
    ap.add_argument("-m", type=int, default=6)
    ap.add_argument("-C", type=float, default=1.0)
    ap.add_argument("-a", "--approx", action="store_true")
    ap.add_argument("-I", "--max-iters", type=int, default=-1)
    ap.add_argument("--delta", type=float, default=0.025)
    args = ap.parse_args(argv)

    from fastsk_jax import FastSK, FastaUtility
    from fastsk_jax.metrics import roc_auc
    from fastsk_jax.svm.linear import CalibratedLinearSVC

    reader = FastaUtility()
    Xtrain, Ytrain = reader.read_data(args.trn)
    Xtest, Ytest = reader.read_data(args.tst)

    t0 = time.time()
    fastsk = FastSK(
        g=args.g, m=args.m, approx=args.approx,
        max_iters=args.max_iters, delta=args.delta,
    )
    fastsk.compute_kernel(Xtrain, Xtest, Ytrain, Ytest)
    print(f"kernel computed in {time.time() - t0:.2f} s")

    Xtr = np.array(fastsk.get_train_kernel())
    Xte = np.array(fastsk.get_test_kernel())
    clf = CalibratedLinearSVC(C=args.C, class_weight="balanced").fit(Xtr, Ytrain)
    acc = clf.score(Xte, Ytest)
    auc = roc_auc(Ytest, clf.predict_proba(Xte)[:, 1])
    print(f"accuracy: {acc:.4f}  AUC: {auc:.6f}")


if __name__ == "__main__":
    main()
