"""Full-corpus multiclass experiments on the shipped NLP sets.

webkb (4-class web text, documents up to 14k chars — admitted by the
sorted engine's int8 digit path) and sentiment (2-class, driven through
the same multiclass machinery as a degenerate case). For each corpus the
gapped k-mer kernel is computed once, then scored three ways:

  * kernel_ovo — our LIBSVM-style one-vs-one C-SVC on the precomputed
    kernel (svm/ovo.py, matching svm.cpp:2034-2358 grouping/voting)
  * linear_ovr — one-vs-rest linear SVC on the empirical kernel map
    (the reference's sklearn route for multiclass sets,
    test/utils.py:307-391)
  * sklearn_ovo — sklearn SVC(kernel="precomputed") (LIBSVM itself) as
    the parity oracle for kernel_ovo

Writes ``experiments/results_multiclass/multiclass.csv``.
"""

from __future__ import annotations

import argparse
import csv
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from fastsk_jax.api import FastSK
from fastsk_jax.io.fasta import FastaUtility

DATA = os.environ.get("FASTSK_DATA", "/root/reference/data")

SETS = [
    # name, train, test, g, m, C
    ("webkb", "webkb-train.fasta", "webkb-test.fasta", 7, 3, 1.0),
    ("sentiment", "sentiment.train.fasta", "sentiment.test.fasta", 7, 3, 1.0),
]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--only", default=None)
    ap.add_argument(
        "--out",
        default=os.path.join(
            os.path.dirname(__file__), "results_multiclass", "nlp_multiclass.csv"
        ),
    )
    args = ap.parse_args()

    rows = []
    for name, trf, tef, g, m, C in SETS:
        if args.only and name != args.only:
            continue
        reader = FastaUtility()
        Xtr, Ytr = reader.read_data(f"{DATA}/{trf}", multiclass=True)
        Xte, Yte = reader.read_data(f"{DATA}/{tef}", multiclass=True)
        Ytr, Yte = np.asarray(Ytr), np.asarray(Yte)
        print(
            f"{name}: ntr={len(Xtr)} nte={len(Xte)} "
            f"classes={sorted(set(Ytr.tolist()))} g={g} m={m}",
            flush=True,
        )
        fsk = FastSK(
            g=g, m=m, approx=True, max_iters=args.iters, skip_variance=True
        )
        t0 = time.perf_counter()
        fsk.compute_kernel(Xtr, Xte)
        kernel_s = time.perf_counter() - t0
        ntr = fsk.n_str_train
        K = fsk.kernel
        Ktr, Kte = K[:ntr, :ntr], K[ntr:, :ntr]
        print(f"{name}: kernel {kernel_s:.1f}s", flush=True)

        from fastsk_jax.svm.kernel_svm import KernelSVC

        t0 = time.perf_counter()
        clf = KernelSVC(C=C).fit(Ktr, Ytr)
        ovo_acc = float(np.mean(clf.predict(Kte) == Yte))
        ovo_s = time.perf_counter() - t0

        from fastsk_jax.svm.linear import MulticlassLinearSVC

        t0 = time.perf_counter()
        lin = MulticlassLinearSVC(C=C).fit(np.array(Ktr), Ytr)
        ovr_acc = float(lin.score(np.array(Kte), Yte))
        ovr_s = time.perf_counter() - t0

        try:
            from sklearn.svm import SVC

            sk = SVC(kernel="precomputed", C=C).fit(Ktr, Ytr)
            sk_acc = float(np.mean(sk.predict(Kte) == Yte))
        except Exception as e:  # pragma: no cover
            print(f"sklearn oracle unavailable: {e}")
            sk_acc = float("nan")

        rows.append(
            {
                "dataset": name,
                "n_train": ntr,
                "n_test": len(Xte),
                "classes": len(set(Ytr.tolist())),
                "g": g,
                "m": m,
                "I": args.iters,
                "C": C,
                "kernel_s": round(kernel_s, 1),
                "ovo_acc": round(ovo_acc, 4),
                "ovo_s": round(ovo_s, 1),
                "linear_ovr_acc": round(ovr_acc, 4),
                "linear_ovr_s": round(ovr_s, 1),
                "sklearn_ovo_acc": round(sk_acc, 4),
            }
        )
        print(rows[-1], flush=True)

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    exists = os.path.exists(args.out) and args.only
    mode = "a" if exists else "w"
    with open(args.out, mode, newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        if mode == "w":
            w.writeheader()
        w.writerows(rows)
    print(f"wrote {args.out}", flush=True)


if __name__ == "__main__":
    main()
