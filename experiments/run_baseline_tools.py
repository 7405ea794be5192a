#!/usr/bin/env python
"""Real third-party oracle runs: gkmSVM-2.0 and LSGKM, built from the
sources the reference vendors (results/baselines/*.tar.gz|zip), vs ours.

The reference's correctness-and-speed story leans on these comparisons
(test/utils.py:448-619, results/run_gkm.py, run_lsgkm.py); through round
3 our runners were only stub-tested because no binaries existed in the
environment. This driver builds nothing (see tools/baselines/README.md
for the build), drives the compiled tools through the same
harness.baselines runners CI stubs, and measures:

  - gkmSVM-2.0: gkmsvm_kernel wall (the kernel-timing comparison of the
    paper's Figure 5 family) + end-to-end AUC via train+classify;
  - LSGKM: gkmtrain wall + AUC via gkmpredict;
  - ours: device-resident exact kernel wall + SMO fit + AUC on the
    same dataset/params (on the accelerator JAX finds; theirs is CPU —
    that hardware gap IS the comparison, matching BASELINE.md's framing).

Outputs experiments/results_baselines/oracle_comparison.csv.

GaKCo is NOT runnable here: its source is not vendored in the reference
(only gkmsvm-2.0.tar.gz, lsgkm.zip, and the JVM String_Kernels_Package,
which needs a java runtime this image lacks) and the environment has no
network. The GaKCo/Blended runners stay stub-validated.
"""

from __future__ import annotations

import argparse
import csv
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)) + "/..")

from fastsk_jax.harness.baselines import (  # noqa: E402
    BaselineNotInstalled,
    GkmRunner,
    LsgkmRunner,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = "/root/reference/data"
GKM_BIN = os.path.join(REPO, "tools", "baselines", "gkmsvm")
# protein needs a separate gkmSVM-2.0 build: MAX_ALPHABET_SIZE 24 +
# NBITS 5 (global.h:26-28) + the -A dictionary flag — exactly the
# recompile the reference prescribes (results/run_experiments.py:314-322)
GKM_PROT_BIN = os.path.join(REPO, "tools", "baselines", "gkmsvm-prot")
PROT_DICT = os.path.join(DATA, "protein.dictionary.txt")
LSGKM_BIN = os.path.join(REPO, "tools", "baselines", "lsgkm-master", "bin")
OUTDIR = os.path.join(REPO, "experiments", "results_baselines")

# dataset, g, m, tuned C, is_protein — the reference's per-dataset
# params (results/spreadsheets/performance_results_summary.csv rows)
CONFIGS = [
    ("EP300", 10, 4, 1.0, False),
    ("KAT2B", 8, 4, 1.0, False),
    ("EP300_47848", 11, 5, 1.0, False),
    # protein: the reference's published gkm failure case — gkm AUC
    # 0.272 on 1.1 (performance_results_summary.csv:2) vs fastsk ~0.85
    ("1.1", 8, 4, 0.01, True),
]


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def run_ours(dataset, g, m, C):
    import jax

    from fastsk_jax import FastSK, FastaUtility
    from fastsk_jax.kernel.config import KernelConfig

    reader = FastaUtility()
    xtr, ytr = reader.read_data(f"{DATA}/{dataset}.train.fasta")
    xte, yte = reader.read_data(f"{DATA}/{dataset}.test.fasta")
    fsk = FastSK(g, m, config=KernelConfig(device_resident=True))
    t0 = time.perf_counter()
    fsk.compute_kernel(xtr, xte, ytr, yte)
    np.asarray(fsk._counts_dev.lo[:1, :1])
    t_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    fsk.compute_kernel(xtr, xte, ytr, yte)
    np.asarray(fsk._counts_dev.lo[:1, :1])
    t_kernel = time.perf_counter() - t0
    t0 = time.perf_counter()
    fsk.fit(C=C, kernel_type="linear")
    auc = fsk.score("auc")
    t_fit_score = time.perf_counter() - t0
    return dict(
        ours_kernel_steady_s=round(t_kernel, 3),
        ours_kernel_cold_s=round(t_cold, 2),
        ours_fit_score_s=round(t_fit_score, 2),
        ours_auc=round(auc, 6),
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--timeout", type=float, default=1800.0,
                    help="per-tool-stage timeout (reference skip-at-1800s)")
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--skip-ours", action="store_true")
    ap.add_argument("--skip-tools", action="store_true",
                    help="only (re)measure the ours columns; the "
                         "column-wise CSV merge keeps prior tool rows")
    ap.add_argument("--datasets", nargs="*", default=None)
    args = ap.parse_args()
    os.makedirs(OUTDIR, exist_ok=True)
    tmp = os.path.join(OUTDIR, "tmp")
    os.makedirs(tmp, exist_ok=True)

    rows = []
    for dataset, g, m, C, is_prot in CONFIGS:
        if args.datasets and dataset not in args.datasets:
            continue
        k = g - m
        row = dict(dataset=dataset, g=g, m=m, k=k, C=C,
                   threads=args.threads)
        log(f"=== {dataset} g={g} m={m} (k={k}) ===")

        # ---- gkmSVM-2.0 (exact: -d = g truncation disabled)
        gkm = GkmRunner(GKM_PROT_BIN if is_prot else GKM_BIN, tmp,
                        dataset, g, k, approx=False,
                        alphabet=PROT_DICT if is_prot else None,
                        outdir=tmp, timeout=args.timeout)
        try:
            if args.skip_tools:
                raise BaselineNotInstalled("--skip-tools")
            gkm.ensure_split_data(f"{DATA}/{dataset}.train.fasta",
                                  f"{DATA}/{dataset}.test.fasta")
            t0 = time.perf_counter()
            gkm.compute_train_kernel(t=args.threads)
            row["gkm_kernel_s"] = round(time.perf_counter() - t0, 2)
            t0 = time.perf_counter()
            gkm.train_svm()
            gkm.classify()
            acc, auc = gkm.evaluate()
            row["gkm_train_classify_s"] = round(time.perf_counter() - t0, 2)
            row["gkm_auc"] = round(auc, 6)
            log(f"gkmSVM-2.0: kernel {row['gkm_kernel_s']}s "
                f"AUC {auc:.4f}")
        except subprocess.TimeoutExpired:
            row["gkm_kernel_s"] = f">={args.timeout}"
            row["gkm_auc"] = "TIMEOUT"
            log("gkmSVM-2.0: TIMEOUT")
        except (BaselineNotInstalled, subprocess.CalledProcessError) as e:
            if str(e) != "--skip-tools":
                row["gkm_auc"] = f"ERROR:{type(e).__name__}"
                log(f"gkmSVM-2.0: {e}")

        # ---- LSGKM (gkm_full kernel, t=2 per run_lsgkm.py)
        ls = LsgkmRunner(LSGKM_BIN, tmp, dataset, g, m, outdir=tmp,
                         timeout=args.timeout)
        try:
            if is_prot:
                # LSGKM hardcodes the ACGT alphabet (lsgkm
                # src/libsvm_gkm.c seq2bid); the reference only ever
                # ran it on DNA (results/run_lsgkm.py)
                row["lsgkm_auc"] = "n/a (DNA-only tool)"
                raise BaselineNotInstalled("--skip-tools")
            if args.skip_tools:
                raise BaselineNotInstalled("--skip-tools")
            t0 = time.perf_counter()
            ls.train(t=args.threads)
            row["lsgkm_train_s"] = round(time.perf_counter() - t0, 2)
            ls.predict(t=args.threads)
        except subprocess.TimeoutExpired:
            row["lsgkm_train_s"] = f">={args.timeout}"
            row["lsgkm_auc"] = "TIMEOUT"
            log("LSGKM: TIMEOUT")
        except (BaselineNotInstalled, subprocess.CalledProcessError) as e:
            if str(e) != "--skip-tools":
                row["lsgkm_auc"] = f"ERROR:{type(e).__name__}"
                log(f"LSGKM: {e}")
        else:
            from fastsk_jax.harness.baselines import (
                _acc_auc,
                _read_pred_scores,
            )

            acc, auc = _acc_auc(
                _read_pred_scores(ls.pos_pred_file),
                _read_pred_scores(ls.neg_pred_file),
            )
            row["lsgkm_auc"] = round(auc, 6)
            log(f"LSGKM: train {row['lsgkm_train_s']}s AUC {auc:.4f}")

        # ---- ours
        if not args.skip_ours:
            try:
                row.update(run_ours(dataset, g, m, C))
                log(f"ours: kernel {row['ours_kernel_steady_s']}s steady, "
                    f"AUC {row['ours_auc']}")
            except Exception as e:  # report, keep the tool rows
                row["ours_auc"] = f"ERROR:{type(e).__name__}"
                log(f"ours: {e}")
            if isinstance(row.get("gkm_kernel_s"), (int, float)) and isinstance(
                row.get("ours_kernel_steady_s"), (int, float)
            ):
                row["kernel_speedup_vs_gkm"] = round(
                    row["gkm_kernel_s"] / row["ours_kernel_steady_s"], 1
                )
        rows.append(row)

    # merge with prior rows (keyed by dataset, column-wise) so partial
    # reruns (--datasets X, --skip-ours / ours-only passes) refresh only
    # the columns they actually measured
    path = os.path.join(OUTDIR, "oracle_comparison.csv")
    merged: dict = {}
    if os.path.exists(path):
        with open(path, newline="") as f:
            for r in csv.DictReader(f):
                merged[r["dataset"]] = r
    for r in rows:
        prev = merged.get(r["dataset"], {})
        merged[r["dataset"]] = {
            **prev,
            **{k: v for k, v in r.items() if v not in ("", None)},
        }
    for r in merged.values():
        # drop any prior speedup first: if the recompute fails (e.g. a
        # ">=1800" timeout wall) the row must carry NO value rather than
        # a stale one computed from an older ours wall (ADVICE r4)
        r.pop("kernel_speedup_vs_gkm", None)
        try:
            r["kernel_speedup_vs_gkm"] = round(
                float(r["gkm_kernel_s"]) / float(r["ours_kernel_steady_s"]),
                1,
            )
        except (KeyError, TypeError, ValueError):
            pass
    keys = []
    for r in merged.values():
        for c in r:
            if c not in keys:
                keys.append(c)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        w.writerows(merged.values())
    log(f"wrote {path}")


if __name__ == "__main__":
    main()
