#!/usr/bin/env python
"""Full-dataset bit-parity check against the compiled reference C++ engine.

Builds the unmodified reference kernel engine (shared.cpp +
fastsk_kernel.cpp via build.sh), dumps its exact normalized kernel for a
dataset, computes ours through the public FastSK API, and compares every
float64 entry for exact equality. Optionally reproduces the end-to-end AUC
with the published pipeline (sklearn LinearSVC + CalibratedClassifierCV on
kernel rows, test/utils.py:393-445) on BOTH kernels, so a published-CSV
discrepancy can be attributed to one side.

Examples:
    python run_reference_parity.py --dataset BioInfer --g 5 --m 4 --auc --C 10
    python run_reference_parity.py --dataset 2.19 --g 8 --m 4 --slice 60 30
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

import numpy as np

sys.path.insert(
    0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")
)

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = "/root/reference/data"


def build() -> str:
    binary = os.path.join(HERE, "dump_kernel")
    if not os.path.exists(binary):
        subprocess.run(["sh", os.path.join(HERE, "build.sh")], check=True)
    return binary


def slice_fasta(src: str, dst: str, n: int) -> None:
    with open(src) as f, open(dst, "w") as out:
        count = 0
        for line in f:
            if line.startswith(">") or ">" in line.split()[0][:8]:
                # label lines in the NLP sets can read "0>1" etc.
                if count >= n:
                    break
                count += 1
            out.write(line)


def dump_reference(binary, train, test, g, m) -> np.ndarray:
    res = subprocess.run(
        [binary, train, test, str(g), str(m)],
        check=True,
        capture_output=True,
        text=True,
    )
    lines = res.stdout.strip().splitlines()
    # skip the engine's progress chatter; the header line is "n=<N> dict=<D>"
    start = next(i for i, ln in enumerate(lines) if ln.startswith("n="))
    lines = lines[start:]
    n = int(lines[0].split()[0].split("=")[1])
    k = np.zeros((n, n), dtype=np.float64)
    for i, line in enumerate(lines[1 : n + 1]):
        vals = [float(v) for v in line.split()]
        k[i, : i + 1] = vals
        k[: i + 1, i] = vals
    return k


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--g", type=int, required=True)
    ap.add_argument("--m", type=int, required=True)
    ap.add_argument("--C", type=float, default=1.0)
    ap.add_argument("--slice", type=int, nargs=2, metavar=("NTRAIN", "NTEST"),
                    help="only the first NTRAIN/NTEST sequences")
    ap.add_argument("--auc", action="store_true",
                    help="also reproduce the published-pipeline AUC on both kernels")
    ap.add_argument("--cpu", action="store_true",
                    help="run our engine on CPU (leave the accelerator free)")
    args = ap.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    binary = build()
    train = f"{DATA}/{args.dataset}.train.fasta"
    test = f"{DATA}/{args.dataset}.test.fasta"
    tmpdir = None
    if args.slice:
        tmpdir = tempfile.mkdtemp()
        tr2 = os.path.join(tmpdir, "train.fasta")
        te2 = os.path.join(tmpdir, "test.fasta")
        slice_fasta(train, tr2, args.slice[0])
        slice_fasta(test, te2, args.slice[1])
        train, test = tr2, te2

    print(f"reference dump: {args.dataset} g={args.g} m={args.m} ...",
          flush=True)
    k_ref = dump_reference(binary, train, test, args.g, args.m)
    print(f"  reference kernel {k_ref.shape}")

    from fastsk_jax import FastSK, FastaUtility

    reader = FastaUtility()
    Xtr, Ytr = reader.read_data(train)
    Xte, Yte = reader.read_data(test)
    fsk = FastSK(g=args.g, m=args.m)
    fsk.compute_kernel(Xtr, Xte, Ytr, Yte)
    k_ours = fsk.kernel
    assert k_ours.shape == k_ref.shape, (k_ours.shape, k_ref.shape)

    bitexact = np.array_equal(k_ours, k_ref)
    maxdiff = float(np.abs(k_ours - k_ref).max())
    print(f"bit-exact: {bitexact}   max |diff|: {maxdiff:.3e}")

    if args.auc:
        from fastsk_jax.svm.linear import train_eval_linear

        ntr = len(Xtr)
        for name, kmat in (("reference", k_ref), ("ours", k_ours)):
            res = train_eval_linear(
                kmat[:ntr, :ntr], kmat[ntr:, :ntr],
                np.asarray(Ytr), np.asarray(Yte), C=args.C,
            )
            print(f"{name} kernel -> published pipeline: "
                  f"acc={res['acc']:.6f} auc={res['auc']:.6f}")

    return 0 if bitexact else 1


if __name__ == "__main__":
    raise SystemExit(main())
