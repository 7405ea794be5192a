#!/usr/bin/env python
"""Validate a saved kernel: symmetric, unit diagonal, PSD-ish.

Parity with results/other_scripts/check_symmetry.py:19-47 (np.allclose of
K against K.T), with extra invariants the gkm kernel must satisfy.
"""

import argparse
import sys

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("kernel_file")
    ap.add_argument("--tol", type=float, default=1e-8)
    args = ap.parse_args(argv)

    sys.path.insert(0, __file__.rsplit("/", 2)[0])
    from fastsk_jax.io.fasta import load_kernel

    K = load_kernel(args.kernel_file)
    ok = True
    if not np.allclose(K, K.T, atol=args.tol):
        print(f"NOT symmetric (max |K - K^T| = {np.abs(K - K.T).max():.3e})")
        ok = False
    if not np.allclose(np.diag(K), 1.0, atol=args.tol):
        print(f"diagonal not 1 (max dev {np.abs(np.diag(K) - 1).max():.3e})")
        ok = False
    eig_min = float(np.linalg.eigvalsh(K).min())
    if eig_min < -1e-6 * len(K):
        print(f"not PSD (min eigenvalue {eig_min:.3e})")
        ok = False
    print("OK" if ok else "FAILED", f"(n={len(K)}, min eig {eig_min:.3e})")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
