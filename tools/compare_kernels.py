#!/usr/bin/env python
"""Elementwise comparison of two saved kernels with a mismatch heatmap.

Parity with results/other_scripts/compare_kernels.py:14-56 (0.01 default
tolerance; heatmap of |K1 - K2| when they disagree).
"""

import argparse
import sys

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("kernel_a")
    ap.add_argument("kernel_b")
    ap.add_argument("--tol", type=float, default=0.01)
    ap.add_argument("--heatmap", metavar="PNG", help="write |A-B| heatmap")
    args = ap.parse_args(argv)

    sys.path.insert(0, __file__.rsplit("/", 2)[0])
    from fastsk_jax.io.fasta import load_kernel

    A = load_kernel(args.kernel_a)
    B = load_kernel(args.kernel_b)
    if A.shape != B.shape:
        print(f"shape mismatch: {A.shape} vs {B.shape}")
        return 1
    diff = np.abs(A - B)
    n_bad = int((diff > args.tol).sum())
    print(
        f"n={A.shape[0]} max|diff|={diff.max():.3e} "
        f"mean|diff|={diff.mean():.3e} entries>{args.tol}: {n_bad}"
    )
    if args.heatmap:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(5, 4))
        im = ax.imshow(diff, cmap="viridis")
        fig.colorbar(im)
        ax.set_title("|K_a - K_b|")
        fig.tight_layout()
        fig.savefig(args.heatmap, dpi=150)
    return 0 if n_bad == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
