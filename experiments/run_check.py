#!/usr/bin/env python
"""The de-facto CI gate, same as the reference's test/run_check.py:45-64:
EP300, g=10 m=6, approx mode, calibrated linear SVM on the EKM,
assert AUC >= 0.9.
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    from fastsk_jax.harness import FastskRunner

    t0 = time.time()
    runner = FastskRunner("EP300")
    res = runner.train_and_test(g=10, m=6, approx=True, C=1.0)
    print(
        f"EP300 g=10 m=6 approx: acc={res['acc']:.4f} auc={res['auc']:.6f} "
        f"iters={res['iters']} ({time.time() - t0:.1f} s)"
    )
    assert res["auc"] >= 0.9, f"AUC {res['auc']} below the 0.9 gate"
    print("PASS")


if __name__ == "__main__":
    main()
