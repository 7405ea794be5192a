"""Full-dataset parity gates (FASTSK_RUN_SLOW=1; minutes each).

Expected values are the reference's published numbers
(results/spreadsheets/performance_results_summary.csv) — the exact rows
reproduce to ~1e-6 because the kernels are bit-identical and the SVM
workflow matches sklearn's to machine precision (see experiments/results_tables/).
"""

import pytest

from fastsk_jax.harness import FastskRunner

pytestmark = pytest.mark.slow


def test_ep300_exact_auc_matches_published():
    res = FastskRunner("EP300").train_and_test(g=10, m=4, C=1.0)
    assert res["auc"] == pytest.approx(0.990724, abs=1e-6)
    assert res["acc"] == pytest.approx(0.9525, abs=1e-6)


def test_ctcf_exact_auc_matches_published():
    res = FastskRunner("CTCF").train_and_test(g=13, m=7, C=1.0)
    assert res["auc"] == pytest.approx(0.969578, abs=1e-6)


def test_protein_2_31_exact_auc_matches_published():
    res = FastskRunner("2.31").train_and_test(g=15, m=10, C=0.01)
    assert res["auc"] == pytest.approx(0.999791, abs=1e-5)


def test_ep300_47848_exact_close_to_published():
    res = FastskRunner("EP300_47848").train_and_test(g=11, m=5, C=1.0)
    assert abs(res["auc"] - 0.953283) < 1e-3
