"""Runner library, Lasso regression, extra readers, extended metrics."""

import numpy as np
import pytest

from fastsk_jax.io.readers import ArabicUtility, DslUtility
from fastsk_jax.metrics import (
    average_precision,
    balanced_accuracy,
    binary_class_cross_validation,
)
from fastsk_jax.svm.lasso import Lasso, LassoCV

from conftest import random_ragged_seqs


def test_lasso_matches_sklearn(rng):
    from sklearn.linear_model import Lasso as SkLasso

    X = rng.normal(size=(60, 12))
    w_true = np.zeros(12)
    w_true[[1, 4, 7]] = [2.0, -1.5, 0.7]
    y = X @ w_true + 0.05 * rng.normal(size=60) + 0.3
    for alpha in (0.01, 0.1):
        ours = Lasso(alpha=alpha, max_iter=20000, tol=1e-8).fit(X, y)
        sk = SkLasso(alpha=alpha, max_iter=100000, tol=1e-10).fit(X, y)
        np.testing.assert_allclose(ours.coef_, sk.coef_, atol=2e-3)
        np.testing.assert_allclose(ours.intercept_, sk.intercept_, atol=2e-3)


def test_lasso_cv_recovers_signal(rng):
    X = rng.normal(size=(80, 20))
    y = 3.0 * X[:, 2] - 2.0 * X[:, 11] + 0.1 * rng.normal(size=80)
    model = LassoCV(cv=5, n_alphas=20).fit(X, y)
    Xte = rng.normal(size=(40, 20))
    yte = 3.0 * Xte[:, 2] - 2.0 * Xte[:, 11] + 0.1 * rng.normal(size=40)
    assert model.score(Xte, yte) > 0.95


def test_arabic_reader(tmp_path):
    p = tmp_path / "arabic.tsv"
    p.write_text(
        "abcdefghijk\tMSA\n"
        "zzzzzzzzzzzz\tCAI\n"
        "shortie\tMSA\n"  # < 10 chars: dropped
        "abcdefghijk\tXXX\n"  # not a kept dialect: dropped
    )
    X, Y = ArabicUtility().read_data(str(p))
    assert len(X) == 2
    assert Y == [1, 2]  # dense class ids starting at 1


def test_dsl_reader(tmp_path):
    p = tmp_path / "dsl.tsv"
    p.write_text("abcdefghijk\tlang-a\nqrstuvwxyzab\tlang-b\nabcabcabcabc\tlang-a\n")
    X, Y = DslUtility().read_data(str(p))
    assert len(X) == 3
    assert Y == [1, 2, 1]


def test_bac_and_ap():
    y = np.array([1, 1, 1, 0, 0, 0])
    pred = np.array([1, 1, 0, 0, 0, 1])
    assert balanced_accuracy(y, pred) == pytest.approx((2 / 3 + 2 / 3) / 2)
    scores = np.array([0.9, 0.8, 0.4, 0.3, 0.2, 0.6])
    from sklearn.metrics import average_precision_score

    assert average_precision(y, scores) == pytest.approx(
        average_precision_score(y, scores)
    )


def test_binary_cross_validation(rng):
    n = 60
    X = rng.normal(size=(n, 5))
    y = (X[:, 0] + 0.3 * rng.normal(size=n) > 0).astype(int)
    gram = X @ X.T
    out = binary_class_cross_validation(gram, y, n_folds=5, C=1.0)
    assert out["auc"] > 0.9
    assert 0.7 < out["accuracy"] <= 1.0
    assert set(out) >= {"auc", "accuracy", "bac", "ap", "precision", "recall", "f1"}


def test_fastsk_runner_on_reference_slice(tmp_path, rng):
    """FastskRunner end to end on a synthetic fasta pair in the reference
    format (balanced labels, motif signal)."""
    from test_integration import make_synthetic_motif_data
    from test_cli_persistence import _write_fasta

    Xtr, Ytr = make_synthetic_motif_data(rng, 30, 30)
    Xte, Yte = make_synthetic_motif_data(rng, 12, 30)
    _write_fasta(tmp_path / "syn.train.fasta", Xtr, Ytr)
    _write_fasta(tmp_path / "syn.test.fasta", Xte, Yte)

    from fastsk_jax.harness import FastskRunner

    runner = FastskRunner("syn", data_locations=(str(tmp_path),))
    res = runner.train_and_test(g=6, m=2, C=1.0)
    assert res["auc"] > 0.9


def test_fastsk_regressor(tmp_path, rng):
    """Regression path: float labels -> kernel -> LassoCV -> r^2."""
    import test_integration as ti

    X, _ = ti.make_synthetic_motif_data(rng, 40, 26)
    # construct labels correlated with motif-kernel structure: y = row sums
    # of the exact kernel (a smooth function of sequence content)
    from fastsk_jax import FastSK

    fsk = FastSK(g=6, m=2)
    fsk.compute_train(X)
    yfull = np.asarray(fsk.kernel).sum(axis=1)
    with open(tmp_path / "reg.train.fasta", "w") as f:
        for seq, label in zip(X[:60], yfull[:60]):
            f.write(f">{label}\n" + "".join("acgt"[v - 1] for v in seq) + "\n")
    with open(tmp_path / "reg.test.fasta", "w") as f:
        for seq, label in zip(X[60:], yfull[60:]):
            f.write(f">{label}\n" + "".join("acgt"[v - 1] for v in seq) + "\n")

    from fastsk_jax.harness import FastskRegressor

    reg = FastskRegressor("reg", data_locations=(str(tmp_path),))
    r2 = reg.train_and_test(g=6, m=2, approx=False)
    assert r2 > 0.8


def test_multiclass_linear_svc(rng):
    from fastsk_jax.svm.linear import MulticlassLinearSVC

    n, d = 160, 6
    y = rng.integers(0, 4, n)
    centers = rng.normal(size=(4, d)) * 3
    X = centers[y] + rng.normal(size=(n, d))
    m = MulticlassLinearSVC(C=1.0).fit(X, y)
    Xt = centers[y] + rng.normal(size=(n, d))
    assert m.score(Xt, y) > 0.9
    assert m.decision_function(Xt).shape == (n, 4)


def test_score_report(rng):
    import test_integration as ti
    from fastsk_jax import FastSK

    Xtr, Ytr = ti.make_synthetic_motif_data(rng, 25, 24)
    Xte, Yte = ti.make_synthetic_motif_data(rng, 10, 24)
    fsk = FastSK(g=6, m=2)
    fsk.compute_kernel(Xtr, Xte, Ytr, Yte)
    fsk.fit(C=1.0, kernel_type="fastsk")
    rep = fsk.score_report()
    assert set(rep) >= {"accuracy", "auc", "tpr", "tnr", "fpr", "fnr"}
    assert rep["auc"] > 0.9


def test_multiclass_runner_end_to_end(tmp_path, rng):
    """TSV multiclass pipeline: 3 planted-motif dialects."""
    motifs = {lab: rng.integers(0, 26, size=6) for lab in ("AAA", "BBB", "CCC")}

    def make(n):
        lines = []
        for _ in range(n):
            lab = ("AAA", "BBB", "CCC")[rng.integers(0, 3)]
            s = rng.integers(0, 26, size=30)
            pos = rng.integers(0, 24)
            s[pos : pos + 6] = motifs[lab]
            lines.append("".join(chr(97 + v) for v in s) + "\t" + lab)
        return "\n".join(lines) + "\n"

    (tmp_path / "tr.tsv").write_text(make(60))
    (tmp_path / "te.tsv").write_text(make(24))

    from fastsk_jax.harness.runner import FastskMulticlassRunner

    runner = FastskMulticlassRunner(
        str(tmp_path / "tr.tsv"), str(tmp_path / "te.tsv")
    )
    res = runner.train_and_test(g=6, m=2, approx=False)
    assert res["acc"] > 0.7


def test_arabic_runner_kernel_ovo(tmp_path, rng):
    """MADAR-format dialect data (3-letter city codes, ArabicUtility)
    through the kernel one-vs-one path end to end — the reference routes
    these sets through sklearn OvR only (test/utils.py:307-369); here the
    precomputed-kernel OvO handles them natively."""
    from fastsk_jax.harness.runner import FastskMulticlassRunner
    from fastsk_jax.io.readers import ArabicUtility

    motifs = {"MSA": [1, 1, 2, 2, 1, 1], "CAI": [3, 3, 4, 4, 3, 3],
              "BEI": [5, 6, 5, 6, 5, 6]}

    def make(n):
        lines = []
        for _ in range(n):
            lab = ("MSA", "CAI", "BEI")[rng.integers(0, 3)]
            s = rng.integers(0, 26, size=30)
            pos = rng.integers(0, 24)
            s[pos : pos + 6] = motifs[lab]
            lines.append("".join(chr(97 + v) for v in s) + "\t" + lab)
        return "\n".join(lines) + "\n"

    (tmp_path / "tr.tsv").write_text(make(60))
    (tmp_path / "te.tsv").write_text(make(24))
    runner = FastskMulticlassRunner(
        str(tmp_path / "tr.tsv"), str(tmp_path / "te.tsv"),
        reader=ArabicUtility(),
    )
    assert sorted(set(runner.Ytrain)) == [1, 2, 3]  # dense city-code ids
    res = runner.train_and_test(g=6, m=2, approx=False, svm="kernel_ovo")
    assert res["acc"] > 0.7


def test_multiclass_runner_kernel_ovo(tmp_path, rng):
    """The kernel one-vs-one path classifies the synthetic MADAR-style
    task as well as the linear OvR path."""
    motifs = {"AAA": [1, 1, 2, 2, 1, 1], "BBB": [3, 3, 4, 4, 3, 3],
              "CCC": [5, 6, 5, 6, 5, 6]}

    def make(n):
        lines = []
        for _ in range(n):
            lab = ("AAA", "BBB", "CCC")[rng.integers(0, 3)]
            s = rng.integers(0, 26, size=30)
            pos = rng.integers(0, 24)
            s[pos : pos + 6] = motifs[lab]
            lines.append("".join(chr(97 + v) for v in s) + "\t" + lab)
        return "\n".join(lines) + "\n"

    (tmp_path / "tr.tsv").write_text(make(60))
    (tmp_path / "te.tsv").write_text(make(24))

    from fastsk_jax.harness.runner import FastskMulticlassRunner

    runner = FastskMulticlassRunner(
        str(tmp_path / "tr.tsv"), str(tmp_path / "te.tsv")
    )
    res = runner.train_and_test(g=6, m=2, approx=False, svm="kernel_ovo")
    assert res["acc"] > 0.7
