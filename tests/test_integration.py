"""End-to-end pipeline tests: fasta -> kernel -> SVM -> metrics."""


import numpy as np
import pytest

from fastsk_jax import FastSK, FastaUtility
from fastsk_jax.svm.linear import train_eval_linear



def make_synthetic_motif_data(rng, n_per_class, length, alphabet=4, seed=99):
    """Two classes carrying distinct planted motifs (fixed per seed) repeated
    along otherwise-uniform sequences — a strong, learnable kernel signal."""
    motif_rng = np.random.default_rng(seed)
    motifs = [
        motif_rng.integers(1, alphabet + 1, size=8),
        motif_rng.integers(1, alphabet + 1, size=8),
    ]
    X, Y = [], []
    for label in (1, 0):
        motif = motifs[label]
        for _ in range(n_per_class):
            s = rng.integers(1, alphabet + 1, size=length)
            for rep in range(2):
                pos = rng.integers(0, length - 8)
                s[pos : pos + 8] = motif
            X.append(s.tolist())
            Y.append(label)
    perm = rng.permutation(len(X))
    return [X[i] for i in perm], [Y[i] for i in perm]


def test_synthetic_end_to_end_ekm(rng):
    """The documented workflow (run_check.py): EKM + calibrated linear SVM."""
    Xtr, Ytr = make_synthetic_motif_data(rng, 40, 30)
    Xte, Yte = make_synthetic_motif_data(rng, 15, 30)

    fsk = FastSK(g=6, m=2)
    fsk.compute_kernel(Xtr, Xte, Ytr, Yte)
    res = train_eval_linear(
        np.array(fsk.get_train_kernel()),
        np.array(fsk.get_test_kernel()),
        Ytr,
        Yte,
        C=1.0,
    )
    assert res["auc"] > 0.95


def test_synthetic_fit_score_kernel_svm(rng):
    """The reference's native path: fit() + score() on the precomputed kernel."""
    Xtr, Ytr = make_synthetic_motif_data(rng, 30, 24)
    Xte, Yte = make_synthetic_motif_data(rng, 12, 24)

    fsk = FastSK(g=6, m=2)
    fsk.compute_kernel(Xtr, Xte, Ytr, Yte)
    fsk.fit(C=1.0, kernel_type="fastsk")
    auc = fsk.score("auc")
    acc = fsk.score("accuracy")
    assert auc > 0.9
    assert acc > 80.0  # reference convention: percentage


def test_approx_close_to_exact_on_synthetic(rng):
    Xtr, Ytr = make_synthetic_motif_data(rng, 25, 24)
    f_exact = FastSK(g=8, m=4)
    f_exact.compute_train(Xtr)
    f_apx = FastSK(g=8, m=4, approx=True, max_iters=40, seed=11)
    f_apx.compute_train(Xtr)
    K1 = np.asarray(f_exact.kernel)
    K2 = np.asarray(f_apx.kernel)
    # normalized kernels should be close even with 40/70 subsets sampled
    assert np.abs(K1 - K2).max() < 0.08


def test_save_kernel_roundtrip(rng, tmp_path):
    Xtr, Ytr = make_synthetic_motif_data(rng, 5, 16)
    fsk = FastSK(g=5, m=1)
    fsk.compute_train(Xtr)
    path = tmp_path / "kernel.txt"
    fsk.save_kernel(str(path))
    lines = path.read_text().strip().split("\n")
    assert len(lines) == 10
    row0 = [float(tok.split(":")[1]) for tok in lines[0].split()]
    np.testing.assert_allclose(row0, np.asarray(fsk.kernel)[0], rtol=1e-6)


def test_stdev_trace_reference_semantics(rng):
    """First recorded sd is the reference's iter-1 sentinel sqrt(9999999)."""
    Xtr, Ytr = make_synthetic_motif_data(rng, 20, 24)
    fsk = FastSK(g=8, m=4, approx=True, max_iters=10)
    fsk.compute_train(Xtr)
    sds = fsk.get_stdevs()
    assert len(sds) == fsk.iterations == 10
    assert sds[0] == pytest.approx(np.sqrt(9999999), rel=1e-5)
    assert all(s < 1000 for s in sds[1:])


def test_approx_seed_determinism(rng):
    Xtr, _ = make_synthetic_motif_data(rng, 15, 20)
    a = FastSK(g=7, m=3, approx=True, max_iters=12, seed=5)
    a.compute_train(Xtr)
    b = FastSK(g=7, m=3, approx=True, max_iters=12, seed=5)
    b.compute_train(Xtr)
    np.testing.assert_array_equal(a.kernel_counts, b.kernel_counts)
    c = FastSK(g=7, m=3, approx=True, max_iters=12, seed=6)
    c.compute_train(Xtr)
    assert not np.array_equal(a.kernel_counts, c.kernel_counts)


@pytest.mark.slow
def test_ep300_run_check_parity():
    """The reference CI gate (test/run_check.py): EP300, g=10 m=6 approx,
    calibrated linear SVM on the EKM, AUC >= 0.9."""
    from fastsk_jax.harness.runner import read_split

    Xtr, Ytr, Xte, Yte = read_split("EP300")
    fsk = FastSK(g=10, m=6, approx=True)
    fsk.compute_kernel(Xtr, Xte, Ytr, Yte)
    res = train_eval_linear(
        np.array(fsk.get_train_kernel()),
        np.array(fsk.get_test_kernel()),
        Ytr,
        Yte,
        C=1.0,
    )
    assert res["auc"] >= 0.9


def test_reference_import_alias():
    """The reference's documented import surface (src/fastsk/__init__.py:1-2,
    src/fastsk/utils.py) works verbatim against the JAX engine — existing
    user scripts switch without edits."""
    from fastsk import FastSK as AliasFastSK
    from fastsk import FastaUtility as AliasFasta
    from fastsk.utils import FastaUtility as UtilsFasta, Vocabulary

    import fastsk_jax

    assert AliasFastSK is fastsk_jax.FastSK
    assert AliasFasta is UtilsFasta is fastsk_jax.FastaUtility
    assert Vocabulary is fastsk_jax.Vocabulary


def test_former_package_name_alias():
    """The package's former name (the one other ``fastsk_*`` package
    beside ``fastsk_jax``) still imports, submodules included, as the
    same module objects, with a DeprecationWarning."""
    import pathlib
    import subprocess
    import sys

    import fastsk_jax

    root = pathlib.Path(fastsk_jax.__file__).resolve().parent.parent
    (old,) = [
        p.name for p in root.glob("fastsk_*")
        if p.name != "fastsk_jax" and (p / "__init__.py").exists()
    ]
    code = (
        "import warnings, fastsk_jax, fastsk_jax.kernel.config as c\n"
        "with warnings.catch_warnings(record=True) as w:\n"
        "    warnings.simplefilter('always')\n"
        f"    import {old}\n"
        f"    from {old}.kernel.config import KernelConfig\n"
        f"    from {old}.api import FastSK\n"
        f"    import {old}.ops.pairs_pallas as pp\n"
        f"assert {old} is fastsk_jax and KernelConfig is c.KernelConfig\n"
        "assert FastSK is fastsk_jax.FastSK\n"
        "import fastsk_jax.ops.pairs_pallas as pp2\n"
        "assert pp is pp2\n"
        "assert any(x.category is DeprecationWarning for x in w)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=root, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
