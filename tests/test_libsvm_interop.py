"""True cross-tool interop: models written by fastsk_jax.svm.libsvm_io are
loaded and predicted by the reference's UNMODIFIED LIBSVM fork
(tools/reference_oracle/svm_oracle links libsvm-code/svm.cpp verbatim:
svm_load_model svm.cpp:2903-3010, svm_predict_values svm.cpp:2521-2616,
svm_predict_probability svm.cpp:2617-2660). This is stronger than the
round-trip tests in test_multiclass_svm.py: the parser on the other side
is the reference's own."""

import os
import subprocess

import numpy as np
import pytest

from fastsk_jax.svm.kernel_svm import (
    EpsilonSVR,
    KernelSVC,
    NuSVC,
    OneClassSVM,
    save_svm_model,
)

ORACLE_DIR = os.path.join(os.path.dirname(__file__), "..", "tools", "reference_oracle")
ORACLE = os.path.join(ORACLE_DIR, "svm_oracle")


@pytest.fixture(scope="module")
def oracle():
    if not os.path.exists(ORACLE):
        subprocess.run(["sh", os.path.join(ORACLE_DIR, "build.sh")], check=True)
    return ORACLE


def run_oracle(oracle, model_path, gram_test, tmp_path):
    rows = str(tmp_path / "rows.csv")
    np.savetxt(rows, np.asarray(gram_test, dtype=np.float64), delimiter=",", fmt="%.17g")
    res = subprocess.run(
        [oracle, str(model_path), rows], check=True, capture_output=True, text=True
    )
    return np.array([[float(v) for v in ln.split()] for ln in res.stdout.splitlines()])


def make_multiclass(rng, n_per=30, d=5, nc=3, sep=2.5):
    X, y = [], []
    for c in range(nc):
        center = rng.normal(size=d) * sep
        X.append(rng.normal(size=(n_per, d)) + center)
        y.extend([c] * n_per)
    return np.concatenate(X), np.asarray(y)


def test_reference_libsvm_loads_and_matches_binary(oracle, rng, tmp_path):
    X = rng.normal(size=(80, 4))
    y = np.where(X[:, 0] + 0.3 * rng.normal(size=80) > 0, 1, -1)
    gram = X @ X.T
    model = KernelSVC(C=1.0, probability=True).fit(gram, y)
    path = tmp_path / "bin.model"
    save_svm_model(str(path), model, fmt="libsvm", svm_type="c_svc")
    Xt = rng.normal(size=(25, 4))
    gt = Xt @ X.T
    out = run_oracle(oracle, path, gt, tmp_path)
    # columns: pred, dec, p(label0), p(label1)
    np.testing.assert_array_equal(out[:, 0].astype(int), model.predict(gt))
    np.testing.assert_allclose(out[:, 1], model.decision_function(gt), rtol=1e-12, atol=1e-12)
    # our proba columns follow classes_ = sorted; the model file's label
    # order is LIBSVM grouping ([1, -1] here) -> label0 == our column 1
    np.testing.assert_allclose(out[:, 2], model.predict_proba(gt)[:, 1], rtol=1e-9, atol=1e-9)


def test_reference_libsvm_matches_multiclass_ovo(oracle, rng, tmp_path):
    X, y = make_multiclass(rng, nc=4)
    gram = X @ X.T
    model = KernelSVC(C=1.0).fit(gram, y)
    path = tmp_path / "mc.model"
    save_svm_model(str(path), model, fmt="libsvm", svm_type="c_svc")
    Xt, _ = make_multiclass(rng, nc=4)
    gt = Xt @ X.T
    out = run_oracle(oracle, path, gt, tmp_path)
    np.testing.assert_array_equal(out[:, 0].astype(int), model.predict(gt))
    np.testing.assert_allclose(out[:, 1:7], model.decision_function(gt), rtol=1e-10, atol=1e-10)


def test_reference_libsvm_matches_nu_svc(oracle, rng, tmp_path):
    X, y = make_multiclass(rng, nc=2)
    y = np.where(y == 0, -1, 1)
    gram = X @ X.T
    model = NuSVC(nu=0.3).fit(gram, y)
    path = tmp_path / "nu.model"
    save_svm_model(str(path), model, fmt="libsvm", svm_type="nu_svc")
    Xt, _ = make_multiclass(rng, nc=2)
    gt = Xt @ X.T
    out = run_oracle(oracle, path, gt, tmp_path)
    np.testing.assert_array_equal(out[:, 0].astype(int), model.predict(gt))
    np.testing.assert_allclose(out[:, 1], model.decision_function(gt), rtol=1e-12, atol=1e-12)


def test_reference_libsvm_matches_svr_and_oneclass(oracle, rng, tmp_path):
    X = rng.normal(size=(60, 4))
    y = X[:, 0] * 2.0 + 0.1 * rng.normal(size=60)
    gram = X @ X.T
    Xt = rng.normal(size=(20, 4))
    gt = Xt @ X.T

    svr = EpsilonSVR(C=1.0).fit(gram, y)
    p1 = tmp_path / "svr.model"
    save_svm_model(str(p1), svr, fmt="libsvm", svm_type="epsilon_svr")
    out = run_oracle(oracle, p1, gt, tmp_path)
    np.testing.assert_allclose(out[:, 0], svr.predict(gt), rtol=1e-12, atol=1e-12)

    oc = OneClassSVM(nu=0.2).fit(gram)
    p2 = tmp_path / "oc.model"
    save_svm_model(str(p2), oc, fmt="libsvm", svm_type="one_class")
    out2 = run_oracle(oracle, p2, gt, tmp_path)
    np.testing.assert_array_equal(out2[:, 0].astype(int), oc.predict(gt))
