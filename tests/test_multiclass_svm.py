"""OvO multiclass kernel SVM + LIBSVM text model format vs sklearn/libsvm."""

import numpy as np
import pytest

from fastsk_jax.svm.kernel_svm import (
    EpsilonSVR,
    KernelSVC,
    NuSVC,
    OneClassSVM,
    save_svm_model,
)
from fastsk_jax.svm.libsvm_io import load_libsvm_model, save_libsvm_model
from fastsk_jax.svm.ovo import group_labels, multiclass_probability


def make_multiclass(rng, n_per=30, d=5, nc=4, sep=2.5):
    """Clustered classes; labels emitted in sorted first-occurrence order
    so our grouping order matches sklearn's sorted classes_."""
    X, y = [], []
    for c in range(nc):
        center = rng.normal(size=d) * sep
        X.append(rng.normal(size=(n_per, d)) + center)
        y.extend([c] * n_per)
    X = np.concatenate(X)
    y = np.asarray(y)
    return X, y


def test_group_labels_order_and_swap_quirk():
    assert group_labels([3, 1, 3, 2]) == [3, 1, 2]
    assert group_labels([-1, 1, -1]) == [1, -1]  # LIBSVM swap
    assert group_labels([1, -1, 1]) == [1, -1]
    assert group_labels([0, 1, 0]) == [0, 1]  # no swap for 0/1


def test_multiclass_probability_recovers_consistent_p():
    p_true = np.array([0.5, 0.3, 0.15, 0.05])
    k = len(p_true)
    r = np.zeros((k, k))
    for i in range(k):
        for j in range(k):
            if i != j:
                r[i, j] = p_true[i] / (p_true[i] + p_true[j])
    p = multiclass_probability(r)
    np.testing.assert_allclose(p, p_true, atol=1e-3)
    assert abs(p.sum() - 1.0) < 1e-9


def test_ovo_kernel_svc_matches_sklearn(rng):
    from sklearn.svm import SVC

    X, y = make_multiclass(rng)
    Xt, _ = make_multiclass(rng)
    gram = X @ X.T
    gram_t = Xt @ X.T
    ours = KernelSVC(C=1.0).fit(gram, y)
    theirs = SVC(
        C=1.0, kernel="precomputed", decision_function_shape="ovo"
    ).fit(gram, y)
    # pair decision values agree to solver tolerance (same SMO problem)
    np.testing.assert_allclose(
        ours.decision_function(gram_t),
        theirs.decision_function(gram_t),
        atol=2e-2,
    )
    assert (ours.predict(gram_t) == theirs.predict(gram_t)).mean() >= 0.99


def test_ovo_nu_svc_matches_sklearn(rng):
    from sklearn.svm import NuSVC as SkNuSVC

    X, y = make_multiclass(rng, nc=3)
    Xt, _ = make_multiclass(rng, nc=3)
    gram = X @ X.T
    gram_t = Xt @ X.T
    ours = NuSVC(nu=0.3, eps=1e-6).fit(gram, y)
    theirs = SkNuSVC(
        nu=0.3, tol=1e-6, kernel="precomputed", decision_function_shape="ovo"
    ).fit(gram, y)
    np.testing.assert_allclose(
        ours.decision_function(gram_t),
        theirs.decision_function(gram_t),
        atol=5e-2,
    )
    assert (ours.predict(gram_t) == theirs.predict(gram_t)).mean() >= 0.99


def test_ovo_predict_proba_valid_and_useful(rng):
    X, y = make_multiclass(rng)
    gram = X @ X.T
    model = KernelSVC(C=1.0, probability=True).fit(gram, y)
    proba = model.predict_proba(gram)
    assert proba.shape == (len(y), 4)
    np.testing.assert_allclose(proba.sum(axis=1), 1.0, atol=1e-6)
    # argmax-probability should classify the (separable) training set well
    assert (np.argmax(proba, axis=1) == y).mean() > 0.95


# ------------------------------------------------------- LIBSVM text format


def test_libsvm_roundtrip_binary_with_probability(rng, tmp_path):
    X = rng.normal(size=(80, 4))
    y = np.where(X[:, 0] + 0.3 * rng.normal(size=80) > 0, 1, -1)
    gram = X @ X.T
    model = KernelSVC(C=1.0, probability=True).fit(gram, y)
    path = str(tmp_path / "m.model")
    save_svm_model(path, model, fmt="libsvm", svm_type="c_svc")
    loaded = load_libsvm_model(path)
    assert loaded.svm_type == "c_svc"
    assert loaded.label == [1, -1]
    Xt = rng.normal(size=(25, 4))
    gt = Xt @ X.T
    np.testing.assert_allclose(
        loaded.decision_function(gt)[:, 0],
        model.decision_function(gt),
        rtol=1e-12, atol=1e-12,
    )
    assert (loaded.predict(gt) == model.predict(gt)).all()
    # probabilities: loaded column 0 is P(label[0]=+1) == our classes_[1]
    np.testing.assert_allclose(
        loaded.predict_proba(gt)[:, 0],
        model.predict_proba(gt)[:, 1],
        rtol=1e-12, atol=1e-12,
    )


def test_libsvm_roundtrip_multiclass(rng, tmp_path):
    X, y = make_multiclass(rng, nc=3)
    gram = X @ X.T
    model = KernelSVC(C=1.0, probability=True).fit(gram, y)
    path = str(tmp_path / "mc.model")
    save_svm_model(path, model, fmt="libsvm", svm_type="c_svc")
    loaded = load_libsvm_model(path)
    assert loaded.nr_class == 3
    Xt, _ = make_multiclass(rng, nc=3)
    gt = Xt @ X.T
    np.testing.assert_allclose(
        loaded.decision_function(gt),
        model.decision_function(gt),
        rtol=1e-10, atol=1e-10,
    )
    assert (loaded.predict(gt) == model.predict(gt)).all()
    np.testing.assert_allclose(
        loaded.predict_proba(gt),  # label (grouping) order == sorted here
        model.predict_proba(gt),
        rtol=1e-10, atol=1e-10,
    )


def test_libsvm_roundtrip_svr_and_oneclass(rng, tmp_path):
    X = rng.normal(size=(60, 4))
    y = X[:, 0] * 2.0 + 0.1 * rng.normal(size=60)
    gram = X @ X.T
    svr = EpsilonSVR(C=1.0).fit(gram, y)
    p1 = str(tmp_path / "svr.model")
    save_svm_model(p1, svr, fmt="libsvm", svm_type="epsilon_svr")
    loaded = load_libsvm_model(p1)
    Xt = rng.normal(size=(20, 4))
    gt = Xt @ X.T
    np.testing.assert_allclose(loaded.predict(gt), svr.predict(gt), rtol=1e-12)

    oc = OneClassSVM(nu=0.2).fit(gram)
    p2 = str(tmp_path / "oc.model")
    save_svm_model(p2, oc, fmt="libsvm", svm_type="one_class")
    loaded2 = load_libsvm_model(p2)
    assert (loaded2.predict(gt) == oc.predict(gt)).all()


def test_libsvm_format_is_parseable_header(rng, tmp_path):
    """The written file follows the svm_save_model layout the stock tools
    parse: known header keys, rho/label/nr_sv arity, '0:<idx>' SV nodes."""
    X, y = make_multiclass(rng, nc=3)
    gram = X @ X.T
    model = KernelSVC(C=1.0).fit(gram, y)
    path = str(tmp_path / "fmt.model")
    save_svm_model(path, model, fmt="libsvm", svm_type="c_svc")
    lines = open(path).read().splitlines()
    header = {}
    sv_at = lines.index("SV")
    for ln in lines[:sv_at]:
        k, *v = ln.split()
        header[k] = v
    assert header["svm_type"] == ["c_svc"]
    assert header["kernel_type"] == ["precomputed"]
    nc = int(header["nr_class"][0])
    assert len(header["rho"]) == nc * (nc - 1) // 2
    assert len(header["label"]) == nc
    assert len(header["nr_sv"]) == nc
    total = int(header["total_sv"][0])
    svs = [ln for ln in lines[sv_at + 1 :] if ln.strip()]
    assert len(svs) == total
    for ln in svs:
        parts = ln.split()
        assert len(parts) == nc - 1 + 1
        idx, val = parts[-1].split(":")
        assert idx == "0" and 1 <= int(val) <= len(y)


# ------------------------------------------------------- FastSK.fit wiring


def _tiny_fastsk(rng, labels):
    from fastsk_jax import FastSK

    X = [rng.integers(1, 5, size=30).tolist() for _ in range(len(labels))]
    fsk = FastSK(g=4, m=1)
    fsk.compute_kernel(X[: len(labels) - 6], X[len(labels) - 6 :],
                       labels[: len(labels) - 6], labels[len(labels) - 6 :])
    return fsk


def test_fit_svm_type_dispatch_and_nu_used(rng):
    labels = [1, -1] * 12
    fsk = _tiny_fastsk(rng, labels)
    fsk.fit(svm_type="nu_svc", nu=0.2, kernel_type="fastsk")
    d1 = np.asarray(fsk._model.decision_function(fsk._test_gram()))
    fsk.fit(svm_type="nu_svc", nu=0.7, kernel_type="fastsk")
    d2 = np.asarray(fsk._model.decision_function(fsk._test_gram()))
    assert not np.allclose(d1, d2)  # nu actually parameterizes the fit
    fsk.fit(svm_type="c_svc", kernel_type="fastsk")
    assert fsk.score("auc") >= 0.0  # scoring path intact


def test_fit_multiclass_kernel_svm(rng):
    labels = [0, 1, 2] * 8
    fsk = _tiny_fastsk(rng, labels)
    fsk.fit(svm_type="c_svc", kernel_type="fastsk")
    acc = fsk.score("accuracy")
    assert 0.0 <= acc <= 100.0
    with pytest.raises(ValueError):
        fsk.score("auc")  # auc is binary-only


def test_fit_svr_and_one_class(rng):
    labels = list(np.linspace(-1.0, 1.0, 24))
    fsk = _tiny_fastsk(rng, labels)
    fsk.fit(svm_type="epsilon_svr", kernel_type="fastsk")
    r2 = fsk.score("r2")
    assert np.isfinite(r2)
    fsk.fit(svm_type="one_class", nu=0.3, kernel_type="fastsk")
    report_ok = fsk._model.predict(fsk._test_gram())
    assert set(np.unique(report_ok)).issubset({-1, 1})


def test_rbf_gamma_uses_nfeat(rng):
    labels = [1, -1] * 12
    fsk = _tiny_fastsk(rng, labels)
    assert fsk.nfeat == sum(30 - 4 + 1 for _ in range(24))
    fsk.fit(kernel_type="rbf")
    assert fsk.score("accuracy") >= 0.0


# ------------------------------------------------- real multiclass data (webkb)


def _webkb_slice(tmp_path, name, per_class, max_len=160):
    """Write a small balanced slice of the shipped 4-class webkb corpus."""
    import os

    src = os.path.join("/root/reference/data", name)
    if not os.path.exists(src):
        pytest.skip("reference webkb data not available")
    taken = {}
    out = []
    with open(src) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    for lab, seq in zip(lines[::2], lines[1::2]):
        c = int(lab[1:])
        if taken.get(c, 0) >= per_class or len(seq) < 20:
            continue
        taken[c] = taken.get(c, 0) + 1
        out += [lab, seq[:max_len]]
    dst = tmp_path / name
    dst.write_text("\n".join(out) + "\n")
    assert len(taken) == 4
    return str(dst)


def test_webkb_multiclass_runner_kernel_ovo(tmp_path):
    """End-to-end 4-class OvO kernel SVM on real webkb text: the runner's
    kernel_ovo path must agree with sklearn SVC(precomputed) on the same
    gkm kernel, and the FASTA multiclass reader must accept labels 0-3."""
    from sklearn.svm import SVC

    from fastsk_jax.harness.runner import FastskMulticlassRunner
    from fastsk_jax.svm.kernel_svm import KernelSVC

    train = _webkb_slice(tmp_path, "webkb-train.fasta", per_class=12)
    test = _webkb_slice(tmp_path, "webkb-test.fasta", per_class=6)
    runner = FastskMulticlassRunner(train, test)
    assert sorted(set(runner.Ytrain)) == [0, 1, 2, 3]

    res = runner.train_and_test(g=4, m=1, approx=False, svm="kernel_ovo")
    assert 0.0 <= res["acc"] <= 1.0

    # cross-check the OvO path against sklearn on the identical kernel
    from fastsk_jax import FastSK

    fsk = FastSK(g=4, m=1)
    fsk.compute_kernel(runner.train_seq, runner.test_seq)
    ntr = fsk.n_str_train
    K, Kt = fsk.kernel[:ntr, :ntr], fsk.kernel[ntr:, :ntr]
    y = np.asarray(runner.Ytrain)
    ours = KernelSVC(C=1.0).fit(K, y).predict(Kt)
    theirs = SVC(C=1.0, kernel="precomputed").fit(K, y).predict(Kt)
    assert (ours == theirs).mean() >= 0.95

    # the linear OvR reference path still runs on the same reader output
    res2 = runner.train_and_test(g=4, m=1, approx=False, svm="linear_ovr")
    assert 0.0 <= res2["acc"] <= 1.0
