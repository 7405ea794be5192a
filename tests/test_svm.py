"""JAX SVM stack vs sklearn/libsvm oracles."""

import numpy as np
import pytest

from fastsk_jax.metrics import accuracy_score, auc_pairwise, roc_auc
from fastsk_jax.svm.kernel_svm import KernelSVC
from fastsk_jax.svm.linear import (
    CalibratedLinearSVC,
    LinearSVC,
    stratified_kfold_indices,
    train_eval_linear,
)
from fastsk_jax.svm.platt import sigmoid_predict, sigmoid_train


def make_blobs(rng, n=120, d=6, sep=1.5):
    y = rng.integers(0, 2, size=n)
    X = rng.normal(size=(n, d)) + sep * (2 * y - 1)[:, None] * rng.normal(size=d)
    return X.astype(np.float64), y


# --------------------------------------------------------------- linear


def test_linear_svc_matches_sklearn(rng):
    from sklearn.svm import LinearSVC as SkLinearSVC

    X, y = make_blobs(rng)
    ours = LinearSVC(C=1.0).fit(X, y)
    theirs = SkLinearSVC(C=1.0, loss="squared_hinge", tol=1e-8, max_iter=100000).fit(X, y)
    # same optimum: weights and decisions agree to solver tolerance
    np.testing.assert_allclose(ours.coef_, theirs.coef_, rtol=0, atol=2e-3)
    np.testing.assert_allclose(ours.intercept_, theirs.intercept_, rtol=0, atol=2e-3)
    Xt, yt = make_blobs(rng)
    assert (ours.predict(Xt) == theirs.predict(Xt)).mean() >= 0.99


def test_linear_svc_balanced_matches_sklearn(rng):
    from sklearn.svm import LinearSVC as SkLinearSVC

    X, y = make_blobs(rng, n=150)
    y[:100] = 0  # imbalance
    ours = LinearSVC(C=0.5, class_weight="balanced").fit(X, y)
    theirs = SkLinearSVC(
        C=0.5, class_weight="balanced", loss="squared_hinge", tol=1e-8, max_iter=100000
    ).fit(X, y)
    np.testing.assert_allclose(ours.coef_, theirs.coef_, rtol=0, atol=5e-3)


def test_stratified_folds_match_sklearn():
    from sklearn.model_selection import StratifiedKFold

    y = np.array([0, 1, 1, 0, 1, 0, 0, 1, 1, 1, 0, 1, 0, 0, 1, 1, 0, 1, 0, 1])
    ours = stratified_kfold_indices(y, 5)
    theirs = [te for _, te in StratifiedKFold(n_splits=5).split(np.zeros_like(y), y)]
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, np.sort(b))


def test_calibrated_matches_sklearn(rng):
    from sklearn.calibration import CalibratedClassifierCV
    from sklearn.svm import LinearSVC as SkLinearSVC

    X, y = make_blobs(rng, n=200)
    Xt, yt = make_blobs(rng, n=80)
    ours = CalibratedLinearSVC(C=1.0).fit(X, y)
    theirs = CalibratedClassifierCV(SkLinearSVC(C=1.0, max_iter=100000), cv=5).fit(X, y)
    p_ours = ours.predict_proba(Xt)[:, 1]
    p_theirs = theirs.predict_proba(Xt)[:, 1]
    np.testing.assert_allclose(p_ours, p_theirs, atol=0.02)
    assert abs(roc_auc(yt, p_ours) - roc_auc(yt, p_theirs)) < 0.01


# --------------------------------------------------------------- platt


def test_platt_sigmoid_reasonable(rng):
    dec = np.concatenate([rng.normal(2, 1, 50), rng.normal(-2, 1, 50)])
    y = np.concatenate([np.ones(50), -np.ones(50)])
    A, B = sigmoid_train(dec, y)
    assert A < 0  # decreasing in -f convention: P(pos) grows with dec value
    p = sigmoid_predict(dec, A, B)
    assert p[:50].mean() > 0.8
    assert p[50:].mean() < 0.2


# --------------------------------------------------------------- kernel svc


def test_kernel_svc_matches_libsvm_precomputed(rng):
    from sklearn.svm import SVC

    X, y = make_blobs(rng, n=100, d=5)
    K = X @ X.T
    ours = KernelSVC(C=1.0, eps=1e-5).fit(K, y)
    theirs = SVC(C=1.0, kernel="precomputed", tol=1e-5).fit(K, y)

    d_ours = ours.decision_function(K)
    d_theirs = theirs.decision_function(K)
    np.testing.assert_allclose(d_ours, d_theirs, atol=1e-2)
    assert (ours.predict(K) == theirs.predict(K)).all()
    # dual solution parity
    a_theirs = np.zeros(len(y))
    a_theirs[theirs.support_] = theirs.dual_coef_[0]
    np.testing.assert_allclose(ours.alpha_y_, a_theirs, atol=1e-2)


def test_kernel_svc_probability_auc_close_to_libsvm(rng):
    from sklearn.svm import SVC

    X, y = make_blobs(rng, n=120, d=5)
    Xt, yt = make_blobs(rng, n=60, d=5)
    K = X @ X.T
    Kt = Xt @ X.T
    ours = KernelSVC(C=1.0, probability=True).fit(K, y)
    theirs = SVC(C=1.0, kernel="precomputed", probability=True, random_state=0).fit(K, y)
    auc_ours = roc_auc(yt, ours.predict_proba(Kt)[:, 1])
    auc_theirs = roc_auc(yt, theirs.predict_proba(Kt)[:, 1])
    assert abs(auc_ours - auc_theirs) < 0.03


# --------------------------------------------------------------- metrics


def test_auc_variants():
    y = np.array([1, 1, 0, 0])
    s = np.array([0.9, 0.5, 0.5, 0.1])
    # pairwise-strict: pairs (0.9>0.5), (0.9>0.1), (0.5>0.1) correct, (0.5,0.5) tie=0
    assert auc_pairwise(y, s) == 0.75
    # standard: tie gets half credit
    assert roc_auc(y, s) == 0.875

    from sklearn.metrics import roc_auc_score

    rng = np.random.default_rng(0)
    yy = rng.integers(0, 2, 200)
    ss = rng.normal(size=200) + yy
    assert abs(roc_auc(yy, ss) - roc_auc_score(yy, ss)) < 1e-12


def test_accuracy_handles_label_conventions():
    assert accuracy_score([-1, 1, 1], [-1, 1, -1]) == pytest.approx(2 / 3)
    assert accuracy_score([0, 1, 1], [0, 1, 0]) == pytest.approx(2 / 3)


def test_integration_train_eval_linear(rng):
    X, y = make_blobs(rng, n=150, d=8)
    Xt, yt = make_blobs(rng, n=60, d=8)
    res = train_eval_linear(X, Xt, y, yt, C=1.0)
    assert res["auc"] > 0.9
    assert res["acc"] > 0.85


def test_epsilon_svr_matches_sklearn(rng):
    from sklearn.svm import SVR

    from fastsk_jax.svm.kernel_svm import EpsilonSVR

    n = 50
    X = rng.normal(size=(n, 4))
    y = X @ np.array([1.0, -2.0, 0.5, 0.0]) + 0.1 * rng.normal(size=n)
    gram = (X @ X.T).astype(np.float64)
    ours = EpsilonSVR(C=1.0, epsilon=0.1, eps=1e-5).fit(gram, y)
    sk = SVR(kernel="precomputed", C=1.0, epsilon=0.1, tol=1e-5).fit(gram, y)
    Xq = rng.normal(size=(20, 4))
    gq = Xq @ X.T
    np.testing.assert_allclose(ours.predict(gq), sk.predict(gq), atol=1e-3)


def test_one_class_svm_matches_sklearn(rng):
    from sklearn.svm import OneClassSVM as SkOneClass

    from fastsk_jax.svm.kernel_svm import OneClassSVM

    n = 60
    X = rng.normal(size=(n, 3))
    gram = np.exp(-0.5 * np.sum((X[:, None] - X[None, :]) ** 2, -1))
    ours = OneClassSVM(nu=0.3, eps=1e-6).fit(gram)
    sk = SkOneClass(kernel="precomputed", nu=0.3, tol=1e-6).fit(gram)
    Xq = np.concatenate([X[:10], X[:10] + 5.0])
    gq = np.exp(-0.5 * np.sum((Xq[:, None] - X[None, :]) ** 2, -1))
    np.testing.assert_allclose(
        ours.decision_function(gq), sk.decision_function(gq), atol=1e-3
    )
    solid = np.abs(sk.decision_function(gq)) > 1e-3  # borderline signs may flip
    np.testing.assert_array_equal(
        ours.predict(gq)[solid], sk.predict(gq)[solid]
    )


def test_nu_svc_matches_sklearn(rng):
    from sklearn.svm import NuSVC as SkNuSVC

    from fastsk_jax.svm.kernel_svm import NuSVC

    n = 60
    X = rng.normal(size=(n, 4))
    y = (X[:, 0] + 0.4 * rng.normal(size=n) > 0).astype(int)
    gram = (X @ X.T).astype(np.float64)
    ours = NuSVC(nu=0.3, eps=1e-6).fit(gram, y)
    sk = SkNuSVC(kernel="precomputed", nu=0.3, tol=1e-6).fit(gram, y)
    Xq = rng.normal(size=(25, 4))
    gq = Xq @ X.T
    np.testing.assert_allclose(
        ours.decision_function(gq), sk.decision_function(gq), atol=2e-3
    )
    solid = np.abs(sk.decision_function(gq)) > 1e-2
    np.testing.assert_array_equal(ours.predict(gq)[solid], sk.predict(gq)[solid])


def test_nu_svr_matches_sklearn(rng):
    from sklearn.svm import NuSVR as SkNuSVR

    from fastsk_jax.svm.kernel_svm import NuSVR

    n = 50
    X = rng.normal(size=(n, 4))
    y = X @ np.array([1.0, -2.0, 0.5, 0.0]) + 0.1 * rng.normal(size=n)
    gram = (X @ X.T).astype(np.float64)
    ours = NuSVR(C=1.0, nu=0.5, eps=1e-6).fit(gram, y)
    sk = SkNuSVR(kernel="precomputed", C=1.0, nu=0.5, tol=1e-6).fit(gram, y)
    Xq = rng.normal(size=(20, 4))
    gq = Xq @ X.T
    np.testing.assert_allclose(ours.predict(gq), sk.predict(gq), atol=5e-3)


def test_warm_start_restriction_feasible_and_equivalent(rng):
    """Platt fold solves warm-start from the full optimum restricted to the
    fold; the repair must land exactly on y^T a = 0 inside the box, and a
    warm-started solve must reach the same optimum as a cold start (the
    eps stopping rule is a property of the point, not the path)."""
    from fastsk_jax.svm.kernel_svm import _restrict_feasible

    X, y = make_blobs(rng, n=90, d=5)
    K = X @ X.T
    full = KernelSVC(C=1.0, eps=1e-5).fit(K, y)
    y_signed = np.where(y == full.classes_[1], 1.0, -1.0)
    alpha = full.alpha_y_ * y_signed
    c_vec = np.full(len(y), 1.0, dtype=np.float32)

    keep = np.sort(rng.permutation(len(y))[:72])
    a0 = _restrict_feasible(alpha[keep], y_signed[keep], c_vec[keep])
    assert (a0 >= 0).all() and (a0 <= c_vec[keep] + 1e-7).all()
    assert abs(float(np.dot(a0.astype(np.float64), y_signed[keep]))) < 1e-5

    sub = KernelSVC(C=1.0, eps=1e-5)
    sub.classes_ = full.classes_
    ys, cs = y_signed[keep].astype(np.float32), c_vec[keep]
    a_cold, rho_cold, it_cold = sub._solve(K[np.ix_(keep, keep)], ys, cs)
    a_warm, rho_warm, it_warm = sub._solve(
        K[np.ix_(keep, keep)], ys, cs, alpha0=a0
    )
    d_cold = K[np.ix_(keep, keep)] @ (a_cold * ys) - rho_cold
    d_warm = K[np.ix_(keep, keep)] @ (a_warm * ys) - rho_warm
    np.testing.assert_allclose(d_warm, d_cold, atol=1e-2)
    # iteration savings are a large-n property (measured on the published
    # sets); on toy problems the restricted optimum can sit farther away —
    # only equivalence is asserted here
    assert it_warm > 0 and it_cold > 0


def test_probability_platt_params_unchanged_by_warm_start(rng):
    """Both Platt CV modes must land on the same sigmoid (to solver
    tolerance): platt_warm_start=False (the default, reproducing the
    reference's cold-start svm_binary_svc_probability folds,
    svm.cpp:1913-1999) against a hand-rolled cold-start reference, and
    the opt-in warm-started mode against the same."""
    from fastsk_jax.svm.kernel_svm import _smo_solve, _gram_f32
    from fastsk_jax.svm.linear import stratified_kfold_indices
    from fastsk_jax.svm.platt import sigmoid_train

    X, y = make_blobs(rng, n=100, d=5)
    K = X @ X.T
    model_cold = KernelSVC(C=1.0, probability=True).fit(K, y)
    assert model_cold.platt_warm_start is False  # reference-parity default
    model = KernelSVC(C=1.0, probability=True, platt_warm_start=True).fit(
        K, y
    )

    # cold-start reference platt (the pre-warm-start implementation)
    import jax.numpy as jnp
    gram = _gram_f32(K)
    y_signed = np.where(y == model.classes_[1], 1.0, -1.0).astype(np.float32)
    c_vec = np.full(len(y), 1.0, dtype=np.float32)
    folds = stratified_kfold_indices(y, 5)
    all_idx = np.arange(len(y))
    dec = np.zeros(len(y))
    for f in folds:
        tr = np.setdiff1d(all_idx, f)
        Q = jnp.asarray(gram[np.ix_(tr, tr)]) * jnp.outer(
            jnp.asarray(y_signed[tr]), jnp.asarray(y_signed[tr]))
        a, rho, _ = _smo_solve(
            Q, jnp.asarray(y_signed[tr]), jnp.asarray(c_vec[tr]),
            model.eps, 10_000_000)
        a = np.asarray(a, np.float64)
        dec[f] = gram[np.ix_(f, tr)] @ (a * y_signed[tr]) - float(rho)
    A_cold, B_cold = sigmoid_train(dec, y_signed)
    A_warm, B_warm = model.platt_
    assert abs(A_warm - A_cold) < 0.2 * max(1.0, abs(A_cold))
    assert abs(B_warm - B_cold) < 0.1
    # the default (cold-start) mode tracks the hand-rolled cold-start
    # reference at least as tightly as the warm mode does
    A_def, B_def = model_cold.platt_
    assert abs(A_def - A_cold) < 0.2 * max(1.0, abs(A_cold))
    assert abs(B_def - B_cold) < 0.1


def test_blocked_smo_matches_pairwise_and_sklearn(rng):
    """The q-pair working-set decomposition must land on the same dual
    optimum (same eps KKT rule) as the pairwise reference loop and
    LIBSVM, including with per-sample C (balanced weights) and at sizes
    that force duplicate/frozen working-set slots."""
    import jax.numpy as jnp
    from sklearn.svm import SVC

    from fastsk_jax.svm.kernel_svm import (
        _smo_solve_blocked,
        _smo_solve_general,
    )

    for n, cw in ((150, None), (90, "balanced")):
        X, y = make_blobs(rng, n=n, d=5)
        K = (X @ X.T).astype(np.float32)
        y_signed = np.where(y == 1, 1.0, -1.0).astype(np.float32)
        if cw == "balanced":
            counts = np.array([(y == c).sum() for c in (0, 1)], float)
            w = len(y) / (2.0 * counts)
            c_vec = (np.where(y == 1, w[1], w[0])).astype(np.float32)
        else:
            c_vec = np.full(n, 1.0, dtype=np.float32)
        Q = jnp.asarray(K) * jnp.outer(jnp.asarray(y_signed), jnp.asarray(y_signed))
        args = (
            Q, jnp.asarray(y_signed), jnp.asarray(c_vec),
            -jnp.ones((n,), jnp.float32), jnp.zeros((n,), jnp.float32),
            1e-4,
        )
        a_ref, rho_ref, _ = _smo_solve_general(*args, 10_000_000)
        # q=16 on n=90 guarantees overlapping I_up/I_low selections
        a_blk, rho_blk, it = _smo_solve_blocked(
            *args, q=16, inner_steps=16, max_outer=100_000
        )
        assert int(it) > 0
        a_ref, a_blk = np.asarray(a_ref, np.float64), np.asarray(a_blk, np.float64)
        # box + equality feasibility, exact
        assert (a_blk >= 0).all() and (a_blk <= c_vec + 1e-6).all()
        assert abs(float(a_blk @ y_signed)) < 1e-3
        d_ref = K @ (a_ref * y_signed) - float(rho_ref)
        d_blk = K @ (a_blk * y_signed) - float(rho_blk)
        np.testing.assert_allclose(d_blk, d_ref, atol=2e-2)
        if cw is None:
            sk = SVC(C=1.0, kernel="precomputed", tol=1e-5).fit(K, y)
            np.testing.assert_allclose(d_blk, sk.decision_function(K), atol=2e-2)


def test_kernel_svc_blocked_threshold_path(rng):
    """KernelSVC routes n >= BLOCKED_MIN_N through the blocked solver;
    force the threshold down and check decisions against the pairwise
    path on the identical problem."""
    X, y = make_blobs(rng, n=140, d=6)
    K = X @ X.T
    lowered = KernelSVC(C=1.0, eps=1e-5)
    lowered.BLOCKED_MIN_N = 1
    a = lowered.fit(K, y)
    ref = KernelSVC(C=1.0, eps=1e-5)
    ref.BLOCKED_MIN_N = 10**9
    b = ref.fit(K, y)
    np.testing.assert_allclose(
        a.decision_function(K), b.decision_function(K), atol=2e-2
    )
    assert (a.predict(K) == b.predict(K)).all()
