"""JAX linear SVM (squared hinge, L2) and calibrated-CV classifier.

The reference's published numbers come from sklearn
``LinearSVC(C).fit(K_train_rows)`` wrapped in ``CalibratedClassifierCV(cv=5)``
over kernel rows used as an empirical kernel map (test/run_check.py:55-56,
test/utils.py:435-437). This module is a from-scratch JAX implementation of
that estimator pair: a trust-region-free Newton-CG on the primal squared-hinge
objective (the same optimum liblinear's TRON finds) and Platt-sigmoid
calibration over deterministic stratified folds.

Solvers run under jit, so the O(n_train^2) matvecs run on the device.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..metrics import roc_auc
from .platt import sigmoid_predict, sigmoid_train


@functools.partial(jax.jit, static_argnames=("max_newton", "max_cg"))
def _solve_squared_hinge(
    X: jnp.ndarray,  # [n, d] float32 (intercept column appended by caller)
    y: jnp.ndarray,  # [n] float32 in {-1, +1}
    C: jnp.ndarray,  # scalar float32
    sample_weight: jnp.ndarray,  # [n] float32
    tol: float = 1e-6,
    max_newton: int = 50,
    max_cg: int = 64,
) -> jnp.ndarray:
    """min_w 0.5 ||w||^2 + C * sum_i s_i * max(0, 1 - y_i x_i.w)^2."""

    n, d = X.shape

    def grad_fn(w):
        margins = 1.0 - y * (X @ w)
        active = jnp.maximum(margins, 0.0)
        return w - 2.0 * C * (X.T @ (sample_weight * y * active)), margins

    def hvp(w_active_mask, v):
        xv = X @ v
        return v + 2.0 * C * (X.T @ (sample_weight * w_active_mask * xv))

    def cg_solve(mask, g):
        # solve H x = -g by conjugate gradients
        x0 = jnp.zeros_like(g)
        r0 = -g
        p0 = r0
        rs0 = r0 @ r0

        def body(state):
            i, x, r, p, rs = state
            hp = hvp(mask, p)
            alpha = rs / jnp.maximum(p @ hp, 1e-30)
            x = x + alpha * p
            r = r - alpha * hp
            rs_new = r @ r
            p = r + (rs_new / jnp.maximum(rs, 1e-30)) * p
            return i + 1, x, r, p, rs_new

        def cond(state):
            i, x, r, p, rs = state
            return (i < max_cg) & (rs > 1e-12 * jnp.maximum(rs0, 1e-30))

        _, x, _, _, _ = jax.lax.while_loop(cond, body, (0, x0, r0, p0, rs0))
        return x

    def obj(w):
        margins = jnp.maximum(1.0 - y * (X @ w), 0.0)
        return 0.5 * (w @ w) + C * jnp.sum(sample_weight * margins**2)

    def newton_body(state):
        it, w, gnorm = state
        g, margins = grad_fn(w)
        mask = (margins > 0).astype(X.dtype)
        step = cg_solve(mask, g)

        # backtracking line search on the exact objective
        f0 = obj(w)
        gd = g @ step

        def ls_body(s):
            t, _ = s
            return t * 0.5, obj(w + t * 0.5 * step)

        def ls_cond(s):
            t, fv = s
            return (fv > f0 + 1e-4 * t * gd) & (t > 1e-8)

        t_final, _ = jax.lax.while_loop(ls_cond, ls_body, (1.0, obj(w + step)))
        w = w + t_final * step
        g_new, _ = grad_fn(w)
        return it + 1, w, jnp.linalg.norm(g_new)

    def newton_cond(state):
        it, w, gnorm = state
        return (it < max_newton) & (gnorm > tol * n)

    w0 = jnp.zeros((d,), X.dtype)
    g0, _ = grad_fn(w0)
    _, w, _ = jax.lax.while_loop(
        newton_cond, newton_body, (0, w0, jnp.linalg.norm(g0))
    )
    return w


@dataclass
class LinearSVC:
    """Binary linear SVM with squared-hinge loss (sklearn-LinearSVC parity).

    ``class_weight="balanced"`` reweights C per class by
    ``n_samples / (n_classes * class_count)``, matching the harness's
    ``LinearSVC(class_weight='balanced')`` (test/utils.py:435).
    """

    C: float = 1.0
    class_weight: Optional[str] = None
    tol: float = 1e-6

    def fit(self, X: np.ndarray, y) -> "LinearSVC":
        X = np.asarray(X, dtype=np.float32)
        y = np.asarray(y)
        classes = np.unique(y)
        if len(classes) != 2:
            raise ValueError(f"binary classification only; got classes {classes}")
        self.classes_ = classes
        y_signed = np.where(y == classes[1], 1.0, -1.0).astype(np.float32)

        if self.class_weight == "balanced":
            counts = np.array([(y == c).sum() for c in classes], dtype=np.float64)
            cw = len(y) / (2.0 * counts)
            sw = np.where(y == classes[1], cw[1], cw[0]).astype(np.float32)
        else:
            sw = np.ones_like(y_signed)

        Xi = np.concatenate([X, np.ones((len(X), 1), np.float32)], axis=1)
        w = _solve_squared_hinge(
            jnp.asarray(Xi),
            jnp.asarray(y_signed),
            jnp.float32(self.C),
            jnp.asarray(sw),
            tol=self.tol,
        )
        w = np.asarray(w, dtype=np.float64)
        self.coef_ = w[:-1][None, :]
        self.intercept_ = w[-1:]
        return self

    def decision_function(self, X) -> np.ndarray:
        X = np.asarray(X, dtype=np.float64)
        return X @ self.coef_[0] + self.intercept_[0]

    def predict(self, X) -> np.ndarray:
        d = self.decision_function(X)
        return np.where(d > 0, self.classes_[1], self.classes_[0])

    def score(self, X, y) -> float:
        return float(np.mean(self.predict(X) == np.asarray(y)))


def stratified_kfold_indices(y, n_splits: int = 5) -> List[np.ndarray]:
    """Deterministic stratified folds, bit-matching sklearn's unshuffled
    StratifiedKFold: per-fold class allocations come from n_splits-strided
    slices of the sorted labels, and each class's samples are assigned to
    folds in contiguous encounter-order blocks of those sizes."""
    y = np.asarray(y)
    classes, y_enc = np.unique(y, return_inverse=True)
    n_classes = len(classes)
    y_sorted = np.sort(y_enc)
    allocation = np.array(
        [
            np.bincount(y_sorted[i::n_splits], minlength=n_classes)
            for i in range(n_splits)
        ]
    )
    test_folds = np.empty(len(y), dtype=np.int64)
    for k in range(n_classes):
        folds_for_class = np.arange(n_splits).repeat(allocation[:, k])
        test_folds[y_enc == k] = folds_for_class
    return [np.flatnonzero(test_folds == i) for i in range(n_splits)]


@dataclass
class CalibratedLinearSVC:
    """LinearSVC + per-fold Platt calibration, averaged over folds.

    Equivalent estimator to sklearn ``CalibratedClassifierCV(LinearSVC(C),
    cv=5)`` as used by the reference's validation pipeline
    (test/run_check.py:55-56): 5 stratified folds, each fold's model
    calibrated on its held-out decisions, probabilities averaged.
    """

    C: float = 1.0
    cv: int = 5
    class_weight: Optional[str] = None

    def fit(self, X, y) -> "CalibratedLinearSVC":
        X = np.asarray(X, dtype=np.float32)
        y = np.asarray(y)
        self.classes_ = np.unique(y)
        # degrade gracefully on tiny data: every fold's training split must
        # still contain both classes
        min_class = int(min(np.bincount(np.searchsorted(self.classes_, y))))
        cv = max(2, min(self.cv, min_class)) if min_class >= 2 else 0
        if cv == 0:
            # toy-sized data (one sample in a class): uncalibrated fallback
            svc = LinearSVC(C=self.C, class_weight=self.class_weight).fit(X, y)
            dec = svc.decision_function(X)
            A, B = sigmoid_train(dec, np.where(y == self.classes_[1], 1, -1))
            self._models = [(svc, A, B)]
            return self
        folds = stratified_kfold_indices(y, cv)
        all_idx = np.arange(len(y))
        self._models: List[Tuple[LinearSVC, float, float]] = []
        for f in folds:
            train_idx = np.setdiff1d(all_idx, f)
            svc = LinearSVC(C=self.C, class_weight=self.class_weight).fit(
                X[train_idx], y[train_idx]
            )
            dec = svc.decision_function(X[f])
            A, B = sigmoid_train(dec, np.where(y[f] == self.classes_[1], 1, -1))
            self._models.append((svc, A, B))
        return self

    def predict_proba(self, X) -> np.ndarray:
        X = np.asarray(X, dtype=np.float64)
        probs = np.zeros(len(X), dtype=np.float64)
        for svc, A, B in self._models:
            probs += sigmoid_predict(svc.decision_function(X), A, B)
        probs /= len(self._models)
        return np.stack([1.0 - probs, probs], axis=1)

    def predict(self, X) -> np.ndarray:
        p = self.predict_proba(X)[:, 1]
        return np.where(p > 0.5, self.classes_[1], self.classes_[0])

    def score(self, X, y) -> float:
        return float(np.mean(self.predict(X) == np.asarray(y)))


def train_eval_linear(
    K_train: np.ndarray,
    K_test: np.ndarray,
    Ytrain,
    Ytest,
    C: float = 1.0,
) -> dict:
    """The reference validation pipeline in one call (run_check.py:54-64):
    calibrated linear SVM on kernel rows; returns accuracy and AUROC."""
    clf = CalibratedLinearSVC(C=C).fit(np.asarray(K_train), np.asarray(Ytrain))
    probs = clf.predict_proba(np.asarray(K_test))[:, 1]
    acc = clf.score(np.asarray(K_test), np.asarray(Ytest))
    return {"acc": acc, "auc": roc_auc(np.asarray(Ytest), probs)}


@dataclass
class MulticlassLinearSVC:
    """One-vs-rest linear SVC for multiclass workloads (the MADAR Arabic
    dialect task, test/utils.py:307-369 — the reference leans on sklearn's
    built-in OvR there)."""

    C: float = 1.0
    class_weight: Optional[str] = None

    def fit(self, X, y) -> "MulticlassLinearSVC":
        X = np.asarray(X, dtype=np.float32)
        y = np.asarray(y)
        self.classes_ = np.unique(y)
        if len(self.classes_) < 2:
            raise ValueError("need at least two classes")
        self._models = []
        for c in self.classes_:
            yc = (y == c).astype(int)
            self._models.append(
                LinearSVC(C=self.C, class_weight=self.class_weight).fit(X, yc)
            )
        return self

    def decision_function(self, X) -> np.ndarray:
        X = np.asarray(X, dtype=np.float64)
        return np.stack([m.decision_function(X) for m in self._models], axis=1)

    def predict(self, X) -> np.ndarray:
        return self.classes_[self.decision_function(X).argmax(axis=1)]

    def score(self, X, y) -> float:
        return float(np.mean(self.predict(X) == np.asarray(y)))
