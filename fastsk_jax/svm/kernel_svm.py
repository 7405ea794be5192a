"""Kernel C-SVC on a precomputed Gram matrix — a JAX SMO solver.

Replaces the reference's embedded LIBSVM fork (libsvm-code/svm.cpp: the
FASTSK kernel type reads precomputed kernel values, svm.cpp:237-240). The
solver is the same optimization problem LIBSVM's Solver::Solve handles —

    min 0.5 a^T Q a - e^T a,  0 <= a_i <= C_i,  y^T a = 0,
    Q_ij = y_i y_j K_ij

— with LIBSVM's second-order working-set selection (svm.cpp:805-923) and
stopping rule, but implemented as a single jitted ``lax.while_loop`` over
dense vector ops: the whole Gram lives in device memory, every iteration is
O(n) vector work, and there is no kernel cache, shrinking, or locking
because none of it is needed when K is resident.

Probability estimates use Platt scaling on 5-fold cross-validated decision
values, mirroring ``svm_binary_svc_probability`` (svm.cpp:1913-1999) with a
deterministic fold assignment.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import ClassVar, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .linear import stratified_kfold_indices
from .platt import sigmoid_predict, sigmoid_train

_NEG_INF = -1e30
_TAU = 1e-12


def _gram_f32(gram):
    """Accept a host or device Gram without forcing a transfer: device
    Grams (the device-resident kernel path, kernel/device_counts.py) stay
    on device for the jitted solvers; host arrays keep the numpy path."""
    if isinstance(gram, jax.Array):
        return gram.astype(jnp.float32)
    return np.asarray(gram, dtype=np.float32)


def _decision_values(gram_rows, coef: np.ndarray, rho: float) -> np.ndarray:
    """``gram_rows @ coef - rho`` pulling only the O(n) result: device rows
    dot on device in f32; host rows keep the f64 numpy path."""
    if isinstance(gram_rows, jax.Array):
        d = gram_rows.astype(jnp.float32) @ jnp.asarray(coef, dtype=jnp.float32)
        return np.asarray(d, dtype=np.float64) - rho
    return np.asarray(gram_rows, np.float64) @ coef - rho


def _snap_bounds(alpha: jnp.ndarray, C_vec: jnp.ndarray) -> jnp.ndarray:
    """Clamp alphas within 1e-6*C of a bound exactly onto it (f32 pair
    updates leave machine-epsilon residues where LIBSVM's doubles are
    exact; the rho/r free-SV averages must agree on the active set)."""
    thr = 1e-6 * C_vec
    return jnp.where(
        alpha < thr, 0.0, jnp.where(alpha > C_vec - thr, C_vec, alpha)
    )


@functools.partial(jax.jit, static_argnames=("max_iter",))
def _smo_solve_general(
    Q: jnp.ndarray,  # [n, n] float32, Q = (y y^T) * K
    y: jnp.ndarray,  # [n] float32 {-1, +1}
    C_vec: jnp.ndarray,  # [n] per-sample upper bound
    p: jnp.ndarray,  # [n] linear term (C-SVC: -e)
    alpha0: jnp.ndarray,  # [n] feasible start (sum y.a fixed by caller)
    eps: float,
    max_iter: int,
):
    """Generalized single-constraint SMO: min 0.5 a^T Q a + p^T a subject to
    0 <= a <= C, y^T a = const — LIBSVM Solver::Solve
    (svm.cpp:411-1028) covering C-SVC, epsilon-SVR and one-class via the
    caller's choice of Q, p, bounds and warm start."""
    n = Q.shape[0]
    # HIGHEST precision: warm starts make alpha0 nonzero, and grad is only
    # ever updated incrementally from here — a bf16-pass grad0 would bias
    # the KKT stop rule and rho for the entire solve.
    grad0 = jnp.matmul(Q, alpha0, precision=jax.lax.Precision.HIGHEST) + p

    def select(alpha, grad):
        # I_up: y=+1 & a<C  or  y=-1 & a>0 ; I_low: y=+1 & a>0 or y=-1 & a<C
        up = jnp.where(y > 0, alpha < C_vec, alpha > 0)
        low = jnp.where(y > 0, alpha > 0, alpha < C_vec)
        minus_yg = -y * grad
        gmax = jnp.max(jnp.where(up, minus_yg, _NEG_INF))
        i = jnp.argmax(jnp.where(up, minus_yg, _NEG_INF))
        gmax2 = jnp.max(jnp.where(low, -minus_yg, _NEG_INF))

        # second-order j selection among I_low with positive violation
        # b_t = Gmax + y_t grad_t (libsvm svm.cpp:858-886)
        b = gmax + y * grad
        qd = jnp.diagonal(Q)
        a_coef = qd[i] + qd - 2.0 * y[i] * y * Q[i, :]
        a_coef = jnp.where(a_coef <= 0, _TAU, a_coef)
        obj_diff = -(b * b) / a_coef
        cand = low & (b > 0)
        j = jnp.argmin(jnp.where(cand, obj_diff, -_NEG_INF))
        return i, j, gmax, gmax2

    def body(state):
        alpha, grad, it, _ = state
        i, j, gmax, gmax2 = select(alpha, grad)

        yi, yj = y[i], y[j]
        qd = jnp.diagonal(Q)
        quad = qd[i] + qd[j] - 2.0 * yi * yj * Q[i, j]
        quad = jnp.where(quad <= 0, _TAU, quad)

        # analytic pair Newton step (libsvm svm.cpp:565-706):
        #   y_i != y_j: d = (-G_i - G_j)/quad;  a_i += d, a_j += d
        #   y_i == y_j: d = ( G_i - G_j)/quad;  a_i -= d, a_j += d
        ai, aj = alpha[i], alpha[j]
        same_sign = yi == yj
        delta_eq = (grad[i] - grad[j]) / quad
        delta_neq = (-grad[i] - grad[j]) / quad
        new_ai = jnp.where(same_sign, ai - delta_eq, ai + delta_neq)
        new_aj = jnp.where(same_sign, aj + delta_eq, aj + delta_neq)

        # project onto the feasible segment of the box; the conserved
        # quantity is a_i + a_j (same sign) or a_i - a_j (different sign)
        s_term = jnp.where(same_sign, ai + aj, ai - aj)
        lo_i = jnp.where(same_sign, jnp.maximum(0.0, s_term - C_vec[j]), jnp.maximum(0.0, s_term))
        hi_i = jnp.where(same_sign, jnp.minimum(C_vec[i], s_term), jnp.minimum(C_vec[i], C_vec[j] + s_term))
        new_ai = jnp.clip(new_ai, lo_i, hi_i)
        new_aj = jnp.where(same_sign, s_term - new_ai, new_ai - s_term)

        dai = new_ai - ai
        daj = new_aj - aj
        grad = grad + Q[i, :] * dai + Q[j, :] * daj
        alpha = alpha.at[i].set(new_ai).at[j].set(new_aj)
        return alpha, grad, it + 1, gmax + gmax2

    def cond(state):
        alpha, grad, it, viol = state
        return (it < max_iter) & (viol >= eps)

    alpha, grad, iters, _ = jax.lax.while_loop(
        cond, body, (alpha0, grad0, jnp.int32(0), jnp.float32(jnp.inf))
    )
    alpha, rho = _finalize_rho(alpha, grad, y, C_vec)
    return alpha, rho, iters


def _finalize_rho(alpha, grad, y, C_vec):
    """Snap f32 bound residues and compute the bias.

    LIBSVM's double updates leave alphas exactly at 0/C, ours can leave
    ~1e-7 leftovers on the pair partner, and those phantom "free" SVs
    would pollute the gradient-averaged rho. rho: average -y*grad over
    free SVs, else midpoint of bounds (libsvm Solver::calculate_rho,
    svm.cpp:974-1004)."""
    alpha = _snap_bounds(alpha, C_vec)
    free = (alpha > 0) & (alpha < C_vec)
    yg = y * grad
    nfree = jnp.sum(free)
    up = jnp.where(y > 0, alpha < C_vec, alpha > 0)
    low = jnp.where(y > 0, alpha > 0, alpha < C_vec)
    ub = jnp.min(jnp.where(up, yg, -_NEG_INF))
    lb = jnp.max(jnp.where(low, yg, _NEG_INF))
    rho = jnp.where(nfree > 0, jnp.sum(jnp.where(free, yg, 0.0)) / nfree, (ub + lb) / 2.0)
    return alpha, rho


@functools.partial(
    jax.jit, static_argnames=("q", "inner_steps", "max_outer")
)
def _smo_solve_blocked(
    Q: jnp.ndarray,  # [n, n] float32, Q = (y y^T) * K
    y: jnp.ndarray,  # [n] float32 {-1, +1}
    C_vec: jnp.ndarray,  # [n] per-sample upper bound
    p: jnp.ndarray,  # [n] linear term (C-SVC: -e)
    alpha0: jnp.ndarray,  # [n] feasible start
    eps: float,
    *,
    q: int = 64,
    inner_steps: int = 64,
    max_outer: int = 100_000,
):
    """Working-set decomposition SMO (SVMlight-family, q > 2): each outer
    iteration gathers the q most KKT-violating coordinates (top q/2 of
    I_up by -y*grad, top q/2 of I_low by y*grad), runs ``inner_steps``
    exact pair updates on the q-variable subproblem entirely in small
    vectors, then applies one rank-q gradient update ``grad += dalpha @
    Q[idx, :]`` as one matmul.

    Converges to the same dual optimum as the pairwise loop: the maximal
    violating pair is always inside the working set (it attains the two
    top-1 scores), every inner update is an exact constrained pair
    minimization, and the outer stop is the identical global rule
    ``gmax + gmax2 < eps`` — the returned point satisfies the same KKT
    tolerance as LIBSVM's Solver::Solve, it just gets there with ~q
    updates per O(n) selection instead of one (svm.cpp:805-923 does one
    pair per full working-set selection).

    Wall-clock motivation: the pairwise loop's iteration is
    latency-bound (~10 O(n) ops per update); at n in the thousands the
    decomposition replaces ~q sequential O(n) selections with one O(n)
    top_k plus q tiny O(q) steps and a [q]x[q,n] matvec.
    """
    n = Q.shape[0]
    half = q // 2
    grad0 = jnp.matmul(Q, alpha0, precision=jax.lax.Precision.HIGHEST) + p
    tri = jnp.tril(jnp.ones((q, q), jnp.bool_), k=-1)

    def inner_body(_, state):
        a_l, g_l, y_l, lo_l, hi_l, Q_l = state
        up_l = jnp.where(y_l > 0, a_l < hi_l, a_l > lo_l)
        low_l = jnp.where(y_l > 0, a_l > lo_l, a_l < hi_l)
        minus_yg = -y_l * g_l
        gmax = jnp.max(jnp.where(up_l, minus_yg, _NEG_INF))
        i = jnp.argmax(jnp.where(up_l, minus_yg, _NEG_INF))
        gmax2 = jnp.max(jnp.where(low_l, -minus_yg, _NEG_INF))

        b = gmax + y_l * g_l
        qd = jnp.diagonal(Q_l)
        a_coef = qd[i] + qd - 2.0 * y_l[i] * y_l * Q_l[i, :]
        a_coef = jnp.where(a_coef <= 0, _TAU, a_coef)
        obj_diff = -(b * b) / a_coef
        cand = low_l & (b > 0)
        j = jnp.argmin(jnp.where(cand, obj_diff, -_NEG_INF))

        yi, yj = y_l[i], y_l[j]
        quad = qd[i] + qd[j] - 2.0 * yi * yj * Q_l[i, j]
        quad = jnp.where(quad <= 0, _TAU, quad)
        ai, aj = a_l[i], a_l[j]
        same_sign = yi == yj
        delta_eq = (g_l[i] - g_l[j]) / quad
        delta_neq = (-g_l[i] - g_l[j]) / quad
        new_ai = jnp.where(same_sign, ai - delta_eq, ai + delta_neq)

        # project onto the feasible segment of the general box
        # [lo, hi] (frozen duplicate slots have lo == hi); conserved:
        # a_i + a_j (same sign) or a_i - a_j (different sign)
        s_term = jnp.where(same_sign, ai + aj, ai - aj)
        lo_i = jnp.where(
            same_sign,
            jnp.maximum(lo_l[i], s_term - hi_l[j]),
            jnp.maximum(lo_l[i], s_term + lo_l[j]),
        )
        hi_i = jnp.where(
            same_sign,
            jnp.minimum(hi_l[i], s_term - lo_l[j]),
            jnp.minimum(hi_l[i], s_term + hi_l[j]),
        )
        new_ai = jnp.clip(new_ai, lo_i, hi_i)
        new_aj = jnp.where(same_sign, s_term - new_ai, new_ai - s_term)

        # no-op once the subproblem meets the global tolerance
        live = (gmax + gmax2) >= eps
        dai = jnp.where(live, new_ai - ai, 0.0)
        daj = jnp.where(live, new_aj - aj, 0.0)
        g_l = g_l + Q_l[i, :] * dai + Q_l[j, :] * daj
        a_l = a_l.at[i].add(dai).at[j].add(daj)
        return a_l, g_l, y_l, lo_l, hi_l, Q_l

    def outer_body(state):
        alpha, grad, it, _ = state
        up = jnp.where(y > 0, alpha < C_vec, alpha > 0)
        low = jnp.where(y > 0, alpha > 0, alpha < C_vec)
        minus_yg = -y * grad
        _, iu = jax.lax.top_k(jnp.where(up, minus_yg, _NEG_INF), half)
        _, il = jax.lax.top_k(jnp.where(low, y * grad, _NEG_INF), half)
        idx = jnp.concatenate([iu, il])

        # a free SV can appear in both halves: freeze every later
        # duplicate slot (box collapsed to its current value) so only
        # one live copy moves and scatter-adds stay exact
        dup = jnp.any((idx[:, None] == idx[None, :]) & tri, axis=1)
        a_l = alpha[idx]
        y_l = y[idx]
        g_l = grad[idx]
        lo_l = jnp.where(dup, a_l, 0.0)
        hi_l = jnp.where(dup, a_l, C_vec[idx])
        # row selection as a one-hot matmul rather than a gather: the
        # product is exact at HIGHEST precision (one nonzero per row)
        onehot = (idx[:, None] == jnp.arange(n)[None, :]).astype(Q.dtype)
        Q_rows = jnp.matmul(
            onehot, Q, precision=jax.lax.Precision.HIGHEST
        )  # [q, n]
        Q_l = jnp.matmul(
            Q_rows, onehot.T, precision=jax.lax.Precision.HIGHEST
        )  # [q, q]

        a_out, *_ = jax.lax.fori_loop(
            0, inner_steps, inner_body, (a_l, g_l, y_l, lo_l, hi_l, Q_l)
        )
        dalpha = a_out - a_l  # 0 on frozen duplicate slots
        alpha = alpha.at[idx].add(dalpha)
        grad = grad + jnp.matmul(
            dalpha, Q_rows, precision=jax.lax.Precision.HIGHEST
        )

        up2 = jnp.where(y > 0, alpha < C_vec, alpha > 0)
        low2 = jnp.where(y > 0, alpha > 0, alpha < C_vec)
        gmax = jnp.max(jnp.where(up2, -y * grad, _NEG_INF))
        gmax2 = jnp.max(jnp.where(low2, y * grad, _NEG_INF))
        return alpha, grad, it + 1, gmax + gmax2

    def cond(state):
        _, _, it, viol = state
        return (it < max_outer) & (viol >= eps)

    alpha, grad, iters, _ = jax.lax.while_loop(
        cond, outer_body, (alpha0, grad0, jnp.int32(0), jnp.float32(jnp.inf))
    )
    alpha, rho = _finalize_rho(alpha, grad, y, C_vec)
    return alpha, rho, iters


@dataclass
class KernelSVC:
    """C-SVC on a precomputed kernel, with optional Platt probabilities.

    fit(gram, y): gram is K[train, train]. predict/decision take
    K[new, train] rows against the same training set.
    """

    C: float = 1.0
    eps: float = 1e-3
    probability: bool = False
    max_iter: int = 10_000_000
    class_weight: Optional[str] = None
    cv_folds: int = 5
    # Platt CV folds: False (default) reproduces the reference's
    # cold-start svm_binary_svc_probability folds (svm.cpp:1913-1999).
    # True warm-starts each fold from the full-problem optimum — faster,
    # but that optimum saw the held-out rows, and because the
    # eps-approximate stopping point is non-unique the fold decision
    # values become weakly dependent on their own labels (a mild
    # calibration leak, bounded by the solver tolerance; AUC measured
    # bit-unchanged on the published suites). Opt in for speed only.
    platt_warm_start: bool = False

    def fit(self, gram: np.ndarray, y) -> "KernelSVC":
        gram = _gram_f32(gram)
        y = np.asarray(y)
        classes = np.unique(y)
        if len(classes) < 2:
            raise ValueError(f"need at least two classes; got {classes}")
        if len(classes) > 2:
            # one-vs-one multiclass, LIBSVM-style (svm.cpp:2163-2358);
            # sklearn-ordered classes_, proba columns follow classes_
            from .ovo import OneVsOneSVC

            self._ovo = OneVsOneSVC(
                lambda: KernelSVC(
                    C=self.C,
                    eps=self.eps,
                    probability=False,
                    max_iter=self.max_iter,
                    class_weight=self.class_weight,
                ),
                probability=self.probability,
                cv_folds=self.cv_folds,
            ).fit(gram, y)
            self.classes_ = classes
            self._proba_order = np.array(
                [self._ovo.classes_.index(c) for c in classes]
            )
            return self
        self._ovo = None
        self.classes_ = classes
        y_signed = np.where(y == classes[1], 1.0, -1.0).astype(np.float32)

        if self.class_weight == "balanced":
            counts = np.array([(y == c).sum() for c in classes], dtype=np.float64)
            cw = len(y) / (2.0 * counts)
            c_vec = np.where(y == classes[1], cw[1], cw[0]) * self.C
        else:
            c_vec = np.full(len(y), self.C)
        c_vec = c_vec.astype(np.float32)

        alpha, rho, iters = self._solve(gram, y_signed, c_vec)
        self.alpha_y_ = alpha * y_signed
        self.rho_ = float(rho)
        self.iters_ = int(iters)
        self.support_ = np.flatnonzero(alpha > 0)

        if self.probability:
            self._fit_platt(gram, y, y_signed, c_vec)
        return self

    # Opt-in experimental routing to _smo_solve_blocked for n >= this
    # value; None = always use the pairwise reference loop. Measured on
    # EP300_47848 (n=6506, on the accelerator this was first built for —
    # not measured on a GPU): the decomposition converges to the
    # same optimum but LOSES — 29,151 outer iterations vs 11,546 pairwise
    # updates (the q-subproblem hits local eps after ~2 updates and the
    # remaining inner steps no-op, so each outer buys ~1 useful update at
    # many times the cost). Kept because the machinery (one-hot row
    # selection, general-box pair updates, frozen duplicate slots) is the
    # substrate for a smarter multi-pair selection rule. ClassVar so the
    # toggle stays a class-level experiment switch and not a dataclass
    # __init__ field.
    BLOCKED_MIN_N: ClassVar[Optional[int]] = None

    def _solve(self, gram, y_signed, c_vec, alpha0=None):
        max_iter = min(self.max_iter, max(10_000_000, 100 * len(y_signed)))
        n = len(y_signed)
        Q = jnp.asarray(gram) * jnp.outer(
            jnp.asarray(y_signed), jnp.asarray(y_signed)
        )
        if alpha0 is None:
            alpha0 = jnp.zeros((n,), jnp.float32)
        args = (
            Q,
            jnp.asarray(y_signed),
            jnp.asarray(c_vec),
            -jnp.ones((n,), jnp.float32),
            jnp.asarray(alpha0, jnp.float32),
            self.eps,
        )
        if self.BLOCKED_MIN_N is not None and n >= max(self.BLOCKED_MIN_N, 64):
            # n >= q is required by the top_k halves inside the blocked
            # solver; small problems (or small CV folds) route to the
            # pairwise loop, which is faster there anyway.
            q = 64
            alpha, rho, iters = _smo_solve_blocked(
                *args, q=q, inner_steps=q,
                max_outer=max(1, max_iter // q),
            )
        else:
            alpha, rho, iters = _smo_solve_general(*args, max_iter)
        return np.asarray(alpha, np.float64), float(rho), int(iters)

    def _fit_platt(self, gram, y, y_signed, c_vec):
        """Cross-validated decision values -> sigmoid (svm.cpp:1913-1999).

        Each fold's SMO is warm-started from the full-problem optimum
        restricted to the fold's training rows (repaired back onto the
        y^T a = 0 constraint by `_restrict_feasible`). The stopping rule
        is a property of the point, not the path (max KKT violation <
        eps, svm.cpp:805-923), so the fold solution meets the identical
        tolerance LIBSVM's cold start does — it just starts much closer:
        measured 3-6x fewer iterations per fold on the published sets.
        """
        folds = stratified_kfold_indices(y, self.cv_folds)
        n = len(y)
        all_idx = np.arange(n)
        alpha_full = self.alpha_y_ * y_signed  # recover alpha >= 0
        dec = np.zeros(n, dtype=np.float64)
        if isinstance(gram, jax.Array):
            # Device Grams: solve each fold ON THE FULL GRAM with the
            # held-out rows' box collapsed to C_i = 0 — a zero-box row
            # can join neither I_up nor I_low (for y=+1, alpha < C reads
            # 0 < 0; for y=-1, alpha > 0 reads 0 > 0), so it is inert and
            # the solve IS the fold subproblem, same eps-KKT contract.
            # This avoids the O(n^2) fold-submatrix gathers and reuses one
            # compiled shape bucket for the main solve and every fold.
            for f in folds:
                c_mask = np.asarray(c_vec, np.float32).copy()
                c_mask[f] = 0.0
                a0 = (
                    _restrict_feasible(alpha_full, y_signed, c_mask)
                    if self.platt_warm_start
                    else None
                )
                a, rho, _ = self._solve(gram, y_signed, c_mask, alpha0=a0)
                coef = jnp.asarray(a * y_signed, jnp.float32)  # 0 on f
                d = jnp.matmul(
                    gram, coef, precision=jax.lax.Precision.HIGHEST
                )
                dec[f] = np.asarray(d, np.float64)[f] - rho
        else:
            for f in folds:
                tr = np.setdiff1d(all_idx, f)
                a0 = (
                    _restrict_feasible(alpha_full[tr], y_signed[tr], c_vec[tr])
                    if self.platt_warm_start
                    else None
                )
                a, rho, _ = self._solve(
                    gram[np.ix_(tr, tr)], y_signed[tr], c_vec[tr], alpha0=a0
                )
                dec[f] = gram[np.ix_(f, tr)] @ (a * y_signed[tr]) - rho
        self.platt_ = sigmoid_train(dec, y_signed)

    def decision_function(self, gram_rows: np.ndarray) -> np.ndarray:
        """gram_rows: K[new, train]. Multiclass: [n, C(nc,2)] pair
        decisions in LIBSVM pair order."""
        if getattr(self, "_ovo", None) is not None:
            return self._ovo.decision_function(gram_rows)
        return _decision_values(gram_rows, self.alpha_y_, self.rho_)

    def predict(self, gram_rows: np.ndarray) -> np.ndarray:
        if getattr(self, "_ovo", None) is not None:
            return self._ovo.predict(gram_rows)
        d = self.decision_function(gram_rows)
        return np.where(d > 0, self.classes_[1], self.classes_[0])

    def predict_proba(self, gram_rows: np.ndarray) -> np.ndarray:
        if not self.probability:
            raise RuntimeError("fit with probability=True for predict_proba")
        if getattr(self, "_ovo", None) is not None:
            return self._ovo.predict_proba(gram_rows)[:, self._proba_order]
        A, B = self.platt_
        p = sigmoid_predict(self.decision_function(gram_rows), A, B)
        return np.stack([1.0 - p, p], axis=1)

    def score(self, gram_rows, y) -> float:
        return float(np.mean(self.predict(gram_rows) == np.asarray(y)))


def save_svm_model(
    path: str, model: "KernelSVC", fmt: str = "npz", svm_type: str = "c_svc"
) -> None:
    """Persist a fitted model: fast ``npz`` (default) or the LIBSVM text
    format (``fmt="libsvm"``, svm.cpp:2672-2758) for interop with tools
    reading precomputed-kernel model files. The npz path only handles
    binary KernelSVC; libsvm covers every solver type."""
    if fmt == "libsvm":
        from .libsvm_io import save_libsvm_model

        save_libsvm_model(path, model, svm_type)
        return
    if fmt != "npz":
        raise ValueError("fmt must be 'npz' or 'libsvm'")
    if getattr(model, "_ovo", None) is not None:
        raise ValueError("multiclass models persist via fmt='libsvm'")
    np.savez(
        path if path.endswith(".npz") else path + ".npz",
        kind=np.bytes_(b"kernel_svc"),
        alpha_y=model.alpha_y_,
        rho=np.float64(model.rho_),
        classes=model.classes_,
        C=np.float64(model.C),
        eps=np.float64(model.eps),
        probability=np.bool_(model.probability),
        platt=np.asarray(getattr(model, "platt_", (0.0, 0.0)), dtype=np.float64),
    )


def load_svm_model(path: str) -> "KernelSVC":
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path, allow_pickle=False) as z:
        if z["kind"].item() != b"kernel_svc":
            raise ValueError(f"not a kernel_svc model file: {path}")
        model = KernelSVC(
            C=float(z["C"]), eps=float(z["eps"]), probability=bool(z["probability"])
        )
        model.alpha_y_ = z["alpha_y"]
        model.rho_ = float(z["rho"])
        model.classes_ = z["classes"]
        model.support_ = np.flatnonzero(model.alpha_y_ != 0)
        if model.probability:
            model.platt_ = tuple(z["platt"])
    return model


@functools.partial(jax.jit, static_argnames=("max_iter",))
def _smo_solve(Q, y, C_vec, eps, max_iter):
    """C-SVC specialization: p = -e, cold start at zero."""
    n = Q.shape[0]
    return _smo_solve_general(
        Q, y, C_vec, -jnp.ones((n,), jnp.float32),
        jnp.zeros((n,), jnp.float32), eps, max_iter
    )


def _restrict_feasible(
    alpha: np.ndarray, y_signed: np.ndarray, c_vec: np.ndarray
) -> np.ndarray:
    """Project a restriction of a feasible alpha back onto the SMO
    feasible set: 0 <= a <= C and y^T a = 0.

    Dropping rows from a full-problem solution leaves a residual
    r = y^T a != 0. Repair by greedily shrinking alphas of the class with
    the surplus (largest first), which keeps every coordinate in its box;
    the surplus class's alpha mass always covers |r| because the other
    class's mass (>= 0) equals it minus r. Exact in f64; the f32 cast
    residual (~sqrt(n) * C * eps_f32) is far below the solver's stopping
    tolerance and the f32 drift of the pair updates themselves.
    """
    a = np.asarray(alpha, np.float64).copy()
    a = np.clip(a, 0.0, np.asarray(c_vec, np.float64))
    r = float(np.dot(a, y_signed))
    if r != 0.0:
        sign = 1.0 if r > 0 else -1.0
        idx = np.flatnonzero((y_signed == sign) & (a > 0))
        order = idx[np.argsort(-a[idx], kind="stable")]
        cum = np.cumsum(a[order])
        take = np.minimum(a[order], np.maximum(0.0, abs(r) - (cum - a[order])))
        a[order] -= take
    return a.astype(np.float32)


@dataclass
class EpsilonSVR:
    """epsilon-SVR on a precomputed kernel (LIBSVM solve_epsilon_svr,
    svm.cpp:1560-1610: the 2n-variable dual with the same SMO core)."""

    C: float = 1.0
    epsilon: float = 0.1  # tube width (LIBSVM's -p)
    eps: float = 1e-3  # stopping tolerance
    max_iter: int = 10_000_000

    def fit(self, gram: np.ndarray, y) -> "EpsilonSVR":
        # the 2n x 2n SVR problem is assembled host-side; device Grams
        # are pulled here (regression sets are small)
        gram = np.asarray(gram, dtype=np.float32)
        y = np.asarray(y, dtype=np.float32)
        n = len(y)
        K2 = np.block([[gram, gram], [gram, gram]])
        y2 = np.concatenate([np.ones(n), -np.ones(n)]).astype(np.float32)
        Q2 = K2 * np.outer(y2, y2)
        p2 = np.concatenate([self.epsilon - y, self.epsilon + y]).astype(np.float32)
        alpha, rho, iters = _smo_solve_general(
            jnp.asarray(Q2),
            jnp.asarray(y2),
            jnp.full(2 * n, self.C, jnp.float32),
            jnp.asarray(p2),
            jnp.zeros(2 * n, jnp.float32),
            self.eps,
            min(self.max_iter, max(10_000_000, 100 * n)),
        )
        alpha = np.asarray(alpha, np.float64)
        self.coef_ = alpha[:n] - alpha[n:]  # a - a*
        self.rho_ = float(rho)
        self.iters_ = int(iters)
        return self

    def predict(self, gram_rows: np.ndarray) -> np.ndarray:
        return _decision_values(gram_rows, self.coef_, self.rho_)

    def score(self, gram_rows, y) -> float:
        from ..metrics import r2_score

        return r2_score(np.asarray(y, np.float64), self.predict(gram_rows))


@dataclass
class OneClassSVM:
    """One-class SVM on a precomputed kernel (LIBSVM solve_one_class,
    svm.cpp:1526-1558: bounds 1, sum(alpha) = nu * l, warm-started at the
    LIBSVM initial point)."""

    nu: float = 0.5
    eps: float = 1e-3
    max_iter: int = 10_000_000

    def fit(self, gram: np.ndarray) -> "OneClassSVM":
        gram = np.asarray(gram, dtype=np.float32)
        n = len(gram)
        alpha0 = np.zeros(n, dtype=np.float32)
        budget = self.nu * n
        full = int(budget)
        alpha0[:full] = 1.0
        if full < n:
            alpha0[full] = budget - full
        alpha, rho, iters = _smo_solve_general(
            jnp.asarray(gram),
            jnp.ones(n, jnp.float32),
            jnp.ones(n, jnp.float32),
            jnp.zeros(n, jnp.float32),
            jnp.asarray(alpha0),
            self.eps,
            min(self.max_iter, max(10_000_000, 100 * n)),
        )
        self.coef_ = np.asarray(alpha, np.float64)
        self.rho_ = float(rho)
        self.iters_ = int(iters)
        return self

    def decision_function(self, gram_rows: np.ndarray) -> np.ndarray:
        return _decision_values(gram_rows, self.coef_, self.rho_)

    def predict(self, gram_rows: np.ndarray) -> np.ndarray:
        return np.where(self.decision_function(gram_rows) > 0, 1, -1)


@functools.partial(jax.jit, static_argnames=("max_iter",))
def _smo_solve_nu(
    Q: jnp.ndarray,  # [n, n] float32, Q = (y y^T) * K
    y: jnp.ndarray,  # [n] float32 {-1, +1}
    C_vec: jnp.ndarray,  # [n] upper bounds
    p: jnp.ndarray,  # [n] linear term
    alpha0: jnp.ndarray,  # feasible start (per-class sums fixed)
    eps: float,
    max_iter: int,
):
    """LIBSVM Solver_NU (svm.cpp:1029-1285): two equality constraints
    (per-class alpha sums are separately conserved), so working-set pairs
    are chosen within a class and the bias splits into rho and r.

    Returns (alpha, rho, r, iters); decision uses rho, and for nu-SVC the
    dual is rescaled by 1/r downstream (svm.cpp:1504-1524).
    """
    # nu solvers always start from a nonzero feasible point; see the
    # precision note in _smo_solve_general.
    grad0 = jnp.matmul(Q, alpha0, precision=jax.lax.Precision.HIGHEST) + p

    def body(state):
        alpha, grad, it, _ = state
        qd = jnp.diagonal(Q)
        # i candidates: y=+1 from {a < C} maximizing -G;
        #               y=-1 from {a > 0} maximizing +G (svm.cpp:1049-1068)
        upP = (y > 0) & (alpha < C_vec)
        lowP = (y > 0) & (alpha > 0)
        upN = (y < 0) & (alpha > 0)
        lowN = (y < 0) & (alpha < C_vec)
        sp = jnp.where(upP, -grad, _NEG_INF)
        gmaxp = jnp.max(sp)
        ip = jnp.argmax(sp)
        sn = jnp.where(upN, grad, _NEG_INF)
        gmaxn = jnp.max(sn)
        in_ = jnp.argmax(sn)
        gmaxp2 = jnp.max(jnp.where(lowP, grad, _NEG_INF))
        gmaxn2 = jnp.max(jnp.where(lowN, -grad, _NEG_INF))

        # j: global second-order choice across both classes (svm.cpp:1078-1127)
        bP = gmaxp + grad
        bN = gmaxn - grad
        aP = qd[ip] + qd - 2.0 * Q[ip, :]
        aN = qd[in_] + qd - 2.0 * Q[in_, :]
        objP = -(bP * bP) / jnp.maximum(aP, _TAU)
        objN = -(bN * bN) / jnp.maximum(aN, _TAU)
        candP = lowP & (bP > 0)
        candN = lowN & (bN > 0)
        obj_all = jnp.where(candP, objP, jnp.where(candN, objN, -_NEG_INF))
        j = jnp.argmin(obj_all)
        i = jnp.where(y[j] > 0, ip, in_)

        quad = qd[i] + qd[j] - 2.0 * Q[i, j]
        quad = jnp.where(quad <= 0, _TAU, quad)
        ai, aj = alpha[i], alpha[j]
        delta = (grad[i] - grad[j]) / quad  # same-class pair update
        s_term = ai + aj
        lo_i = jnp.maximum(0.0, s_term - C_vec[j])
        hi_i = jnp.minimum(C_vec[i], s_term)
        new_ai = jnp.clip(ai - delta, lo_i, hi_i)
        new_aj = s_term - new_ai
        grad = grad + Q[i, :] * (new_ai - ai) + Q[j, :] * (new_aj - aj)
        alpha = alpha.at[i].set(new_ai).at[j].set(new_aj)
        viol = jnp.maximum(gmaxp + gmaxp2, gmaxn + gmaxn2)
        return alpha, grad, it + 1, viol

    def cond(state):
        _, _, it, viol = state
        return (it < max_iter) & (viol >= eps)

    alpha, grad, iters, _ = jax.lax.while_loop(
        cond, body, (alpha0, grad0, jnp.int32(0), jnp.float32(jnp.inf))
    )
    alpha, rho, r = _finalize_nu(alpha, grad, y, C_vec)
    return alpha, rho, r, iters


def _finalize_nu(alpha, grad, y, C_vec):
    """Snap bound residues, then the class-wise bias split: per-class r
    from free-SV gradient averages, falling back to the midpoint of the
    strict bound sets — raw G for BOTH classes, exactly libsvm
    Solver_NU::calculate_rho (svm.cpp:1229-1280): ub from the lower-bound
    set (alpha == 0), lb from the upper-bound set (== C)."""
    alpha = _snap_bounds(alpha, C_vec)

    def class_r(cls):
        mask = y == cls
        free = mask & (alpha > 0) & (alpha < C_vec)
        nfree = jnp.sum(free)
        gsum = jnp.sum(jnp.where(free, grad, 0.0))
        ub = jnp.min(jnp.where(mask & (alpha <= 0), grad, -_NEG_INF))
        lb = jnp.max(jnp.where(mask & (alpha >= C_vec), grad, _NEG_INF))
        return jnp.where(nfree > 0, gsum / nfree, (ub + lb) / 2.0)

    r1 = class_r(1.0)
    r2 = class_r(-1.0)
    # svm.cpp:1276-1279: si->rho = (r1 - r2)/2, si->r = (r1 + r2)/2
    rho = (r1 - r2) / 2.0
    r = (r1 + r2) / 2.0
    return alpha, rho, r


@dataclass
class NuSVC:
    """nu-SVC on a precomputed kernel (LIBSVM solve_nu_svc,
    svm.cpp:1496-1524: Solver_NU then rescale the dual by 1/r)."""

    nu: float = 0.5
    eps: float = 1e-3
    probability: bool = False
    max_iter: int = 10_000_000
    cv_folds: int = 5

    def fit(self, gram: np.ndarray, y) -> "NuSVC":
        gram = _gram_f32(gram)
        y = np.asarray(y)
        classes = np.unique(y)
        if len(classes) < 2:
            raise ValueError(f"need at least two classes; got {classes}")
        if len(classes) > 2:
            from .ovo import OneVsOneSVC

            self._ovo = OneVsOneSVC(
                lambda: NuSVC(nu=self.nu, eps=self.eps, max_iter=self.max_iter),
                probability=self.probability,
                cv_folds=self.cv_folds,
            ).fit(gram, y)
            self.classes_ = classes
            self._proba_order = np.array(
                [self._ovo.classes_.index(c) for c in classes]
            )
            return self
        self._ovo = None
        if self.probability:
            from .ovo import platt_cv_binary

            ys01 = np.where(y == classes[1], 1.0, -1.0)
            self.platt_ = platt_cv_binary(
                lambda: NuSVC(nu=self.nu, eps=self.eps, max_iter=self.max_iter),
                gram if isinstance(gram, jax.Array) else np.asarray(gram, np.float64),
                ys01,
                self.cv_folds,
            )
        self.classes_ = classes
        ys = np.where(y == classes[1], 1.0, -1.0).astype(np.float32)
        n = len(y)
        n_pos = int((ys > 0).sum())
        n_neg = n - n_pos
        budget = self.nu * n / 2.0
        if budget > min(n_pos, n_neg):
            raise ValueError("nu is infeasible for this class balance")

        # LIBSVM initial point: fill each class greedily up to the budget
        alpha0 = np.zeros(n, dtype=np.float32)
        for cls in (1.0, -1.0):
            left = budget
            for idx in np.flatnonzero(ys == cls):
                take = min(1.0, left)
                alpha0[idx] = take
                left -= take
                if left <= 0:
                    break
        Q = gram * np.outer(ys, ys)
        alpha, rho, r, iters = _smo_solve_nu(
            jnp.asarray(Q),
            jnp.asarray(ys),
            jnp.ones(n, jnp.float32),
            jnp.zeros(n, jnp.float32),
            jnp.asarray(alpha0),
            self.eps,
            min(self.max_iter, max(10_000_000, 100 * n)),
        )
        r = float(r)
        scale = 1.0 / r if r != 0 else 1.0
        self.alpha_y_ = np.asarray(alpha, np.float64) * ys * scale
        self.rho_ = float(rho) * scale
        self.iters_ = int(iters)
        return self

    def decision_function(self, gram_rows: np.ndarray) -> np.ndarray:
        if getattr(self, "_ovo", None) is not None:
            return self._ovo.decision_function(gram_rows)
        return _decision_values(gram_rows, self.alpha_y_, self.rho_)

    def predict(self, gram_rows: np.ndarray) -> np.ndarray:
        if getattr(self, "_ovo", None) is not None:
            return self._ovo.predict(gram_rows)
        d = self.decision_function(gram_rows)
        return np.where(d > 0, self.classes_[1], self.classes_[0])

    def predict_proba(self, gram_rows: np.ndarray) -> np.ndarray:
        if not self.probability:
            raise RuntimeError("fit with probability=True for predict_proba")
        if getattr(self, "_ovo", None) is not None:
            return self._ovo.predict_proba(gram_rows)[:, self._proba_order]
        A, B = self.platt_
        p = sigmoid_predict(self.decision_function(gram_rows), A, B)
        return np.stack([1.0 - p, p], axis=1)


@dataclass
class NuSVR:
    """nu-SVR on a precomputed kernel (LIBSVM solve_nu_svr,
    svm.cpp:1611-1655: 2n-variable Solver_NU, epsilon replaced by nu)."""

    C: float = 1.0
    nu: float = 0.5
    eps: float = 1e-3
    max_iter: int = 10_000_000

    def fit(self, gram: np.ndarray, y) -> "NuSVR":
        gram = np.asarray(gram, dtype=np.float32)
        y = np.asarray(y, dtype=np.float32)
        n = len(y)
        K2 = np.block([[gram, gram], [gram, gram]])
        y2 = np.concatenate([np.ones(n), -np.ones(n)]).astype(np.float32)
        Q2 = K2 * np.outer(y2, y2)
        p2 = np.concatenate([-y, y]).astype(np.float32)
        # initial point: sum C*nu*l/2 spread per LIBSVM
        alpha0 = np.zeros(2 * n, dtype=np.float32)
        left = self.C * self.nu * n / 2.0
        for i in range(n):
            take = min(self.C, left)
            alpha0[i] = alpha0[n + i] = take
            left -= take
            if left <= 0:
                break
        alpha, rho, r, iters = _smo_solve_nu(
            jnp.asarray(Q2),
            jnp.asarray(y2),
            jnp.full(2 * n, self.C, jnp.float32),
            jnp.asarray(p2),
            jnp.asarray(alpha0),
            self.eps,
            min(self.max_iter, max(10_000_000, 200 * n)),
        )
        alpha = np.asarray(alpha, np.float64)
        self.coef_ = alpha[:n] - alpha[n:]
        self.rho_ = float(rho)
        self.iters_ = int(iters)
        return self

    def predict(self, gram_rows: np.ndarray) -> np.ndarray:
        return _decision_values(gram_rows, self.coef_, self.rho_)

    def score(self, gram_rows, y) -> float:
        from ..metrics import r2_score

        return r2_score(np.asarray(y, np.float64), self.predict(gram_rows))
