"""Runner library — the workflow every published FastSK number came from.

Mirrors the reference's FastskRunner / FastskRegressor / time_fastsk
(test/utils.py:15-104, 393-445; old_utils.py:452-499): read a dataset
pair, compute the gkm kernel, train a calibrated linear SVM on the kernel
rows (empirical kernel map) or LassoCV for regression, and report
acc/AUC/r². The timing helper runs the kernel in a subprocess with a
kill-on-timeout, like the reference's multiprocessing wrapper
(test/utils.py:33-53), because exact mode at extreme g/m can run long.
"""

from __future__ import annotations

import multiprocessing
import os
import os.path as osp
import time
from typing import Optional

import numpy as np

from ..api import FastSK
from ..io.fasta import FastaUtility
from ..kernel.config import KernelConfig
from ..metrics import roc_auc
from ..svm.linear import CalibratedLinearSVC


# the in-repo corpora (EP300, KAT2B) as gkm-SVM pos/neg splits
CORPORA = osp.join(
    osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__)))),
    "experiments", "results_baselines", "tmp",
)
DATA_LOCATIONS = ("data", CORPORA)


def read_split(prefix: str, data_locations=DATA_LOCATIONS, reader=None):
    """``(Xtrain, Ytrain, Xtest, Ytest)`` of dataset ``prefix`` from the
    first location holding ``<prefix>.train.fasta`` (``>label`` headers)
    or ``<prefix>.train.pos.fasta`` (pos/neg split, labels 1/0)."""
    reader = reader or FastaUtility()
    for loc in data_locations:
        base = osp.join(loc, prefix)
        if osp.exists(f"{base}.train.fasta"):
            return (*reader.read_data(f"{base}.train.fasta"),
                    *reader.read_data(f"{base}.test.fasta"))
        if osp.exists(f"{base}.train.pos.fasta"):
            return (*reader.read_pos_neg(f"{base}.train"),
                    *reader.read_pos_neg(f"{base}.test"))
    raise FileNotFoundError(f"no {prefix} split under {data_locations}")


class FastskRunner:
    """fasta pair -> kernel -> calibrated LinearSVC on the EKM -> acc/auc."""

    def __init__(self, prefix: str, data_locations=DATA_LOCATIONS):
        self.prefix = prefix
        (self.train_seq, self.Ytrain,
         self.test_seq, self.Ytest) = read_split(prefix, data_locations)

    def compute_kernel(
        self,
        g: int,
        m: int,
        t: int = -1,
        approx: bool = False,
        I: int = -1,
        delta: float = 0.025,
        skip_variance: bool = False,
        config: Optional[KernelConfig] = None,
    ) -> FastSK:
        fsk = FastSK(
            g=g, m=m, t=t, approx=approx, delta=delta,
            max_iters=I, skip_variance=skip_variance, config=config,
        )
        fsk.compute_kernel(self.train_seq, self.test_seq, self.Ytrain, self.Ytest)
        return fsk

    def train_and_test(
        self,
        g: int,
        m: int,
        t: int = -1,
        approx: bool = False,
        I: int = -1,
        delta: float = 0.025,
        skip_variance: bool = False,
        C: float = 1.0,
        config: Optional[KernelConfig] = None,
    ) -> dict:
        fsk = self.compute_kernel(
            g, m, t=t, approx=approx, I=I, delta=delta,
            skip_variance=skip_variance, config=config,
        )
        Xtrain = np.array(fsk.get_train_kernel())
        Xtest = np.array(fsk.get_test_kernel())
        clf = CalibratedLinearSVC(C=C, class_weight="balanced").fit(
            Xtrain, self.Ytrain
        )
        acc = clf.score(Xtest, self.Ytest)
        probs = clf.predict_proba(Xtest)[:, 1]
        auc = roc_auc(self.Ytest, probs)
        return {"acc": acc, "auc": auc, "iters": fsk.iterations}


class FastskRegressor:
    """fasta pair with float labels -> kernel -> LassoCV -> r^2
    (old_utils.py:452-499)."""

    def __init__(self, prefix: str, data_locations=DATA_LOCATIONS):
        loc = next(
            (d for d in data_locations if osp.exists(osp.join(d, f"{prefix}.train.fasta"))),
            None,
        )
        if loc is None:
            raise FileNotFoundError(f"no {prefix}.train.fasta under {data_locations}")
        reader = FastaUtility()
        self.train_seq, ytr = reader.read_data(
            osp.join(loc, f"{prefix}.train.fasta"), regression=True
        )
        self.test_seq, yte = reader.read_data(
            osp.join(loc, f"{prefix}.test.fasta"), regression=True
        )
        self.Ytrain = np.asarray(ytr, dtype=np.float64)
        self.Ytest = np.asarray(yte, dtype=np.float64)

    def train_and_test(
        self,
        g: int,
        m: int,
        t: int = -1,
        approx: bool = True,
        I: int = 100,
        delta: float = 0.025,
        skip_variance: bool = False,
    ) -> float:
        from ..svm.lasso import LassoCV

        fsk = FastSK(
            g=g, m=m, t=t, approx=approx, delta=delta,
            max_iters=I, skip_variance=skip_variance,
        )
        fsk.compute_kernel(self.train_seq, self.test_seq)
        Xtrain = np.array(fsk.get_train_kernel())
        Xtest = np.array(fsk.get_test_kernel())
        model = LassoCV(cv=5, random_state=293).fit(Xtrain, self.Ytrain)
        return model.score(Xtest, self.Ytest)


def _timed_child(queue, prefix, kwargs, steady_runs):
    from ..utils.observe import enable_compilation_cache

    enable_compilation_cache()
    runner = FastskRunner(prefix)
    t0 = time.time()
    runner.compute_kernel(**kwargs)
    first = time.time() - t0
    steady = first
    for _ in range(steady_runs):
        runner2 = FastskRunner(prefix)  # fresh buffers; jit caches persist
        t0 = time.time()
        runner2.compute_kernel(**kwargs)
        steady = min(steady, time.time() - t0)
    queue.put((first, steady))


def time_fastsk(
    g: int,
    m: int,
    t: int = -1,
    prefix: str = "EP300",
    approx: bool = False,
    I: int = -1,
    skip_variance: bool = False,
    timeout: Optional[float] = None,
    detail: bool = False,
    steady_runs: int = 1,
):
    """Kernel wall-clock with a kill-on-timeout subprocess wrapper.

    With ``detail=True`` returns ``(first_s, steady_s, timed_out)`` where
    ``first_s`` includes jit compilation and ``steady_s`` is the best of
    ``steady_runs`` re-runs with warm caches, so
    experiment CSVs aren't dominated by compile noise (the reference's
    wrapper, test/utils.py:15-66, cannot distinguish the two). Without
    ``detail`` returns the steady seconds (or ``timeout`` if killed).

    With a ``timeout`` the timing runs in a spawned child, which opens the
    device; this parent stays off it. A JAX process reserves most of a
    GPU's memory when it first touches it, so a caller that has already
    used the GPU must time in-process (``timeout=None``) instead.
    """
    kwargs = dict(g=g, m=m, t=t, approx=approx, I=I, skip_variance=skip_variance)
    if timeout is None:
        q: multiprocessing.Queue = multiprocessing.Queue()
        _timed_child(q, prefix, kwargs, steady_runs)
        first, steady = q.get()
        return (first, steady, False) if detail else steady
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    proc = ctx.Process(
        target=_timed_child, args=(q, prefix, kwargs, steady_runs)
    )
    proc.start()
    proc.join(timeout)
    if proc.is_alive():
        proc.terminate()
        proc.join()
        to = float(timeout)
        return (to, to, True) if detail else to
    try:
        # the child can CRASH without posting a result (engine rejection,
        # OOM, device error): a bare q.get() would then block forever and
        # hang the whole sweep — surface the failure instead
        first, steady = q.get(timeout=5)
    except Exception:
        raise RuntimeError(
            f"timed child exited (code {proc.exitcode}) without a result "
            f"for g={g} m={m} prefix={prefix}"
        ) from None
    return (first, steady, False) if detail else steady


class FastskMulticlassRunner:
    """TSV multiclass workflow (MADAR Arabic / DSL): kernel -> one-vs-rest
    linear SVC on the EKM -> accuracy (the reference handles these sets
    through sklearn's built-in OvR, test/utils.py:307-391)."""

    def __init__(self, train_file: str, test_file: str, reader=None):
        from ..io.readers import DslUtility

        if reader is None:
            if train_file.endswith(".fasta"):
                # webkb/sentiment ship as FASTA with integer labels beyond
                # {-1,0,1}; read them through the multiclass FASTA path.
                fasta = FastaUtility()
                self.train_seq, self.Ytrain = fasta.read_data(
                    train_file, multiclass=True
                )
                self.test_seq, self.Ytest = fasta.read_data(
                    test_file, multiclass=True
                )
                return
            reader = DslUtility()
        self.train_seq, self.Ytrain = reader.read_data(train_file)
        self.test_seq, self.Ytest = reader.read_data(test_file)

    def train_and_test(
        self,
        g: int,
        m: int,
        approx: bool = True,
        I: int = 50,
        C: float = 1.0,
        skip_variance: bool = True,
        svm: str = "linear_ovr",
    ) -> dict:
        """``svm``: "linear_ovr" = one-vs-rest linear SVC on the EKM (the
        reference's sklearn path); "kernel_ovo" = LIBSVM-style one-vs-one
        C-SVC directly on the precomputed kernel (svm/ovo.py)."""
        fsk = FastSK(
            g=g, m=m, approx=approx, max_iters=I, skip_variance=skip_variance
        )
        fsk.compute_kernel(self.train_seq, self.test_seq)
        if svm == "kernel_ovo":
            from ..svm.kernel_svm import KernelSVC

            k = fsk.kernel
            ntr = fsk.n_str_train
            clf = KernelSVC(C=C).fit(k[:ntr, :ntr], np.asarray(self.Ytrain))
            preds = clf.predict(k[ntr:, :ntr])
            return {"acc": float(np.mean(preds == np.asarray(self.Ytest)))}
        from ..svm.linear import MulticlassLinearSVC

        Xtrain = np.array(fsk.get_train_kernel())
        Xtest = np.array(fsk.get_test_kernel())
        clf = MulticlassLinearSVC(C=C).fit(Xtrain, self.Ytrain)
        return {"acc": clf.score(Xtest, self.Ytest)}
