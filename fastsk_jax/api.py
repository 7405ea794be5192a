"""User-facing FastSK model class.

Signature-compatible with the reference Python surface (bindings.cpp:12-51):
``FastSK(g, m, t=-1, approx=False, delta=0.025, max_iters=-1,
skip_variance=False)`` plus ``compute_kernel / compute_train /
get_train_kernel / get_test_kernel / get_stdevs / save_kernel / fit /
score``. Differences are deliberate improvements:

- ``t`` (thread count) is accepted for compatibility but parallelism is
  device-mesh driven (``KernelConfig.mesh``), not thread driven.
- approx mode is deterministic given ``seed`` (the reference seeds its work
  queue shuffle with time(0), fastsk_kernel.cpp:37).
- labels can be passed to ``compute_kernel`` (or via ``set_labels``) so
  ``fit``/``score`` actually work end-to-end — in the reference's released
  Python bindings the label members are never populated.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .kernel.config import KernelConfig
from .kernel.engine import ApproxResult, DenseGkmEngine, cosine_normalize
from .kernel.sorted_engine import SortedGkmEngine
from .ops.encode import EncodedSeqs, encode_sequences, validate_g


def _collapse_shards(arr):
    """A mesh-sharded device array -> one device (device-to-device
    collect, no host round-trip): the SVM solvers and decision matvecs
    are single-device programs.

    Across PROCESS boundaries a single-device collapse is impossible
    (the target device is unaddressable from the other hosts), so the
    array collapses to fully-replicated on the same mesh instead: every
    process then holds a complete copy and the downstream solver runs as
    identical SPMD replicas — the multi-host fit/score path
    (tests/test_multihost.py)."""
    import jax

    if not isinstance(arr, jax.Array) or len(arr.sharding.device_set) <= 1:
        return arr
    devs = arr.sharding.device_set
    if len({d.process_index for d in devs}) == 1:
        return jax.device_put(arr, sorted(devs, key=str)[0])
    sh = arr.sharding
    if isinstance(sh, jax.sharding.NamedSharding):
        rep = jax.sharding.NamedSharding(
            sh.mesh, jax.sharding.PartitionSpec()
        )
        return jax.device_put(arr, rep)
    return arr


class FastSK:
    def __init__(
        self,
        g: int,
        m: int,
        t: int = -1,
        approx: bool = False,
        delta: float = 0.025,
        max_iters: int = -1,
        skip_variance: bool = False,
        seed: int = 0,
        config: Optional[KernelConfig] = None,
    ):
        self.g = int(g)
        self.m = int(m)
        self.k = self.g - self.m
        self.t = t  # accepted for API parity; see module docstring
        self.approx = bool(approx)
        self.delta = float(delta)
        self.max_iters = int(max_iters)
        self.skip_variance = bool(skip_variance)
        self.seed = int(seed)
        self.config = config or KernelConfig()

        # Persistent compile cache for every entry point that constructs
        # a model (CLI, smoke, experiments, user code), so cold processes
        # reuse prior compiles (utils/observe.compilation_cache_dir).
        from .utils.observe import enable_compilation_cache

        enable_compilation_cache()

        self._counts: Optional[np.ndarray] = None  # int64 [N, N]
        self._K: Optional[np.ndarray] = None  # float64 normalized [N, N]
        self._counts_dev = None  # DeviceCounts (device-resident mode)
        self._K_dev = None  # f32 normalized, on device
        self._stdevs: List[float] = []
        self._iters: int = 0
        self.n_str_train = 0
        self.n_str_test = 0
        self.train_labels: Optional[np.ndarray] = None
        self.test_labels: Optional[np.ndarray] = None
        self._model = None

    # ------------------------------------------------------------ kernel

    def _make_engine(self, enc: EncodedSeqs):
        b_total = enc.hash_base ** self.k
        if b_total <= self.config.b_max_dense:
            return DenseGkmEngine(enc, self.g, self.m, self.config)
        return SortedGkmEngine(enc, self.g, self.m, self.config)

    def _make_exact_engine(self, enc: EncodedSeqs):
        """Exact mode prefers the all-pairs engines (single fused sweep over
        window pairs, no C(g,m) pass loop): the seq-aligned one when
        lengths are near-uniform, the packed one on ragged data or when
        the seq-aligned int32 bound rejects the shape; the theta engine is
        the forced/fallback path."""
        from .kernel.pairs_engine import PackedPairsEngine, PairsGkmEngine

        choice = self.config.exact_engine
        if choice not in ("auto", "pairs", "packed", "theta"):
            raise ValueError(f"unknown exact_engine {choice!r}")
        if choice == "theta":
            return self._make_engine(enc)
        if choice == "packed":
            return PackedPairsEngine(enc, self.g, self.m, self.config)
        windows = enc.num_windows(self.g)
        waste = enc.n * ((int(windows.max()) + 7) // 8 * 8) / max(
            int(((windows + 7) // 8 * 8).sum()), 1
        )
        try:
            if choice == "auto" and waste > 1.5:
                return PackedPairsEngine(enc, self.g, self.m, self.config)
            return PairsGkmEngine(enc, self.g, self.m, self.config)
        except ValueError:
            if choice == "pairs":
                raise
            try:
                return PackedPairsEngine(enc, self.g, self.m, self.config)
            except ValueError:
                pass
            return self._make_engine(enc)

    def _compute(self, enc: EncodedSeqs) -> None:
        validate_g(enc, self.g, self.m)
        engine = (
            self._make_engine(enc) if self.approx else self._make_exact_engine(enc)
        )
        # device-resident mode: keep the counts on device and defer the
        # O(N^2) host pull (the workflow bottleneck through the remote
        # until the host matrix is explicitly accessed; fit/score
        # consume the kernel on device (kernel/device_counts.py).
        # Checkpointed device runs snapshot to host at the opt-in cadence
        # but the result stays on device; under a mesh the dense engine
        # keeps ROWS-SHARDED DeviceCounts (other engines' mesh paths
        # accumulate to host and fall through).
        use_dev = self.config.device_resident
        if self.config.mesh is not None and not isinstance(
            engine, DenseGkmEngine
        ):
            use_dev = False
        if self.config.checkpoint_path is not None and not (
            isinstance(engine, DenseGkmEngine) and self.config.mesh is None
        ):
            # only the single-device dense engine checkpoints its
            # device-resident accumulation; a requested checkpoint must
            # never be silently ignored — fall back to the host
            # (checkpointable) paths for every other engine/mesh combo
            use_dev = False
        self._counts_dev = None
        self._K_dev = None
        if self.approx:
            # approx device_out stays single-device/non-checkpointed (the
            # Welford state is not checkpointed on device)
            dev_ok = (
                use_dev
                and self.config.mesh is None
                and self.config.checkpoint_path is None
                and isinstance(engine, (DenseGkmEngine, SortedGkmEngine))
            )
            res: ApproxResult = engine.approx(
                conv_delta=self.delta,
                max_iters=self.max_iters,
                skip_variance=self.skip_variance,
                seed=self.seed,
                **({"device_out": True} if dev_ok else {}),
            )
            self._stdevs = res.stdevs
            self._iters = res.iters
            counts = res.counts
        else:
            if use_dev and hasattr(engine, "exact_device"):
                counts = engine.exact_device()
            else:
                counts = engine.exact()
            self._iters = 0
            self._stdevs = []
        if isinstance(counts, np.ndarray):
            self._counts = counts
            self._K = cosine_normalize(counts)
        else:  # DeviceCounts
            self._counts_dev = counts
            self._K_dev = counts.normalized_f32()
            self._counts = None
            self._K = None
        self.n_str_train = enc.n_train
        self.n_str_test = enc.n_test
        # total g-mer count across all sequences — the reference's nfeat
        # (fastsk.cpp:117: features->n), used as the rbf gamma denominator
        self.nfeat = int(enc.num_windows(self.g).sum())

    def compute_kernel(
        self,
        Xtrain: Sequence[Sequence[int]],
        Xtest: Sequence[Sequence[int]],
        Ytrain: Optional[Sequence[int]] = None,
        Ytest: Optional[Sequence[int]] = None,
    ) -> None:
        """Compute the joint (train+test) normalized kernel matrix."""
        enc = encode_sequences(Xtrain, Xtest)
        self._compute(enc)
        if Ytrain is not None:
            self.train_labels = np.asarray(Ytrain)
        if Ytest is not None:
            self.test_labels = np.asarray(Ytest)

    def compute_train(self, Xtrain: Sequence[Sequence[int]], Ytrain=None) -> None:
        """Compute the train-only kernel matrix."""
        enc = encode_sequences(Xtrain, None)
        self._compute(enc)
        if Ytrain is not None:
            self.train_labels = np.asarray(Ytrain)

    def set_labels(self, Ytrain: Sequence[int], Ytest: Optional[Sequence[int]] = None):
        self.train_labels = np.asarray(Ytrain)
        if Ytest is not None:
            self.test_labels = np.asarray(Ytest)

    # ------------------------------------------------------------ access

    def _require_kernel(self) -> np.ndarray:
        if self._K is None:
            # device-resident run, host matrix explicitly requested:
            # materialize once (exact integer pull + f64 normalization,
            # identical to the host-path result)
            self._K = cosine_normalize(self.kernel_counts)
        return self._K

    @property
    def kernel(self) -> np.ndarray:
        """Full normalized (train+test) kernel matrix, float64 [N, N]."""
        return self._require_kernel()

    @property
    def kernel_counts(self) -> np.ndarray:
        """Unnormalized integer count kernel, int64 [N, N] (pulled from
        the device lazily in device-resident mode, without paying the
        f64 normalization the `kernel` property adds)."""
        if self._counts is None:
            if self._counts_dev is None:
                raise RuntimeError("call compute_kernel or compute_train first")
            self._counts = self._counts_dev.to_host_int64()
        return self._counts

    def get_train_kernel(self) -> List[List[float]]:
        """Train block of the normalized kernel (fastsk.cpp:190-200)."""
        k = self._require_kernel()
        ntr = self.n_str_train
        return k[:ntr, :ntr].tolist()

    def get_test_kernel(self) -> List[List[float]]:
        """Test-vs-train block of the normalized kernel (fastsk.cpp:202-217)."""
        k = self._require_kernel()
        ntr = self.n_str_train
        return k[ntr:, :ntr].tolist()

    def get_stdevs(self) -> List[float]:
        """Per-iteration convergence sd trace (approx mode)."""
        return list(self._stdevs)

    @property
    def iterations(self) -> int:
        """Number of Monte-Carlo iterations consumed (approx mode)."""
        return self._iters

    def save_kernel(self, kernel_file: str) -> None:
        """Write the kernel: the reference text format (fastsk.cpp:223-237,
        one row of 1-indexed ``col:value`` pairs per sequence) by default,
        or fast binary ``.npy``/``.npz`` (with counts + split sizes) when
        the filename says so — the text format is quadratic in python-loop
        time and impractical at 7k+ sequences."""
        k = self._require_kernel()
        if kernel_file.endswith(".npy"):
            np.save(kernel_file, k)
            return
        if kernel_file.endswith(".npz"):
            np.savez_compressed(
                kernel_file,
                kernel=k,
                counts=self._counts,
                n_train=np.int64(self.n_str_train),
                n_test=np.int64(self.n_str_test),
            )
            return
        n = k.shape[0]
        with open(kernel_file, "w") as f:
            for i in range(n):
                f.write(
                    "".join(f"{j + 1}:{k[i, j]:e} " for j in range(n))
                )
                f.write("\n")

    # ------------------------------------------------------------ svm

    def fit(
        self,
        C: float = 1.0,
        nu: float = 0.5,
        eps: float = 0.001,
        kernel_type: str = "linear",
        svm_type: str = "c_svc",
    ) -> None:
        """Train an SVM on the computed kernel (defaults match
        bindings.cpp:36-41). ``kernel_type``:

        - "fastsk": SVM directly on the precomputed gkm kernel
        - "linear": SVM with a linear kernel over kernel rows (the
          reference's default — kernel rows as an empirical kernel map)
        - "rbf":    SVM with an RBF kernel over kernel rows,
          gamma = 1/nfeat (fastsk.cpp:273)

        ``svm_type`` selects the solver, like LIBSVM's -s
        (svm_parameter.svm_type, svm.h:26; the reference's FastSK class
        pins C_SVC, fastsk.hpp:19, but the full LIBSVM surface is part of
        its capability set): "c_svc" (default), "nu_svc", "one_class",
        "epsilon_svr", "nu_svr". ``nu`` parameterizes the nu_* and
        one_class solvers — the reference accepts it but C_SVC ignores it.
        Multiclass labels train one-vs-one automatically (svm.cpp:2163+).
        """
        from .svm.kernel_svm import (
            EpsilonSVR,
            KernelSVC,
            NuSVC,
            NuSVR,
            OneClassSVM,
        )

        if svm_type not in ("c_svc", "nu_svc", "one_class", "epsilon_svr", "nu_svr"):
            raise ValueError(
                "svm_type must be one of c_svc, nu_svc, one_class, "
                f"epsilon_svr, nu_svr; got {svm_type!r}"
            )
        needs_labels = svm_type != "one_class"
        if needs_labels and self.train_labels is None:
            raise RuntimeError(
                "labels are required: pass Ytrain to compute_kernel or call set_labels"
            )
        if kernel_type not in ("fastsk", "linear", "rbf"):
            raise ValueError("kernel must be 'linear', 'fastsk', or 'rbf'")
        ntr = self.n_str_train
        if self._K_dev is not None:
            # stays on device; mesh-sharded kernels collapse to one chip
            rows_train = _collapse_shards(self._K_dev[:ntr, :ntr])
        else:
            rows_train = self._require_kernel()[:ntr, :ntr]
        gram = self._build_gram(rows_train, rows_train, kernel_type)
        self._fit_kernel_type = kernel_type
        self._fit_svm_type = svm_type
        if svm_type == "c_svc":
            self._model = KernelSVC(C=C, eps=eps, probability=True).fit(
                gram, np.asarray(self.train_labels)
            )
        elif svm_type == "nu_svc":
            self._model = NuSVC(nu=nu, eps=eps, probability=True).fit(
                gram, np.asarray(self.train_labels)
            )
        elif svm_type == "one_class":
            self._model = OneClassSVM(nu=nu, eps=eps).fit(gram)
        elif svm_type == "epsilon_svr":
            self._model = EpsilonSVR(C=C, eps=eps).fit(
                gram, np.asarray(self.train_labels)
            )
        else:  # nu_svr
            self._model = NuSVR(C=C, nu=nu, eps=eps).fit(
                gram, np.asarray(self.train_labels)
            )

    def _build_gram(self, rows_a, rows_train, kernel_type: str):
        """Gram of ``rows_a`` against ``rows_train`` under ``kernel_type``.

        Rows are normalized-kernel rows: np float64 on the host path, jax
        f32 on the device-resident path — device Grams are built on device
        (the EKM ``rows @ rows.T`` runs at HIGHEST precision)
        so fit/score never pull the O(N^2) matrices.
        """
        if kernel_type == "fastsk":
            return rows_a
        import jax
        import jax.numpy as jnp

        on_dev = isinstance(rows_a, jax.Array)
        if on_dev:
            xp = jnp

            def dot(a, b):
                return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)

        else:
            xp = np

            def dot(a, b):
                return a @ b

        if kernel_type == "linear":
            return dot(rows_a, rows_train.T)
        # rbf, gamma = 1/nfeat (fastsk.cpp:273)
        gamma = 1.0 / max(self.nfeat, 1)
        sq_a = xp.sum(rows_a**2, axis=1)
        sq_t = xp.sum(rows_train**2, axis=1)
        return xp.exp(
            -gamma * (sq_a[:, None] + sq_t[None, :] - 2 * dot(rows_a, rows_train.T))
        )

    def _test_gram(self) -> np.ndarray:
        """Test-vs-train Gram matrix under the fitted kernel_type (on
        device when the kernel is device-resident)."""
        ntr = self.n_str_train
        if self._K_dev is not None:
            rows_train = _collapse_shards(self._K_dev[:ntr, :ntr])
            rows_test = _collapse_shards(self._K_dev[ntr:, :ntr])
        else:
            k = self._require_kernel()
            rows_train = k[:ntr, :ntr]
            rows_test = k[ntr:, :ntr]
        return self._build_gram(rows_test, rows_train, self._fit_kernel_type)

    def score(self, metric: str = "auc") -> float:
        """Predict on the test block and report accuracy or AUROC
        (fastsk.cpp:418-530, minus the unconditional auc_file.txt side
        effect)."""
        from .metrics import accuracy_score, auc_pairwise, r2_score

        if metric not in ("accuracy", "auc", "r2"):
            raise ValueError("metric argument must be 'accuracy', 'auc', or 'r2'")
        if self._model is None:
            raise RuntimeError("call fit() first")
        if self.test_labels is None:
            raise RuntimeError("test labels are required for score()")
        gram_test = self._test_gram()
        y_test = np.asarray(self.test_labels)
        svm_type = getattr(self, "_fit_svm_type", "c_svc")
        if svm_type in ("epsilon_svr", "nu_svr"):
            if metric != "r2":
                raise ValueError("regression models score with metric='r2'")
            return r2_score(
                y_test.astype(np.float64), self._model.predict(gram_test)
            )
        preds = self._model.predict(gram_test)
        if metric == "auc":
            if svm_type == "one_class" or len(self._model.classes_) != 2:
                raise ValueError(
                    "metric='auc' requires a binary classifier; use 'accuracy'"
                )
            probs = self._model.predict_proba(gram_test)[:, 1]
            return auc_pairwise(y_test, probs)
        if metric == "r2":
            raise ValueError("metric='r2' is for the SVR types")
        return accuracy_score(y_test, preds) * 100.0

    def save_predictions(self, path: str) -> None:
        """Write per-test-point ``label value`` lines — the reference's
        auc_file.txt side effect (fastsk.cpp:447-476, 502), opt-in here
        instead of unconditional. ``value`` is the positive-class
        probability for binary classifiers, the predicted value for SVR
        types, and the predicted class otherwise."""
        if self._model is None:
            raise RuntimeError("call fit() first")
        if self.test_labels is None:
            raise RuntimeError("test labels are required")
        gram_test = self._test_gram()
        svm_type = getattr(self, "_fit_svm_type", "c_svc")
        if svm_type in ("epsilon_svr", "nu_svr"):
            vals = self._model.predict(gram_test)
        elif (
            len(getattr(self._model, "classes_", [])) == 2
            and getattr(self._model, "probability", False)
        ):
            vals = self._model.predict_proba(gram_test)[:, 1]
        else:
            vals = self._model.predict(gram_test)
        with open(path, "w") as f:
            for label, v in zip(np.asarray(self.test_labels), vals):
                f.write(f"{label} {v}\n")

    def score_report(self) -> dict:
        """Full scoring report: acc, AUROC, TPR/TNR/FNR/FPR — everything
        the reference's score() prints (fastsk.cpp:508-529), as a dict."""
        from .metrics import accuracy_score, auc_pairwise, confusion_rates

        if self._model is None:
            raise RuntimeError("call fit() first")
        if self.test_labels is None:
            raise RuntimeError("test labels are required")
        gram_test = self._test_gram()
        y = np.asarray(self.test_labels)
        preds = self._model.predict(gram_test)
        out = {"accuracy": accuracy_score(y, preds)}
        if len(getattr(self._model, "classes_", [])) == 2:
            probs = self._model.predict_proba(gram_test)[:, 1]
            out["auc"] = auc_pairwise(y, probs)
            out.update(confusion_rates(y, preds))
        return out
