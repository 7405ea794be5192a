"""CLI, checkpoint/resume, and model/kernel persistence tests."""

import os

import numpy as np
import pytest

from fastsk_jax import FastSK, KernelConfig
from fastsk_jax.cli import main as cli_main
from fastsk_jax.io.fasta import load_kernel
from fastsk_jax.svm.kernel_svm import KernelSVC, load_svm_model, save_svm_model

from conftest import GOLDEN, random_ragged_seqs


def _write_fasta(path, X, Y, alphabet="acgt"):
    with open(path, "w") as f:
        for seq, label in zip(X, Y):
            f.write(f">{label}\n")
            f.write("".join(alphabet[v - 1] for v in seq) + "\n")


@pytest.fixture
def fasta_pair(tmp_path, rng):
    from test_integration import make_synthetic_motif_data

    Xtr, Ytr = make_synthetic_motif_data(rng, 30, 28)
    Xte, Yte = make_synthetic_motif_data(rng, 12, 28)
    tr, te = tmp_path / "tr.fasta", tmp_path / "te.fasta"
    _write_fasta(tr, Xtr, Ytr)
    _write_fasta(te, Xte, Yte)
    return str(tr), str(te)


def test_cli_end_to_end(fasta_pair, capsys):
    tr, te = fasta_pair
    rc = cli_main(["-g", "6", "-m", "2", "-C", "1.0", "--json", "-q", tr, te])
    assert rc == 0
    import json

    out = json.loads(capsys.readouterr().out.strip())
    assert out["auc"] > 0.9
    assert out["accuracy"] > 80


def test_cli_small_reference_files(capsys):
    rc = cli_main(
        [
            "-g", "3", "-m", "1", "--json", "-q", "--no-svm",
            os.path.join(GOLDEN, "small.train.fasta"),
            os.path.join(GOLDEN, "small.test.fasta"),
        ]
    )
    assert rc == 0


def test_cli_save_predictions(fasta_pair, tmp_path, capsys):
    """--save-predictions writes the reference's auc_file.txt content
    (label + positive-class probability per test point, fastsk.cpp:447)."""
    tr, te = fasta_pair
    ppath = str(tmp_path / "preds.txt")
    rc = cli_main(
        ["-g", "6", "-m", "2", "-q", "--save-predictions", ppath, tr, te]
    )
    assert rc == 0
    rows = [line.split() for line in open(ppath)]
    n_test = sum(1 for line in open(te) if line.startswith(">"))
    assert len(rows) == n_test
    labels = {r[0] for r in rows}
    assert labels <= {"-1", "0", "1"}
    probs = np.array([float(r[1]) for r in rows])
    assert ((probs >= 0) & (probs <= 1)).all()
    # strong signal: probabilities separate the classes
    y = np.array([int(r[0]) for r in rows])
    assert probs[y == 1].mean() > probs[y != 1].mean()


def test_save_predictions_regression(rng, tmp_path):
    from test_integration import make_synthetic_motif_data

    Xtr, _ = make_synthetic_motif_data(rng, 20, 24)
    Xte, _ = make_synthetic_motif_data(rng, 8, 24)
    ytr = rng.normal(size=len(Xtr))
    yte = rng.normal(size=len(Xte))
    f = FastSK(g=6, m=2)
    f.compute_kernel(Xtr, Xte, ytr, yte)
    f.fit(C=1.0, kernel_type="fastsk", svm_type="epsilon_svr")
    p = str(tmp_path / "preds.txt")
    f.save_predictions(p)
    rows = [line.split() for line in open(p)]
    assert len(rows) == len(Xte)
    np.testing.assert_allclose(
        [float(r[0]) for r in rows], yte, rtol=0, atol=1e-12
    )


def test_cli_save_kernel_roundtrip(fasta_pair, tmp_path, capsys):
    tr, te = fasta_pair
    kpath = str(tmp_path / "k.txt")
    cli_main(["-g", "5", "-m", "1", "-q", "--no-svm", "--save-kernel", kpath, tr, te])
    K = load_kernel(kpath)
    assert K.shape[0] == K.shape[1] == 84  # 60 train + 24 test
    np.testing.assert_allclose(np.diag(K), 1.0, atol=1e-9)
    np.testing.assert_allclose(K, K.T, atol=1e-12)


def test_cli_approx_deterministic(fasta_pair, tmp_path, capsys):
    tr, te = fasta_pair
    import json

    outs = []
    for _ in range(2):
        cli_main(
            ["-g", "8", "-m", "4", "-a", "-I", "12", "--seed", "7", "--json",
             "-q", tr, te]
        )
        outs.append(json.loads(capsys.readouterr().out.strip()))
    assert outs[0]["auc"] == outs[1]["auc"]


def test_svm_model_save_load(tmp_path, rng):
    n = 40
    X = rng.normal(size=(n, 6))
    y = (X[:, 0] + 0.2 * rng.normal(size=n) > 0).astype(int)
    gram = X @ X.T
    model = KernelSVC(C=1.0, probability=True).fit(gram, y)
    path = str(tmp_path / "model")
    save_svm_model(path, model)
    loaded = load_svm_model(path)
    q = rng.normal(size=(10, 6)) @ X.T
    np.testing.assert_allclose(model.decision_function(q), loaded.decision_function(q))
    np.testing.assert_allclose(model.predict_proba(q), loaded.predict_proba(q))


def test_exact_checkpoint_resume(tmp_path, rng):
    """Interrupt exact accumulation mid-way; a fresh engine must resume from
    the checkpoint and produce the identical kernel."""
    X = random_ragged_seqs(rng, 12, 10, 16, alphabet=4)
    ck = str(tmp_path / "ck.npz")
    cfg = KernelConfig(
        checkpoint_path=ck, checkpoint_every=8, theta_batch=4,
        exact_engine="theta",
    )
    ref = FastSK(g=8, m=4, config=KernelConfig(exact_engine="theta"))
    ref.compute_train(X)

    # run partially by monkey-interrupting after a few batches
    class Stop(Exception):
        pass

    fsk1 = FastSK(g=8, m=4, config=cfg)
    from fastsk_jax.kernel import engine as engine_mod

    orig = engine_mod.gkm.exact_batch_update
    calls = {"n": 0}

    def wrapped(*a, **kw):
        calls["n"] += 1
        if calls["n"] > 5:
            raise Stop()
        return orig(*a, **kw)

    engine_mod.gkm.exact_batch_update = wrapped
    try:
        with pytest.raises(Stop):
            fsk1.compute_train(X)
    finally:
        engine_mod.gkm.exact_batch_update = orig
    assert os.path.exists(ck)

    fsk2 = FastSK(g=8, m=4, config=cfg)
    fsk2.compute_train(X)
    np.testing.assert_array_equal(ref.kernel_counts, fsk2.kernel_counts)


def test_approx_checkpoint_resume(tmp_path, rng):
    X = random_ragged_seqs(rng, 12, 12, 18, alphabet=4)
    ck = str(tmp_path / "cka.npz")
    cfg = KernelConfig(checkpoint_path=ck, checkpoint_every=4, theta_batch=4)
    ref = FastSK(g=8, m=4, approx=True, max_iters=20, seed=3)
    ref.compute_train(X)

    class Stop(Exception):
        pass

    from fastsk_jax.kernel import engine as engine_mod

    orig = engine_mod.gkm.approx_batch_update
    calls = {"n": 0}

    def wrapped(*a, **kw):
        calls["n"] += 1
        if calls["n"] > 2:
            raise Stop()
        return orig(*a, **kw)

    fsk1 = FastSK(g=8, m=4, approx=True, max_iters=20, seed=3, config=cfg)
    engine_mod.gkm.approx_batch_update = wrapped
    try:
        with pytest.raises(Stop):
            fsk1.compute_train(X)
    finally:
        engine_mod.gkm.approx_batch_update = orig

    fsk2 = FastSK(g=8, m=4, approx=True, max_iters=20, seed=3, config=cfg)
    fsk2.compute_train(X)
    assert fsk2.iterations == ref.iterations
    np.testing.assert_array_equal(ref.kernel_counts, fsk2.kernel_counts)


def test_stale_checkpoint_ignored(tmp_path, rng):
    """A checkpoint from different data/params must not be reused."""
    X1 = random_ragged_seqs(rng, 8, 10, 14, alphabet=4)
    X2 = random_ragged_seqs(rng, 8, 10, 14, alphabet=4)
    ck = str(tmp_path / "ck2.npz")
    cfg = KernelConfig(checkpoint_path=ck, checkpoint_every=1, theta_batch=2,
                       exact_engine="theta")
    a = FastSK(g=6, m=2, config=cfg)
    a.compute_train(X1)
    b = FastSK(g=6, m=2, config=cfg)
    b.compute_train(X2)
    ref = FastSK(g=6, m=2, config=KernelConfig(exact_engine="theta"))
    ref.compute_train(X2)
    np.testing.assert_array_equal(ref.kernel_counts, b.kernel_counts)


def test_save_kernel_npz(rng, tmp_path):
    from test_integration import make_synthetic_motif_data

    X, _ = make_synthetic_motif_data(rng, 6, 16)
    fsk = FastSK(g=5, m=1)
    fsk.compute_train(X)
    path = str(tmp_path / "k.npz")
    fsk.save_kernel(path)
    with np.load(path) as z:
        np.testing.assert_allclose(z["kernel"], np.asarray(fsk.kernel))
        np.testing.assert_array_equal(z["counts"], fsk.kernel_counts)
        assert int(z["n_train"]) == 12


def test_cli_checkpoint_flag(fasta_pair, tmp_path, capsys):
    import json

    tr, te = fasta_pair
    ck = str(tmp_path / "cli_ck.npz")
    cli_main(["-g", "8", "-m", "4", "-a", "-I", "10", "--json", "-q",
              "--checkpoint", ck, "--checkpoint-every", "4", tr, te])
    out1 = json.loads(capsys.readouterr().out.strip())
    assert os.path.exists(ck)
    # resuming from the finished checkpoint reproduces the same result
    cli_main(["-g", "8", "-m", "4", "-a", "-I", "10", "--json", "-q",
              "--checkpoint", ck, "--checkpoint-every", "4", tr, te])
    out2 = json.loads(capsys.readouterr().out.strip())
    assert out1["auc"] == out2["auc"]


def test_fastsk_predict_tool(tmp_path, rng):
    """fastsk-predict applies a LIBSVM text model to a saved kernel and
    reproduces the in-process predictions (svm-predict parity, C12)."""
    import numpy as np

    from fastsk_jax import FastSK
    from fastsk_jax.predict_cli import main as predict_main
    from fastsk_jax.svm.kernel_svm import save_svm_model

    X = [rng.integers(1, 5, size=30).tolist() for _ in range(30)]
    Y = [1, -1] * 15
    fsk = FastSK(g=5, m=2)
    fsk.compute_kernel(X[:22], X[22:], Y[:22], Y[22:])
    fsk.fit(C=1.0, kernel_type="fastsk")
    kpath = str(tmp_path / "k.npz")
    fsk.save_kernel(kpath)
    mpath = str(tmp_path / "m.model")
    save_svm_model(mpath, fsk._model, fmt="libsvm", svm_type="c_svc")

    out = str(tmp_path / "preds.txt")
    assert predict_main([mpath, kpath, out, "-b"]) == 0
    lines = open(out).read().splitlines()
    assert lines[0].startswith("labels ")
    preds = np.array([int(float(l.split()[0])) for l in lines[1:]])
    k = fsk.kernel
    expected = fsk._model.predict(k[22:, :22])
    np.testing.assert_array_equal(preds, expected)
