"""chip_smoke.py's phases at tiny sizes on the CPU: the same code paths,
checks and printing as on the card, on slices of the in-repo corpora.
Its ``main`` refuses to run without a GPU."""

import pytest

import chip_smoke as cs
from fastsk_jax import FastaUtility
from fastsk_jax.harness.runner import CORPORA, read_split


def load_split(name, reader):
    return read_split(name, (CORPORA,), reader)


@pytest.fixture(scope="module")
def kat2b():
    reader = FastaUtility()
    Xtr, Ytr, Xte, Yte = load_split("KAT2B", reader)
    return reader, (Xtr[:16] + Xtr[-16:], Ytr[:16] + Ytr[-16:],
                    Xte[:5] + Xte[-5:], Yte[:5] + Yte[-5:])


def test_main_refuses_without_gpu(capsys):
    assert cs.main([]) != 0
    assert cs.main(["--chips", "4"]) != 0
    assert capsys.readouterr().out == ""  # no result line


def test_check_raises_on_failure(capsys):
    cs.check(True, "fine")
    assert "ok: fine" in capsys.readouterr().out
    with pytest.raises(cs.SmokeFailure):
        cs.check(False, "broken")


def test_read_split_sizes_and_labels():
    Xtr, Ytr, Xte, Yte = load_split("KAT2B", FastaUtility())
    assert (len(Xtr), len(Xte)) == (6318, 702)
    assert sum(Ytr) == 3159 and sum(Yte) == 351
    assert {len(x) for x in Xtr + Xte} == {200}
    Xtr, Ytr, Xte, Yte = load_split("EP300", FastaUtility())
    assert len(Xtr) + len(Xte) == 4000 and {len(x) for x in Xtr} == {100}


def test_phase_compile_and_exact_dna(kat2b, capsys):
    reader, (Xtr, Ytr, Xte, Yte) = kat2b
    cs.phase_compile(Xtr, Ytr, Xte, g=13, m=7)
    out = cs.phase_exact_dna(Xtr, Ytr, Xte, Yte, reader, g=13, m=7,
                             auc_min=0.0, oracle_size=4, reps=1)
    assert out["counts"].shape == (42, 42) and out["iters"] > 0
    text = capsys.readouterr().out
    assert "SMO solve" in text and "us/iteration" in text and "CLI" in text


def test_phase_ragged_and_kernel_vs_xla(kat2b):
    _, (Xtr, _, Xte, _) = kat2b
    got = cs.kernel_vs_xla(Xtr[:8] + Xte[:2], 16, 10, reps=1)
    assert got["route"] == "xla" and got["counts"].shape == (10, 10)
    X = cs.ragged_corpus(20, 10, 50, 20, seed=0)
    assert len(X) == 20 and min(map(len, X)) >= 10 and max(map(len, X)) <= 50
    assert all(1 <= c <= 20 for x in X for c in x)
    cs.phase_ragged(20, 10, 50, g=8, m=4, oracle_size=5)


def test_phase_theta_approx_and_tf32():
    Xtr, Ytr, Xte, Yte = load_split("EP300", FastaUtility())
    cs.phase_theta_approx(Xtr[:12] + Xtr[-12:], Ytr[:12] + Ytr[-12:],
                          Xte[:4] + Xte[-4:], Yte[:4] + Yte[-4:],
                          g=10, m_exact=4, m_approx=6, max_iters=2,
                          auc_min=0.0)
    cs.phase_tf32(200, 2, g=6, m=3)


def test_phase_mesh_on_virtual_devices(kat2b):
    reader, kat = kat2b
    ep = load_split("EP300", reader)
    ep = (ep[0][:10] + ep[0][-10:], ep[1][:10] + ep[1][-10:],
          ep[2][:3] + ep[2][-3:], ep[3][:3] + ep[3][-3:])
    cs.phase_mesh(*kat, *ep, n_dev=4, g=13, m=7, g_theta=10, m_theta=4)


def test_oracle_block_detects_a_wrong_count():
    X = cs.ragged_corpus(6, 8, 20, 4, seed=2)
    import sys

    sys.path.insert(0, cs.os.path.join(cs.REPO, "tests"))
    import oracle

    K = oracle.exact_counts(X, 4, 2)
    assert cs.oracle_block(X, K, 4, 2, size=6, seed=0)
    K[1, 2] += 1
    assert not cs.oracle_block(X, K, 4, 2, size=6, seed=0)
