"""DL baseline (CharCNN / SeqLSTM) shape and learning tests."""

import numpy as np
import pytest

from conftest import random_ragged_seqs


@pytest.fixture
def fasta_pair(tmp_path, rng):
    from test_cli_persistence import _write_fasta
    from test_integration import make_synthetic_motif_data

    Xtr, Ytr = make_synthetic_motif_data(rng, 40, 60)
    Xte, Yte = make_synthetic_motif_data(rng, 15, 60)
    tr, te = tmp_path / "tr.fasta", tmp_path / "te.fasta"
    _write_fasta(tr, Xtr, Ytr)
    _write_fasta(te, Xte, Yte)
    return str(tr), str(te)


def test_charcnn_learns_motifs(fasta_pair):
    from fastsk_jax.models.train import train_model

    res = train_model("cnn", *fasta_pair, epochs=12, batch_size=16, seed=0)
    assert res.auc > 0.8
    assert res.history[-1]["loss"] < res.history[0]["loss"]


def test_lstm_forward_and_masking(rng):
    import jax
    import jax.numpy as jnp

    from fastsk_jax.models import SeqLSTM

    model = SeqLSTM(vocab_size=6, hidden_size=16, embedding_size=8)
    toks = jnp.asarray(rng.integers(1, 5, size=(3, 12)), dtype=jnp.int32)
    lengths = jnp.asarray([12, 5, 8], dtype=jnp.int32)
    params = model.init(jax.random.PRNGKey(0), toks, lengths)
    logits = model.apply(params, toks, lengths)
    assert logits.shape == (3, 2)
    # masking: padding tokens beyond the length must not change the output
    toks2 = toks.at[1, 5:].set(3)
    logits2 = model.apply(params, toks2, lengths)
    np.testing.assert_allclose(logits[1], logits2[1], atol=1e-5)


def test_lstm_learns(fasta_pair):
    from fastsk_jax.models.train import train_model

    res = train_model("lstm", *fasta_pair, epochs=15, batch_size=16, seed=0)
    assert res.history[-1]["loss"] < res.history[0]["loss"]


def test_run_repeats_fractions(fasta_pair):
    from fastsk_jax.models.train import run_repeats

    rows = run_repeats(
        "cnn", *fasta_pair, seeds=2, train_fractions=(0.5, 1.0), epochs=2,
        batch_size=16,
    )
    assert len(rows) == 4
    assert {r["fraction"] for r in rows} == {0.5, 1.0}
