"""Format converter tool (tools/convert_formats.py): gkm pos/neg splits
and bare-label normalization (reference results/other_scripts/gkmify.py
and gkm_formatter.py equivalents)."""

import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

from convert_formats import gkmify, main, normalize, split_pos_neg  # noqa: E402


def _write(path, text):
    with open(path, "w") as fh:
        fh.write(text)


def test_split_pos_neg_standard(tmp_path):
    p = tmp_path / "x.fasta"
    _write(p, ">1\nACGT\n>-1\nTTTT\n>1\nGGGG\n>0\nCCCC\n")
    pos, neg, nxt = split_pos_neg(str(p))
    assert pos == [">1", "acgt", ">3", "gggg"]
    assert neg == [">2", "tttt", ">4", "cccc"]
    assert nxt == 5


def test_split_pos_neg_nlp_label_lines(tmp_path):
    """NLP corpora write 'LABEL>1' and sequences may contain '>'."""
    p = tmp_path / "x.fasta"
    _write(p, "LABEL>1\nif x > y then\nLABEL>-1\nplain text\n")
    pos, neg, _ = split_pos_neg(str(p))
    assert pos == [">1", "if x > y then"]
    assert neg == [">2", "plain text"]


def test_gkmify_quartet(tmp_path):
    d = tmp_path / "data"
    d.mkdir()
    _write(d / "TOY.train.fasta", ">1\nAAAA\n>-1\nCCCC\n")
    _write(d / "TOY.test.fasta", ">1\nGGGG\n>0\nTTTT\n")
    out = tmp_path / "gkm"
    written = gkmify(str(d), "TOY", str(out))
    assert len(written) == 4
    names = sorted(os.path.basename(w) for w in written)
    assert names == [
        "TOY.test.neg.fasta",
        "TOY.test.pos.fasta",
        "TOY.train.neg.fasta",
        "TOY.train.pos.fasta",
    ]
    # ids must be unique across the whole quartet (gkm tools key on them)
    ids = []
    for w in written:
        with open(w) as fh:
            ids += [l for l in fh.read().split() if l.startswith(">")]
    assert len(ids) == len(set(ids)) == 4
    with open(out / "TOY.train.pos.fasta") as fh:
        assert fh.read() == ">1\naaaa\n"


def test_normalize_multiline(tmp_path):
    src = tmp_path / "raw.txt"
    _write(src, "1\nAAAT\nGGG\n  TT \n-1\nCC\nC\n")
    dst = tmp_path / "out.fasta"
    assert normalize(str(src), str(dst)) == 2
    with open(dst) as fh:
        assert fh.read() == ">1\nAAATGGGTT\n>-1\nCCC\n"
    # the output round-trips through our reader
    from fastsk_jax import FastaUtility

    X, Y = FastaUtility().read_data(str(dst))
    assert Y == [1, -1]
    assert len(X[0]) == 9 and len(X[1]) == 3


def test_normalize_rejects_headerless(tmp_path):
    src = tmp_path / "bad.txt"
    _write(src, "ACGT\n1\nAAAA\n")
    with pytest.raises(ValueError):
        normalize(str(src), str(tmp_path / "o.fasta"))


def test_cli_entry(tmp_path, capsys):
    d = tmp_path / "data"
    d.mkdir()
    _write(d / "TOY.train.fasta", ">1\nAAAA\n>-1\nCCCC\n")
    _write(d / "TOY.test.fasta", ">1\nGGGG\n>-1\nTTTT\n")
    rc = main([
        "gkmify", "--dir", str(d), "--prefix", "TOY",
        "--out-dir", str(tmp_path / "o"),
    ])
    assert rc == 0
    assert len(capsys.readouterr().out.splitlines()) == 4
