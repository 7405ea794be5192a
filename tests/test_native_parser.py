"""Native C++ FASTA parser: exact parity with the Python reader."""

import os

import numpy as np
import pytest

from fastsk_jax.io.fasta import FastaUtility
from fastsk_jax.native import loader

from conftest import CORPORA, GOLDEN


def _labeled_copy(tmp_path, name: str) -> str:
    """A labeled (``>1`` / ``>0``) FASTA of the in-repo corpus split
    ``<name>.{pos,neg}.fasta``; labels come from the file names."""
    out = tmp_path / f"{name}.fasta"
    with open(out, "w") as dst:
        for label, part in ((1, "pos"), (0, "neg")):
            with open(os.path.join(CORPORA, f"{name}.{part}.fasta")) as src:
                for line in src:
                    line = line.strip()
                    if line and not line.startswith(">"):
                        dst.write(f">{label}\n{line}\n")
    return str(out)


def _seeded_fasta(tmp_path, name: str, alphabet: str, n: int, seed: int) -> str:
    rng = np.random.default_rng(seed)
    out = tmp_path / name
    with open(out, "w") as f:
        for _ in range(n):
            seq = "".join(rng.choice(list(alphabet), size=rng.integers(20, 120)))
            f.write(f">{rng.integers(0, 2)}\n{seq}\n")
    return str(out)


# in-repo stand-ins for the reference corpora of the same names: the
# small split, an EP300 slice, a protein-alphabet and a text-alphabet file
_FIXTURES = {
    "small.train.fasta": lambda tmp: os.path.join(GOLDEN, "small.train.fasta"),
    "EP300.test.fasta": lambda tmp: os.path.join(GOLDEN, "ep_sl.test.fasta"),
    "1.1.test.fasta": lambda tmp: _seeded_fasta(
        tmp, "1.1.test.fasta", "ACDEFGHIKLMNPQRSTVWY", 60, 11
    ),
    "AImed.train.fasta": lambda tmp: _seeded_fasta(
        tmp, "AImed.train.fasta",
        "abcdefghijklmnopqrstuvwxyz ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789.,-()",
        60, 12,
    ),
}


@pytest.mark.parametrize("name", list(_FIXTURES))
def test_native_matches_python_reader(name, tmp_path):
    path = _FIXTURES[name](tmp_path)
    py = FastaUtility(use_native=False)
    Xp, Yp = py.read_data(path)
    nat = FastaUtility(use_native=True)
    Xn, Yn = nat.read_data(path)
    assert Yp == Yn
    assert len(Xp) == len(Xn)
    for a, b in zip(Xp, Xn):
        assert a == b
    assert py.vocab.size() == nat.vocab.size()


def test_native_shared_vocab_across_files():
    train = os.path.join(GOLDEN, "ep_sl.train.fasta")
    test = os.path.join(GOLDEN, "ep_sl.test.fasta")
    nat = FastaUtility(use_native=True)
    Xtr, _ = nat.read_data(train)
    Xte, _ = nat.read_data(test)
    py = FastaUtility(use_native=False)
    Xtr_p, _ = py.read_data(train)
    Xte_p, _ = py.read_data(test)
    assert Xtr == Xtr_p and Xte == Xte_p


def test_native_rejects_malformed(tmp_path):
    bad = tmp_path / "bad.fasta"
    bad.write_text("not a label line\nacgt\n")
    reader = loader.NativeFastaReader()
    with pytest.raises(ValueError):
        reader.read_data(str(bad))


def test_native_falls_back_on_unicode(tmp_path):
    uni = tmp_path / "uni.fasta"
    uni.write_text(">1\nاختبار\n", encoding="utf-8")
    reader = loader.NativeFastaReader()
    with pytest.raises(ValueError):
        reader.read_data(str(uni))
    # the FastaUtility wrapper silently falls back to the Python path
    X, Y = FastaUtility(use_native=True).read_data(str(uni))
    assert Y == [1] and len(X[0]) == 6


def test_native_parse_speed_sanity(tmp_path):
    """The native parser should beat the Python reader on a real file
    (the 6,318-sequence KAT2B training split).

    Best-of-3 on both sides to keep the comparison robust under noisy
    shared-machine load; the bound is still strict (native must win)."""
    import time

    path = _labeled_copy(tmp_path, "KAT2B.train")
    loader.get_library()  # build outside the timed region

    def best_of(fn, n=3):
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return min(times)

    py_t = best_of(lambda: FastaUtility(use_native=False).read_data(path))
    nat_t = best_of(lambda: FastaUtility(use_native=True).read_data(path))
    assert nat_t < py_t, (nat_t, py_t)


# ------------------------------------------------------------- fuzz/property


def _gen_fasta(rng, path, n_seqs, crlf=False, long_lines=False):
    """Random valid FASTA both readers must parse identically: varied
    labels ({-1,0,1} with optional +, padding spaces), mixed-case
    sequence bytes over letters/digits, blank lines, optional CRLF
    endings, lines past the reference's STRMAXLEN=15000 (shared.h:4 —
    unenforced in its pybind path, unbounded here), and a possibly
    missing trailing newline."""
    nl = "\r\n" if crlf else "\n"
    alpha = "acgtnACGTNrykm"
    parts = []
    for i in range(n_seqs):
        label = rng.choice(["-1", "0", "1", "+1", " 1", "1 "])
        prefix = rng.choice(["", "seq"])
        parts.append(f"{prefix}>{label}{nl}")
        if rng.random() < 0.2:
            parts.append(nl)  # blank line between records
        length = (
            int(rng.integers(15000, 16001))
            if long_lines and rng.random() < 0.3
            else int(rng.integers(1, 400))
        )
        seq = "".join(rng.choice(list(alpha), size=length))
        last = i == n_seqs - 1
        parts.append(seq + ("" if last and rng.random() < 0.3 else nl))
    path.write_text("".join(parts))


def test_native_fuzz_matches_python(tmp_path, rng):
    for trial in range(25):
        f = tmp_path / f"fuzz{trial}.fasta"
        _gen_fasta(
            rng, f,
            n_seqs=int(rng.integers(1, 12)),
            crlf=bool(rng.random() < 0.3),
            long_lines=(trial % 5 == 0),
        )
        py = FastaUtility(use_native=False)
        Xp, Yp = py.read_data(str(f))
        nat = FastaUtility(use_native=True)
        Xn, Yn = nat.read_data(str(f))
        assert Yp == Yn, f"labels diverge on trial {trial}"
        assert Xp == Xn, f"encodings diverge on trial {trial}"
        assert py.vocab.size() == nat.vocab.size()


@pytest.mark.parametrize(
    "content",
    [
        ">1.0\nacgt\n",  # float-looking label: python int() rejects
        ">2\nacgt\n",  # out-of-range classification label
        ">1x\nacgt\n",  # trailing junk after the number
        ">\nacgt\n",  # empty label
        ">1>2\nacgt\n",  # multiple '>'
        "acgt\n>1\n",  # sequence before any label line
        ">1\n",  # label without sequence (unequal counts)
    ],
)
def test_native_and_python_reject_the_same_inputs(tmp_path, content):
    bad = tmp_path / "bad.fasta"
    bad.write_text(content)
    with pytest.raises((ValueError, AssertionError)):
        loader.NativeFastaReader().read_data(str(bad))
    with pytest.raises((ValueError, AssertionError)):
        FastaUtility(use_native=False).read_data(str(bad))
