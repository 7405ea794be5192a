"""FASTA reading, vocabulary, encoding, and combinatorics tests."""

import os

import numpy as np
import pytest

from fastsk_jax import FastaUtility, Vocabulary
from fastsk_jax.ops.combinatorics import enumerate_combinations, nchoosek, sample_combinations
from fastsk_jax.ops.encode import encode_sequences, validate_g

from conftest import GOLDEN


def test_vocab_reserves_zero():
    v = Vocabulary()
    assert v.size() == 1
    assert v.add("a") == 1
    assert v.add("c") == 2
    assert v.add("a") == 1
    assert v.size() == 3
    assert v.get("zzz") == 0


def test_read_small_fixture():
    reader = FastaUtility()
    X, Y = reader.read_data(os.path.join(GOLDEN, "small.train.fasta"))
    assert Y == [1, 0]
    # "ACACA" -> a=1, c=2 ; "AAACA"
    assert X[0] == [1, 2, 1, 2, 1]
    assert X[1] == [1, 1, 1, 2, 1]


def test_shared_vocab_across_files():
    reader = FastaUtility()
    Xtr, _ = reader.read_data(os.path.join(GOLDEN, "small.train.fasta"))
    Xte, _ = reader.read_data(os.path.join(GOLDEN, "small.test.fasta"))
    # same characters -> same codes in both splits
    assert Xte[0] == [1, 2, 1, 2, 1]
    assert reader.shortest_seq(os.path.join(GOLDEN, "small.test.fasta")) == 5


def test_read_dna_matches_expected_alphabet():
    reader = FastaUtility()
    X, Y = reader.read_data(os.path.join(GOLDEN, "ep_sl.test.fasta"))
    flat = {c for seq in X for c in seq}
    assert flat <= {1, 2, 3, 4, 5}  # acgt (+ possible n)
    assert set(Y) <= {0, 1}


def test_regression_labels():
    import tempfile

    with tempfile.NamedTemporaryFile("w", suffix=".fasta", delete=False) as f:
        f.write(">0.75\nACGT\n>1.25\nGTCA\n")
        path = f.name
    X, Y = FastaUtility().read_data(path, regression=True)
    assert Y == ["0.75", "1.25"]
    os.unlink(path)


def test_encode_sequences_layout():
    enc = encode_sequences([[1, 2, 3], [2, 2]], [[3, 1, 2, 1, 3]])
    assert enc.n_train == 2
    assert enc.n_test == 1
    assert enc.n == 3
    assert enc.max_len % 8 == 0
    np.testing.assert_array_equal(enc.lengths, [3, 2, 5])
    assert enc.dict_size == 4  # {0,1,2,3}
    assert enc.nfeat(2) == 2 + 1 + 4


def test_validate_g_constraints():
    enc = encode_sequences([[1, 2, 3, 4]], [[1, 2, 3]])
    with pytest.raises(ValueError, match="shortest test"):
        validate_g(enc, 4, 1)
    with pytest.raises(ValueError, match="greater than m"):
        validate_g(enc, 3, 3)
    with pytest.raises(ValueError, match="at most 20"):
        validate_g(enc, 21, 1)
    validate_g(enc, 3, 1)


def test_nchoosek():
    assert nchoosek(16, 10) == 8008
    assert nchoosek(20, 10) == 184756
    assert nchoosek(5, 0) == 1
    assert nchoosek(4, 5) == 0


def test_enumerate_combinations_lexicographic():
    combos = enumerate_combinations(4, 2)
    expected = [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]]
    np.testing.assert_array_equal(combos, expected)

    from itertools import combinations as ic

    combos = enumerate_combinations(9, 4)
    np.testing.assert_array_equal(combos, list(ic(range(9), 4)))


def test_sample_combinations_seeded():
    a = sample_combinations(8, 3, np.random.default_rng(7))
    b = sample_combinations(8, 3, np.random.default_rng(7))
    np.testing.assert_array_equal(a, b)
    # a permutation of the full enumeration
    assert {tuple(r) for r in a} == {tuple(r) for r in enumerate_combinations(8, 3)}
