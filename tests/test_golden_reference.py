"""Bit-for-bit parity with kernels computed by the ACTUAL reference C++
engine (see tests/golden/README.md for provenance).

These are float64 equality tests: identical integer counts + the same
float64 normalization must reproduce the reference doubles exactly.
"""

import os

import numpy as np
import pytest

from fastsk_jax import FastSK, FastaUtility, KernelConfig

from conftest import GOLDEN

# dump_kernel output for small.train+test.fasta (reference C++, exact mode)
SMALL_G3M1 = np.array([
    [1.0, 0.64450338663548956, 1.0, 0.38924947208076149],
    [0.64450338663548956, 1.0, 0.64450338663548956, 0.58536940700496354],
    [1.0, 0.64450338663548956, 1.0, 0.38924947208076149],
    [0.38924947208076149, 0.58536940700496354, 0.38924947208076149, 1.0],
])
SMALL_G4M2 = np.array([
    [1.0, 0.46291004988627571, 1.0, 0.30860669992418382],
    [0.46291004988627571, 1.0, 0.46291004988627571, 0.6428571428571429],
    [1.0, 0.46291004988627571, 1.0, 0.30860669992418382],
    [0.30860669992418382, 0.6428571428571429, 0.30860669992418382, 1.0],
])


def _compute(train, test, g, m, **cfg):
    reader = FastaUtility()
    Xtr, _ = reader.read_data(train)
    Xte, _ = reader.read_data(test)
    fsk = FastSK(g=g, m=m, config=KernelConfig(**cfg) if cfg else None)
    fsk.compute_kernel(Xtr, Xte)
    return np.asarray(fsk.kernel)


@pytest.mark.parametrize("g,m,golden", [(3, 1, SMALL_G3M1), (4, 2, SMALL_G4M2)])
def test_small_fasta_bit_identical(g, m, golden):
    K = _compute(
        os.path.join(GOLDEN, "small.train.fasta"),
        os.path.join(GOLDEN, "small.test.fasta"),
        g, m,
    )
    np.testing.assert_array_equal(K, golden)


def _load_tri(path):
    with open(path) as f:
        header = f.readline()
        while not header.startswith("n="):  # skip the engine's progress noise
            header = f.readline()
        n = int(header.split()[0].split("=")[1])
        K = np.zeros((n, n))
        for i in range(n):
            vals = [float(v) for v in f.readline().split()]
            K[i, : i + 1] = vals
            K[: i + 1, i] = vals
    return K


@pytest.mark.parametrize("engine", ["pairs", "theta"])
def test_ep300_slice_bit_identical(engine):
    golden = _load_tri(os.path.join(GOLDEN, "ep_sl_g6m2.txt"))
    K = _compute(
        os.path.join(GOLDEN, "ep_sl.train.fasta"),
        os.path.join(GOLDEN, "ep_sl.test.fasta"),
        6, 2, exact_engine=engine,
    )
    np.testing.assert_array_equal(K, golden)
