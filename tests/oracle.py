"""Independent numpy oracle for the gapped k-mer kernel.

This is a from-scratch transcription of the *semantics* of the reference
counting algorithm (shared.cpp:268-333 countAndUpdateTri summed over every
C(g,m) position subset, fastsk_kernel.cpp:96-103 cosine normalization), used
only to validate the JAX engines. It deliberately uses a different algorithm
shape (per-subset unique/bincount + dense outer products) so agreement is
meaningful.
"""

from __future__ import annotations

from itertools import combinations as itercombs
from typing import List, Sequence

import numpy as np


def extract_gmers(X: Sequence[Sequence[int]], g: int):
    """All g-mers of all sequences plus the owning-sequence index."""
    feats: List[np.ndarray] = []
    group: List[int] = []
    for i, seq in enumerate(X):
        s = np.asarray(seq, dtype=np.int64)
        for j in range(len(s) - g + 1):
            feats.append(s[j : j + g])
            group.append(i)
    return np.array(feats, dtype=np.int64), np.array(group, dtype=np.int64)


def partial_kernel(feats, group, theta, n_str) -> np.ndarray:
    """K_theta[a, b] = sum over k-mer values v of c_a(v) * c_b(v).

    Equivalent to one pass of countAndUpdateTri: every run of equal projected
    k-mers (singletons included) contributes the outer product of its
    per-sequence counts.
    """
    proj = feats[:, list(theta)]
    _, inv = np.unique(proj, axis=0, return_inverse=True)
    n_buckets = int(inv.max()) + 1 if len(inv) else 0
    C = np.zeros((n_str, n_buckets), dtype=np.int64)
    np.add.at(C, (group, inv), 1)
    return C @ C.T


def exact_counts(X: Sequence[Sequence[int]], g: int, m: int) -> np.ndarray:
    """Unnormalized exact kernel: sum of K_theta over all C(g, g-m) subsets."""
    k = g - m
    feats, group = extract_gmers(X, g)
    n_str = len(X)
    K = np.zeros((n_str, n_str), dtype=np.int64)
    for theta in itercombs(range(g), k):
        K += partial_kernel(feats, group, theta, n_str)
    return K


def counts_for_thetas(
    X: Sequence[Sequence[int]], g: int, thetas: np.ndarray
) -> np.ndarray:
    """Sum of K_theta over an explicit list of position subsets."""
    feats, group = extract_gmers(X, g)
    n_str = len(X)
    K = np.zeros((n_str, n_str), dtype=np.int64)
    for theta in np.asarray(thetas):
        K += partial_kernel(feats, group, tuple(int(t) for t in theta), n_str)
    return K


def cosine_normalize(K: np.ndarray) -> np.ndarray:
    """K[i,j] / sqrt(K[i,i] * K[j,j]) in float64 (fastsk_kernel.cpp:96-103)."""
    K = K.astype(np.float64)
    diag = np.diag(K).copy()
    return K / np.sqrt(np.multiply.outer(diag, diag))


def exact_kernel(X: Sequence[Sequence[int]], g: int, m: int) -> np.ndarray:
    return cosine_normalize(exact_counts(X, g, m))
