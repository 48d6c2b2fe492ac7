"""The dual-network posterior, QUAL and strand counts in plain NumPy.

From ClairS-TO's ``call_variants.py``: for allele k with AFF class-1
probability p and NEG class-1 probability q, bin p and 1 - q by the
platform's likelihood points, w = W_k[bin p, bin(1 - q)] + eps, and

    posterior_k = p (1 - q) w / (p (1 - q) w + (1 - p) q (1 - w)).

The likelihood file holds the alleles' 10 x 10 matrices, then per allele a
row of AFF points and a row of NEG points, each with a last entry that is
dropped.  Strand counts come from the window's center row: each quality
block's reference base is stored as minus the block's sum.
"""

import sys

import numpy as np

EPS = sys.float_info.epsilon


def load_likelihood(path, n_alleles, dtype=np.float64):
    data = np.loadtxt(path)
    mats = np.stack([data[10 * k:10 * k + 10] for k in range(n_alleles)])
    pts = data[10 * n_alleles:]
    edges = [np.concatenate([[0.0], pts[r][:-1], [1.0]]) for r in range(2 * n_alleles)]
    return mats.astype(dtype), np.stack(edges[0::2]), np.stack(edges[1::2])


def posterior(p_aff, p_neg, lik, dtype=np.float64):
    """(N, alleles) posterior from class-1 probabilities, in ``dtype``."""
    mats, aff_edges, neg_edges = lik
    p = np.asarray(p_aff, dtype)
    q = np.asarray(p_neg, dtype)
    n_al = p.shape[1]
    bi = np.stack([np.digitize(p[:, k], aff_edges[k]) for k in range(n_al)], axis=1) - 1
    bj = np.stack([np.digitize(1 - q[:, k], neg_edges[k]) for k in range(n_al)], axis=1) - 1
    bi, bj = np.clip(bi, 0, 9), np.clip(bj, 0, 9)
    w = mats.astype(dtype)[np.arange(n_al)[None, :], bi, bj] + dtype(EPS)
    a = p * (1 - q) * w
    return a / (a + (1 - p) * q * (1 - w))


def strand_counts(center):
    """(forward (N, 4), reverse (N, 4)) int64 base counts from the raw
    center rows (N, 34) of the AFF view."""
    out = []
    for lo in (0, 9):
        block = np.asarray(center[:, lo:lo + 4], np.int64)
        total = block.sum(axis=1, keepdims=True)
        out.append(np.where(block < 0, -total, block))
    return out
