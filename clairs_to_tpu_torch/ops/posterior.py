# Port copy of clairs_to_tpu/ops/posterior.py (host path).
"""Dual-network Bayesian posterior — the core of call_variants, vectorized.

Reference math (ClairS-TO clairs/call_variants.py:181-304): for each
allele k in {A,C,G,T[,I,D]}, given the affirmative probability p = P_AFF(k)
and negational probability q = P_NEG(not-k), bin (p, 1-q) into a per-platform
10x10 joint-likelihood matrix W (np.digitize with bin edges [0, pts..., 1]),
then

    w = W[bin(p), bin(1-q)] + eps
    posterior_k = p*(1-q)*w / (p*(1-q)*w + (1-p)*q*(1-w))

The call is argmax_k posterior_k; SNV mode: variant iff argmax base != ref;
indel mode: variant iff argmax in {I, D}.

``posterior_probs_np`` is float64 NumPy, bit-matching the reference's
scalar-Python math; the engine runs it on the host for every batch.

QUAL (call_variants.py:79-88): max(-10*log10((1-p+1e-10)/(p+1e-10)) + 2, 0),
rounded to 4 decimals.
"""

import sys
from dataclasses import dataclass
from math import log, e as _e

import numpy as np

EPS = sys.float_info.epsilon
PHRED_TRANS = -10 * log(_e, 10)  # call_variants.py:79


@dataclass
class LikelihoodData:
    """Per-allele joint matrices and digitize bin edges.

    matrices: (n_alleles, 10, 10) float64
    aff_edges / neg_edges: (n_alleles, 11) float64 — [0, pts..., 1]
    """

    matrices: np.ndarray
    aff_edges: np.ndarray
    neg_edges: np.ndarray

    @property
    def n_alleles(self):
        return self.matrices.shape[0]


def load_likelihood_matrix(path, n_alleles=4):
    """Parse the reference's likelihood_matrix.txt layout
    (call_variants.py:655-796): n_alleles 10-row matrices, then for each
    allele an AFF bin-point row and a NEG bin-point row (last element of each
    row dropped, 0 prepended, 1 appended)."""
    data = np.loadtxt(path)
    matrices = np.stack([data[10 * k : 10 * (k + 1)] for k in range(n_alleles)])
    point_rows = data[10 * n_alleles :]
    aff_edges, neg_edges = [], []
    for k in range(n_alleles):
        aff_pts = point_rows[2 * k].flatten()[:-1]
        neg_pts = point_rows[2 * k + 1].flatten()[:-1]
        aff_edges.append(np.concatenate([[0.0], aff_pts, [1.0]]))
        neg_edges.append(np.concatenate([[0.0], neg_pts, [1.0]]))
    return LikelihoodData(
        matrices=matrices.astype(np.float64),
        aff_edges=np.stack(aff_edges),
        neg_edges=np.stack(neg_edges),
    )


def uniform_likelihood_data(n_alleles=4, weight=0.5):
    """Synthetic flat matrix (for tests / running without trained assets)."""
    matrices = np.full((n_alleles, 10, 10), weight, dtype=np.float64)
    edges = np.tile(np.linspace(0.0, 1.0, 11), (n_alleles, 1))
    # interior edges only; keep exact 0/1 endpoints like the loader
    return LikelihoodData(matrices=matrices, aff_edges=edges.copy(), neg_edges=edges.copy())


def _digitize_rows(values, edges):
    """Per-allele np.digitize(value, edges[k]) - 1, clamped to [0, 9].

    np.digitize(x, bins) with the reference's [0,...,1] edges maps x in [0,1)
    to 1..10; -1 gives 0..9.  x == 1.0 would index out of range in the
    reference (latent bug); we clamp instead.
    """
    out = np.empty(values.shape, dtype=np.int64)
    for k in range(values.shape[1]):
        out[:, k] = np.digitize(values[:, k], edges[k]) - 1
    return np.clip(out, 0, 9)


def posterior_probs_np(p_aff, p_neg, lik: LikelihoodData):
    """Float64 posterior per allele.

    Args:
      p_aff: (B, n_alleles) P(somatic via allele k) — AFF class-1 softmax.
      p_neg: (B, n_alleles) P(not somatic via allele k) — NEG class-1 softmax.
    Returns:
      (B, n_alleles) float64 posterior probabilities.
    """
    p = np.asarray(p_aff, dtype=np.float64)
    q = np.asarray(p_neg, dtype=np.float64)
    ai = _digitize_rows(p, lik.aff_edges)
    ni = _digitize_rows(1.0 - q, lik.neg_edges)
    k_idx = np.arange(p.shape[1])[None, :]
    w = lik.matrices[k_idx, ai, ni] + EPS
    num = p * (1.0 - q) * w
    den = num + (1.0 - p) * q * (1.0 - w)
    return num / den


def quality_score_np(probability):
    """Vectorized QUAL (call_variants.py:81-88), float64, 4-decimal rounding."""
    p = np.asarray(probability, dtype=np.float64)
    q = np.maximum(PHRED_TRANS * np.log(((1.0 - p) + 1e-10) / (p + 1e-10)) + 2.0, 0.0)
    return np.round(q, 4)
