"""The port's posterior (clairs_to_tpu_torch/ops/posterior.py) against the
JAX package's: the likelihood loader and the float64 host path, bit for
bit."""

import os

import numpy as np
import pytest

from clairs_to_tpu.ops import posterior as jpost
from clairs_to_tpu_torch.ops import posterior as tpost

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets")
LIK_FILES = [
    ("flagship_ont_snv/likelihood_matrix.txt", 4),
    ("flagship_ont_snv/indel/likelihood_matrix.txt", 6),
]


def _probs(n, a, seed):
    rng = np.random.default_rng(seed)
    p = np.round(rng.uniform(0, 1, size=(n, a)), 8)
    q = np.round(rng.uniform(0, 1, size=(n, a)), 8)
    # exact 0 and 1 at both ends
    p[:4] = [[0.0] * a, [1.0] * a, [0.5] * a, [1e-9] * a]
    q[:4] = [[1.0] * a, [0.0] * a, [0.5] * a, [1.0 - 1e-9] * a]
    return p, q


@pytest.mark.parametrize("fname,n_alleles", LIK_FILES)
def test_likelihood_loader_identical(fname, n_alleles):
    path = os.path.join(ASSETS, fname)
    a = jpost.load_likelihood_matrix(path, n_alleles=n_alleles)
    b = tpost.load_likelihood_matrix(path, n_alleles=n_alleles)
    for field in ("matrices", "aff_edges", "neg_edges"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))


@pytest.mark.parametrize("fname,n_alleles", LIK_FILES)
def test_host_posterior_bit_identical(fname, n_alleles):
    path = os.path.join(ASSETS, fname)
    lik_j = jpost.load_likelihood_matrix(path, n_alleles=n_alleles)
    lik_t = tpost.load_likelihood_matrix(path, n_alleles=n_alleles)
    p, q = _probs(500, n_alleles, seed=n_alleles)
    # values on the bin edges themselves
    p[4:15] = lik_j.aff_edges[0][:, None]
    q[4:15] = 1.0 - lik_j.neg_edges[0][:, None]
    a = jpost.posterior_probs_np(p, q, lik_j)
    b = tpost.posterior_probs_np(p, q, lik_t)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jpost.quality_score_np(a.max(1)),
                                  tpost.quality_score_np(b.max(1)))


def test_uniform_likelihood_identical():
    a, b = jpost.uniform_likelihood_data(6), tpost.uniform_likelihood_data(6)
    np.testing.assert_array_equal(a.matrices, b.matrices)
    np.testing.assert_array_equal(a.aff_edges, b.aff_edges)
