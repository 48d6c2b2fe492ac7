"""The port's posterior (clairs_to_tpu_torch/ops/posterior.py) against the
JAX package's: the float64 host path bit for bit, the torch device path
against posterior_probs_jnp."""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from clairs_to_tpu.ops import posterior as jpost
from clairs_to_tpu_torch.ops import posterior as tpost

torch.set_num_threads(1)
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


@pytest.mark.parametrize("fname,n_alleles", LIK_FILES)
def test_device_posterior_matches_jnp(fname, n_alleles):
    lik = tpost.load_likelihood_matrix(os.path.join(ASSETS, fname), n_alleles=n_alleles)
    p, q = _probs(400, n_alleles, seed=10 + n_alleles)
    p, q = p.astype(np.float32), q.astype(np.float32)
    # float32 values exactly on the (float32) bin edges: searchsorted(right)
    # must put them in the bin they open, like np.digitize
    aff32 = lik.aff_edges.astype(np.float32)
    neg32 = lik.neg_edges.astype(np.float32)
    p[4:15] = aff32.T
    q[4:15] = (1.0 - neg32.T)
    args32 = [lik.matrices.astype(np.float32), aff32, neg32]
    want = np.asarray(jpost.posterior_probs_jnp(jnp.asarray(p), jnp.asarray(q),
                                                *map(jnp.asarray, args32)))
    got = tpost.posterior_probs_torch(torch.from_numpy(p), torch.from_numpy(q),
                                      *map(torch.from_numpy, args32)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    best = want.max(1)
    np.testing.assert_allclose(
        tpost.quality_score_torch(torch.from_numpy(best)).numpy(),
        np.asarray(jpost.quality_score_jnp(jnp.asarray(best))), rtol=1e-5, atol=1e-4)


def test_searchsorted_bins_equal_digitize():
    edges = np.array([0.0, 0.1, 0.25, 0.3, 0.5, 0.6, 0.7, 0.8, 0.9, 0.95, 1.0])
    vals = np.concatenate([edges, np.linspace(0, 1, 101), [0.0999999, 0.1000001]])
    want = np.clip(np.digitize(vals, edges) - 1, 0, 9)
    got = (torch.searchsorted(torch.from_numpy(edges), torch.from_numpy(vals), right=True)
           - 1).clamp(0, 9).numpy()
    np.testing.assert_array_equal(got, want)
