"""The port's GRU recurrence (clairs_to_tpu_torch/ops/gru.py) against the JAX
package: the lax.scan direction, the layer, and the Pallas kernel in
interpret mode.  Kernel-against-plain on the card: tests/test_torch_cuda.py."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from clairs_to_tpu.models import bigru
from clairs_to_tpu.ops import gru_pallas
from clairs_to_tpu_torch.ops import gru as tgru

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets")
T = 33


def _layer_params(in_dim, hidden, seed=0):
    p = bigru.init(jax.random.PRNGKey(seed),
                   bigru.BiGRUConfig(in_channels=in_dim, hidden1=hidden, hidden2=hidden))
    return jax.tree_util.tree_map(np.asarray, p["gru1"])


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _torch_params(p):
    return {k: {n: _t(v) for n, v in d.items()} for k, d in p.items()}


def _gates(p, x, key="ih"):
    xt = np.asarray(x).transpose(1, 0, 2)
    return (np.asarray(jnp.dot(xt, p[key]["weight"].T,
                               precision=jax.lax.Precision.HIGHEST))
            + p[key]["bias"]).astype(np.float32)


@pytest.fixture
def interpret_pallas(monkeypatch):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: orig(*a, interpret=True, **k))


@pytest.mark.parametrize("hidden", [16, 24])
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_direction_plain_matches_scan(hidden, reverse):
    in_dim, B = 34, 8
    p = _layer_params(in_dim, hidden)
    x = np.random.default_rng(1).normal(size=(B, T, in_dim)).astype(np.float32)
    xg = _gates(p, x)
    with jax.default_matmul_precision("highest"):
        if reverse:
            want = bigru._gru_direction(jnp.asarray(xg[::-1]), p["hh"], hidden)[::-1]
        else:
            want = bigru._gru_direction(jnp.asarray(xg), p["hh"], hidden)
    got = tgru.gru_direction_plain(_t(xg), _t(p["hh"]["weight"].T), _t(p["hh"]["bias"]),
                                   reverse=reverse)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("hidden", [16, 24])
def test_gru_direction_matches_pallas_interpret(interpret_pallas, hidden):
    in_dim, B = 34, 8
    p = _layer_params(in_dim, hidden, seed=2)
    x = np.random.default_rng(3).normal(size=(B, T, in_dim)).astype(np.float32)
    xg = _gates(p, x)
    want = gru_pallas.gru_direction_pallas(
        jnp.asarray(xg), p["hh"]["weight"].T, p["hh"]["bias"], hidden)
    launches = tgru.gru_direction.launches
    # CPU tensors: the wrapper takes the plain version and launches nothing
    got = tgru.gru_direction(_t(xg), _t(p["hh"]["weight"].T), _t(p["hh"]["bias"]))
    assert tgru.gru_direction.launches == launches
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("hidden", [16, 24])
def test_bigru_layer_matches_jax(hidden):
    in_dim, B = 34, 4
    p = _layer_params(in_dim, hidden, seed=4)
    x = np.random.default_rng(5).normal(size=(B, T, in_dim)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = bigru._bigru_layer(jnp.asarray(x), p, hidden)
    got = tgru.bigru_layer(torch.from_numpy(x), _torch_params(p), hidden)
    assert got.shape == (B, T, 2 * hidden)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_bigru_layer_matches_pallas_layer(interpret_pallas):
    in_dim, hidden, B = 34, 16, 4
    p = _layer_params(in_dim, hidden, seed=6)
    x = np.random.default_rng(7).normal(size=(B, T, in_dim)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = gru_pallas.bigru_layer_pallas(jnp.asarray(x), p, hidden)
    got = tgru.bigru_layer(torch.from_numpy(x), _torch_params(p), hidden)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("layer,hidden", [("gru1", 128), ("gru2", 192)])
def test_bigru_layer_flagship_shapes(layer, hidden):
    """The flagship ONT NEG weights at their real widths catch transposes
    that square-ish tiny widths could hide."""
    data = np.load(os.path.join(ASSETS, "flagship_ont_snv", "neg.npz"))
    p = {k: {n: data[f"['{layer}']/['{k}']/['{n}']"] for n in ("weight", "bias")}
         for k in ("ih", "hh", "ih_reverse", "hh_reverse")}
    in_dim = p["ih"]["weight"].shape[1]
    x = np.random.default_rng(8).normal(size=(8, T, in_dim)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = bigru._bigru_layer(jnp.asarray(x), p, hidden)
    got = tgru.bigru_layer(torch.from_numpy(x), _torch_params(p), hidden)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gru_direction_rejects_mixed_devices():
    xg = torch.zeros(T, 2, 48)
    with pytest.raises(ValueError):
        tgru.gru_direction(xg, torch.zeros(16, 48, device="meta"), torch.zeros(48))
