"""The gradient of the port's GRU recurrence against the JAX package's.

The Pallas kernel has no gradient: the JAX package trains through
clairs_to_tpu/models/bigru.py::_gru_direction, so the reference here is
``jax.vjp`` of that function (of ``_bigru_layer`` for a whole layer).  The
port's side is ``gru_direction_backward_plain`` and ``GRUDirection`` on CPU
tensors, which the trainer runs on the CPU.  The backward kernel against
its plain version on the card: tests/test_torch_cuda.py."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clairs_to_tpu.models import bigru
from clairs_to_tpu_torch.ops import _native
from clairs_to_tpu_torch.ops import gru as tgru

torch.set_num_threads(1)
ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets")


def _close(got, want):
    """max |Δ| <= 1e-5 · max(1, max |ref|), per gradient."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= 1e-5 * max(1.0, float(np.abs(want).max(initial=0.0))), err


def _inputs(H, T, B, seed):
    rng = np.random.default_rng(seed)
    bound = H ** -0.5
    xg = rng.normal(size=(T, B, 3 * H)).astype(np.float32)
    w = rng.uniform(-bound, bound, (3 * H, H)).astype(np.float32)   # torch.nn.GRU's W_hh
    b = rng.uniform(-bound, bound, 3 * H).astype(np.float32)
    gout = rng.normal(size=(T, B, H)).astype(np.float32)
    return xg, w, b, gout


@functools.lru_cache(maxsize=None)
def _jax_grads(H, T, B, reverse, seed):
    """(inputs, out, (d x_gates, d W_hh, d b_hh)) from jax.vjp of
    _gru_direction; the reverse direction reverses the gates in and the
    output back, as _bigru_layer does."""
    xg, w, b, gout = _inputs(H, T, B, seed)

    def f(x, w_hh, b_hh):
        p = {"weight": w_hh, "bias": b_hh}
        if reverse:
            return bigru._gru_direction(x[::-1], p, H)[::-1]
        return bigru._gru_direction(x, p, H)

    with jax.default_matmul_precision("highest"):
        out, vjp = jax.vjp(f, jnp.asarray(xg), jnp.asarray(w), jnp.asarray(b))
        grads = vjp(jnp.asarray(gout))
    return (xg, w, b, gout), np.asarray(out), tuple(np.asarray(g) for g in grads)


GRID = [(H, T, B, reverse) for H in (1, 16, 24, 40) for T in (1, 33) for B in (1, 7)
        for reverse in (False, True)]


def _ids(case):
    H, T, B, reverse = case
    return f"H{H}-T{T}-B{B}-{'rev' if reverse else 'fwd'}"


@pytest.mark.parametrize("case", GRID, ids=[_ids(c) for c in GRID])
def test_backward_plain_matches_jax_vjp(case):
    H, T, B, reverse = case
    (xg, w, b, gout), _out, (dx, dw, db) = _jax_grads(H, T, B, reverse, seed=H + T + B)
    t = torch.from_numpy
    w_t = t(w).t().contiguous()
    out = tgru.gru_direction_plain(t(xg), w_t, t(b), reverse=reverse)
    gx, gw_t, gb = tgru.gru_direction_backward_plain(t(xg), w_t, t(b), out, t(gout),
                                                     reverse=reverse)
    _close(gx, dx)
    _close(gw_t.t(), dw)
    _close(gb, db)


@pytest.mark.parametrize("case", GRID, ids=[_ids(c) for c in GRID])
def test_function_matches_jax_vjp(case):
    """``GRUDirection`` on CPU tensors, through ``gru_direction`` as the
    trainer calls it: forward and gradients, with no kernel launched."""
    H, T, B, reverse = case
    (xg, w, b, gout), out_j, (dx, dw, db) = _jax_grads(H, T, B, reverse, seed=H + T + B)
    x = torch.from_numpy(xg).requires_grad_(True)
    w_hh = torch.from_numpy(w).requires_grad_(True)
    b_hh = torch.from_numpy(b).requires_grad_(True)
    launches = (tgru.gru_direction.launches, tgru.gru_direction_backward.launches)
    out = tgru.gru_direction(x, w_hh.t().contiguous(), b_hh, reverse=reverse)
    assert type(out.grad_fn).__name__ == "GRUDirectionBackward"
    out.backward(torch.from_numpy(gout))
    assert (tgru.gru_direction.launches, tgru.gru_direction_backward.launches) == launches
    _close(out.detach(), out_j)
    _close(x.grad, dx)
    _close(w_hh.grad, dw)
    _close(b_hh.grad, db)


@pytest.mark.parametrize("reverse", [False, True])
def test_function_passes_gradcheck_in_float64(reverse):
    rng = np.random.default_rng(11)
    H, T, B = 8, 5, 3
    x = torch.from_numpy(rng.normal(size=(T, B, 3 * H))).requires_grad_(True)
    w_t = torch.from_numpy(rng.uniform(-0.5, 0.5, (H, 3 * H))).requires_grad_(True)
    b = torch.from_numpy(rng.uniform(-0.5, 0.5, 3 * H)).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda *a: tgru.GRUDirection.apply(*a, reverse), (x, w_t, b))


def test_no_grad_forward_skips_the_function():
    xg, w, b, _g = _inputs(16, 33, 3, seed=1)
    w_t = torch.from_numpy(w).t().contiguous().requires_grad_(True)
    with torch.no_grad():
        out = tgru.gru_direction(torch.from_numpy(xg), w_t, torch.from_numpy(b))
    assert out.grad_fn is None
    # no input that requires grad: the plain forward, no Function
    assert tgru.gru_direction(torch.from_numpy(xg), w_t.detach(),
                              torch.from_numpy(b)).grad_fn is None


def _layer_vjp(p_np, x, gout, hidden):
    with jax.default_matmul_precision("highest"):
        _out, vjp = jax.vjp(lambda xx, pp: bigru._bigru_layer(xx, pp, hidden),
                            jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, p_np))
        dx, dp = vjp(jnp.asarray(gout))
    return np.asarray(dx), jax.tree_util.tree_map(np.asarray, dp)


def _check_layer(p_np, x, hidden, seed):
    gout = np.random.default_rng(seed).normal(size=(x.shape[0], x.shape[1], 2 * hidden))
    gout = gout.astype(np.float32)
    dx, dp = _layer_vjp(p_np, x, gout, hidden)
    p = {k: {n: torch.from_numpy(np.array(v, np.float32)).requires_grad_(True)
             for n, v in d.items()} for k, d in p_np.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tgru.bigru_layer(xt, p, hidden)
    out.backward(torch.from_numpy(gout))
    _close(xt.grad, dx)
    for k, d in p.items():
        for n, v in d.items():
            _close(v.grad, dp[k][n])


def test_bigru_layer_gradients_match_jax():
    hidden, in_dim, B, T = 16, 34, 5, 33
    p = bigru.init(jax.random.PRNGKey(3),
                   bigru.BiGRUConfig(in_channels=in_dim, hidden1=hidden, hidden2=hidden))
    p = jax.tree_util.tree_map(np.asarray, p["gru1"])
    x = np.random.default_rng(4).normal(size=(B, T, in_dim)).astype(np.float32)
    _check_layer(p, x, hidden, seed=5)


@pytest.mark.parametrize("layer,hidden", [("gru1", 128), ("gru2", 192)])
def test_bigru_layer_gradients_at_flagship_widths(layer, hidden):
    """The flagship ONT NEG weights at their real widths, two rows."""
    data = np.load(os.path.join(ASSETS, "flagship_ont_snv", "neg.npz"))
    p = {k: {n: data[f"['{layer}']/['{k}']/['{n}']"] for n in ("weight", "bias")}
         for k in ("ih", "hh", "ih_reverse", "hh_reverse")}
    in_dim = p["ih"]["weight"].shape[1]
    x = np.random.default_rng(6).normal(size=(2, 33, in_dim)).astype(np.float32)
    _check_layer(p, x, hidden, seed=7)


def test_backward_build_failure_raises(tmp_path, monkeypatch):
    """A backward source that nvcc refuses raises from ``build``, and no
    library is loaded in its place."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: broken source' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_native, "nvcc", lambda: str(fake))
    monkeypatch.setattr(tgru.LIBS["gru_bwd"], "so", str(tmp_path / "libgru_bwd.so"))
    monkeypatch.setattr(tgru.LIBS["gru_bwd"], "fns", None)
    with pytest.raises(RuntimeError, match="nvcc failed on gru_bwd.cu"):
        tgru.build(("gru_bwd",))
    assert tgru.LIBS["gru_bwd"].fns is None
    assert not os.path.exists(tmp_path / "libgru_bwd.so")
