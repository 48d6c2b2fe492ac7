"""The launch geometry of the backward kernel (csrc/gru_bwd.cu) and its split
of the work, on the CPU.

``ops/gru.py::bwd_geometry`` sizes the kernel's grid: clusters of CTAs,
each CTA a slice of hidden columns, each cluster a slice of batch rows.
These tests hold it to what the kernel needs (every (row, column) owned
exactly once, shared memory and threads within a CTA's limits), and hold a
NumPy emulation of the kernel's split (per-CTA column slices of W_hh^T and
W_hh, grad_hg gathered from every CTA's slice each step) to ``_bptt_plain``
and to ``jax.vjp`` of clairs_to_tpu/models/bigru.py::_gru_direction.  The
kernel itself against its plain version on the card: tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clairs_to_tpu.models import bigru
from clairs_to_tpu_torch.ops import gru as tgru

BATCHES = (1, 15, 16, 17, 255, 256, 257, 800, 8192)


def _owners(n, per, parts):
    """Which of ``parts`` slices of ``per`` owns each of n indices; fails
    on an index owned twice or never."""
    owner = np.full(n, -1)
    for p in range(parts):
        span = np.arange(p * per, min(n, (p + 1) * per))
        assert (owner[span] == -1).all()
        owner[span] = p
    assert (owner >= 0).all()
    return owner


@pytest.mark.parametrize("active", [1, 7, 15, 30, 132])
def test_geometry_owns_every_row_and_column_once(active):
    for H in range(1, tgru.MAX_HIDDEN + 1):
        cluster = tgru.bwd_cluster(H)
        assert cluster in tgru.BWD_CLUSTERS
        if cluster == 16:   # the non-portable size only where 8 leaves too little room
            assert tgru.bwd_max_rows(H, 8) < tgru.BWD_MIN_ROWS
        for B in BATCHES:
            geo = tgru.bwd_geometry(H, B, active)
            assert geo["cluster"] == cluster and geo["ctas"] == geo["clusters"] * cluster
            assert geo["rows"] % tgru.BWD_TILE == 0 and geo["rows"] <= tgru.bwd_max_rows(H, cluster)
            _owners(B, geo["rows"], geo["clusters"])
            _owners(H, geo["cols"], cluster)
            assert geo["smem_bytes"] == tgru.bwd_smem_bytes(H, cluster, geo["rows"])
            assert geo["smem_bytes"] <= 227 * 1024
            assert 0 < geo["threads"] <= tgru.BWD_MAX_THREADS
            assert geo["waves"] == -(-geo["clusters"] // active)


@pytest.mark.parametrize("H,active,clusters", [(192, 15, 13), (192, 16, 16), (128, 30, 22)])
def test_geometry_fills_one_wave_at_the_training_batch(H, active, clusters):
    """``train`` runs B=256: one wave of clusters on a card that holds
    ``active`` of them at once (15 clusters of 8 on an H100 80GB HBM3)."""
    geo = tgru.bwd_geometry(H, 256, active)
    assert geo["waves"] == 1 and geo["clusters"] == clusters


def test_geometry_raises_when_the_card_runs_no_cluster():
    with pytest.raises(RuntimeError, match="cannot run a cluster of 8 CTAs"):
        tgru.bwd_geometry(192, 256, 0)


def test_smem_bytes_at_the_flagship_widths():
    """The layout's arithmetic spelled out once (csrc/gru_bwd.cu, ``Layout``):
    at H=192 a cluster of 8 CTAs, 24 columns each; W_hh^T rows of 72 floats
    padded to 76, W_hh rows of 24 padded to 28; h_prev rows of 196 and
    grad_hg rows of 580 floats."""
    assert tgru.bwd_cluster(192) == 8 and tgru.bwd_cols(192, 8) == (24, 24)
    assert tgru.bwd_smem_bytes(192, 8, 20) == 4 * (192 * 76 + 576 * 28 + 20 * 196 + 2 * 20 * 580)
    assert tgru.bwd_max_rows(192, 8) == 20
    assert tgru.bwd_cluster(128) == 4 and tgru.bwd_max_rows(128, 4) == 16   # 256 threads
    assert tgru.bwd_cluster(256) == 16 and tgru.bwd_cols(256, 16) == (16, 16)


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def emulate(xg, wt, bhh, h, gout, reverse, cluster, rows):
    """The kernel's split in NumPy, float32: cluster n owns batch rows
    [n rows, n rows + rows); its CTA c owns hidden columns J and keeps
    W_hh^T[:, (J, H + J, 2H + J)] and W_hh[:, J] = W_hh^T[J, :]^T.  Each
    step every CTA rebuilds hg for J from the full h_prev, forms its slice
    of grad_hg and writes it into the cluster's gathered buffer; then every
    CTA takes dh_prev[:, J] from the whole buffer.  Returns (grad_x_gates,
    grad_hg)."""
    T, B, H3 = xg.shape
    H = H3 // 3
    cols = -(-H // cluster)
    gx, ghg = np.zeros_like(xg), np.zeros_like(xg)
    slices = [np.arange(c * cols, min(H, (c + 1) * cols)) for c in range(cluster)]
    for r0 in range(0, B, rows):
        rs = slice(r0, min(B, r0 + rows))
        carry = np.zeros((rs.stop - r0, H), np.float32)
        for s in range(T):
            t = s if reverse else T - 1 - s
            tp = t + 1 if reverse else t - 1
            h_prev = h[tp, rs] if 0 <= tp < T else np.zeros_like(carry)
            gathered = np.zeros((rs.stop - r0, H3), np.float32)
            for J in slices:
                if not len(J):
                    continue
                idx = np.concatenate([J, H + J, 2 * H + J])
                hg = h_prev @ wt[:, idx] + bhh[idx]
                x = xg[t, rs][:, idx]
                n_j = len(J)
                r = _sigmoid(x[:, :n_j] + hg[:, :n_j])
                z = _sigmoid(x[:, n_j:2 * n_j] + hg[:, n_j:2 * n_j])
                hn = hg[:, 2 * n_j:]
                n = np.tanh(x[:, 2 * n_j:] + r * hn)
                dh = gout[t, rs][:, J] + carry[:, J]
                dpn = dh * (1 - z) * (1 - n * n)
                dpz = dh * (h_prev[:, J] - n) * (z * (1 - z))
                dpr = dpn * hn * (r * (1 - r))
                gx[t][rs, idx] = np.concatenate([dpr, dpz, dpn], axis=1)
                gathered[:, idx] = np.concatenate([dpr, dpz, dpn * r], axis=1)
                carry[:, J] = dh * z
            ghg[t, rs] = gathered
            for J in slices:   # after the cluster barrier: W_hh[:, J] from W_hh^T[J, :]
                carry[:, J] += gathered @ wt[J, :].T
    return gx, ghg


def _case(H, T, B, seed):
    rng = np.random.default_rng(seed)
    bound = H ** -0.5
    xg = rng.normal(size=(T, B, 3 * H)).astype(np.float32)
    w = rng.uniform(-bound, bound, (3 * H, H)).astype(np.float32)   # torch.nn.GRU's W_hh
    b = rng.uniform(-bound, bound, 3 * H).astype(np.float32)
    gout = rng.normal(size=(T, B, H)).astype(np.float32)
    return xg, w, b, gout


def _close(got, want, tol=1e-5):
    """max |Δ| <= tol · max(1, max |ref|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())


# (H, cluster, rows): one CTA; 4 CTAs of 6 columns; 8 of 5 (the last short);
# 16 of 3 (the last two without a column); H=17 in 4 CTAs of 5; the
# flagship gru1 geometry at a small batch
SPLITS = [(16, 1, 4), (24, 4, 8), (40, 8, 4), (40, 16, 12), (17, 4, 4), (128, 4, 8)]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("H,cluster,rows", SPLITS)
def test_emulated_split_matches_the_plain_backward_and_jax(H, cluster, rows, reverse):
    T, B = 5, 7   # B not a multiple of rows: the last cluster is short
    xg, w, b, gout = _case(H, T, B, seed=H + cluster)
    wt = np.ascontiguousarray(w.T)
    t = torch.from_numpy
    out = tgru.gru_direction_plain(t(xg), t(wt), t(b), reverse=reverse)
    gx, ghg = emulate(xg, wt, b, out.numpy(), gout, reverse, cluster, rows)
    want_gx, want_ghg = tgru._bptt_plain(t(xg), t(wt), t(b), out, t(gout), reverse)
    _close(gx, want_gx)
    _close(ghg, want_ghg)

    def f(x, w_hh, b_hh):
        p = {"weight": w_hh, "bias": b_hh}
        if reverse:
            return bigru._gru_direction(x[::-1], p, H)[::-1]
        return bigru._gru_direction(x, p, H)

    with jax.default_matmul_precision("highest"):
        _out, vjp = jax.vjp(f, jnp.asarray(xg), jnp.asarray(w), jnp.asarray(b))
        dx, dw, db = (np.asarray(g) for g in vjp(jnp.asarray(gout)))
    _close(gx, dx)
    grad_w_t, grad_b = tgru._weight_grads(out, t(ghg), reverse)
    _close(grad_w_t.numpy().T, dw)
    _close(grad_b.numpy(), db)
