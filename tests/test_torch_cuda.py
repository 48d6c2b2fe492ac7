"""The port's CUDA kernels on the card: ``gru_direction`` and
``gru_direction_backward`` against their plain versions, and training
through them against training through the plain loop.

Marked ``cuda``; each test skips where there is no GPU.  Run them on a
machine with an H100 with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``
(``--noconftest``: tests/conftest.py imports jax, which that machine lacks).
"""

import numpy as np
import pytest
import torch

from clairs_to_tpu_torch.ops import gru as tgru

pytestmark = pytest.mark.cuda
T = 33


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(B, H, seed, device, T=T):
    rng = np.random.default_rng(seed)
    xg = torch.from_numpy(rng.normal(size=(T, B, 3 * H)).astype(np.float32)).to(device)
    bound = H ** -0.5
    w = torch.from_numpy(rng.uniform(-bound, bound, size=(H, 3 * H)).astype(np.float32))
    b = torch.from_numpy(rng.uniform(-bound, bound, size=3 * H).astype(np.float32))
    return xg, w.to(device), b.to(device)


@pytest.mark.parametrize("H", [1, 16, 24, 40, 128, 192, 200, 256])
@pytest.mark.parametrize("B", [1, 63, 65, 1000, 8191, 8192])
@pytest.mark.parametrize("steps", [1, T])
@pytest.mark.parametrize("reverse", [False, True])
def test_kernel_matches_plain(cuda, H, B, steps, reverse):
    """Ragged last tiles (B not a multiple of 64); H not a multiple of 4
    (no 16-byte path), of 32 (the K padding) or of a 64-unit group; one
    step and the engine's 33."""
    xg, w, b = _inputs(B, H, seed=H + B, device=cuda, T=steps)
    before = tgru.gru_direction.launches
    got = tgru.gru_direction(xg, w, b, reverse=reverse)
    torch.cuda.synchronize()
    assert tgru.gru_direction.launches == before + 1
    want = tgru.gru_direction_plain(xg, w, b, reverse=reverse)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_kernel_is_deterministic(cuda):
    xg, w, b = _inputs(8191, 192, seed=3, device=cuda)
    first = tgru.gru_direction(xg, w, b)
    second = tgru.gru_direction(xg, w, b)
    assert torch.equal(first, second)


def test_kernel_rejects_bad_inputs(cuda):
    xg, w, b = _inputs(8, 16, seed=0, device=cuda)
    with pytest.raises(TypeError):
        tgru.gru_direction(xg.double(), w.double(), b.double())
    with pytest.raises(ValueError):
        tgru.gru_direction(xg[:, :, :47], w, b)
    with pytest.raises(ValueError):
        tgru.gru_direction(xg.transpose(0, 1), w, b)
    xg, w, b = _inputs(2, 257, seed=0, device=cuda)
    with pytest.raises(ValueError):
        tgru.gru_direction(xg, w, b)


def _rel(got, want):
    """max |got - want| / max |want|: the phase-2 measure of chip_smoke.py."""
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("H", [1, 16, 24, 40, 128, 192, 200, 256])
@pytest.mark.parametrize("B", [1, 15, 16, 17, 63, 65, 255, 256, 257, 800, 1000, 8191, 8192])
@pytest.mark.parametrize("reverse", [False, True])
def test_backward_kernel_matches_plain(cuda, H, B, reverse):
    """The backward kernel against ``gru_direction_backward_plain`` from the
    forward kernel's output: every gradient within 1e-5 of the largest
    reference value.  B straddles the rows a cluster owns (4, 12, 16, 20 at
    these H) and the training batch; no cluster size divides H = 24, 40 or
    200 into whole tiles of 4 columns, and at H = 1 three of a tile's four
    columns are padding."""
    xg, w, b = _inputs(B, H, seed=H + B + 1, device=cuda)
    out = tgru.gru_direction(xg, w, b, reverse=reverse)
    gout = torch.randn(out.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(H))
    before = tgru.gru_direction_backward.launches
    got = tgru.gru_direction_backward(xg, w, b, out, gout, reverse=reverse)
    torch.cuda.synchronize()
    assert tgru.gru_direction_backward.launches == before + 1
    want = tgru.gru_direction_backward_plain(xg, w, b, out, gout, reverse=reverse)
    for name, g, r in zip(("grad_x_gates", "grad_w_hh_t", "grad_b_hh"), got, want):
        assert g.shape == r.shape and torch.isfinite(g).all(), name
        assert _rel(g, r) <= 1e-5, (name, _rel(g, r))


@pytest.mark.parametrize("reverse", [False, True])
def test_function_matches_autograd_through_the_plain_loop(cuda, reverse):
    """``GRUDirection`` (the two kernels) against autograd through
    ``gru_direction_plain`` on the card, at the flagship gru2 width."""
    xg, w, b = _inputs(800, 192, seed=5, device=cuda)
    gout = torch.randn(T, 800, 192, device=cuda)
    leaves = [t.clone().requires_grad_(True) for t in (xg, w, b)]
    got = torch.autograd.grad(tgru.gru_direction(*leaves, reverse=reverse), leaves, gout)
    plain = [t.clone().requires_grad_(True) for t in (xg, w, b)]
    want = torch.autograd.grad(tgru.gru_direction_plain(*plain, reverse=reverse), plain, gout)
    for g, r in zip(got, want):
        assert _rel(g, r) <= 1e-5, _rel(g, r)


def test_backward_kernel_is_deterministic(cuda):
    xg, w, b = _inputs(8191, 192, seed=4, device=cuda)
    out = tgru.gru_direction(xg, w, b)
    gout = torch.randn_like(out)
    first = tgru.gru_direction_backward_kernel(xg, w, b, out, gout)
    second = tgru.gru_direction_backward_kernel(xg, w, b, out, gout)
    assert all(torch.equal(a, c) for a, c in zip(first, second))


def test_backward_kernel_rejects_bad_inputs(cuda):
    xg, w, b = _inputs(8, 16, seed=0, device=cuda)
    out = tgru.gru_direction(xg, w, b)
    with pytest.raises(ValueError):
        tgru.gru_direction_backward(xg, w, b, out[:, :4], out)
    with pytest.raises(ValueError):
        tgru.gru_direction_backward(xg, w, b, out, out.transpose(0, 1).contiguous())
    with pytest.raises(TypeError):
        tgru.gru_direction_backward(xg, w, b, out, out.double())


def test_unschedulable_cluster_raises(cuda, monkeypatch):
    """No fallback: a cluster shape that the card reports it cannot run
    (no cluster at once), or that the kernel's library refuses (32 CTAs),
    raises RuntimeError without launching the kernel or running the plain
    loop."""
    xg, w, b = _inputs(256, 192, seed=6, device=cuda)
    out = tgru.gru_direction(xg, w, b)

    def no_plain(*a, **k):
        raise AssertionError("the plain loop ran on CUDA tensors")
    monkeypatch.setattr(tgru, "_bptt_plain", no_plain)
    before = tgru.gru_direction_backward.launches
    key = (192, torch.cuda.current_device())
    monkeypatch.setitem(tgru._active, key, 0)
    with pytest.raises(RuntimeError, match="cannot run a cluster"):
        tgru.gru_direction_backward(xg, w, b, out, out)
    monkeypatch.delitem(tgru._active, key)
    monkeypatch.setattr(tgru, "bwd_cluster", lambda H: 32)
    with pytest.raises(RuntimeError, match="refused"):
        tgru.gru_direction_backward(xg, w, b, out, out)
    assert tgru.gru_direction_backward.launches == before


def test_unbuildable_backward_raises_in_training(cuda, tmp_path, monkeypatch):
    """No fallback: with a backward source that does not compile, a training
    step on the card raises instead of training through the plain loop."""
    from clairs_to_tpu_torch.bench.demo import TINY_BIGRU, TINY_CVT
    from clairs_to_tpu_torch.train import DualTrainer, TrainConfig

    broken = tmp_path / "gru_bwd.cu"
    broken.write_text(open(tgru.LIBS["gru_bwd"].source).read() + "\nthis is not C++;\n")
    monkeypatch.setattr(tgru.LIBS["gru_bwd"], "source", str(broken))
    monkeypatch.setattr(tgru.LIBS["gru_bwd"], "so", str(tmp_path / "libgru_bwd.so"))
    monkeypatch.setattr(tgru.LIBS["gru_bwd"], "fns", None)
    tgru.build(("gru",))
    tr = DualTrainer("snv", TrainConfig(dropout_rate=0.0), TINY_CVT, TINY_BIGRU, device="cuda")
    x = torch.zeros(16, 33, 34, device=cuda)
    labels = torch.zeros(16, 4, dtype=torch.int64, device=cuda)
    loss = tr.loss(x, x, labels, 1 - labels)
    with pytest.raises(RuntimeError, match="nvcc failed on gru_bwd.cu"):
        loss.backward()
    assert tgru.LIBS["gru_bwd"].fns is None


def test_training_step_on_the_card_matches_the_cpu(cuda):
    """One step of the tiny pair from the same weights: the card's loss and
    gradient norm (the GRU kernels) against the CPU path's (the plain loops)."""
    from clairs_to_tpu_torch.bench.demo import TINY_BIGRU, TINY_CVT
    from clairs_to_tpu_torch.bench.synth import synthesize_batch
    from clairs_to_tpu_torch.train import DualTrainer, TrainConfig

    torch.backends.cudnn.allow_tf32 = False
    x, cov, som = synthesize_batch(np.random.default_rng(0), 256)
    x = x * np.where(cov > 50, 50.0 / cov, 1.0).astype(np.float32)[:, None, None]
    aff = np.stack([som == k for k in range(4)], axis=1).astype(np.int64)
    got = []
    for device in ("cuda", "cpu"):
        tr = DualTrainer("snv", TrainConfig(dropout_rate=0.0), TINY_CVT, TINY_BIGRU,
                         device=device)
        batch = [torch.from_numpy(a).to(device) for a in (x, x, aff, 1 - aff)]
        loss = tr.loss(*batch)
        loss.backward()
        got.append((loss.item(), tr.apply_gradients().item()))
    np.testing.assert_allclose(got[0], got[1], rtol=1e-4)


def test_kernel_step_matches_the_plain_loop_step(cuda):
    """One flagship-width step from the same weights through the kernels and
    through the plain loop under autograd: the loss within 1e-6 and every
    gradient leaf within 1e-5, relative."""
    from clairs_to_tpu_torch.bench.grad_check import compare, step_grads, train_batch
    from clairs_to_tpu_torch.train import DualTrainer, TrainConfig

    tc = TrainConfig(dropout_rate=0.0)
    batch, _ = train_batch(256, 5, "cuda")
    kern = DualTrainer("snv", tc, device="cuda")
    plain = DualTrainer("snv", tc, device="cuda")
    for net in ("aff", "neg"):
        plain.models[net].load_state_dict(kern.models[net].state_dict())
    gap = compare(step_grads(kern, batch), step_grads(plain, batch, use_kernel=False))
    assert gap["loss_rel"] <= 1e-6 and gap["worst_leaf_rel"] <= 1e-5, gap
