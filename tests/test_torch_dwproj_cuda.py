"""The CvT's depthwise projection kernels (``csrc/dwproj.cu``) on the card.

The kernel pair against ``dwproj_plain`` under autograd at B=800 (a training
batch) and B=8,192 (an engine batch), for every (channels, width) of the
flagship SNV and indel CvTs, both strides, contiguous and channels-last
inputs: the output and each gradient (input, 3x3 weight with its outer rows
exactly 0, scale, shift) within 1e-5 of the largest reference value, and in
the input's memory format; two backward runs equal bit for bit; the pair
captured in a CUDA graph and replayed on new inputs equals the eager pair;
misuse (float64, an image two rows high, a non-contiguous weight, a wrong
gradient) raises; and ``.launches`` moves on the training step's path (the
capture of a graphed step) and the engine's.  Beside them, the CvT around
the pair: a training step runs no cuDNN ``wgrad_alg0_engine`` kernel, and
an engine batch launches no more kernels than the count written down.

Marked ``cuda``; each test skips where there is no GPU.  Run them on a
machine with an H100 with
``python -m pytest --noconftest -m cuda tests/test_torch_dwproj_cuda.py``
(``--noconftest``: tests/conftest.py imports jax, which that machine lacks).
"""

import numpy as np
import pytest
import torch

from clairs_to_tpu_torch.models import bigru, cvt
from clairs_to_tpu_torch.ops import dwproj as D

pytestmark = pytest.mark.cuda
TOL = 1e-5
SHAPES = [(16, 17), (32, 17), (64, 9), (128, 5)]   # flagship SNV and indel projections
# kernels of one SNV engine batch of 8,192 rows with the CvT's 1x1
# convolutions and stage embeds as F.conv2d (H100, torch 2.11)
ENGINE_KERNELS_CONV = 856


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _rel(got, want):
    got, want = got.detach(), want.detach()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def _inputs(B, C, W, channels_last, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, C, 1, W, generator=g)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    w = torch.randn(C, 1, 3, 3, generator=g) * 0.3
    scale, shift = torch.rand(C, generator=g) + 0.5, torch.randn(C, generator=g)
    return [t.cuda() for t in (x, w, scale, shift)]


def _fmt(channels_last):
    return torch.channels_last if channels_last else torch.contiguous_format


@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("C,W", SHAPES)
@pytest.mark.parametrize("B", [800, 8192])
def test_kernels_equal_the_plain_version(B, C, W, stride, channels_last):
    args = _inputs(B, C, W, channels_last, seed=B + C + stride)
    plain = [t.clone().requires_grad_(True) for t in args]
    kern = [t.clone().requires_grad_(True) for t in args]
    want = D.dwproj_plain(*plain, stride)
    launches = (D.dwproj.launches, D.dwproj_backward.launches)
    got = D.dwproj(*kern, stride)
    assert got.is_contiguous(memory_format=_fmt(channels_last))
    assert _rel(got, want) <= TOL
    g = torch.randn_like(want)
    want_grads = torch.autograd.grad(want, plain, g)
    got_grads = torch.autograd.grad(got, kern, g)
    torch.cuda.synchronize()
    assert (D.dwproj.launches, D.dwproj_backward.launches) == (launches[0] + 1, launches[1] + 1)
    for name, a, b in zip(("dx", "dweight", "dscale", "dshift"), got_grads, want_grads):
        assert _rel(a, b) <= TOL, name
    assert got_grads[0].is_contiguous(memory_format=_fmt(channels_last))
    outer = got_grads[1][:, :, (0, 2), :]
    assert torch.equal(outer, torch.zeros_like(outer))


@pytest.mark.parametrize("C,W", SHAPES)
def test_two_backward_runs_are_bit_equal(C, W):
    x, w, scale, _ = _inputs(800, C, W, False, seed=C)
    for stride in (1, 2):
        g = torch.randn(800, C, 1, D.out_width(W, stride), device="cuda")
        first = D.dwproj_backward(x, w, scale, g, stride)
        second = D.dwproj_backward(x, w, scale, g, stride)
        assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_a_captured_pair_replays_as_the_eager_pair():
    args = _inputs(800, 128, 5, False, seed=5)
    static = [t.clone().requires_grad_(True) for t in args]
    g = torch.randn(800, 128, 1, 3, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):   # builds and loads the library outside the capture
        torch.autograd.grad(D.dwproj(*static, 2), static, g)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = D.dwproj(*static, 2)
        grads = torch.autograd.grad(y, static, g)
    fresh = _inputs(800, 128, 5, False, seed=6)
    with torch.no_grad():
        for dst, src in zip(static, fresh):
            dst.copy_(src)
    graph.replay()
    eager = [t.clone().requires_grad_(True) for t in fresh]
    want_y = D.dwproj(*eager, 2)
    want = torch.autograd.grad(want_y, eager, g)
    torch.cuda.synchronize()
    assert torch.equal(y, want_y)
    assert all(torch.equal(a, b) for a, b in zip(grads, want))


@pytest.mark.parametrize("bad", ["float64", "two_rows", "weight_view", "gradient"])
def test_misuse_raises(bad):
    x, w, scale, shift = _inputs(8, 16, 9, False, seed=1)
    if bad == "float64":
        with pytest.raises(TypeError):
            D.dwproj(x.double(), w.double(), scale.double(), shift.double(), 1)
    elif bad == "two_rows":
        with pytest.raises(ValueError):
            D.dwproj(torch.cat([x, x], dim=2), w, scale, shift, 1)
    elif bad == "weight_view":
        with pytest.raises(ValueError):
            D.dwproj(x, w.transpose(2, 3), scale, shift, 1)
    else:
        with pytest.raises(ValueError):
            D.dwproj_backward(x, w, scale, torch.zeros(8, 16, 1, 9, device="cuda"), 2)


def test_launches_move_on_the_training_and_engine_paths():
    from clairs_to_tpu_torch.infer.engine import InferenceEngine
    from clairs_to_tpu_torch.ops import posterior as post
    from clairs_to_tpu_torch.train import CAPTURE_WARMUP_STEPS, DualTrainer, TrainConfig

    projections = 2 * sum(cvt.SNV_CVT_CONFIG.depths)
    trainer = DualTrainer("snv", TrainConfig(), device="cuda")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 40, size=(96, 33, 34)).astype(np.float32)).cuda()
    labels = torch.from_numpy(rng.integers(0, 2, size=(96, 4))).cuda()
    before = (D.dwproj.launches, D.dwproj_backward.launches)
    gen = torch.Generator(device="cuda").manual_seed(1)
    for _ in range(3):   # one capture, then replays that launch nothing from the host
        trainer.step(x, x + 1, labels, 1 - labels, gen)
    steps = CAPTURE_WARMUP_STEPS + 1
    assert (D.dwproj.launches - before[0], D.dwproj_backward.launches - before[1]) == \
        (steps * projections, steps * projections)
    gen0 = torch.Generator().manual_seed(0)
    engine = InferenceEngine(cvt.CvT(cvt.SNV_CVT_CONFIG).reset_parameters(gen0),
                             bigru.BiGRU(bigru.SNV_BIGRU_CONFIG).reset_parameters(gen0),
                             post.uniform_likelihood_data(4), device_batch=256, device="cuda")
    counts = rng.integers(0, 40, size=(256, 33, 34)).astype(np.int32)
    cov = np.full(256, 30, np.float32)
    before = D.dwproj.launches
    engine.run_batch(counts, counts, cov, cov)
    assert D.dwproj.launches - before == projections


def _kernels(fn):
    """Names of the kernels ``fn`` runs on the card, once warmed up (memset
    and copy operations left out)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith(("Memcpy", "Memset"))]


def _train_batch(rows, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 40, size=(rows, 33, 34)).astype(np.float32)
    som = rng.integers(-1, 4, size=rows)
    aff = np.stack([som == k for k in range(4)], axis=1).astype(np.int64)
    return [torch.from_numpy(a).cuda() for a in (x, x + 1, aff, 1 - aff)]


def test_a_training_step_takes_no_wgrad_alg0_engine():
    """The CvT's convolutions but the depthwise one are GEMMs over its
    tokens: an eager SNV step at 800 rows (a training batch) runs no cuDNN
    ``wgrad_alg0_engine`` kernel, in either layout's variant."""
    from clairs_to_tpu_torch.train import DualTrainer, TrainConfig

    trainer = DualTrainer("snv", TrainConfig(dropout_rate=0.3), device="cuda")
    batch, gen = _train_batch(800, 0), torch.Generator(device="cuda").manual_seed(1)
    names = _kernels(lambda: trainer._eager_step(*batch, generator=gen))
    assert not [n for n in names if "wgrad_alg0_engine" in n]


def test_an_engine_forward_launches_no_more_kernels():
    """One SNV engine batch of 8,192 rows launches no more kernels than
    ``ENGINE_KERNELS_CONV``; with the CvT's GEMMs it launched 822 there."""
    from clairs_to_tpu_torch.infer.engine import InferenceEngine
    from clairs_to_tpu_torch.ops import posterior as post

    gen0 = torch.Generator().manual_seed(0)
    engine = InferenceEngine(cvt.CvT(cvt.SNV_CVT_CONFIG).reset_parameters(gen0),
                             bigru.BiGRU(bigru.SNV_BIGRU_CONFIG).reset_parameters(gen0),
                             post.uniform_likelihood_data(4), device_batch=8192, device="cuda")
    rng = np.random.default_rng(0)
    counts = rng.integers(0, 40, size=(8192, 33, 34)).astype(np.int32)
    cov = np.full(8192, 30, np.float32)
    names = _kernels(lambda: engine.run_batch(counts, counts + 1, cov, cov))
    assert len(names) <= ENGINE_KERNELS_CONV, len(names)
