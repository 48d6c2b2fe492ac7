"""The CvT's depthwise projection (``ops/dwproj.py``) on the CPU.

``dwproj_plain``, which the wrapper takes for CPU tensors, against the
layers it stands for: ``F.conv2d`` (3x3, groups=C, stride (1, s), padding 1)
followed by the BatchNorm's ``x * scale + shift``, in the forward and in
every gradient (the input, the 3x3 leaf with its outer rows exactly 0, and
the BatchNorm's weight, bias, running mean and running variance), at every
(channels, width) the SNV, indel and tiny CvTs give their projections, both
strides, contiguous and channels-last inputs; the output in the input's
memory format.  The backward kernel's arithmetic (the five per-channel sums
and the input gradient's index rule), emulated here chunk by chunk, against
autograd.  The first pass's geometry, the shape checks,
and the CvT sending every projection through ``dwproj``.  The kernels
themselves run on the card: ``tests/test_torch_dwproj_cuda.py``.
"""

import pytest
import torch
import torch.nn.functional as F

from clairs_to_tpu_torch.bench.demo import TINY_CVT
from clairs_to_tpu_torch.models import cvt
from clairs_to_tpu_torch.ops import dwproj as D

torch.set_num_threads(1)
ROWS = 6
TOL = 1e-5   # max |d| / max |ref|: float32 sums in another order


def _widths(config):
    """(channels, width) of each stage's projections: the input is 33 wide
    and each stage's embed halves it (stride 2, padding 1)."""
    w, out = config.width, set()
    for dim in config.emb_dims:
        w = (w - 1) // 2 + 1
        out.add((dim, w))
    return out


SHAPES = sorted(_widths(cvt.SNV_CVT_CONFIG) | _widths(cvt.INDEL_CVT_CONFIG) | _widths(TINY_CVT))


def _rel(got, want):
    got, want = got.detach(), want.detach()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def _leaves(C, W, channels_last, seed, rows=ROWS):
    """x, the 3x3 weight and the BatchNorm's four leaves, all requiring grad."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(rows, C, 1, W, generator=g)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    leaves = [x, torch.randn(C, 1, 3, 3, generator=g) * 0.3,
              torch.rand(C, generator=g) + 0.5, torch.randn(C, generator=g),
              torch.randn(C, generator=g) * 0.1, torch.rand(C, generator=g) + 0.5]
    return [t.requires_grad_(True) for t in leaves]


def _scale_shift(weight, bias, mean, var, eps=1e-5):
    inv = torch.rsqrt(var + eps)
    return weight * inv, bias - mean * weight * inv


def _layers(x, w, bn_w, bn_b, mean, var, stride):
    """The two layers the projection stands for, as the CvT ran them."""
    out = F.conv2d(x, w, stride=(1, stride), padding=(1, 1), groups=x.shape[1])
    scale, shift = _scale_shift(bn_w, bn_b, mean, var)
    return out * scale.reshape(1, -1, 1, 1) + shift.reshape(1, -1, 1, 1)


def _fmt(channels_last):
    return torch.channels_last if channels_last else torch.contiguous_format


@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("C,W", SHAPES)
def test_plain_equals_conv_and_batchnorm(C, W, stride, channels_last):
    got_in = _leaves(C, W, channels_last, seed=C + W + stride)
    want_in = [t.detach().clone().requires_grad_(True) for t in got_in]
    got = D.dwproj(got_in[0], got_in[1], *_scale_shift(*got_in[2:]), stride)
    want = _layers(*want_in, stride)
    assert got.shape == want.shape == (ROWS, C, 1, D.out_width(W, stride))
    assert got.is_contiguous(memory_format=_fmt(channels_last))
    assert _rel(got, want) <= TOL
    g = torch.randn(want.shape, generator=torch.Generator().manual_seed(W))
    got_grads = torch.autograd.grad(got, got_in, g)
    want_grads = torch.autograd.grad(want, want_in, g)
    for name, a, b in zip(("x", "weight", "bn.weight", "bn.bias", "running_mean",
                           "running_var"), got_grads, want_grads):
        assert _rel(a, b) <= TOL, name
    outer = got_grads[1][:, :, (0, 2), :]
    assert torch.equal(outer, torch.zeros_like(outer))


def _emulated_backward(x, w, scale, g, stride):
    """csrc/dwproj.cu's backward in PyTorch: per first-pass chunk (the
    geometry's rows) the sums of g x_t, g conv and g, then over the chunks;
    dx by the index rule j stride = i + 1 - t."""
    B, C, _, W = x.shape
    Wo = g.shape[-1]
    geo = D.bwd_geometry(B, C)
    k = w[:, 0, 1, :]
    xp = F.pad(x, (1, 1))[:, :, 0]
    span = (Wo - 1) * stride + 1
    taps = [xp[..., t:t + span:stride] for t in range(3)]
    conv = sum(tap * k[:, t, None] for t, tap in enumerate(taps))
    g = g[:, :, 0]
    sums = torch.zeros(C, 5)
    for lo in range(0, B, geo["rows_per_chunk"]):
        rows = slice(lo, lo + geo["rows_per_chunk"])
        part = [(g[rows] * tap[rows]).sum(dim=(0, 2)) for tap in taps]
        part += [(g[rows] * conv[rows]).sum(dim=(0, 2)), g[rows].sum(dim=(0, 2))]
        sums += torch.stack(part, dim=1)
    dx = torch.zeros(B, C, W)
    for i in range(W):
        for t in range(3):
            num = i + 1 - t
            if num >= 0 and num % stride == 0 and num // stride < Wo:
                dx[:, :, i] += k[:, t] * g[:, :, num // stride]
    dw = torch.zeros_like(w)
    dw[:, 0, 1, :] = sums[:, :3] * scale[:, None]
    return dx[:, :, None] * scale[:, None, None], dw, sums[:, 3], sums[:, 4]


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("C,W", [(16, 17), (64, 9), (128, 5)])
def test_the_kernels_backward_arithmetic_matches_autograd(C, W, stride):
    """40 rows: several first-pass chunks of 8 (16 for C=16) rows."""
    x, w, *bn = [t.detach() for t in _leaves(C, W, False, seed=C * W, rows=40)]
    scale, shift = _scale_shift(*bn)
    leaves = [t.clone().requires_grad_(True) for t in (x, w, scale, shift)]
    y = D.dwproj_plain(*leaves, stride)
    g = torch.randn(y.shape, generator=torch.Generator().manual_seed(stride))
    want = torch.autograd.grad(y, leaves, g)
    got = _emulated_backward(x, w, scale, g, stride)
    for name, a, b in zip(("dx", "dweight", "dscale", "dshift"), got, want):
        assert _rel(a, b) <= TOL, name


@pytest.mark.parametrize("B", [0, 1, 7, 800, 801, 8192, 100_000])
@pytest.mark.parametrize("C", [1, 16, 24, 32, 64, 128])
def test_backward_geometry_owns_every_row_once(B, C):
    geo = D.bwd_geometry(B, C)
    lanes = geo["threads"] // geo["ct"]
    assert geo["ct"] == min(C, 32) and geo["threads"] <= D.BWD_THREADS
    assert geo["rows_per_chunk"] % lanes == 0
    assert 1 <= geo["chunks"] <= D.BWD_MAX_CHUNKS
    assert (geo["chunks"] - 1) * geo["rows_per_chunk"] < max(B, 1) \
        <= geo["chunks"] * geo["rows_per_chunk"]
    assert geo == D.bwd_geometry(B, C)


@pytest.mark.parametrize("bad", ["two_rows", "kernel_5", "scale_length", "stride_0"])
def test_shapes_the_projection_does_not_take_raise(bad):
    x, w, *bn = [t.detach() for t in _leaves(16, 9, False, seed=1)]
    scale, shift = _scale_shift(*bn)
    args = dict(x=x, weight=w, scale=scale, shift=shift, stride=1)
    args.update({"two_rows": dict(x=torch.cat([x, x], dim=2)),
                 "kernel_5": dict(weight=torch.zeros(16, 1, 5, 5)),
                 "scale_length": dict(scale=scale[:8]),
                 "stride_0": dict(stride=0)}[bad])
    with pytest.raises(ValueError):
        D.dwproj(**args)


def test_a_tensor_off_the_cpu_takes_the_kernel_path_and_its_checks():
    """Any tensor not on the CPU sends the call to the kernels, whose checks
    refuse what is not one CUDA device: no plain fallback."""
    x, w, *bn = [t.detach() for t in _leaves(16, 9, False, seed=2)]
    scale, shift = _scale_shift(*bn)
    with pytest.raises(ValueError, match="one CUDA device"):
        D.dwproj(x, w.to("meta"), scale, shift, 2)
    launches = (D.dwproj.launches, D.dwproj_backward.launches)
    D.dwproj(x, w, scale, shift, 2)
    assert (D.dwproj.launches, D.dwproj_backward.launches) == launches


@pytest.mark.parametrize("config", [cvt.SNV_CVT_CONFIG, cvt.INDEL_CVT_CONFIG, TINY_CVT],
                         ids=["snv", "indel", "tiny"])
def test_the_cvt_sends_every_projection_through_dwproj(config, monkeypatch):
    seen = []

    def spy(x, weight, scale, shift, stride):
        seen.append((tuple(x.shape[1:]), stride))
        return D.dwproj(x, weight, scale, shift, stride)
    monkeypatch.setattr(cvt, "dwproj", spy)
    model = cvt.CvT(config).reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        model(torch.randn(2, 33, 34))
    assert len(seen) == 2 * sum(config.depths)
    assert {(c, w) for (c, _, w), _ in seen} == _widths(config)
    assert sorted({s for _, s in seen}) == [1, config.kv_proj_stride]


def test_a_build_failure_raises_and_loads_nothing(tmp_path, monkeypatch):
    from clairs_to_tpu_torch.ops import _native

    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: broken source' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_native, "nvcc", lambda: str(fake))
    monkeypatch.setattr(D.LIB, "so", str(tmp_path / "libdwproj.so"))
    monkeypatch.setattr(D.LIB, "fns", None)
    with pytest.raises(RuntimeError, match="nvcc failed on dwproj.cu"):
        D.build()
    assert D.LIB.fns is None
    assert not (tmp_path / "libdwproj.so").exists()
