"""The CvT's depthwise projection: a hand-written CUDA kernel pair and its
plain version.

``dwproj`` is the 3x3 depthwise convolution (stride (1, s), padding 1) of a
(B, C, 1, W) image followed by the BatchNorm's per-channel ``scale`` and
``shift``.  On an image one row high only the kernel's middle row meets
data, so it is a 3-tap filter along W.  For CUDA tensors it launches the
forward kernel of ``csrc/dwproj.cu``, and under autograd runs through
``DWProj``, whose backward is that file's backward kernels; for CPU tensors
it runs ``dwproj_plain`` (three shifted slices), which autograd
differentiates.  On a CUDA tensor it launches its kernel or raises; it never
falls back.  The output keeps the input's memory format (channels-last or
contiguous), as ``F.conv2d`` followed by elementwise ops does.

No TPU kernel is replaced: the JAX package leaves this convolution to XLA.
The kernels are built by ``nvcc`` into ``build/kernels/libdwproj.so`` at the
repository root on first use and loaded with ctypes (``ops/_native.py``).
"""

import ctypes
import threading

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from clairs_to_tpu_torch.ops import _native

TAPS = 3
SUMS = 5             # csrc/dwproj.cu: per-channel sums of the backward
BWD_THREADS = 256    # threads of a block of the backward's first pass
BWD_MAX_CHUNKS = 128  # batch chunks of the first pass, each a block column

_P, _I = ctypes.c_void_p, ctypes.c_int
_S = ctypes.POINTER(ctypes.c_longlong)
LIB = _native.Library(
    "dwproj.cu", "libdwproj.so",
    {"dwproj_forward_f32": (_I, [_P] * 5 + [_I] * 5 + [_S] * 2 + [_I, _P]),
     "dwproj_backward_f32": (_I, [_P] * 9 + [_I] * 5 + [_S] * 3 + [_I] * 4 + [_P])})
_count_lock = threading.Lock()


def build(verbose=False):
    """Compile ``csrc/dwproj.cu`` if the library is missing or older than it,
    and load it.  Returns the compiler's diagnostics ("" when current);
    raises with them if the build fails."""
    return _native.build(LIB, verbose=verbose)


def out_width(W, stride):
    """Output width of a 3-tap convolution with padding 1 and ``stride``."""
    return (W - 1) // stride + 1


def _format(x):
    """The memory format ``F.conv2d`` gives its output for ``x``."""
    cl = not x.is_contiguous() and x.is_contiguous(memory_format=torch.channels_last)
    return torch.channels_last if cl else torch.contiguous_format


def _check_shapes(x, weight, stride, *per_channel):
    """Raise unless ``x`` (B, C, 1, W), ``weight`` (C, 1, 3, 3) and the
    (C,) tensors ``per_channel`` make a projection; returns (B, C, W,
    W_out)."""
    if x.dim() != 4 or x.shape[2] != 1:
        raise ValueError(f"dwproj: input (B, C, 1, W), got {tuple(x.shape)}")
    B, C, _, W = x.shape
    if tuple(weight.shape) != (C, 1, 3, 3) or any(tuple(t.shape) != (C,) for t in per_channel):
        raise ValueError(f"dwproj: weight (C, 1, 3, 3), scale and shift (C,) for C={C}")
    if min(stride, C, W) < 1:
        raise ValueError(f"dwproj: stride {stride}, channels {C} and width {W} must be positive")
    return B, C, W, out_width(W, stride)


def dwproj_plain(x, weight, scale, shift, stride):
    """The projection in plain PyTorch: x (B, C, 1, W), weight (C, 1, 3, 3)
    of which the middle row is used, scale and shift (C,).  Returns
    (B, C, 1, W_out) in ``x``'s memory format."""
    W = _check_shapes(x, weight, stride, scale, shift)[2]
    span = (out_width(W, stride) - 1) * stride + 1
    xp = F.pad(x, (1, 1))
    k = weight[:, 0, 1, :]

    def col(v):
        return v.reshape(1, -1, 1, 1)
    conv = sum(xp[..., t:t + span:stride] * col(k[:, t]) for t in range(TAPS))
    return (conv * col(scale) + col(shift)).contiguous(memory_format=_format(x))


def bwd_geometry(B, C):
    """The backward's first pass: blocks of ``ct`` channels x ``threads //
    ct`` row lanes, over ``chunks`` chunks of ``rows_per_chunk`` batch rows
    (a multiple of the row lanes); depends on (B, C) only, so the sums are
    taken in one order for a shape."""
    ct = min(C, 32)
    lanes = BWD_THREADS // ct
    B = max(B, 1)
    rows = -(-B // min(-(-B // lanes), BWD_MAX_CHUNKS))
    rows = -(-rows // lanes) * lanes
    return dict(ct=ct, threads=lanes * ct, chunks=-(-B // rows), rows_per_chunk=rows)


def _strides(t):
    s = t.stride()
    return (ctypes.c_longlong * 3)(s[0], s[1], s[3])


def _check(x, weight, stride, *per_channel):
    """Raise unless ``x``, ``weight`` and the (C,) tensors ``per_channel``
    are a projection the kernels take; returns (B, C, W, W_out)."""
    tensors = (x, weight, *per_channel)
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError("dwproj: all tensors must be on one CUDA device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("dwproj: float32 tensors only")
    shape = _check_shapes(x, weight, stride, *per_channel)
    if not all(t.is_contiguous() for t in (weight, *per_channel)):
        raise ValueError("dwproj: weight, scale and shift must be contiguous")
    return shape


def _forward(x, weight, scale, shift, stride):
    """The forward kernel, without autograd."""
    B, C, W, Wo = _check(x, weight, stride, scale, shift)
    fmt = _format(x)
    y = torch.empty((B, C, 1, Wo), dtype=torch.float32, device=x.device, memory_format=fmt)
    with torch.cuda.device(x.device):
        err = LIB.fn("dwproj_forward_f32")(
            x.data_ptr(), weight.data_ptr(), scale.data_ptr(), shift.data_ptr(), y.data_ptr(),
            B, C, W, Wo, stride, _strides(x), _strides(y), int(fmt == torch.channels_last),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"dwproj forward kernel launch failed: cudaError {err}")
    with _count_lock:   # a server launches from several threads
        dwproj.launches += 1
    return y


def dwproj_backward(x, weight, scale, g, stride):
    """The kernels' gradients of ``dwproj`` for CUDA tensors, given the
    gradient ``g`` on its output: (dx in ``x``'s memory format, dweight
    (C, 1, 3, 3) with its outer rows 0, dscale, dshift).  Deterministic: no
    atomics, and sums taken in an order fixed by the shape.
    ``dwproj_backward.launches`` counts its calls as the host makes them
    (two kernels each): once at a CUDA graph's capture, not at each replay."""
    B, C, W, Wo = _check(x, weight, stride, scale)
    if g.device != x.device or g.dtype != torch.float32 or tuple(g.shape) != (B, C, 1, Wo):
        raise ValueError(f"dwproj_backward: gradient {tuple(g.shape)} {g.dtype} on {g.device} "
                         f"for an output ({B}, {C}, 1, {Wo}) float32 on {x.device}")
    geo = bwd_geometry(B, C)
    dx = torch.empty((B, C, 1, W), dtype=torch.float32, device=x.device,
                     memory_format=_format(x))
    partial = torch.empty((C, SUMS, geo["chunks"]), dtype=torch.float32, device=x.device)
    dweight = torch.empty_like(weight)
    dscale = torch.empty_like(scale)
    dshift = torch.empty_like(scale)
    with torch.cuda.device(x.device):
        err = LIB.fn("dwproj_backward_f32")(
            x.data_ptr(), g.data_ptr(), weight.data_ptr(), scale.data_ptr(), dx.data_ptr(),
            partial.data_ptr(), dweight.data_ptr(), dscale.data_ptr(), dshift.data_ptr(),
            B, C, W, Wo, stride, _strides(x), _strides(g), _strides(dx), geo["ct"],
            geo["threads"], geo["chunks"], geo["rows_per_chunk"],
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"dwproj backward kernel launch failed: cudaError {err}")
    with _count_lock:
        dwproj_backward.launches += 1
    return dx, dweight, dscale, dshift


dwproj_backward.launches = 0


class DWProj(torch.autograd.Function):
    """``dwproj`` of CUDA tensors with its gradient: the forward kernel,
    keeping x, the weight and scale; the backward kernels."""

    @staticmethod
    def forward(ctx, x, weight, scale, shift, stride):
        ctx.save_for_backward(x, weight, scale)
        ctx.stride = stride
        return _forward(x, weight, scale, shift, stride)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, weight, scale = ctx.saved_tensors
        return (*dwproj_backward(x, weight, scale, g, ctx.stride), None)


def dwproj(x, weight, scale, shift, stride):
    """The projection: x (B, C, 1, W) float32, weight (C, 1, 3, 3) (its
    middle row used), scale and shift (C,), ``stride`` along W.  Returns
    (B, C, 1, (W - 1) // stride + 1) in ``x``'s memory format.  CPU tensors
    take ``dwproj_plain``; CUDA tensors the kernels, through ``DWProj`` when
    grad mode is on and an input requires grad.  ``dwproj.launches`` counts
    the forward kernel's launches as the host makes them."""
    if all(t.device.type == "cpu" for t in (x, weight, scale, shift)):
        return dwproj_plain(x, weight, scale, shift, stride)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, weight, scale, shift)):
        return DWProj.apply(x, weight, scale, shift, stride)
    return _forward(x, weight, scale, shift, stride)


dwproj.launches = 0
