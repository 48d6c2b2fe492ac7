"""CvT (Convolutional vision Transformer) — the Affirmative network.

PyTorch counterpart of clairs_to_tpu/models/cvt.py, with the same
parameter layout (OIHW conv weights, (out, in) linear weights), so a JAX
parameter pytree maps onto this module's ``state_dict`` key for key
(models/checkpoint.py).  Semantics that must match exactly:

* input (B, 33, 34) is viewed as an NCHW image (B, C=34, H=1, W=33);
* each stage: Conv2d(k=3, pad=1, stride=2) embed -> channelwise LayerNorm
  (eps added to the *std*, biased variance — not ``nn.LayerNorm``) ->
  transformer blocks with depthwise-conv QKV projections (q stride 1, kv
  stride (1, 2), BatchNorm on its running statistics) and 1x1-conv
  feedforward (mult 4, exact GELU);
* trunk flatten (NCHW row-major) -> fc1(128) -> per-allele fc2(128)+fc3(2),
  SELU after every fc including fc3;
* training-time dropout at the JAX forward's three fc sites only: the
  flattened trunk, the fc1 output and each head's fc2 output.

The BatchNorm reads its running statistics in training too: the JAX
package trains them as parameters (train.py optimizes the whole tree), so
they are never batch statistics.

Attention is plain torch (matmul + softmax): the JAX package computes it
outside any Pallas kernel too.
"""

import math
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

SNV_ALLELES = ("a", "c", "g", "t")
INDEL_ALLELES = ("a", "c", "g", "t", "i", "d")


@dataclass(frozen=True)
class CvTConfig:
    in_channels: int = 34
    width: int = 33
    emb_dims: Tuple[int, ...] = (32, 64, 128)
    emb_kernel: int = 3
    emb_stride: int = 2
    proj_kernel: int = 3
    kv_proj_stride: int = 2
    heads: Tuple[int, ...] = (1, 3, 6)
    depths: Tuple[int, ...] = (1, 2, 10)
    mlp_mult: int = 4
    dim_head: int = 64
    fc_dim: int = 128
    num_classes: int = 2
    alleles: Tuple[str, ...] = SNV_ALLELES

    @property
    def num_stages(self):
        return len(self.emb_dims)


SNV_CVT_CONFIG = CvTConfig()
INDEL_CVT_CONFIG = CvTConfig(
    emb_dims=(16, 64, 128), heads=(1, 3, 4), depths=(1, 2, 3), alleles=INDEL_ALLELES
)


def _param(*shape):
    return nn.Parameter(torch.empty(*shape))


def fc_dropout(t, rate, generator):
    """Keeps each value with probability ``1 - rate`` and scales a kept one
    by ``1/keep``; the identity at rate 0 or without a generator.  The mask
    is drawn from ``generator`` (on ``t``'s device), site after site."""
    if rate <= 0.0 or generator is None:
        return t
    keep = 1.0 - rate
    mask = torch.rand(t.shape, generator=generator, device=t.device) < keep
    return torch.where(mask, t / keep, torch.zeros_like(t))


def channel_layernorm(x, g, b, eps=1e-5):
    """Normalise over the channel dim; eps is added to the std."""
    mean = x.mean(dim=1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=1, keepdim=True)
    return (x - mean) / (torch.sqrt(var) + eps) * g + b


class Linear(nn.Module):
    """``x @ weight.T + bias`` with torch's (out, in) weight layout."""

    def __init__(self, in_f, out_f):
        super().__init__()
        self.weight = _param(out_f, in_f)
        self.bias = _param(out_f)

    def forward(self, x):
        return torch.matmul(x, self.weight.t()) + self.bias


class BatchNorm(nn.Module):
    """BatchNorm on its running statistics, in the JAX package's scale/shift
    form, in eval and train mode alike.  The statistics are buffers, so an
    optimizer sees them only when given them (train.py does)."""

    def __init__(self, dim, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = _param(dim)
        self.bias = _param(dim)
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))

    def forward(self, x):
        inv = torch.rsqrt(self.running_var + self.eps)
        scale = (self.weight * inv).reshape(1, -1, 1, 1)
        shift = (self.bias - self.running_mean * self.weight * inv).reshape(1, -1, 1, 1)
        return x * scale + shift


class DepthwiseProj(nn.Module):
    """Depthwise conv (stride (1, s), padding k//2) -> BN -> 1x1 conv."""

    def __init__(self, dim_in, dim_out, k, stride):
        super().__init__()
        self.stride = stride
        self.dw_weight = _param(dim_in, 1, k, k)
        self.bn = BatchNorm(dim_in)
        self.pw_weight = _param(dim_out, dim_in, 1, 1)

    def forward(self, x):
        k = self.dw_weight.shape[-1]
        out = F.conv2d(x, self.dw_weight, stride=(1, self.stride),
                       padding=(k // 2, k // 2), groups=x.shape[1])
        return F.conv2d(self.bn(out), self.pw_weight)


class Attention(nn.Module):
    def __init__(self, dim, heads, dim_head, k, kv_stride):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.to_q = DepthwiseProj(dim, inner, k, 1)
        self.to_kv = DepthwiseProj(dim, inner * 2, k, kv_stride)
        self.out_weight = _param(dim, inner, 1, 1)
        self.out_bias = _param(dim)

    def forward(self, x):
        b, _, h, w = x.shape
        heads, dh = self.heads, self.dim_head
        inner = heads * dh
        q = self.to_q(x)
        kv = self.to_kv(x)
        k, v = kv[:, :inner], kv[:, inner:]

        def tokens(t):
            # (b, heads*dh, H, W) -> (b, heads, H*W, dh)
            bb, _, hh, ww = t.shape
            return t.reshape(bb, heads, dh, hh * ww).transpose(2, 3)

        q, k, v = tokens(q), tokens(k), tokens(v)
        dots = torch.matmul(q, k.transpose(2, 3)) * (dh ** -0.5)
        attn = torch.softmax(dots, dim=-1)
        out = torch.matmul(attn, v)
        # (b, heads, n, dh) -> (b, heads*dh, H, W)
        out = out.transpose(2, 3).reshape(b, inner, h, w)
        return F.conv2d(out, self.out_weight, self.out_bias)


class FeedForward(nn.Module):
    def __init__(self, dim, mult):
        super().__init__()
        self.w1 = _param(dim * mult, dim, 1, 1)
        self.b1 = _param(dim * mult)
        self.w2 = _param(dim, dim * mult, 1, 1)
        self.b2 = _param(dim)

    def forward(self, x):
        out = F.gelu(F.conv2d(x, self.w1, self.b1), approximate="none")
        return F.conv2d(out, self.w2, self.b2)


class Block(nn.Module):
    def __init__(self, dim, config: CvTConfig, heads):
        super().__init__()
        self.attn_ln_g = _param(1, dim, 1, 1)
        self.attn_ln_b = _param(1, dim, 1, 1)
        self.attn = Attention(dim, heads, config.dim_head, config.proj_kernel,
                              config.kv_proj_stride)
        self.ff_ln_g = _param(1, dim, 1, 1)
        self.ff_ln_b = _param(1, dim, 1, 1)
        self.ff = FeedForward(dim, config.mlp_mult)

    def forward(self, x):
        x = self.attn(channel_layernorm(x, self.attn_ln_g, self.attn_ln_b)) + x
        return self.ff(channel_layernorm(x, self.ff_ln_g, self.ff_ln_b)) + x


class Stage(nn.Module):
    def __init__(self, dim_in, dim, config: CvTConfig, heads, depth):
        super().__init__()
        k = config.emb_kernel
        self.stride, self.pad = config.emb_stride, k // 2
        self.emb_weight = _param(dim, dim_in, k, k)
        self.emb_bias = _param(dim)
        self.ln_g = _param(1, dim, 1, 1)
        self.ln_b = _param(1, dim, 1, 1)
        self.blocks = nn.ModuleList(Block(dim, config, heads) for _ in range(depth))

    def forward(self, x):
        x = F.conv2d(x, self.emb_weight, self.emb_bias,
                     stride=(self.stride, self.stride), padding=(self.pad, self.pad))
        x = channel_layernorm(x, self.ln_g, self.ln_b)
        for blk in self.blocks:
            x = blk(x)
        return x


class Head(nn.Module):
    def __init__(self, fc_dim, num_classes):
        super().__init__()
        self.fc2 = Linear(fc_dim, fc_dim)
        self.fc3 = Linear(fc_dim, num_classes)

    def forward(self, feat, dropout_rate=0.0, generator=None):
        h = F.selu(fc_dropout(self.fc2(feat), dropout_rate, generator))
        return F.selu(self.fc3(h))


def trunk_flat_dim(config: CvTConfig) -> int:
    w = config.width
    for _ in range(config.num_stages):
        w = math.ceil(w / 2)
    return config.emb_dims[-1] * w


def heads_forward(model, flat, dropout_rate, generator):
    """fc1 and the per-allele heads of either network, with dropout on the
    flat trunk, the fc1 output and each fc2 output, in that order."""
    flat = fc_dropout(flat, dropout_rate, generator)
    feat = F.selu(fc_dropout(model.fc1(flat), dropout_rate, generator))
    return torch.stack([model.heads[al](feat, dropout_rate, generator)
                        for al in model.config.alleles], dim=1)


class CvT(nn.Module):
    """(B, 33, 34) pileup tensors -> (B, n_alleles, num_classes) logits."""

    def __init__(self, config: CvTConfig = SNV_CVT_CONFIG):
        super().__init__()
        self.config = config
        stages, dim_in = [], config.in_channels
        for s, dim in enumerate(config.emb_dims):
            stages.append(Stage(dim_in, dim, config, config.heads[s], config.depths[s]))
            dim_in = dim
        self.stages = nn.ModuleList(stages)
        self.fc1 = Linear(trunk_flat_dim(config), config.fc_dim)
        self.heads = nn.ModuleDict(
            {al: Head(config.fc_dim, config.num_classes) for al in config.alleles})

    def forward(self, x, dropout_rate=0.0, generator=None):
        """``dropout_rate``/``generator``: training-time fc dropout; the
        inference forward leaves them at 0/None."""
        x = x.transpose(1, 2).unsqueeze(2)   # (B, W, C) -> NCHW with H=1
        for stage in self.stages:
            x = stage(x)
        return heads_forward(self, x.reshape(x.shape[0], -1), dropout_rate, generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        """Random weights with the JAX ``init``'s distributions (not its
        numbers: the generators differ)."""
        for name, t in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("ln_g", "attn_ln_g", "ff_ln_g") or name.endswith("bn.weight"):
                t.fill_(1.0)
            elif name.endswith("bn.bias"):
                t.zero_()
            elif leaf in ("weight", "bias"):       # Linear: bound 1/sqrt(in)
                fan_in = self.get_parameter(name[: -len(leaf)] + "weight").shape[1]
                t.uniform_(-fan_in ** -0.5, fan_in ** -0.5, generator=generator)
            elif t.dim() == 4 and leaf not in ("ln_b", "attn_ln_b", "ff_ln_b"):
                fan_in = t[0].numel()                # conv weight
                t.uniform_(-fan_in ** -0.5, fan_in ** -0.5, generator=generator)
            else:                                    # LN shifts, conv biases
                t.zero_()
        return self
