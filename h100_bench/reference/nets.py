"""Plain PyTorch forward of ClairS-TO's two networks, read from the raw
checkpoint files.

Written from the published description (ClairS-TO v0.4.4,
``clairs/model.py``) and the checkpoints' own key names, with plain
operations and no kernel of the program: the CvT (AFF) with convolutional
token embeddings, depthwise-conv projections and a channelwise LayerNorm
whose epsilon is added to the standard deviation; the BiGRU (NEG), two
bidirectional layers written as a loop over the 33 positions (gates r, z,
n; the reset gate multiplies the biased recurrent branch).  Both end in
fc1, then per allele fc2 and fc3, SELU after each.  Dropout sites take a
mask drawn from a generator, site by site, as training draws them.

Imports nothing of the program: the checkpoints are ``.npz`` files whose
keys are paths such as ``['stages']/[0]/['emb_weight']``.
"""

import re

import numpy as np
import torch
import torch.nn.functional as F

_SEG = re.compile(r"\['([^']*)'\]|\[(\d+)\]")


def load_npz(path, device):
    """{dotted name: float32 tensor on ``device``} of one checkpoint."""
    out = {}
    with np.load(path) as data:
        for key in data.files:
            if key.startswith("__"):
                continue
            name = ".".join(a or b for a, b in _SEG.findall(key))
            out[name] = torch.from_numpy(np.asarray(data[key], np.float32)).to(device)
    return out


def rescale(x, cov, min_cov=50.0):
    """Each row times min_cov / cov where cov > min_cov (the division in
    float64, rounded once to float32)."""
    c = cov.double()
    scale = torch.where(c > min_cov, min_cov / c, torch.ones_like(c)).float()
    return x * scale[:, None, None]


class Dropout:
    """Keeps a value with probability 1 - rate and scales it by 1/keep; the
    mask of each site is the next draw of ``generator``."""

    def __init__(self, rate, generator):
        self.rate, self.gen = rate, generator

    def __call__(self, t):
        if self.gen is None or self.rate <= 0:
            return t
        keep = 1.0 - self.rate
        mask = torch.rand(t.shape, generator=self.gen, device=t.device) < keep
        return torch.where(mask, t / keep, torch.zeros_like(t))


def _ln(x, g, b, eps=1e-5):
    mu = x.mean(dim=1, keepdim=True)
    sd = ((x - mu) ** 2).mean(dim=1, keepdim=True).sqrt()
    return (x - mu) / (sd + eps) * g + b


def _proj(p, pre, x, stride):
    """Depthwise 3x3 conv, BatchNorm on its running statistics, 1x1 conv."""
    w = p[pre + ".dw_weight"]
    k = w.shape[-1]
    y = F.conv2d(x, w, stride=(1, stride), padding=k // 2, groups=x.shape[1])
    mean, var = p[pre + ".bn.running_mean"], p[pre + ".bn.running_var"]
    y = ((y - mean[:, None, None]) / torch.sqrt(var[:, None, None] + 1e-5)
         * p[pre + ".bn.weight"][:, None, None] + p[pre + ".bn.bias"][:, None, None])
    return F.conv2d(y, p[pre + ".pw_weight"])


def _heads(p, flat, alleles, drop):
    feat = F.selu(drop(flat @ p["fc1.weight"].t() + p["fc1.bias"]))
    outs = []
    for al in alleles:
        h = F.selu(drop(feat @ p[f"heads.{al}.fc2.weight"].t() + p[f"heads.{al}.fc2.bias"]))
        outs.append(F.selu(h @ p[f"heads.{al}.fc3.weight"].t() + p[f"heads.{al}.fc3.bias"]))
    return torch.stack(outs, dim=1)


def cvt_logits(p, cfg, x, drop=None):
    """(B, 33, 34) rescaled counts -> (B, alleles, 2) logits of the CvT."""
    drop = drop or Dropout(0.0, None)
    y = x.transpose(1, 2)[:, :, None, :]          # channels first, height 1
    dh = cfg["dim_head"]
    for s, (heads, depth) in enumerate(zip(cfg["heads"], cfg["depths"])):
        pre = f"stages.{s}"
        y = F.conv2d(y, p[pre + ".emb_weight"], p[pre + ".emb_bias"], stride=2, padding=1)
        y = _ln(y, p[pre + ".ln_g"], p[pre + ".ln_b"])
        for blk in range(depth):
            b = f"{pre}.blocks.{blk}"
            z = _ln(y, p[b + ".attn_ln_g"], p[b + ".attn_ln_b"])
            q = _proj(p, b + ".attn.to_q", z, 1)
            kv = _proj(p, b + ".attn.to_kv", z, 2)
            inner = heads * dh
            n_b, _, hh, ww = q.shape
            q = q.reshape(n_b, heads, dh, -1).transpose(2, 3)
            k = kv[:, :inner].reshape(n_b, heads, dh, -1).transpose(2, 3)
            v = kv[:, inner:].reshape(n_b, heads, dh, -1).transpose(2, 3)
            att = torch.softmax(q @ k.transpose(2, 3) / dh ** 0.5, dim=-1)
            o = (att @ v).transpose(2, 3).reshape(n_b, inner, hh, ww)
            y = y + F.conv2d(o, p[b + ".attn.out_weight"], p[b + ".attn.out_bias"])
            z = _ln(y, p[b + ".ff_ln_g"], p[b + ".ff_ln_b"])
            z = F.gelu(F.conv2d(z, p[b + ".ff.w1"], p[b + ".ff.b1"]))
            y = y + F.conv2d(z, p[b + ".ff.w2"], p[b + ".ff.b2"])
    flat = drop(y.reshape(y.shape[0], -1))
    return _heads(p, flat, cfg["alleles"], drop)


def _gru(x, w_ih, b_ih, w_hh, b_hh, reverse):
    """One direction over the positions of x (B, T, in) -> (B, T, H)."""
    hidden = w_hh.shape[1]
    gates_x = x @ w_ih.t() + b_ih
    h = x.new_zeros((x.shape[0], hidden))
    outs = [None] * x.shape[1]
    steps = range(x.shape[1] - 1, -1, -1) if reverse else range(x.shape[1])
    for t in steps:
        gx = gates_x[:, t]
        gh = h @ w_hh.t() + b_hh
        r = torch.sigmoid(gx[:, :hidden] + gh[:, :hidden])
        z = torch.sigmoid(gx[:, hidden:2 * hidden] + gh[:, hidden:2 * hidden])
        n = torch.tanh(gx[:, 2 * hidden:] + r * gh[:, 2 * hidden:])
        h = (1 - z) * n + z * h
        outs[t] = h
    return torch.stack(outs, dim=1)


def bigru_logits(p, cfg, x, drop=None):
    """(B, 33, 34) rescaled counts -> (B, alleles, 2) logits of the BiGRU."""
    drop = drop or Dropout(0.0, None)
    y = x
    for layer in ("gru1", "gru2"):
        fwd = _gru(y, p[f"{layer}.ih.weight"], p[f"{layer}.ih.bias"],
                   p[f"{layer}.hh.weight"], p[f"{layer}.hh.bias"], False)
        bwd = _gru(y, p[f"{layer}.ih_reverse.weight"], p[f"{layer}.ih_reverse.bias"],
                   p[f"{layer}.hh_reverse.weight"], p[f"{layer}.hh_reverse.bias"], True)
        y = torch.cat([fwd, bwd], dim=-1)
    flat = drop(y.reshape(y.shape[0], -1))
    return _heads(p, flat, cfg["alleles"], drop)


def class1_probs(aff, neg, net_cfg, x_aff, x_neg, cov_aff, cov_neg, block=4096):
    """Class-1 softmax of each allele of both networks, (N, 2, alleles)
    float32, in blocks of ``block`` rows."""
    out = []
    with torch.no_grad():
        for i in range(0, x_aff.shape[0], block):
            sl = slice(i, i + block)
            la = cvt_logits(aff, net_cfg["cvt"], rescale(x_aff[sl], cov_aff[sl]))
            ln = bigru_logits(neg, net_cfg["bigru"], rescale(x_neg[sl], cov_neg[sl]))
            out.append(torch.stack((torch.softmax(la, -1)[..., 1],
                                    torch.softmax(ln, -1)[..., 1]), dim=1))
    return torch.cat(out)


def set_tf32(enabled):
    """TF32 in matmuls and cuDNN convolutions on or off."""
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
