"""Peaks of one NVIDIA H100 and the work of the port's networks and
kernels, counted from their shapes.

Peaks: NVIDIA's data sheet for the SXM part, dense rates.  Every FLOP-based
share of the benchmark is priced at the TF32 tensor-core rate: the forward
GRU kernel runs its products on the tensor cores (3xTF32), and a share
priced at the 67 TFLOP/s fp32 rate could pass 100% for such a kernel.

FLOP are 2 per multiply-add of the work itself, whatever computes it: a
convolution counts every output element times its kernel's taps over the
input channels of its group, padding included, as
``torch.utils.flop_counter.FlopCounterMode`` counts it; gate arithmetic,
norms and softmax are not counted.  Bytes count each input read once and
each output written once.
"""

import math

PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES = 3.35e12
T = 33          # positions of a pileup window: the recurrence's steps
IN_CH = 34      # pileup channels


def _conv_out(w, k, stride, pad):
    return (w + 2 * pad - k) // stride + 1


def cvt_flops_per_row(cfg):
    """Forward FLOP of one row through the CvT (the AFF network).  ``cfg``:
    emb_dims, heads, depths, dim_head, mlp_mult, fc_dim, num_classes,
    alleles, and optionally emb_kernel / emb_stride / proj_kernel /
    kv_proj_stride (3, 2, 3, 2)."""
    k, s = cfg.get("emb_kernel", 3), cfg.get("emb_stride", 2)
    pk, kv_s = cfg.get("proj_kernel", 3), cfg.get("kv_proj_stride", 2)
    h, w, c_in = 1, T, IN_CH
    total = 0
    for dim, heads, depth in zip(cfg["emb_dims"], cfg["heads"], cfg["depths"]):
        h, w = _conv_out(h, k, s, k // 2), _conv_out(w, k, s, k // 2)
        n = h * w
        total += 2 * n * dim * c_in * k * k                     # embedding conv
        inner = heads * cfg["dim_head"]
        w_kv = _conv_out(w, pk, kv_s, pk // 2)
        m = h * w_kv
        per_block = (2 * n * dim * pk * pk + 2 * n * inner * dim          # to_q
                     + 2 * m * dim * pk * pk + 2 * m * 2 * inner * dim    # to_kv
                     + 2 * 2 * heads * n * m * cfg["dim_head"]            # q.k, attn.v
                     + 2 * n * dim * inner                                # out
                     + 2 * 2 * n * dim * cfg["mlp_mult"] * dim)           # feedforward
        total += depth * per_block
        c_in = dim
    flat = cfg["emb_dims"][-1] * h * w
    return total + _heads_flops(flat, cfg)


def _heads_flops(flat, cfg):
    fc = cfg["fc_dim"]
    return 2 * flat * fc + len(cfg["alleles"]) * (2 * fc * fc + 2 * fc * cfg["num_classes"])


def bigru_flops_per_row(cfg):
    """Forward FLOP of one row through the BiGRU (the NEG network): both
    layers' input and recurrent products in both directions, then the
    heads."""
    total, d_in = 0, IN_CH
    for hidden in (cfg["hidden1"], cfg["hidden2"]):
        total += 2 * (2 * T * d_in * 3 * hidden + 2 * T * hidden * 3 * hidden)
        d_in = 2 * hidden
    return total + _heads_flops(T * d_in, cfg)


def pair_flops_per_row(net_cfg):
    """Forward FLOP of one row through both networks of a variant type."""
    return cvt_flops_per_row(net_cfg["cvt"]) + bigru_flops_per_row(net_cfg["bigru"])


def gru_fwd_work(B, H):
    """(FLOP, bytes) of one forward GRU direction over T steps: the h.W_hh
    product; x_gates and the output once, W_hh^T and b_hh once."""
    return 2.0 * T * B * H * 3 * H, 4.0 * (T * B * 3 * H + T * B * H + H * 3 * H + 3 * H)


def gru_bwd_work(B, H):
    """(FLOP, bytes) of one backward GRU direction: its two products a step
    (dh.W_hh and the W_hh gradient's h^T.dg); x_gates, h and grad_out read
    once, grad_x_gates and grad_hg written once, W_hh and b_hh once."""
    return (2 * 2.0 * T * B * 3 * H * H,
            4.0 * (3 * T * B * 3 * H + 2 * T * B * H + 3 * H * H + 3 * H))


def bound_s(flops, nbytes):
    """Least seconds for the work on one H100: the larger of its FLOP at
    the TF32 peak and its bytes at the HBM peak."""
    return max(flops / PEAK_TF32_FLOPS, nbytes / PEAK_HBM_BYTES)


def share_pct(useful_s, spent_s):
    """A share of a peak in percent, or None where nothing was measured."""
    if not spent_s or spent_s <= 0 or useful_s is None or math.isnan(useful_s):
        return None
    return 100.0 * useful_s / spent_s
