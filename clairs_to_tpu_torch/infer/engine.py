"""Dual-network inference engine.

PyTorch counterpart of clairs_to_tpu/infer/engine.py, with the same API:

    (B,33,34) AFF counts, (B,33,34) NEG counts, coverages
      -> depth rescale (scale by 50/cov when cov>50)
      -> CvT logits  +  BiGRU logits
      -> per-allele softmax (class-1 prob)
      -> host float64 posterior + QUAL (ops/posterior.py)

Batches are padded to a static ``device_batch``; padded rows are dropped on
the host.  The wire format is the JAX engine's: one packed int16 tensor
(AFF counts plus a coverage row) and an int16 NEG-minus-AFF delta, added
in float32 on the device before the rescale; a float32 path remains for
non-integral inputs.  On CUDA the host buffers are pinned, the copies are
``non_blocking`` and each part of a slice records one CUDA event that
``result()`` waits on; on the CPU everything runs synchronously.

Several devices (``devices=[...]``, the counterpart of the JAX engine's 1-D
mesh): one replica of the two networks per device.  Every padded slice is
split evenly along the batch axis, one part per replica; all parts are
dispatched before any is consumed, and the parts are concatenated in order.
"""

import contextlib
import copy
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn

from clairs_to_tpu_torch import config as cfg
from clairs_to_tpu_torch.models import bigru, cvt
from clairs_to_tpu_torch.models.checkpoint import params_from_jax
from clairs_to_tpu_torch.ops import posterior as post
from clairs_to_tpu_torch.utils import metrics as tracing


@dataclass
class BatchResult:
    """Host-side per-candidate results (valid rows only)."""

    p_aff: np.ndarray        # (N, n_alleles) float64 — class-1 softmax of AFF, %.8f-rounded
    p_neg: np.ndarray        # (N, n_alleles) float64 — class-1 softmax of NEG, %.8f-rounded
    posterior: np.ndarray    # (N, n_alleles) float64 — exact host posterior
    forward_acgt: np.ndarray   # (N, 4) int — FAU..FTU recovered strand counts
    reverse_acgt: np.ndarray   # (N, 4) int — RAU..RTU


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller asks for the CPU; raises without a GPU."""
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    return device


def local_devices(device="cuda", device_count=None):
    """The devices a run will use: ``device_count`` GPUs of those visible
    (default: all of them; never more than there are), or ``device_count``
    CPU replicas (default: one)."""
    first = resolve_device(device)
    if first.type != "cuda":
        return [first] * max(1, device_count or 1)
    visible = torch.cuda.device_count()
    n = max(1, min(device_count or visible, visible))
    return [torch.device("cuda", i) for i in range(n)]


def set_matmul_precision(precision):
    """"highest": TF32 off for matmuls and cuDNN convolutions; anything else
    allows it.  The two switches are process-wide, so every engine sets them
    from its own precision where it dispatches a forward."""
    tf32 = precision != "highest"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def _on_device(device):
    """Makes a CUDA device the current one (streams, events and the GRU
    kernel follow it); nothing to do for the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _rescale(x, coverage, min_rescale_cov):
    # predict.py:177-197: multiply all channels by min_rescale_cov/cov when
    # cov > min_rescale_cov (float32, matching the reference).  full_like
    # keeps it a true division: torch's ``scalar / tensor`` multiplies by a
    # reciprocal, which rounds differently
    scale = torch.where(coverage > min_rescale_cov,
                        torch.full_like(coverage, min_rescale_cov) / coverage,
                        torch.ones_like(coverage))
    return x * scale[:, None, None]


def recover_strand_counts(aff_raw_center):
    """Recover FAU..FTU / RAU..RTU from the raw AFF tensor's center row.

    The tensor encodes the reference base's count as the negated sum of its
    ACGT block; every negative entry in a row becomes -(row sum).

    Args:
      aff_raw_center: (B, 34) float/int — the unrescaled center position row.
    Returns:
      (forward (B,4) int64, reverse (B,4) int64)
    """
    out = []
    for sl in (slice(0, 4), slice(9, 13)):
        block = np.asarray(aff_raw_center[:, sl], dtype=np.float64)
        row_sums = block.sum(axis=1)
        fixed = np.where(block < 0, -row_sums[:, None], block)
        out.append(np.rint(fixed).astype(np.int64))
    return out[0], out[1]


def _as_model(params, kind, config):
    """An nn.Module as given, or one built from a JAX parameter pytree."""
    if isinstance(params, nn.Module):
        return params
    model = cvt.CvT(config) if kind == "cvt" else bigru.BiGRU(config)
    model.load_state_dict(params_from_jax(params, kind, config))
    return model


class InferenceEngine:
    """Dual-network engine for one variant type (snv|indel).

    ``aff_params``/``neg_params``: a ``CvT``/``BiGRU`` module, or the JAX
    package's parameter pytree with numpy leaves.  ``use_kernel``: None runs
    the GRU recurrence through the CUDA kernel on CUDA (the plain loop on
    the CPU); False forces the plain loop.  ``matmul_precision="highest"``
    turns TF32 off for matmuls and cuDNN convolutions (parity mode).
    ``devices``: one replica per entry (``device=`` is the short form for
    one); the same device may be named several times.  ``device_batch`` is
    rounded up to a multiple of the replica count.
    """

    def __init__(
        self,
        aff_params,
        neg_params,
        likelihood: post.LikelihoodData,
        mode: str = "snv",
        device_batch: int = cfg.DEVICE_BATCH,
        min_rescale_cov: float = float(cfg.MIN_RESCALE_COV),
        cvt_config=None,
        bigru_config=None,
        use_kernel: Optional[bool] = None,
        matmul_precision: str = "highest",
        device=None,
        devices=None,
    ):
        assert mode in ("snv", "indel")
        self.mode = mode
        self.devices = ([resolve_device(d) for d in devices] if devices
                        else [resolve_device(device)])
        self.device = self.devices[0]
        n_rep = len(self.devices)
        self.cvt_config = cvt_config or (
            cvt.SNV_CVT_CONFIG if mode == "snv" else cvt.INDEL_CVT_CONFIG)
        self.bigru_config = bigru_config or (
            bigru.SNV_BIGRU_CONFIG if mode == "snv" else bigru.INDEL_BIGRU_CONFIG)
        self.n_alleles = len(self.cvt_config.alleles)
        # the padded batch axis must split evenly across the replicas
        self.device_batch = -(-device_batch // n_rep) * n_rep
        self.min_rescale_cov = min_rescale_cov
        self.use_kernel = use_kernel
        self.matmul_precision = matmul_precision
        self.likelihood = likelihood
        self._on_cuda = any(d.type == "cuda" for d in self.devices)
        aff = _as_model(aff_params, "cvt", self.cvt_config).eval()
        neg = _as_model(neg_params, "bigru", self.bigru_config).eval()
        # the first replica is the model as given, moved; the others are copies
        self.aff_models = [aff.to(d) if i == 0 else copy.deepcopy(aff).to(d)
                           for i, d in enumerate(self.devices)]
        self.neg_models = [neg.to(d) if i == 0 else copy.deepcopy(neg).to(d)
                           for i, d in enumerate(self.devices)]
        self.aff_model, self.neg_model = self.aff_models[0], self.neg_models[0]
        self._lik_mat = torch.as_tensor(likelihood.matrices, dtype=torch.float32,
                                        device=self.device)
        self._aff_edges = torch.as_tensor(likelihood.aff_edges, dtype=torch.float32,
                                          device=self.device)
        self._neg_edges = torch.as_tensor(likelihood.neg_edges, dtype=torch.float32,
                                          device=self.device)
        self._zero_delta = [None] * n_rep   # device-resident int16 zeros, lazy

    # ---- device programs ------------------------------------------------
    def _net_probs(self, x_aff, x_neg, cov_aff, cov_neg, replica=0):
        x_aff = _rescale(x_aff.float(), cov_aff, self.min_rescale_cov)
        x_neg = _rescale(x_neg.float(), cov_neg, self.min_rescale_cov)
        probs_aff = torch.softmax(self.aff_models[replica](x_aff), dim=-1)
        probs_neg = torch.softmax(
            self.neg_models[replica](x_neg, use_kernel=self.use_kernel), dim=-1)
        return probs_aff, probs_neg

    @staticmethod
    def _stack_p1(probs_aff, probs_neg):
        # (B, 2, A) class-1 probabilities: all the host posterior consumes
        return torch.stack((probs_aff[..., 1], probs_neg[..., 1]), dim=1)

    @torch.inference_mode()
    def _forward_full(self, x_aff, x_neg, cov_aff, cov_neg, replica=0):
        return self._stack_p1(*self._net_probs(x_aff, x_neg, cov_aff, cov_neg, replica))

    @torch.inference_mode()
    def _forward_delta(self, packed, x_delta, replica=0):
        """``packed`` (B,34,34) int16: rows 0-32 the AFF counts, row 33
        columns 0/1 the AFF/NEG coverages; ``x_delta`` (B,33,34) int16 =
        NEG - AFF.  The float32 add happens before the rescale, so the
        result equals the full-view path for integral counts."""
        x_aff = packed[:, :33, :].float()
        cov_aff = packed[:, 33, 0].float()
        cov_neg = packed[:, 33, 1].float()
        x_neg = x_aff + x_delta.float()
        return self._stack_p1(*self._net_probs(x_aff, x_neg, cov_aff, cov_neg, replica))

    @torch.inference_mode()
    def _forward_fused(self, x_aff, x_neg, cov_aff, cov_neg):
        probs_aff, probs_neg = self._net_probs(x_aff, x_neg, cov_aff, cov_neg)
        posterior = post.posterior_probs_torch(
            probs_aff[..., 1], probs_neg[..., 1], self._lik_mat, self._aff_edges,
            self._neg_edges)
        best_p, best = torch.max(posterior, dim=1)
        return posterior, best, post.quality_score_torch(best_p)

    # ---- host API -------------------------------------------------------
    def _pad(self, arr, value=0):
        n = arr.shape[0]
        if n == self.device_batch:
            return arr
        pad_width = [(0, self.device_batch - n)] + [(0, 0)] * (arr.ndim - 1)
        return np.pad(arr, pad_width, constant_values=value)

    def _put(self, arr, replica=0):
        """Host numpy -> device tensor (pinned, non-blocking on CUDA)."""
        device = self.devices[replica]
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if device.type != "cuda":
            return t
        return t.pin_memory().to(device, non_blocking=True)

    def _part(self, arr, replica):
        """Replica ``replica``'s rows of a padded slice."""
        rows = self.device_batch // len(self.devices)
        return arr[replica * rows:(replica + 1) * rows]

    def _intify(self, arr):
        """int16 wire encoding of a count tensor, or None when unsafe."""
        if arr.dtype == np.int16:
            return arr
        if arr.dtype.kind in "iu":
            if arr.size and (int(arr.max()) >= 32768 or int(arr.min()) < -32768):
                return None
            return arr.astype(np.int16)
        if arr.dtype.kind == "f":
            xi = arr.astype(np.int16)
            if bool((xi == arr).all()):
                return xi
            return None
        return None

    def _zero_delta_dev(self, replica=0):
        """Device-resident int16 zero delta for identical AFF/NEG views."""
        if self._zero_delta[replica] is None:
            self._zero_delta[replica] = torch.zeros(
                (self.device_batch // len(self.devices), 33, 34), dtype=torch.int16,
                device=self.devices[replica])
        return self._zero_delta[replica]

    def run_batch(self, x_aff, x_neg, cov_aff, cov_neg) -> BatchResult:
        """Synchronous convenience wrapper over ``run_batch_async``."""
        return self.run_batch_async(x_aff, x_neg, cov_aff, cov_neg).result()

    def run_batch_async(self, x_aff, x_neg, cov_aff, cov_neg) -> "PendingBatch":
        """Dispatch a batch; the returned PendingBatch's .result() waits.

        Args: raw (unrescaled) count tensors (N,33,34) and coverages (N,).
        Inputs larger than ``device_batch`` run in fixed-shape slices.
        The batch's spans (``utils/metrics.py``) share one id, through
        ``result()``.
        """
        bid = tracing.new_id()
        with tracing.span("engine.dispatch", bid):
            return self._dispatch(bid, x_aff, x_neg, cov_aff, cov_neg)

    def _dispatch(self, bid, x_aff, x_neg, cov_aff, cov_neg) -> "PendingBatch":
        n = x_aff.shape[0]
        identity = x_neg is x_aff
        x_aff = np.asarray(x_aff)
        cov_aff = np.asarray(cov_aff)
        cov_neg = cov_aff if cov_neg is cov_aff else np.asarray(cov_neg)
        with tracing.span("engine.pack"):
            xa16 = self._intify(x_aff)
            ca16 = self._intify(cov_aff) if xa16 is not None else None
            cn16 = (ca16 if cov_neg is cov_aff else
                    (self._intify(cov_neg) if ca16 is not None else None))
            use_int = xa16 is not None and ca16 is not None and cn16 is not None
            d16 = None
            if use_int and not identity:
                xn16 = self._intify(np.asarray(x_neg))
                if xn16 is None:
                    use_int = False
                else:
                    delta = xn16.astype(np.int32) - xa16
                    if delta.size and (int(delta.max()) >= 32768
                                       or int(delta.min()) < -32768):
                        use_int = False
                    else:
                        d16 = delta.astype(np.int16)
            if use_int:
                # row 33 columns 2.. are never read: np.empty leaves them unset
                packed = np.empty((n, 34, 34), np.int16)
                packed[:, :33, :] = xa16
                packed[:, 33, 0] = ca16
                packed[:, 33, 1] = cn16
        if self._on_cuda:
            set_matmul_precision(self.matmul_precision)
        handles, h2d_bytes = [], 0
        for i in range(0, n, self.device_batch):
            sl = slice(i, i + self.device_batch)
            ni = min(self.device_batch, n - i)
            with tracing.span("engine.upload"):
                if use_int:
                    padded = (self._pad(packed[sl]),
                              None if d16 is None else self._pad(d16[sl]))
                else:
                    padded = (self._pad(np.asarray(x_aff[sl], np.float32)),
                              None if identity else self._pad(np.asarray(x_neg[sl], np.float32)),
                              self._pad(np.asarray(cov_aff[sl], np.float32), value=1),
                              None if cov_neg is cov_aff
                              else self._pad(np.asarray(cov_neg[sl], np.float32), value=1))
            # every replica's part is dispatched before any is consumed; each
            # has its own pinned buffer and its own event on its own device
            parts = []
            for k, device in enumerate(self.devices):
                with _on_device(device):
                    with tracing.span("engine.upload"):
                        part = [None if a is None else self._put(self._part(a, k), k)
                                for a in padded]
                    if device.type == "cuda":
                        h2d_bytes += sum(a.nbytes for a in part if a is not None)
                    with tracing.span("engine.launch"):
                        if use_int:
                            pk, xd = part
                            p1 = self._forward_delta(
                                pk, self._zero_delta_dev(k) if xd is None else xd, k)
                        else:
                            xa, xn, ca, cn = part
                            p1 = self._forward_full(xa, xa if xn is None else xn,
                                                    ca, ca if cn is None else cn, k)
                        event = None
                        if device.type == "cuda":
                            host = torch.empty(p1.shape, dtype=p1.dtype, pin_memory=True)
                            host.copy_(p1, non_blocking=True)
                            event = torch.cuda.Event()
                            event.record()
                            p1 = host
                parts.append((p1, event))
            handles.append((ni, sl, parts))
        tracing.count("engine.batches")
        tracing.count("engine.rows", n)
        tracing.count("engine.rows_padded", len(handles) * self.device_batch)
        tracing.count("engine.float_path_batches", int(not use_int))
        tracing.count("engine.h2d_bytes", h2d_bytes)
        return PendingBatch(self, handles, x_aff, bid)

    def _consume(self, n, x_aff_slice, parts) -> BatchResult:
        """``parts``: the replicas' (B/n, 2, A) class-1 probabilities on the
        host, in order."""
        p1 = parts[0] if len(parts) == 1 else torch.cat(parts)
        # the reference round-trips probabilities through '%.8f' text between
        # predict and call_variants; match that rounding so the float64
        # posterior sees identical inputs
        p1h = p1.numpy().astype(np.float64)
        p_aff = np.round(p1h[:n, 0], 8)
        p_neg = np.round(p1h[:n, 1], 8)
        with tracing.span("engine.posterior"):
            posterior = post.posterior_probs_np(p_aff, p_neg, self.likelihood)
        with tracing.span("engine.strands"):
            fwd, rev = recover_strand_counts(
                np.asarray(x_aff_slice)[:, cfg.FLANKING_BASE_NUM, :])
        return BatchResult(p_aff=p_aff, p_neg=p_neg, posterior=posterior,
                           forward_acgt=fwd, reverse_acgt=rev)

    def run_batch_fused(self, x_aff, x_neg, cov_aff, cov_neg):
        """Posterior, argmax and QUAL on the device; returns device tensors
        for the padded batch.  Runs on the first replica."""
        if self._on_cuda:
            set_matmul_precision(self.matmul_precision)
        xa = self._put(self._pad(np.asarray(x_aff, np.float32)))
        xn = self._put(self._pad(np.asarray(x_neg, np.float32)))
        ca = self._put(self._pad(np.asarray(cov_aff, np.float32), value=1))
        cn = self._put(self._pad(np.asarray(cov_neg, np.float32), value=1))
        return self._forward_fused(xa, xn, ca, cn)


class PendingBatch:
    """A dispatched run_batch: device slices in flight, host copies queued."""

    def __init__(self, engine, handles, x_aff, bid):
        self._engine = engine
        self._handles = handles
        self._x_aff = x_aff
        self._id = bid
        self._result = None

    def result(self) -> BatchResult:
        if self._result is not None:
            return self._result
        with tracing.span("engine.result", self._id):
            self._result = self._collect()
        self._handles = None
        self._x_aff = None
        return self._result

    def _collect(self) -> BatchResult:
        parts = []
        for (ni, sl, slice_parts) in self._handles:
            with tracing.span("engine.wait"):
                for _p1, event in slice_parts:
                    if event is not None:
                        event.synchronize()
            with tracing.span("engine.consume"):
                parts.append(self._engine._consume(ni, self._x_aff[sl],
                                                   [p1 for p1, _event in slice_parts]))
        if len(parts) == 1:
            res = parts[0]
        else:
            res = BatchResult(
                p_aff=np.concatenate([p.p_aff for p in parts]),
                p_neg=np.concatenate([p.p_neg for p in parts]),
                posterior=np.concatenate([p.posterior for p in parts]),
                forward_acgt=np.concatenate([p.forward_acgt for p in parts]),
                reverse_acgt=np.concatenate([p.reverse_acgt for p in parts]),
            )
        return res
