# Port of clairs_to_tpu/train.py.
"""Training + calibration for the dual-network ensemble.

PyTorch counterpart of clairs_to_tpu/train.py: the same losses, optimizer,
batches and calibration, so that from the same weights and data both
packages take the same steps (tests/test_torch_train.py).

Label semantics (derived from the posterior formula, call_variants.py:193-213):
  AFF class-1 of allele k = P(the somatic variant is allele k)
  NEG class-1 of allele k = P(the somatic variant is NOT allele k)
so a somatic site with alt C has AFF labels (0,1,0,0) and NEG labels
(1,0,1,1); a non-somatic site is all-zero / all-one.

What the JAX step does, and how it is matched here:
* the optimizer is ``optax.chain(clip_by_global_norm, adamw)`` over the
  whole parameter tree, the CvT's BatchNorm running statistics included;
  here those are module buffers, so the trainer hands the optimizer every
  tensor of ``state_dict`` (parameters and buffers) and nothing else;
* optax clips by ``max/‖g‖`` only when ``‖g‖ >= max``, with no epsilon
  (``clip_by_global_norm`` below; torch's ``clip_grad_norm_`` differs);
* ``optax.adamw(lr, weight_decay=wd)`` is b1 0.9, b2 0.999, eps 1e-8 and
  decays every leaf: ``torch.optim.AdamW`` with one group and ``wd`` given;
* the NEG network's recurrence trains through ops/gru.py::GRUDirection:
  on CUDA the forward kernel and a hand-written backward kernel, on the CPU
  the plain loop and an explicit backward loop; the JAX step trains
  through XLA's gradient of ``lax.scan``, the same function;
* batches come from ``np.random.default_rng(seed)`` in the JAX order; the
  dropout masks come from a ``torch.Generator``, which cannot reproduce
  ``jax.random``, so the two agree step for step only at dropout 0.

Calibration builds the per-platform likelihood matrix the reference loads
from likelihood_matrix.txt (call_variants.py:655-796); numpy, copied.
"""

from dataclasses import dataclass

import numpy as np
import torch

from clairs_to_tpu_torch import config as cfg
from clairs_to_tpu_torch.infer.engine import resolve_device, set_matmul_precision
from clairs_to_tpu_torch.models import bigru, cvt
from clairs_to_tpu_torch.models.checkpoint import (  # noqa: F401  (the JAX module's API)
    checkpoint_arch,
    load_checkpoint,
    load_checkpoint_auto,
    save_checkpoint,
)
from clairs_to_tpu_torch.ops.posterior import LikelihoodData
from clairs_to_tpu_torch.utils import metrics as tracing


@dataclass
class TrainConfig:
    learning_rate: float = cfg.INITIAL_LEARNING_RATE
    weight_decay: float = cfg.WEIGHT_DECAY
    grad_clip: float = cfg.GRAD_NORM_CLIP
    batch_size: int = cfg.TRAIN_BATCH_SIZE
    epochs: int = cfg.MAX_EPOCH
    focal_gamma: float = 2.0       # param.py:73 apply_focal_loss
    dropout_rate: float = 0.3      # model.py:179,407 dropout_fc
    seed: int = 0


def focal_ce(logits, labels, gamma):
    """Per-allele focal cross-entropy; labels (B, A) in {0,1}."""
    logp = torch.log_softmax(logits, dim=-1)                       # (B, A, 2)
    onehot = torch.nn.functional.one_hot(labels.long(), 2).to(logp.dtype)
    pt = torch.sum(onehot * torch.exp(logp), dim=-1)
    ce = -torch.sum(onehot * logp, dim=-1)
    return torch.mean(((1.0 - pt) ** gamma) * ce)


def clip_by_global_norm(grads, max_norm):
    """optax.clip_by_global_norm in place: every gradient becomes
    ``g / ‖g‖ * max_norm`` when the global norm ‖g‖ is at least
    ``max_norm``, and stays as it is below.  Returns ‖g‖ (a tensor: no
    host synchronisation).  The squares are summed in float64: the CPU's
    fp32 norm of a leaf of a million elements strays by 1e-5 relative,
    where optax's (XLA's tree sum) and CUDA's stay near 1e-7."""
    norms = torch._foreach_norm(grads, 2, dtype=torch.float64)
    norm = torch.linalg.vector_norm(torch.stack(norms)).to(grads[0].dtype)
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


def _rescale(x, cov):
    # train.py:124-130: scale by 50/cov where cov > 50, in float32
    scale = np.where(cov > 50, 50.0 / cov, 1.0).astype(np.float32)
    return x * scale[:, None, None]


class DualTrainer:
    """Trains AFF (CvT) and NEG (BiGRU) on the same tensors.

    ``device``: ``cuda`` unless the caller asks for the CPU; there is no
    fallback.  On CUDA every step and every ``predict_probs`` turns TF32 off
    for matmuls and cuDNN convolutions ("highest"), as the engine does at
    dispatch.
    Weights start from the JAX ``init``'s distributions (not its numbers);
    load others into ``models[...]`` with ``load_state_dict``.
    """

    def __init__(self, mode="snv", tc: TrainConfig = None, cvt_config=None,
                 bigru_config=None, device="cuda"):
        self.tc = tc or TrainConfig()
        self.device = resolve_device(device)
        self.cvt_config = cvt_config or (
            cvt.SNV_CVT_CONFIG if mode == "snv" else cvt.INDEL_CVT_CONFIG)
        self.bigru_config = bigru_config or (
            bigru.SNV_BIGRU_CONFIG if mode == "snv" else bigru.INDEL_BIGRU_CONFIG)
        gen = torch.Generator().manual_seed(self.tc.seed)
        self.models = {
            "aff": cvt.CvT(self.cvt_config).reset_parameters(gen).to(self.device),
            "neg": bigru.BiGRU(self.bigru_config).reset_parameters(gen).to(self.device),
        }
        # the JAX leaves: every parameter and buffer (the BatchNorm running
        # statistics), keyed "aff.<state_dict name>" / "neg.<...>"
        self.tensors = {f"{net}.{name}": t for net, m in self.models.items()
                        for name, t in m.state_dict(keep_vars=True).items()}
        for t in self.tensors.values():
            t.requires_grad_(True)
        self.opt = torch.optim.AdamW(
            list(self.tensors.values()), lr=self.tc.learning_rate, betas=(0.9, 0.999),
            eps=1e-8, weight_decay=self.tc.weight_decay)

    def _set_precision(self):
        if self.device.type == "cuda":
            set_matmul_precision("highest")

    def loss(self, x, x_neg, aff_labels, neg_labels, generator=None, use_kernel=True):
        """The summed focal loss of both networks on one batch (device
        tensors), with the trainer's dropout drawn from ``generator``.
        ``use_kernel=False`` runs the BiGRU's plain loop under autograd
        instead of the kernels: the yardstick the kernel step is held to."""
        self._set_precision()
        dr = self.tc.dropout_rate
        la = self.models["aff"](x, dropout_rate=dr, generator=generator)
        ln = self.models["neg"](x_neg, use_kernel=use_kernel, dropout_rate=dr,
                                generator=generator)
        g = self.tc.focal_gamma
        return focal_ce(la, aff_labels, g) + focal_ce(ln, neg_labels, g)

    def apply_gradients(self):
        """Clip by the global norm, one AdamW step, clear the gradients.
        Returns the global norm before clipping (a device tensor)."""
        grads = [t.grad for t in self.tensors.values()]
        norm = clip_by_global_norm(grads, self.tc.grad_clip)
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        return norm

    def step(self, x, x_neg, aff_labels, neg_labels, generator=None):
        """One training step; returns the loss (a device tensor).  Its spans
        (``utils/metrics.py``): ``train.step`` around ``train.forward``,
        ``train.backward`` and ``train.optim``."""
        with tracing.span("train.step"):
            with tracing.span("train.forward"):
                loss = self.loss(x, x_neg, aff_labels, neg_labels, generator)
            with tracing.span("train.backward"):
                loss.backward()
            with tracing.span("train.optim"):
                self.apply_gradients()
        return loss.detach()

    def fit(self, x, somatic_allele, epochs=None, batch_size=None, log_every=0,
            rescale_cov=None, positive_fraction=0.3, x_neg=None):
        """Train on tensors x (N,33,34) with per-site somatic allele index
        (-1 = not somatic).  Returns the loss history: the last step's loss
        of each epoch, read from the device once per epoch.

        ``x_neg`` supplies the negational network's view when it differs
        from x (the reference's dual-BQ asymmetry: AFF tensors use platform
        min_bq, NEG tensors min_bq=0 — run_clairs_to:1237 vs :1264).

        Candidate sets are extremely imbalanced (somatic sites are rare), so
        batches are class-balanced: ~``positive_fraction`` of each batch is
        drawn from somatic sites with replacement.
        """
        tc = self.tc
        epochs = epochs or tc.epochs
        batch_size = batch_size or tc.batch_size
        n = x.shape[0]
        n_all = len(self.cvt_config.alleles)
        som = np.asarray(somatic_allele)
        aff_labels = np.stack([(som == k) for k in range(n_all)], axis=1).astype(np.int64)
        neg_labels = 1 - aff_labels
        x = np.asarray(x, np.float32)
        x_neg = x if x_neg is None else np.asarray(x_neg, np.float32)
        if rescale_cov is not None:
            same = x_neg is x
            x = _rescale(x, rescale_cov)
            x_neg = x if same else _rescale(x_neg, rescale_cov)
        rng = np.random.default_rng(tc.seed)
        pos_idx = np.where(som >= 0)[0]
        neg_idx = np.where(som < 0)[0]
        balanced = positive_fraction and len(pos_idx) and len(neg_idx)
        n_pos = int(batch_size * positive_fraction) if balanced else 0
        history = []
        steps = max(n // batch_size, 1)
        gen = torch.Generator(device=self.device).manual_seed(tc.seed + 1)
        for m in self.models.values():
            m.train()

        def dev(a):
            return torch.from_numpy(a).to(self.device)

        for ep in range(epochs):
            perm = rng.permutation(n)
            for s in range(steps):
                if balanced:
                    idx = np.concatenate([
                        rng.choice(pos_idx, size=n_pos, replace=True),
                        rng.choice(neg_idx, size=batch_size - n_pos, replace=True),
                    ])
                else:
                    idx = perm[s * batch_size : (s + 1) * batch_size]
                    if len(idx) < batch_size:  # keep shapes static: wrap
                        idx = np.concatenate([idx, perm[: batch_size - len(idx)]])
                xb = dev(x[idx])
                loss = self.step(xb, xb if x_neg is x else dev(x_neg[idx]),
                                 dev(aff_labels[idx]), dev(neg_labels[idx]), gen)
            history.append(float(loss))
            if log_every and (ep + 1) % log_every == 0:
                print(f"[train] epoch {ep + 1}/{epochs} loss={history[-1]:.4f}")
        return history

    @torch.no_grad()
    def predict_probs(self, x, rescale_cov=None, batch_size=512, x_neg=None, use_kernel=None):
        """Class-1 softmax probs from both nets: (p_aff, p_neg), each (N, A).
        Eval mode, batches padded to ``batch_size``; the NEG network runs as
        the engine runs it (``use_kernel`` None: the CUDA kernel on CUDA)."""
        x = np.asarray(x, np.float32)
        x_neg = x if x_neg is None else np.asarray(x_neg, np.float32)
        if rescale_cov is not None:
            x2 = _rescale(x, rescale_cov)
            x_neg = x2 if x_neg is x else _rescale(x_neg, rescale_cov)
            x = x2
        for m in self.models.values():
            m.eval()
        self._set_precision()
        outs_a, outs_n = [], []
        n = x.shape[0]
        for i in range(0, n, batch_size):
            xb = x[i : i + batch_size]
            xnb = x_neg[i : i + batch_size]
            if xb.shape[0] < batch_size:
                pad = batch_size - xb.shape[0]
                xb = np.pad(xb, [(0, pad), (0, 0), (0, 0)])
                xnb = np.pad(xnb, [(0, pad), (0, 0), (0, 0)])
            xa = torch.from_numpy(xb).to(self.device)
            xn = xa if xnb is xb else torch.from_numpy(xnb).to(self.device)
            outs_a.append(torch.softmax(self.models["aff"](xa), dim=-1)[..., 1])
            outs_n.append(torch.softmax(self.models["neg"](xn, use_kernel=use_kernel),
                                        dim=-1)[..., 1])
        p_aff = torch.cat(outs_a).cpu().numpy()[:n]
        p_neg = torch.cat(outs_n).cpu().numpy()[:n]
        return p_aff, p_neg


def calibrate_likelihood(p_aff, p_neg, somatic_allele, n_alleles=4,
                         n_bins=10, smooth=1.0) -> LikelihoodData:
    """Build LikelihoodData from calibration predictions.

    W[k][i][j] = smoothed P(somatic-k | p_aff-bin i, (1-p_neg)-bin j); bin
    edges are per-allele deciles of the observed values (interior points,
    with exact 0/1 endpoints like the reference loader).
    """
    som = np.asarray(somatic_allele)
    matrices = np.zeros((n_alleles, n_bins, n_bins))
    aff_edges = np.zeros((n_alleles, n_bins + 1))
    neg_edges = np.zeros((n_alleles, n_bins + 1))
    for k in range(n_alleles):
        a = np.asarray(p_aff[:, k], np.float64)
        q = 1.0 - np.asarray(p_neg[:, k], np.float64)
        pts_a = np.quantile(a, np.linspace(0, 1, n_bins + 1)[1:-1])
        pts_q = np.quantile(q, np.linspace(0, 1, n_bins + 1)[1:-1])
        pts_a = np.clip(np.sort(pts_a), 1e-6, 1 - 1e-6)
        pts_q = np.clip(np.sort(pts_q), 1e-6, 1 - 1e-6)
        aff_edges[k] = np.concatenate([[0.0], pts_a, [1.0]])
        neg_edges[k] = np.concatenate([[0.0], pts_q, [1.0]])
        ai = np.clip(np.digitize(a, aff_edges[k]) - 1, 0, n_bins - 1)
        qi = np.clip(np.digitize(q, neg_edges[k]) - 1, 0, n_bins - 1)
        pos = som == k
        for i in range(n_bins):
            for j in range(n_bins):
                m = (ai == i) & (qi == j)
                npos = float(np.sum(pos & m))
                ntot = float(np.sum(m))
                matrices[k, i, j] = (npos + smooth) / (ntot + 2 * smooth)
    return LikelihoodData(matrices=matrices, aff_edges=aff_edges, neg_edges=neg_edges)


def save_likelihood_matrix(path, lik: LikelihoodData):
    """Write the reference likelihood_matrix.txt layout
    (call_variants.py:655-796): per-allele 10-row matrices, then per allele
    an AFF point row and a NEG point row (each padded with a dropped
    sentinel element)."""
    rows = [lik.matrices[k] for k in range(lik.n_alleles)]
    point_rows = []
    for k in range(lik.n_alleles):
        point_rows.append(np.concatenate([lik.aff_edges[k][1:-1], [1.0]]))
        point_rows.append(np.concatenate([lik.neg_edges[k][1:-1], [1.0]]))
    data = np.vstack([np.vstack(rows), np.vstack(point_rows)])
    np.savetxt(path, data)
    return path
