# Port-only: the JAX package has no counterpart.
"""One training step's gradients, leaf by leaf, on two devices and in float64.

    python -m clairs_to_tpu_torch.bench.grad_check [--rows 800] [--device cuda]

Builds the flagship SNV networks once, copies the same weights
into three trainers (fp32 on ``--device``, fp32 on the CPU, float64 on the
CPU), takes one step of each on the same dual-view ONT rows at dropout 0,
and prints one JSON object: for each pair of steps the relative gap of the
loss and of the gradient global norm, the leaf with the largest relative
error, and the leaf with the largest share of the gap in the squared norm.
The float64 step is the reference that says which fp32 step strays.
"""

import argparse
import json
import sys
import time

import numpy as np
import torch

from clairs_to_tpu_torch.bench.synth import synthesize_dual_batch
from clairs_to_tpu_torch.train import DualTrainer, TrainConfig


def train_batch(n, seed, device, n_alleles=4):
    """``n`` dual-view ONT rows as one training step takes them (rescaled
    by 50/cov, AFF and NEG labels), on ``device``; also the raw rows
    ``(x, x_neg, cov)`` for ``predict_probs``."""
    x, x_neg, cov, _cov_neg, som = synthesize_dual_batch(np.random.default_rng(seed), n,
                                                         platform="ont")
    scale = np.where(cov > 50, 50.0 / cov, 1.0).astype(np.float32)[:, None, None]
    aff = np.stack([som == k for k in range(n_alleles)], axis=1).astype(np.int64)
    host = (x * scale, x_neg * scale, aff, 1 - aff)
    return [torch.from_numpy(a).to(device) for a in host], (x, x_neg, cov)


def to_float64(tr):
    """Make every trained tensor of ``tr`` float64 in place (the same leaf
    objects, so the optimizer and ``tr.tensors`` still hold them)."""
    for t in tr.tensors.values():
        t.data = t.data.double()
    return tr


def step_grads(tr, batch, use_kernel=True):
    """One step of ``tr`` on ``batch``: (loss, global norm before clipping,
    {leaf name: its gradient as a CPU float64 tensor}).  ``use_kernel``:
    as ``DualTrainer.loss`` takes it."""
    loss = tr.loss(*batch, use_kernel=use_kernel)
    loss.backward()
    # a copy: clipping scales the gradients in place
    grads = {k: t.grad.detach().to("cpu", torch.float64, copy=True)
             for k, t in tr.tensors.items()}
    norm = tr.apply_gradients()
    return loss.item(), norm.item(), grads


def compare(got, want):
    """Two ``step_grads`` results against each other: the relative gaps of
    the loss and the norm, the leaf with the largest ‖g - w‖ / ‖w‖, and the
    leaf whose ‖g‖² - ‖w‖² is the largest share of the squared norms' gap."""
    (loss_g, norm_g, g), (loss_w, norm_w, w) = got, want
    rel = {k: float(torch.linalg.vector_norm(g[k] - w[k]) /
                    max(float(torch.linalg.vector_norm(w[k])), 1e-30)) for k in w}
    gap = {k: float(g[k].square().sum() - w[k].square().sum()) for k in w}
    worst = max(rel, key=rel.get)
    top = max(gap, key=lambda k: abs(gap[k]))
    total = sum(gap.values())
    return dict(loss_rel=abs(loss_g - loss_w) / abs(loss_w),
                norm_rel=abs(norm_g - norm_w) / abs(norm_w),
                worst_leaf=worst, worst_leaf_rel=rel[worst],
                worst_leaf_norm=float(torch.linalg.vector_norm(w[worst])),
                norm_gap_leaf=top, norm_gap_share=gap[top] / total if total else 0.0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=800)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    tc = TrainConfig(dropout_rate=0.0)
    batch, _ = train_batch(a.rows, 5, a.device)   # phase 10's rows in chip_smoke.py
    trainers = {"device": DualTrainer("snv", tc, device=a.device)}
    state = {n: m.state_dict() for n, m in trainers["device"].models.items()}
    for name in ("cpu", "cpu_f64"):
        tr = DualTrainer("snv", tc, device="cpu")
        for n, m in tr.models.items():
            m.load_state_dict(state[n])
        trainers[name] = to_float64(tr) if name == "cpu_f64" else tr
    steps, secs = {}, {}
    for name, tr in trainers.items():
        b = [t.cpu() for t in batch] if name != "device" else batch
        if name == "cpu_f64":
            b = [t.double() if t.is_floating_point() else t for t in b]
        t0 = time.time()
        steps[name] = step_grads(tr, b)
        secs[name] = time.time() - t0
    out = {f"{g}_vs_{w}": compare(steps[g], steps[w])
           for g, w in (("device", "cpu"), ("device", "cpu_f64"), ("cpu", "cpu_f64"))}
    out.update(rows=a.rows, device=a.device, step_s=secs,
               loss={k: s[0] for k, s in steps.items()},
               grad_norm={k: s[1] for k, s in steps.items()})
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
