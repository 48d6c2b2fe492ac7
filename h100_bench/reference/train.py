"""Plain training steps of a network pair, and the comparison with the
program's.

The loss is ClairS-TO's focal cross-entropy (gamma 2) of each network over
its alleles, summed over the two networks.  Every leaf of both checkpoints
trains, the BatchNorm running statistics included, as in the JAX package's
optimizer over the whole parameter tree.  A step clips the gradients by
their global norm (scaled by max / norm when norm >= max, the squares
summed in float64) and takes one AdamW step (beta1 0.9, beta2 0.999, eps
1e-8, the decay applied to the weights before the update), written out here
rather than taken from ``torch.optim``.
"""

import numpy as np
import torch

from h100_bench.reference import nets

LR, WEIGHT_DECAY, CLIP, GAMMA = 5e-4, 1e-6, 1.0, 2.0
BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


def focal(logits, labels, gamma=GAMMA):
    logp = torch.log_softmax(logits, dim=-1)
    lp = torch.gather(logp, -1, labels[..., None].long())[..., 0]
    return torch.mean((1 - lp.exp()) ** gamma * -lp)


def follow(paths, net_cfg, batches, dropout, seed, device, tf32=False):
    """Steps of the plain pair from the raw checkpoints over ``batches``
    [(x_aff, x_neg, aff_labels, neg_labels)], with dropout masks from a
    generator seeded ``seed`` on ``device``.  Returns {"losses": [...],
    "first_grad": {leaf: the clipped gradient of step 1}, "after": {leaf:
    value after the last step}, "before": {leaf: the start}}."""
    nets.set_tf32(tf32)
    try:
        leaves = {f"{net}.{k}": v.clone().requires_grad_(True)
                  for net, path in paths.items() for k, v in nets.load_npz(path, device).items()}
        before = {k: v.detach().cpu().clone() for k, v in leaves.items()}
        m = {k: torch.zeros_like(v) for k, v in leaves.items()}
        v2 = {k: torch.zeros_like(v) for k, v in leaves.items()}
        gen = torch.Generator(device=device).manual_seed(seed)
        drop = nets.Dropout(dropout, gen)
        losses, first_grad = [], None
        for step, (xa, xn, la, ln) in enumerate(batches, start=1):
            aff = {k[4:]: t for k, t in leaves.items() if k.startswith("aff.")}
            neg = {k[4:]: t for k, t in leaves.items() if k.startswith("neg.")}
            loss = (focal(nets.cvt_logits(aff, net_cfg["cvt"], xa.float(), drop), la)
                    + focal(nets.bigru_logits(neg, net_cfg["bigru"], xn.float(), drop), ln))
            names = list(leaves)
            grads = torch.autograd.grad(loss, [leaves[k] for k in names])
            norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
            scale = CLIP / norm if float(norm) >= CLIP else torch.ones_like(norm)
            grads = {k: g * scale for k, g in zip(names, grads)}
            if step == 1:
                first_grad = {k: g.detach().cpu() for k, g in grads.items()}
            with torch.no_grad():
                for k, g in grads.items():
                    p = leaves[k]
                    p.mul_(1 - LR * WEIGHT_DECAY)
                    m[k].mul_(BETA1).add_(g, alpha=1 - BETA1)
                    v2[k].mul_(BETA2).addcmul_(g, g, value=1 - BETA2)
                    m_hat = m[k] / (1 - BETA1 ** step)
                    v_hat = v2[k] / (1 - BETA2 ** step)
                    p.sub_(LR * m_hat / (v_hat.sqrt() + EPS))
            losses.append(float(loss.detach()))
        after = {k: v.detach().cpu().clone() for k, v in leaves.items()}
    finally:
        nets.set_tf32(False)
    return {"losses": losses, "first_grad": first_grad, "after": after, "before": before}


def _leaf_gaps(got, want, names):
    """Each leaf's gap between the two norms, over the larger of the
    reference leaf's norm and the median leaf's."""
    ref_norms = {k: float(want[k].double().norm()) for k in names}
    median = float(np.median(list(ref_norms.values())))
    return {k: abs(float(got[k].double().norm()) - ref_norms[k]) / max(ref_norms[k], median, 1e-30)
            for k in names}


def compare(prog, ref):
    """(name, reading) of the numbers compared, then of those only read.

    Compared: the first step's loss (relative gap); the first gradient as
    the optimizer got it, by the worst leaf; the parameters' change after
    the checked steps, by the median leaf and by the worst.  Leaves whose
    reference gradient is under a thousandth of the median leaf's move by
    round-off alone: the change leaves them out.  The worst leaf's change
    carries the round-off of a few near-degenerate leaves (the BatchNorm
    shifts of the query projections) from step to step under Adam, so its
    limit sits well above the median's: it is there for a wrong update
    confined to a few leaves, which the median does not see.  Read beside
    them: each later step's loss."""
    steps = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    grad = _leaf_gaps(prog["first_grad"], ref["first_grad"], list(ref["first_grad"]))
    g_norms = {k: float(g.double().norm()) for k, g in ref["first_grad"].items()}
    g_median = float(np.median(list(g_norms.values())))
    moving = [k for k, n in g_norms.items() if n >= 1e-3 * g_median]
    before = ref["before"]
    change = _leaf_gaps({k: prog["after"][k].double() - before[k].double() for k in moving},
                        {k: ref["after"][k].double() - before[k].double() for k in moving},
                        moving)
    return ([("loss_gap_step1", steps[0]), ("grad_norm_gap", max(grad.values())),
             ("update_gap_median", float(np.median(list(change.values())))),
             ("update_gap_worst", max(change.values()))]
            + [(f"loss_gap_step{i}", g) for i, g in enumerate(steps[1:], start=2)])


def worst_leaves(prog, ref, top=5):
    """The leaves whose change after the checked steps differs most, each
    as (name, gap of the change's norm over the larger of the reference's
    and the median leaf's, the reference's first gradient over the median
    leaf's): the look behind ``update_gap_worst``."""
    g_norms = {k: float(g.double().norm()) for k, g in ref["first_grad"].items()}
    g_median = float(np.median(list(g_norms.values())))
    change = {k: float((ref["after"][k].double() - ref["before"][k].double()).norm())
              for k in g_norms}
    c_median = float(np.median(list(change.values())))
    rows = []
    for k in g_norms:
        got = float((prog["after"][k].double() - ref["before"][k].double()).norm())
        rows.append((k, abs(got - change[k]) / max(change[k], c_median), g_norms[k] / g_median))
    return sorted(rows, key=lambda r: -r[1])[:top]
