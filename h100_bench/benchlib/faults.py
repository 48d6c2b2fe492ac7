"""Faults planted under a run's timed path, to show that ``correct`` can
come out false: each replaces one function of the program for as long as
it is planted.  Used by the benchmark's tests on the CPU and by
``calibrate.py --fault`` on the card, never by a benchmark run."""

import numpy as np
import torch


def _engine(fault, patch):
    from clairs_to_tpu_torch.infer import engine

    consume = engine.InferenceEngine._consume

    def broken(self, n, x_aff_slice, parts):
        res = consume(self, n, x_aff_slice, parts)
        if fault == "engine.half":          # half of the batch left out
            h = n // 2
            return engine.BatchResult(res.p_aff[:h], res.p_neg[:h], res.posterior[:h],
                                      res.forward_acgt[:h], res.reverse_acgt[:h])
        res.p_neg = res.p_neg.copy()        # an answer altered where it is produced
        res.p_neg[n // 3, 1] = np.round(res.p_neg[n // 3, 1] * 0.999, 8)
        return res

    patch(engine.InferenceEngine, "_consume", broken)


def _train(fault, patch):
    from clairs_to_tpu_torch import train

    if fault == "train.unchanged":         # a step that returns its state unchanged
        patch(train.DualTrainer, "apply_gradients",
              lambda self: self.opt.zero_grad(set_to_none=True))
    elif fault == "train.half":            # half the batch left out, the mean over the rest
        loss = train.DualTrainer.loss

        def half(self, x, x_neg, aff_labels, neg_labels, generator=None, use_kernel=True):
            h = x.shape[0] // 2
            return loss(self, x[:h], x_neg[:h], aff_labels[:h], neg_labels[:h], generator,
                        use_kernel)

        patch(train.DualTrainer, "loss", half)
    elif fault == "train.leaf":            # one leaf's update lost after the first step
        apply = train.DualTrainer.apply_gradients

        def lose_leaf(self):
            self.fault_steps = getattr(self, "fault_steps", 0) + 1
            if self.fault_steps > 1:
                self.tensors[LEAF].grad.zero_()
            return apply(self)

        patch(train.DualTrainer, "apply_gradients", lose_leaf)
    else:                                  # a gradient altered where it is produced
        clip = train.clip_by_global_norm

        def altered(grads, max_norm):
            norm = clip(grads, max_norm)
            torch._foreach_mul_(grads, 1.01)
            return norm

        patch(train, "clip_by_global_norm", altered)


FAULTS = ("engine.half", "engine.altered", "train.unchanged", "train.half", "train.leaf",
          "train.altered")
LEAF = "neg.gru2.hh.weight"   # the BiGRU's second layer, the backward kernel's W_hh


def plant(fault, patch=None):
    """Plants ``fault``; ``patch(obj, name, value)`` defaults to setattr
    with the old value kept.  Returns a function that takes it out."""
    undo = []

    def setter(obj, name, value):
        undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    (_engine if fault.startswith("engine.") else _train)(fault, patch or setter)

    def remove():
        for obj, name, old in reversed(undo):
            setattr(obj, name, old)

    return remove
