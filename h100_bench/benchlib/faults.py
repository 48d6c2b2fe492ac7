"""Faults planted under a run's timed path, to show that ``correct`` can
come out false: each replaces one function of the program for as long as
it is planted.  ``call.after_warmup`` drops the last chunk's calls from
the second whole run on, so only the window's runs carry it.  Used by the
benchmark's tests on the CPU and by ``calibrate.py --fault`` on the card,
never by a benchmark run."""

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


def _call(fault, patch):
    from clairs_to_tpu_torch.cli import run as cli
    from clairs_to_tpu_torch.infer import calling, pipeline
    from clairs_to_tpu_torch.postcall import haplotype

    if fault == "call.min_bq0":            # the AFF view built at min_bq 0
        init = pipeline.CallingPipeline.__init__

        def at_zero(self, *a, **kw):
            init(self, *a, **kw)
            self.aff_min_bq = 0

        patch(pipeline.CallingPipeline, "__init__", at_zero)
    elif fault == "call.phaser_skipped":   # no read haplotagged: the phaser skipped
        from clairs_to_tpu_torch.phasing import phaser

        patch(phaser, "phase_and_tag", lambda pe, het_sites, *a, **kw: np.zeros(0, np.int8))
    elif fault == "call.filter_skipped":   # one hard filter skipped: the strand test
        batch = haplotype.HaplotypeFilterEngine.verdict_batch

        def no_strand_test(self, sites):
            out = batch(self, sites)
            for v in out.values():
                v.pass_strand_bias = True
            return out

        patch(haplotype.HaplotypeFilterEngine, "verdict_batch", no_strand_test)
    elif fault == "call.prob_altered":     # one call's probability altered a chunk
        call = calling.call_from_posterior
        done = set()

        def altered(record, posterior, *a, **kw):
            row = call(record, posterior, *a, **kw)
            if (row is not None and kw.get("mode") == "indel" and row["QUAL"] > 0
                    and kw.get("best_p") is not None and (record.pos in done or not any(
                        abs(record.pos - p) < 125_000 for p in done))):
                done.add(record.pos)
                p = kw["best_p"] - 0.01
                kw.update(best_p=p, quality=float(np.round(max(
                    -10 * np.log10((1 - p + 1e-10) / (p + 1e-10)) + 2, 0.0), 4)))
                row = call(record, posterior, *a, **kw)
            return row

        patch(calling, "call_from_posterior", altered)
    else:
        finish = pipeline.CallingPipeline.finish_chunk
        runs = [0]

        def drop_last(self, pending):
            res = finish(self, pending)
            if res.chunk.chunk_id == res.chunk.chunk_num - 1 and (
                    fault == "call.chunk_dropped" or runs[0] > 1):
                res.snv_rows, res.indel_rows = [], []
            return res

        body = cli._pipeline_body

        def counted(*a, **kw):
            runs[0] += 1
            return body(*a, **kw)

        patch(pipeline.CallingPipeline, "finish_chunk", drop_last)
        patch(cli, "_pipeline_body", counted)


FAULTS = ("engine.half", "engine.altered", "train.unchanged", "train.half", "train.leaf",
          "train.altered", "call.chunk_dropped", "call.prob_altered", "call.min_bq0",
          "call.filter_skipped", "call.phaser_skipped", "call.after_warmup")
LEAF = "neg.gru2.hh.weight"   # the BiGRU's second layer, the backward kernel's W_hh


def plant(fault, patch=None):
    """Plants ``fault``; ``patch(obj, name, value)`` defaults to setattr
    with the old value kept.  Returns a function that takes it out."""
    undo = []

    def setter(obj, name, value):
        undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    {"engine": _engine, "train": _train, "call": _call}[fault.split(".")[0]](fault, patch or setter)

    def remove():
        for obj, name, old in reversed(undo):
            setattr(obj, name, old)

    return remove
