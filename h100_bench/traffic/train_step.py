"""Training steps of one network pair, closed loop, through
``train.py::DualTrainer.step`` on the card (both GRU kernels).

Cell parameters (``workloads/<cell>.json``): ``mode`` (snv | indel),
``rows`` a step, ``pool`` batches made in set-up and kept on the device,
used in turn, ``dropout``, ``depth_range``, ``checked_steps`` (3).  The
trainer starts from the configuration's checkpoints.  Set-up builds the one
trainer, drives it through the first ``checked_steps`` steps on pool
batches 0, 1, 2 (rows that all differ) with the window's own call and
feed, and hands it to the window.  ``correct``: the plain reference follows
those steps from the raw checkpoints with the same dropout masks (drawn
from a generator of the same seed, site by site) and compares the first
step's loss, the first gradient as AdamW got it (its first moment after one
step over 1 - beta1) by the worst leaf, and the parameters' change after
the checked steps by the median leaf and by the worst
(``reference/train.py::compare``).  A window step whose loss is not finite
counts as failed; the window's steps have no reference of their own.
"""

import os
import time

import torch

from h100_bench.benchlib import synth
from h100_bench.reference import train as ref_train


def make_pool(ctx):
    """[(x_aff, x_neg, aff_labels, neg_labels)] on the device, each row
    times 50 / coverage where coverage > 50, as ``DualTrainer.fit``
    rescales."""
    spec, cfg = ctx.spec, ctx.config
    n_al = len(cfg[spec["mode"]]["cvt"]["alleles"])
    kw = dict(n=spec["rows"], dual=cfg["dual_view"], mode=spec["mode"],
              depth_range=tuple(spec["depth_range"]))
    pool = []
    for xa, xn, ca, _cn, som in synth.draw_many(ctx.seed, [kw] * spec["pool"], ctx.device):
        c = ca.double()
        scale = torch.where(c > 50, 50.0 / c, torch.ones_like(c)).float()[:, None, None]
        aff = torch.stack([som == k for k in range(n_al)], dim=1).long()
        pool.append((xa.float() * scale, xn.float() * scale, aff, 1 - aff))
    return pool


def weight_paths(ctx):
    sub = "" if ctx.spec["mode"] == "snv" else "indel/"
    base = ctx.path(ctx.config["model_dir"])
    return {"aff": os.path.join(base, sub + "aff.npz"), "neg": os.path.join(base, sub + "neg.npz")}


def dropout_seed(ctx):
    return (ctx.seed * 2654435761 + 1) % (2 ** 63)


def setup(ctx):
    from clairs_to_tpu_torch.models.checkpoint import load_checkpoint
    from clairs_to_tpu_torch.train import DualTrainer, TrainConfig

    spec = ctx.spec
    pool = make_pool(ctx)
    ctx.phase("pool")
    trainer = DualTrainer(spec["mode"], TrainConfig(dropout_rate=spec["dropout"]),
                          device=ctx.device.type)
    for net, path in weight_paths(ctx).items():
        load_checkpoint(path, trainer.models[net])
    ctx.phase("trainer")
    gen = torch.Generator(device=ctx.device).manual_seed(dropout_seed(ctx))
    losses, first_grad, after = [], None, None
    for s in range(spec["checked_steps"]):
        losses.append(trainer.step(*pool[s], generator=gen))
        if s == 0:
            beta1 = trainer.opt.param_groups[0]["betas"][0]
            # a leaf the optimizer never stepped has no moment: no gradient
            first_grad = {k: (trainer.opt.state.get(t, {}).get("exp_avg", torch.zeros_like(t))
                              / (1 - beta1)).cpu() for k, t in trainer.tensors.items()}
    after = {k: t.detach().cpu().clone() for k, t in trainer.tensors.items()}
    losses = [float(x) for x in losses]
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
        torch.cuda.reset_peak_memory_stats(ctx.device)
    ctx.phase("checked steps")
    return {"trainer": trainer, "pool": pool, "gen": gen, "next": spec["checked_steps"],
            "program": {"losses": losses, "first_grad": first_grad, "after": after}}


def window(ctx, state):
    trainer, pool, gen, spans = state["trainer"], state["pool"], state["gen"], ctx.spans
    i = state["next"]
    losses = []
    ctx.start_window()
    steps = 0
    while True:
        with spans.span("train.step"):
            losses.append(trainer.step(*pool[i % len(pool)], generator=gen))
        i += 1
        steps += 1
        if time.perf_counter() - ctx.t_window >= ctx.seconds:
            break
    with spans.span("train.drain"):
        if ctx.device.type == "cuda":
            torch.cuda.synchronize(ctx.device)
    window_s = ctx.stop_window()
    # a step whose loss is not a finite number has failed
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    ctx.counters.update(steps=steps, rows=steps * ctx.spec["rows"], window_s=window_s)
    return {"e2e": {"train_step_ms": 1e3 * window_s / steps}, "attempted": steps,
            "failed": failed}


def release(ctx, state):
    for k in ("trainer", "gen"):
        state.pop(k, None)
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return state


def _reference(ctx, state, tf32=False):
    spec = ctx.spec
    return ref_train.follow(
        weight_paths(ctx), ctx.config[spec["mode"]], state["pool"][:spec["checked_steps"]],
        dropout=spec["dropout"], seed=dropout_seed(ctx), device=ctx.device, tf32=tf32)


def readings(ctx, state):
    """Every reading of the program against the reference, compared or
    not (each step's loss beside the compared numbers)."""
    return ref_train.compare(state["program"], _reference(ctx, state))


def look(ctx, state):
    return ref_train.worst_leaves(state["program"], _reference(ctx, state))


def check(ctx, state):
    lim = ctx.spec["limits"]
    return [(name, value, lim[name]) for name, value in readings(ctx, state) if name in lim]


def control(ctx, state):
    """The reference with TF32 on, in the program's place."""
    return ref_train.compare(_reference(ctx, state, tf32=True), _reference(ctx, state))
