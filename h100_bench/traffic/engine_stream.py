"""A closed-loop stream of full device batches through the SNV and indel
engines, as ``run`` builds them (``cli/run.py::load_engines``).

Cell parameters (``workloads/<cell>.json``): ``device_batch`` rows a
batch, ``pool`` {mode: batches made in set-up}, ``order`` the modes in
turn as [mode, batches] runs, ``depth_range`` of the candidates,
``warm_batches`` run in set-up.  One caller: batch k+1 is
dispatched (``run_batch_async``) before batch k's ``result()`` is taken.
Every batch is full and drawn from the pool in turn, so every seed gives
the same work in another order of rows.  ``correct``: every answer of the
window against the plain reference (class-1 probabilities of both
networks, the float64 posterior from the program's probabilities, the
strand counts).
"""

import os
import time

import numpy as np
import torch

from h100_bench.benchlib import synth
from h100_bench.reference import nets
from h100_bench.reference import posterior as ref_post


def load_engines(ctx):
    """(snv, indel) engines of the cell's configuration, on ``ctx.device``."""
    from clairs_to_tpu_torch.cli.run import build_parser, load_engines as load

    cfg = ctx.config
    argv = ["-T", os.devnull, "-R", os.devnull, "-o", ctx.cache, "-p", cfg["platform"],
            "--device", ctx.device.type, "--model_dir", ctx.path(cfg["model_dir"]),
            "--device_batch", str(ctx.spec["device_batch"]),
            "--matmul_precision", cfg["matmul_precision"]]
    return load(build_parser().parse_args(argv))


def make_pool(ctx):
    """{mode: [batch as host arrays]} drawn from the seed on the device, one
    child seed a batch."""
    cfg, spec = ctx.config, ctx.spec
    jobs = [(mode, dict(n=spec["device_batch"], dual=cfg["dual_view"], mode=mode,
                        depth_range=tuple(spec["depth_range"])))
            for mode, n in spec["pool"].items() for _ in range(n)]
    batches = synth.draw_many(ctx.seed, [kw for _m, kw in jobs], ctx.device)
    pool = {mode: [] for mode in spec["pool"]}
    for (mode, _kw), b in zip(jobs, batches):
        pool[mode].append(synth.to_host(b))
    return pool


def expand_order(spec):
    """The cell's ``order`` of [mode, batches] runs, one mode a batch."""
    return [mode for mode, n in spec["order"] for _ in range(n)]


def setup(ctx):
    pool = make_pool(ctx)
    ctx.phase("pool")
    snv, indel = load_engines(ctx)
    engines = {"snv": snv, "indel": indel}
    ctx.phase("engines")
    # warm every shape the window uses: a synchronous batch of each mode,
    # then ``warm_batches`` pipelined in the window's order, which also lets
    # the host's allocators settle on the batches' buffers
    for mode in pool:
        engines[mode].run_batch(*pool[mode][0][:4])
    order, prev = expand_order(ctx.spec), None
    for k in range(ctx.spec["warm_batches"]):
        mode = order[k % len(order)]
        pend = engines[mode].run_batch_async(*pool[mode][k % len(pool[mode])][:4])
        if prev is not None:
            prev.result()
        prev = pend
    prev.result()
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
        torch.cuda.reset_peak_memory_stats(ctx.device)
    ctx.phase("warm-up")
    return {"engines": engines, "pool": pool}


def window(ctx, state):
    engines, pool, order = state["engines"], state["pool"], expand_order(ctx.spec)
    spans, traced = ctx.spans, ctx.trace and ctx.device.type == "cuda"
    results, next_idx = [], {m: 0 for m in pool}
    batches = {m: 0 for m in pool}

    def consume(item):
        mode, i, pend, done = item
        if done is not None:
            with spans.span("engine.wait"):
                done.synchronize()
        with spans.span("engine.result"):
            results.append((mode, i, pend.result()))

    ctx.start_window()
    prev, k = None, 0
    while True:
        mode = order[k % len(order)]
        i = next_idx[mode] % len(pool[mode])
        next_idx[mode] += 1
        with spans.span("engine.dispatch"):
            pend = engines[mode].run_batch_async(*pool[mode][i][:4])
        done = None
        if traced:
            done = torch.cuda.Event()
            done.record()
        if prev is not None:
            consume(prev)
        prev = (mode, i, pend, done)
        batches[mode] += 1
        k += 1
        if time.perf_counter() - ctx.t_window >= ctx.seconds:
            break
    consume(prev)
    window_s = ctx.stop_window()
    rows = ctx.spec["device_batch"] * k
    state["results"] = results
    ctx.counters.update(batches=batches, rows=rows, window_s=window_s)
    return {"e2e": {"engine_cand_per_s": rows / window_s}, "attempted": rows, "failed": 0}


def release(ctx, state):
    """Frees the engines before the reference runs."""
    state.pop("engines", None)
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return state


def _reference(ctx, state, tf32=False):
    """{mode: [(N, 2, A) float64 class-1 probabilities of pool batch i]}."""
    cfg = ctx.config
    nets.set_tf32(tf32)
    out = {}
    try:
        for mode, batches in state["pool"].items():
            sub = "" if mode == "snv" else "indel/"
            aff = nets.load_npz(ctx.path(os.path.join(cfg["model_dir"], sub + "aff.npz")),
                                ctx.device)
            neg = nets.load_npz(ctx.path(os.path.join(cfg["model_dir"], sub + "neg.npz")),
                                ctx.device)
            probs = []
            for xa, xn, ca, cn, _som in batches:
                t = [torch.from_numpy(np.asarray(a, np.float32)).to(ctx.device)
                     for a in (xa, xn, ca, cn)]
                p = nets.class1_probs(aff, neg, cfg[mode], *t).double().cpu().numpy()
                probs.append(np.round(p, 8))
            out[mode] = probs
    finally:
        nets.set_tf32(False)
    return out


def _likelihoods(ctx):
    cfg = ctx.config
    return {mode: ref_post.load_likelihood(
        ctx.path(os.path.join(cfg["model_dir"], ("" if mode == "snv" else "indel/")
                              + "likelihood_matrix.txt")), len(cfg[mode]["cvt"]["alleles"]))
            for mode in ctx.spec["pool"]}


def check(ctx, state):
    """Every answer of the window against the reference."""
    ref = _reference(ctx, state)
    liks = _likelihoods(ctx)
    strands = {m: [ref_post.strand_counts(b[0][:, synth.FLANK]) for b in batches]
               for m, batches in state["pool"].items()}
    p_gap = post_gap = 0.0
    missing = strand_bad = 0
    n_rows = ctx.spec["device_batch"]
    for mode, i, r in state["results"]:
        want = ref[mode][i]
        if r.p_aff.shape != want[:, 0].shape or r.p_neg.shape != want[:, 1].shape:
            missing += n_rows - min(r.p_aff.shape[0], r.p_neg.shape[0])
            continue
        p_gap = max(p_gap, float(np.abs(r.p_aff - want[:, 0]).max()),
                    float(np.abs(r.p_neg - want[:, 1]).max()))
        post_gap = max(post_gap, float(np.abs(
            ref_post.posterior(r.p_aff, r.p_neg, liks[mode]) - r.posterior).max()))
        fwd, rev = strands[mode][i]
        strand_bad += int(((r.forward_acgt != fwd).any(1) | (r.reverse_acgt != rev).any(1)).sum())
    lim = ctx.spec["limits"]
    return [("prob_gap", p_gap, lim["prob_gap"]),
            ("posterior_gap", post_gap, lim["posterior_gap"]),
            ("strand_rows_wrong", strand_bad, 0),
            ("rows_missing", missing, 0)]


def control(ctx, state):
    """The control's readings: the reference with TF32 on in the program's
    place against the reference, and the posterior in float32 against
    float64."""
    ref = _reference(ctx, state)
    low = _reference(ctx, state, tf32=True)
    liks = _likelihoods(ctx)
    p_gap = post_gap = 0.0
    for mode in ref:
        for want, got in zip(ref[mode], low[mode]):
            p_gap = max(p_gap, float(np.abs(got - want).max()))
            post_gap = max(post_gap, float(np.abs(
                ref_post.posterior(want[:, 0], want[:, 1], liks[mode], np.float32)
                - ref_post.posterior(want[:, 0], want[:, 1], liks[mode])).max()))
    return [("prob_gap", p_gap), ("posterior_gap", post_gap)]
