"""Smoke run of the PyTorch/CUDA port (clairs_to_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build the GRU kernels (csrc/gru.cu, the forward, and csrc/gru_bwd.cu,
     its backward) from the checkout, one nvcc each, both at once;
  2. hold the forward kernel against its plain PyTorch version on the card
     (H in {16, 24, 128, 192}, B in {8192, 8191, 4096, 1000}, both
     directions) and time it, with x_gates cold in L2, beside the plain
     version and cuDNN's torch.nn.GRU (a yardstick only).
     Then the backward kernel at the training shapes
     (T=33, H in {128, 192}, B in {800, 256}, both directions), with its
     launch geometry (cluster size, CTAs, rows a cluster, clusters the card
     runs at once, shared memory a CTA): against
     gru_direction_backward_plain from the forward kernel's output and
     against autograd through gru_direction_plain from that loop's own
     output, each gradient within 1e-5 of the largest reference value; timed
     cold in L2 beside the plain version and the backward of cuDNN's
     torch.nn.GRU (torch.autograd.grad of its output).  Then the CvT's
     depthwise projection kernels (csrc/dwproj.cu) at the flagship
     SNV CvT's 26 projections in the net's layouts, B=800 and B=8192:
     against dwproj_plain under autograd within 1e-5, the backward bit-equal
     over two runs, and each projection's forward and forward + backward
     timed in a captured CUDA graph beside the plain version, the library
     (F.conv2d then x * scale + shift) and the byte bound; phases 3, 9 and
     10 check one forward launch a projection (and in training one
     backward), and every ``run`` of phases 4 to 11 that the projections'
     launches lie between 3 and 6.5 times the GRU forward's (12 and 26
     projections against 4 GRU launches a batch);
  3. the engine's forward on the flagship ONT SNV and indel weights at
     device_batch 8192, with the kernel against the plain GRU;
  4. ``clairs_to_tpu_torch run -p ont`` with every post-calling stage opted
     out (the first slice's path) on a simulated 2 Mb ONT BAM at 60x, then on
     a 200 kb region of it on the card and on the CPU, the CPU's calls being
     the reference;
  5. ``run -p ont`` with its default flags on the whole 2 Mb: phasing and
     the haplotype filter, PoN tagging against a bgzipped, indexed panel
     written here, Verdict, bgzip + tabix output.  The three C++ libraries
     must have loaded, reads must get haplotags, the haplotype filter and
     the PoN must each mark a row, and TabixReader must read the outputs
     back.  Then the same flags on the 200 kb region, card against CPU;
  6. ``run -p ilmn`` with its default flags (realignment, the postfilter) on
     a simulated 300 kb Illumina BAM at 50x, card against CPU;
  7. ``serve``: the port's server on a thread of this process, ``--preload
     ont``, three requests over loopback HTTP with phase 5's flags (the
     200 kb region twice, then the 2 Mb genome).  Every answer must come from
     cached engines with returncode 0 and more kernel launches than before,
     ``/health`` must list one engine, and the VCFs must equal phase 5's;
     each request's seconds stand beside the batch run's (WARM_SAVING);
  8. two processes on the one card: ranks 0 and 1 of one coordinator on
     loopback as ``python -m clairs_to_tpu_torch run`` children with
     ``--chunk_num 4``, started with every library an ONT run loads
     deleted from build/kernels/ (the GRU's and the depthwise projection's
     forward kernels, the engine's wire routine, the decoder and the verdict
     library), so both build them at once.  Both must own chunks and launch
     the kernels, only rank 0 may write the output, and the output must
     equal a single-process run's;
  9. replicas on the one card: an engine with ``devices=[cuda:0, cuda:0]``
     against the one-device engine at 8192 rows (8 launches a forward
     instead of 4, the split, the per-part events);
 10. training at the flagship widths: (a) one step of the SNV pair on 800
     dual-view rows at dropout 0 from the same weights on the card and on
     the CPU path, loss, gradient global norm and every gradient leaf
     (‖g - w‖ / ‖w‖) within 1e-4 relative, the worst leaf named; the card's
     step, which runs the BiGRU through both GRU kernels (4 launches of
     each), against the same step through the plain loop under autograd on
     the card (``use_kernel=False``): loss within 1e-6 and every leaf within
     1e-5, relative; and against a float64 step on the CPU (as
     bench/grad_check.py takes it) within 1e-4;
     (b) twenty steps timed with CUDA events, split into forward + loss,
     backward and clip + AdamW, with the peak device memory, in turns with
     the plain-loop step (plain, kernels, kernels, plain); then five of each
     under torch.profiler for the device's busy share of the unprofiled
     wall; (c) ``train --dual_view --platform ont`` for ``--mode snv`` and
     ``--mode indel`` into the layout ``run --model_dir`` reads; (d) its
     networks' ``predict_probs`` with the kernel against the plain GRU,
     within 5e-5; (c) and (d) must launch each kernel exactly as often as
     their steps and row counts say (path ``train``); (e) ``run
     --model_dir`` with those networks on phase 4's genome and flags (path
     ``train_run``);
 11. run paths: ``run`` on a simulated three-contig ONT genome (3 x 100 kb
     at 60x, ``--chunk_size 50000``) with ``-c chr1,chr3``, a BED and
     ``--alt_fn`` with ``--output_depth true --output_alt_info true``, on the
     card and with ``--device cpu`` (the same rows, the same dump); then, on
     the card, one chunk's shards deleted and the first command again with
     ``--resume`` (one chunk called again, its dump lines appended, the first
     run's rows).  The kernel must launch in both card runs.
Each path's launches of the GRU kernels and the depthwise projection
kernels (forward and backward) are counted from 0 just before it.  Prints
the card's name and power limit, a ``kernels`` JSON line, and as the last line ``{"ok": true,
"device": {...}}``.  Exits non-zero without a GPU.  Working files go under
build/chip_smoke/ in the checkout.
"""

import argparse
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")
ASSETS = os.path.join(REPO, "assets", "flagship_ont_snv")
T = 33
# H100 SXM peaks (NVIDIA data sheet): TF32 on the tensor cores, fp32 outside
# them, HBM3
PEAK_TF32_FLOPS = 495e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
KERNEL_TOL = 1e-5     # kernel vs plain GRU outputs, fp32 both
BWD_TOL = 1e-5        # max |Δ| / max |ref| of each gradient, backward kernel vs plain
DWPROJ_TOL = 1e-5     # the same, depthwise projection kernels vs dwproj_plain under autograd
ENGINE_TOL = 5e-5     # class-1 probabilities, kernel engine vs plain-GRU engine
REPLICA_TOL = 5e-5    # class-1 probabilities, two replicas vs one device
TRAIN_TOL = 1e-4      # relative: loss and gradient global norm, card vs CPU step
KERNEL_STEP_LOSS_TOL = 1e-6   # relative: kernel step vs plain-loop step on the card
KERNEL_STEP_GRAD_TOL = 1e-5   # relative, every gradient leaf: the same two steps
GENOME_LEN = 2_000_000
ILMN_GENOME_LEN = 300_000
RUN_PATHS_CONTIG = 100_000   # phase 11: three contigs, two chunks each
RUN_PATHS_CHUNK = 50_000
COVERAGE = 60


def log(msg):
    print(msg, flush=True)


def read_model(platform):
    """bamio/simulate's read model of a platform family (its coverage is set
    by the caller)."""
    from clairs_to_tpu_torch.bench.profiles import PROFILES

    return {k: v for k, v in PROFILES[platform].items() if k != "coverage"}


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, iters, warmup=2):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cold_ms(fn, iters=10):
    """Median ms of single calls, each after a 128 MiB write that leaves none
    of its inputs in the 50 MB L2, as the engine's input GEMM leaves x_gates."""
    flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")
    fn()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(iters)]
    for start, end in events:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(start.elapsed_time(end) for start, end in events)


def gru_bound_ms(B, H):
    """Least time for one direction: each input read and output written once
    against HBM, the h.W_hh product against the TF32 tensor-core peak (gate
    math not counted).  ``bound_fp32_ms`` prices the product at the fp32 rate
    outside the tensor cores instead, the bound of the first kernel's PERF row."""
    bytes_ = 4 * (T * B * 3 * H + T * B * H + H * 3 * H + 3 * H)
    flops = 2.0 * T * B * H * 3 * H
    by_bytes, by_ops = bytes_ / PEAK_BYTES * 1e3, flops / PEAK_TF32_FLOPS * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="operations" if by_ops >= by_bytes else "bytes",
                bound_fp32_ms=max(by_bytes, flops / PEAK_FP32_FLOPS * 1e3))


def gru_bwd_bound_ms(B, H):
    """Least time for one direction's backward kernel: x_gates, h and
    grad_out read once, grad_x_gates and grad_hg written once, W_hh and b_hh
    once, against HBM; its two per-step products, 2 x 2·T·B·3H·H FLOP, at
    the 67 TFLOP/s fp32 rate outside the tensor cores (the kernel runs fp32
    FMAs)."""
    bytes_ = 4 * (3 * T * B * 3 * H + 2 * T * B * H + 3 * H * H + 3 * H)
    flops = 2 * 2.0 * T * B * 3 * H * H
    by_bytes, by_ops = bytes_ / PEAK_BYTES * 1e3, flops / PEAK_FP32_FLOPS * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="operations" if by_ops >= by_bytes else "bytes",
                bound_rate="fp32 67 TFLOP/s, HBM 3.35 TB/s")


def _rel(got, want):
    """max |got - want| / max |want|."""
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def phase_build(gru):
    from clairs_to_tpu_torch.ops import dwproj

    t0 = time.time()
    diag = gru.build(verbose=True)
    log(f"[build] gru.cu and gru_bwd.cu built (one nvcc each, at once) and loaded in "
        f"{time.time() - t0:.2f} s")
    t0 = time.time()
    diag += dwproj.build(verbose=True)
    log(f"[build] dwproj.cu built and loaded in {time.time() - t0:.2f} s")
    for line in diag.splitlines():
        if any(k in line for k in ("registers", "spill", "smem", ".cu:", "Compiling entry")):
            log(f"[build] {line.strip()}")


def phase_kernel(gru, dev):
    rng = np.random.default_rng(0)
    max_err, timings = 0.0, {}
    for H in (16, 24, 128, 192):
        bound = H ** -0.5
        w = torch.from_numpy(rng.uniform(-bound, bound, (H, 3 * H)).astype(np.float32)).to(dev)
        b = torch.from_numpy(rng.uniform(-bound, bound, 3 * H).astype(np.float32)).to(dev)
        for B in (8192, 8191, 4096, 1000):   # 4096: a replica's half
            xg = torch.from_numpy(rng.normal(size=(T, B, 3 * H)).astype(np.float32)).to(dev)
            for reverse in (False, True):
                got = gru.gru_direction(xg, w, b, reverse=reverse)
                want = gru.gru_direction_plain(xg, w, b, reverse=reverse)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                max_err = max(max_err, err)
                log(f"[kernel] H={H} B={B} reverse={reverse} max_abs_err={err:.3e}")
                if not torch.allclose(got, want, rtol=KERNEL_TOL, atol=KERNEL_TOL):
                    raise AssertionError(f"kernel disagrees at H={H} B={B} reverse={reverse}")
            if B == 8192 and H in (128, 192):
                in_size = 34 if H == 128 else 256    # gru1 / gru2 layer inputs
                lib = torch.nn.GRU(in_size, H).to(dev)
                x_in = torch.randn(T, B, in_size, device=dev)
                with torch.no_grad():
                    t = dict(
                        kernel_ms=cold_ms(lambda: gru.gru_direction(xg, w, b)),
                        plain_ms=cuda_ms(lambda: gru.gru_direction_plain(xg, w, b), 10),
                        library_ms=cuda_ms(lambda: lib(x_in), 20),
                    )
                t.update(gru_bound_ms(B, H))
                timings[H] = t
                log(f"[kernel] timing T={T} B={B} H={H}: " + json.dumps(t))
    return max_err, timings


GRADS = ("grad_x_gates", "grad_w_hh_t", "grad_b_hh")


def phase_backward(gru, dev):
    """Phase 2, the backward kernel at the training shapes: held to
    gru_direction_backward_plain (from the forward kernel's output) and to
    autograd through gru_direction_plain (the kernel given that loop's own
    output), then timed.  Returns (the largest relative and
    absolute differences, timings and launch geometry by (H, B))."""
    rng = np.random.default_rng(3)
    worst_rel, worst_abs, timings = 0.0, 0.0, {}
    for H in (128, 192):
        bound = H ** -0.5
        w = torch.from_numpy(rng.uniform(-bound, bound, (H, 3 * H)).astype(np.float32)).to(dev)
        b = torch.from_numpy(rng.uniform(-bound, bound, 3 * H).astype(np.float32)).to(dev)
        for B in (800, 256):
            xg = torch.from_numpy(rng.normal(size=(T, B, 3 * H)).astype(np.float32)).to(dev)
            gout = torch.from_numpy(rng.normal(size=(T, B, H)).astype(np.float32)).to(dev)
            for reverse in (False, True):
                out = gru.gru_direction(xg, w, b, reverse=reverse)
                got = gru.gru_direction_backward(xg, w, b, out, gout, reverse)
                want = gru.gru_direction_backward_plain(xg, w, b, out, gout, reverse)
                leaves = [t.clone().requires_grad_(True) for t in (xg, w, b)]
                plain_out = gru.gru_direction_plain(*leaves, reverse=reverse)
                auto = torch.autograd.grad(plain_out, leaves, gout)
                got_auto = gru.gru_direction_backward(xg, w, b, plain_out.detach(), gout,
                                                      reverse)
                torch.cuda.synchronize()
                rel = {n: (_rel(g, r), _rel(ga, ra)) for n, g, r, ga, ra in
                       zip(GRADS, got, want, got_auto, auto)}
                worst_abs = max([worst_abs] + [float((g - r).abs().max())
                                               for g, r in zip(got, want)])
                worst_rel = max([worst_rel] + [max(v) for v in rel.values()])
                log(f"[backward] H={H} B={B} reverse={reverse} max|d|/max|ref| vs plain, vs "
                    f"autograd: " + ", ".join(f"{n} {a:.2e} {c:.2e}" for n, (a, c) in rel.items()))
                if max(max(v) for v in rel.values()) > BWD_TOL or \
                        not all(torch.isfinite(g).all() for g in got):
                    raise AssertionError(f"backward kernel disagrees at H={H} B={B} "
                                         f"reverse={reverse}: {rel}")
            in_size = 34 if H == 128 else 256    # gru1 / gru2 layer inputs
            lib = torch.nn.GRU(in_size, H).to(dev)
            x_in = torch.randn(T, B, in_size, device=dev, requires_grad=True)
            lib_out, _ = lib(x_in)
            lib_leaves = [x_in, *lib.parameters()]
            out = gru.gru_direction(xg, w, b)
            geo = gru.bwd_launch_geometry(H, B, dev)
            log(f"[backward] geometry H={H} B={B}: cluster {geo['cluster']} CTAs of "
                f"{geo['cols']} columns, {geo['ctas']} CTAs, {geo['rows']} rows a cluster, "
                f"{geo['clusters']} clusters in {geo['waves']} wave(s) of at most "
                f"{geo['active_clusters']} at once, {geo['smem_bytes']} bytes of shared "
                f"memory and {geo['threads']} threads a CTA")
            t = dict(
                kernel_ms=cold_ms(lambda: gru.gru_direction_backward_kernel(xg, w, b, out, gout)),
                wrapper_ms=cold_ms(lambda: gru.gru_direction_backward(xg, w, b, out, gout)),
                plain_ms=cuda_ms(lambda: gru.gru_direction_backward_plain(xg, w, b, out, gout), 5),
                library_ms=cuda_ms(lambda: torch.autograd.grad(lib_out, lib_leaves, gout,
                                                               retain_graph=True), 10),
            )
            t.update(gru_bwd_bound_ms(B, H))
            t["geometry"] = geo
            timings[H, B] = t
            log(f"[backward] timing T={T} B={B} H={H}: " + json.dumps(t))
    return dict(max_rel_err=worst_rel, max_abs_err=worst_abs), timings


def graph_ms(fn, reps=20, iters=5):
    """Device ms of one ``fn()``: ``reps`` calls captured in one CUDA graph
    (after three eager calls on a side stream), replayed ``iters`` times
    between two events.  So the host's launch cost is left out, as in the
    training step's graph, and inputs of a few MB stay in the 50 MB L2."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def _dwproj_calls(dev):
    """(C, W, stride, channels-last) of each of the flagship SNV CvT's
    depthwise projections in one forward, in the layouts the net gives them."""
    from clairs_to_tpu_torch.models import cvt
    from clairs_to_tpu_torch.ops.dwproj import dwproj

    calls = []

    def spy(x, weight, scale, shift, stride):
        cl = not x.is_contiguous() and x.is_contiguous(memory_format=torch.channels_last)
        calls.append((x.shape[1], x.shape[3], stride, cl))
        return dwproj(x, weight, scale, shift, stride)
    model = cvt.CvT(cvt.SNV_CVT_CONFIG).reset_parameters(torch.Generator().manual_seed(0))
    real, cvt.dwproj = cvt.dwproj, spy
    try:
        with torch.no_grad():
            model.to(dev)(torch.zeros(2, 33, 34, device=dev))
    finally:
        cvt.dwproj = real
    return calls


def phase_dwproj(dev):
    """Phase 2, the depthwise projection kernels (csrc/dwproj.cu) at the
    flagship SNV CvT's 26 projections, in the net's layouts, at B=800 (a
    training step) and B=8192 (an engine batch): the kernel pair against
    dwproj_plain under autograd (output and every gradient within 1e-5 of
    the largest reference value), two backward runs bit-equal; then each
    distinct projection timed by ``graph_ms``, forward alone and forward +
    backward (autograd.grad of x, weight, scale, shift), beside the plain
    version and the library (F.conv2d groups=C, then x * scale + shift),
    with the byte bound (x read and y written in the forward; x, g read and
    dx written in the backward; at 3.35 TB/s).  Returns per-shape rows and
    the sums over the 26 projections."""
    from collections import Counter

    import torch.nn.functional as F

    from clairs_to_tpu_torch.ops import dwproj as D

    def lib(x, w, scale, shift, stride):
        out = F.conv2d(x, w, stride=(1, stride), padding=(1, 1), groups=x.shape[1])
        return out * scale.reshape(1, -1, 1, 1) + shift.reshape(1, -1, 1, 1)

    calls = Counter(_dwproj_calls(dev))
    worst, res = 0.0, {}
    for B in (800, 8192):
        rows, totals = [], Counter()
        for (C, W, stride, cl), n in calls.items():
            gen = torch.Generator(device=dev).manual_seed(B + C + W + stride)
            x = torch.randn(B, C, 1, W, device=dev, generator=gen)
            if cl:
                x = x.contiguous(memory_format=torch.channels_last)
            args = [x, 0.3 * torch.randn(C, 1, 3, 3, device=dev, generator=gen),
                    0.5 + torch.rand(C, device=dev, generator=gen),
                    torch.randn(C, device=dev, generator=gen)]
            leaves = [t.clone().requires_grad_(True) for t in args]
            Wo = D.out_width(W, stride)
            g = torch.randn(B, C, 1, Wo, device=dev, generator=gen)
            got = D.dwproj(*leaves, stride)
            got_grads = torch.autograd.grad(got, leaves, g)
            again = D.dwproj_backward(args[0], args[1], args[2], g, stride)
            want = D.dwproj_plain(*leaves, stride)
            want_grads = torch.autograd.grad(want, leaves, g)
            torch.cuda.synchronize()
            errs = [_rel(got.detach(), want.detach())] + [
                _rel(a, b) for a, b in zip(got_grads, want_grads)]
            worst = max([worst] + errs)
            if max(errs) > DWPROJ_TOL or not all(
                    torch.equal(a, b) for a, b in zip(got_grads, again)):
                raise AssertionError(f"dwproj disagrees or is not deterministic at B={B} C={C} "
                                     f"W={W} stride={stride}: {errs}")

            def fwd_bwd(fn):
                # fresh leaves: autograd syncs the caller's stream with the stream of a
                # leaf's first backward, which must not be the legacy stream under capture
                fresh = [t.clone().requires_grad_(True) for t in args]
                return lambda: torch.autograd.grad(fn(*fresh, stride), fresh, g)
            with torch.no_grad():
                t = dict(kernel_fwd_ms=graph_ms(lambda: D.dwproj(*args, stride)),
                         plain_fwd_ms=graph_ms(lambda: D.dwproj_plain(*args, stride)),
                         library_fwd_ms=graph_ms(lambda: lib(*args, stride)))
            t.update(kernel_fwd_bwd_ms=graph_ms(fwd_bwd(D.dwproj)),
                     plain_fwd_bwd_ms=graph_ms(fwd_bwd(D.dwproj_plain)),
                     library_fwd_bwd_ms=graph_ms(fwd_bwd(lib)),
                     bound_fwd_ms=4 * B * C * (W + Wo) / PEAK_BYTES * 1e3,
                     bound_bwd_ms=4 * B * C * (2 * W + Wo) / PEAK_BYTES * 1e3)
            rows.append(dict(B=B, C=C, W=W, stride=stride, channels_last=cl, count=n,
                             max_rel_err=max(errs), **t))
            totals.update({k: n * v for k, v in t.items()})
            log(f"[dwproj] B={B} C={C} W={W} stride={stride} channels_last={cl} x{n}: "
                f"max|d|/max|ref| {max(errs):.2e}, " + json.dumps(t))
        res[B] = dict(rows=rows, totals=dict(totals))
        log(f"[dwproj] B={B}, the {sum(calls.values())} projections of the SNV CvT summed: "
            + json.dumps(dict(totals)))
    res["max_rel_err"] = worst
    return res


def _flagship(mode, dev):
    """(aff, neg, likelihood, engine keywords) of the flagship ONT weights."""
    from clairs_to_tpu_torch.models.checkpoint import load_checkpoint_auto
    from clairs_to_tpu_torch.ops.posterior import load_likelihood_matrix

    sub = "" if mode == "snv" else "indel"
    aff, cc = load_checkpoint_auto(os.path.join(ASSETS, sub, "aff.npz"), mode, "cvt", dev)
    neg, gc = load_checkpoint_auto(os.path.join(ASSETS, sub, "neg.npz"), mode, "bigru", dev)
    lik = load_likelihood_matrix(os.path.join(ASSETS, sub, "likelihood_matrix.txt"),
                                 len(cc.alleles))
    return aff, neg, lik, dict(mode=mode, device_batch=8192, cvt_config=cc, bigru_config=gc)


def _engine_batch(n=8192):
    rng = np.random.default_rng(1)
    x_aff = rng.integers(-30, 31, size=(n, 33, 34)).astype(np.int16)
    x_neg = (x_aff + rng.integers(-2, 3, size=x_aff.shape)).astype(np.int16)
    cov = rng.integers(10, 120, size=n).astype(np.float32)
    return x_aff, x_neg, cov


def phase_engine(dev):
    from clairs_to_tpu_torch.infer.engine import InferenceEngine
    from clairs_to_tpu_torch.ops import dwproj, gru

    x_aff, x_neg, cov = _engine_batch()
    out = {}
    for mode in ("snv", "indel"):
        aff, neg, lik, kw = _flagship(mode, dev)
        kern = InferenceEngine(aff, neg, lik, device=dev, **kw)
        plain = InferenceEngine(aff, neg, lik, use_kernel=False, device=dev, **kw)
        before = gru.gru_direction.launches, dwproj.dwproj.launches
        a = kern.run_batch(x_aff, x_neg, cov, cov)
        launched = gru.gru_direction.launches - before[0]
        dw_launched = dwproj.dwproj.launches - before[1]
        if dw_launched != 2 * sum(kw["cvt_config"].depths):
            raise AssertionError(f"{mode}: {dw_launched} dwproj launches in a CvT forward, "
                                 f"expected one a projection")
        p = plain.run_batch(x_aff, x_neg, cov, cov)
        err = max(np.abs(a.p_aff - p.p_aff).max(), np.abs(a.p_neg - p.p_neg).max())
        forward_ms = {name: 1e3 * _wall(lambda e=e: e.run_batch(x_aff, x_neg, cov, cov), 3)
                      for name, e in (("kernel", kern), ("plain", plain))}
        # where run_batch's time goes: each net alone on the device, the rest
        # is host work (packing, copies, the float64 posterior)
        xa = torch.from_numpy(x_aff.astype(np.float32)).to(dev)
        with torch.inference_mode():
            forward_ms["cvt"] = cuda_ms(lambda: kern.aff_model(xa), 5)
            forward_ms["bigru"] = cuda_ms(lambda: kern.neg_model(xa), 5)
        log(f"[engine] {mode}: batch 8192, GRU launches {launched}, max |p diff| "
            f"{err:.3e}, run_batch ms kernel {forward_ms['kernel']:.2f} "
            f"plain {forward_ms['plain']:.2f}; device ms CvT {forward_ms['cvt']:.2f} "
            f"BiGRU {forward_ms['bigru']:.2f}")
        if launched != 4:
            raise AssertionError(f"{mode}: expected 4 GRU launches per NEG forward, got {launched}")
        if err > ENGINE_TOL or not np.isfinite(a.posterior).all():
            raise AssertionError(f"{mode}: engine with kernel disagrees ({err:.3e})")
        out[mode] = dict(max_abs_err=float(err), dwproj_launches=dw_launched,
                         **{f"{k}_ms": v for k, v in forward_ms.items()})
    return out


def _wall(fn, iters):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters


def _calls(path, filt="PASS"):
    """Rows as (what cuda and cpu must agree on ..., QUAL)."""
    rows = []
    for line in open(path):
        if line.startswith("#"):
            continue
        c = line.rstrip("\n").split("\t")
        if filt is None or c[6] == filt:
            rows.append((c[0], int(c[1]), c[3], c[4], c[6], c[7], c[9].split(":")[0],
                         float(c[5])))
    return rows


OPT_OUT = ("--disable_intermediate_phasing", "--disable_verdict", "--panel_of_normals", "None")


def _cli_args(ds, out_dir, device, platform="ont", extra=()):
    args = ["-T", ds["bam"], "-R", ds["fasta"], "-o", out_dir, "-t", "8", "-p", platform,
            "--device", device, *extra]
    if device == "cpu":
        args += ["--device_batch", "1024"]
    return args


def _summary(text):
    """The last RunMetricsSummary of a run's log or output."""
    return json.loads(re.findall(r"RunMetricsSummary: (\{.*\})", text)[-1])


def _run_cli(ds, out_dir, device, platform="ont", extra=()):
    """One ``run`` through the CLI's entry point; returns (wall seconds,
    candidates, the run's stage seconds and counters)."""
    from clairs_to_tpu_torch.cli.run import main

    t0 = time.time()
    rc = main(_cli_args(ds, out_dir, device, platform, extra))
    wall = time.time() - t0
    if rc != 0:
        raise AssertionError(f"run exited {rc}")
    text = open(os.path.join(out_dir, "run_clairs_to_tpu_torch.log")).read()
    n_cand = int(re.findall(r"\[INFO\] (\d+) candidates, total time", text)[-1])
    return wall, n_cand, _summary(text)


def _zero_launches():
    """Count the GRU forward kernel's and the depthwise projection forward
    kernel's launches from 0."""
    from clairs_to_tpu_torch.ops import dwproj, gru

    gru.gru_direction.launches = dwproj.dwproj.launches = 0


def _launches():
    """(GRU forward, depthwise projection forward) launches counted so far."""
    from clairs_to_tpu_torch.ops import dwproj, gru

    return gru.gru_direction.launches, dwproj.dwproj.launches


def _projections(mode):
    """The depthwise projections of a CvT forward: two a transformer block."""
    from clairs_to_tpu_torch.models import mode_configs

    return 2 * sum(mode_configs(mode)[0].depths)


def _check_dwproj(tag, launches, dw_launches):
    """Every engine batch runs one CvT forward (a dwproj launch a projection:
    26 in the SNV net, 12 in the indel net) beside one BiGRU forward (4 GRU
    launches), so a path that calls through the kernels launches dwproj
    between 3 and 6.5 times as often as the GRU forward kernel."""
    lo, hi = (_projections(m) / 4 for m in ("indel", "snv"))
    if not (launches > 0 and lo * launches <= dw_launches <= hi * launches):
        raise AssertionError(f"{tag}: {dw_launches} dwproj launches against {launches} GRU "
                             f"launches, not between {lo} and {hi} times as many")


def _counted_run(tag, card, ds, out_dir, platform="ont", extra=()):
    """A run on the card with the kernels' launches counted from 0."""
    _zero_launches()
    wall, n_cand, summary = _run_cli(ds, out_dir, "cuda", platform, extra)
    launches, dw_launches = _launches()
    log(f"[{tag}] {card}: {n_cand} candidates in {wall:.2f} s wall = {n_cand / wall:.1f} "
        f"cand/s; GRU launches {launches}, dwproj launches {dw_launches}")
    log(f"[{tag}] stages {json.dumps(summary['stages'])}")
    log(f"[{tag}] counters {json.dumps(summary['counters'])}")
    _check_dwproj(tag, launches, dw_launches)
    counted = summary["counters"].get("gru_launches"), summary["counters"].get("dwproj_launches")
    if counted != (launches, dw_launches):
        raise AssertionError(f"{tag}: the run's gru_launches and dwproj_launches counters "
                             f"{counted} are not the wrappers' counts")
    return dict(candidates=n_cand, wall_s=wall, cand_per_s=n_cand / wall, launches=launches,
                dwproj_launches=dw_launches, stages=summary["stages"],
                counters=summary["counters"])


def _same_calls(tag, gpu_dir, cpu_dir, names=("snv.vcf", "indel.vcf"), who=("cuda", "cpu")):
    """One run's rows against another's (by default the card's against the
    CPU path's): same sites, alleles, FILTER, INFO and GT, QUAL within 0.01."""
    total = 0
    for name in names:
        want = _calls(os.path.join(cpu_dir, name), None)
        got = _calls(os.path.join(gpu_dir, name), None)
        gap = max((abs(a[-1] - b[-1]) for a, b in zip(want, got)), default=0.0)
        log(f"[{tag}] {name}: {len(got)} rows on {who[0]}, {len(want)} on {who[1]}, "
            f"largest QUAL gap {gap:.4f}")
        if [r[:-1] for r in got] != [r[:-1] for r in want] or gap > 0.01:
            differ = [(a, b) for a, b in zip(want, got) if a[:-1] != b[:-1]][:3]
            raise AssertionError(f"{tag} {name}: {who[0]} and {who[1]} calls differ: {differ}")
        total += len(got)
    if not total:
        raise AssertionError(f"{tag}: no rows to compare")


def _score(tag, ds, out_dir, names):
    """PASS calls against the simulated somatic truth.  A tumor-only caller
    cannot tell a germline het site from a somatic one by its reads, so PASS
    calls at simulated germline sites are counted apart."""
    truth = {(r[1], r[2], r[3]) for r in _calls(ds["truth"], None)}
    germline = {v.pos + 1 for v in ds["variants"] if v.germline}
    called = {(r[1], r[2], r[3]) for n in names for r in _calls(os.path.join(out_dir, n))}
    leaked = {c for c in called if c[0] in germline}
    called -= leaked
    tp = len(truth & called)
    recall, precision = tp / max(len(truth), 1), tp / max(len(called), 1)
    log(f"[{tag}] PASS calls vs truth: recall {recall:.4f} precision {precision:.4f} "
        f"({len(truth)} true, {len(called)} called, {len(leaked)} more at germline sites)")
    if recall < 0.5 or precision < 0.5:
        raise AssertionError(f"{tag}: calls do not recover the simulated variants")
    return dict(recall=recall, precision=precision, germline_pass=len(leaked))


def _check_tabix(tag, out_dir, name, ctg, lo, hi):
    from clairs_to_tpu_torch.vcf.tabix import TabixReader

    gz = os.path.join(out_dir, name + ".gz")
    if not (os.path.exists(gz) and os.path.exists(gz + ".tbi")):
        raise AssertionError(f"{tag}: {name}.gz or its .tbi is missing")
    got = [l.split("\t")[:2] for l in TabixReader(gz).fetch(ctg, lo, hi)]
    want = [[r[0], str(r[1])] for r in _calls(os.path.join(out_dir, name), None)
            if r[0] == ctg and lo < r[1] <= hi]
    log(f"[{tag}] {name}.gz: TabixReader.fetch({ctg}:{lo}-{hi}) gave {len(got)} rows")
    if got != want:
        raise AssertionError(f"{tag}: tabix fetch of {name}.gz disagrees with the plain VCF")
    return len(got)


def phase_opt_out(card, ds, region):
    """Phase 4, the earlier slice's path: every post-calling stage opted out.
    The whole genome on the card (the wall that phase 5's is held against),
    then a region, the card against the CPU path."""
    extra = ("--model_dir", ASSETS, *OPT_OUT)
    out_dir = os.path.join(WORK, "optout_cuda")
    res = _counted_run("opt-out", card, ds, out_dir, extra=extra)
    res.update(_score("opt-out", ds, out_dir, ("snv.vcf", "indel.vcf")))
    gpu_dir, cpu_dir = os.path.join(WORK, "optout_cuda_region"), os.path.join(WORK, "optout_cpu")
    _run_cli(ds, gpu_dir, "cuda", extra=extra + ("-r", region))
    _run_cli(ds, cpu_dir, "cpu", extra=extra + ("-r", region))
    _same_calls(f"opt-out {region}", gpu_dir, cpu_dir)
    return res


def write_pon(ds, path, keep=0.75):
    """A panel of normals of most simulated germline sites, bgzipped and
    indexed with the port's own writer."""
    from clairs_to_tpu_torch.vcf.tabix import write_tabix_vcf

    rng = np.random.default_rng(11)
    germ = sorted((v.pos, v.ref, v.alt) for v in ds["variants"] if v.germline)
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for pos, ref, alt in germ:
            if rng.random() < keep:
                f.write(f"{ds['ctg']}\t{pos + 1}\t.\t{ref}\t{alt}\t.\t.\t.\n")
    write_tabix_vcf(path)
    return path + ".gz"


HAPLOTYPE_TAGS = ("LowAltBQ", "LowAltMQ", "ReadStartEnd", "VariantCluster", "NoAncestry",
                  "MultiHap", "StrandBias", "LowSeqEntropy")


def phase_default_ont(card, ds, genome_len, region):
    """Phase 5, this slice's path: ``run -p ont`` with no opt-out flag and a
    panel of normals, on the whole genome; then on a region, the card
    against the CPU path."""
    pon = write_pon(ds, os.path.join(WORK, "pon.vcf"))
    extra = ("--panel_of_normals", pon)
    out_dir = os.path.join(WORK, "default_cuda")
    res = _counted_run("default", card, ds, out_dir, extra=extra)
    stages, counters = res["stages"], res["counters"]
    for stage in ("hard_filters", "pon_tagging", "verdict", "tabix"):
        if stage not in stages:
            raise AssertionError(f"default: stage {stage} did not run")
    tagged, reads = counters.get("reads_haplotagged", 0), counters.get("reads_phasing_input", 0)
    log(f"[default] phasing: {counters.get('phasing_anchors', 0)} anchor sites, "
        f"{tagged} of {reads} reads haplotagged")
    if tagged <= 0:
        raise AssertionError("default: no read was haplotagged")
    rows = _calls(os.path.join(out_dir, "snv.vcf"), None)
    n_hap = sum(any(t in r[4].split(";") for t in HAPLOTYPE_TAGS) for r in rows)
    n_phaseable = sum(r[5].startswith("H;") or r[5] == "H" for r in rows)
    n_pon = sum("NonSomatic" in r[4] for r in rows)
    n_verdict = sum("Verdict_" in r[5] for r in rows)
    n_indel = len(_calls(os.path.join(out_dir, "indel.vcf"), None))
    log(f"[default] {len(rows)} SNV rows, {n_indel} indel rows: {n_hap} failed by the "
        f"haplotype filter, {n_phaseable} phaseable, {n_pon} tagged NonSomatic, "
        f"{n_verdict} tagged by Verdict")
    text = open(os.path.join(out_dir, "run_clairs_to_tpu_torch.log")).read()
    log("[default] " + re.findall(r"\[INFO\] (Verdict.*)", text)[-1])
    if not (rows and n_indel and n_hap and n_pon):
        raise AssertionError("default: rows, haplotype-filter tags or PoN tags are missing")
    res["tabix_rows"] = [_check_tabix("default", out_dir, name, ds["ctg"], genome_len // 4,
                                      genome_len // 2) for name in ("snv.vcf", "indel.vcf")]
    res.update(_score("default", ds, out_dir, ("snv.vcf", "indel.vcf")))
    res.update(rows_snv=len(rows), rows_indel=n_indel, haplotype_failed=n_hap,
               pon_tagged=n_pon, verdict_tagged=n_verdict)

    gpu_dir, cpu_dir = os.path.join(WORK, "default_cuda_region"), os.path.join(WORK, "default_cpu")
    wall, _n, summary = _run_cli(ds, gpu_dir, "cuda", extra=extra + ("-r", region))
    res.update(pon=pon, region=dict(wall_s=wall, stages=summary["stages"]))
    _run_cli(ds, cpu_dir, "cpu", extra=extra + ("-r", region))
    _same_calls(f"default {region}", gpu_dir, cpu_dir)
    return res


def phase_ilmn(card, genome_len):
    """Phase 6: ``run -p ilmn`` with its default flags (realignment, then the
    postfilter) on 150-base reads, the card against the CPU path."""
    from clairs_to_tpu_torch.bamio.simulate import make_dataset
    from clairs_to_tpu_torch.postcall import realignment

    t0 = time.time()
    ds = make_dataset(os.path.join(WORK, "data_ilmn"), seed=9, genome_len=genome_len,
                      coverage=50, n_snv=max(20, genome_len // 10_000), n_indel=0,
                      n_germline=max(10, genome_len // 10_000), **read_model("ilmn"))
    log(f"[ilmn] simulated {genome_len} bp Illumina at 50x in {time.time() - t0:.1f} s")
    calls = []
    real = realignment.realign_filter

    def counting(*a, **kw):
        calls.append(kw.get("window") is not None)
        return real(*a, **kw)

    realignment.realign_filter = counting
    try:
        gpu_dir, cpu_dir = os.path.join(WORK, "ilmn_cuda"), os.path.join(WORK, "ilmn_cpu")
        res = _counted_run("ilmn", card, ds, gpu_dir, platform="ilmn")
        _run_cli(ds, cpu_dir, "cpu", platform="ilmn")
    finally:
        realignment.realign_filter = real
    rows = _calls(os.path.join(gpu_dir, "snv.vcf"), None)
    n_sb = sum(";SB=" in r[5] for r in rows)
    n_re = sum("Realignment" in r[4] for r in rows)
    log(f"[ilmn] realign_filter called {len(calls)} times (with the window's reads: "
        f"{sum(calls)}); {len(rows)} SNV rows, {n_sb} through the postfilter, "
        f"{n_re} failed by realignment")
    if not (calls and all(calls) and rows and n_sb and "hard_filters" in res["stages"]):
        raise AssertionError("ilmn: realignment or the postfilter did not run")
    _same_calls("ilmn", gpu_dir, cpu_dir)
    _check_tabix("ilmn", gpu_dir, "snv.vcf", ds["ctg"], 0, genome_len)
    res.update(_score("ilmn", ds, gpu_dir, ("snv.vcf",)))
    res.update(rows_snv=len(rows), realign_failed=n_re)
    return res


def _http(url, payload=None, timeout=600):
    """(status, JSON body) of a GET, or of a POST of ``payload``."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def phase_serve(card, ds, region, batch):
    """Phase 7: the server on a thread of this process, engines preloaded,
    three requests with phase 5's flags over loopback HTTP.  ``batch`` is
    phase 5's result: its runs are what the answers must equal."""
    from clairs_to_tpu_torch import serve

    t0 = time.time()
    srv = serve.make_server("127.0.0.1", 0, preload="ont", device="cuda")
    preload_s = time.time() - t0
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    extra = ("--panel_of_normals", batch["pon"])
    plan = [("region", extra + ("-r", region), "default_cuda_region", batch["region"]),
            ("region again", extra + ("-r", region), "default_cuda_region", batch["region"]),
            ("genome", extra, "default_cuda", batch)]
    answers = []
    _zero_launches()
    try:
        for k, (what, flags, batch_dir, batch_run) in enumerate(plan):
            out_dir = os.path.join(WORK, f"serve_{k}")
            before = _launches()
            status, r = _http(base + "/v1/call", {"argv": _cli_args(ds, out_dir, "cuda",
                                                                      extra=flags)})
            launched, dw_launched = (n - b for n, b in zip(_launches(), before))
            if status != 200 or r.get("returncode") != 0:
                raise AssertionError(f"serve: request {k} ({what}) answered {status}: {r}")
            stages, counters = r["metrics"]["stages"], r["metrics"]["counters"]
            log(f"[serve] {card}: request {k} ({what}): {r['seconds']:.2f} s, engines_cached "
                f"{r['engines_cached']}, GRU launches {launched}, dwproj launches "
                f"{dw_launched}; the batch run took "
                f"{batch_run['wall_s']:.2f} s")
            log(f"[serve] request {k} stages {json.dumps(stages)}")
            log(f"[serve] batch run stages {json.dumps(batch_run['stages'])}")
            if not r["engines_cached"]:
                raise AssertionError(f"serve: request {k} did not find the preloaded engines")
            _check_dwproj(f"serve: request {k}", launched, dw_launched)
            counted = counters.get("gru_launches"), counters.get("dwproj_launches")
            if counted != (launched, dw_launched):
                raise AssertionError(f"serve: request {k} launched the kernels "
                                     f"{(launched, dw_launched)} times, its counters say "
                                     f"{counted}")
            if "load_engines" in stages:
                raise AssertionError(f"serve: request {k} loaded engines of its own")
            _same_calls(f"serve {what}", out_dir, os.path.join(WORK, batch_dir),
                        who=("the server", "the batch run"))
            answers.append(dict(what=what, seconds=r["seconds"], launches=launched,
                                dwproj_launches=dw_launched, stages=stages,
                                batch_wall_s=batch_run["wall_s"]))
        status, health = _http(base + "/health")
        if status != 200 or health["status"] != "ok" or len(health["engines"]) != 1:
            raise AssertionError(f"serve: /health says {health}")
        status, bad = _http(base + "/v1/call", {"argv": []})
        if status != 400:
            raise AssertionError(f"serve: an empty argv answered {status}: {bad}")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    launches, dw_launches = _launches()
    warm, cold = answers[1], batch["region"]
    load = cold["stages"].get("load_engines", 0.0) + cold["stages"].get("engine_warmup", 0.0)
    log(f"[serve] WARM_SAVING {card}: region as a batch run {cold['wall_s']:.2f} s "
        f"(load_engines + engine_warmup {load:.2f} s), as a warm request "
        f"{warm['seconds']:.2f} s; preload took {preload_s:.2f} s; /health lists "
        f"{health['engines']}")
    return dict(launches=launches, dwproj_launches=dw_launches, preload_s=preload_s,
                requests=answers)


def _verdict_line(text):
    lines = re.findall(r"\[INFO\] (Verdict: .*)", text)
    if not lines:
        raise AssertionError("no Verdict line in the run's output")
    return lines[-1]


def phase_two_process(card, ds, pon, n_candidates):
    """Phase 8: ranks 0 and 1 of one coordinator, both on cuda:0, against a
    single-process run with the same ``--chunk_num 4`` (which must find the
    ``n_candidates`` of the one-chunk run).  Every library an ONT run loads
    (the two forward kernels, the wire routine, the decoder and the verdict
    library) is deleted first (this process keeps its loaded copies), so
    both ranks build each of them at the same time."""
    import socket

    from clairs_to_tpu_torch.bamio import native
    from clairs_to_tpu_torch.ops import dwproj, gru, wire
    from clairs_to_tpu_torch.postcall import verdict_native

    extra = ("--panel_of_normals", pon, "--chunk_num", "4")
    one_dir, two_dir = os.path.join(WORK, "one_process"), os.path.join(WORK, "two_process")
    wall, n_cand, one = _run_cli(ds, one_dir, "cuda", extra=extra)
    log(f"[two-process] {card}: one process, 4 chunks: {n_cand} candidates in {wall:.2f} s")
    log(f"[two-process] one process stages {json.dumps(one['stages'])}")
    if n_cand != n_candidates:
        raise AssertionError(f"two-process: four chunks gave {n_cand} candidates, one chunk "
                             f"{n_candidates}")

    # what an ONT run loads
    built = [lib.so for lib in (gru.LIBS["gru"], dwproj.LIB, wire.LIB, native.LIB,
                                verdict_native.LIB)]
    for so in built:
        os.remove(so)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        addr = f"127.0.0.1:{s.getsockname()[1]}"
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    logs = [os.path.join(WORK, f"two_process_rank{rank}.log") for rank in (0, 1)]
    procs = []
    t0 = time.time()
    try:
        for rank, path in enumerate(logs):
            cmd = [sys.executable, "-m", "clairs_to_tpu_torch", "run",
                   *_cli_args(ds, two_dir, "cuda", extra=extra), "--coordinator_address", addr,
                   "--num_processes", "2", "--process_id", str(rank)]
            with open(path, "w") as f:
                procs.append(subprocess.Popen(cmd, cwd=REPO, env=env, stdout=f,
                                              stderr=subprocess.STDOUT))
        codes = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall2 = time.time() - t0
    texts = [open(path).read() for path in logs]
    if codes != [0, 0]:
        raise AssertionError(f"two-process: exit codes {codes}:\n{texts[0][-2000:]}\n"
                             f"{texts[1][-2000:]}")
    missing = [so for so in built if not os.path.exists(so)]
    if missing:
        raise AssertionError(f"two-process: the ranks did not rebuild {missing}")
    ranks = []
    for rank, text in enumerate(texts):
        summary = _summary(text)
        launches = summary["counters"].get("gru_launches", 0)
        dw_launches = summary["counters"].get("dwproj_launches", 0)
        log(f"[two-process] rank {rank}: {summary['counters']['candidates']} candidates, "
            f"GRU launches {launches}, dwproj launches {dw_launches}, stages "
            f"{json.dumps(summary['stages'])}")
        if f"Host {rank}/2: owns 2/4 chunks" not in text or launches <= 0:
            raise AssertionError(f"two-process: rank {rank} owned no chunks or never launched "
                                 f"the kernel:\n{text[-2000:]}")
        _check_dwproj(f"two-process: rank {rank}", launches, dw_launches)
        # the Python pileup that a rank falls back to when its C++ decoder
        # did not build or load is some fifty times slower
        decode, decode_one = (x["stages"]["decode_tensor_build(worker)"] for x in (summary, one))
        if decode > 30 + 10 * decode_one:
            raise AssertionError(f"two-process: rank {rank} decoded for {decode} s against "
                                 f"{decode_one} s in one process: no C++ decoder?")
        ranks.append(dict(launches=launches, dwproj_launches=dw_launches,
                          stages=summary["stages"],
                          candidates=summary["counters"]["candidates"]))
    if "SNV output" not in texts[0] or "SNV output" in texts[1] \
            or "host 0 merges the output" not in texts[1]:
        raise AssertionError("two-process: rank 1 must stop at the barrier and rank 0 write "
                             "the output")
    log(f"[two-process] {card}: two processes, 2 chunks each: {wall2:.2f} s wall, the build "
        f"of two kernels and three C++ libraries by both ranks included")
    _same_calls("two-process", two_dir, one_dir, who=("two processes", "one process"))
    v_two = _verdict_line(texts[0])
    v_one = _verdict_line(open(os.path.join(one_dir, "run_clairs_to_tpu_torch.log")).read())
    log(f"[two-process] Verdict, two processes: {v_two}")
    log(f"[two-process] Verdict, one process:   {v_one}")
    # rank 0 appends rank 1's allele counts after its own, so the loci reach
    # the segmentation out of genome order; the estimate may move in its
    # last digit (the JAX package's gather does the same)
    fit = re.compile(r"purity=([\d.]+) ploidy=([\d.]+) tagged=(\d+)")
    two, single = fit.search(v_two), fit.search(v_one)
    if not (two and single) or abs(float(two[1]) - float(single[1])) > 0.02 \
            or two.groups()[1:] != single.groups()[1:]:
        raise AssertionError(f"two-process: Verdict differs: {v_two!r} vs {v_one!r}")
    return dict(launches=sum(r["launches"] for r in ranks),
                dwproj_launches=sum(r["dwproj_launches"] for r in ranks), wall_s=wall2,
                ranks=ranks, one_process_wall_s=wall, verdict_same_line=v_two == v_one)


def phase_replicas(dev):
    """Phase 9: two replicas on the one card against one device, flagship
    weights, 8192 rows: each replica takes 4096 rows on its own copy of the
    networks, with its own pinned buffers and event."""
    from clairs_to_tpu_torch.infer.engine import InferenceEngine

    x_aff, x_neg, cov = _engine_batch()
    out, total, dw_total = {}, 0, 0
    for mode in ("snv", "indel"):
        aff, neg, lik, kw = _flagship(mode, dev)
        one = InferenceEngine(aff, neg, lik, device=dev, **kw)
        two = InferenceEngine(aff, neg, lik, devices=["cuda:0", "cuda:0"], **kw)
        want = one.run_batch(x_aff, x_neg, cov, cov)
        _zero_launches()
        got = two.run_batch(x_aff, x_neg, cov, cov)
        launched, dw_launched = _launches()
        err = max(np.abs(got.p_aff - want.p_aff).max(), np.abs(got.p_neg - want.p_neg).max())
        ms = {name: 1e3 * _wall(lambda e=e: e.run_batch(x_aff, x_neg, cov, cov), 3)
              for name, e in (("one_device", one), ("two_replicas", two))}
        log(f"[replicas] {mode}: 8192 rows as 2 x 4096 on cuda:0, GRU launches {launched}, "
            f"dwproj launches {dw_launched}, "
            f"max |p diff| {err:.3e}, run_batch ms one device {ms['one_device']:.2f} "
            f"two replicas {ms['two_replicas']:.2f}")
        if (launched, dw_launched) != (8, 2 * _projections(mode)):
            raise AssertionError(f"replicas {mode}: expected 8 GRU launches and "
                                 f"{2 * _projections(mode)} dwproj launches, got {launched} "
                                 f"and {dw_launched}")
        if err > REPLICA_TOL or not np.isfinite(got.posterior).all() \
                or got.posterior.shape != want.posterior.shape:
            raise AssertionError(f"replicas {mode}: two replicas disagree with one device "
                                 f"({err:.3e})")
        if not np.array_equal(got.forward_acgt, want.forward_acgt):
            raise AssertionError(f"replicas {mode}: strand counts differ")
        total += launched
        dw_total += dw_launched
        out[mode] = dict(max_abs_err=float(err), **{f"{k}_ms": v for k, v in ms.items()})
    out["launches"], out["dwproj_launches"] = total, dw_total
    return out


def _one_step(tr, batch, gen, use_kernel):
    tr.loss(*batch, generator=gen, use_kernel=use_kernel).backward()
    tr.apply_gradients()


def _timed_steps(tr, batch, gen, use_kernel=True, steps=20, warmup=3):
    """Median ms of each part of a training step over ``steps`` steps
    (CUDA events), the host wall per step, and the peak device memory.
    ``gen``: the dropout generator; ``use_kernel=False``: the BiGRU through
    the plain loop under autograd."""
    for _ in range(warmup):
        _one_step(tr, batch, gen, use_kernel)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events = [[torch.cuda.Event(enable_timing=True) for _ in range(4)] for _ in range(steps)]
    t0 = time.perf_counter()
    for ev in events:
        ev[0].record()
        loss = tr.loss(*batch, generator=gen, use_kernel=use_kernel)
        ev[1].record()
        loss.backward()
        ev[2].record()
        tr.apply_gradients()
        ev[3].record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    parts = ("forward_loss", "backward", "clip_adamw")
    out = {f"{name}_ms": statistics.median(ev[i].elapsed_time(ev[i + 1]) for ev in events)
           for i, name in enumerate(parts)}
    out.update(step_ms=statistics.median(ev[0].elapsed_time(ev[3]) for ev in events),
               wall_ms=wall_ms, peak_mib=torch.cuda.max_memory_allocated() / 2**20)
    return out


def _device_busy(tr, batch, gen, wall_ms, use_kernel=True, steps=5):
    """torch.profiler over ``steps`` training steps: the card's kernel time
    a step over ``wall_ms``, the host wall of one step timed without the
    profiler (its CPU-activity tracing stretches the wall it traces), the
    kernel launches a step, and the eight kernels with the most device time
    (ms and launches a step)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            _one_step(tr, batch, gen, use_kernel)
        torch.cuda.synchronize()
    profiled_ms = (time.perf_counter() - t0) * 1e3 / steps
    # device-side events, less the GPU ranges of user annotations (such as
    # "Optimizer.step#AdamW.step"), which overlap the kernels inside them
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return dict(device_ms_per_step=device_ms, wall_ms_per_step=wall_ms,
                device_busy=device_ms / wall_ms, profiled_wall_ms_per_step=profiled_ms,
                kernel_launches_per_step=sum(e.count for e in kernels) / steps,
                top_kernels=[(e.key[:80], e.self_device_time_total / 1e3 / steps,
                              e.count / steps) for e in top])


def phase_train(card, ds):
    """Phase 10: the training path at the flagship widths; ``ds`` is phase
    4's genome.  Returns its numbers, the GRU and depthwise projection
    launches of the training path (``train``'s steps and calibration
    forwards and (d)'s, counted from 0 before (c)) and those of the calling
    run (e), counted from 0 before it."""
    from clairs_to_tpu_torch.__main__ import SUBMODULES
    from clairs_to_tpu_torch.bench.grad_check import compare, step_grads, to_float64, train_batch
    from clairs_to_tpu_torch.models.checkpoint import load_checkpoint
    from clairs_to_tpu_torch.ops import dwproj, gru
    from clairs_to_tpu_torch.train import CAPTURE_WARMUP_STEPS, DualTrainer, TrainConfig

    res = {}
    # (a) one step, card against CPU, from the same weights; the card's step
    # against the same step through the plain loop on the card and against
    # a float64 step on the CPU
    tc = TrainConfig(dropout_rate=0.0)
    batch, (x, x_neg, cov) = train_batch(tc.batch_size, 5, "cuda")
    card_tr = DualTrainer("snv", tc, device="cuda")
    plain_tr = DualTrainer("snv", tc, device="cuda")
    cpu_tr = DualTrainer("snv", tc, device="cpu")
    f64_tr = DualTrainer("snv", tc, device="cpu")
    for tr in (plain_tr, cpu_tr, f64_tr):
        for net in ("aff", "neg"):
            tr.models[net].load_state_dict(card_tr.models[net].state_dict())
    to_float64(f64_tr)
    gru.gru_direction.launches = gru.gru_direction_backward.launches = 0
    dwproj.dwproj.launches = dwproj.dwproj_backward.launches = 0
    t0 = time.time()
    got = step_grads(card_tr, batch)
    t1 = time.time()
    res["step_launches"] = dict(gru_direction=gru.gru_direction.launches,
                                gru_direction_backward=gru.gru_direction_backward.launches)
    res["step_dwproj_launches"] = dict(dwproj=dwproj.dwproj.launches,
                                       dwproj_backward=dwproj.dwproj_backward.launches)
    want = step_grads(cpu_tr, [t.cpu() for t in batch])
    cpu_s = time.time() - t1
    gap = compare(got, want)
    log(f"[train] {card}: one flagship SNV step on {tc.batch_size} rows: loss cuda "
        f"{got[0]:.7f} cpu {want[0]:.7f} (rel {gap['loss_rel']:.2e}); grad global norm "
        f"cuda {got[1]:.7f} cpu {want[1]:.7f} (rel {gap['norm_rel']:.2e}); worst leaf "
        f"{gap['worst_leaf']} (|g| {gap['worst_leaf_norm']:.3e}) rel {gap['worst_leaf_rel']:.2e}; "
        f"largest share of the norm gap {gap['norm_gap_leaf']} ({gap['norm_gap_share']:.2f}); "
        f"the card's step took {t1 - t0:.1f} s (first, with cuDNN's planning), the CPU's "
        f"{cpu_s:.1f} s; GRU launches in the card's step {json.dumps(res['step_launches'])}")
    if max(gap["loss_rel"], gap["norm_rel"], gap["worst_leaf_rel"]) > TRAIN_TOL:
        raise AssertionError(f"train: the card's step disagrees with the CPU's ({gap})")
    if res["step_launches"] != dict(gru_direction=4, gru_direction_backward=4):
        raise AssertionError(f"train: a step launched the GRU kernels {res['step_launches']} "
                             f"times, not 4 and 4")
    projections = 2 * sum(card_tr.cvt_config.depths)
    if res["step_dwproj_launches"] != dict(dwproj=projections, dwproj_backward=projections):
        raise AssertionError(f"train: a step launched the dwproj kernels "
                             f"{res['step_dwproj_launches']} times, not {projections} each")
    res.update(gap, loss=got[0], grad_norm=got[1])
    plain = step_grads(plain_tr, batch, use_kernel=False)
    kp = compare(got, plain)
    log(f"[train] kernels vs plain loop under autograd, same batch and weights, on the card: "
        + json.dumps(kp))
    if kp["loss_rel"] > KERNEL_STEP_LOSS_TOL or kp["worst_leaf_rel"] > KERNEL_STEP_GRAD_TOL:
        raise AssertionError(f"train: the kernel step disagrees with the plain-loop step ({kp})")
    res["vs_plain_loop"] = kp
    t0 = time.time()
    f64 = step_grads(f64_tr, [t.cpu().double() if t.is_floating_point() else t.cpu()
                              for t in batch])
    res["vs_float64"] = {name: compare(s, f64) for name, s in
                         (("cuda_kernels", got), ("cuda_plain_loop", plain), ("cpu", want))}
    log(f"[train] against a float64 CPU step ({time.time() - t0:.1f} s): "
        + json.dumps(res["vs_float64"]))
    ref = res["vs_float64"]["cuda_kernels"]
    if max(ref["loss_rel"], ref["norm_rel"], ref["worst_leaf_rel"]) > TRAIN_TOL:
        raise AssertionError(f"train: the card's step strays from the float64 step ({ref})")
    # (b) the step's time and memory, dropout on as in training, in turns
    # with the plain-loop step: plain, kernels, kernels, plain; two
    # trainers on the card, as in the runs before the backward kernel
    del card_tr, plain_tr, cpu_tr, f64_tr
    timed = {True: DualTrainer("snv", TrainConfig(), device="cuda"),
             False: DualTrainer("snv", TrainConfig(), device="cuda")}
    gen = torch.Generator(device="cuda").manual_seed(1)
    turns = [(k, _timed_steps(timed[k], batch, gen, use_kernel=k))
             for k in (False, True, True, False)]
    for k, step in turns:
        log(f"[train] {card}: flagship SNV step at {tc.batch_size} rows through "
            f"{'the kernels' if k else 'the plain loop'} (median of 20, CUDA events): "
            + json.dumps(step))
    res["step_turns"] = [dict(kernels=k, **step) for k, step in turns]
    res["step"] = turns[1][1]
    res["plain_loop_step"] = turns[0][1]
    res["profile"] = _device_busy(timed[True], batch, gen, res["step"]["wall_ms"])
    log(f"[train] torch.profiler over 5 kernel steps: " + json.dumps(res["profile"]))
    res["plain_loop_profile"] = _device_busy(timed[False], batch, gen,
                                             res["plain_loop_step"]["wall_ms"], use_kernel=False)
    log(f"[train] torch.profiler over 5 plain-loop steps: "
        + json.dumps(res["plain_loop_profile"]))
    del timed
    # (c) the subcommand, both modes, into run's --model_dir layout
    model_dir = os.path.join(WORK, "trained")
    res["cli_wall_s"] = {}
    gru.gru_direction.launches = gru.gru_direction_backward.launches = 0
    dwproj.dwproj.launches = dwproj.dwproj_backward.launches = 0
    for mode, sub in (("snv", ""), ("indel", "indel")):
        t0 = time.time()
        rc = SUBMODULES["train"](["--output_dir", os.path.join(model_dir, sub), "--mode", mode,
                                  "--dual_view", "--platform", "ont", "--n_train", "1280",
                                  "--epochs", "2"])
        res["cli_wall_s"][mode] = time.time() - t0
        if rc != 0:
            raise AssertionError(f"train --mode {mode} exited {rc}")
        log(f"[train] {card}: train --mode {mode} --dual_view --n_train 1280 --epochs 2 took "
            f"{res['cli_wall_s'][mode]:.2f} s")
    # (d) its SNV networks with the kernel against the plain GRU
    tr = DualTrainer("snv", device="cuda")
    for net, name in (("aff", "aff.npz"), ("neg", "neg.npz")):
        load_checkpoint(os.path.join(model_dir, name), tr.models[net])
    kern = tr.predict_probs(x, rescale_cov=cov, x_neg=x_neg)
    res["launches"] = gru.gru_direction.launches
    res["bwd_launches"] = gru.gru_direction_backward.launches
    res["dwproj_launches"] = dwproj.dwproj.launches
    res["dwproj_bwd_launches"] = dwproj.dwproj_backward.launches
    plain = tr.predict_probs(x, rescale_cov=cov, x_neg=x_neg, use_kernel=False)
    err = max(float(np.abs(a - b).max()) for a, b in zip(kern, plain))
    log(f"[train] predict_probs on {len(x)} rows: kernel vs plain GRU max |p diff| {err:.3e}")
    if err > ENGINE_TOL or not all(np.isfinite(a).all() for a in kern):
        raise AssertionError(f"train: predict_probs with the kernel disagrees ({err:.3e})")
    res["predict_max_abs_err"] = err
    # 4 launches of each kernel a training step (two bidirectional layers),
    # counted as the host launches them: each mode's fit captures its step
    # once, after CAPTURE_WARMUP_STEPS eager steps, and its replays launch
    # nothing from the host; 2 modes; 4 forward launches a NEG forward, one
    # forward per 512 rows: train's calibration forwards 3000 rows a mode,
    # (d) 800.  The CvT's forward and backward launch dwproj once a
    # projection where the BiGRU launches each GRU kernel 4 times; (d)
    # predicts with the SNV pair
    steps = CAPTURE_WARMUP_STEPS + 1
    calib = -(-3000 // 512)
    predict = -(-len(x) // 512)
    want = (4 * (2 * steps + 2 * calib + predict), 4 * 2 * steps)
    log(f"[train] launches_by_path[\"train\"] = {res['launches']} forward, "
        f"{res['bwd_launches']} backward (expected {want[0]}, {want[1]})")
    if (res["launches"], res["bwd_launches"]) != want:
        raise AssertionError(f"train: {res['launches']} and {res['bwd_launches']} GRU "
                             f"launches, expected {want}")
    both = _projections("snv") + _projections("indel")
    want = ((steps + calib) * both + predict * _projections("snv"), steps * both)
    got = (res["dwproj_launches"], res["dwproj_bwd_launches"])
    log(f"[train] dwproj launches of the train path: {got[0]} forward, {got[1]} backward "
        f"(expected {want[0]}, {want[1]})")
    if got != want:
        raise AssertionError(f"train: {got[0]} and {got[1]} dwproj launches, expected {want}")
    # (e) call with the trained networks
    out_dir = os.path.join(WORK, "trained_run")
    _zero_launches()
    wall, n_cand, summary = _run_cli(ds, out_dir, "cuda", extra=("--model_dir", model_dir,
                                                                 *OPT_OUT))
    res["run_launches"], res["run_dwproj_launches"] = _launches()
    _check_dwproj("train: run --model_dir", res["run_launches"], res["run_dwproj_launches"])
    for name in ("snv.vcf", "indel.vcf"):
        if not os.path.exists(os.path.join(out_dir, name)):
            raise AssertionError(f"train: run --model_dir wrote no {name}")
    rows = {n: len(_calls(os.path.join(out_dir, n), None)) for n in ("snv.vcf", "indel.vcf")}
    log(f"[train] run --model_dir with the trained networks: {n_cand} candidates in "
        f"{wall:.2f} s, rows {json.dumps(rows)}, GRU launches {res['run_launches']}, dwproj "
        f"launches {res['run_dwproj_launches']}")
    res.update(run_wall_s=wall, run_rows=rows)
    return res


def _dump_lines(text, ctg, lo, hi):
    """The lines of an --alt_fn dump at ``ctg``:``lo``+1..``hi`` (1-based)."""
    return "".join(l for l in text.splitlines(keepends=True)
                   if l.split("\t")[0] == ctg and lo < int(l.split("\t")[1]) <= hi)


def phase_run_paths(card, contig_len=RUN_PATHS_CONTIG, chunk_size=RUN_PATHS_CHUNK):
    """Phase 11: ``run`` on a three-contig ONT genome with ``-c chr1,chr3``,
    a BED and the ``--alt_fn`` dump (depth and alt info) on the card, then
    the same with ``--device cpu``: the same rows and the same dump.  Then,
    on the card, one chunk's shards deleted and the first command again with
    ``--resume``: only that chunk is called again, its dump lines are
    appended, and the rows are the first run's."""
    from clairs_to_tpu_torch.bamio.simulate import make_multi_contig_dataset
    from clairs_to_tpu_torch.genome.chunks import chunk_contig

    t0 = time.time()
    ds = make_multi_contig_dataset(
        os.path.join(WORK, "data_multi"), n_contigs=3, seed=13, genome_len=contig_len,
        coverage=COVERAGE, n_snv=max(5, contig_len // 10_000),
        n_indel=max(2, contig_len // 20_000), n_germline=contig_len // 300,
        read_length=read_model("ont")["read_length"], error_rate=read_model("ont")["error_rate"])
    log(f"[run-paths] simulated 3 x {contig_len} bp ONT at {COVERAGE}x in "
        f"{time.time() - t0:.1f} s")
    bed_intervals = [("chr1", 0, contig_len * 3 // 5), ("chr2", 0, contig_len),
                     ("chr3", contig_len * 3 // 10, contig_len)]
    bed = os.path.join(WORK, "run_paths.bed")
    with open(bed, "w") as f:
        f.writelines(f"{c}\t{lo}\t{hi}\n" for c, lo, hi in bed_intervals)

    def flags(alt_fn):
        return ("-c", "chr1,chr3", "-b", bed, "--chunk_size", str(chunk_size), "--alt_fn",
                alt_fn, "--output_depth", "true", "--output_alt_info", "true")

    gpu_dir, cpu_dir = os.path.join(WORK, "run_paths_cuda"), os.path.join(WORK, "run_paths_cpu")
    first_dir = os.path.join(WORK, "run_paths_cuda_first")
    alt_gpu, alt_cpu = gpu_dir + ".alt.tsv", cpu_dir + ".alt.tsv"
    res = _counted_run("run-paths", card, ds, gpu_dir, extra=flags(alt_gpu))
    log(f"[run-paths] {card}: " + json.dumps(dict(
        wall_s=res["wall_s"], candidates=res["candidates"], cand_per_s=res["cand_per_s"],
        launches=res["launches"], stages=res["stages"])))
    os.makedirs(first_dir)
    for name in ("snv.vcf", "indel.vcf"):
        shutil.copy(os.path.join(gpu_dir, name), first_dir)
    rows = [r for n in ("snv.vcf", "indel.vcf") for r in _calls(os.path.join(gpu_dir, n), None)]
    inside = all(any(r[0] == c and lo < r[1] <= hi for c, lo, hi in bed_intervals) for r in rows)
    if not rows or {r[0] for r in rows} != {"chr1", "chr3"} or not inside:
        raise AssertionError("run-paths: rows outside chr1 and chr3 or outside the BED, or none")
    truth = {(r[0], r[1], r[2], r[3]) for r in _calls(ds["truth"], None)
             if r[0] != "chr2" and any(r[0] == c and lo < r[1] <= hi for c, lo, hi in bed_intervals)}
    called = {r[:4] for n in ("snv.vcf", "indel.vcf") for r in _calls(os.path.join(gpu_dir, n))}
    recall = len(truth & called) / max(len(truth), 1)
    log(f"[run-paths] PASS calls vs truth in the BED: recall {recall:.4f} "
        f"({len(truth)} true, {len(called)} PASS)")
    if recall < 0.5:
        raise AssertionError("run-paths: calls do not recover the simulated variants")
    dump = open(alt_gpu).read()

    # resume: chr3's last chunk called again, on the card
    chunks = chunk_contig("chr3", contig_len, chunk_size)
    last = chunks[-1]
    for kind in ("snv", "indel"):
        os.remove(os.path.join(gpu_dir, "tmp", "vcf_output",
                               f"p_{kind}_chr3_{last.chunk_id}.vcf"))
    again = _counted_run("run-paths resume", card, ds, gpu_dir, extra=flags(alt_gpu) + (
        "--resume",))
    text = open(os.path.join(gpu_dir, "run_clairs_to_tpu_torch.log")).read()
    resumed = text.count("resumed from existing output")
    n_chunks = 2 * len(chunks)
    log(f"[run-paths] --resume: {resumed} of {n_chunks} chunks resumed, "
        f"{again['candidates']} candidates called again in {again['wall_s']:.2f} s")
    if resumed != n_chunks - 1 or again["candidates"] <= 0:
        raise AssertionError(f"run-paths: --resume resumed {resumed} chunks, not {n_chunks - 1}")
    if open(alt_gpu).read() != dump + _dump_lines(dump, "chr3", last.ctg_start, last.ctg_end):
        raise AssertionError("run-paths: --resume did not append the redone chunk's dump lines")
    _same_calls("run-paths resume", gpu_dir, first_dir, who=("the resumed run", "the first run"))

    # the CPU path on the first run's command
    cpu = _run_cli(ds, cpu_dir, "cpu", extra=flags(alt_cpu))
    _same_calls("run-paths", first_dir, cpu_dir)
    if open(alt_cpu).read() != dump or not dump:
        raise AssertionError("run-paths: the --alt_fn dumps of the card and the CPU differ")
    log(f"[run-paths] --alt_fn dumps identical on cuda and cpu: {dump.count(chr(10))} lines; "
        f"the CPU run took {cpu[0]:.2f} s")
    return dict(launches=res["launches"] + again["launches"],
                dwproj_launches=res["dwproj_launches"] + again["dwproj_launches"], first=res,
                resumed=dict(chunks=resumed, wall_s=again["wall_s"],
                             candidates=again["candidates"], launches=again["launches"],
                             stages=again["stages"]),
                recall=recall, dump_lines=dump.count("\n"), cpu_wall_s=cpu[0])


def phase_end_to_end(card, genome_len, ilmn_len):
    """Phases 4 to 8 on one simulated ONT genome and one Illumina genome."""
    from clairs_to_tpu_torch import realign
    from clairs_to_tpu_torch.bamio import native
    from clairs_to_tpu_torch.bamio.simulate import make_dataset
    from clairs_to_tpu_torch.postcall import verdict_native

    # the three C++ libraries build here with g++; none may fall back to numpy
    t0 = time.time()
    libs = dict(pileup_native=native.available(), verdict_native=verdict_native.available(),
                realign_native=realign.available())
    log(f"[libs] built and loaded in {time.time() - t0:.1f} s: {json.dumps(libs)}")
    if not all(libs.values()):
        raise AssertionError(f"a C++ library is not available: {libs}")

    # germline sites every 300 bases under 500-base reads: reads link them,
    # so the phaser has real work
    t0 = time.time()
    ds = make_dataset(os.path.join(WORK, "data"), seed=7, genome_len=genome_len,
                      coverage=COVERAGE, n_snv=max(20, genome_len // 20_000),
                      n_indel=max(10, genome_len // 40_000), n_germline=genome_len // 300,
                      somatic_hap_aware=True, **read_model("ont"))
    log(f"[e2e] simulated {genome_len} bp ONT at {COVERAGE}x in {time.time() - t0:.1f} s")
    region = f"{ds['ctg']}:1-{min(genome_len, 200_000)}"
    res = dict(genome_len=genome_len,
               opt_out=phase_opt_out(card, ds, region),
               default_ont=phase_default_ont(card, ds, genome_len, region),
               ilmn=phase_ilmn(card, ilmn_len))
    res["serve"] = phase_serve(card, ds, region, res["default_ont"])
    res["two_process"] = phase_two_process(card, ds, res["default_ont"]["pon"],
                                           res["default_ont"]["candidates"])
    res["dataset"] = ds   # for phase 10; not printed
    return res


def main(argv=None):
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device; this script runs only on a GPU\n")
        return 2
    try:
        from clairs_to_tpu_torch.ops import gru
    except ImportError as e:
        sys.stderr.write(f"chip_smoke: the clairs_to_tpu_torch package is missing ({e})\n")
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    t_start = time.time()
    card = card_line()
    log(f"[card] {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    phase_build(gru)
    max_err, timings = phase_kernel(gru, dev)
    bwd_err, bwd_timings = phase_backward(gru, dev)
    dw = phase_dwproj(dev)
    engine = phase_engine(dev)
    e2e = phase_end_to_end(card, GENOME_LEN, ILMN_GENOME_LEN)
    e2e["replicas"] = phase_replicas(dev)
    e2e["train"] = phase_train(card, e2e.pop("dataset"))
    e2e["run_paths"] = phase_run_paths(card)
    log(f"[done] {time.time() - t_start:.1f} s; " + json.dumps(dict(engine=engine, e2e=e2e)))

    t = timings[192]
    kernels = [dict(
        name="gru_direction", route="cuda", source="clairs_to_tpu_torch/csrc/gru.cu",
        replaces="clairs_to_tpu/ops/gru_pallas.py:61",
        launches=e2e["default_ont"]["launches"],
        launches_by_path=dict({k: e2e[k]["launches"] for k in (
            "opt_out", "default_ont", "ilmn", "serve", "two_process", "replicas", "train",
            "run_paths")},
            train_run=e2e["train"]["run_launches"]),
        max_abs_err=max_err, ms=t["kernel_ms"], plain_ms=t["plain_ms"],
        bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=t["library_ms"],
        bound_fp32_ms=t["bound_fp32_ms"], shape=f"T={T} B=8192 H=192",
        h128=timings[128],
    )]
    tb = bwd_timings[192, 800]
    kernels.append(dict(
        name="gru_direction_backward", route="cuda", source="clairs_to_tpu_torch/csrc/gru_bwd.cu",
        replaces="backward of clairs_to_tpu/ops/gru_pallas.py:61 (JAX differentiates "
                 "models/bigru.py:41's lax.scan)",
        launches=e2e["train"]["bwd_launches"],
        launches_by_path=dict(train=e2e["train"]["bwd_launches"],
                              train_step=e2e["train"]["step_launches"]["gru_direction_backward"]),
        max_abs_err=bwd_err["max_abs_err"], max_rel_err=bwd_err["max_rel_err"],
        ms=tb["kernel_ms"], wrapper_ms=tb["wrapper_ms"], plain_ms=tb["plain_ms"],
        bound_ms=tb["bound_ms"], bound_by=tb["bound_by"], bound_rate=tb["bound_rate"],
        library_ms=tb["library_ms"], shape=f"T={T} B=800 H=192",
        other_shapes={f"H={h} B={b}": v for (h, b), v in bwd_timings.items() if (h, b) != (192, 800)},
        geometry=tb["geometry"],
    ))
    step, batch = dw[800]["totals"], dw[8192]["totals"]
    kernels.append(dict(
        name="dwproj", route="cuda", source="clairs_to_tpu_torch/csrc/dwproj.cu",
        replaces="none (the JAX package leaves the CvT's depthwise conv to XLA)",
        launches=e2e["default_ont"]["dwproj_launches"],
        launches_by_path=dict(
            {k: e2e[k]["dwproj_launches"] for k in (
                "opt_out", "default_ont", "ilmn", "serve", "two_process", "replicas", "train",
                "run_paths")},
            engine_snv=engine["snv"]["dwproj_launches"],
            engine_indel=engine["indel"]["dwproj_launches"],
            train_backward=e2e["train"]["dwproj_bwd_launches"],
            train_step=e2e["train"]["step_dwproj_launches"]["dwproj"],
            train_step_backward=e2e["train"]["step_dwproj_launches"]["dwproj_backward"],
            train_run=e2e["train"]["run_dwproj_launches"]),
        max_rel_err=dw["max_rel_err"],
        shape="the SNV CvT's 26 projections, B=800 (a step) and B=8192 (an engine batch)",
        step_ms={k: step[k] for k in ("kernel_fwd_bwd_ms", "plain_fwd_bwd_ms",
                                      "library_fwd_bwd_ms")},
        step_bound_ms=step["bound_fwd_ms"] + step["bound_bwd_ms"],
        batch_fwd_ms={k: batch[k] for k in ("kernel_fwd_ms", "plain_fwd_ms", "library_fwd_ms")},
        batch_bound_fwd_ms=batch["bound_fwd_ms"],
    ))
    for k in kernels:
        if min(k["launches_by_path"].values()) <= 0:
            raise AssertionError(f"a path never launched {k['name']}: {k['launches_by_path']}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
