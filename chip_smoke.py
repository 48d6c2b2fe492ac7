"""Smoke run of the PyTorch/CUDA port (clairs_to_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--prev-source OLD_GRU_CU]

Phases, each fatal on failure:
  1. build the GRU kernel (csrc/gru.cu) from the checkout with nvcc;
  2. hold the kernel against its plain PyTorch version on the card
     (H in {16, 24, 128, 192}, B in {8192, 8191, 1000}, both directions) and
     time it, with x_gates cold in L2, beside the plain version and cuDNN's
     torch.nn.GRU (a yardstick only).
     With --prev-source, an earlier gru.cu (the same C entry point, taking
     W_hh^T unpacked) is built beside it and the two are timed in turns:
     old, new, new, old;
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
     ``--chunk_num 4``, started with the kernel and the two C++ libraries of
     an ONT run deleted, so both build them at once.  Both must own chunks and launch
     the kernel, only rank 0 may write the output, and the output must equal
     a single-process run's;
  9. replicas on the one card: an engine with ``devices=[cuda:0, cuda:0]``
     against the one-device engine at 8192 rows (8 launches a forward
     instead of 4, the split, the per-part events);
 10. training at the flagship widths: (a) one step of the SNV pair on 800
     dual-view rows at dropout 0 from the same weights on the card and on
     the CPU path, loss, gradient global norm and every gradient leaf
     (‖g - w‖ / ‖w‖) within 1e-4 relative, the worst leaf named;
     (b) twenty steps timed with CUDA events, split into forward + loss,
     backward and clip + AdamW, with the peak device memory, then five
     under torch.profiler for the device's busy share of the unprofiled
     wall; (c) ``train --dual_view --platform ont`` for ``--mode snv`` and
     ``--mode indel`` into the layout ``run --model_dir`` reads; (d) its
     networks' ``predict_probs`` with the kernel against the plain GRU,
     within 5e-5; (c) and (d) must launch the kernel exactly as often as
     their row counts say (path ``train``); (e) ``run --model_dir`` with
     those networks on phase 4's genome and flags (path ``train_run``).
Each path's GRU launches are counted from 0 just before it.  Prints the card's name and power
limit, a ``kernels`` JSON line, and as the last line ``{"ok": true,
"device": {...}}``.  Exits non-zero without a GPU.  Working files go under
build/chip_smoke/ in the checkout.
"""

import argparse
import ctypes
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
ENGINE_TOL = 5e-5     # class-1 probabilities, kernel engine vs plain-GRU engine
REPLICA_TOL = 5e-5    # class-1 probabilities, two replicas vs one device
TRAIN_TOL = 1e-4      # relative: loss and gradient global norm, card vs CPU step
GENOME_LEN = 2_000_000
ILMN_GENOME_LEN = 300_000
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


def start_prev_build(src):
    """Start nvcc on an earlier gru.cu; returns (process, library path)."""
    from clairs_to_tpu_torch.ops import gru

    so = os.path.join(WORK, "libgru_prev.so")
    cmd = [gru._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-o", so, os.path.abspath(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so


def load_prev(build):
    """The earlier kernel as a function of (x_gates, w_hh_t, b_hh)."""
    proc, so = build
    diag, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the previous gru.cu:\n{diag}")
    fn = ctypes.CDLL(so).gru_direction_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]

    def run(xg, w, b):
        steps, B, _ = xg.shape
        out = torch.empty((steps, B, w.shape[0]), dtype=torch.float32, device=xg.device)
        err = fn(xg.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), steps, B,
                 w.shape[0], 0, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"previous gru kernel launch failed: cudaError {err}")
        return out
    return run


def phase_build(gru):
    t0 = time.time()
    diag = gru.build(verbose=True)
    log(f"[build] gru.cu built and loaded in {time.time() - t0:.2f} s")
    for line in diag.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"[build] {line.strip()}")


def phase_kernel(gru, dev, prev=None):
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
                if prev is not None:
                    err = (prev(xg, w, b) - gru.gru_direction(xg, w, b)).abs().max().item()
                    if err > KERNEL_TOL:
                        raise AssertionError(f"previous kernel disagrees at H={H} ({err:.3e})")
                    turns = [cold_ms(lambda: prev(xg, w, b)),
                             cold_ms(lambda: gru.gru_direction(xg, w, b)),
                             cold_ms(lambda: gru.gru_direction(xg, w, b)),
                             cold_ms(lambda: prev(xg, w, b))]
                    t["turns_old_new_new_old_ms"] = turns
                    t["prev_ms"] = (turns[0] + turns[3]) / 2
                    t["kernel_ms"] = (turns[1] + turns[2]) / 2
                t.update(gru_bound_ms(B, H))
                timings[H] = t
                log(f"[kernel] timing T={T} B={B} H={H}: " + json.dumps(t))
    return max_err, timings


def _flagship(mode, dev):
    """(aff, neg, likelihood, engine keywords) of the flagship ONT weights."""
    from clairs_to_tpu_torch.models.checkpoint import load_checkpoint_auto
    from clairs_to_tpu_torch.ops.posterior import load_likelihood_matrix

    sub, n_al = ("", 4) if mode == "snv" else ("indel", 6)
    aff, cc = load_checkpoint_auto(os.path.join(ASSETS, sub, "aff.npz"), mode, "cvt", dev)
    neg, gc = load_checkpoint_auto(os.path.join(ASSETS, sub, "neg.npz"), mode, "bigru", dev)
    lik = load_likelihood_matrix(os.path.join(ASSETS, sub, "likelihood_matrix.txt"), n_al)
    return aff, neg, lik, dict(mode=mode, device_batch=8192, cvt_config=cc, bigru_config=gc)


def _engine_batch(n=8192):
    rng = np.random.default_rng(1)
    x_aff = rng.integers(-30, 31, size=(n, 33, 34)).astype(np.int16)
    x_neg = (x_aff + rng.integers(-2, 3, size=x_aff.shape)).astype(np.int16)
    cov = rng.integers(10, 120, size=n).astype(np.float32)
    return x_aff, x_neg, cov


def phase_engine(dev):
    from clairs_to_tpu_torch.infer.engine import InferenceEngine
    from clairs_to_tpu_torch.ops import gru

    x_aff, x_neg, cov = _engine_batch()
    out = {}
    for mode in ("snv", "indel"):
        aff, neg, lik, kw = _flagship(mode, dev)
        kern = InferenceEngine(aff, neg, lik, device=dev, **kw)
        plain = InferenceEngine(aff, neg, lik, use_kernel=False, device=dev, **kw)
        before = gru.gru_direction.launches
        a = kern.run_batch(x_aff, x_neg, cov, cov)
        launched = gru.gru_direction.launches - before
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
        out[mode] = dict(max_abs_err=float(err), **{f"{k}_ms": v for k, v in forward_ms.items()})
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


def _counted_run(tag, card, ds, out_dir, platform="ont", extra=()):
    """A run on the card with the kernel's launches counted from 0."""
    from clairs_to_tpu_torch.ops import gru

    gru.gru_direction.launches = 0
    wall, n_cand, summary = _run_cli(ds, out_dir, "cuda", platform, extra)
    launches = gru.gru_direction.launches
    log(f"[{tag}] {card}: {n_cand} candidates in {wall:.2f} s wall = {n_cand / wall:.1f} "
        f"cand/s; GRU launches {launches}")
    log(f"[{tag}] stages {json.dumps(summary['stages'])}")
    log(f"[{tag}] counters {json.dumps(summary['counters'])}")
    if launches <= 0:
        raise AssertionError(f"{tag}: the run never launched the GRU kernel")
    if summary["counters"].get("gru_launches") != launches:
        raise AssertionError(f"{tag}: the run's gru_launches counter is not the wrapper's count")
    return dict(candidates=n_cand, wall_s=wall, cand_per_s=n_cand / wall, launches=launches,
                stages=summary["stages"], counters=summary["counters"])


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
    from clairs_to_tpu_torch.ops import gru

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
    gru.gru_direction.launches = 0
    try:
        for k, (what, flags, batch_dir, batch_run) in enumerate(plan):
            out_dir = os.path.join(WORK, f"serve_{k}")
            before = gru.gru_direction.launches
            status, r = _http(base + "/v1/call", {"argv": _cli_args(ds, out_dir, "cuda",
                                                                      extra=flags)})
            launched = gru.gru_direction.launches - before
            if status != 200 or r.get("returncode") != 0:
                raise AssertionError(f"serve: request {k} ({what}) answered {status}: {r}")
            stages, counters = r["metrics"]["stages"], r["metrics"]["counters"]
            log(f"[serve] {card}: request {k} ({what}): {r['seconds']:.2f} s, engines_cached "
                f"{r['engines_cached']}, GRU launches {launched}; the batch run took "
                f"{batch_run['wall_s']:.2f} s")
            log(f"[serve] request {k} stages {json.dumps(stages)}")
            log(f"[serve] batch run stages {json.dumps(batch_run['stages'])}")
            if not r["engines_cached"]:
                raise AssertionError(f"serve: request {k} did not find the preloaded engines")
            if launched <= 0 or counters.get("gru_launches") != launched:
                raise AssertionError(f"serve: request {k} launched the kernel {launched} times, "
                                     f"its counter says {counters.get('gru_launches')}")
            if "load_engines" in stages:
                raise AssertionError(f"serve: request {k} loaded engines of its own")
            _same_calls(f"serve {what}", out_dir, os.path.join(WORK, batch_dir),
                        who=("the server", "the batch run"))
            answers.append(dict(what=what, seconds=r["seconds"], launches=launched,
                                stages=stages, batch_wall_s=batch_run["wall_s"]))
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
    launches = gru.gru_direction.launches
    warm, cold = answers[1], batch["region"]
    load = cold["stages"].get("load_engines", 0.0) + cold["stages"].get("engine_warmup", 0.0)
    log(f"[serve] WARM_SAVING {card}: region as a batch run {cold['wall_s']:.2f} s "
        f"(load_engines + engine_warmup {load:.2f} s), as a warm request "
        f"{warm['seconds']:.2f} s; preload took {preload_s:.2f} s; /health lists "
        f"{health['engines']}")
    return dict(launches=launches, preload_s=preload_s, requests=answers)


def _verdict_line(text):
    lines = re.findall(r"\[INFO\] (Verdict: .*)", text)
    if not lines:
        raise AssertionError("no Verdict line in the run's output")
    return lines[-1]


def phase_two_process(card, ds, pon, n_candidates):
    """Phase 8: ranks 0 and 1 of one coordinator, both on cuda:0, against a
    single-process run with the same ``--chunk_num 4`` (which must find the
    ``n_candidates`` of the one-chunk run).  The kernel and the
    two C++ libraries an ONT run loads are deleted first (this process keeps
    its loaded copies),
    so both ranks build each of them at the same time."""
    import socket

    from clairs_to_tpu_torch.bamio import native
    from clairs_to_tpu_torch.ops import gru
    from clairs_to_tpu_torch.postcall import verdict_native

    extra = ("--panel_of_normals", pon, "--chunk_num", "4")
    one_dir, two_dir = os.path.join(WORK, "one_process"), os.path.join(WORK, "two_process")
    wall, n_cand, one = _run_cli(ds, one_dir, "cuda", extra=extra)
    log(f"[two-process] {card}: one process, 4 chunks: {n_cand} candidates in {wall:.2f} s")
    log(f"[two-process] one process stages {json.dumps(one['stages'])}")
    if n_cand != n_candidates:
        raise AssertionError(f"two-process: four chunks gave {n_cand} candidates, one chunk "
                             f"{n_candidates}")

    built = [gru._SO, native._SO, verdict_native._SO]   # what an ONT run loads
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
        log(f"[two-process] rank {rank}: {summary['counters']['candidates']} candidates, "
            f"GRU launches {launches}, stages {json.dumps(summary['stages'])}")
        if f"Host {rank}/2: owns 2/4 chunks" not in text or launches <= 0:
            raise AssertionError(f"two-process: rank {rank} owned no chunks or never launched "
                                 f"the kernel:\n{text[-2000:]}")
        # the Python pileup that a rank falls back to when its C++ decoder
        # did not build or load is some fifty times slower
        decode, decode_one = (x["stages"]["decode_tensor_build(worker)"] for x in (summary, one))
        if decode > 30 + 10 * decode_one:
            raise AssertionError(f"two-process: rank {rank} decoded for {decode} s against "
                                 f"{decode_one} s in one process: no C++ decoder?")
        ranks.append(dict(launches=launches, stages=summary["stages"],
                          candidates=summary["counters"]["candidates"]))
    if "SNV output" not in texts[0] or "SNV output" in texts[1] \
            or "host 0 merges the output" not in texts[1]:
        raise AssertionError("two-process: rank 1 must stop at the barrier and rank 0 write "
                             "the output")
    log(f"[two-process] {card}: two processes, 2 chunks each: {wall2:.2f} s wall, the build "
        f"of the kernel and two C++ libraries by both ranks included")
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
    return dict(launches=sum(r["launches"] for r in ranks), wall_s=wall2, ranks=ranks,
                one_process_wall_s=wall, verdict_same_line=v_two == v_one)


def phase_replicas(dev):
    """Phase 9: two replicas on the one card against one device, flagship
    weights, 8192 rows: each replica takes 4096 rows on its own copy of the
    networks, with its own pinned buffers and event."""
    from clairs_to_tpu_torch.infer.engine import InferenceEngine
    from clairs_to_tpu_torch.ops import gru

    x_aff, x_neg, cov = _engine_batch()
    out, total = {}, 0
    for mode in ("snv", "indel"):
        aff, neg, lik, kw = _flagship(mode, dev)
        one = InferenceEngine(aff, neg, lik, device=dev, **kw)
        two = InferenceEngine(aff, neg, lik, devices=["cuda:0", "cuda:0"], **kw)
        want = one.run_batch(x_aff, x_neg, cov, cov)
        gru.gru_direction.launches = 0
        got = two.run_batch(x_aff, x_neg, cov, cov)
        launched = gru.gru_direction.launches
        err = max(np.abs(got.p_aff - want.p_aff).max(), np.abs(got.p_neg - want.p_neg).max())
        ms = {name: 1e3 * _wall(lambda e=e: e.run_batch(x_aff, x_neg, cov, cov), 3)
              for name, e in (("one_device", one), ("two_replicas", two))}
        log(f"[replicas] {mode}: 8192 rows as 2 x 4096 on cuda:0, GRU launches {launched}, "
            f"max |p diff| {err:.3e}, run_batch ms one device {ms['one_device']:.2f} "
            f"two replicas {ms['two_replicas']:.2f}")
        if launched != 8:
            raise AssertionError(f"replicas {mode}: expected 8 GRU launches, got {launched}")
        if err > REPLICA_TOL or not np.isfinite(got.posterior).all() \
                or got.posterior.shape != want.posterior.shape:
            raise AssertionError(f"replicas {mode}: two replicas disagree with one device "
                                 f"({err:.3e})")
        if not np.array_equal(got.forward_acgt, want.forward_acgt):
            raise AssertionError(f"replicas {mode}: strand counts differ")
        total += launched
        out[mode] = dict(max_abs_err=float(err), **{f"{k}_ms": v for k, v in ms.items()})
    out["launches"] = total
    return out


def _timed_steps(tr, batch, gen, steps=20, warmup=3):
    """Median ms of each part of a training step over ``steps`` steps
    (CUDA events), the host wall per step, and the peak device memory.
    ``gen``: the dropout generator."""
    for _ in range(warmup):
        tr.step(*batch, generator=gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events = [[torch.cuda.Event(enable_timing=True) for _ in range(4)] for _ in range(steps)]
    t0 = time.perf_counter()
    for ev in events:
        ev[0].record()
        loss = tr.loss(*batch, generator=gen)
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


def _device_busy(tr, batch, gen, wall_ms, steps=5):
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
            tr.step(*batch, generator=gen)
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
    4's genome.  Returns its numbers, the GRU launches of the training path
    (``train``'s calibration forwards and (d)'s, counted from 0 before (c))
    and those of the calling run (e), counted from 0 before it."""
    from clairs_to_tpu_torch.__main__ import SUBMODULES
    from clairs_to_tpu_torch.bench.grad_check import compare, step_grads, train_batch
    from clairs_to_tpu_torch.models.checkpoint import load_checkpoint
    from clairs_to_tpu_torch.ops import gru
    from clairs_to_tpu_torch.train import DualTrainer, TrainConfig

    res = {}
    # (a) one step, card against CPU, from the same weights
    tc = TrainConfig(dropout_rate=0.0)
    batch, (x, x_neg, cov) = train_batch(tc.batch_size, 5, "cuda")
    card_tr = DualTrainer("snv", tc, device="cuda")
    cpu_tr = DualTrainer("snv", tc, device="cpu")
    for net in ("aff", "neg"):
        cpu_tr.models[net].load_state_dict(card_tr.models[net].state_dict())
    t0 = time.time()
    got = step_grads(card_tr, batch)
    t1 = time.time()
    want = step_grads(cpu_tr, [t.cpu() for t in batch])
    cpu_s = time.time() - t1
    gap = compare(got, want)
    log(f"[train] {card}: one flagship SNV step on {tc.batch_size} rows: loss cuda "
        f"{got[0]:.7f} cpu {want[0]:.7f} (rel {gap['loss_rel']:.2e}); grad global norm "
        f"cuda {got[1]:.7f} cpu {want[1]:.7f} (rel {gap['norm_rel']:.2e}); worst leaf "
        f"{gap['worst_leaf']} (|g| {gap['worst_leaf_norm']:.3e}) rel {gap['worst_leaf_rel']:.2e}; "
        f"largest share of the norm gap {gap['norm_gap_leaf']} ({gap['norm_gap_share']:.2f}); "
        f"the card's step took {t1 - t0:.1f} s (first, with cuDNN's planning), the CPU's "
        f"{cpu_s:.1f} s")
    if max(gap["loss_rel"], gap["norm_rel"], gap["worst_leaf_rel"]) > TRAIN_TOL:
        raise AssertionError(f"train: the card's step disagrees with the CPU's ({gap})")
    res.update(gap, loss=got[0], grad_norm=got[1])
    # (b) the step's time and memory, dropout on as in training
    timed_tr = DualTrainer("snv", TrainConfig(), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    res["step"] = _timed_steps(timed_tr, batch, gen)
    log(f"[train] {card}: flagship SNV step at {tc.batch_size} rows (median of 20, CUDA "
        f"events): " + json.dumps(res["step"]))
    res["profile"] = _device_busy(timed_tr, batch, gen, res["step"]["wall_ms"])
    log(f"[train] torch.profiler over 5 steps: " + json.dumps(res["profile"]))
    del card_tr, cpu_tr, timed_tr
    # (c) the subcommand, both modes, into run's --model_dir layout
    model_dir = os.path.join(WORK, "trained")
    res["cli_wall_s"] = {}
    gru.gru_direction.launches = 0
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
    plain = tr.predict_probs(x, rescale_cov=cov, x_neg=x_neg, use_kernel=False)
    err = max(float(np.abs(a - b).max()) for a, b in zip(kern, plain))
    log(f"[train] predict_probs on {len(x)} rows: kernel vs plain GRU max |p diff| {err:.3e}")
    if err > ENGINE_TOL or not all(np.isfinite(a).all() for a in kern):
        raise AssertionError(f"train: predict_probs with the kernel disagrees ({err:.3e})")
    res["predict_max_abs_err"] = err
    # 4 launches a NEG forward (two bidirectional layers), one forward per
    # 512 rows: train's calibration forwards 3000 rows a mode, (d) 800
    batches = 2 * -(-3000 // 512) + -(-len(x) // 512)
    log(f"[train] launches_by_path[\"train\"] = {res['launches']} (expected {4 * batches})")
    if res["launches"] != 4 * batches:
        raise AssertionError(f"train: {res['launches']} GRU launches, expected {4 * batches}")
    # (e) call with the trained networks
    out_dir = os.path.join(WORK, "trained_run")
    gru.gru_direction.launches = 0
    wall, n_cand, summary = _run_cli(ds, out_dir, "cuda", extra=("--model_dir", model_dir,
                                                                 *OPT_OUT))
    res["run_launches"] = gru.gru_direction.launches
    for name in ("snv.vcf", "indel.vcf"):
        if not os.path.exists(os.path.join(out_dir, name)):
            raise AssertionError(f"train: run --model_dir wrote no {name}")
    rows = {n: len(_calls(os.path.join(out_dir, n), None)) for n in ("snv.vcf", "indel.vcf")}
    log(f"[train] run --model_dir with the trained networks: {n_cand} candidates in "
        f"{wall:.2f} s, rows {json.dumps(rows)}, GRU launches {res['run_launches']}")
    res.update(run_wall_s=wall, run_rows=rows)
    return res


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
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--prev-source", help="an earlier csrc/gru.cu to time against")
    args = ap.parse_args(argv)
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

    prev_build = start_prev_build(args.prev_source) if args.prev_source else None
    phase_build(gru)
    prev = load_prev(prev_build) if prev_build else None
    max_err, timings = phase_kernel(gru, dev, prev)
    engine = phase_engine(dev)
    e2e = phase_end_to_end(card, GENOME_LEN, ILMN_GENOME_LEN)
    e2e["replicas"] = phase_replicas(dev)
    e2e["train"] = phase_train(card, e2e.pop("dataset"))
    log(f"[done] {time.time() - t_start:.1f} s; " + json.dumps(dict(engine=engine, e2e=e2e)))

    t = timings[192]
    kernels = [dict(
        name="gru_direction", route="cuda", source="clairs_to_tpu_torch/csrc/gru.cu",
        replaces="clairs_to_tpu/ops/gru_pallas.py:61",
        launches=e2e["default_ont"]["launches"],
        launches_by_path=dict({k: e2e[k]["launches"] for k in (
            "opt_out", "default_ont", "ilmn", "serve", "two_process", "replicas", "train")},
            train_run=e2e["train"]["run_launches"]),
        max_abs_err=max_err, ms=t["kernel_ms"], plain_ms=t["plain_ms"],
        bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=t["library_ms"],
        bound_fp32_ms=t["bound_fp32_ms"], shape=f"T={T} B=8192 H=192",
        h128=timings[128],
    )]
    if "prev_ms" in t:
        kernels[0]["prev_ms"] = t["prev_ms"]
    if min(kernels[0]["launches_by_path"].values()) <= 0:
        raise AssertionError(f"a path never launched the kernel: {kernels[0]['launches_by_path']}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
