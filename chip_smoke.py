"""Smoke run of the PyTorch/CUDA port (clairs_to_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build the GRU kernel (csrc/gru.cu) from the checkout with nvcc;
  2. hold the kernel against its plain PyTorch version on the card
     (H in {16, 128, 192}, B in {8192, 1000}, both directions) and time it
     beside the plain version and cuDNN's torch.nn.GRU (a yardstick only);
  3. the engine's forward on the flagship ONT SNV and indel weights at
     device_batch 8192, with the kernel against the plain GRU;
  4. ``clairs_to_tpu_torch run -p ont`` end to end on a simulated 2 Mb ONT
     BAM at 60x with SNVs and indels, then the same region run on the CPU
     as the reference for the calls.
Prints the card's name and power limit, a ``kernels`` JSON line, and as
the last line ``{"ok": true, "device": {...}}``.  Exits non-zero without a
GPU.  Working files go under build/chip_smoke/ in the checkout.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")
ASSETS = os.path.join(REPO, "assets", "flagship_ont_snv")
T = 33
# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
KERNEL_TOL = 1e-5     # kernel vs plain GRU outputs, fp32 both
ENGINE_TOL = 5e-5     # class-1 probabilities, kernel engine vs plain-GRU engine
# bamio/simulate ONT read model (copied from clairs_to_tpu/bench/profiles.py)
ONT_PROFILE = dict(read_length=500, error_rate=0.002,
                   eval_profile=dict(hp_error_mult=4.0, strand_err_mult=1.6,
                                     qual_decay=6.0, burst_rate=0.08,
                                     burst_len=40, burst_qual=8))
GENOME_LEN = 2_000_000
COVERAGE = 60


def log(msg):
    print(msg, flush=True)


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


def gru_bound_ms(B, H):
    """Least time for one direction: each input read and output written once
    against HBM, the h.W_hh FMAs against the fp32 peak (gate math not counted)."""
    bytes_ = 4 * (T * B * 3 * H + T * B * H + H * 3 * H + 3 * H)
    flops = 2.0 * T * B * H * 3 * H
    by_bytes, by_ops = bytes_ / PEAK_BYTES * 1e3, flops / PEAK_FP32_FLOPS * 1e3
    return max(by_bytes, by_ops), ("operations" if by_ops >= by_bytes else "bytes")


def phase_build(gru):
    t0 = time.time()
    diag = gru.build(verbose=True)
    log(f"[build] gru.cu built and loaded in {time.time() - t0:.2f} s")
    for line in diag.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"[build] {line.strip()}")


def phase_kernel(gru, dev):
    rng = np.random.default_rng(0)
    max_err, timings = 0.0, {}
    for H in (16, 128, 192):
        bound = H ** -0.5
        w = torch.from_numpy(rng.uniform(-bound, bound, (H, 3 * H)).astype(np.float32)).to(dev)
        b = torch.from_numpy(rng.uniform(-bound, bound, 3 * H).astype(np.float32)).to(dev)
        for B in (8192, 1000):
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
                        kernel_ms=cuda_ms(lambda: gru.gru_direction(xg, w, b), 20),
                        plain_ms=cuda_ms(lambda: gru.gru_direction_plain(xg, w, b), 10),
                        library_ms=cuda_ms(lambda: lib(x_in), 20),
                    )
                t["bound_ms"], t["bound_by"] = gru_bound_ms(B, H)
                timings[H] = t
                log(f"[kernel] timing T={T} B={B} H={H}: " + json.dumps(t))
    return max_err, timings


def phase_engine(dev):
    from clairs_to_tpu_torch.infer.engine import InferenceEngine
    from clairs_to_tpu_torch.models.checkpoint import load_checkpoint_auto
    from clairs_to_tpu_torch.ops import gru
    from clairs_to_tpu_torch.ops.posterior import load_likelihood_matrix

    rng = np.random.default_rng(1)
    n = 8192
    x_aff = rng.integers(-30, 31, size=(n, 33, 34)).astype(np.int16)
    x_neg = (x_aff + rng.integers(-2, 3, size=x_aff.shape)).astype(np.int16)
    cov = rng.integers(10, 120, size=n).astype(np.float32)
    out = {}
    for mode, sub, n_al in (("snv", "", 4), ("indel", "indel", 6)):
        aff, cc = load_checkpoint_auto(os.path.join(ASSETS, sub, "aff.npz"), mode, "cvt", dev)
        neg, gc = load_checkpoint_auto(os.path.join(ASSETS, sub, "neg.npz"), mode, "bigru", dev)
        lik = load_likelihood_matrix(os.path.join(ASSETS, sub, "likelihood_matrix.txt"), n_al)
        kw = dict(mode=mode, device_batch=8192, cvt_config=cc, bigru_config=gc, device=dev)
        kern = InferenceEngine(aff, neg, lik, **kw)
        plain = InferenceEngine(aff, neg, lik, use_kernel=False, **kw)
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
    rows = []
    for line in open(path):
        if line.startswith("#"):
            continue
        c = line.split("\t")
        if filt is None or c[6] == filt:
            rows.append((c[0], int(c[1]), c[3], c[4], c[6], float(c[5])))
    return rows


def _run_cli(ds, out_dir, device, extra=()):
    from clairs_to_tpu_torch.cli.run import main

    args = ["-T", ds["bam"], "-R", ds["fasta"], "-o", out_dir, "-t", "8", "-p", "ont",
            "--model_dir", ASSETS, "--disable_intermediate_phasing", "--disable_verdict",
            "--panel_of_normals", "None", "--device", device, *extra]
    t0 = time.time()
    rc = main(args)
    wall = time.time() - t0
    if rc != 0:
        raise AssertionError(f"run exited {rc}")
    text = open(os.path.join(out_dir, "run_clairs_to_tpu_torch.log")).read()
    n_cand = int(re.findall(r"\[INFO\] (\d+) candidates, total time", text)[-1])
    summary = re.findall(r"RunMetricsSummary: (\{.*\})", text)[-1]
    return wall, n_cand, summary


def phase_end_to_end(card, genome_len):
    from clairs_to_tpu_torch.bamio.simulate import make_dataset
    from clairs_to_tpu_torch.ops import gru

    data_dir = os.path.join(WORK, "data")
    t0 = time.time()
    ds = make_dataset(data_dir, seed=7, genome_len=genome_len, coverage=COVERAGE,
                      n_snv=max(20, genome_len // 20_000), n_indel=max(10, genome_len // 40_000),
                      n_germline=max(10, genome_len // 20_000), **ONT_PROFILE)
    log(f"[e2e] simulated {genome_len} bp ONT at {COVERAGE}x in {time.time() - t0:.1f} s")

    gru.gru_direction.launches = 0
    out_dir = os.path.join(WORK, "out_cuda")
    wall, n_cand, summary = _run_cli(ds, out_dir, "cuda")
    launches = gru.gru_direction.launches
    snv, indel = (os.path.join(out_dir, f) for f in ("snv.vcf", "indel.vcf"))
    n_snv, n_indel = len(_calls(snv, None)), len(_calls(indel, None))
    log(f"[e2e] {card}: {n_cand} candidates in {wall:.2f} s wall = {n_cand / wall:.1f} cand/s; "
        f"{n_snv} SNV rows, {n_indel} indel rows; GRU launches {launches}")
    log(f"[e2e] stages {summary}")
    if not (n_snv and n_indel and launches > 0):
        raise AssertionError("end-to-end run produced no rows or never launched the kernel")

    truth = {(r[1], r[2], r[3]) for r in _calls(ds["truth"], None)}
    called = {(r[1], r[2], r[3]) for r in _calls(snv) + _calls(indel)}
    tp = len(truth & called)
    recall, precision = tp / max(len(truth), 1), tp / max(len(called), 1)
    log(f"[e2e] PASS calls vs truth: recall {recall:.4f} precision {precision:.4f}")
    if recall < 0.5 or precision < 0.5:
        raise AssertionError("calls do not recover the simulated variants")

    # reference on a small input: the same region through the plain CPU path
    region = f"chrS:1-{min(genome_len, 200_000)}"
    cpu_dir = os.path.join(WORK, "out_cpu")
    gpu_dir = os.path.join(WORK, "out_cuda_region")
    _run_cli(ds, cpu_dir, "cpu", ("-r", region, "--device_batch", "1024"))
    _run_cli(ds, gpu_dir, "cuda", ("-r", region))
    for name in ("snv.vcf", "indel.vcf"):
        want = _calls(os.path.join(cpu_dir, name), None)
        got = _calls(os.path.join(gpu_dir, name), None)
        gap = max((abs(a[5] - b[5]) for a, b in zip(want, got)), default=0.0)
        log(f"[e2e] {region} {name}: {len(got)} rows on cuda, {len(want)} on cpu, "
            f"largest QUAL gap {gap:.4f}")
        if [r[:5] for r in got] != [r[:5] for r in want] or gap > 0.01:
            raise AssertionError(f"{name}: cuda and cpu calls differ in {region}")
    return dict(candidates=n_cand, wall_s=wall, cand_per_s=n_cand / wall,
                launches=launches, genome_len=genome_len)


def main():
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
    engine = phase_engine(dev)
    e2e = phase_end_to_end(card, GENOME_LEN)
    log(f"[done] {time.time() - t_start:.1f} s; " + json.dumps(dict(engine=engine, e2e=e2e)))

    t = timings[192]
    kernels = [dict(
        name="gru_direction", route="cuda", source="clairs_to_tpu_torch/csrc/gru.cu",
        replaces="clairs_to_tpu/ops/gru_pallas.py:61", launches=e2e["launches"],
        max_abs_err=max_err, ms=t["kernel_ms"], plain_ms=t["plain_ms"],
        bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=t["library_ms"],
        shape=f"T={T} B=8192 H=192", h128=timings[128],
    )]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
