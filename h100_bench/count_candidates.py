#!/usr/bin/env python3
"""Counts the SNV and indel candidates that ``run`` finds in a simulated
genome: the ratio behind the engine cell's ``order``.

    python3 h100_bench/count_candidates.py --seed 7 --genome_len 2000000 [--platform ont]

The genome is ``chip_smoke.py`` phase 5's recipe (60x, germline every 300
bases, one somatic SNV per 20 kb and one indel per 40 kb, haplotype-aware
somatic sites, the platform's read model).  ``run`` goes through its
decode and candidate finding with default flags; the positions each chunk
hands to the SNV and the indel engine are counted there and the engines
are not called.  Prints one JSON line.  Runs on the host alone.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--genome_len", type=int, default=2_000_000)
    ap.add_argument("--coverage", type=int, default=60)
    ap.add_argument("--platform", default="ont")
    ap.add_argument("--work", default=os.path.join(ROOT, "build", "h100_bench", "count"))
    args = ap.parse_args(argv)

    from clairs_to_tpu_torch.bamio.simulate import make_dataset
    from clairs_to_tpu_torch.bench.profiles import PROFILES
    from clairs_to_tpu_torch.cli.run import main as run_main
    from clairs_to_tpu_torch.infer.pipeline import CallingPipeline

    n = args.genome_len
    model = {k: v for k, v in PROFILES[args.platform].items() if k != "coverage"}
    t0 = time.time()
    ds = make_dataset(os.path.join(args.work, f"data_{args.platform}_{args.seed}_{n}"),
                      seed=args.seed, genome_len=n, coverage=args.coverage,
                      n_snv=max(20, n // 20_000), n_indel=max(10, n // 40_000),
                      n_germline=n // 300, somatic_hap_aware=True, **model)
    sim_s = time.time() - t0

    chunks = []

    def count(self, pe, chunk, positions, *a, mode, **kw):
        chunks.append((chunk.ctg_start, mode, len(positions)))
        return None

    CallingPipeline._dispatch_positions = count
    out = os.path.join(args.work, f"out_{args.platform}_{args.seed}_{n}")
    t0 = time.time()
    rc = run_main(["-T", ds["bam"], "-R", ds["fasta"], "-o", out, "-t", "5",
                   "-p", args.platform, "--device", "cpu"])
    totals = {m: sum(k for _s, mm, k in chunks if mm == m) for m in ("snv", "indel")}
    print(json.dumps({"seed": args.seed, "genome_len": n, "platform": args.platform,
                      "rc": rc, "simulate_s": sim_s, "run_s": time.time() - t0,
                      "candidates": totals, "chunks": sorted(chunks)}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
