#!/usr/bin/env python3
"""Readings from which a cell's limits are set, on the card.

    python3 h100_bench/calibrate.py --workload <cell> --seeds 1,2,3 --seconds 3 [--control]

For each seed, in one process: the cell's set-up, a window of ``--seconds``
at the cell's own sizes and load, and the compared numbers of the program
against the plain reference (the lower readings).  With ``--control``, also
the control's: the reference in the program's place, computed in the
precision below the configuration's (TF32 for float32 with TF32 off; the
posterior in float32 for float64), against the reference (the upper
readings).  Prints one JSON line a seed; the benchmark's runs never run
this.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from h100_bench import run  # noqa: E402
from h100_bench.benchlib import faults  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", choices=faults.FAULTS,
                    help="plant a fault under the timed path: its readings are the program's")
    ap.add_argument("--look", action="store_true", help="the worst leaves (training)")
    args = ap.parse_args(argv)
    run._env()
    import torch

    _man, cell, config, spec, driver = run.load_cell(args.workload)
    if args.fault:
        faults.plant(args.fault)
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = run.Ctx(cell, config, spec, seed, args.seconds, False, torch.device("cuda", 0))
        state = driver.setup(ctx)
        res = driver.window(ctx, state)
        state = driver.release(ctx, state)
        readings = (driver.readings(ctx, state) if hasattr(driver, "readings")
                    else [(n, v) for n, v, _lim in driver.check(ctx, state)])
        out = {"seed": seed, "e2e": res["e2e"], "program": dict(readings)}
        if args.fault:
            out["fault"] = args.fault
        if args.look:
            out["look"] = driver.look(ctx, state)
        if args.control:
            out["control"] = dict(driver.control(ctx, state))
        print(json.dumps(out), flush=True)
        del state
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
