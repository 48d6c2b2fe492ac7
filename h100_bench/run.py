#!/usr/bin/env python3
"""Runs one cell of the H100 benchmark of clairs_to_tpu_torch once.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is looked up by name in BENCHMARK.json; its parameters are
``h100_bench/workloads/<cell>.json``, whose ``driver`` names the general
generator and loop in ``h100_bench/traffic/<driver>.py``; its configuration
is ``h100_bench/configs/<config>.json``; each per-layer metric is read by
``h100_bench/metrics/<metric>.py``.  A run builds its inputs from the seed,
warms up (set-up), measures for ``--seconds``, checks what the timed path
produced against the plain reference in ``h100_bench/reference/``, and
prints one JSON line last on standard output.  With ``--trace 1`` the window
runs under a CUDA-only ``torch.profiler`` and the line carries the per-layer
metrics and a breakdown; with ``--trace 0`` the end-to-end metrics.

A driver module has these functions: ``setup(ctx)`` returns its state,
``window(ctx, state)`` measures and returns its counts and end-to-end
values, ``release(ctx, state)`` frees the program's state and keeps what
the check needs, ``check(ctx, state)`` returns the compared numbers, each
as (name, value, limit), and ``control(ctx, state)`` the control's
readings (for ``calibrate.py`` only).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
CACHE = os.path.join(ROOT, "build", "h100_bench")
FORBIDDEN = ("jax", "jaxlib", "flax", "clairs_to_tpu")


def _env():
    """Caches inside the checkout at fixed paths; no library loads JAX."""
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["USE_FLAX"] = os.environ["USE_JAX"] = "0"
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)


def load_file(kind, name):
    """The module ``h100_bench/<kind>/<name>.py``, found by name."""
    path = os.path.join(BENCH, kind, name + ".py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(f"h100_bench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def manifest():
    return load_json(ROOT, "BENCHMARK.json")


def load_cell(name, spec_overrides=None):
    """(manifest, cell entry, configuration, cell parameters, driver module)
    of the cell ``name``, each found by its name."""
    man = manifest()
    cell = {w["name"]: w for w in man["workloads"]}[name]
    config = load_json(BENCH, "configs", cell["config"] + ".json")
    spec = dict(load_json(BENCH, "workloads", cell["name"] + ".json"), **(spec_overrides or {}))
    return man, cell, config, spec, load_file("traffic", spec["driver"])


def cell_metrics(man, cell):
    """(end-to-end metrics, per-layer metrics) that ``cell`` reports."""
    e2e = [m for m in man["end_to_end"] if cell in m.get("workloads", [cell])]
    return e2e, [m for m in man["per_layer"] if cell in m["workloads"]]


class Ctx:
    """What a driver and a metric reader see of a run."""

    def __init__(self, cell, config, spec, seed, seconds, trace, device):
        from h100_bench.benchlib.trace import Spans

        self.cell, self.config, self.spec = cell, config, spec
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = device
        self.cache = CACHE
        self.spans = Spans(trace)
        self.tracer = None
        self.counters = {}
        self.phases = []

    def phase(self, name):
        """Marks the end of a set-up phase, for the record on stderr."""
        self.phases.append((name, time.perf_counter() - T_START))

    def path(self, rel):
        """A path of the checkout, given relative to its root."""
        return os.path.join(ROOT, rel)

    def start_window(self):
        """Called by a driver right before its first timed call."""
        if self.trace:
            from h100_bench.benchlib.trace import DeviceTrace

            self.tracer = DeviceTrace(self.device)
            self.tracer.start()
        self.t_window = time.perf_counter()
        self.setup_s = self.t_window - T_START

    def stop_window(self):
        """Called by a driver right after its last timed result; the
        window ends before the trace is read."""
        elapsed = time.perf_counter() - self.t_window
        if self.tracer is not None:
            self.tracer.stop()
        return elapsed


def _forbidden_loaded():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None, device=None, spec_overrides=None):
    """Runs a cell; returns the exit code.  ``device`` and
    ``spec_overrides`` let a test run a small copy of a cell on the CPU,
    past the look for a card."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _env()
    if args.workload not in {w["name"] for w in manifest()["workloads"]}:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    man, cell, config, spec, driver = load_cell(args.workload, spec_overrides)

    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
                  f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)
    ctx = Ctx(cell, config, spec, args.seed, args.seconds, bool(args.trace), device)
    ctx.phase("imports")
    state = driver.setup(ctx)
    res = driver.window(ctx, state)
    marks = [0.0] + [t for _n, t in ctx.phases]
    print("set-up: " + ", ".join(f"{n} {t - t0:.3f} s" for (n, t), t0 in zip(ctx.phases, marks))
          + f"; window {ctx.counters.get('window_s', 0):.3f} s", file=sys.stderr)
    on_cuda = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if on_cuda else 0
    dev = {"platform": "gpu" if on_cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    e2e, layer = cell_metrics(man, cell["name"])
    metrics, breakdown = {}, None
    if ctx.trace:
        for m in layer:
            value = load_file("metrics", m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if ctx.tracer is not None:
            dev["busy_s"], dev["window_s"] = ctx.tracer.busy_s, ctx.tracer.window_s
            breakdown = ctx.tracer.breakdown(ctx.spans)
    else:
        values = dict(res["e2e"], setup_s=ctx.setup_s)
        for m in e2e:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    state = driver.release(ctx, state)
    checks = driver.check(ctx, state)
    correct = all(v <= lim for _n, v, lim in checks) and res["failed"] == 0
    for name, v, lim in checks:
        print(f"check {name}: {v!r} (limit {lim!r}){'' if v <= lim else ' FAILED'}",
              file=sys.stderr)
    line = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"],
            "metrics": metrics, "device": dev}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    found = _forbidden_loaded()
    if found:
        print("JAX or the JAX package was loaded in the benchmark's process: "
              + ", ".join(found), file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
