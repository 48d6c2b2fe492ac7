# Port copy of clairs_to_tpu/utils/metrics.py.
"""Run metrics, stage timing, and logging.

Aux-subsystem parity with the reference (SURVEY.md §5.1/§5.5): per-stage
wall-clock (the reference's `time` prefixes + per-stage logs,
run_clairs_to:1188-1196), structured counters (candidates per chunk,
tensors per shard, per-filter kill counts, PoN tagging summary lines), tee
logging to <output_dir>/run_clairs_to_tpu_torch.log, and an optional torch.profiler
trace around the device loop.
"""

import contextlib
import json
import sys
import time
from collections import Counter, defaultdict


class Tee:
    """Duplicate stdout to a log file (run_clairs_to:112-135)."""

    def __init__(self, path, stream=None):
        self._fp = open(path, "a")
        self._stream = stream or sys.stdout

    def write(self, data):
        self._stream.write(data)
        self._fp.write(data)

    def flush(self):
        self._stream.flush()
        self._fp.flush()

    def close(self):
        self._fp.close()


class RunMetrics:
    """Counters + stage timers; one instance per pipeline run."""

    def __init__(self):
        self.counters = Counter()
        self.stage_seconds = defaultdict(float)
        self._t0 = time.time()

    def count(self, name, n=1):
        self.counters[name] += n

    @contextlib.contextmanager
    def stage(self, name):
        start = time.time()
        try:
            yield
        finally:
            self.stage_seconds[name] += time.time() - start

    def summary(self):
        return {
            "total_seconds": round(time.time() - self._t0, 2),
            "stages": {k: round(v, 2) for k, v in sorted(self.stage_seconds.items())},
            "counters": dict(self.counters),
        }

    def report(self, out=None):
        out = out or sys.stdout
        s = self.summary()
        out.write("[INFO] RunMetricsSummary: " + json.dumps(s) + "\n")
        for k, v in s["stages"].items():
            out.write(f"[INFO]   stage {k}: {v}s\n")
        return s


@contextlib.contextmanager
def device_trace(trace_dir=None):
    """torch.profiler trace around the device loop (no-op when dir is None).

    Writes a Chrome trace (``trace.json``) into ``trace_dir``."""
    if not trace_dir:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
