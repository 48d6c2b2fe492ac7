# Port copy of clairs_to_tpu/utils/metrics.py.
"""Run metrics, stage timing, spans, and logging.

Aux-subsystem parity with the reference (SURVEY.md §5.1/§5.5): per-stage
wall-clock (the reference's `time` prefixes + per-stage logs,
run_clairs_to:1188-1196), structured counters (candidates per chunk,
tensors per shard, per-filter kill counts, PoN tagging summary lines), tee
logging to <output_dir>/run_clairs_to_tpu_torch.log, and an optional
torch.profiler trace around the device loop.

Spans: ``RECORDER`` keeps the spans that the engine, the trainer and the
run's stages open, on ``time.perf_counter()``, the clock of the benchmark's
device trace.  A span records only while a ``torch.profiler`` session is
active on its thread (``torch.autograd._profiler_enabled()``, checked on
entry); otherwise it costs that check.  Its counters count under the same
switch.  ``device_trace`` writes the spans of its window into its Chrome
trace as a host track on the device's clock, and what the counters counted
in the window as counter tracks.
"""

import contextlib
import itertools
import json
import os
import sys
import threading
import time
from collections import Counter, defaultdict, deque
from typing import NamedTuple, Optional

from torch.autograd import _profiler_enabled

# spans kept in memory: the oldest are dropped beyond this (a 51-s window of
# the engine or the trainer records a few thousand)
SPAN_CAPACITY = 1 << 18


class Span(NamedTuple):
    """A finished span: ``start`` and ``end`` in ``time.perf_counter()``
    seconds; ``sid`` its serial number, ``parent`` the ``sid`` of the span
    open around it on its thread (None at the top); ``id`` the batch or
    chunk it belongs to (given, or its parent's); ``thread`` the native
    thread id."""

    name: str
    start: float
    end: float
    sid: int
    parent: Optional[int]
    id: object
    thread: int


class _Open:
    """An open span; records itself on exit."""

    __slots__ = ("_rec", "name", "id", "sid", "parent", "start")

    def __init__(self, rec, name, id):
        self._rec, self.name, self.id = rec, name, id

    def __enter__(self):
        stack = self._rec._stack()
        top = stack[-1] if stack else None
        self.parent = None if top is None else top.sid
        if self.id is None and top is not None:
            self.id = top.id
        self.sid = next(self._rec._serial)
        stack.append(self)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        self._rec._stack().remove(self)
        self._rec.add(Span(self.name, self.start, end, self.sid, self.parent, self.id,
                           threading.get_native_id()))
        return False


_OFF = contextlib.nullcontext()


class Recorder:
    """Spans in a bounded buffer, and counters, both kept only while a
    profiler is active; safe to use from several threads."""

    def __init__(self, capacity=SPAN_CAPACITY):
        self._lock = threading.Lock()
        self._spans = deque(maxlen=capacity)
        self._counters = Counter()
        self._local = threading.local()
        self._serial = itertools.count(1)
        self._ids = itertools.count(1)
        self.dropped = 0

    def _stack(self):
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name, id=None):
        """Context manager: a span named ``name`` while a profiler is
        active on this thread, nothing otherwise."""
        if not _profiler_enabled():
            return _OFF
        return _Open(self, name, id)

    def new_id(self):
        """A fresh id for the spans of one batch."""
        return next(self._ids)

    def count(self, name, n=1):
        """Adds ``n`` to the counter ``name`` while a profiler is active on
        this thread."""
        if not _profiler_enabled():
            return
        with self._lock:
            self._counters[name] += n

    def add(self, span: Span):
        """Appends a finished span; beyond the capacity the oldest goes."""
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self.dropped += 1
            self._spans.append(span)

    def spans(self, start=None, end=None):
        """The spans that lie within [start, end] (perf_counter seconds),
        in the order they ended."""
        with self._lock:
            items = list(self._spans)
        return [s for s in items
                if (start is None or s.start >= start) and (end is None or s.end <= end)]

    def counters(self):
        with self._lock:
            return dict(self._counters)


# the process's recorder: the engine, the trainer and the run's stages
# record here, and the benchmark's per-layer metrics read it
RECORDER = Recorder()
span = RECORDER.span
count = RECORDER.count
new_id = RECORDER.new_id


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
    """Counters + stage timers; one instance per pipeline run.  A stage adds
    its seconds to ``stage_seconds`` and is a span of ``RECORDER``; stages
    may run on several threads at once."""

    def __init__(self):
        self.counters = Counter()
        self.stage_seconds = defaultdict(float)
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()

    def count(self, name, n=1):
        with self._lock:
            self.counters[name] += n

    @contextlib.contextmanager
    def stage(self, name, id=None):
        start = time.perf_counter()
        try:
            with RECORDER.span(name, id):
                yield
        finally:
            with self._lock:
                self.stage_seconds[name] += time.perf_counter() - start

    def summary(self):
        with self._lock:
            stages = dict(self.stage_seconds)
            counters = dict(self.counters)
        return {
            "total_seconds": round(time.perf_counter() - self._t0, 2),
            "stages": {k: round(v, 2) for k, v in sorted(stages.items())},
            "counters": counters,
        }

    def report(self, out=None):
        out = out or sys.stdout
        s = self.summary()
        out.write("[INFO] RunMetricsSummary: " + json.dumps(s) + "\n")
        for k, v in s["stages"].items():
            out.write(f"[INFO]   stage {k}: {v}s\n")
        return s


def _synchronize_all(torch):
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def _anchor_ts(events, cuda):
    """The trace's timestamp (us) of the anchor operation: on CUDA the
    second operation on a device, on the CPU the second ``aten::fill_``."""
    if cuda:
        hits = [e["ts"] for e in events
                if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "ts" in e]
    else:
        hits = [e["ts"] for e in events if e.get("name") == "aten::fill_" and "ts" in e]
    if len(hits) < 2:
        raise RuntimeError("the profiler recorded no anchor operation")
    return sorted(hits)[1]


def _write_host_track(path, spans, counts, t0, t1, cuda):
    """Adds ``spans`` to the Chrome trace at ``path`` as complete events of a
    host track, placed on the trace's clock by the anchor taken at
    perf_counter time ``t0``, and ``counts``, what each counter counted in
    the window up to ``t1``, as counter tracks that rise from 0 at ``t0``."""
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    base = _anchor_ts(events, cuda)
    pid = os.getpid()
    events.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                   "args": {"name": "host: program spans (perf_counter, anchored)"}})
    for s in spans:
        events.append({"ph": "X", "cat": "program_span", "name": s.name, "pid": pid,
                       "tid": s.thread, "ts": base + (s.start - t0) * 1e6,
                       "dur": (s.end - s.start) * 1e6,
                       "args": {"id": s.id, "sid": s.sid, "parent": s.parent}})
    for name, n in sorted(counts.items()):
        for ts, value in ((base, 0), (base + (t1 - t0) * 1e6, n)):
            events.append({"ph": "C", "cat": "program_counter", "name": name, "pid": pid,
                           "ts": ts, "args": {"value": value}})
    with open(path, "w") as f:
        json.dump(trace, f)


@contextlib.contextmanager
def device_trace(trace_dir=None):
    """torch.profiler trace around the device loop (no-op when dir is None).

    Writes a Chrome trace (``trace.json``) into ``trace_dir``: CUDA activity
    alone where there is a GPU (CPU activity stretches the host's work
    several fold), CPU activity on a machine without one.  After a
    synchronise the host notes ``perf_counter`` and runs one small
    operation, the second in the trace, which ties the trace's clock to the
    host's; the recorder's spans and counts of the window are written on
    that clock."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    os.makedirs(trace_dir, exist_ok=True)
    anchor = torch.zeros(1, device="cuda" if cuda else "cpu")
    if cuda:
        _synchronize_all(torch)
    prof = profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU])
    before = RECORDER.counters()
    prof.start()
    try:
        # the trace's first operation warms the profiler's first launch,
        # which runs late; the second is the anchor
        anchor.fill_(0.0)
        if cuda:
            _synchronize_all(torch)
        t0 = time.perf_counter()
        anchor.fill_(1.0)
        yield
    finally:
        if cuda:
            _synchronize_all(torch)
        t1 = time.perf_counter()
        prof.stop()
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    counts = {k: v - before.get(k, 0) for k, v in RECORDER.counters().items()}
    _write_host_track(path, RECORDER.spans(t0, t1), counts, t0, t1, cuda)
