"""The device timeline of a traced run, and the benchmark's host spans.

``DeviceTrace`` runs ``torch.profiler`` with CUDA activity only over the
measured window (CPU activity tracing stretches the host's work several
fold).  The device's clock is tied to the host's by an anchor: after a
synchronise, the host notes its clock and launches one small operation,
the first on the device in the trace.  ``Spans`` holds the benchmark's own
host spans around its calls into the program, so that an idle gap of the
device can be named by what the host was doing.
"""

import contextlib
import time

import torch


class Spans:
    """Host spans (name, start s, end s) on ``time.perf_counter``; a no-op
    unless enabled, so the untraced run pays nothing."""

    def __init__(self, enabled):
        self.enabled = enabled
        self.items = []

    def span(self, name):
        if not self.enabled:
            return contextlib.nullcontext()
        return self._span(name)

    @contextlib.contextmanager
    def _span(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.items.append((name, t0, time.perf_counter()))

    def total(self, name):
        return sum(t1 - t0 for n, t0, t1 in self.items if n == name)

    def count(self, name):
        return sum(1 for n, _t0, _t1 in self.items if n == name)

    def at(self, t):
        """The innermost span open at host time ``t``, or None."""
        best = None
        for n, t0, t1 in self.items:
            if t0 <= t < t1 and (best is None or t0 >= best[1]):
                best = (n, t0)
        return best[0] if best else None


def _kineto_events(prof):
    """(name, start s, end s) of every operation on a CUDA device, in the
    device's clock."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            start = e.start_ns() * 1e-9
            out.append((e.name(), start, start + e.duration_ns() * 1e-9))
    return out


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


class DeviceTrace:
    """CUDA-only profile of one window on one device.  After ``stop``:
    ``ops`` lists (name, start, end) in the host's clock, ``window_s`` is
    the traced window's length and ``busy_s`` the union of the device's
    operations inside it."""

    def __init__(self, device):
        self.device = device
        self.ops, self.busy, self.window_s, self.busy_s = [], [], None, None
        self._prof = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        anchor = torch.zeros(1, device=self.device)
        torch.cuda.synchronize(self.device)
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        torch.cuda.synchronize(self.device)
        self._t0 = time.perf_counter()
        anchor.fill_(1.0)          # the trace's first operation
        self._anchor = anchor

    def stop(self):
        torch.cuda.synchronize(self.device)
        self._t1 = time.perf_counter()
        self._prof.stop()
        events = sorted(_kineto_events(self._prof), key=lambda e: e[1])
        self._prof = None
        if not events:
            raise RuntimeError("the profiler recorded no operation on the device")
        offset = events[0][1] - self._t0
        self.ops = [(n, s - offset, e - offset) for n, s, e in events[1:]]
        self.window_s = self._t1 - self._t0
        self.busy = _union([(max(s, self._t0), min(e, self._t1)) for _n, s, e in self.ops
                            if e > self._t0 and s < self._t1])
        self.busy_s = sum(e - s for s, e in self.busy)

    def kernel_seconds(self, predicate):
        """(launches, device seconds) of the operations whose name passes."""
        hits = [e - s for n, s, e in self.ops if predicate(n)]
        return len(hits), sum(hits)

    def launches(self):
        """Kernels launched in the window (copies and memsets left out)."""
        return sum(1 for n, _s, _e in self.ops if not n.startswith("Memcpy")
                   and not n.startswith("Memset"))

    def breakdown(self, spans, top=10):
        """The device operations that took most time, and the longest idle
        gaps named by the host span open at their middle."""
        by_name = {}
        for n, s, e in self.ops:
            by_name[n] = by_name.get(n, 0.0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        edges = [self._t0] + [x for iv in self.busy for x in iv] + [self._t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        named = [[spans.at(0.5 * (a + b)) or "outside_spans", b - a] for a, b in gaps[:top]]
        return {"device_ops": [[n[:160], s] for n, s in ops], "idle_gaps": named}
