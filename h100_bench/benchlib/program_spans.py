"""Readings of the program's own spans (``clairs_to_tpu_torch.utils.metrics``)
inside the traced window.  The program records a span only while a profiler
is active, so only the ``--trace 1`` run has them; they are on
``time.perf_counter``, the clock of ``benchlib/trace.py``, so they meet the
device's busy intervals directly.  A program without the recorder, or a
window without the spans, reads None.
"""

from h100_bench.benchlib.trace import _union


def window_spans(ctx):
    """The program's spans that lie inside the traced window, or None."""
    win = ctx.counters.get("window_s")
    if ctx.tracer is None or not win:
        return None
    try:
        from clairs_to_tpu_torch.utils import metrics
    except ImportError:
        return None
    recorder = getattr(metrics, "RECORDER", None)
    if recorder is None:
        return None
    return recorder.spans(ctx.t_window, ctx.t_window + win) or None


def _seconds(spans, name):
    """Summed seconds of the spans named ``name``, or None where there is none."""
    hits = [s.end - s.start for s in spans if s.name == name]
    return sum(hits) if hits else None


def ms_per_batch(ctx, name):
    """Milliseconds of the spans named ``name`` per engine batch of the
    window, the batches counted as the distinct ids of its engine spans."""
    spans = window_spans(ctx)
    total = spans and _seconds(spans, name)
    if total is None:
        return None
    batches = {s.id for s in spans if s.name.startswith("engine.")}
    return 1e3 * total / len(batches)


def ms_per_step(ctx, name):
    """Milliseconds of the spans named ``name`` per ``train.step`` span of
    the window."""
    spans = window_spans(ctx)
    total = spans and _seconds(spans, name)
    steps = spans and sum(1 for s in spans if s.name == "train.step")
    if total is None or not steps:
        return None
    return 1e3 * total / steps


def _overlap(a, b):
    """Length of the intersection of two sorted lists of disjoint intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_pct_in(ctx, name):
    """100 x the time of the traced window in which the device is idle while
    a span named ``name`` is open (it, or a span inside it, is the innermost
    open span), over the window."""
    spans = window_spans(ctx)
    tr = ctx.tracer
    open_ = spans and _union([(s.start, s.end) for s in spans if s.name == name])
    if not open_ or not tr.window_s:
        return None
    inside = sum(e - s for s, e in open_)
    return 100.0 * (inside - _overlap(open_, tr.busy)) / tr.window_s
