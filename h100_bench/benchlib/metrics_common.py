"""Readings that several per-layer metrics share."""


def idle_pct(ctx):
    """100 x (1 - the union of the device's operations / the traced
    window), or None without a trace."""
    tr = ctx.tracer
    if tr is None or not tr.window_s:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def window_s(ctx):
    """The traced window's length where there is one, else the host's."""
    tr = ctx.tracer
    return tr.window_s if tr is not None else ctx.counters.get("window_s")


POSTCALL = ("hard_filters", "verdict_counts", "merge", "pon_tagging", "verdict", "tabix")


def s_per_kcand(ctx, stages):
    """Seconds of ``run``'s ``stages`` over the window's runs per 1,000
    candidates, from each run's ``RunMetricsSummary`` (``ctx.counters
    ["runs"]``), which keeps stage seconds whether a profiler runs or not;
    None without a run or a candidate."""
    runs = [r for r in ctx.counters.get("runs", []) if r.get("rc") == 0]
    cand = sum(r["counters"].get("candidates", 0) for r in runs)
    if not cand:
        return None
    return 1e3 * sum(r["stages"].get(s, 0.0) for r in runs for s in stages) / cand
