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
