"""Seconds of the realignment filter (``RunMetricsSummary`` stage
``realign_filter``, inside ``hard_filters``) summed over the window's runs,
per 1,000 candidates; None where no run timed the stage."""

from h100_bench.benchlib.metrics_common import s_per_kcand


def read(ctx):
    runs = [r for r in ctx.counters.get("runs", []) if r.get("rc") == 0]
    if not any("realign_filter" in r["stages"] for r in runs):
        return None
    return s_per_kcand(ctx, ("realign_filter",))
