"""Milliseconds of the realignment filter a call it checked: the
``RunMetricsSummary`` stage ``realign_filter`` over the counter
``realign_sites``, each summed over the window's runs; None without a
checked call."""


def read(ctx):
    runs = [r for r in ctx.counters.get("runs", []) if r.get("rc") == 0]
    sites = sum(r["counters"].get("realign_sites", 0) for r in runs)
    if not sites:
        return None
    return 1e3 * sum(r["stages"].get("realign_filter", 0.0) for r in runs) / sites
