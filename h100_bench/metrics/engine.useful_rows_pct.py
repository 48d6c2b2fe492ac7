"""100 x the rows of real candidates over the rows the engines sent to the
card (padded to whole 8,192-row slices), from the program's counters
``engine.rows`` and ``engine.rows_padded`` over the traced window."""


def read(ctx):
    c = ctx.counters.get("program") or {}
    padded = c.get("engine.rows_padded", 0)
    if not padded:
        return None
    return 100.0 * c.get("engine.rows", 0) / padded
