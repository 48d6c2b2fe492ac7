"""Share of the traced window in which no operation ran on the device while
the engine's host was packing a batch (the program's ``engine.pack`` span, or
a span inside it, innermost): the part of ``device_idle.engine`` that the
packing holds."""

from h100_bench.benchlib.program_spans import idle_pct_in


def read(ctx):
    return idle_pct_in(ctx, "engine.pack")
