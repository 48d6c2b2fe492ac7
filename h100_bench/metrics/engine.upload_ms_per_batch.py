"""Host milliseconds a batch in the engine's ``engine.upload`` span (the
program's own, ``infer/engine.py``), per batch of the traced window."""

from h100_bench.benchlib.program_spans import ms_per_batch


def read(ctx):
    return ms_per_batch(ctx, "engine.upload")
