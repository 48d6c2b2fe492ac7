"""Seconds of decode on the prefetch workers (``RunMetricsSummary`` stage
``decode_tensor_build(worker)``, summed over the window's runs and the
workers' threads) per 1,000 candidates the runs handed to the engines."""

from h100_bench.benchlib.metrics_common import s_per_kcand


def read(ctx):
    return s_per_kcand(ctx, ("decode_tensor_build(worker)",))
