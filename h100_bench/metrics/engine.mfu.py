"""Model FLOP of the rows through both networks of each batch, counted
from the configuration's shapes, per second of the traced window, as a
share of the H100's dense TF32 peak."""

from h100_bench.benchlib import flops
from h100_bench.benchlib.metrics_common import window_s


def read(ctx):
    batches, win = ctx.counters.get("batches"), window_s(ctx)
    if not batches or not win:
        return None
    rows = ctx.spec["device_batch"]
    work = sum(n * rows * flops.pair_flops_per_row(ctx.config[mode]) for mode, n in batches.items())
    return 100.0 * work / win / flops.PEAK_TF32_FLOPS
