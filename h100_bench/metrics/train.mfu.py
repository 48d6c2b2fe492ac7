"""Model FLOP of the training steps, 3 x the forward FLOP of the pair a row
(forward, and a backward of twice its work), times the rows of the traced
window's steps, per second of the window, as a share of the H100's dense
TF32 peak."""

from h100_bench.benchlib import flops
from h100_bench.benchlib.metrics_common import window_s


def read(ctx):
    rows, win = ctx.counters.get("rows"), window_s(ctx)
    if not rows or not win:
        return None
    work = 3 * flops.pair_flops_per_row(ctx.config[ctx.spec["mode"]]) * rows
    return 100.0 * work / win / flops.PEAK_TF32_FLOPS
