"""The backward GRU kernel's share of its roofline: the least time of the
backward's work (``benchlib.flops.gru_bwd_work``: FLOP at the TF32 peak,
bytes at the HBM peak, the larger) summed over the window's launches, over
the device time of the kernels named KERNEL.  A training step launches one
per direction and layer: two at hidden1, two at hidden2, each over the
step's rows."""

from h100_bench.benchlib import flops

KERNEL = "gru_direction_backward_kernel"


def read(ctx):
    tr = ctx.tracer
    if tr is None or not ctx.counters.get("steps"):
        return None
    launches, secs = tr.kernel_seconds(lambda n: KERNEL in n)
    if not launches:
        return None
    g = ctx.config[ctx.spec["mode"]]["bigru"]
    rows = ctx.spec["rows"]
    mean_launch = sum(flops.bound_s(*flops.gru_bwd_work(rows, h))
                      for h in (g["hidden1"], g["hidden2"])) / 2
    return flops.share_pct(launches * mean_launch, secs)
