"""The forward GRU kernel's share of its roofline: the least time of the
recurrence's work (``benchlib.flops.gru_fwd_work``: FLOP at the TF32 peak,
bytes at the HBM peak, the larger) summed over the window's launches, over
the device time of the kernels named KERNEL.  A NEG forward launches one
kernel per direction and layer: two at hidden1, two at hidden2."""

from h100_bench.benchlib import flops

KERNEL = "gru_direction_kernel"


def read(ctx):
    tr, batches = ctx.tracer, ctx.counters.get("batches")
    if tr is None or not batches:
        return None
    launches, secs = tr.kernel_seconds(lambda n: KERNEL in n)
    if not launches:
        return None
    rows = ctx.spec["device_batch"]
    per_forward = []
    for mode in batches:
        g = ctx.config[mode]["bigru"]
        per_forward.append(sum(2 * flops.bound_s(*flops.gru_fwd_work(rows, h))
                               for h in (g["hidden1"], g["hidden2"])))
    forwards = sum(batches.values())
    mean_launch = sum(p * batches[m] for p, m in zip(per_forward, batches)) / (4 * forwards)
    return flops.share_pct(launches * mean_launch, secs)
