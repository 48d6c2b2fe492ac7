"""Device milliseconds a training step: the union of the device's
operations in the traced window over its steps.  The profiler stretches
the host's dispatch (the traced step is longer than the untraced one), but
not the device's work, so this reads the same traced or not."""


def read(ctx):
    tr, steps = ctx.tracer, ctx.counters.get("steps")
    if tr is None or not steps:
        return None
    return 1e3 * tr.busy_s / steps
