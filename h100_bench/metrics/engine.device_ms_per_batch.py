"""Device milliseconds a batch of the engine: the union of the device's
operations in the traced window over the window's batches.  The profiler
stretches the host's dispatch, not the device's work, so this reads the
same traced or not."""


def read(ctx):
    tr, batches = ctx.tracer, ctx.counters.get("batches")
    if tr is None or not batches:
        return None
    return 1e3 * tr.busy_s / sum(batches.values())
