"""Host milliseconds a batch in the engine: the benchmark's span around
``run_batch_async`` plus its span around ``PendingBatch.result()``, taken
once the batch's work on the device is done (a CUDA event recorded after
the dispatch), per batch of the traced window."""


def read(ctx):
    sp = ctx.spans
    n = sp.count("engine.dispatch")
    if not n:
        return None
    return 1e3 * (sp.total("engine.dispatch") + sp.total("engine.result")) / n
