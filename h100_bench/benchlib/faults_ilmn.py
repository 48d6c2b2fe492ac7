"""Faults planted under an Illumina run's timed path, to show that the
``ilmn_flagship.genome_call`` cell's ``correct`` can come out false: each
replaces one function of the program for as long as it is planted.  Used
by the benchmark's tests on the CPU and by ``calibrate_ilmn.py --fault``
on the card, never by a benchmark run."""

FAULTS = ("ilmn.realign_skipped", "ilmn.postfilter_skipped", "ilmn.aff_min_bq20",
          "ilmn.chunk_dropped")


def _plant(fault, patch):
    from clairs_to_tpu_torch.infer import pipeline
    from clairs_to_tpu_torch.postcall import hardfilter, realignment

    if fault == "ilmn.realign_skipped":      # the realignment filter skipped
        patch(realignment, "realign_filter", lambda *a, **kw: 0)
    elif fault == "ilmn.postfilter_skipped":  # the postfilter's verdicts never applied
        patch(hardfilter, "apply_hard_filters", lambda rows, verdicts: 0)
    elif fault == "ilmn.aff_min_bq20":       # ONT's min_bq 20 leaking into the AFF view
        init = pipeline.CallingPipeline.__init__

        def at_twenty(self, *a, **kw):
            init(self, *a, **kw)
            self.aff_min_bq = 20

        patch(pipeline.CallingPipeline, "__init__", at_twenty)
    elif fault == "ilmn.chunk_dropped":      # the last chunk's calls dropped
        finish = pipeline.CallingPipeline.finish_chunk

        def drop_last(self, pending):
            res = finish(self, pending)
            if res.chunk.chunk_id == res.chunk.chunk_num - 1:
                res.snv_rows, res.indel_rows = [], []
            return res

        patch(pipeline.CallingPipeline, "finish_chunk", drop_last)
    else:
        raise ValueError(f"unknown fault {fault!r}")


def plant(fault, patch=None):
    """Plants ``fault``; ``patch(obj, name, value)`` defaults to setattr
    with the old value kept.  Returns a function that takes it out."""
    undo = []

    def setter(obj, name, value):
        undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    _plant(fault, patch or setter)

    def remove():
        for obj, name, old in reversed(undo):
            setattr(obj, name, old)

    return remove
