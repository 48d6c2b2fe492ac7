"""Host milliseconds a training step in the trainer's ``train.replay`` span
(the program's own, ``train.py::DualTrainer.step``: the launch of the step's
captured CUDA graph), per ``train.step`` span of the traced window.  A
program that does not replay a graph reads None."""

from h100_bench.benchlib.program_spans import ms_per_step


def read(ctx):
    return ms_per_step(ctx, "train.replay")
