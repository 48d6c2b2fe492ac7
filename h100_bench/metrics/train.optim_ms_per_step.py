"""Host milliseconds a training step in the trainer's ``train.optim`` span
(the program's own, ``train.py::DualTrainer.step``), per ``train.step`` span
of the traced window."""

from h100_bench.benchlib.program_spans import ms_per_step


def read(ctx):
    return ms_per_step(ctx, "train.optim")
