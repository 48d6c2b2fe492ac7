"""The benchmark's per-layer metrics that read the program's spans
(``h100_bench/metrics/``, source ``program_span``), each on a hand-built
window: spans of the port's recorder, the device's busy intervals and the
window loop's counters."""

import types

import pytest

from clairs_to_tpu_torch.utils import metrics as tracing
from h100_bench import run

T = 100.0       # the window's start, perf_counter seconds
W = 10.0        # its length


def _span(name, start, end, sid, parent=None, id=None):
    return tracing.Span(name, T + start, T + end, sid, parent, id, 1)


ENGINE = [
    # before the window: left out
    _span("engine.pack", -1.0, -0.94, 1, None, 0),
    # batch 1: dispatch 0-0.1, result 0.2-0.21
    _span("engine.pack", 0.0, 0.06, 3, 2, 1),
    _span("engine.upload", 0.06, 0.07, 4, 2, 1),
    _span("engine.launch", 0.07, 0.1, 5, 2, 1),
    _span("engine.dispatch", 0.0, 0.1, 2, None, 1),
    # batch 2: dispatch 0.1-0.2, result 0.3-0.32
    _span("engine.pack", 0.1, 0.18, 7, 6, 2),
    _span("engine.upload", 0.18, 0.195, 8, 6, 2),
    _span("engine.launch", 0.195, 0.2, 9, 6, 2),
    _span("engine.dispatch", 0.1, 0.2, 6, None, 2),
    _span("engine.wait", 0.2, 0.2, 11, 10, 1),
    _span("engine.posterior", 0.2, 0.205, 13, 12, 1),
    _span("engine.consume", 0.2, 0.21, 12, 10, 1),
    _span("engine.result", 0.2, 0.21, 10, None, 1),
    _span("engine.wait", 0.3, 0.3, 15, 14, 2),
    _span("engine.consume", 0.3, 0.32, 16, 14, 2),
    _span("engine.result", 0.3, 0.32, 14, None, 2),
]
BUSY = [[T + 0.03, T + 0.08], [T + 0.12, T + 0.2]]

TRAIN = [_span(name, s0 + a, s0 + b, sid0 + k, sid0 if k else None)
         for s0, sid0 in ((0.0, 1), (0.08, 10))
         for k, (name, a, b) in enumerate((("train.step", 0.0, 0.08),
                                            ("train.forward", 0.0, 0.02),
                                            ("train.backward", 0.02, 0.05),
                                            ("train.optim", 0.05, 0.075)))]


def _ctx(spans, monkeypatch, busy=BUSY, traced=True):
    rec = tracing.Recorder()
    for s in spans:
        rec.add(s)
    monkeypatch.setattr(tracing, "RECORDER", rec)
    tracer = types.SimpleNamespace(busy=busy, window_s=W,
                                   busy_s=sum(e - s for s, e in busy)) if traced else None
    return types.SimpleNamespace(tracer=tracer, t_window=T, counters={"window_s": W})


def _read(name, ctx):
    return run.load_file("metrics", name).read(ctx)


@pytest.mark.parametrize("name, want", [
    ("engine.pack_ms_per_batch", (60 + 80) / 2),
    ("engine.upload_ms_per_batch", (10 + 15) / 2),
    ("engine.launch_ms_per_batch", (30 + 5) / 2),
    ("engine.consume_ms_per_batch", (10 + 20) / 2),
    # idle inside the packing: 0.03 of the first (busy from 0.03), 0.02 of
    # the second (busy from 0.12), over the 10-s window
    ("device_idle.engine.pack", 100 * (0.03 + 0.02) / W),
])
def test_engine_metric_reads_its_spans(name, want, monkeypatch):
    assert _read(name, _ctx(ENGINE, monkeypatch)) == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("name, want", [
    ("train.forward_ms_per_step", 20.0),
    ("train.backward_ms_per_step", 30.0),
    ("train.optim_ms_per_step", 25.0),
])
def test_trainer_metric_reads_its_spans(name, want, monkeypatch):
    assert _read(name, _ctx(TRAIN, monkeypatch)) == pytest.approx(want, rel=1e-9)


def test_idle_in_pack_is_a_part_of_the_idle_window(monkeypatch):
    ctx = _ctx(ENGINE, monkeypatch)
    assert 0 < _read("device_idle.engine.pack", ctx) <= _read("device_idle.engine", ctx)


def test_overlapping_spans_count_once_in_the_idle_share(monkeypatch):
    nested = [_span("engine.pack", 0.0, 0.06, 1, None, 1),
              _span("engine.pack", 0.01, 0.02, 2, 1, 1)]
    got = _read("device_idle.engine.pack", _ctx(nested, monkeypatch, busy=[]))
    assert got == pytest.approx(100 * 0.06 / W)


@pytest.mark.parametrize("name", ["engine.pack_ms_per_batch", "engine.upload_ms_per_batch",
                                  "engine.launch_ms_per_batch", "engine.consume_ms_per_batch",
                                  "device_idle.engine.pack", "train.forward_ms_per_step",
                                  "train.backward_ms_per_step", "train.optim_ms_per_step"])
def test_no_spans_no_reading(name, monkeypatch):
    """Nothing to read gives None: no trace, no spans in the window (the
    untraced run), or a program without the recorder (an older port)."""
    spans = ENGINE + TRAIN
    assert _read(name, _ctx(spans, monkeypatch, traced=False)) is None
    assert _read(name, _ctx([s._replace(start=s.start - 50, end=s.end - 50) for s in spans],
                            monkeypatch)) is None
    ctx = _ctx(spans, monkeypatch)
    monkeypatch.delattr(tracing, "RECORDER")
    assert _read(name, ctx) is None
