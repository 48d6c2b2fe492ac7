"""The port's spans and counters (clairs_to_tpu_torch/utils/metrics.py) on
the CPU: the engine's and the trainer's spans under a profiler, none
without one, the buffer's bound, ``RunMetrics`` kept as it was and safe
from several decode workers, and ``device_trace``'s host track."""

import json
import os
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from clairs_to_tpu_torch.infer.engine import InferenceEngine
from clairs_to_tpu_torch.models import bigru, cvt
from clairs_to_tpu_torch.ops import posterior as post
from clairs_to_tpu_torch.parallel.scheduler import PrefetchPipeline
from clairs_to_tpu_torch.train import DualTrainer, TrainConfig
from clairs_to_tpu_torch.utils import metrics as tracing

torch.set_num_threads(1)
CVT = cvt.CvTConfig(emb_dims=(8, 16, 32), heads=(1, 1, 2), depths=(1, 1, 1))
GRU = bigru.BiGRUConfig(hidden1=16, hidden2=24)
ENGINE_SPANS = {"engine.dispatch": None, "engine.pack": "engine.dispatch",
                "engine.upload": "engine.dispatch", "engine.launch": "engine.dispatch",
                "engine.result": None, "engine.wait": "engine.result",
                "engine.consume": "engine.result", "engine.posterior": "engine.consume",
                "engine.strands": "engine.consume"}


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(scope="module")
def engine():
    gen = torch.Generator().manual_seed(0)
    return InferenceEngine(cvt.CvT(CVT).reset_parameters(gen),
                           bigru.BiGRU(GRU).reset_parameters(gen),
                           post.uniform_likelihood_data(4), device_batch=32,
                           cvt_config=CVT, bigru_config=GRU, device="cpu")


def _batch(n, seed, integral=True):
    rng = np.random.default_rng(seed)
    x = rng.integers(-40, 40, size=(n, 33, 34)).astype(np.int32)
    xn = x + rng.integers(-2, 3, size=x.shape).astype(np.int32)
    cov = rng.integers(10, 120, size=n).astype(np.float32)
    if not integral:
        return x + 0.25, xn + 0.25, cov, cov
    return x, xn, cov, cov


def _new_counts(before):
    after = tracing.RECORDER.counters()
    return {k: after.get(k, 0) - before.get(k, 0) for k in after}


def test_engine_batches_record_every_span_with_parent_and_one_id(engine):
    engine.run_batch(*_batch(8, 0))
    before = tracing.RECORDER.counters()
    t0 = time.perf_counter()
    with _profiled():
        first = engine.run_batch_async(*_batch(40, 1))     # two slices of 32
        second = engine.run_batch_async(*_batch(5, 2))
        first.result()
        second.result()
    spans = tracing.RECORDER.spans(t0)
    by_sid = {s.sid: s for s in spans}
    ids = sorted({s.id for s in spans})
    assert len(ids) == 2
    for bid in ids:
        mine = [s for s in spans if s.id == bid]
        assert {s.name for s in mine} == set(ENGINE_SPANS)
        for s in mine:
            want = ENGINE_SPANS[s.name]
            parent = by_sid.get(s.parent)
            assert (parent.name if parent else None) == want, s
            if parent is not None:
                assert parent.start <= s.start <= s.end <= parent.end
            assert s.thread == threading.get_native_id()
    # one launch, wait and consume a slice and two uploads (the slice's, then
    # the one replica's): the first batch has two slices; one pack a batch
    assert sum(1 for s in spans if s.id == ids[0] and s.name == "engine.launch") == 2
    assert sum(1 for s in spans if s.id == ids[1] and s.name == "engine.consume") == 1
    for bid, slices in zip(ids, (2, 1)):
        assert sum(1 for s in spans if s.id == bid and s.name == "engine.pack") == 1
        assert sum(1 for s in spans if s.id == bid and s.name == "engine.upload") == 2 * slices
    counts = _new_counts(before)
    assert counts["engine.batches"] == 2 and counts["engine.rows"] == 45
    assert counts["engine.rows_padded"] == 96 and counts["engine.float_path_batches"] == 0
    assert counts["engine.wire_fused_batches"] == 2
    assert counts["engine.h2d_bytes"] == 0        # the CPU uploads nothing


def test_each_replica_uploads_then_launches_in_turn():
    """The replicas' upload and forward interleave, one replica after the
    other, each under its own spans: replica 0's forward is not held back
    by the others' copies."""
    gen = torch.Generator().manual_seed(0)
    rep = InferenceEngine(cvt.CvT(CVT).reset_parameters(gen),
                          bigru.BiGRU(GRU).reset_parameters(gen),
                          post.uniform_likelihood_data(4), device_batch=30,
                          cvt_config=CVT, bigru_config=GRU,
                          devices=["cpu", "cpu", "cpu"])
    t0 = time.perf_counter()
    with _profiled():
        rep.run_batch(*_batch(20, 8))
    spans = sorted((s for s in tracing.RECORDER.spans(t0)
                    if s.name in ("engine.upload", "engine.launch")), key=lambda s: s.start)
    assert [s.name for s in spans] == ["engine.upload"] + ["engine.upload",
                                                           "engine.launch"] * 3


def test_engine_counts_the_float_path(engine):
    before = tracing.RECORDER.counters()
    with _profiled():
        engine.run_batch(*_batch(3, 3, integral=False))
    counts = _new_counts(before)
    assert counts["engine.float_path_batches"] == 1 and counts["engine.rows"] == 3


def test_the_wire_routine_counts_each_batch_it_packs(engine):
    """``engine.wire_fused_batches``: one for each batch of integral views,
    two or one, int32 or cast to it; none for non-integral inputs, and
    nothing without a profiler."""
    x, xn, cov, _ = _batch(6, 9)
    before = tracing.RECORDER.counters()
    with _profiled():
        engine.run_batch(x, xn, cov, cov)                     # two int32 views
        engine.run_batch(x, x, cov, cov)                      # one
        engine.run_batch(x.astype(np.int64), xn, cov, cov)    # cast to int32
        engine.run_batch(*_batch(6, 9, integral=False))       # float32
    counts = _new_counts(before)
    assert counts["engine.wire_fused_batches"] == 3 and counts["engine.batches"] == 4
    assert counts["engine.float_path_batches"] == 1
    before = tracing.RECORDER.counters()
    engine.run_batch(x, xn, cov, cov)
    assert tracing.RECORDER.counters() == before


def test_trainer_step_records_three_children():
    trainer = DualTrainer("snv", TrainConfig(dropout_rate=0.0), CVT, GRU, device="cpu")
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.integers(0, 30, size=(6, 33, 34)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 2, size=(6, 4)))
    t0 = time.perf_counter()
    with _profiled():
        trainer.step(x, x, labels, 1 - labels)
    spans = tracing.RECORDER.spans(t0)
    assert [s.name for s in spans] == ["train.forward", "train.backward", "train.optim",
                                       "train.step"]
    step = spans[-1]
    assert step.parent is None
    for child in spans[:-1]:
        assert child.parent == step.sid and step.start <= child.start <= child.end <= step.end
    assert spans[0].end <= spans[1].start and spans[1].end <= spans[2].start


def test_nothing_recorded_without_a_profiler(engine):
    trainer = DualTrainer("snv", TrainConfig(dropout_rate=0.0), CVT, GRU, device="cpu")
    x = torch.zeros(2, 33, 34)
    labels = torch.zeros(2, 4, dtype=torch.long)
    before = tracing.RECORDER.counters()
    t0 = time.perf_counter()
    engine.run_batch(*_batch(4, 5))
    trainer.step(x, x, labels, 1 - labels)
    with tracing.span("outside"):
        tracing.count("outside")
    assert not torch.autograd._profiler_enabled()
    assert tracing.RECORDER.spans(t0) == []
    assert tracing.RECORDER.counters() == before


def test_the_buffer_keeps_its_bound():
    rec = tracing.Recorder(capacity=8)
    with _profiled():
        for i in range(20):
            with rec.span(f"s{i}"):
                pass
    names = [s.name for s in rec.spans()]
    assert names == [f"s{i}" for i in range(12, 20)] and rec.dropped == 12


def test_ids_are_inherited_and_given_ids_kept():
    rec = tracing.Recorder()
    with _profiled():
        with rec.span("outer", "chunk:0"):
            with rec.span("inner"):
                with rec.span("own", 7):
                    pass
    own, inner, outer = rec.spans()
    assert (outer.id, inner.id, own.id) == ("chunk:0", "chunk:0", 7)
    assert (outer.parent, inner.parent, own.parent) == (None, outer.sid, inner.sid)


def test_run_metrics_summary_keeps_its_keys():
    m = tracing.RunMetrics()
    with m.stage("calling"):
        time.sleep(0.01)
    with pytest.raises(ValueError):
        with m.stage("calling"):
            raise ValueError
    m.count("candidates", 3)
    m.count("candidates")
    out = types.SimpleNamespace(lines=[], write=lambda s: out.lines.append(s))
    s = m.report(out)
    assert set(s) == {"total_seconds", "stages", "counters"}
    assert s["counters"] == {"candidates": 4} and s["stages"]["calling"] >= 0.01
    assert out.lines[0].startswith("[INFO] RunMetricsSummary: {")
    assert json.loads(out.lines[0].split("RunMetricsSummary: ", 1)[1]) == s
    assert out.lines[1] == f"[INFO]   stage calling: {s['stages']['calling']}s\n"


def test_a_stage_records_a_span_under_a_profiler_only():
    m = tracing.RunMetrics()
    t0 = time.perf_counter()
    with m.stage("off"):
        pass
    with _profiled():
        with m.stage("on", "chr1:0"):
            pass
    assert [(s.name, s.id) for s in tracing.RECORDER.spans(t0)] == [("on", "chr1:0")]
    assert set(m.stage_seconds) == {"off", "on"}


def test_decode_workers_lose_no_stage_seconds(monkeypatch):
    """More workers than cores add to one stage at once: each stage lasts
    exactly half a second of a per-thread clock, so a lost update shows as
    a shortfall of the sum."""
    clock = threading.local()

    def perf_counter():
        clock.t = getattr(clock, "t", 0.0) + 0.5
        return clock.t

    monkeypatch.setattr(tracing, "time", types.SimpleNamespace(perf_counter=perf_counter))
    m = tracing.RunMetrics()
    per_item, items = 400, 2 * (os.cpu_count() or 1) + 4

    def decode(_item):
        for _ in range(per_item):
            with m.stage("decode_tensor_build(worker)"):
                pass
        return _item

    got = []

    def consume():
        got.extend(i for i, _res in PrefetchPipeline(decode, range(items), depth=items,
                                                     workers=items))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        consumer = threading.Thread(target=consume, daemon=True)
        consumer.start()
        consumer.join(120)
    finally:
        sys.setswitchinterval(interval)
    assert not consumer.is_alive() and got == list(range(items))
    assert m.stage_seconds["decode_tensor_build(worker)"] == 0.5 * per_item * items


def test_the_caller_waits_for_decode_under_a_span():
    rec_before = time.perf_counter()
    release = threading.Event()

    def decode(item):
        release.wait(5)
        return item

    def later():
        time.sleep(0.05)
        release.set()

    threading.Thread(target=later, daemon=True).start()
    with _profiled():
        got = [i for i, _res in PrefetchPipeline(decode, range(3), workers=2)]
    assert got == [0, 1, 2]
    waits = [s for s in tracing.RECORDER.spans(rec_before) if s.name == "decode.wait"]
    assert len(waits) == 3 and waits[0].end - waits[0].start >= 0.03
    assert all(s.thread == threading.get_native_id() for s in waits)


def test_device_trace_writes_the_spans_on_the_trace_clock(engine, tmp_path):
    engine.run_batch(*_batch(4, 6))
    with tracing.device_trace(str(tmp_path)):
        engine.run_batch(*_batch(4, 7))
    trace = json.load(open(tmp_path / "trace.json"))
    events = trace["traceEvents"]
    host = [e for e in events if e.get("cat") == "program_span"]
    assert {e["name"] for e in host} == set(ENGINE_SPANS)
    assert len({e["args"]["id"] for e in host}) == 1
    # what the counters counted in the window, as counter tracks from 0
    counts = [e for e in events if e.get("cat") == "program_counter"]
    assert {e["name"] for e in counts} >= {"engine.batches", "engine.rows",
                                            "engine.rows_padded", "engine.h2d_bytes"}
    rows = sorted((e for e in counts if e["name"] == "engine.rows"), key=lambda e: e["ts"])
    assert [e["args"]["value"] for e in rows] == [0, 4] and all(e["ph"] == "C" for e in rows)
    assert rows[0]["ts"] <= min(e["ts"] for e in host)
    assert rows[1]["ts"] >= max(e["ts"] + e["dur"] for e in host)
    # the CPU trace: the engine's operations fall inside its spans
    launch = next(e for e in host if e["name"] == "engine.launch")
    ops = [e for e in events if e.get("cat") == "cpu_op" and e["name"].startswith("aten::")
           and launch["ts"] <= e["ts"] <= launch["ts"] + launch["dur"]]
    assert ops
    dispatch = next(e for e in host if e["name"] == "engine.dispatch")
    first_op = min(e["ts"] for e in events if e.get("cat") == "cpu_op"
                   and e["name"] != "aten::fill_")
    assert dispatch["ts"] <= first_op


def test_device_trace_without_a_directory_records_nothing():
    t0 = time.perf_counter()
    with tracing.device_trace(None):
        with tracing.span("x"):
            pass
    assert tracing.RECORDER.spans(t0) == []
