"""The genome cell's per-layer metrics, each on a hand-built window: the
runs' ``RunMetricsSummary`` stage seconds and counters, the program's
engine counters, the device's busy intervals; and None where there is
nothing to read."""

import types

import pytest

from h100_bench import run

W = 10.0
RUNS = [{"rc": 0, "stages": {"decode_tensor_build(worker)": 3.0, "hard_filters": 1.0,
                             "merge": 0.25, "pon_tagging": 0.5, "verdict": 2.0, "tabix": 0.25,
                             "verdict_counts": 0.5, "device_infer": 9.0, "calling": 20.0},
         "counters": {"candidates": 2000}},
        {"rc": 0, "stages": {"decode_tensor_build(worker)": 5.0, "hard_filters": 1.5,
                             "verdict": 1.0}, "counters": {"candidates": 2000}},
        {"rc": "RuntimeError('a failed run')"}]


def _ctx(runs=RUNS, program=None, busy_s=2.5, traced=True):
    tracer = types.SimpleNamespace(window_s=W, busy_s=busy_s) if traced else None
    return types.SimpleNamespace(tracer=tracer, counters={
        "window_s": W, "runs": runs,
        "program": program if program is not None else {"engine.rows": 4096,
                                                        "engine.rows_padded": 16384}})


def _read(name, ctx):
    return run.load_file("metrics", name).read(ctx)


@pytest.mark.parametrize("name, want", [
    # 8 s of worker decode over 4,000 candidates
    ("decode.worker_s_per_kcand", 2.0),
    # hard_filters, verdict_counts, merge, pon_tagging, verdict, tabix: 7 s
    ("postcall.s_per_kcand", 1.75),
    ("device_idle.call", 75.0),
    ("engine.useful_rows_pct", 25.0),
])
def test_genome_metric_reads_its_window(name, want):
    assert _read(name, _ctx()) == pytest.approx(want)


@pytest.mark.parametrize("name, ctx", [
    ("decode.worker_s_per_kcand", _ctx(runs=[])),
    ("decode.worker_s_per_kcand", _ctx(runs=[{"rc": 1}])),
    ("postcall.s_per_kcand", _ctx(runs=[{"rc": 0, "stages": {}, "counters": {}}])),
    ("postcall.s_per_kcand", _ctx(runs=RUNS[2:])),
    ("device_idle.call", _ctx(traced=False)),
    ("engine.useful_rows_pct", _ctx(program={})),
    ("engine.useful_rows_pct", _ctx(program={"engine.rows": 5})),
])
def test_nothing_to_read_no_reading(name, ctx):
    assert _read(name, ctx) is None


def test_postcall_counts_the_stages_after_inference_only():
    from h100_bench.benchlib import metrics_common

    assert set(metrics_common.POSTCALL) == {"hard_filters", "verdict_counts", "merge",
                                        "pon_tagging", "verdict", "tabix"}
    only_decode = [{"rc": 0, "stages": {"decode_tensor_build(worker)": 4.0, "calling": 9.0},
                    "counters": {"candidates": 1000}}]
    assert _read("postcall.s_per_kcand", _ctx(runs=only_decode)) == 0.0
