"""The Illumina cell's realignment metrics, each on a hand-built window of
runs' ``RunMetricsSummary`` stage seconds and counters; and None where
there is nothing to read: no run, no candidate, no checked call, or a
program that times no ``realign_filter`` stage."""

import types

import pytest

from h100_bench import run

RUNS = [{"rc": 0, "stages": {"realign_filter": 3.0, "hard_filters": 3.5, "verdict": 1.0},
         "counters": {"candidates": 1000, "realign_sites": 600, "realign_reads": 70_000}},
        {"rc": 0, "stages": {"realign_filter": 1.0, "hard_filters": 1.25},
         "counters": {"candidates": 1000, "realign_sites": 200}},
        {"rc": "RuntimeError('a failed run')"}]


def _read(name, runs):
    ctx = types.SimpleNamespace(tracer=None, counters={"window_s": 10.0, "runs": runs})
    return run.load_file("metrics", name).read(ctx)


@pytest.mark.parametrize("name, want", [
    ("realign.s_per_kcand", 2.0),      # 4 s over 2,000 candidates
    ("realign.ms_per_site", 5.0),      # 4 s over 800 checked calls
])
def test_realign_metric_reads_its_window(name, want):
    assert _read(name, RUNS) == pytest.approx(want)


PARENT = [{"rc": 0, "stages": {"hard_filters": 3.5}, "counters": {"candidates": 1000}}]


@pytest.mark.parametrize("name", ["realign.s_per_kcand", "realign.ms_per_site"])
@pytest.mark.parametrize("runs", [
    [], RUNS[2:], PARENT,
    [{"rc": 0, "stages": {"realign_filter": 0.0}, "counters": {}}],
], ids=["no_run", "failed_run", "no_stage", "no_candidate"])
def test_nothing_to_read_no_reading(name, runs):
    assert _read(name, runs) is None


def test_the_stage_is_inside_postcall_and_not_counted_twice():
    """``postcall.s_per_kcand`` sums ``hard_filters``, which holds the
    realignment filter, and not ``realign_filter`` itself."""
    from h100_bench.benchlib import metrics_common

    assert "realign_filter" not in metrics_common.POSTCALL
    assert _read("postcall.s_per_kcand", RUNS) == pytest.approx(1e3 * 5.75 / 2000)


def test_the_ilmn_cell_reports_its_metrics():
    """The Illumina cell reports call_cand_per_s, the genome cell's four
    per-layer metrics and the two realignment metrics, all moving
    call_cand_per_s; the realignment metrics are read in no other cell."""
    man = run.manifest()
    e2e, layer = run.cell_metrics(man, "ilmn_flagship.genome_call")
    assert {m["name"] for m in e2e} == {"call_cand_per_s", "setup_s"}
    assert {m["name"] for m in layer} == {
        "decode.worker_s_per_kcand", "postcall.s_per_kcand", "device_idle.call",
        "engine.useful_rows_pct", "realign.s_per_kcand", "realign.ms_per_site"}
    assert all(m["moves"] == "call_cand_per_s" for m in layer)
    for m in layer:
        want = (["ilmn_flagship.genome_call"] if m["name"].startswith("realign.")
                else ["ont_flagship.genome_call", "ilmn_flagship.genome_call"])
        assert m["workloads"] == want
