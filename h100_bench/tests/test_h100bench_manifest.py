"""BENCHMARK.json keeps to the benchmark's contract, and the harness finds
every cell, configuration and metric by its name."""

import json
import os
import re

import pytest

from h100_bench import run

MAN = run.manifest()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
            "per_layer"}
CELLS = {w["name"]: w for w in MAN["workloads"]}


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(MAN) == TOP_KEYS
    assert os.path.getsize(os.path.join(run.ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(MAN["paths"]) <= 16 and 1 <= len(MAN["command"]) <= 32
    for p in MAN["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and not p.startswith("/")
        assert ".." not in p.split("/") and not p.rstrip("/").endswith("_torch")
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    for word in MAN["command"]:
        assert _line(word)


def test_run_seconds_fit_a_full_check():
    # 2 + 14 x 24 runs of run_seconds + 60 s, 2 x 90 s a cell, 1200 s spare
    assert (2 + 14 * 24) * (MAN["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("entry", MAN["configs"], ids=lambda c: c["name"])
def test_config_entry(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.fullmatch(entry["name"]) and _line(entry["source"]) and _line(entry["why"])
    assert entry["file"] == f"h100_bench/configs/{entry['name']}.json"
    with open(os.path.join(run.ROOT, entry["file"])) as f:
        cfg = json.load(f)
    assert len(entry["reduced"]) <= 16
    for key in entry["reduced"]:
        assert NAME.fullmatch(key) and key in cfg
        assert not re.search(r"(_dim|_rank|hidden|heads|emb_dims|mlp_mult)$", key)
    assert cfg["reduced"] == entry["reduced"]
    assert any(w["config"] == entry["name"] for w in MAN["workloads"])


@pytest.mark.parametrize("cell", MAN["workloads"], ids=lambda w: w["name"])
def test_cell_is_found_by_name(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.fullmatch(cell["name"]) and NAME.fullmatch(cell["traffic"])
    assert cell["chips"] == 1 and _line(cell["why"])
    assert cell["config"] in {c["name"] for c in MAN["configs"]}
    driver = run.load_cell(cell["name"])[-1]
    for fn in ("setup", "window", "release", "check", "control"):
        assert callable(getattr(driver, fn))


def test_cells_unique_and_four_chip_share():
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs)) and len(CELLS) == len(MAN["workloads"])
    assert 1 <= len(CELLS) <= 24


@pytest.mark.parametrize("m", MAN["end_to_end"] + MAN["per_layer"], ids=lambda m: m["name"])
def test_metric_fields(m):
    assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"])
    assert m["better"] in ("lower", "higher")
    if m in MAN["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"])
        assert callable(run.load_file("metrics", m["name"]).read)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in m.get("workloads", []):
        assert cell in CELLS


def test_metric_names_unique_and_setup_first_class():
    names = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(names) == len(set(names))
    setup = [m for m in MAN["end_to_end"] if m["name"] == "setup_s"]
    assert len(setup) == 1 and "workloads" not in setup[0] and setup[0]["bound"] <= 0.25


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_every_cell_reports_setup_another_and_a_layer(cell):
    e2e, layer = run.cell_metrics(MAN, cell)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and layer


@pytest.mark.parametrize("m", MAN["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_cells_report_what_it_moves(m):
    moved = {e["name"]: e for e in MAN["end_to_end"]}[m["moves"]]
    for cell in m["workloads"]:
        assert cell in moved.get("workloads", [cell])


def test_one_layer_name_per_layer():
    by_layer = {}
    for m in MAN["per_layer"]:
        by_layer.setdefault(m["layer"].split(" ")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def test_the_genome_cell_and_its_metrics():
    """The genome cell reports call_cand_per_s and its four per-layer
    metrics, and no cell reports the training metrics that read nothing
    since the step became one CUDA graph."""
    cell = CELLS["ont_flagship.genome_call"]
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("ont_flagship", "genome_call", 1)
    e2e, layer = run.cell_metrics(MAN, cell["name"])
    assert {m["name"] for m in e2e} == {"call_cand_per_s", "setup_s"}
    assert {m["name"] for m in layer} == {"decode.worker_s_per_kcand", "postcall.s_per_kcand",
                                          "device_idle.call", "engine.useful_rows_pct"}
    assert all(m["moves"] == "call_cand_per_s" and m["workloads"] == [cell["name"]]
               for m in layer)
    names = {m["name"] for m in MAN["per_layer"]}
    assert not names & {"train.forward_ms_per_step", "train.backward_ms_per_step",
                        "train.optim_ms_per_step"}
    assert "train.replay_ms_per_step" in names
