"""The Illumina cell on the CPU at a small size: a sound run is correct,
and each fault of ``benchlib/faults_ilmn.py`` planted under the timed path
makes it not correct."""

import json

import pytest

from h100_bench import run
from h100_bench.benchlib import faults_ilmn

CELL = "ilmn_flagship.genome_call"
GENOME = dict(run.load_json(run.BENCH, "workloads", CELL + ".json")["genome"],
              genome_len=100_000)
SMALL = {"genome": GENOME, "device_batch": 256,
         "run_args": ["-p", "ilmn", "--chunk_size", "40000", "-t", "5"]}
SEED = 3_000_000_001      # its genome holds a call certain to fail the realignment filter


@pytest.fixture(autouse=True)
def _genome_cache(tmp_path_factory, monkeypatch):
    monkeypatch.setattr(run, "CACHE", str(tmp_path_factory.getbasetemp() / "h100_bench"))


def _run(capsys):
    rc = run.main(["--workload", CELL, "--seed", str(SEED), "--seconds", "0.1"],
                  device="cpu", spec_overrides=SMALL)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_a_sound_run_is_correct(capsys):
    line = _run(capsys)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0


@pytest.mark.parametrize("fault", faults_ilmn.FAULTS)
def test_a_fault_is_not_correct(fault, monkeypatch, capsys):
    faults_ilmn.plant(fault, monkeypatch.setattr)
    line = _run(capsys)
    assert line["correct"] is False and line["failed"] == 0
    print(fault, json.dumps(line["checks"]))


def test_a_genome_without_a_certain_tag_is_drawn_again(monkeypatch, tmp_path):
    """Where the seed's genome holds no call certain to fail the
    realignment filter, set-up draws the seed's next genome; it raises
    where none of them holds one."""
    import torch

    _man, cell, config, spec, driver = run.load_cell(CELL, SMALL)
    ctx = run.Ctx(cell, config, spec, SEED, 0.0, False, torch.device("cpu"))
    ctx.cache = str(tmp_path)
    found, looked = driver.certain_realignment, []

    def not_the_first(exp):
        looked.append(exp)
        return None if len(looked) == 1 else found(exp)

    monkeypatch.setattr(driver, "certain_realignment", not_the_first)
    state = driver.setup(ctx)
    k = len(looked) - 1
    assert k >= 1 and state["genome_seed"] == SEED + (k << 48)
    assert state["exp"] is looked[-1] and state["warm"]["rc"] == 0
    monkeypatch.setattr(driver, "certain_realignment", lambda exp: None)
    monkeypatch.setattr(driver, "REDRAWS", 1)
    with pytest.raises(RuntimeError, match="realignment filter"):
        driver.setup(ctx)
