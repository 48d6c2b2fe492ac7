"""A run past the look for a card, on the CPU at a small size, with the
timed path broken underneath, comes out not correct; a sound one correct."""

import json

import pytest

from h100_bench import run
from h100_bench.benchlib import faults

GENOME = run.load_json(run.BENCH, "workloads", "ont_flagship.genome_call.json")["genome"]
SMALL = {"ont_flagship.engine_stream": {"device_batch": 16, "pool": {"snv": 2, "indel": 1},
                                        "order": [["snv", 1], ["indel", 1]],
                                        "warm_batches": 2},
         "ont_flagship.train_snv": {"rows": 16, "pool": 4},
         "ont_flagship.genome_call": {"genome": dict(GENOME, genome_len=40_000, n_snv=6, n_indel=6),
                                      "device_batch": 256}}
CELL_OF = {"engine": "ont_flagship.engine_stream", "train": "ont_flagship.train_snv",
           "call": "ont_flagship.genome_call"}


@pytest.fixture(autouse=True)
def _genome_cache(tmp_path_factory, monkeypatch):
    """The genome cell's files in a directory of the test session's own."""
    monkeypatch.setattr(run, "CACHE", str(tmp_path_factory.getbasetemp() / "h100_bench"))


def _run(cell, capsys, seed=2 ** 31 + 101):
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", "0.3"],
                  device="cpu", spec_overrides=SMALL[cell])
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_sound_run_is_correct(cell, capsys):
    line = _run(cell, capsys)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_a_fault_is_not_correct(fault, monkeypatch, capsys):
    faults.plant(fault, monkeypatch.setattr)
    line = _run(CELL_OF[fault.split(".")[0]], capsys)
    assert line["correct"] is False and line["failed"] == 0
