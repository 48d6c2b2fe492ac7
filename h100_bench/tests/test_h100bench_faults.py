"""A run past the look for a card, on the CPU at a small size, with the
timed path broken underneath, comes out not correct; a sound one correct."""

import json

import pytest

from h100_bench import run
from h100_bench.benchlib import faults

SMALL = {"ont_flagship.engine_stream": {"device_batch": 16, "pool": {"snv": 2, "indel": 1},
                                        "order": [["snv", 1], ["indel", 1]],
                                        "warm_batches": 2},
         "ont_flagship.train_snv": {"rows": 16, "pool": 4}}


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
    cell = "ont_flagship.engine_stream" if fault.startswith("engine.") else "ont_flagship.train_snv"
    assert _run(cell, capsys)["correct"] is False
