"""Nothing of the benchmark loads JAX or the JAX package, and the reference
loads nothing of the program.  Top-level module names are compared whole:
the port's name begins with the JAX package's."""

import glob
import json
import os
import subprocess
import sys

from h100_bench import run

LOADER = r"""
import importlib.util, json, sys
sys.path.insert(0, {root!r})
for path in {paths!r}:
    spec = importlib.util.spec_from_file_location("m" + str(abs(hash(path))), path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_names(paths):
    code = LOADER.format(root=run.ROOT, paths=paths)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, USE_FLAX="0"))
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def _files(*kinds):
    return sorted(p for k in kinds for p in glob.glob(os.path.join(run.BENCH, k, "*.py")))


def test_harness_loads_no_jax():
    tools = ("run.py", "calibrate.py", "count_candidates.py")
    paths = ([os.path.join(run.BENCH, f) for f in tools]
             + _files("benchlib", "traffic", "metrics", "reference"))
    names = _top_names(paths)
    assert not names & {"jax", "jaxlib", "flax", "clairs_to_tpu"}


def test_reference_loads_nothing_of_the_program():
    names = _top_names(_files("reference") + [os.path.join(run.BENCH, "benchlib",
                                                           "genome_sim.py")])
    assert not names & {"jax", "jaxlib", "flax", "clairs_to_tpu", "clairs_to_tpu_torch"}


def test_a_run_that_loads_jax_prints_no_result(monkeypatch, capsys):
    import types

    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc = run.main(["--workload", "ont_flagship.engine_stream", "--seed", "5", "--seconds",
                   "0.2"], device="cpu",
                  spec_overrides={"device_batch": 8, "pool": {"snv": 1, "indel": 1}})
    assert rc != 0 and "{" not in capsys.readouterr().out


def test_no_card_no_result(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "ont_flagship.train_snv", "--seed", "5", "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_without_the_program_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, a run exits with another code than 0 and prints no result."""
    import shutil

    shutil.copy(os.path.join(run.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(run.BENCH, tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, '.'); from h100_bench import run; "
            "sys.exit(run.main(['--workload', 'ont_flagship.engine_stream', '--seed', '1', "
            "'--seconds', '1'], device='cpu'))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode != 0 and "{" not in out.stdout
