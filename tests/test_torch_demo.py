"""The port's demo (clairs_to_tpu_torch/bench/demo.py) against the JAX
package's: with the committed demo networks both call the same rows and
score the same; without them the port trains, calibrates and calls."""

import os

import pytest
import torch

import jax_native_libs
from clairs_to_tpu.bench.demo import run_demo as jax_demo
from clairs_to_tpu_torch.bench import demo as tdemo

torch.set_num_threads(1)
GENOME = 20_000


@pytest.fixture(scope="module", autouse=True)
def _jax_native_libs():
    """The JAX side runs on its C++ libraries (tests/jax_native_libs.py)."""
    jax_native_libs.load_all()


def _rows(path):
    """Per row: what must be equal, then QUAL."""
    out = []
    for line in open(path):
        if not line.startswith("#"):
            c = line.rstrip("\n").split("\t")
            out.append((tuple(c[:5] + c[6:]), float(c[5])))
    return out


def test_demo_with_assets_matches_jax(tmp_path):
    want = jax_demo(str(tmp_path / "jax"), genome_len=GENOME, device_batch=256)
    got = tdemo.run_demo(str(tmp_path / "torch"), genome_len=GENOME, device_batch=256,
                         device="cpu")
    assert (got.tp, got.fp, got.fn) == (want.tp, want.fp, want.fn)
    assert (got.f1, got.precision, got.recall) == (want.f1, want.precision, want.recall)
    assert got.report == want.report
    jr, tr = _rows(want.vcf_path), _rows(got.vcf_path)
    assert [r[0] for r in tr] == [r[0] for r in jr] and tr
    # QUAL follows the float32 forward (ROADMAP Queue 3: within 0.01)
    assert max(abs(a[1] - b[1]) for a, b in zip(jr, tr)) <= 0.01
    assert got.tp > 0 and got.f1 > 0.5, got.report


def test_demo_trains_without_assets(tmp_path, monkeypatch):
    """No model directory: train the tiny networks for one epoch on
    synthesized tensors, calibrate on a simulated BAM, call another."""
    calls = []
    real = tdemo.DualTrainer

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(tdemo, "DualTrainer", spy)
    res = tdemo.run_demo(str(tmp_path), genome_len=GENOME, epochs=1, device_batch=256,
                         model_dir=None, device="cpu")
    assert calls and calls[0]["device"] == "cpu" and calls[0]["tc"].epochs == 1
    assert calls[0]["cvt_config"] == tdemo.TINY_CVT
    assert os.path.exists(res.vcf_path) and "Precision" in res.report
    assert res.tp + res.fn > 0 and 0.0 <= res.f1 <= 1.0
