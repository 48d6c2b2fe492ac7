"""The port's spans on the card: the profiler's flag under a CUDA-only
profile (the benchmark's traced window runs one), the engine's spans under
it, and ``device_trace``'s anchor, which puts a batch's kernels inside its
spans on the shared clock.

Marked ``cuda``; each test skips where there is no GPU.  Run them on a
machine with an H100 with
``python -m pytest --noconftest -m cuda tests/test_torch_tracing_cuda.py``
(``--noconftest``: tests/conftest.py imports jax, which that machine lacks).
"""

import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from clairs_to_tpu_torch.infer.engine import InferenceEngine
from clairs_to_tpu_torch.models import bigru, cvt
from clairs_to_tpu_torch.ops import posterior as post
from clairs_to_tpu_torch.utils import metrics as tracing

pytestmark = pytest.mark.cuda
ENGINE_SPANS = {"engine.dispatch", "engine.pack", "engine.upload", "engine.launch",
                "engine.result", "engine.wait", "engine.consume", "engine.posterior",
                "engine.strands"}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@pytest.fixture(scope="module")
def engine():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator().manual_seed(0)
    return InferenceEngine(cvt.CvT(cvt.SNV_CVT_CONFIG).reset_parameters(gen),
                           bigru.BiGRU(bigru.SNV_BIGRU_CONFIG).reset_parameters(gen),
                           post.uniform_likelihood_data(4), device_batch=1024,
                           device="cuda")


def _batch(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-40, 40, size=(n, 33, 34)).astype(np.int32)
    xn = x + rng.integers(-2, 3, size=x.shape).astype(np.int32)
    cov = rng.integers(10, 120, size=n).astype(np.float32)
    return x, xn, cov, cov


def test_the_profiler_flag_reads_true_under_a_cuda_only_profile(engine):
    assert not torch.autograd._profiler_enabled()
    with profile(activities=[ProfilerActivity.CUDA]):
        assert torch.autograd._profiler_enabled()
    assert not torch.autograd._profiler_enabled()


def test_the_engine_records_its_spans_under_a_cuda_only_profile(engine):
    engine.run_batch(*_batch(1000, 0))
    before = tracing.RECORDER.counters()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]):
        engine.run_batch_async(*_batch(1000, 1)).result()
    spans = tracing.RECORDER.spans(t0)
    assert {s.name for s in spans} == ENGINE_SPANS and len({s.id for s in spans}) == 1
    after = tracing.RECORDER.counters()
    # the packed int16 tensor (34 x 34) and the int16 delta (33 x 34) a row
    assert after["engine.h2d_bytes"] - before.get("engine.h2d_bytes", 0) == \
        1024 * (34 * 34 + 33 * 34) * 2


def test_device_trace_puts_the_batch_kernels_inside_its_spans(engine, tmp_path):
    engine.run_batch(*_batch(1000, 2))
    with tracing.device_trace(str(tmp_path)):
        engine.run_batch_async(*_batch(1000, 3)).result()
    trace = json.load(open(tmp_path / "trace.json"))
    events = trace["traceEvents"]
    assert not [e for e in events if e.get("cat") == "cpu_op"]     # CUDA activity only
    host = {e["name"]: e for e in events if e.get("cat") == "program_span"}
    assert set(host) == ENGINE_SPANS
    device = sorted((e for e in events if e.get("cat") in DEVICE_CATS), key=lambda e: e["ts"])
    batch = device[2:]                  # the warm-up and the anchor left out
    kernels = [e for e in batch if e["cat"] == "kernel"]
    assert kernels
    launch, wait = host["engine.launch"], host["engine.wait"]
    assert min(e["ts"] for e in kernels) >= launch["ts"]
    assert max(e["ts"] + e["dur"] for e in batch) <= wait["ts"] + wait["dur"]
    upload = host["engine.upload"]
    h2d = [e for e in batch if "HtoD" in e["name"]]
    assert h2d and min(e["ts"] for e in h2d) >= upload["ts"]
    batches = [e["args"]["value"] for e in events
               if e.get("cat") == "program_counter" and e["name"] == "engine.batches"]
    assert max(batches) == 1                # the window's batch, not the warm-up's
