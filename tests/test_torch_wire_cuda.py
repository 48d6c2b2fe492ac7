"""The engine's one-pass wire routine (``ops/wire.py``) on the card: a full
8,192-row batch of int32 dual views reaches the device as the same int16
tensors, bit for bit, as NumPy's casts and int32 delta encode, with the
same bytes and the same probabilities; and batches in flight keep their
pinned buffers.

Marked ``cuda``; each test skips where there is no GPU.  Run them on a
machine with an H100 with
``python -m pytest --noconftest -m cuda tests/test_torch_wire_cuda.py``
(``--noconftest``: tests/conftest.py imports jax, which that machine lacks).
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from clairs_to_tpu_torch.infer.engine import InferenceEngine
from clairs_to_tpu_torch.models import bigru, cvt
from clairs_to_tpu_torch.ops import posterior as post
from clairs_to_tpu_torch.utils import metrics as tracing

pytestmark = pytest.mark.cuda
ROWS = 8192
FIELDS = ("p_aff", "p_neg", "posterior", "forward_acgt", "reverse_acgt")


@pytest.fixture(scope="module")
def engine():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator().manual_seed(0)
    return InferenceEngine(cvt.CvT(cvt.SNV_CVT_CONFIG).reset_parameters(gen),
                           bigru.BiGRU(bigru.SNV_BIGRU_CONFIG).reset_parameters(gen),
                           post.uniform_likelihood_data(4), device_batch=ROWS,
                           device="cuda")


def _views(n, seed):
    rng = np.random.default_rng(seed)
    xa = rng.integers(-40, 90, size=(n, 33, 34)).astype(np.int32)
    xn = (xa + rng.integers(-3, 4, size=xa.shape)).astype(np.int32)
    return xa, xn, rng.integers(10, 120, size=n).astype(np.float32)


def _same(got, want):
    for field in FIELDS:
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))


def _numpy_wire(xa, xn, ca, cn):
    """The encoding the engine built with NumPy before the routine: int16
    casts, the delta taken in int32."""
    packed = np.zeros((xa.shape[0], 34, 34), np.int16)
    packed[:, :33] = xa.astype(np.int16)
    packed[:, 33, 0] = ca.astype(np.int16)
    packed[:, 33, 1] = cn.astype(np.int16)
    return packed, (xn.astype(np.int32) - xa).astype(np.int16)


def test_a_full_batch_reaches_the_card_as_numpy_encodes_it(engine, monkeypatch):
    xa, xn, cov = _views(ROWS, 0)
    engine.run_batch(xa, xn, cov, cov)           # builds the routine and the kernel
    sent = []
    forward = engine._forward

    def keep(packed, second, replica=0):
        p1 = forward(packed, second, replica)
        sent.append((packed.clone(), second.clone(), p1.clone()))
        return p1

    monkeypatch.setattr(engine, "_forward", keep)
    before = tracing.RECORDER.counters()
    with profile(activities=[ProfilerActivity.CUDA]):
        engine.run_batch(xa, xn, cov, cov + 2)
    after = tracing.RECORDER.counters()
    counts = {k: after.get(k, 0) - before.get(k, 0)
              for k in ("engine.wire_fused_batches", "engine.float_path_batches",
                        "engine.h2d_bytes")}
    assert counts["engine.wire_fused_batches"] == 1
    assert counts["engine.float_path_batches"] == 0
    # the packed int16 tensor (34 x 34) and the int16 delta (33 x 34) a row
    assert counts["engine.h2d_bytes"] == ROWS * (34 * 34 + 33 * 34) * 2
    (pk, dl, p1), = sent
    want_pk, want_dl = (torch.from_numpy(a).cuda() for a in _numpy_wire(xa, xn, cov, cov + 2))
    assert pk.is_cuda and pk.dtype == torch.int16 and dl.dtype == torch.int16
    # int16 equality is equality of bits; row 33 past column 1 is never read
    assert torch.equal(pk[:, :33], want_pk[:, :33])
    assert torch.equal(pk[:, 33, :2], want_pk[:, 33, :2])
    assert torch.equal(dl, want_dl)
    assert torch.equal(p1, forward(want_pk, want_dl))


def test_batches_in_flight_keep_their_pinned_buffers(engine):
    """Three batches dispatched before any result is taken each give what
    the batch gives alone: a pinned block is not handed out again while a
    copy still reads it."""
    batches = [_views(ROWS, 1), _views(ROWS, 2), _views(ROWS // 2 + 5, 3)]
    pending = [engine.run_batch_async(xa, xn, cov, cov) for xa, xn, cov in batches]
    results = [p.result() for p in pending]
    for (xa, xn, cov), got in zip(batches, results):
        _same(got, engine.run_batch(xa, xn, cov, cov))
