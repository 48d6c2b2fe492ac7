"""The trainer's CUDA-graph step on the card, held to the eager step.

Two flagship SNV trainers start from the same weights and generator seed;
one steps through ``DualTrainer.step`` (the captured graph, replayed), the
other through ``_eager_step`` (the same kernels launched one at a time).
Over five steps on batches in tensors of their own, dropout on: the losses,
the leaves and AdamW's first moments agree, the generator ends at the same
offset, the first step is already a replay, each step returns a tensor of its
own, and the gradients stay the graph's buffers.  A new batch shape captures
once more.

The step runs no cuDNN kernel: the CvT's convolutions are cuBLAS GEMMs
over its tokens and its depthwise projections the hand-written pair, and
every kernel of the step sums in an order fixed by the shapes.  So two
replays of the graph from one snapshot leave the leaves equal bit for bit,
and the graph and the eager step agree to 1e-6.

The spans and counters of a capture are checked on a step of their own,
under a CUDA-only profile as in the benchmark's traced window, with cuDNN's
default algorithms: a capture profiled with cuDNN held deterministic, or
under a profile of CPU activity, left later CUDA-only profiles of the
process blind to their first operations (torch 2.11), which breaks
``device_trace``'s anchor.

Marked ``cuda``; each test skips where there is no GPU.  Run them on a
machine with an H100 with
``python -m pytest --noconftest -m cuda tests/test_torch_train_graph_cuda.py``
(``--noconftest``: tests/conftest.py imports jax, which that machine lacks).
"""

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from clairs_to_tpu_torch.models import bigru, cvt
from clairs_to_tpu_torch.train import DualTrainer, TrainConfig
from clairs_to_tpu_torch.utils import metrics as tracing

pytestmark = pytest.mark.cuda
ROWS, STEPS, SEED = 96, 5, 2 ** 31 + 17
REL = 1e-6


def _batch(rows, seed, device="cuda"):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 40, size=(rows, 33, 34)).astype(np.float32)
    xn = x + rng.integers(0, 3, size=x.shape).astype(np.float32)
    som = rng.integers(-1, 4, size=rows)
    aff = np.stack([som == k for k in range(4)], axis=1).astype(np.int64)
    return [torch.from_numpy(a).to(device) for a in (x, xn, aff, 1 - aff)]


def _new_counts(before):
    after = tracing.RECORDER.counters()
    return {k: after.get(k, 0) - before.get(k, 0) for k in ("train.captures", "train.replays")}


def _rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


@pytest.fixture(scope="module")
def runs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tc = TrainConfig(dropout_rate=0.3)
    graphed = DualTrainer("snv", tc, device="cuda")
    eager = DualTrainer("snv", tc, device="cuda")
    for net in ("aff", "neg"):
        eager.models[net].load_state_dict(graphed.models[net].state_dict())
    gens = [torch.Generator(device="cuda").manual_seed(SEED) for _ in range(2)]
    batches = [_batch(ROWS, s) for s in range(STEPS)]
    replays = []
    replay = torch.cuda.CUDAGraph.replay
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda.CUDAGraph, "replay", lambda g: replays.append(g) or replay(g))
        losses = [graphed.step(*batches[0], generator=gens[0])]
        torch.cuda.synchronize()
        # the capture runs nothing: the static loss holds a value only once replayed
        first = dict(replays=len(replays), static_loss=graphed._graph.loss.clone(),
                     grads={k: t.grad.data_ptr() for k, t in graphed.tensors.items()})
        losses += [graphed.step(*b, generator=gens[0]) for b in batches[1:]]
    first["all_replays"] = len(replays)
    want = [eager._eager_step(*b, generator=gens[1]) for b in batches]
    torch.cuda.synchronize()
    return dict(graphed=graphed, eager=eager, gens=gens, losses=losses, want=want, first=first)


def _tiny_trainer():
    cfg_c = cvt.CvTConfig(emb_dims=(8, 16, 32), heads=(1, 1, 2), depths=(1, 1, 1))
    cfg_g = bigru.BiGRUConfig(hidden1=16, hidden2=24)
    return DualTrainer("snv", TrainConfig(dropout_rate=0.3), cfg_c, cfg_g, device="cuda")


def test_each_graphed_step_gives_the_eager_loss(runs):
    for got, want in zip(runs["losses"], runs["want"]):
        assert _rel(got, want) <= REL, (float(got), float(want))


def test_leaves_and_first_moments_agree_after_the_last_step(runs):
    g, e = runs["graphed"], runs["eager"]
    for k in g.tensors:
        tg, te = g.tensors[k], e.tensors[k]
        assert _rel(tg.detach(), te.detach()) <= REL, k
        assert _rel(g.opt.state[tg]["exp_avg"], e.opt.state[te]["exp_avg"]) <= REL, k
    assert float(g.opt.state[tg]["step"]) == float(e.opt.state[te]["step"]) == STEPS


def test_the_generator_ends_at_the_eager_offset(runs):
    got, want = runs["gens"]
    assert torch.equal(got.get_state(), want.get_state())
    assert got.get_offset() > 0


def test_the_first_step_of_a_key_is_a_replay(runs):
    first = runs["first"]
    assert first["replays"] == 1 and first["all_replays"] == STEPS
    assert torch.equal(first["static_loss"], runs["losses"][0])
    assert torch.equal(runs["losses"][0], runs["want"][0])


def test_a_capture_records_its_spans_and_counters():
    """The first step of a key: ``train.step`` around ``train.capture`` (the
    three warm-up steps' and the captured step's ``train.forward``,
    ``train.backward``, ``train.optim``), ``train.feed`` and ``train.replay``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    trainer, gen = _tiny_trainer(), torch.Generator(device="cuda").manual_seed(7)
    before = tracing.RECORDER.counters()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]):
        trainer.step(*_batch(24, 9), generator=gen)
        torch.cuda.synchronize()
    assert _new_counts(before) == {"train.captures": 1, "train.replays": 1}
    spans = tracing.RECORDER.spans(t0)
    (step,) = [s for s in spans if s.name == "train.step"]
    top = [s.name for s in spans if s.parent == step.sid]
    assert top == ["train.capture", "train.feed", "train.replay"]
    (capture,) = [s for s in spans if s.name == "train.capture"]
    inside = [s.name for s in spans if s.parent == capture.sid]
    assert inside == ["train.forward", "train.backward", "train.optim"] * 4


def test_each_step_returns_a_tensor_of_its_own(runs):
    losses, static = runs["losses"], runs["graphed"]._graph.loss
    ptrs = {t.data_ptr() for t in losses}
    assert len(ptrs) == STEPS and static.data_ptr() not in ptrs
    assert len({float(t) for t in losses}) == STEPS
    assert all(torch.isfinite(t) for t in losses)


def test_the_gradients_are_the_graph_buffers(runs):
    g = runs["graphed"]
    grads = {k: t.grad for k, t in g.tensors.items()}
    assert all(v is not None and bool(torch.isfinite(v).all()) for v in grads.values())
    assert {k: v.data_ptr() for k, v in grads.items()} == runs["first"]["grads"]


def test_a_new_batch_shape_captures_once_more():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    trainer, gen = _tiny_trainer(), torch.Generator(device="cuda").manual_seed(3)
    before = tracing.RECORDER.counters()
    with profile(activities=[ProfilerActivity.CUDA]):
        for rows, seed in ((32, 0), (32, 1), (20, 2), (20, 3), (32, 4)):
            trainer.step(*_batch(rows, seed), generator=gen)
    assert _new_counts(before) == {"train.captures": 3, "train.replays": 5}
    assert trainer._graph.inputs[0].shape[0] == 32


def test_two_replays_from_one_snapshot_give_bit_equal_leaves():
    """The flagship step as the benchmark's training cell runs it (800
    rows): restored to one snapshot of the leaves,
    AdamW's state and the generator, two replays of the graph leave every
    leaf equal bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    trainer = DualTrainer("snv", TrainConfig(dropout_rate=0.3), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    batch = _batch(800, 11)
    trainer.step(*batch, generator=gen)   # the capture, then its first replay
    saved = trainer._snapshot(gen)
    leaves = []
    for _ in range(2):
        trainer._restore(saved, gen)
        trainer.step(*batch, generator=gen)
        torch.cuda.synchronize()
        leaves.append({k: t.detach().clone() for k, t in trainer.tensors.items()})
    assert trainer._graph is not None and len(leaves[0]) == len(trainer.tensors)
    assert [k for k in leaves[0] if not torch.equal(leaves[0][k], leaves[1][k])] == []
