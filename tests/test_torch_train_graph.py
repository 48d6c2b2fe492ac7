"""The pieces of the trainer's CUDA-graph step that run on the CPU: the key a
captured step is valid for, the snapshot and restore around the capture's
warm-up, the feed into the static buffers, and the CPU step, which stays
eager.  The graph itself is held to the eager step on the card
(tests/test_torch_train_graph_cuda.py)."""

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from clairs_to_tpu_torch import train as ttrain
from clairs_to_tpu_torch.models import bigru, cvt
from clairs_to_tpu_torch.train import DualTrainer, TrainConfig
from clairs_to_tpu_torch.utils import metrics as tracing

CVT = cvt.CvTConfig(emb_dims=(8, 16, 32), heads=(1, 1, 2), depths=(1, 1, 1))
GRU = bigru.BiGRUConfig(hidden1=16, hidden2=24)


def _trainer(dropout=0.3):
    return DualTrainer("snv", TrainConfig(dropout_rate=dropout), CVT, GRU, device="cpu")


def _batch(n, seed, dual=True):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(0, 30, size=(n, 33, 34)).astype(np.float32))
    xn = x + torch.from_numpy(rng.integers(0, 2, size=(n, 33, 34)).astype(np.float32))
    aff = torch.from_numpy(rng.integers(0, 2, size=(n, 4)))
    return [x, xn if dual else x, aff, 1 - aff]


def _key(batch, generator, rate=0.3):
    return ttrain.graph_key(*batch, generator, rate)


GEN = torch.Generator()


def _same_values_new_tensors(b):
    return [t.clone() for t in b]


def _strided(b):
    # the same values in other strides: the feed copies them into the buffers
    return [t.transpose(0, -1).contiguous().transpose(0, -1) for t in b]


def _other_values(b):
    return [t + 1 for t in b]


def _more_rows(b):
    return [torch.cat([t, t[:1]]) for t in b]


def _float64_view(b):
    return [b[0].double(), b[1], b[2], b[3]]


def _int32_labels(b):
    return [b[0], b[1], b[2].int(), b[3]]


def _aliased(b):
    return [b[0], b[0], b[2], b[3]]


@pytest.mark.parametrize("change, moves", [
    (_same_values_new_tensors, False), (_strided, False), (_other_values, False),
    (_more_rows, True), (_float64_view, True), (_int32_labels, True), (_aliased, True)],
    ids=lambda v: getattr(v, "__name__", str(v)))
def test_the_graph_key_follows_shapes_dtypes_and_aliasing_only(change, moves):
    batch = _batch(6, 1)
    assert (_key(change(batch), GEN) != _key(batch, GEN)) is moves


@pytest.mark.parametrize("other", ["generator", "no generator", "rate"])
def test_the_graph_key_follows_the_generator_and_the_dropout_rate(other):
    batch = _batch(6, 1)
    key = _key(batch, GEN)
    changed = {"generator": _key(batch, torch.Generator()),
               "no generator": _key(batch, None),
               "rate": _key(batch, GEN, 0.2)}[other]
    assert changed != key
    # the same generator object keys the same, whatever its state
    GEN.manual_seed(5)
    assert _key(batch, GEN) == key


def _state(trainer, gen):
    leaves = {k: t.detach().clone() for k, t in trainer.tensors.items()}
    opt = {k: {s: v.clone() for s, v in trainer.opt.state[t].items()}
           for k, t in trainer.tensors.items() if trainer.opt.state.get(t)}
    return leaves, opt, gen.get_state().clone()


def _assert_bitwise(a, b):
    (la, oa, ga), (lb, ob, gb) = a, b
    assert la.keys() == lb.keys() and all(torch.equal(la[k], lb[k]) for k in la)
    assert oa.keys() == ob.keys()
    for k in oa:
        assert oa[k].keys() == ob[k].keys()
        assert all(torch.equal(oa[k][s], ob[k][s]) for s in oa[k])
    assert torch.equal(ga, gb)


def test_snapshot_and_restore_around_the_warm_up_leave_the_state_bitwise():
    """A trainer one step in: the warm-up's steps move every leaf, AdamW's
    state and the generator; the restore puts each back bit for bit, in
    the same storages."""
    trainer, gen = _trainer(), torch.Generator().manual_seed(3)
    batch = _batch(6, 2)
    trainer.step(*batch, generator=gen)
    before = _state(trainer, gen)
    ptrs = {k: t.data_ptr() for k, t in trainer.tensors.items()}
    saved = trainer._snapshot(gen)
    for _ in range(ttrain.CAPTURE_WARMUP_STEPS):
        trainer._update(*batch, gen)
    moved = _state(trainer, gen)
    for net in ("aff.", "neg."):
        assert any(not torch.equal(before[0][k], moved[0][k]) for k in before[0]
                   if k.startswith(net))
    assert not torch.equal(before[2], moved[2])
    trainer._restore(saved, gen)
    _assert_bitwise(_state(trainer, gen), before)
    assert {k: t.data_ptr() for k, t in trainer.tensors.items()} == ptrs


def test_a_restored_fresh_state_steps_as_a_fresh_trainer():
    """A trainer that never stepped has no AdamW state; the warm-up creates
    it and the restore zeroes it, which is the state AdamW would create: the
    next step is bit for bit that of an untouched twin."""
    batch = _batch(6, 3)
    warmed, twin = _trainer(), _trainer()
    gw, gt = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    saved = warmed._snapshot(gw)
    for _ in range(ttrain.CAPTURE_WARMUP_STEPS):
        warmed._update(*batch, gw)
    warmed._restore(saved, gw)
    assert all(float(v.abs().max()) == 0.0 for st in warmed.opt.state.values()
               for v in st.values())
    lw = warmed.step(*batch, generator=gw)
    lt = twin.step(*batch, generator=gt)
    assert torch.equal(lw, lt)
    _assert_bitwise(_state(warmed, gw), _state(twin, gt))


@pytest.mark.parametrize("dual", [True, False], ids=["two views", "one view"])
def test_the_feed_copies_the_inputs_into_the_same_buffers(dual):
    first, second = _batch(5, 4, dual), _batch(5, 5, dual)
    inputs = [t.clone() for t in first]
    if not dual:
        inputs[1] = inputs[0]
    g = ttrain._StepGraph(_key(first, None), None, inputs, None)
    ptrs = [t.data_ptr() for t in inputs]
    g.feed(second)
    assert all(torch.equal(a, b) for a, b in zip(g.inputs, second))
    assert not any(a is b for a, b in zip(g.inputs, second))
    assert [t.data_ptr() for t in g.inputs] == ptrs and (g.inputs[1] is g.inputs[0]) is not dual


def test_the_cpu_step_stays_eager_with_its_three_spans():
    trainer, gen = _trainer(), torch.Generator().manual_seed(6)
    before = tracing.RECORDER.counters()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU]):
        for seed in (7, 8):
            trainer.step(*_batch(6, seed), generator=gen)
    names = [s.name for s in tracing.RECORDER.spans(t0)]
    assert names == ["train.forward", "train.backward", "train.optim", "train.step"] * 2
    after = tracing.RECORDER.counters()
    assert after.get("train.captures", 0) == before.get("train.captures", 0)
    assert after.get("train.replays", 0) == before.get("train.replays", 0)
    assert trainer._graph is None
    assert all(t.grad is None for t in trainer.tensors.values())
    (group,) = trainer.opt.param_groups
    assert not group["fused"] and not group["capturable"]
