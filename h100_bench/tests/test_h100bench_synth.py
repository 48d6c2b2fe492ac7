"""The benchmark's generator: the same tensors for a seed, valid counts,
and labels that follow the tensors."""

import numpy as np
import pytest
import torch

from h100_bench.benchlib import synth

BLOCKS = (0, 9, synth.CH["ALMQ"], synth.CH["aLMQ"], synth.CH["ALBQ"], synth.CH["aLBQ"])


@pytest.mark.parametrize("mode", ["snv", "indel"])
def test_same_seed_same_batch(mode):
    a = synth.dual_batch(2 ** 31 + 17, 300, mode=mode)
    b = synth.dual_batch(2 ** 31 + 17, 300, mode=mode)
    c = synth.dual_batch(2 ** 31 + 18, 300, mode=mode)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])


def test_pool_seeds_are_fixed_by_the_seed():
    assert synth.batch_seeds(5, 4) == synth.batch_seeds(5, 4)
    assert synth.batch_seeds(5, 4)[:2] == synth.batch_seeds(5, 2)
    assert len(set(synth.batch_seeds(3_000_000_001, 16))) == 16


@pytest.mark.parametrize("mode,dual", [("snv", True), ("indel", True), ("snv", False)])
def test_counts_are_valid(mode, dual):
    xa, xn, ca, cn, som = synth.to_host(synth.dual_batch(11, 2000, mode=mode, dual=dual))
    assert xa.dtype == np.int32 and xa.shape == (2000, 33, 34) and (xn is xa) == (not dual)
    assert ca.dtype == np.float32 and (ca >= 25).all() and (ca == cn).all()
    for x in (xa, xn):
        for b in BLOCKS:
            block = x[..., b:b + 4]
            # one entry of each block is minus the block's total, the rest counts
            assert ((block < 0).sum(-1) <= 1).all()
            assert (block.sum(-1) <= 0).all()
    # the NEG view holds the AFF view's bases and the low-BQ ones beside them
    assert ((xn[..., 26:34] >= 0) | (xn[..., 26:34] <= xa[..., 26:34])).all()
    if not dual:
        assert (xa == xn).all()


def test_labels_follow_the_center():
    # the NEG view holds every quality bucket of the alt reads
    _xa, xn, _ca, _cn, som = synth.to_host(synth.dual_batch(12, 4000, mode="indel"))
    center = xn[:, synth.FLANK]
    for k in (4, 5):
        rows = som == k
        chan = synth.CH["I1"] if k == 4 else synth.CH["D1"]
        rev = synth.CH["i1"] if k == 4 else synth.CH["d1"]
        assert rows.any() and (center[rows, chan] + center[rows, rev] >= synth.MIN_SUPPORT).all()
    for k in range(4):
        rows = som == k
        assert rows.any()
        fwd = np.where(center[rows, k] < 0, 0, center[rows, k])
        assert (fwd + np.where(center[rows, 9 + k] < 0, 0, center[rows, 9 + k]) > 0).all()
