"""The benchmark's FLOP and byte counts against FlopCounterMode on the
plain reference nets and against chip_smoke.py's bounds."""

import os

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from h100_bench import run
from h100_bench.benchlib import flops
from h100_bench.reference import nets

CFG = run.load_json(run.BENCH, "configs", "ont_flagship.json")


def _params(mode, kind, device="cpu"):
    sub = "" if mode == "snv" else "indel/"
    return nets.load_npz(os.path.join(run.ROOT, CFG["model_dir"], sub + kind + ".npz"), device)


@pytest.mark.parametrize("mode", ["snv", "indel"])
def test_cvt_flops_match_the_counter(mode):
    p = _params(mode, "aff")
    with FlopCounterMode(display=False) as fc:
        nets.cvt_logits(p, CFG[mode]["cvt"], torch.randn(3, 33, 34))
    assert fc.get_total_flops() == 3 * flops.cvt_flops_per_row(CFG[mode]["cvt"])


@pytest.mark.parametrize("mode", ["snv", "indel"])
def test_bigru_flops_match_the_counter(mode):
    p = _params(mode, "neg")
    with FlopCounterMode(display=False) as fc:
        nets.bigru_logits(p, CFG[mode]["bigru"], torch.randn(2, 33, 34))
    assert fc.get_total_flops() == 2 * flops.bigru_flops_per_row(CFG[mode]["bigru"])


def test_pair_flops_as_published():
    # 79.8 MFLOP a row for the SNV pair, 57.2 for the indel pair
    assert flops.pair_flops_per_row(CFG["snv"]) == 34152448 + 45650944
    assert flops.pair_flops_per_row(CFG["indel"]) == 11492480 + 45717504


@pytest.mark.parametrize("B,H", [(8192, 128), (8192, 192), (800, 128), (800, 192), (256, 192)])
def test_gru_work_matches_chip_smoke(B, H):
    import chip_smoke

    fl, by = flops.gru_fwd_work(B, H)
    bound = chip_smoke.gru_bound_ms(B, H)["bound_ms"] * 1e-3
    assert np.isclose(flops.bound_s(fl, by), bound, rtol=1e-12)
    fl, by = flops.gru_bwd_work(B, H)
    smoke = chip_smoke.gru_bwd_bound_ms(B, H)
    # the same work; chip_smoke.py prices the backward's FLOP at the fp32
    # rate outside the tensor cores, the benchmark at the TF32 peak
    assert np.isclose(max(by / flops.PEAK_HBM_BYTES, fl / chip_smoke.PEAK_FP32_FLOPS),
                      smoke["bound_ms"] * 1e-3, rtol=1e-12)


def test_share_is_none_without_time():
    assert flops.share_pct(1.0, 0) is None and flops.share_pct(1.0, 2.0) == 50.0
