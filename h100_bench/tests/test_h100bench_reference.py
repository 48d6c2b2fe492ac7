"""The plain reference against the port's plain CPU path at a small size."""

import os

import numpy as np
import pytest
import torch

from h100_bench import run
from h100_bench.benchlib import synth
from h100_bench.reference import nets, posterior, train

CFG = run.load_json(run.BENCH, "configs", "ont_flagship.json")
MODEL = os.path.join(run.ROOT, CFG["model_dir"])


def _engine(mode):
    from clairs_to_tpu_torch.cli.run import build_parser, load_engines

    args = build_parser().parse_args(["-T", os.devnull, "-R", os.devnull, "-o", os.devnull,
                                      "-p", "ont", "--device", "cpu", "--model_dir", MODEL,
                                      "--device_batch", "64"])
    return load_engines(args)[0 if mode == "snv" else 1]


@pytest.mark.parametrize("mode", ["snv", "indel"])
def test_engine_answers_match_the_reference(mode):
    eng = _engine(mode)
    xa, xn, ca, cn, _som = synth.to_host(synth.dual_batch(21, 48, mode=mode))
    res = eng.run_batch(xa, xn, ca, cn)
    sub = "" if mode == "snv" else "indel/"
    aff = nets.load_npz(os.path.join(MODEL, sub + "aff.npz"), "cpu")
    neg = nets.load_npz(os.path.join(MODEL, sub + "neg.npz"), "cpu")
    t = [torch.from_numpy(np.asarray(a, np.float32)) for a in (xa, xn, ca, cn)]
    p = np.round(nets.class1_probs(aff, neg, CFG[mode], *t).double().numpy(), 8)
    assert np.abs(p[:, 0] - res.p_aff).max() < 1e-5
    assert np.abs(p[:, 1] - res.p_neg).max() < 1e-5
    lik = posterior.load_likelihood(os.path.join(MODEL, sub + "likelihood_matrix.txt"),
                                    len(CFG[mode]["cvt"]["alleles"]))
    assert np.array_equal(posterior.posterior(res.p_aff, res.p_neg, lik), res.posterior)
    fwd, rev = posterior.strand_counts(xa[:, synth.FLANK])
    assert np.array_equal(fwd, res.forward_acgt) and np.array_equal(rev, res.reverse_acgt)


def test_likelihood_reader_matches_the_port():
    from clairs_to_tpu_torch.ops.posterior import load_likelihood_matrix

    path = os.path.join(MODEL, "indel", "likelihood_matrix.txt")
    port = load_likelihood_matrix(path, n_alleles=6)
    mats, aff, neg = posterior.load_likelihood(path, 6)
    assert np.array_equal(mats, port.matrices) and np.array_equal(aff, port.aff_edges)
    assert np.array_equal(neg, port.neg_edges)


def test_training_steps_match_the_port():
    from clairs_to_tpu_torch.models.checkpoint import load_checkpoint
    from clairs_to_tpu_torch.train import DualTrainer, TrainConfig

    rows, seed = 12, 77
    xa, xn, ca, _cn, som = synth.dual_batch(31, 3 * rows)
    aff_l = torch.stack([som == k for k in range(4)], dim=1).long()
    batches = [(xa[i:i + rows].float(), xn[i:i + rows].float(), aff_l[i:i + rows],
                1 - aff_l[i:i + rows]) for i in range(0, 3 * rows, rows)]
    paths = {"aff": os.path.join(MODEL, "aff.npz"), "neg": os.path.join(MODEL, "neg.npz")}
    tr = DualTrainer("snv", TrainConfig(dropout_rate=0.3), device="cpu")
    for net, path in paths.items():
        load_checkpoint(path, tr.models[net])
    gen = torch.Generator().manual_seed(seed)
    losses, first = [], None
    for i, b in enumerate(batches):
        losses.append(float(tr.step(*b, generator=gen)))
        if i == 0:
            first = {k: tr.opt.state[t]["exp_avg"] / 0.1 for k, t in tr.tensors.items()}
    prog = {"losses": losses, "first_grad": first,
            "after": {k: t.detach().clone() for k, t in tr.tensors.items()}}
    ref = train.follow(paths, CFG["snv"], batches, 0.3, seed, torch.device("cpu"))
    readings = dict(train.compare(prog, ref))
    assert max(readings[f"loss_gap_step{i}"] for i in (1, 2, 3)) < 1e-5
    assert readings["grad_norm_gap"] < 1e-4
    assert readings["update_gap_worst"] < 1e-3 and readings["update_gap_median"] < 1e-4
