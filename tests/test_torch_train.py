"""The port's trainer (clairs_to_tpu_torch/train.py) against the JAX
package's, on the CPU at small widths: the loss, the trained leaves, one
step from the same weights, the loss history, clipping, dropout,
calibration and checkpoints carried both ways.  Dropout draws differ
between jax.random and torch.Generator, so the step parity runs at rate 0."""

import json
from dataclasses import asdict, replace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from clairs_to_tpu import train as jtrain
from clairs_to_tpu.bench.demo import TINY_BIGRU as J_TINY_BIGRU
from clairs_to_tpu.bench.demo import TINY_CVT as J_TINY_CVT
from clairs_to_tpu.bench.synth import synthesize_batch
from clairs_to_tpu.models import bigru as jbigru
from clairs_to_tpu.models import cvt as jcvt
from clairs_to_tpu_torch import train as ttrain
from clairs_to_tpu_torch.bench import grad_check
from clairs_to_tpu_torch.bench.demo import TINY_BIGRU, TINY_CVT
from clairs_to_tpu_torch.models import bigru as tbigru
from clairs_to_tpu_torch.models import cvt as tcvt
from clairs_to_tpu_torch.models.checkpoint import keypath_to_name, params_from_jax

torch.set_num_threads(1)
N, BATCH = 192, 96
LR = 1e-3


def _data(n=N, seed=3, mode="snv"):
    rng = np.random.default_rng(seed)
    return synthesize_batch(rng, n, depth_range=(25, 95), somatic_af_range=(0.08, 0.35),
                            mode=mode)


def _jax_leaves(params):
    return {f"{net}.{keypath_to_name('/'.join(str(k) for k in kp))}": np.asarray(v)
            for net in ("aff", "neg")
            for kp, v in jax.tree_util.tree_flatten_with_path(params[net])[0]}


def _configs(mode):
    if mode == "snv":
        return J_TINY_CVT, J_TINY_BIGRU, TINY_CVT, TINY_BIGRU
    return (replace(J_TINY_CVT, alleles=jcvt.INDEL_ALLELES),
            replace(J_TINY_BIGRU, alleles=jcvt.INDEL_ALLELES),
            replace(TINY_CVT, alleles=tcvt.INDEL_ALLELES),
            replace(TINY_BIGRU, alleles=tcvt.INDEL_ALLELES))


_JAX_TRAINERS = {}


def _pair(mode="snv"):
    """A JAX trainer at its initial weights and a port trainer (on the CPU)
    holding the same weights, both at dropout 0.  The JAX trainer of a mode
    is built once and reset, so its jitted step compiles once."""
    jc, jg, tcc, tgc = _configs(mode)
    tc = dict(batch_size=BATCH, epochs=1, learning_rate=LR, dropout_rate=0.0)
    if mode not in _JAX_TRAINERS:
        jt = jtrain.DualTrainer(mode, jtrain.TrainConfig(**tc), jc, jg)
        _JAX_TRAINERS[mode] = (jt, jt.params)
    jt, init = _JAX_TRAINERS[mode]
    jt.params, jt.opt_state = init, jt.tx.init(init)
    tt = ttrain.DualTrainer(mode, ttrain.TrainConfig(**tc), tcc, tgc, device="cpu")
    np_params = jax.tree_util.tree_map(np.asarray, init)
    tt.models["aff"].load_state_dict(params_from_jax(np_params["aff"], "cvt", tcc))
    tt.models["neg"].load_state_dict(params_from_jax(np_params["neg"], "bigru", tgc))
    return jt, tt


def _labels(som, n_all):
    aff = np.stack([(som == k) for k in range(n_all)], axis=1).astype(np.int32)
    return aff, 1 - aff


# --- the loss --------------------------------------------------------------

@pytest.mark.parametrize("gamma", [0.0, 2.0])
def test_focal_ce_matches_jax(gamma):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(64, 6, 2)).astype(np.float32) * 3
    labels = rng.integers(0, 2, size=(64, 6)).astype(np.int32)
    want = float(jtrain.focal_ce(jnp.asarray(logits), jnp.asarray(labels), gamma))
    got = float(ttrain.focal_ce(torch.from_numpy(logits), torch.from_numpy(labels), gamma))
    assert abs(got - want) <= 1e-6 * abs(want)


# --- the trained tensors ---------------------------------------------------

@pytest.mark.parametrize("mode", ["snv", "indel"])
def test_trained_tensors_are_the_jax_leaves(mode):
    jt, tt = _pair(mode=mode)
    want = set(_jax_leaves(jt.params))
    assert set(tt.tensors) == want
    assert any(k.endswith("bn.running_mean") for k in want)
    assert any(k.endswith("bn.running_var") for k in want)
    (group,) = tt.opt.param_groups
    assert {id(p) for p in group["params"]} == {id(t) for t in tt.tensors.values()}
    assert len(group["params"]) == len(want)
    assert group["weight_decay"] == 1e-6 and group["betas"] == (0.9, 0.999)
    assert group["eps"] == 1e-8 and group["lr"] == LR
    assert all(t.requires_grad for t in tt.tensors.values())


def test_default_trainer_is_the_flagship_on_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.DualTrainer()
    tt = ttrain.DualTrainer(device="cpu")
    assert tt.cvt_config == tcvt.SNV_CVT_CONFIG and tt.bigru_config == tbigru.SNV_BIGRU_CONFIG
    assert tt.tc.weight_decay == 1e-6 and tt.tc.batch_size == 800


# --- one step from the same weights ----------------------------------------

@pytest.fixture(scope="module")
def one_step():
    """Gradients at the JAX init and both packages' parameters after one
    ``fit`` step of a full batch, at dropout 0."""
    x, cov, som = _data(BATCH)
    x = (x * np.where(cov > 50, 50.0 / cov, 1.0).astype(np.float32)[:, None, None])
    jt, tt = _pair()
    before = _jax_leaves(jt.params)
    al, nl = _labels(som, 4)
    loss_j, grads_j = jax.jit(jax.value_and_grad(jt._loss))(
        jt.params, jnp.asarray(x), jnp.asarray(x), jnp.asarray(al), jnp.asarray(nl),
        jax.random.PRNGKey(0))
    xt = torch.from_numpy(x)
    loss_t = tt.loss(xt, xt, torch.from_numpy(al), torch.from_numpy(nl))
    loss_t.backward()
    loss_t = loss_t.detach()
    grads_t = {k: t.grad.clone() for k, t in tt.tensors.items()}
    tt.opt.zero_grad(set_to_none=True)
    # one fit step (the same balanced batch draw in both) from the same start
    jt2, tt2 = _pair()
    x2, cov2, som2 = _data()
    jt2.fit(x2, som2, rescale_cov=cov2)
    tt2.fit(x2, som2, rescale_cov=cov2)
    return dict(loss=(float(loss_j), float(loss_t)), grads=(_jax_leaves(grads_j), grads_t),
                after=(_jax_leaves(jt2.params),
                       {k: t.detach().numpy() for k, t in tt2.tensors.items()}),
                before=before)


def test_one_step_loss_matches_jax(one_step):
    want, got = one_step["loss"]
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)


def test_one_step_gradients_match_jax(one_step):
    want, got = one_step["grads"]
    assert set(want) == set(got)
    for k in want:
        scale = max(float(np.linalg.norm(want[k])), 1e-12)
        err = float(np.abs(got[k].numpy() - want[k]).max())
        assert err <= 1e-4 * scale, (k, err, scale)
    # the BatchNorm statistics get gradients, as in the JAX step
    bn = [k for k in want if k.endswith("running_var")]
    assert bn and all(np.abs(want[k]).max() > 0 for k in bn)


def test_one_step_parameters_match_jax(one_step):
    want, got = one_step["after"]
    before = one_step["before"]
    diff = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    # Adam's first update is lr*g/(|g|+eps): a gradient near 0 can change sign
    # between the two packages' fp32 summation orders, so a few elements may
    # move by up to 2*lr the other way
    assert (diff <= 1e-5).mean() >= 0.999, (diff > 1e-5).mean()
    assert diff.max() <= 2 * LR + 1e-6
    moved = [k for k in want if k.endswith("running_mean") and
             np.abs(got[k] - before[k]).max() > 0]
    assert moved, "the BatchNorm statistics were not trained"


def test_loss_history_matches_jax():
    x, cov, som = _data()
    jt, tt = _pair()
    want = jt.fit(x, som, rescale_cov=cov, epochs=3)
    got = tt.fit(x, som, rescale_cov=cov, epochs=3)
    assert len(got) == len(want) == 3 and all(isinstance(v, float) for v in got)
    np.testing.assert_allclose(got, want, rtol=1e-3)


def test_unbalanced_batches_and_dual_view_match_jax():
    """No somatic site and fewer rows than a batch: the permutation, wrapped
    to a whole batch; a NEG view of its own."""
    x, cov, _som = _data(80)
    som = np.full(len(x), -1, np.int32)
    x_neg = x + np.random.default_rng(1).integers(0, 2, size=x.shape).astype(np.float32)
    jt, tt = _pair()
    want = jt.fit(x, som, rescale_cov=cov, x_neg=x_neg, epochs=2)
    got = tt.fit(x, som, rescale_cov=cov, x_neg=x_neg, epochs=2)
    np.testing.assert_allclose(got, want, rtol=1e-3)


# --- clipping --------------------------------------------------------------

@pytest.mark.parametrize("scale", [0.01, 10.0])
def test_clip_by_global_norm_matches_optax(scale):
    rng = np.random.default_rng(4)
    grads = [rng.normal(size=s).astype(np.float32) * scale for s in ((7, 3), (5,), (2, 2, 2))]
    want, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(g) for g in grads], None)
    got = [torch.from_numpy(g.copy()) for g in grads]
    norm = ttrain.clip_by_global_norm(got, 1.0)
    np.testing.assert_allclose(float(norm), np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                                                        for g in grads)), rtol=1e-6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)
    if scale < 1:   # under the limit: untouched, bit for bit
        assert all(np.array_equal(g.numpy(), o) for g, o in zip(got, grads))


def test_clip_by_global_norm_is_exact_on_a_large_leaf():
    # the flagship BiGRU's fc1 weight is 128 x 12672: a CPU fp32 norm of it
    # strays by about 1e-5 relative; optax's stays near 1e-7
    rng = np.random.default_rng(6)
    grads = [rng.normal(size=s).astype(np.float32) for s in ((128, 12672), (300,))]
    exact = np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in grads))
    want = float(optax.global_norm([jnp.asarray(g) for g in grads]))
    got = float(ttrain.clip_by_global_norm([torch.from_numpy(g) for g in grads], 1e9))
    assert abs(want - exact) <= 1e-6 * exact
    assert abs(got - exact) <= 1e-6 * exact, (got, exact)


def test_flagship_fp32_step_is_near_a_float64_step(capsys):
    # bench/grad_check.py at the flagship widths on 16 rows: the fp32 step
    # against the same step in float64, leaf by leaf
    assert grad_check.main(["--device", "cpu", "--rows", "16"]) == 0
    out = json.loads(capsys.readouterr().out)
    gap = out["cpu_vs_cpu_f64"]
    assert gap["loss_rel"] <= 1e-6 and gap["norm_rel"] <= 1e-6, gap
    assert gap["worst_leaf_rel"] <= 1e-5, gap
    assert out["device_vs_cpu"]["norm_rel"] == 0.0


# --- dropout ---------------------------------------------------------------

def test_dropout_sites_are_the_jax_ones(monkeypatch):
    sites = []
    real = tcvt.fc_dropout

    def spy(t, rate, generator):
        sites.append(tuple(t.shape))
        return real(t, rate, generator)

    monkeypatch.setattr(tcvt, "fc_dropout", spy)
    x = torch.from_numpy(_data(5)[0])
    gen = torch.Generator().manual_seed(0)
    for model, flat in ((tcvt.CvT(TINY_CVT), tcvt.trunk_flat_dim(TINY_CVT)),
                        (tbigru.BiGRU(TINY_BIGRU), 33 * 2 * TINY_BIGRU.hidden2)):
        model.reset_parameters(torch.Generator().manual_seed(1))
        sites.clear()
        model(x, dropout_rate=0.3, generator=gen)
        assert sites == [(5, flat), (5, 128)] + [(5, 128)] * 4


def test_dropout_keep_rate_scale_and_mask():
    t = torch.ones(400, 500)
    out = tcvt.fc_dropout(t, 0.3, torch.Generator().manual_seed(5))
    kept = out != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.005
    assert torch.all(out[kept] == 1 / 0.7)
    again = tcvt.fc_dropout(t, 0.3, torch.Generator().manual_seed(5))
    other = tcvt.fc_dropout(t, 0.3, torch.Generator().manual_seed(6))
    assert torch.equal(out, again) and not torch.equal(out, other)


@pytest.mark.parametrize("kind", ["cvt", "bigru"])
def test_dropout_is_the_identity_at_rate_zero(kind):
    model = tcvt.CvT(TINY_CVT) if kind == "cvt" else tbigru.BiGRU(TINY_BIGRU)
    model.reset_parameters(torch.Generator().manual_seed(2))
    x = torch.from_numpy(_data(7)[0])
    with torch.no_grad():
        plain = model.eval()(x)
        # train mode changes nothing: the BatchNorm reads its running statistics
        assert torch.equal(model.train()(x), plain)
        assert torch.equal(model(x, dropout_rate=0.0, generator=torch.Generator()), plain)
        assert torch.equal(model(x, dropout_rate=0.5, generator=None), plain)
        dropped = model(x, dropout_rate=0.5, generator=torch.Generator().manual_seed(0))
    assert not torch.equal(dropped, plain)


# --- calibration -----------------------------------------------------------

@pytest.mark.parametrize("n_alleles", [4, 6])
def test_calibration_and_matrix_file_match_jax(n_alleles, tmp_path):
    rng = np.random.default_rng(9)
    n = 3000
    som = np.where(rng.random(n) < 0.2, rng.integers(0, n_alleles, n), -1)
    p_aff = rng.beta(0.5, 2.0, size=(n, n_alleles)).astype(np.float32)
    p_neg = rng.beta(2.0, 0.5, size=(n, n_alleles)).astype(np.float32)
    want = jtrain.calibrate_likelihood(p_aff, p_neg, som, n_alleles=n_alleles)
    got = ttrain.calibrate_likelihood(p_aff, p_neg, som, n_alleles=n_alleles)
    for f in ("matrices", "aff_edges", "neg_edges"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    a, b = str(tmp_path / "j.txt"), str(tmp_path / "t.txt")
    jtrain.save_likelihood_matrix(a, want)
    ttrain.save_likelihood_matrix(b, got)
    assert open(a, "rb").read() == open(b, "rb").read()


# --- checkpoints -----------------------------------------------------------

@pytest.mark.parametrize("kind", ["cvt", "bigru"])
def test_port_checkpoint_loads_in_jax(kind, tmp_path):
    _jt, tt = _pair()
    model = tt.models["aff" if kind == "cvt" else "neg"]
    config = tt.cvt_config if kind == "cvt" else tt.bigru_config
    with torch.no_grad():   # non-trivial BatchNorm statistics
        for name, b in model.named_buffers():
            b.copy_(torch.rand(b.shape) + 0.5)
    path = str(tmp_path / "port.npz")
    ttrain.save_checkpoint(path, model, arch=asdict(config))
    params, jconfig = jtrain.load_checkpoint_auto(path, kind=kind)
    assert jconfig == (J_TINY_CVT if kind == "cvt" else J_TINY_BIGRU)
    x = _data(9)[0]
    fwd = jcvt.forward if kind == "cvt" else jbigru.forward
    with jax.default_matmul_precision("highest"):
        want = np.asarray(fwd(params, jnp.asarray(x), jconfig))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the same key set as the JAX package writes for the same tree
    jpath = str(tmp_path / "jax.npz")
    jtrain.save_checkpoint(jpath, params, arch=asdict(jconfig))
    with np.load(path) as a, np.load(jpath) as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(np.array_equal(a[k], b[k]) for k in a.files)


@pytest.mark.parametrize("kind", ["cvt", "bigru"])
def test_jax_checkpoint_loads_in_port(kind, tmp_path):
    jt, _tt = _pair()
    params = jt.params["aff" if kind == "cvt" else "neg"]
    jconfig = jt.cvt_config if kind == "cvt" else jt.bigru_config
    path = str(tmp_path / "jax.npz")
    jtrain.save_checkpoint(path, params, arch=asdict(jconfig))
    model, config = ttrain.load_checkpoint_auto(path, kind=kind, device="cpu")
    assert config == (TINY_CVT if kind == "cvt" else TINY_BIGRU)
    assert ttrain.checkpoint_arch(path) == jtrain.checkpoint_arch(path)
    x = _data(9)[0]
    fwd = jcvt.forward if kind == "cvt" else jbigru.forward
    with jax.default_matmul_precision("highest"):
        want = np.asarray(fwd(params, jnp.asarray(x), jconfig))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_predict_probs_matches_jax():
    """Padding to the batch size, eval mode, the rescale, dual views."""
    jt, tt = _pair()
    x, cov, _som = _data(150)
    x_neg = x + 1.0
    want = jt.predict_probs(x, rescale_cov=cov, batch_size=64, x_neg=x_neg)
    got = tt.predict_probs(x, rescale_cov=cov, batch_size=64, x_neg=x_neg)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (150, 4)
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    assert not any(m.training for m in tt.models.values())
