"""The port's InferenceEngine (clairs_to_tpu_torch/infer/engine.py) against
the JAX engine on the same tiny weights and inputs, on the CPU: one device,
and three replicas against a JAX mesh over three devices."""

import numpy as np
import jax
import pytest
import torch

from clairs_to_tpu.infer.engine import InferenceEngine as JaxEngine
from clairs_to_tpu.infer.engine import recover_strand_counts as jax_recover
from clairs_to_tpu.models import bigru as jbigru
from clairs_to_tpu.models import cvt as jcvt
from clairs_to_tpu.ops import posterior as jpost
from clairs_to_tpu_torch.infer.engine import InferenceEngine, recover_strand_counts
from clairs_to_tpu_torch.models import bigru as tbigru
from clairs_to_tpu_torch.models import cvt as tcvt
from clairs_to_tpu_torch.ops import posterior as tpost

torch.set_num_threads(1)
# probabilities agree to float32 rounding of differently ordered sums; they
# are %.8f-rounded before the float64 posterior
TOL = dict(rtol=1e-5, atol=2e-6)
CVT_KW = dict(emb_dims=(8, 16, 32), heads=(1, 1, 2), depths=(1, 1, 1))
GRU_KW = dict(hidden1=16, hidden2=24)


@pytest.fixture(scope="module", params=["snv", "indel"])
def engines(request):
    mode = request.param
    alleles = dict(alleles=jcvt.INDEL_ALLELES) if mode == "indel" else {}
    jc, jg = jcvt.CvTConfig(**CVT_KW, **alleles), jbigru.BiGRUConfig(**GRU_KW, **alleles)
    tc, tg = tcvt.CvTConfig(**CVT_KW, **alleles), tbigru.BiGRUConfig(**GRU_KW, **alleles)
    aff = jax.tree_util.tree_map(np.asarray, jcvt.init(jax.random.PRNGKey(0), jc))
    neg = jax.tree_util.tree_map(np.asarray, jbigru.init(jax.random.PRNGKey(1), jg))
    n = len(jc.alleles)
    # a non-flat likelihood so the posterior depends on the bins
    rng = np.random.default_rng(9)
    mats = rng.uniform(0.05, 0.95, size=(n, 10, 10))
    edges = np.tile(np.linspace(0.0, 1.0, 11), (n, 1))
    lik_j = jpost.LikelihoodData(mats, edges.copy(), edges.copy())
    lik_t = tpost.LikelihoodData(mats, edges.copy(), edges.copy())
    je = JaxEngine(aff, neg, lik_j, mode=mode, device_batch=64, cvt_config=jc,
                   bigru_config=jg)
    te = InferenceEngine(aff, neg, lik_t, mode=mode, device_batch=64, cvt_config=tc,
                         bigru_config=tg, device="cpu")
    return je, te


def _batch(n, seed=0, integral=True):
    rng = np.random.default_rng(seed)
    x = rng.integers(-40, 40, size=(n, 33, 34)).astype(np.float32)
    if not integral:
        x = x + 0.25
    cov = rng.integers(10, 120, size=(n,)).astype(np.float32)
    return x, cov


def _same(a, b):
    np.testing.assert_allclose(b.p_aff, a.p_aff, **TOL)
    np.testing.assert_allclose(b.p_neg, a.p_neg, **TOL)
    np.testing.assert_allclose(b.posterior, a.posterior, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(b.forward_acgt, a.forward_acgt)
    np.testing.assert_array_equal(b.reverse_acgt, a.reverse_acgt)


@pytest.mark.parametrize("case", ["identity_int16", "delta_int16", "float32"])
def test_engine_matches_jax(engines, case):
    je, te = engines
    x, cov = _batch(40, seed=1, integral=case != "float32")
    if case == "identity_int16":
        args = (x, x, cov, cov)
    else:
        xn = x + np.random.default_rng(2).integers(-3, 4, size=x.shape)
        args = (x, xn, cov, cov + 7)
    _same(je.run_batch(*args), te.run_batch(*args))


def test_more_rows_than_device_batch(engines):
    je, te = engines
    x, cov = _batch(150, seed=3)   # > device_batch=64: three slices
    a = je.run_batch(x, x, cov, cov)
    b = te.run_batch_async(x, x, cov, cov).result()
    assert b.posterior.shape == (150, te.n_alleles)
    _same(a, b)


def test_padding_invariance(engines):
    _, te = engines
    x, cov = _batch(10, seed=4)
    full = te.run_batch(x, x, cov, cov)
    half = te.run_batch(x[:5], x[:5], cov[:5], cov[:5])
    np.testing.assert_array_equal(full.p_aff[:5], half.p_aff)
    np.testing.assert_array_equal(full.posterior[:5], half.posterior)


def test_int16_and_float32_paths_agree(engines):
    _, te = engines
    x, cov = _batch(12, seed=5)
    a = te.run_batch(x.astype(np.int16), x.astype(np.int16), cov, cov)
    b = te.run_batch(x, x + 0.0, cov, cov.copy())   # float inputs, two views
    np.testing.assert_allclose(b.p_aff, a.p_aff, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(b.p_neg, a.p_neg, rtol=1e-6, atol=1e-7)


def test_fused_matches_jax(engines):
    je, te = engines
    x, cov = _batch(20, seed=6)
    pj, bj, qj = (np.asarray(v)[:20] for v in je.run_batch_fused(x, x, cov, cov))
    pt, bt, qt = (v.numpy()[:20] for v in te.run_batch_fused(x, x, cov, cov))
    np.testing.assert_allclose(pt, pj, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(bt, bj)
    np.testing.assert_allclose(qt, qj, rtol=1e-4, atol=1e-3)


def test_recover_strand_counts_matches_jax():
    rng = np.random.default_rng(7)
    center = rng.integers(0, 30, size=(50, 34)).astype(np.float32)
    ref = rng.integers(0, 4, size=50)
    center[np.arange(50), ref] = -center[:, 0:4].sum(1)
    center[np.arange(50), 9 + ref] = -center[:, 9:13].sum(1)
    for a, b in zip(jax_recover(center), recover_strand_counts(center)):
        np.testing.assert_array_equal(a, b)


REPLICA_TOL = dict(rtol=1e-6, atol=1e-7)   # class-1 probabilities, replicas vs one device


@pytest.fixture(scope="module")
def replica_engines(engines):
    """(JAX engine on a mesh of 3 of the virtual CPU devices, the port's
    engine with three CPU replicas), same weights as ``engines``."""
    from clairs_to_tpu.infer.engine import make_mesh

    je, te = engines
    assert len(jax.devices()) >= 3
    kw = dict(mode=je.mode, device_batch=64)
    jm = JaxEngine(jax.tree_util.tree_map(np.asarray, je.aff_params),
                   jax.tree_util.tree_map(np.asarray, je.neg_params), je.likelihood,
                   cvt_config=je.cvt_config, bigru_config=je.bigru_config,
                   mesh=make_mesh(jax.devices()[:3]), **kw)
    tm = InferenceEngine(te.aff_model, te.neg_model, te.likelihood, cvt_config=te.cvt_config,
                         bigru_config=te.bigru_config, devices=["cpu"] * 3, **kw)
    return jm, tm


@pytest.mark.parametrize("n", [40, 150])   # not a multiple of 3; more than device_batch
@pytest.mark.parametrize("case", ["identity_int16", "delta_int16", "float32"])
def test_replicas_match_one_device_and_jax_mesh(engines, replica_engines, case, n):
    _, te = engines
    jm, tm = replica_engines
    # 64 rounded up to a multiple of 3, as the JAX engine rounds for its mesh
    assert tm.device_batch == jm.device_batch == 66 and len(tm.devices) == 3
    assert tm.aff_models[1] is not tm.aff_models[0]
    x, cov = _batch(n, seed=11, integral=case != "float32")
    if case == "identity_int16":
        args = (x, x, cov, cov)
    else:
        xn = x + np.random.default_rng(12).integers(-3, 4, size=x.shape)
        args = (x, xn, cov, cov + 7)
    one, rep = te.run_batch(*args), tm.run_batch_async(*args).result()
    assert rep.posterior.shape == (n, te.n_alleles)
    np.testing.assert_allclose(rep.p_aff, one.p_aff, **REPLICA_TOL)
    np.testing.assert_allclose(rep.p_neg, one.p_neg, **REPLICA_TOL)
    np.testing.assert_array_equal(rep.forward_acgt, one.forward_acgt)
    _same(jm.run_batch(*args), rep)


def test_replica_parts_are_dispatched_in_order(replica_engines):
    """Each replica gets its own rows of the padded slice, and the parts come
    back in order: a replica whose weights differ shows in its rows only."""
    _, tm = replica_engines
    x, cov = _batch(66, seed=13)
    base = tm.run_batch(x, x, cov, cov)
    saved = tm.neg_models[1].state_dict()
    saved = {k: v.clone() for k, v in saved.items()}
    try:
        with torch.no_grad():
            for p in tm.neg_models[1].parameters():
                p.mul_(0.5)
        got = tm.run_batch(x, x, cov, cov)
    finally:
        tm.neg_models[1].load_state_dict(saved)
    changed = np.abs(got.p_neg - base.p_neg).max(axis=1) > 0
    assert changed[22:44].all() and not changed[:22].any() and not changed[44:].any()
    np.testing.assert_array_equal(got.p_aff, base.p_aff)


def test_tf32_switches_follow_the_dispatching_engine(engines, monkeypatch):
    """The TF32 switches are process-wide: an engine sets them from its own
    precision at every dispatch on a GPU, so a cached "highest" engine is not
    left with the TF32 that a later "default" engine allowed."""
    from clairs_to_tpu_torch.infer.engine import set_matmul_precision

    _, te = engines
    kw = dict(mode=te.mode, device_batch=64, cvt_config=te.cvt_config,
              bigru_config=te.bigru_config, device="cpu")
    exact = InferenceEngine(te.aff_model, te.neg_model, te.likelihood, **kw)
    fast = InferenceEngine(te.aff_model, te.neg_model, te.likelihood,
                           matmul_precision="default", **kw)
    x, cov = _batch(4, seed=14)

    def switches():
        return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32

    before = switches()
    try:
        # on the CPU an engine leaves the switches alone, at construction and at dispatch
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        exact.run_batch(x, x, cov, cov)
        assert switches() == (True, True)
        # as on a GPU
        monkeypatch.setattr(exact, "_on_cuda", True)
        monkeypatch.setattr(fast, "_on_cuda", True)
        for eng, want in ((exact, False), (fast, True), (exact, False)):
            eng.run_batch(x, x, cov, cov)
            assert switches() == (want, want)
        fast.run_batch_fused(x, x, cov, cov)
        assert switches() == (True, True)
        set_matmul_precision("highest")
        assert switches() == (False, False)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def test_local_devices(monkeypatch):
    from clairs_to_tpu_torch.infer.engine import local_devices

    assert local_devices("cpu") == [torch.device("cpu")]
    assert local_devices("cpu", 3) == [torch.device("cpu")] * 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert local_devices("cuda") == [torch.device("cuda", i) for i in range(4)]
    assert local_devices("cuda", 2) == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert len(local_devices("cuda", 9)) == 4     # cut to what is there


def test_cuda_requested_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from clairs_to_tpu_torch.infer.engine import resolve_device

    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    assert resolve_device("cpu").type == "cpu"
