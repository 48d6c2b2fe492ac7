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
from clairs_to_tpu_torch.ops import wire

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


def _args(case, x, cov, seed):
    """(x_aff, x_neg, cov_aff, cov_neg) of a test case: one view or two; the
    ``*_int32`` cases hand over int32 views, as the decoder does."""
    if case.endswith("int32"):
        x = x.astype(np.int32)
    if case.startswith("identity"):
        return x, x, cov, cov
    xn = x + np.random.default_rng(seed).integers(-3, 4, size=x.shape).astype(x.dtype)
    return x, xn, cov, cov + 7


@pytest.mark.parametrize("case", ["identity_int16", "delta_int16", "float32",
                                  "identity_int32", "delta_int32"])
def test_engine_matches_jax(engines, case):
    je, te = engines
    x, cov = _batch(40, seed=1, integral=case != "float32")
    if case.endswith("int32"):
        args = _args(case, x, cov, 2)
    elif case == "identity_int16":
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


def _float_case(case, seed):
    """Batches that leave the int16 wire: a coverage of 32,768 or more with
    two views, non-integral counts in one view, a count of 32,768 or more in
    one view."""
    x, cov = _batch(40, seed=seed, integral=case != "one_view_fractional")
    if case == "dual_deep_coverage":
        cov[[3, 17]] = [32768.0, 40000.0]
        xn = x + np.random.default_rng(seed).integers(-3, 4, size=x.shape)
        return x, xn, cov, cov + 7
    if case == "one_view_large_count":
        x[[2, 30], 16, 5] = [32768.0, 50000.0]
    return x, x, cov, cov


@pytest.mark.parametrize("case", ["dual_deep_coverage", "one_view_fractional",
                                  "one_view_large_count"])
def test_float32_layout_matches_jax(engines, case):
    """What does not fit in int16 goes in the float32 layout (the same rows,
    NEG as a full view) and gives the JAX engine's answers."""
    from torch.profiler import ProfilerActivity, profile

    from clairs_to_tpu_torch.utils import metrics as tracing

    je, te = engines
    args = _float_case(case, 31)
    packed, second = te._pack(args[0], None if args[1] is args[0] else args[1], *args[2:])
    assert packed.dtype == torch.float32 and (second is None) == (args[1] is args[0])
    before = tracing.RECORDER.counters()
    with profile(activities=[ProfilerActivity.CPU]):
        got = te.run_batch(*args)
    after = tracing.RECORDER.counters()
    assert after["engine.float_path_batches"] - before.get("engine.float_path_batches", 0) == 1
    _same(je.run_batch(*args), got)


# ---- the one-pass wire routine (ops/wire.py) -------------------------------

def _views(n, seed):
    """int32 AFF and NEG views as the decoder hands them over, and coverages."""
    rng = np.random.default_rng(seed)
    xa = rng.integers(-40, 40, size=(n, 33, 34)).astype(np.int32)
    xn = (xa + rng.integers(-3, 4, size=xa.shape)).astype(np.int32)
    return xa, xn, rng.integers(10, 120, size=n).astype(np.float32)


def _numpy_wire(xa, xn, ca, cn):
    """The wire encoding as NumPy builds it: int16 casts, the delta in int32."""
    packed = np.zeros((xa.shape[0], 34, 34), np.int16)
    packed[:, :33] = xa.astype(np.int16)
    packed[:, 33, 0] = ca
    packed[:, 33, 1] = cn
    return packed, None if xn is None else (xn.astype(np.int32) - xa).astype(np.int16)


def _limits_views():
    """Counts and deltas at both ends of int16."""
    rng = np.random.default_rng(22)
    xa = rng.choice(np.array([-32768, 32767, -1, 0, 5], np.int32), size=(20, 33, 34))
    # NEG - AFF: -32768 at 32767, 32767 at -32768, -32767 at -1, 32767 at 0
    xn = np.select([xa == 32767, xa == -32768, xa == -1, xa == 0],
                   [-1, -1, -32768, 32767], xa).astype(np.int32)
    return xa, xn, rng.integers(10, 120, size=20).astype(np.float32)


WIRE_CASES = {"random": lambda: _views(40, 20), "int16_limits": _limits_views,
              "padding": lambda: _views(10, 23), "more_rows": lambda: _views(150, 24),
              "identity": lambda: _views(40, 25)}


@pytest.mark.parametrize("case", list(WIRE_CASES))
def test_wire_routine_matches_the_numpy_encoding(engines, case):
    """The routine's packed rows 0-32, row 33 columns 0-1 and delta equal
    NumPy's encoding; the rows that pad the last slice are zero."""
    _, te = engines
    xa, xn, cov = WIRE_CASES[case]()
    if case == "identity":
        xn = None
    n, cov_neg = xa.shape[0], cov + 3
    got = te._pack(xa, xn, cov, cov_neg)
    assert isinstance(got[0], torch.Tensor)       # the routine ran
    packed, delta = (None if t is None else t.numpy() for t in got)
    rows = -(-n // te.device_batch) * te.device_batch
    assert packed.shape == (rows, 34, 34)
    want_p, want_d = _numpy_wire(xa, xn, cov.astype(np.int16), cov_neg.astype(np.int16))
    np.testing.assert_array_equal(packed[:n, :33], want_p[:, :33])
    np.testing.assert_array_equal(packed[:n, 33, :2], want_p[:, 33, :2])
    assert not packed[n:].any()
    if xn is None:
        assert delta is None
    else:
        assert delta.shape == (rows, 33, 34) and not delta[n:].any()
        np.testing.assert_array_equal(delta[:n], want_d)


def test_a_delta_out_of_int16_takes_the_float_path(engines):
    """A NEG - AFF of 32768 is reported, and the batch goes as float32 with
    the answers the routine's path gives for every other row."""
    from torch.profiler import ProfilerActivity, profile

    from clairs_to_tpu_torch.utils import metrics as tracing

    _, te = engines
    xa, xn, cov = _views(12, 26)
    c16 = cov.astype(np.int16)
    xa[5, 3, 4], xn[5, 3, 4] = -16384, 16383
    out = (torch.empty((64, 34, 34), dtype=torch.int16),
           torch.empty((64, 33, 34), dtype=torch.int16))
    assert wire.pack(xa, xn, c16, c16, *out)           # 32767 fits
    fits = te.run_batch(xa, xn.copy(), cov, cov)
    for a, b in ((16384, -16384), (-32768, -1), (32767, 32767)):   # -32768, 32767, 0
        xa[5, 3, 4], xn[5, 3, 4] = a, b
        assert wire.pack(xa, xn, c16, c16, *out)
    # -32769 and a count of 32768 or -32769 do not fit either
    for a, b in ((16384, -16385), (32768, 32767), (0, -32769)):
        xa[5, 3, 4], xn[5, 3, 4] = a, b
        assert not wire.pack(xa, xn, c16, c16, *out), (a, b)
    for a in (32768, -32769):                          # one view
        xa[5, 3, 4] = a
        assert not wire.pack(xa, None, c16, c16, out[0], None), a
    xa[5, 3, 4], xn[5, 3, 4] = -16384, 16384
    assert not wire.pack(xa, xn, c16, c16, *out)       # 32768 does not
    packed, second = te._pack(xa, xn, cov, cov)        # so the batch goes as float32
    assert packed.dtype == second.dtype == torch.float32
    assert packed.shape == (64, 34, 34) and second.shape == (64, 33, 34)
    np.testing.assert_array_equal(packed[:12, :33].numpy(), xa)
    np.testing.assert_array_equal(packed[:12, 33, :2].numpy(), np.stack([cov, cov], 1))
    np.testing.assert_array_equal(second[:12].numpy(), xn)
    assert not packed[12:].any() and not second[12:].any()
    before = tracing.RECORDER.counters()
    with profile(activities=[ProfilerActivity.CPU]):
        got = te.run_batch(xa, xn, cov, cov)
    after = tracing.RECORDER.counters()
    for key in ("engine.float_path_batches", "engine.wire_fused_batches"):
        assert after[key] - before.get(key, 0) == 1, key
    keep = np.arange(12) != 5
    for field in ("p_aff", "p_neg", "posterior", "forward_acgt", "reverse_acgt"):
        np.testing.assert_array_equal(getattr(got, field)[keep], getattr(fits, field)[keep])


def test_other_dtypes_and_layouts_go_through_the_routine_as_int32(engines, monkeypatch):
    """int64, int16 (the warm-ups'), integral float32 and strided views are
    cast to int32 C-contiguous views for the routine, and give the answers
    of the decoder's int32 views; counts past int16 (which a cast to int32
    could wrap back into range) send the batch down the float path."""
    _, te = engines
    xa, xn, cov = _views(30, 27)
    want = te.run_batch(xa, xn, cov, cov)
    seen = []
    pack = wire.pack

    def spy(x_aff, x_neg, *rest):
        seen.append((x_aff, x_neg))
        return pack(x_aff, x_neg, *rest)

    monkeypatch.setattr(wire, "pack", spy)
    wide = np.zeros((30, 33, 68), np.int32)
    wide[:, :, ::2] = xa                             # an int32 view with strides
    for args in ((xa.astype(np.int64), xn.astype(np.int64), cov, cov),
                 (wide[:, :, ::2], xn, cov, cov),
                 (xa, xn.astype(np.int16), cov, cov),
                 (xa.astype(np.float32), xn.astype(np.float32), cov, cov)):
        seen.clear()
        got = te.run_batch(*args)
        assert len(seen) == 1 and all(wire.takes(v) for v in seen[0])
        for field in ("p_aff", "p_neg", "posterior", "forward_acgt", "reverse_acgt"):
            np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    big = xa.astype(np.int64)
    big[3, 2, 1] += 2 ** 32                          # int32 would read it as in range
    seen.clear()
    packed, second = te._pack(big, xn, cov, cov)
    assert not seen and packed.dtype == second.dtype == torch.float32
    assert packed[3, 2, 1] == float(big[3, 2, 1]) and torch.equal(second[:30],
                                                                  torch.from_numpy(xn).float())
    z = np.zeros((1, 33, 34), np.int16)              # the warm-ups' batch
    packed, delta = te._pack(z, z, np.ones(1, np.float32), np.ones(1, np.float32))
    assert len(seen) == 1 and not delta.numpy().any()
    assert packed.numpy()[0, 33, :2].tolist() == [1, 1] and not packed.numpy()[0, :33].any()


def test_three_batches_in_flight_match_their_synchronous_runs(engines):
    """Three batches dispatched before any result is taken each give what
    the batch gives alone: no host buffer is reused while a batch needs it."""
    _, te = engines
    batches = [_views(64, 28), _views(100, 29), _views(30, 30)]
    pending = [te.run_batch_async(xa, xn, cov, cov + 1) for xa, xn, cov in batches]
    results = [p.result() for p in pending]
    for (xa, xn, cov), got in zip(batches, results):
        want = te.run_batch(xa, xn, cov, cov + 1)
        for field in ("p_aff", "p_neg", "posterior", "forward_acgt", "reverse_acgt"):
            np.testing.assert_array_equal(getattr(got, field), getattr(want, field))


def test_a_failed_wire_build_raises(monkeypatch, tmp_path):
    """A routine that does not compile raises with the compiler's message;
    the engine never falls back in silence."""
    broken = tmp_path / "wire.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(wire.LIB, "source", str(broken))
    monkeypatch.setattr(wire.LIB, "so", str(tmp_path / "libwire.so"))
    monkeypatch.setattr(wire.LIB, "fns", None)
    with pytest.raises(RuntimeError, match="failed on wire.cpp"):
        wire.build()
    assert wire.LIB.fns is None


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
@pytest.mark.parametrize("case", ["identity_int16", "delta_int16", "float32",
                                  "identity_int32", "delta_int32"])
def test_replicas_match_one_device_and_jax_mesh(engines, replica_engines, case, n):
    _, te = engines
    jm, tm = replica_engines
    # 64 rounded up to a multiple of 3, as the JAX engine rounds for its mesh
    assert tm.device_batch == jm.device_batch == 66 and len(tm.devices) == 3
    assert tm.aff_models[1] is not tm.aff_models[0]
    x, cov = _batch(n, seed=11, integral=case != "float32")
    if case.endswith("int32"):
        args = _args(case, x, cov, 12)
    elif case == "identity_int16":
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
        fast.run_batch(x, x, cov, cov)
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
