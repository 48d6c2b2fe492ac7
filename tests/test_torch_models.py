"""The port's CvT and BiGRU (clairs_to_tpu_torch/models) against the JAX
package's, and the checkpoint layout carried across."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from clairs_to_tpu.models import bigru as jbigru
from clairs_to_tpu.models import cvt as jcvt
from clairs_to_tpu.train import load_checkpoint_auto as jax_load_auto
from clairs_to_tpu.train import save_checkpoint
from clairs_to_tpu_torch.models import bigru as tbigru
from clairs_to_tpu_torch.models import cvt as tcvt
from clairs_to_tpu_torch.models.checkpoint import (
    keypath_to_name,
    load_checkpoint_auto,
    params_from_jax,
)

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets")

# the tiny configs of tests/test_engine.py, SNV and indel alleles
TINY = {
    "snv": (dict(emb_dims=(8, 16, 32), heads=(1, 1, 2), depths=(1, 1, 1)),
            dict(hidden1=16, hidden2=24)),
    "indel": (dict(emb_dims=(8, 16, 32), heads=(1, 1, 2), depths=(1, 1, 1),
                   alleles=jcvt.INDEL_ALLELES),
              dict(hidden1=16, hidden2=24, alleles=jcvt.INDEL_ALLELES)),
}


def _input(n=6, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(-40, 40, size=(n, 33, 34)) / 10.0).astype(np.float32)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_logits(fwd, params, x, config):
    with jax.default_matmul_precision("highest"):
        return np.asarray(fwd(params, jnp.asarray(x), config))


def _perturb_bn(tree, seed):
    """Non-trivial running statistics, so the BatchNorm path is exercised."""
    rng = np.random.default_rng(seed)
    for stage in tree["stages"]:
        for blk in stage["blocks"]:
            for proj in ("to_q", "to_kv"):
                bn = blk["attn"][proj]["bn"]
                n = bn["weight"].shape[0]
                bn["running_mean"] = rng.normal(size=n).astype(np.float32) * 0.1
                bn["running_var"] = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
                bn["weight"] = rng.uniform(0.5, 1.5, size=n).astype(np.float32)
    return tree


@pytest.mark.parametrize("mode", ["snv", "indel"])
def test_cvt_matches_jax_tiny(mode):
    jc = jcvt.CvTConfig(**TINY[mode][0])
    params = _perturb_bn(_numpy_tree(jcvt.init(jax.random.PRNGKey(0), jc)), seed=1)
    x = _input()
    want = _jax_logits(jcvt.forward, params, x, jc)
    tc = tcvt.CvTConfig(**TINY[mode][0])
    model = tcvt.CvT(tc)
    model.load_state_dict(params_from_jax(params, "cvt", tc))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (6, len(tc.alleles), 2)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("mode", ["snv", "indel"])
def test_bigru_matches_jax_tiny(mode):
    jc = jbigru.BiGRUConfig(**TINY[mode][1])
    params = _numpy_tree(jbigru.init(jax.random.PRNGKey(1), jc))
    x = _input(seed=2)
    want = _jax_logits(jbigru.forward, params, x, jc)
    tc = tbigru.BiGRUConfig(**TINY[mode][1])
    model = tbigru.BiGRU(tc)
    model.load_state_dict(params_from_jax(params, "bigru", tc))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
        plain = model(torch.from_numpy(x), use_kernel=False).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(got, plain)   # on the CPU both are the plain loop


@pytest.mark.parametrize("mode", ["snv", "indel"])
@pytest.mark.parametrize("kind", ["cvt", "bigru"])
def test_flagship_checkpoint_both_loaders(mode, kind):
    """The committed flagship ONT weights through both packages' loaders."""
    sub = "" if mode == "snv" else "indel"
    path = os.path.join(ASSETS, "flagship_ont_snv", sub,
                        "aff.npz" if kind == "cvt" else "neg.npz")
    jparams, jconfig = jax_load_auto(path, mode=mode, kind=kind)
    model, config = load_checkpoint_auto(path, mode=mode, kind=kind, device="cpu")
    assert config.alleles == jconfig.alleles
    x = _input(n=4, seed=3)
    fwd = jcvt.forward if kind == "cvt" else jbigru.forward
    want = _jax_logits(fwd, jparams, x, jconfig)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("kind", ["cvt", "bigru"])
def test_params_from_jax_round_trip(kind, tmp_path):
    """A JAX checkpoint written by the JAX package, read by the port, gives
    the same state as params_from_jax, and every tensor round-trips."""
    if kind == "cvt":
        jc, tc = jcvt.CvTConfig(**TINY["snv"][0]), tcvt.CvTConfig(**TINY["snv"][0])
        params = _numpy_tree(jcvt.init(jax.random.PRNGKey(4), jc))
        arch = dict(kind="cvt", **TINY["snv"][0])
    else:
        jc, tc = jbigru.BiGRUConfig(**TINY["snv"][1]), tbigru.BiGRUConfig(**TINY["snv"][1])
        params = _numpy_tree(jbigru.init(jax.random.PRNGKey(5), jc))
        arch = dict(kind="bigru", **TINY["snv"][1])
    state = params_from_jax(params, kind, tc)
    path = save_checkpoint(str(tmp_path / f"{kind}.npz"), params, arch=arch)
    model, config = load_checkpoint_auto(path, kind=kind, device="cpu")
    assert config == tc
    loaded = model.state_dict()
    assert set(loaded) == set(state)
    for k, v in state.items():
        np.testing.assert_array_equal(loaded[k].numpy(), v.numpy())
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    for keypath, leaf in flat:
        name = keypath_to_name("/".join(str(k) for k in keypath))
        np.testing.assert_array_equal(loaded[name].numpy(), leaf)


def test_keypath_parse():
    assert keypath_to_name("['stages']/[0]/['blocks']/[12]/['ff']/['w1']") == \
        "stages.0.blocks.12.ff.w1"
    with pytest.raises(ValueError):
        keypath_to_name("stages/0")


def test_random_init_is_seeded():
    a = tbigru.BiGRU(tbigru.BiGRUConfig(hidden1=8, hidden2=8)).reset_parameters(
        torch.Generator().manual_seed(3))
    b = tbigru.BiGRU(tbigru.BiGRUConfig(hidden1=8, hidden2=8)).reset_parameters(
        torch.Generator().manual_seed(3))
    for (k, u), v in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(u, v), k
    c = tcvt.CvT(tcvt.CvTConfig(**TINY["snv"][0])).reset_parameters(
        torch.Generator().manual_seed(3))
    assert torch.isfinite(c(torch.from_numpy(_input(n=2)))).all()
