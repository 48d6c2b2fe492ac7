"""The port's CvT and BiGRU (clairs_to_tpu_torch/models) against the JAX
package's, and the checkpoint layout carried across."""

import hashlib
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

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


# the 1x1 convolutions of a stage-3 block of the flagship SNV CvT: the
# module path of the weight and of its bias (None where the site has none)
CONV1X1_SITES = {
    "to_q": ("attn.to_q.pw_weight", None),
    "to_kv": ("attn.to_kv.pw_weight", None),
    "out": ("attn.out_weight", "attn.out_bias"),
    "w1": ("ff.w1", "ff.b1"),
    "w2": ("ff.w2", "ff.b2"),
}


@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("site", sorted(CONV1X1_SITES))
def test_conv1x1_is_the_1x1_convolution(site, with_bias, channels_last):
    """``conv1x1`` on the tokens of an image equals ``F.conv2d`` with the
    1x1 weight on the image: the output, the input's gradient and the
    weight's and bias's gradients, to fp32 round-off; the weight's
    gradient lands in the (O, C, 1, 1) leaf."""
    block = tcvt.CvT(tcvt.SNV_CVT_CONFIG).reset_parameters(
        torch.Generator().manual_seed(0)).stages[2].blocks[0]
    w_name, b_name = CONV1X1_SITES[site]
    weight = block.get_parameter(w_name).detach()
    out_c, in_c = weight.shape[:2]
    assert weight.shape[2:] == (1, 1)
    g = torch.Generator().manual_seed(len(site) + 2 * with_bias + 4 * channels_last)
    bias = None
    if with_bias:
        bias = (block.get_parameter(b_name).detach() if b_name else torch.zeros(out_c))
        bias = bias + torch.randn(out_c, generator=g)
    x = torch.randn(6, in_c, 1, 5, generator=g)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    up = torch.randn(6, out_c, 1, 5, generator=g)

    def run(form):
        leaves = [t.clone().requires_grad_(True) for t in (x, weight)]
        if bias is not None:
            leaves.append(bias.clone().requires_grad_(True))
        b = leaves[2] if bias is not None else None
        if form == "conv":
            y = tcvt.tokens(F.conv2d(leaves[0], leaves[1], b))
        else:
            y = tcvt.conv1x1(tcvt.tokens(leaves[0]), leaves[1], b)
        (y * tcvt.tokens(up)).sum().backward()
        return [y.detach()] + [t.grad for t in leaves]

    want, got = run("conv"), run("gemm")
    assert got[2].shape == weight.shape
    for name, u, v in zip(("output", "input", "weight", "bias"), got, want):
        err = float((u - v).abs().max())
        assert err <= 1e-5 * float(v.abs().max()), (name, err)


@pytest.mark.parametrize("mode,stage", [("snv", 0), ("snv", 1), ("snv", 2), ("indel", 0),
                                        ("indel", 1)])
def test_embed_is_the_stage_convolution(mode, stage):
    """A stage embed as one GEMM over the tokens' 3-wide windows equals
    ``F.conv2d`` (3x3, stride 2, padding 1) on their one-row image: the
    output, the input's gradient, the whole 3x3 weight's gradient (its
    outer rows exactly 0, as the convolution gives them) and the bias's."""
    config = tcvt.SNV_CVT_CONFIG if mode == "snv" else tcvt.INDEL_CVT_CONFIG
    dims = (config.in_channels,) + config.emb_dims
    width = config.width
    for _ in range(stage):
        width = (width - 1) // 2 + 1
    g = torch.Generator().manual_seed(10 * stage + len(mode))
    x = torch.randn(6, width, dims[stage], generator=g)
    weight = torch.randn(dims[stage + 1], dims[stage], 3, 3, generator=g) * 0.2
    bias = torch.randn(dims[stage + 1], generator=g)
    up = torch.randn(6, (width - 1) // 2 + 1, dims[stage + 1], generator=g)

    def run(form):
        leaves = [t.clone().requires_grad_(True) for t in (x, weight, bias)]
        if form == "conv":
            y = tcvt.tokens(F.conv2d(tcvt.image(leaves[0]), leaves[1], leaves[2],
                                     stride=(2, 2), padding=(1, 1)))
        else:
            y = tcvt.embed(*leaves, config.emb_stride)
        (y * up).sum().backward()
        return [y.detach()] + [t.grad for t in leaves]

    want, got = run("conv"), run("gemm")
    assert got[0].shape == want[0].shape == up.shape
    for name, u, v in zip(("output", "input", "weight", "bias"), got, want):
        err = float((u - v).abs().max())
        assert err <= 1e-5 * float(v.abs().max()), (name, err)
    outer = got[2][:, :, (0, 2)]
    assert torch.equal(outer, torch.zeros_like(outer))


@pytest.mark.parametrize("mode,count,digest", [
    ("snv", 316, "2fafcabe78e2397421245ebe7ae24e599012bfe0d4c5cd3b9645ec33fb3d1553"),
    ("indel", 170, "583cc196dc6c529ab2e5d362f8e6086591a3b711d32e65e53cf2f191146ab322"),
])
def test_cvt_state_dict_keeps_its_keys_and_shapes(mode, count, digest):
    """The flagship CvT's ``state_dict``: the JAX parameter tree's keys and
    shapes, in the order the checkpoints hold them (the digest of
    ``key:shape`` lines pins it)."""
    config = tcvt.SNV_CVT_CONFIG if mode == "snv" else tcvt.INDEL_CVT_CONFIG
    state = tcvt.CvT(config).state_dict()
    jc = jcvt.SNV_CVT_CONFIG if mode == "snv" else jcvt.INDEL_CVT_CONFIG
    want = params_from_jax(_numpy_tree(jcvt.init(jax.random.PRNGKey(0), jc)), "cvt", config)
    assert {k: tuple(v.shape) for k, v in state.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    lines = "\n".join(f"{k}:{tuple(v.shape)}" for k, v in state.items())
    assert (len(state), hashlib.sha256(lines.encode()).hexdigest()) == (count, digest)


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
