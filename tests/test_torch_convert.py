"""The port's checkpoint conversion (clairs_to_tpu_torch/models/convert.py)
against the JAX package's: a random state dict under the reference's torch
names maps onto equal parameter trees, which load into the port's modules,
and ``convert_checkpoint`` writes the same ``.npz`` from a whole-module
pickle and from a plain state dict."""

from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

from clairs_to_tpu.models import bigru as jbigru
from clairs_to_tpu.models import convert as jconvert
from clairs_to_tpu.models import cvt as jcvt
from clairs_to_tpu_torch.models import convert as tconvert
from clairs_to_tpu_torch.models import bigru as tbigru
from clairs_to_tpu_torch.models import cvt as tcvt
from clairs_to_tpu_torch.models.checkpoint import keypaths, params_from_jax

torch.set_num_threads(1)
TINY_CVT = dict(emb_dims=(8, 16, 32), heads=(1, 1, 2), depths=(1, 2, 1))
TINY_BIGRU = dict(hidden1=16, hidden2=24)


def _configs(kind, mode, tiny=True):
    alleles = dict(alleles=jcvt.INDEL_ALLELES) if mode == "indel" else {}
    if kind == "cvt":
        base = jcvt.SNV_CVT_CONFIG if mode == "snv" else jcvt.INDEL_CVT_CONFIG
        jc = replace(base, **TINY_CVT, **alleles) if tiny else base
        return jc, tcvt.CvTConfig(**{f: getattr(jc, f) for f in jc.__dataclass_fields__})
    jc = replace(jbigru.BiGRUConfig(**alleles), **TINY_BIGRU) if tiny else (
        jbigru.SNV_BIGRU_CONFIG if mode == "snv" else jbigru.INDEL_BIGRU_CONFIG)
    return jc, tbigru.BiGRUConfig(**{f: getattr(jc, f) for f in jc.__dataclass_fields__})


def reference_state_dict(kind, jconfig, seed=0):
    """Random arrays under the reference's state-dict names.  The names and
    shapes are read off the JAX converter itself: each name it asks for is
    answered with its own index, and the index's place in the tree gives
    the shape of the JAX ``init`` leaf there.  ``kind``: "cvt" | "bigru"."""
    names = []

    class Recorder(dict):
        def __missing__(self, key):
            names.append(key)
            return np.float32(len(names) - 1)

    fn = jconvert.cvt_params_from_state_dict if kind == "cvt" else \
        jconvert.bigru_params_from_state_dict
    init_fn = jcvt.init if kind == "cvt" else jbigru.init
    init = jax.eval_shape(lambda: init_fn(jax.random.PRNGKey(0), jconfig))
    shapes = {}
    jax.tree_util.tree_map(lambda i, leaf: shapes.__setitem__(names[int(i)], leaf.shape),
                           fn(Recorder(), jconfig), init)
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=shapes[k]).astype(np.float32) for k in names}


def _flat(tree):
    return {k: np.asarray(v) for k, v in keypaths(tree)}


@pytest.mark.parametrize("mode", ["snv", "indel"])
@pytest.mark.parametrize("kind", ["cvt", "bigru"])
def test_state_dict_converts_to_equal_trees(kind, mode):
    jc, tc = _configs(kind, mode)
    sd = reference_state_dict(kind, jc)
    if kind == "cvt":
        want, got = jconvert.cvt_params_from_state_dict(sd, jc), \
            tconvert.cvt_params_from_state_dict(sd, tc)
    else:
        want, got = jconvert.bigru_params_from_state_dict(sd, jc), \
            tconvert.bigru_params_from_state_dict(sd, tc)
    want, got = _flat(jax.tree_util.tree_map(np.asarray, want)), _flat(got)
    assert sorted(got) == sorted(want)
    assert all(got[k].dtype == np.float32 and np.array_equal(got[k], want[k]) for k in want)
    # every reference array lands somewhere, once
    assert sorted(float(v.ravel()[0]) for v in got.values()) == \
        sorted(float(v.ravel()[0]) for v in sd.values())
    # and the tree is a state dict of the port's module
    model = (tcvt.CvT if kind == "cvt" else tbigru.BiGRU)(tc)
    model.load_state_dict(params_from_jax(
        tconvert.cvt_params_from_state_dict(sd, tc) if kind == "cvt"
        else tconvert.bigru_params_from_state_dict(sd, tc), kind, tc))


def test_load_npz_state_dict_matches_jax(tmp_path):
    jc, _tc = _configs("bigru", "snv")
    sd = reference_state_dict("bigru", jc)
    path = str(tmp_path / "sd.npz")
    np.savez(path, **sd)
    want, got = jconvert.load_npz_state_dict(path), tconvert.load_npz_state_dict(path)
    assert sorted(got) == sorted(want) == sorted(sd)
    assert all(np.array_equal(got[k], want[k]) for k in sd)
