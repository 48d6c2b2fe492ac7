"""Checkpoints: the JAX package's parameter layout into the port's modules.

Counterparts of clairs_to_tpu/train.py::checkpoint_arch, load_checkpoint
and load_checkpoint_auto.  A JAX checkpoint is a flat ``.npz`` whose keys
are jax keypath strings such as ``"['stages']/[0]/['blocks']/[0]/['ff']/['w1']"``;
the port's module attributes carry the same names, so each key maps to the
``state_dict`` key ``stages.0.blocks.0.ff.w1``.  Nothing here needs jax.
"""

import json
import re

import numpy as np
import torch

from clairs_to_tpu_torch.models import bigru as bigru_mod
from clairs_to_tpu_torch.models import cvt as cvt_mod

_SEGMENT = re.compile(r"\['([^']*)'\]|\[(\d+)\]")


def keypath_to_name(keypath: str) -> str:
    """``"['gru1']/['ih']/['weight']"`` -> ``"gru1.ih.weight"``."""
    parts = []
    for seg in keypath.split("/"):
        m = _SEGMENT.fullmatch(seg)
        if m is None:
            raise ValueError(f"not a jax keypath segment: {seg!r} in {keypath!r}")
        parts.append(m.group(1) if m.group(1) is not None else m.group(2))
    return ".".join(parts)


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield prefix, tree
        return
    for k, v in items:
        yield from _flatten(v, f"{prefix}.{k}" if prefix else str(k))


def _model(kind, config):
    if kind == "cvt":
        return cvt_mod.CvT(config)
    if kind == "bigru":
        return bigru_mod.BiGRU(config)
    raise ValueError(f"unknown model kind {kind!r}")


def params_from_jax(tree, kind, config):
    """The JAX parameter pytree (numpy leaves) as this port's ``state_dict``
    for a ``kind`` ("cvt" | "bigru") model of ``config``; checked against the
    module, key for key and shape for shape."""
    state = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in _flatten(tree)}
    _model(kind, config).load_state_dict(state, strict=True)   # raises on mismatch
    return state


def checkpoint_arch(path):
    """The '__arch__' metadata dict of a checkpoint, or None."""
    with np.load(path) as data:
        if "__arch__" not in data.files:
            return None
        return json.loads(bytes(data["__arch__"]).decode())


def load_checkpoint(path, model):
    """Load a JAX ``.npz`` checkpoint into ``model`` (strict) and return it."""
    with np.load(path) as data:
        state = {keypath_to_name(k): torch.from_numpy(np.asarray(data[k], np.float32))
                 for k in data.files if k != "__arch__"}
    model.load_state_dict(state, strict=True)
    return model


def _config_from_arch(cls, arch):
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in arch.items() if k != "kind"})


def load_checkpoint_auto(path, mode="snv", kind="cvt", device="cuda"):
    """Load a checkpoint, rebuilding its architecture from '__arch__' (or the
    default flagship config when absent).  Returns (model on ``device`` in
    eval mode, config)."""
    arch = checkpoint_arch(path)
    if kind == "cvt":
        config = (_config_from_arch(cvt_mod.CvTConfig, arch) if arch else
                  cvt_mod.SNV_CVT_CONFIG if mode == "snv" else cvt_mod.INDEL_CVT_CONFIG)
    else:
        config = (_config_from_arch(bigru_mod.BiGRUConfig, arch) if arch else
                  bigru_mod.SNV_BIGRU_CONFIG if mode == "snv"
                  else bigru_mod.INDEL_BIGRU_CONFIG)
    model = load_checkpoint(path, _model(kind, config))
    return model.to(device).eval(), config
