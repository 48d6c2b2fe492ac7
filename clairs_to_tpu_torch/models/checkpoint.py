"""Checkpoints: the JAX package's parameter layout into the port's modules.

Counterparts of clairs_to_tpu/train.py::save_checkpoint, checkpoint_arch,
load_checkpoint and load_checkpoint_auto.  A JAX checkpoint is a flat
``.npz`` whose keys are jax keypath strings such as
``"['stages']/[0]/['blocks']/[0]/['ff']/['w1']"``; the port's module
attributes carry the same names, so each key maps to the ``state_dict`` key
``stages.0.blocks.0.ff.w1``, and back.  Nothing here needs jax.
"""

import json
import re

import numpy as np
import torch
from torch import nn

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


def module_tree(model):
    """A module's parameters and buffers as the JAX package's nested tree:
    a ``ModuleList`` is a list, any other module a dict of its tensors and
    children."""
    if isinstance(model, nn.ModuleList):
        return [module_tree(m) for m in model]
    tree = dict(model.named_parameters(recurse=False))
    tree.update(model.named_buffers(recurse=False))
    tree.update((k, module_tree(m)) for k, m in model.named_children())
    return tree


def keypaths(tree, prefix=()):
    """(jax keypath string, leaf) in ``jax.tree_util.tree_flatten_with_path``
    order: dict keys sorted, printed ``['k']``; list indices ``[i]``."""
    if isinstance(tree, dict):
        items = [(f"['{k}']", tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(f"[{i}]", v) for i, v in enumerate(tree)]
    else:
        yield "/".join(prefix), tree
        return
    for seg, v in items:
        yield from keypaths(v, prefix + (seg,))


def save_checkpoint(path, params, arch=None):
    """Flat ``.npz`` in the JAX package's key format, which its
    ``load_checkpoint`` reads.  ``params``: a ``CvT``/``BiGRU`` module (its
    buffers, the BatchNorm statistics, included) or a JAX-layout tree with
    array leaves.  ``arch``: an optional config dict stored under
    '__arch__'."""
    tree = module_tree(params) if isinstance(params, nn.Module) else params
    arrays = {}
    for key, leaf in keypaths(tree):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu().numpy()
        arrays[key] = np.asarray(leaf)
    if arch is not None:
        arrays["__arch__"] = np.frombuffer(json.dumps(arch).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)
    return path


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
    state = {keypath_to_name(k): torch.from_numpy(np.array(v, np.float32))
             for k, v in keypaths(tree)}
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
