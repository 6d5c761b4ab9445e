"""Per-expert checkpoint files (the port of
``deepspeed_tpu/moe/checkpoint.py``; reference ``engine.py:3241
_save_moe_checkpoint``): each stacked expert leaf exploded into one npz a
(layer, expert), ``{tag}/layer_{L}_expert_{E}_model_states.npz``, whose
keys are the JAX package's flax paths (``moe/deepspeed_moe/experts/fc1/
kernel``, ``layers_0/moe/w1``), so that files written by either package
load in the other.  The engine's own checkpoints already hold the global
stacks and resume at any ep degree; these files are the interchange
layout for systems that keep experts apart."""

import os
import re

import numpy as np
import torch

from ..utils.logging import logger

# stacked expert leaves, as flax paths: anything under an "experts" scope
# (moe/layer.py's Experts) or Mixtral's moe/w1..w3
_EXPERT_PAT = re.compile(r"(^|/)experts(/|$)|(^|/)moe/w[123]$")
_LAYER_PAT = re.compile(r"(?:^|/)layers?_(\d+)(?:/|$)")
_MIXTRAL = re.compile(r"^model\.layers\.(\d+)\.block_sparse_moe\.(\w+)$")


def flax_path(name):
    """A port parameter name as the JAX package's flax path: Mixtral's
    ``model.layers.{i}.block_sparse_moe.w1`` is ``layers_{i}/moe/w1``
    (its gate ``layers_{i}/moe/gate/kernel``); every other name (the MoE
    layer's, whose modules carry flax's names) joins its parts with
    ``/``."""
    m = _MIXTRAL.match(name)
    if m:
        leaf = m.group(2)
        return f"layers_{m.group(1)}/moe/" + (
            "gate/kernel" if leaf == "gate" else leaf)
    return name.replace(".", "/")


def is_expert_path(path):
    return bool(_EXPERT_PAT.search(path))


def _layer_of(path):
    m = _LAYER_PAT.search(path)
    return int(m.group(1)) if m else 0


def _numpy(t):
    return (t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(t, dtype=np.float32))


def save_moe_expert_files(named, save_dir, tag="exported"):
    """``named``: {port name: tensor} (e.g. ``engine.fp32_params()``).
    Writes one npz a (layer, expert) of the expert leaves, in fp32; returns
    the files written."""
    root = os.path.join(save_dir, tag)
    os.makedirs(root, exist_ok=True)
    per_file = {}
    for name, leaf in named.items():
        path = flax_path(name)
        if not is_expert_path(path):
            continue
        arr = _numpy(leaf)
        layer = _layer_of(path)
        for e in range(arr.shape[0]):
            fname = f"layer_{layer}_expert_{e}_model_states.npz"
            per_file.setdefault(fname, {})[path] = arr[e]
    files = []
    for fname, tree in per_file.items():
        out = os.path.join(root, fname)
        np.savez(out, **tree)
        files.append(out)
    logger.info(f"saved {len(files)} expert files to {root}")
    return files


def load_moe_expert_files(named, load_dir, tag="exported"):
    """The stacks of ``named`` ({port name: tensor}) rebuilt from the
    per-expert files (each in its leaf's dtype and device); the other
    leaves pass through.  Returns a new dict."""
    root = os.path.join(load_dir, tag)
    stacks = {}
    for fname in sorted(os.listdir(root)):
        m = re.match(r"layer_(\d+)_expert_(\d+)_model_states\.npz", fname)
        if not m:
            continue
        e = int(m.group(2))
        with np.load(os.path.join(root, fname)) as data:
            for path in data.files:
                stacks.setdefault(path, {})[e] = data[path]
    out = {}
    for name, leaf in named.items():
        path = flax_path(name)
        if path not in stacks:
            out[name] = leaf
            continue
        by_e = stacks[path]
        arr = np.stack([by_e[e] for e in sorted(by_e)])
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{path}: expert files give {arr.shape}, the "
                             f"model expects {tuple(leaf.shape)}")
        out[name] = torch.from_numpy(arr).to(dtype=leaf.dtype,
                                             device=leaf.device)
    return out
