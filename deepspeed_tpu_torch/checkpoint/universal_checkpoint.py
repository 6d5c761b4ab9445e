"""Load a universal checkpoint into a port engine at any ZeRO stage and world
size (the port of ``deepspeed_tpu/checkpoint/universal_checkpoint.py``;
reference ``checkpoint/universal_checkpoint.py:22
load_hp_checkpoint_state``).

The JAX loader ``device_put``s each global array with the engine's
shardings.  Here every parameter's files become a whole-leaf source of
``ZeroPartitionPlan.fill_shard``, so each rank copies its own pieces of the
fp32 master and the moments; the compute-dtype parameters are the master's
cast, as in JAX.  Directories written by the JAX package (and by the port
for models with ``params_to_flax``) name flax paths in flax shapes: each
field (``fp32``, ``exp_avg``, ``exp_avg_sq``) goes through the model's
``params_from_flax`` as a tree of its own (a pipeline stage's: the JAX
``PipelineEngine``'s tree, so a directory loads into a pipeline at any
pp, each stage taking its own leaves).  A field no parameter has is
left as it is (Lion has no ``exp_avg_sq``); one that some parameters lack
raises.

A ZeRO-Infinity streaming engine (``runtime/infinity_engine.py``) takes a
universal directory group by group into its host store, each rank its
slices (JAX ``_load_into_infinity``): the master, the host optimizer's
moments (``exp_avg`` → ``m``, ``exp_avg_sq`` → ``v``), the step, the
counters and the lr scheduler.
"""

import json
import os
import sys

import numpy as np
import torch

from ..utils.logging import log_dist
from .constants import (STATE_FIELD_TO_UNIVERSAL, STATE_FIELDS,
                        UNIVERSAL_META, ZERO_FILE_PREFIX)


def _unflatten(leaves):
    tree = {}
    for path, arr in leaves.items():
        node = tree
        *parents, last = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = arr
    return tree


def _from_flax(module, meta, trees):
    """``{field: flax tree} → {field: {name: fp32 tensor}}`` for the
    engine's model; for a ``PipelineModule``'s stage, from the JAX
    ``PipelineEngine``'s tree laid out for the stage count the directory
    records (else the one its block stacks show:
    ``pipe/module.py:stages_of_block_stack``)."""
    pipe = getattr(module, "pipe", None)
    if pipe is not None:
        from ..runtime.pipe import module as pipe_module
        record = meta.get("engine_state", {}).get("pipeline") or {}
        pp = record.get("num_stages")
        if pp is None:
            pp = pipe_module.stages_of_block_stack(
                pipe_module.geometry(pipe),
                [t["blocks"] for t in trees.values()])
        return {f: pipe_module.params_from_flax(t, pipe, pp)
                for f, t in trees.items()}
    pymod = sys.modules.get(type(module).__module__)
    convert = getattr(pymod, "params_from_flax", None)
    if convert is None or getattr(module, "config", None) is None:
        raise ValueError(
            f"{type(module).__name__} has no params_from_flax: a universal "
            "checkpoint with flax names cannot be mapped onto it")
    return {f: convert(t, module.config, dtype="float32")
            for f, t in trees.items()}


def read_universal(root, module):
    """``(meta, {field: {torch name: fp32 tensor}})`` of the universal
    directory ``root``, named as ``module``'s parameters."""
    meta_path = os.path.join(root, UNIVERSAL_META)
    if not os.path.exists(meta_path):
        raise FileNotFoundError(f"not a universal checkpoint: {meta_path}")
    with open(meta_path) as f:
        meta = json.load(f)
    zero_root = os.path.join(root, ZERO_FILE_PREFIX)
    names = list(meta["params"])
    fields = {}
    for field in STATE_FIELDS:
        paths = {n: os.path.join(zero_root, n, f"{field}.npy") for n in names}
        have = [n for n, p in paths.items() if os.path.exists(p)]
        if not have:
            continue
        if len(have) != len(names):
            lack = sorted(set(names) - set(have))
            raise KeyError(f"universal checkpoint {root}: {field} missing "
                           f"for {lack[:4]}")
        fields[field] = {n: np.load(p) for n, p in paths.items()}
    if "fp32" not in fields:
        raise KeyError(f"universal checkpoint {root} holds no fp32 weights")
    if meta.get("param_names", "flax") == "flax":
        fields = _from_flax(module, meta, {
            f: _unflatten(leaves) for f, leaves in fields.items()})
    else:
        fields = {f: {n: torch.from_numpy(np.asarray(a, np.float32))
                      for n, a in leaves.items()}
                  for f, leaves in fields.items()}
    return meta, fields


def load_universal_checkpoint(engine, load_dir, tag=None,
                              load_optimizer_states=True,
                              load_lr_scheduler_states=True,
                              load_module_only=False):
    """Fill ``engine``'s master, moments, parameters, counters, loss scale
    and lr scheduler from the universal directory ``load_dir[/tag]``;
    returns ``(directory, client_state)``.  Every rank calls it."""
    from ..runtime.checkpoint_engine import DATA_STATE_KEYS, restore_state
    from ..runtime.infinity_engine import InfinityEngine
    from ..utils.not_ported import not_ported
    root = os.path.join(load_dir, tag) if tag else load_dir
    meta, fields = read_universal(root, engine.module)
    es = meta.get("engine_state", {})
    data = [k for k in DATA_STATE_KEYS if k in es]
    if data and not load_module_only:
        raise not_ported(f"restoring {', '.join(data)} from a checkpoint "
                         "(the dataloader)", 4)
    if isinstance(engine, InfinityEngine):
        _load_into_infinity(engine, meta, fields,
                            load_optimizer_states and not load_module_only,
                            load_lr_scheduler_states and
                            not load_module_only)
        log_dist(f"ZeRO-Infinity: loaded universal checkpoint from {root} "
                 f"(step {meta.get('step', 0)})", ranks=[0])
        return root, es.get("client_state", {})
    sources = [({name: (0, t.numel(), 0)},
                {f: leaves[name].reshape(-1) for f, leaves in fields.items()})
               for name, t in fields["fp32"].items()]
    if load_module_only:
        # the parameters (and master) only, as the JAX loader returns here
        restore_state(engine, {}, None, sources, load_optimizer_states=False,
                      load_lr_scheduler_states=False)
    else:
        restore_state(engine, es, meta.get("step"), sources,
                      load_optimizer_states=load_optimizer_states,
                      load_lr_scheduler_states=load_lr_scheduler_states)
    log_dist(f"loaded universal checkpoint from {root} "
             f"(step {engine.global_steps})", ranks=[0])
    return root, es.get("client_state", {})


def _load_into_infinity(engine, meta, fields, load_opt, load_sched):
    """The universal ``fields`` ({field: {torch name: tensor}}) into the
    streaming engine's store, this rank's slice of each group."""
    store = engine._store

    def slice_of(key, leaves, full, field):
        src = fields.get(field)
        if key not in store.keys():
            store.add_group(key, leaves)
        flat = torch.zeros(store.numel(key), dtype=torch.float32)
        if src is not None:
            for name, o, k, _ in store.layout(key):
                flat[o:o + k].copy_(src[full(name)].reshape(-1))
        return store.take_slice(key, flat).clone()

    masters, kinds = {}, {}
    for key, leaves, full in engine._groups():
        masters[key] = slice_of(key, leaves, full, "fp32")
        if load_opt:
            kinds[key] = {
                kind: slice_of(key, leaves, full,
                               STATE_FIELD_TO_UNIVERSAL.get(kind, kind))
                for kind in store.KINDS[store.optimizer]}
    engine.install_state(masters, {"step_count": int(meta.get("step", 0)),
                                   "kinds": kinds} if load_opt else None)
    engine.restore_counters(meta.get("engine_state", {}), load_sched)
