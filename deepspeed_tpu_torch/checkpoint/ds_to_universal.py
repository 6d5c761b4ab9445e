"""Engine checkpoint → universal checkpoint (the port of
``deepspeed_tpu/checkpoint/ds_to_universal.py``; reference
``checkpoint/ds_to_universal.py``: ``extract_zero_shards`` :112,
``merge_tp_slices`` :232).

Reads a tag of the port or of upstream DeepSpeed (ZeRO 0-3, the per-rank
files of ``runtime/checkpoint_engine.py``), merges every partition's pieces
into whole parameters (``zero_to_fp32.assemble``) and writes the universal
layout the JAX package reads:

    {out}/universal_meta.json    {"engine_state", "step", "params",
                                  "param_names"}
    {out}/ds_version
    {out}/zero/{name}/fp32.npy, exp_avg.npy, exp_avg_sq.npy

``name`` is the JAX package's flax path and the arrays are in the flax
shapes when the tag's model has ``params_to_flax`` (its record in
``engine_state.json``, ``checkpoint_engine.module_record``);
``param_names`` is then ``"flax"``.  A tag of a ``PipelineModule`` (a
pipeline's stages, or the base engine on ``to_module()``) records its
geometry instead, and its leaves are written as the JAX
``PipelineEngine``'s tree (``runtime/pipe/module.py:params_to_flax``: the
block stack laid out for the tag's stage count, pad slots zero).
Otherwise the module's torch names and shapes stay and ``param_names``
says ``"torch"``.  Runs on the CPU.

A tag of ZeRO-Infinity parameter streaming (``runtime/infinity_engine.py``)
converts too, as JAX's ``_convert_infinity`` does: the world-1
``infinity_state.pkl`` (flax trees, moments flat in flax leaf order; the
JAX package's or the port's), or the per-rank slices of a world > 1 tag,
put together group by group through its manifest.  The lr scheduler, the
client state and the counters go into ``engine_state``.
"""

import argparse
import importlib
import json
import os

import numpy as np

from .constants import DS_VERSION, STATE_FIELDS, STATE_FIELD_TO_UNIVERSAL, \
    UNIVERSAL_META, ZERO_FILE_PREFIX
from .zero_to_fp32 import param_shapes, assemble, resolve_tag

# the streamed tag's keys that go into the universal engine_state
_STREAMED_STATE = ("lr_scheduler", "client_state", "data_sampler",
                   "curriculum_scheduler")


def flax_converter(record, pipeline=None):
    """``named → flax tree`` of the model a tag's ``"module"`` record
    names, or of the ``PipelineModule`` whose geometry its ``"pipeline"``
    record holds (the JAX ``PipelineEngine``'s tree, its block stack laid
    out for the tag's stage count), or None."""
    if pipeline:
        from ..runtime.pipe.module import params_to_flax
        return lambda named: params_to_flax(named, pipeline,
                                            pipeline["num_stages"])
    if not record:
        return None
    mod = importlib.import_module(record["module"])
    cfg = getattr(mod, record["config_class"])(**record["config"])
    return lambda named: mod.params_to_flax(named, cfg)


def flatten(tree, prefix=""):
    """Nested dict → ``{"a/b/c": leaf}``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def convert_to_universal(checkpoint_dir, output_dir, tag=None):
    """Convert the tag at ``checkpoint_dir`` (``tag``, else ``latest``)
    into the universal layout at ``output_dir``; returns ``output_dir``."""
    from ..runtime.checkpoint_engine import read_tag
    tag = resolve_tag(checkpoint_dir, tag)
    root = os.path.join(checkpoint_dir, tag) if tag else checkpoint_dir
    if not os.path.isdir(root):
        raise FileNotFoundError(f"no checkpoint at {root}")
    if os.path.exists(os.path.join(root, "infinity_state.pkl")):
        return _write(output_dir, *_streamed_pkl(root))
    if os.path.exists(os.path.join(root, "infinity_manifest.json")):
        return _write(output_dir, *_streamed_shards(root))
    engine_state, model_sd, sources, step = read_tag(root)
    shapes = param_shapes(model_sd)
    held = [f for f in STATE_FIELDS if any(f in flats for _, flats in
                                           sources)]
    fields = {f: assemble(shapes, sources, f) for f in held}
    to_flax = flax_converter(engine_state.get("module"),
                             engine_state.get("pipeline"))
    if to_flax is not None:
        fields = {f: flatten(to_flax(full)) for f, full in fields.items()}
    else:
        fields = {f: {n: t.numpy() for n, t in full.items()}
                  for f, full in fields.items()}
    return _write(output_dir, fields, engine_state,
                  step if step is not None else engine_state.get(
                      "global_steps", 0),
                  "flax" if to_flax is not None else "torch")


def _streamed_state(state):
    """The universal ``engine_state`` of a streamed tag's counters."""
    es = {k: state.get(k, 0) for k in ("global_steps", "global_samples",
                                       "micro_steps")}
    for key in _STREAMED_STATE:
        if state.get(key):
            es[key] = json.loads(json.dumps(
                state[key], default=lambda o: o.item()))
    return es


def _kinds_to_fields(kinds_by_group, leaves_of):
    """{group: {kind: flat}} → {universal field: {name: array}}, each
    group's flat cut by ``leaves_of(group, flat)`` into {name: array}."""
    fields = {}
    for key, kinds in kinds_by_group.items():
        for kind, flat in kinds.items():
            uni = STATE_FIELD_TO_UNIVERSAL.get(kind)
            if uni is not None:
                fields.setdefault(uni, {}).update(leaves_of(key, flat))
    return fields


def _streamed_pkl(root):
    """``infinity_state.pkl`` (JAX ``_convert_infinity``)."""
    import pickle

    from ..runtime.infinity_engine import unflatten_like
    with open(os.path.join(root, "infinity_state.pkl"), "rb") as f:
        state = pickle.load(f)
    masters = dict(state["master"])
    resident = masters.pop("__resident__", {})

    def prefix(key):
        return "" if key == "__resident__" else key + "/"

    def leaves_of(key, flat):
        tree = resident if key == "__resident__" else masters[key]
        return flatten(unflatten_like(tree, np.asarray(flat, np.float32)),
                       prefix(key))

    merged = dict(resident)
    merged.update(masters)
    fields = {"fp32": flatten(merged)}
    opt = state.get("opt") or {}
    fields.update(_kinds_to_fields(opt.get("kinds") or {}, leaves_of))
    step = int(opt.get("step_count", state.get("global_steps", 0)))
    return fields, _streamed_state(state), step, "flax"


def _streamed_shards(root):
    """A world > 1 streamed tag: each group's whole vectors from the
    ranks' slices, named through the manifest, in flax names when the
    model has ``params_to_flax``."""
    import torch
    with open(os.path.join(root, "infinity_manifest.json")) as f:
        man = json.load(f)
    parts = [torch.load(os.path.join(root, f"infinity_rank_{q}.pt"),
                        map_location="cpu", mmap=True, weights_only=True)
             for q in range(man["world"])]

    def whole(key, kind=None):
        return torch.cat([p["master"][key] if kind is None
                          else p["kinds"][key][kind] for p in parts])

    def named(key, flat):
        return {name: flat[o:o + k].reshape(shape).clone()
                for name, o, k, shape in man["groups"][key]["leaves"]}

    fields = {"fp32": {}}
    kinds = {}
    for key in man["groups"]:
        fields["fp32"].update(named(key, whole(key)))
        kinds[key] = {k: whole(key, k) for k in parts[0]["kinds"][key]}
    fields.update(_kinds_to_fields(kinds, named))
    to_flax = flax_converter(man.get("module"))
    if to_flax is not None:
        fields = {f: flatten(to_flax(full)) for f, full in fields.items()}
    else:
        fields = {f: {n: t.numpy() for n, t in full.items()}
                  for f, full in fields.items()}
    return (fields, _streamed_state(man), int(man["step_count"]),
            "flax" if to_flax is not None else "torch")


def _write(output_dir, fields, engine_state, step, param_names):
    """The universal layout of ``fields`` ({field: {name: array}})."""
    zero_root = os.path.join(output_dir, ZERO_FILE_PREFIX)
    param_meta = {}
    for name, arr in fields["fp32"].items():
        pdir = os.path.join(zero_root, name)
        os.makedirs(pdir, exist_ok=True)
        for f, leaves in fields.items():
            np.save(os.path.join(pdir, f"{f}.npy"),
                    np.asarray(leaves[name], dtype=np.float32))
        param_meta[name] = {"shape": list(arr.shape), "dtype": "float32"}
    meta = {
        "engine_state": engine_state,
        "step": step,
        "params": param_meta,
        "param_names": param_names,
    }
    with open(os.path.join(output_dir, UNIVERSAL_META), "w") as f:
        json.dump(meta, f, indent=2)
    from .. import __version__
    with open(os.path.join(output_dir, DS_VERSION), "w") as f:
        f.write(__version__)
    return output_dir


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Convert a checkpoint to the universal layout "
        "(reference ds_to_universal.py CLI)")
    p.add_argument("--input_folder", required=True)
    p.add_argument("--output_folder", required=True)
    p.add_argument("--tag", default=None)
    args = p.parse_args(argv)
    convert_to_universal(args.input_folder, args.output_folder, tag=args.tag)
    print(f"universal checkpoint written to {args.output_folder}")


if __name__ == "__main__":
    main()
