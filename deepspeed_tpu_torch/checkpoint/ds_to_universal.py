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
``param_names`` is then ``"flax"``.  Otherwise the module's torch names and
shapes stay and ``param_names`` says ``"torch"``.  Runs on the CPU.
"""

import argparse
import importlib
import json
import os

import numpy as np

from .constants import DS_VERSION, STATE_FIELDS, UNIVERSAL_META, \
    ZERO_FILE_PREFIX
from ..utils.not_ported import not_ported
from .zero_to_fp32 import param_shapes, assemble, resolve_tag


def flax_converter(record):
    """``named → flax tree`` of the model a tag's ``"module"`` record
    names, or None."""
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
        # JAX ds_to_universal.py:51 converts a streaming engine's tag
        raise not_ported("converting a ZeRO-Infinity parameter-streaming "
                         "tag (infinity_state.pkl) to the universal layout",
                         10)
    engine_state, model_sd, sources, step = read_tag(root)
    shapes = param_shapes(model_sd)
    held = [f for f in STATE_FIELDS if any(f in flats for _, flats in
                                           sources)]
    fields = {f: assemble(shapes, sources, f) for f in held}
    to_flax = flax_converter(engine_state.get("module"))
    if to_flax is not None:
        fields = {f: flatten(to_flax(full)) for f, full in fields.items()}
    else:
        fields = {f: {n: t.numpy() for n, t in full.items()}
                  for f, full in fields.items()}
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
        "step": step if step is not None else engine_state.get(
            "global_steps", 0),
        "params": param_meta,
        "param_names": "flax" if to_flax is not None else "torch",
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
