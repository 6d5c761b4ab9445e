"""Consolidate a ZeRO checkpoint into one fp32 state dict (the port of
``deepspeed_tpu/checkpoint/zero_to_fp32.py``; reference
``deepspeed/utils/zero_to_fp32.py``).

``save_checkpoint`` copies this file into ``save_dir`` as the recovery
script, so it imports only torch and the standard library::

    python zero_to_fp32.py CHECKPOINT_DIR OUTPUT_FILE [-t TAG]

writes ``{name: fp32 tensor}`` (the module's names) with ``torch.save``.

It reads the port's tags and upstream torch DeepSpeed's ZeRO 0-3 tags, which
share one scheme: rank 0's ``mp_rank_00_model_states.pt`` (``"module"``,
``"param_shapes"``) and one ``zero_pp_rank_{r}_mp_rank_00_optim_states.pt``
a partition.  A tensor-parallel tag of the port (tp > 1) has one
``mp_rank_{t:02d}`` file a tp rank t, the first holding the whole module
and every one the tp geometry (``tp_world_size``, ``tp_splits``: {name:
the dim its slices split}), and optim files
``zero_pp_rank_{d}_mp_rank_{t:02d}_optim_states.pt`` whose pieces are of
the rank's slices; the reader joins the slices along their dim, so the
sources it returns are of the whole parameters.  A pipeline tag of the
port has one ``mp_rank_{s:02d}`` file a stage s (its leaves' shapes, and the ``layer_{idx:02d}-model_states.pt``
files holding its layers' weights) and optim files
``zero_pp_rank_{r}_mp_rank_{s:02d}_optim_states.pt``; a leaf tied across
stages lies in its first stage's files only.  Their
``"optimizer_state_dict"`` is either

* stage ≤ 2 content (the port's at every stage): ``param_slice_mappings``
  (per group ``{name: fragment_address(numel, start)}``),
  ``single_partition_of_fp32_groups`` (per group the rank's flat fp32
  partition) and ``base_optimizer_state["state"]`` (per group the flat
  ``exp_avg``/``exp_avg_sq`` and ``step``), and in the port's files of
  an expert-parallel run ``param_slice_offsets`` (per group ``{name:
  offset of the piece in the parameter}`` for the expert stacks, whose
  pieces do not follow the files' rank order); or
* upstream stage-3 content: ``fp32_flat_groups`` (one flat group, each
  parameter's ceil(numel/dp)-element slice in ``param_shapes`` order, the
  walk of upstream ``ds_to_universal.py:152``) and
  ``optimizer_state_dict["state"][0]``.

:func:`read_zero_tag` turns either into *sources*: one a saved flat group,
``(fragments, flats)`` with ``fragments = {name: (start, numel, within)}``
(the piece ``[within, within + numel)`` of the parameter lies at
``[start, start + numel)`` of each flat) and ``flats = {field: 1-D
tensor}``.  The port's loader fills its own shard from the same sources
(``ZeroPartitionPlan.fill_shard``).

The files pickle ``deepspeed.utils.tensor_fragment.fragment_address`` (and,
upstream, other ``deepspeed`` objects such as the loss scaler).  They are
read with an unpickler that maps that name to a compatible namedtuple and
every other ``deepspeed`` object to a permissive stand-in, so neither
upstream DeepSpeed nor a shim in ``sys.modules`` is needed; files are
memory-mapped, so a reader pages in only the pieces it copies.
"""

import argparse
import collections
import glob
import os
import pickle
import re
import types

import torch

MODEL_FILE = "mp_rank_00_model_states.pt"
MODEL_GLOB = "mp_rank_*_model_states.pt"
OPTIM_GLOB = "zero_pp_rank_*_mp_rank_*_optim_states.pt"
FIELDS = ("fp32", "exp_avg", "exp_avg_sq")
UPSTREAM_FRAGMENT = ("deepspeed.utils.tensor_fragment", "fragment_address")

fragment_address = collections.namedtuple("fragment_address",
                                          ["numel", "start"])
# pickled under upstream's import path (utils/tensor_fragment.py registers
# that module while the port writes)
fragment_address.__module__ = UPSTREAM_FRAGMENT[0]


def optim_file(rank, mp_rank=0):
    return f"zero_pp_rank_{rank}_mp_rank_{mp_rank:02d}_optim_states.pt"


def model_file(mp_rank):
    return f"mp_rank_{mp_rank:02d}_model_states.pt"


def layer_file(idx):
    """Upstream ``PipelineModule.ckpt_layer_path`` without a tensor-parallel
    rank: one file a layer, named by its index in the model."""
    return f"layer_{idx:02d}-model_states.pt"


class _Anything:
    """Stands in for any other pickled ``deepspeed`` object (the loss
    scaler, config enums): its state is kept as attributes."""

    def __init__(self, *args, **kwargs):
        self.args = args
        self.__dict__.update(kwargs)

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)


class _Unpickler(pickle.Unpickler):

    def find_class(self, module, name):
        if (module, name) == UPSTREAM_FRAGMENT:
            return fragment_address
        if module == "deepspeed" or module.startswith("deepspeed."):
            return _Anything
        return super().find_class(module, name)


_PICKLE = types.SimpleNamespace(__name__="zero_to_fp32_pickle",
                                Unpickler=_Unpickler, load=pickle.load)


def load_file(path, mmap=True):
    """``torch.load`` of one checkpoint file on the CPU, memory-mapped."""
    return torch.load(path, map_location="cpu", mmap=mmap,
                      weights_only=False, pickle_module=_PICKLE)


def resolve_tag(checkpoint_dir, tag=None):
    """``tag``, or the one the directory's ``latest`` names, or None."""
    if tag is None:
        latest = os.path.join(checkpoint_dir, "latest")
        if os.path.exists(latest):
            with open(latest) as f:
                tag = f.read().strip() or None
    return tag


def _rank_of(path):
    return [int(x) for x in re.findall(r"rank_(\d+)", os.path.basename(path))]


def param_shapes(model_sd):
    raw = model_sd.get("param_shapes")
    if raw is None:
        return collections.OrderedDict(
            (k, tuple(v.shape)) for k, v in (model_sd.get("module") or {})
            .items() if isinstance(v, torch.Tensor))
    shapes = collections.OrderedDict()
    for group in (raw if isinstance(raw, (list, tuple)) else [raw]):
        for name, shape in group.items():
            shapes[name] = tuple(int(x) for x in shape)
    return shapes


def _state_of(states, gid):
    return states[gid] if isinstance(states, (list, tuple)) else (
        states[gid] if gid in states else list(states.values())[gid])


def _flats(fp32, state):
    out = {"fp32": fp32.reshape(-1)}
    for key in FIELDS[1:]:
        if isinstance(state.get(key), torch.Tensor):
            out[key] = state[key].reshape(-1)
    return out


def _step(state):
    step = state.get("step")
    return None if step is None else int(step)


def _merge_stages(root, stage_sds, mmap=True):
    """One model state of a pipeline tag's stages (``mp_rank_{s}`` a
    stage): every stage's ``param_shapes``, in stage order, and the module
    from the layer files each stage names (``"layers"``: {file: the
    layer's prefix in the parameters' names})."""
    out = dict(stage_sds[0])
    shapes, module = collections.OrderedDict(), collections.OrderedDict()
    for sd in stage_sds:
        shapes.update(param_shapes(sd))
        for name, prefix in (sd.get("layers") or {}).items():
            for k, v in load_file(os.path.join(root, name), mmap).items():
                module[f"{prefix}.{k}"] = v
    out["param_shapes"] = [shapes]
    out["module"] = module or None
    return out


def read_zero_tag(root, mmap=True):
    """``(model states, {name: shape}, sources, step)`` of the tag at
    ``root`` (module docstring); ``step`` is the optimizer's count, or None
    when no file records it.  A pipeline tag's stages (``mp_rank_{s}``)
    are read as one model, a tensor-parallel tag's slices joined."""
    model_path = os.path.join(root, MODEL_FILE)
    if not os.path.exists(model_path):
        raise FileNotFoundError(f"no {MODEL_FILE} under {root}")
    model_sd = load_file(model_path, mmap)
    tp = int(model_sd.get("tp_world_size") or 1)
    stages = sorted(glob.glob(os.path.join(root, MODEL_GLOB)), key=_rank_of)
    if tp == 1 and (len(stages) > 1 or model_sd.get("layers")):
        model_sd = _merge_stages(root, [load_file(p, mmap) for p in stages],
                                 mmap)
    shapes = param_shapes(model_sd)
    # by stage (mp rank), then partition: a leaf lies in one stage's files
    paths = sorted(glob.glob(os.path.join(root, OPTIM_GLOB)),
                   key=lambda p: _rank_of(p)[::-1])
    if model_sd.get("frozen_param_shapes"):
        raise ValueError(f"{root}: frozen parameters are not read (the "
                         "port trains every parameter)")
    if tp > 1:
        sources, step = _tp_sources(model_sd, shapes, paths, tp, mmap)
        return model_sd, shapes, sources, step
    sources, step = _read_optim(root, paths, shapes, mmap)
    return model_sd, shapes, sources, step


def _tp_sources(model_sd, shapes, paths, tp, mmap):
    """Sources of the whole parameters from a tensor-parallel tag: each tp
    rank's files read in its slices' coordinates, the replicated leaves
    from rank 0's, each split leaf's slices joined along its dim (one
    source a leaf)."""
    splits = {n: int(d) for n, d in model_sd["tp_splits"].items()}
    local = collections.OrderedDict()
    for name, shape in shapes.items():
        shape = list(shape)
        if name in splits:
            # a padded leaf's slices are ceil(dim / tp) long
            shape[splits[name]] = -(-shape[splits[name]] // tp)
        local[name] = tuple(shape)
    per_rank = [_read_optim(os.path.dirname(paths[0]) if paths else "",
                            [p for p in paths if _rank_of(p)[1] == t],
                            local, mmap) for t in range(tp)]
    sources = []
    for frags, flats in per_rank[0][0]:
        keep = {n: f for n, f in frags.items() if n not in splits}
        if keep:
            sources.append((keep, flats))
    for name, dim in splits.items():
        flats = {}
        for field in FIELDS:
            parts = [_assemble_leaf(name, local[name], srcs, field)
                     for srcs, _ in per_rank]
            if all(p is not None for p in parts):
                flats[field] = torch.cat(parts, dim=dim).narrow(
                    dim, 0, shapes[name][dim]).reshape(-1)
        numel = 1
        for d in shapes[name]:
            numel *= d
        sources.append(({name: (0, numel, 0)}, flats))
    return sources, per_rank[0][1]


def _assemble_leaf(name, shape, sources, field):
    """One parameter's ``field`` from ``sources`` (None when no source
    holds that field)."""
    numel = 1
    for d in shape:
        numel *= d
    full, covered = torch.empty(numel, dtype=torch.float32), 0
    for frags, flats in sources:
        if name not in frags or field not in flats:
            continue
        start, n, within = frags[name]
        full[within:within + n].copy_(flats[field][start:start + n])
        covered += n
    if covered == 0:
        return None
    if covered != numel:
        raise ValueError(f"{name}: the saved {field} pieces cover {covered} "
                         f"of {numel} elements — an incomplete checkpoint?")
    return full.view(shape)


def _read_optim(root, paths, shapes, mmap=True):
    """``(sources, step)`` of the optim files ``paths`` (one stage's, or
    all of a pipeline's in stage order) of parameters of ``shapes``."""
    sources, step, within, stage3 = [], None, {}, None
    for r, path in enumerate(paths):
        sd = load_file(path, mmap)
        osd = sd.get("optimizer_state_dict", sd)
        is3 = "fp32_flat_groups" in osd
        if "param_slice_mappings" not in osd and not is3:
            raise ValueError(f"{os.path.basename(path)} holds neither stage "
                             "≤ 2 (param_slice_mappings) nor stage-3 "
                             "(fp32_flat_groups) content")
        if stage3 is not None and is3 != stage3:
            raise ValueError(f"{root}: optim files of mixed stages")
        stage3 = is3
        if is3:
            groups, states = (osd["fp32_flat_groups"],
                              osd["optimizer_state_dict"]["state"])
            if len(groups) != 1:
                raise ValueError(f"{os.path.basename(path)}: {len(groups)} "
                                 "flat groups (one is read)")
            state = _state_of(states, 0)
            frags, offset, dp = {}, 0, len(paths)
            for name, shape in shapes.items():
                numel = 1
                for d in shape:
                    numel *= d
                pn = -(-numel // dp)
                valid = max(0, min(pn, numel - r * pn))
                if valid:
                    frags[name] = (offset, valid, r * pn)
                offset += pn
            sources.append((frags, _flats(groups[0], state)))
            step = step if step is not None else _step(state)
            continue
        states = osd["base_optimizer_state"]["state"]
        offsets = osd.get("param_slice_offsets") or []
        for gid, mapping in enumerate(osd["param_slice_mappings"]):
            state = _state_of(states, gid)
            placed = offsets[gid] if gid < len(offsets) else {}
            frags = {}
            for name, frag in mapping.items():
                w = within.get(name, 0)
                if name in placed:
                    w = int(placed[name])
                frags[name] = (int(frag.start), int(frag.numel), w)
                within[name] = w + int(frag.numel)
            sources.append((frags, _flats(
                osd["single_partition_of_fp32_groups"][gid], state)))
            step = step if step is not None else _step(state)
    return sources, step


def assemble(shapes, sources, field="fp32"):
    """``{name: full fp32 tensor}`` of one field from every source; raises
    when a parameter's pieces do not cover it."""
    pieces = {}
    for frags, flats in sources:
        if field not in flats:
            continue
        for name, (start, n, within) in frags.items():
            pieces.setdefault(name, []).append((within, start, n,
                                                flats[field]))
    out = collections.OrderedDict()
    for name, shape in shapes.items():
        numel = 1
        for d in shape:
            numel *= d
        full = torch.empty(numel, dtype=torch.float32)
        covered = 0
        for within, start, n, flat in pieces.get(name, ()):
            full[within:within + n].copy_(flat[start:start + n])
            covered += n
        if covered != numel:
            raise ValueError(f"{name}: the saved {field} pieces cover "
                             f"{covered} of {numel} elements — an "
                             "incomplete checkpoint?")
        out[name] = full.view(shape)
    return out


def get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir, tag=None):
    """``{name: fp32 tensor}`` (reference function of the same name)."""
    tag = resolve_tag(checkpoint_dir, tag)
    root = os.path.join(checkpoint_dir, tag) if tag else checkpoint_dir
    if not os.path.isdir(root):
        raise FileNotFoundError(f"no checkpoint found at {root}")
    _, shapes, sources, _ = read_zero_tag(root)
    return assemble(shapes, sources)


def convert_zero_checkpoint_to_fp32_state_dict(checkpoint_dir, output_file,
                                               tag=None):
    """Write the consolidated fp32 state dict to ``output_file`` with
    ``torch.save``; returns the path."""
    sd = get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir, tag=tag)
    torch.save(sd, output_file)
    total = sum(v.numel() for v in sd.values())
    print(f"saved {len(sd)} tensors / {total:,} elements to {output_file}")
    return output_file


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Extract fp32 weights from a ZeRO checkpoint "
        "(reference zero_to_fp32.py)")
    p.add_argument("checkpoint_dir")
    p.add_argument("output_file")
    p.add_argument("-t", "--tag", default=None)
    args = p.parse_args(argv)
    convert_zero_checkpoint_to_fp32_state_dict(args.checkpoint_dir,
                                               args.output_file, tag=args.tag)


if __name__ == "__main__":
    main()
