"""Checkpoint save and load for the port's engine (the port of
``deepspeed_tpu/runtime/checkpoint_engine.py``).

The JAX engine writes orbax trees of global arrays.  The port keeps the JAX
package's directory protocol (manifest, ``latest``, retries, rollback,
retention, async commit) and writes its tensors in upstream torch
DeepSpeed's per-rank file scheme, which ``deepspeed_tpu/checkpoint/
torch_migration.py`` already reads:

    {save_dir}/latest                 tag name (written after the manifest)
    {save_dir}/zero_to_fp32.py        the standalone recovery script
    {save_dir}/{tag}/engine_state.json   the JAX keys (counters, loss scale,
                                         lr scheduler, client state)
    {save_dir}/{tag}/manifest.json       size + CRC32 of every file, config
                                         hash (the JAX format)
    {save_dir}/{tag}/mp_rank_00_model_states.pt     rank 0: {"module": the
        whole state in the compute dtype (a stage-3 model gathered unit by
        unit), "param_shapes": [{name: shape}]}
    {save_dir}/{tag}/zero_pp_rank_{r}_mp_rank_00_optim_states.pt   one a
        partition (rank 0's alone below stage 1): {"optimizer_state_dict":
        {"param_slice_mappings": [{name: fragment_address(numel, start)}],
         "single_partition_of_fp32_groups": [the fp32 shard],
         "base_optimizer_state": {"state": [{"exp_avg", "exp_avg_sq",
                                            "step"}]}}}

The fp32 group is the master (the fp32 parameters when there is none);
Lion and momentum SGD write ``exp_avg`` only; LAMB's scratch and chunk
table, the ranks' sum hook and a client's ``lr_override`` are never written:
a load copies into the live state's buffers, so they stay (the JAX
``_strip_lr_override``/``_reattach_lr_override``, ``:255-270``).  Every
stage writes the stage ≤ 2 content (``ZeroPartitionPlan.fragment_map``), and
a load at any world size and stage fills its shard from the overlapping
pieces (``ZeroPartitionPlan.fill_shard``): the elastic resume JAX gets from
orbax's global arrays (``:13-15``).  Upstream stage-3 tags
(``fp32_flat_groups``) load through the same fill.

A 1-bit optimizer (``runtime/fp16/onebit/``) writes its moments as
``exp_avg``/``exp_avg_sq`` (JAX's ``mu``/``nu``), and every rank writes
what is its own, JAX's other ``OnebitState`` fields, to
``onebit_rank_{r}_states.pt``: ``{"world", "worker_error",
"server_error", "extra"}`` (the count is the optim file's step).  A load at the same world size restores them;
at another one the error buffers restart at zero (their sizes depend on
the world) and the extras are rank 0's.

Under a pipeline of more than one stage (``runtime/pipe/engine.py``) every
stage writes what it owns, and a leaf tied across stages is written once,
by the first stage holding it:

    {save_dir}/{tag}/mp_rank_{s:02d}_model_states.pt   the first data rank
        of stage s: {"module": None, "param_shapes": [its leaves],
        "layers": {layer file: the layer's prefix in the names}, the
        counters, "mp_world_size": pp}
    {save_dir}/{tag}/layer_{idx:02d}-model_states.pt   one a layer (idx its
        index in the ``PipelineModule``; a tied key's layer is its first
        occurrence): {name within the layer: compute-dtype tensor}
    {save_dir}/{tag}/zero_pp_rank_{d}_mp_rank_{s:02d}_optim_states.pt
        the content above, one a partition d of stage s's data group

These are upstream DeepSpeed's pipeline names (``PipelineModule.
ckpt_layer_path`` without a tensor-parallel rank; upstream's mp rank of a
pipeline is the stage's rank in its model group, the stage here).  The
leaves keep their names whatever the split (``blocks.{j}`` is block j of
the model), so a tag loads at another pp, dp, sp or stage, and into the
base engine on ``PipelineModule.to_module()``, by
``ZeroPartitionPlan.fill_shard`` over every stage's pieces; the commit
waits for every rank of every stage.  ``engine_state.json`` holds the
pipeline's geometry (``runtime/pipe/module.py:geometry``), from which the
universal converter writes the JAX engine's names.  Under sequence
parallelism the partitions are over the data group dp × sp, named by the
rank in it.

Under tensor parallelism (tp > 1; upstream's model-parallel names) every
tp rank t writes its own files, its pieces in its slices' coordinates:

    {save_dir}/{tag}/mp_rank_{t:02d}_model_states.pt   the first data rank
        of tp rank t: {"module": the whole module (tp rank 0; None on the
        others), "param_shapes": the whole shapes, "tp_world_size",
        "tp_rank", "tp_splits": {name: the dim its slices split}}
    {save_dir}/{tag}/zero_pp_rank_{d}_mp_rank_{t:02d}_optim_states.pt
        partition d of tp rank t's data group

``zero_to_fp32.read_zero_tag`` joins the slices, so a tp tag loads at any
tp, dp and stage (a tp engine cuts the whole leaves to its slices,
:func:`localize_sources`), into the base engine, and converts to the
universal layout as a tp-1 tag does.

With MiCS (``mics_shard_size``) the state is sharded within a shard group
and replicated across the groups: the first group's ranks alone write
their partitions, named by their rank in the group, so a tag holds one
partition a shard and loads at any world size and stage.  hpZ keeps the
master on the world's slices and writes as stage 3 does; its secondary
copy of the parameters is derived from the master and is not written.

A save stages every tensor on the host before it returns; a thread writes
the files (each retried), and the commit (manifest, then ``latest``, then
retention) waits until every rank's files are written.  With
``async_save`` the commit is :meth:`_AsyncSaveHandle.wait`.
"""

import json
import os
import shutil
import threading
import time
import zlib
from collections import OrderedDict

import torch

from ..checkpoint import zero_to_fp32
from ..checkpoint.zero_to_fp32 import (MODEL_FILE, fragment_address,
                                       layer_file, model_file, optim_file,
                                       read_zero_tag)
from ..utils.fault_injection import fault_point
from ..utils.logging import log_dist, logger
from ..utils.not_ported import not_ported
from ..utils.tensor_fragment import pickled_as_upstream
from .loss_scaler import LossScaleState

MANIFEST_NAME = "manifest.json"
MANIFEST_VERSION = 1
ENGINE_STATE = "engine_state.json"
# the JAX engine's data and curriculum keys (``collect_data_state``, :381)
DATA_STATE_KEYS = ("data_sampler", "curriculum_scheduler")


# --------------------------------------------------------------- integrity
def _retry(fn, attempts, backoff, what):
    """Retry ``fn`` on transient failures with exponential backoff
    (reference Nebula engine retries commit the same way).  ``attempts`` is
    the number of RE-tries; 0 = fail on the first error."""
    for i in range(attempts + 1):
        try:
            return fn()
        except (OSError, IOError) as e:
            if i >= attempts:
                raise
            delay = backoff * (2 ** i)
            logger.warning("checkpoint %s failed (%s: %s); retry %d/%d "
                           "in %.2fs", what, type(e).__name__, e, i + 1,
                           attempts, delay)
            if delay > 0:
                time.sleep(delay)


def _file_crc32(path, chunk=1 << 22):
    crc = 0
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                return crc & 0xFFFFFFFF
            crc = zlib.crc32(b, crc)


def _walk_tag_files(root):
    """Relative paths of every file in a tag dir, manifest excluded."""
    out = []
    for dirpath, _, files in os.walk(root):
        for name in files:
            rel = os.path.relpath(os.path.join(dirpath, name), root)
            if rel != MANIFEST_NAME and not rel.endswith(".tmp"):
                out.append(rel)
    return sorted(out)


def write_manifest(root, config_hash=None, tag=None):
    """Commit the tag's integrity manifest — file list + sizes + content
    checksums + config hash — written to a temp file and atomically
    renamed, AFTER every file write finished: its presence certifies the
    tag is complete, its checksums certify the bytes."""
    files = {}
    for rel in _walk_tag_files(root):
        path = os.path.join(root, rel)
        files[rel] = {"size": os.path.getsize(path),
                      "crc32": _file_crc32(path)}
    manifest = {"version": MANIFEST_VERSION, "tag": str(tag),
                "config_hash": config_hash, "files": files}
    tmp = os.path.join(root, f"{MANIFEST_NAME}.{os.getpid()}.tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=2)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(root, MANIFEST_NAME))
    return manifest


def verify_checkpoint_tag(root):
    """Verify a tag dir against its manifest.

    Returns ``(status, detail)`` with status one of ``"valid"`` (manifest
    present, every file matches size+checksum), ``"legacy"`` (no manifest —
    a pre-integrity checkpoint OR a partial write that died before commit;
    indistinguishable, so callers prefer any verified tag over it), or
    ``"corrupt"`` (manifest present but unreadable / files missing or
    mismatched)."""
    if not os.path.isdir(root):
        return "corrupt", "tag directory missing"
    mpath = os.path.join(root, MANIFEST_NAME)
    if not os.path.exists(mpath):
        return "legacy", "no manifest (pre-integrity save or partial write)"
    try:
        with open(mpath) as f:
            manifest = json.load(f)
        files = manifest["files"]
    except (ValueError, KeyError, OSError) as e:
        return "corrupt", f"unreadable manifest: {e}"
    for rel, meta in files.items():
        path = os.path.join(root, rel)
        try:
            if not os.path.exists(path):
                return "corrupt", f"missing file {rel}"
            size = os.path.getsize(path)
            if size != meta["size"]:
                return "corrupt", (f"size mismatch {rel}: "
                                   f"{size} != {meta['size']}")
            if _file_crc32(path) != meta["crc32"]:
                return "corrupt", f"checksum mismatch {rel}"
        except OSError as e:
            return "corrupt", f"unreadable file {rel}: {e}"
    return "valid", "ok"


def _tag_sort_key(load_dir, tag):
    """Newest-first ordering: the step counter recorded in the tag's own
    engine_state.json (mtime breaks ties / stands in when unreadable)."""
    root = os.path.join(load_dir, tag)
    step = -1
    try:
        with open(os.path.join(root, ENGINE_STATE)) as f:
            step = int(json.load(f).get("global_steps", -1))
    except (OSError, ValueError, TypeError):
        pass
    try:
        mtime = os.path.getmtime(root)
    except OSError:
        mtime = 0.0
    return (step, mtime)


def list_checkpoint_tags(load_dir):
    """Tag subdirs (anything holding an engine_state.json or a manifest),
    newest first."""
    try:
        names = os.listdir(load_dir)
    except OSError:
        return []
    tags = [n for n in names
            if os.path.isdir(os.path.join(load_dir, n)) and
            (os.path.exists(os.path.join(load_dir, n, ENGINE_STATE))
             or os.path.exists(os.path.join(load_dir, n, MANIFEST_NAME)))]
    return sorted(tags, key=lambda t: _tag_sort_key(load_dir, t),
                  reverse=True)


def find_latest_valid_tag(load_dir, exclude=(), not_newer_than=None):
    """Newest tag that passes manifest verification; falls back to the
    newest legacy (manifest-less) tag only when NO verified tag exists.
    ``not_newer_than``: a tag name — candidates newer than it (step counter,
    mtime tiebreak) are skipped, so a fallback can only roll BACK."""
    ceiling = (_tag_sort_key(load_dir, not_newer_than)
               if not_newer_than is not None else None)

    def newer_than_ceiling(key):
        if ceiling is None:
            return False
        if ceiling[0] < 0:
            # the reference tag's step counter is unreadable (often WHY we
            # are falling back): compare by mtime alone
            return key[1] > ceiling[1]
        return key > ceiling

    legacy = None
    for tag in list_checkpoint_tags(load_dir):
        if tag in exclude:
            continue
        if newer_than_ceiling(_tag_sort_key(load_dir, tag)):
            continue
        status, _ = verify_checkpoint_tag(os.path.join(load_dir, tag))
        if status == "valid":
            return tag, "valid"
        if status == "legacy" and legacy is None:
            legacy = tag
    return (legacy, "legacy") if legacy is not None else (None, None)


def _tag_committed(root):
    """Cheap committed-ness check for retention: a readable manifest (full
    verification is the loader's job)."""
    try:
        with open(os.path.join(root, MANIFEST_NAME)) as f:
            json.load(f)
        return True
    except (OSError, ValueError):
        return False


def prune_checkpoint_tags(save_dir, keep_n, protect=None):
    """Bounded retention: delete *committed* tags (manifest present)
    beyond the newest ``keep_n``.  Uncommitted/corrupt tags are never
    deleted; the newest committed tag — plus ``protect``, the tag just
    written — always survives."""
    if not keep_n or keep_n < 1:
        return []
    try:
        committed = [t for t in list_checkpoint_tags(save_dir)
                     if _tag_committed(os.path.join(save_dir, t))]
        doomed = [t for t in committed[keep_n:] if t != protect]
    except OSError as e:   # retention must never fail a committed save
        logger.warning("checkpoint retention: scan failed (%s); skipped", e)
        return []
    removed = []
    for tag in doomed:
        try:
            shutil.rmtree(os.path.join(save_dir, tag))
            removed.append(tag)
        except OSError as e:
            logger.warning("checkpoint retention: could not remove %s (%s)",
                           tag, e)
    if removed:
        log_dist(f"checkpoint retention: pruned {removed} "
                 f"(keep_n={keep_n})", ranks=[0])
    return removed


def _write_latest(latest_path, tag):
    tmp = f"{latest_path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write(str(tag))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, latest_path)


# ------------------------------------------------------------------- save
class _FileWriter:
    """Writes a tag's staged files on a thread, each inside the retry loop
    with the ``ckpt.save_tree`` and ``ckpt.mid_write`` fault points (the
    JAX package's orbax checkpointer role: ``wait_until_finished`` and
    ``close``)."""

    def __init__(self, root, tag, jobs, retries, backoff):
        self.root, self.tag, self.jobs = root, tag, jobs
        self.retries, self.backoff = retries, backoff
        self.error = None
        self.bytes = {}
        self.seconds = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"ckpt-{tag}")
        self._thread.start()

    def _run(self):
        t0 = time.perf_counter()
        try:
            for name, obj in self.jobs:
                path = os.path.join(self.root, name)

                def once():
                    fault_point("ckpt.save_tree", tag=self.tag, sub=name)
                    with pickled_as_upstream():
                        torch.save(obj, path)

                _retry(once, self.retries, self.backoff,
                       f"write of {self.tag}/{name}")
                self.bytes[name] = os.path.getsize(path)
                fault_point("ckpt.mid_write", tag=self.tag, root=self.root,
                            sub=name)
        except Exception as e:  # noqa: BLE001 — raised by wait
            self.error = e
        finally:
            self.jobs = None       # the host copies go with the writes
            self.seconds = time.perf_counter() - t0

    def wait_until_finished(self):
        self._thread.join()
        if self.error is not None:
            raise self.error

    def close(self):
        pass


class _AsyncSaveHandle:
    """Pending checkpoint: ``wait()`` commits manifest + ``latest`` only
    after every file is durably written — on every rank: ``agree`` (a MIN
    over the ranks, or None at one rank) tells each whether all wrote —
    and re-raises any background-write exception; a failed save is never
    treated as durable."""

    def __init__(self, checkpointers, latest_path=None, tag=None,
                 root=None, config_hash=None, integrity=False,
                 keep_n=0, save_dir=None, retries=0, backoff=0.0,
                 agree=None):
        self._ckptrs = checkpointers
        self._latest_path = latest_path
        self._tag = tag
        self._root = root
        self._config_hash = config_hash
        self._integrity = integrity
        self._keep_n = keep_n
        self._save_dir = save_dir
        self._retries = retries
        self._backoff = backoff
        self._agree = agree or (lambda ok: ok)
        self._done = False
        self.stage_seconds = None     # host copies, set by the save
        self.wait_seconds = None

    def wait(self):
        if self._done:
            return
        t0 = time.perf_counter()
        try:
            errors = []
            for c in self._ckptrs:
                try:
                    c.wait_until_finished()
                except Exception as e:  # noqa: BLE001 — surfaced below
                    errors.append(e)
                finally:
                    c.close()
            if not self._agree(not errors) or errors:
                # neither manifest nor `latest` is written: the previous
                # valid tag stays the resume target
                logger.error(
                    "checkpoint %s FAILED in its write (%s); tag not "
                    "committed — the previous valid tag remains the resume "
                    "target", self._tag, errors[0] if errors else
                    "on another rank")
                if errors:
                    raise errors[0]
                raise RuntimeError(f"checkpoint {self._tag}: another rank's "
                                   "write failed; tag not committed")
            error = None
            try:
                if self._integrity and self._root is not None:
                    _retry(lambda: write_manifest(
                        self._root, self._config_hash, self._tag),
                        self._retries, self._backoff, "manifest commit")
                if self._latest_path is not None:
                    _retry(lambda: _write_latest(self._latest_path,
                                                 self._tag),
                           self._retries, self._backoff, "latest commit")
            except Exception as e:  # noqa: BLE001 — every rank learns it
                error = e
            # every rank returns only once the commit is durable
            if not self._agree(error is None):
                if error is not None:
                    raise error
                raise RuntimeError(f"checkpoint {self._tag}: the commit "
                                   "failed on another rank")
            fault_point("ckpt.committed", tag=self._tag, root=self._root)
            if self._integrity and self._save_dir is not None:
                prune_checkpoint_tags(self._save_dir, self._keep_n,
                                      protect=str(self._tag))
        finally:
            self._done = True  # a failed commit must not wedge retries
            self.wait_seconds = time.perf_counter() - t0

    @property
    def done(self):
        return self._done

    def stats(self):
        """This rank's seconds staging the host copies, writing its files
        (the writer's thread), committing after them (:meth:`wait`: the
        wait for the writes, the manifest's CRC pass, ``latest``), and
        ``{file: bytes}`` it wrote."""
        out = {}
        for c in self._ckptrs:
            out.update(getattr(c, "bytes", {}))
        return dict(stage_s=self.stage_seconds,
                    write_s=sum(getattr(c, "seconds", 0) or 0
                                for c in self._ckptrs),
                    commit_s=self.wait_seconds, bytes=out)


def _host(t):
    """A host copy of ``t`` that owns its storage (a view of a larger
    buffer would otherwise save the whole buffer)."""
    return t.detach().to("cpu", copy=True)


def module_record(module):
    """{module, config_class, config} naming the module's model config when
    its Python module has ``params_to_flax`` (what the universal converter
    needs to write JAX names and shapes), else None."""
    import dataclasses
    import sys
    pymod = sys.modules.get(type(module).__module__)
    cfg = getattr(module, "config", None)
    if getattr(pymod, "params_to_flax", None) is None or \
            not dataclasses.is_dataclass(cfg):
        return None
    return {"module": pymod.__name__, "config_class": type(cfg).__name__,
            "config": dataclasses.asdict(cfg)}


def engine_state(engine, client_state=None):
    """The ``engine_state.json`` of a save: the JAX keys (``:437-450``),
    the loss scaler's counters beside its scale, and the model's record."""
    ss = engine.scale_state
    state = {
        "global_steps": engine.global_steps,
        "global_samples": engine.global_samples,
        "micro_steps": engine.micro_steps,
        "skipped_steps": engine.skipped_steps,
        "loss_scale": float(ss.scale),
        "loss_scale_state": {"growth_tracker": ss.growth_tracker,
                             "hysteresis": ss.hysteresis},
        "zero_stage": engine.zero_stage,
        "dp_world_size": engine.dp_world_size,
        "client_state": client_state or {},
    }
    pipe = getattr(engine.module, "pipe", None)
    if pipe is not None:
        # what the universal converter needs to write JAX's names
        from .pipe.module import geometry
        state["pipeline"] = dict(geometry(pipe),
                                 num_stages=engine.pp_world_size)
    if engine.lr_scheduler is not None and hasattr(engine.lr_scheduler,
                                                   "state_dict"):
        state["lr_scheduler"] = engine.lr_scheduler.state_dict()
    record = module_record(engine.module)
    if record is not None:
        state["module"] = record
    return state


def optim_state_dict(engine):
    """This rank's optim file content (module docstring), on the host."""
    plan, opt = engine.zero_plan, engine.opt_state
    state = {"step": torch.tensor(opt.count)}
    for key in ("exp_avg", "exp_avg_sq"):
        t = getattr(opt, key, None)
        if t is not None:
            state[key] = _host(t)
    frags = plan.fragment_map(engine._layout,
                              dense=plan.sharded or engine._data_rank == 0)
    skip = engine._tied_copies()
    mapping = OrderedDict(
        (name, fragment_address(numel=k, start=off))
        for name, (k, off, _) in frags.items() if name not in skip)
    osd = {
        "zero_stage": engine.zero_stage,
        "partition_count": plan.world_size if plan.sharded else 1,
        "param_slice_mappings": [mapping],
        "single_partition_of_fp32_groups": [_host(engine._target())],
        "base_optimizer_state": {"state": [state]},
    }
    if plan.experts_split:
        # where each expert piece lies in the whole stack: the files' rank
        # order is not the stacks' order at ep > 1 (zero_to_fp32.py)
        osd["param_slice_offsets"] = [OrderedDict(
            (name, within) for name, (_, _, within) in frags.items()
            if name in plan.leaf_base)]
    return {"optimizer_state_dict": osd}


ONEBIT_FILE = "onebit_rank_{}_states.pt"


def onebit_state_dict(engine):
    """This rank's own 1-bit optimizer state (module docstring)."""
    st = engine.opt_state
    return {"world": st.world,
            "worker_error": _host(st.worker_error),
            "server_error": _host(st.server_error),
            "extra": {k: _host(v) for k, v in st.extra.items()}}


def restore_onebit(engine, root):
    """The 1-bit state of this rank's file (rank 0's extras at another
    world size, the error buffers then left at zero)."""
    st = engine.opt_state
    path = os.path.join(root, ONEBIT_FILE.format(engine.dp_rank))
    same = os.path.exists(path)
    if not same:
        path = os.path.join(root, ONEBIT_FILE.format(0))
        if not os.path.exists(path):
            logger.warning(f"{root} holds no 1-bit optimizer state: the "
                           "error buffers and extras start afresh")
            return
    sd = torch.load(path, map_location="cpu", weights_only=False)
    with torch.no_grad():
        for k, v in sd["extra"].items():
            if k in st.extra and st.extra[k].shape == v.shape:
                st.extra[k].copy_(v)
        if same and sd["world"] == st.world:
            st.worker_error.copy_(sd["worker_error"])
            st.server_error.copy_(sd["server_error"])
        else:
            st.worker_error.zero_()
            st.server_error.zero_()
            logger.warning(f"1-bit error buffers of world {sd['world']} "
                           f"at world {st.world}: they restart at zero")


def _writes_partition(engine):
    """(whether this rank writes an optim file, the partition's index):
    every partition of a sharded plan, rank 0 alone below stage 1; MiCS's
    first shard group alone."""
    plan = engine.zero_plan
    if plan.mics:
        replicas = engine._zcomm.replica_group
        first = replicas is None or replicas.rank() == 0
        return first, engine._shard_group.rank()
    if plan.experts_split and not plan.sharded:
        # one rank of each expert-data group: its experts' stacks
        return plan.expert_rank == 0, engine.dp_rank
    rank = engine._data_rank
    return plan.sharded or rank == 0, rank


def _model_jobs(engine, module):
    """The files of the model's weights, written by the first rank of a
    data group: the module state (one stage), or under a pipeline of more
    stages this stage's ``mp_rank_{s}`` file and one layer file a layer
    it writes (module docstring)."""
    cfg = engine._config
    skip = engine._tied_copies()
    states = {
        "param_shapes": [OrderedDict((n, torch.Size(s)) for n, *_, s in
                                     engine.global_layout()[0]
                                     if n not in skip)],
        "global_steps": engine.global_steps,
        "global_samples": engine.global_samples,
        "skipped_steps": engine.skipped_steps,
        "dp_world_size": engine.dp_world_size,
        "mp_world_size": engine.pp_world_size,
        "ds_config": dict(cfg._param_dict),
    }
    if engine.tp_world_size > 1:
        t = engine.tp_rank
        return [(model_file(t), dict(
            states, module=module if t == 0 else None,
            tp_world_size=engine.tp_world_size, tp_rank=t,
            tp_splits={n: d for n, (d, _, _) in engine._tp_splits.items()}))]
    if engine.pp_world_size == 1:
        return [(MODEL_FILE, dict(states, module=module))]
    from .pipe.module import geometry
    index = geometry(engine.pipe_module)["layers"]
    layers = OrderedDict()
    for name, t in module.items():
        if name in skip:
            continue
        region, key, rest = name.split(".", 2)
        prefix = f"{region}.{key}"
        layers.setdefault(prefix, OrderedDict())[rest] = t
    files = OrderedDict((layer_file(index[p]), p) for p in layers)
    jobs = [(name, layers[p]) for name, p in files.items()]
    jobs.append((model_file(engine.stage_id),
                 dict(states, module=None, layers=files)))
    return jobs


def save_engine_checkpoint(engine, save_dir, tag=None, client_state=None,
                           save_latest=True, async_save=False):
    """Stage and write a tag (module docstring); returns the
    :class:`_AsyncSaveHandle` with ``async_save``, else True once the tag
    is committed.  Every rank calls it."""
    t0 = time.perf_counter()
    if tag is None:
        tag = f"global_step{engine.global_steps}"
    save_dir = os.path.abspath(save_dir)
    root = os.path.join(save_dir, str(tag))
    rank, cfg = engine._data_rank, engine._config
    first = rank == 0 and engine.stage_id == 0 and engine.tp_rank == 0
    ic = cfg.checkpoint_integrity
    commits = first or cfg.use_node_local_storage
    os.makedirs(root, exist_ok=True)
    if first:
        with open(os.path.join(root, ENGINE_STATE), "w") as f:
            json.dump(engine_state(engine, client_state), f, indent=2)
    # a collective at stage 3 and at tp > 1
    module = engine.module_state_dict(dst=0)
    jobs = _model_jobs(engine, module) if rank == 0 else []
    writes, part = _writes_partition(engine)
    if writes:
        jobs.append((optim_file(part, engine.stage_id or engine.tp_rank),
                     optim_state_dict(engine)))
    if engine._onebit:
        jobs.append((ONEBIT_FILE.format(rank), onebit_state_dict(engine)))
    writer = _FileWriter(root, tag, jobs, ic.save_retries, ic.retry_backoff)
    handle = _AsyncSaveHandle(
        [writer], latest_path=(os.path.join(save_dir, "latest")
                               if save_latest and commits else None),
        tag=tag, root=root, config_hash=cfg.config_hash(),
        integrity=ic.enabled and commits, keep_n=ic.keep_n,
        save_dir=save_dir, retries=ic.save_retries,
        backoff=ic.retry_backoff,
        agree=(engine._all_ranks_agree
               if engine._data_world * engine.pp_world_size *
               engine.tp_world_size > 1 else None))
    handle.stage_seconds = time.perf_counter() - t0
    engine.last_checkpoint = handle
    if first:
        # the recovery script beside the tags (reference engine.py:3540)
        shutil.copy2(zero_to_fp32.__file__,
                     os.path.join(save_dir, "zero_to_fp32.py"))
    if async_save:
        log_dist(f"async checkpoint staged {root}", ranks=[0])
        return handle
    handle.wait()
    log_dist(f"saved checkpoint {root}", ranks=[0])
    return True


# ------------------------------------------------------------------- load
def _resolve_load_tag(engine, load_dir, tag):
    """Resolve + verify the tag to load.  A corrupt or partial tag (failed
    manifest verification) logs LOUDLY and falls back to the newest valid
    tag instead of loading garbage.  Returns the tag or None."""
    requested = tag
    integrity = engine._config.checkpoint_integrity.enabled
    if tag is None:
        latest = os.path.join(load_dir, "latest")
        if os.path.exists(latest):
            with open(latest) as f:
                tag = f.read().strip() or None
        if tag is None:
            # `save_latest=False` snapshots stay invisible to auto-resume,
            # but say what IS recoverable
            hint, status = (find_latest_valid_tag(load_dir) if integrity
                            else (None, None))
            logger.warning(
                f"no 'latest' file at {load_dir}; nothing loaded"
                + (f" (a {status} tag '{hint}' exists — pass "
                   f"tag={hint!r} to resume from it)"
                   if hint is not None else ""))
            return None

    if not integrity:
        if not os.path.isdir(os.path.join(load_dir, str(tag))):
            logger.warning(f"checkpoint dir {load_dir}/{tag} missing; "
                           "nothing loaded")
            return None
        return tag

    # an EXPLICITLY requested tag may only fall back to an OLDER tag: naming
    # a tag is often a deliberate rollback away from a newer state
    ceiling = str(tag) if requested is not None else None

    status, detail = verify_checkpoint_tag(os.path.join(load_dir, str(tag)))
    if status == "valid":
        return tag
    if status == "legacy":
        fallback, fstatus = find_latest_valid_tag(load_dir,
                                                  exclude=(str(tag),),
                                                  not_newer_than=ceiling)
        if fstatus == "valid":
            logger.error(
                f"CHECKPOINT INTEGRITY: tag '{tag}' at {load_dir} has no "
                f"manifest ({detail}) — treating as partial; falling back "
                f"to newest verified tag '{fallback}'")
            return fallback
        if os.path.isdir(os.path.join(load_dir, str(tag))):
            logger.warning(
                f"checkpoint tag '{tag}' has no integrity manifest "
                f"({detail}); loading best-effort (legacy layout)")
            return tag
        logger.warning(f"checkpoint dir {load_dir}/{tag} missing; "
                       "nothing loaded")
        return None
    logger.error(
        f"CHECKPOINT INTEGRITY: tag '{tag}' at {load_dir} FAILED "
        f"verification ({detail}); refusing to load it")
    fallback, fstatus = find_latest_valid_tag(load_dir, exclude=(str(tag),),
                                              not_newer_than=ceiling)
    if fallback is None:
        logger.error(f"no other usable tag under {load_dir}; nothing loaded"
                     + ("" if requested is None else
                        f" (requested tag was '{requested}')"))
        return None
    logger.error(f"RECOVERY: falling back to newest {fstatus} tag "
                 f"'{fallback}' (checkpoint rollback: {load_dir}/{tag})")
    return fallback


def _state_of_upstream_tag(model_sd):
    """engine_state of an upstream DeepSpeed tag (no engine_state.json):
    its model states' counters."""
    state = {k: model_sd.get(k, 0) for k in ("global_steps",
                                             "global_samples",
                                             "skipped_steps")}
    lr = model_sd.get("lr_scheduler")
    if isinstance(lr, dict) and "last_batch_iteration" in lr:
        state["lr_scheduler"] = lr
    return state


def read_tag(root):
    """``(engine_state, model states, sources, step)`` of a tag of the port
    or of upstream DeepSpeed (``zero_to_fp32.read_zero_tag``); an upstream
    tag's counters stand in for its missing engine_state.json.  A JAX
    (orbax) tag, or data state the port cannot restore, raises."""
    if not os.path.exists(os.path.join(root, MODEL_FILE)) and \
            os.path.isdir(os.path.join(root, "model")):
        raise ValueError(
            f"{root} is a JAX-package (orbax) tag: convert it with "
            "deepspeed_tpu.checkpoint.convert_to_universal and load the "
            "result with checkpoint.load_universal")
    model_sd, _, sources, step = read_zero_tag(root)
    path = os.path.join(root, ENGINE_STATE)
    if os.path.exists(path):
        with open(path) as f:
            state = json.load(f)
    else:
        state = _state_of_upstream_tag(model_sd)
    data = [k for k in DATA_STATE_KEYS if k in state]
    if data:
        raise not_ported(f"restoring {', '.join(data)} from a checkpoint "
                         "(the dataloader)", 4)
    return state, model_sd, sources, step


def restore_state(engine, state, step, sources, module=None,
                  load_optimizer_states=True, load_lr_scheduler_states=True,
                  load_module_only=False, load_module_strict=True,
                  custom_load_fn=None):
    """Fill the engine from a checkpoint read at any world size and stage:
    ``sources`` (``fill_shard``'s) give the fp32 master and the moments,
    ``module`` ({name: tensor}, or None) the compute-dtype parameters
    (else they are the master's cast), ``step`` the optimizer's count,
    ``state`` the counters, loss scale and lr scheduler."""
    if engine.params is None:
        engine._install_parameters()
    if engine.opt_state is None:
        engine._init_opt_state()
    if module is not None:
        module = _checked_module(engine, module, load_module_strict)
    if engine._tp_splits:
        sources = localize_sources(engine, sources)
    with torch.no_grad():
        if load_module_only:
            if module is None:
                raise ValueError("load_module_only: the tag holds no module "
                                 "weights")
            engine._load_module(module, custom_load_fn)
            engine._master_from_params()
        else:
            opt = engine.opt_state
            targets = {"fp32": engine._target()}
            if load_optimizer_states:
                for key in ("exp_avg", "exp_avg_sq"):
                    targets[key] = getattr(opt, key, None)
            for t in targets.values():
                if t is not None:
                    t.zero_()
            engine.zero_plan.fill_shard(engine._layout, sources, targets)
            if load_optimizer_states and step is not None:
                opt.count = int(step)
            if module is not None:
                engine._load_module(module, custom_load_fn)
            else:
                engine._params_from_master()
    if not load_module_only and load_lr_scheduler_states and \
            engine.lr_scheduler is not None and "lr_scheduler" in state \
            and hasattr(engine.lr_scheduler, "load_state_dict"):
        engine.lr_scheduler.load_state_dict(state["lr_scheduler"])
    restore_counters(engine, state)


def localize_sources(engine, sources):
    """``sources`` of whole parameters (any tag, any tp) → the same with
    each of the engine's tp-sharded leaves cut to this rank's slice (one
    source a leaf, in the slice's coordinates), which ``fill_shard`` reads
    against the engine's layout."""
    from ..checkpoint.zero_to_fp32 import FIELDS, _assemble_leaf
    splits = engine._tp_splits
    out = []
    for frags, flats in sources:
        keep = {n: f for n, f in frags.items() if n not in splits}
        if keep:
            out.append((keep, flats))
    for name in splits:
        whole = engine._tp_whole_shape(name)
        flats = {}
        for field in FIELDS:
            t = _assemble_leaf(name, whole, sources, field)
            if t is not None:
                flats[field] = engine._local_value(name, t).reshape(-1)
        if flats:
            n = next(iter(flats.values())).numel()
            out.append(({name: (0, n, 0)}, flats))
    return out


def restore_counters(engine, state):
    """Counters and the loss scale (``:713-722``); the scaler's tracker and
    hysteresis too when the tag holds them (a JAX tag holds the scale
    only)."""
    for key in ("global_steps", "global_samples", "micro_steps",
                "skipped_steps"):
        if key in state:
            setattr(engine, key, int(state[key]))
    if "micro_steps" not in state and "global_steps" in state:
        engine.micro_steps = engine.global_steps * \
            engine.gradient_accumulation_steps()
    if "loss_scale" in state:
        fresh = engine.loss_scaler.init()
        extra = state.get("loss_scale_state") or {}
        engine.scale_state = LossScaleState(
            scale=float(state["loss_scale"]),
            growth_tracker=int(extra.get("growth_tracker",
                                         fresh.growth_tracker)),
            hysteresis=int(extra.get("hysteresis", fresh.hysteresis)))
    engine._acc_fresh = True
    engine._pending_loss = None


def _checked_module(engine, module, strict):
    """The module weights the layout names, ``strict``: no name missing or
    unknown; else the missing keep their values."""
    names = {n for n, *_ in engine._layout}
    real = {n: t for n, t in module.items()
            if isinstance(t, torch.Tensor) and t.numel() > 0}
    if not real:
        return None     # upstream stage 3 writes placeholders
    missing = sorted(names - set(real))
    # a pipeline stage holds some of the model's leaves
    unknown = [] if engine.pp_world_size > 1 else sorted(set(real) - names)
    if strict and (missing or unknown):
        raise KeyError(f"checkpoint module: missing {missing[:4]}, unknown "
                       f"{unknown[:4]} (load_module_strict=False loads the "
                       "rest)")
    return {n: t for n, t in real.items() if n in names}


def _agree_on_tag(engine, tag):
    """Rank 0's resolved tag on every rank (each rank resolves its own with
    node-local storage): over the stages, then over each data group."""
    if engine._data_world * engine.pp_world_size * \
            engine.tp_world_size == 1 or \
            engine._config.use_node_local_storage:
        return tag
    from .. import comm as dist
    buf = torch.zeros(1024, dtype=torch.uint8, device=engine.device)
    if engine._data_rank == 0 and engine.stage_id == 0 and \
            engine.tp_rank == 0 and tag is not None:
        raw = str(tag).encode()
        if len(raw) > buf.numel() - 1:
            raise ValueError(f"tag name of {len(raw)} bytes")
        buf[0] = 1
        buf[1:1 + len(raw)] = torch.tensor(list(raw), dtype=torch.uint8)
    if engine.pp_world_size > 1:
        dist.broadcast(buf, src=0, group=engine._pp_group.as_flat())
    if engine.tp_world_size > 1:
        dist.broadcast(buf, src=0, group=engine._tp_group)
    if engine._data_world > 1:
        dist.broadcast(buf, src=0, group=engine._dp_group)
    host = buf.cpu()
    if not int(host[0]):
        return None
    return bytes(host[1:].tolist()).rstrip(b"\0").decode()


def load_engine_checkpoint(engine, load_dir, tag=None,
                           load_optimizer_states=True,
                           load_lr_scheduler_states=True,
                           load_module_only=False, load_module_strict=True,
                           custom_load_fn=None):
    """Resolve, verify and load a tag of the port or of upstream DeepSpeed
    into ``engine`` at its world size and stage; returns ``(tag dir,
    client_state)``, or ``(None, {})`` when nothing was loaded."""
    load_dir = os.path.abspath(load_dir)
    tag = None if (engine._data_rank or engine.stage_id or
                   engine.tp_rank) and not \
        engine._config.use_node_local_storage else \
        _resolve_load_tag(engine, load_dir, tag)
    tag = _agree_on_tag(engine, tag)
    if tag is None:
        return None, {}
    root = os.path.join(load_dir, str(tag))
    if not os.path.isdir(root):
        logger.warning(f"checkpoint dir {root} missing; nothing loaded")
        return None, {}
    state, model_sd, sources, step = read_tag(root)
    mpath = os.path.join(root, MANIFEST_NAME)
    if os.path.exists(mpath):
        try:
            with open(mpath) as f:
                saved_hash = json.load(f).get("config_hash")
        except (OSError, ValueError):
            saved_hash = None
        if saved_hash and saved_hash != engine._config.config_hash():
            logger.warning(
                f"checkpoint {root} was saved under a different config "
                f"(hash {saved_hash} != {engine._config.config_hash()}); "
                "resuming anyway — expected after an elastic rescale, "
                "suspicious otherwise")
    restore_state(engine, state, step, sources,
                  module=model_sd.get("module"),
                  load_optimizer_states=load_optimizer_states,
                  load_lr_scheduler_states=load_lr_scheduler_states,
                  load_module_only=load_module_only,
                  load_module_strict=load_module_strict,
                  custom_load_fn=custom_load_fn)
    if engine._onebit and load_optimizer_states and not load_module_only:
        restore_onebit(engine, root)
    log_dist(f"loaded checkpoint {root}", ranks=[0])
    return root, state.get("client_state", {})
