"""InfinityEngine: the training engine of ZeRO-Infinity parameter
streaming, ``zero_optimization.offload_param.device`` cpu or nvme at any
stage (the port of ``deepspeed_tpu/runtime/infinity_engine.py``;
reference ZeRO-Infinity, ``runtime/zero/stage3.py`` with
``partitioned_param_swapper.py:37`` and the host Adam).

The model is ``embed → blocks → head`` (its ``streaming_parts()``); every
block's state lives in the :class:`~.zero.infinity.BlockStore` (host or
NVMe), and a step is a Python-level stream of per-block calls:

  forward:   fetch(i+1) on the copy stream ─ x_{i+1} = block(w_i, x_i)
             with no graph; release(w_i)
  head:      loss and its gradients to x_L and the resident leaves in one
             autograd call
  backward:  re-fetch(i) in reverse; each block recomputed from its saved
             input inside ``torch.autograd.grad`` over its leaves and its
             input; its gradients start down to the host stash, and the
             previous block's are waited for (one block deep)
  step:      the host optimizer over every block, the new wire cache
             written in the same pass; the gradients averaged over ``gas``
             and clipped by one multiplier from ``grad_sq_norm``

so the card holds at most the current block, the one being fetched and
the boundary activations (``max_resident_blocks`` ≤ 3); the full model
never exists on the card, its random init included
(:meth:`InfinityEngine.initialize_parameters`).

At world size > 1 the host store is sharded over the data ranks
(``runtime/zero/infinity.py``): each fetch all-gathers a block from the
ranks' slices, each block's gradients are reduce-scattered, the loss is
the global batch's token-counted mean (the model's ``sum_count`` loss over
the all-reduced count, as the base engine takes it), the gradient norm
sums the ranks' slices once, and each rank's host sweep updates its slice.

Checkpoints: at world 1 the JAX package's ``infinity_state.pkl`` (masters
in the flax paths and shapes, moments flat in flax leaf order), so a tag
crosses between the packages; at world > 1 no rank gathers the store: each
writes its slices to ``infinity_rank_{r}.pt`` beside
``infinity_manifest.json`` (the groups' layouts, the world size, the
counters).  Either loads at any world size, and
``checkpoint.convert_to_universal`` converts either; a universal directory
loads into a streaming engine with ``checkpoint.load_universal``.

Under sequence parallelism (JAX's single-process meshes of any shape,
``:25-28``) each rank streams its chunk of the sequence: the model's
``use_ulysses`` blocks run ``DistributedAttention`` over the sp group in
the forward and in the backward's recompute, the rotary tables and
positions start at the chunk's first position, the loss is the global
next-token loss, and the data group the store is sharded over and the
gradients are reduce-scattered over is dp × sp.

Refused loudly, with JAX's messages: fp16, ZeRO++, a model without
``streaming_parts``, an optimizer with no host kernel (LAMB).
"""

import json
import os
import pickle
import sys
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import comm as dist
from ..utils.logging import log_dist
from ..utils.timer import (BACKWARD_GLOBAL_TIMER, FORWARD_GLOBAL_TIMER,
                           STEP_GLOBAL_TIMER)
from .engine import DeepSpeedEngine
from .zero.infinity import BlockStore, views

RESIDENT = "__resident__"
STATE_FILE = "infinity_state.pkl"
SHARD_MANIFEST = "infinity_manifest.json"
SHARD_FILE = "infinity_rank_{}.pt"


def flax_leaves(tree):
    """The leaves of a nested dict in the JAX package's flatten order
    (sorted keys, depth first)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from flax_leaves(v)
        else:
            yield v


def unflatten_like(tree, flat):
    """A flat vector cut into ``tree``'s leaves (flatten order, shapes)."""
    off = 0

    def walk(node):
        nonlocal off
        out = {}
        for k in sorted(node):
            v = node[k]
            if isinstance(v, dict):
                out[k] = walk(v)
            else:
                n = int(np.prod(np.shape(v), dtype=np.int64))
                out[k] = np.asarray(flat[off:off + n],
                                    dtype=np.float32).reshape(np.shape(v))
                off += n
        return out

    return walk(tree)


class _SaveThread:
    """A background write; :meth:`wait` joins it, raises its error, then
    runs ``commit`` (on the caller's thread: it may be a collective)."""

    def __init__(self, fn, commit=None):
        self._err = None
        self._commit = commit
        self._t = threading.Thread(target=self._run, args=(fn, ),
                                   daemon=False)
        self._t.start()

    def _run(self, fn):
        try:
            fn()
        except BaseException as e:   # re-raised in wait()
            self._err = e

    def wait(self):
        self._t.join()
        if self._err is not None:
            raise self._err
        if self._commit is not None:
            self._commit()


class InfinityEngine(DeepSpeedEngine):

    def __init__(self, *args, **kwargs):
        cfg, model = kwargs["config"], kwargs["model"]
        zc = cfg.zero_config
        if cfg.fp16_enabled:
            raise ValueError(
                "ZeRO-Infinity param streaming supports bf16/fp32 only — "
                "fp16 dynamic loss scaling would need a host-side unscale/"
                "overflow pass; use bf16 (reference recommends the same)")
        if zc.zero_quantized_weights or zc.zero_quantized_gradients:
            raise ValueError("ZeRO++ quantization cannot compose with "
                             "param streaming (weights live on host)")
        if getattr(model, "streaming_parts", None) is None:
            raise TypeError(
                "offload_param requires a model exposing streaming_parts() "
                "(see runtime/zero/infinity.StreamingSpec; models/llama.py "
                "implements it) — for monolithic models use "
                "offload_optimizer instead")
        self._spec = model.streaming_parts()
        self._store = None
        self._pending_install = None
        super().__init__(*args, **kwargs)
        sharded = self._data_world > 1
        oo = zc.offload_optimizer
        state_dev = zc.offload_optimizer_device
        self._store = BlockStore(
            param_device=zc.offload_param_device,
            state_device="cpu" if state_dev == "none" else state_dev,
            nvme_path=(zc.offload_param.nvme_path or
                       (oo.nvme_path if oo is not None else None)),
            optimizer=cfg.optimizer_name or "adam",
            opt_params=dict(cfg.optimizer_params or {}),
            wire_dtype=self.compute_dtype,
            grad_accum_fp32=self.gradient_accumulation_steps() > 1,
            device=self.device,
            rank=self._dp_group.rank() if sharded else 0,
            group=self._dp_group if sharded else None)
        self._dev_blocks = {}      # key → {name: device tensor}
        self._pending_fetch = {}   # key → fetch handle (copy in flight)
        self._dev_resident = None
        self._acts = None          # the saved block inputs of a micro-step
        self._fwd_batch = None
        self._head_stash = None    # (resident grads of the head, dL/dx_L)
        self.max_resident_blocks = 0
        self.sweep_seconds = []
        if self._pending_install is not None:
            self._install_host(self._pending_install)
        elif not any(p.is_meta for p in model.parameters()):
            self._install_host(dict(model.named_parameters()))

    def _configure_offload(self, optimizer_device=None):
        # the BlockStore holds all the state; none of the base engine's
        super()._configure_offload("none")

    # --------------------------------------------------------------- install
    def _install_parameters(self, model_parameters=None):
        if self._store is None:        # the base __init__: after the store
            self._pending_install = dict(model_parameters) \
                if model_parameters is not None else None
            return
        self._install_host(dict(model_parameters))

    def _groups(self):
        """(key, leaves, name of a leaf → module name) of each group."""
        spec = self._spec
        yield (RESIDENT, spec.resident_leaves, lambda n: n)
        for key, prefix in zip(spec.block_keys, spec.block_prefixes):
            yield (key, spec.block_leaves, lambda n, p=prefix: p + n)

    def _install_host(self, source):
        """``source``: {module name: tensor} (e.g. fp32 weights)."""
        for key, leaves, full in self._groups():
            missing = [full(n) for n, _ in leaves if full(n) not in source]
            if missing:
                raise KeyError(f"streaming group {key!r}: parameters "
                               f"missing {missing[:4]}")
            self._store.install_group(
                key, leaves, {n: torch.as_tensor(source[full(n)]).float()
                              for n, _ in leaves})
        self._log_installed()

    def _log_installed(self):
        n = sum(self._store.param_bytes(k) for k in self._store.keys())
        log_dist(f"ZeRO-Infinity: {len(self._spec.block_keys)} blocks "
                 f"host-resident ({n / 2**30:.2f}G wire bytes; param_device="
                 f"{self._store.param_device} state_device="
                 f"{self._store.state_device})", ranks=[0])

    def initialize_parameters(self, seed, *sample_inputs, **kw):
        """Random weights (the model's init rule) drawn group by group on
        the host: the full model exists neither on the card nor, beyond
        one block, in fp32 on the host.  Each leaf has its own CPU
        generator, seeded by ``seed`` and its name, so the leaves of a
        group are drawn in parallel threads and the weights do not depend
        on their number."""
        def draw(full, leaf):
            name, shape = leaf
            t = torch.empty(shape, dtype=torch.float32)
            gen = torch.Generator(device="cpu").manual_seed(
                (int(seed) << 32) ^ zlib.crc32(full(name).encode()))
            self._spec.init_leaf(full(name), t, gen)
            return name, t

        with ThreadPoolExecutor(self._store.threads) as pool:
            for key, leaves, full in self._groups():
                # only the leaves this rank's slice holds a piece of
                self._store.add_group(key, leaves)
                mine = self._store.leaves_in_slice(key)
                values = dict(pool.map(lambda leaf: draw(full, leaf),
                                       [lf for lf in leaves
                                        if lf[0] in mine]))
                self._store.install_group(key, leaves, values)
                del values
        self._log_installed()
        return self.module

    def _init_opt_state(self):
        pass     # the store's moments are the optimizer state

    def _check_params(self):
        if self._store is None or not self._store.keys():
            raise RuntimeError(
                "engine has no parameters — pass model_parameters to "
                "initialize() or call engine.initialize_parameters(seed) "
                "first")

    # ----------------------------------------------------------- fetch logic
    def _fetch_async(self, key):
        if key in self._dev_blocks or key in self._pending_fetch:
            return
        self._pending_fetch[key] = self._store.start_fetch(key)
        self._count_resident()

    def _count_resident(self):
        self.max_resident_blocks = max(
            self.max_resident_blocks,
            len(self._dev_blocks) + len(self._pending_fetch))

    def _get_block(self, key):
        if key not in self._dev_blocks:
            h = self._pending_fetch.pop(key, None) or \
                self._store.start_fetch(key)
            self._dev_blocks[key] = self._store.finish_fetch(h)
            self._count_resident()
        return self._dev_blocks[key]

    def _release_block(self, key):
        self._dev_blocks.pop(key, None)

    def _get_resident(self):
        if self._dev_resident is None:
            self._dev_resident = self._store.finish_fetch(
                self._store.start_fetch(RESIDENT))
        return self._dev_resident

    # ------------------------------------------------------------- execution
    def forward(self, *inputs, **kwargs):
        """The model's loss (training: the head's gradients are computed
        here too, in the same autograd call); logits in eval mode without
        labels."""
        self._check_params()
        batch = [self._to_device(x) for x in inputs]
        kwargs = {k: self._to_device(v) for k, v in kwargs.items()}
        spec, keys = self._spec, self._spec.block_keys
        acts = []
        if self.training:
            self.timers(FORWARD_GLOBAL_TIMER).start()
        with torch.no_grad():
            res = self._get_resident()
            x = spec.embed_apply(res, *batch, **kwargs)
            for i, key in enumerate(keys):
                if i + 1 < len(keys):
                    self._fetch_async(keys[i + 1])
                w = self._get_block(key)
                acts.append(x)
                x = spec.block_apply(w, x)
                self._release_block(key)
            if not self.training:
                return spec.head_apply(res, x, *batch, **kwargs)
        # backward starts at the last block: its fetch overlaps the head
        self._fetch_async(keys[-1])
        with torch.enable_grad():
            leaves = {k: v.detach().requires_grad_() for k, v in res.items()}
            xl = x.detach().requires_grad_()
            if self._data_world > 1:
                loss, shown = self._global_head_loss(leaves, xl, batch,
                                                     kwargs)
            else:
                loss = shown = spec.head_apply(leaves, xl, *batch, **kwargs)
            grads = torch.autograd.grad(loss, [xl, *leaves.values()],
                                        allow_unused=True)
        self._head_stash = (grads[1:], grads[0])
        self._acts = acts
        self._fwd_batch = (batch, kwargs)
        self.timers(FORWARD_GLOBAL_TIMER).stop()
        return shown.detach()

    def _global_head_loss(self, leaves, xl, batch, kwargs):
        """(this rank's share of the loss, the global loss): the head's
        masked sum over the all-reduced count, so the gradients summed by
        the reduce-scatters are those of the global batch's mean (the base
        engine's ``_global_batch_loss``)."""
        total, count = self._spec.head_apply(
            leaves, xl, *batch, loss_reduction="sum_count", **kwargs)
        both = torch.stack([total.detach().float(), count.detach().float()])
        dist.all_reduce(both, group=self._dp_group)
        denom = torch.clamp(both[1], min=1.0)
        return total.float() / denom, both[0] / denom

    __call__ = forward

    def backward(self, loss=None, **kwargs):
        if self._head_stash is None:
            raise RuntimeError("backward() called without a prior forward() "
                               "in training mode")
        self.timers(BACKWARD_GLOBAL_TIMER).start()
        spec, keys = self._spec, self._spec.block_keys
        dres, dx = self._head_stash
        acts, (batch, kw) = self._acts, self._fwd_batch
        self._head_stash = self._acts = self._fwd_batch = None
        pending = None     # the previous block's gradients on their way
        for i in range(len(keys) - 1, -1, -1):
            if i:
                self._fetch_async(keys[i - 1])
            w = self._get_block(keys[i])
            with torch.enable_grad():
                wl = {k: v.detach().requires_grad_() for k, v in w.items()}
                xin = acts[i].requires_grad_()
                y = spec.block_apply(wl, xin)
                grads = torch.autograd.grad(y, [xin, *wl.values()],
                                            grad_outputs=dx,
                                            allow_unused=True)
            dx = grads[0]
            acts[i] = None
            self._release_block(keys[i])
            started = self._store.start_grads(keys[i], list(grads[1:]))
            if pending is not None:
                self._store.finish_grads(pending)
            pending = started
            del grads, wl, y
        self._store.finish_grads(pending)
        res = self._get_resident()
        with torch.enable_grad():
            leaves = {k: v.detach().requires_grad_() for k, v in res.items()}
            x0 = spec.embed_apply(leaves, *batch, **kw)
            demb = torch.autograd.grad(x0, list(leaves.values()),
                                       grad_outputs=dx, allow_unused=True)
        total = [a if b is None else b if a is None else a + b
                 for a, b in zip(dres, demb)]
        self._store.accumulate_grads(RESIDENT, total)
        if not self.is_gradient_accumulation_boundary():
            # the next micro-step starts at block 0 (a boundary invalidates
            # every fetch)
            self._fetch_async(keys[0])
        self._acc_fresh = False
        self.timers(BACKWARD_GLOBAL_TIMER).stop()
        return loss

    def step(self, use_kernel=True):
        """At the boundary: one host optimizer sweep.  The streamed loss
        carries no 1/gas factor, so the stash holds the sum over the
        window: it is averaged here, and clipped, by one multiplier."""
        self._check_params()
        self.timers(STEP_GLOBAL_TIMER).start()
        if self.is_gradient_accumulation_boundary():
            if self._acc_fresh:
                raise RuntimeError("step() at a grad-accum boundary without "
                                   "any backward() since the last boundary")
            gas = self.gradient_accumulation_steps()
            scale = 1.0
            clip = self._config.gradient_clipping
            gn = None
            if clip and clip > 0:
                gn = float(np.sqrt(self._store.grad_sq_norm())) / gas
                if gn > clip:
                    scale = clip / gn
            lr = self.get_lr()[0]
            if self.device.type == "cuda":
                # no copy may still read the cache the sweep rewrites
                torch.cuda.synchronize(self.device)
            t0 = time.perf_counter()
            self._store.optimizer_sweep(
                lr=lr, grad_scale=scale / gas if (gas > 1 or scale != 1.0)
                else None)
            self.sweep_seconds.append(time.perf_counter() - t0)
            # the host cache changed: every device copy is stale
            self._dev_resident = None
            self._dev_blocks.clear()
            self._pending_fetch.clear()
            self._last_gnorm = gn
            self._acc_fresh = True
            self.global_steps += 1
            self.global_samples += self.train_batch_size()
            if self.lr_scheduler is not None and hasattr(self.lr_scheduler,
                                                         "step"):
                self.lr_scheduler.step()
                self._scheduler_reclaims_lr()
        self.micro_steps += 1
        self.timers(STEP_GLOBAL_TIMER).stop()

    # ------------------------------------------------------------ state APIs
    def hbm_param_bytes(self):
        """Wire bytes of block parameters now on the card (the contract:
        the working set, not the model)."""
        return sum(self._store.param_bytes(k) for k in
                   (*self._dev_blocks, *self._pending_fetch))

    def _whole(self, key, part):
        """A group's whole padded flat vector (CPU) from this rank's slice
        ``part``: an all-gather over the ranks at world > 1."""
        if self._store.world == 1:
            return part
        t = part.to(self.device)
        out = torch.empty(self._store.numel(key), dtype=t.dtype,
                          device=self.device)
        dist.allgather_fn(out, t, group=self._dp_group)
        return out.cpu()

    def _masters(self):
        """{module name: fp32 tensor} of every leaf, from the store (a
        collective at world > 1)."""
        flats = {k: self._whole(k, v)
                 for k, v in self._store.export_master().items()}
        out = {}
        for key, leaves, full in self._groups():
            for name, t in views(flats[key], self._store.layout(key)).items():
                out[full(name)] = t
        return out

    def get_fp32_param(self, name=None):
        """The fp32 master of leaf ``name`` (a module name), or of every
        leaf ({name: tensor}) when None."""
        masters = self._masters()
        return masters if name is None else masters[name]

    def module_state_dict(self, dst=None):
        """{module name: compute-dtype tensor} in the module's order, from
        the host master (JAX ``_export_16bit_tree``)."""
        self._check_params()
        masters = self._masters()
        return {n: masters[n].to(self.compute_dtype)
                for n, _ in self.module.named_parameters() if n in masters}

    # ------------------------------------------------------- checkpoints
    def _flax_module(self):
        pymod = sys.modules.get(type(self.module).__module__)
        if getattr(pymod, "params_to_flax", None) is None:
            raise TypeError(f"{type(self.module).__name__}'s module has no "
                            "params_to_flax: infinity_state.pkl is written "
                            "in the JAX package's layout")
        return pymod

    def _to_flax(self, key, flat):
        """A group's flat vector (port layout) → its flax tree."""
        pymod, cfg = self._flax_module(), self.module.config
        full = dict((k, f) for k, _, f in self._groups())[key]
        named = {full(n): t for n, t in
                 views(flat, self._store.layout(key)).items()}
        tree = pymod.params_to_flax(named, cfg)
        return tree if key == RESIDENT else tree[key]

    def _from_flax(self, trees):
        """{key: flax tree} of every group → {key: fp32 flat} in the
        port's layout."""
        full_tree = dict(trees.get(RESIDENT, {}))
        full_tree.update({k: v for k, v in trees.items() if k != RESIDENT})
        named = self._flax_module().params_from_flax(
            full_tree, self.module.config, dtype="float32")
        out = {}
        for key, leaves, full in self._groups():
            flat = torch.zeros(self._store.numel(key), dtype=torch.float32)
            for name, o, k, _ in self._store.layout(key):
                flat[o:o + k].copy_(named[full(name)].reshape(-1))
            out[key] = flat
        return out

    def _counters(self, client_state):
        return {
            "global_steps": self.global_steps,
            "global_samples": self.global_samples,
            "micro_steps": self.micro_steps,
            "lr_scheduler": (self.lr_scheduler.state_dict()
                             if self.lr_scheduler is not None and
                             hasattr(self.lr_scheduler, "state_dict")
                             else None),
            "client_state": client_state or {},
        }

    def save_checkpoint(self, save_dir, tag=None, client_state=None,
                        save_latest=True, exclude_frozen_parameters=False,
                        async_save=False):
        """A tag of the store (module docstring), then ``latest``: at world
        1 ``{save_dir}/{tag}/infinity_state.pkl`` in the JAX package's
        layout, at world > 1 each rank's slices and rank 0's manifest.  The
        snapshot is taken before returning; ``async_save`` writes it in a
        thread (:meth:`wait_for_checkpoint` commits it).  Every rank calls
        it."""
        self._check_params()
        self.wait_for_checkpoint()
        tag = str(tag or f"global_step{self.global_steps}")
        root = os.path.join(save_dir, tag)
        os.makedirs(root, exist_ok=True)
        if self._store.world == 1:
            path = os.path.join(root, STATE_FILE)
            state = dict(self._flax_state(), **self._counters(client_state))

            def write():
                with open(path, "wb") as f:
                    pickle.dump(state, f, protocol=pickle.HIGHEST_PROTOCOL)
        else:
            path = root
            write = self._shard_writer(root, client_state)
        latest = (os.path.join(save_dir, "latest") if save_latest else None)
        commit = self._commit(latest, tag)
        if self._store.world == 1:
            # no collective in the commit: the thread makes it, as JAX's
            def write(written=write, commit=commit):
                written()
                commit()
            commit = None
        self._pending_ckpt = _SaveThread(write, commit)
        if not async_save:
            self.wait_for_checkpoint()
        return path

    def _commit(self, latest, tag):
        """What makes a written tag the resume target: every rank's files
        are written (a barrier at world > 1), then rank 0 writes
        ``latest``."""
        def commit():
            if self._store.world > 1:
                dist.barrier(group=self._dp_group)
            if latest is not None and self._dp_group.rank() == 0:
                with open(latest, "w") as f:
                    f.write(tag)
        return commit

    def _flax_state(self):
        """The ``master`` and ``opt`` of ``infinity_state.pkl``: every
        group in the flax layout, the moments flat in flax leaf order."""
        opt = self._store.export_state()
        masters = self._store.export_master()
        kinds = {}
        for key, ks in opt["kinds"].items():
            kinds[key] = {k: np.concatenate([
                np.ravel(a) for a in flax_leaves(self._to_flax(key, v))])
                for k, v in ks.items()}
        return {"master": {k: self._to_flax(k, v) for k, v in
                           masters.items()},
                "opt": {"step_count": opt["step_count"], "kinds": kinds}}

    def _shard_writer(self, root, client_state):
        """World > 1: this rank's slices (and rank 0's manifest), copied
        now, written by the returned function."""
        from .checkpoint_engine import module_record
        store = self._store
        opt = store.export_state()
        mine = {"master": store.export_master(), "kinds": opt["kinds"],
                "rank": store.rank}
        manifest = None
        if store.rank == 0:
            manifest = dict(
                self._counters(client_state), world=store.world,
                optimizer=store.optimizer, step_count=opt["step_count"],
                module=module_record(self.module),
                groups={key: {"padded": store.numel(key),
                              "leaves": [[full(n), o, k, list(shape)]
                                         for n, o, k, shape in
                                         store.layout(key)]}
                        for key, _, full in self._groups()})

        def write():
            torch.save(mine, os.path.join(root,
                                          SHARD_FILE.format(store.rank)))
            if manifest is not None:
                with open(os.path.join(root, SHARD_MANIFEST), "w") as f:
                    json.dump(manifest, f, indent=1)
        return write

    def wait_for_checkpoint(self):
        pending = getattr(self, "_pending_ckpt", None)
        if pending is not None:
            self._pending_ckpt = None
            pending.wait()

    def load_checkpoint(self, load_dir, tag=None,
                        load_optimizer_states=True,
                        load_lr_scheduler_states=True, **kw):
        """Load a streamed tag written at any world size (or, with
        ``checkpoint.load_universal``, a universal directory); returns
        ``(path, client_state)``.  Every rank calls it."""
        self.wait_for_checkpoint()
        if self._config.load_universal_checkpoint:
            from ..checkpoint.universal_checkpoint import \
                load_universal_checkpoint
            return load_universal_checkpoint(
                self, load_dir, tag=tag,
                load_optimizer_states=load_optimizer_states,
                load_lr_scheduler_states=load_lr_scheduler_states)
        if tag is None:
            with open(os.path.join(load_dir, "latest")) as f:
                tag = f.read().strip()
        root = os.path.join(load_dir, str(tag))
        for key, leaves, _ in self._groups():
            if key not in self._store.keys():
                self._store.add_group(key, leaves)
        if os.path.exists(os.path.join(root, STATE_FILE)):
            path = os.path.join(root, STATE_FILE)
            with open(path, "rb") as f:
                state = pickle.load(f)
            masters, opt = self._from_pkl(state, path)
        else:
            path = root
            state, masters, opt = self._from_shards(root)
        self.install_state(masters, opt if load_optimizer_states else None)
        self.restore_counters(state, load_lr_scheduler_states)
        return path, state.get("client_state", {})

    def install_state(self, masters, opt=None):
        """{key: this rank's fp32 master slice} and, unless None, ``{
        "step_count", "kinds": {key: {kind: slice}}}`` into the store (the
        groups laid out first when the engine holds none yet)."""
        for key, leaves, _ in self._groups():
            if not self._store.installed(key):
                self._store.install_zeros(key, leaves)
        self._store.import_master(masters)
        if opt is not None:
            self._store.import_state(opt)

    def restore_counters(self, state, load_lr_scheduler_states=True):
        self.global_steps = state.get("global_steps", self.global_steps)
        self.global_samples = state.get("global_samples",
                                        self.global_samples)
        self.micro_steps = state.get("micro_steps", self.micro_steps)
        if load_lr_scheduler_states and \
                state.get("lr_scheduler") is not None and \
                self.lr_scheduler is not None and \
                hasattr(self.lr_scheduler, "load_state_dict"):
            self.lr_scheduler.load_state_dict(state["lr_scheduler"])
        self._dev_resident = None
        self._dev_blocks.clear()
        self._pending_fetch.clear()
        self._acc_fresh = True

    def _from_pkl(self, state, path):
        """A world-1 ``infinity_state.pkl`` (flax layout) → this rank's
        master slices and optimizer state."""
        expect = {k for k, _, _ in self._groups()}
        if set(state["master"]) != expect:
            raise KeyError(f"{path}: groups {sorted(state['master'])[:4]}, "
                           f"the model's {sorted(expect)[:4]}")
        take = self._store.take_slice
        masters = {k: take(k, v).clone() for k, v in
                   self._from_flax(state["master"]).items()}
        opt = state["opt"]
        per_kind = {}
        for key, ks in opt["kinds"].items():
            for k, flat in ks.items():
                per_kind.setdefault(k, {})[key] = unflatten_like(
                    state["master"][key], np.asarray(flat))
        kinds = {}
        for k, trees in per_kind.items():
            for key, flat in self._from_flax(trees).items():
                kinds.setdefault(key, {})[k] = take(key, flat).clone()
        return masters, {"step_count": opt["step_count"], "kinds": kinds}

    def _from_shards(self, root):
        """A world > 1 tag → (manifest, this rank's master slices, its
        optimizer state): each slice filled from the old ranks' files that
        overlap it."""
        with open(os.path.join(root, SHARD_MANIFEST)) as f:
            man = json.load(f)
        store = self._store
        for key, _, full in self._groups():
            want = [[full(n), o, k, list(shape)]
                    for n, o, k, shape in store.layout(key)]
            got = man["groups"].get(key)
            if got is None or got["leaves"] != want:
                raise KeyError(f"{root}: group {key!r} is not the model's")
        masters, kinds = {}, {}
        for q in range(man["world"]):
            part = torch.load(os.path.join(root, SHARD_FILE.format(q)),
                              map_location="cpu", mmap=True,
                              weights_only=True)
            for key, _, _ in self._groups():
                s0 = man["groups"][key]["padded"] // man["world"]
                bufs = [(masters, None, part["master"][key])] + [
                    (kinds.setdefault(key, {}), k, v)
                    for k, v in part["kinds"][key].items()]
                lo, hi = store.slice_range(key)
                a, b = max(lo, q * s0), min(hi, (q + 1) * s0)
                for dst, kind, src in bufs:
                    slot = key if kind is None else kind
                    if slot not in dst:
                        dst[slot] = torch.zeros(hi - lo, dtype=torch.float32)
                    if a < b:
                        dst[slot][a - lo:b - lo].copy_(
                            src[a - q * s0:b - q * s0])
        return man, masters, {"step_count": man["step_count"],
                              "kinds": kinds}
