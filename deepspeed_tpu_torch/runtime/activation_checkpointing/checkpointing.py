"""Activation checkpointing (the port of ``deepspeed_tpu/runtime/
activation_checkpointing/checkpointing.py``; reference ``runtime/
activation_checkpointing/checkpointing.py``).

The JAX package maps every knob onto a ``jax.checkpoint`` policy.  Here
a segment runs under non-reentrant ``torch.utils.checkpoint`` and the
policy table (JAX ``:40``) maps to torch:

* ``nothing_saveable`` (and ``"none"``, JAX's ``policy=None``): a plain
  checkpoint, the segment's inputs saved and the rest recomputed;
* ``dots_saveable`` / ``checkpoint_dots``: a selective checkpoint
  (``create_selective_checkpoint_contexts``) that keeps the outputs of
  the matrix products (``aten.mm``, ``addmm``, ``bmm`` and kernel B1's
  forward, one dispatcher op, ``ops/kernels/flash_attention.py:
  flash_forward_op``) and recomputes everything else;
* ``dots_with_no_batch_dims_saveable`` (and its alias
  ``checkpoint_dots_with_no_batch_dims``): the same without ``bmm``;
* ``everything_saveable``: no checkpoint.

The configured flags (``configure``, from the ``activation_checkpointing``
block):

* ``contiguous_memory_optimization``: ``dots_with_no_batch_dims_saveable``
  (JAX ``:70-73``);
* ``cpu_checkpointing``: what the segment saves goes to pinned host memory
  and comes back at the recompute (saved-tensor hooks, as
  ``torch.autograd.graph.save_on_cpu(pin_memory=True)``); on the card a
  tensor that cannot be pinned raises.  JAX offloads the dots
  (``offload_dot_with_no_batch_dims``) and recomputes the rest; a
  selective checkpoint keeps its saved outputs outside the saved-tensor
  hooks, so here the segment saves its inputs only (``nothing_saveable``)
  and those go to the host;
* ``partition_activations``: each tp rank keeps its 1/tp slice of what the
  segment saves, along the largest dimension tp divides (JAX's
  ``shard_spec`` rule, ``runtime/zero/partition.py:52``), all-gathered over
  the tp group at the recompute.  At tp = 1 it is the identity; the sp
  ranks already hold different chunks, so only tp partitions.

The RNG tracker holds a ``torch.Generator`` seed for each name; ``fork``
yields a generator derived from the name's seed and use count (JAX folds
the count into a key).
"""

import contextlib
import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import CheckpointPolicy as _Save
from torch.utils.checkpoint import (checkpoint as _torch_checkpoint,
                                    create_selective_checkpoint_contexts)

# policy name → the ops whose outputs the segment keeps: None recomputes
# everything, "all" keeps everything (no checkpoint)
_DOTS = ("mm", "addmm", "bmm", "flash")
_POLICIES = {
    "none": None,
    "nothing_saveable": None,
    "everything_saveable": "all",
    "dots_saveable": _DOTS,
    "checkpoint_dots": _DOTS,
    "dots_with_no_batch_dims_saveable": ("mm", "addmm", "flash"),
    "checkpoint_dots_with_no_batch_dims": ("mm", "addmm", "flash"),
}


def _ops(kinds):
    from ...ops.kernels.flash_attention import flash_forward_op  # noqa: F401
    aten = torch.ops.aten
    table = {"mm": aten.mm.default, "addmm": aten.addmm.default,
             "bmm": aten.bmm.default,
             "flash": torch.ops.deepspeed_tpu_torch.flash_attention_fwd.default}
    return frozenset(table[k] for k in kinds)


def policy_ops(name):
    """The saved-op set of a policy name (None: recompute everything,
    "all": no checkpoint); an unknown name raises ``ValueError``."""
    if name not in _POLICIES:
        raise ValueError(f"unknown remat policy {name!r} (have: "
                         f"{', '.join(_POLICIES)})")
    kinds = _POLICIES[name]
    return kinds if kinds in (None, "all") else _ops(kinds)


def remat(function, policy_name="nothing_saveable"):
    """``function`` wrapped to run as a checkpointed segment under the named
    policy (the models' per-block remat): call it with the segment's
    arguments."""
    saved = policy_ops(policy_name)
    if saved == "all":
        return function
    kw = dict(use_reentrant=False)
    if saved is not None:
        def keep(ctx, op, *args, **kwargs):
            return _Save.MUST_SAVE if op in saved else _Save.PREFER_RECOMPUTE
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, keep)
    return functools.partial(_torch_checkpoint, function, **kw)


@dataclass
class CheckpointPolicy:
    """Resolved activation-checkpointing behavior (from the
    ``activation_checkpointing`` config block)."""
    partition_activations: bool = False
    cpu_checkpointing: bool = False
    contiguous_memory_optimization: bool = False
    number_checkpoints: Optional[int] = None
    policy_name: str = "nothing_saveable"

    def name(self):
        """The policy-table name this configuration runs (module
        docstring)."""
        if self.cpu_checkpointing:
            return "nothing_saveable"
        if self.contiguous_memory_optimization:
            return "dots_with_no_batch_dims_saveable"
        return self.policy_name


_config: Optional[CheckpointPolicy] = None


def configure(mpu_=None, deepspeed_config=None, partition_activations=None,
              contiguous_checkpointing=None, num_checkpoints=None,
              checkpoint_in_cpu=None, synchronize=None, profile=None):
    """Reference ``checkpointing.configure()``: a DeepSpeedConfig's
    ``activation_checkpointing`` block or explicit flags."""
    global _config
    cfg = CheckpointPolicy()
    if deepspeed_config is not None:
        ac = getattr(deepspeed_config, "activation_checkpointing_config",
                     None)
        if ac is not None:
            cfg.partition_activations = ac.partition_activations
            cfg.cpu_checkpointing = ac.cpu_checkpointing
            cfg.contiguous_memory_optimization = \
                ac.contiguous_memory_optimization
            cfg.number_checkpoints = ac.number_checkpoints
    if partition_activations is not None:
        cfg.partition_activations = partition_activations
    if contiguous_checkpointing is not None:
        cfg.contiguous_memory_optimization = contiguous_checkpointing
    if num_checkpoints is not None:
        cfg.number_checkpoints = num_checkpoints
    if checkpoint_in_cpu is not None:
        cfg.cpu_checkpointing = checkpoint_in_cpu
    _config = cfg
    return cfg


def is_configured():
    return _config is not None


def reset():
    global _config
    _config = None


def get_policy():
    return _config or CheckpointPolicy()


def _split_dim(shape, n):
    """The largest dim of ``shape`` that ``n`` divides (ties: the first),
    or None."""
    for i, d in sorted(enumerate(shape), key=lambda t: -t[1]):
        if d % n == 0:
            return i
    return None


def _pinned_copy(t):
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    if not host.is_pinned():
        raise RuntimeError("cpu_checkpointing: a saved activation could not "
                           "be pinned")
    host.copy_(t)
    return host


class _SavedActivations(torch.autograd.graph.saved_tensors_hooks):
    """Saved-tensor hooks of ``partition_activations`` (``tp_group`` of
    more than one rank: keep this rank's slice, all-gather at unpack) and
    ``cpu_checkpointing`` (``to_host``: keep it in pinned host memory on a
    card, in place on the CPU)."""

    def __init__(self, tp_group, to_host):
        n = tp_group.size() if tp_group is not None else 1
        r = tp_group.rank() if n > 1 else 0

        def pack(t):
            dim = _split_dim(t.shape, n) if n > 1 and t.dim() else None
            if dim is not None:
                w = t.shape[dim] // n
                # a copy: a view would keep the whole tensor alive
                t = t.narrow(dim, r * w, w).clone(
                    memory_format=torch.contiguous_format)
            device = t.device
            if to_host and t.is_cuda:
                t = _pinned_copy(t)
            return t, device, dim

        def unpack(packed):
            t, device, dim = packed
            t = t.to(device, non_blocking=True)
            if dim is not None:
                from ... import comm
                t = comm.all_gather(t, group=tp_group.as_flat(), axis=dim)
            return t

        super().__init__(pack, unpack)


def _hooks(cfg):
    if not (cfg.partition_activations or cfg.cpu_checkpointing):
        return contextlib.nullcontext()
    group = None
    if cfg.partition_activations:
        from ...utils import groups
        if groups.mesh_is_initialized():
            group = groups._get_tensor_parallel_group()
    return _SavedActivations(group, cfg.cpu_checkpointing)


def checkpoint(function, *args, policy=None, prevent_cse=True, **kwargs):
    """Megatron-compatible ``checkpoint(fn, *args)`` (reference ``:948``):
    the segment's activations are recomputed in the backward, under
    ``policy`` (a :class:`CheckpointPolicy` or a policy name) or the
    configured one.  ``prevent_cse`` is JAX's and has no effect here."""
    cfg = get_policy()
    name = (policy.name() if isinstance(policy, CheckpointPolicy)
            else policy if policy is not None else cfg.name())
    with _hooks(cfg):
        return remat(function, name)(*args, **kwargs)


def non_reentrant_checkpoint(function, *args, **kwargs):
    """Reference non-reentrant variant (``:704``): every checkpoint here is
    non-reentrant."""
    return checkpoint(function, *args, **kwargs)


def checkpoint_wrapper(function, policy=None):
    """``function`` as a checkpointed callable."""
    return functools.partial(checkpoint, function, policy=policy)


# --------------------------------------------------------------------- RNG
def _derive(seed, count):
    return int(np.random.SeedSequence([seed, count]).generate_state(
        1, np.uint64)[0] >> 1)


class RNGStatesTracker:
    """Named random streams (reference ``CudaRNGStatesTracker`` ``:124``):
    a seed a name; ``fork`` yields a ``torch.Generator`` seeded from the
    name's seed and use count, so the recompute of a segment that forks in
    order replays its draws."""

    def __init__(self):
        self._seeds = {}
        self._use_count = {}

    def reset(self):
        self._seeds.clear()
        self._use_count.clear()

    def get_states(self):
        return {n: (s, self._use_count[n]) for n, s in self._seeds.items()}

    def set_states(self, states):
        self._seeds = {n: s for n, (s, _) in states.items()}
        self._use_count = {n: c for n, (_, c) in states.items()}

    def add(self, name, seed):
        if name in self._seeds:
            raise Exception(f"rng state {name} already exists")
        self._seeds[name] = int(seed)
        self._use_count[name] = 0

    @contextlib.contextmanager
    def fork(self, name="model-parallel-rng", device="cpu"):
        if name not in self._seeds:
            raise Exception(f"rng state {name} not added")
        self._use_count[name] += 1
        gen = torch.Generator(device=device)
        gen.manual_seed(_derive(self._seeds[name], self._use_count[name]))
        yield gen


_RNG_TRACKER = RNGStatesTracker()


def get_rng_tracker():
    return _RNG_TRACKER


def model_parallel_rng_seed(seed):
    """Reference ``model_parallel_cuda_manual_seed`` (``:201``): the
    default stream shares ``seed`` across tp ranks; the model-parallel
    stream adds 2718 + the tp rank, so dropout differs per shard."""
    from ...utils import groups
    tp_rank = (groups._get_tensor_parallel_rank()
               if groups.mesh_is_initialized() else 0)
    _RNG_TRACKER.reset()
    _RNG_TRACKER.add("default", seed)
    _RNG_TRACKER.add("model-parallel-rng", seed + 2718 + tp_rank)
    return _RNG_TRACKER
