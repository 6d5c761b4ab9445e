"""ZeRO-3's parameter gather and release, and the bucketed gradient
reduce-scatter of stages 2-3 (the port of
``deepspeed_tpu/runtime/zero/overlap.py``; reference
``runtime/zero/stage3.py`` and ``partitioned_param_coordinator.py``).

The JAX file shapes XLA's schedule: identity markers whose forward emits
each bucket's all-gathers and whose backward emits each bucket's reduces,
fenced so that at most a window of buckets is in flight.  Here the engine
runs eagerly, one unit at a time (``runtime/zero/partition.py``: a block of
the model, the outer unit of every other leaf, the persistent unit):

* each unit has one compute-dtype buffer and its module parameters are
  fixed views into it.  :meth:`ZeroCoordinator.release` sets the buffer's
  storage to size 0; :meth:`ZeroCoordinator.gather` resizes it back and
  all-gathers every rank's slice into it.  A block is gathered by a
  forward pre-hook, released by a forward hook, gathered again by a hook
  on its output's gradient (before its first backward node runs) and, under
  remat, found gathered by the recompute that ``torch.utils.checkpoint``
  runs inside backward.  The outer unit is gathered by the engine's
  ``forward`` and released at the end of ``backward``; the persistent unit
  is never released and takes part in no gather until the step.  The
  gathers write through ``buffer.data``, so autograd's saved views of the
  weights keep their version: what they see after a re-gather is the same
  values;
* the gradients: a post-accumulate-grad hook on every leaf folds its
  gradient, in ``grad_accum_dtype``, into its unit's scratch and frees it;
  once the unit's last leaf is in, the scratch is reduce-scattered (SUM)
  into the unit's slice of the shard accumulator (copied on a step's first
  micro-step, added after) and a block's buffer is released.  The end of
  ``backward`` reduces the units whose leaves got no gradient, as zeros;
* a *held* unit (the pipeline engine holds the units of a stage's tied
  leaves) sums its gradients over the step's micro-steps in its scratch
  and is reduce-scattered only by :meth:`ZeroCoordinator.reduce_held`,
  after the stages have summed the tied leaves (a collective across
  stages inside the 1F1B stream would wait on a stage that is elsewhere
  in it);
* ``overlap_comm`` issues each unit's reduce-scatter asynchronously, with
  at most ``max_inflight`` outstanding (``comm_optimizations.overlap``);
  all are waited on before ``backward`` returns;
* the collectives are the engine's :class:`~.zeropp.ZeroComm`'s: qwZ
  gathers and qgZ reduce-scatters on a quantized wire, hpZ's gathers
  over the ``zp`` group, MiCS's shard and replica groups.  A quantized
  gather keeps its codes alive while the unit is in flight and
  dequantizes into the buffer at the wait; remat's regather in backward
  takes the same path;
* an explicit ``stage3_prefetch_bucket_size`` groups the blocks into
  buckets in forward order (:func:`partition_prefetch_buckets`); when a
  bucket starts, the next ones are all-gathered asynchronously, so that at
  most :func:`live_window` buckets are gathered or in flight.  Backward
  gathers on demand, as the JAX backward marker is the identity.

:func:`_greedy_partition`, :func:`partition_prefetch_buckets`,
:func:`live_window` and :func:`gather_items`' persistence split are the JAX
functions in plain Python (``tests/test_torch_zero.py`` holds them to the
JAX file on the same items).
"""

import contextlib

import numpy as np
import torch

from .partition import BLOCK, OUTER, PERSISTENT

MB = 1 << 20

RELEASED, IN_FLIGHT, GATHERED = "released", "in flight", "gathered"


class GradBucket:
    """One size-bounded group of items, dispatched as a unit: ``indices``
    into the forward-order item list, ``elems`` the element count (the unit
    ``stage3_max_live_parameters`` budgets in)."""

    __slots__ = ("index", "indices", "paths", "nbytes", "elems")

    def __init__(self, index, indices, paths, nbytes, elems=0):
        self.index = index
        self.indices = tuple(indices)
        self.paths = tuple(paths)
        self.nbytes = int(nbytes)
        self.elems = int(elems)

    def __repr__(self):
        return (f"GradBucket({self.index}, leaves={len(self.indices)}, "
                f"{self.nbytes / MB:.2f}MiB)")


def leaf_elems(x):
    return int(np.prod(getattr(x, "shape", ()), dtype=np.int64))


def leaf_nbytes(x):
    itemsize = getattr(getattr(x, "dtype", None), "itemsize", 4)
    return leaf_elems(x) * int(itemsize)


def _greedy_partition(indexed_items, bucket_bytes):
    """``(index, path, leaf)`` triples in dispatch order → buckets: every
    item in exactly one bucket, a bucket closed before an item would take
    it past ``bucket_bytes`` (an item larger than that alone in its own),
    the order kept."""
    bucket_bytes = max(1, int(bucket_bytes))
    buckets = []
    cur_idx, cur_paths, cur_bytes, cur_elems = [], [], 0, 0

    def close():
        nonlocal cur_idx, cur_paths, cur_bytes, cur_elems
        if cur_idx:
            buckets.append(GradBucket(len(buckets), cur_idx, cur_paths,
                                      cur_bytes, cur_elems))
            cur_idx, cur_paths, cur_bytes, cur_elems = [], [], 0, 0

    for i, path, leaf in indexed_items:
        nb = leaf_nbytes(leaf)
        if cur_idx and cur_bytes + nb > bucket_bytes:
            close()
        cur_idx.append(i)
        cur_paths.append(path)
        cur_bytes += nb
        cur_elems += leaf_elems(leaf)
        if cur_bytes >= bucket_bytes:
            close()
    close()
    return buckets


def partition_prefetch_buckets(items, bucket_bytes, skip=()):
    """Forward-order ``(path, leaf)`` items → buckets in forward order; the
    persistent paths in ``skip`` are in no bucket."""
    skip = frozenset(skip)
    return _greedy_partition(
        ((i, path, leaf) for i, (path, leaf) in enumerate(items)
         if path not in skip), bucket_bytes)


def gather_items(items, min_partition_size):
    """``(items, persistent paths)``: a leaf with fewer than
    ``min_partition_size`` elements is persistent (whole on every rank, in
    no gather and no live budget).  The JAX split also keeps whole a leaf
    whose dims do not divide over the ranks; the port pads instead."""
    items = list(items)
    return items, {p for p, x in items if leaf_elems(x) < min_partition_size}


def live_window(buckets, max_live_params, max_inflight=2):
    """The largest ``W ≤ max_inflight`` such that every ``W`` consecutive
    buckets hold at most ``max_live_params`` elements; at least 1, and
    ``max_inflight`` when ``max_live_params`` ≤ 0."""
    w = max(1, int(max_inflight))
    if not buckets or not max_live_params or max_live_params <= 0:
        return w
    elems = [b.elems for b in buckets]
    w = min(w, len(elems))
    while w > 1 and any(sum(elems[k:k + w]) > max_live_params
                        for k in range(len(elems) - w + 1)):
        w -= 1
    return w


def block_modules(module):
    """[(prefix, module)] of every element of the model's block containers
    (the outermost ones), in registration order: an ``nn.ModuleList``, or
    a container that sets ``zero_block_container`` (a pipeline stage's
    ``blocks``, keyed by each block's index in the model)."""
    out = []
    for name, m in module.named_modules():
        if not (isinstance(m, torch.nn.ModuleList) or
                getattr(m, "zero_block_container", False)):
            continue
        if any(name.startswith(p + ".") for p, _ in out):
            continue
        out += [(f"{name}.{k}" if name else k, child)
                for k, child in m.named_children()]
    return out


class Unit:
    """One unit: its kind, block module (None for the outer and persistent
    units), leaves ``[(name, offset in the unit, numel, shape)]`` and
    compute-dtype buffer."""

    def __init__(self, index, kind, module, leaves):
        self.index = index
        self.kind = kind
        self.module = module
        self.leaves = leaves
        self.buffer = None
        self.state = GATHERED
        self.handle = None
        self.scratch = None
        self.arrived = 0
        self.reduced = False


class ZeroCoordinator:
    """The gathers, releases and gradient reduce-scatters of the bucketed
    plans (module docstring).  ``comm``: the engine's ``ZeroComm``.
    ``shard``: stage 3's compute-dtype parameter shard (in the plan's
    ``param_slice`` layout), which the units' buffers gather; None at
    stage 2 with ``overlap_comm``, where only the gradients are bucketed.
    ``primary``: the world slices of the parameters (the persistent unit's
    source; ``shard`` but under hpZ).  ``prefetch``: {bucket_bytes,
    max_inflight, max_live_params}, or None."""

    def __init__(self, plan, units, comm, device, compute_dtype,
                 accum_dtype, shard=None, overlap=False, max_inflight=2,
                 prefetch=None, primary=None):
        self.plan = plan
        self.units = units
        self.comm = comm
        self.device = device
        self.compute_dtype = compute_dtype
        self.accum_dtype = accum_dtype
        self.shard = shard
        self.primary = shard if primary is None else primary
        self.sharded_params = shard is not None
        self.overlap = overlap
        self.max_inflight = max(1, int(max_inflight))
        self.in_backward = False
        self.live_elems = 0          # elements gathered or in flight
        self.peak_live_elems = 0
        self._acc = None
        self._fresh = True
        self._pending = []           # reduce-scatters not yet waited on
        self.buckets, self.window, self._bucket_of = [], 1, {}
        self._issued = set()
        self._hooks = []
        self._grad_hooks = []
        # units whose gradients are summed over the step's micro-steps and
        # reduced only by :meth:`reduce_held` (a pipeline stage's tied
        # leaves, which must first be summed over the stages)
        self.held = set()
        if self.sharded_params:
            for u in units:
                u.buffer = torch.zeros(plan.unit_numel[u.index],
                                       dtype=compute_dtype, device=device)
                self.live_elems += u.buffer.numel()
                self.release(u)
            self.peak_live_elems = self.live_elems
            self._hooks = [h for u in units if u.kind == BLOCK
                           for h in self._hook_block(u)]
            if prefetch is not None:
                self._plan_prefetch(prefetch)

    def detach(self):
        """Remove the module hooks and the parameters' gradient hooks (a
        new layout replaces this one, or the engine goes)."""
        for h in self._hooks + self._grad_hooks:
            h.remove()
        self._hooks, self._grad_hooks = [], []

    def close(self, wait=True):
        """Tear down: every collective in flight waited on (``wait``) and
        dropped, every unit's buffer freed, the hooks removed, so that
        nothing of this coordinator keeps device memory alive.  A
        parameter's gradient hook is held by autograd's C++ side, which
        Python's garbage collector does not see: left in place, it kept
        this coordinator, and with it the stage-3 shard, alive after the
        engine was collected (ROADMAP queue C3)."""
        if wait:
            for entry in self._pending:
                self._finish(entry)
        self._pending = []
        for u in self.units:
            if u.handle is not None and wait:
                u.handle.wait()
            u.handle = None
            if u.buffer is not None:
                u.buffer.untyped_storage().resize_(0)
            u.buffer = u.scratch = None
            u.state = RELEASED
        self.detach()
        self.shard = self.primary = self._acc = None
        self.live_elems = 0

    # ---------------------------------------------------- gather / release
    def _plan_prefetch(self, prefetch):
        blocks = [u for u in self.units if u.kind == BLOCK]
        items = [(str(u.index), torch.empty(self.plan.unit_numel[u.index],
                                            dtype=self.compute_dtype,
                                            device="meta"))
                 for u in blocks]
        self.buckets = partition_prefetch_buckets(items,
                                                  prefetch["bucket_bytes"])
        self.window = live_window(self.buckets, prefetch["max_live_params"],
                                  prefetch["max_inflight"])
        self._bucket_units = [[blocks[i] for i in b.indices]
                              for b in self.buckets]
        self._bucket_of = {u.index: k for k, us in
                           enumerate(self._bucket_units) for u in us}

    def gather(self, unit, async_op=False):
        """All-gather ``unit``'s buffer (a no-op when gathered; waits for
        it when in flight, unless ``async_op``)."""
        if unit.state == GATHERED:
            return
        if unit.state == RELEASED:
            buf = unit.buffer
            buf.untyped_storage().resize_(buf.numel() * buf.element_size())
            lo, hi = self.plan.param_slice(unit.index)
            # buf.data: the write leaves the version of autograd's saved
            # views of the weights as it was (the values are the same)
            unit.handle = self.comm.gather_params(
                buf.data, self.shard[lo:hi], unit.index, async_op=True)
            unit.state = IN_FLIGHT
            self.live_elems += buf.numel()
            self.peak_live_elems = max(self.peak_live_elems,
                                       self.live_elems)
        if not async_op:
            unit.handle.wait()
            unit.handle = None
            unit.state = GATHERED

    def release(self, unit):
        """Free ``unit``'s buffer (the persistent unit stays)."""
        if unit.kind == PERSISTENT or unit.state == RELEASED:
            return
        if unit.state == IN_FLIGHT:
            unit.handle.wait()
            unit.handle = None
        unit.buffer.untyped_storage().resize_(0)
        unit.state = RELEASED
        self.live_elems -= unit.buffer.numel()

    @contextlib.contextmanager
    def allocated(self, unit):
        """Inside the ``with``, ``unit``'s buffer has storage (its values
        are not gathered), so views into it can be made."""
        buf = unit.buffer
        empty = buf.untyped_storage().size() == 0
        if empty:
            buf.untyped_storage().resize_(buf.numel() * buf.element_size())
        try:
            yield buf
        finally:
            if empty:
                buf.untyped_storage().resize_(0)

    def release_all(self):
        """Every unit but the persistent one released
        (``engine.empty_partition_cache``)."""
        for u in self.units:
            self.release(u)

    def start_forward(self):
        """Before the model runs: the outer unit gathered, the prefetch's
        buckets all to be issued again."""
        self._issued.clear()
        self.gather_outer()

    def gather_outer(self):
        for u in self.units:
            if u.kind == OUTER:
                self.gather(u)

    def release_outer(self):
        for u in self.units:
            if u.kind == OUTER:
                self.release(u)

    def refresh_persistent(self):
        """The persistent unit's updated slices, gathered on every rank
        (after the step)."""
        for u in self.units:
            if u.kind == PERSISTENT:
                lo, hi = self.plan.shard_slice(u.index)
                self.comm.gather_shard(u.buffer.data,
                                       self.primary[lo:hi], u=u.index)

    def _prefetch(self, unit):
        k = self._bucket_of.get(unit.index)
        if k is None:
            return
        for j in range(k, min(k + self.window, len(self._bucket_units))):
            if j not in self._issued:
                self._issued.add(j)
                for u in self._bucket_units[j]:
                    self.gather(u, async_op=True)

    def _hook_block(self, unit):
        def pre_forward(module, args):
            if not self.in_backward and self.buckets:
                self._prefetch(unit)
            self.gather(unit)

        def post_forward(module, args, output):
            if self.in_backward:       # remat's recompute inside backward
                return output
            self.release(unit)
            for t in (output if isinstance(output, (tuple, list))
                      else (output, )):
                if isinstance(t, torch.Tensor) and t.requires_grad:
                    # before this block's first backward node runs
                    t.register_hook(lambda g: (self.gather(unit), g)[1])
                    break
            return output

        return (unit.module.register_forward_pre_hook(pre_forward),
                unit.module.register_forward_hook(post_forward))

    # ---------------------------------------------------------- gradients
    def attach(self, named_params):
        """Post-accumulate-grad hooks on the module's (new) parameters;
        ``named_params``: name → parameter."""
        where = {name: (u, off, n) for u in self.units
                 for name, off, n, _ in u.leaves}
        for h in self._grad_hooks:      # the parameters this replaces
            h.remove()
        self._grad_hooks = []
        for name, p in named_params.items():
            u, off, n = where[name]
            self._grad_hooks.append(p.register_post_accumulate_grad_hook(
                lambda p, u=u, off=off, n=n: self._on_grad(u, off, n, p)))

    def start_backward(self, acc, fresh):
        """Before a micro-step's backward: the shard accumulator and whether
        this micro-step starts it."""
        self._acc, self._fresh = acc, fresh
        for u in self.units:
            u.arrived, u.reduced = 0, False
            if fresh or u.index not in self.held:
                u.scratch = None
        self.in_backward = True

    def _scratch(self, unit):
        if unit.scratch is None:
            unit.scratch = torch.zeros(self.plan.unit_numel[unit.index],
                                       dtype=self.accum_dtype,
                                       device=self.device)
        return unit.scratch

    def _on_grad(self, unit, off, n, p):
        if not self.in_backward:
            raise RuntimeError("a ZeRO gradient outside engine.backward()")
        if unit.reduced:
            raise RuntimeError(f"a second gradient for a leaf of unit "
                               f"{unit.index}, already reduced")
        with torch.no_grad():
            view = self._scratch(unit)[off:off + n]
            if unit.index in self.held:
                view.add_(p.grad.reshape(-1))
            else:
                view.copy_(p.grad.reshape(-1))
        p.grad = None
        if unit.index in self.held:
            return
        unit.arrived += 1
        if unit.arrived == len(unit.leaves):
            self._reduce(unit)

    def _reduce(self, unit):
        """Reduce-scatter the unit's scratch into its slice of the
        accumulator; a block's buffer is released."""
        lo, hi = self.plan.shard_slice(unit.index)
        out = self._acc[lo:hi]
        tmp = None if self._fresh else torch.empty_like(out)
        handle = self.comm.reduce_scatter(out if tmp is None else tmp,
                                          self._scratch(unit),
                                          async_op=self.overlap,
                                          u=unit.index)
        self._pending.append((handle, unit.scratch, tmp, out))
        unit.scratch, unit.reduced = None, True
        if self.sharded_params and unit.kind == BLOCK:
            self.release(unit)
        limit = self.max_inflight if self.overlap else 0
        while len(self._pending) > limit:
            self._finish(self._pending.pop(0))

    @staticmethod
    def _finish(entry):
        handle, _, tmp, out = entry
        if hasattr(handle, "wait"):
            handle.wait()
        if tmp is not None:
            out.add_(tmp)

    def finish_backward(self):
        """After autograd: units whose leaves got no gradient (or not all)
        reduced with zeros for what is missing, every reduce-scatter waited
        on, the outer unit released."""
        self.in_backward = False
        for u in self.units:
            if not u.reduced and u.index not in self.held:
                self._reduce(u)
        while self._pending:
            self._finish(self._pending.pop(0))
        self._acc = None
        if self.sharded_params:
            self.release_outer()

    def reduce_held(self, acc, combine):
        """At the step's end: each held unit's gradients, summed over its
        micro-steps, first passed to ``combine(unit, scratch)`` (which may
        change them in place) and then reduce-scattered into its slice of
        the shard accumulator ``acc`` (copied: no micro-step wrote it)."""
        self._acc, self._fresh = acc, True
        for u in self.units:
            if u.index in self.held:
                combine(u, self._scratch(u))
                self._reduce(u)
        while self._pending:
            self._finish(self._pending.pop(0))
        self._acc = None
