"""ZeRO-Infinity parameter streaming: parameters and optimizer state on the
host (or NVMe), fed to the card one transformer block at a time (the port
of ``deepspeed_tpu/runtime/zero/infinity.py``; reference
``runtime/swap_tensor/partitioned_param_swapper.py:37`` and
``csrc/adam/cpu_adam_impl.cpp``).

The model shows itself as ``embed → L blocks of one structure → head``
(:class:`StreamingSpec`, from a model's ``streaming_parts()``); the engine
(``runtime/infinity_engine.py``) runs the blocks one by one while
:class:`BlockStore` keeps every block's state off the card, ONE flat vector
per (block, kind) in the port's leaf order (the block module's
``named_parameters``), each leaf 16-element aligned:

* the fp32 master and the moments in plain host memory, or in files under
  ``nvme_path`` (``runtime/swap_tensor.py``), so a block's update is one
  host kernel call (``ops/cpu_optimizers.py``) and a block's swap one file;
* the compute-dtype wire cache (bf16, or the fp32 master itself) pinned on
  a card's machine: a fetch is one asynchronous host-to-device copy on a
  side stream; the host kernel writes the new cache in the same pass as the
  update (``bf16_out``), so updated weights never cross the card twice;
* the gradient stash, pinned too: a block's gradients come down as one
  asynchronous copy on another side stream into the stash (wire dtype at
  one micro-step a step, fp32 when accumulating).

At world size W > 1 the store is sharded across the ranks, not replicated
(JAX's one process a host replicates it; here a host runs one process a
card, and four copies of a 13B store would not fit its memory).  Each
group's flat vector is padded to a multiple of 16·W elements and rank r
holds slice r of it: its master, moments, wire cache and gradient stash.
A fetch copies the rank's slice of the cache to the card and all-gathers
the block there (issued where the fetch starts, so every rank issues the
gathers, the prefetch's included, in one order); a block's gradients are
reduce-scattered (SUM: the loss is already the global batch's mean) and
only the rank's slice comes down; the host sweep updates the rank's slice.
Adam and Lion are elementwise, so the result is the replicated sweep's.

A failed swap raises; an optimizer with no host kernel raises.
"""

import contextlib
import os
import tempfile
from typing import Callable, NamedTuple

import numpy as np
import torch

from ... import comm as dist
from ...utils.logging import log_dist

_ALIGN = 16


class StreamingSpec(NamedTuple):
    """How a model exposes its blocks to the streaming engine.

    ``block_keys``       the JAX package's key of each block ("layers_0",
                         ...), the keys of ``infinity_state.pkl``.
    ``block_prefixes``   each block's module path ("model.layers.0.").
    ``block_leaves``     ((local name, shape), ...) of one block, in the
                         block module's order; every block shares them.
    ``resident_keys``    the JAX keys of the embed/norm/head group.
    ``resident_leaves``  ((module name, shape), ...) of that group.
    ``embed_apply``      ``(resident, input_ids, labels=None,
                         attention_mask=None) -> activations``
    ``block_apply``      ``(block leaves by local name, activations) ->
                         activations``
    ``head_apply``       ``(resident, activations, input_ids, labels=None,
                         attention_mask=None, loss_reduction="mean") ->
                         loss`` (logits without labels; "sum_count": the
                         loss's sum and count, ``llama.lm_loss``)
    ``init_leaf``        ``(module name, fp32 CPU tensor, generator)``:
                         fills one leaf with the model's random init.
    """
    block_keys: tuple
    block_prefixes: tuple
    block_leaves: tuple
    resident_keys: tuple
    resident_leaves: tuple
    embed_apply: Callable
    block_apply: Callable
    head_apply: Callable
    init_leaf: Callable


def group_layout(leaves):
    """[(name, offset, numel, shape)] of ``leaves`` packed into one flat
    vector, each leaf 16-element aligned, and the vector's length."""
    out, off = [], 0
    for name, shape in leaves:
        n = int(np.prod(shape, dtype=np.int64))
        out.append((name, off, n, tuple(shape)))
        off += -(-n // _ALIGN) * _ALIGN
    return out, off


def views(flat, layout):
    """{name: view of ``flat``} in the layout's shapes."""
    return {name: flat[o:o + n].view(shape) for name, o, n, shape in layout}


def host_threads(world):
    """The host threads one rank of ``world`` ranks on this host may take
    (``LOCAL_WORLD_SIZE`` when the launcher sets it): the cores over the
    ranks that share them, and never more than ``OMP_NUM_THREADS`` asks
    (OpenMP's setting is the process's: raising it would change the other
    host kernels' reduction order too)."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    cores = len(os.sched_getaffinity(0)) if hasattr(
        os, "sched_getaffinity") else (os.cpu_count() or 1)
    share = max(1, cores // max(1, local))
    return min(share, int(os.environ.get("OMP_NUM_THREADS", share)))


class _FetchHandle:
    """A fetch in flight: an optional NVMe read, then the copy to the
    card, then (world > 1) the all-gather of the block."""

    def __init__(self, key):
        self.key = key
        self.read = None       # SwapHandle of an NVMe read
        self.flat = None       # the device copy (the whole block)
        self.event = None      # the copy's end on the side stream
        self.gather = None     # the all-gather's handle


class BlockStore:
    """Host or NVMe residency of per-block parameters and optimizer state.

    ``param_device``/``state_device``: "cpu" (host memory) or "nvme".
    ``optimizer``: adam, adamw, fusedadam, adagrad or lion, on the host
    kernels.  ``device``: the engine's (a card: the wire cache and the
    gradient stash are pinned, transfers asynchronous on side streams).
    ``group``: the ranks the store is sharded over (module docstring);
    ``rank`` is this rank's place in it.  The host kernels and the aio
    pool take :func:`host_threads` threads.
    """

    KINDS = {"adam": ("m", "v"), "adamw": ("m", "v"), "fusedadam": ("m", "v"),
             "adagrad": ("sum", ), "lion": ("m", )}

    def __init__(self, param_device="cpu", state_device="cpu", nvme_path=None,
                 optimizer="adam", opt_params=None,
                 wire_dtype=torch.bfloat16, grad_accum_fp32=False,
                 device="cpu", rank=0, group=None):
        if optimizer not in self.KINDS:
            raise ValueError(
                f"host optimizer {optimizer!r} is not supported for "
                f"ZeRO-Infinity param streaming (have: "
                f"{sorted(self.KINDS)}); the native LAMB has no host kernel")
        self.param_device = param_device
        self.state_device = state_device
        self.optimizer = optimizer
        p = dict(opt_params or {})
        self.lr = p.get("lr", 1e-3)
        self.betas = tuple(p.get("betas", (0.9, 0.999) if "adam" in optimizer
                                 else (0.9, 0.99)))
        self.eps = p.get("eps", 1e-8)
        self.weight_decay = p.get("weight_decay", 0.0)
        self.adamw_mode = optimizer in ("adamw", "fusedadam") or \
            p.get("adam_w_mode", False)
        self.wire_dtype = wire_dtype
        self.grad_accum_fp32 = grad_accum_fp32
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self.group = group
        self.world = group.size() if group is not None else 1
        self.rank = rank if self.world > 1 else 0
        self.threads = host_threads(self.world)
        self.step_count = 0
        self._kernels = None
        self._layout = {}    # key → ([(name, off, numel, shape)], padded
        #                     length, this rank's slice length)
        self._master = {}    # key → flat fp32 (state in host memory)
        self._state = {}     # key → {kind: flat fp32}
        self._cache = {}     # key → flat wire dtype (params in host memory)
        self._grads = {}     # key → flat stash, from a block's first grads
        self._installed = set()
        self.transfer = {"h2d_bytes": 0, "d2h_bytes": 0}
        self._copies = {"h2d": [], "d2h": []}   # (start, end) events
        if self._cuda:
            self._h2d = torch.cuda.Stream(self.device)
            self._d2h = torch.cuda.Stream(self.device)
        self._swapper = None
        if "nvme" in (param_device, state_device):
            from ..swap_tensor import AsyncTensorSwapper
            base = nvme_path or os.path.join(tempfile.gettempdir(),
                                             "ds_tpu_infinity")
            swap_dir = os.path.join(str(base), "param_stream", f"rank{rank}")
            self._swapper = AsyncTensorSwapper(
                swap_dir, thread_count=min(4, self.threads))
            log_dist(f"ZeRO-Infinity param streaming → {swap_dir}", ranks=[0])
        log_dist(f"ZeRO-Infinity host store: rank {self.rank} of "
                 f"{self.world}, {self.threads} host threads a rank",
                 ranks=[0])

    def _mark(self):
        if not self._cuda:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _timed_copy(self, way, dst, src):
        start = self._mark()
        dst.copy_(src, non_blocking=True)
        end = self._mark()
        self._copies[way].append((start, end))
        return end

    def transfer_seconds(self):
        """{"h2d": s, "d2h": s}: the card's time in the copies since the
        last call (waits for them)."""
        out = {}
        for way, evs in self._copies.items():
            for _, end in evs:
                end.synchronize()
            out[way] = sum(a.elapsed_time(b) for a, b in evs) / 1e3
            evs.clear()
        return out

    def _host_empty(self, n, dtype):
        return torch.empty(n, dtype=dtype, pin_memory=self._cuda)

    # ------------------------------------------------------------ install
    def add_group(self, key, leaves):
        """Lay a group out (``leaves``: ((name, shape), ...)) without
        values: padded to a multiple of 16 · world elements."""
        layout, n = group_layout(leaves)
        unit = _ALIGN * self.world
        padded = -(-n // unit) * unit
        self._layout[key] = (layout, padded, padded // self.world)

    def install_group(self, key, leaves, values):
        """Adopt a group's fp32 values (``{name: tensor}`` over ``leaves``,
        ((name, shape), ...)); this rank keeps its slice, with zero moments
        and its wire cache."""
        self.add_group(key, leaves)
        layout, n, _ = self._layout[key]
        flat = torch.zeros(n, dtype=torch.float32)
        mine = self.leaves_in_slice(key)
        for name, o, k, shape in layout:
            if name not in values and name not in mine:
                continue     # another rank's: not needed here
            t = values[name]
            if tuple(t.shape) != shape:
                raise ValueError(f"{key}/{name}: shape {tuple(t.shape)} != "
                                 f"{shape}")
            flat[o:o + k].copy_(t.detach().reshape(-1))
        self._set_master(key, self.take_slice(key, flat).clone(),
                         zero_state=True)

    def leaves_in_slice(self, key):
        """The names of the group's leaves that overlap this rank's
        slice (all of them at world 1)."""
        lo, hi = self.slice_range(key)
        return {name for name, o, k, _ in self._layout[key][0]
                if o < hi and o + k > lo}

    def install_zeros(self, key, leaves):
        """Lay a group out with zero master and state (a load fills
        them)."""
        self.add_group(key, leaves)
        self._set_master(key, torch.zeros(self.shard_numel(key)),
                         zero_state=True)

    def slice_range(self, key):
        """[lo, hi) of this rank's slice in the group's padded flat
        vector."""
        s = self._layout[key][2]
        return self.rank * s, (self.rank + 1) * s

    def take_slice(self, key, flat):
        """This rank's slice (a view) of the group's whole padded flat
        vector."""
        lo, hi = self.slice_range(key)
        return flat[lo:hi]

    def installed(self, key):
        """Whether the group holds values (a load may still lay it out
        first)."""
        return key in self._installed

    def _set_master(self, key, flat, zero_state=False):
        self._installed.add(key)
        cache = flat
        if self.wire_dtype != torch.float32:
            cache = self._host_empty(flat.numel(), self.wire_dtype)
            cache.copy_(flat)
        if self.state_device == "nvme":
            self._swapper.swap_out(f"{key}:master", flat)
            if zero_state:
                for k in self.KINDS[self.optimizer]:
                    self._swapper.swap_out(f"{key}:{k}", torch.zeros_like(
                        flat))
        else:
            self._master[key] = flat
            if zero_state:
                self._state[key] = {k: torch.zeros_like(flat)
                                    for k in self.KINDS[self.optimizer]}
        if self.param_device == "nvme":
            self._swapper.swap_out(f"{key}:cache", cache)
        else:
            if cache is flat and self._cuda:
                cache = self._host_empty(flat.numel(), torch.float32)
                cache.copy_(flat)
            self._cache[key] = cache
        if self._swapper is not None:
            self._swapper.synchronize()

    def keys(self):
        return tuple(self._layout)

    def layout(self, key):
        return self._layout[key][0]

    def numel(self, key):
        """The group's padded length (the whole block on the card)."""
        return self._layout[key][1]

    def shard_numel(self, key):
        """The length of this rank's slice."""
        return self._layout[key][2]

    def param_bytes(self, key):
        return self.numel(key) * torch.empty(
            (), dtype=self.wire_dtype).element_size()

    def host_bytes(self):
        """Bytes of host memory the store holds (master, moments, cache,
        stash; NVMe-resident kinds excluded)."""
        out = 0
        for key in self.keys():
            n = self.shard_numel(key)
            if self.state_device != "nvme":
                out += 4 * n * (1 + len(self.KINDS[self.optimizer]))
            if self.param_device != "nvme":
                out += n * torch.empty(
                    (), dtype=self.wire_dtype).element_size()
        out += sum(t.numel() * t.element_size() for t in self._grads.values())
        return out

    # ------------------------------------------------------------ fetch
    def start_fetch(self, key):
        """Start fetching a group: its NVMe read, or (cache in host memory)
        its copy to the card on the side stream."""
        h = _FetchHandle(key)
        if self.param_device == "nvme":
            h.read = self._swapper.swap_in(
                f"{key}:cache",
                out=self._host_empty(self.shard_numel(key), self.wire_dtype))
        else:
            self._copy_up(h, self._cache[key])
        return h

    def _copy_up(self, h, host):
        """The rank's slice to the card and (world > 1) the block's
        all-gather, both queued behind the compute stream's work."""
        whole = self.world > 1
        if not self._cuda:
            h.flat = host
            if whole:
                h.flat = torch.empty(self.numel(h.key), dtype=host.dtype)
                h.gather = dist.allgather_fn(h.flat, host, group=self.group,
                                             async_op=True)
            return
        cur = torch.cuda.current_stream(self.device)
        n = self.numel(h.key)
        flat = torch.empty(n, dtype=host.dtype, device=self.device)
        lo, hi = self.slice_range(h.key)
        mine = flat[lo:hi]
        # after whatever the compute stream queued before (the buffer may
        # be memory it just freed)
        self._h2d.wait_stream(cur)
        with torch.cuda.stream(self._h2d):
            h.event = self._timed_copy("h2d", mine, host)
            if whole:
                # the gather follows the copy on this stream (in place:
                # the rank's slice is its block of the output)
                h.gather = dist.allgather_fn(flat, mine, group=self.group,
                                             async_op=True)
        self.transfer["h2d_bytes"] += host.numel() * host.element_size()
        # a pinned source freed before the copy ends is not reused until
        # it does (PyTorch's pinned allocator records the copy's stream)
        h.flat = flat

    def finish_fetch(self, handle):
        """{name: device view} of a fetched group; the compute stream waits
        for its copy and gather."""
        if handle.flat is None:
            self._copy_up(handle, handle.read.wait())
        if handle.gather is not None:
            with (torch.cuda.stream(self._h2d) if self._cuda else
                  contextlib.nullcontext()):
                handle.gather.wait()
                if self._cuda:
                    handle.event = self._mark()
            handle.gather = None
        if handle.event is not None:
            torch.cuda.current_stream(self.device).wait_event(handle.event)
            handle.event = None
        return views(handle.flat, self.layout(handle.key))

    # ------------------------------------------------------------ grads
    def _reduce_scatter(self, key, grads):
        """World > 1: the group's gradients as one padded flat on the
        device, reduce-scattered (SUM) over the ranks: this rank's slice,
        in the gradients' dtype."""
        layout, n, s = self._layout[key]
        dt = grads_dtype(grads)
        full = torch.zeros(n, dtype=dt, device=self.device)
        for (_, o, k, _), g in zip(layout, grads):
            if g is not None:
                full[o:o + k].copy_(g.reshape(-1))
        out = torch.empty(s, dtype=dt, device=self.device)
        dist.reduce_scatter_fn(out, full, group=self.group)
        return out

    def start_grads(self, key, grads):
        """A group's gradients (device tensors in its leaf order, None for
        a leaf without one) start down to the host stash, on the side
        stream: accumulated in place at its first micro-step, through a
        staging buffer after (world > 1: the rank's slice of their
        reduce-scatter).  Returns what :meth:`finish_grads` takes."""
        layout, _, n = self._layout[key]
        if self.world > 1:
            mine = self._reduce_scatter(key, grads)
            layout = [("", 0, n, (n, ))]
            grads = [mine]
        stash = self._grads.get(key)
        first = stash is None
        if first:
            dt = torch.float32 if self.grad_accum_fp32 else self.wire_dtype
            stash = self._grads[key] = self._host_empty(n, dt)
            stash.zero_()
        dst = stash if first else self._host_empty(n, grads_dtype(grads))
        if not first:
            dst.zero_()
        pend = {"key": key, "dst": dst, "first": first, "grads": grads,
                "event": None}
        ctx = torch.cuda.stream(self._d2h) if self._cuda else \
            contextlib.nullcontext()
        if self._cuda:
            self._d2h.wait_stream(torch.cuda.current_stream(self.device))
        with ctx:
            start = self._mark()
            for (_, o, k, _), g in zip(layout, grads):
                if g is not None:
                    dst[o:o + k].copy_(g.reshape(-1), non_blocking=True)
            if self._cuda:
                pend["event"] = self._mark()
                self._copies["d2h"].append((start, pend["event"]))
        self.transfer["d2h_bytes"] += n * dst.element_size()
        return pend

    def finish_grads(self, pend):
        if pend["event"] is not None:
            pend["event"].synchronize()
        if not pend["first"]:
            stash = self._grads[pend["key"]]
            stash.add_(pend["dst"].to(stash.dtype))

    def accumulate_grads(self, key, grads):
        self.finish_grads(self.start_grads(key, grads))

    def grad_sq_norm(self):
        """Σ ‖g‖² over every stash (the host kernel, in double), summed
        over the ranks' slices."""
        from ...ops.cpu_optimizers import cpu_sq_norm
        sq = sum(cpu_sq_norm(s if s.dtype == torch.float32 else s.float())
                 for s in self._grads.values())
        if self.world > 1:
            t = torch.tensor([sq], dtype=torch.float64, device=self.device)
            sq = float(dist.all_reduce(t, group=self.group)[0])
        return sq

    # ------------------------------------------------------------ step
    def _get_kernels(self):
        if self._kernels is None:
            from ...ops import cpu_optimizers as k
            k.set_host_threads(self.threads)
            if self.optimizer == "adagrad":
                self._kernels = k.DeepSpeedCPUAdagrad(
                    lr=self.lr, eps=self.eps, weight_decay=self.weight_decay)
            elif self.optimizer == "lion":
                self._kernels = k.DeepSpeedCPULion(
                    lr=self.lr, betas=self.betas,
                    weight_decay=self.weight_decay)
            else:
                self._kernels = k.DeepSpeedCPUAdam(
                    lr=self.lr, betas=self.betas, eps=self.eps,
                    weight_decay=self.weight_decay,
                    adamw_mode=self.adamw_mode)
        return self._kernels

    def _read_state(self, key):
        if self.state_device != "nvme":
            return self._master[key], self._state[key]
        sw = self._swapper
        master = sw.swap_in(f"{key}:master", async_op=False).wait()
        return master, {k: sw.swap_in(f"{key}:{k}", async_op=False).wait()
                        for k in self.KINDS[self.optimizer]}

    def optimizer_sweep(self, lr=None, grad_scale=None):
        """One host optimizer step over every group that received
        gradients; ``grad_scale`` multiplies them (the clip coefficient
        and 1/gas).  The wire cache is written in the same kernel pass."""
        kern = self._get_kernels()
        self.step_count += 1
        for key in list(self._grads):
            stash = self._grads.pop(key)
            grad = stash if stash.dtype == torch.float32 else stash.float()
            if grad_scale is not None and grad_scale != 1.0:
                grad.mul_(np.float32(grad_scale))
            master, state = self._read_state(key)
            if self.wire_dtype == torch.bfloat16:
                out = (self._host_empty(master.numel(), torch.bfloat16)
                       if self.param_device == "nvme" else self._cache[key])
            else:
                out = None
            # every group of one sweep shares one bias-correction step
            kern.step_count = self.step_count - 1
            if self.optimizer == "adagrad":
                kern.step(master, grad, state["sum"], bf16_out=out, lr=lr)
            elif self.optimizer == "lion":
                kern.step(master, grad, state["m"], bf16_out=out, lr=lr)
            else:
                kern.step(master, grad, state["m"], state["v"], bf16_out=out,
                          lr=lr)
            if self.state_device == "nvme":
                self._swapper.swap_out(f"{key}:master", master)
                for k, s in state.items():
                    self._swapper.swap_out(f"{key}:{k}", s)
            cache = out if out is not None else master
            if self.param_device == "nvme":
                self._swapper.swap_out(f"{key}:cache", cache)
            elif out is None and cache is not self._cache[key]:
                # an fp32 cache apart from the master (pinned, or the
                # master read from NVMe): the next fetch reads the cache
                self._cache[key].copy_(master)
        if self._swapper is not None:
            # durable before the next step's reads
            self._swapper.synchronize()

    # ------------------------------------------------- checkpoint interface
    def export_master(self):
        """{key: fp32 flat copy} in the port's layout (this rank's
        slices)."""
        return {key: self._read_state(key)[0].clone() for key in self.keys()}

    def export_state(self):
        out = {"step_count": self.step_count, "kinds": {}}
        for key in self.keys():
            out["kinds"][key] = {k: v.clone() for k, v in
                                 self._read_state(key)[1].items()}
        return out

    def import_master(self, flats):
        """{key: fp32 flat in the port's layout (this rank's slice)}:
        master and cache."""
        for key, flat in flats.items():
            self._set_master(key, flat.float().contiguous().clone())

    def import_state(self, state):
        self.step_count = int(state["step_count"])
        for key, kinds in state["kinds"].items():
            flat = {k: v.float().contiguous().clone()
                    for k, v in kinds.items()}
            if self.state_device == "nvme":
                for k, v in flat.items():
                    self._swapper.swap_out(f"{key}:{k}", v)
            else:
                self._state[key] = flat
        if self._swapper is not None:
            self._swapper.synchronize()


def grads_dtype(grads):
    return next(g.dtype for g in grads if g is not None)
