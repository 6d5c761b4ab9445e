"""Optimizer-state offload and ``offload_states``/``reload_states``: the
port of the offload pieces of ``deepspeed_tpu/runtime/engine.py``, mixed
into :class:`~.engine.DeepSpeedEngine`.

* ``offload_optimizer.device: cpu`` (JAX: the ``pinned_host`` memory kind,
  ``runtime/zero/partition.py:478-515``): from the engine's build on, the
  fp32 master and the moments (this rank's shard of them) live in pinned
  host memory, pinned once and timed (``offload_stats``).  B2, B3 or B8
  still computes the update on the card: it reads and writes that memory
  in place through its device-mapped address, so the result is the one
  without offload, bit for bit.  The compute-dtype parameters, the
  gradients and LAMB's scratch stay on the card.
* ``offload_optimizer.device: nvme`` (``engine.py:671-865``): the same
  state lives in files between steps (``runtime/swap_tensor.py``); its
  buffers on the engine's device keep their identity with no storage.
  The reads start at the boundary's ``backward``.  At the boundary the
  host Adam or Lion (``ops/cpu_optimizers.py``) updates the state on the
  host and only the new compute-dtype parameters go up, under JAX's
  conditions (:meth:`_try_host_offload_step`; ``DS_TPU_HOST_OFFLOAD_STEP=0``
  turns it off); otherwise the state comes back to the device, the kernel
  applies, and it goes out again.
* ``offload_states(include)`` (``engine.py:2115-2160``) copies the named
  states to the host (pinned on a card's machine) and frees their device
  storage; the tensors keep their identity (the module's parameters stay
  views), so ``reload_states`` only refills them.  The engine reloads on
  its own where JAX does: the parameters before ``forward``, the
  accumulated gradients before ``backward`` folds into them, everything
  before ``step`` and before a checkpoint.

On the CPU (``device="cpu"``) host and device are one memory: the
placement is the engine's record (:meth:`state_placement`), the copies
and the freed storage are real.
"""

import contextlib
import os
import tempfile
import time

import numpy as np
import torch

from .. import comm as dist
from ..utils.logging import log_dist
from .config import ADAM_OPTIMIZERS, LION_OPTIMIZER

# JAX ``engine.py:2115-2119``: the public names → the engine's attributes
OFFLOAD_STATE_ATTRS = {"optim_states": "opt_state", "hp_params": "master",
                       "lp_params": "params", "lp_grads": "grad_acc"}


def _free(t):
    t.untyped_storage().resize_(0)


def _refill(t, host, non_blocking=False):
    t.untyped_storage().resize_(t.numel() * t.element_size())
    t.copy_(host, non_blocking=non_blocking)


def _resident(t):
    return t is not None and t.untyped_storage().size() > 0


class OffloadMixin:

    def _configure_offload(self, optimizer_device=None):
        """``optimizer_device``: overrides the config's (parameter streaming
        keeps its own state)."""
        zc = self._config.zero_config
        self._offload_device = (zc.offload_optimizer_device
                                if optimizer_device is None
                                else optimizer_device)
        # pinned memory exists only beside a card
        self._pin_state = (self._offload_device == "cpu" and
                           self.device.type == "cuda")
        self._host_offloaded = {}
        self._nvme_swapper = None
        self._nvme_prefetch = None
        self._state_on_nvme = False
        self.host_offload_steps = 0
        self.offload_stats = {"pin_seconds": 0.0, "pinned_bytes": 0}
        if self._offload_device == "nvme":
            from .swap_tensor import PartitionedOptimizerSwapper
            base = zc.offload_optimizer.nvme_path or os.path.join(
                tempfile.gettempdir(), "ds_tpu_nvme")
            swap_dir = os.path.join(str(base), f"zero_stage_{zc.stage}",
                                    f"rank{dist.get_rank()}")
            self._nvme_swapper = PartitionedOptimizerSwapper(swap_dir)
            log_dist(f"NVMe optimizer-state offload → {swap_dir}", ranks=[0])

    # ----------------------------------------------------- the fp32 state
    def _fp32_zeros(self, n):
        """A zero fp32 buffer of the optimizer's state: pinned host memory
        under ``offload_optimizer: cpu`` on a card (timed), else on the
        engine's device."""
        if not self._pin_state:
            return torch.zeros(n, dtype=torch.float32, device=self.device)
        t0 = time.perf_counter()
        t = torch.zeros(n, dtype=torch.float32, pin_memory=True)
        self.offload_stats["pin_seconds"] += time.perf_counter() - t0
        self.offload_stats["pinned_bytes"] += 4 * n
        return t

    def _moments(self):
        """{field: tensor} of the optimizer state's moments."""
        st = self.opt_state
        if st is None:
            return {}
        return {k: getattr(st, k) for k in self._transform.MOMENTS
                if isinstance(getattr(st, k, None), torch.Tensor)}

    def _state_buffers(self):
        """{name: tensor} of the fp32 state that offload moves: the master
        (mixed precision) and the moments."""
        out = {} if self.master is None else {"master": self.master}
        out.update(self._moments())
        return out

    def _after_opt_state_init(self):
        if self._pin_state:
            self.offload_stats["pinned_bytes"] += sum(
                4 * t.numel() for t in self._moments().values())
        if self._nvme_swapper is not None:
            # the state leaves the device at the build (reference
            # stage3.py swaps out at init)
            self._nvme_swap_out()

    def state_placement(self):
        """{state: "device" | "host" | "nvme"}: where the engine keeps the
        parameters, the gradient accumulator, the master and each moment
        (its own record, which on the CPU is the only witness)."""
        names = {"params": self.params, "grad_acc": self.grad_acc}
        names.update(self._state_buffers())
        hosted = {id(t) for recs in self._host_offloaded.values()
                  for t, _ in recs}
        on_host = set(self._state_buffers()) if \
            self._offload_device == "cpu" else set()
        out = {}
        for name, t in names.items():
            if t is None:
                continue
            if id(t) in hosted or name in on_host:
                out[name] = "host"
            elif self._state_on_nvme and name in self._state_buffers():
                out[name] = "nvme"
            else:
                out[name] = "device"
        return out

    # ------------------------------------------------------------ NVMe
    def _nvme_swap_out(self):
        """The fp32 state → its files (asynchronous writes of host copies);
        the device buffers keep no storage."""
        bufs = self._state_buffers()
        host = {k: t.detach().to("cpu", copy=True) for k, t in bufs.items()}
        for t in bufs.values():
            _free(t)
        self._state_on_nvme = True
        self._nvme_swapper.swap_out_tree(host)

    def _nvme_start_swap_in(self):
        if self._nvme_prefetch is None:
            self._nvme_prefetch = self._nvme_swapper.swap_in_tree_async()

    def _nvme_finish_swap_in(self):
        self._nvme_start_swap_in()
        host = self._nvme_swapper.finish_swap_in(self._nvme_prefetch)
        self._nvme_prefetch = None
        return host

    def _ensure_state_resident(self):
        """Every offloaded state back on the device: what
        ``offload_states`` moved, and the state on NVMe."""
        if self._host_offloaded:
            self.reload_states()
        if self._nvme_swapper is None or not self._state_on_nvme:
            return
        host = self._nvme_finish_swap_in()
        for k, t in self._state_buffers().items():
            _refill(t, host[k])
        self._state_on_nvme = False

    @contextlib.contextmanager
    def _state_on_host(self, write_back):
        """For a checkpoint: the state on NVMe read to the host (not to the
        device) and bound in place of the empty buffers while the block
        runs; ``write_back`` swaps it out again after (a load)."""
        if self._host_offloaded:
            self.reload_states()
        if self._nvme_swapper is None or not self._state_on_nvme:
            yield
            return
        bufs = self._state_buffers()
        host = self._nvme_finish_swap_in()
        self._bind_state(host)
        try:
            yield
        finally:
            if write_back:
                self._nvme_swapper.swap_out_tree(self._state_buffers())
            self._bind_state(bufs)

    def _bind_state(self, tensors):
        for k, t in tensors.items():
            if k == "master":
                self.master = t
            else:
                setattr(self.opt_state, k, t)

    def _host_step_kind(self):
        """"adam" or "lion" when the config's optimizer has a host kernel
        for exactly its update (JAX ``engine.py:611-630``), else None."""
        cfg = self._config
        name = cfg.optimizer_name
        if self._client_optimizer or name is None:
            return None
        if name in ADAM_OPTIMIZERS and self._transform.bias_correction:
            return "adam"
        if name == LION_OPTIMIZER:
            return "lion"
        return None

    def _try_host_offload_step(self):
        """The host optimizer step of NVMe offload (JAX ``engine.py:722-
        865``; reference ``csrc/adam/cpu_adam_impl.cpp``): the gradients go
        down, the host kernel updates the fp32 state read from disk, only
        the compute-dtype parameters go up, and the state goes back out.
        Returns the gradient norm, or None where JAX keeps the device path:
        fp16, offloaded states, the finite-grad guard, more than one rank,
        no host kernel for the optimizer, or ``DS_TPU_HOST_OFFLOAD_STEP=0``;
        and under a pipeline of more than one stage, whose norm is summed
        over the stages (JAX's fused pipeline step is a device program)."""
        if self._nvme_swapper is None or not self._state_on_nvme or \
                self._acc_fresh:
            return None
        if os.environ.get("DS_TPU_HOST_OFFLOAD_STEP", "1") == "0":
            return None
        kind = self._host_step_kind()
        if kind is None or self._config.fp16_enabled or \
                self._host_offloaded or self._finite_guard.enabled or \
                self._data_world > 1 or self.pp_world_size > 1:
            return None
        from ..ops import cpu_optimizers as K
        g = self._reduced_grads().detach().to("cpu", torch.float32,
                                              copy=True)
        self.grad_acc = None
        host = self._nvme_finish_swap_in()
        target = host["master"] if self.master is not None else \
            self._param_shard().detach().to("cpu", copy=True)
        pieces = self.zero_plan.leaf_pieces(self._layout)
        gn = float(np.sqrt(sum(K.cpu_sq_norm(g[o:o + n])
                               for o, n, _ in pieces)))
        clip = self._config.gradient_clipping
        if clip and clip > 0 and gn > clip:
            g *= np.float32(clip / gn)
        tr, st = self._transform, self.opt_state
        count = st.count + 1
        lr = tr.current_lr(count, st)
        out = torch.empty(g.numel(), dtype=torch.bfloat16) if \
            self.compute_dtype == torch.bfloat16 else None
        if kind == "adam":
            kern = K.DeepSpeedCPUAdam(lr=tr.lr, betas=tr.betas, eps=tr.eps,
                                      weight_decay=tr.weight_decay,
                                      adamw_mode=tr.adam_w_mode)
            kern.step_count = count - 1
            kern.step(target, g, host["exp_avg"], host["exp_avg_sq"],
                      bf16_out=out, lr=lr)
        else:
            kern = K.DeepSpeedCPULion(lr=tr.lr, betas=tr.betas,
                                      weight_decay=tr.weight_decay)
            kern.step(target, g, host["exp_avg"], bf16_out=out, lr=lr)
        with torch.no_grad():
            self._param_shard().copy_(out if out is not None else target)
            if self.zero_plan.sharded:
                self._gather_updated()
        st.count = count
        self._nvme_swapper.swap_out_tree(host)   # the master updated in place
        self.host_offload_steps += 1
        return gn

    # -------------------------------------------- offload_states on demand
    def _offload_targets(self, attr):
        """The device tensors behind one of JAX's four states (the fp32
        state that ``offload_optimizer: cpu`` keeps on the host is not
        among them)."""
        if attr == "params":
            ts = [self.params, self._pshard]
        elif attr == "grad_acc":
            ts = [self.grad_acc]
        elif attr == "master":
            ts = [] if self._offload_device == "cpu" else [self.master]
        else:
            st = self.opt_state
            home = set(self._transform.MOMENTS) if \
                self._offload_device == "cpu" else set()
            ts = [] if st is None else [
                getattr(st, k) for k in vars(st)
                if isinstance(getattr(st, k), torch.Tensor) and
                k not in home]
        return [t for t in ts if _resident(t)]

    def offload_states(self, include=None, device="cpu", pin_memory=True,
                       non_blocking=False):
        """Move engine states to host memory on demand (reference
        ``engine.py:3720``; JAX ``engine.py:2121``), freeing their device
        memory.  ``include``: a subset of "optim_states", "hp_params",
        "lp_params", "lp_grads" (``OffloadStateTypeEnum.`` prefixes
        accepted); default all.  The host copies are pinned with
        ``pin_memory`` on a card; ``non_blocking`` leaves the copies in
        flight on the current stream."""
        if str(device) not in ("cpu", "OffloadDeviceEnum.cpu"):
            raise ValueError(f"only host offload is supported, got {device}")
        if self._state_on_nvme:
            raise RuntimeError("states already offloaded to NVMe")
        names = (list(include) if include is not None
                 else list(OFFLOAD_STATE_ATTRS))
        attrs = []
        for name in names:
            attr = OFFLOAD_STATE_ATTRS.get(str(name).split(".")[-1])
            if attr is None:
                raise ValueError(f"unknown state {name!r} (have: "
                                 f"{sorted(OFFLOAD_STATE_ATTRS)})")
            attrs.append(attr)
        pin = pin_memory and self.device.type == "cuda"
        with torch.no_grad():
            for attr in attrs:
                if attr in self._host_offloaded:
                    continue
                recs = []
                for t in self._offload_targets(attr):
                    host = torch.empty(t.shape, dtype=t.dtype,
                                       pin_memory=pin)
                    host.copy_(t, non_blocking=non_blocking and pin)
                    _free(t)
                    recs.append((t, host))
                if recs:
                    self._host_offloaded[attr] = recs

    def reload_states(self, non_blocking=False):
        """Refill every offloaded state on the device (reference
        ``engine.py:3747``)."""
        for attr in list(self._host_offloaded):
            self._reload(attr, non_blocking)

    def _reload(self, attr, non_blocking=False):
        recs = self._host_offloaded.pop(attr, None)
        with torch.no_grad():
            for t, host in recs or ():
                _refill(t, host, non_blocking and host.is_pinned())
