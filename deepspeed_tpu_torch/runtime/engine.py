"""DeepSpeedEngine, ZeRO stage 0 (the port of
``deepspeed_tpu/runtime/engine.py``; reference ``runtime/engine.py:183``).

The JAX engine owns a jitted train step over a mesh; this one owns a torch
module on one CUDA card (or, asked by name, the CPU):

* parameters (``_install_parameters``, ``engine.py:494-528``): every leaf
  in the compute dtype (bf16 or fp32; norm weights and the LM head too),
  laid out in ONE flat buffer whose slices become the module's parameters;
  with bf16 an fp32 master of the same layout is kept.  The gradient
  accumulator and Adam's moments share that layout, so the boundary update
  is one launch of kernel B2 over all leaves.
* ``forward`` runs the model and keeps the graph; ``backward`` runs
  autograd and folds the micro-step's gradients, cast to
  ``grad_accum_dtype``, into the accumulator (``engine.py:1302-1305``,
  ``:1444-1448``).  The JAX engine computes the gradients inside
  ``forward`` (one ``value_and_grad`` program) and only folds them in
  ``backward``; here the backward pass itself runs in ``backward``.
* ``step`` at the accumulation boundary, in ``engine.py:1469-1535``'s
  order: unscale (the static scale is 1 for bf16/fp32), global norm,
  clip (the coefficient rides into the Adam kernel as a device scalar, so
  no host sync and no extra pass), Adam on the master, the bf16 copy
  written by the same kernel.
"""

import numpy as np
import torch

from ..accelerator import resolve_device
from ..ops.adam import FusedAdamTransform, fused_adam
from ..utils.logging import log_dist
from ..utils.not_ported import not_ported
from .config import ADAMW_OPTIMIZER, FUSED_ADAM_OPTIMIZER, DeepSpeedConfig
from .loss_scaler import create_loss_scaler
from .lr_schedules import get_lr_scheduler
from .utils import (clip_coefficient, count_parameters, global_grad_norm,
                    make_scaled_loss_fn)

_ALIGN = 16   # elements: every leaf starts 64-byte aligned in fp32 buffers
_ACCUM_DTYPES = {None: torch.float32, "fp32": torch.float32,
                 "bf16": torch.bfloat16}


def flat_layout(named_shapes):
    """[(name, offset, numel, shape)] of leaves packed into one flat buffer,
    each starting at a multiple of ``_ALIGN`` elements, and the buffer's
    length.  ``named_shapes``: (name, shape) pairs."""
    layout, off = [], 0
    for name, shape in named_shapes:
        n = int(np.prod(shape, dtype=np.int64))
        layout.append((name, off, n, tuple(shape)))
        off += -(-n // _ALIGN) * _ALIGN
    return layout, off


class _ParamGroup(dict):
    """torch-style param group whose ``["lr"] = x`` writes reach the
    optimizer's ``lr_override`` (``engine.py:70``)."""

    def __init__(self, engine, **kw):
        super().__init__(**kw)
        self._engine = engine

    def __setitem__(self, key, value):
        super().__setitem__(key, value)
        if key == "lr" and value is not None:
            self._engine._set_client_lr(float(value))

    # dict.update/setdefault bypass __setitem__ on subclasses
    def update(self, *args, **kw):
        for k, v in dict(*args, **kw).items():
            self[k] = v

    def setdefault(self, key, default=None):
        if key not in self:
            self[key] = default
        return self[key]


class _OptimizerFacade:
    """torch-optimizer-shaped view of the engine's optimizer state
    (``engine.py:98``): ``param_groups`` writes take effect."""

    def __init__(self, engine):
        self._engine = engine
        self.param_groups = [_ParamGroup(engine, lr=None)]

    def state_dict(self):
        return {"opt_state": self._engine.opt_state}

    def load_state_dict(self, sd):
        self._engine.opt_state = sd["opt_state"]

    def zero_grad(self, set_to_none=True):
        pass  # the accumulator restarts at each boundary

    def step(self):
        self._engine.step()

    @property
    def loss_scale(self):
        return self._engine.cur_scale


class DeepSpeedEngine:

    def __init__(self, args=None, model=None, optimizer=None,
                 model_parameters=None, training_data=None,
                 lr_scheduler=None, collate_fn=None, config=None, mpu=None,
                 device=None):
        if not isinstance(config, DeepSpeedConfig):
            config = DeepSpeedConfig(config)
        if not isinstance(model, torch.nn.Module):
            raise TypeError("model must be a torch.nn.Module")
        if mpu is not None:
            raise not_ported("initialize(mpu=...) (model parallelism)", 9)
        if training_data is not None or collate_fn is not None:
            raise not_ported("initialize(training_data=..., collate_fn=...) "
                             "(the dataloader)", 4)
        self._config = config
        self.device = resolve_device(device)
        self.module = model
        self.training = True
        self.global_steps = 0
        self.global_samples = 0
        self.micro_steps = 0
        config.resolve_batch_sizes(1)   # one data-parallel rank

        self.compute_dtype = (torch.bfloat16 if config.bfloat16_enabled
                              else torch.float32)
        self.loss_scaler = create_loss_scaler(config.fp16_enabled)
        self.grad_accum_dtype = _ACCUM_DTYPES[
            config.gradient_accumulation_dtype]
        self.zero_stage = config.zero_optimization_stage
        self._loss_fn = make_scaled_loss_fn(model,
                                            self.gradient_accumulation_steps())

        self.params = None        # flat, compute dtype; module params view it
        self.master = None        # flat fp32 (mixed precision only)
        self.grad_acc = None
        self.opt_state = None
        self._layout = None       # [(name, offset, numel, shape)]
        self._pending_loss = None
        self._acc_fresh = True
        self._pending_client_lr = None
        self._last_gnorm = None
        if model_parameters is not None or not any(
                p.is_meta for p in model.parameters()):
            self._install_parameters(model_parameters)

        self.optimizer = None
        self._transform = None
        self._configure_optimizer(optimizer)
        self.lr_scheduler = self._configure_lr_scheduler(lr_scheduler)
        self.training_dataloader = None
        if self.params is not None:
            log_dist(f"DeepSpeedEngine ready: zero_stage={self.zero_stage} "
                     f"dtype={self.compute_dtype} device={self.device} "
                     f"params={count_parameters(self.module):,}", ranks=[0])

    # ------------------------------------------------------------------ setup
    def _tie(self):
        """Let the module share what it shares (``tie_weights``: a tied LM
        head is the embedding), so each shared leaf is trained once."""
        tie = getattr(self.module, "tie_weights", None)
        if tie is not None:
            tie()

    def _bind(self, flat):
        """Make the module's parameters views into ``flat``."""
        for name, off, n, shape in self._layout:
            *path, leaf = name.split(".")
            mod = self.module.get_submodule(".".join(path))
            setattr(mod, leaf, torch.nn.Parameter(
                flat[off:off + n].view(shape), requires_grad=True))
        self._tie()

    def _install_parameters(self, model_parameters=None):
        """Lay every trainable leaf out in one flat buffer of the compute
        dtype (and an fp32 master when mixed), from ``model_parameters``
        (name → tensor, e.g. fp32 weights) or the module's own values."""
        self._tie()
        named = list(self.module.named_parameters())
        layout, off = flat_layout((n, p.shape) for n, p in named)
        self._layout = layout
        source = (dict(model_parameters) if model_parameters is not None
                  else {n: p for n, p in named})
        missing = [n for n, *_ in layout if n not in source]
        unknown = sorted(set(source) - {n for n, *_ in layout})
        if missing or unknown:
            raise KeyError(f"model_parameters: missing {missing[:4]}, "
                           f"unknown {unknown[:4]}")
        mixed = self.compute_dtype != torch.float32
        self.params = torch.zeros(off, dtype=self.compute_dtype,
                                  device=self.device)
        self.master = (torch.zeros(off, dtype=torch.float32,
                                   device=self.device) if mixed else None)
        with torch.no_grad():
            for name, o, n, shape in layout:
                t = torch.as_tensor(source[name])
                if tuple(t.shape) != shape:
                    raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                                     f"{shape}")
                if t.is_meta:
                    continue
                t = t.detach().to(self.device).reshape(-1)
                self.params[o:o + n].copy_(t)
                if mixed:
                    self.master[o:o + n].copy_(t)
        self._bind(self.params)
        self.grad_acc = None
        self._acc_fresh = True

    def initialize_parameters(self, seed, *sample_inputs, **kw):
        """Random weights from the module's ``init_weights`` with a
        ``torch.Generator`` seeded on the engine's device, drawn in fp32
        (into the master when mixed) and cast to the compute dtype."""
        if self._layout is None:
            self._install_parameters()
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        target = self.master if self.master is not None else self.params
        self._bind(target)
        self.module.init_weights(gen)
        if self.master is not None:
            with torch.no_grad():
                self.params.copy_(self.master)
            self._bind(self.params)
        if self.opt_state is None:
            self._configure_optimizer(None)
        return self.module

    def _configure_optimizer(self, client_optimizer):
        """Reference ``_configure_optimizer`` (``engine.py:559``): the
        config's adam/adamw/fusedadam, or a client ``fused_adam``."""
        cfg = self._config
        lr_fn = None
        if cfg.scheduler_name is not None:
            self._sched_for_lr = get_lr_scheduler(cfg.scheduler_name,
                                                  cfg.scheduler_params)
            lr_fn = self._sched_for_lr.get_lr
        if client_optimizer is not None:
            if not isinstance(client_optimizer, FusedAdamTransform):
                raise not_ported("a client optimizer other than "
                                 "ops.adam.FusedAdam", 11)
            self._transform = client_optimizer
        elif cfg.optimizer_name is not None:
            p = dict(cfg.optimizer_params or {})
            name = cfg.optimizer_name
            lr = p.pop("lr", 1e-3)
            adam_w = p.pop("adam_w_mode", name in (ADAMW_OPTIMIZER,
                                                   FUSED_ADAM_OPTIMIZER))
            self._transform = fused_adam(
                lr=lr, betas=tuple(p.pop("betas", (0.9, 0.999))),
                eps=p.pop("eps", 1e-8),
                weight_decay=p.pop("weight_decay", 0.0), adam_w_mode=adam_w,
                bias_correction=p.pop("bias_correction", True), lr_fn=lr_fn)
        else:
            self._transform = fused_adam(lr=1e-3, lr_fn=lr_fn)
        if self._transform.lr_fn is None and lr_fn is not None:
            self._transform.lr_fn = lr_fn
        self.optimizer = _OptimizerFacade(self)
        if self.params is not None:
            target = self.master if self.master is not None else self.params
            self.opt_state = self._transform.init(target)
            if self._pending_client_lr is not None:
                self._set_client_lr(self._pending_client_lr)

    def _configure_lr_scheduler(self, client_scheduler):
        if client_scheduler is not None:
            return client_scheduler
        return getattr(self, "_sched_for_lr", None)

    # -------------------------------------------------------------- properties
    def train_batch_size(self):
        return self._config.train_batch_size

    def train_micro_batch_size_per_gpu(self):
        return self._config.train_micro_batch_size_per_gpu

    def gradient_accumulation_steps(self):
        return self._config.gradient_accumulation_steps

    def zero_optimization_stage(self):
        return self.zero_stage

    def zero_optimization(self):
        return self.zero_stage > 0

    def fp16_enabled(self):
        return self._config.fp16_enabled

    def bfloat16_enabled(self):
        return self._config.bfloat16_enabled

    def gradient_clipping(self):
        return self._config.gradient_clipping

    @property
    def cur_scale(self):
        return self.loss_scaler.cur_scale

    def get_lr(self):
        if self._pending_client_lr is not None:
            return [self._pending_client_lr]
        if self.lr_scheduler is not None and hasattr(self.lr_scheduler,
                                                     "get_lr"):
            return [float(self.lr_scheduler.get_lr(max(1,
                                                       self.global_steps)))]
        return [None]

    def _scheduler_reclaims_lr(self):
        """An engine-managed scheduler rewrites the lr every step, so a
        one-off client lr write lasts until the scheduler's next step."""
        if self._pending_client_lr is None:
            return
        self._pending_client_lr = None
        if self.opt_state is not None:
            self.opt_state.lr_override = float("nan")

    def _set_client_lr(self, value):
        """A torch-API ``param_groups[0]["lr"]`` write → the state's
        ``lr_override``."""
        self._pending_client_lr = value
        if self.opt_state is not None:
            self.opt_state.lr_override = float(value)

    def is_gradient_accumulation_boundary(self):
        return (self.micro_steps + 1) % self.gradient_accumulation_steps() \
            == 0

    def train(self, mode=True):
        self.training = mode
        self.module.train(mode)
        return self

    def eval(self):
        return self.train(False)

    def parameter_names(self):
        return [name for name, *_ in self._layout]

    def get_fp32_param(self, name):
        """The fp32 value of one leaf (the master's, when mixed)."""
        src = self.master if self.master is not None else self.params
        for n, off, numel, shape in self._layout:
            if n == name:
                return src[off:off + numel].view(shape).float()
        raise KeyError(name)

    # ------------------------------------------------------------- public API
    def _to_device(self, x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        return x.to(self.device) if isinstance(x, torch.Tensor) else x

    def _check_params(self):
        if self.params is None:
            raise RuntimeError(
                "engine has no parameters — pass model_parameters to "
                "initialize() or call engine.initialize_parameters(seed) "
                "first")

    def forward(self, *inputs, **kwargs):
        """Reference ``engine.py:1848``: the model's loss.  In training mode
        the graph is kept for :meth:`backward`; in eval mode no graph is
        built."""
        self._check_params()
        inputs = [self._to_device(x) for x in inputs]
        kwargs = {k: self._to_device(v) for k, v in kwargs.items()}
        if not self.training:
            with torch.no_grad():
                return self.module(*inputs, **kwargs)
        scaled, loss = self._loss_fn(self.cur_scale, *inputs, **kwargs)
        self._pending_loss = scaled
        return loss

    __call__ = forward

    def backward(self, loss=None, **kwargs):
        """Reference ``engine.py:2007``: autograd of the stashed, scaled
        loss, then the gradients, cast to ``grad_accum_dtype``, are folded
        into the flat accumulator."""
        if self._pending_loss is None:
            raise RuntimeError("backward() called without a prior forward() "
                               "in training mode")
        self._pending_loss.backward()
        self._pending_loss = None
        if self.grad_acc is None:
            self.grad_acc = torch.zeros(self.params.numel(),
                                        dtype=self.grad_accum_dtype,
                                        device=self.device)
        params = dict(self.module.named_parameters())
        with torch.no_grad():
            for name, off, n, _ in self._layout:
                p = params[name]
                view = self.grad_acc[off:off + n]
                if p.grad is None:
                    if self._acc_fresh:
                        view.zero_()
                    continue
                g = p.grad.reshape(-1)
                if self._acc_fresh:
                    view.copy_(g)
                else:
                    view.add_(g.to(self.grad_accum_dtype))
                p.grad = None
        self._acc_fresh = False
        return loss

    def step(self, use_kernel=True):
        """Reference ``engine.py:2204``: the update at the accumulation
        boundary.  ``use_kernel=False`` runs kernel B2's plain version leaf
        by leaf (``chip_smoke.py`` compares the two on the card)."""
        self._check_params()
        if self.is_gradient_accumulation_boundary():
            if self._acc_fresh:
                raise RuntimeError("step() at a grad-accum boundary without "
                                   "any backward() since the last boundary")
            grads = self.grad_acc
            gnorm = global_grad_norm([grads])
            clip = self._config.gradient_clipping
            coef = clip_coefficient(gnorm, clip) if clip and clip > 0 \
                else None
            mixed = self.master is not None
            self._transform.step(
                grads, self.opt_state, self.master if mixed else self.params,
                param_out=self.params if mixed else None, grad_scale=coef,
                leaves=None if use_kernel else
                [(off, n) for _, off, n, _ in self._layout])
            self._acc_fresh = True
            self._last_gnorm = gnorm
            self.global_steps += 1
            self.global_samples += self.train_batch_size()
            if self.lr_scheduler is not None and hasattr(self.lr_scheduler,
                                                         "step"):
                self.lr_scheduler.step()
                self._scheduler_reclaims_lr()
        self.micro_steps += 1

    def train_batch(self, data_iter=None):
        """Forward, backward and step over one accumulation window; returns
        the mean loss (an fp32 tensor)."""
        if data_iter is None:
            raise not_ported("train_batch() without data_iter (the "
                             "dataloader)", 4)
        losses = []
        for _ in range(self.gradient_accumulation_steps()):
            batch = next(data_iter)
            if not isinstance(batch, (tuple, list)):
                batch = (batch, )
            loss = self.forward(*batch)
            self.backward(loss)
            self.step()
            losses.append(loss.detach().float())
        return torch.stack(losses).mean()

    def save_checkpoint(self, *args, **kwargs):
        raise not_ported("save_checkpoint", 5)

    def load_checkpoint(self, *args, **kwargs):
        raise not_ported("load_checkpoint", 5)
