"""DeepSpeedEngine, ZeRO stage 0 (the port of
``deepspeed_tpu/runtime/engine.py``; reference ``runtime/engine.py:183``).

The JAX engine owns a jitted train step over a mesh; this one owns a torch
module on one CUDA card (or, asked by name, the CPU):

* parameters (``_install_parameters``, ``engine.py:494-528``): every leaf
  in the compute dtype (bf16, fp16 or fp32; norm weights and the LM head
  too), laid out in ONE flat buffer whose slices become the module's
  parameters; with bf16 or fp16 an fp32 master of the same layout is kept.
  The gradient accumulator and the optimizer's state share that layout, so
  the boundary update is one launch of an optimizer kernel over all leaves
  (B2 Adam, B8 Lion) or one per phase (B3 LAMB).
* ``forward`` runs the model and keeps the graph; ``backward`` runs
  autograd on the loss times the loss scale and folds the micro-step's
  gradients, cast to ``grad_accum_dtype``, into the accumulator
  (``engine.py:1302-1305``, ``:1444-1448``).  The JAX engine computes the
  gradients inside ``forward`` (one ``value_and_grad`` program) and only
  folds them in ``backward``; here the backward pass itself runs in
  ``backward``.
* ``step`` at the accumulation boundary, in ``engine.py:1469-1535``'s
  order: unscale by 1/scale, the overflow check on the unscaled gradient
  (fp16 or the finite-grad guard), global norm, the guard's spike test,
  clip, optimizer, skip, scaler update.  The unscale and the clip
  coefficient ride into the optimizer kernel as one device scalar, so they
  cost no pass of their own.  On a skipped step the JAX engine computes the
  update and selects the old state (``:1496-1501``); here the flag is read
  on the host once per boundary (only when fp16 or the guard is on, as the
  JAX guard syncs at ``:1584``) and nothing is launched: the master, the
  moments, the optimizer's count and so its lr stay as they were.
"""

import numpy as np
import torch

from ..accelerator import resolve_device
from ..ops.adam import FlatTransform, fused_adam
from ..ops.lamb import fused_lamb
from ..ops.lion import fused_lion, sgd
from ..utils.logging import log_dist, logger
from ..utils.not_ported import not_ported
from .config import (ADAM_OPTIMIZERS, ADAMW_OPTIMIZER, FUSED_ADAM_OPTIMIZER,
                     FUSED_LAMB_OPTIMIZER, LAMB_OPTIMIZER, LION_OPTIMIZER,
                     SGD_OPTIMIZER, DeepSpeedConfig)
from .loss_scaler import create_loss_scaler, has_overflow
from .lr_schedules import get_lr_scheduler
from .utils import (clip_coefficient, count_parameters, global_grad_norm,
                    make_scaled_loss_fn)

_ALIGN = 16   # elements: every leaf starts 64-byte aligned in fp32 buffers
_ACCUM_DTYPES = {None: torch.float32, "fp32": torch.float32,
                 "bf16": torch.bfloat16, "fp16": torch.float16}


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


def _optimizer_from_config(name, p, lr_fn):
    """The JAX engine's config → optimizer dispatch (``engine.py:598-634``),
    with its defaults; keys it does not read are not read here either."""
    lr = p.pop("lr", 1e-3)
    if name in ADAM_OPTIMIZERS:
        adam_w = p.pop("adam_w_mode", name in (ADAMW_OPTIMIZER,
                                               FUSED_ADAM_OPTIMIZER))
        return fused_adam(
            lr=lr, betas=tuple(p.pop("betas", (0.9, 0.999))),
            eps=p.pop("eps", 1e-8), weight_decay=p.pop("weight_decay", 0.0),
            adam_w_mode=adam_w, bias_correction=p.pop("bias_correction", True),
            lr_fn=lr_fn)
    if name in (LAMB_OPTIMIZER, FUSED_LAMB_OPTIMIZER):
        return fused_lamb(
            lr=lr, betas=tuple(p.pop("betas", (0.9, 0.999))),
            eps=p.pop("eps", 1e-8), weight_decay=p.pop("weight_decay", 0.0),
            max_coeff=p.pop("max_coeff", 10.0),
            min_coeff=p.pop("min_coeff", 0.01), lr_fn=lr_fn)
    if name == LION_OPTIMIZER:
        return fused_lion(lr=lr, betas=tuple(p.pop("betas", (0.9, 0.99))),
                          weight_decay=p.pop("weight_decay", 0.0),
                          lr_fn=lr_fn)
    if name == SGD_OPTIMIZER:
        return sgd(lr=lr, momentum=p.pop("momentum", 0.0),
                   weight_decay=p.pop("weight_decay", 0.0), lr_fn=lr_fn)
    raise ValueError(f"unsupported optimizer {name!r}")


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
                              else torch.float16 if config.fp16_enabled
                              else torch.float32)
        self.loss_scaler = create_loss_scaler(config.fp16_enabled,
                                              config.loss_scale,
                                              config.dynamic_loss_scale_args)
        self.scale_state = self.loss_scaler.init()
        self.skipped_steps = 0
        self._finite_guard = config.finite_grads_config
        self._consecutive_skips = 0
        self._gnorm_ema = None   # host-side running mean for spike detection
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
        self._last_skipped = False
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
            self._init_opt_state()
        return self.module

    def _configure_optimizer(self, client_optimizer):
        """Reference ``_configure_optimizer`` (``engine.py:559``; the JAX
        dispatch ``:595-634``): the config's adam/adamw/fusedadam,
        lamb/fusedlamb, lion or sgd, or a client transform of
        ``ops.adam``/``ops.lamb``/``ops.lion``."""
        cfg = self._config
        lr_fn = None
        if cfg.scheduler_name is not None:
            self._sched_for_lr = get_lr_scheduler(cfg.scheduler_name,
                                                  cfg.scheduler_params)
            lr_fn = self._sched_for_lr.get_lr
        if client_optimizer is not None:
            if not isinstance(client_optimizer, FlatTransform):
                raise not_ported("a client optimizer other than the port's "
                                 "FusedAdam, FusedLamb, FusedLion or sgd", 11)
            self._transform = client_optimizer
        elif cfg.optimizer_name is not None:
            self._transform = _optimizer_from_config(
                cfg.optimizer_name, dict(cfg.optimizer_params or {}), lr_fn)
        else:
            self._transform = fused_adam(lr=1e-3, lr_fn=lr_fn)
        if self._transform.lr_fn is None and lr_fn is not None:
            self._transform.lr_fn = lr_fn
        self.optimizer = _OptimizerFacade(self)
        if self.params is not None:
            self._init_opt_state()

    def _init_opt_state(self):
        self.opt_state = self._transform.init(
            self._target(), [(o, n) for _, o, n, _ in self._layout])
        if self._pending_client_lr is not None:
            self._set_client_lr(self._pending_client_lr)

    def _target(self):
        """The fp32 buffer the optimizer updates: the master when mixed."""
        return self.master if self.master is not None else self.params

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
        """The loss scale of the next micro-step (``engine.py:973``)."""
        return self.scale_state.scale

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
        boundary, in ``engine.py:1469-1535``'s order.  ``use_kernel=False``
        runs the optimizer kernel's plain version leaf by leaf
        (``chip_smoke.py`` compares the two on the card)."""
        self._check_params()
        if self.is_gradient_accumulation_boundary():
            if self._acc_fresh:
                raise RuntimeError("step() at a grad-accum boundary without "
                                   "any backward() since the last boundary")
            self._apply_update(use_kernel)
            self._acc_fresh = True
            self.global_steps += 1
            self.global_samples += self.train_batch_size()
            if self.lr_scheduler is not None and hasattr(self.lr_scheduler,
                                                         "step"):
                self.lr_scheduler.step()
                self._scheduler_reclaims_lr()
        self.micro_steps += 1

    def _apply_update(self, use_kernel):
        """Unscale, overflow check, global norm, spike test, clip,
        optimizer, skip, scaler update (``engine.py:1469-1535``)."""
        fp16, guard = self._config.fp16_enabled, self._finite_guard.enabled
        grads = self.grad_acc
        inv = np.float32(1.0) / np.float32(self.scale_state.scale)
        # the norm of the unscaled gradient: 1/scale is a power of two for
        # the dynamic scaler, so the product is exact
        gnorm = global_grad_norm([grads])
        if inv != 1:
            gnorm = gnorm * torch.tensor(inv, device=gnorm.device)
        overflow = skip = False
        if fp16 or guard:
            # one host sync per boundary, only when a step can be skipped
            flags = has_overflow([grads])
            if guard:
                flags = torch.stack([flags, gnorm > self._spike_limit()])
            flags = flags.cpu()
            overflow = bool(flags.reshape(-1)[0])
            skip = bool(flags.any())
        if not skip:
            clip = self._config.gradient_clipping
            scale = (clip_coefficient(gnorm, clip) if clip and clip > 0
                     else None)
            if inv != 1:
                inv_t = torch.tensor(inv, device=gnorm.device)
                scale = inv_t if scale is None else scale * inv_t
            mixed = self.master is not None
            self._transform.step(grads, self.opt_state, self._target(),
                                 param_out=self.params if mixed else None,
                                 grad_scale=scale, use_kernel=use_kernel)
        # loss-scale dynamics key off true fp16 overflow only — a grad-norm
        # spike must not shrink the scale
        self.scale_state = self.loss_scaler.update(self.scale_state,
                                                   overflow)
        if fp16 and skip:
            self.skipped_steps += 1
        if guard:
            self._account_guarded_step(skip, gnorm)
        self._last_gnorm = gnorm
        self._last_skipped = skip

    def _spike_limit(self):
        """Grad-norm ceiling for the current step (``engine.py:1565``):
        ``spike_factor ×`` the running mean of recent healthy grad norms,
        +inf while disabled or warming up."""
        g = self._finite_guard
        if (not g.enabled or g.grad_norm_spike_factor <= 0
                or self._gnorm_ema is None
                or self.global_steps < g.spike_warmup_steps):
            return float("inf")
        return float(np.float32(g.grad_norm_spike_factor * self._gnorm_ema))

    def _account_guarded_step(self, skipped, gnorm):
        """Host-side consecutive-skip bookkeeping of the finite-grad guard
        (``engine.py:1577``): aborts when skips persist, since skipping
        forever turns a poisoned input pipeline into a run that 'finishes'
        without having trained."""
        g = self._finite_guard
        gn = float(gnorm)
        if not skipped:
            self._consecutive_skips = 0
            if np.isfinite(gn):
                self._gnorm_ema = (gn if self._gnorm_ema is None
                                   else 0.9 * self._gnorm_ema + 0.1 * gn)
            return
        self._consecutive_skips += 1
        logger.warning(
            "finite-grad guard: skipped poisoned step %d (grad norm %s, "
            "%d consecutive skip(s), abort at %d)", self.global_steps + 1,
            gn, self._consecutive_skips, g.max_consecutive_skips)
        if self._consecutive_skips >= g.max_consecutive_skips:
            raise RuntimeError(
                f"finite-grad guard: {self._consecutive_skips} consecutive "
                f"steps produced non-finite or spiking gradients (last "
                f"grad norm {gn}, step {self.global_steps + 1}) — the "
                "input pipeline or numerics are poisoned, not transient; "
                "aborting so the supervisor can restart from the last "
                "valid checkpoint. Raise resilience.check_finite_grads."
                "max_consecutive_skips if this is expected.")

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
