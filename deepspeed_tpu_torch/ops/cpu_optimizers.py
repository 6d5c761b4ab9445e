"""Host (CPU) optimizers for offload (the port of
``deepspeed_tpu/ops/cpu_optimizers.py``; reference
``deepspeed/ops/adam/cpu_adam.py`` ``DeepSpeedCPUAdam``, and Adagrad and
Lion).

The kernels are the JAX package's own host C++
(``csrc/host/cpu_optimizers.cpp``, a copy; OpenMP ``parallel for simd``),
built with g++ by ``ops/op_builder.py:CPUOptimizersBuilder`` at first use
and called through ctypes.  They update contiguous fp32 CPU tensors in
place and can write the new parameter's bf16 bits into ``bf16_out`` (a
``torch.bfloat16`` tensor) in the same pass.  Beside each kernel stands
its plain PyTorch version (``*_plain``), in the kernel's order of
operations (the kernel may contract products into FMAs, so the two agree
to rounding, not bit for bit).
"""

import ctypes

import numpy as np
import torch

from .op_builder import CPUOptimizersBuilder


def _lib():
    return CPUOptimizersBuilder().load()


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _check(name, t, n, dtype=torch.float32):
    if not isinstance(t, torch.Tensor) or t.device.type != "cpu" or \
            t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} CPU tensor")
    if t.numel() != n:
        raise ValueError(f"{name} size {t.numel()} != {n}")


def _checked(param, bufs, bf16_out):
    n = param.numel()
    _check("param", param, n)
    for name, t in bufs:
        _check(name, t, n)
    if bf16_out is not None:
        _check("bf16_out", bf16_out, n, torch.bfloat16)
    return n


class DeepSpeedCPUAdam:
    """In-place host Adam/AdamW (reference ``ops/adam/cpu_adam.py:18``).
    Each :meth:`step` call advances ``step_count`` by one; a sweep over
    several buffers that shares one bias-correction step sets
    ``step_count`` before each call (``runtime/zero/infinity.py``)."""

    def __init__(self, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0, adamw_mode=True):
        self._lib = _lib()
        self.lr = lr
        self.betas = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.adamw_mode = adamw_mode
        self.step_count = 0

    def step(self, param, grad, exp_avg, exp_avg_sq, bf16_out=None, lr=None):
        n = _checked(param, [("grad", grad), ("exp_avg", exp_avg),
                             ("exp_avg_sq", exp_avg_sq)], bf16_out)
        self.step_count += 1
        self._lib.ds_cpu_adam_step(
            _ptr(param), _ptr(grad), _ptr(exp_avg), _ptr(exp_avg_sq), n,
            float(lr if lr is not None else self.lr), float(self.betas[0]),
            float(self.betas[1]), float(self.eps), float(self.weight_decay),
            self.step_count, int(self.adamw_mode),
            _ptr(bf16_out) if bf16_out is not None else None)


class DeepSpeedCPUAdagrad:

    def __init__(self, lr=1e-2, eps=1e-10, weight_decay=0.0):
        self._lib = _lib()
        self.lr = lr
        self.eps = eps
        self.weight_decay = weight_decay

    def step(self, param, grad, state_sum, bf16_out=None, lr=None):
        n = _checked(param, [("grad", grad), ("state_sum", state_sum)],
                     bf16_out)
        self._lib.ds_cpu_adagrad_step(
            _ptr(param), _ptr(grad), _ptr(state_sum), n,
            float(lr if lr is not None else self.lr), float(self.eps),
            float(self.weight_decay),
            _ptr(bf16_out) if bf16_out is not None else None)


class DeepSpeedCPULion:

    def __init__(self, lr=1e-4, betas=(0.9, 0.99), weight_decay=0.0):
        self._lib = _lib()
        self.lr = lr
        self.betas = betas
        self.weight_decay = weight_decay

    def step(self, param, grad, exp_avg, bf16_out=None, lr=None):
        n = _checked(param, [("grad", grad), ("exp_avg", exp_avg)], bf16_out)
        self._lib.ds_cpu_lion_step(
            _ptr(param), _ptr(grad), _ptr(exp_avg), n,
            float(lr if lr is not None else self.lr), float(self.betas[0]),
            float(self.betas[1]), float(self.weight_decay),
            _ptr(bf16_out) if bf16_out is not None else None)


def set_host_threads(n):
    """Run the host kernels that this thread calls on ``n`` OpenMP
    threads (``omp_set_num_threads`` of the library's OpenMP runtime)."""
    _lib().omp_set_num_threads(int(n))


def cpu_sq_norm(grad):
    """Σ g² in double precision over a contiguous fp32 CPU tensor."""
    _check("grad", grad, grad.numel())
    return float(_lib().ds_cpu_sq_norm(_ptr(grad), grad.numel()))


# ------------------------------------------------------------------ plain
def _f(x):
    return torch.tensor(np.float32(x))


def cpu_adam_step_plain(param, grad, exp_avg, exp_avg_sq, bf16_out=None, *,
                        lr, beta1, beta2, eps, weight_decay, step,
                        adamw_mode=True):
    """``ds_cpu_adam_step``'s arithmetic on fp32 tensors, in place."""
    b1, b2, lr_, wd = _f(beta1), _f(beta2), _f(lr), _f(weight_decay)
    bc1 = 1.0 - torch.pow(b1, step)
    bc2_sqrt = torch.sqrt(1.0 - torch.pow(b2, step))
    g, p = grad.clone(), param.clone()
    if weight_decay != 0.0:
        if adamw_mode:
            p = p - lr_ * wd * p
        else:
            g = g + wd * p
    exp_avg.copy_(b1 * exp_avg + (1.0 - b1) * g)
    exp_avg_sq.copy_(b2 * exp_avg_sq + (1.0 - b2) * g * g)
    p = p - (lr_ / bc1) * exp_avg / (torch.sqrt(exp_avg_sq) / bc2_sqrt +
                                     _f(eps))
    param.copy_(p)
    if bf16_out is not None:
        bf16_out.copy_(p)


def cpu_adagrad_step_plain(param, grad, state_sum, bf16_out=None, *, lr, eps,
                           weight_decay):
    """``ds_cpu_adagrad_step``'s arithmetic, in place."""
    g = grad + _f(weight_decay) * param if weight_decay != 0.0 else grad
    state_sum.add_(g * g)
    param.sub_(_f(lr) * g / (torch.sqrt(state_sum) + _f(eps)))
    if bf16_out is not None:
        bf16_out.copy_(param)


def cpu_lion_step_plain(param, grad, exp_avg, bf16_out=None, *, lr, beta1,
                        beta2, weight_decay):
    """``ds_cpu_lion_step``'s arithmetic, in place."""
    b1, b2, lr_ = _f(beta1), _f(beta2), _f(lr)
    c = b1 * exp_avg + (1.0 - b1) * grad
    p = param - lr_ * _f(weight_decay) * param
    param.copy_(p - lr_ * torch.sign(c))
    exp_avg.copy_(b2 * exp_avg + (1.0 - b2) * grad)
    if bf16_out is not None:
        bf16_out.copy_(param)


def cpu_sq_norm_plain(grad):
    return float(grad.double().square().sum())
