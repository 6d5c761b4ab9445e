"""Fused Adam(W) step: the hand-written CUDA kernel's wrapper and its plain
PyTorch version.

Replaces the Pallas TPU kernel ``deepspeed_tpu/ops/pallas/optimizers.py``
``fused_adam_step`` (:79, kernel body ``_adam_kernel`` :60): one pass that
reads the gradient and the fp32 master, m and v, and writes master, m, v and
the bf16 copy of the parameter.  The kernel is ``csrc/optimizers.cu``, built
by ``ops/op_builder.py`` and called through ctypes on PyTorch's current
stream.

Where the Pallas kernel is called once per leaf, the port's step is one
launch over ALL leaves: the engine keeps every leaf's state in one flat
buffer per kind (``runtime/engine.py``), so the wrapper takes flat 1-D
tensors and needs no pointer table.  What bounds it on an H100: bytes, 30
per element with an fp32 gradient.

On CPU tensors :func:`fused_adam_step` computes :func:`fused_adam_step_plain`
on the one flat leaf; on CUDA tensors it launches the kernel or raises.
``fused_adam_step.launches`` counts kernel launches.
"""

import numpy as np
import torch

from ..op_builder import OptimizersBuilder

_GRAD_CODES = {torch.float32: 0, torch.bfloat16: 1}


def bias_corrections(beta1, beta2, count, bias_correction=True):
    """(c1, c2) = (1 - beta1**count, 1 - beta2**count) in fp32, as
    ``fused_adam_step`` forms them (1 when bias correction is off)."""
    if not bias_correction:
        return 1.0, 1.0
    one, cf = np.float32(1.0), np.float32(count)
    return (float(one - np.float32(beta1)**cf),
            float(one - np.float32(beta2)**cf))


def fused_adam_step_plain(grads, masters, exp_avgs, exp_avg_sqs,
                          params_out=None, *, lr, beta1, beta2, eps,
                          weight_decay, count, adam_w_mode=True,
                          bias_correction=True, grad_scale=None):
    """The kernel's step, leaf by leaf, in place: lists of gradients (fp32
    or bf16), fp32 masters, m and v, and optionally the tensors that get the
    new master in their own dtype.  Every product and sum is its own fp32
    op, in ``_adam_kernel``'s order (so the kernel, which contracts nothing
    into FMAs, gives the same bits).  ``grad_scale``: a 0-dim fp32 tensor
    that multiplies the gradient (the clip coefficient), or None."""
    c1, c2 = bias_corrections(beta1, beta2, count, bias_correction)
    outs = params_out if params_out is not None else [None] * len(grads)
    for g, p, m, v, out in zip(grads, masters, exp_avgs, exp_avg_sqs, outs):
        # 0-dim fp32 tensors on the leaf's device: PyTorch divides by a
        # host scalar as a product with its reciprocal, by a tensor exactly
        b1, b2, lr_, eps_, wd, c1_, c2_ = (
            torch.tensor(x, dtype=torch.float32, device=p.device)
            for x in (beta1, beta2, lr, eps, weight_decay, c1, c2))
        g = g.float()
        if grad_scale is not None:
            g = g * grad_scale.to(p.device)
        if not adam_w_mode:
            g = g + wd * p
        m.copy_(b1 * m + (1.0 - b1) * g)
        v.copy_(b2 * v + ((1.0 - b2) * g) * g)
        step = (m / c1_) / (torch.sqrt(v / c2_) + eps_)
        if adam_w_mode:
            step = step + wd * p
        p.copy_(p - lr_ * step)
        if out is not None:
            out.copy_(p)


def fused_adam_step(grad, master, exp_avg, exp_avg_sq, param_out=None, *,
                    lr, beta1, beta2, eps, weight_decay, count,
                    adam_w_mode=True, bias_correction=True, grad_scale=None):
    """One Adam(W) (or L2, ``adam_w_mode=False``) step over flat 1-D
    buffers, in place.  ``grad``: fp32 or bf16; ``master``, ``exp_avg``,
    ``exp_avg_sq``: fp32; ``param_out``: bf16 buffer that gets the new
    master (or None); ``count``: the 1-based step; ``grad_scale``: a 0-dim
    fp32 tensor on the same device multiplying the gradient, or None."""
    bufs = (("grad", grad), ("master", master), ("exp_avg", exp_avg),
            ("exp_avg_sq", exp_avg_sq))
    if param_out is not None:
        bufs += (("param_out", param_out), )
    n = master.numel()
    for name, t in bufs:
        if t.dim() != 1 or t.numel() != n:
            raise ValueError(f"{name} must be a flat buffer of {n} elements, "
                             f"got {tuple(t.shape)}")
    devices = {t.device for _, t in bufs}
    if len(devices) != 1:
        raise ValueError(f"buffers on several devices: {devices}")
    device = master.device.type
    hyper = dict(lr=lr, beta1=beta1, beta2=beta2, eps=eps,
                 weight_decay=weight_decay, count=count,
                 adam_w_mode=adam_w_mode, bias_correction=bias_correction,
                 grad_scale=grad_scale)
    if device == "cpu":
        fused_adam_step_plain([grad], [master], [exp_avg], [exp_avg_sq],
                              None if param_out is None else [param_out],
                              **hyper)
        return
    if device != "cuda":
        raise ValueError(f"fused Adam runs on cpu or cuda, not {device}")
    if grad.dtype not in _GRAD_CODES:
        raise TypeError(f"fused Adam kernel takes an fp32 or bf16 gradient, "
                        f"got {grad.dtype}")
    for name, t in bufs[1:4]:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be fp32, got {t.dtype}")
    if param_out is not None and param_out.dtype != torch.bfloat16:
        raise TypeError(f"param_out must be bf16, got {param_out.dtype}")
    for name, t in bufs:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if grad_scale is not None and (grad_scale.numel() != 1 or
                                   grad_scale.dtype != torch.float32 or
                                   grad_scale.device != master.device):
        raise ValueError("grad_scale must be one fp32 value on the card")
    if n == 0:
        return
    c1, c2 = bias_corrections(beta1, beta2, count, bias_correction)
    lib = OptimizersBuilder().load()
    with torch.cuda.device(master.device):
        err = lib.ds_fused_adam(
            grad.data_ptr(), _GRAD_CODES[grad.dtype], master.data_ptr(),
            exp_avg.data_ptr(), exp_avg_sq.data_ptr(),
            None if param_out is None else param_out.data_ptr(),
            None if grad_scale is None else grad_scale.data_ptr(), n,
            float(lr), float(beta1), float(beta2), float(eps),
            float(weight_decay), c1, c2, int(bool(adam_w_mode)),
            torch.cuda.current_stream(master.device).cuda_stream)
    if err:
        raise RuntimeError(f"fused Adam kernel launch failed: "
                           f"{lib.ds_cuda_error_string(err).decode()} ({err})")
    fused_adam_step.launches += 1


fused_adam_step.launches = 0
