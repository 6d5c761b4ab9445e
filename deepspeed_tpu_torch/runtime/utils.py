"""Runtime utilities (the port of ``deepspeed_tpu/runtime/utils.py``):
``global_grad_norm`` (:11), the coefficient of
``clip_grads_by_global_norm`` (:21), ``make_scaled_loss_fn`` (:153) and
``count_parameters``.  The engine clips by handing the coefficient to the
optimizer kernel, so no pass scales the gradients themselves."""

import torch


def global_grad_norm(grads):
    """L2 norm over gradient tensors, accumulated in fp32 (a 0-dim tensor);
    no squared copy of a gradient is made."""
    grads = [g for g in grads if g is not None]
    if not grads:
        return torch.zeros((), dtype=torch.float32)
    norms = [torch.linalg.vector_norm(g, dtype=torch.float32) for g in grads]
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_coefficient(norm, max_norm):
    """``min(1, max_norm / (norm + 1e-6))`` as a 0-dim fp32 tensor on the
    norm's device; 1 when it is not finite (the overflow path handles
    those steps)."""
    coef = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return torch.where(torch.isfinite(coef), coef, torch.ones_like(coef))


def make_scaled_loss_fn(apply_fn, gas):
    """The loss-scaling convention of every micro-step: the model's loss in
    fp32, times the loss scale, over the gradient-accumulation steps
    (reference engine.backward :2023).  Returns (scaled, raw)."""

    def loss_fn(scale, *inputs, **kwargs):
        out = apply_fn(*inputs, **kwargs)
        loss = out[0] if isinstance(out, (tuple, list)) else out
        return loss.float() * scale / gas, loss

    return loss_fn


def count_parameters(params):
    """Element count over tensors (or a module's parameters)."""
    if isinstance(params, torch.nn.Module):
        params = params.parameters()
    return sum(p.numel() for p in params)
