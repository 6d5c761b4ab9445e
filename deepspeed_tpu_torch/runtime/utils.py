"""Runtime utilities (the port of ``deepspeed_tpu/runtime/utils.py``):
``global_grad_norm`` (:11), the coefficient of
``clip_grads_by_global_norm`` (:21), ``make_scaled_loss_fn`` (:153),
``count_parameters`` and the pipeline's ``partition_uniform`` /
``partition_balanced`` (:32, :42, copies).  The engine clips by handing the coefficient to the
optimizer kernel, so no pass scales the gradients themselves."""

import numpy as np
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


def partition_uniform(num_items, num_parts):
    """Reference ``partition_uniform``: balanced contiguous split boundaries."""
    parts = [0] * (num_parts + 1)
    chunk = num_items // num_parts
    residual = num_items % num_parts
    for p in range(num_parts):
        parts[p + 1] = parts[p] + chunk + (1 if p < residual else 0)
    return parts


def partition_balanced(weights, num_parts):
    """Reference ``partition_balanced``: split so max part weight is minimized
    (prefix-sum + binary search).  Weights should be positive integers (the
    limit search is integral) — scale float weights up first."""
    n = len(weights)
    prefix = np.concatenate([[0], np.cumsum(weights)])

    def can(limit):
        parts, last, count = [0], 0, 0
        for i in range(1, n + 1):
            if prefix[i] - prefix[last] > limit:
                if i - 1 == last:
                    return None
                parts.append(i - 1)
                last = i - 1
                count += 1
                if count >= num_parts:
                    return None
        parts.append(n)
        return parts if len(parts) <= num_parts + 1 else None

    lo = max(weights) if n else 0
    hi = int(prefix[-1]) or 1
    best = None
    while lo <= hi:
        mid = (lo + hi) // 2
        p = can(mid)
        if p is not None:
            best = p
            hi = mid - 1
        else:
            lo = mid + 1
    if best is None:
        return partition_uniform(n, num_parts)
    # pad to exactly num_parts+1 boundaries
    while len(best) < num_parts + 1:
        best.append(n)
    if n >= num_parts:
        # The greedy packer may use fewer parts than requested, leaving
        # empty trailing parts (repeated boundaries) — an empty PIPELINE
        # STAGE downstream.  Borrow one item from the left neighbor for
        # each empty part, back to front: the shrunken neighbor can only
        # get lighter and the new 1-item part weighs ≤ max(weights) ≤ the
        # found bottleneck, so optimality is preserved.
        for i in range(num_parts - 1, 0, -1):
            if best[i] >= best[i + 1]:
                best[i] = best[i + 1] - 1
    return best
