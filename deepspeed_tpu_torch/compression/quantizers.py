"""Quantization-aware-training fake-quantizer (the port of
``deepspeed_tpu/compression/quantizers.py:17 fake_quantize``; reference
``compression/basic_layer.py`` quantize functions + ``utils.py``).

Straight-through: the backward is the identity, so QAT gradients flow, as
the reference's autograd Functions and the JAX package's custom VJP do.
Per-group quantization reshapes to (groups, -1) like the reference's
``quantize_groups``.  Plain PyTorch, as it is XLA code in JAX.
"""

import torch


def _fq_impl(x, bits, symmetric, num_groups):
    orig_shape, orig_dtype = x.shape, x.dtype
    flat = x.reshape(-1).float()
    n = flat.shape[0]
    g = max(1, min(num_groups, n))
    pad = (-n) % g
    # edge-pad: zero padding would pollute the last group's min/max range
    if pad:
        flat = torch.cat([flat, flat[-1:].expand(pad)])
    grp = flat.reshape(g, -1)
    # 0-dim tensors, not Python floats: on the card PyTorch divides by a
    # host scalar as a product with its reciprocal, by a tensor truly
    if symmetric:
        qmax = torch.tensor(2.0**(bits - 1) - 1, device=x.device)
        scale = torch.clamp_min(grp.abs().amax(dim=1, keepdim=True),
                                1e-8) / qmax
        q = torch.clamp(torch.round(grp / scale), -qmax, qmax)
        out = q * scale
    else:
        levels = torch.tensor(2.0**bits - 1, device=x.device)
        lo = grp.amin(dim=1, keepdim=True)
        hi = grp.amax(dim=1, keepdim=True)
        scale = torch.clamp_min(hi - lo, 1e-8) / levels
        q = torch.clamp(torch.round((grp - lo) / scale), 0, levels)
        out = q * scale + lo
    return out.reshape(-1)[:n].reshape(orig_shape).to(orig_dtype)


class _FakeQuantize(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, bits, symmetric, num_groups):
        return _fq_impl(x, bits, symmetric, num_groups)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


def fake_quantize(x, bits, symmetric=True, num_groups=1):
    """Quantize-dequantize ``x`` to ``bits`` with a straight-through
    gradient: per group of ``x.numel() / num_groups`` (the flattened
    tensor, edge-padded), symmetric absmax or asymmetric min/max."""
    return _FakeQuantize.apply(x, bits, symmetric, num_groups)
