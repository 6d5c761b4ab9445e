"""Weight-only quantized serving (reference ``inference/quantization``; the
port of ``deepspeed_tpu/inference/quant_serving.py``).

Every float weight with two or more dimensions (projections, the embedding,
the LM head, a MoE router gate and expert stacks) is held between steps as
blockwise int8 (int4 in int8 storage) plus one fp32 scale per group of 128
elements.  The ragged step dequantizes each weight just before its product
(:func:`weight`), so no full-precision copy of the model lives beside the
quantized one.

Groups follow the JAX tree's row-major layout: a linear layer's JAX kernel
is ``[in, out]`` where ``nn.Linear`` keeps ``[out, in]``, so it is quantized
as ``weight.t()``; the embedding and the stacked experts already lie as in
JAX.  Dequantization rounds to the weight's original dtype and then to the
serving dtype, as ``dequantize_tree`` does.
"""

import torch
from torch import nn

from ..ops.kernels.quantizer import (dequantize_blockwise,
                                     dequantize_blockwise_plain,
                                     quantize_blockwise)
from ..utils.logging import log_dist
from .config import LANE_GROUP

#: quantization_mode spellings (reference config_v2.py) → bits
MODES = {"int8": 8, "int4": 4, "q8": 8, "q4": 4}


def resolve_mode(mode):
    """quantization_mode string → bits, or a clear error for modes whose
    wire format is not served (e.g. the reference's CUDA-only ``wf6af16``
    FP6 path)."""
    if mode is None:
        return None
    bits = MODES.get(str(mode).lower())
    if bits is None:
        raise NotImplementedError(
            f"quantization_mode={mode!r} is not served here; supported: "
            f"{sorted(MODES)} (fp6/fp8 wire formats exist in "
            "ops/fp_quantizer but only int4/int8 serving is wired)")
    return bits


class QuantizedWeight(nn.Module):
    """A weight held as ``q`` int8 ``[groups, gs]`` and ``scales`` fp32
    ``[groups]`` (buffers, so they follow the module across devices).
    ``meta = (shape, dtype, groups)`` of the quantized tensor in its JAX
    layout; ``transposed``: the module's own layout is that tensor's
    transpose (a linear layer's ``[out, in]``)."""

    def __init__(self, q, scales, meta, dtype, transposed):
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("scales", scales)
        self.meta = meta
        self.serving_dtype = dtype
        self.transposed = transposed

    def dequantize(self, use_kernel=True):
        """The weight in the original dtype, then in the serving dtype
        (``dequantize_tree``'s two casts), in the module's layout."""
        fn = dequantize_blockwise if use_kernel else dequantize_blockwise_plain
        w = fn(self.q, self.scales, self.meta).to(self.serving_dtype)
        return w.t() if self.transposed else w


def weight(t, use_kernel=True):
    """A resident weight as it is; a :class:`QuantizedWeight` dequantized
    now (the kernel, or its plain version with ``use_kernel=False``)."""
    if isinstance(t, QuantizedWeight):
        return t.dequantize(use_kernel)
    return t


def _owner(model, name):
    *path, leaf = name.split(".")
    mod = model
    for p in path:
        mod = getattr(mod, p)
    return mod, leaf


def _replace(owner, leaf, new):
    delattr(owner, leaf)
    setattr(owner, leaf, new)


@torch.no_grad()
def quantize_tree(model, bits, dtype):
    """Replace every float parameter of ``model`` with two or more
    dimensions by a :class:`QuantizedWeight` serving ``dtype`` (groups of
    ``LANE_GROUP``), one at a time (each full-precision tensor is freed as
    soon as its copy exists).  With a tied head the LM head shares the
    embedding's quantized copy, as the JAX tree has no head leaf then.
    Returns ``{name: meta}``."""
    tied = getattr(model.config, "tie_word_embeddings", False)
    names = [n for n, p in model.named_parameters()
             if p.dim() >= 2 and p.is_floating_point()
             and not (tied and n == "lm_head.weight")]
    metas = {}
    for name in names:
        owner, leaf = _owner(model, name)
        transposed = isinstance(owner, nn.Linear)
        p = getattr(owner, leaf)
        q, s, meta = quantize_blockwise(p.t() if transposed else p, bits,
                                        LANE_GROUP)
        del p
        _replace(owner, leaf, QuantizedWeight(q, s, meta, dtype, transposed))
        metas[name] = meta
    if tied:
        _replace(model.lm_head, "weight", model.model.embed_tokens.weight)
    log_dist(f"weight-only quant: {len(metas)} weight tensors stored as "
             f"int{bits} wire format", ranks=[0])
    return metas


def dequantize_tree(model, use_kernel=True):
    """Every quantized weight of ``model``, dequantized:
    ``{name: tensor}`` in the JAX layout (the tests hold it against the
    JAX package's ``dequantize_tree``)."""
    out = {}
    for name, mod in model.named_modules(remove_duplicate=False):
        if isinstance(mod, QuantizedWeight):
            w = mod.dequantize(use_kernel)
            out[name] = w.t() if mod.transposed else w
    return out


def resident_bytes(model):
    """Bytes of the weights kept between steps (int8 values, fp32 scales
    and every weight that stays in full precision)."""
    return sum(t.numel() * t.element_size()
               for t in list(model.parameters()) + list(model.buffers()))
