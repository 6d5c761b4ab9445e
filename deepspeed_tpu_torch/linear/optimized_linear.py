"""OptimizedLinear (reference ``linear/optimized_linear.py:18``; the port of
``deepspeed_tpu/linear/optimized_linear.py``): a linear layer for
memory-efficient fine-tuning, a frozen base weight, optionally
fake-quantized, plus trainable LoRA adapters
``y = x·W + (alpha/r)·(x·A)·B``.

The weights keep the JAX package's layout and names (``kernel`` [in, out],
``lora_a`` [in, r], ``lora_b`` [r, out], ``bias`` [out]), so
:func:`params_from_flax` carries a flax ``OptimizedLinear``'s params
across as they are.  The quantized variant fake-quantizes the base through
``compression/quantizers.py:fake_quantize`` (integer, straight-through;
it ignores ``q_dtype``, as in JAX).  ``base_weight_sharding > 1`` needs
the comm layer and raises.

:func:`init_lora`, :func:`merge_lora` and :func:`unmerge_lora` are the
functional path over a nested dict/list of tensors: split off the
adapters of the 2-D kernels whose path names a target module, and fold
them in or out.
"""

import math

import numpy as np
import torch
from torch import nn

from ..compression.quantizers import fake_quantize
from ..models.llama import torch_dtype
from ..utils.not_ported import not_ported
from .config import LoRAConfig, QuantizationConfig
from .quantization import map_with_path, path_leaves


class OptimizedLinear(nn.Module):
    """Drop-in linear; LoRA + optional weight quantization.

    Reference semantics (``LoRAOptimizedLinear.forward``): the base is
    frozen (no gradient); adapters start at A uniform in ±sqrt(1/in) and
    B zeros, so the initial output equals the base linear's.  ``dtype``
    is the compute dtype; the parameters are fp32, as in JAX."""

    def __init__(self, input_dim, output_dim, lora_config: LoRAConfig = None,
                 quantization_config: QuantizationConfig = None, bias=False,
                 dtype="float32", device=None):
        super().__init__()
        cfg = lora_config or LoRAConfig()
        if cfg.base_weight_sharding > 1:
            raise not_ported("OptimizedLinear base_weight_sharding > 1 (the "
                             "base weight sharded over the data-parallel "
                             "ranks)", 2)
        self.lora_config = cfg
        self.quantization_config = quantization_config
        self.dtype = torch_dtype(dtype)
        f32 = dict(dtype=torch.float32, device=device)
        kernel = torch.empty(input_dim, output_dim, **f32)
        # flax lecun_normal: truncated normal of std sqrt(1/in), cut at ±2
        # before its rescale by 1/0.87962566
        nn.init.trunc_normal_(kernel, std=1.0, a=-2.0, b=2.0)
        kernel.mul_(math.sqrt(1.0 / input_dim) / 0.87962566103423978)
        self.kernel = nn.Parameter(kernel, requires_grad=False)
        bound = math.sqrt(1.0 / input_dim)
        self.lora_a = nn.Parameter(torch.empty(input_dim, cfg.lora_r, **f32)
                                   .uniform_(-bound, bound))
        self.lora_b = nn.Parameter(torch.zeros(cfg.lora_r, output_dim,
                                               **f32))
        self.bias = (nn.Parameter(torch.zeros(output_dim, **f32))
                     if bias else None)

    def forward(self, x):
        kernel = self.kernel
        qc = self.quantization_config
        if qc is not None:
            kernel = fake_quantize(kernel, qc.q_bits, True,
                                   max(1, kernel.numel() // qc.group_size))
        dt = self.dtype
        xd = x.to(dt)
        out = xd @ kernel.detach().to(dt)         # the frozen base
        scaling = self.lora_config.lora_alpha / self.lora_config.lora_r
        out = out + (scaling * (xd @ self.lora_a.to(dt))) @ self.lora_b.to(dt)
        if self.bias is not None:
            out = out + self.bias.to(dt)
        return out


def params_from_flax(tree, device="cpu"):
    """A flax ``OptimizedLinear``'s params (numpy or jax arrays) → the
    module's state dict: the same names and layouts, fp32."""
    return {name: torch.tensor(np.asarray(a, dtype=np.float32),
                               device=device)
            for name, a in tree.items()}


def init_lora(params, lora_config: LoRAConfig = None, generator=None):
    """Functional LoRA init over a nested dict/list of tensors: for each 2-D
    kernel whose path names one of ``target_mods``, a (lora_a, lora_b)
    pair (A uniform in ±sqrt(1/in), B zeros, so the merged weight starts
    equal to the base).  Returns ``{path: {"lora_a": A, "lora_b": B}}``.
    ``generator`` (a ``torch.Generator``, default seed 0) draws the A's;
    its numbers are not ``jax.random``'s."""
    cfg = lora_config or LoRAConfig()
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    out = {}
    for path, x in path_leaves(params):
        if getattr(x, "ndim", 0) != 2 or \
                not any(t in path for t in cfg.target_mods):
            continue
        bound = math.sqrt(1.0 / x.shape[0])
        a = torch.empty(x.shape[0], cfg.lora_r).uniform_(
            -bound, bound, generator=generator).to(x.device)
        b = torch.zeros(cfg.lora_r, x.shape[1], device=x.device)
        out[path] = {"lora_a": a, "lora_b": b}
    return out


def _fold(params, lora_params, lora_config, sign):
    cfg = lora_config or LoRAConfig()
    scaling = cfg.lora_alpha / cfg.lora_r

    def fold(path, p):
        lp = lora_params.get(path)
        if lp is None:
            return p
        delta = (scaling * lp["lora_a"].float()) @ lp["lora_b"].float()
        return (p.float() + sign * delta).to(p.dtype)

    return map_with_path(fold, params)


def merge_lora(params, lora_params, lora_config: LoRAConfig = None):
    """Fold adapters into the base weights (the hybrid-engine 'fuse_lora'
    path, reference ``runtime/hybrid_engine.py:132``).  ``lora_params`` is
    the path-keyed dict from :func:`init_lora`."""
    return _fold(params, lora_params, lora_config, 1.0)


def unmerge_lora(params, lora_params, lora_config: LoRAConfig = None):
    """Inverse of :func:`merge_lora` (hybrid-engine 'unfuse_lora',
    reference ``runtime/hybrid_engine.py:146``)."""
    return _fold(params, lora_params, lora_config, -1.0)
