"""Quantized parameter container (reference ``linear/quantization.py``
``QuantizedParameter``; the port of ``deepspeed_tpu/linear/
quantization.py``): weights stored quantized with per-group scales,
dequantized on use.

Formats (reference parametrization ``q_bits``/``mantissa_bits``):
  * ``q_dtype="int"``: symmetric int8/int4 through the blockwise quantizer
    (kernel B5, ``ops/kernels/quantizer.py``);
  * ``q_dtype="fp"``, or ``q_bits`` 6 or 12: FP8 e4m3 / FP6 e3m2 / FP12
    e4m7 through ``ops/fp_quantizer.py`` (kernel B6 for FP6 and FP12):
    6-bit weights pack 4 → 3 bytes, 0.75 B a value.
"""

import torch

from ..ops.fp_quantizer import dequantize_fp, quantize_fp
from ..ops.quantizer import dequantize_blockwise, quantize_blockwise
from .config import QuantizationConfig


class QuantizedParameter:
    """Container: quantize once, ``dequantized()`` per use.  2× (int8) or
    2.7× (fp6) less memory than bf16 for frozen base weights."""

    # canonical mantissa widths: fp8 = e4m3, fp6 = e3m2 (FP6-LLM),
    # fp12 = e4m7.  The config's mantissa_bits (default 3) applies to
    # 8-bit; narrower formats use their canonical layout or packed buffers
    # would decode under the wrong bit split.
    _CANONICAL_MANTISSA = {6: 2, 12: 7}

    def __init__(self, data, quant_config: QuantizationConfig = None):
        self.quant_config = quant_config or QuantizationConfig()
        cfg = self.quant_config
        data = torch.as_tensor(data)
        self._fp = getattr(cfg, "q_dtype", "int") == "fp" or cfg.q_bits in (6,
                                                                          12)
        if self._fp:
            mantissa = self._CANONICAL_MANTISSA.get(cfg.q_bits,
                                                    cfg.mantissa_bits)
            self.q, self.scales, self.meta = quantize_fp(
                data, q_bits=cfg.q_bits, mantissa_bits=mantissa,
                group_size=cfg.group_size)
        else:
            self.q, self.scales, self.meta = quantize_blockwise(
                data, num_bits=cfg.q_bits, group_size=cfg.group_size)

    def dequantized(self):
        if self._fp:
            return dequantize_fp(self.q, self.scales, self.meta)
        return dequantize_blockwise(self.q, self.scales, self.meta)

    @property
    def shape(self):
        return self.meta[0]


def path_leaves(tree, prefix=()):
    """(path, leaf) of nested dicts, lists and tuples, the path as 'a/b/0'
    (the JAX package's ``path_str`` of a key path)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from path_leaves(v, prefix + (str(k), ))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from path_leaves(v, prefix + (str(i), ))
    else:
        yield "/".join(prefix), tree


def map_with_path(fn, tree, prefix=()):
    """The same nesting with each leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, prefix + (str(k), ))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, prefix + (str(i), ))
                          for i, v in enumerate(tree))
    return fn("/".join(prefix), tree)


def quantize_param_tree(tree, quant_config=None, predicate=None):
    """Quantize the leaves of two or more dimensions of a nested dict/list
    of tensors (the JAX layout) into :class:`QuantizedParameter` holders;
    other leaves, and those ``predicate`` refuses, stay as they are."""

    def q(_, x):
        if predicate is not None and not predicate(x):
            return x
        if getattr(x, "ndim", 0) < 2:
            return x
        return QuantizedParameter(x, quant_config)

    return map_with_path(q, tree)
