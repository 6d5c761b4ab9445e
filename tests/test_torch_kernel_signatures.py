"""The port's kernel entry points keep the JAX functions' signatures:
parameter names, order, kinds and defaults, by ``inspect.signature``.  A
positional argument then means the same thing in both packages (JAX's
``flash_attention`` takes ``block_q`` sixth, where the port once took
``window``).  The tile sizes the port accepts but does not use are
checked."""

import importlib
import inspect

import pytest
import torch

from deepspeed_tpu.ops import fp_quantizer as jax_fp
from deepspeed_tpu_torch.ops import fp_quantizer as port_fp
from deepspeed_tpu_torch.ops.kernels import block_sparse_attention as port_bs
from deepspeed_tpu_torch.ops.kernels import flash_attention as port_fa
from deepspeed_tpu_torch.ops.kernels import flash_bias as port_fb

# the modules (``deepspeed_tpu.ops.pallas`` re-exports functions of the
# same names over them)
jax_fa, jax_fb, jax_bs = (
    importlib.import_module(f"deepspeed_tpu.ops.pallas.{m}")
    for m in ("flash_attention", "flash_bias", "block_sparse_attention"))

PAIRS = {
    "flash_attention": (jax_fa.flash_attention, port_fa.flash_attention),
    "flash_attention_plain": (jax_fa.flash_attention,
                              port_fa.flash_attention_plain),
    "flash_attention_bias": (jax_fb.flash_attention_bias,
                             port_fb.flash_attention_bias),
    "flash_attention_bias_plain": (jax_fb.flash_attention_bias,
                                   port_fb.flash_attention_bias_plain),
    "block_sparse_flash_attention": (jax_bs.block_sparse_flash_attention,
                                     port_bs.block_sparse_flash_attention),
    "quantize_fp": (jax_fp.quantize_fp, port_fp.quantize_fp),
    "dequantize_fp": (jax_fp.dequantize_fp, port_fp.dequantize_fp),
}


def _params(fn):
    return [(p.name, p.kind, p.default)
            for p in inspect.signature(fn).parameters.values()]


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_signature_equals_jax(name):
    jax_fn, port_fn = PAIRS[name]
    assert _params(port_fn) == _params(jax_fn)


@pytest.mark.parametrize("fn", [port_fa.flash_attention,
                                port_fa.flash_attention_plain])
def test_flash_attention_tiles_are_checked_and_inert(fn):
    """Any valid tile gives the same result; JAX's sixth positional
    argument is ``block_q``, not the window."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 40, 2, 16, generator=g) for _ in range(3))
    ref = fn(q, k, v, True)
    for tiles in ((16, 16), (None, None), (512, 64)):
        assert torch.equal(fn(q, k, v, True, None, *tiles), ref)
    windowed = fn(q, k, v, True, None, 512, 512, 8)
    assert torch.equal(windowed, fn(q, k, v, causal=True, window=8))
    assert not torch.equal(windowed, ref)
    for bad in (0, -16, 16.0, True, "64"):
        with pytest.raises(ValueError, match="block_q"):
            fn(q, k, v, True, None, bad)
        with pytest.raises(ValueError, match="block_k"):
            fn(q, k, v, block_k=bad)


@pytest.mark.parametrize("fn", [port_fb.flash_attention_bias,
                                port_fb.flash_attention_bias_plain])
def test_flash_bias_tiles_are_checked_and_inert(fn):
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(2, 24, 2, 8, generator=g) for _ in range(3))
    bias = torch.randn(1, 2, 24, 24, generator=g)
    ref = fn(q, k, v, bias)
    assert torch.equal(fn(q, k, v, bias, None, False, None, 32, None), ref)
    with pytest.raises(ValueError, match="block_q"):
        fn(q, k, v, bias, block_q=0)
    with pytest.raises(ValueError, match="block_k"):
        fn(q, k, v, bias, None, False, None, 256, 2.5)
