"""The port's ``linear/`` (OptimizedLinear, LoRA helpers, quantized
parameter trees) and ``compression/quantizers.py:fake_quantize`` against
the JAX package's, on the CPU, on the same numpy inputs and weights.

- ``quantize_param_tree`` over a ``llama_tiny`` tree in the flax layout:
  every ``dequantized()`` leaf equals JAX's bit for bit for FP6 and FP12
  (kernel B6's plain version) and int8 (B5's), fp32 and bf16 trees, but
  for the three FP12 codes of the bf16 tree that lie at JAX's exp2(-13)
  margin (``tests/test_torch_fp_quantizer.py``), held exactly; the leaves
  of fewer than two dims stay as they are.
- ``OptimizedLinear`` with and without ``quantization_config``, through
  ``params_from_flax``: outputs and gradients against the flax module's,
  2e-5 absolute and relative in fp32 (the same products, summed in another
  order).  The frozen base gets no gradient (JAX: zeros).
- ``fake_quantize``: bit for bit, and a straight-through gradient.
- ``init_lora`` / ``merge_lora`` / ``unmerge_lora``: the same adapter keys
  and shapes; merging JAX's own adapters gives JAX's weights within 1e-6
  (a rank-r product in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu import linear as jax_linear
from deepspeed_tpu.compression.quantizers import \
    fake_quantize as jax_fake_quantize
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu.ops import fp_quantizer as jax_fp
from deepspeed_tpu_torch import linear as port_linear
from deepspeed_tpu_torch.compression import fake_quantize
from deepspeed_tpu_torch.linear.optimized_linear import params_from_flax
from deepspeed_tpu_torch.ops.kernels import fp_quantizer as port_kfp

from test_torch_fp_quantizer import _codes_apart_at_jax_exp2_margin
from test_torch_llama_serving import _flax_tree

TOL = dict(atol=2e-5, rtol=2e-5)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q", [dict(q_dtype="fp", q_bits=6),
                               dict(q_dtype="fp", q_bits=12),
                               dict(q_bits=12), dict(q_bits=8)],
                         ids=["fp6", "fp12", "fp12_by_bits", "int8"])
def test_quantize_param_tree_dequantizes_as_jax(q, dtype):
    cfg = jax_llama.llama_tiny(dtype="float32", remat=False)
    tree = _flax_tree(cfg, 3)
    jtree = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), tree)
    ttree = jax.tree_util.tree_map(
        lambda a: torch.tensor(np.asarray(a.astype(jnp.float32))).to(
            getattr(torch, dtype)), jtree)
    jq = jax_linear.quantize_param_tree(jtree, jax_linear.QuantizationConfig(
        **q))
    before = port_kfp.quantize_fp_packed.launches
    pq = port_linear.quantize_param_tree(
        ttree, port_linear.QuantizationConfig(**q))
    assert port_kfp.quantize_fp_packed.launches == before   # CPU: plain
    n_quantized = apart = 0
    for (path, j), (_, p), (_, x) in zip(_leaves(jq), _leaves(pq),
                                         _leaves(ttree)):
        if not isinstance(j, jax_linear.QuantizedParameter):
            assert p is x and p.dim() < 2
            continue
        assert isinstance(p, port_linear.QuantizedParameter), path
        assert p.shape == tuple(j.shape) and p._fp == j._fp
        got = p.dequantized()
        assert got.dtype == getattr(torch, dtype), path
        want = j.dequantized()
        if p._fp:
            # scales bit for bit; codes too, but at JAX's exp2 margin
            # (e4m7 only: tests/test_torch_fp_quantizer.py); the port's
            # bytes dequantized by JAX give the port's tensor bit for bit
            np.testing.assert_array_equal(p.scales.numpy(),
                                          np.asarray(j.scales))
            n = _codes_apart_at_jax_exp2_margin(
                p.q, j.q, p.scales, x, *p.meta[3:5], p.meta[5])
            apart += n
            if n:
                want = jax_fp.dequantize_fp(jnp.asarray(p.q.numpy()),
                                            jnp.asarray(p.scales.numpy()),
                                            j.meta)
        np.testing.assert_array_equal(
            got.float().numpy(), np.asarray(want.astype(jnp.float32)),
            err_msg=path)
        n_quantized += 1
    assert n_quantized == 2 + 7 * cfg.num_hidden_layers
    # codes apart from JAX's: the fp32 tree reaches no margin; the bf16
    # tree's FP12 codes reach it 3 times (counted, not hidden)
    assert apart == (3 if (q.get("q_bits") == 12 and dtype == "bfloat16")
                     else 0), apart


def test_quantized_parameter_roundtrip_and_tree_structure():
    """JAX's ``tests/unit/linear`` cases on the port."""
    w = np.random.default_rng(3).standard_normal((64, 64)).astype(np.float32)
    qp = port_linear.QuantizedParameter(torch.tensor(w))
    deq = qp.dequantized().numpy()
    assert deq.shape == (64, 64)
    assert np.abs(deq - w).max() <= np.abs(w).max() / 127
    tree = {"a": {"kernel": torch.ones(32, 32), "bias": torch.ones(32)},
            "b": [torch.ones(4, 128), torch.ones(3)]}
    qt = port_linear.quantize_param_tree(tree)
    assert isinstance(qt["a"]["kernel"], port_linear.QuantizedParameter)
    assert qt["a"]["bias"].shape == (32, )         # 1-D untouched
    assert isinstance(qt["b"][0], port_linear.QuantizedParameter)
    assert qt["b"][1] is tree["b"][1]
    skip = port_linear.quantize_param_tree(tree, predicate=lambda x: False)
    assert skip["a"]["kernel"] is tree["a"]["kernel"]
    fp6 = port_linear.QuantizedParameter(
        torch.tensor(w), port_linear.QuantizationConfig(q_bits=6))
    assert fp6.meta[3:5] == (6, 2) and fp6.q.numel() * 4 == w.size * 3


@pytest.mark.parametrize("symmetric", [True, False], ids=["sym", "asym"])
@pytest.mark.parametrize("bits,groups", [(8, 1), (4, 3), (8, 7)])
def test_fake_quantize_matches_jax(bits, groups, symmetric):
    x = (np.random.default_rng(bits + groups).standard_normal((10, 13))
         * 2).astype(np.float32)
    want, vjp = jax.vjp(lambda t: jax_fake_quantize(t, bits, symmetric,
                                                    groups), jnp.asarray(x))
    t = torch.tensor(x, requires_grad=True)
    got = fake_quantize(t, bits, symmetric, groups)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    g = np.random.default_rng(0).standard_normal(x.shape).astype(np.float32)
    got.backward(torch.tensor(g))
    np.testing.assert_array_equal(t.grad.numpy(), g)
    np.testing.assert_array_equal(np.asarray(vjp(jnp.asarray(g))[0]), g)


def _flax_linear(seed, in_dim, out_dim, bias, qc):
    """A flax OptimizedLinear's params with lora_b made non-zero, so the
    adapter path shows in outputs and gradients."""
    m = jax_linear.OptimizedLinear(
        output_dim=out_dim, lora_config=jax_linear.LoRAConfig(lora_r=4),
        quantization_config=qc, bias=bias)
    x = jnp.zeros((1, in_dim))
    params = dict(m.init(jax.random.PRNGKey(seed), x)["params"])
    rng = np.random.default_rng(seed)
    params["lora_b"] = jnp.asarray(rng.standard_normal((4, out_dim)) * 0.1,
                                   jnp.float32)
    if bias:
        params["bias"] = jnp.asarray(rng.standard_normal(out_dim),
                                     jnp.float32)
    return m, params


@pytest.mark.parametrize("bias", [False, True], ids=["", "bias"])
@pytest.mark.parametrize("quant", [None, 8, 4], ids=["fp", "q8", "q4"])
def test_optimized_linear_matches_flax(quant, bias):
    in_dim, out_dim = 48, 24
    jqc = (None if quant is None
           else jax_linear.QuantizationConfig(q_bits=quant, group_size=128))
    m, params = _flax_linear(quant or 0, in_dim, out_dim, bias, jqc)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, in_dim)).astype(np.float32)
    do = rng.standard_normal((3, 5, out_dim)).astype(np.float32)
    out, vjp = jax.vjp(lambda p, x: m.apply({"params": p}, x), params,
                       jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(do))

    pqc = (None if quant is None
           else port_linear.QuantizationConfig(q_bits=quant, group_size=128))
    pm = port_linear.OptimizedLinear(
        in_dim, out_dim, lora_config=port_linear.LoRAConfig(lora_r=4),
        quantization_config=pqc, bias=bias)
    pm.load_state_dict(params_from_flax(params))
    xt = torch.tensor(x, requires_grad=True)
    got = pm(xt)
    got.backward(torch.tensor(do))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **TOL)
    for name in ("lora_a", "lora_b") + (("bias", ) if bias else ()):
        np.testing.assert_allclose(getattr(pm, name).grad.numpy(),
                                   np.asarray(gp[name]), err_msg=name, **TOL)
    assert pm.kernel.grad is None and not np.asarray(gp["kernel"]).any()
    if quant is not None:      # the base really is fake-quantized
        plain = port_linear.OptimizedLinear(
            in_dim, out_dim, lora_config=port_linear.LoRAConfig(lora_r=4),
            bias=bias)
        plain.load_state_dict(params_from_flax(params))
        assert not torch.allclose(plain(xt), got)


def test_optimized_linear_init_and_refusals():
    """At init B = 0: the output equals the base linear's.  The sharded
    base needs the comm layer."""
    torch.manual_seed(0)
    m = port_linear.OptimizedLinear(16, 32, port_linear.LoRAConfig(lora_r=8))
    x = torch.randn(4, 16)
    torch.testing.assert_close(m(x), x @ m.kernel, atol=1e-6, rtol=0)
    assert not m.kernel.requires_grad and m.lora_a.requires_grad
    assert m.lora_a.abs().max() <= 16 ** -0.5
    with pytest.raises(NotImplementedError, match="item 2"):
        port_linear.OptimizedLinear(
            16, 32, port_linear.LoRAConfig(base_weight_sharding=2))


def test_init_merge_unmerge_lora_match_jax():
    base = np.random.default_rng(4).standard_normal((16, 16)).astype(
        np.float32)
    jparams = {"blk": {"q_proj": {"kernel": jnp.asarray(base)},
                       "ln": {"scale": jnp.ones(16)}}}
    pparams = {"blk": {"q_proj": {"kernel": torch.tensor(base)},
                       "ln": {"scale": torch.ones(16)}}}
    cfg = dict(lora_r=4, target_mods=["q_proj"])
    jlora = jax_linear.init_lora(jparams, jax_linear.LoRAConfig(**cfg))
    plora = port_linear.init_lora(pparams, port_linear.LoRAConfig(**cfg))
    assert list(plora) == list(jlora) == ["blk/q_proj/kernel"]
    a, b = plora["blk/q_proj/kernel"]["lora_a"], \
        plora["blk/q_proj/kernel"]["lora_b"]
    assert a.shape == (16, 4) and b.shape == (4, 16) and not b.any()
    assert a.abs().max() <= 0.25
    merged = port_linear.merge_lora(pparams, plora)     # B = 0: identity
    assert torch.equal(merged["blk"]["q_proj"]["kernel"], torch.tensor(base))
    # JAX's adapters, B nudged, merged by both
    jlora["blk/q_proj/kernel"]["lora_b"] = jnp.ones((4, 16)) * 0.1
    tlora = {"blk/q_proj/kernel": {
        k: torch.tensor(np.asarray(v))
        for k, v in jlora["blk/q_proj/kernel"].items()}}
    jmerged = jax_linear.merge_lora(jparams, jlora)
    pmerged = port_linear.merge_lora(pparams, tlora)
    np.testing.assert_allclose(pmerged["blk"]["q_proj"]["kernel"].numpy(),
                               np.asarray(jmerged["blk"]["q_proj"]["kernel"]),
                               atol=1e-6, rtol=0)
    assert pmerged["blk"]["ln"]["scale"] is pparams["blk"]["ln"]["scale"]
    back = port_linear.unmerge_lora(pmerged, tlora)
    jback = jax_linear.unmerge_lora(jmerged, jlora)
    np.testing.assert_allclose(back["blk"]["q_proj"]["kernel"].numpy(),
                               np.asarray(jback["blk"]["q_proj"]["kernel"]),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(back["blk"]["q_proj"]["kernel"].numpy(), base,
                               atol=1e-5)
