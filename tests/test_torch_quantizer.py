"""The port's blockwise quantizer (B5's plain versions, what the CUDA
kernels are held to on the card) and its weight-only quantized serving
(``quantization_mode``) against the JAX package's, on the CPU.

The quantizer must be bit-identical: the same groups of the row-major
flatten, the same fp32 absmax, the same true division and round-half-to-even,
so ``q``, the scales and ``meta`` agree exactly on the valid groups (the JAX
package pads its group count to a Pallas row block; the port pads only the
last group).  Serving: every dequantized weight equals the JAX engine's
``dequantize_tree`` leaf bit for bit, which holds only if each leaf was
quantized in its JAX layout (a linear layer's ``[in, out]``) and rounded to
its original dtype, then to the serving dtype; greedy tokens must then be
identical to the JAX quantized engine's (fp32 serving).
"""

import weakref

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepspeed_tpu.inference.quant_serving import \
    dequantize_tree as jax_dequantize_tree
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu.models import mixtral as jax_mixtral
from deepspeed_tpu.ops.pallas import quantizer as jax_q
from deepspeed_tpu_torch.inference import quant_serving
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
from deepspeed_tpu_torch.models import llama as port_llama
from deepspeed_tpu_torch.models import mixtral as port_mixtral
from deepspeed_tpu_torch.ops import quantizer as port_q
from deepspeed_tpu_torch.ops.kernels import quantizer as port_kq

from test_torch_llama_serving import _flax_tree as _llama_tree
from test_torch_mixtral_serving import _flax_tree as _mixtral_tree


def _bf16(a):
    """numpy fp32 values rounded to bf16 (by JAX) and back."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


# ------------------------------------------------------------ quantizer
def _quant_input(bits, group_size, dtype):
    """A [37, 300] tensor (11,100 elements: the last group partial), with
    an all-zero group (scale 1) and exact halves (round half to even)."""
    r = np.random.default_rng(bits + group_size)
    x = r.standard_normal((37, 300)).astype(np.float32) * 3.0
    x[2, :] = 0.0
    x.reshape(-1)[:128] = 0.0                      # one all-zero group
    x.reshape(-1)[128:136] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 63.5, -127]
    if dtype == "bfloat16":
        x = _bf16(x)
    return (jnp.asarray(x, getattr(jnp, dtype)),
            torch.from_numpy(x.copy()).to(getattr(torch, dtype)))


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["xla", "pallas_interpret"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("group_size", [128, 2048])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_quantize_matches_jax(use_pallas, bits, group_size, dtype):
    """Against the XLA path (the one JAX serving runs off the TPU, and the
    semantics the CUDA kernel implements): ``q``, scales, ``meta`` and the
    dequantized tensor bit for bit.  The Pallas kernel in interpret mode
    computes its scale as ``absmax · fl(1/qmax)`` instead of
    ``absmax / qmax`` (checked below), so there the scales agree bit for
    bit wherever those two roundings agree, ``q`` agrees bit for bit in
    those groups and by at most 1 in the others; its dequantization of its
    own ``q`` and scales is bit-identical to the port's."""
    xj, xt = _quant_input(bits, group_size, dtype)
    qj, sj, mj = jax_q.quantize_blockwise(xj, bits, group_size,
                                          use_pallas=use_pallas)
    qt, st, mt = port_q.quantize_blockwise(xt, bits, group_size)
    groups = mj[2]
    qj, sj = np.asarray(qj)[:groups], np.asarray(sj)[:groups]
    assert mt == (tuple(mj[0]), xt.dtype, groups)
    assert qt.dtype == torch.int8 and qt.shape == qj.shape
    qmax = 127 if bits == 8 else 7
    assert int(qt.abs().max()) == qmax
    if use_pallas:
        recip = np.float32(1.0) / np.float32(qmax)
        flat = np.zeros(groups * qj.shape[1], np.float32)
        flat[:xt.numel()] = xt.float().reshape(-1).numpy()
        absmax = np.abs(flat.reshape(groups, -1)).max(axis=1)
        np.testing.assert_array_equal(
            sj, np.where(absmax == 0, np.float32(1), absmax * recip))
        same = sj == st.numpy()
        np.testing.assert_array_equal(qt.numpy()[same], qj[same])
        assert np.abs(qt.numpy().astype(int) - qj).max() <= 1
        qt, st = torch.from_numpy(qj.copy()), torch.from_numpy(sj.copy())
    else:
        np.testing.assert_array_equal(qt.numpy(), qj)
        np.testing.assert_array_equal(st.numpy(), sj)
    dj = jax_q.dequantize_blockwise(jnp.asarray(qt.numpy()),
                                    jnp.asarray(st.numpy()), mj,
                                    use_pallas=use_pallas)
    dt = port_q.dequantize_blockwise(qt, st, mt)
    assert dt.dtype == xt.dtype and dt.shape == xt.shape
    np.testing.assert_array_equal(dt.float().numpy(),
                                  np.asarray(dj.astype(jnp.float32)))


def test_quantizer_wrappers_on_the_cpu():
    """On CPU tensors the wrappers are their plain versions and launch
    nothing; a non-float input is refused."""
    x = torch.randn(5, 256, generator=torch.Generator().manual_seed(0))
    q, s, meta = port_kq.quantize_blockwise(x, 8, 128)
    ref = port_kq.quantize_blockwise_plain(x, 8, 128)
    assert torch.equal(q, ref[0]) and torch.equal(s, ref[1])
    assert meta == ref[2] == ((5, 256), torch.float32, 10)
    assert port_kq.quantize_blockwise.launches == 0
    assert port_kq.dequantize_blockwise.launches == 0
    with pytest.raises(TypeError, match="float"):
        port_kq.quantize_blockwise(torch.ones(4, dtype=torch.int32))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("group_size", [128, 256])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_transposed_and_contiguous_inputs_match_jax(bits, group_size, dtype):
    """A weight as ``nn.Linear`` keeps it ([out, in]) handed over as
    ``p.t()`` (the transposed route's input on the card), and the same
    values contiguous, both give JAX's ``quantize_blockwise`` of the [in,
    out] kernel (XLA path) bit for bit."""
    r = np.random.default_rng(bits + group_size)
    p = r.standard_normal((512, 136)).astype(np.float32) * 3.0   # [out, in]
    p[:group_size, 5] = 0.0                  # an all-zero group
    p[:4, 7] = [127.0, 63.5, -0.5, 2.5]      # absmax 127: ties at int8
    if dtype == "bfloat16":
        p = _bf16(p)
    kernel = np.ascontiguousarray(p.T)       # the JAX layout [in, out]
    qj, sj, mj = jax_q.quantize_blockwise(
        jnp.asarray(kernel, getattr(jnp, dtype)), bits, group_size,
        use_pallas=False)
    pt = torch.from_numpy(p.copy()).to(getattr(torch, dtype))
    for x in (pt.t(), pt.t().contiguous()):
        q, sc, meta = port_kq.quantize_blockwise(x, bits, group_size)
        groups = meta[2]
        assert meta[0] == tuple(mj[0]) == (136, 512) and groups == mj[2]
        np.testing.assert_array_equal(q.numpy(), np.asarray(qj)[:groups])
        np.testing.assert_array_equal(sc.numpy(), np.asarray(sj)[:groups])


def test_quantize_route_rule():
    """One rule on shapes, strides, dtype and address: ``p.t()`` of a
    row-major weight is read as it lies where its groups tile ``out`` and
    its rows are 16-byte aligned (all 225 ``nn.Linear`` weights of
    Llama-2-7B, the fp32 LM head too); contiguous tensors are contiguous;
    any other layout is copied."""
    route = port_kq.quantize_route
    bf16, fp16, fp32 = torch.bfloat16, torch.float16, torch.float32
    p = torch.zeros(11008, 4096, dtype=bf16)             # [out, in]
    t = p.t()
    assert route(tuple(t.shape), t.stride(), bf16, 0, 128) == "transposed"
    assert route(tuple(t.shape), t.stride(), fp16, 64, 256) == "transposed"
    assert route(tuple(p.shape), p.stride(), bf16, 0, 128) == "contiguous"
    assert route((8, 4096, 14336), (4096 * 14336, 14336, 1), bf16, 8,
                 128) == "contiguous"                    # unaligned: still
    # the fp32 LM head [32000, 4096] as its p.t(): 16-byte rows of 4096
    assert route((4096, 32000), (1, 4096), fp32, 0, 128) == "transposed"
    assert route((4098, 32000), (1, 4098), fp32, 0, 128) == "copy"
    assert route((4100, 32000), (1, 4100), fp32, 0, 128) == "transposed"
    assert route((4096, 11008), (1, 4096), torch.float64, 0, 128) == "copy"
    assert route((4096, 11008), (1, 4096), bf16, 8, 128) == "copy"
    assert route((4096, 11008), (1, 4096), bf16, 0, 2048) == "copy"
    assert route((4096, 11000), (1, 4096), bf16, 0, 128) == "copy"  # out
    assert route((4100, 11008), (1, 4100), bf16, 0, 128) == "copy"  # in
    s = p[:, ::2]
    assert route(tuple(s.shape), s.stride(), bf16, 0, 128) == "copy"
    # group_size is clamped as the JAX package clamps it (300 → 256)
    assert route(tuple(t.shape), t.stride(), bf16, 0, 300) == "transposed"


def _fake_quant_lib(monkeypatch):
    calls = []

    class Lib:
        def ds_quantize_blockwise(self, *args):
            calls.append(("contiguous", args))
            return 0

        def ds_quantize_blockwise_t(self, *args):
            calls.append(("transposed", args))
            return 0

    monkeypatch.setattr(port_kq.QuantizerBuilder, "load", lambda self: Lib())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: __import__("contextlib").nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: type("S", (), {"cuda_stream": 0})())
    return calls


def test_launch_hands_a_transposed_weight_over_as_it_lies(monkeypatch):
    """The transposed route hands the C entry p's own pointer, ``out`` and
    ``in`` (p's shape), the group and qmax, and makes no contiguous copy;
    the contiguous route hands the element and group counts; the copy
    route copies first."""
    calls = _fake_quant_lib(monkeypatch)
    p = torch.randn(512, 136).to(torch.bfloat16)
    copies = []
    real = torch.Tensor.contiguous

    def counted(self, *a, **k):
        copies.append(tuple(self.shape))
        return real(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "contiguous", counted)
    q, sc, meta, route = port_kq._launch_quantize(p.t(), 8, 128)
    assert route == "transposed" and copies == []
    (kind, args), = calls
    assert kind == "transposed"
    assert args[:2] == (p.data_ptr(), 1)
    assert args[2:4] == (q.data_ptr(), sc.data_ptr())
    assert args[4:8] == (512, 136, 128, 127.0)
    assert q.shape == (136 * 4, 128) and sc.shape == (136 * 4, )
    assert meta == ((136, 512), torch.bfloat16, 544)

    calls.clear()
    _, _, _, route = port_kq._launch_quantize(p, 4, 256)
    (kind, args), = calls
    assert (route, kind, copies) == ("contiguous", "contiguous", [])
    assert args[0] == p.data_ptr() and args[4:8] == (512 * 136, 272, 256,
                                                     7.0)

    calls.clear()
    s = p[:, ::2]
    _, _, _, route = port_kq._launch_quantize(s, 8, 128)
    (kind, args), = calls
    assert (route, kind, copies) == ("copy", "contiguous", [(512, 68)])
    assert args[0] != s.data_ptr()


# -------------------------------------------------------------- serving
_SM = dict(max_tracked_sequences=8, max_ragged_batch_size=16,
           max_ragged_sequence_count=8, max_context=64, block_size=8,
           num_blocks=64, prefill_atom_size=0)


def _engines(arch, mode, dtype="float32", seed=0, round_bf16=False):
    """(JAX engine, port engine) over the same weights with
    ``quantization_mode=mode``; ``round_bf16`` first rounds the fp32 tree
    to bf16 values, so that a bf16 port model holds the JAX leaves'
    exact values."""
    if arch == "llama":
        pm, make = port_llama, _llama_tree
        jcfg = jax_llama.llama_tiny(dtype=dtype, remat=False,
                                    num_key_value_heads=2)
        pcfg = port_llama.llama_tiny(dtype=dtype, num_key_value_heads=2)
        jmodel, pmodel = jax_llama.LlamaModel, port_llama.LlamaModel
    else:
        pm, make = port_mixtral, _mixtral_tree
        jcfg = jax_mixtral.mixtral_tiny(dtype=dtype, remat=False)
        pcfg = port_mixtral.mixtral_tiny(dtype=dtype)
        jmodel, pmodel = jax_mixtral.MixtralModel, port_mixtral.MixtralModel
    tree = make(jcfg, seed)
    if round_bf16:
        tree = _map(tree, _bf16)
    config = dict(dtype=dtype, decode_burst=16, state_manager=dict(_SM),
                  quantization_mode=mode)
    jax_eng = JaxEngine(jmodel(jcfg), tree, dict(config))
    port_eng = InferenceEngineV2(
        pmodel(pcfg, device="meta"), pm.params_from_flax(tree, pcfg),
        dict(config), device="cpu")
    return jax_eng, port_eng, tree


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _jax_leaf(tree, name):
    """The JAX tree's leaf for a port weight name."""
    parts = name.split(".")
    if name == "model.embed_tokens.weight":
        return tree["embed_tokens"]["embedding"]
    if name == "lm_head.weight":
        return tree["lm_head"]["kernel"]
    layer = tree[f"layers_{parts[2]}"]
    if parts[3] == "block_sparse_moe":
        moe = layer["moe"]
        return moe["gate"]["kernel"] if parts[4] == "gate" else moe[parts[4]]
    return layer[parts[3]][parts[4]]["kernel"]


@pytest.mark.parametrize("arch", ["llama", "mixtral"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantized_weights_match_jax_bit_for_bit(arch, dtype):
    jax_eng, port_eng, _ = _engines(arch, "int8", dtype,
                                    round_bf16=dtype == "bfloat16")
    want = jax_dequantize_tree(jax_eng.params, jax_eng._quant_meta,
                               jnp.dtype(dtype))
    got = quant_serving.dequantize_tree(port_eng.module)
    assert len(got) == len(jax_eng._quant_meta) == len(port_eng._quant_meta)
    for name, t in got.items():
        leaf = np.asarray(_jax_leaf(want, name))
        assert t.dtype == getattr(torch, dtype), name
        np.testing.assert_array_equal(
            t.float().numpy(), leaf.astype(np.float32).reshape(t.shape),
            err_msg=name)
    # resident between steps: int8 values and fp32 scales, no float
    # weight of two or more dimensions
    assert not [n for n, p in port_eng.module.named_parameters()
                if p.dim() >= 2]
    assert port_eng.module.device == torch.device("cpu")
    assert quant_serving.resident_bytes(port_eng.module) < sum(
        np.asarray(v).size for v in _leaves(jax_eng.params)) * 2


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


@pytest.mark.parametrize("arch", ["llama", "mixtral"])
@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_generate_matches_jax(arch, mode):
    """fp32 serving with decode bursts: identical greedy tokens."""
    jax_eng, port_eng, _ = _engines(arch, mode)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 256, size=n).tolist() for n in (15, 6, 9)]
    want = jax_eng.generate(prompts, max_new_tokens=6)
    got = port_eng.generate(prompts, max_new_tokens=6)
    assert got == want
    assert getattr(port_eng, "burst_steps", 0) >= 1


def test_dequantize_per_leaf_inside_each_step(monkeypatch):
    """Each ragged step dequantizes every quantized leaf once, just before
    its use: at no time are more dequantized weights alive than one MoE
    layer's three expert stacks (the JAX wrapper dequantizes the whole
    tree at the start of the step)."""
    _, port_eng, _ = _engines("mixtral", "int8")
    refs, most = [], [0]
    real = quant_serving.dequantize_blockwise

    def counted(q, s, meta):
        out = real(q, s, meta)
        refs.append(weakref.ref(out))
        most[0] = max(most[0], sum(r() is not None for r in refs))
        return out

    monkeypatch.setattr(quant_serving, "dequantize_blockwise", counted)
    port_eng.generate([[1, 2, 3]], max_new_tokens=1)     # one step
    assert len(refs) == len(port_eng._quant_meta) == 2 + 2 * 8
    assert most[0] <= 3


def test_quantization_mode_refusals():
    model = port_llama.LlamaModel(port_llama.llama_tiny(dtype="float32"))
    with pytest.raises(NotImplementedError, match="quantization_mode"):
        InferenceEngineV2(model, config=dict(quantization_mode="wf6af16"),
                          device="cpu")
    with pytest.raises(NotImplementedError, match="tensor parallelism"):
        InferenceEngineV2(model, config=dict(
            quantization_mode="int8", tensor_parallel={"tp_size": 2}),
            device="cpu")
    assert quant_serving.resolve_mode("Q4") == 4
    assert quant_serving.resolve_mode(None) is None
