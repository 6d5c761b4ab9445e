"""Diffusers/CLIP attention injection in the port
(``module_inject/diffusers_injection.py``) against the JAX package's
(``tests/unit/model_parallelism/test_diffusers_injection.py``) on the CPU.

* transformers' CLIP text encoder: the torch ``CLIPTextModel`` under the
  port's ``fused_attention`` against ``FlaxCLIPTextModel`` under JAX's,
  with the same weights (the flax tree converted here): the last hidden
  state at rtol/atol 2e-5, one fused call a layer on both sides; the same
  through ``generic_injection()`` and ``fused_attention()`` with no
  module (the class swapped, the calls counted) and the forwards
  restored at exit.
* A stand-in of diffusers' ``Attention`` (``to_q``, ``to_k``, ``to_v``,
  ``to_out``) against JAX's ``FlaxAttention`` stand-in under
  ``fused_attention``, at 2e-5.
* Each fallback case of ``make_interceptor`` runs the module's own code,
  bit for bit, and counts a fallback: a padding mask (fused under
  ``assume_full_mask``), ``output_attentions``, a causal mask that is not
  the standard one, attention dropout in training, cross-attention by
  keyword and by position, and a diffusers group norm.
* A failure inside the fused path raises instead of falling back.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import flax.linen as fnn

from deepspeed_tpu.module_inject import \
    fused_attention as jax_fused_attention
from deepspeed_tpu_torch import module_inject
from deepspeed_tpu_torch.module_inject import diffusers_injection as di

transformers = pytest.importorskip("transformers")

TOL = dict(rtol=2e-5, atol=2e-5)


def _clip_config():
    return transformers.CLIPTextConfig(
        vocab_size=99, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4,
        max_position_embeddings=32)


def flax_to_torch_state(tree):
    """A flax param tree (numpy leaves) → a torch state dict: a Dense
    ``kernel`` [in, out] becomes ``weight`` [out, in], a LayerNorm's
    ``scale`` and an Embed's ``embedding`` become ``weight``."""
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + [str(k)])
                continue
            a = np.asarray(v, dtype=np.float32)
            name = {"kernel": "weight", "scale": "weight",
                    "embedding": "weight"}.get(k, k)
            if k == "kernel":
                a = a.T
            out[".".join(prefix + [name])] = torch.from_numpy(a.copy())

    walk(tree, [])
    return out


@pytest.fixture(scope="module")
def clip():
    """(flax model, torch model with the flax weights, ids)."""
    fm = transformers.FlaxCLIPTextModel(_clip_config(), seed=0)
    tm = transformers.CLIPTextModel(_clip_config()).eval()
    missing, unexpected = tm.load_state_dict(
        flax_to_torch_state(jax.device_get(fm.params)), strict=False)
    assert not unexpected and all("position_ids" in m for m in missing)
    ids = np.random.default_rng(0).integers(0, 99, size=(2, 16)).astype(
        np.int32)
    return fm, tm, ids


def test_clip_text_encoder_fused_matches_jax(clip):
    fm, tm, ids = clip
    jcount = [0]
    with jax_fused_attention(counter=jcount):
        want = np.asarray(fm(ids).last_hidden_state)
    count = [0, 0]
    t_ids = torch.from_numpy(ids).long()
    with torch.no_grad():
        plain = tm(t_ids).last_hidden_state.numpy()
        with module_inject.fused_attention(counter=count, module=tm):
            got = tm(t_ids).last_hidden_state.numpy()
    assert jcount[0] == 2 and count == [2, 0]
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, plain, **TOL)
    assert not any("forward" in vars(m) for m in tm.modules())


def test_generic_injection_swaps_the_class_and_restores_it(clip):
    _, tm, ids = clip
    cls = type(tm.text_model.encoder.layers[0].self_attn)
    orig = cls.forward
    count = {}
    with torch.no_grad():
        plain = tm(torch.from_numpy(ids).long()).last_hidden_state
        with module_inject.generic_injection():
            assert cls.forward is not orig
            got = tm(torch.from_numpy(ids).long()).last_hidden_state
        with module_inject.fused_attention(counter=count):
            again = tm(torch.from_numpy(ids).long()).last_hidden_state
    assert cls.forward is orig
    assert count == {"fused": 2}
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
    np.testing.assert_array_equal(again.numpy(), got.numpy())
    with pytest.raises(ValueError, match="dtype"):
        module_inject.generic_injection(dtype=torch.int8)


# ------------------------------------------------------ diffusers layout
class FlaxAttention(fnn.Module):
    """JAX's stand-in of diffusers-flax attention (the JAX test's)."""
    heads: int = 4
    dim_head: int = 8

    def setup(self):
        inner = self.heads * self.dim_head
        self.scale = self.dim_head ** -0.5
        self.query = fnn.Dense(inner, use_bias=False)
        self.key = fnn.Dense(inner, use_bias=False)
        self.value = fnn.Dense(inner, use_bias=False)
        self.proj_attn = fnn.Dense(inner)

    def __call__(self, hidden):
        B, S, _ = hidden.shape
        q = self.query(hidden).reshape(B, S, self.heads, self.dim_head)
        k = self.key(hidden).reshape(B, S, self.heads, self.dim_head)
        v = self.value(hidden).reshape(B, S, self.heads, self.dim_head)
        s = jnp.einsum("bqhd,bkhd->bhqk", q, k) * self.scale
        p = jax.nn.softmax(s, axis=-1)
        out = jnp.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, S, -1)
        return self.proj_attn(out)


class Attention(nn.Module):
    """A stand-in of diffusers' ``Attention``: its names, its forward
    signature and its eager math (the card has no diffusers)."""

    def __init__(self, dim, heads, dim_head, cross_dim=None, dropout=0.0):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.scale = heads, dim_head ** -0.5
        self.group_norm = self.spatial_norm = None
        self.residual_connection, self.rescale_output_factor = False, 1.0
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(cross_dim or dim, inner, bias=False)
        self.to_v = nn.Linear(cross_dim or dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, dim),
                                     nn.Dropout(dropout)])

    def forward(self, hidden_states, encoder_hidden_states=None,
                attention_mask=None, **cross_attention_kwargs):
        B, S, _ = hidden_states.shape
        ctx = hidden_states if encoder_hidden_states is None \
            else encoder_hidden_states
        q = self.to_q(hidden_states).view(B, S, self.heads, -1)
        k = self.to_k(ctx).view(B, ctx.shape[1], self.heads, -1)
        v = self.to_v(ctx).view(B, ctx.shape[1], self.heads, -1)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * self.scale
        if attention_mask is not None:
            s = s + attention_mask
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, S, -1)
        for m in self.to_out:
            out = m(out)
        return out


def _attention_pair(seed=2):
    D = 32
    x = np.random.default_rng(seed).standard_normal((2, 10, D)).astype(
        np.float32)
    fmod = FlaxAttention()
    params = fmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tmod = Attention(D, 4, 8).eval()
    p = jax.device_get(params)["params"]
    with torch.no_grad():
        for t, f in (("to_q", "query"), ("to_k", "key"), ("to_v", "value")):
            getattr(tmod, t).weight.copy_(torch.from_numpy(
                np.asarray(p[f]["kernel"]).T.copy()))
        tmod.to_out[0].weight.copy_(torch.from_numpy(
            np.asarray(p["proj_attn"]["kernel"]).T.copy()))
        tmod.to_out[0].bias.copy_(torch.from_numpy(
            np.asarray(p["proj_attn"]["bias"])))
    return fmod, params, tmod, x


def test_diffusers_attention_fused_matches_jax():
    fmod, params, tmod, x = _attention_pair()
    jcount = [0]
    with jax_fused_attention(counter=jcount):
        want = np.asarray(fmod.apply(params, jnp.asarray(x)))
    count = {}
    with torch.no_grad(), module_inject.fused_attention(counter=count,
                                                        module=tmod):
        got = tmod(torch.from_numpy(x)).numpy()
    assert jcount[0] == 1 and count == {"fused": 1}
    np.testing.assert_allclose(got, want, **TOL)


# ------------------------------------------------------ fallback cases
def _clip_attention():
    cfg = _clip_config()
    cfg._attn_implementation = "eager"
    torch.manual_seed(0)
    return transformers.models.clip.modeling_clip.CLIPAttention(cfg).eval()


def _causal(S):
    m = torch.full((S, S), torch.finfo(torch.float32).min).triu(1)
    return m[None, None].expand(2, 1, S, S)


def _fallback_cases():
    x = torch.randn(2, 8, 32, generator=torch.Generator().manual_seed(4))
    pad = torch.zeros(2, 1, 8, 8)
    pad[..., -2:] = torch.finfo(torch.float32).min
    odd = _causal(8).clone()
    odd[..., 3, 1] = torch.finfo(torch.float32).min
    ctx = torch.randn(2, 5, 24, generator=torch.Generator().manual_seed(5))
    return {
        "padding_mask": (_clip_attention, (x, pad), {}),
        "output_attentions": (_clip_attention, (x, ),
                              dict(causal_attention_mask=_causal(8),
                                   output_attentions=True)),
        "odd_causal_mask": (_clip_attention, (x, ),
                            dict(causal_attention_mask=odd)),
        "dropout_in_training": (
            lambda: Attention(32, 4, 8, dropout=0.5).train(), (x, ), {}),
        "cross_by_keyword": (lambda: Attention(32, 4, 8, cross_dim=24),
                             (x, ), dict(encoder_hidden_states=ctx)),
        "cross_by_position": (lambda: Attention(32, 4, 8, cross_dim=24),
                              (x, ctx), {}),
        "group_norm": (_group_normed, (x, ), {}),
    }


def _group_normed():
    mod = Attention(32, 4, 8)
    mod.group_norm = nn.GroupNorm(4, 32)
    return mod


@pytest.mark.parametrize("case", sorted(_fallback_cases()))
def test_fallback_case_runs_the_module_own_code(case):
    make, args, kw = _fallback_cases()[case]
    mod = make()
    torch.manual_seed(9)
    want = mod(*args, **kw)
    count = [0, 0]
    torch.manual_seed(9)
    with module_inject.fused_attention(counter=count, module=mod):
        got = mod(*args, **kw)
    assert count == [0, 1]
    want = want[0] if isinstance(want, tuple) else want
    got = got[0] if isinstance(got, tuple) else got
    np.testing.assert_array_equal(got.detach().numpy(),
                                  want.detach().numpy())


def test_assume_full_mask_keeps_the_fused_path():
    mod = _clip_attention()
    x = torch.randn(2, 8, 32, generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        want = mod(x, causal_attention_mask=_causal(8))[0]
        count = [0, 0]
        pad = torch.zeros(2, 1, 8, 8)
        with module_inject.fused_attention(counter=count, module=mod):
            got = mod(x, None, _causal(8))[0]
            mod(x, pad, _causal(8))               # all zeros: a no-op
        pad[..., -1] = -1.0
        with module_inject.fused_attention(counter=count, module=mod,
                                           assume_full_mask=True):
            mod(x, pad, _causal(8))
    assert count == [3, 0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_a_failing_fused_path_raises(monkeypatch):
    mod = _clip_attention()

    def broken(*a, **k):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(di, "attention_core", broken)
    count = [0, 0]
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        with module_inject.fused_attention(counter=count, module=mod):
            mod(torch.randn(2, 8, 32))
    assert count == [0, 0] and "forward" not in vars(mod)
