"""FPDT of the port (``sequence/fpdt_layer.py`` over ``sequence/
blockwise.py``) against the JAX package's ``sequence/fpdt_layer.py`` on the
CPU, fp32, inputs from numpy seeds (JAX's ``test_fpdt.py`` shapes).

* ``update_out_and_lse``: the same merge at 1e-6, dead rows included;
* ``_chunk_attend`` (one pair: JAX's boolean mask, B1's ``causal``) at
  2e-5;
* ``chunked_attention``: values and the gradients of ``sum(out ** 2)``,
  causal and not, even and uneven tiles ((16, 16), (32, 8), (8, 32),
  (64, 64), a sequence that does not tile), at 2e-5 (JAX's own tests hold
  it to dense attention at 2e-4 / 5e-4);
* ``FPDTHostOffloadAttention``: the stream over history chunks and the
  decode-style stream, with and without ``double_buffer``, against JAX's
  at 2e-5 and bit-equal to each other; every merge call takes operands of
  the same size whatever the context (JAX's 128K property at a small
  size);
* ``fpdt_ffn`` and ``fpdt_logits_loss`` (values and gradients) at 1e-5;
* ``FPDT_Attention`` at sp 2 (two gloo processes) against JAX's on an
  sp-2 mesh: output and gradients at 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.sequence import fpdt_layer as jax_fpdt
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch.sequence import fpdt_layer as port_fpdt
from torch_dist_worker import spawn

B, S, H, D = 2, 64, 4, 8
TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(seed, s=S):
    rng = np.random.default_rng(seed)
    return tuple((0.3 * rng.standard_normal((B, s, H, D))).astype(np.float32)
                 for _ in range(3))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_update_out_and_lse_matches_jax():
    rng = np.random.default_rng(0)
    out, new = (rng.standard_normal((B, S, H, D)).astype(np.float32)
                for _ in range(2))
    lse, new_lse = (rng.standard_normal((B, S, H)).astype(np.float32)
                    for _ in range(2))
    lse[:, :4] = jax_fpdt.NEG_INF            # rows dead so far
    new_lse[:, 2:6] = jax_fpdt.NEG_INF       # rows the new chunk misses
    want = jax_fpdt.update_out_and_lse(*(jnp.asarray(a) for a in
                                         (out, lse, new, new_lse)))
    got = port_fpdt.update_out_and_lse(*_t(out, lse, new, new_lse))
    assert port_fpdt.NEG_INF == jax_fpdt.NEG_INF
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("causal", [False, True])
def test_chunk_attend_matches_jax(causal):
    q, k, v = _qkv(1, s=16)
    mask = np.tril(np.ones((16, 16), bool)) if causal else None
    want = jax_fpdt._chunk_attend(*(jnp.asarray(a) for a in (q, k, v)),
                                  mask=None if mask is None
                                  else jnp.asarray(mask))
    got = port_fpdt._chunk_attend(*_t(q, k, v), causal=causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def _jax_chunked(q, k, v, qc, kc, causal):
    def loss(q, k, v):
        return jnp.sum(jax_fpdt.chunked_attention(
            q, k, v, q_chunk=qc, kv_chunk=kc, causal=causal) ** 2)

    args = [jnp.asarray(a) for a in (q, k, v)]
    out = jax_fpdt.chunked_attention(*args, q_chunk=qc, kv_chunk=kc,
                                     causal=causal)
    return [np.asarray(out)] + [np.asarray(g) for g in jax.grad(
        loss, argnums=(0, 1, 2))(*args)]


def _port_chunked(q, k, v, qc, kc, causal):
    q, k, v = (t.requires_grad_() for t in _t(q, k, v))
    out = port_fpdt.chunked_attention(q, k, v, q_chunk=qc, kv_chunk=kc,
                                      causal=causal)
    (out ** 2).sum().backward()
    return [out.detach().numpy(), q.grad.numpy(), k.grad.numpy(),
            v.grad.numpy()]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("q_chunk,kv_chunk", [(16, 16), (32, 8), (8, 32),
                                              (64, 64), (24, 16)])
def test_chunked_attention_matches_jax(causal, q_chunk, kv_chunk):
    """Values and gradients; (24, 16) does not tile S = 64 and falls back
    to one q chunk, as in JAX."""
    q, k, v = _qkv(2)
    want = _jax_chunked(q, k, v, q_chunk, kv_chunk, causal)
    got = _port_chunked(q, k, v, q_chunk, kv_chunk, causal)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)


def _stream(attn, q, k, v, decode):
    if decode:
        return [attn.attend(q[:, lo:lo + 16], k[:, lo:lo + 16],
                            v[:, lo:lo + 16]) for lo in range(0, S, 16)]
    for lo in range(0, S, 16):
        attn.append_kv(k[:, lo:lo + 16], v[:, lo:lo + 16])
    assert attn.context_length == S
    return [attn.attend(q)]


@pytest.mark.parametrize("decode", [False, True])
def test_host_offload_matches_jax(decode):
    q, k, v = _qkv(3)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = np.concatenate([np.asarray(o) for o in _stream(
        jax_fpdt.FPDTHostOffloadAttention(chunk_size=16), jq, jk, jv,
        decode)], axis=1)
    outs = {}
    for db in (False, True):
        attn = port_fpdt.FPDTHostOffloadAttention(chunk_size=16,
                                                  double_buffer=db)
        outs[db] = torch.cat(_stream(attn, *_t(q, k, v), decode),
                             dim=1).numpy()
        np.testing.assert_allclose(outs[db], want, **TOL)
    np.testing.assert_array_equal(outs[True], outs[False])


def test_host_offload_operands_do_not_grow():
    """Every merge call of a decode-style stream takes q, one k/v chunk,
    out and lse: the same bytes at every context length, and 8 tails +
    sum(0..7) past-chunk merges for 8 blocks."""
    rng = np.random.default_rng(4)
    attn = port_fpdt.FPDTHostOffloadAttention(chunk_size=8)
    call_bytes = []
    merge = attn._merge

    def counting(*args):
        call_bytes.append(sum(a.numel() * a.element_size() for a in args
                              if isinstance(a, torch.Tensor)))
        return merge(*args)

    attn._merge = counting
    for _ in range(8):
        blk = torch.from_numpy(rng.standard_normal((1, 8, 1, 16)).astype(
            np.float32))
        out = attn.attend(blk, k_new=blk, v_new=blk)
        assert torch.isfinite(out).all()
    assert attn.context_length == 64
    assert len(set(call_bytes)) == 1, sorted(set(call_bytes))
    assert len(call_bytes) == 8 + sum(range(8))


def test_fpdt_ffn_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    w1 = (0.2 * rng.standard_normal((D, 4 * D))).astype(np.float32)
    w2 = (0.2 * rng.standard_normal((4 * D, D))).astype(np.float32)
    want = jax_fpdt.fpdt_ffn(
        lambda h: jax.nn.gelu(h @ jnp.asarray(w1)) @ jnp.asarray(w2),
        jnp.asarray(x), chunk_size=16)
    tw1, tw2 = _t(w1, w2)
    xt = torch.from_numpy(x).requires_grad_()
    got = port_fpdt.fpdt_ffn(
        lambda h: torch.nn.functional.gelu(h @ tw1, approximate="tanh")
        @ tw2, xt, chunk_size=16)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    got.sum().backward()
    g = jax.grad(lambda h: jnp.sum(jax_fpdt.fpdt_ffn(
        lambda y: jax.nn.gelu(y @ jnp.asarray(w1)) @ jnp.asarray(w2), h,
        chunk_size=16)))(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("chunk", [16, 24])
def test_fpdt_logits_loss_matches_jax(chunk):
    """Values and gradients in hidden and the vocabulary kernel; 24 does
    not tile S and runs as one slab, as in JAX."""
    rng = np.random.default_rng(6)
    V = 97
    hidden = rng.standard_normal((B, S, D)).astype(np.float32)
    vocab = (0.1 * rng.standard_normal((D, V))).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    args = (jnp.asarray(hidden), jnp.asarray(vocab))
    want, gwant = jax.value_and_grad(
        lambda h, w: jax_fpdt.fpdt_logits_loss(h, w, jnp.asarray(labels),
                                               chunk_size=chunk),
        argnums=(0, 1))(*args)
    h, w = (t.requires_grad_() for t in _t(hidden, vocab))
    got = port_fpdt.fpdt_logits_loss(h, w, torch.from_numpy(labels),
                                     chunk_size=chunk)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    for g, w_ in zip((h.grad, w.grad), gwant):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=1e-5,
                                   atol=1e-6)
    per_token = port_fpdt.fpdt_logits_loss(
        *_t(hidden, vocab), torch.from_numpy(labels), chunk_size=chunk,
        reduction="none")
    assert per_token.shape == (B, S)


def _jax_fpdt_attention(q, k, v, chunk):
    groups.reset_mesh()
    groups.initialize_mesh(dp=1, sp=2, devices=jax.devices()[:2])
    try:
        attn = jax_fpdt.FPDT_Attention(q_chunk=chunk, kv_chunk=chunk,
                                       causal=True)
        args = [jnp.asarray(a) for a in (q, k, v)]
        out = attn(*args)
        grads = jax.grad(lambda *a: jnp.sum(attn(*a) ** 2),
                         argnums=(0, 1, 2))(*args)
        return [np.asarray(out)] + [np.asarray(g) for g in grads]
    finally:
        groups.reset_mesh()


def test_fpdt_attention_sp2_matches_jax():
    q, k, v = _qkv(7)
    want = _jax_fpdt_attention(q, k, v, 16)
    got = spawn(2, [dict(name="fpdt", kind="fpdt_attn", q=q, k=k, v=v,
                         chunk=16)], timeout=200)["fpdt"]
    for i, key in enumerate(("out", "dq", "dk", "dv")):
        full = np.concatenate([r[key] for r in got], axis=1)
        np.testing.assert_allclose(full, want[i], err_msg=key, **TOL)
