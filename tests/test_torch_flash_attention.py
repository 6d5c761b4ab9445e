"""The port's flash attention (kernel B1's plain version, on the CPU)
against the JAX package's Pallas kernel, run in interpret mode as
``tests/unit/ops/test_pallas_kernels.py`` runs it, forward and gradients
(``jax.vjp`` against torch autograd), on the same numpy inputs.

Tolerance 2e-5 (absolute and relative) in fp32: both sides compute scores,
probabilities and sums in fp32, in another order.  The port's
``_xla_attention`` is also held to its JAX twin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.attention import _xla_attention as jax_xla_attention
from deepspeed_tpu.ops.attention import attention_core as jax_attention_core
from deepspeed_tpu.ops.pallas.flash_attention import \
    flash_attention as pallas_flash
from deepspeed_tpu_torch.ops import _use_kernels
from deepspeed_tpu_torch.ops import attention as port_attention
from deepspeed_tpu_torch.ops.kernels import flash_attention as port_fa

TOL = dict(atol=2e-5, rtol=2e-5)


def _inputs(seed, B, sq, sk, Hq, Hkv, D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, sq, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, sk, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, sk, Hkv, D)).astype(np.float32)
    do = rng.standard_normal((B, sq, Hq, D)).astype(np.float32)
    return q, k, v, do


def _jax(q, k, v, do, **kw):
    o, vjp = jax.vjp(
        lambda q, k, v: pallas_flash(q, k, v, block_q=32, block_k=32, **kw),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(x) for x in (o, *vjp(jnp.asarray(do)))]


def _port(q, k, v, do, **kw):
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    o = port_fa.flash_attention(qt, kt, vt, **kw)
    o.backward(torch.from_numpy(do))
    return [x.detach().numpy() for x in (o, qt.grad, kt.grad, vt.grad)]


CASES = {
    "causal": dict(shape=(2, 64, 64, 4, 4, 32), kw=dict(causal=True)),
    "noncausal": dict(shape=(1, 100, 100, 2, 2, 64), kw=dict(causal=False)),
    "sq_lt_sk": dict(shape=(1, 32, 96, 2, 2, 32), kw=dict(causal=True)),
    "gqa_4_2": dict(shape=(1, 64, 64, 4, 2, 32), kw=dict(causal=True)),
    "window": dict(shape=(1, 100, 100, 2, 2, 32),
                   kw=dict(causal=True, window=40)),
    "alibi": dict(shape=(1, 64, 64, 4, 4, 32),
                  kw=dict(causal=True,
                          alibi_slopes=np.array([0.5, 0.25, 0.125, 0.0625],
                                                np.float32))),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas_forward_and_grads(case):
    spec = CASES[case]
    q, k, v, do = _inputs(sum(map(ord, case)), *spec["shape"])
    kw = dict(spec["kw"])
    jkw = dict(kw)
    if "alibi_slopes" in kw:
        kw["alibi_slopes"] = torch.from_numpy(kw["alibi_slopes"])
        jkw["alibi_slopes"] = jnp.asarray(jkw["alibi_slopes"])
    want = _jax(q, k, v, do, **jkw)
    got = _port(q, k, v, do, **kw)
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)


def test_dead_rows_are_zero_without_nan():
    """sq > sk, causal: the first sq - sk rows see no key; they output 0
    and take no gradient, as in the Pallas kernel."""
    q, k, v, do = _inputs(7, 1, 96, 32, 2, 2, 32)
    want = _jax(q, k, v, do, causal=True)
    got = _port(q, k, v, do, causal=True)
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)
    dead = 96 - 32
    assert not got[0][:, :dead].any() and not got[1][:, :dead].any()
    assert got[0][:, dead:].any()


def test_plain_lse_marks_dead_rows():
    q, k, v, _ = _inputs(3, 1, 40, 8, 2, 2, 16)
    o, lse = port_fa._plain_fwd(*(torch.from_numpy(x) for x in (q, k, v)),
                                16**-0.5, causal=True)
    assert lse.shape == (1, 2, 40)
    assert (lse[:, :, :32] == port_fa.DEAD_ROW_LSE).all()
    assert torch.isfinite(lse).all() and (o[:, :32] == 0).all()


@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=False),
                                dict(causal=True, window=24),
                                dict(causal=True, alibi_slopes=[0.5, 0.25])],
                         ids=["causal", "noncausal", "window", "alibi"])
def test_xla_attention_matches_jax(kw):
    """The CPU path of ``attention_core``, including the uniform softmax of
    a row that sees no key (sq > sk)."""
    q, k, v, _ = _inputs(11, 2, 48, 40, 2, 2, 16)
    jkw = dict(kw)
    if "alibi_slopes" in kw:
        jkw["alibi_slopes"] = jnp.asarray(kw["alibi_slopes"], jnp.float32)
        kw = dict(kw, alibi_slopes=torch.tensor(kw["alibi_slopes"]))
    want = np.asarray(jax_xla_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), **jkw))
    got = port_attention._xla_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), **kw).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_attention_core_dispatch_on_cpu():
    q, k, v, _ = _inputs(5, 1, 16, 16, 2, 2, 8)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    xla = port_attention._xla_attention(qt, kt, vt)
    assert torch.equal(port_attention.attention_core(qt, kt, vt), xla)
    plain = port_attention.attention_core(qt, kt, vt, use_kernel=False)
    torch.testing.assert_close(plain, xla, **TOL)
    with pytest.raises(ValueError, match="causal"):
        port_attention.attention_core(qt, kt, vt, causal=False, window=4)


@pytest.mark.parametrize("kw", [dict(causal=True),
                                dict(causal=True, window=24),
                                dict(causal=True, alibi_slopes=[0.5, 0.25])],
                         ids=["causal", "window", "alibi"])
def test_attention_core_under_the_kernel_switch_matches_jax(monkeypatch, kw):
    """``DS_TPU_DISABLE_PALLAS_ATTN`` shuts the gate for CUDA tensors too,
    and ``attention_core`` then computes JAX's XLA path (which JAX takes
    under the same switch even with ``DS_TPU_FORCE_PALLAS=1``): outputs
    and gradients.  The XLA path rounds the probabilities to q's dtype
    before P·V; the kernels do not, so the two are different functions in
    bf16."""
    class CudaLike:
        device = torch.device("cuda")

    assert _use_kernels.use_kernels(CudaLike())
    monkeypatch.setenv("DS_TPU_DISABLE_PALLAS_ATTN", "1")
    monkeypatch.setenv("DS_TPU_FORCE_PALLAS", "1")
    assert not _use_kernels.use_kernels(CudaLike())
    q, k, v, do = _inputs(13, 2, 48, 48, 2, 2, 16)
    jkw = dict(kw)
    if "alibi_slopes" in kw:
        jkw["alibi_slopes"] = jnp.asarray(kw["alibi_slopes"], jnp.float32)
        kw = dict(kw, alibi_slopes=torch.tensor(kw["alibi_slopes"]))
    o, vjp = jax.vjp(lambda q, k, v: jax_attention_core(q, k, v, **jkw),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(x) for x in (o, *vjp(jnp.asarray(do)))]
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = port_attention.attention_core(qt, kt, vt, **kw)
    out.backward(torch.from_numpy(do))
    got = [x.detach().numpy() for x in (out, qt.grad, kt.grad, vt.grad)]
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)
