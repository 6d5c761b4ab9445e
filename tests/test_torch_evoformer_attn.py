"""The port's ``DS4Sci_EvoformerAttention`` and chunked
``evoformer_attention`` against the JAX package's, on the same numpy
inputs: outputs and the gradients to Q, K, V and both biases.

- With a pair bias and ``DS_TPU_EVOFORMER_FLASH=1`` JAX routes the call
  through its Pallas bias kernels (interpret mode on the CPU); the port
  takes the same route on its own (the kernels' plain versions on the
  CPU).  On this route the mask bias gets no gradient: zeros from JAX,
  none from the port.
- Without a pair bias, with ``DS_TPU_EVOFORMER_FLASH=0``, or with
  ``DS_TPU_DISABLE_PALLAS_ATTN`` set, both take the chunked path, which
  differentiates the mask bias too.

Tolerances: fp32 outputs 2e-5 and gradients 5e-5 absolute, 5e-4 relative
(the same fp32 arithmetic in another order; the route's gradients are held
as ``tests/unit/ops/test_flash_bias.py`` holds them); bf16 2e-2, as
``tests/unit/ops/test_evoformer_attn.py`` holds bf16 outputs (both sides
round o, and the chunked path P, to bf16 at the same places).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.deepspeed4science import \
    DS4Sci_EvoformerAttention as jax_ds4sci
from deepspeed_tpu.ops.deepspeed4science import \
    evoformer_attention as jax_evoformer
from deepspeed_tpu_torch.ops.deepspeed4science import (
    DS4Sci_EvoformerAttention, evoformer_attention)
from deepspeed_tpu_torch.ops.kernels import flash_bias as port_fb

OUT_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=5e-5, rtol=5e-4)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)


def _make(B, N, L, H, D, mask=True, pair=True, seed=0):
    """Q, K, V, dO and [mask bias (0 / -1e9 over the last 3 keys, one MSA
    row masked whole), pair bias]."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q, k, v, do = (f(B, N, L, H, D) for _ in range(4))
    biases = []
    if mask:
        keep = np.ones((B, N, 1, 1, L), np.float32)
        keep[..., L - 3:] = 0
        keep[:, -1] = 0
        biases.append((-1e9 * (1 - keep)).astype(np.float32))
    if pair:
        biases.append(f(B, 1, H, L, L) * 0.3)
    return q, k, v, do, biases


def _jax(fn, q, k, v, do, biases, dtype=jnp.float32):
    args = [jnp.asarray(x, dtype) for x in (q, k, v, *biases)]
    out, vjp = jax.vjp(lambda q, k, v, *bs: fn(q, k, v, list(bs)), *args)
    grads = vjp(jnp.asarray(do, dtype))
    return [np.asarray(x, np.float32) for x in (out, *grads)]


def _port(fn, q, k, v, do, biases, dtype=torch.float32):
    leaves = [torch.tensor(x).to(dtype).requires_grad_(True)
              for x in (q, k, v, *biases)]
    out = fn(*leaves[:3], leaves[3:])
    out.backward(torch.tensor(do).to(dtype))
    return [out.detach().float().numpy()] + [
        None if t.grad is None else t.grad.float().numpy() for t in leaves]


def _assert_close(got, want, names, out_tol, grad_tol):
    np.testing.assert_allclose(got[0], want[0], err_msg="out", **out_tol)
    for name, g, w in zip(names, got[1:], want[1:]):
        np.testing.assert_allclose(g, w, err_msg=name, **grad_tol)


@pytest.mark.parametrize("with_mask", [True, False], ids=["mask", "nomask"])
def test_pair_bias_route_matches_jax_kernel_route(monkeypatch, with_mask):
    monkeypatch.setenv("DS_TPU_EVOFORMER_FLASH", "1")
    q, k, v, do, biases = _make(1, 3, 40, 2, 16, mask=with_mask)
    want = _jax(jax_ds4sci, q, k, v, do, biases)
    got = _port(DS4Sci_EvoformerAttention, q, k, v, do, biases)
    _assert_close(got[:4] + got[-1:], want[:4] + want[-1:],
                  ("dQ", "dK", "dV", "dPair"), OUT_TOL, GRAD_TOL)
    if with_mask:
        assert not want[4].any() and got[4] is None


def test_route_runs_the_bias_kernel_function(monkeypatch):
    """Without the switch the port routes a pair-biased call (JAX does
    only on a TPU), and the route reaches ``flash_attention_bias``."""
    monkeypatch.delenv("DS_TPU_EVOFORMER_FLASH", raising=False)
    calls = []
    real = port_fb.FlashBiasFunction.apply

    def spy(*args):
        calls.append(args[-1])            # use_kernel
        return real(*args)

    monkeypatch.setattr(port_fb.FlashBiasFunction, "apply", spy)
    q, k, v, _, biases = _make(1, 2, 24, 2, 8)
    DS4Sci_EvoformerAttention(*(torch.tensor(x) for x in (q, k, v)),
                              [torch.tensor(b) for b in biases])
    assert calls == [False]               # the plain version, on the CPU
    calls.clear()
    DS4Sci_EvoformerAttention(*(torch.tensor(x) for x in (q, k, v)),
                              [torch.tensor(biases[0]), None])
    assert calls == []                    # no pair bias: chunked path


@pytest.mark.parametrize("L,block_q", [(40, 16), (40, 64)],
                         ids=["chunked", "direct"])
def test_no_pair_bias_chunked_path_matches_jax(L, block_q):
    q, k, v, do, biases = _make(2, 2, L, 2, 8, pair=False, seed=L + block_q)

    def fn(mod):
        return lambda q, k, v, bs: mod(q, k, v, bs, block_q=block_q)

    want = _jax(fn(jax_evoformer), q, k, v, do, biases)
    got = _port(fn(evoformer_attention), q, k, v, do, biases)
    _assert_close(got, want, ("dQ", "dK", "dV", "dMask"), OUT_TOL, GRAD_TOL)


def test_switch_off_takes_chunked_path_with_mask_gradient(monkeypatch):
    monkeypatch.setenv("DS_TPU_EVOFORMER_FLASH", "0")
    q, k, v, do, biases = _make(1, 2, 40, 2, 8, seed=3)
    want = _jax(lambda q, k, v, bs: jax_evoformer(q, k, v, bs, block_q=16),
                q, k, v, do, biases)
    got = _port(DS4Sci_EvoformerAttention, q, k, v, do, biases)
    _assert_close(got, want, ("dQ", "dK", "dV", "dMask", "dPair"), OUT_TOL,
                  GRAD_TOL)
    assert np.abs(got[4]).max() > 0       # the mask bias is trained


def test_kernel_switch_takes_chunked_path_as_jax(monkeypatch):
    """``DS_TPU_DISABLE_PALLAS_ATTN``, the switch of every attention site,
    sends a pair-biased call to the chunked path in both packages, even
    with JAX's route forced (``DS_TPU_EVOFORMER_FLASH=1``): outputs and
    gradients against JAX's chunked path, the mask bias's included, which
    the kernel route leaves at zero."""
    monkeypatch.setenv("DS_TPU_DISABLE_PALLAS_ATTN", "1")
    monkeypatch.setenv("DS_TPU_EVOFORMER_FLASH", "1")

    def refuse(*args):
        raise AssertionError("the bias kernels' route was taken")

    monkeypatch.setattr(port_fb.FlashBiasFunction, "apply", refuse)
    q, k, v, do, biases = _make(1, 2, 40, 2, 8, seed=4)
    want = _jax(jax_ds4sci, q, k, v, do, biases)
    got = _port(DS4Sci_EvoformerAttention, q, k, v, do, biases)
    _assert_close(got, want, ("dQ", "dK", "dV", "dMask", "dPair"), OUT_TOL,
                  GRAD_TOL)
    assert np.abs(got[4]).max() > 0       # the mask bias is trained


def test_bf16_route_matches_jax(monkeypatch):
    monkeypatch.setenv("DS_TPU_EVOFORMER_FLASH", "1")
    q, k, v, do, biases = _make(1, 2, 24, 2, 16, seed=5)
    want = _jax(jax_ds4sci, q, k, v, do, biases, jnp.bfloat16)
    got = _port(DS4Sci_EvoformerAttention, q, k, v, do, biases,
                torch.bfloat16)
    _assert_close(got[:4] + got[-1:], want[:4] + want[-1:],
                  ("dQ", "dK", "dV", "dPair"), BF16_TOL, BF16_TOL)


def test_asserts():
    q = torch.zeros(1, 2, 8, 2, 4)
    with pytest.raises(AssertionError, match="at most two"):
        DS4Sci_EvoformerAttention(q, q, q, [None, None, None])
    with pytest.raises(AssertionError, match="incompatible"):
        DS4Sci_EvoformerAttention(q, q, q, [torch.zeros(1, 2, 1, 1, 7)])


def test_fully_masked_row_backward_follows_the_saved_lse(monkeypatch):
    """A reference fault the port keeps (ROADMAP queue C): in a row whose
    keys are all masked by -1e9, fp32 absorbs log L into lse = m, so the
    route's backward recomputes p = 1 where the softmax gave 1/L.  Its
    forward agrees with the chunked path; dQ of that row is L times the
    chunked path's, as in the JAX kernel (held above)."""
    q, k, v, do, biases = _make(1, 3, 40, 2, 16, seed=9)   # row 2 masked
    got = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("DS_TPU_EVOFORMER_FLASH", flag)
        got[flag] = _port(DS4Sci_EvoformerAttention, q, k, v, do, biases)
    np.testing.assert_allclose(got["1"][0], got["0"][0], **OUT_TOL)
    np.testing.assert_allclose(got["1"][1][:, :2], got["0"][1][:, :2],
                               **GRAD_TOL)
    np.testing.assert_allclose(got["1"][1][:, 2], 40 * got["0"][1][:, 2],
                               atol=40 * 5e-5, rtol=5e-4)
