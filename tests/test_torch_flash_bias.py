"""The port's bias-operand flash attention (kernel B10's plain versions, on
the CPU) against the JAX package's Pallas kernels, run in interpret mode as
``tests/unit/ops/test_flash_bias.py`` runs them: outputs and the gradients
to q, k, v and the bias (``jax.vjp`` against torch autograd), on the same
numpy inputs, in fp32.

Tolerances: outputs 2e-5 absolute and relative (both sides compute
scores, probabilities and sums in fp32, in another order); gradients 5e-5
absolute and 5e-4 relative, as the JAX package's own test holds its kernel
to its naive reference (dbias sums ds over up to 6 group members, and dq,
dk, dv carry the recomputed probabilities through two more products).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas.flash_bias import \
    flash_attention_bias as pallas_flash_bias
from deepspeed_tpu_torch.ops.kernels import flash_bias as port_fb

OUT_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=5e-5, rtol=5e-4)


def _inputs(seed, B, sq, sk, H, D, bias_shape, mask_rows=None):
    """q, k, v, do, the bias (scaled by 0.5, as the JAX test does) and a
    0 / -1e9 key mask over ``mask_rows`` batch rows: its last 5 keys are
    masked everywhere and row 1 is masked whole."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q, k, v, do = f(B, sq, H, D), f(B, sk, H, D), f(B, sk, H, D), \
        f(B, sq, H, D)
    bias = f(*bias_shape) * 0.5
    mask = None
    if mask_rows:
        keep = np.ones((mask_rows, 1, 1, sk), np.float32)
        keep[..., sk - 5:] = 0
        keep[1] = 0
        mask = (-1e9 * (1 - keep)).astype(np.float32)
    return q, k, v, do, bias, mask


def _jax(q, k, v, do, bias, mask, **kw):
    args = [jnp.asarray(x) for x in (q, k, v, bias)]
    m = None if mask is None else jnp.asarray(mask)

    def f(q, k, v, b, m):
        return pallas_flash_bias(q, k, v, b, mask_bias=m, block_q=32,
                                 block_k=32, **kw)

    o, vjp = jax.vjp(f, *args, m)
    grads = vjp(jnp.asarray(do))
    return [np.asarray(o)] + [None if g is None else np.asarray(g)
                              for g in grads]


def _port(q, k, v, do, bias, mask, **kw):
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v, bias)]
    m = None if mask is None else torch.tensor(mask, requires_grad=True)
    o = port_fb.flash_attention_bias(*leaves, mask_bias=m, **kw)
    o.backward(torch.from_numpy(do))
    return ([o.detach().numpy()] + [t.grad.numpy() for t in leaves]
            + [None if m is None else m.grad])


CASES = {
    # (B, sq, sk, H, D, bias shape, mask rows, kwargs)
    "noncausal": (2, 40, 40, 2, 16, (2, 2, 40, 40), None, {}),
    "causal": (2, 40, 40, 2, 16, (2, 2, 40, 40), None, dict(causal=True)),
    "causal_dead_rows": (1, 40, 24, 2, 16, (1, 2, 40, 24), None,
                         dict(causal=True)),
    "grouped": (6, 40, 40, 2, 16, (2, 1, 40, 40), None, {}),
    "mask": (4, 40, 40, 2, 16, (2, 2, 40, 40), 4, {}),
    "mask_grouped": (4, 40, 40, 2, 16, (2, 1, 40, 40), 2,
                     dict(softmax_scale=0.3)),
    "unaligned": (2, 37, 29, 2, 12, (1, 2, 37, 29), None, {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas_forward_and_grads(case):
    B, sq, sk, H, D, bias_shape, mask_rows, kw = CASES[case]
    q, k, v, do, bias, mask = _inputs(sum(map(ord, case)), B, sq, sk, H, D,
                                      bias_shape, mask_rows)
    want = _jax(q, k, v, do, bias, mask, **kw)
    got = _port(q, k, v, do, bias, mask, **kw)
    np.testing.assert_allclose(got[0], want[0], err_msg="o", **OUT_TOL)
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got[1:5], want[1:5]):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, err_msg=name, **GRAD_TOL)
    if mask is not None:
        # JAX returns a zero cotangent for the mask, the port none at all
        assert not want[5].any() and got[5] is None


def test_plain_lse_marks_dead_rows():
    q, k, v, _, bias, _ = _inputs(3, 1, 40, 8, 2, 16, (1, 2, 40, 8))
    o, lse = port_fb._plain_fwd(*(torch.from_numpy(x) for x in (q, k, v,
                                                                bias)),
                                None, 16**-0.5, causal=True)
    assert lse.shape == (1, 2, 40)
    assert (lse[:, :, :32] == port_fb.DEAD_ROW_LSE).all()
    assert torch.isfinite(lse).all() and (o[:, :32] == 0).all()


def test_bias_gradient_keeps_bias_dtype():
    q, k, v, do, bias, _ = _inputs(5, 2, 24, 24, 2, 16, (1, 2, 24, 24))
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    b16 = torch.tensor(bias).to(torch.bfloat16).requires_grad_(True)
    port_fb.flash_attention_bias(qt, kt, vt, b16).backward(
        torch.from_numpy(do))
    assert b16.grad.dtype == torch.bfloat16 and b16.grad.shape == b16.shape
    frozen = torch.tensor(bias)
    out = port_fb.flash_attention_bias(qt, kt, vt, frozen)
    out.backward(torch.from_numpy(do))
    assert frozen.grad is None


def test_argument_checks():
    q = torch.zeros(4, 16, 2, 8)
    bias = torch.zeros(2, 1, 16, 16)
    with pytest.raises(ValueError, match="GQA"):
        port_fb.flash_attention_bias(q, q[:, :, :1], q[:, :, :1], bias)
    with pytest.raises(ValueError, match="Bb, Hb"):
        port_fb.flash_attention_bias(q, q, q, torch.zeros(3, 1, 16, 16))
    with pytest.raises(ValueError, match="score plane"):
        port_fb.flash_attention_bias(q, q, q, torch.zeros(2, 1, 16, 8))
    with pytest.raises(ValueError, match="mask_bias"):
        port_fb.flash_attention_bias(q, q, q, bias,
                                     mask_bias=torch.zeros(3, 1, 1, 16))
