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

The card's bf16/fp16 kernels run their products on the tensor cores and
feed the fp32 P and dS to them as hi + lo in the input type (in fp16
scaled by powers of two); ``_emulate_tensor_cores`` is that design in
plain PyTorch.  It is held here to the JAX kernel run in the same low
precision (which computes in fp32 and rounds each output once, as the
card's plain versions do) at the card tests' tolerances: bf16
2^-7·|ref| + 1e-4, fp16 2^-10·|ref| + 1e-4 (one ulp of the output plus
fp32 differences), dbias compared in the bias's type, as JAX returns it;
with dO scaled by 2^-12 or 2^10 the absolute term becomes 2^-12 of the
output's largest value.  Rounding P and dS once instead (hi alone) breaks
those tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas.flash_bias import \
    flash_attention_bias as pallas_flash_bias
from deepspeed_tpu_torch.ops import op_builder
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


# ------------------------------------- the tensor-core design (emulated)
_JNP = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}
_RTOL = {torch.bfloat16: 2.0**-7, torch.float16: 2.0**-10}


def _low_inputs(case, dtype, do_scale=1.0):
    """The case's inputs rounded to ``dtype`` (the mask stays fp32)."""
    B, sq, sk, H, D, bias_shape, mask_rows, kw = CASES[case]
    q, k, v, do, bias, mask = _inputs(sum(map(ord, case)), B, sq, sk, H, D,
                                      bias_shape, mask_rows)
    low = [torch.from_numpy(x).to(dtype)
           for x in (q, k, v, do * np.float32(do_scale), bias)]
    return low, None if mask is None else torch.from_numpy(mask), kw


def _jax_low(q, k, v, do, bias, mask, **kw):
    """The JAX kernel (interpreted) on inputs in q's low-precision type:
    o, dq, dk, dv, dbias as fp32 numpy (dbias rounded to the bias's type,
    as JAX returns it)."""
    jd = _JNP[q.dtype]
    args = [jnp.asarray(t.float().numpy()).astype(jd)
            for t in (q, k, v, bias)]
    m = None if mask is None else jnp.asarray(mask.numpy())

    def f(q, k, v, b, m):
        return pallas_flash_bias(q, k, v, b, mask_bias=m, block_q=32,
                                 block_k=32, **kw)

    o, vjp = jax.vjp(f, *args, m)
    grads = vjp(jnp.asarray(do.float().numpy()).astype(jd))
    return [np.array(x.astype(jnp.float32)) for x in (o, *grads[:4])]


def _over_tolerance(low, mask, kw, keep_lo, abs_tol=None):
    """Worst |emulated - JAX| / tolerance over o, dq, dk, dv and dbias;
    the emulated backward reads JAX's o, as the card's kernels read o as
    stored."""
    q, k, v, do, bias = low
    want = [torch.from_numpy(w) for w in _jax_low(q, k, v, do, bias, mask,
                                                  **kw)]
    scale = kw.get("softmax_scale", q.shape[-1]**-0.5)
    got = port_fb._emulate_tensor_cores(
        q, k, v, do, bias, mask, scale, kw.get("causal", False),
        keep_lo=keep_lo, o=want[0].to(q.dtype))
    worst = {}
    for name, g, w in zip(("o", "dq", "dk", "dv", "dbias"), got, want):
        g = g.to(bias.dtype).float()
        assert g.shape == w.shape and torch.isfinite(g).all(), name
        atol = 1e-4 if abs_tol is None else abs_tol * w.abs().max()
        worst[name] = ((g - w).abs() / (_RTOL[q.dtype] * w.abs() + atol)
                       ).max().item()
    return worst


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_tensor_core_design_matches_pallas(case, dtype):
    """The cases above (grouped bias, a masked row, dead causal rows,
    unaligned D) in bf16 and fp16: the emulated kernels within the card
    tolerances of JAX's kernel; the single rounding of P and dS outside
    them."""
    low, mask, kw = _low_inputs(case, dtype)
    worst = _over_tolerance(low, mask, kw, keep_lo=True)
    assert max(worst.values()) <= 1.0, worst
    worst = _over_tolerance(low, mask, kw, keep_lo=False)
    assert max(worst[w] for w in ("o", "dq", "dk", "dv")) > 1.0, worst


@pytest.mark.parametrize("do_scale", [2.0**-12, 2.0**10])
def test_fp16_tensor_core_design_holds_gradients_of_any_size(do_scale):
    """dS is as large as dO, and fp16 keeps its bits only through the
    power-of-two scales: dO × 2^-12 and × 2^10, held to 2^-10·|ref| plus
    2^-12 of the output's largest |value|."""
    low, mask, kw = _low_inputs("mask_grouped", torch.float16, do_scale)
    worst = _over_tolerance(low, mask, kw, keep_lo=True, abs_tol=2.0**-12)
    assert max(worst.values()) <= 1.0, worst


def test_dbias_split_sums_in_chunk_order():
    """The split count comes from the shapes alone: a group of 64
    members splits into 4 chunks here, small groups stay whole, and
    AlphaFold2's MSA-row call takes 8; summed chunk by chunk, dbias stays
    within fp32 rounding of the plain sum."""
    B, L, H, D = 64, 40, 2, 16
    assert port_fb.dbias_splits(B, H, L, L, 1, H) == 4
    assert port_fb.dbias_splits(6, H, L, L, 2, 1) == 1
    # the MSA-row shape of AlphaFold2's fine-tuning crop: 8 chunks
    assert port_fb.dbias_splits(512, 8, 384, 384, 1, 8) == 8
    rng = np.random.default_rng(11)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((B, L, H, D))
                                    .astype(np.float32)).to(torch.bfloat16)
                   for _ in range(4))
    bias = torch.from_numpy(rng.standard_normal((1, H, L, L))
                            .astype(np.float32)).to(torch.bfloat16)
    scale = D**-0.5
    o, lse = port_fb._plain_fwd(q, k, v, bias, None, scale)
    _, delta = port_fb._plain_bwd_dq(q, k, v, o, do, lse, bias, None, scale)
    want = port_fb._plain_bwd_dbias(q, k, v, do, lse, delta, bias, None,
                                    scale)
    got = port_fb._emulate_tensor_cores(q, k, v, do, bias, None, scale,
                                        o=o)[4]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4,
                               rtol=1e-5)


def test_builder_hashes_included_headers(tmp_path, monkeypatch):
    """A kernel library is named by its source and the headers it
    includes: editing a header names a new library, so a stale build is
    never reused."""
    header = tmp_path / "common.cuh"
    header.write_text("// v1\n")
    src = tmp_path / "kernel.cu"
    src.write_text('#include <cuda_runtime.h>\n#include "common.cuh"\n')
    monkeypatch.setattr(op_builder.FlashBiasBuilder, "SOURCE", str(src))
    builder = op_builder.FlashBiasBuilder()
    assert builder.sources() == [str(src), str(header)]
    before = builder.lib_path()
    assert builder.lib_path() == before
    header.write_text("// v2\n")
    assert builder.lib_path() != before
    # the package's two tensor-core sources share one header
    for cls in (op_builder.FlashBiasBuilder, op_builder.FlashAttentionBuilder):
        monkeypatch.undo()
        names = [p.rsplit("/", 1)[-1] for p in cls().sources()]
        assert "mma_common.cuh" in names, names
