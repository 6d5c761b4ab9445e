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


# The card's bf16/fp16 kernels feed the fp32 P and dS to their tensor-core
# products as hi + lo in the input type (scaled by powers of two in fp16);
# ``_emulate_split_products`` does the same in plain PyTorch.  Held here to
# the card tests' tolerances (bf16 2^-7·|ref| + 1e-4, fp16 2^-10·|ref| +
# 1e-4: one ulp of the output plus fp32 differences) against the plain
# version, which the JAX kernel matches in fp32 on the same (rounded)
# inputs.  Before the outputs' rounding the products are held to the fp32
# plain version within SPLIT_BITS of the output's largest value; rounding
# P and dS once instead (hi alone, as FlashAttention-2 does) breaks both.
SPLIT_CASES = {
    "bf16_causal": dict(shape=(1, 256, 256, 4, 4, 64), dtype="bfloat16",
                        kw=dict(causal=True)),
    "bf16_gqa_alibi_sq_lt_sk": dict(
        shape=(1, 200, 256, 4, 1, 40), dtype="bfloat16",
        kw=dict(causal=True, alibi_slopes=[0.5, 0.25, 0.125, 0.0625])),
    "fp16_gqa_window": dict(shape=(1, 256, 256, 4, 2, 64), dtype="float16",
                            kw=dict(causal=True, window=100)),
    "fp16_noncausal": dict(shape=(2, 256, 192, 2, 2, 32), dtype="float16",
                           kw=dict(causal=False)),
}
# the products' error bound, as a share of the output's largest |value|:
# P and dS keep about 16 (bf16) or 22 (fp16) bits, less what fp32 sums of
# a few hundred terms lose
SPLIT_BITS = {torch.bfloat16: 16, torch.float16: 19}


def _split_tol(dtype, ref):
    rtol = 2.0**-7 if dtype == torch.bfloat16 else 2.0**-10
    return rtol * ref.abs() + 1e-4


def _split_inputs(seed, shape, dtype, do_scale=1.0):
    q, k, v, do = _inputs(seed, *shape)
    return [torch.from_numpy(x).to(dtype)
            for x in (q, k, v, do * np.float32(do_scale))]


def _over_card_tolerance(q, k, v, do, scale, causal, window, slopes,
                         keep_lo):
    """Worst |emulated - plain| / card tolerance over o, dq, dk, dv."""
    dtype = q.dtype
    o, dq, dk, dv = port_fa._emulate_split_products(
        q, k, v, do, scale, causal, window, slopes, keep_lo=keep_lo)
    # the plain versions on the same o, as the card tests hold the kernels
    o_ref, lse = port_fa._plain_fwd(q, k, v, scale, causal, window, slopes)
    dq_ref, delta = port_fa._plain_bwd_dq(q, k, v, o, do, lse, scale, causal,
                                          window, slopes)
    dk_ref, dv_ref = port_fa._plain_bwd_dkv(q, k, v, do, lse, delta, scale,
                                            causal, window, slopes)
    worst = {}
    for name, got, ref in (("o", o, o_ref), ("dq", dq, dq_ref),
                           ("dk", dk, dk_ref), ("dv", dv, dv_ref)):
        assert got.dtype == dtype and torch.isfinite(got).all(), name
        worst[name] = ((got.float() - ref.float()).abs()
                       / _split_tol(dtype, ref.float())).max().item()
    return worst


def _product_bits(q, k, v, do, scale, causal, window, slopes, keep_lo):
    """-log2 of max |emulated - plain| / max |plain| for o, dq, dk, dv in
    fp32 (before the outputs' rounding), the plain version on fp32 copies
    of the same inputs; the backward reads o rounded, as the kernels do."""
    f = [t.float() for t in (q, k, v, do)]
    o_low = port_fa._emulate_split_products(q, k, v, do, scale, causal,
                                            window, slopes)[0]
    got = port_fa._emulate_split_products(q, k, v, do, scale, causal, window,
                                          slopes, keep_lo=keep_lo,
                                          out_dtype=torch.float32)
    o_ref, lse = port_fa._plain_fwd(*f[:3], scale, causal, window, slopes)
    dq_ref, delta = port_fa._plain_bwd_dq(*f[:3], o_low.float(), f[3], lse,
                                          scale, causal, window, slopes)
    dk_ref, dv_ref = port_fa._plain_bwd_dkv(*f, lse, delta, scale, causal,
                                            window, slopes)
    return {name: -np.log2(((g - r).abs().max() / r.abs().max()).item())
            for name, g, r in zip(("o", "dq", "dk", "dv"), got,
                                  (o_ref, dq_ref, dk_ref, dv_ref))}


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_products_hold_the_card_tolerance(case):
    spec = SPLIT_CASES[case]
    dtype = getattr(torch, spec["dtype"])
    # inputs exact in the low-precision type, for both packages
    arrays = _split_inputs(sum(map(ord, case)), spec["shape"], dtype)
    kw = dict(spec["kw"])
    causal, window = kw.get("causal", True), kw.get("window", 0)
    slopes = kw.get("alibi_slopes")
    slopes = None if slopes is None else torch.tensor(slopes)
    args = (*arrays, arrays[0].shape[-1]**-0.5, causal, window, slopes)
    worst = _over_card_tolerance(*args, keep_lo=True)
    assert max(worst.values()) <= 1.0, worst
    bits = _product_bits(*args, keep_lo=True)
    assert min(bits.values()) >= SPLIT_BITS[dtype], bits
    # a single rounding of P and dS is a different function: the card
    # tolerance and the products' bound both reject it
    worst = _over_card_tolerance(*args, keep_lo=False)
    assert max(worst.values()) > 1.0, worst
    bits = _product_bits(*args, keep_lo=False)
    assert max(bits.values()) < SPLIT_BITS[dtype], bits
    # JAX's kernel agrees with the plain version on these inputs in fp32
    f32 = [t.float().numpy() for t in arrays]
    jkw = dict(kw)
    if slopes is not None:
        jkw["alibi_slopes"] = jnp.asarray(slopes.numpy())
    want = _jax(*f32, **jkw)
    pkw = dict(kw)
    if slopes is not None:
        pkw["alibi_slopes"] = slopes
    got = _port(*f32, **pkw)
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)


def _split_error(x, dtype, scale):
    """|hi + lo - x·scale| / scale in float64, hi and lo from the split of
    x·scale (x fp32, scale a power of two)."""
    hi, lo = port_fa._split(x * scale, dtype)
    return (hi.double() + lo.double() - (x * scale).double()).abs() / scale


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
def test_split_keeps_the_bits_of_p_and_ds(dtype):
    """hi + lo keeps 16 (bf16) or 21 (fp16) significant bits of P over
    [2^-18, 1] and of each dS row down to 2^-17 of its largest |dS|, and
    within 2^-38 of that largest value below; values off the 2^-24 grid,
    as exponentials and differences are."""
    bits = 16 if dtype == torch.bfloat16 else 21
    rng = np.random.default_rng(7)
    p = torch.from_numpy(np.exp2(-18 * rng.random(4096)).astype(np.float32))
    err = _split_error(p, dtype, port_fa.P_SCALE[dtype])
    assert (err <= 2.0**-bits * p.double()).all()
    # rows of dS from 2^-30 to 2^20 in size, each spanning 2^-40 of its max
    mag = np.exp2(-40 * rng.random((64, 256)) + rng.uniform(-30, 20, (64, 1)))
    ds = torch.from_numpy((mag * rng.choice([-1, 1], mag.shape))
                          .astype(np.float32))
    amax = ds.abs().amax(-1, keepdim=True)
    err = _split_error(ds, dtype, port_fa._ds_scale(amax, dtype))
    big = ds.abs() >= 2.0**-17 * amax
    assert (err[big] <= 2.0**-bits * ds.abs().double()[big]).all()
    assert (err <= 2.0**-bits * ds.abs().double()
            + 2.0**-38 * amax.double()).all()
    if dtype == torch.float16:
        # unscaled, fp16's lo is subnormal below 2^-3: bits are lost
        assert (_split_error(p, dtype, 1.0)
                > 2.0**-bits * p.double()).any()
        assert (_split_error(ds, dtype, 1.0)
                > 2.0**-bits * ds.abs().double()).any()


@pytest.mark.parametrize("do_scale", [2.0**-14, 2.0**-8, 2.0**10])
def test_fp16_split_products_hold_gradients_of_any_size(do_scale):
    """dS is as large as dO: the fp16 scales keep the products' bound for
    gradients far from 1, where hi + lo unscaled would lose it."""
    spec = SPLIT_CASES["fp16_gqa_window"]
    arrays = _split_inputs(3, spec["shape"], torch.float16, do_scale)
    bits = _product_bits(*arrays, arrays[0].shape[-1]**-0.5, True, 100,
                         None, keep_lo=True)
    assert min(bits.values()) >= SPLIT_BITS[torch.float16], bits
