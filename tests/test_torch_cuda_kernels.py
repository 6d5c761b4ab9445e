"""The CUDA kernels against their plain versions, on the card: paged
attention (B4), flash attention forward and backward (B1) and the fused
Adam step (B2).

Marked ``cuda``: each test asks for the ``card`` fixture, which skips when
torch sees no CUDA device.  The file imports neither JAX nor the JAX
package, so it also runs on a machine that has only PyTorch:
``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_cuda_kernels.py``.

Tolerances, elementwise: attention fp32 1e-4 (same fp32 arithmetic,
another summation order); attention bf16 2^-7·|ref| + 1e-4 (both sides
accumulate in fp32 and round each output once to bf16, 8 significant bits,
so they may differ by one ulp of |ref|).  Adam: one fp32 ulp, 2^-23·|ref|
(the kernel and its plain version do the same fp32 operations in the same
order, none contracted into an FMA), and one bf16 ulp for the bf16 copy.
"""

import pytest
import torch

from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
from deepspeed_tpu_torch.ops.kernels import optimizers as opt
from deepspeed_tpu_torch.ops.kernels import paged_attention as pa


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _batch(device, dtype, H, Hkv, Dh, atom, n_tiles, seed, bs=16, maxb=8):
    """Atom tiles of consecutive positions, each with its own distinct
    pages, followed by pad rows (position 0, table of zeros)."""
    g = torch.Generator().manual_seed(seed)
    T = n_tiles * atom
    nb = 1 + n_tiles * maxb
    q = torch.randn(T, H, Dh, generator=g)
    kc = torch.randn(nb, bs, Hkv, Dh, generator=g)
    vc = torch.randn(nb, bs, Hkv, Dh, generator=g)
    tables = torch.zeros(T, maxb, dtype=torch.int32)
    pos = torch.zeros(T, dtype=torch.int32)
    pages = 1 + torch.randperm(nb - 1, generator=g).int()
    for i in range(n_tiles):
        take = int(torch.randint(1, atom + 1, (1, ), generator=g))
        start = int(torch.randint(0, maxb * bs - take + 1, (1, ),
                                  generator=g))
        rows = slice(i * atom, i * atom + take)
        tables[rows] = pages[i * maxb:(i + 1) * maxb]
        pos[rows] = torch.arange(start, start + take, dtype=torch.int32)
    cast = [t.to(device=device, dtype=dtype) for t in (q, kc, vc)]
    return (*cast, tables.to(device), pos.to(device))


def _tol(dtype, ref):
    if dtype == torch.float32:
        return 1e-4
    return 2.0**-7 * ref.abs() + 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("H,Hkv", [(8, 8), (8, 2)], ids=["mha", "gqa"])
@pytest.mark.parametrize("window", [0, 40])
@pytest.mark.parametrize("atom", [1, 4, 16])
def test_kernel_matches_plain(card, dtype, Dh, H, Hkv, window, atom):
    batch = _batch(card, dtype, H, Hkv, Dh, atom, 6,
                   seed=atom * 100 + window + Dh + Hkv)
    before = (pa.paged_attention.launches, pa.paged_attention_atoms.launches)
    if atom == 1:
        got = pa.paged_attention(*batch, window=window)
    else:
        got = pa.paged_attention_atoms(*batch, atom, window=window)
    torch.cuda.synchronize()
    q, kc, vc, tables, pos = batch
    ref = pa.paged_attention_plain(q, kc, vc,
                                   pa._first_row_tables(tables, atom), pos,
                                   window)
    over = (got.float() - ref.float()).abs() / _tol(dtype, ref.float())
    assert over.max().item() <= 1.0, over.max().item()
    after = (pa.paged_attention.launches, pa.paged_attention_atoms.launches)
    assert sum(after) == sum(before) + 1


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(card):
    q, kc, vc, tables, pos = _batch(card, torch.float32, 4, 2, 64, 1, 3, 0)
    with pytest.raises(TypeError, match="int32"):
        pa.paged_attention(q, kc, vc, tables.long(), pos)
    with pytest.raises(TypeError, match="bf16 or fp32"):
        pa.paged_attention(q.half(), kc.half(), vc.half(), tables, pos)
    with pytest.raises(ValueError, match="head_dim"):
        pa.paged_attention(q[..., :32].contiguous(),
                           kc[..., :32].contiguous(),
                           vc[..., :32].contiguous(), tables, pos)
    with pytest.raises(ValueError, match="contiguous"):
        pa.paged_attention(q.transpose(0, 1).contiguous().transpose(0, 1),
                           kc, vc, tables, pos)


# ------------------------------------------------------------ B1 flash
FLASH_CASES = {
    # (B, sq, sk, Hq, Hkv, D, causal, window, alibi)
    "causal": (2, 130, 130, 4, 4, 128, True, 0, False),
    "noncausal_d64": (1, 100, 150, 4, 4, 64, False, 0, False),
    "sq_lt_sk_gqa": (2, 70, 200, 8, 2, 128, True, 0, False),
    "dead_rows": (1, 150, 60, 4, 2, 96, True, 0, False),
    "window_gqa": (1, 300, 300, 8, 2, 128, True, 100, False),
    "alibi": (1, 128, 128, 4, 4, 64, True, 0, True),
}


def _flash_inputs(card, case, dtype):
    B, sq, sk, Hq, Hkv, D, causal, window, alibi = FLASH_CASES[case]
    g = torch.Generator().manual_seed(len(case))
    q, k, v, do = (torch.randn(B, s, h, D, generator=g).to(card, dtype)
                   for s, h in ((sq, Hq), (sk, Hkv), (sk, Hkv), (sq, Hq)))
    slopes = (torch.rand(Hq, generator=g).to(card) * 0.1 if alibi
              else None)
    return q, k, v, do, dict(causal=causal, window=window, slopes=slopes)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_kernels_match_plain(card, case, dtype):
    """Each of the three kernels against its plain version on the same
    inputs (the backward ones on the forward kernel's o and lse)."""
    q, k, v, do, kw = _flash_inputs(card, case, dtype)
    scale = q.shape[-1]**-0.5
    o, lse = fa.flash_attention_fwd(q, k, v, scale, **kw)
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, o, do, lse, scale, **kw)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale, **kw)
    o_ref, lse_ref = fa._plain_fwd(q, k, v, scale, **kw)
    dq_ref, delta_ref = fa._plain_bwd_dq(q, k, v, o, do, lse, scale, **kw)
    dk_ref, dv_ref = fa._plain_bwd_dkv(q, k, v, do, lse, delta, scale, **kw)
    torch.cuda.synchronize()
    for what, got, ref in (("o", o, o_ref), ("dq", dq, dq_ref),
                           ("dk", dk, dk_ref), ("dv", dv, dv_ref)):
        assert torch.isfinite(got).all(), what
        over = (got.float() - ref.float()).abs() / _tol(dtype, ref.float())
        assert over.max().item() <= 1.0, (what, over.max().item())
    for what, got, ref in (("lse", lse, lse_ref), ("delta", delta,
                                                   delta_ref)):
        assert ((got - ref).abs() <= 1e-4 + 1e-5 * ref.abs()).all(), what


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_flash_autograd_launches_each_kernel_once(card, dtype):
    q, k, v, do, kw = _flash_inputs(card, "window_gqa", dtype)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = (fa.flash_attention_fwd.launches,
              fa.flash_attention_bwd_dq.launches,
              fa.flash_attention_bwd_dkv.launches)
    o = fa.flash_attention(*leaves, causal=kw["causal"], window=kw["window"])
    o.backward(do)
    torch.cuda.synchronize()
    after = (fa.flash_attention_fwd.launches,
             fa.flash_attention_bwd_dq.launches,
             fa.flash_attention_bwd_dkv.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
    assert all(torch.isfinite(t.grad).all() for t in leaves)


@pytest.mark.cuda
def test_flash_wrapper_rejects_what_the_kernels_do_not_take(card):
    q = torch.randn(1, 8, 2, 64, device=card)
    with pytest.raises(TypeError, match="bf16 or fp32"):
        fa.flash_attention(q.half(), q.half(), q.half())
    wide = torch.randn(1, 8, 2, 160, device=card)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(wide, wide, wide)
    strided = torch.randn(1, 2, 8, 64, device=card).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(strided, q, q)
    with pytest.raises(ValueError, match="causal"):
        fa.flash_attention(q, q, q, causal=False, window=4)


# ------------------------------------------------------------ B2 adam
@pytest.mark.cuda
@pytest.mark.parametrize("grad_dtype", [torch.float32, torch.bfloat16],
                         ids=["grad_fp32", "grad_bf16"])
@pytest.mark.parametrize("adam_w_mode", [True, False], ids=["adamw", "l2"])
@pytest.mark.parametrize("clip,bf16_out", [(False, True), (True, False)],
                         ids=["copy", "clip"])
def test_fused_adam_kernel_matches_plain(card, grad_dtype, adam_w_mode, clip,
                                         bf16_out):
    n = 1_000_003                               # not a multiple of 4
    g = torch.Generator().manual_seed(n + adam_w_mode)
    grad = torch.randn(n, generator=g).to(card, grad_dtype)
    master = torch.randn(n, generator=g).to(card)
    m = (0.1 * torch.randn(n, generator=g)).to(card)
    v = (0.01 * torch.rand(n, generator=g)).to(card)
    ref = [t.clone() for t in (master, m, v)]
    out = (torch.empty(n, dtype=torch.bfloat16, device=card) if bf16_out
           else None)
    out_ref = None if out is None else out.clone()
    hyper = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8,
                 weight_decay=0.01, count=7, adam_w_mode=adam_w_mode,
                 grad_scale=torch.tensor(0.37, device=card) if clip else None)
    before = opt.fused_adam_step.launches
    opt.fused_adam_step(grad, master, m, v, out, **hyper)
    opt.fused_adam_step_plain([grad], *([t] for t in ref),
                              None if out is None else [out_ref], **hyper)
    torch.cuda.synchronize()
    assert opt.fused_adam_step.launches == before + 1
    for got, want in zip((master, m, v), ref):
        assert ((got - want).abs() <= 2.0**-23 * want.abs()).all()
    if out is not None:
        assert ((out.float() - out_ref.float()).abs() <=
                2.0**-8 * out_ref.float().abs()).all()


@pytest.mark.cuda
def test_fused_adam_wrapper_rejects(card):
    x = torch.zeros(64, device=card)
    hyper = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8,
                 weight_decay=0.0, count=1)
    with pytest.raises(TypeError, match="gradient"):
        opt.fused_adam_step(x.half(), x, x.clone(), x.clone(), **hyper)
    with pytest.raises(ValueError, match="aligned"):
        opt.fused_adam_step(x[1:33], x[1:33], x[1:33], x[1:33], **hyper)
    with pytest.raises(TypeError, match="bf16"):
        opt.fused_adam_step(x, x, x.clone(), x.clone(), x.clone(), **hyper)
