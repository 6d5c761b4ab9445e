"""The CUDA kernels against their plain versions, on the card: paged
attention (B4), flash attention forward and backward (B1, fp32, bf16 and
fp16), the fused Adam step (B2), the two LAMB phases (B3), the Lion step
(B8), the grouped matmul (B7), blockwise quantize/dequantize (B5) and
the bias-operand flash attention's forward, dq, dk/dv and dbias (B10),
the block-sparse attention forward (B9) and the FP6/FP12 grid quantizer
(B6); and the engine's ZeRO steps on a one-rank NCCL world against ZeRO 0
(ZeRO 3 without a host sync).

Marked ``cuda``: each test asks for the ``card`` fixture, which skips when
torch sees no CUDA device.  The file imports neither JAX nor the JAX
package, so it also runs on a machine that has only PyTorch:
``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_cuda_kernels.py``.

Tolerances, elementwise: attention fp32 1e-4 (same fp32 arithmetic,
another summation order); attention bf16 2^-7·|ref| + 1e-4 and fp16
2^-10·|ref| + 1e-4 (both sides accumulate in fp32 and round each output
once, to 8 or 11 significant bits, so they may differ by one ulp of |ref|;
the bf16/fp16 flash kernels feed P and dS to the tensor cores as hi + lo
in the input type, about 16 or 22 significant bits — in fp16 scaled by
powers of two —, and hold the same tolerances, also over 4096 keys; with
gradients 2^-12 and 2^10 in size, where an absolute 1e-4 would hide their
error, the backward is held to the same relative tolerance plus 2^-12 of
the output's largest value).  The flash kernels are bit-equal across two
runs (no atomics, a fixed summation order).  Paged attention takes the
same tolerances on every route (bf16/fp16: the tensor cores with P as
hi + lo, decode's split states merged in split order) and is bit-equal
across two runs.
Adam: one fp32 ulp, 2^-23·|ref| (the kernel and its plain version do the
same fp32 operations in the same order, none contracted into an FMA), and
one ulp of the copy's type.  LAMB and Lion: m, v, u and Lion's master bit
for bit (the same fp32 operations in the same order); LAMB's per-leaf sums
within 1e-5 relative of float64 sums (fp32 partials in another order), its
ratios within 1e-5, its master within lr·|Δratio|·|u| plus one fp32 ulp
of each rounded product (lr·ratio, and its product with u) and of the
result.  Grouped matmul: fp32 1e-4 + 1e-5·|ref| (fp32 FMA in another
order); bf16 2^-7·|ref| and fp16 2^-10·|ref|, each plus 1e-4 (both sides
sum in fp32 and round once), on every route (wgmma + TMA at 128 and 64
rows a tile, mma.sync), bit-equal over two runs; its backward (dx on
wgmma + TMA or the CUDA cores, dw on wgmma + TMA, mma.sync or the CUDA
cores) one ulp of |ref| in the type plus 2^-10 of the product's rms (both
sum the same products in fp32 in other orders), bit-equal over two runs,
and each expert's dw bit-equal whatever non-finite values its
neighbours' rows hold.  Quantize and dequantize: bit for bit (the
same fp32 operations, a true division and round half to even).  Flash
bias: o, dq, dk, dv as flash attention's (its bf16/fp16 kernels are on
the tensor cores with the same hi + lo design, held also with dO × 2^-12
and × 2^10); lse, delta and the fp32 dbias 1e-4 + 1e-5·|ref| (fp32 sums
in another order; the absolute term scaled with dO); dbias bit for bit
across two runs (a fixed summation order, also where it is split into
chunks summed by a second kernel).  Block-sparse attention: as flash
attention's (fp32 sums in another order: 64 keys a pass where the plain
version takes one layout block a step; bf16/fp16 on the tensor cores
with P as hi + lo, as flash attention's), bit-equal over two runs.  FP quantizer: packed codes and
scales bit for bit.
"""

import pytest
import torch

from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
from deepspeed_tpu_torch.ops.kernels import flash_bias as fb
from deepspeed_tpu_torch.ops.kernels import grouped_matmul as gm
from deepspeed_tpu_torch.ops.kernels import quantizer as qz
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
    if dtype == torch.float16:
        return 2.0**-10 * ref.abs() + 1e-4
    return 2.0**-7 * ref.abs() + 1e-4


def _paged_call(batch, atom, window):
    """One wrapper call; (output, {route: launches} of this call)."""
    fn = pa.paged_attention if atom == 1 else pa.paged_attention_atoms
    before = dict(fn.route_launches), fn.launches
    if atom == 1:
        got = fn(*batch, window=window)
    else:
        got = fn(*batch, atom, window=window)
    torch.cuda.synchronize()
    routes = {r: n - before[0][r] for r, n in fn.route_launches.items()
              if n != before[0][r]}
    assert fn.launches == before[1] + 1
    return got, routes


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16],
                         ids=["fp32", "bf16", "fp16"])
@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("H,Hkv", [(8, 8), (8, 2), (8, 4), (16, 2)],
                         ids=["mha", "gqa", "gqa2", "gqa8"])
@pytest.mark.parametrize("window", [0, 40])
@pytest.mark.parametrize("atom", [1, 4, 16])
def test_kernel_matches_plain(card, dtype, Dh, H, Hkv, window, atom):
    """Every route against the plain version: fp32 on the CUDA cores,
    bf16/fp16 decode and atoms on the tensor cores with 1, 2, 4 or 8 row
    tiles a block (M = atom·H/Hkv up to 128), six tiles split across
    spans; one launch a call, on the route launch_plan names; a second run
    bit for bit the first."""
    batch = _batch(card, dtype, H, Hkv, Dh, atom, 6,
                   seed=atom * 100 + window + Dh + Hkv)
    got, routes = _paged_call(batch, atom, window)
    q, kc, vc, tables, pos = batch
    want = pa.launch_plan(dtype, q.shape[0], H, Hkv, tables.shape[1], atom)
    assert routes == {want[0]: 1}
    ref = pa.paged_attention_plain(q, kc, vc,
                                   pa._first_row_tables(tables, atom), pos,
                                   window)
    over = (got.float() - ref.float()).abs() / _tol(dtype, ref.float())
    assert over.max().item() <= 1.0, over.max().item()
    again, _ = _paged_call(batch, atom, window)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16],
                         ids=["fp32", "bf16", "fp16"])
@pytest.mark.parametrize("Dh", [80, 100, 32, 112])
@pytest.mark.parametrize("window", [0, 40])
@pytest.mark.parametrize("atom", [1, 16])
def test_kernel_matches_plain_at_padded_head_widths(card, dtype, Dh, window,
                                                    atom):
    """Head widths below a tile's (Phi's 80 and OpenLLaMA-3B's 100 in the
    128 tile, 32 in the 64 tile; 80, 112 and 32 copy 16 bytes, 100 copies
    8) on every route, at the same tolerances, bit for bit over two runs."""
    batch = _batch(card, dtype, 8, 2, Dh, atom, 6, seed=atom + window + Dh)
    got, routes = _paged_call(batch, atom, window)
    q, kc, vc, tables, pos = batch
    want = pa.launch_plan(dtype, q.shape[0], 8, 2, tables.shape[1], atom)
    assert routes == {want[0]: 1}
    ref = pa.paged_attention_plain(q, kc, vc,
                                   pa._first_row_tables(tables, atom), pos,
                                   window)
    over = (got.float() - ref.float()).abs() / _tol(dtype, ref.float())
    assert over.max().item() <= 1.0, over.max().item()
    again, _ = _paged_call(batch, atom, window)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
@pytest.mark.parametrize("atom,n_tiles", [(1, 512), (16, 40)])
def test_one_span_writes_the_output(card, dtype, atom, n_tiles):
    """Grids of a full wave or more take one span (no scratch, no merge
    kernel): decode at T·Hkv = 4096 blocks, atoms at 40 tiles × 8 kv heads
    of 64 rows; the block writes the output itself."""
    batch = _batch(card, dtype, 32, 8, 128, atom, n_tiles, seed=7)
    q, _, _, tables, _ = batch
    assert pa.launch_plan(dtype, q.shape[0], 32, 8, tables.shape[1],
                          atom)[1] == 1
    got, routes = _paged_call(batch, atom, 0)
    assert routes == {"decode_split" if atom == 1 else "atom_mma": 1}
    q, kc, vc, tables, pos = batch
    ref = pa.paged_attention_plain(q, kc, vc,
                                   pa._first_row_tables(tables, atom), pos)
    over = (got.float() - ref.float()).abs() / _tol(dtype, ref.float())
    assert over.max().item() <= 1.0, over.max().item()


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(card):
    q, kc, vc, tables, pos = _batch(card, torch.float32, 4, 2, 64, 1, 3, 0)
    with pytest.raises(TypeError, match="int32"):
        pa.paged_attention(q, kc, vc, tables.long(), pos)
    with pytest.raises(TypeError, match="caches of q's dtype"):
        pa.paged_attention(q.half(), kc.bfloat16(), vc.bfloat16(), tables,
                           pos)
    with pytest.raises(ValueError, match="head_dim"):     # odd
        pa.paged_attention(q[..., :33].contiguous(),
                           kc[..., :33].contiguous(),
                           vc[..., :33].contiguous(), tables, pos)
    wide = _batch(card, torch.bfloat16, 4, 2, 136, 1, 3, 0)
    with pytest.raises(ValueError, match="head_dim"):     # above 128
        pa.paged_attention(*wide)
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
    # head dims that are not multiples of 16: zero-padded columns of the
    # tensor-core tiles (72: 16-byte copies; 36: element copies)
    "d72": (2, 150, 150, 4, 2, 72, True, 0, False),
    "d36_noncausal": (1, 90, 70, 4, 4, 36, False, 0, False),
    # sq, sk off the 64-row and 64-key tiles, GQA 4:1 and ALiBi together
    "ragged_gqa_alibi": (2, 200, 333, 8, 2, 128, True, 0, True),
    # 4096-key sums against the unchanged tolerance
    "long": (1, 4096, 4096, 4, 4, 128, True, 0, False),
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16],
                         ids=["fp32", "bf16", "fp16"])
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16],
                         ids=["fp32", "bf16", "fp16"])
@pytest.mark.parametrize("case", ["window_gqa", "ragged_gqa_alibi", "d72"])
def test_flash_kernels_are_deterministic(card, case, dtype):
    """No atomics and a fixed summation order: each kernel run twice on
    the same inputs gives bit-equal o, lse, dq, delta, dk and dv."""
    q, k, v, do, kw = _flash_inputs(card, case, dtype)
    scale = q.shape[-1]**-0.5

    def run():
        o, lse = fa.flash_attention_fwd(q, k, v, scale, **kw)
        dq, delta = fa.flash_attention_bwd_dq(q, k, v, o, do, lse, scale,
                                              **kw)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale,
                                            **kw)
        return dict(o=o, lse=lse, dq=dq, delta=delta, dk=dk, dv=dv)

    first, second = run(), run()
    torch.cuda.synchronize()
    for what in first:
        assert torch.equal(first[what], second[what]), what


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
@pytest.mark.parametrize("do_scale", [2.0**-12, 2.0**10])
def test_flash_backward_holds_gradients_of_any_size(card, dtype, do_scale):
    """dS is as large as dO, and fp16 keeps dS's bits only through its
    power-of-two scales.  Held to 2^-10·|ref| (bf16 2^-7·|ref|) plus 2^-12
    of the output's largest |value| in place of the absolute 1e-4, which
    gradients 2^-12 in size would meet whatever they held."""
    q, k, v, do, kw = _flash_inputs(card, "window_gqa", dtype)
    do = (do.float() * do_scale).to(dtype)
    scale = q.shape[-1]**-0.5
    o, lse = fa.flash_attention_fwd(q, k, v, scale, **kw)
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, o, do, lse, scale, **kw)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale, **kw)
    dq_ref, _ = fa._plain_bwd_dq(q, k, v, o, do, lse, scale, **kw)
    dk_ref, dv_ref = fa._plain_bwd_dkv(q, k, v, do, lse, delta, scale, **kw)
    torch.cuda.synchronize()
    rtol = 2.0**-10 if dtype == torch.float16 else 2.0**-7
    for what, got, ref in (("dq", dq, dq_ref), ("dk", dk, dk_ref),
                           ("dv", dv, dv_ref)):
        ref = ref.float()
        tol = rtol * ref.abs() + 2.0**-12 * ref.abs().max()
        over = (got.float() - ref).abs() / tol
        assert torch.isfinite(got).all(), what
        assert over.max().item() <= 1.0, (what, over.max().item())


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
    with pytest.raises(TypeError, match="bf16, fp16 or fp32"):
        fa.flash_attention(q.double(), q.double(), q.double())
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
@pytest.mark.parametrize("grad_dtype", [torch.float32, torch.bfloat16,
                                        torch.float16],
                         ids=["grad_fp32", "grad_bf16", "grad_fp16"])
@pytest.mark.parametrize("adam_w_mode", [True, False], ids=["adamw", "l2"])
@pytest.mark.parametrize("clip,out_dtype", [(False, torch.bfloat16),
                                            (False, torch.float16),
                                            (True, None)],
                         ids=["copy", "fp16_copy", "clip"])
def test_fused_adam_kernel_matches_plain(card, grad_dtype, adam_w_mode, clip,
                                         out_dtype):
    n = 1_000_003                               # not a multiple of 4
    g = torch.Generator().manual_seed(n + adam_w_mode)
    grad = torch.randn(n, generator=g).to(card, grad_dtype)
    master = torch.randn(n, generator=g).to(card)
    m = (0.1 * torch.randn(n, generator=g)).to(card)
    v = (0.01 * torch.rand(n, generator=g)).to(card)
    ref = [t.clone() for t in (master, m, v)]
    out = (torch.empty(n, dtype=out_dtype, device=card) if out_dtype
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
        assert torch.equal(out, out_ref)


@pytest.mark.cuda
def test_fused_adam_wrapper_rejects(card):
    x = torch.zeros(64, device=card)
    hyper = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8,
                 weight_decay=0.0, count=1)
    with pytest.raises(TypeError, match="gradient"):
        opt.fused_adam_step(x.double(), x, x.clone(), x.clone(), **hyper)
    with pytest.raises(ValueError, match="aligned"):
        opt.fused_adam_step(x[1:33], x[1:33], x[1:33], x[1:33], **hyper)
    with pytest.raises(TypeError, match="bf16"):
        opt.fused_adam_step(x, x, x.clone(), x.clone(), x.clone(), **hyper)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ("adam", "lamb", "lion"))
def test_optimizer_kernels_update_pinned_host_state_in_place(card, kernel):
    """Offloaded optimizer state: master and moments in pinned host memory
    beside a gradient and a bf16 copy on the card take the kernel route
    (one launch, read and written through the device-mapped address) and
    give the same bits as the same launch on device buffers; pageable
    host state is refused."""
    n = 1 << 20
    g = torch.Generator().manual_seed(n)
    grad = torch.randn(n, generator=g).to(card, torch.bfloat16)
    state = [torch.randn(n, generator=g), 0.1 * torch.randn(n, generator=g),
             0.01 * torch.rand(n, generator=g)]
    pinned = [t.pin_memory() for t in state]
    device = [t.to(card) for t in state]
    outs = [torch.empty(n, dtype=torch.bfloat16, device=card)
            for _ in range(2)]
    fn = {"adam": opt.fused_adam_step, "lion": opt.fused_lion_step,
          "lamb": opt.fused_lamb_phase1}[kernel]
    table = opt.LambTable([(0, n // 2), (n // 2, n // 2)], device=card)

    def run(bufs, out):
        if kernel == "adam":
            opt.fused_adam_step(grad, *bufs, out, lr=1e-3, beta1=0.9,
                                beta2=0.999, eps=1e-8, weight_decay=0.01,
                                count=3)
        elif kernel == "lion":
            opt.fused_lion_step(grad, *bufs[:2], out, lr=1e-3, beta1=0.9,
                                beta2=0.99, weight_decay=0.01)
        else:
            opt.fused_lamb_step(grad, *bufs, torch.empty(n, device=card),
                                out, table=table, lr=1e-3, beta1=0.9,
                                beta2=0.999, eps=1e-6, weight_decay=0.01,
                                count=3)

    before = fn.launches
    run(pinned, outs[0])
    run(device, outs[1])
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    assert all(t.is_pinned() for t in pinned)
    for a, b in zip(pinned, device):
        assert torch.equal(a, b.cpu())
    assert torch.equal(outs[0], outs[1])
    with pytest.raises(ValueError, match="pageable"):
        run([t.clone() for t in state], outs[0])


# --------------------------------------------------------- B3 LAMB, B8 Lion
def _opt_state(card, n, grad_dtype, seed):
    g = torch.Generator().manual_seed(seed)
    grad = torch.randn(n, generator=g).to(card, grad_dtype)
    master = torch.randn(n, generator=g).to(card)
    m = (0.1 * torch.randn(n, generator=g)).to(card)
    v = (0.01 * torch.rand(n, generator=g)).to(card)
    return grad, master, m, v


def _leaves(sizes, align=16):
    out, off = [], 0
    for n in sizes:
        out.append((off, n))
        off += -(-n // align) * align
    return out, off


@pytest.mark.cuda
@pytest.mark.parametrize("grad_dtype", [torch.float32, torch.float16,
                                        torch.bfloat16],
                         ids=["grad_fp32", "grad_fp16", "grad_bf16"])
@pytest.mark.parametrize("out_dtype", [torch.float16, torch.bfloat16, None],
                         ids=["fp16_copy", "bf16_copy", "no_copy"])
def test_fused_lamb_kernels_match_plain(card, grad_dtype, out_dtype):
    """Leaves of many sizes (one of several chunks, one of a few elements,
    one of zeros whose ratio is 1), small chunks so that leaves span many
    blocks; two runs of phase 1 give the same bits."""
    sizes = [70_001, 1024, 4096, 3, 33_333, 100]
    leaves, n = _leaves(sizes)
    grad, master, m, v = _opt_state(card, n, grad_dtype, 11)
    master[leaves[-1][0]:leaves[-1][0] + leaves[-1][1]] = 0
    pad = torch.ones(n, dtype=torch.bool, device=card)  # gaps between leaves
    for o, k in leaves:
        pad[o:o + k] = False
    for t in (grad, master, m, v):
        t[pad] = 0
    table = opt.LambTable(leaves, device=card, chunk=4096)
    hyper = dict(beta1=0.9, beta2=0.999, eps=1e-6, weight_decay=0.01,
                 count=3, grad_scale=torch.tensor(0.37, device=card))
    ref = [t.clone() for t in (master, m, v)]
    u = torch.zeros_like(master)
    u_ref = torch.zeros_like(master)
    out = (torch.zeros(n, dtype=out_dtype, device=card) if out_dtype
           else None)
    before = (opt.fused_lamb_phase1.launches, opt.fused_lamb_phase2.launches)
    partials = opt.fused_lamb_phase1(grad, master, m, v, u, table, **hyper)
    m2, v2, u2 = (t.clone() for t in (ref[1], ref[2], u_ref))
    again = opt.fused_lamb_phase1(grad, master, m2, v2, u2, table, **hyper)
    stats = opt.fused_lamb_phase2(master, u, out, table, partials, lr=1e-2)
    torch.cuda.synchronize()
    assert torch.equal(partials, again)
    assert (opt.fused_lamb_phase1.launches, opt.fused_lamb_phase2.launches) \
        == (before[0] + 2, before[1] + 1)
    views = table.views
    sums = opt.fused_lamb_phase1_plain(views(grad), views(ref[0]),
                                       views(ref[1]), views(ref[2]),
                                       views(u_ref), **hyper)
    assert torch.equal(m, ref[1]) and torch.equal(v, ref[2])
    assert torch.equal(u, u_ref)
    for i, (o, k) in enumerate(leaves):
        p0 = ref[0][o:o + k].double()
        uu = u_ref[o:o + k].double()
        want = torch.stack([(p0 * p0).sum(), (uu * uu).sum()])
        assert ((stats[i, :2].double() - want).abs() <=
                1e-5 * want.abs()).all(), i
    ratios = opt.fused_lamb_phase2_plain(views(ref[0]), views(u_ref), None,
                                         sums, lr=1e-2)
    assert stats[-1, 2].item() == 1.0
    assert ((stats[:, 2] - ratios).abs() <= 1e-5 * ratios.abs()).all()
    for i, (o, k) in enumerate(leaves):
        # lr·|Δratio|·|u|, the rounding of lr·ratio and of its product with
        # u (an fp32 ulp each), and one ulp of the new master
        slack = (1e-2 * ((stats[i, 2] - ratios[i]).abs() +
                         2.0**-22 * ratios[i]) * u_ref[o:o + k].abs() +
                 2.0**-23 * ref[0][o:o + k].abs())
        assert ((master[o:o + k] - ref[0][o:o + k]).abs() <=
                slack + 1e-30).all(), i
    if out is not None:
        assert torch.equal(out[~pad], master[~pad].to(out_dtype))
    assert not master[pad].any() and not m[pad].any() and not u[pad].any()


@pytest.mark.cuda
@pytest.mark.parametrize("grad_dtype", [torch.float32, torch.float16],
                         ids=["grad_fp32", "grad_fp16"])
@pytest.mark.parametrize("out_dtype", [torch.float16, torch.bfloat16, None],
                         ids=["fp16_copy", "bf16_copy", "no_copy"])
def test_fused_lion_kernel_matches_plain(card, grad_dtype, out_dtype):
    n = 1_000_003
    grad, master, m, _ = _opt_state(card, n, grad_dtype, 5)
    ref = [master.clone(), m.clone()]
    out = (torch.empty(n, dtype=out_dtype, device=card) if out_dtype
           else None)
    out_ref = None if out is None else out.clone()
    hyper = dict(lr=1e-3, beta1=0.9, beta2=0.99, weight_decay=0.1,
                 grad_scale=torch.tensor(0.5, device=card))
    before = opt.fused_lion_step.launches
    opt.fused_lion_step(grad, master, m, out, **hyper)
    opt.fused_lion_step_plain([grad], [ref[0]], [ref[1]],
                              None if out is None else [out_ref], **hyper)
    torch.cuda.synchronize()
    assert opt.fused_lion_step.launches == before + 1
    assert torch.equal(master, ref[0]) and torch.equal(m, ref[1])
    if out is not None:
        assert torch.equal(out, out_ref)


# ------------------------------------------------------------ B7 gmm
GMM_CASES = {
    # (group sizes, K, N): uneven groups with empty ones, a tile boundary
    # inside a group, K/N edges (multiples of 8, and not)
    "moe_uneven": ([70, 0, 130, 1, 64, 0, 3, 12], 256, 384),
    "decode_2_per_expert": ([2] * 8, 512, 640),
    "one_group": ([200, 0, 0, 0], 128, 128),
    "ragged_kn": ([33, 0, 17, 50], 100, 77),
    "small_k": ([5, 9], 8, 24),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16],
                         ids=["fp32", "bf16", "fp16"])
@pytest.mark.parametrize("case", sorted(GMM_CASES))
def test_gmm_kernel_matches_plain(card, dtype, case):
    sizes, K, N = GMM_CASES[case]
    g = torch.Generator().manual_seed(K + N)
    T, E = sum(sizes), len(sizes)
    x = torch.randn(T, K, generator=g).to(card, dtype)
    w = (torch.randn(E, K, N, generator=g) / K**0.5).to(card, dtype)
    gs = torch.tensor(sizes, dtype=torch.int32, device=card)
    before = gm.gmm.launches
    got = gm.gmm(x, w, gs)
    torch.cuda.synchronize()
    assert gm.gmm.launches == before + 1
    ref = gm.gmm_plain(x, w, gs)
    assert got.dtype == dtype and got.shape == (T, N)
    if dtype == torch.float32:
        tol = 1e-4 + 1e-5 * ref.abs()
    else:
        tol = _tol(dtype, ref.float())
    over = (got.float() - ref.float()).abs() / tol
    assert over.max().item() <= 1.0, over.max().item()


# (group sizes, K, N, rows past the groups) for the TMA routes: groups
# straddling 128-row tiles, empty first and last experts, a one-row group;
# an expert of exactly 64 rows that starts inside a 64-row box, with K and
# N not multiples of dw's 128 x 256 tile
TMA_CASES = {
    "straddle": ([0, 130, 1, 257, 0, 64, 3, 0], 128, 256, 0),
    "rows_past": ([70, 0, 190], 192, 136, 37),
    "decode": ([2] * 8, 256, 384, 0),
    "one_row": ([1], 64, 8, 5),
    "mid_box": ([37, 64, 0, 100, 5], 320, 328, 11),
}


def _gmm_inputs(card, dtype, sizes, K, N, extra):
    g = torch.Generator().manual_seed(K + N + extra)
    T, E = sum(sizes) + extra, len(sizes)
    x = torch.randn(T, K, generator=g).to(card, dtype)
    w = (torch.randn(E, K, N, generator=g) / K**0.5).to(card, dtype)
    return x, w, torch.tensor(sizes, dtype=torch.int32, device=card)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
@pytest.mark.parametrize("route", ["wgmma_tma", "wgmma_tma_64", "mma_sync"])
@pytest.mark.parametrize("case", sorted(TMA_CASES))
def test_gmm_every_route_matches_plain(card, case, route, dtype):
    """Each bf16/fp16 route on the same inputs against the plain version;
    rows past the sum of the sizes are zero; a rerun gives the same
    bits."""
    sizes, K, N, extra = TMA_CASES[case]
    x, w, gs = _gmm_inputs(card, dtype, sizes, K, N, extra)
    got, taken = gm._launch(x, w, gs, route)
    again, _ = gm._launch(x, w, gs, route)
    torch.cuda.synchronize()
    assert taken == route
    ref = gm.gmm_plain(x, w, gs)
    over = (got.float() - ref.float()).abs() / _tol(dtype, ref.float())
    assert over.max().item() <= 1.0, over.max().item()
    assert torch.equal(got, again)
    assert not got[sum(sizes):].any()


@pytest.mark.cuda
def test_gmm_counts_its_launch_by_route_and_refuses_a_wrong_one(card):
    """gmm launches on :func:`gmm_route`'s route and counts it there; the
    C entry refuses a route whose kernel cannot take the arguments (K not
    a multiple of 64, N not of 8, an unaligned x, fp32 on a 16-bit route
    or the other way round) rather than compute a wrong result."""
    x, w, gs = _gmm_inputs(card, torch.bfloat16, [40, 24], 128, 64, 0)
    before = dict(gm.gmm.route_launches)
    gm.gmm(x, w, gs)
    assert gm.gmm.route_launches["wgmma_tma_64"] == \
        before["wgmma_tma_64"] + 1
    base = torch.zeros(64 * 128 + 4, dtype=torch.bfloat16, device=card)
    shifted = base[4:].view(64, 128)                   # 8 bytes off
    for args, route in (
            (_gmm_inputs(card, torch.bfloat16, [40, 24], 96, 64, 0),
             "wgmma_tma"),
            (_gmm_inputs(card, torch.float16, [40, 24], 128, 12, 0),
             "wgmma_tma_64"),
            ((shifted, w, gs), "wgmma_tma_64"),
            ((x, w, gs), "fp32"),
            (_gmm_inputs(card, torch.float32, [40, 24], 128, 64, 0),
             "mma_sync")):
        with pytest.raises(RuntimeError, match=route):
            gm._launch(*args, route)


@pytest.mark.cuda
def test_gmm_rows_past_the_groups_are_zero(card):
    x = torch.randn(10, 16, device=card, dtype=torch.bfloat16)
    w = torch.randn(2, 16, 8, device=card, dtype=torch.bfloat16)
    y = gm.gmm(x, w, torch.tensor([3, 4], dtype=torch.int32, device=card))
    assert torch.equal(y[7:], torch.zeros_like(y[7:]))
    with pytest.raises(TypeError, match="int32"):
        gm.gmm(x, w, torch.tensor([3, 4], device=card))


# ------------------------------------------------------ B7's backward
def _bwd_tol(dtype, ref):
    """One ulp of |ref| in the type (fp32: 1e-5·|ref|), plus 2^-10 of the
    product's rms: both sum the same products in fp32 in other orders."""
    rtol = {torch.float32: 1e-5, torch.bfloat16: 2.0**-7,
            torch.float16: 2.0**-10}[dtype]
    return rtol * ref.abs() + 2.0**-10 * ref.square().mean().sqrt()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16],
                         ids=["fp32", "bf16", "fp16"])
@pytest.mark.parametrize("case", sorted(TMA_CASES))
def test_gmm_backward_kernels_match_plain(card, case, dtype):
    """dx on every route its dtype has (wgmma + TMA at 128 and 64 rows a
    tile, the CUDA cores) and dw (wgmma + TMA and mma.sync for 16-bit, the
    CUDA cores) against their plain versions; reruns bit-equal; dx's rows
    past the groups and an empty expert's dw are zeros."""
    sizes, K, N, extra = TMA_CASES[case]
    x, w, gs = _gmm_inputs(card, dtype, sizes, K, N, extra)
    dy = torch.randn(x.shape[0], N, generator=torch.Generator().manual_seed(
        3)).to(card, dtype)
    want_dx = gm.gmm_dx_plain(dy, w, gs).float()
    want_dw = gm.gmm_dw_plain(x, dy, gs).float()
    for kind, routes, fn, args, want in (
            ("dx", gm.BWD_ROUTES["dx"], gm.gmm_dx, (dy, w, gs), want_dx),
            ("dw", gm.BWD_ROUTES["dw"], gm.gmm_dw, (x, dy, gs), want_dw)):
        for route in routes:
            if dtype == torch.float32 and route != "simt":
                continue
            got, again = fn(*args, route=route), fn(*args, route=route)
            torch.cuda.synchronize()
            over = (got.float() - want).abs() / _bwd_tol(dtype, want)
            assert over.max().item() <= 1.0, (kind, route, over.max())
            assert torch.equal(got, again), (kind, route)
    assert not gm.gmm_dx(dy, w, gs)[sum(sizes):].any()
    dw = gm.gmm_dw(x, dy, gs)
    for e, n in enumerate(sizes):
        if n == 0:
            assert not dw[e].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
@pytest.mark.parametrize("case", sorted(TMA_CASES))
def test_gmm_dw_keeps_a_neighbours_nonfinite_rows_out(card, case, dtype):
    """An expert's last rows share a box with the next experts' (and with
    the rows past the groups): with -inf in x and +inf in dy on every
    other expert's rows, and NaN past the groups, each of the other
    experts' dw is finite and bit-equal to the run on clean inputs, on
    every 16-bit dw route; an empty expert's dw is exactly zero."""
    sizes, K, N, extra = TMA_CASES[case]
    x, _, gs = _gmm_inputs(card, dtype, sizes, K, N, extra)
    dy = torch.randn(x.shape[0], N, generator=torch.Generator().manual_seed(
        5)).to(card, dtype)
    starts = [sum(sizes[:e]) for e in range(len(sizes))]
    live = [e for e, n in enumerate(sizes) if n]
    for parity in (0, 1):
        bad = live[parity::2]
        xp, dyp = x.clone(), dy.clone()
        for e in bad:
            xp[starts[e]:starts[e] + sizes[e]] = -float("inf")
            dyp[starts[e]:starts[e] + sizes[e]] = float("inf")
        xp[sum(sizes):] = float("nan")
        dyp[sum(sizes):] = float("nan")
        for route in gm.BWD_ROUTES["dw"]:
            clean = gm.gmm_dw(x, dy, gs, route=route)
            got = gm.gmm_dw(xp, dyp, gs, route=route)
            torch.cuda.synchronize()
            for e in range(len(sizes)):
                if e in bad:
                    assert not got[e].isfinite().all(), (route, e)
                    continue
                assert got[e].isfinite().all(), (route, parity, e)
                assert torch.equal(got[e], clean[e]), (route, parity, e)
                if sizes[e] == 0:
                    assert not got[e].any(), (route, e)


@pytest.mark.cuda
def test_gmm_dw_refuses_a_route_that_cannot_take_the_arguments(card):
    """The dw entry refuses wgmma + TMA for K or N not a multiple of 8, an
    unaligned x, or fp32, and mma.sync for fp32, rather than compute a
    wrong result; the wrapper picks mma.sync for those 16-bit shapes."""
    x, _, gs = _gmm_inputs(card, torch.bfloat16, [40, 24], 100, 64, 0)
    dy = torch.randn(64, 64, device=card, dtype=torch.bfloat16)
    base = torch.zeros(64 * 128 + 4, dtype=torch.bfloat16, device=card)
    shifted = base[4:].view(64, 128)                   # 8 bytes off
    for args, route in (((x, dy, gs), "wgmma_tma"),
                        ((dy, x[:, :60].contiguous(), gs), "wgmma_tma"),
                        ((shifted, dy, gs), "wgmma_tma"),
                        ((x.float(), dy.float(), gs), "wgmma_tma"),
                        ((x.float(), dy.float(), gs), "mma_sync")):
        with pytest.raises(RuntimeError, match=route):
            gm.gmm_dw(*args, route=route)
    before = dict(gm.gmm_dw.route_launches)
    got = gm.gmm_dw(x, dy, gs)
    assert gm.gmm_dw.route_launches["mma_sync"] == before["mma_sync"] + 1
    want = gm.gmm_dw_plain(x, dy, gs).float()
    over = (got.float() - want).abs() / _bwd_tol(torch.bfloat16, want)
    assert over.max().item() <= 1.0


@pytest.mark.cuda
def test_gmm_autograd_launches_the_backward_kernels(card):
    """Through ``gmm`` under autograd: one dx and one dw launch a
    backward, on :func:`gmm_bwd_route`'s routes, and the gradients are
    the kernels' own; with x detached only dw launches."""
    x, w, gs = _gmm_inputs(card, torch.bfloat16, [300, 0, 212], 128, 256, 0)
    x.requires_grad_(True)
    w.requires_grad_(True)
    dy = torch.randn(x.shape[0], 256, device=card, dtype=torch.bfloat16)
    before = (gm.gmm_dx.launches, gm.gmm_dw.launches,
              dict(gm.gmm_dx.route_launches), dict(gm.gmm_dw.route_launches))
    gx, gw = torch.autograd.grad(gm.gmm(x, w, gs), (x, w), dy)
    assert (gm.gmm_dx.launches, gm.gmm_dw.launches) == \
        (before[0] + 1, before[1] + 1)
    assert gm.gmm_dx.route_launches["wgmma_tma"] == \
        before[2]["wgmma_tma"] + 1
    assert gm.gmm_dw.route_launches["wgmma_tma"] == \
        before[3]["wgmma_tma"] + 1
    assert torch.equal(gx, gm.gmm_dx(dy, w.detach(), gs))
    assert torch.equal(gw, gm.gmm_dw(x.detach(), dy, gs))
    n = gm.gmm_dx.launches
    torch.autograd.grad(gm.gmm(x.detach(), w, gs), (w, ), dy)
    assert gm.gmm_dx.launches == n


# ------------------------------------------------------------ B5 quantizer
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16],
                         ids=["fp32", "bf16", "fp16"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("group_size", [128, 2048, 300, 8192, 640, 1024])
@pytest.mark.parametrize("shape,offset", [((37, 300), 0), ((4096, 512), 0),
                                          ((1001, ), 1), ((1920, 512), 0)],
                         ids=["partial_group", "aligned", "misaligned",
                              "whole"])
def test_quantizer_kernels_match_plain(card, dtype, bits, group_size, shape,
                                       offset):
    """``offset`` 1 starts the input one element into its storage, so the
    kernel takes its unvectorised path; group 300 is clamped to 256.  The
    group sizes reach every kernel of the one-pass scheme: 1, 2, 4 and 8
    units a lane (128/300/640 in teams of 8 lanes, 1024, 2048), and groups
    read twice (8192); ``whole`` divides by every group size, so each is
    also reached by its kernel for whole, aligned groups."""
    g = torch.Generator().manual_seed(bits + group_size)
    n = 1
    for d in shape:
        n *= d
    base = (torch.randn(n + offset, generator=g) * 3).to(card, dtype)
    x = base[offset:].view(shape)
    x.view(-1)[:256] = 0                          # an all-zero group
    before = (qz.quantize_blockwise.launches,
              qz.dequantize_blockwise.launches)
    q, s, meta = qz.quantize_blockwise(x, bits, group_size)
    q_ref, s_ref, meta_ref = qz.quantize_blockwise_plain(x, bits, group_size)
    torch.cuda.synchronize()
    assert meta == meta_ref
    assert torch.equal(q, q_ref) and torch.equal(s, s_ref)
    got = qz.dequantize_blockwise(q, s, meta)
    want = qz.dequantize_blockwise_plain(q, s, meta)
    assert got.dtype == dtype and torch.equal(got, want)
    assert (qz.quantize_blockwise.launches,
            qz.dequantize_blockwise.launches) == (before[0] + 1,
                                                  before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("group_size", [128, 2048])
@pytest.mark.parametrize("fmt", ["int8", "int4", "fp8", "fp6", "fp12"])
def test_wire_codecs_match_plain_on_a_shard(card, fmt, group_size, dtype):
    """ZeRO++'s wire codecs (``comm/collectives/quantized.py:wire_codec``:
    B5 for int8/int4, B6 for fp6/fp12, the e4m3fn cast for fp8) on a unit
    slice whose length is no multiple of the group (its last group padded),
    against the plain versions on the same values: codes, scales and the
    decode bit for bit, the decode also written into a view of a larger
    buffer (``out=``, as a gather dequantizes each rank's part in place).
    """
    from deepspeed_tpu_torch.comm.collectives import quantized as Q
    from deepspeed_tpu_torch.ops import fp_quantizer as fpq
    from deepspeed_tpu_torch.ops.kernels import fp_quantizer as kfp
    g = torch.Generator().manual_seed(group_size + len(fmt))
    n = 7 * group_size + 1000
    x = (torch.randn(n, generator=g) * 3).to(card, dtype)
    x[:group_size] = 0                            # an all-zero group
    quant, dequant = Q.wire_codec(fmt, group_size)
    before = (qz.quantize_blockwise.launches,
              qz.dequantize_blockwise.launches,
              kfp.quantize_fp_packed.launches)
    q, s, meta = quant(x)
    if fmt in ("int8", "int4"):
        q_ref, s_ref, meta_ref = qz.quantize_blockwise_plain(
            x, 8 if fmt == "int8" else 4, group_size)
    elif fmt == "fp8":
        q_ref, s_ref, meta_ref = q, s, meta       # the cast: no kernel
    else:
        bits, man = Q._FP_FORMATS[fmt]
        q_ref, s_ref = kfp.quantize_fp_packed_plain(
            x, bits, man, Q.effective_group_size(group_size))
        meta_ref = meta
    torch.cuda.synchronize()
    assert meta == meta_ref
    assert torch.equal(q, q_ref) and torch.equal(s, s_ref)
    big = torch.full((3 * n, ), 7.0, dtype=dtype, device=card)
    got = dequant(q, s, meta, out=big[n:2 * n])
    assert got.data_ptr() == big[n:].data_ptr()
    want = (qz.dequantize_blockwise_plain(q, s, meta)
            if fmt in ("int8", "int4") else fpq.dequantize_fp(q, s, meta))
    assert torch.equal(big[n:2 * n], want)
    assert bool((big[:n] == 7).all() and (big[2 * n:] == 7).all())
    launched = (qz.quantize_blockwise.launches - before[0],
                qz.dequantize_blockwise.launches - before[1],
                kfp.quantize_fp_packed.launches - before[2])
    assert launched == {"int8": (1, 1, 0), "int4": (1, 1, 0),
                        "fp8": (0, 0, 0), "fp6": (0, 0, 1),
                        "fp12": (0, 0, 1)}[fmt]


def _quant_routed(x, bits, group_size):
    """quantize_blockwise on the card held bit for bit to its plain
    version; the routes the call counted."""
    before = dict(qz.quantize_blockwise.route_launches)
    q, s, meta = qz.quantize_blockwise(x, bits, group_size)
    torch.cuda.synchronize()
    routes = [r for r, n in qz.quantize_blockwise.route_launches.items()
              if n != before[r]]
    q_ref, s_ref, meta_ref = qz.quantize_blockwise_plain(x, bits, group_size)
    assert meta == meta_ref
    assert torch.equal(q, q_ref) and torch.equal(s, s_ref)
    return routes


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16],
                         ids=["fp32", "bf16", "fp16"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("group_size", [128, 256])
@pytest.mark.parametrize("out,inp", [(512, 136), (1024, 64), (256, 1000)],
                         ids=["in_past_a_tile", "one_tile", "in_1000"])
def test_quantizer_reads_a_transposed_weight_as_it_lies(card, dtype, bits,
                                                        group_size, out,
                                                        inp):
    """``p.t()`` of a row-major [out, in] weight (the serving path's
    layout) takes the transposed route, bit for bit against the plain
    version of the same view, with an all-zero group and values at ties
    of the rounding."""
    g = torch.Generator().manual_seed(out + inp + bits)
    p = (torch.randn(out, inp, generator=g) * 3).to(card, dtype)
    p[:group_size, 5] = 0                         # an all-zero group
    # absmax 127: scale 1 in int8, and 63.5, -0.5, 2.5 sit at ties
    p[:4, 7] = torch.tensor([127.0, 63.5, -0.5, 2.5])
    assert _quant_routed(p.t(), bits, group_size) == ["transposed"]


@pytest.mark.cuda
def test_quantizer_routes_other_layouts_through_a_copy(card):
    """A strided slice, the ``p.t()`` of an fp32 p whose rows (510
    values) are not 16-byte aligned, and a transposed view whose ``out`` is
    not a multiple of the group take the copy route; a contiguous tensor
    the contiguous one; all bit for bit."""
    x = torch.randn(256, 512, device=card, dtype=torch.bfloat16)
    assert _quant_routed(x[:, ::2], 8, 128) == ["copy"]
    assert _quant_routed(x.float()[:, :510].contiguous().t(), 8,
                         128) == ["copy"]
    assert _quant_routed(x[:200].t(), 8, 128) == ["copy"]
    assert _quant_routed(x, 8, 128) == ["contiguous"]


def _every_16_bit_value(card, dtype, rounds=8):
    """Groups of exact int8 rounding ties (absmax 127 · 2^e, the rest
    (k + 0.5) · 2^e, e in [-12, 8]: normal in bf16 and fp16), then every
    finite bf16 or fp16 value ``rounds`` times in random orders (random
    group scales), as [rows, 2048] with rows % 8 == 0."""
    vals = torch.arange(65536, dtype=torch.int32).to(torch.int16).view(dtype)
    vals = vals[torch.isfinite(vals.float())]
    g = torch.Generator().manual_seed(0)
    k = torch.arange(-127, 127, dtype=torch.float32) + 0.5
    ties = [torch.cat([torch.tensor([127.0]), k, torch.zeros(1)]) * 2.0**e
            for e in range(-12, 9)]
    x = torch.cat(ties + [vals[torch.randperm(vals.numel(),
                                              generator=g)].float()
                          for _ in range(rounds)])
    return x[:x.numel() // 16384 * 16384].to(card, dtype).view(-1, 2048)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
def test_quantizers_bit_equal_on_every_16_bit_value(card, dtype):
    """Every bf16/fp16 value at random scales and at exact rounding ties,
    bit for bit against the plain versions: B5's quantize on both read
    routes, and B6's packed FP6/FP12."""
    from deepspeed_tpu_torch.ops.kernels import fp_quantizer as kfq
    x = _every_16_bit_value(card, dtype)
    for bits in (8, 4):
        for gs in (128, 256):
            assert _quant_routed(x, bits, gs) == ["contiguous"]
            assert _quant_routed(x.t().contiguous().t(), bits,
                                 gs) == ["transposed"]
    for q_bits, man in ((6, 2), (12, 7)):
        for gs in (128, 512):
            got = kfq.quantize_fp_packed(x, q_bits, man, gs)
            ref = kfq.quantize_fp_packed_plain(x, q_bits, man, gs)
            assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


# ------------------------------------------------------------ B10 flash bias
FLASH_BIAS_CASES = {
    # (B, sq, sk, H, D, bias [Bb, Hb], mask rows, causal, fp32 bias)
    "msa_d32_mask": (6, 100, 100, 4, 32, (2, 4), 6, False, False),
    "grouped_heads": (3, 70, 70, 4, 32, (1, 2), 3, False, False),
    "causal_dead_rows_d16": (2, 90, 60, 2, 16, (2, 2), 0, True, False),
    "causal_sq_lt_sk_d128": (1, 80, 150, 2, 128, (1, 1), 1, True, False),
    "d64_fp32_bias": (2, 130, 130, 2, 64, (1, 1), 2, False, True),
    "unaligned_d12": (2, 37, 29, 3, 12, (2, 3), 0, False, False),
    # a group of 64 members: the bf16/fp16 dbias splits it into 4 chunks
    "msa_group64_split": (64, 100, 100, 4, 32, (1, 4), 64, False, False),
}


def _flash_bias_inputs(card, case, dtype):
    """q, k, v, do, bias and a 0 / -1e9 key mask: the last 7 keys masked
    in every row, batch row 1 masked whole."""
    B, sq, sk, H, D, (Bb, Hb), mrows, causal, f32 = FLASH_BIAS_CASES[case]
    g = torch.Generator().manual_seed(len(case))
    q, do = (torch.randn(B, sq, H, D, generator=g).to(card, dtype)
             for _ in range(2))
    k, v = (torch.randn(B, sk, H, D, generator=g).to(card, dtype)
            for _ in range(2))
    bias = (torch.randn(Bb, Hb, sq, sk, generator=g) * 0.5).to(
        card, torch.float32 if f32 else dtype)
    mask = None
    if mrows:
        keep = torch.ones(mrows, 1, 1, sk)
        keep[..., sk - 7:] = 0
        keep[min(1, mrows - 1)] = 0
        mask = (-1e9 * (1 - keep)).to(card)
    return q, k, v, do, bias, mask, causal


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16],
                         ids=["fp32", "bf16", "fp16"])
@pytest.mark.parametrize("case", sorted(FLASH_BIAS_CASES))
def test_flash_bias_kernels_match_plain(card, case, dtype):
    """Each of the four kernels against its plain version on the same
    inputs (the backward ones on the forward kernel's o and lse, and the
    dq kernel's delta); dbias bit-identical across two runs.  Tolerances:
    o, dq, dk, dv as the flash kernels'; lse, delta and the fp32 dbias
    1e-4 + 1e-5·|ref| (fp32 sums in another order)."""
    q, k, v, do, bias, mask, causal = _flash_bias_inputs(card, case, dtype)
    args = (bias, mask, q.shape[-1]**-0.5, causal)
    o, lse = fb.flash_bias_fwd(q, k, v, *args)
    dq, delta = fb.flash_bias_bwd_dq(q, k, v, o, do, lse, *args)
    dk, dv = fb.flash_bias_bwd_dkv(q, k, v, do, lse, delta, *args)
    dbias = fb.flash_bias_bwd_dbias(q, k, v, do, lse, delta, *args)
    again = fb.flash_bias_bwd_dbias(q, k, v, do, lse, delta, *args)
    o_ref, lse_ref = fb._plain_fwd(q, k, v, *args)
    dq_ref, delta_ref = fb._plain_bwd_dq(q, k, v, o, do, lse, *args)
    dk_ref, dv_ref = fb._plain_bwd_dkv(q, k, v, do, lse, delta, *args)
    dbias_ref = fb._plain_bwd_dbias(q, k, v, do, lse, delta, *args)
    torch.cuda.synchronize()
    for what, got, ref in (("o", o, o_ref), ("dq", dq, dq_ref),
                           ("dk", dk, dk_ref), ("dv", dv, dv_ref)):
        assert got.dtype == dtype and torch.isfinite(got).all(), what
        over = (got.float() - ref.float()).abs() / _tol(dtype, ref.float())
        assert over.max().item() <= 1.0, (what, over.max().item())
    for what, got, ref in (("lse", lse, lse_ref), ("delta", delta,
                                                   delta_ref),
                           ("dbias", dbias, dbias_ref)):
        assert got.dtype == torch.float32 and got.shape == ref.shape, what
        assert ((got - ref).abs() <= 1e-4 + 1e-5 * ref.abs()).all(), what
    assert torch.equal(dbias, again)
    if causal and q.shape[1] > k.shape[1]:
        dead = q.shape[1] - k.shape[1]
        assert (lse[:, :, :dead] == fb.DEAD_ROW_LSE).all()
        assert not o[:, :dead].any() and not dq[:, :dead].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
@pytest.mark.parametrize("do_scale", [2.0**-12, 2.0**10])
def test_flash_bias_backward_holds_gradients_of_any_size(card, dtype,
                                                         do_scale):
    """B10's twin of the flash test above: dS is as large as dO, and fp16
    keeps dS's bits only through its power-of-two scales.  dq, dk, dv
    held to 2^-10·|ref| (bf16 2^-7·|ref|) plus 2^-12 of the output's
    largest |value|; dbias, linear in dO, to the usual 1e-5·|ref| with
    its absolute 1e-4 scaled by dO's factor."""
    q, k, v, do, bias, mask, causal = _flash_bias_inputs(
        card, "msa_group64_split", dtype)
    do = (do.float() * do_scale).to(dtype)
    args = (bias, mask, q.shape[-1]**-0.5, causal)
    o, lse = fb.flash_bias_fwd(q, k, v, *args)
    dq, delta = fb.flash_bias_bwd_dq(q, k, v, o, do, lse, *args)
    dk, dv = fb.flash_bias_bwd_dkv(q, k, v, do, lse, delta, *args)
    dbias = fb.flash_bias_bwd_dbias(q, k, v, do, lse, delta, *args)
    dq_ref, _ = fb._plain_bwd_dq(q, k, v, o, do, lse, *args)
    dk_ref, dv_ref = fb._plain_bwd_dkv(q, k, v, do, lse, delta, *args)
    dbias_ref = fb._plain_bwd_dbias(q, k, v, do, lse, delta, *args)
    torch.cuda.synchronize()
    rtol = 2.0**-10 if dtype == torch.float16 else 2.0**-7
    for what, got, ref in (("dq", dq, dq_ref), ("dk", dk, dk_ref),
                           ("dv", dv, dv_ref)):
        ref = ref.float()
        tol = rtol * ref.abs() + 2.0**-12 * ref.abs().max()
        over = (got.float() - ref).abs() / tol
        assert torch.isfinite(got).all(), what
        assert over.max().item() <= 1.0, (what, over.max().item())
    tol = 1e-4 * do_scale + 1e-5 * dbias_ref.abs()
    assert ((dbias - dbias_ref).abs() <= tol).all()


@pytest.mark.cuda
def test_flash_bias_takes_a_bias_of_the_other_16_bit_type(card):
    """fp16 inputs with a bf16 bias: the tensor-core kernels read a bias in
    the input type or fp32, so the wrapper hands them this one in fp32
    (exact); every output equals the run given that fp32 bias, bit for
    bit."""
    q, k, v, do, bias, mask, causal = _flash_bias_inputs(
        card, "msa_d32_mask", torch.float16)
    b16 = bias.to(torch.bfloat16)

    def run(b):
        args = (b, mask, q.shape[-1]**-0.5, causal)
        o, lse = fb.flash_bias_fwd(q, k, v, *args)
        dq, delta = fb.flash_bias_bwd_dq(q, k, v, o, do, lse, *args)
        dk, dv = fb.flash_bias_bwd_dkv(q, k, v, do, lse, delta, *args)
        dbias = fb.flash_bias_bwd_dbias(q, k, v, do, lse, delta, *args)
        return o, lse, dq, delta, dk, dv, dbias

    got, want = run(b16), run(b16.float())
    torch.cuda.synchronize()
    for what, a, b in zip(("o", "lse", "dq", "delta", "dk", "dv", "dbias"),
                          got, want):
        assert torch.equal(a, b), what


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_flash_bias_autograd_launches_each_kernel_once(card, dtype,
                                                       monkeypatch):
    """A CUDA tensor never reaches a plain version: with every plain
    version made to raise, one forward and backward still runs, on one
    launch of each kernel; the bias's gradient keeps its dtype and the
    mask gets none."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")

    for name in ("_plain_fwd", "_plain_bwd_dq", "_plain_bwd_dkv",
                 "_plain_bwd_dbias"):
        monkeypatch.setattr(fb, name, refuse)
    q, k, v, do, bias, mask, _ = _flash_bias_inputs(card, "msa_d32_mask",
                                                    dtype)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v, bias)]
    mask.requires_grad_(True)
    counters = (fb.flash_bias_fwd, fb.flash_bias_bwd_dq,
                fb.flash_bias_bwd_dkv, fb.flash_bias_bwd_dbias)
    before = [c.launches for c in counters]
    fb.flash_attention_bias(*leaves, mask_bias=mask).backward(do)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [1] * 4
    assert all(torch.isfinite(t.grad).all() for t in leaves)
    assert leaves[3].grad.dtype == dtype and mask.grad is None


@pytest.mark.cuda
def test_flash_bias_build_failure_raises(card, monkeypatch, tmp_path):
    """A source that does not compile raises on the first call; nothing
    falls back to the plain version."""
    from deepspeed_tpu_torch.ops import op_builder
    broken = tmp_path / "flash_bias.cu"
    broken.write_text("this is not CUDA\n")
    monkeypatch.setenv("DS_TORCH_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(op_builder.FlashBiasBuilder, "SOURCE", str(broken))
    monkeypatch.delitem(op_builder.CUDAOpBuilder._libs, "flash_bias",
                        raising=False)
    q = torch.randn(1, 16, 2, 32, device=card)
    bias = torch.randn(1, 2, 16, 16, device=card)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        fb.flash_attention_bias(q, q, q, bias)


@pytest.mark.cuda
def test_flash_bias_wrapper_rejects_what_the_kernels_do_not_take(card):
    q = torch.randn(2, 8, 2, 32, device=card)
    bias = torch.randn(1, 2, 8, 8, device=card)
    with pytest.raises(TypeError, match="bf16, fp16 or fp32"):
        fb.flash_attention_bias(q.double(), q.double(), q.double(), bias)
    wide = torch.randn(1, 8, 2, 160, device=card)
    with pytest.raises(ValueError, match="head_dim"):
        fb.flash_attention_bias(wide, wide, wide, bias[:1])
    strided = torch.randn(2, 2, 8, 32, device=card).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fb.flash_attention_bias(strided, q, q, bias)
    with pytest.raises(TypeError, match="mask_bias must be fp32"):
        fb.flash_bias_fwd(q, q, q, bias, torch.zeros(2, 1, 1, 8,
                                                     device=card).half(),
                          0.1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fb.flash_bias_fwd(q.cpu(), q.cpu(), q.cpu(), bias.cpu(), None, 0.1)


# ------------------------------------------------- B9 block-sparse attention
def _bsa_layout(H, nb, causal, seed):
    """Per-head random layouts, about half the blocks live, with key block
    0 live in every row but row 1 of head 0, which has no live block."""
    g = torch.Generator().manual_seed(seed)
    layout = torch.rand(H, nb, nb, generator=g) < 0.5
    layout[:, :, 0] = True
    if causal:
        layout &= torch.tril(torch.ones(nb, nb, dtype=torch.bool))
    layout[0, 1, :] = False
    return layout.numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16],
                         ids=["fp32", "bf16", "fp16"])
@pytest.mark.parametrize("causal", [False, True], ids=["bidir", "causal"])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("block", [16, 32, 64, 128])
def test_block_sparse_kernel_matches_plain(card, block, D, causal, dtype):
    """One launch against the plain version on the same inputs, per-head
    layouts with an empty row (which must give 0); the [B, H, S, D]
    entry's transposed views without a copy give the same bits as
    contiguous inputs."""
    from deepspeed_tpu_torch.ops.kernels import block_sparse_attention as bs
    B, H, nb = 2, 3, 5
    S = nb * block
    layout = _bsa_layout(H, nb, causal, block + D)
    g = torch.Generator().manual_seed(D)
    q, k, v = (torch.randn(B, H, S, D, generator=g).to(card, dtype)
               .transpose(1, 2) for _ in range(3))         # strided views
    before = bs.block_sparse_attention_fwd.launches
    o = bs.block_sparse_attention_fwd(q, k, v, layout, block, causal=causal)
    again = bs.block_sparse_attention_fwd(
        *(t.contiguous() for t in (q, k, v)), layout, block, causal=causal)
    ref = bs.block_sparse_attention_plain(q, k, v, layout, block,
                                          causal=causal)
    torch.cuda.synchronize()
    assert bs.block_sparse_attention_fwd.launches == before + 2
    assert o.dtype == dtype and o.shape == (B, S, H, D) and o.is_contiguous()
    assert torch.isfinite(o).all() and torch.equal(o, again)
    over = (o.float() - ref.float()).abs() / _tol(dtype, ref.float())
    assert over.max().item() <= 1.0, over.max().item()
    assert not o[:, block:2 * block, 0].any()             # the empty row


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
@pytest.mark.parametrize("name,block,causal,D", [
    ("fixed", 16, False, 64), ("fixed", 16, True, 64),
    ("bigbird", 16, False, 64), ("bigbird", 32, True, 40),
    ("fixed", 32, False, 24), ("bigbird", 64, False, 15),
    ("fixed", 128, True, 128)])
def test_block_sparse_tensor_core_row_groups(card, name, block, causal, D,
                                             dtype):
    """The tensor-core route on the package's layouts: "fixed" windows
    sharing one key list (block 16), BigBird groups split into one q block
    each, row groups of half a q block (block 128); head dims that take
    16-byte (64, 128), 4-byte (24, 40) and element (15) copies; against
    the plain version, bit-equal over two runs."""
    from deepspeed_tpu_torch.ops import sparse_attention as sa
    from deepspeed_tpu_torch.ops.kernels import block_sparse_attention as bs
    H, nb, B = 4, 16, 2
    kw = dict(num_heads=H, block=block, different_layout_per_head=True)
    if causal:
        kw["attention"] = "unidirectional"
    cfg = (sa.FixedSparsityConfig(num_local_blocks=4, num_global_blocks=1,
                                  num_different_global_patterns=4, **kw)
           if name == "fixed" else
           sa.BigBirdSparsityConfig(num_random_blocks=3, seed=5, **kw))
    S = nb * block
    layout = cfg.make_layout(S)
    g = torch.Generator().manual_seed(block + D)
    q, k, v = (torch.randn(B, S, H, D, generator=g).to(card, dtype)
               for _ in range(3))
    o = bs.block_sparse_attention_fwd(q, k, v, layout, block, causal=causal)
    again = bs.block_sparse_attention_fwd(q, k, v, layout, block,
                                          causal=causal)
    ref = bs.block_sparse_attention_plain(q, k, v, layout, block,
                                          causal=causal)
    torch.cuda.synchronize()
    assert torch.equal(o, again) and torch.isfinite(o).all()
    over = (o.float() - ref.float()).abs() / _tol(dtype, ref.float())
    assert over.max().item() <= 1.0, over.max().item()


@pytest.mark.cuda
def test_block_sparse_autograd_and_dispatch(card, monkeypatch):
    """A CUDA tensor never reaches the plain version: one kernel launch per
    forward; the backward is the gather formulation's autograd (no kernel
    launch), equal to its gradients; ``SparseSelfAttention`` takes the
    kernel on CUDA tensors, and the gather formulation under
    ``DS_TPU_DISABLE_PALLAS_ATTN``."""
    from deepspeed_tpu_torch.ops import sparse_attention as sa
    from deepspeed_tpu_torch.ops.kernels import block_sparse_attention as bs

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(bs, "block_sparse_attention_plain", refuse)
    cfg = sa.BigBirdSparsityConfig(num_heads=4, block=64,
                                   num_random_blocks=2)
    layout = cfg.make_layout(512)
    g = torch.Generator().manual_seed(3)
    q, k, v, do = (torch.randn(2, 512, 4, 64, generator=g).to(card)
                   for _ in range(4))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = bs.block_sparse_attention_fwd.launches
    out = bs.block_sparse_flash_attention(*leaves, layout, 64)
    out.backward(do)
    assert bs.block_sparse_attention_fwd.launches == before + 1
    ref = sa.sparse_attention(*ref_leaves, layout, 64)
    ref.backward(do)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= 1e-4
    # the same autograd graph; the gather's backward sums with atomics,
    # in an order that may change between runs
    for a, b in zip(leaves, ref_leaves):
        assert ((a.grad - b.grad).abs() <= 1e-5 + 1e-5 * b.grad.abs()).all()
    attn = sa.SparseSelfAttention(cfg)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))    # [B, H, S, D]
    before = bs.block_sparse_attention_fwd.launches
    o = attn(qh, kh, vh)
    assert bs.block_sparse_attention_fwd.launches == before + 1
    monkeypatch.setenv("DS_TPU_DISABLE_PALLAS_ATTN", "1")
    o_gather = attn(qh, kh, vh)
    assert bs.block_sparse_attention_fwd.launches == before + 1
    torch.cuda.synchronize()
    assert (o - o_gather).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_block_sparse_wrapper_rejects_what_the_kernel_does_not_take(card):
    from deepspeed_tpu_torch.ops.kernels import block_sparse_attention as bs
    layout = _bsa_layout(2, 4, False, 0)
    q = torch.randn(1, 32, 2, 16, device=card)
    with pytest.raises(ValueError, match="layout blocks"):
        bs.block_sparse_flash_attention(q, q, q, layout, 8)
    wide = torch.randn(1, 64, 2, 160, device=card)
    with pytest.raises(ValueError, match="head_dim"):
        bs.block_sparse_flash_attention(wide, wide, wide, layout, 16)
    x = torch.randn(1, 64, 2, 16, device=card)
    with pytest.raises(TypeError, match="bf16, fp16 or fp32"):
        bs.block_sparse_flash_attention(x.double(), x.double(), x.double(),
                                        layout, 16)
    with pytest.raises(ValueError, match="layout must be"):
        bs.block_sparse_flash_attention(x, x, x, layout[:, :2], 16)


# ------------------------------------------------------ B6 FP quantization
def _fpq_input(card, dtype, offset):
    """[37, 300] (a partial last group, padded groups) with groups of each
    kind at group size 128: random; all zero; a subnormal-range group (one
    large value, the rest 1e-4 of it, down in the format's subnormals);
    and exact grid ties and values that round past the grid's max."""
    g = torch.Generator().manual_seed(offset)
    x = torch.randn(37 * 300 + offset, generator=g) * 3
    v = x[offset:]
    v[128:256] = 0
    v[256:384] *= 1e-4
    v[256] = 50.0
    v[384:512] = torch.linspace(-28.0, 28.0, 128)
    v[384:392] = torch.tensor([28.0, 27.99, -27.99, 0.5, 1.5, 2.5, -0.5,
                               13.0])
    return x.to(card, dtype)[offset:].view(37, 300)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16],
                         ids=["fp32", "bf16", "fp16"])
@pytest.mark.parametrize("q_bits,man", [(6, 2), (12, 7)])
@pytest.mark.parametrize("group_size", [128, 512, 8192, 640, 1024])
@pytest.mark.parametrize("offset", [0, 1, None],
                         ids=["aligned", "misaligned", "whole"])
def test_fp_quantizer_kernel_matches_plain(card, dtype, q_bits, man,
                                           group_size, offset):
    """Packed bytes and scales bit for bit (the same fp32 operations: true
    divisions, the grid rounding, pack_codes's byte order); ``quantize_fp``
    makes that one launch and returns them.  Group sizes 640 (5 units a
    lane of a team of 8), 1024 (2 units) and 8192 (read twice) reach the
    one-pass scheme's other kernels; ``whole`` is a [5120, 2048] input
    that fills its padded group count at every group size, so each is
    also reached by its kernel for whole, aligned groups."""
    from deepspeed_tpu_torch.ops import fp_quantizer as fq
    from deepspeed_tpu_torch.ops.kernels import fp_quantizer as kfq
    if offset is None:
        g = torch.Generator().manual_seed(group_size + q_bits)
        x = (torch.randn(5120, 2048, generator=g) * 0.02).to(card, dtype)
        x.view(-1)[:group_size] = 0               # an all-zero group
        gs, _, padded = fq.fp_groups(x.numel(), group_size)
        assert padded * gs == x.numel()
    else:
        x = _fpq_input(card, dtype, offset)
    before = kfq.quantize_fp_packed.launches
    packed, scales = kfq.quantize_fp_packed(x, q_bits, man, group_size)
    ref, ref_scales = kfq.quantize_fp_packed_plain(x, q_bits, man,
                                                   group_size)
    torch.cuda.synchronize()
    assert kfq.quantize_fp_packed.launches == before + 1
    assert packed.dtype == torch.uint8
    assert torch.equal(packed, ref) and torch.equal(scales, ref_scales)
    got, s, meta = fq.quantize_fp(x, q_bits, man, group_size)
    assert kfq.quantize_fp_packed.launches == before + 2
    assert torch.equal(got, ref) and torch.equal(s, ref_scales)
    back = fq.dequantize_fp(got, s, meta)
    assert back.dtype == dtype and back.shape == x.shape
    assert torch.isfinite(back).all()


@pytest.mark.cuda
def test_fp_quantizer_fp8_launches_nothing(card):
    from deepspeed_tpu_torch.ops import fp_quantizer as fq
    from deepspeed_tpu_torch.ops.kernels import fp_quantizer as kfq
    x = torch.randn(1000, device=card)
    before = kfq.quantize_fp_packed.launches
    packed, s, meta = fq.quantize_fp(x, 8, 3, 128)
    assert kfq.quantize_fp_packed.launches == before
    cpu = fq.quantize_fp(x.cpu(), 8, 3, 128)
    assert torch.equal(packed.cpu(), cpu[0]) and torch.equal(s.cpu(), cpu[1])


# ------------------------------------------- the comm layer on NCCL, ZeRO
@pytest.fixture(scope="module")
def nccl_world():
    """A one-rank NCCL world on the card (``comm.init_distributed``)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from deepspeed_tpu_torch import comm as dist
    cdb = dist.init_distributed(dist_backend="nccl", verbose=False)
    assert cdb.name == "nccl" and dist.get_world_size() == 1
    yield dist
    dist.destroy_process_group()


NCCL_OPS = ("all_reduce_SUM", "all_reduce_MAX", "all_reduce_MIN",
            "all_reduce_AVG", "all_reduce_PRODUCT", "all_gather_axis0",
            "all_gather_axis1", "reduce_scatter", "broadcast",
            "all_to_all_single", "allgather_fn_in_place",
            "reduce_scatter_fn", "barrier")


@pytest.mark.cuda
@pytest.mark.parametrize("op", NCCL_OPS)
def test_nccl_world_of_one_collective(nccl_world, op):
    """Each collective at world size 1 over NCCL: the JAX facade's result
    for one rank, which is its input (or, for a product or a mean over one
    rank, the input itself)."""
    from deepspeed_tpu_torch.comm import ReduceOp
    dist = nccl_world
    x = torch.randn(8, 6, generator=torch.Generator().manual_seed(3)).cuda()
    want = x.clone()
    if op.startswith("all_reduce"):
        got = dist.all_reduce(x, op=ReduceOp[op.split("_")[-1]])
    elif op.startswith("all_gather_axis"):
        got = dist.all_gather(x, axis=int(op[-1]))
    elif op == "reduce_scatter":
        got = dist.reduce_scatter(x)
    elif op == "broadcast":
        got = dist.broadcast(x, src=0)
    elif op == "all_to_all_single":
        got = dist.all_to_all_single(x, split_axis=0, concat_axis=1)
    elif op == "allgather_fn_in_place":
        flat = x.reshape(-1)
        got = dist.allgather_fn(flat, flat[:]).view(8, 6)
    elif op == "reduce_scatter_fn":
        out = torch.empty(48, device="cuda")
        got = dist.reduce_scatter_fn(out, x).view(8, 6)
    else:
        dist.barrier()
        got = want
    torch.cuda.synchronize()
    assert got.is_cuda and torch.equal(got, want)


@pytest.mark.cuda
def test_fused_adam_on_a_shard_at_an_offset(card):
    """B2 on rank 1's shard of a padded flat buffer (the ZeRO path's call:
    views at a non-zero offset, 16-element aligned), against its plain
    version on the same views; the other shard is left untouched."""
    n, world = 2 * 1_000_000, 2
    s = n // world
    g = torch.Generator().manual_seed(11)
    grad = torch.randn(n, generator=g).to(card, torch.bfloat16)
    master = torch.randn(s, generator=g).to(card)
    m = (0.1 * torch.randn(s, generator=g)).to(card)
    v = (0.01 * torch.rand(s, generator=g)).to(card)
    params = torch.randn(n, generator=g).to(card, torch.bfloat16)
    ref = [t.clone() for t in (master, m, v)]
    params_ref = params.clone()
    hyper = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8,
                 weight_decay=0.01, count=3,
                 grad_scale=torch.tensor(0.5, device=card))
    before = opt.fused_adam_step.launches
    opt.fused_adam_step(grad[s:], master, m, v, params[s:], **hyper)
    opt.fused_adam_step_plain([grad[s:]], *([t] for t in ref),
                              [params_ref[s:]], **hyper)
    torch.cuda.synchronize()
    assert opt.fused_adam_step.launches == before + 1
    for got, want in zip((master, m, v), ref):
        assert ((got - want).abs() <= 2.0**-23 * want.abs()).all()
    assert torch.equal(params, params_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("stage", (1, 2))
def test_zero_step_on_the_card_equals_zero0(nccl_world, stage):
    """A bf16 Llama step at ZeRO 1/2 on the card (world size 1 over NCCL)
    equals the ZeRO-0 step bit for bit: the reduce-scatter and the
    in-place all-gather of one rank are copies."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LlamaModel, llama_tiny
    ids = torch.randint(0, 256, (2, 32),
                        generator=torch.Generator().manual_seed(0)).cuda()
    out = []
    for st in (0, stage):
        eng = deepspeed_tpu_torch.initialize(
            model=LlamaModel(llama_tiny(dtype="bfloat16", remat=False),
                             device="meta"),
            config={"train_micro_batch_size_per_gpu": 2,
                    "gradient_accumulation_steps": 2,
                    "bf16": {"enabled": True},
                    "optimizer": {"type": "fusedadam",
                                  "params": {"lr": 1e-3}},
                    "zero_optimization": {"stage": st}})[0]
        eng.initialize_parameters(0)
        losses = []
        for _ in range(4):
            loss = eng(ids, ids)
            eng.backward(loss)
            eng.step()
            losses.append(loss.item())
        out.append((losses, eng.params.clone(), eng.fp32_params().clone()))
    assert out[0][0] == out[1][0]
    assert torch.equal(out[0][1], out[1][1])
    assert torch.equal(out[0][2], out[1][2])


@pytest.mark.cuda
@pytest.mark.parametrize("stage", (1, 2))
def test_zero_lamb_on_the_card_matches_zero0(nccl_world, stage):
    """LAMB at ZeRO 1/2 on the card (one NCCL rank).  At one rank the
    pieces are whole leaves and the engine takes the fused two-phase call:
    ZeRO 0's losses and master bit for bit.  With the leaves' sums over the
    ranks armed by hand (the route of more than one rank: each piece's
    partials summed on the card, all-reduced, one partial a piece to phase
    2), the same losses within rtol 1e-3 and a master within rtol 2e-5
    plus lr/20.  No step of the three makes a host sync."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2Model, gpt2_tiny
    from deepspeed_tpu_torch.ops.kernels import optimizers as opt
    lr = 2e-3
    ids = torch.randint(0, 256, (2, 64),
                        generator=torch.Generator().manual_seed(1)).cuda()
    out = {}
    for run, st in (("zero0", 0), ("fused", stage), ("armed", stage)):
        eng = deepspeed_tpu_torch.initialize(
            model=GPT2Model(gpt2_tiny(dtype="bfloat16", remat=False),
                            device="meta"),
            config={"train_micro_batch_size_per_gpu": 2,
                    "bf16": {"enabled": True},
                    "optimizer": {"type": "fusedlamb",
                                  "params": {"lr": lr}},
                    "zero_optimization": {"stage": st}})[0]
        eng.initialize_parameters(0)
        assert eng.opt_state.reduce_sums is None
        if run == "armed":
            eng._sum_lamb_leaves_over_ranks()
        before = opt.fused_lamb_phase2.launches
        losses = []
        for _ in range(4):
            loss = eng(ids, ids)
            eng.backward(loss)
            torch.cuda.set_sync_debug_mode("error")
            try:
                eng.step()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            losses.append(loss.item())
        assert opt.fused_lamb_phase2.launches - before == 4
        out[run] = (losses, eng.fp32_params().clone())
    assert out["fused"][0] == out["zero0"][0]
    assert torch.equal(out["fused"][1], out["zero0"][1])
    torch.testing.assert_close(out["armed"][0], out["zero0"][0], rtol=1e-3,
                               atol=0)
    torch.testing.assert_close(out["armed"][1], out["zero0"][1], rtol=2e-5,
                               atol=lr / 20)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ("plain", "overlap", "prefetch"))
def test_zero3_on_the_card_matches_zero0(nccl_world, variant):
    """A bf16 Llama at ZeRO 3 on the card (one NCCL rank), with remat,
    gradient accumulation 2 and blocks sharded (the norms persistent):
    without ``overlap_comm``, with it, and with it and a prefetch window of
    two one-block buckets.  At one rank a gather and a reduce-scatter are
    copies: ZeRO 0's losses, master and parameters bit for bit.  Every
    forward, backward and step of ZeRO 3 runs under
    ``torch.cuda.set_sync_debug_mode("error")``: the gathers, releases and
    reduce-scatters make no host sync."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LlamaModel, llama_tiny
    ids = torch.randint(0, 256, (2, 64),
                        generator=torch.Generator().manual_seed(2)).cuda()
    zero3 = {"stage": 3, "stage3_param_persistence_threshold": 8 * 100}
    if variant != "plain":
        zero3["overlap_comm"] = True
    if variant == "prefetch":
        zero3["stage3_prefetch_bucket_size"] = 1
    out = {}
    for st, zero in ((0, {"stage": 0}), (3, zero3)):
        eng = deepspeed_tpu_torch.initialize(
            model=LlamaModel(llama_tiny(dtype="bfloat16", remat=True),
                             device="meta"),
            config={"train_micro_batch_size_per_gpu": 2,
                    "gradient_accumulation_steps": 2,
                    "bf16": {"enabled": True},
                    "optimizer": {"type": "fusedadam",
                                  "params": {"lr": 1e-3}},
                    "zero_optimization": zero})[0]
        eng.initialize_parameters(0)
        losses = []
        for _ in range(6):
            if st == 3:
                torch.cuda.set_sync_debug_mode("error")
            try:
                loss = eng(ids, ids)
                eng.backward(loss)
                eng.step()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            losses.append(loss.item())
        names = eng.parameter_names()
        fp32, params = eng.fp32_params(), eng.gathered_params()
        out[st] = (losses, {n: (fp32[o:o + k].clone(), params[o:o + k]
                                .clone()) for n, o, k, _ in eng._layout})
        if st == 3:
            plan = eng.zero_plan.describe()
            assert plan["unit_kinds"] == {"outer": 1, "block": 2,
                                          "persistent": 1}
            assert plan["prefetch_enabled"] == (variant == "prefetch")
            assert eng._coord.window == (2 if variant == "prefetch" else 1)
    assert out[3][0] == out[0][0]
    assert out[3][1].keys() == out[0][1].keys() == set(names)
    for name, (master, param) in out[0][1].items():
        assert torch.equal(out[3][1][name][0], master), name
        assert torch.equal(out[3][1][name][1], param), name


@pytest.mark.cuda
def test_pipeline_zero3_on_the_card_equals_the_base_engine(nccl_world):
    """The ``PipelineEngine`` at pp = 1 under ZeRO 3 on the card (one NCCL
    rank): a bf16 GPT-2 with remat, its blocks sharded, two microbatches a
    step, against the base engine on ``to_module()`` at the same ZeRO 3:
    losses and master bit for bit, and each wrapper's launches equal."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import gpt2_tiny, pipeline_module
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.ops.kernels import optimizers as ko
    gen = torch.Generator().manual_seed(3)
    batches = [(ids.cuda(), ids.roll(-1, 1).cuda()) for ids in (
        torch.randint(0, 256, (2, 64), generator=gen) for _ in range(2))]
    counters = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkv, ko.fused_adam_step)
    out = {}
    for kind in ("pipeline", "base"):
        # heads of 64, a width B1 takes
        pm = pipeline_module(gpt2_tiny(dtype="bfloat16", hidden_size=128,
                                       num_attention_heads=2),
                             activation_checkpoint_interval=1)
        eng = deepspeed_tpu_torch.initialize(
            model=pm if kind == "pipeline" else pm.to_module(device="meta"),
            config={"train_micro_batch_size_per_gpu": 2,
                    "gradient_accumulation_steps": 2,
                    "bf16": {"enabled": True},
                    "optimizer": {"type": "fusedadam",
                                  "params": {"lr": 1e-3}},
                    "zero_optimization": {
                        "stage": 3,
                        "stage3_param_persistence_threshold": 8 * 100}})[0]
        eng.initialize_parameters(0)
        assert eng.zero_plan.describe()["unit_kinds"]["block"] == 2
        for fn in counters:
            fn.launches = 0
        losses = []
        for _ in range(3):
            if kind == "pipeline":
                losses.append(eng.train_batch(iter(batches)).item())
                continue
            micro = []
            for x, y in batches:
                loss = eng(x, y)
                eng.backward(loss)
                eng.step()
                micro.append(loss.detach().float())
            losses.append(torch.stack(micro).mean().item())
        out[kind] = (losses, eng.fp32_params().clone(),
                     [fn.launches for fn in counters])
    assert type(eng).__name__ == "DeepSpeedEngine"
    assert out["pipeline"][0] == out["base"][0]
    assert torch.equal(out["pipeline"][1], out["base"][1])
    assert out["pipeline"][2] == out["base"][2] and all(out["base"][2])
