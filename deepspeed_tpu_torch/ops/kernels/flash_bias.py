"""Flash attention with a trainable additive bias: the hand-written CUDA
kernels' wrappers, their autograd function and their plain PyTorch
versions.

Replaces the Pallas TPU kernels of ``deepspeed_tpu/ops/pallas/
flash_bias.py`` behind ``flash_attention_bias`` (:397) and the custom VJP
``_flash_bias``: the forward ``_fwd_kernel`` (:56) and the backward
``_bwd_dq_kernel`` (:127), ``_bwd_dkv_kernel`` (:158) and
``_bwd_dbias_kernel`` (:194).  Here the four kernels are
``csrc/flash_bias.cu`` (nvcc for ``sm_90a``, called through ctypes on
PyTorch's current stream) and the custom VJP is :class:`FlashBiasFunction`:
its forward launches the forward kernel and saves the fp32 ``lse``; its
backward launches the dq kernel (which also forms ``delta = rowsum(dO·O)``),
then the dk/dv kernel, then the dbias kernel, whose fp32 sum over each bias
element's (batch, head) group comes back at the bias's own shape.  In bf16
and fp16 that sum is split into :func:`dbias_splits` chunks of consecutive
group members, summed into a scratch buffer this module allocates, then
summed in chunk order (a second kernel in the same call).

Semantics (the TPU kernel's): q, k, v [B, S, H, D] with no GQA; ``bias``
[Bb, Hb, Sq, Sk] read by batch b at row b // (B // Bb) and by head h at
h // (H // Hb); ``mask_bias`` an optional [Bm, 1, 1, Sk], fp32, additive,
without gradient; fp32 scores ``(q·kᵀ)·scale``, then ``+ bias``, then
``+ mask``; a bottom-right aligned causal mask; a row that sees no key
outputs 0 with lse -1e30.

What bounds them on an H100: at the Evoformer's head dim of 32, bytes
(q, k, v, o, the bias and their gradients at 3.35 TB/s), and below that
the exponentials (one a score in each kernel).  In bf16 and fp16 the
kernels run their products on the tensor cores (``mma.sync``, fp32
accumulation), feeding the fp32 P and dS of the Pallas kernels'
arithmetic as hi + lo in the input type, in fp16 scaled by powers of two,
as flash attention's kernels do (:func:`_emulate_tensor_cores` is that
design in plain PyTorch, for the tests); in fp32 they run fp32 FMA on the
CUDA cores (see the source's note).

On CPU tensors :func:`flash_attention_bias` computes
:func:`flash_attention_bias_plain`; on CUDA tensors it launches the kernels
or raises.  ``flash_bias_fwd.launches``, ``flash_bias_bwd_dq.launches``,
``flash_bias_bwd_dkv.launches`` and ``flash_bias_bwd_dbias.launches`` count
kernel launches.
"""

import torch

from ..op_builder import FlashBiasBuilder
from .flash_attention import (P_SCALE, _ds_scale, _split_matmul,
                              check_tiles)

DEAD_ROW_LSE = -1e30     # lse of a row that sees no key (finite sentinel)
# JAX's tile defaults (flash_bias.py:43-44), kept for its signature
DEFAULT_BLOCK_Q = 256
DEFAULT_BLOCK_K = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# ds_flash_bias_smem_bytes(pass, D): pass p (0 fwd, 1 dq, 2 dk/dv, 3 dbias)
# of the tensor-core route with a bf16/fp16 bias is p, with an fp32 bias
# MMA_FP32_BIAS_PASS + p, of the fp32 route FP32_ROUTE_PASS + p
MMA_FP32_BIAS_PASS, FP32_ROUTE_PASS = 4, 8
# the dbias split (bf16/fp16): enough chunks of at least DBIAS_MIN_MEMBERS
# group members each that the grid reaches DBIAS_TARGET_BLOCKS blocks of
# 64 x 64 bias elements (several waves on 132 SMs, where one block a bias
# tile gives 288 at AlphaFold2's MSA-row shape)
DBIAS_TILE = 64
DBIAS_MIN_MEMBERS = 16
DBIAS_TARGET_BLOCKS = 2048


def dbias_splits(B, H, sq, sk, Bb, Hb):
    """Chunks the dbias kernel splits each bias element's Gb·Gh group
    members into, from the shapes alone (so two runs, and two cards, sum
    in the same order): 1 for groups under 2·DBIAS_MIN_MEMBERS."""
    members = (B // Bb) * (H // Hb)
    tiles = (-(-sq // DBIAS_TILE)) * (-(-sk // DBIAS_TILE)) * Bb * Hb
    return max(1, min(members // DBIAS_MIN_MEMBERS,
                      -(-DBIAS_TARGET_BLOCKS // tiles)))


def _visible(sq, sk, causal, device):
    """[sq, sk] visibility: bottom-right causal (row + sk - sq >= col)."""
    if not causal:
        return torch.ones(sq, sk, dtype=torch.bool, device=device)
    row = torch.arange(sq, device=device)[:, None] + (sk - sq)
    return row >= torch.arange(sk, device=device)[None, :]


def _heads(x):
    """[B, S, H, D] → fp32 [B, H, S, D]."""
    return x.float().transpose(1, 2)


def _scores(q, k, bias, mask, scale, causal):
    """fp32 scores [B, H, sq, sk]: (q·kᵀ)·scale, then + bias (broadcast
    over its batch and head groups), then + mask, each a rounded fp32
    operation as in the kernels; invisible pairs -inf.  Also returns the
    visibility."""
    B, sq, H, _ = q.shape
    sk = k.shape[1]
    s = (_heads(q) @ _heads(k).transpose(-1, -2)) * scale
    Bb, Hb = bias.shape[:2]
    s.view(Bb, B // Bb, Hb, H // Hb, sq, sk).add_(
        bias.float()[:, None, :, None])
    if mask is not None:
        Bm = mask.shape[0]
        s.view(Bm, B // Bm, H, sq, sk).add_(mask.float().view(Bm, 1, 1, 1, sk))
    vis = _visible(sq, sk, causal, q.device)
    return s.masked_fill_(~vis, float("-inf")), vis


def _probs(q, k, lse, bias, mask, scale, causal):
    """The backward's recomputed probabilities exp(s - lse), 0 where
    invisible."""
    s, vis = _scores(q, k, bias, mask, scale, causal)
    return torch.where(vis, torch.exp(s - lse[..., None]), 0.0)


def _plain_fwd(q, k, v, bias, mask, scale, causal=False):
    """The forward kernel's plain version: (o in q's dtype, lse [B, H, sq]
    fp32, -1e30 for a row that sees no key)."""
    s, _ = _scores(q, k, bias, mask, scale, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - torch.where(m == float("-inf"), 0.0, m))
    del s
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0, 1.0, l)
    o = (p @ _heads(v)) / l_safe
    lse = torch.where(m == float("-inf"), DEAD_ROW_LSE, m + torch.log(l_safe))
    return o.transpose(1, 2).to(q.dtype), lse[..., 0]


def _dscores(q, k, v, do, lse, delta, bias, mask, scale, causal):
    """(p, ds = p·(dO·vᵀ - delta)), fp32 [B, H, sq, sk]."""
    p = _probs(q, k, lse, bias, mask, scale, causal)
    dp = _heads(do) @ _heads(v).transpose(-1, -2)
    return p, dp.sub_(delta[..., None]).mul_(p)


def _plain_bwd_dq(q, k, v, o, do, lse, bias, mask, scale, causal=False):
    """The dq kernel's plain version: (dq in q's dtype, delta =
    rowsum(do·o) [B, H, sq] fp32, from o as stored)."""
    delta = (_heads(do) * _heads(o)).sum(dim=-1)
    _, ds = _dscores(q, k, v, do, lse, delta, bias, mask, scale, causal)
    dq = ds.mul_(scale) @ _heads(k)
    return dq.transpose(1, 2).to(q.dtype), delta


def _plain_bwd_dkv(q, k, v, do, lse, delta, bias, mask, scale,
                   causal=False):
    """The dk/dv kernel's plain version: (dk, dv) in k's dtype."""
    p, ds = _dscores(q, k, v, do, lse, delta, bias, mask, scale, causal)
    dv = p.transpose(-1, -2) @ _heads(do)
    del p
    dk = ds.mul_(scale).transpose(-1, -2) @ _heads(q)
    return dk.transpose(1, 2).to(k.dtype), dv.transpose(1, 2).to(v.dtype)


def _plain_bwd_dbias(q, k, v, do, lse, delta, bias, mask, scale,
                     causal=False):
    """The dbias kernel's plain version: fp32 [Bb, Hb, sq, sk], ds summed
    over each bias element's batch and head group members."""
    _, ds = _dscores(q, k, v, do, lse, delta, bias, mask, scale, causal)
    B, H, sq, sk = ds.shape
    Bb, Hb = bias.shape[:2]
    return ds.view(Bb, B // Bb, Hb, H // Hb, sq, sk).sum(dim=(1, 3))


def _emulate_tensor_cores(q, k, v, do, bias, mask, scale, causal=False,
                          keep_lo=True, o=None):
    """The bf16/fp16 kernels' numerical design in plain PyTorch, for the
    tests: S and dP from the exact low-precision inputs in fp32; fp32
    scores with the bias and the mask added in the kernels' order; P and
    dS fp32, each product that takes them (P·V, dS·K, Pᵀ·dO, dSᵀ·Q) fed
    P or dS as hi + lo in q's dtype, scaled first by ``P_SCALE`` or by
    ``_ds_scale`` of the row's largest |dS| (flash attention's
    ``_split_matmul``); dbias from the fp32 dS, summed member by member
    within each of :func:`dbias_splits` chunks and then chunk by chunk.
    The backward reads ``o`` (the emulated forward's, rounded, by
    default), as the kernels read o as stored.  → (o, dq, dk, dv) in q's
    dtype and dbias in fp32.  ``keep_lo=False`` rounds P and dS once
    instead."""
    dtype = q.dtype
    B, sq, H, _ = q.shape
    sk = k.shape[1]
    Bb, Hb = bias.shape[:2]
    qf, kf, vf, dof = _heads(q), _heads(k), _heads(v), _heads(do)
    s, vis = _scores(q, k, bias, mask, scale, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - torch.where(m == float("-inf"), 0.0, m))
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0, 1.0, l)
    o_emu = (_split_matmul(p, vf, dtype, P_SCALE[dtype], keep_lo)
             / l_safe).transpose(1, 2)
    lse = torch.where(m == float("-inf"), DEAD_ROW_LSE, m + torch.log(l_safe))
    o_read = o_emu.to(dtype) if o is None else o
    delta = (dof * _heads(o_read)).sum(dim=-1, keepdim=True)
    p = torch.where(vis, torch.exp(s - lse), 0.0)
    del s
    ds = p * (dof @ vf.transpose(-1, -2) - delta)
    dss = ds * scale
    dq = _split_matmul(dss, kf, dtype,
                       _ds_scale(dss.abs().amax(-1, keepdim=True), dtype),
                       keep_lo)
    dv = _split_matmul(p.transpose(-1, -2), dof, dtype, P_SCALE[dtype],
                       keep_lo)
    dk = _split_matmul(dss.transpose(-1, -2), qf, dtype,
                       _ds_scale(dss.abs().amax(dim=2)[..., None], dtype),
                       keep_lo)
    # dbias: member m = (batch member m // Gh, head member m % Gh)
    groups = ds.view(Bb, B // Bb, Hb, H // Hb, sq, sk).permute(
        1, 3, 0, 2, 4, 5).reshape(-1, Bb, Hb, sq, sk)
    G = groups.shape[0]
    splits = dbias_splits(B, H, sq, sk, Bb, Hb)
    dbias = None
    for c in range(splits):
        part = groups[c * G // splits].clone()
        for member in range(c * G // splits + 1, (c + 1) * G // splits):
            part += groups[member]
        dbias = part if dbias is None else dbias + part
    return (o_emu.to(dtype), dq.transpose(1, 2).to(dtype),
            dk.transpose(1, 2).to(dtype), dv.transpose(1, 2).to(dtype), dbias)


def _kernel_checks(tensors, bias, mask):
    dtype = tensors[0][1].dtype
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"flash bias kernels take bf16, fp16 or fp32, got "
                        f"{dtype}")
    for name, t in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {dtype}")
    if bias.dtype not in _DTYPE_CODES:
        raise TypeError(f"bias must be bf16, fp16 or fp32, got {bias.dtype}")
    if mask is not None and mask.dtype != torch.float32:
        raise TypeError(f"mask_bias must be fp32, got {mask.dtype}")
    for name, t in tensors + [("bias", bias), ("mask", mask)]:
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}: the kernels take "
                             f"CUDA tensors")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    D = tensors[0][1].shape[-1]
    if D > 128:
        raise ValueError(f"flash bias kernels take head_dim <= 128, got {D}")


def _raise_on(lib, err, what):
    if err:
        raise RuntimeError(f"flash bias {what} kernel launch failed: "
                           f"{lib.ds_cuda_error_string(err).decode()} ({err})")


def _kernel_bias(q, bias):
    """The bias as the kernels take it: bf16/fp16 inputs read a bias in
    their own type or in fp32, so a bias of the other 16-bit type goes in
    as fp32 (exact: the kernels add it in fp32)."""
    if q.dtype != torch.float32 and bias.dtype not in (q.dtype,
                                                       torch.float32):
        return bias.float()
    return bias


def _dims(q, k, bias, mask, scale, causal):
    B, sq, H, D = q.shape
    return (B, H, sq, k.shape[1], D, bias.shape[0], bias.shape[1],
            0 if mask is None else mask.shape[0], scale, int(bool(causal)),
            _DTYPE_CODES[q.dtype], _DTYPE_CODES[bias.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)


def _ptr(t):
    return None if t is None else t.data_ptr()


def flash_bias_fwd(q, k, v, bias, mask, scale, causal=False):
    """Forward kernel: (o [B, sq, H, D] in q's dtype, lse [B, H, sq] fp32).
    CUDA tensors only."""
    _kernel_checks([("q", q), ("k", k), ("v", v)], bias, mask)
    bias = _kernel_bias(q, bias)
    lib = FlashBiasBuilder().load()
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[0], q.shape[2], q.shape[1],
                      dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.ds_flash_bias_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            _ptr(mask), o.data_ptr(), lse.data_ptr(),
            *_dims(q, k, bias, mask, scale, causal))
    _raise_on(lib, err, "forward")
    flash_bias_fwd.launches += 1
    return o, lse


flash_bias_fwd.launches = 0


def flash_bias_bwd_dq(q, k, v, o, do, lse, bias, mask, scale, causal=False):
    """dq kernel: (dq in q's dtype, delta = rowsum(do·o) [B, H, sq] fp32).
    CUDA tensors only."""
    _kernel_checks([("q", q), ("k", k), ("v", v), ("o", o), ("do", do)],
                   bias, mask)
    bias = _kernel_bias(q, bias)
    lib = FlashBiasBuilder().load()
    dq = torch.empty_like(q)
    delta = torch.empty_like(lse)
    with torch.cuda.device(q.device):
        err = lib.ds_flash_bias_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), bias.data_ptr(), _ptr(mask),
            dq.data_ptr(), delta.data_ptr(),
            *_dims(q, k, bias, mask, scale, causal))
    _raise_on(lib, err, "dq")
    flash_bias_bwd_dq.launches += 1
    return dq, delta


flash_bias_bwd_dq.launches = 0


def flash_bias_bwd_dkv(q, k, v, do, lse, delta, bias, mask, scale,
                       causal=False):
    """dk/dv kernel: (dk, dv) in k's dtype.  CUDA tensors only."""
    _kernel_checks([("q", q), ("k", k), ("v", v), ("do", do)], bias, mask)
    bias = _kernel_bias(q, bias)
    lib = FlashBiasBuilder().load()
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = lib.ds_flash_bias_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), bias.data_ptr(), _ptr(mask),
            dk.data_ptr(), dv.data_ptr(),
            *_dims(q, k, bias, mask, scale, causal))
    _raise_on(lib, err, "dk/dv")
    flash_bias_bwd_dkv.launches += 1
    return dk, dv


flash_bias_bwd_dkv.launches = 0


def flash_bias_bwd_dbias(q, k, v, do, lse, delta, bias, mask, scale,
                         causal=False):
    """dbias kernel: fp32 [Bb, Hb, sq, sk], summed over each element's
    group members in a fixed order (bit-identical across runs); in
    bf16/fp16 through a scratch of :func:`dbias_splits` partial planes,
    freed on return.  One launch of the wrapper, two kernels.  CUDA
    tensors only."""
    _kernel_checks([("q", q), ("k", k), ("v", v), ("do", do)], bias, mask)
    bias = _kernel_bias(q, bias)
    lib = FlashBiasBuilder().load()
    dbias = torch.empty(bias.shape, dtype=torch.float32, device=q.device)
    splits = 1
    if q.dtype != torch.float32:
        B, sq, H, _ = q.shape
        splits = dbias_splits(B, H, sq, k.shape[1], *bias.shape[:2])
    # the chunks' partial sums, summed in order by the second kernel
    scratch = (torch.empty((splits, ) + tuple(bias.shape),
                           dtype=torch.float32, device=q.device)
               if splits > 1 else None)
    with torch.cuda.device(q.device):
        err = lib.ds_flash_bias_bwd_dbias(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), bias.data_ptr(), _ptr(mask),
            dbias.data_ptr(), _ptr(scratch), splits,
            *_dims(q, k, bias, mask, scale, causal))
    _raise_on(lib, err, "dbias")
    flash_bias_bwd_dbias.launches += 1
    return dbias


flash_bias_bwd_dbias.launches = 0


class FlashBiasFunction(torch.autograd.Function):
    """The port of ``_flash_bias``'s custom VJP: the forward kernel, then
    the dq, dk/dv and dbias kernels by recomputation from the saved fp32
    lse — or, with ``use_kernel=False``, each kernel's plain version.  The
    mask gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias, mask, causal, scale, use_kernel):
        fwd = flash_bias_fwd if use_kernel else _plain_fwd
        o, lse = fwd(q, k, v, bias, mask, scale, causal)
        ctx.save_for_backward(q, k, v, bias, mask, o, lse)
        ctx.cfg = (scale, causal, use_kernel)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, mask, o, lse = ctx.saved_tensors
        scale, causal, use_kernel = ctx.cfg
        bwd_dq, bwd_dkv, bwd_dbias = (
            (flash_bias_bwd_dq, flash_bias_bwd_dkv, flash_bias_bwd_dbias)
            if use_kernel else (_plain_bwd_dq, _plain_bwd_dkv,
                                _plain_bwd_dbias))
        do = do.contiguous()
        dq, delta = bwd_dq(q, k, v, o, do, lse, bias, mask, scale, causal)
        dk, dv = bwd_dkv(q, k, v, do, lse, delta, bias, mask, scale, causal)
        dbias = bwd_dbias(q, k, v, do, lse, delta, bias, mask, scale, causal)
        return dq, dk, dv, dbias.to(bias.dtype), None, None, None, None


def _check(q, k, v, bias, mask_bias):
    """``flash_attention_bias``'s argument checks (JAX :414-440)."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be [B, S, H, D] and k, v alike, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, sq, H, D = q.shape
    _, sk, Hk, _ = k.shape
    if Hk != H:
        raise ValueError("flash_attention_bias: GQA is not supported "
                         f"(q heads {H} != kv heads {Hk})")
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"q {tuple(q.shape)} does not fit k/v "
                         f"{tuple(k.shape)} (batch, head dim)")
    if bias.dim() != 4 or B % bias.shape[0] or H % bias.shape[1]:
        raise ValueError(f"bias shape {tuple(bias.shape)} must be [Bb, Hb, "
                         f"Sq, Sk] with Bb | {B} and Hb | {H}")
    if bias.shape[2] != sq or bias.shape[3] != sk:
        raise ValueError(f"bias [..., {bias.shape[2]}, {bias.shape[3]}] must "
                         f"carry the full [Sq={sq}, Sk={sk}] score plane")
    if mask_bias is not None and (
            mask_bias.dim() != 4 or tuple(mask_bias.shape[1:3]) != (1, 1)
            or mask_bias.shape[3] != sk or B % mask_bias.shape[0]):
        raise ValueError(f"mask_bias shape {tuple(mask_bias.shape)} must be "
                         f"[Bm, 1, 1, {sk}] with Bm | {B}")
    devices = {t.device for t in (q, k, v, bias, mask_bias) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")
    return q.device.type


def _args(q, k, v, bias, mask_bias, causal, softmax_scale):
    scale = (float(softmax_scale) if softmax_scale is not None
             else q.shape[-1]**-0.5)
    mask = (None if mask_bias is None
            else mask_bias.detach().float().contiguous())
    return q, k, v, bias, mask, bool(causal), scale


def flash_attention_bias_plain(q, k, v, bias, mask_bias=None, causal=False,
                               softmax_scale=None, block_q=DEFAULT_BLOCK_Q,
                               block_k=DEFAULT_BLOCK_K):
    """The kernels' function in plain PyTorch, differentiable in q, k, v
    and bias, with :func:`flash_attention_bias`'s signature: materialized
    fp32 scores, each kernel's plain version step by step (the backward
    recomputes P from the saved lse and takes delta from o as stored).
    The mask is detached."""
    check_tiles(block_q, block_k)
    _check(q, k, v, bias, mask_bias)
    return FlashBiasFunction.apply(
        *_args(q, k, v, bias, mask_bias, causal, softmax_scale), False)


def flash_attention_bias(q, k, v, bias, mask_bias=None, causal=False,
                         softmax_scale=None, block_q=DEFAULT_BLOCK_Q,
                         block_k=DEFAULT_BLOCK_K):
    """[B, S, H, D] flash attention with a trainable additive bias
    [Bb, Hb, Sq, Sk] (Bb | B, Hb | H, contiguous broadcast groups) and an
    optional additive mask [Bm, 1, 1, Sk] without gradient, with the JAX
    function's signature.  Differentiable in q, k, v and bias; dbias comes
    back at the bias's own shape and dtype.  ``block_q`` and ``block_k``
    are the TPU kernel's tile sizes: they are checked (positive ints or
    None), but the card's kernels use tiles of their own, so they do not
    change the result.  CPU tensors: the plain version; CUDA tensors: the
    kernels (bf16, fp16 or fp32, head_dim <= 128, contiguous)."""
    check_tiles(block_q, block_k)
    device = _check(q, k, v, bias, mask_bias)
    if device not in ("cpu", "cuda"):
        raise ValueError(f"flash bias attention runs on cpu or cuda, not "
                         f"{device}")
    return FlashBiasFunction.apply(
        *_args(q, k, v, bias, mask_bias, causal, softmax_scale),
        device == "cuda")
