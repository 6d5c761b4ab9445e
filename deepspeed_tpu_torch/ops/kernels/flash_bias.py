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
element's (batch, head) group comes back at the bias's own shape.

Semantics (the TPU kernel's): q, k, v [B, S, H, D] with no GQA; ``bias``
[Bb, Hb, Sq, Sk] read by batch b at row b // (B // Bb) and by head h at
h // (H // Hb); ``mask_bias`` an optional [Bm, 1, 1, Sk], fp32, additive,
without gradient; fp32 scores ``(q·kᵀ)·scale``, then ``+ bias``, then
``+ mask``; a bottom-right aligned causal mask; a row that sees no key
outputs 0 with lse -1e30.

What bounds them on an H100: at the Evoformer's head dim of 32, bytes
(q, k, v, o and their gradients at 3.35 TB/s); the kernels run their
products in fp32 FMA on the CUDA cores (see the source's note).

On CPU tensors :func:`flash_attention_bias` computes
:func:`flash_attention_bias_plain`; on CUDA tensors it launches the kernels
or raises.  ``flash_bias_fwd.launches``, ``flash_bias_bwd_dq.launches``,
``flash_bias_bwd_dkv.launches`` and ``flash_bias_bwd_dbias.launches`` count
kernel launches.
"""

import torch

from ..op_builder import FlashBiasBuilder
from .flash_attention import check_tiles

DEAD_ROW_LSE = -1e30     # lse of a row that sees no key (finite sentinel)
# JAX's tile defaults (flash_bias.py:43-44), kept for its signature
DEFAULT_BLOCK_Q = 256
DEFAULT_BLOCK_K = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


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
    group members in a fixed order (bit-identical across runs).  CUDA
    tensors only."""
    _kernel_checks([("q", q), ("k", k), ("v", v), ("do", do)], bias, mask)
    lib = FlashBiasBuilder().load()
    dbias = torch.empty(bias.shape, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.ds_flash_bias_bwd_dbias(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), bias.data_ptr(), _ptr(mask),
            dbias.data_ptr(), *_dims(q, k, bias, mask, scale, causal))
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
