"""Flash attention: the hand-written CUDA kernels' wrappers, their autograd
function and their plain PyTorch version.

Replaces the Pallas TPU kernels of ``deepspeed_tpu/ops/pallas/
flash_attention.py``: ``flash_attention`` (:415) / ``_flash`` (:390), whose
forward ``_fwd_kernel`` (:114) and backward ``_bwd_dq_kernel`` (:219) and
``_bwd_dkv_kernel`` (:259) sit behind a ``jax.custom_vjp``.  Here the three
kernels are ``csrc/flash_attention.cu`` (nvcc for ``sm_90a``, called through
ctypes on PyTorch's current stream) and the custom VJP is
:class:`FlashAttentionFunction`: its forward launches the forward kernel and
saves the fp32 ``lse``; its backward launches the dq kernel (which also
forms ``delta = rowsum(dO·O)``) and then the dk/dv kernel.

What bounds them on an H100: operations (2 products forward, 5 backward,
over the live causal keys).  In bf16 and fp16 the kernels run them on the
tensor cores (``mma.sync``, fp32 accumulation), feeding the fp32 P and dS
of the Pallas kernel's arithmetic as hi + lo in the input type, in fp16
scaled by powers of two (:func:`_emulate_split_products` is that design in
plain PyTorch, for the tests); in fp32 they run fp32 FMA on the CUDA cores
(see the source's note).

On CPU tensors :func:`flash_attention` computes :func:`flash_attention_plain`
(autograd gives its gradients); on CUDA tensors it launches the kernels or
raises.  ``flash_attention_fwd.launches``, ``flash_attention_bwd_dq.launches``
and ``flash_attention_bwd_dkv.launches`` count kernel launches.
"""

from typing import Optional, Tuple

import torch

from ..op_builder import FlashAttentionBuilder

DEAD_ROW_LSE = -1e30     # lse of a row that sees no key (finite sentinel)
# JAX's tile defaults (flash_attention.py:32-33), kept for its signature
DEFAULT_BLOCK_Q = 512
DEFAULT_BLOCK_K = 512
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# ds_flash_smem_bytes(pass, D) reports the fp32 route's pass p (0 fwd, 1 dq,
# 2 dk/dv) as FP32_ROUTE_PASS + p (kFp32Route in the source)
FP32_ROUTE_PASS = 3


def _mask(sq, sk, causal, window, device):
    """[sq, sk] visibility: bottom-right causal (row + sk - sq >= col) and
    the sliding window (col > row + sk - sq - window)."""
    if not causal:
        return torch.ones(sq, sk, dtype=torch.bool, device=device)
    row = torch.arange(sq, device=device)[:, None] + (sk - sq)
    col = torch.arange(sk, device=device)[None, :]
    mask = row >= col
    if window:
        mask &= col > row - window
    return mask


def _scores(q, k, scale, causal, window, slopes):
    """fp32 scores [B, Hq, sq, sk] with ALiBi, masked to -inf, and the mask.
    k is repeated to Hq heads by the caller."""
    sq, sk = q.shape[2], k.shape[2]
    s = (q @ k.transpose(-1, -2)) * scale
    if slopes is not None:
        s = s + slopes[None, :, None, None] * torch.arange(
            sk, dtype=torch.float32, device=q.device)
    mask = _mask(sq, sk, causal, window, q.device)
    return s.masked_fill(~mask, float("-inf")), mask


def _heads(x, g):
    """[B, S, H, D] → fp32 [B, H·g, S, D] (each head repeated g times)."""
    x = x.float().transpose(1, 2)
    return x.repeat_interleave(g, dim=1) if g > 1 else x


def _plain_fwd(q, k, v, scale, causal=True, window=0, slopes=None):
    """The forward kernel's plain version: (o in q's dtype, lse [B, Hq, sq]
    fp32, -1e30 for a row that sees no key)."""
    g = q.shape[2] // k.shape[2]
    s, _ = _scores(_heads(q, 1), _heads(k, g), scale, causal, window, slopes)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - torch.where(m == float("-inf"), 0.0, m))
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0, 1.0, l)
    o = (p @ _heads(v, g)) / l_safe
    lse = torch.where(m == float("-inf"), DEAD_ROW_LSE, m + torch.log(l_safe))
    return o.transpose(1, 2).to(q.dtype), lse[..., 0]


def _plain_probs(q, k, lse, scale, causal, window, slopes):
    g = q.shape[2] // k.shape[2]
    s, mask = _scores(_heads(q, 1), _heads(k, g), scale, causal, window,
                      slopes)
    return torch.where(mask, torch.exp(s - lse[..., None]), 0.0)


def _plain_bwd_dq(q, k, v, o, do, lse, scale, causal=True, window=0,
                  slopes=None):
    """The dq kernel's plain version: (dq in q's dtype, delta =
    rowsum(do·o) [B, Hq, sq] fp32, from o as stored)."""
    g = q.shape[2] // k.shape[2]
    p = _plain_probs(q, k, lse, scale, causal, window, slopes)
    dof = _heads(do, 1)
    delta = (dof * _heads(o, 1)).sum(dim=-1)
    ds = p * (dof @ _heads(v, g).transpose(-1, -2) - delta[..., None]) * scale
    dq = ds @ _heads(k, g)
    return dq.transpose(1, 2).to(q.dtype), delta


def _plain_bwd_dkv(q, k, v, do, lse, delta, scale, causal=True, window=0,
                   slopes=None):
    """The dk/dv kernel's plain version: (dk, dv) in k's dtype, summed over
    each kv head's group of q heads in fp32."""
    B, sk, Hkv, D = k.shape
    g = q.shape[2] // Hkv
    p = _plain_probs(q, k, lse, scale, causal, window, slopes)
    dof = _heads(do, 1)
    ds = p * (dof @ _heads(v, g).transpose(-1, -2) - delta[..., None]) * scale
    dv = p.transpose(-1, -2) @ dof                       # [B, Hq, sk, D]
    dk = ds.transpose(-1, -2) @ _heads(q, 1)
    group = lambda x: x.view(B, Hkv, g, sk, D).sum(dim=2).transpose(1, 2)  # noqa: E731
    return group(dk).to(k.dtype), group(dv).to(v.dtype)


# fp16's P enters its split scaled by 2^15 (bf16 needs no scale: its lo is a
# normal number wherever P is), so that lo stays a normal fp16 number for
# P >= 2^-18; the product is unscaled by the same power of two.
P_SCALE = {torch.bfloat16: 1.0, torch.float16: 2.0**15}
DS_EXP_LIMIT = 60   # the dS scale 2^e keeps -60 <= e <= 60


def _split(x, dtype):
    """fp32 x → (hi, lo) in ``dtype``, as fp32: hi = round(x), lo =
    round(x - hi)."""
    hi = x.to(dtype).float()
    return hi, (x - hi).to(dtype).float()


def _ds_scale(amax, dtype):
    """The power of two by which the kernels scale the dS rows whose largest
    |dS| is ``amax`` before the split: in fp16 it takes amax into
    [2^14, 2^15), so that hi stays finite and lo a normal number down to
    2^-17·amax (2^60 where amax is 0 or below 2^-46); 1 in bf16."""
    if dtype != torch.float16:
        return torch.ones_like(amax)
    _, ex = torch.frexp(amax)            # amax = m·2^ex, 0.5 <= m < 1
    e = torch.where(amax > 0, 15 - ex, DS_EXP_LIMIT)
    return torch.exp2(e.clamp(-DS_EXP_LIMIT, DS_EXP_LIMIT).float())


def _split_matmul(a, b, dtype, scale=1.0, keep_lo=True):
    """a @ b with a·scale split into hi + lo in ``dtype`` and b exact in it:
    two products summed into one fp32 result and unscaled (``scale`` a power
    of two, per row of a), as the tensor-core kernels feed P and dS to their
    mma.  ``keep_lo=False`` rounds a·scale once (hi alone)."""
    hi, lo = _split(a * scale, dtype)
    out = lo @ b + hi @ b if keep_lo else hi @ b
    return out / scale


def _emulate_split_products(q, k, v, do, scale, causal=True, window=0,
                            slopes=None, keep_lo=True, out_dtype=None):
    """The tensor-core kernels' numerical design in plain PyTorch, for the
    tests: S and dP from the exact low-precision inputs in fp32, P and dS
    fp32, each product that takes P or dS (P·V, dS·K, Pᵀ·dO, dSᵀ·Q) fed
    P or dS as hi + lo in q's dtype, scaled first by :data:`P_SCALE` or
    :func:`_ds_scale` (the largest |dS| of each row of the product's first
    operand, over the whole row and GQA group: the kernels' final scale,
    the coarsest they use).  → (o, dq, dk, dv) in ``out_dtype`` (q's dtype
    by default; fp32 shows the products before that rounding); the fp32
    lse and delta are :func:`_plain_fwd`'s and :func:`_plain_bwd_dq`'s.
    ``keep_lo=False`` rounds P and dS once instead."""
    dtype = q.dtype
    out_dtype = out_dtype or dtype
    B, sk, Hkv, D = k.shape
    g = q.shape[2] // Hkv
    qf, kf, vf, dof = _heads(q, 1), _heads(k, g), _heads(v, g), _heads(do, 1)
    s, mask = _scores(qf, kf, scale, causal, window, slopes)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - torch.where(m == float("-inf"), 0.0, m))
    l = p.sum(dim=-1, keepdim=True)
    pv = _split_matmul(p, vf, dtype, P_SCALE[dtype], keep_lo)
    o = (pv / torch.where(l == 0, 1.0, l)).transpose(1, 2)
    lse = torch.where(m == float("-inf"), DEAD_ROW_LSE,
                      m + torch.log(torch.where(l == 0, 1.0, l)))
    p = torch.where(mask, torch.exp(s - lse), 0.0)
    delta = (dof * _heads(o.to(dtype), 1)).sum(dim=-1, keepdim=True)
    ds = p * (dof @ vf.transpose(-1, -2) - delta) * scale
    dq = _split_matmul(ds, kf, dtype,
                       _ds_scale(ds.abs().amax(-1, keepdim=True), dtype),
                       keep_lo)
    dv = _split_matmul(p.transpose(-1, -2), dof, dtype, P_SCALE[dtype],
                       keep_lo)
    # dk's rows are keys: one scale per key over the kv head's q heads
    key_max = ds.abs().amax(dim=2).view(B, Hkv, g, sk).amax(dim=2)
    key_max = key_max.repeat_interleave(g, dim=1)[..., None]
    dk = _split_matmul(ds.transpose(-1, -2), qf, dtype,
                       _ds_scale(key_max, dtype), keep_lo)
    group = lambda x: x.view(B, Hkv, g, sk, D).sum(dim=2).transpose(1, 2)  # noqa: E731
    return (o.to(out_dtype), dq.transpose(1, 2).to(out_dtype),
            group(dk).to(out_dtype), group(dv).to(out_dtype))


def _slopes_f32(alibi_slopes, Hq, device):
    if alibi_slopes is None:
        return None
    return torch.as_tensor(alibi_slopes).detach().to(
        device=device, dtype=torch.float32).reshape(Hq).contiguous()


def flash_attention_plain(q, k, v, causal=True, softmax_scale=None,
                          block_q=DEFAULT_BLOCK_Q, block_k=DEFAULT_BLOCK_K,
                          window=0, alibi_slopes=None):
    """The kernels' function in plain PyTorch, differentiable in q, k, v,
    with :func:`flash_attention`'s signature.
    q: [B, sq, Hq, D]; k, v: [B, sk, Hkv, D] → [B, sq, Hq, D] in q's dtype.

    Forward and backward follow the three kernels step by step: fp32
    scores, probabilities and sums, each output rounded once; the backward
    recomputes P from the saved lse and takes delta from o as stored.  A row
    that sees no key is 0 (``_xla_attention`` gives it a uniform softmax)
    and gets no gradient.  ALiBi slopes get no gradient."""
    check_tiles(block_q, block_k)
    scale = (float(softmax_scale) if softmax_scale is not None
             else q.shape[-1]**-0.5)
    return FlashAttentionFunction.apply(
        q, k, v, _slopes_f32(alibi_slopes, q.shape[2], q.device),
        bool(causal), scale, int(window), False)


def check_tiles(block_q, block_k):
    """JAX's ``block_q``/``block_k`` tile sizes: positive ints or None.  The
    card's kernels use tiles of their own, so the values do not change the
    result."""
    for name, b in (("block_q", block_q), ("block_k", block_k)):
        if b is not None and (isinstance(b, bool) or not isinstance(b, int)
                              or b <= 0):
            raise ValueError(f"{name} must be a positive int or None, got "
                             f"{b!r}")


def _check(q, k, v, causal, window, alibi_slopes):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be [B, S, H, D] and k, v alike [B, S, Hkv, "
                         f"D], got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, _, Hq, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or Hq % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} does not fit k/v "
                         f"{tuple(k.shape)} (batch, head dim, Hkv | Hq)")
    if window and not causal:
        raise ValueError("sliding window requires causal attention")
    if alibi_slopes is not None and torch.as_tensor(
            alibi_slopes).numel() != Hq:
        raise ValueError(f"alibi_slopes must have {Hq} entries")
    devices = {t.device for t in (q, k, v)}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")
    return q.device.type


def _kernel_checks(*named):
    dtype = named[0][1].dtype
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"flash attention kernels take bf16, fp16 or fp32, "
                        f"got {dtype}")
    for name, t in named:
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    D = named[0][1].shape[-1]
    if D > 128:
        raise ValueError(f"flash attention kernels take head_dim <= 128, "
                         f"got {D}")


def _slopes_ptr(slopes, Hq, device):
    s = _slopes_f32(slopes, Hq, device)
    return s, None if s is None else s.data_ptr()


def _raise_on(lib, err, what):
    if err:
        raise RuntimeError(f"flash attention {what} kernel launch failed: "
                           f"{lib.ds_cuda_error_string(err).decode()} ({err})")


def _dims(q, k, scale, causal, window):
    B, sq, Hq, D = q.shape
    return (B, Hq, k.shape[2], sq, k.shape[1], D, scale, int(bool(causal)),
            int(window), _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)


def flash_attention_fwd(q, k, v, scale, causal=True, window=0, slopes=None):
    """Forward kernel: (o [B, sq, Hq, D] in q's dtype, lse [B, Hq, sq]
    fp32).  CUDA tensors only."""
    _kernel_checks(("q", q), ("k", k), ("v", v))
    lib = FlashAttentionBuilder().load()
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[0], q.shape[2], q.shape[1],
                      dtype=torch.float32, device=q.device)
    s, s_ptr = _slopes_ptr(slopes, q.shape[2], q.device)
    with torch.cuda.device(q.device):
        err = lib.ds_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               s_ptr, o.data_ptr(), lse.data_ptr(),
                               *_dims(q, k, scale, causal, window))
    _raise_on(lib, err, "forward")
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0


def flash_attention_bwd_dq(q, k, v, o, do, lse, scale, causal=True, window=0,
                           slopes=None):
    """dq kernel: (dq in q's dtype, delta = rowsum(do·o) [B, Hq, sq] fp32).
    CUDA tensors only."""
    _kernel_checks(("q", q), ("k", k), ("v", v), ("o", o), ("do", do))
    lib = FlashAttentionBuilder().load()
    dq = torch.empty_like(q)
    delta = torch.empty_like(lse)
    s, s_ptr = _slopes_ptr(slopes, q.shape[2], q.device)
    with torch.cuda.device(q.device):
        err = lib.ds_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), s_ptr, dq.data_ptr(),
            delta.data_ptr(), *_dims(q, k, scale, causal, window))
    _raise_on(lib, err, "dq")
    flash_attention_bwd_dq.launches += 1
    return dq, delta


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale, causal=True,
                            window=0, slopes=None):
    """dk/dv kernel: (dk, dv) in k's dtype, summed over each kv head's
    group of q heads.  CUDA tensors only."""
    _kernel_checks(("q", q), ("k", k), ("v", v), ("do", do))
    lib = FlashAttentionBuilder().load()
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    s, s_ptr = _slopes_ptr(slopes, q.shape[2], q.device)
    with torch.cuda.device(q.device):
        err = lib.ds_flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), s_ptr, dk.data_ptr(),
            dv.data_ptr(), *_dims(q, k, scale, causal, window))
    _raise_on(lib, err, "dk/dv")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0


@torch.library.custom_op("deepspeed_tpu_torch::flash_attention_fwd",
                         mutates_args=())
def flash_forward_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     slopes: Optional[torch.Tensor], causal: bool,
                     scale: float, window: int,
                     use_kernel: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel (or, ``use_kernel=False``, its plain version) as
    one dispatcher op: (o, lse).  A selective activation-checkpointing
    policy sees it as one op and can keep its outputs
    (``runtime/activation_checkpointing``)."""
    fwd = flash_attention_fwd if use_kernel else _plain_fwd
    o, lse = fwd(q, k, v, scale, causal, window, slopes)
    return o.contiguous(), lse


@flash_forward_op.register_fake
def _(q, k, v, slopes, causal, scale, window, use_kernel):
    return (torch.empty_like(q),
            q.new_empty((q.shape[0], q.shape[2], q.shape[1]),
                        dtype=torch.float32))


class FlashAttentionFunction(torch.autograd.Function):
    """The port of ``_flash``'s custom VJP: the forward kernel, then the dq
    and dk/dv kernels by recomputation from the saved fp32 lse — or, with
    ``use_kernel=False``, each kernel's plain version."""

    @staticmethod
    def forward(ctx, q, k, v, slopes, causal, scale, window, use_kernel):
        o, lse = flash_forward_op(q, k, v, slopes, causal, scale, window,
                                  use_kernel)
        ctx.save_for_backward(q, k, v, o, lse, slopes)
        ctx.cfg = (scale, causal, window, use_kernel)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, slopes = ctx.saved_tensors
        scale, causal, window, use_kernel = ctx.cfg
        bwd_dq, bwd_dkv = ((flash_attention_bwd_dq, flash_attention_bwd_dkv)
                           if use_kernel else (_plain_bwd_dq, _plain_bwd_dkv))
        do = do.contiguous()
        dq, delta = bwd_dq(q, k, v, o, do, lse, scale, causal, window, slopes)
        dk, dv = bwd_dkv(q, k, v, do, lse, delta, scale, causal, window,
                         slopes)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, causal=True, softmax_scale=None,
                    block_q=DEFAULT_BLOCK_Q, block_k=DEFAULT_BLOCK_K,
                    window=0, alibi_slopes=None):
    """[B, S, H, D] flash attention with GQA (Hkv | Hq), differentiable in
    q, k and v, with the JAX function's signature.  ``window`` > 0 keeps
    each query's last ``window`` keys (needs ``causal``).  ``block_q`` and
    ``block_k`` are the TPU kernel's tile sizes: they are checked (positive
    ints or None), but the card's kernels use tiles of their own, so they
    do not change the result.  CPU tensors: the plain version; CUDA
    tensors: the kernels (bf16, fp16 or fp32, head_dim <= 128,
    contiguous)."""
    check_tiles(block_q, block_k)
    device = _check(q, k, v, causal, window, alibi_slopes)
    if device == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     softmax_scale=softmax_scale,
                                     window=window,
                                     alibi_slopes=alibi_slopes)
    if device != "cuda":
        raise ValueError(f"flash attention runs on cpu or cuda, not {device}")
    scale = (float(softmax_scale) if softmax_scale is not None
             else q.shape[-1]**-0.5)
    return FlashAttentionFunction.apply(
        q, k, v, _slopes_f32(alibi_slopes, q.shape[2], q.device),
        bool(causal), scale, int(window), True)
