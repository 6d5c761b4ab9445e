"""Block-sparse flash attention: the hand-written CUDA kernel's wrapper,
its autograd function and its plain PyTorch version.

Replaces the Pallas TPU kernel of ``deepspeed_tpu/ops/pallas/
block_sparse_attention.py``: ``block_sparse_flash_attention`` (:135), whose
``_kernel`` (:36) is launched at :102 behind the custom VJP ``_bs_flash``
(:114).  Here the kernel is ``csrc/block_sparse_attention.cu`` (nvcc for
``sm_90a``, called through ctypes on PyTorch's current stream) and the
custom VJP is :class:`BlockSparseAttentionFunction`: its forward launches
the kernel; its backward is autograd over the gather formulation
(``ops/sparse_attention/sparse_self_attention.py:sparse_attention``) on
the saved q, k and v, as JAX's ``_bs_bwd`` (:123) differentiates it.
There is no backward kernel, in JAX or here.

Semantics (the TPU kernel's): q, k, v [B, S, H, D] with S a multiple of
the layout block; a layout [H or 1, nq, nk] bool; for each q block only
its live k/v blocks, fp32 scores × scale, the causal mask row >= col, an
online softmax from -inf, a row with no live key giving 0, the output in
q's dtype.  The layout's idx/valid tables are built on the host once per
layout (``layout_gather_tables``) and moved to the card once per layout
and device (:func:`device_tables`).

What bounds it on an H100: bytes and operations about equally at
BigBird's width; the kernel runs its products in fp32 FMA on the CUDA
cores (see the source's note).

On CPU tensors :func:`block_sparse_flash_attention` computes
:func:`block_sparse_attention_plain`; on CUDA tensors it launches the
kernel or raises.  ``block_sparse_attention_fwd.launches`` counts kernel
launches.
"""

import numpy as np
import torch

from ..op_builder import BlockSparseAttentionBuilder
from ..sparse_attention.sparse_self_attention import (layout_gather_tables,
                                                      layout_key,
                                                      sparse_attention)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
BLOCKS = (16, 32, 64, 128)       # the layout blocks the kernel takes

_DEVICE_TABLE_CACHE = {}


def device_tables(layout, num_heads, device):
    """(idx int32 [H, nq, maxk], cnt int32 [H, nq]) of a layout on
    ``device``, cached by layout contents and device (keyed like
    ``_GATHER_TABLE_CACHE``), so a forward copies nothing to the card."""
    layout, idx, valid = layout_gather_tables(layout, num_heads)
    key = layout_key(layout) + (str(device), )
    hit = _DEVICE_TABLE_CACHE.get(key)
    if hit is None:
        if len(_DEVICE_TABLE_CACHE) > 64:  # layouts are few; bound anyway
            _DEVICE_TABLE_CACHE.clear()
        hit = (torch.as_tensor(idx, device=device).contiguous(),
               torch.as_tensor(valid.sum(axis=-1), dtype=torch.int32,
                               device=device).contiguous())
        _DEVICE_TABLE_CACHE[key] = hit
    return hit


def block_sparse_attention_plain(q, k, v, layout, block, causal=False,
                                 scale=None):
    """The kernel's function in plain PyTorch, step by step: each q block
    takes its live k/v blocks in slot order, each with an online softmax
    from -inf (fp32 scores × scale, the causal mask row >= col), a row
    with no live key giving 0 (JAX ``:71-75``).  [B, S, H, D] in q's
    dtype."""
    B, S, H, D = q.shape
    nb = S // block
    scale = scale if scale is not None else D ** -0.5
    layout, idx, valid = layout_gather_tables(layout, H)
    dev = q.device
    idx_t = torch.as_tensor(idx, device=dev).long()
    valid_t = torch.as_tensor(valid, device=dev)

    def blocks(t):                         # → fp32 [B, H, nb, block, D]
        return t.reshape(B, nb, block, H, D).permute(0, 3, 1, 2, 4).float()

    qb, kb, vb = blocks(q), blocks(k), blocks(v)
    pos = torch.arange(block, device=dev)
    qpos = (torch.arange(nb, device=dev)[:, None] * block + pos)[..., None]
    heads = torch.arange(H, device=dev)[:, None]
    acc = torch.zeros_like(qb)
    m = torch.full(qb.shape[:-1] + (1, ), float("-inf"), device=dev)
    l = torch.zeros_like(m)
    for j in range(idx.shape[2]):
        col = idx_t[:, :, j]                               # [H, nq]
        kj, vj = kb[:, heads, col], vb[:, heads, col]      # [B, H, nq, c, D]
        s = (qb @ kj.transpose(-1, -2)) * scale            # [B, H, nq, t, c]
        mask = torch.ones_like(s, dtype=torch.bool)
        if causal:
            kpos = col[..., None, None] * block + pos      # [H, nq, 1, c]
            mask = mask & (qpos >= kpos)
        s = torch.where(mask, s, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        m_safe = torch.where(m_new == float("-inf"), 0.0, m_new)
        p = torch.where(mask, torch.exp(s - m_safe), 0.0)
        alpha = torch.where(m == float("-inf"), 0.0, torch.exp(m - m_safe))
        live = valid_t[None, :, :, j, None, None]          # [1, H, nq, 1, 1]
        l = torch.where(live, alpha * l + p.sum(dim=-1, keepdim=True), l)
        acc = torch.where(live, acc * alpha + p @ vj, acc)
        m = torch.where(live, m_new, m)
    o = acc / torch.where(l == 0.0, 1.0, l)
    return o.permute(0, 2, 3, 1, 4).reshape(B, S, H, D).to(q.dtype)


def _raise_on(lib, err):
    if err:
        raise RuntimeError(f"block-sparse attention kernel launch failed: "
                           f"{lib.ds_cuda_error_string(err).decode()} "
                           f"({err})")


def block_sparse_attention_fwd(q, k, v, layout, block, causal=False,
                               scale=None):
    """One launch of the kernel on CUDA tensors: o [B, S, H, D] in q's
    dtype.  q, k, v may be any strided view whose last dim is contiguous
    (the ``[B, H, S, D]`` entry's transposes are not copied)."""
    B, S, H, D = q.shape
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"block-sparse attention kernel takes bf16, fp16 or "
                        f"fp32, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share a dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if block not in BLOCKS:
        raise ValueError(f"block-sparse attention kernel takes layout blocks "
                         f"{BLOCKS}, got {block}")
    if D > 128:
        raise ValueError(f"block-sparse attention kernel takes head_dim <= "
                         f"128, got {D}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q, k and v must have a contiguous last dim")
    devices = {t.device for t in (q, k, v)}
    if len(devices) != 1 or q.device.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors on one device, got "
                         f"{devices}")
    scale = float(scale) if scale is not None else D ** -0.5
    idx, cnt = device_tables(layout, H, q.device)
    o = torch.empty(B, S, H, D, dtype=q.dtype, device=q.device)
    lib = BlockSparseAttentionBuilder().load()
    strides = [st for t in (q, k, v) for st in t.stride()[:3]]
    with torch.cuda.device(q.device):
        err = lib.ds_block_sparse_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            idx.data_ptr(), cnt.data_ptr(), B, S, H, D, block, idx.shape[1],
            idx.shape[2], *strides, scale, int(bool(causal)),
            _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(lib, err)
    block_sparse_attention_fwd.launches += 1
    return o


block_sparse_attention_fwd.launches = 0


class BlockSparseAttentionFunction(torch.autograd.Function):
    """Forward: the kernel (``use_kernel``) or its plain version; backward:
    autograd over the gather formulation on the saved q, k, v."""

    @staticmethod
    def forward(ctx, q, k, v, layout, block, causal, scale, use_kernel):
        fwd = (block_sparse_attention_fwd if use_kernel
               else block_sparse_attention_plain)
        o = fwd(q, k, v, layout, block, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v)
        ctx.cfg = (layout, block, causal, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        layout, block, causal, scale = ctx.cfg
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True)
                      for t in ctx.saved_tensors]
            out = sparse_attention(*leaves, layout, block, causal=causal,
                                   scale=scale)
            grads = torch.autograd.grad(out, leaves, do)
        return (*grads, None, None, None, None, None)


def block_sparse_flash_attention(q, k, v, layout, block, causal=False,
                                 scale=None):
    """[B, S, H, D] block-sparse attention streaming only the layout's live
    blocks (layout: [H or 1, nq, nk] bool), with the JAX function's
    signature.  Differentiable in q, k and v (the backward is the gather
    formulation's).  S must be a multiple of ``block``.  CPU tensors: the
    plain version; CUDA tensors: the kernel (bf16, fp16 or fp32,
    head_dim <= 128, layout blocks 16, 32, 64 or 128)."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be [B, S, H, D] alike, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, D = q.shape
    if S % block:
        raise ValueError(f"S={S} not a multiple of layout block {block}")
    nb = S // block
    lshape = np.shape(layout)
    if len(lshape) != 3 or lshape[0] not in (1, H) or lshape[1:] != (nb,
                                                                    nb):
        raise ValueError(f"layout must be [{H} or 1, {nb}, {nb}], got "
                         f"{lshape}")
    device = q.device.type
    if device not in ("cpu", "cuda"):
        raise ValueError(f"block-sparse attention runs on cpu or cuda, not "
                         f"{device}")
    scale = float(scale) if scale is not None else D ** -0.5
    return BlockSparseAttentionFunction.apply(q, k, v, layout, block,
                                              bool(causal), scale,
                                              device == "cuda")
