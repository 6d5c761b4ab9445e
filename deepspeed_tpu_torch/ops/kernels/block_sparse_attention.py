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
q's dtype.  The layout's tables are built on the host once per layout
and moved to the card once per layout and device (:func:`device_tables`):
idx/valid (``layout_gather_tables``) for the fp32 route, and for the
bf16/fp16 route the row groups of :func:`row_group_tables` (64 query rows
a block, one key list per group: the union of its q blocks' live k
blocks, each with a mask of the warps that see it).

What bounds it on an H100: bytes and operations about equally at
BigBird's width, operations at block 16; bf16/fp16 run on the tensor
cores (``mma.sync``), fp32 on the CUDA cores (see the source's note).

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

GROUP_ROWS = 64      # query rows a block of the tensor-core kernel
WARP_ROWS = 16       # query rows a warp
SPLIT_FACTOR = 2     # a group whose union exceeds this × its longest
#                      member list is split into one group per member

_ROW_GROUP_CACHE = {}
_DEVICE_TABLE_CACHE = {}
_DEVICE_TABLE_BY_ID = {}


def _warp_rows(first):
    """The first row of each of the 4 warps' 16 rows of a group whose rows
    start at ``first``."""
    return [first + w * WARP_ROWS for w in range(4)]


def row_group_tables(layout, num_heads, block):
    """The tensor-core kernel's row groups of a layout: (groups int32
    [G, 8], keys int32 [L]).  A group row holds (head, offset of its key
    list in ``keys``, its length, the first query row of each of the 4
    warps or -1, 0); a key entry is ``k_block | warp_mask << 24``, bit w
    set where warp w sees that block.  A group is 64 // block consecutive q
    blocks (half a q block at block 128) with the union of their lists in
    ascending order; where the union is longer than SPLIT_FACTOR × its
    longest member list, each member q block becomes a group of its own
    (its warps' rows only).  Groups are ordered longest list first.
    Cached by layout contents and block."""
    layout, idx, valid = layout_gather_tables(layout, num_heads)
    key = layout_key(layout) + (block, )
    hit = _ROW_GROUP_CACHE.get(key)
    if hit is not None:
        return hit
    H, nq = idx.shape[:2]
    cnt = valid.sum(axis=-1)
    lists = [[idx[h, i, :cnt[h, i]] for i in range(nq)] for h in range(H)]
    members = max(1, GROUP_ROWS // block)   # q blocks a group
    per = 4 // members                      # warps a member q block
    full = (1 << per) - 1
    groups = []                             # (head, rows, [(kb, mask)])

    def add(h, rows, entries):
        groups.append((h, rows, sorted(entries.items())))

    for h in range(H):
        if block > GROUP_ROWS:              # two groups a q block
            for i in range(nq):
                for half in range(block // GROUP_ROWS):
                    add(h, _warp_rows(i * block + half * GROUP_ROWS),
                        {int(kb): 0xF for kb in lists[h][i]})
            continue
        for i0 in range(0, nq, members):
            mine = list(range(i0, min(i0 + members, nq)))
            union = {}
            for j, i in enumerate(mine):
                for kb in lists[h][i]:
                    union[int(kb)] = union.get(int(kb), 0) | (full << per * j)
            longest = max(len(lists[h][i]) for i in mine)
            rows = _warp_rows(i0 * block)
            rows[len(mine) * per:] = [-1] * (4 - len(mine) * per)
            if len(mine) == 1 or len(union) <= SPLIT_FACTOR * longest:
                add(h, rows, union)
                continue
            for j, i in enumerate(mine):        # one group a member
                own = [-1] * 4
                own[:per] = rows[j * per:(j + 1) * per]
                add(h, own, {int(kb): full for kb in lists[h][i]})
    groups.sort(key=lambda grp: -len(grp[2]))   # stable: longest first
    table = np.zeros((len(groups), 8), dtype=np.int32)
    keys, off = [], 0
    for n, (h, rows, entries) in enumerate(groups):
        table[n, :3] = (h, off, len(entries))
        table[n, 3:7] = rows
        keys += [kb | mask << 24 for kb, mask in entries]
        off += len(entries)
    hit = (table, np.asarray(keys or [0], dtype=np.int32))
    if len(_ROW_GROUP_CACHE) > 64:          # layouts are few; bound anyway
        _ROW_GROUP_CACHE.clear()
    _ROW_GROUP_CACHE[key] = hit
    return hit


def _immutable(layout):
    """A numpy layout nothing can change in place: its data lies in a
    ``bytes`` object, so numpy refuses to make it (or any view of it)
    writeable (``SparseSelfAttention``'s layouts are such).  A read-only
    array that owns its data is not: its owner may unfreeze it."""
    root = layout
    while isinstance(root, np.ndarray):
        root = root.base
    return isinstance(layout, np.ndarray) and isinstance(root, bytes)


def device_tables(layout, num_heads, device, block=None):
    """The kernel's tables of a layout on ``device``: (idx int32 [H, nq,
    maxk], cnt int32 [H, nq]) and, given ``block``, the row groups and key
    list of :func:`row_group_tables` after them.  Cached by layout
    contents, block and device (keyed like ``_GATHER_TABLE_CACHE``), so a
    forward copies nothing to the card.  An immutable layout (see
    :func:`_immutable`) is looked up by identity first: hashing the
    contents of a layout at block 16 and S = 4096 (1 MB) takes about a
    millisecond of host time a call, more than the kernel."""
    frozen, given = _immutable(layout), layout
    ident = (id(layout), num_heads, block, str(device))
    if frozen:
        hit = _DEVICE_TABLE_BY_ID.get(ident)
        if hit is not None and hit[0] is layout:
            return hit[1]
    layout, idx, valid = layout_gather_tables(layout, num_heads)
    key = layout_key(layout) + (block, str(device))
    hit = _DEVICE_TABLE_CACHE.get(key)
    if hit is None:
        if len(_DEVICE_TABLE_CACHE) > 64:  # layouts are few; bound anyway
            _DEVICE_TABLE_CACHE.clear()
        hit = (torch.as_tensor(idx, device=device).contiguous(),
               torch.as_tensor(valid.sum(axis=-1), dtype=torch.int32,
                               device=device).contiguous())
        if block is not None:
            hit += tuple(torch.as_tensor(t, device=device).contiguous()
                         for t in row_group_tables(layout, num_heads, block))
        _DEVICE_TABLE_CACHE[key] = hit
    if frozen:
        if len(_DEVICE_TABLE_BY_ID) > 64:
            _DEVICE_TABLE_BY_ID.clear()
        # the entry holds the layout: its id is not reused while cached
        _DEVICE_TABLE_BY_ID[ident] = (given, hit)
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
    idx, cnt, groups, keys = device_tables(layout, H, q.device, block)
    o = torch.empty(B, S, H, D, dtype=q.dtype, device=q.device)
    lib = BlockSparseAttentionBuilder().load()
    strides = [st for t in (q, k, v) for st in t.stride()[:3]]
    with torch.cuda.device(q.device):
        err = lib.ds_block_sparse_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            idx.data_ptr(), cnt.data_ptr(), groups.data_ptr(),
            keys.data_ptr(), groups.shape[0], B, S, H, D, block,
            idx.shape[1], idx.shape[2], *strides, scale, int(bool(causal)),
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
