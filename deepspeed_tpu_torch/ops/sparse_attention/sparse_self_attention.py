"""Block-sparse self attention: the port of ``deepspeed_tpu/ops/
sparse_attention/sparse_self_attention.py`` (reference
``ops/sparse_attention/sparse_self_attention.py:12``).

:func:`sparse_attention` is the gather formulation in plain PyTorch: each
q block gathers only its layout's live k/v blocks (padded to the layout's
largest row population) and takes one softmax over them, in fp32.  It is
the CPU path, the path under ``DS_TPU_DISABLE_PALLAS_ATTN``, and the
backward of the block-sparse kernel (B9, ``ops/kernels/
block_sparse_attention.py``), which has no backward kernel, as in JAX.
:class:`SparseSelfAttention` dispatches between the two.
"""

import numpy as np
import torch
from torch import nn

from .._use_kernels import use_kernels

_NEG_INF = float("-inf")


def _row_gather_indices(layout_h):
    """[nq, nk] bool → (idx [nq, maxk], valid [nq, maxk]) with idx padded by
    repeating the first live block (masked out via valid)."""
    nq, nk = layout_h.shape
    counts = layout_h.sum(axis=1)
    maxk = max(1, int(counts.max()))
    idx = np.zeros((nq, maxk), dtype=np.int32)
    valid = np.zeros((nq, maxk), dtype=bool)
    for i in range(nq):
        cols = np.nonzero(layout_h[i])[0]
        idx[i, :len(cols)] = cols
        valid[i, :len(cols)] = True
        if len(cols) == 0:
            valid[i, 0] = False
    return idx, valid


_GATHER_TABLE_CACHE = {}


def layout_key(layout):
    """The cache key of a layout: its shape and contents."""
    return layout.shape, layout.tobytes()


def layout_gather_tables(layout, num_heads):
    """[H or 1, nq, nk] bool layout → (layout, idx, valid), the latter two
    [H, nq, maxk] host arrays padded to the max row population.  Cached by
    layout contents: the Python row walk runs once per distinct layout,
    not per forward.  ``valid`` is a prefix of each row."""
    layout = np.asarray(layout)
    if layout.shape[0] == 1:
        layout = np.broadcast_to(layout, (num_heads, ) + layout.shape[1:])
    key = layout_key(layout)
    hit = _GATHER_TABLE_CACHE.get(key)
    if hit is not None:
        return layout, hit[0], hit[1]
    H = layout.shape[0]
    idxs, valids = zip(*(_row_gather_indices(layout[h]) for h in range(H)))
    maxk = max(i.shape[1] for i in idxs)
    idx = np.stack([np.pad(i, ((0, 0), (0, maxk - i.shape[1])))
                    for i in idxs]).astype(np.int32)   # [H, nq, maxk]
    valid = np.stack([np.pad(m, ((0, 0), (0, maxk - m.shape[1])))
                      for m in valids])                # [H, nq, maxk] bool
    if len(_GATHER_TABLE_CACHE) > 64:  # layouts are few; bound anyway
        _GATHER_TABLE_CACHE.clear()
    _GATHER_TABLE_CACHE[key] = (idx, valid)
    return layout, idx, valid


def sparse_attention(q, k, v, layout, block, causal=False, scale=None):
    """q/k/v: [B, S, H, D]; layout: [H or 1, nq, nk] bool (block level).
    Returns [B, S, H, D] in q's dtype, differentiable in q, k and v.

    fp32 scores × scale; padding slots masked, and with ``causal`` the
    row >= col mask within and between blocks; the max taken with -inf → 0
    (a row with no live key gives 0); the denominator floored at 1e-30."""
    B, S, H, D = q.shape
    nb = S // block
    scale = scale if scale is not None else D ** -0.5
    layout, idx, valid = layout_gather_tables(layout, H)
    maxk = idx.shape[2]
    dev = q.device
    idx_t = torch.as_tensor(idx, device=dev).long()
    valid_t = torch.as_tensor(valid, device=dev)

    def blocks(t):                         # → fp32 [H, B, nb, block, D]
        return t.reshape(B, nb, block, H, D).permute(3, 0, 1, 2, 4).float()

    qb, kb, vb = blocks(q), blocks(k), blocks(v)
    # each q block's live k/v blocks: [H, B, nq, maxk, block, D]
    hs = torch.arange(H, device=dev)[:, None, None, None]
    bs = torch.arange(B, device=dev)[None, :, None, None]
    kg = kb[hs, bs, idx_t[:, None]]
    vg = vb[hs, bs, idx_t[:, None]]
    s = torch.einsum("hbqtd,hbqkcd->hbqtkc", qb, kg) * scale
    mask = valid_t[:, None, :, None, :, None]       # [H, 1, nq, 1, maxk, 1]
    if causal:
        pos = torch.arange(block, device=dev)
        qpos = torch.arange(nb, device=dev)[:, None] * block + pos  # [nq, t]
        kpos = idx_t[..., None] * block + pos             # [H, nq, maxk, c]
        cm = qpos[None, :, :, None, None] >= kpos[:, :, None]
        mask = mask & cm[:, None]
    mask = mask.expand(s.shape)
    s = torch.where(mask, s, _NEG_INF)
    flat = s.shape[:4] + (maxk * block, )
    sf = s.reshape(flat)
    m = sf.amax(dim=-1, keepdim=True)
    m = torch.where(m == _NEG_INF, 0.0, m)
    p = torch.where(mask.reshape(flat), torch.exp(sf - m), 0.0)
    denom = torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)
    p = (p / denom).reshape(s.shape)
    out = torch.einsum("hbqtkc,hbqkcd->hbqtd", p, vg)   # [H, B, nq, t, D]
    return out.permute(1, 2, 3, 0, 4).reshape(B, S, H, D).to(q.dtype)


class SparseSelfAttention(nn.Module):
    """Reference ``SparseSelfAttention`` API: configure once with a
    SparsityConfig, call with [B, H, S, D] tensors (reference layout) or
    [B, S, H, D] (``bshd=True``).  ``causal`` defaults to the config's
    ``attention == "unidirectional"``; layouts are cached per sequence
    length.

    CUDA tensors with S a multiple of the layout block take the
    block-sparse kernel (B9), unless ``DS_TPU_DISABLE_PALLAS_ATTN`` is set;
    everything else takes the gather formulation, as in JAX."""

    def __init__(self, sparsity_config, key_padding_mask_mode="add",
                 attn_mask_mode="mul", max_seq_length=2048):
        super().__init__()
        self.sparsity_config = sparsity_config
        self.max_seq_length = max_seq_length
        self._layouts = {}

    def layout(self, seq_len):
        """The layout for ``seq_len``, made once on a ``bytes`` buffer, so
        that nothing can change it in place and the kernel's table cache
        can look it up by identity."""
        if seq_len not in self._layouts:
            layout = np.asarray(self.sparsity_config.make_layout(seq_len))
            self._layouts[seq_len] = np.frombuffer(
                layout.tobytes(), dtype=layout.dtype).reshape(layout.shape)
        return self._layouts[seq_len]

    def forward(self, query, key, value, bshd=False, causal=None):
        q, k, v = query, key, value
        if not bshd:  # reference [B, H, S, D] → internal [B, S, H, D]
            q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        S = q.shape[1]
        if causal is None:
            causal = getattr(self.sparsity_config, "attention",
                             None) == "unidirectional"
        block = self.sparsity_config.block
        fn = sparse_attention
        if use_kernels(q) and S % block == 0:
            from ..kernels.block_sparse_attention import \
                block_sparse_flash_attention
            fn = block_sparse_flash_attention
        out = fn(q, k, v, self.layout(S), block, causal=causal)
        return out if bshd else out.transpose(1, 2)
