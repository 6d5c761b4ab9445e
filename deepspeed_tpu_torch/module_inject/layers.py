"""Tensor-parallel layers (the port of ``deepspeed_tpu/module_inject/
layers.py``; reference ``module_inject/layers.py``: ``LinearLayer`` :124,
``LinearAllreduce`` :78).

The JAX layers put a sharding constraint on the kernel and let GSPMD insert
the all-reduce.  Here one process a rank holds its slice of each sharded
weight and its tp group, and the layers make the collectives themselves
(``comm/functional.py``):

* :class:`ColumnParallelLinear` holds rows ``[r·n, (r+1)·n)`` of the
  ``[out, in]`` weight (and of the bias): its product gives this rank's
  ``out/tp`` features.  Its input enters the tp region through
  :func:`copy_to_tp_region` (identity forward, psum of the gradient
  backward);
* :class:`RowParallelLinear` holds columns ``[r·n, (r+1)·n)`` of the weight
  (the bias whole): its product is a partial sum, reduced over the group by
  :func:`reduce_from_tp_region`, then the bias is added once;
* :class:`VocabParallelEmbedding` holds rows ``[r·n, (r+1)·n)`` of the
  ``[V, D]`` table: ids outside its range look up zeros and the rows are
  summed over the group.  JAX has no module for it (only the
  ``embed_tokens/embedding`` rule), the port needs one.

Each keeps its parameters under ``weight``/``bias``, so a model's names do
not change when ``module_inject/auto_tp.py:shard_params_for_tp`` swaps
them in, and records its ``tp_group``, ``tp_rank`` and ``tp_size``.  At one rank each computes bit for bit what the
``nn.Linear`` or ``nn.Embedding`` it replaces computes.

The models call the products themselves (``models/llama.py``: one
``copy_to_tp_region`` for q, k and v, one for gate and up), so the helpers
below read a layer's group: :func:`tp_group_of`.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..comm.functional import (copy_to_tp_region, gather_from_tp_region,
                               reduce_from_tp_region)


def tp_group_of(module):
    """The tp group a parallel layer computes over; None for any other
    module or a group of one rank."""
    g = getattr(module, "tp_group", None)
    return g if g is not None and g.size() > 1 else None


def _param(t):
    return nn.Parameter(t, requires_grad=False)


def _slice(t, dim, rank, size):
    """Slice ``rank`` of ``size`` of ``t`` along ``dim``, contiguous (a
    meta tensor stays meta).  Where ``size`` does not divide the dim, each
    slice is ``ceil(dim / size)`` long and the last ones are padded with
    zeros (a padded vocabulary, ``auto_tp.tp_splits``)."""
    whole = t.shape[dim]
    n = -(-whole // size)
    lo = min(rank * n, whole)
    part = t.narrow(dim, lo, min(n, whole - lo))
    if part.shape[dim] == n:
        return part.contiguous()
    pad = list(t.shape)
    pad[dim] = n - part.shape[dim]
    return torch.cat([part, torch.zeros(pad, dtype=t.dtype,
                                        device=t.device)], dim=dim)


class _Parallel(nn.Module):

    def _setup(self, group, rank, size):
        self.tp_group = group
        self.tp_rank = int(rank)
        self.tp_size = int(size)


class ColumnParallelLinear(_Parallel):
    """Output-feature-sharded linear (reference ``LinearLayer``).  Build it
    from a whole ``nn.Linear`` with :meth:`from_linear`."""

    def __init__(self, weight, bias=None, group=None, rank=0, size=1):
        super().__init__()
        self._setup(group, rank, size)
        self.weight = _param(weight)
        self.bias = None if bias is None else _param(bias)

    @classmethod
    def from_linear(cls, lin, group, rank, size):
        return cls(_slice(lin.weight.detach(), 0, rank, size),
                   None if lin.bias is None else
                   _slice(lin.bias.detach(), 0, rank, size),
                   group, rank, size)

    def forward(self, x):
        return F.linear(copy_to_tp_region(x, tp_group_of(self)), self.weight,
                        self.bias)


class RowParallelLinear(_Parallel):
    """Input-feature-sharded linear; its product's partial sums are
    all-reduced over the group (reference ``LinearAllreduce``)."""

    def __init__(self, weight, bias=None, group=None, rank=0, size=1):
        super().__init__()
        self._setup(group, rank, size)
        self.weight = _param(weight)
        self.bias = None if bias is None else _param(bias)

    @classmethod
    def from_linear(cls, lin, group, rank, size):
        return cls(_slice(lin.weight.detach(), 1, rank, size),
                   None if lin.bias is None else lin.bias.detach(),
                   group, rank, size)

    def forward(self, x):
        y = reduce_from_tp_region(F.linear(x, self.weight), tp_group_of(self))
        return y if self.bias is None else y + self.bias


class VocabParallelEmbedding(_Parallel):
    """A ``[V, D]`` embedding table sharded on V; ``vocab_start`` is the
    first id this rank holds."""

    def __init__(self, weight, group=None, rank=0, size=1):
        super().__init__()
        self._setup(group, rank, size)
        self.weight = _param(weight)

    @classmethod
    def from_embedding(cls, emb, group, rank, size):
        return cls(_slice(emb.weight.detach(), 0, rank, size), group, rank,
                   size)

    @property
    def vocab_start(self):
        return self.tp_rank * self.weight.shape[0]

    def forward(self, ids):
        return vocab_parallel_lookup(self.weight, ids, self.vocab_start,
                                     tp_group_of(self))


def vocab_parallel_lookup(weight, ids, vocab_start, group):
    """Rows of a vocabulary-sharded table: this rank's rows for the ids in
    ``[vocab_start, vocab_start + V/tp)``, zeros for the others, summed over
    ``group`` (exact: one nonzero term a row).  ``group`` None: a plain
    lookup."""
    ids = ids.long()
    if group is None:
        return F.embedding(ids, weight)
    local = ids - vocab_start
    outside = (local < 0) | (local >= weight.shape[0])
    rows = F.embedding(local.masked_fill(outside, 0), weight)
    rows = rows.masked_fill(outside.unsqueeze(-1), 0)
    return reduce_from_tp_region(rows, group)


def tp_embedding(module, ids, dtype=None):
    """``module``'s rows (an ``nn.Embedding`` or a
    :class:`VocabParallelEmbedding`), the table cast to ``dtype`` first."""
    w = module.weight if dtype is None else module.weight.to(dtype)
    if isinstance(module, VocabParallelEmbedding):
        return vocab_parallel_lookup(w, ids, module.vocab_start,
                                     tp_group_of(module))
    return F.embedding(ids.long(), w)


def vocab_slice(owner, table):
    """``(group, first row, rows)`` of a table ``owner`` holds (a flax-style
    ``Embed`` whose ``embedding`` ``shard_params_for_tp`` cut): its tp group
    (None when whole) and the global rows its slice covers."""
    group = tp_group_of(owner)
    rows = table.shape[0]
    return group, (owner.tp_rank * rows if group is not None else 0), rows


def embed_rows(owner, table, ids):
    """Rows of ``table`` (``owner``'s, cast as the caller wants) for
    ``ids``: a vocabulary-parallel lookup when the table is sharded."""
    group, start, _ = vocab_slice(owner, table)
    if group is None:
        return F.embedding(ids.long(), table)
    return vocab_parallel_lookup(table, ids, start, group)


def gather_logits(logits, head):
    """Vocabulary-sharded logits of a column-parallel head, all-gathered
    along the last dim (the whole vocabulary, the same on every rank)."""
    return gather_from_tp_region(logits, tp_group_of(head))


def attention_heads(q_proj, k_proj, cfg):
    """``(q heads, kv heads, kv rows, group)`` this rank's attention runs:
    the config's counts outside tensor parallelism, else the local counts
    from the weights' rows and, when the kv projections are replicated
    while q is sharded (GQA with fewer kv heads than tp ranks, JAX
    ``engine_v2.py:120-123``), the rows ``(start, stop)`` of the one kv
    head its q heads read (None otherwise)."""
    group = tp_group_of(q_proj)
    if group is None:
        return cfg.num_attention_heads, cfg.num_key_value_heads, None, None
    head_dim = cfg.head_dim
    hq = q_proj.weight.shape[0] // head_dim
    hkv = k_proj.weight.shape[0] // head_dim
    if tp_group_of(k_proj) is not None:
        return hq, hkv, None, group
    # tp = m · hkv ranks: rank r's hq heads lie in kv head r // m
    m = q_proj.tp_size // hkv
    kv = q_proj.tp_rank // m
    return hq, 1, (kv * head_dim, (kv + 1) * head_dim), group


def kv_weights(proj, rows, group):
    """``(weight, bias)`` of a k or v projection for this rank's heads: the
    whole replicated projection's ``rows`` (its gradient summed over the tp
    group, which each rank feeds its own q heads' part of), or the layer's
    own."""
    w, b = proj.weight, proj.bias
    if rows is None:
        return w, b
    w = copy_to_tp_region(w, group)[rows[0]:rows[1]]
    if b is not None:
        b = copy_to_tp_region(b, group)[rows[0]:rows[1]]
    return w, b


# reference-compatible names
LinearLayer = ColumnParallelLinear
LinearAllreduce = RowParallelLinear
