"""Block-sparsity layout configs (reference
``ops/sparse_attention/sparsity_config.py``: SparsityConfig base + Dense,
Fixed, Variable, BigBird, BSLongformer).

The port's own copy of ``deepspeed_tpu/ops/sparse_attention/
sparsity_config.py`` (numpy only; the port imports nothing of the JAX
package).  The layouts must stay array-equal to the JAX package's,
random blocks included (``np.random.default_rng(seed)``):
``tests/test_torch_sparse_attention.py`` holds them so.

A layout is a boolean block matrix ``[num_heads, nq_blocks, nk_blocks]``
(True = that (q-block, k-block) tile is attended).  The math of each variant
follows the published patterns (Sparse Transformers fixed, BigBird
global+window+random, Longformer sliding+global); the construction below is
written from those definitions, not the reference's tensor code.
"""

import numpy as np


class SparsityConfig:
    """Base: block size + head layout sharing (reference ``:SparsityConfig``)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head

    @property
    def num_layout_heads(self):
        return self.num_heads if self.different_layout_per_head else 1

    def setup_layout(self, seq_len):
        if seq_len % self.block != 0:
            raise ValueError(
                f"seq_len {seq_len} not divisible by block {self.block}")
        nb = seq_len // self.block
        return np.zeros((self.num_heads, nb, nb), dtype=bool)

    def _broadcast_heads(self, layout):
        if not self.different_layout_per_head:
            layout[1:] = layout[0]
        return layout

    def make_layout(self, seq_len):
        raise NotImplementedError


class DenseSparsityConfig(SparsityConfig):
    """All blocks attended (debug/reference parity)."""

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        layout[:] = True
        return layout


class FixedSparsityConfig(SparsityConfig):
    """Sparse-Transformers 'fixed': local windows of ``num_local_blocks``
    plus column attention to the last ``num_global_blocks`` block(s) of each
    preceding window (reference ``:FixedSparsityConfig``)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_local_blocks=4, num_global_blocks=1,
                 attention="bidirectional", horizontal_global_attention=False,
                 num_different_global_patterns=1):
        super().__init__(num_heads, block, different_layout_per_head)
        if num_local_blocks % num_global_blocks != 0:
            raise ValueError("num_local_blocks must be a multiple of "
                             "num_global_blocks")
        self.num_local_blocks = num_local_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.num_different_global_patterns = num_different_global_patterns

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        L, G = self.num_local_blocks, self.num_global_blocks
        causal = self.attention == "unidirectional"
        for h in range(self.num_layout_heads):
            # local windows
            for start in range(0, nb, L):
                end = min(start + L, nb)
                for i in range(start, end):
                    hi = (i + 1) if causal else end
                    layout[h, i, start:hi] = True
            # global columns: representative block(s) of each window
            pat = (h % self.num_different_global_patterns
                   if self.different_layout_per_head else 0)
            for start in range(0, nb, L):
                # last G blocks of the window, shifted by the head pattern
                g_lo = start + L - (pat + 1) * G
                g_hi = g_lo + G
                if g_lo < 0 or g_lo >= nb:
                    continue
                g_hi = min(g_hi, nb)
                if causal:
                    layout[h, g_hi:, g_lo:g_hi] = True
                else:
                    layout[h, :, g_lo:g_hi] = True
                if self.horizontal_global_attention:
                    layout[h, g_lo:g_hi, :] = True
        if causal:
            tri = np.tril(np.ones((nb, nb), dtype=bool))
            layout &= tri
        return self._broadcast_heads(layout)


class VariableSparsityConfig(SparsityConfig):
    """Variable local window sizes + explicit global block indices + random
    blocks (reference ``:VariableSparsityConfig``)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_random_blocks=0, local_window_blocks=(4, ),
                 global_block_indices=(0, ), global_block_end_indices=None,
                 attention="bidirectional", horizontal_global_attention=False,
                 seed=0):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.local_window_blocks = list(local_window_blocks)
        self.global_block_indices = list(global_block_indices)
        self.global_block_end_indices = (
            list(global_block_end_indices) if global_block_end_indices else None)
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.seed = seed

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        causal = self.attention == "unidirectional"
        rng = np.random.default_rng(self.seed)
        for h in range(self.num_layout_heads):
            # variable local windows: cycle through the given sizes
            start = 0
            wi = 0
            while start < nb:
                w = self.local_window_blocks[
                    min(wi, len(self.local_window_blocks) - 1)]
                end = min(start + w, nb)
                for i in range(start, end):
                    hi = (i + 1) if causal else end
                    layout[h, i, start:hi] = True
                start = end
                wi += 1
            # globals
            if self.global_block_end_indices is None:
                cols = [(i, i + 1) for i in self.global_block_indices]
            else:
                cols = list(zip(self.global_block_indices,
                                self.global_block_end_indices))
            for lo, hi in cols:
                lo, hi = max(lo, 0), min(hi, nb)
                layout[h, :, lo:hi] = True
                if self.horizontal_global_attention:
                    layout[h, lo:hi, :] = True
            # random blocks
            for i in range(nb):
                if self.num_random_blocks:
                    cols_r = rng.choice(nb, size=self.num_random_blocks,
                                        replace=False)
                    layout[h, i, cols_r] = True
        if causal:
            layout &= np.tril(np.ones((nb, nb), dtype=bool))
        return self._broadcast_heads(layout)


class BigBirdSparsityConfig(SparsityConfig):
    """BigBird: random + sliding window + global (reference
    ``:BigBirdSparsityConfig``)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_random_blocks=1, num_sliding_window_blocks=3,
                 num_global_blocks=1, attention="bidirectional", seed=0):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.seed = seed

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        g = self.num_global_blocks
        causal = self.attention == "unidirectional"
        rng = np.random.default_rng(self.seed)
        for h in range(self.num_layout_heads):
            for i in range(nb):
                layout[h, i, max(0, i - w):min(nb, i + w + 1)] = True
                if self.num_random_blocks:
                    cols = rng.choice(nb, size=self.num_random_blocks,
                                      replace=False)
                    layout[h, i, cols] = True
            layout[h, :, :g] = True     # global columns
            layout[h, :g, :] = True     # global rows
        if causal:
            layout &= np.tril(np.ones((nb, nb), dtype=bool))
        return self._broadcast_heads(layout)


class BSLongformerSparsityConfig(SparsityConfig):
    """Longformer: sliding window + explicit global blocks (reference
    ``:BSLongformerSparsityConfig``)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_sliding_window_blocks=3, global_block_indices=(0, ),
                 global_block_end_indices=None, attention="bidirectional"):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = list(global_block_indices)
        self.global_block_end_indices = (
            list(global_block_end_indices) if global_block_end_indices else None)
        self.attention = attention

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        for h in range(self.num_layout_heads):
            for i in range(nb):
                layout[h, i, max(0, i - w):min(nb, i + w + 1)] = True
            if self.global_block_end_indices is None:
                cols = [(i, i + 1) for i in self.global_block_indices]
            else:
                cols = list(zip(self.global_block_indices,
                                self.global_block_end_indices))
            for lo, hi in cols:
                lo, hi = max(lo, 0), min(hi, nb)
                layout[h, :, lo:hi] = True
                layout[h, lo:hi, :] = True
        if self.attention == "unidirectional":
            layout &= np.tril(np.ones((nb, nb), dtype=bool))
        return self._broadcast_heads(layout)
