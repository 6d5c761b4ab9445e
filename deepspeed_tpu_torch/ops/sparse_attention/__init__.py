"""Block-sparse attention (reference ``deepspeed/ops/sparse_attention/``;
the port of ``deepspeed_tpu/ops/sparse_attention/``)."""

from .sparse_self_attention import SparseSelfAttention, sparse_attention
from .sparsity_config import (BigBirdSparsityConfig, BSLongformerSparsityConfig,
                              DenseSparsityConfig, FixedSparsityConfig,
                              SparsityConfig, VariableSparsityConfig)
