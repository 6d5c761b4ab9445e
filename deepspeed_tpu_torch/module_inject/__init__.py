from .auto_tp import AutoTP, Spec, shard_params_for_tp
from .containers import (InjectionPolicy, POLICIES, policy_for,
                         replace_transformer_layer,
                         revert_transformer_layer)
from .layers import (ColumnParallelLinear, RowParallelLinear, LinearAllreduce,
                     LinearLayer, VocabParallelEmbedding)
from .tp_parser import TpParser, derive_tp_rules_from_dataflow
from .replace_module import (fused_attention, generic_injection,
                             make_interceptor)
