from .checkpoint import (is_expert_path, load_moe_expert_files,
                         save_moe_expert_files)
from .engine import (MoeOptions, dispatch_combine, dispatch_wire,
                     ep_hierarchy, expert_dispatch_wire_bytes)
from .experts import ExpertFFN, Experts, expert_sharding_rules
from .layer import MoE
from .sharded_moe import TopKGate, top1gating, top2gating, topkgating
from .utils import (configure_moe_param_groups, has_moe_layers,
                    is_moe_param, is_moe_param_group, moe_param_mask,
                    split_params_grads_into_shared_and_expert_params,
                    split_params_into_different_moe_groups_for_optimizer,
                    split_params_into_shared_and_expert_params)
