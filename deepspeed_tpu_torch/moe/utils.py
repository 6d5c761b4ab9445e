"""MoE parameter-group utilities (the port of
``deepspeed_tpu/moe/utils.py``; reference ``deepspeed/moe/utils.py``:
``has_moe_layers`` :15, ``is_moe_param`` :27,
``split_params_into_shared_and_expert_params`` :33,
``split_params_into_different_moe_groups_for_optimizer`` :72,
``configure_moe_param_groups`` :155).

JAX keys a leaf's identity on its pytree path; the port on its parameter
name, read as JAX's path (``checkpoint.flax_path``): a leaf under an
``experts`` scope, or one of Mixtral's stacks, is an expert leaf.  The
reference tags tensors with ``.allreduce=False``; here the names carry
it, and the splits are dicts name → tensor (None holes where JAX's trees
hold None)."""

from .checkpoint import flax_path, is_expert_path


def _named(params):
    """{name: tensor} of an ``nn.Module`` or a dict."""
    if hasattr(params, "named_parameters"):
        return dict(params.named_parameters())
    return dict(params)


def is_moe_param(name) -> bool:
    """Whether the parameter ``name`` is a stacked expert leaf."""
    return is_expert_path(flax_path(name))


def has_moe_layers(params):
    """(bool, number of expert leaves)."""
    n = sum(1 for name in _named(params) if is_moe_param(name))
    return n > 0, n


def moe_param_mask(params, experts=True):
    """{name: bool}: True on the expert leaves (the complement with
    ``experts=False``)."""
    return {name: is_moe_param(name) == experts for name in _named(params)}


def split_params_into_shared_and_expert_params(params):
    """(shared, expert): two dicts with every name, the other split's
    leaves None."""
    named = _named(params)
    shared = {n: (None if is_moe_param(n) else v) for n, v in named.items()}
    expert = {n: (v if is_moe_param(n) else None) for n, v in named.items()}
    return shared, expert


def split_params_grads_into_shared_and_expert_params(grads):
    return split_params_into_shared_and_expert_params(grads)


def configure_moe_param_groups(params, expert_lr=None,
                               expert_weight_decay=None):
    """[shared group, expert group]: dicts whose ``"params"`` hold the
    splits; the first carries ``"param_labels"`` ({name: "shared" or
    "expert"}), the second the expert overrides of lr and weight decay."""
    named = _named(params)
    labels = {n: ("expert" if is_moe_param(n) else "shared") for n in named}
    shared, expert = split_params_into_shared_and_expert_params(named)
    groups = [{"name": "shared", "params": shared, "moe": False,
               "param_labels": labels},
              {"name": "expert", "params": expert, "moe": True}]
    if expert_lr is not None:
        groups[1]["lr"] = expert_lr
    if expert_weight_decay is not None:
        groups[1]["weight_decay"] = expert_weight_decay
    return groups


def is_moe_param_group(param_group) -> bool:
    return bool(param_group.get("moe", False))


def split_params_into_different_moe_groups_for_optimizer(
        param_groups, max_group_size=None):
    """The tutorial's name: a module, a dict of parameters, a
    ``{"params": ..., **options}`` group or a list of such groups → the
    shared and expert groups (``max_group_size`` is ignored, as in JAX)."""
    if isinstance(param_groups, dict) and "params" in param_groups:
        base = dict(param_groups)
        groups = configure_moe_param_groups(base.pop("params"))
        for g in groups:
            for k, v in base.items():
                g.setdefault(k, v)
        return groups
    if isinstance(param_groups, (list, tuple)) and param_groups and \
            all(isinstance(pg, dict) and "params" in pg
                for pg in param_groups):
        out = []
        for pg in param_groups:
            out.extend(
                split_params_into_different_moe_groups_for_optimizer(pg))
        return out
    return configure_moe_param_groups(param_groups)
