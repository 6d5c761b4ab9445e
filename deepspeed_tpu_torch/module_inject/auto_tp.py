"""AutoTP: tensor-parallel sharding of a model's parameters (the port of
``deepspeed_tpu/module_inject/auto_tp.py``; reference
``module_inject/auto_tp.py:273``).

The JAX file derives a **rule table** (flax parameter-path suffix →
``PartitionSpec``) and places each leaf with one ``jax.device_put``; GSPMD
then inserts the collectives.  The port keeps the rule table, its three name
patterns and its divisibility fallback, with a spec type of its own
(:class:`Spec`: a tuple of axis names, or tuples of them, or None, per
dimension of the flax leaf), and :func:`shard_params_for_tp` does what the
reference's ``ReplaceWithTensorSlicing`` does: it cuts each covered leaf
to this rank's slice and swaps the covered linears and embeddings for
``module_inject/layers.py``'s parallel modules, which make the
collectives.

Rules speak of the JAX package's flax paths and shapes; a port model
names its leaves after HuggingFace and keeps torch's ``[out, in]``
layouts.  Each model module maps one to the other with ``tp_leaf_info(name,
shape, cfg)``: the leaf's flax path, its flax shape and, for each flax
dimension, the torch dimension a split of it is (None where a split would
not be one contiguous slab).  Rank t keeps slab t of that torch dimension,
which holds the same elements as the t-th addressable shard of JAX's
``NamedSharding`` for the spec.
"""

import re
import sys

from ..utils.logging import logger

# column-parallel (shard output features, the LAST kernel dim): layers whose
# outputs stay sharded until a row-parallel layer reduces them
_COLUMN_PAT = re.compile(
    r"(q_proj|k_proj|v_proj|qkv|query|key|value|gate_proj|up_proj|c_fc|fc1"
    r"|wi_0|wi_1|wi|dense_h_to_4h|w1|w3|intermediate)$")
# row-parallel (shard input features, the FIRST kernel dim): the reduce point
_ROW_PAT = re.compile(
    r"(o_proj|out_proj|down_proj|c_proj|mlp_proj|fc2|wo|dense_4h_to_h|w2"
    r"|attention_output|output)$")
# vocab-sharded embeddings
_EMBED_PAT = re.compile(r"(embed_tokens|wte|word_embeddings|embedding)$")

TP_AXIS = "tp"


class Spec(tuple):
    """A partition spec: per dimension an axis name, a tuple of names, or
    None (JAX's ``PartitionSpec``, without ``jax.sharding``)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self):
        return f"Spec{tuple.__repr__(self)}"


def _walk(tree, prefix=()):
    """[(flax path tuple, leaf)] of a nested dict, in insertion order."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += _walk(v, prefix + (str(k), ))
        else:
            out.append((prefix + (str(k), ), v))
    return out


def path_str(path):
    """A flax path tuple → the ``a/b/c`` string rules match."""
    return "/".join(str(p) for p in path)


def match_tp_rule(rules, path):
    """The spec of ``path`` (``a/b/c``) in ``rules`` (JAX
    ``partition.py:152``): the longest exact suffix key at a component
    boundary, a scope wildcard ``scope/*`` claiming the leading dims and
    composing with an exact key matched at the same time."""
    if not rules:
        return None
    best, best_len = None, -1
    scope_spec, scope_len = None, -1
    bounded = "/" + path
    for key, spec in rules.items():
        if key.endswith("/*"):
            scope = key[:-2]
            if ("/" + scope + "/") in bounded and len(key) > scope_len:
                scope_spec, scope_len = spec, len(key)
            continue
        if (path == key or path.endswith("/" + key)) and len(key) > best_len:
            best, best_len = spec, len(key)
    if scope_spec is not None and best is not None:
        return Spec(*tuple(scope_spec) + tuple(best))
    if scope_spec is not None:
        return scope_spec
    return best


class AutoTP:
    """Derive TP sharding rules from a parameter tree (reference
    ``AutoTP.tp_parser``, ``module_inject/auto_tp.py:273``)."""

    @staticmethod
    def derive_rules(params, tp_axis=TP_AXIS):
        """Rules from a flax-layout tree (nested dicts of anything with a
        ``shape``), or from a port model through its ``tp_leaf_info``."""
        if not isinstance(params, dict):
            params = flax_shape_tree(params)
        rules = {}
        for path, leaf in _walk(params):
            parts = list(path)
            if len(parts) < 2 or parts[-1] not in ("kernel", "embedding"):
                continue
            owner = parts[-2]
            ndim = len(tuple(leaf.shape))
            if parts[-1] == "embedding" or _EMBED_PAT.search(owner):
                rules[f"{owner}/{parts[-1]}"] = Spec(tp_axis, None)
            elif _COLUMN_PAT.search(owner):
                # DenseGeneral kernels may be [D, H, Dh] (3D): shard the
                # first output dim (heads); plain Dense [D, F]: shard F.
                spec = ((None, tp_axis, None) if ndim == 3 else
                        (None, ) * (ndim - 1) + (tp_axis, ))
                rules[f"{owner}/kernel"] = Spec(*spec)
            elif _ROW_PAT.search(owner):
                spec = (tp_axis, ) + (None, ) * (ndim - 1)
                rules[f"{owner}/kernel"] = Spec(*spec)
        return rules

    @staticmethod
    def is_column_parallel(name):
        return bool(_COLUMN_PAT.search(name))

    @staticmethod
    def is_row_parallel(name):
        return bool(_ROW_PAT.search(name))


def _axes(ax):
    return ax if isinstance(ax, tuple) else (ax, )


def _restrict_spec_to_mesh(spec, axis_names=(TP_AXIS, )):
    """Drop the axes the mesh lacks: the ``zero`` pin and a training axis
    such as ``ep`` (``Spec('ep', None, ('tp', 'zero'))`` → ``Spec(None,
    None, 'tp')`` on a tp mesh).  ``axis_names``: the mesh's axes (or an
    object with ``axis_names``)."""
    have = set(getattr(axis_names, "axis_names", axis_names))
    out = []
    for ax in spec:
        names = tuple(a for a in _axes(ax) if a is not None and a in have)
        out.append(names if len(names) > 1 else (names[0] if names else None))
    return Spec(*out)


def _divisible(shape, spec, sizes):
    """Whether every sharded dim of ``shape`` divides over its axes
    (``sizes``: axis name → size)."""
    for dim, axis in zip(shape, tuple(spec) + (None, ) * len(shape)):
        if axis is None:
            continue
        size = 1
        for a in _axes(axis):
            size *= sizes[a]
        if dim % size != 0:
            return False
    return True


def _model_module(model):
    return sys.modules.get(type(model).__module__)


def leaf_info(model):
    """[(name, flax path, flax shape, torch dim per flax dim)] of the
    model's parameters (its module's ``tp_leaf_info``)."""
    info = getattr(_model_module(model), "tp_leaf_info", None)
    if info is None:
        raise TypeError(f"{type(model).__name__}'s module has no "
                        "tp_leaf_info (the map from its leaves to the flax "
                        "paths tp rules name)")
    out = []
    cfg = getattr(model, "config", None)
    for name, p in model.named_parameters():
        got = info(name, tuple(p.shape), cfg)
        if got is not None:
            out.append((name, ) + tuple(got))
    return out


class _Shape:

    def __init__(self, shape):
        self.shape = tuple(shape)
        self.ndim = len(self.shape)


def flax_shape_tree(model):
    """The model's leaves as the JAX package's nested flax tree of shapes
    (what rules and :meth:`AutoTP.derive_rules` read)."""
    tree = {}
    for _, path, shape, _ in leaf_info(model):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = _Shape(shape)
    return tree


def model_tp_rules(model):
    """The model's own rules: ``model.tp_sharding_rules``, else its
    module's ``tp_rules(config)``, else None."""
    rules = getattr(model, "tp_sharding_rules", None)
    if rules is not None:
        return rules
    fn = getattr(_model_module(model), "tp_rules", None)
    return None if fn is None else fn(model.config)


def tp_splits(model, rules, tp, tp_axis=TP_AXIS):
    """{name: torch dim} of the leaves ``rules`` shard at tp size ``tp``;
    a leaf whose sharded dim ``tp`` does not divide, or whose split is no
    slab of its torch layout, stays whole (with JAX's warning), unless the
    model's module lists it in ``TP_PAD_LEAVES``: then each rank holds
    ``ceil(dim / tp)`` rows, the last ones padded with zeros (GPT-2's
    50257-row vocabulary, which GSPMD pads too)."""
    out = {}
    pads = getattr(_model_module(model), "TP_PAD_LEAVES", ())
    for name, path, shape, dims in leaf_info(model):
        spec = match_tp_rule(rules, path_str(path))
        if spec is None:
            continue
        spec = _restrict_spec_to_mesh(spec, (tp_axis, ))
        sharded = [d for d, ax in enumerate(spec) if ax is not None]
        if not sharded:
            continue
        if not _divisible(shape, spec, {tp_axis: tp}) and name not in pads:
            logger.warning(
                "AutoTP: %s shape %s not divisible by %s — replicating",
                path_str(path), shape, spec)
            continue
        d = dims[sharded[0]] if len(sharded) == 1 else None
        if d is None:
            logger.warning("AutoTP: %s: %s is no slab of the port's layout "
                           "— replicating", path_str(path), spec)
            continue
        out[name] = d
    return out


def shard_params_for_tp(model, rules=None, group=None, tp_axis=TP_AXIS):
    """Cut ``model`` to this rank's part over the tp ``group`` (default:
    the mesh's tp group), in place, and return it (reference
    ``ReplaceWithTensorSlicing``, ``auto_tp.py:30``).  ``rules`` default to
    :func:`model_tp_rules`, else :meth:`AutoTP.derive_rules`.

    A sharded ``nn.Linear`` becomes a :class:`ColumnParallelLinear` (its
    weight split on dim 0) or a :class:`RowParallelLinear` (dim 1), a
    sharded ``nn.Embedding`` a :class:`VocabParallelEmbedding`, and any
    other sharded parameter is cut in place, its module given the group
    (``tp_group``, ``tp_rank``, ``tp_size``).  Slices are contiguous; a
    meta model stays meta.  The model records ``tp_splits`` ({name: (dim,
    rank, size)}) and ``tp_global_shapes`` ({name: whole shape}), which
    loaders read to cut whole tensors (``tp_local``)."""
    from torch import nn
    from .layers import (ColumnParallelLinear, RowParallelLinear,
                         VocabParallelEmbedding, _slice)
    if group is None:
        from ..utils import groups
        group = groups._get_tensor_parallel_group()
    size, rank = group.size(), group.rank()
    if rules is None:
        rules = model_tp_rules(model) or AutoTP.derive_rules(model)
    # at one rank every covered layer is replaced too, holding it whole
    splits = tp_splits(model, rules, size, tp_axis)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    done = {}
    for name, dim in list(splits.items()):
        *path, leaf = name.split(".")
        owner = model.get_submodule(".".join(path))
        if id(owner) in done:
            continue
        parent_path, _, attr = ".".join(path).rpartition(".")
        parent = model.get_submodule(parent_path)
        if isinstance(owner, nn.Linear) and leaf == "weight":
            cls = ColumnParallelLinear if dim == 0 else RowParallelLinear
            new = cls.from_linear(owner, group, rank, size)
        elif isinstance(owner, nn.Embedding) and dim == 0:
            new = VocabParallelEmbedding.from_embedding(owner, group, rank,
                                                        size)
        else:
            p = getattr(owner, leaf)
            setattr(owner, leaf, nn.Parameter(_slice(p.detach(), dim, rank,
                                                     size),
                                              requires_grad=p.requires_grad))
            owner.tp_group, owner.tp_rank, owner.tp_size = group, rank, size
            bias = ".".join(path + ["bias"])
            n_in = getattr(owner, "n_in", None)
            if leaf == "kernel" and n_in is not None and dim >= n_in and \
                    bias in shapes and bias not in splits:
                # a DenseGeneral sharded on an output dim: its bias (of the
                # output shape) follows, as GSPMD propagates it
                b = owner.bias
                owner.bias = nn.Parameter(
                    _slice(b.detach(), dim - n_in, rank, size),
                    requires_grad=b.requires_grad)
                splits[bias] = dim - n_in
            continue
        setattr(parent, attr, new)
        done[id(owner)] = new
        if isinstance(new, ColumnParallelLinear) and new.bias is not None:
            # the bias follows the kernel's output slices
            splits[".".join(path + ["bias"])] = 0
    model.tp_splits = {n: (d, rank, size) for n, d in splits.items()}
    model.tp_global_shapes = shapes
    return model


def tp_local(model, name, t):
    """``t``, a whole value of leaf ``name``, cut to this rank's slice when
    the model is sharded (contiguous); else ``t``."""
    split = getattr(model, "tp_splits", {}).get(name)
    if split is None:
        return t
    dim, rank, size = split
    whole = model.tp_global_shapes[name]
    if tuple(t.shape) != tuple(whole):
        return t
    from .layers import _slice
    return _slice(t, dim, rank, size)


def tp_trim(t, dim, whole):
    """The slices of a padded leaf joined along ``dim`` (``tp · ceil(whole
    / tp)`` long) cut back to its ``whole`` length; else ``t``."""
    if t.shape[dim] == whole:
        return t
    return t.narrow(dim, 0, whole)
