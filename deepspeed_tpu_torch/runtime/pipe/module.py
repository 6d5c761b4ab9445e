"""PipelineModule (the port of ``deepspeed_tpu/runtime/pipe/module.py``;
reference ``runtime/pipe/module.py``: LayerSpec ``:30``, TiedLayerSpec
``:77``, PipelineModule ``:86``, ``_partition_layers`` ``:391`` with the
methods uniform | parameters | profile | type:regex).

A layer is a ``LayerSpec`` of a torch ``nn.Module`` class that takes
``device=`` (built only on the stage that runs it), a module instance, or
a plain callable ``f(x) -> x``.  ``TiedLayerSpec``s of one key share their
parameters: each stage that holds an occurrence holds one copy, and the
engine keeps the copies equal (``runtime/pipe/engine.py``).

:class:`PipeStage` is the ``nn.Module`` of one stage's layers, and at one
stage the whole model (``PipelineModule.to_module``: the plain model the
base engine trains, as JAX's ``_build_apply`` is the plain apply).  Its
parameters are named ``pre.{i}.*``, ``blocks.{j}.*`` (j the block's
index in the model), ``post.{i}.*`` and ``tied.{key}.*``: the groups of
the JAX engine's parameter tree (``params["pre"]["layer_i"]``,
``params["blocks"]``, ``params["post"]["layer_i"]``,
``params["tied"][key]``).  :func:`params_from_flax` and
:func:`params_to_flax` carry weights across.
"""

import inspect
import re
import time

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...utils.logging import logger
from ..utils import partition_balanced, partition_uniform


class LayerSpec:
    """Deferred layer constructor (reference ``module.py:30``): stores the
    class and its arguments so that a stage builds only its own layers."""

    def __init__(self, typename, *module_args, **module_kwargs):
        self.typename = typename
        self.module_args = module_args
        self.module_kwargs = module_kwargs

    def build(self, device=None):
        """The layer; ``device`` goes to a class that takes ``device=``."""
        kw = dict(self.module_kwargs)
        if device is not None and _takes_device(self.typename):
            kw["device"] = device
        return self.typename(*self.module_args, **kw)

    @property
    def name(self):
        return getattr(self.typename, "__name__", str(self.typename))

    def __repr__(self):
        return f"LayerSpec({self.name})"


class TiedLayerSpec(LayerSpec):
    """Reference ``:77``: layers sharing parameters across stages (e.g. a
    tied embedding and head).  ``key`` names the tie; ``forward_fn(module,
    x)`` lets an occurrence run another function over the shared module."""

    def __init__(self, key, typename, *module_args, forward_fn=None,
                 tied_weight_attr="weight", **module_kwargs):
        super().__init__(typename, *module_args, **module_kwargs)
        if "." in str(key):
            raise ValueError(f"tied key {key!r} may not contain '.'")
        self.key = key
        self.forward_fn = forward_fn
        self.tied_weight_attr = tied_weight_attr


def _takes_device(typename):
    try:
        params = inspect.signature(typename).parameters
    except (TypeError, ValueError):
        return False
    return "device" in params or any(
        p.kind == p.VAR_KEYWORD for p in params.values())


class _Lambda(nn.Module):
    """A plain callable as a layer without parameters."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


class PipelineModule:
    """Layer-list model for pipeline execution (reference ``:86``)."""

    def __init__(self, layers, num_stages=None, topology=None,
                 loss_fn=None, seed_layers=False, base_seed=1234,
                 partition_method="parameters",
                 activation_checkpoint_interval=0):
        self.specs = []
        for layer in layers:
            if isinstance(layer, LayerSpec):
                self.specs.append(layer)
            elif isinstance(layer, nn.Module):
                self.specs.append(LayerSpec(lambda m=layer: m))
            elif callable(layer) and not isinstance(layer, type):
                self.specs.append(LayerSpec(lambda f=layer: _Lambda(f)))
            else:
                self.specs.append(LayerSpec(layer))
        self.loss_fn = loss_fn
        self.seed_layers = seed_layers
        self.base_seed = base_seed
        self.partition_method = partition_method
        self.activation_checkpoint_interval = activation_checkpoint_interval
        self.num_stages = num_stages
        self.topology = topology
        # stage boundaries of partition_layers
        self.parts = None

    def __len__(self):
        return len(self.specs)

    # --------------------------------------------------------------- partition
    def _count_layer_params(self):
        """Parameter counts per layer (method "parameters"): a layer's
        ``param_shapes()`` where it has one, else its parameters' numel,
        built on the meta device (no storage)."""
        counts = []
        for spec in self.specs:
            layer = spec.build(device="meta")
            if hasattr(layer, "param_shapes"):
                n = sum(int(np.prod(s)) for s in layer.param_shapes())
            elif isinstance(layer, nn.Module):
                n = sum(p.numel() for p in layer.parameters())
            else:
                n = 1
            counts.append(max(1, n))
        return counts

    def _profile_layer_latencies(self, example_input, iters=3):
        """Per-layer forward latency (method "profile"): each layer built on
        the example input's device and timed on the output of the layer
        before it.  A layer that cannot be timed leaves every later shape
        unknown, so the whole profile falls back to parameter counts."""
        x = torch.as_tensor(example_input)
        sync = (torch.cuda.synchronize if x.device.type == "cuda"
                else (lambda: None))
        lats = []
        with torch.no_grad():
            for spec in self.specs:
                try:
                    layer = spec.build(device=x.device)
                    y = layer(x)            # warm-up
                    sync()
                    t0 = time.perf_counter()
                    for _ in range(iters):
                        y = layer(x)
                    sync()
                    lats.append(max((time.perf_counter() - t0) / iters,
                                    1e-7))
                    x = y
                except Exception as e:  # any layer failure: fall back
                    logger.warning(
                        f"profile partition: layer {spec.name} not timeable "
                        f"({type(e).__name__}: {e}); falling back to "
                        "parameter-count weights")
                    return self._count_layer_params()
        lo = min(lats)
        return [max(1, round(v / lo * 100)) for v in lats]

    def partition_layers(self, num_stages, method=None, example_input=None):
        """Reference ``_partition_layers`` ``:391``: stage boundaries
        ``parts`` (num_stages + 1 of them).  ``method="profile"`` needs
        ``example_input``, a sample input of the first layer."""
        method = (method or self.partition_method).lower()
        num_layers = len(self.specs)
        if method == "uniform":
            self.parts = partition_uniform(num_layers, num_stages)
        elif method == "parameters":
            self.parts = partition_balanced(self._count_layer_params(),
                                            num_stages)
        elif method == "profile":
            if example_input is None:
                raise ValueError(
                    "partition_method='profile' needs example_input= "
                    "(a sample input for the first layer)")
            self.parts = partition_balanced(
                self._profile_layer_latencies(example_input), num_stages)
        elif method.startswith("type:"):
            pattern = method.split(":", 1)[1]
            binary = [1 if re.search(pattern, s.name, re.IGNORECASE) else 0
                      for s in self.specs]
            self.parts = partition_balanced([b or 1 for b in binary],
                                            num_stages)
        else:
            raise NotImplementedError(f"partition method {method!r}")
        self.num_stages = num_stages
        logger.debug(f"pipeline partition ({method}): {self.parts}")
        return self.parts

    def stage_layers(self, stage_id):
        assert self.parts is not None, "call partition_layers first"
        return self.specs[self.parts[stage_id]:self.parts[stage_id + 1]]

    def stage_owner(self, layer_idx):
        for s in range(self.num_stages):
            if self.parts[s] <= layer_idx < self.parts[s + 1]:
                return s
        raise ValueError(layer_idx)

    def tied_groups(self):
        """Reference ``_index_tied_modules`` ``:468``: key → the indices of
        its layers (keys used more than once)."""
        groups = {}
        for i, spec in enumerate(self.specs):
            if isinstance(spec, TiedLayerSpec):
                groups.setdefault(spec.key, []).append(i)
        return {k: v for k, v in groups.items() if len(v) > 1}

    # ------------------------------------------------------ the engine's split
    def regions(self):
        """(pre, blocks, post) layer-index ranges, as the JAX engine splits
        the list (``pipe/engine.py:123 _analyze_layers``): the blocks are
        the longest run of specs with one signature that are not tied; the
        layers before it run on the first stage, those after it on the
        last."""
        sig = [(s.typename, s.module_args,
                tuple(sorted(s.module_kwargs.items()))) for s in self.specs]
        eligible = [not isinstance(s, TiedLayerSpec) for s in self.specs]
        best_start, best_len = 0, 0
        i = 0
        while i < len(sig):
            j = i
            while j < len(sig) and sig[j] == sig[i] and \
                    eligible[j] == eligible[i]:
                j += 1
            if eligible[i] and j - i > best_len:
                best_start, best_len = i, j - i
            i = j
        if best_len < 1:
            raise ValueError("PipelineModule needs at least one layer")
        n = len(self.specs)
        return (range(0, best_start), range(best_start, best_start + best_len),
                range(best_start + best_len, n))

    def stage_map(self, num_stages):
        """{stage: [layer indices]}: the first stage runs the pre layers,
        the blocks split by ``partition_uniform`` (JAX's stage geometry,
        without its pad slots), the last stage the post layers."""
        pre, blocks, post = self.regions()
        parts = partition_uniform(len(blocks), num_stages)
        out = {}
        for s in range(num_stages):
            own = [blocks[k] for k in range(parts[s], parts[s + 1])]
            if s == 0:
                own = list(pre) + own
            if s == num_stages - 1:
                own = own + list(post)
            out[s] = own
        return out

    def tie_owners(self, num_stages):
        """{key: sorted stages holding an occurrence} of each tied key."""
        owners = {}
        for s, layers in self.stage_map(num_stages).items():
            for i in layers:
                spec = self.specs[i]
                if isinstance(spec, TiedLayerSpec):
                    owners.setdefault(spec.key, set()).add(s)
        return {k: sorted(v) for k, v in owners.items()}

    def build_stage(self, stage, num_stages, device=None):
        """The :class:`PipeStage` of ``stage``, its layers built on
        ``device`` (e.g. "meta": no storage until the engine installs
        weights)."""
        return PipeStage(self, self.stage_map(num_stages)[stage],
                         last=stage == num_stages - 1, device=device)

    def to_module(self, device=None):
        """The whole model as one ``nn.Module`` (the stage of a one-stage
        pipeline): ``forward(x, labels)`` gives ``loss_fn(out, labels)``.
        The base engine trains it (JAX: ``_build_apply``)."""
        return self.build_stage(0, 1, device)


class _Blocks(nn.ModuleDict):
    """A stage's blocks, keyed by each block's index in the model; ZeRO 3
    and bucketed ZeRO 2 make each of them a unit
    (``runtime/zero/overlap.py:block_modules``)."""

    zero_block_container = True


class PipeStage(nn.Module):
    """One stage's layers.  ``forward(x)`` runs them; on the last stage,
    ``forward(x, labels)`` gives the loss.  Blocks run under activation
    checkpointing in runs of ``activation_checkpoint_interval``."""

    def __init__(self, pipe, layer_ids, last, device=None):
        super().__init__()
        self.last = last
        self.pipe = pipe        # not a module: its layers are not registered
        self.loss_fn = pipe.loss_fn
        self.interval = int(pipe.activation_checkpoint_interval or 0)
        pre, blocks, post = pipe.regions()
        self.pre = nn.ModuleDict()
        self.blocks = _Blocks()
        self.post = nn.ModuleDict()
        self.tied = nn.ModuleDict()
        self._seeds = {}    # module path → the layer index that seeds it
        # (region, key in it or None for a tied layer, tied key, spec)
        self._calls = []
        for i in layer_ids:
            spec = pipe.specs[i]
            region = ("pre" if i in pre else
                      "blocks" if i in blocks else "post")
            if isinstance(spec, TiedLayerSpec):
                if spec.key not in self.tied:
                    self.tied[spec.key] = spec.build(device)
                    self._seeds[f"tied.{spec.key}"] = min(
                        pipe.tied_groups().get(spec.key, [i]))
                self._calls.append((region, None, spec.key, spec))
                continue
            # JAX's names: layer_i within pre and post, blocks by index
            key = str(i if region == "blocks" else
                      i - (pre.start if region == "pre" else post.start))
            getattr(self, region)[key] = spec.build(device)
            self._seeds[f"{region}.{key}"] = i
            self._calls.append((region, key, None, spec))

    def _run(self, call, x):
        region, key, tied, spec = call
        module = self.tied[tied] if tied is not None else \
            getattr(self, region)[key]
        fwd = getattr(spec, "forward_fn", None)
        return fwd(module, x) if fwd is not None else module(x)

    def forward(self, x, labels=None):
        block_run = []

        def flush(x):
            if not block_run:
                return x
            calls = list(block_run)
            block_run.clear()

            def run(x):
                for c in calls:
                    x = self._run(c, x)
                return x
            if torch.is_grad_enabled():
                return checkpoint(run, x, use_reentrant=False)
            return run(x)

        for call in self._calls:
            if self.interval > 0 and call[0] == "blocks":
                block_run.append(call)
                if len(block_run) == self.interval:
                    x = flush(x)
                continue
            x = flush(x)
            x = self._run(call, x)
        x = flush(x)
        if labels is None or not self.last or self.loss_fn is None:
            return x
        return self.loss_fn(x, labels)

    @torch.no_grad()
    def init_weights(self, generator, std=0.02):
        """Random weights, each layer from its own generator seeded by the
        engine's seed and the layer's index in the model (a tied module by
        its key's first layer), so that a layer draws the same values
        whatever the stage split: a layer's ``init_weights(generator)``
        where it has one, else normal(0, ``std``) for weights of two or
        more dims, 0 for 1-dim ones."""
        base = generator.initial_seed()
        for path, i in self._seeds.items():
            region, key = path.split(".", 1)
            module = getattr(self, region)[key]
            gen = torch.Generator(device=generator.device).manual_seed(
                base + 1000003 * (i + 1))
            if hasattr(module, "init_weights"):
                module.init_weights(gen)
                continue
            for p in module.parameters():
                if p.dim() >= 2:
                    p.normal_(0.0, std, generator=gen)
                else:
                    p.zero_()
        return self


def tp_leaf_info(name, shape, cfg=None):
    """``(flax path, flax shape, torch dim of each flax dim)`` of a stage's
    leaf (``module_inject/auto_tp.py``; the stage's layers keep flax's
    names and layouts): ``blocks.{i}.…`` is JAX's stacked ``blocks/…``
    leaf, whose leading (pipeline slot) dim is no torch dim; ``pre.{k}``
    and ``post.{k}`` are ``layer_{k}``, ``tied.{key}`` the tied module."""
    parts = name.split(".")
    dims = tuple(range(len(shape)))
    if parts[0] == "blocks":
        return ("blocks", ) + tuple(parts[2:]), (1, ) + tuple(shape), \
            (None, ) + dims
    if parts[0] in ("pre", "post"):
        return (parts[0], f"layer_{parts[1]}") + tuple(parts[2:]), \
            tuple(shape), dims
    return tuple(parts), tuple(shape), dims


# ------------------------------------------------------------ weights across
def _slot_to_layer(n_blocks, num_stages):
    """The JAX engine's padded block slots (``pipe/engine.py:104-116``):
    slot p → block index, or -1 for a pad slot."""
    parts = partition_uniform(n_blocks, num_stages)
    per = max(parts[i + 1] - parts[i] for i in range(num_stages))
    out = []
    for s in range(num_stages):
        for i in range(per):
            out.append(parts[s] + i if parts[s] + i < parts[s + 1] else -1)
    return out


def _flat(tree, prefix):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}"
        if isinstance(v, dict):
            out.update(_flat(v, path))
        else:
            out[path] = np.asarray(v, dtype=np.float32)
    return out


def _layer_from_flax(subtree):
    """{name within the layer: array} of one layer's flax subtree: the flax
    path joined by dots (a torch layer names its parameters as the flax
    layer does, in the flax shapes, as ``models/gpt2.py`` does)."""
    return {k[1:]: v for k, v in _flat(subtree, "").items()}


def _layer_to_flax(named):
    tree = {}
    for name, a in named.items():
        node = tree
        *path, leaf = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = a
    return tree


def geometry(pipe):
    """What :func:`params_from_flax` and :func:`params_to_flax` need of a
    ``PipelineModule`` (a checkpoint records it): ``{"pre": [...],
    "post": [...], "blocks": [block layer indices], "layers": {prefix:
    layer index}}``, the pre and post lists holding each layer's prefix in
    :class:`PipeStage`'s names (``tied.{key}`` for a tied layer; its layer
    index is its key's first)."""
    pre, blocks, post = pipe.regions()
    out = {"pre": [], "post": [], "blocks": list(blocks), "layers": {}}
    for region, rng in (("pre", pre), ("post", post)):
        for i, li in enumerate(rng):
            spec = pipe.specs[li]
            tied = isinstance(spec, TiedLayerSpec)
            prefix = f"tied.{spec.key}" if tied else f"{region}.{i}"
            out[region].append(prefix)
            out["layers"].setdefault(prefix, li)
    out["layers"].update({f"blocks.{b}": b for b in blocks})
    return out


def _geometry(pipe):
    return pipe if isinstance(pipe, dict) else geometry(pipe)


def stages_of_block_stack(geo, stacks):
    """The stage count of a JAX tree's padded block stack (a JAX tree
    records none).  ``stacks``: the block stack (``tree["blocks"]``) of
    each field of the tree (fp32, the moments).  Stage counts that give
    the stack's slot count may lay the blocks out differently (10 blocks
    make 12 slots at pp 3, 4 and 6, their pad slots at 7 and 11, 8 and
    11, 9 and 11); of those, the one taken is the only one whose
    pad slots are all inert: zero in some field.  The JAX engine's pad
    slots take no gradient, so their moments stay zero once a real block
    has stepped, and the port's converter writes them zero.  Where no
    layout or more than one is left, the stage count must be recorded in
    the directory's meta."""
    n = len(geo["blocks"])
    leaves = [np.asarray(a) for st in stacks for a in _leaves(st)]
    n_slots = leaves[0].shape[0]
    layouts = {}
    for pp in range(1, n + 1):
        slots = _slot_to_layer(n, pp)
        if len(slots) == n_slots:
            layouts.setdefault(tuple(slots), pp)
    if len(layouts) > 1:
        per_field = [[np.asarray(a) for a in _leaves(st)] for st in stacks]

        def inert(p):
            return any(all(not a[p].any() for a in field)
                       for field in per_field)
        layouts = {k: pp for k, pp in layouts.items()
                   if all(inert(p) for p, b in enumerate(k) if b < 0)}
    if len(layouts) != 1:
        raise ValueError(
            f"the stage count of a block stack of {n_slots} slots for {n} "
            "blocks cannot be read from it: record it as "
            '{"engine_state": {"pipeline": {"num_stages": N}}} in the '
            "universal directory's meta")
    return next(iter(layouts.values()))


def _leaves(tree):
    if isinstance(tree, dict):
        return [a for v in tree.values() for a in _leaves(v)]
    return [tree]


def params_from_flax(tree, pipe, num_stages, dtype=torch.float32):
    """The JAX ``PipelineEngine``'s parameter tree (numpy leaves; its block
    stack laid out for ``num_stages`` stages, with pad slots) → {name:
    tensor} in :class:`PipeStage`'s names over every stage.  The engine of
    each stage takes its own names from it.  ``pipe``: the
    ``PipelineModule`` or its :func:`geometry`."""
    geo = _geometry(pipe)
    out = {}

    def put(prefix, subtree):
        for name, a in _layer_from_flax(subtree).items():
            out[f"{prefix}.{name}"] = torch.from_numpy(
                np.array(a, dtype=np.float32)).to(dtype)

    for region in ("pre", "post"):
        for i, prefix in enumerate(geo[region]):
            if prefix.startswith("tied."):
                put(prefix, tree["tied"][prefix[len("tied."):]])
            else:
                put(prefix, tree[region][f"layer_{i}"])
    blocks = geo["blocks"]
    slots = _slot_to_layer(len(blocks), num_stages)
    for p, b in enumerate(slots):
        if b < 0:
            continue
        put(f"blocks.{blocks[b]}", _index_tree(tree["blocks"], p))
    return out


def _index_tree(tree, p):
    return {k: (_index_tree(v, p) if isinstance(v, dict)
                else np.asarray(v)[p]) for k, v in tree.items()}


def params_to_flax(named, pipe, num_stages):
    """The inverse of :func:`params_from_flax`: {name: tensor or array} of
    every stage (e.g. each stage's fp32 master, by name) → the JAX engine's
    tree for ``num_stages`` stages, pad slots zero."""
    geo = _geometry(pipe)
    arr = {k: (v.detach().float().cpu().numpy()
               if isinstance(v, torch.Tensor) else np.asarray(v, np.float32))
           for k, v in named.items()}

    def take(prefix):
        n = len(prefix) + 1
        return {k[n:]: v for k, v in arr.items() if k.startswith(prefix + ".")}

    tree = {"pre": {}, "post": {}}
    tied = {}
    for region in ("pre", "post"):
        for i, prefix in enumerate(geo[region]):
            if prefix.startswith("tied."):
                tied[prefix[len("tied."):]] = _layer_to_flax(take(prefix))
            else:
                tree[region][f"layer_{i}"] = _layer_to_flax(take(prefix))
    blocks = geo["blocks"]
    slots = _slot_to_layer(len(blocks), num_stages)
    per_layer = [_layer_to_flax(take(f"blocks.{b}")) for b in blocks]

    def stack(nodes):
        first = nodes[0]
        if isinstance(first, dict):
            return {k: stack([n[k] for n in nodes]) for k in first}
        return np.stack(nodes)

    zero = lambda node: ({k: zero(v) for k, v in node.items()}  # noqa: E731
                         if isinstance(node, dict) else np.zeros_like(node))
    tree["blocks"] = stack([per_layer[b] if b >= 0 else zero(per_layer[0])
                            for b in slots])
    if tied:
        tree["tied"] = tied
    return tree
