"""Dataflow tensor-parallel parser (the port of
``deepspeed_tpu/module_inject/tp_parser.py``; reference
``module_inject/auto_tp.py:273 tp_parser``).

The JAX parser runs a taint analysis over the model's jaxpr.  The port runs
the same analysis over the model's ATen graph, traced with
``torch.fx.experimental.proxy_tensor.make_fx`` (tracing mode ``"real"``, no
gradient: the plain path; a meta model traces on meta tensors).  The
transfer rules are JAX's (``tp_parser.py:59-230``), read on ATen ops:

* a matmul (``mm``, ``addmm``, ``bmm``, ...) of an activation with a value
  derived from ONE parameter alone marks that parameter COLUMN and records
  it as the product's last kernel;
* a residual ``add`` merging two differently tainted branches, one of them
  carrying a last kernel, is the all-reduce point: the producer of each
  merged branch becomes ROW and the taint restarts;
* a gather (``embedding``, ``index``) from a parameter marks it EMBED;
* ``sort``/``topk`` turn the column kernels in their operands' taint into
  ROUTER (gating stays replicated);
* the grouped expert product (B7's ``gmm``, which the parser sees as one
  op, ``ds_tp_parser::grouped_matmul``) gives EXPERT_COLUMN, or
  EXPERT_ROW when its input already carries an expert kernel;
* the elementwise, shape and reduction ops of JAX's pass list keep the last
  kernel, every other op drops it.

Classes are reported by the leaves' flax paths (each model module's
``tp_leaf_info``, else its ``params_to_flax``), so they compare with JAX's
directly, and :func:`derive_tp_rules_from_dataflow` returns the JAX
package's rule table for them.
"""

import operator
from contextlib import contextmanager
from typing import Dict, NamedTuple, Optional

from ..utils.logging import logger
from .auto_tp import Spec, path_str


class _State(NamedTuple):
    """Dataflow fact for one graph value."""
    taint: frozenset            # kernel ids since the last residual merge
    last_kernel: Optional[int]  # id of the matmul kernel that produced it
    param: Optional[int]        # id if the value is a pure transform of ONE
    #                             parameter


_EMPTY = _State(frozenset(), None, None)

_DOT = {"mm", "bmm", "matmul", "dot", "mv", "linear"}
_ADDMM = {"addmm", "baddbmm", "addmv"}
# JAX's _ELEMENTWISE_PASS in ATen names: shape, cast, elementwise and
# reduction ops keep a value's last kernel
_ELEMENTWISE_PASS = {
    "_to_copy", "to", "clone", "contiguous", "view", "_unsafe_view",
    "reshape", "t", "transpose", "permute", "expand", "unsqueeze", "squeeze",
    "slice", "select", "narrow", "split", "split_with_sizes", "chunk",
    "unbind", "cat", "stack", "flatten", "alias", "detach", "lift_fresh",
    "lift_fresh_copy", "exp", "log", "tanh", "sigmoid", "rsqrt", "sqrt",
    "neg", "sign", "abs", "maximum", "minimum", "clamp", "clamp_min",
    "clamp_max", "pow", "erf", "amax", "amin", "max", "min", "sum", "mean",
    "div", "sub", "rsub", "where", "masked_fill", "copy", "copy_", "cumsum",
    "logsumexp", "gelu", "silu", "relu", "_softmax", "softmax",
    "_log_softmax", "log_softmax", "iota", "arange", "eq", "ne", "lt", "le",
    "gt", "ge", "logical_and", "logical_or", "logical_not", "argmax",
    "argmin", "all", "any", "fill", "scalar_tensor", "_to_dtype", "square",
    "reciprocal", "exp2", "var", "var_mean", "native_layer_norm",
    "getitem", "repeat_interleave", "repeat", "index_select", "gather",
    "embedding", "index", "zeros_like", "ones_like", "full_like",
    "empty_like",
}

_GROUPED = None


def _grouped_op():
    """``ds_tp_parser::grouped_matmul(x, w, group_sizes)``: B7's product as
    one op of the graph (its plain version; shapes only on meta)."""
    global _GROUPED
    if _GROUPED is None:
        import torch
        from ..ops.kernels.grouped_matmul import gmm_plain
        lib = torch.library.Library("ds_tp_parser", "DEF")
        lib.define("grouped_matmul(Tensor x, Tensor w, Tensor group_sizes) "
                   "-> Tensor")
        lib.impl("grouped_matmul", lambda x, w, g: gmm_plain(x, w, g),
                 "CPU")

        def meta(x, w, g):
            return x.new_empty((x.shape[0], w.shape[2]))

        lib.impl("grouped_matmul", meta, "Meta")
        _GROUPED = (lib, torch.ops.ds_tp_parser.grouped_matmul.default)
    return _GROUPED[1]


@contextmanager
def _traceable_grouped_matmul():
    """The models' grouped matmul swapped for the graph op while tracing."""
    from ..models import mixtral
    op = _grouped_op()
    saved = mixtral.gmm, mixtral.gmm_plain
    mixtral.gmm = mixtral.gmm_plain = op
    try:
        yield
    finally:
        mixtral.gmm, mixtral.gmm_plain = saved


def flax_paths(model):
    """{port leaf name: flax path string} of a port model: its module's
    ``tp_leaf_info``, else one ``params_to_flax`` call a leaf."""
    import sys
    import numpy as np
    mod = sys.modules.get(type(model).__module__)
    info = getattr(mod, "tp_leaf_info", None)
    out = {}
    for name, p in model.named_parameters():
        if info is not None:
            got = info(name, tuple(p.shape), model.config)
            if got is not None:
                out[name] = path_str(got[0])
            continue
        tree = mod.params_to_flax({name: np.broadcast_to(
            np.float32(0), tuple(p.shape))}, model.config)
        path = []
        while isinstance(tree, dict) and tree:
            key = next(iter(tree))
            path.append(key)
            tree = tree[key]
        if path:
            out[name] = path_str(path)
    return out


class TpParser:
    """One-shot parser: ``TpParser().parse(model, *inputs)`` →
    {"column": [flax paths], "row": [...], "embed": [...], "router": [...],
    "expert_column": [...], "expert_row": [...]}."""

    def __init__(self):
        self.kernel_class: Dict[int, str] = {}
        self.param_paths: Dict[int, str] = {}

    def parse(self, model, *inputs):
        import torch
        from torch.func import functional_call
        from torch.fx.experimental.proxy_tensor import make_fx
        named = list(model.named_parameters())
        paths = flax_paths(model)
        names = [n for n, _ in named]
        self.param_paths = {i: paths.get(n, n) for i, n in enumerate(names)}

        def fn(flat, *ins):
            return functional_call(model, dict(zip(names, flat)), ins)

        with torch.no_grad(), _traceable_grouped_matmul():
            gm = make_fx(fn, tracing_mode="real")(
                [p.detach() for _, p in named], *inputs)
        self._walk(gm.graph, len(named))
        out = {"column": [], "row": [], "embed": [], "router": [],
               "expert_column": [], "expert_row": []}
        for pid, cls in self.kernel_class.items():
            out[cls].append(self.param_paths[pid])
        return out

    # ------------------------------------------------------------ plumbing
    def _walk(self, graph, n_params):
        env = {}
        k = 0
        for node in graph.nodes:
            if node.op == "placeholder":
                env[node] = (_State(frozenset(), None, k) if k < n_params
                             else _EMPTY)
                k += 1
                continue
            if node.op != "call_function":
                continue
            states = self._states(node, env)
            if node.target is operator.getitem:
                env[node] = env.get(node.args[0], _EMPTY)
                continue
            name = self._name(node.target)
            if name == "grouped_matmul":
                out = self._ragged_dot(states[:2])
            elif name in _DOT:
                out = self._dot(states[:2])
                if name == "linear" and len(states) > 2:
                    out = self._add([out, states[2]])
            elif name in _ADDMM:
                out = self._add([states[0], self._dot(states[1:3])])
            elif name in ("add", "add_") and len(states) == 2:
                out = self._add(states)
            elif name in ("mul", "mul_") and len(states) == 2:
                out = self._mul(states)
            elif name == "embedding":
                # aten.embedding(weight, indices)
                out = self._gather(states)
            elif name in ("index", "index_select", "gather") and states:
                out = self._gather(states)
            elif name in ("sort", "topk", "argsort"):
                for s in states:
                    for kid in s.taint:
                        if self.kernel_class.get(kid) == "column":
                            self.kernel_class[kid] = "router"
                out = self._passthrough(states, keep_last=False)
            else:
                out = self._passthrough(states,
                                        keep_last=name in _ELEMENTWISE_PASS)
            env[node] = out

    @staticmethod
    def _name(target):
        packet = getattr(target, "overloadpacket", None)
        if packet is not None:
            return packet.__name__.split(".")[-1]
        return getattr(target, "__name__", str(target))

    @staticmethod
    def _states(node, env):
        """The states of the node's tensor operands, in argument order
        (lists flattened; scalars left out)."""
        import torch
        out = []

        def take(a):
            if isinstance(a, torch.fx.Node):
                out.append(env.get(a, _EMPTY))
            return a

        torch.fx.node.map_arg((node.args, node.kwargs), take)
        return out

    # ------------------------------------------------------------ transfer
    def _passthrough(self, states, keep_last=True):
        taint = frozenset().union(*[s.taint for s in states]) \
            if states else frozenset()
        params = {s.param for s in states if s.param is not None}
        lasts = {s.last_kernel for s in states if s.last_kernel is not None}
        param = params.pop() if len(params) == 1 and not taint else None
        last = lasts.pop() if keep_last and len(lasts) == 1 else None
        return _State(taint, last, param)

    def _dot(self, states):
        if len(states) < 2:
            return self._passthrough(states)
        a, b = states[0], states[1]
        if b.param is not None and a.param is None:
            act, kernel = a, b.param
        elif a.param is not None and b.param is None:
            act, kernel = b, a.param
        else:
            return _State(a.taint | b.taint, None, None)
        self.kernel_class.setdefault(kernel, "column")
        return _State(act.taint | {kernel}, kernel, None)

    def _ragged_dot(self, states):
        a, b = states[0], states[1]
        if b.param is not None:
            act, kernel = a, b.param
        elif a.param is not None:
            act, kernel = b, a.param
        else:
            return _State(a.taint | b.taint, None, None)
        expert = {k for k in act.taint
                  if self.kernel_class.get(k, "").startswith("expert")}
        cls = "expert_row" if expert else "expert_column"
        self.kernel_class.setdefault(kernel, cls)
        return _State(act.taint | {kernel}, kernel, None)

    def _add(self, states):
        a, b = states[0], states[1]
        if a.param is not None and not a.taint:
            return b
        if b.param is not None and not b.taint:
            return a
        if a.taint != b.taint and (a.last_kernel is not None
                                   or b.last_kernel is not None):
            for s in (a, b):
                if s.last_kernel is not None:
                    self.kernel_class[s.last_kernel] = "row"
            return _EMPTY
        return self._passthrough(states)

    def _mul(self, states):
        a, b = states[0], states[1]
        if a.param is not None and not a.taint:
            return b
        if b.param is not None and not b.taint:
            return a
        return _State(a.taint | b.taint, None, None)

    def _gather(self, states):
        src = states[0]
        if src.param is not None:
            self.kernel_class.setdefault(src.param, "embed")
            return _EMPTY
        return self._passthrough(states)


def derive_tp_rules_from_dataflow(model, *inputs, tp_axis="tp",
                                  with_zero_pin=False):
    """Rule table (flax path suffix → :class:`Spec`) from the dataflow
    classification (JAX ``tp_parser.py:233``).  ``with_zero_pin`` adds the
    JAX package's ``zero`` placeholder as its hand-written rules do; the
    port's ZeRO slices flat buffers, so it is off by default."""
    import sys
    classes = TpParser().parse(model, *inputs)
    mod = sys.modules.get(type(model).__module__)
    info = getattr(mod, "tp_leaf_info", None)
    paths = flax_paths(model)
    shapes = {}
    for name, p in model.named_parameters():
        if name not in paths:
            continue
        if info is not None:
            shapes[paths[name]] = tuple(info(name, tuple(p.shape),
                                             model.config)[1])
        else:
            shapes[paths[name]] = _flax_shape(mod, name, p, model.config)
    z = ("zero", ) if with_zero_pin else ()
    rules = {}

    def spec_for(path, cls):
        nd = len(shapes[path])
        if cls == "embed":
            return Spec((tp_axis, ) + z if z else tp_axis,
                        *([None] * (nd - 1)))
        if cls == "router":
            return Spec(*([None] * nd))
        if cls == "expert_column":
            return Spec("ep", None, (tp_axis, ) + z if z else tp_axis)
        if cls == "expert_row":
            return Spec("ep", (tp_axis, ) + z if z else tp_axis, None)
        if cls == "column":
            if nd == 3:
                return Spec(None, tp_axis, *z) if z else Spec(None, tp_axis,
                                                             None)
            return Spec(*([None] * (nd - 1)),
                        (tp_axis, ) + z if z else tp_axis)
        rest = z + (None, ) * max(nd - 1 - len(z), 0)
        return Spec(tp_axis, *rest)

    for cls in ("embed", "column", "row", "router", "expert_column",
                "expert_row"):
        for path in classes[cls]:
            parts = path.split("/")
            suffix = "/".join(parts[-2:]) if len(parts) >= 2 else path
            spec = spec_for(path, cls)
            prev = rules.get(suffix)
            if prev is not None and prev != spec:
                logger.warning("tp_parser: conflicting specs for %s (%s vs "
                               "%s) — keeping first", suffix, prev, spec)
                continue
            rules[suffix] = spec

    def _strip_zero(ax):
        names = tuple(a for a in (ax if isinstance(ax, tuple) else (ax, ))
                      if a not in (None, "zero"))
        return names if len(names) > 1 else (names[0] if names else None)

    for path, shape in shapes.items():
        if path.endswith("/bias"):
            suffix = "/".join(path.split("/")[-2:])
            kspec = rules.get(suffix[:-5] + "/kernel")
            if kspec and len(shape) + 1 == len(tuple(kspec)):
                rules[suffix[:-5] + "/bias"] = Spec(
                    *[_strip_zero(a) for a in tuple(kspec)[1:]])
    return rules


def _flax_shape(mod, name, p, cfg):
    import numpy as np
    tree = mod.params_to_flax({name: np.broadcast_to(
        np.float32(0), tuple(p.shape))}, cfg)
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tuple(np.shape(tree))
