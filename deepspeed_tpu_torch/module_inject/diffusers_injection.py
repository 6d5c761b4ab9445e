"""Diffusers/CLIP attention injection (the port of ``deepspeed_tpu/
module_inject/diffusers_injection.py``; reference ``generic_injection``,
``module_inject/replace_module.py:88``).

The JAX package intercepts Flax modules by class name and submodule
layout and runs their q/k/v/out projections through the module's own
Dense layers and the attention through ``ops.attention_core``.  The port
does the same to ``torch.nn.Module``s: for the length of
:func:`fused_attention` the ``forward`` of every matching module (the
instances under ``module``, or, without one, every loaded class of a
matching name) is swapped for the interceptor, and restored at exit.  The
attention is ``ops/attention.py:attention_core``, kernel B1 on the card.

Matched by class name and layout (:data:`DEFAULT_POLICIES`); neither
transformers nor diffusers is imported:

* ``CLIPAttention`` (transformers' CLIP text and vision encoders:
  ``q_proj``, ``k_proj``, ``v_proj``, ``out_proj``, ``num_heads``,
  ``scale``), causal when its ``causal_attention_mask`` argument is the
  standard causal mask;
* ``Attention`` / ``CrossAttention`` (diffusers' UNet and VAE attention:
  ``to_q``, ``to_k``, ``to_v``, ``to_out``, ``heads``, ``scale``).

The module's own code runs instead (JAX's fallback cases) for
cross-attention (``encoder_hidden_states``, ``context`` or
``key_value_states``, by keyword or in the context's position),
``output_attentions``, a padding mask that is not a no-op (unless
``assume_full_mask``), a causal mask that is not the standard one,
attention dropout in training, and the diffusers features the fused path
does not compute (a group or spatial norm, q/k norms, a residual
connection, an output rescale, a 4-d input).  The cases are decided from
the call's arguments and the module's attributes *before* the fused path;
JAX's catch-all ``except`` around the fused call is not carried over, so
a kernel that fails to build or launch raises.  Fused and fallback calls
are counted apart in the caller's ``counter``.
"""

import contextlib
import weakref

import torch
from torch import nn

from ..ops.attention import attention_core

# class name → the attention's layout.  ``params``: the forward's
# positional parameter names; ``cross``: the one that carries another
# sequence's keys and values; ``out``: a Linear, or a list of modules
# applied in turn (diffusers' [Linear, Dropout])
DEFAULT_POLICIES = {
    "CLIPAttention": dict(
        q="q_proj", k="k_proj", v="v_proj", out="out_proj",
        heads=("num_heads", "heads"), scale=("scale", ), returns_tuple=True,
        params=("hidden_states", "attention_mask", "causal_attention_mask",
                "output_attentions"), cross=None),
    "Attention": dict(
        q="to_q", k="to_k", v="to_v", out="to_out", heads=("heads", ),
        scale=("scale", ), returns_tuple=False,
        params=("hidden_states", "encoder_hidden_states", "attention_mask"),
        cross="encoder_hidden_states"),
}
DEFAULT_POLICIES["CrossAttention"] = DEFAULT_POLICIES["Attention"]

# any of these being set means cross-attention: the module's own code
_CROSS_KWARGS = ("context", "encoder_hidden_states", "key_value_states")
# diffusers features the fused path does not compute: (attribute, the
# value that means "off")
_DIFFUSERS_OFF = (("group_norm", None), ("spatial_norm", None),
                  ("norm_q", None), ("norm_k", None), ("norm_cross", None),
                  ("residual_connection", False),
                  ("rescale_output_factor", 1.0))

def _first_attr(mod, names):
    for n in names:
        v = getattr(mod, n, None)
        if v is not None:
            return v
    return None


def _layout_matches(mod, pol):
    return all(isinstance(getattr(mod, pol[k], None), nn.Module)
               for k in ("q", "k", "v", "out")) and \
        _first_attr(mod, pol["heads"]) is not None


def _mask_is_noop(mask):
    """Whether a padding mask changes nothing: all True (bool), all zeros
    (an additive float mask, as transformers and diffusers pass it), or
    all ones (an int 0/1 mask, as the JAX package's callers pass it)."""
    if mask.dtype == torch.bool:
        return bool(mask.all())
    if mask.is_floating_point():
        return bool((mask == 0).all())
    return bool((mask == 1).all())


def _is_standard_causal(mask, S):
    """Whether an additive ``[.., S, S]`` mask is the causal one: zeros on
    and below the diagonal, the dtype's minimum (or -inf) above it."""
    if mask.shape[-2:] != (S, S) or not mask.is_floating_point():
        return False
    m = mask.reshape(-1, S, S)
    below = torch.ones(S, S, dtype=torch.bool, device=mask.device).tril()
    low = torch.finfo(mask.dtype).min
    return bool((m[:, below] == 0).all()) and \
        bool((m[:, ~below] <= low).all())


def _bind(pol, args, kwargs):
    bound = dict(zip(pol["params"], args))
    bound.update(kwargs)
    return bound


class _MaskMemo:
    """The checks of a mask tensor, kept while that tensor lives unchanged:
    the encoders hand every layer the same mask, and each check reads it
    back to the host (one device sync)."""

    def __init__(self):
        self._seen = {}

    def __call__(self, check, mask, *args):
        key = (id(mask), check, args)
        hit = self._seen.get(key)
        if hit is not None and hit[0]() is mask and \
                hit[1] == mask._version:
            return hit[2]
        out = check(mask, *args)
        self._seen[key] = (weakref.ref(mask), mask._version, out)
        return out


def _fallback_reason(mod, pol, bound, assume_full_mask, memo):
    """None when the call can take the fused path, else why not."""
    if any(bound.get(k) is not None for k in _CROSS_KWARGS):
        return "cross-attention"
    extra = set(bound) - set(pol["params"]) - {"output_attentions",
                                               "deterministic"}
    if any(bound[k] is not None for k in extra):
        return f"arguments {sorted(extra)}"
    if bound.get("output_attentions"):
        return "output_attentions"
    hidden = bound.get("hidden_states")
    if not isinstance(hidden, torch.Tensor) or hidden.dim() != 3:
        return "input layout"
    mask = bound.get("attention_mask")
    if mask is not None and not assume_full_mask and \
            not memo(_mask_is_noop, mask):
        return "padding mask"
    causal = bound.get("causal_attention_mask")
    if causal is not None and not memo(_is_standard_causal, causal,
                                       hidden.shape[1]):
        return "causal mask"
    rate = getattr(mod, "dropout", 0.0)
    out = getattr(mod, pol["out"])
    if isinstance(out, (nn.ModuleList, nn.Sequential)):
        rate = max([rate if isinstance(rate, (int, float)) else 0.0] +
                   [m.p for m in out if isinstance(m, nn.Dropout)])
    if mod.training and isinstance(rate, (int, float)) and rate > 0:
        return "attention dropout in training"
    if pol["cross"] == "encoder_hidden_states":
        for attr, off in _DIFFUSERS_OFF:
            if getattr(mod, attr, off) != off:
                return attr
    return None


def _apply_out(out, x):
    if isinstance(out, (nn.ModuleList, nn.Sequential)):
        for m in out:
            x = m(x)
        return x
    return out(x)


def _fused_call(mod, pol, bound):
    hidden = bound["hidden_states"]
    B, S, _ = hidden.shape
    heads = int(_first_attr(mod, pol["heads"]))
    q = getattr(mod, pol["q"])(hidden)
    k = getattr(mod, pol["k"])(hidden)
    v = getattr(mod, pol["v"])(hidden)
    Dh = q.shape[-1] // heads
    causal = bound.get("causal_attention_mask") is not None
    out = attention_core(q.reshape(B, S, heads, Dh).contiguous(),
                         k.reshape(B, S, heads, Dh).contiguous(),
                         v.reshape(B, S, heads, Dh).contiguous(),
                         causal=causal,
                         softmax_scale=_first_attr(mod, pol["scale"]))
    out = _apply_out(getattr(mod, pol["out"]), out.reshape(B, S, heads * Dh))
    return (out, None) if pol["returns_tuple"] else out


def _count(counter, fused):
    if counter is None:
        return
    if isinstance(counter, dict):
        key = "fused" if fused else "fallback"
        counter[key] = counter.get(key, 0) + 1
    elif fused:
        counter[0] += 1
    elif len(counter) > 1:
        counter[1] += 1


def make_interceptor(policies=None, counter=None, assume_full_mask=False):
    """``interceptor(module, next_fun, args, kwargs)``: the fused path for
    a module whose class name and layout match ``policies`` (default
    :data:`DEFAULT_POLICIES`) and whose call is none of the fallback cases
    (module docstring), else ``next_fun(*args, **kwargs)``, the module's
    own code.  ``counter``: a list (``[0]`` fused, ``[1]`` fallback, as
    long as it is) or a dict (``"fused"``, ``"fallback"``).
    ``assume_full_mask``: treat any padding mask as a no-op."""
    policies = dict(DEFAULT_POLICIES if policies is None else policies)
    memo = _MaskMemo()

    def interceptor(module, next_fun, args, kwargs):
        pol = policies.get(type(module).__name__)
        if pol is None or not _layout_matches(module, pol):
            return next_fun(*args, **kwargs)
        bound = _bind(pol, args, kwargs)
        if _fallback_reason(module, pol, bound, assume_full_mask, memo):
            _count(counter, False)
            return next_fun(*args, **kwargs)
        out = _fused_call(module, pol, bound)
        _count(counter, True)
        return out

    interceptor.policies = policies
    return interceptor


def _classes(names):
    """Every loaded ``nn.Module`` subclass whose name is in ``names``."""
    seen, out, todo = set(), [], [nn.Module]
    while todo:
        cls = todo.pop()
        for sub in cls.__subclasses__():
            if sub in seen:
                continue
            seen.add(sub)
            todo.append(sub)
            if sub.__name__ in names and "forward" in vars(sub):
                out.append(sub)
    return out


@contextlib.contextmanager
def fused_attention(policies=None, counter=None, assume_full_mask=False,
                    module=None):
    """Inside the context, matching attentions run fused.  ``module``: only
    the matching modules under it (their instance ``forward`` swapped);
    None: every loaded class of a matching name (its ``forward`` swapped).
    Everything is restored at exit, also on an exception."""
    icpt = make_interceptor(policies, counter, assume_full_mask)
    names = set(icpt.policies)
    restore = []
    try:
        if module is not None:
            for mod in module.modules():
                if type(mod).__name__ in names:
                    had = "forward" in vars(mod)
                    orig = mod.forward

                    def fwd(*a, _m=mod, _o=orig, **k):
                        return icpt(_m, _o, a, k)

                    mod.forward = fwd
                    restore.append((mod, had, orig))
        else:
            for cls in _classes(names):
                orig = cls.forward

                def fwd(self, *a, _o=orig, **k):
                    return icpt(self, _o.__get__(self), a, k)

                cls.forward = fwd
                restore.append((cls, True, orig))
        yield icpt
    finally:
        for obj, had, orig in reversed(restore):
            if isinstance(obj, type) or had:
                setattr(obj, "forward", orig)
            else:
                del obj.forward


def generic_injection(module=None, dtype=None, enable_cuda_graph=None,
                      policies=None, assume_full_mask=False):
    """Reference-parity entry (``replace_module.py:88``): the
    :func:`fused_attention` context manager over ``module`` (every loaded
    matching class without one).  ``enable_cuda_graph`` is accepted for
    the signature; ``dtype`` must be a float type."""
    if dtype is not None and dtype not in (torch.float16, torch.bfloat16,
                                           torch.float32, "float16",
                                           "bfloat16", "float32", "fp16",
                                           "bf16", "fp32"):
        raise ValueError(f"unsupported dtype {dtype}")
    return fused_attention(policies, assume_full_mask=assume_full_mask,
                           module=module)
