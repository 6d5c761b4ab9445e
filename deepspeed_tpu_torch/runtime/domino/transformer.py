"""Domino µ-streams (the port of ``deepspeed_tpu/runtime/domino/
transformer.py``).

:func:`split_microstreams` keeps JAX's contract: every batch-like input
(a tensor whose first dim is the batch) splits into ``n_streams`` parts
and the loss is the mean of the parts' losses, which is the unsplit loss
for a uniform per-row mean, with the unsplit gradients.  A loss that
returns ``(sum, count)`` (``loss_reduction="sum_count"``, the engine's
global-batch loss) sums both over the parts instead, which is exact for
any mask.

Where ``apply_fn`` is a model with ``forward_microstreams`` (the Llama
family, ``models/llama.py``), the parts run interleaved, block by block,
through :func:`domino_layer`; elsewhere they run one after the other.
"""

import time

import torch

from ...comm.functional import (reduce_from_tp_region_async,
                                wait_tp_region)
from ...module_inject.layers import tp_group_of
from .overlap import measure_tp_overlap


def split_batch(x, n_streams, batch):
    """``x`` as ``n_streams`` parts along dim 0 when it is batch-like (a
    tensor of ``batch`` rows), else ``[x] * n_streams``."""
    if isinstance(x, torch.Tensor) and x.dim() > 0 and x.shape[0] == batch:
        return list(torch.chunk(x, n_streams, dim=0))
    return [x] * n_streams


def check_split(batch, n_streams):
    if batch % n_streams != 0:
        raise ValueError(f"domino n_streams={n_streams} must divide the "
                         f"micro batch (got batch {batch})")


def combine_losses(outs):
    """The parts' losses as one: the mean of scalar losses (JAX's
    ``jnp.mean``), or the summed ``(sum, count)`` pairs."""
    if isinstance(outs[0], (tuple, list)):
        return tuple(sum(o[i] for o in outs) for i in range(len(outs[0])))
    return torch.stack([o.float() if o.dtype != torch.float32 else o
                        for o in outs]).mean()


def split_microstreams(apply_fn, n_streams=2, batch_argnum=0):
    """``apply_fn(*inputs, **kw) -> loss`` with every batch-like input
    (positional or keyword) split into ``n_streams`` µ-streams; returns the
    combined loss (:func:`combine_losses`).  ``n_streams < 2``:
    ``apply_fn`` itself."""
    if n_streams < 2:
        return apply_fn
    interleaved = getattr(apply_fn, "forward_microstreams", None)

    def split_apply(*inputs, **kw):
        B = inputs[batch_argnum].shape[0]
        check_split(B, n_streams)
        if interleaved is not None:
            return interleaved(n_streams, *inputs, **kw)
        parts = [split_batch(x, n_streams, B) for x in inputs]
        kparts = {k: split_batch(v, n_streams, B) for k, v in kw.items()}
        return combine_losses([
            apply_fn(*[p[i] for p in parts],
                     **{k: v[i] for k, v in kparts.items()})
            for i in range(n_streams)])

    split_apply.__wrapped__ = apply_fn
    return split_apply


def split_block_microstreams(block_fn, n_streams=2):
    """Activation-level variant: ``block_fn(x, *args) -> y`` runs as
    ``n_streams`` independent calls on the parts of ``x`` (dim 0), whose
    outputs are concatenated.  A Llama-family block (a module with
    ``self_attn.partial`` and ``mlp.partial``) runs through
    :func:`domino_layer`, its reduces overlapped."""
    if n_streams < 2:
        return block_fn

    def split_block(x, *args):
        check_split(x.shape[0], n_streams)
        xs = list(torch.chunk(x, n_streams, dim=0))
        if _splittable(block_fn):
            return torch.cat(domino_layer(block_fn, xs, *args), dim=0)
        return torch.cat([block_fn(p, *args) for p in xs], dim=0)

    return split_block


def _splittable(layer):
    return (hasattr(getattr(layer, "self_attn", None), "partial") and
            hasattr(getattr(layer, "mlp", None), "partial"))


def domino_layer(layer, xs, *args):
    """One pre-norm block over the µ-streams ``xs`` (a list of [b, S, D]),
    the reference ``DominoTransformerLayer``'s schedule: stream i's
    attention reduce is started async and stream i+1's attention runs
    under it; stream i's MLP reduce flies under stream i+1's MLP (and the
    first MLP under the last attention).  Each reduce is waited for where
    its sum enters the residual.  Without a tp group the reduces are
    identities and the streams simply run in turn.  ``args`` go to the
    attention (cos, sin, use_kernel for the Llama family).  A block
    without ``partial`` pieces runs stream by stream."""
    if not _splittable(layer):
        return [layer(x, *args) for x in xs]
    attn, mlp, dt = layer.self_attn, layer.mlp, layer.dtype
    g_attn, g_mlp = tp_group_of(attn.o_proj), tp_group_of(mlp.down_proj)
    pending = [reduce_from_tp_region_async(
        attn.partial(layer.input_layernorm(x, dt), *args), g_attn)
        for x in xs]
    hs, mlps = [], []
    for x, (a, handle) in zip(xs, pending):
        h = x + wait_tp_region(a, handle)
        hs.append(h)
        mlps.append(reduce_from_tp_region_async(
            mlp.partial(layer.post_attention_layernorm(h, dt)), g_mlp))
    return [h + wait_tp_region(m, handle)
            for h, (m, handle) in zip(hs, mlps)]


def domino_ab(apply_fn, *inputs, n_streams=2, time_steps=0, **kw):
    """The plain and µ-stream forms of ``apply_fn(*inputs, **kw)``, each
    traced once by :func:`~.overlap.measure_tp_overlap`, optionally timed
    (``time_steps`` > 0: the mean seconds a call, forward and backward of
    the loss, on the caller's device), and the winner by JAX's rule: the
    plain form when its async collectives are all overlapped already or
    the split one overlaps no more of them, else Domino; measured times
    decide when there are any."""
    split_fn = split_microstreams(apply_fn, n_streams)
    report = {"plain": measure_tp_overlap(apply_fn, *inputs, **kw),
              "domino": measure_tp_overlap(split_fn, *inputs, **kw),
              "n_streams": n_streams}

    def _time(fn):
        def once():
            out = fn(*inputs, **kw)
            loss = out[0] if isinstance(out, (tuple, list)) else out
            if loss.requires_grad:
                loss.backward()
            return loss
        once()
        _sync(inputs)
        t0 = time.perf_counter()
        for _ in range(time_steps):
            once()
        _sync(inputs)
        return (time.perf_counter() - t0) / time_steps

    if time_steps > 0:
        report["plain"]["step_s"] = _time(apply_fn)
        report["domino"]["step_s"] = _time(split_fn)
        report["winner"] = ("plain" if report["plain"]["step_s"]
                            <= report["domino"]["step_s"] else "domino")
    else:
        report["winner"] = decide(report["plain"], report["domino"])
    return report


def decide(plain, domino):
    """JAX ``domino_ab``'s structural rule on two overlap reports."""
    fully_hidden = (plain["async_pairs"] > 0
                    and plain["overlapped_pairs"] >= plain["async_pairs"])
    return ("plain" if fully_hidden or
            domino["overlapped_pairs"] <= plain["overlapped_pairs"]
            else "domino")


def _sync(inputs):
    for x in inputs:
        if isinstance(x, torch.Tensor) and x.is_cuda:
            torch.cuda.synchronize(x.device)
            return
