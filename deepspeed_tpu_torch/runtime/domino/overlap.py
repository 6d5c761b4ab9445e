"""Tensor-parallel overlap, read from a trace (the port of
``deepspeed_tpu/runtime/domino/overlap.py``).

JAX's ``measure_tp_overlap`` compiles a function and walks the optimized
HLO schedule.  Eager PyTorch has no schedule to read: the port runs the
function once under ``torch.profiler`` and walks the trace.  Its report
keeps JAX's keys:

* ``collectives``: the c10d collectives the call ran (NCCL's on the
  card, gloo's on the CPU);
* ``async_pairs``: those started async and waited for later
  (``comm/functional.py``'s :data:`ASYNC_START` / :data:`ASYNC_WAIT`
  ranges, paired in start order);
* ``overlapped_pairs``: async pairs with at least one compute op (a
  product, an attention kernel's launch) called between the start and the
  wait, i.e. work the current stream was given while the collective was
  in flight on its own;

with ``backend`` (``"nccl"``, ``"gloo"`` or ``"none"``) and
``overlapped`` as JAX adds them.  On the card the report also has
``device_overlapped``: how many of the trace's NCCL kernels ran while
another kernel ran on the device, ``span_ms`` / ``device_busy_ms``:
the call's span and the time some kernel ran in it (their ratio the
device's busy share), and the summed kernel time of NCCL's kernels and of
the others (None where the trace holds no device events).
"""

import re

import torch

from ...comm.functional import ASYNC_START, ASYNC_WAIT

_COLLECTIVE_RE = re.compile(
    r"^c10d::(allreduce|_?allgather|_?reduce_scatter|alltoall|broadcast)")
_COMPUTE_RE = re.compile(
    r"^(aten::(mm|addmm|bmm|baddbmm|matmul|linear|einsum|"
    r"_scaled_dot_product\w*|_flash\w*)|deepspeed_tpu_torch::\w+)$")


def _span(e):
    return e.time_range.start, e.time_range.end


def analyze_trace_overlap(events):
    """The report of one trace's events (``prof.events()``: objects with
    ``name``, ``time_range`` and ``device_type``)."""
    host = [e for e in events
            if getattr(e, "device_type", None) !=
            torch.autograd.DeviceType.CUDA]
    host.sort(key=lambda e: e.time_range.start)
    collectives = sum(1 for e in host if _COLLECTIVE_RE.match(e.name))
    starts, waits = [], []
    for e in host:
        if e.name == ASYNC_START:
            starts.append(_span(e))
        elif e.name == ASYNC_WAIT:
            waits.append(_span(e))
    compute = [e.time_range.start for e in host
               if _COMPUTE_RE.match(e.name)]
    pairs = list(zip(starts, waits))
    overlapped = sum(1 for (_, i_end), (w_start, _) in pairs
                     if any(i_end <= t < w_start for t in compute))
    report = {"collectives": collectives, "async_pairs": len(pairs),
              "overlapped_pairs": overlapped,
              "device_overlapped": _device_overlap(events)}
    report.update(_device_busy(events, host))
    return report


def _device_kernels(events):
    return [e for e in events if getattr(e, "device_type", None) ==
            torch.autograd.DeviceType.CUDA]


def _device_overlap(events):
    dev = _device_kernels(events)
    if not dev:
        return None
    nccl = [_span(e) for e in dev if "nccl" in e.name.lower()]
    other = [_span(e) for e in dev if "nccl" not in e.name.lower()]
    return sum(1 for s, t in nccl
               if any(a < t and b > s for a, b in other))


def _device_busy(events, host):
    """``span_ms`` (the trace's first host op to its last device kernel)
    and ``device_busy_ms`` (the union of the kernels' intervals): their
    ratio is the device's busy share over the call; ``nccl_kernel_ms``
    and ``other_kernel_ms``: the summed durations of the NCCL kernels and
    of the rest.  None without device events."""
    kernels = _device_kernels(events)
    spans = sorted(_span(e) for e in kernels)
    if not spans or not host:
        return {"span_ms": None, "device_busy_ms": None,
                "nccl_kernel_ms": None, "other_kernel_ms": None}
    nccl = sum(b - a for a, b in (_span(e) for e in kernels
                                  if "nccl" in e.name.lower()))
    total = sum(b - a for a, b in spans)
    busy, at = 0.0, spans[0][0]
    for a, b in spans:
        a = max(a, at)
        if b > a:
            busy += b - a
            at = b
    start = min(host[0].time_range.start, spans[0][0])
    end = max(max(b for _, b in spans), host[-1].time_range.end)
    return {"span_ms": (end - start) / 1e3, "device_busy_ms": busy / 1e3,
            "nccl_kernel_ms": nccl / 1e3,
            "other_kernel_ms": (total - nccl) / 1e3}


def _backend(inputs):
    import torch.distributed as tdist
    if not tdist.is_available() or not tdist.is_initialized():
        return "none"
    return str(tdist.get_backend())


def measure_tp_overlap(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` once under ``torch.profiler`` (the
    forward; a loss that needs a gradient also runs its backward) and
    report its collective-overlap structure (module docstring)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    cuda = any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        out = fn(*args, **kwargs)
        loss = out[0] if isinstance(out, (tuple, list)) else out
        if isinstance(loss, torch.Tensor) and loss.requires_grad:
            loss.backward()
        if cuda:
            torch.cuda.synchronize()
    report = analyze_trace_overlap(prof.events())
    report["backend"] = _backend(args)
    report["overlapped"] = (report["async_pairs"] > 0
                            and report["overlapped_pairs"] > 0)
    return report


def DominoTransformerLayer(block_cls, *args, **kwargs):
    """JAX's alias, kept for reference-shaped code: the block itself.  The
    port's overlapped schedule is :func:`~.transformer.domino_layer`, which
    runs such a block over µ-streams."""
    return block_cls(*args, **kwargs)
