"""Error-feedback 1-bit compressed all-reduce (the port of
``deepspeed_tpu/runtime/comm/compressed.py``; reference
``runtime/comm/nccl.py:51 compressed_allreduce``, ``compressed.py:13
CompressedBackend`` and the packbits op).

The 1-bit optimizers send the sign of the error-compensated momentum and
one fp32 scale a tensor, 1/32 of a dense fp32 all-reduce's bytes, and keep
the quantization residual to add back next step.  Two stages, as in JAX:

  1. each rank packs its signs (8 a byte) and sends chunk j to rank j
     (``all_to_all_single``); the scales go to everyone (``all_gather``);
     rank j decodes and averages its chunk (the "server"), carrying its
     own server error;
  2. rank j compresses its averaged chunk again and ``all_gather``s it
     with its scale, so every rank ends with the same average.

Here each rank passes its own tensor (JAX passes the stack of every
worker's).  :func:`compressed_allreduce_many` runs several tensors through
one set of four collectives, each tensor with its own scale, padding and
error buffers, so its result is that of :func:`compressed_allreduce` on
each tensor alone.  The packed bytes go over the wire as ``uint8``.

The sums of squares behind the scales accumulate in float64, so a card and
the CPU give the same scale for the same input (the ``all_reduce``-free
parts are then bit-equal across devices); JAX sums in float32.
"""

import numpy as np
import torch

from ... import comm as dist

_SHIFTS = tuple(range(8))


def pack_signs(bits):
    """bool[k·8] → uint8[k] (packbits, little bit order: bit i of byte j is
    ``bits[8j + i]``)."""
    b = bits.reshape(-1, 8).to(torch.uint8)
    pow2 = torch.tensor([1 << i for i in _SHIFTS], dtype=torch.uint8,
                        device=bits.device)
    return (b * pow2).sum(dim=1).to(torch.uint8)


def unpack_signs(packed):
    """uint8[k] → float32[k·8] of ±1."""
    shifts = torch.tensor(_SHIFTS, dtype=torch.uint8, device=packed.device)
    bits = (packed.reshape(-1, 1) >> shifts) & 1
    return (bits.to(torch.float32) * 2.0 - 1.0).reshape(-1)


def error_shapes(numel, n):
    """(worker error size, server error size): ``numel`` padded so each of
    the ``n`` chunks holds a whole number of bytes of signs."""
    chunk = -(-numel // n)
    chunk += (-chunk) % 8
    return chunk * n, chunk


def _scale(x):
    """‖x‖ / √numel in fp32 (the sum of squares in float64).  The divisor
    is a host scalar (fp32's correctly rounded square root): a tensor made
    from it on the card would be a synchronous copy, one a tensor."""
    sq = torch.sum(x.double() * x.double()).float()
    return torch.sqrt(sq) / float(np.sqrt(np.float32(x.numel())))


def compress(x, error):
    """One rank's compression of ``x`` (fp32, ``error``'s length) with its
    residual: ``(corrected, scale, packed signs, new error)``."""
    corrected = x + error
    scale = _scale(corrected)
    signs = corrected >= 0
    pm = signs.to(torch.float32) * 2 - 1
    new_error = corrected - scale * pm
    return corrected, scale, pack_signs(signs), new_error


def _wire_group(group):
    """``group`` (default the world) marked flat: the packed signs must
    not meet an installed collectives engine's quantized wires."""
    g = group if group is not None else dist.get_world_group()
    return g.as_flat()


def compressed_allreduce_many(xs, worker_errors, server_errors, group=None):
    """The 1-bit mean of each tensor of ``xs`` over ``group``'s ranks, with
    error feedback.  ``worker_errors[i]``/``server_errors[i]``: fp32 of
    :func:`error_shapes` ``(xs[i].numel(), n)``.  Returns ``(means, new
    worker errors, new server errors)``; the means have the inputs' shapes
    and dtypes and are the same on every rank.  At one rank the inputs
    come back unchanged."""
    g = _wire_group(group)
    n = g.size()
    if n <= 1:
        return list(xs), list(worker_errors), list(server_errors)
    packed, scales, new_we = [], [], []
    for x, we in zip(xs, worker_errors):
        flat = x.reshape(-1).float()
        flat = torch.nn.functional.pad(flat, (0, we.numel() - flat.numel()))
        _, scale, p, w = compress(flat, we)
        packed.append(p.view(n, -1))
        scales.append(scale.reshape(1))
        new_we.append(w)
    widths = [p.shape[1] for p in packed]
    # stage 1: chunk j of every tensor to rank j, every scale to everyone
    recv = dist.all_to_all_single(torch.cat(packed, dim=1).contiguous(),
                                  group=g)
    all_scales = dist.all_gather(torch.cat(scales), group=g).view(n, -1)
    packed2, scales2, new_se = [], [], []
    col = 0
    for i, (w, se) in enumerate(zip(widths, server_errors)):
        mine = recv[:, col:col + w]
        col += w
        decoded = unpack_signs(mine).view(n, -1) * all_scales[:, i:i + 1]
        total = decoded[0].clone()
        for r in range(1, n):
            total += decoded[r]
        _, s2, p2, e2 = compress(total / n, se)
        packed2.append(p2)
        scales2.append(s2.reshape(1))
        new_se.append(e2)
    # stage 2: every rank's averaged chunks, and their scales
    g_p = dist.all_gather(torch.cat(packed2), group=g).view(n, -1)
    g_s = dist.all_gather(torch.cat(scales2), group=g).view(n, -1)
    out, col = [], 0
    for i, (x, w) in enumerate(zip(xs, widths)):
        full = (unpack_signs(g_p[:, col:col + w]).view(n, -1) *
                g_s[:, i:i + 1]).reshape(-1)
        col += w
        out.append(full[:x.numel()].view(x.shape).to(x.dtype))
    return out, new_we, new_se


def compressed_allreduce(x, worker_error, server_error, group=None):
    """:func:`compressed_allreduce_many` of one tensor: ``(mean, new worker
    error, new server error)``."""
    out, we, se = compressed_allreduce_many([x], [worker_error],
                                            [server_error], group)
    return out[0], we[0], se[0]


def wire_bytes(numels, n):
    """Bytes one rank sends in :func:`compressed_allreduce_many` of tensors
    of ``numels`` elements over ``n`` ranks, counted as a ring sends them:
    its packed chunks for the other n - 1 ranks, then n - 1 hops of each
    all-gather (its averaged chunk, and the fp32 scales twice).  A ring
    all-reduce of the same tensors in fp16 sends 2·(n - 1)/n · 2 bytes an
    element."""
    if n <= 1:
        return 0
    chunk = sum(error_shapes(int(k), n)[1] // 8 for k in numels)
    return 2 * (n - 1) * (chunk + 4 * len(numels))


class CompressedBackend:
    """The counterpart of JAX's ``CompressedBackend`` (reference
    ``runtime/comm/compressed.py:13``) for one rank: it holds the error
    state of each (key, size) and takes this rank's own tensor."""

    def __init__(self, group=None):
        self.group = _wire_group(group)
        self.n = self.group.size()
        self._errors = {}

    def compressed_allreduce(self, x, key=0):
        """The error-compensated mean of every rank's ``x`` (this rank's
        contribution), the same on each."""
        numel = x.numel()
        we_size, se_size = error_shapes(numel, self.n)
        # one residual a (key, size): a tensor of another size must not
        # take another's feedback
        key = (key, numel)
        we, se = self._errors.get(key, (
            torch.zeros(we_size, dtype=torch.float32, device=x.device),
            torch.zeros(se_size, dtype=torch.float32, device=x.device)))
        out, we, se = compressed_allreduce(x, we, se, self.group)
        self._errors[key] = (we, se)
        return out
