"""The communication backend on ``torch.distributed`` (the port of
``deepspeed_tpu/comm/backend.py``'s ``MeshBackend``; reference
``comm/torch.py:90`` ``TorchBackend``): NCCL on the card, gloo on the CPU.

The JAX backend is single-controller: a collective takes a *global* array
sharded on dim 0 (or on ``axis``) over the group and returns a global array
(``backend.py:200-260``).  Here there is one process a rank, and rank r
holds block r of that global array.  Every op keeps JAX's result per rank:

* ``all_reduce``: the reduction over the ranks' blocks, on every rank;
* ``all_gather(axis, tiled=True)``: the blocks concatenated along ``axis``
  (stacked on a new dim 0 when ``tiled=False``);
* ``reduce_scatter(axis)``: block r, along ``axis``, of the sum of the
  ranks' full tensors, on rank r;
* ``broadcast(src)``: block ``src`` on every rank;
* ``all_to_all(split_axis, concat_axis)``: each rank's block split along
  ``split_axis``, chunk j sent to rank j, the received chunks concatenated
  along ``concat_axis`` in rank order;
* ``barrier``.

Each returns its result.  Where torch's op works in place (``all_reduce``,
``broadcast``) the input tensor is that result.  ``all_reduce``,
``all_gather_into`` and ``reduce_scatter`` into a given output also take
``async_op=True`` and then return an :class:`AsyncHandle` instead.  The
collectives are ``all_reduce``, ``all_gather_into_tensor``,
``reduce_scatter_tensor``, ``all_to_all_single``, ``broadcast`` and
``barrier``, which torch 2.11 and 2.13 both have.
"""

import torch
import torch.distributed as dist

from .reduce_op import ReduceOp, torch_op


class AsyncHandle:
    """An async collective in flight (``torch.distributed``'s ``Work``, or
    any object with ``wait`` and ``is_completed``, such as a quantized
    gather's).  :meth:`wait` makes the current stream wait for it (on the
    CPU: the caller) and returns its result; a one-rank group's handle is
    complete from the start.  ``on_wait`` callbacks run once, at the first
    wait."""

    def __init__(self, work, result):
        self._work = work
        self.result = result
        self._on_wait = []
        self._waited = False

    def on_wait(self, fn):
        self._on_wait.append(fn)

    def is_completed(self):
        return self._waited or self._work is None or \
            self._work.is_completed()

    def wait(self):
        if not self._waited:
            if self._work is not None:
                self._work.wait()
            self._work = None
            self._waited = True
            for fn in self._on_wait:
                fn()
        return self.result


def _done(result, work, async_op):
    """``result``, or with ``async_op`` its handle."""
    return AsyncHandle(work, result) if async_op else result


class ProcessGroup:
    """A communication group: the mesh axis names it spans and the torch
    process group that carries it (None: the world).  A group over axes
    whose sizes are all 1 (``local``) holds only the calling rank: its
    collectives return their input as a one-rank collective would.  The
    facade never offers a collective over a ``flat`` group to the
    installed collectives engine (the training engine's own groups, whose
    wires its ZeRO plan chooses)."""

    def __init__(self, axis_names, pg=None, local=False, flat=False):
        if isinstance(axis_names, str):
            axis_names = (axis_names, )
        self.axis_names = tuple(axis_names)
        self.pg = pg
        self.local = local
        self.flat = flat

    def as_flat(self):
        """This group, marked ``flat``."""
        return ProcessGroup(self.axis_names, pg=self.pg, local=self.local,
                            flat=True)

    def size(self):
        return 1 if self.local else dist.get_world_size(self.pg)

    def rank(self):
        return 0 if self.local else dist.get_rank(self.pg)

    def __repr__(self):
        return f"ProcessGroup(axes={self.axis_names}, size={self.size()})"


def _contig_front(x, axis):
    """``x`` with ``axis`` moved to dim 0, contiguous (no copy for
    axis 0 of a contiguous tensor)."""
    return x.movedim(axis, 0).contiguous() if axis else x.contiguous()


class TorchBackend:
    """The comm backend: a torch process group world and collectives over
    its groups with the JAX facade's per-rank results."""

    def __init__(self, name):
        self.name = name
        self.world_group = ProcessGroup(("world", ))
        self.initialized = True

    def rank(self):
        return dist.get_rank()

    def world_size(self):
        return dist.get_world_size()

    def _group(self, group):
        return group if group is not None else self.world_group

    def all_reduce(self, x, op=ReduceOp.SUM, group=None, async_op=False):
        g = self._group(group)
        work = None
        if not g.local:
            work = dist.all_reduce(x, op=torch_op(op), group=g.pg,
                                   async_op=async_op)
        return _done(x, work, async_op)

    def all_gather(self, x, group=None, axis=0, tiled=True):
        g = self._group(group)
        n = g.size()
        axis = axis % max(x.dim(), 1)
        if g.local:
            return x if tiled else x.unsqueeze(0)
        xm = _contig_front(x, axis)
        out = torch.empty((n * xm.shape[0], ) + tuple(xm.shape[1:]),
                          dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, xm, group=g.pg)
        if not tiled:
            return out.view((n, ) + tuple(x.shape))
        return out.movedim(0, axis) if axis else out

    def all_gather_into(self, out, x, group=None, async_op=False):
        """Flat all-gather into ``out`` (n × ``x.numel()`` elements); ``x``
        may be ``out``'s own block r, which is then gathered in place."""
        g = self._group(group)
        work = None
        if g.local:
            if out.data_ptr() != x.data_ptr():
                out.copy_(x)
        else:
            work = dist.all_gather_into_tensor(out, x, group=g.pg,
                                               async_op=async_op)
        return _done(out, work, async_op)

    def reduce_scatter(self, x, op=ReduceOp.SUM, group=None, axis=0,
                       out=None, async_op=False):
        g = self._group(group)
        if async_op and out is None:
            raise ValueError("an async reduce_scatter writes into a given "
                             "output")
        n = g.size()
        axis = axis % max(x.dim(), 1)
        if x.shape[axis] % n:
            raise ValueError(f"reduce_scatter: dim {axis} of {tuple(x.shape)}"
                             f" does not divide over {n} ranks")
        if g.local:
            if out is not None:
                out.copy_(x)
                return _done(out, None, async_op)
            return x
        xm = _contig_front(x, axis)
        if out is None:
            out = torch.empty((xm.shape[0] // n, ) + tuple(xm.shape[1:]),
                              dtype=x.dtype, device=x.device)
            dist.reduce_scatter_tensor(out, xm, op=torch_op(op), group=g.pg)
            return out.movedim(0, axis) if axis else out
        work = dist.reduce_scatter_tensor(out, xm, op=torch_op(op),
                                          group=g.pg, async_op=async_op)
        return _done(out, work, async_op)

    def broadcast(self, x, src=0, group=None):
        g = self._group(group)
        if not g.local:
            dist.broadcast(x, src=dist.get_global_rank(g.pg, src)
                           if g.pg is not None else src, group=g.pg)
        return x

    def all_to_all(self, x, group=None, split_axis=0, concat_axis=0):
        g = self._group(group)
        n = g.size()
        if g.local:
            return x
        split_axis %= x.dim()
        concat_axis %= x.dim()
        if x.shape[split_axis] % n:
            raise ValueError(f"all_to_all: dim {split_axis} of "
                             f"{tuple(x.shape)} does not split over {n} "
                             "ranks")
        xm = _contig_front(x, split_axis)
        out = torch.empty_like(xm)
        dist.all_to_all_single(out, xm, group=g.pg)
        chunks = [c.movedim(0, split_axis) for c in out.chunk(n, 0)]
        return torch.cat(chunks, dim=concat_axis)

    def send(self, x, dst, group=None, tag=0):
        dist.send(x, dst, group=self._group(group).pg, tag=tag)

    def recv(self, x, src, group=None, tag=0):
        dist.recv(x, src, group=self._group(group).pg, tag=tag)
        return x

    def barrier(self, group=None):
        g = self._group(group)
        if not g.local:
            dist.barrier(group=g.pg)
