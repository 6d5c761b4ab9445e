"""Tensor swapping to NVMe or disk (the port of
``deepspeed_tpu/runtime/swap_tensor.py``; reference
``runtime/swap_tensor/`` ``AsyncTensorSwapper``, the partitioned optimizer
swapper).

A tensor on the card is copied to the host once, then the aio handle
(``ops/aio.py``) streams it to its own file; swapping in is the mirror,
into a fresh host tensor or a given one (a pinned buffer).  Transfers are
asynchronous: callers hold a :class:`SwapHandle` and ``wait()`` where they
use the data.  A failed read or write raises.
"""

import os
import shutil

import torch


class SwapHandle:
    """One aio request in flight and its host buffer."""

    def __init__(self, aio, req_id, buf, meta=None, done=False):
        self._aio = aio
        self._req = req_id
        self.buf = buf
        self.meta = meta or {}
        self._done = done

    def wait(self):
        """The buffer, once its request is done; raises once if it failed
        (a later wait does not wait again)."""
        if not self._done:
            self._done = True
            self._aio.wait(self._req)
        return self.buf

    @property
    def done(self):
        return self._done


def _host(t):
    """``t`` on the host, contiguous (``t`` itself when it already is)."""
    return t.detach().to("cpu").contiguous()


class AsyncTensorSwapper:
    """A key → file store of tensors with asynchronous reads and writes
    (reference ``runtime/swap_tensor/async_swapper.py``)."""

    def __init__(self, swap_dir, aio_handle=None, block_size=1 << 20,
                 queue_depth=32, thread_count=4):
        from ..ops.aio import AIOHandle
        self.swap_dir = os.path.abspath(swap_dir)
        os.makedirs(self.swap_dir, exist_ok=True)
        self.aio = aio_handle or AIOHandle(block_size=block_size,
                                           queue_depth=queue_depth,
                                           thread_count=thread_count)
        self._meta = {}   # key → (shape, dtype)
        self._inflight = []

    def _path(self, key):
        # injective: under a plain replacement 'a/b' and 'a_b' would share
        # a file
        safe = str(key).replace("_", "__").replace("/", "_s_")
        if os.sep != "/":
            safe = safe.replace(os.sep, "_s_")
        return os.path.join(self.swap_dir, f"{safe}.swp")

    def swap_out(self, key, tensor, async_op=True):
        """Tensor (on the card or the host) → its file.  The host buffer
        (``tensor`` itself when it is a contiguous CPU tensor) must stay
        unchanged until the handle is waited for."""
        host = _host(tensor)
        self._meta[key] = (tuple(host.shape), host.dtype)
        if async_op:
            req = self.aio.async_write(host, self._path(key))
            h = SwapHandle(self.aio, req, host, {"key": key})
            self._inflight.append(h)
            return h
        self.aio.write(host, self._path(key))
        return SwapHandle(self.aio, 0, host, {"key": key}, done=True)

    def swap_in(self, key, async_op=True, out=None):
        """Its file → a new host tensor, or ``out`` (contiguous, on the
        host, of the tensor's shape and dtype)."""
        if key not in self._meta:
            raise KeyError(f"no swapped tensor under key {key!r}")
        shape, dtype = self._meta[key]
        if out is None:
            out = torch.empty(shape, dtype=dtype)
        elif out.numel() * out.element_size() != \
                torch.Size(shape).numel() * torch.empty(
                    (), dtype=dtype).element_size():
            raise ValueError(f"swap_in({key!r}): out holds "
                             f"{out.numel()} × {out.dtype}, the file "
                             f"{shape} × {dtype}")
        if async_op:
            req = self.aio.async_read(out, self._path(key))
            h = SwapHandle(self.aio, req, out, {"key": key})
            self._inflight.append(h)
            return h
        self.aio.read(out, self._path(key))
        return SwapHandle(self.aio, 0, out, {"key": key}, done=True)

    def synchronize(self):
        """Wait for every request in flight."""
        inflight, self._inflight = self._inflight, []
        for h in inflight:
            h.wait()

    def contains(self, key):
        return key in self._meta

    def release(self, key):
        self._meta.pop(key, None)
        try:
            os.remove(self._path(key))
        except OSError:
            pass

    def cleanup(self):
        self.synchronize()
        shutil.rmtree(self.swap_dir, ignore_errors=True)
        self._meta.clear()


class PartitionedOptimizerSwapper:
    """Optimizer-state residency for NVMe offload (reference
    ``runtime/swap_tensor/partitioned_optimizer_swapper.py:219``): a dict
    of tensors lives on disk between steps; :meth:`swap_in_tree` brings it
    back to the host, :meth:`swap_out_tree` streams it out again, both
    asynchronous."""

    def __init__(self, swap_dir, **aio_kwargs):
        self.swapper = AsyncTensorSwapper(swap_dir, **aio_kwargs)
        self._names = None

    def swap_out_tree(self, tree):
        self._names = list(tree)
        return [self.swapper.swap_out(f"opt_{i}", tree[name])
                for i, name in enumerate(self._names)]

    def swap_in_tree(self):
        return self.finish_swap_in(self.swap_in_tree_async())

    def swap_in_tree_async(self):
        """Start the reads; returns the handles.  Started at the
        accumulation boundary's backward, the reads overlap its tail."""
        if self._names is None:
            raise RuntimeError("nothing swapped out")
        # the writes must land before the same files are read
        self.swapper.synchronize()
        return [(name, self.swapper.swap_in(f"opt_{i}"))
                for i, name in enumerate(self._names)]

    def finish_swap_in(self, handles):
        return {name: h.wait() for name, h in handles}

    def synchronize(self):
        self.swapper.synchronize()

    def cleanup(self):
        self.swapper.cleanup()
