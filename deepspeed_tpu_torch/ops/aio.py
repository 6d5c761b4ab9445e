"""Async I/O for NVMe offload (the port of ``deepspeed_tpu/ops/aio.py``;
reference ``csrc/aio/py_lib/deepspeed_py_io_handle.cpp`` ``aio_handle``).

Two native engines behind one handle, the JAX package's own host C++
(``csrc/host/ds_aio.cpp``, ``csrc/host/ds_aio_uring.cpp``, copies), built
with g++ by ``ops/op_builder.py:AsyncIOBuilder`` at first use:

* ``uring``: io_uring, one driver thread keeping ``queue_depth``
  block-sized operations in flight;
* ``threads``: a portable thread pool.

``engine="auto"`` probes io_uring once per process and, where the kernel
refuses it (containers often do), takes the thread pool and logs that it
did.  Buffers are contiguous CPU torch tensors or numpy arrays; a failed
read or write raises.
"""

import ctypes

import numpy as np
import torch

from ..utils.logging import logger
from .op_builder import AsyncIOBuilder

_URING_ALIGN = 4096
_uring_probe = None


def _lib():
    return AsyncIOBuilder().load()


def uring_available():
    """True when the kernel accepts io_uring_setup (it may be compiled in
    but disabled by sysctl or seccomp).  Probed once a process."""
    global _uring_probe
    if _uring_probe is None:
        _uring_probe = bool(_lib().ds_uring_available())
    return _uring_probe


def aio_aligned_empty(shape, dtype, align=_URING_ALIGN):
    """Like ``np.empty`` (or, for a torch dtype, ``torch.empty``) with the
    buffer's start aligned to ``align`` bytes, which qualifies it for
    ``O_DIRECT`` transfers."""
    shape = tuple(shape) if isinstance(shape, (tuple, list)) else (shape, )
    n = int(np.prod(shape, dtype=np.int64))
    if isinstance(dtype, torch.dtype):
        item = torch.empty((), dtype=dtype).element_size()
        raw = torch.empty(n * item + align, dtype=torch.uint8)
        start = (-raw.data_ptr()) % align
        return raw[start:start + n * item].view(dtype).view(shape)
    dtype = np.dtype(dtype)
    raw = np.empty(n * dtype.itemsize + align, dtype=np.uint8)
    start = (-raw.ctypes.data) % align
    return raw[start:start + n * dtype.itemsize].view(dtype).reshape(shape)


def _buf(arr):
    """(address, bytes) of a contiguous host buffer."""
    if isinstance(arr, torch.Tensor):
        if arr.device.type != "cpu" or not arr.is_contiguous():
            raise ValueError("aio buffers must be contiguous CPU tensors")
        return ctypes.c_void_p(arr.data_ptr()), \
            arr.numel() * arr.element_size()
    if not arr.flags["C_CONTIGUOUS"]:
        raise ValueError("aio buffers must be C-contiguous")
    return arr.ctypes.data_as(ctypes.c_void_p), arr.nbytes


class AIOHandle:
    """The reference's ``aio_handle`` (``queue_depth`` × ``block_size``
    submission, synchronous and submit/wait calls) over a native engine.

    ``engine``: "auto" (io_uring where the kernel allows, else the thread
    pool), "uring" (raises where refused) or "threads".  ``o_direct``
    applies to a request whose buffer, offset and length are all 4 KiB
    aligned (:func:`aio_aligned_empty`)."""

    def __init__(self, block_size=1 << 20, queue_depth=32, thread_count=4,
                 single_submit=False, overlap_events=True, engine="auto",
                 o_direct=False):
        if engine not in ("auto", "uring", "threads"):
            raise ValueError(f"unknown aio engine {engine!r}")
        self._lib = lib = _lib()
        self._h = None
        use_uring = engine in ("auto", "uring") and uring_available()
        if engine == "uring" and not use_uring:
            raise RuntimeError("io_uring unavailable on this kernel "
                               "(disabled by sysctl/seccomp?)")
        h = None
        if use_uring:
            h = lib.ds_uring_handle_new(block_size, queue_depth,
                                        1 if o_direct else 0)
            if not h and engine == "uring":
                raise RuntimeError("io_uring ring setup failed")
            use_uring = bool(h)
        if engine == "auto" and not use_uring:
            logger.warning("aio: io_uring refused by this kernel; the "
                           "thread-pool engine serves I/O")
        self.engine = "uring" if use_uring else "threads"
        prefix = "ds_uring" if use_uring else "ds_aio"
        if not use_uring:
            h = lib.ds_aio_handle_new(block_size, queue_depth, thread_count,
                                      1 if o_direct else 0)
        self._h = h
        (self._free, self._sread, self._swrite, self._wait, self._pending,
         self._read, self._write) = (
            getattr(lib, f"{prefix}_{op}") for op in (
                "handle_free", "submit_read", "submit_write", "wait",
                "pending", "pread", "pwrite"))
        self.block_size = block_size
        self.queue_depth = queue_depth
        self.thread_count = thread_count
        self._live = {}   # request id → buffer, held until wait()

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._free(self._h)
                self._h = None
        except Exception:
            pass

    # --- synchronous
    def read(self, arr, path, offset=0):
        ptr, nbytes = _buf(arr)
        if self._read(self._h, str(path).encode(), ptr, nbytes, offset):
            raise IOError(f"aio read failed: {path}")

    def write(self, arr, path, offset=0):
        ptr, nbytes = _buf(arr)
        if self._write(self._h, str(path).encode(), ptr, nbytes, offset):
            raise IOError(f"aio write failed: {path}")

    # --- asynchronous: the handle holds the buffer until wait(), so a
    # caller dropping its reference mid-flight frees nothing the kernel
    # still writes into
    def async_read(self, arr, path, offset=0):
        ptr, nbytes = _buf(arr)
        rid = self._sread(self._h, str(path).encode(), ptr, nbytes, offset)
        self._live[rid] = arr
        return rid

    def async_write(self, arr, path, offset=0):
        ptr, nbytes = _buf(arr)
        rid = self._swrite(self._h, str(path).encode(), ptr, nbytes, offset)
        self._live[rid] = arr
        return rid

    def wait(self, request_id):
        rc = self._wait(self._h, request_id)
        self._live.pop(request_id, None)
        if rc != 0:
            raise IOError(f"aio request {request_id} failed (rc={rc})")

    def pending(self):
        return self._pending(self._h)
