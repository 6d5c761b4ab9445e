"""Kernel builder (reference ``op_builder/builder.py``; the port of
``deepspeed_tpu/ops/op_builder.py:NativeOpBuilder``, g++ + ctypes).

A CUDA kernel of this package is a ``csrc/*.cu`` file with a plain C
interface.  ``nvcc`` compiles it for Hopper (``sm_90a``) into a shared
library under a build directory that git ignores, named by a hash of the
source, the headers it includes from ``csrc/`` and the flags, and
``ctypes`` loads it.  No PyTorch headers are included, so a build takes
seconds.  The build happens at first use, never at import; ``build_all``
starts one ``nvcc`` per source at once.

The host libraries of offload (:class:`HostOpBuilder`: the host
optimizers and the async I/O engines, ``csrc/host/*.cpp``, copies of the
JAX package's sources) are built the same way with ``g++`` and the JAX
builders' flags, into the same directory.

The build directory is ``$DS_TORCH_BUILD_DIR`` if set, else
``build/deepspeed_tpu_torch/`` beside the package.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time

from ..utils.logging import logger

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def build_dir():
    return os.environ.get("DS_TORCH_BUILD_DIR") or os.path.join(
        os.path.dirname(_PKG_ROOT), "build", "deepspeed_tpu_torch")


def find_nvcc():
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels of "
                       "deepspeed_tpu_torch are compiled at first use")


class CUDAOpBuilder:
    """One ``.cu`` source → one ``lib<NAME>-<hash>.so`` loaded by ctypes."""

    NAME = "base"
    SOURCE = None         # path under the package root

    _libs = {}            # NAME → loaded CDLL (one load per process)

    def source(self):
        return os.path.join(_PKG_ROOT, self.SOURCE)

    def sources(self):
        """The ``.cu`` source and every header it includes by a quoted
        ``#include`` beside it (headers' own includes followed)."""
        found, todo = [], [self.source()]
        while todo:
            path = todo.pop()
            if path in found or not os.path.exists(path):
                continue
            found.append(path)
            with open(path, errors="replace") as f:
                for name in _INCLUDE.findall(f.read()):
                    todo.append(os.path.join(os.path.dirname(path), name))
        return found

    def flags(self):
        return NVCC_FLAGS

    def command(self, out):
        return [find_nvcc(), *self.flags(), self.source(), "-o", out]

    def lib_path(self):
        """Named by a hash of the flags, the source and its headers: an
        edited header builds a new library."""
        h = hashlib.sha256()
        for path in self.sources():
            with open(path, "rb") as f:
                h.update(f.read())
        h.update(" ".join(self.flags()).encode())
        return os.path.join(build_dir(),
                            f"lib{self.NAME}-{h.hexdigest()[:16]}.so")

    def start_build(self):
        """Start the compiler unless the library is built; returns the running
        process (or None) for :meth:`finish_build`."""
        out = self.lib_path()
        if os.path.exists(out):
            return None
        os.makedirs(build_dir(), exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = self.command(tmp)
        logger.info(f"building {self.NAME}: {' '.join(cmd)}")
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        proc.ds_tmp, proc.ds_t0 = tmp, time.perf_counter()
        proc.ds_compiler = os.path.basename(cmd[0])
        return proc

    def finish_build(self, proc):
        """Wait for :meth:`start_build`'s process; returns (seconds, the
        compiler's output including ``ptxas -v``; for a library built
        earlier, 0 and the output its build kept beside it).  Raises on
        failure."""
        if proc is None:
            try:
                with open(self.lib_path() + ".log") as f:
                    return 0.0, f.read()
            except OSError:
                return 0.0, "(cached)"
        log, _ = proc.communicate()
        secs = time.perf_counter() - proc.ds_t0
        if proc.returncode != 0:
            raise RuntimeError(f"{proc.ds_compiler} failed for {self.NAME} "
                               f"(rc={proc.returncode}):\n{log}")
        with open(self.lib_path() + ".log", "w") as f:
            f.write(log)
        os.replace(proc.ds_tmp, self.lib_path())   # atomic publish
        return secs, log

    def build(self):
        return self.finish_build(self.start_build())

    def load(self):
        lib = CUDAOpBuilder._libs.get(self.NAME)
        if lib is None:
            self.build()
            lib = ctypes.CDLL(self.lib_path())
            self.bind(lib)
            CUDAOpBuilder._libs[self.NAME] = lib
        return lib

    def bind(self, lib):
        """Declare ``argtypes``/``restype`` of the library's functions."""
        raise NotImplementedError


class PagedAttentionBuilder(CUDAOpBuilder):
    NAME = "paged_attention"
    SOURCE = os.path.join("csrc", "paged_attention.cu")

    def bind(self, lib):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ds_paged_attention.argtypes = [
            p, p, p, p, p, p, p,       # q, k_cache, v_cache, tables, pos,
            #                            out, scratch
            i, i, i, i, i, i, i, i,    # T, H, Hkv, Dh, bs, maxb, atom, window
            ctypes.c_float, i,         # scale, dtype code
            i, i, i, i, p]             # route, splits, span, row tiles, stream
        lib.ds_paged_attention.restype = i
        lib.ds_paged_attention_smem_bytes.argtypes = [i, i, i]
        lib.ds_paged_attention_smem_bytes.restype = i
        lib.ds_paged_attention_blocks_per_sm.argtypes = [i, i, i]
        lib.ds_paged_attention_blocks_per_sm.restype = i
        lib.ds_cuda_error_string.argtypes = [i]
        lib.ds_cuda_error_string.restype = ctypes.c_char_p


class FlashAttentionBuilder(CUDAOpBuilder):
    NAME = "flash_attention"
    SOURCE = os.path.join("csrc", "flash_attention.cu")

    def bind(self, lib):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # B, Hq, Hkv, sq, sk, D, scale, causal, window, dtype code, stream
        dims = [i, i, i, i, i, i, f, i, i, i, p]
        # tensors: q k v slopes o lse | q k v o do lse slopes dq delta |
        # q k v do lse delta slopes dk dv
        lib.ds_flash_fwd.argtypes = [p] * 6 + dims
        lib.ds_flash_bwd_dq.argtypes = [p] * 9 + dims
        lib.ds_flash_bwd_dkv.argtypes = [p] * 9 + dims
        for fn in (lib.ds_flash_fwd, lib.ds_flash_bwd_dq,
                   lib.ds_flash_bwd_dkv):
            fn.restype = i
        lib.ds_flash_smem_bytes.argtypes = [i, i]
        lib.ds_flash_smem_bytes.restype = i
        lib.ds_cuda_error_string.argtypes = [i]
        lib.ds_cuda_error_string.restype = ctypes.c_char_p


class OptimizersBuilder(CUDAOpBuilder):
    NAME = "optimizers"
    SOURCE = os.path.join("csrc", "optimizers.cu")

    def bind(self, lib):
        p, i, f, n = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
            ctypes.c_longlong
        lib.ds_fused_adam.argtypes = [
            p, i, p, p, p,              # grad, grad dtype, master, m, v,
            p, i, p, n,                 # out, out dtype, gscale, n
            f, f, f, f, f, f, f,        # lr, b1, b2, eps, wd, c1, c2
            i, p]                       # adam_w_mode, stream
        lib.ds_fused_lion.argtypes = [
            p, i, p, p,                 # grad, grad dtype, master, m,
            p, i, p, n,                 # out, out dtype, gscale, n
            f, f, f, f, p]              # lr, b1, b2, wd, stream
        lib.ds_lamb_phase1.argtypes = [
            p, i, p, p, p, p, p,        # grad, grad dtype, master, m, v, u,
            #                             gscale
            p, i, p,                    # chunk table, chunks, partials
            f, f, f, f, f, f, p]        # b1, b2, eps, wd, c1, c2, stream
        lib.ds_lamb_phase2.argtypes = [
            p, p, p, i,                 # master, u, out, out dtype
            p, i, p, p, p,              # chunk table, chunks, leaf chunks,
            #                             partials, leaf stats
            f, f, f, p]                 # lr, max/min coeff, stream
        for fn in (lib.ds_fused_adam, lib.ds_fused_lion, lib.ds_lamb_phase1,
                   lib.ds_lamb_phase2):
            fn.restype = i
        lib.ds_cuda_error_string.argtypes = [i]
        lib.ds_cuda_error_string.restype = ctypes.c_char_p


class GroupedMatmulBuilder(CUDAOpBuilder):
    NAME = "grouped_matmul"
    SOURCE = os.path.join("csrc", "grouped_matmul.cu")

    def bind(self, lib):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ds_gmm.argtypes = [
            p, p, p, p,                 # x, w, group_sizes, y
            i, i, i, i, i, i, p]        # T, K, N, E, dtype, route, stream
        lib.ds_gmm.restype = i
        for fn in (lib.ds_gmm_dx, lib.ds_gmm_dw):
            # dx: dy, w, group_sizes, dx; dw: x, dy, group_sizes, dw
            fn.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
            fn.restype = i
        lib.ds_cuda_error_string.argtypes = [i]
        lib.ds_cuda_error_string.restype = ctypes.c_char_p


class QuantizerBuilder(CUDAOpBuilder):
    NAME = "quantizer"
    SOURCE = os.path.join("csrc", "quantizer.cu")

    def bind(self, lib):
        p, i, f, n = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
            ctypes.c_longlong
        lib.ds_quantize_blockwise.argtypes = [
            p, i, p, p,                 # x, dtype code, q, scales
            n, n, i, f, p]              # n, groups, group size, qmax, stream
        lib.ds_quantize_blockwise_t.argtypes = [
            p, i, p, p,                 # p, dtype code, q, scales
            i, i, i, f, p]              # out, in, group size, qmax, stream
        lib.ds_dequantize_blockwise.argtypes = [
            p, p, p, i,                 # q, scales, out, dtype code
            n, i, p]                    # n, group size, stream
        for fn in (lib.ds_quantize_blockwise, lib.ds_quantize_blockwise_t,
                   lib.ds_dequantize_blockwise):
            fn.restype = i
        lib.ds_cuda_error_string.argtypes = [i]
        lib.ds_cuda_error_string.restype = ctypes.c_char_p


class FlashBiasBuilder(CUDAOpBuilder):
    NAME = "flash_bias"
    SOURCE = os.path.join("csrc", "flash_bias.cu")

    def bind(self, lib):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # B, H, sq, sk, D, Bb, Hb, Bm, scale, causal, dtype code, bias
        # dtype code, stream
        dims = [i] * 8 + [f, i, i, i, p]
        # tensors: q k v bias mask o lse | q k v o do lse bias mask dq delta
        # | q k v do lse delta bias mask dk dv | ... bias mask dbias
        # scratch, then the dbias split count
        lib.ds_flash_bias_fwd.argtypes = [p] * 7 + dims
        lib.ds_flash_bias_bwd_dq.argtypes = [p] * 10 + dims
        lib.ds_flash_bias_bwd_dkv.argtypes = [p] * 10 + dims
        lib.ds_flash_bias_bwd_dbias.argtypes = [p] * 10 + [i] + dims
        for fn in (lib.ds_flash_bias_fwd, lib.ds_flash_bias_bwd_dq,
                   lib.ds_flash_bias_bwd_dkv, lib.ds_flash_bias_bwd_dbias):
            fn.restype = i
        lib.ds_flash_bias_smem_bytes.argtypes = [i, i]
        lib.ds_flash_bias_smem_bytes.restype = i
        lib.ds_cuda_error_string.argtypes = [i]
        lib.ds_cuda_error_string.restype = ctypes.c_char_p


class BlockSparseAttentionBuilder(CUDAOpBuilder):
    NAME = "block_sparse_attention"
    SOURCE = os.path.join("csrc", "block_sparse_attention.cu")

    def bind(self, lib):
        p, i, f, n = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
            ctypes.c_longlong
        lib.ds_block_sparse_attention_fwd.argtypes = [
            p, p, p, p, p, p,           # q, k, v, o, idx, cnt
            p, p, i,                    # row groups, keys, groups
            i, i, i, i, i, i, i,        # B, S, H, D, block, nq, maxk
            n, n, n, n, n, n, n, n, n,  # q, k, v strides of b, s, h
            f, i, i, p]                 # scale, causal, dtype code, stream
        lib.ds_block_sparse_attention_fwd.restype = i
        # block, D, route (0 fp32, 1 tensor cores)
        lib.ds_block_sparse_attention_smem_bytes.argtypes = [i, i, i]
        lib.ds_block_sparse_attention_smem_bytes.restype = i
        lib.ds_cuda_error_string.argtypes = [i]
        lib.ds_cuda_error_string.restype = ctypes.c_char_p


class FPQuantizerBuilder(CUDAOpBuilder):
    NAME = "fp_quantizer"
    SOURCE = os.path.join("csrc", "fp_quantizer.cu")

    def bind(self, lib):
        p, i, f, n = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
            ctypes.c_longlong
        lib.ds_quantize_fp_packed.argtypes = [
            p, i, p, p,                 # x, dtype code, packed, scales
            n, n, i,                    # n, groups, group size
            i, i, f, p]                 # q_bits, mantissa bits, maxv, stream
        lib.ds_quantize_fp_packed.restype = i
        lib.ds_cuda_error_string.argtypes = [i]
        lib.ds_cuda_error_string.restype = ctypes.c_char_p


class HostOpBuilder(CUDAOpBuilder):
    """A host C++ library (JAX ``ops/op_builder.py:70 NativeOpBuilder``):
    ``SOURCES`` under ``csrc/host/``, compiled by ``g++`` with the JAX
    builder's flags and ``EXTRA_CFLAGS``/``EXTRA_LDFLAGS``."""

    SOURCES = ()
    EXTRA_CFLAGS = ()
    EXTRA_LDFLAGS = ()

    def sources(self):
        return [os.path.join(_PKG_ROOT, s) for s in self.SOURCES]

    def flags(self):
        return ("-O3", "-shared", "-fPIC", "-std=c++17", *self.EXTRA_CFLAGS,
                *self.EXTRA_LDFLAGS)

    def command(self, out):
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("g++ not found: the host libraries of "
                               "deepspeed_tpu_torch are compiled at first use")
        return [gxx, "-O3", "-shared", "-fPIC", "-std=c++17",
                *self.EXTRA_CFLAGS, *self.sources(), "-o", out,
                *self.EXTRA_LDFLAGS]


class CPUOptimizersBuilder(HostOpBuilder):
    """The host Adam/Adagrad/Lion and the squared norm (JAX
    ``ops/cpu_optimizers.py:18 CPUAdamBuilder``)."""
    NAME = "cpu_optimizers"
    SOURCES = (os.path.join("csrc", "host", "cpu_optimizers.cpp"), )
    EXTRA_CFLAGS = ("-fopenmp", "-march=native", "-funroll-loops")
    EXTRA_LDFLAGS = ("-fopenmp", )

    def bind(self, lib):
        p, n, f, i = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float, \
            ctypes.c_int
        lib.ds_cpu_adam_step.argtypes = [p, p, p, p, n, f, f, f, f, f, i, i,
                                         p]
        lib.ds_cpu_adagrad_step.argtypes = [p, p, p, n, f, f, f, p]
        lib.ds_cpu_lion_step.argtypes = [p, p, p, n, f, f, f, f, p]
        lib.ds_cpu_sq_norm.restype = ctypes.c_double
        lib.ds_cpu_sq_norm.argtypes = [p, n]
        # the OpenMP runtime the library links (``set_host_threads``)
        lib.omp_set_num_threads.argtypes = [i]
        lib.omp_set_num_threads.restype = None


class AsyncIOBuilder(HostOpBuilder):
    """The io_uring and thread-pool I/O engines (JAX ``ops/aio.py:26``)."""
    NAME = "async_io"
    SOURCES = (os.path.join("csrc", "host", "ds_aio.cpp"),
               os.path.join("csrc", "host", "ds_aio_uring.cpp"))
    EXTRA_CFLAGS = ("-pthread", )
    EXTRA_LDFLAGS = ("-pthread", )

    def bind(self, lib):
        p, n, i, s = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, \
            ctypes.c_char_p
        lib.ds_aio_handle_new.restype = p
        lib.ds_aio_handle_new.argtypes = [n, i, i, i]
        lib.ds_aio_handle_free.argtypes = [p]
        lib.ds_uring_available.restype = i
        lib.ds_uring_handle_new.restype = p
        lib.ds_uring_handle_new.argtypes = [n, i, i]
        lib.ds_uring_handle_free.argtypes = [p]
        for prefix in ("ds_aio", "ds_uring"):
            for op in ("submit_read", "submit_write"):
                fn = getattr(lib, f"{prefix}_{op}")
                fn.restype = n
                fn.argtypes = [p, s, p, n, n]
            wait = getattr(lib, f"{prefix}_wait")
            wait.restype = i
            wait.argtypes = [p, n]
            pend = getattr(lib, f"{prefix}_pending")
            pend.restype = n
            pend.argtypes = [p]
            for op in ("pread", "pwrite"):
                fn = getattr(lib, f"{prefix}_{op}")
                fn.restype = i
                fn.argtypes = [p, s, p, n, n]


ALL_OPS = {b.NAME: b for b in (PagedAttentionBuilder, FlashAttentionBuilder,
                               OptimizersBuilder, GroupedMatmulBuilder,
                               QuantizerBuilder, FlashBiasBuilder,
                               BlockSparseAttentionBuilder,
                               FPQuantizerBuilder, CPUOptimizersBuilder,
                               AsyncIOBuilder)}


def build_all():
    """Build every kernel and host library, one compiler per library
    started together.  Returns {name: (seconds, compiler output)}."""
    builders = [cls() for cls in ALL_OPS.values()]
    procs = [(b, b.start_build()) for b in builders]
    return {b.NAME: b.finish_build(proc) for b, proc in procs}
