"""``ds_io`` / ``ds_nvme_tune``: the aio parameter sweep (the port of
``deepspeed_tpu/nvme/perf_sweep.py``; reference
``deepspeed/nvme/perf_run_sweep.py``), on the port's handle: read and
write GB/s over (engine, block_size, queue_depth, thread_count), and the
best setting for the swap subsystem.

``python -m deepspeed_tpu_torch.nvme.perf_sweep --nvme_dir DIR`` prints
the best setting (``--full``: every one).
"""

import argparse
import itertools
import json
import os
import tempfile
import time

import numpy as np

from ..utils.logging import logger


def _bench_config(path, size_mb, block_size, queue_depth, threads,
                  engine="threads", o_direct=False):
    from ..ops.aio import AIOHandle, aio_aligned_empty
    h = AIOHandle(block_size=block_size, queue_depth=queue_depth,
                  thread_count=threads, engine=engine, o_direct=o_direct)
    data = aio_aligned_empty((size_mb << 20, ), np.uint8)
    data[:] = np.random.default_rng(0).integers(
        0, 255, size_mb << 20, dtype=np.uint8)
    t0 = time.perf_counter()
    h.write(data, path)
    t_write = time.perf_counter() - t0
    buf = aio_aligned_empty((size_mb << 20, ), np.uint8)
    t0 = time.perf_counter()
    h.read(buf, path)
    t_read = time.perf_counter() - t0
    if not (buf[:1024] == data[:1024]).all():
        raise IOError(f"aio sweep: {path} read back other bytes")
    gb = size_mb / 1024
    return {"engine": h.engine, "block_size": block_size,
            "queue_depth": queue_depth, "threads": threads,
            "o_direct": o_direct, "write_gbps": gb / t_write,
            "read_gbps": gb / t_read}


def run_sweep(nvme_dir=None, size_mb=64,
              block_sizes=(256 << 10, 1 << 20, 8 << 20),
              queue_depths=(8, 32), thread_counts=(2, 4, 8),
              engine="all", o_direct=False):
    """Sweep (engine, block_size, queue_depth, threads).  ``engine="all"``
    covers the io_uring engine (when the kernel allows) AND the thread
    pool — the reference's perf_run_sweep sweeps single_submit/
    overlap_events the same way; here the engine axis replaces those."""
    from ..ops.aio import uring_available
    nvme_dir = nvme_dir or tempfile.gettempdir()
    path = os.path.join(nvme_dir, "ds_io_sweep.bin")
    if engine == "all":
        engines = ["threads"] + (["uring"] if uring_available() else [])
    elif engine == "auto":
        # resolve before the sweep so the uring thread-axis dedup below
        # sees the literal engine name
        engines = ["uring" if uring_available() else "threads"]
    else:
        engines = [engine]
    results = []
    try:
        for eng, bs, qd, tc in itertools.product(engines, block_sizes,
                                                 queue_depths,
                                                 thread_counts):
            if eng == "uring" and tc != thread_counts[0]:
                continue  # uring has no thread axis; sweep it once
            r = _bench_config(path, size_mb, bs, qd, tc, engine=eng,
                              o_direct=o_direct)
            results.append(r)
            logger.info("aio sweep: %s", r)
    finally:
        try:
            os.remove(path)
        except OSError:
            pass
    best = max(results, key=lambda r: r["read_gbps"] + r["write_gbps"])
    return {"results": results, "best": best}


def sweep_main():
    parser = argparse.ArgumentParser(description="aio/NVMe perf sweep")
    parser.add_argument("--nvme_dir", default=None)
    parser.add_argument("--size_mb", type=int, default=64)
    parser.add_argument("--engine", default="all",
                        choices=("all", "uring", "threads", "auto"))
    parser.add_argument("--o_direct", action="store_true")
    parser.add_argument("--full", action="store_true",
                        help="print every config, not just the best")
    args = parser.parse_args()
    out = run_sweep(args.nvme_dir, args.size_mb, engine=args.engine,
                    o_direct=args.o_direct)
    print(json.dumps(out if args.full else out["best"], indent=2))


if __name__ == "__main__":
    sweep_main()
