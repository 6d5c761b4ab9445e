"""The port's host libraries of offload against the JAX package's bindings
(``tests/unit/ops/test_native_ops.py``): the host Adam (AdamW and L2),
Adagrad, Lion and the squared norm bit for bit on the same seeded arrays
(both compile the same C++ with the same flags), the bf16 shadow bit for
bit against ``tensor.to(torch.bfloat16)``, each kernel against its plain
PyTorch version (rtol 1e-6: the kernel may contract into FMAs); the aio
handle (round trip, async overlap, offset I/O, a missing file, O_DIRECT
aligned I/O, io_uring buffers held across async calls) and the swappers'
round trips; the builder's library names and the perf sweep."""

import gc
import os

import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import cpu_optimizers as jax_cpu
from deepspeed_tpu_torch.ops import cpu_optimizers as K
from deepspeed_tpu_torch.ops.aio import (AIOHandle, aio_aligned_empty,
                                         uring_available)
from deepspeed_tpu_torch.ops.op_builder import (ALL_OPS, AsyncIOBuilder,
                                                CPUOptimizersBuilder,
                                                build_dir)
from deepspeed_tpu_torch.runtime.swap_tensor import (
    AsyncTensorSwapper, PartitionedOptimizerSwapper)

ENGINES = ["threads", "uring"]


def _handle(engine, **kw):
    """A handle on ``engine``; io_uring is probed here, not at import (the
    kernel may refuse it: the test then skips)."""
    if engine == "uring" and not uring_available():
        pytest.skip("io_uring refused by this kernel")
    h = AIOHandle(engine=engine, **kw)
    assert h.engine == engine
    return h


def _arrays(n, seed, k):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n).astype(np.float32) for _ in range(k)]


def _t(a):
    return torch.from_numpy(a.copy())


# ------------------------------------------------------- host optimizers
@pytest.mark.parametrize("adamw", [True, False])
def test_cpu_adam_bit_equal_to_jax(adamw):
    n = 10001                         # odd: the SIMD tails
    p, g = _arrays(n, 0, 2)
    m, v = np.zeros(n, np.float32), np.zeros(n, np.float32)
    hp = dict(lr=1e-2, betas=(0.9, 0.99), eps=1e-8, weight_decay=0.01,
              adamw_mode=adamw)
    ref, mine = jax_cpu.DeepSpeedCPUAdam(**hp), K.DeepSpeedCPUAdam(**hp)
    jp, jm, jv = p.copy(), m.copy(), v.copy()
    tp, tm, tv = _t(p), _t(m), _t(v)
    out_j = np.zeros(n, np.uint16)
    out_t = torch.zeros(n, dtype=torch.bfloat16)
    for _ in range(3):
        ref.step(jp, g, jm, jv, bf16_out=out_j)
        mine.step(tp, _t(g), tm, tv, bf16_out=out_t)
    for a, b in ((jp, tp), (jm, tm), (jv, tv)):
        np.testing.assert_array_equal(a, b.numpy())
    np.testing.assert_array_equal(out_j, out_t.view(torch.int16).numpy()
                                  .view(np.uint16))
    assert mine.step_count == 3


def test_cpu_adam_bf16_shadow_is_torch_rounding():
    """The kernel's bf16 bits are ``Tensor.to(torch.bfloat16)`` of its
    fp32 result, NaN and ties included."""
    n = 4096
    p = _t(np.random.default_rng(1).standard_normal(n).astype(np.float32))
    p[:4] = torch.tensor([float("nan"), float("inf"), -0.0, 1.00390625])
    g, m, v = torch.ones(n), torch.zeros(n), torch.zeros(n)
    shadow = torch.zeros(n, dtype=torch.bfloat16)
    K.DeepSpeedCPUAdam(lr=1e-2).step(p, g, m, v, bf16_out=shadow)
    want = p.to(torch.bfloat16)
    assert torch.equal(shadow[4:], want[4:])
    assert torch.isnan(shadow[0]) and torch.equal(shadow[1:4], want[1:4])


@pytest.mark.parametrize("adamw", [True, False])
def test_cpu_adam_matches_its_plain_version(adamw):
    n = 3001
    p, g = _arrays(n, 5, 2)
    m, v = np.zeros(n, np.float32), np.zeros(n, np.float32)
    tp, tm, tv = _t(p), _t(m), _t(v)
    pp, pm, pv = _t(p), _t(m), _t(v)
    kern = K.DeepSpeedCPUAdam(lr=1e-2, betas=(0.9, 0.99), eps=1e-8,
                              weight_decay=0.01, adamw_mode=adamw)
    for step in range(1, 4):
        kern.step(tp, _t(g), tm, tv)
        K.cpu_adam_step_plain(pp, _t(g), pm, pv, lr=1e-2, beta1=0.9,
                              beta2=0.99, eps=1e-8, weight_decay=0.01,
                              step=step, adamw_mode=adamw)
    torch.testing.assert_close(tp, pp, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(tv, pv, rtol=1e-6, atol=1e-9)


def test_cpu_adagrad_bit_equal_to_jax_and_plain():
    n = 5000
    p, g = _arrays(n, 2, 2)
    s = np.zeros(n, np.float32)
    jp, js = p.copy(), s.copy()
    tp, ts = _t(p), _t(s)
    jax_cpu.DeepSpeedCPUAdagrad(lr=0.1, eps=1e-10, weight_decay=0.01).step(
        jp, g, js)
    K.DeepSpeedCPUAdagrad(lr=0.1, eps=1e-10, weight_decay=0.01).step(
        tp, _t(g), ts)
    np.testing.assert_array_equal(jp, tp.numpy())
    np.testing.assert_array_equal(js, ts.numpy())
    pp, ps = _t(p), _t(s)
    K.cpu_adagrad_step_plain(pp, _t(g), ps, lr=0.1, eps=1e-10,
                             weight_decay=0.01)
    torch.testing.assert_close(tp, pp, rtol=1e-6, atol=1e-7)


def test_cpu_lion_bit_equal_to_jax_and_plain():
    n = 3000
    p, g, m = _arrays(n, 3, 3)
    jp, jm = p.copy(), m.copy()
    tp, tm = _t(p), _t(m)
    out_j = np.zeros(n, np.uint16)
    out_t = torch.zeros(n, dtype=torch.bfloat16)
    jax_cpu.DeepSpeedCPULion(lr=1e-3, betas=(0.9, 0.99),
                             weight_decay=0.1).step(jp, g, jm, bf16_out=out_j)
    K.DeepSpeedCPULion(lr=1e-3, betas=(0.9, 0.99), weight_decay=0.1).step(
        tp, _t(g), tm, bf16_out=out_t)
    np.testing.assert_array_equal(jp, tp.numpy())
    np.testing.assert_array_equal(jm, tm.numpy())
    np.testing.assert_array_equal(out_j, out_t.view(torch.int16).numpy()
                                  .view(np.uint16))
    pp, pm = _t(p), _t(m)
    K.cpu_lion_step_plain(pp, _t(g), pm, lr=1e-3, beta1=0.9, beta2=0.99,
                          weight_decay=0.1)
    torch.testing.assert_close(tp, pp, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(tm, pm, rtol=1e-6, atol=1e-7)


def test_sq_norm_bit_equal_to_jax():
    g = np.random.default_rng(4).standard_normal(12345).astype(np.float32)
    assert K.cpu_sq_norm(_t(g)) == jax_cpu.cpu_sq_norm(g)
    assert abs(K.cpu_sq_norm(_t(g)) - K.cpu_sq_norm_plain(_t(g))) < 1e-6


def test_host_kernels_refuse_bad_buffers():
    p = torch.zeros(8)
    with pytest.raises(ValueError, match="contiguous"):
        K.DeepSpeedCPUAdam().step(p, torch.zeros(8, dtype=torch.float64),
                                  torch.zeros(8), torch.zeros(8))
    with pytest.raises(ValueError, match="size"):
        K.DeepSpeedCPULion().step(p, torch.zeros(7), torch.zeros(8))
    with pytest.raises(ValueError, match="bf16_out"):
        K.DeepSpeedCPUAdagrad().step(p, torch.zeros(8), torch.zeros(8),
                                     bf16_out=torch.zeros(8))


# ------------------------------------------------------------------ aio
@pytest.mark.parametrize("engine", ENGINES)
def test_aio_roundtrip(tmp_path, engine):
    h = _handle(engine, block_size=4096, thread_count=4)
    data = torch.randn(100000, generator=torch.Generator().manual_seed(0))
    h.write(data, tmp_path / "t.bin")
    out = torch.empty_like(data)
    h.read(out, tmp_path / "t.bin")
    assert torch.equal(out, data)
    back = np.empty(100000, np.float32)      # numpy buffers too
    h.read(back, tmp_path / "t.bin")
    np.testing.assert_array_equal(back, data.numpy())


@pytest.mark.parametrize("engine", ENGINES)
def test_aio_async_overlap(tmp_path, engine):
    h = _handle(engine, block_size=1 << 16, thread_count=4)
    arrays = [torch.full((50000, ), float(i)) for i in range(8)]
    reqs = [h.async_write(a, tmp_path / f"{i}.bin")
            for i, a in enumerate(arrays)]
    assert h.pending() >= 0
    for r in reqs:
        h.wait(r)
    bufs = [torch.empty(50000) for _ in range(8)]
    reqs = [h.async_read(b, tmp_path / f"{i}.bin")
            for i, b in enumerate(bufs)]
    for r in reqs:
        h.wait(r)
    for i, b in enumerate(bufs):
        assert torch.equal(b, arrays[i])


@pytest.mark.parametrize("engine", ENGINES)
def test_aio_offset_io(tmp_path, engine):
    h = _handle(engine)
    base = torch.arange(1000, dtype=torch.float32)
    h.write(base, tmp_path / "o.bin")
    chunk = torch.empty(100)
    h.read(chunk, tmp_path / "o.bin", offset=400)   # floats 100..199
    assert torch.equal(chunk, base[100:200])


@pytest.mark.parametrize("engine", ENGINES)
def test_aio_read_missing_file_raises(tmp_path, engine):
    h = _handle(engine)
    with pytest.raises(IOError):
        h.read(torch.empty(10), tmp_path / "missing.bin")
    rid = h.async_read(torch.empty(10), tmp_path / "missing.bin")
    with pytest.raises(IOError):
        h.wait(rid)


@pytest.mark.parametrize("engine", ENGINES)
def test_aio_o_direct_aligned(tmp_path, engine):
    """4 KiB-aligned buffer, offset and length round-trip with O_DIRECT; a
    misaligned request on the same handle takes buffered I/O."""
    h = _handle(engine, queue_depth=16, o_direct=True)
    a = aio_aligned_empty((1 << 20, ), torch.uint8)
    assert a.data_ptr() % 4096 == 0
    a.copy_(torch.randint(0, 255, (1 << 20, ), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(1)))
    h.write(a, tmp_path / "d.bin")
    b = aio_aligned_empty((1 << 20, ), torch.uint8)
    h.read(b, tmp_path / "d.bin")
    assert torch.equal(a, b)
    odd = torch.arange(1003, dtype=torch.int32).to(torch.uint8)
    h.write(odd, tmp_path / "odd.bin")
    back = torch.empty_like(odd)
    h.read(back, tmp_path / "odd.bin")
    assert torch.equal(odd, back)
    n = aio_aligned_empty((3, 5), np.float32)
    assert n.shape == (3, 5) and n.ctypes.data % 4096 == 0


def test_aio_uring_buffer_pinned_across_async(tmp_path):
    """The handle keeps async buffers alive until wait(): the caller's only
    reference dropped mid-flight frees nothing the kernel writes into."""
    h = _handle("uring", block_size=1 << 16)
    data = torch.randint(0, 255, (1 << 20, ), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(2))
    h.write(data, tmp_path / "p.bin")
    reqs = [h.async_read(torch.empty(1 << 18, dtype=torch.uint8),
                         tmp_path / "p.bin", i << 18) for i in range(4)]
    gc.collect()
    for i, r in enumerate(reqs):
        buf = h._live[r]
        h.wait(r)
        assert torch.equal(buf, data[i << 18:(i + 1) << 18])
    assert not h._live


def test_aio_unknown_engine_raises():
    with pytest.raises(ValueError, match="unknown aio engine"):
        AIOHandle(engine="libaio")


# ------------------------------------------------------------- swapping
def test_tensor_swapper_roundtrip(tmp_path):
    sw = AsyncTensorSwapper(tmp_path / "swap")
    a = torch.arange(1024, dtype=torch.float32).reshape(32, 32)
    sw.swap_out("layer0/w", a).wait()
    sw.swap_out("layer0_w", a * 2).wait()      # no alias with 'layer0/w'
    back = sw.swap_in("layer0/w").wait()
    assert torch.equal(back, a) and back.shape == (32, 32)
    assert torch.equal(sw.swap_in("layer0_w").wait(), a * 2)
    out = torch.empty(32, 32)
    assert sw.swap_in("layer0/w", async_op=False, out=out).buf is out
    assert torch.equal(out, a)
    with pytest.raises(ValueError, match="out holds"):
        sw.swap_in("layer0/w", out=torch.empty(7))
    with pytest.raises(KeyError):
        sw.swap_in("nope")
    os.remove(sw._path("layer0_w"))
    with pytest.raises(IOError):
        sw.swap_in("layer0_w").wait()
    sw.cleanup()
    assert not os.path.exists(tmp_path / "swap")


def test_optimizer_swapper_tree(tmp_path):
    tree = {"master": torch.ones(64), "exp_avg": torch.zeros(8),
            "exp_avg_sq": torch.full((8, ), 2.0, dtype=torch.float32)}
    sw = PartitionedOptimizerSwapper(tmp_path / "opt_swap")
    with pytest.raises(RuntimeError, match="nothing swapped out"):
        sw.swap_in_tree()
    for h in sw.swap_out_tree(tree):
        h.wait()
    back = sw.swap_in_tree()
    assert list(back) == list(tree)
    for k in tree:
        assert torch.equal(back[k], tree[k])
    sw.cleanup()


# -------------------------------------------------------------- builder
def test_host_builders_name_their_libraries_by_source_and_flags():
    for cls in (CPUOptimizersBuilder, AsyncIOBuilder):
        b = cls()
        assert ALL_OPS[b.NAME] is cls
        path = b.lib_path()
        assert os.path.dirname(path) == build_dir()
        assert os.path.basename(path).startswith(f"lib{b.NAME}-")
        b.load()
        assert os.path.exists(path)
        cmd = b.command("out.so")
        assert os.path.basename(cmd[0]) == "g++"
        assert all(f in cmd for f in b.EXTRA_CFLAGS)


def test_perf_sweep_reports_the_best_setting(tmp_path):
    from deepspeed_tpu_torch.nvme import run_sweep
    out = run_sweep(str(tmp_path), size_mb=1, block_sizes=(1 << 16, ),
                    queue_depths=(4, ), thread_counts=(1, 2),
                    engine="threads")
    assert len(out["results"]) == 2
    assert out["best"] in out["results"]
    assert all(r["read_gbps"] > 0 and r["write_gbps"] > 0
               for r in out["results"])
