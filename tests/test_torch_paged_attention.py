"""The port's paged attention (``deepspeed_tpu_torch/ops/kernels/
paged_attention.py``) against the JAX package's Pallas kernel, run in
interpret mode on the CPU, and against its gather path.

On a CPU tensor each wrapper of the port computes its kernel's plain
version, so these tests hold the plain version — the yardstick the CUDA
kernel is compared with on the card — to the TPU kernel's semantics: GQA,
sliding window, atom tiles streamed by their first row's table, pad rows.
Tolerance 2e-5 (fp32, different summation order), as the JAX package's own
kernel-vs-gather test uses.

The bf16/fp16 routes' arithmetic (split-KV decode, tensor-core atoms, P fed
as hi + lo) is emulated on the CPU by ``_emulate_split_kv_tensor_cores`` and
held to the card's tolerances against the Pallas kernel on inputs rounded
to the working type: 2^-7·|ref| + 1e-4 in bf16, 2^-10·|ref| + 1e-4 in fp16
(both sides sum in fp32 and round each output once, so they may differ by
one ulp of |ref|).  ``launch_plan``, the route rule, is tested on its own.
"""

import contextlib
import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepspeed_tpu.inference.v2 import ragged_forward as jax_rf
from deepspeed_tpu.ops.pallas import paged_attention as jax_pa
from deepspeed_tpu_torch.inference.v2 import ragged_forward as port_rf
from deepspeed_tpu_torch.ops.kernels import paged_attention as port_pa

TOL = dict(atol=2e-5, rtol=2e-5)
NB, BS, MAXB, DH = 16, 8, 4, 16


def _batch(seed, atom, n_tiles, H, Hkv):
    """q and caches, plus a ragged batch of ``n_tiles`` atom tiles: each
    tile is a run of consecutive positions of one sequence with its own
    block table, followed by pad rows (position 0, all-zero table)."""
    rng = np.random.default_rng(seed)
    T = n_tiles * atom
    q = rng.standard_normal((T, H, DH)).astype(np.float32)
    kc = rng.standard_normal((NB, BS, Hkv, DH)).astype(np.float32)
    vc = rng.standard_normal((NB, BS, Hkv, DH)).astype(np.float32)
    tables = np.zeros((T, MAXB), np.int32)
    pos = np.zeros(T, np.int32)
    for i in range(n_tiles):
        table = rng.choice(np.arange(1, NB), MAXB, replace=False)
        take = int(rng.integers(1, atom + 1))
        start = int(rng.integers(0, MAXB * BS - take + 1))
        rows = slice(i * atom, i * atom + take)
        tables[rows] = table
        pos[rows] = np.arange(start, start + take)
    return q, kc, vc, tables, pos


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("atom", [1, 4])
@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("H,Hkv", [(4, 4), (4, 2)], ids=["mha", "gqa"])
def test_plain_matches_pallas_kernel(H, Hkv, window, atom):
    """Wrapper (plain version on CPU) vs the Pallas kernel, every row."""
    batch = _batch(10 * atom + window + Hkv, atom, 6, H, Hkv)
    if atom == 1:
        want = jax_pa.paged_attention(*_j(*batch), window=window)
        got = port_pa.paged_attention(*_t(*batch), window=window)
    else:
        want = jax_pa.paged_attention_atoms(*_j(*batch), atom, window=window)
        got = port_pa.paged_attention_atoms(*_t(*batch), atom,
                                            window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("H,Hkv", [(4, 4), (4, 2)], ids=["mha", "gqa"])
def test_gather_path_matches_jax_gather(H, Hkv, window):
    """``_paged_attention(use_kernel=False)``: each row gathers its own
    block run, in both packages."""
    batch = _batch(7 + window + Hkv, 4, 5, H, Hkv)
    want = jax_rf._paged_attention(*_j(*batch), BS, window=window,
                                   use_kernel=False)
    got = port_rf._paged_attention(*_t(*batch), BS, window=window,
                                   use_kernel=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("window", [0, 8])
def test_layout_split_matches_pallas(monkeypatch, window):
    """The (decode_cap, atom) region split: one-row tiles for the decode
    region, atom tiles after it, against the JAX dispatch through the
    Pallas kernels."""
    monkeypatch.setenv("DS_TPU_TEST_PAGED_INTERPRET", "1")
    q1, kc, vc, t1, p1 = _batch(3, 1, 4, 4, 2)      # 4 decode rows
    q2, _, _, t2, p2 = _batch(4, 4, 3, 4, 2)        # 3 atom tiles
    batch = (np.concatenate([q1, q2]), kc, vc, np.concatenate([t1, t2]),
             np.concatenate([p1, p2]))
    layout = (4, 4)
    want = jax_rf._paged_attention(*_j(*batch), BS, window=window,
                                   layout=layout)
    got = port_rf._paged_attention(*_t(*batch), BS, window=window,
                                   layout=layout)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_atom_tile_streams_first_row_table():
    """Rows of one tile whose own tables differ still read the first row's
    pages (the kernel's rule), unlike the per-row gather."""
    q, kc, vc, tables, pos = _batch(5, 4, 2, 4, 2)
    tables[1] = tables[1][::-1]         # second row: a different table
    pos[:4] = [9, 10, 11, 12]
    want = jax_pa.paged_attention_atoms(*_j(q, kc, vc, tables, pos), 4)
    got = port_pa.paged_attention_atoms(*_t(q, kc, vc, tables, pos), 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    gather = port_pa.paged_attention_plain(*_t(q, kc, vc, tables, pos))
    assert not torch.allclose(gather[1], got[1])


def test_wrapper_rejects_ragged_atom_count():
    q, kc, vc, tables, pos = _t(*_batch(0, 4, 2, 4, 2))
    with pytest.raises(ValueError, match="multiple of atom"):
        port_pa.paged_attention_atoms(q[:7], kc, vc, tables[:7], pos[:7], 4)


# ------------------------- the bf16/fp16 routes' arithmetic, emulated
EDH, EBS, EMAXB, ENB = 64, 8, 10, 40


def _emu_batch(seed, atom, n_tiles, H, Hkv, dtype, dh=EDH):
    """Like :func:`_batch` at a head dim the kernel takes (``dh``, 64 by
    default), tables of 10 pages of 8 (80 keys: two 64-key tiles), and a
    last tile whose rows sit past the table (with a window they see no key
    at all).  q and caches rounded to ``dtype``; torch tensors."""
    rng = np.random.default_rng(seed)
    T = n_tiles * atom
    q, kc, vc = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dtype) for shape in ((T, H, dh),
                                             (ENB, EBS, Hkv, dh),
                                             (ENB, EBS, Hkv, dh)))
    tables = np.zeros((T, EMAXB), np.int32)
    pos = np.zeros(T, np.int32)
    for i in range(n_tiles):
        table = rng.choice(np.arange(1, ENB), EMAXB, replace=False)
        take = int(rng.integers(1, atom + 1))
        start = int(rng.integers(0, EMAXB * EBS - take + 1))
        if i == n_tiles - 1:
            take, start = atom, EMAXB * EBS + 20
        rows = slice(i * atom, i * atom + take)
        tables[rows] = table
        pos[rows] = np.arange(start, start + take)
    return q, kc, vc, torch.from_numpy(tables), torch.from_numpy(pos)


def _pallas_in(dtype, q, kc, vc, tables, pos, atom, window):
    """The Pallas kernel (interpreted) on the same values in fp32, its
    output rounded once to ``dtype``."""
    want = jax_pa.paged_attention_atoms(
        *(jnp.asarray(t.float().numpy()) for t in (q, kc, vc)),
        jnp.asarray(tables.numpy()), jnp.asarray(pos.numpy()), atom,
        window=window)
    return torch.from_numpy(np.array(want)).to(dtype)


def _worst_over_tol(got, ref, dtype):
    rtol = 2.0**-10 if dtype == torch.float16 else 2.0**-7
    diff = (got.float() - ref.float()).abs()
    return (diff / (rtol * ref.float().abs() + 1e-4)).max().item()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
@pytest.mark.parametrize("atom", [1, 4, 16])
@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("H,Hkv", [(4, 4), (8, 2)], ids=["mha", "gqa"])
def test_tensor_core_emulation_matches_pallas_kernel(H, Hkv, window, atom,
                                                     dtype):
    """The bf16/fp16 kernel's arithmetic (its split plan, 64-key tiles,
    warps' key slices merged in order, P as hi + lo) against the Pallas
    kernel within the card tolerance, every row: pad rows, decode rows
    whose later splits see no key, and a tile past its table."""
    q, kc, vc, tables, pos = _emu_batch(atom * 3 + window + Hkv, atom, 6, H,
                                        Hkv, dtype)
    ref = _pallas_in(dtype, q, kc, vc, tables, pos, atom, window)
    got = port_pa._emulate_split_kv_tensor_cores(q, kc, vc, tables, pos,
                                                 atom, window)
    assert _worst_over_tol(got, ref, dtype) <= 1.0
    route, splits, span, _ = port_pa.launch_plan(dtype, q.shape[0], H, Hkv,
                                                 EMAXB, atom)
    assert route == ("decode_split" if atom == 1 else "atom_mma")
    p = pos.tolist()    # a few tiles split; some see no key in some splits
    spans = [port_pa._tile_keys(p[t:t + atom], s, span, EBS, EMAXB, window)
             for t in range(0, len(p), atom) for s in range(splits)]
    assert splits > 1 and any(b >= e for b, e in spans)
    if window:          # the last tile's rows see no key: 0
        assert not got[-atom:].float().any()


@pytest.mark.parametrize("atom", [1, 16])
@pytest.mark.parametrize("target,splits", [(1, 1), (24, 2)])
def test_spans_of_several_tiles(monkeypatch, target, splits, atom):
    """Fewer splits than pages (one split walks 80 keys, two 64-key tiles;
    two splits of five pages), decode and atoms, against the Pallas kernel
    in bf16; a P rounded once instead of hi + lo breaks the tolerance."""
    monkeypatch.setattr(port_pa, "SPLIT_TARGET_BLOCKS", target)
    monkeypatch.setattr(port_pa, "ATOM_SPLIT_TARGET_BLOCKS", target)
    q, kc, vc, tables, pos = _emu_batch(11 + atom, atom, 6, 8, 2,
                                        torch.bfloat16)
    plan = port_pa.launch_plan(q.dtype, 6 * atom, 8, 2, EMAXB, atom)
    assert plan[1] == splits
    ref = _pallas_in(q.dtype, q, kc, vc, tables, pos, atom, 0)
    got = port_pa._emulate_split_kv_tensor_cores(q, kc, vc, tables, pos,
                                                 atom)
    once = port_pa._emulate_split_kv_tensor_cores(q, kc, vc, tables, pos,
                                                  atom, keep_lo=False)
    assert _worst_over_tol(got, ref, q.dtype) <= 1.0
    assert _worst_over_tol(once, ref, q.dtype) > 1.0


@pytest.mark.parametrize("tiles", [1, 6, 16, 64, 130, 4096])
@pytest.mark.parametrize("Hkv", [1, 8, 32])
@pytest.mark.parametrize("maxb", [1, 3, 32, 48, 257])
@pytest.mark.parametrize("atom", [1, 16])
def test_launch_plan_spans_cover_every_page_once(tiles, Hkv, maxb, atom):
    """The splits: consecutive spans of ``span`` pages, each starting
    inside the table, together covering its maxb pages exactly once; no
    more blocks than the route's target, never a split more than the table
    has pages."""
    route, splits, span, row_tiles = port_pa.launch_plan(
        torch.bfloat16, tiles * atom, 4 * Hkv, Hkv, maxb, atom)
    assert route == ("decode_split" if atom == 1 else "atom_mma")
    assert row_tiles == (1 if atom == 1 else 4)
    pages = [p for s in range(splits)
             for p in range(s * span, min((s + 1) * span, maxb))]
    assert pages == list(range(maxb))
    assert all(s * span < maxb for s in range(splits))
    assert splits <= maxb
    target = (port_pa.SPLIT_TARGET_BLOCKS if atom == 1
              else port_pa.ATOM_SPLIT_TARGET_BLOCKS)
    blocks = tiles * Hkv * splits
    assert splits == 1 or blocks <= target


@pytest.mark.parametrize("dtype,atom,g,want", [
    (torch.float32, 1, 1, ("fp32", 1)), (torch.float32, 16, 4, ("fp32", 1)),
    (torch.bfloat16, 1, 1, ("decode_split", 1)),
    (torch.float16, 1, 8, ("decode_split", 1)),
    (torch.bfloat16, 4, 1, ("atom_mma", 1)),
    (torch.bfloat16, 16, 1, ("atom_mma", 1)),
    (torch.float16, 16, 2, ("atom_mma", 2)),
    (torch.bfloat16, 12, 4, ("atom_mma", 4)),
    (torch.bfloat16, 16, 4, ("atom_mma", 4)),
    (torch.bfloat16, 16, 8, ("atom_mma", 8)),
    (torch.bfloat16, 32, 8, ("atom_mma", 8))])
def test_launch_plan_route_and_row_tiles(dtype, atom, g, want):
    """The route rule: fp32 → the CUDA cores; bf16/fp16 decode →
    decode_split, atoms → atom_mma (one split at 64 tiles × 8 kv heads),
    with the least power of two of 16-row tiles covering the M = atom·g
    rows, at most 8."""
    route, splits, span, row_tiles = port_pa.launch_plan(dtype, 64 * atom,
                                                         8 * g, 8, 32, atom)
    assert (route, row_tiles if route != "fp32" else 1) == want
    if route != "decode_split":
        assert (splits, span) == (1, 32)


def test_launch_reads_no_device_value(monkeypatch):
    """The launch path reads shapes only: with every way of bringing a
    tensor's value to the host made to raise, ``_launch`` hands the C entry
    launch_plan's route, splits, span and row tiles and a scratch of
    splits·T·H·(Dh + 2) fp32 values, whatever the positions; the counters
    count one launch by route."""
    calls = []

    class Lib:
        def ds_paged_attention(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(port_pa.PagedAttentionBuilder, "load",
                        lambda self: Lib())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: type("S", (), {"cuda_stream": 0})())
    empty = torch.empty
    scratch = []

    def recording_empty(*shape, **kw):
        t = empty(*shape, **kw)
        scratch.append(t.numel())
        return t

    monkeypatch.setattr(torch, "empty", recording_empty)
    batch = list(_emu_batch(0, 1, 6, 8, 2, torch.bfloat16))
    for name in ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
                 "__index__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, lambda *a, **k: 1 / 0)
    before = dict(port_pa.paged_attention.route_launches)
    for pos in (batch[4], batch[4] + 7):
        out, route = port_pa._launch(*batch[:4], pos, 1, 0)
        port_pa._count(port_pa.paged_attention, route)
        assert out.shape == batch[0].shape
    monkeypatch.undo()
    plan = port_pa.launch_plan(torch.bfloat16, 6, 8, 2, EMAXB, 1)
    assert route == plan[0] == "decode_split"
    assert calls[0][-5:-1] == (port_pa.ROUTES.index(plan[0]), *plan[1:])
    assert [c[7:] for c in calls[:1]] == [c[7:] for c in calls[1:]]
    assert scratch == [plan[1] * 6 * 8 * (EDH + 2)] * 2
    after = port_pa.paged_attention.route_launches
    assert after["decode_split"] == before["decode_split"] + 2


def test_atoms_split_only_under_one_wave():
    """A prefill of few tiles splits (Mistral's 8 tiles × 8 kv heads: 64
    blocks → 4 spans, 256 blocks); 8 tiles × 32 heads (256 blocks) and
    stage 4's 47 tiles × 32 heads do not."""
    bf16 = torch.bfloat16
    assert port_pa.launch_plan(bf16, 128, 32, 8, 48, 16) == (
        "atom_mma", 4, 12, 4)
    assert port_pa.launch_plan(bf16, 128, 32, 32, 32, 16) == (
        "atom_mma", 1, 32, 1)
    assert port_pa.launch_plan(bf16, 752, 32, 32, 32, 16) == (
        "atom_mma", 1, 32, 1)


def test_launch_plan_takes_shapes_only():
    assert list(inspect.signature(port_pa.launch_plan).parameters) == [
        "dtype", "T", "H", "Hkv", "maxb", "atom"]


def test_cpu_path_counts_no_launch():
    """The plain version on the CPU is not a kernel launch."""
    before = (port_pa.paged_attention.launches,
              port_pa.paged_attention_atoms.launches)
    batch = _t(*_batch(1, 4, 2, 4, 2))
    port_pa.paged_attention(*batch)
    port_pa.paged_attention_atoms(*batch, 4)
    assert (port_pa.paged_attention.launches,
            port_pa.paged_attention_atoms.launches) == before


def _fake_launch_lib(monkeypatch):
    """``_launch`` against a library that records its arguments: the C
    entry's calls, and the scratch sizes ``torch.empty`` was asked for."""
    calls, scratch = [], []

    class Lib:
        def ds_paged_attention(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(port_pa.PagedAttentionBuilder, "load",
                        lambda self: Lib())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: type("S", (), {"cuda_stream": 0})())
    empty = torch.empty

    def recording_empty(*shape, **kw):
        t = empty(*shape, **kw)
        scratch.append(t.numel())
        return t

    monkeypatch.setattr(torch, "empty", recording_empty)
    return calls, scratch


@pytest.mark.parametrize("dh", [80, 100])
@pytest.mark.parametrize("dtype,atom,route", [
    (torch.bfloat16, 1, "decode_split"), (torch.bfloat16, 4, "atom_mma"),
    (torch.float32, 1, "fp32")])
def test_launch_takes_head_widths_below_128(monkeypatch, dh, dtype, atom,
                                            route):
    """Head widths other than 64 and 128 (Phi's 80, OpenLLaMA-3B's 100)
    reach the C entry on launch_plan's route, with the true Dh, the scale
    Dh^-0.5 and a scratch of splits·T·H·(Dh + 2) fp32 values."""
    calls, scratch = _fake_launch_lib(monkeypatch)
    q, kc, vc, tables, pos = _emu_batch(0, atom, 4, 8, 2, dtype, dh=dh)
    T = q.shape[0]
    out, got = port_pa._launch(q, kc, vc, tables, pos, atom, 0)
    monkeypatch.undo()
    plan = port_pa.launch_plan(dtype, T, 8, 2, EMAXB, atom)
    assert got == plan[0] == route
    assert out.shape == (T, 8, dh)
    (args, ) = calls
    # ... T, H, Hkv, Dh, bs, maxb, atom, window, scale, dtype, route,
    # splits, span, row tiles, stream
    assert args[7:15] == (T, 8, 2, dh, EBS, EMAXB, atom, 0)
    assert args[15] == pytest.approx(dh ** -0.5)
    assert args[-5:-1] == (port_pa.ROUTES.index(route), *plan[1:])
    want_scratch = [plan[1] * T * 8 * (dh + 2)] if plan[1] > 1 else []
    assert scratch == want_scratch


@pytest.mark.parametrize("dh", [130, 99, 0])
def test_launch_refuses_odd_or_wide_heads(monkeypatch, dh):
    """An odd head width, or one above 128 (B1's limit too), is refused
    before anything reaches the card, with the limit in the message."""
    calls, _ = _fake_launch_lib(monkeypatch)
    q, kc, vc, tables, pos = _emu_batch(0, 1, 2, 4, 2, torch.bfloat16,
                                        dh=dh)
    with pytest.raises(ValueError, match="even head_dim of at most 128"):
        port_pa._launch(q, kc, vc, tables, pos, 1, 0)
    assert calls == []


@pytest.mark.parametrize("dh", [80, 100])
@pytest.mark.parametrize("atom", [1, 4])
def test_tensor_core_emulation_at_padded_head_widths(dh, atom):
    """The bf16 route's arithmetic at a head width its tile pads (the
    padding adds exact zeros to q·k and is never stored) against the Pallas
    kernel, interpreted, at the card tolerance."""
    batch = _emu_batch(5, atom, 5, 4, 2, torch.bfloat16, dh=dh)
    got = port_pa._emulate_split_kv_tensor_cores(*batch, atom)
    want = _pallas_in(torch.bfloat16, *batch, atom, 0)
    assert _worst_over_tol(got, want, torch.bfloat16) <= 1.0


def _layout_batch():
    q1, kc, vc, t1, p1 = _batch(3, 1, 4, 4, 2)      # 4 decode rows
    q2, _, _, t2, p2 = _batch(4, 4, 3, 4, 2)        # 3 atom tiles
    return _t(np.concatenate([q1, q2]), kc, vc, np.concatenate([t1, t2]),
              np.concatenate([p1, p2]))


@pytest.mark.parametrize("layout", [(0, 0), (4, 4)], ids=["rows", "split"])
def test_disable_paged_switch_takes_gather_path(monkeypatch, layout):
    """``DS_TPU_DISABLE_PALLAS_PAGED`` set: the ragged step's attention
    calls neither paged wrapper and returns the gather path's output, each
    row reading its own table (``ragged_forward.py:64-67, 82-107``)."""
    def refuse(*args, **kwargs):
        raise AssertionError("a paged kernel wrapper was called")

    monkeypatch.setattr(port_rf, "paged_attention", refuse)
    monkeypatch.setattr(port_rf, "paged_attention_atoms", refuse)
    monkeypatch.setenv("DS_TPU_DISABLE_PALLAS_PAGED", "1")
    batch = _layout_batch()
    got = port_rf._paged_attention(*batch, BS, window=8, layout=layout)
    want = port_pa.paged_attention_plain(*batch, window=8)
    assert torch.equal(got, want)
    monkeypatch.delenv("DS_TPU_DISABLE_PALLAS_PAGED")
    with pytest.raises(AssertionError, match="paged kernel wrapper"):
        port_rf._paged_attention(*batch, BS, window=8, layout=layout)
