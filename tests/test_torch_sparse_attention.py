"""The port's block-sparse attention (``ops/sparse_attention`` and kernel
B9's plain version, on the CPU) against the JAX package's, on the same
numpy inputs.

- Every sparsity layout class gives JAX's layout array for array, random
  blocks included (both draw from ``np.random.default_rng(seed)``), and
  the same idx/valid gather tables.
- ``sparse_attention`` (the gather formulation) and
  ``SparseSelfAttention``: outputs and the gradients to q, k and v.
- ``block_sparse_attention_plain`` against JAX's
  ``block_sparse_flash_attention`` run in interpret mode (as
  ``tests/unit/ops/test_sparse_attention.py`` runs it), causal and
  bidirectional, with a row that has no live block; the port's wrapper
  (plain forward, the gather formulation's backward) against the JAX
  kernel's custom VJP.
- The tensor-core kernel's host-built row groups (``row_group_tables``)
  cover each live (q block, k block) pair once and no dead one, for the
  five layout classes at blocks 16-128, causal and not; its arithmetic
  (passes over the group key lists, P fed as hi + lo), emulated on the
  CPU, holds the card's bf16/fp16 tolerances against JAX's interpreted
  kernel, where P rounded once does not in bf16.

Tolerances: outputs 2e-5 absolute and relative, gradients 5e-5 absolute
and 5e-4 relative, the ones JAX's own kernel-against-gather tests use (the
same fp32 arithmetic in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import sparse_attention as jax_sa
from deepspeed_tpu.ops.pallas.block_sparse_attention import \
    block_sparse_flash_attention as jax_bs_flash
from deepspeed_tpu.ops.sparse_attention import \
    sparse_self_attention as jax_ssa
from deepspeed_tpu_torch.ops import sparse_attention as port_sa
from deepspeed_tpu_torch.ops.kernels import block_sparse_attention as port_bs
from deepspeed_tpu_torch.ops.sparse_attention import \
    sparse_self_attention as port_ssa

OUT_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=5e-5, rtol=5e-4)

LAYOUTS = {
    "dense": ("DenseSparsityConfig", dict(num_heads=2, block=8), 64),
    "fixed_bi": ("FixedSparsityConfig",
                 dict(num_heads=4, block=8, num_local_blocks=4,
                      num_global_blocks=1, different_layout_per_head=True,
                      num_different_global_patterns=4), 256),
    "fixed_uni_horizontal": (
        "FixedSparsityConfig",
        dict(num_heads=2, block=16, num_local_blocks=4, num_global_blocks=2,
             attention="unidirectional", horizontal_global_attention=True,
             different_layout_per_head=True,
             num_different_global_patterns=2), 256),
    "variable_random": (
        "VariableSparsityConfig",
        dict(num_heads=3, block=8, different_layout_per_head=True,
             num_random_blocks=2, local_window_blocks=(1, 2, 4),
             global_block_indices=(0, 5), global_block_end_indices=(2, 7),
             horizontal_global_attention=True, seed=3), 128),
    "variable_uni": ("VariableSparsityConfig",
                     dict(num_heads=2, block=8, num_random_blocks=1,
                          attention="unidirectional"), 64),
    "bigbird_bi": ("BigBirdSparsityConfig",
                   dict(num_heads=4, block=8, num_random_blocks=3,
                        num_sliding_window_blocks=3, num_global_blocks=2,
                        different_layout_per_head=True, seed=7), 256),
    "bigbird_uni": ("BigBirdSparsityConfig",
                    dict(num_heads=2, block=16, num_random_blocks=1,
                         attention="unidirectional"), 128),
    "longformer": ("BSLongformerSparsityConfig",
                   dict(num_heads=2, block=8, num_sliding_window_blocks=3,
                        global_block_indices=(0, 3),
                        global_block_end_indices=(1, 5)), 64),
}


def _configs(name):
    cls, kw, seq = LAYOUTS[name]
    return getattr(jax_sa, cls)(**kw), getattr(port_sa, cls)(**kw), seq


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_layouts_and_tables_equal_jax(name):
    jcfg, pcfg, seq = _configs(name)
    want, got = jcfg.make_layout(seq), pcfg.make_layout(seq)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    H = want.shape[0]
    for layout in (want, want[:1]):             # per head, and shared
        _, jidx, jvalid = jax_ssa.layout_gather_tables(layout, H)
        _, pidx, pvalid = port_ssa.layout_gather_tables(layout, H)
        np.testing.assert_array_equal(pidx, jidx)
        np.testing.assert_array_equal(pvalid, jvalid)
        # the kernel's per-row counts: valid is a prefix of each row
        counts = pvalid.sum(axis=-1)
        np.testing.assert_array_equal(
            pvalid, np.arange(pvalid.shape[-1]) < counts[..., None])


def test_unaligned_sequence_raises():
    with pytest.raises(ValueError, match="not divisible"):
        port_sa.FixedSparsityConfig(num_heads=1, block=16).make_layout(40)
    q = torch.zeros(1, 40, 1, 8)
    with pytest.raises(ValueError, match="multiple of layout block"):
        port_bs.block_sparse_flash_attention(q, q, q,
                                             np.ones((1, 3, 3), bool), 16)


def _qkv(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * scale).astype(np.float32)
            for _ in range(4)]


def _jax_vjp(fn, q, k, v, do):
    out, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))
    return [np.asarray(x) for x in (out, *vjp(jnp.asarray(do)))]


def _port_vjp(fn, q, k, v, do):
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = fn(*leaves)
    out.backward(torch.tensor(do))
    return [out.detach().numpy()] + [t.grad.numpy() for t in leaves]


def _assert_close(got, want):
    np.testing.assert_allclose(got[0], want[0], err_msg="out", **OUT_TOL)
    for name, g, w in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        np.testing.assert_allclose(g, w, err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("name,causal", [
    ("fixed_uni_horizontal", True), ("bigbird_bi", False),
    ("longformer", False), ("variable_random", False), ("dense", False),
    ("bigbird_uni", True)])
def test_gather_formulation_matches_jax(name, causal):
    """``sparse_attention`` forward and backward, [B, S, H, D]."""
    _, pcfg, _ = _configs(name)
    S = 4 * pcfg.block
    layout = pcfg.make_layout(S)
    q, k, v, do = _qkv(len(name), (2, S, pcfg.num_heads, 8))

    def fn(mod):
        return lambda q, k, v: mod.sparse_attention(q, k, v, layout,
                                                    pcfg.block, causal=causal)

    _assert_close(_port_vjp(fn(port_ssa), q, k, v, do),
                  _jax_vjp(fn(jax_ssa), q, k, v, do))


def _random_layout(rng, H, nb, causal, dead_row):
    """About half the blocks live, key block 0 live in every row, and with
    ``dead_row`` one row of head 1 with no live block at all."""
    layout = rng.random((H, nb, nb)) < 0.5
    layout[:, :, 0] = True
    if causal:
        layout &= np.tril(np.ones((nb, nb), bool))[None]
    if dead_row:
        layout[1, 2, :] = False
    return layout


@pytest.mark.parametrize("causal", [False, True], ids=["bidir", "causal"])
@pytest.mark.parametrize("dead_row", [False, True], ids=["", "dead_row"])
def test_plain_matches_jax_interpreted_kernel(causal, dead_row):
    """The kernel's plain version against JAX's Pallas kernel in interpret
    mode, forward; the port's wrapper against JAX's custom VJP, gradients
    (both the gather formulation's backward).  A row with no live block
    gives 0 and no gradient."""
    rng = np.random.default_rng(11 + causal)
    B, S, H, D, block = 2, 64, 2, 16, 16
    layout = _random_layout(rng, H, S // block, causal, dead_row)
    q, k, v, do = _qkv(int(causal) + 2 * dead_row, (B, S, H, D), 0.5)
    plain = port_bs.block_sparse_attention_plain(
        *(torch.tensor(x) for x in (q, k, v)), layout, block, causal=causal)

    def fn(mod):
        return lambda q, k, v: mod.block_sparse_flash_attention(
            q, k, v, layout, block, causal=causal)

    want = _jax_vjp(lambda q, k, v: jax_bs_flash(q, k, v, layout, block,
                                                 causal=causal), q, k, v, do)
    got = _port_vjp(fn(port_bs), q, k, v, do)
    np.testing.assert_allclose(plain.numpy(), want[0], **OUT_TOL)
    assert torch.equal(torch.from_numpy(got[0]), plain)
    _assert_close(got, want)
    if dead_row:
        rows = slice(2 * block, 3 * block)
        assert not got[0][:, rows, 1].any() and not want[0][:, rows, 1].any()
        assert not got[1][:, rows, 1].any()
    assert port_bs.block_sparse_attention_fwd.launches == 0


@pytest.mark.parametrize("block,D", [(32, 16), (8, 8)])
def test_plain_matches_jax_kernel_at_other_blocks(block, D):
    """Shared layout (one head of layout for all), another block size, a
    scale of its own."""
    rng = np.random.default_rng(block)
    B, S, H = 1, 4 * block, 3
    layout = rng.random((1, 4, 4)) < 0.6
    layout[:, :, 1] = True
    q, k, v, _ = _qkv(block + D, (B, S, H, D))
    want = jax_bs_flash(*(jnp.asarray(x) for x in (q, k, v)), layout, block,
                        scale=0.3)
    got = port_bs.block_sparse_attention_plain(
        *(torch.tensor(x) for x in (q, k, v)), layout, block, scale=0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)


@pytest.mark.parametrize("bshd", [False, True], ids=["bhsd", "bshd"])
@pytest.mark.parametrize("name", ["fixed_uni_horizontal", "bigbird_bi"])
def test_sparse_self_attention_matches_jax(name, bshd):
    """The module API: [B, H, S, D] by default or [B, S, H, D]; causal from
    the config's ``attention``; on the CPU both take the gather
    formulation."""
    jcfg, pcfg, _ = _configs(name)
    S = 4 * pcfg.block
    shape = ((2, S, pcfg.num_heads, 8) if bshd
             else (2, pcfg.num_heads, S, 8))
    q, k, v, do = _qkv(3, shape)
    jattn, pattn = jax_sa.SparseSelfAttention(jcfg), \
        port_sa.SparseSelfAttention(pcfg)
    want = _jax_vjp(lambda q, k, v: jattn(q, k, v, bshd=bshd), q, k, v, do)
    got = _port_vjp(lambda q, k, v: pattn(q, k, v, bshd=bshd), q, k, v, do)
    _assert_close(got, want)
    np.testing.assert_array_equal(pattn.layout(S), jattn.layout(S))


def test_sparse_self_attention_kernel_dispatch(monkeypatch):
    """Where the gate opens (a CUDA tensor; forced here) the module calls
    the kernel's wrapper, whose forward on the CPU is the plain version:
    JAX's module with ``DS_TPU_FORCE_PALLAS=1`` runs its interpreted
    kernel on the same inputs."""
    calls = []
    real = port_bs.block_sparse_flash_attention

    def spy(*args, **kwargs):
        calls.append(kwargs.get("causal"))
        return real(*args, **kwargs)

    monkeypatch.setattr(port_bs, "block_sparse_flash_attention", spy)
    monkeypatch.setattr(port_ssa, "use_kernels", lambda t: True)
    kw = dict(num_heads=2, block=16, num_local_blocks=2, num_global_blocks=1,
              attention="unidirectional")
    q, k, v, _ = _qkv(5, (1, 2, 64, 16), 0.5)
    got = port_sa.SparseSelfAttention(port_sa.FixedSparsityConfig(**kw))(
        *(torch.tensor(x) for x in (q, k, v)))
    monkeypatch.setenv("DS_TPU_FORCE_PALLAS", "1")
    want = jax_sa.SparseSelfAttention(jax_sa.FixedSparsityConfig(**kw))(
        *(jnp.asarray(x) for x in (q, k, v)))
    assert calls == [True]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)


def test_switch_off_takes_the_gather_formulation(monkeypatch):
    """With ``DS_TPU_DISABLE_PALLAS_ATTN`` set the gate stays shut even for
    a CUDA tensor (a stand-in here), and both packages compute the gather
    formulation: JAX's even with ``DS_TPU_FORCE_PALLAS=1``."""
    monkeypatch.setenv("DS_TPU_DISABLE_PALLAS_ATTN", "1")
    monkeypatch.setenv("DS_TPU_FORCE_PALLAS", "1")

    class CudaLike:
        device = torch.device("cuda")

    assert not port_ssa.use_kernels(CudaLike())

    def refuse(*args, **kwargs):
        raise AssertionError("the kernel's wrapper was called")

    monkeypatch.setattr(port_bs, "block_sparse_flash_attention", refuse)
    jcfg, pcfg, _ = _configs("bigbird_uni")
    q, k, v, do = _qkv(9, (1, 2, 64, 8))
    want = _jax_vjp(jax_sa.SparseSelfAttention(jcfg), q, k, v, do)
    got = _port_vjp(port_sa.SparseSelfAttention(pcfg), q, k, v, do)
    _assert_close(got, want)


def test_device_tables_cached_per_layout():
    """The kernel's idx/cnt tables are made once per layout and device."""
    layout = port_sa.BigBirdSparsityConfig(num_heads=2, block=16,
                                           seed=4).make_layout(128)
    a = port_bs.device_tables(layout, 2, torch.device("cpu"))
    b = port_bs.device_tables(layout.copy(), 2, torch.device("cpu"))
    assert a[0] is b[0] and a[1] is b[1]
    _, idx, valid = port_ssa.layout_gather_tables(layout, 2)
    np.testing.assert_array_equal(a[0].numpy(), idx)
    np.testing.assert_array_equal(a[1].numpy(), valid.sum(-1))
    assert a[0].dtype == a[1].dtype == torch.int32


def test_device_tables_frozen_layout_by_identity(monkeypatch):
    """A layout nothing can change in place (``SparseSelfAttention``'s,
    on a ``bytes`` buffer) is looked up by identity, without hashing its
    contents again; any other by contents, so changing it in place gives
    new tables, also a read-only one whose owner unfreezes, edits and
    freezes it again."""
    attn = port_sa.SparseSelfAttention(port_sa.FixedSparsityConfig(
        num_heads=2, block=16))
    frozen = attn.layout(128)
    assert attn.layout(128) is frozen
    with pytest.raises(ValueError):
        frozen.setflags(write=True)
    cpu = torch.device("cpu")
    first = port_bs.device_tables(frozen, 2, cpu, 16)
    calls = []
    real = port_bs.layout_gather_tables
    monkeypatch.setattr(port_bs, "layout_gather_tables",
                        lambda *a: calls.append(1) or real(*a))
    assert port_bs.device_tables(frozen, 2, cpu, 16) is first
    assert not calls
    owned = frozen.copy()
    owned.setflags(write=False)
    assert port_bs.device_tables(owned, 2, cpu, 16)[0] is first[0]
    assert calls
    owned.setflags(write=True)
    owned[:, :, 0] = ~owned[:, :, 0]
    owned.setflags(write=False)
    changed = port_bs.device_tables(owned, 2, cpu, 16)
    assert not torch.equal(changed[1], first[1])


# ----------------------------------- the tensor-core kernel's row groups
TABLE_CONFIGS = {
    "dense": ("DenseSparsityConfig", {}),
    "fixed": ("FixedSparsityConfig",
              dict(num_local_blocks=4, num_global_blocks=1,
                   different_layout_per_head=True,
                   num_different_global_patterns=2)),
    "variable": ("VariableSparsityConfig",
                 dict(num_random_blocks=2, local_window_blocks=(1, 2, 4),
                      global_block_indices=(0, 5),
                      different_layout_per_head=True, seed=3)),
    "bigbird": ("BigBirdSparsityConfig",
                dict(num_random_blocks=3, num_sliding_window_blocks=3,
                     num_global_blocks=2, different_layout_per_head=True,
                     seed=7)),
    "longformer": ("BSLongformerSparsityConfig",
                   dict(num_sliding_window_blocks=3,
                        global_block_indices=(0, 3))),
}


def _table_layout(name, block, causal, nb=16, heads=2):
    cls, kw = TABLE_CONFIGS[name]
    kw = dict(kw, num_heads=heads, block=block)
    if causal and name != "dense":
        kw["attention"] = "unidirectional"
    layout = getattr(port_sa, cls)(**kw).make_layout(nb * block)
    if causal and name == "dense":
        layout = layout & np.tril(np.ones((nb, nb), bool))[None]
    return layout


def _covered(groups, keys, block):
    """Count of each (head, 16-row unit, k block) the tables make a warp
    compute: [H, S / 16, nk] ints."""
    H = groups[:, 0].max() + 1
    count = {}
    for h, off, n, *rows in groups[:, :7].tolist():
        for e in keys[off:off + n].tolist():
            kb, mask = e & 0xFFFFFF, e >> 24
            for w, r0 in enumerate(rows):
                if mask >> w & 1:
                    assert r0 >= 0 and r0 % 16 == 0
                    unit = (h, r0 // 16, kb)
                    count[unit] = count.get(unit, 0) + 1
    return H, count


@pytest.mark.parametrize("causal", [False, True], ids=["bidir", "causal"])
@pytest.mark.parametrize("block", [16, 32, 64, 128])
@pytest.mark.parametrize("name", sorted(TABLE_CONFIGS))
def test_row_groups_cover_the_live_pairs_once(name, block, causal):
    """The host-built row groups of the tensor-core kernel: every live
    (q block, k block) pair is computed for each 16-row unit of the q
    block exactly once, no dead pair is, every query row belongs to one
    warp of one group, and each key list ascends."""
    layout = _table_layout(name, block, causal)
    H, nb = layout.shape[0], layout.shape[1]
    groups, keys = port_bs.row_group_tables(layout, H, block)
    assert groups.dtype == keys.dtype == np.int32 and groups.shape[1] == 8
    _, count = _covered(groups, keys, block)
    units = block // 16
    want = {(h, qb * units + u, kb): 1
            for h, qb, kb in zip(*np.nonzero(layout)) for u in range(units)}
    assert count == want
    rows = groups[:, 3:7][groups[:, 3:7] >= 0]
    np.testing.assert_array_equal(np.sort(rows // 16 % (nb * units)),
                                  np.repeat(np.arange(nb * units), H))
    for h, off, n in groups[:, :3].tolist():
        kbs = keys[off:off + n] & 0xFFFFFF
        assert (np.diff(kbs) > 0).all()
    lengths = groups[:, 2]
    assert (np.diff(lengths) <= 0).all()            # longest list first
    assert port_bs.row_group_tables(layout.copy(), H, block)[0] is groups


def test_row_groups_share_keys_and_split_where_they_do_not():
    """At block 16 the "fixed" layout's local windows are one group of 4
    q blocks each (one list serves 64 rows), causal too; BigBird's random
    blocks make the union more than twice a member's list, so its groups
    are split into one q block each."""
    for causal in (False, True):
        layout = _table_layout("fixed", 16, causal, nb=32, heads=1)
        groups, _ = port_bs.row_group_tables(layout, 1, 16)
        assert len(groups) == 32 // 4 and (groups[:, 3:7] >= 0).all()
    layout = _table_layout("bigbird", 16, False, nb=32, heads=1)
    groups, _ = port_bs.row_group_tables(layout, 1, 16)
    assert len(groups) > 32 // 4
    assert ((groups[:, 4:7] < 0).all(axis=1)).any()


# ------------------------- the tensor-core kernel's arithmetic, emulated
LOG2E = 1.4426950408889634


def _round(x, dtype):
    return x.to(dtype).float()


def _emulate_tc_kernel(q, k, v, layout, block, causal, dtype, split):
    """The bf16/fp16 kernel step by step on fp32 tensors [B, S, H, D]
    holding ``dtype`` values: its row groups and 64-key passes, fp32
    scores, exponentials of (s - m) * log2 e, and P fed to P V as hi + lo
    of P * kP (``split``) or rounded once, each rounded to ``dtype``; the
    output rounded once to ``dtype``."""
    B, S, H, D = q.shape
    scale = D ** -0.5
    kp = 2.0 ** 15 if dtype == torch.float16 else 1.0
    groups, keys = port_bs.row_group_tables(layout, H, block)
    out = torch.zeros(B, S, H, D)
    for h, off, n, *rows in groups[:, :7].tolist():
        entries = keys[off:off + n].tolist()
        krow = [(e & 0xFFFFFF) * block + t for e in entries
                for t in range(block)]
        kbit = [e >> 24 for e in entries for _ in range(block)]
        for w, r0 in enumerate(rows):
            if r0 < 0:
                continue
            qw = q[:, r0:r0 + 16, h]                        # [B, 16, D]
            m = torch.full((B, 16), float("-inf"))
            l = torch.zeros(B, 16)
            acc = torch.zeros(B, 16, D)
            for p0 in range(0, len(krow), 64):
                cols = krow[p0:p0 + 64]
                see = torch.tensor([b >> w & 1 for b in kbit[p0:p0 + 64]],
                                   dtype=torch.bool)
                if not see.any():
                    continue
                kw, vw = k[:, cols, h], v[:, cols, h]
                s = (qw @ kw.transpose(1, 2)) * scale
                mask = see[None, None, :].expand_as(s)
                if causal:
                    qpos = torch.arange(r0, r0 + 16)[:, None]
                    mask = mask & (qpos >= torch.tensor(cols)[None, :])
                s = torch.where(mask, s, float("-inf"))
                m_new = torch.maximum(m, s.amax(-1))
                msafe = torch.where(m_new == float("-inf"), 0.0, m_new)
                alpha = torch.where(m == float("-inf"), 0.0,
                                    torch.exp2((m - msafe) * LOG2E))
                pr = torch.exp2((s - msafe[..., None]) * LOG2E) * kp
                l = alpha * l + pr.sum(-1) / kp
                hi = _round(pr, dtype)
                pv = hi @ vw
                if split:
                    pv = (_round(pr - hi, dtype) @ vw) + pv
                acc = acc * alpha[..., None] + pv
                m = m_new
            den = torch.where(l == 0.0, 1.0, l) * kp
            out[:, r0:r0 + 16, h] = acc / den[..., None]
    return out.to(dtype)


def _worst_over_tol(got, ref, dtype):
    rtol = 2.0 ** -10 if dtype == torch.float16 else 2.0 ** -7
    diff = (got.float() - ref.float()).abs()
    return (diff / (rtol * ref.float().abs() + 1e-4)).max().item()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
@pytest.mark.parametrize("name,block,causal", [
    ("fixed", 16, False), ("fixed", 16, True), ("bigbird", 16, False),
    ("bigbird", 64, False), ("fixed", 32, True)])
def test_tc_kernel_p_rounding_holds_the_card_tolerance(name, block, causal,
                                                       dtype):
    """The kernel's arithmetic, emulated on the CPU with P fed as hi + lo,
    holds the card's tolerance (2^-7·|ref| + 1e-4 in bf16, 2^-10·|ref| +
    1e-4 in fp16) against JAX's Pallas kernel in interpret mode on the same
    inputs; in bf16, P rounded once does not (fp16's 11 bits pass in some
    cases, fail in others: the ratio is printed)."""
    nb = 8 if block == 64 else 16
    layout = _table_layout(name, block, causal, nb=nb, heads=2)
    B, S, H, D = 1, nb * block, 2, 64
    rng = np.random.default_rng(block + 2 * causal + len(name))
    q, k, v = (torch.from_numpy(rng.standard_normal((B, S, H, D))
                                .astype(np.float32)).to(dtype).float()
               for _ in range(3))
    want = jax_bs_flash(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                        layout, block, causal=causal)
    ref = torch.from_numpy(np.array(want)).to(dtype)
    split = _emulate_tc_kernel(q, k, v, layout, block, causal, dtype, True)
    once = _emulate_tc_kernel(q, k, v, layout, block, causal, dtype, False)
    worst_split = _worst_over_tol(split, ref, dtype)
    worst_once = _worst_over_tol(once, ref, dtype)
    print(f"{name} block {block} causal={causal} {dtype}: worst |err|/tol "
          f"hi + lo {worst_split:.3f}, once {worst_once:.3f}")
    assert worst_split <= 1.0, worst_split
    if dtype == torch.bfloat16:
        assert worst_once > 1.0, worst_once
