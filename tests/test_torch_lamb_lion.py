"""The port's LAMB, Lion and SGD (kernels B3 and B8's plain versions, on
the CPU) against the JAX package: the flat multi-leaf steps against the
Pallas ``fused_lamb_step`` / ``fused_lion_step`` (interpret mode) leaf by
leaf, and ``ops.lamb``'s ``FusedLamb`` / ``ops.lion``'s ``FusedLion`` and
``sgd`` against JAX ``fused_lamb`` / ``fused_lion`` / ``sgd`` over 5
updates with a schedule and an ``lr_override``.

Tolerances: fp32 state rtol 1e-6, atol 1e-6 (the same fp32 operations;
XLA may fuse a product into an FMA, forms ``b**count`` with its own pow and
sums the LAMB norms in another order); the low-precision parameter copy one
ulp of its type (2^-8 relative for bf16, 2^-11 for fp16), since a master
that differs in its last fp32 bit can round the other way.  The LAMB
transforms are compared with betas exact in fp32: JAX ``fused_lamb`` forms
``1 - beta`` from the Python float in float64 and rounds it once, the
kernels (the Pallas ones too) subtract the fp32 beta from 1 in fp32; for
beta2 = 0.999 the two differ by 1.3e-5 relative, which a trust ratio of 10
lifts above 1e-6 in the master within five updates.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.lamb import fused_lamb as jax_fused_lamb
from deepspeed_tpu.ops.lion import fused_lion as jax_fused_lion
from deepspeed_tpu.ops.lion import sgd as jax_sgd
from deepspeed_tpu.ops.pallas.optimizers import \
    fused_lamb_step as pallas_lamb_step
from deepspeed_tpu.ops.pallas.optimizers import \
    fused_lion_step as pallas_lion_step
from deepspeed_tpu.runtime.lr_schedules import WarmupLR as JaxWarmupLR
from deepspeed_tpu_torch.ops.kernels import optimizers as opt
from deepspeed_tpu_torch.ops.lamb import FusedLamb
from deepspeed_tpu_torch.ops.lion import FusedLion, sgd
from deepspeed_tpu_torch.runtime.lr_schedules import WarmupLR

SHAPES = [(33, 17), (7, ), (5, 3, 2), (130, )]   # deliberately unaligned
FP32 = dict(rtol=1e-6, atol=1e-6)
GRAD_DTYPES = {"fp32": (torch.float32, jnp.float32),
               "bf16": (torch.bfloat16, jnp.bfloat16),
               "fp16": (torch.float16, jnp.float16)}
OUT_DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16, 2.0**-8),
              "fp16": (torch.float16, jnp.float16, 2.0**-11)}


def _flat(arrays, align=16):
    """Leaves packed into one zero-padded flat buffer; returns the buffer
    and each leaf's (offset, numel)."""
    offs, off = [], 0
    for a in arrays:
        offs.append((off, a.size))
        off += -(-a.size // align) * align
    buf = np.zeros(off, np.float32)
    for a, (o, n) in zip(arrays, offs):
        buf[o:o + n] = a.ravel()
    return buf, offs


def _state(seed, shapes=SHAPES):
    rng = np.random.default_rng(seed)
    g = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    p = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    m = [0.1 * rng.standard_normal(s).astype(np.float32) for s in shapes]
    v = [0.01 * np.abs(rng.standard_normal(s)).astype(np.float32)
         for s in shapes]
    return g, p, m, v


def _pad_is_zero(buf, offs):
    pad = np.ones(buf.numel(), bool)
    for o, n in offs:
        pad[o:o + n] = False
    return not buf.float().numpy()[pad].any()


@pytest.mark.parametrize("grad", sorted(GRAD_DTYPES))
@pytest.mark.parametrize("out", sorted(OUT_DTYPES))
@pytest.mark.parametrize("count", [1, 4])
def test_flat_lamb_matches_pallas_per_leaf(grad, out, count):
    g, p, m, v = _state(count + 7 * len(grad))
    hyper = dict(lr=1e-2, beta1=0.9, beta2=0.999, eps=1e-6,
                 weight_decay=0.01, count=count, max_coeff=10.0,
                 min_coeff=0.01)
    (gt, pt, mt, vt), offs = [torch.from_numpy(_flat(x)[0]) for x in
                              (g, p, m, v)], _flat(g)[1]
    gt = gt.to(GRAD_DTYPES[grad][0])
    out_t, out_j, ulp = OUT_DTYPES[out]
    po = torch.zeros(pt.numel(), dtype=out_t)
    table = opt.LambTable(offs)
    stats = opt.fused_lamb_step(gt, pt, mt, vt, torch.zeros_like(pt), po,
                                table=table, **hyper)
    assert stats.shape == (len(SHAPES), 3)
    for i, (o, n) in enumerate(offs):
        gj = jnp.asarray(g[i]).astype(GRAD_DTYPES[grad][1])
        bf, pw, mw, vw = pallas_lamb_step(
            gj, jnp.asarray(p[i]), jnp.asarray(m[i]), jnp.asarray(v[i]),
            out_dtype=out_j, **hyper)
        shape = SHAPES[i]
        np.testing.assert_allclose(pt[o:o + n].view(shape), pw, **FP32)
        np.testing.assert_allclose(mt[o:o + n].view(shape), mw, **FP32)
        np.testing.assert_allclose(vt[o:o + n].view(shape), vw, **FP32)
        np.testing.assert_allclose(po[o:o + n].view(shape).float(),
                                   np.asarray(bf, np.float32), rtol=ulp,
                                   atol=0)
        np.testing.assert_allclose(stats[i, 0], np.sum(p[i] * p[i]),
                                   rtol=1e-6)
    assert _pad_is_zero(pt, offs) and _pad_is_zero(mt, offs)


@pytest.mark.parametrize("grad", sorted(GRAD_DTYPES))
@pytest.mark.parametrize("out", sorted(OUT_DTYPES))
def test_flat_lion_matches_pallas_per_leaf(grad, out):
    g, p, m, _ = _state(3 + len(grad) + len(out))
    hyper = dict(lr=1e-3, beta1=0.9, beta2=0.99, weight_decay=0.1)
    (gt, pt, mt), offs = [torch.from_numpy(_flat(x)[0]) for x in
                          (g, p, m)], _flat(g)[1]
    gt = gt.to(GRAD_DTYPES[grad][0])
    out_t, out_j, ulp = OUT_DTYPES[out]
    po = torch.zeros(pt.numel(), dtype=out_t)
    opt.fused_lion_step(gt, pt, mt, po, **hyper)
    for i, (o, n) in enumerate(offs):
        gj = jnp.asarray(g[i]).astype(GRAD_DTYPES[grad][1])
        bf, pw, mw = pallas_lion_step(gj, jnp.asarray(p[i]),
                                      jnp.asarray(m[i]), out_dtype=out_j,
                                      **hyper)
        shape = SHAPES[i]
        np.testing.assert_allclose(pt[o:o + n].view(shape), pw, **FP32)
        np.testing.assert_allclose(mt[o:o + n].view(shape), mw, **FP32)
        np.testing.assert_allclose(po[o:o + n].view(shape).float(),
                                   np.asarray(bf, np.float32), rtol=ulp,
                                   atol=0)
    assert _pad_is_zero(pt, offs) and _pad_is_zero(mt, offs)


def test_lamb_table_cuts_leaves_into_chunks():
    leaves = [(0, 10), (16, 0), (16, 33), (64, 8)]
    table = opt.LambTable(leaves, chunk=8)
    rows = table.rows.tolist()
    assert table.n_chunks == len(rows) == 2 + 0 + 5 + 1
    assert table.leaf_chunks.tolist() == [0, 2, 2, 7, 8]
    for leaf, (off, n) in enumerate(leaves):
        mine = rows[table.leaf_chunks[leaf]:table.leaf_chunks[leaf + 1]]
        assert all(r[2] == leaf and r[0] % 4 == 0 and 0 < r[1] <= 8
                   for r in mine)
        covered = [i for s, k, _ in mine for i in range(s, s + k)]
        assert covered == list(range(off, off + n))
    with pytest.raises(ValueError, match="multiple of 4"):
        opt.LambTable([(2, 8)])


def test_lamb_plain_phases_and_wrappers():
    """The one-call plain step equals its two phases; the per-phase kernel
    wrappers refuse CPU buffers; a gradient scale multiplies the gradient
    before everything else."""
    g, p, m, v = _state(9)
    buf = [torch.from_numpy(_flat(x)[0]) for x in (g, p, m, v)]
    offs = _flat(g)[1]
    table = opt.LambTable(offs)
    hyper = dict(beta1=0.9, beta2=0.99, eps=1e-8, weight_decay=0.0, count=2)
    a = [t.clone() for t in buf]
    stats = opt.fused_lamb_step(a[0], *a[1:], torch.zeros_like(a[1]),
                                table=table, lr=1e-3,
                                grad_scale=torch.tensor(0.5), **hyper)
    b = [t.clone() for t in buf]
    b[0] = b[0] * 0.5
    u = torch.zeros_like(b[1])
    views = table.views
    sums = opt.fused_lamb_phase1_plain(views(b[0]), views(b[1]), views(b[2]),
                                       views(b[3]), views(u), **hyper)
    ratios = opt.fused_lamb_phase2_plain(views(b[1]), views(u), None, sums,
                                         lr=1e-3)
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
    assert torch.equal(stats[:, :2], sums) and torch.equal(stats[:, 2],
                                                           ratios)
    with pytest.raises(ValueError, match="CUDA"):
        opt.fused_lamb_phase1(*buf, u, table, **hyper)
    with pytest.raises(ValueError, match="flat buffer"):
        opt.fused_lion_step(buf[0], buf[1].view(-1, 16), buf[2], lr=1e-3,
                            beta1=0.9, beta2=0.99, weight_decay=0.0)


def _lamb_tree(seed):
    """Leaves whose trust ratio clips at max_coeff (large weights), at
    min_coeff (tiny weights), is 1 (a zero leaf) or lies in between."""
    rng = np.random.default_rng(seed)
    shapes = [(33, 17), (40, ), (5, 3, 2), (130, ), (9, 4)]
    params = [rng.standard_normal(shapes[0]).astype(np.float32),
              (100.0 * rng.standard_normal(shapes[1])).astype(np.float32),
              (1e-4 * rng.standard_normal(shapes[2])).astype(np.float32),
              np.zeros(shapes[3], np.float32),
              (0.3 * rng.standard_normal(shapes[4])).astype(np.float32)]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(5)]
    return shapes, params, grads


EXACT_BETAS = (0.875, 0.9921875)      # 1 - 2^-3, 1 - 2^-7
OPTIMIZERS = {
    "lamb": (lambda lr_fn: jax_fused_lamb(lr=1e-3, betas=EXACT_BETAS,
                                          eps=1e-6, weight_decay=0.01,
                                          lr_fn=lr_fn),
             lambda lr_fn: FusedLamb(lr=1e-3, betas=EXACT_BETAS, eps=1e-6,
                                     weight_decay=0.01, lr_fn=lr_fn)),
    "lamb_no_bias_correction": (
        lambda lr_fn: jax_fused_lamb(lr=1e-3, betas=EXACT_BETAS,
                                     bias_correction=False, max_coeff=5.0,
                                     min_coeff=0.1, lr_fn=lr_fn),
        lambda lr_fn: FusedLamb(lr=1e-3, betas=EXACT_BETAS,
                                bias_correction=False, max_coeff=5.0,
                                min_coeff=0.1, lr_fn=lr_fn)),
    "lion": (lambda lr_fn: jax_fused_lion(lr=1e-3, betas=(0.9, 0.99),
                                          weight_decay=0.1, lr_fn=lr_fn),
             lambda lr_fn: FusedLion(lr=1e-3, betas=(0.9, 0.99),
                                     weight_decay=0.1, lr_fn=lr_fn)),
    "sgd": (lambda lr_fn: jax_sgd(lr=1e-3, lr_fn=lr_fn),
            lambda lr_fn: sgd(lr=1e-3, lr_fn=lr_fn)),
    "sgd_momentum_wd": (
        lambda lr_fn: jax_sgd(lr=1e-3, momentum=0.9, weight_decay=0.05,
                              lr_fn=lr_fn),
        lambda lr_fn: sgd(lr=1e-3, momentum=0.9, weight_decay=0.05,
                          lr_fn=lr_fn)),
    "sgd_nesterov": (
        lambda lr_fn: jax_sgd(lr=1e-3, momentum=0.9, nesterov=True,
                              lr_fn=lr_fn),
        lambda lr_fn: sgd(lr=1e-3, momentum=0.9, nesterov=True,
                          lr_fn=lr_fn)),
}


@pytest.mark.parametrize("case", sorted(OPTIMIZERS))
@pytest.mark.parametrize("use_kernel", [True, False],
                         ids=["wrapper", "plain"])
def test_transform_matches_jax_over_five_updates(case, use_kernel):
    """WarmupLR schedule evaluated at the 1-based count, an lr_override
    written before update 3 and cleared (NaN) before update 5; for LAMB the
    leaves clip the ratio at both ends and one is all zeros."""
    shapes, params, grads = _lamb_tree(len(case))
    sched = dict(warmup_min_lr=0.0, warmup_max_lr=1e-2, warmup_num_steps=4)
    make_jax, make_port = OPTIMIZERS[case]
    jtr = make_jax(JaxWarmupLR(**sched).get_lr)
    jp = [jnp.asarray(x) for x in params]
    jstate = jtr.init(jp)
    ptr = make_port(WarmupLR(**sched).get_lr)
    buf, offs = _flat(params)
    target = torch.from_numpy(buf)
    pstate = ptr.init(target, offs)
    for step, gs in enumerate(grads, start=1):
        if step == 3:
            jstate = jstate._replace(lr_override=jnp.float32(2e-3))
            pstate.lr_override = 2e-3
        if step == 5:
            jstate = jstate._replace(lr_override=jnp.float32(np.nan))
            pstate.lr_override = float("nan")
        upd, jstate = jtr.update([jnp.asarray(g) for g in gs], jstate, jp)
        jp = [p + u for p, u in zip(jp, upd)]
        ptr.step(torch.from_numpy(_flat(gs)[0]), pstate, target,
                 use_kernel=use_kernel)
    assert pstate.count == int(jstate.count) == 5
    for (o, n), want, shape in zip(offs, jp, shapes):
        np.testing.assert_allclose(target[o:o + n].view(shape), want,
                                   **FP32)
    assert _pad_is_zero(target, offs)


def test_lamb_ratios_clip_as_jax_does():
    """The leaves of the LAMB case do reach both clip bounds and the zero
    rule: the wrapper's ratios of the first update are [in range, 10, 0.01,
    1, in range]."""
    shapes, params, grads = _lamb_tree(0)
    buf, offs = _flat(params)
    target = torch.from_numpy(buf)
    ptr = FusedLamb(lr=1e-3, eps=1e-6)
    state = ptr.init(target, offs)
    stats = ptr.step(torch.from_numpy(_flat(grads[0])[0]), state, target)
    r = stats[:, 2].tolist()
    assert r[1] == 10.0 and r[2] == pytest.approx(0.01) and r[3] == 1.0
    assert 0.01 < r[0] < 10.0 and 0.01 < r[4] < 10.0
