"""The port's Adam step (kernel B2's plain version, on the CPU) against the
JAX package: the multi-tensor step over one flat buffer against the Pallas
``fused_adam_step`` (interpret mode) leaf by leaf, and ``ops.adam``'s
``FusedAdam`` against JAX ``fused_adam`` over 5 updates with a schedule and
an ``lr_override``.

Tolerances: fp32 state rtol 1e-6, atol 1e-7 (the same fp32 operations in
the same order; XLA may fuse a product into an FMA and forms ``b**count``
with its own pow); the bf16 parameter copy one bf16 ulp (2^-8 relative),
since a master that differs in its last fp32 bit can round the other way.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.adam import fused_adam as jax_fused_adam
from deepspeed_tpu.ops.pallas.optimizers import \
    fused_adam_step as pallas_adam_step
from deepspeed_tpu.runtime.lr_schedules import WarmupLR as JaxWarmupLR
from deepspeed_tpu_torch.ops.adam import FusedAdam
from deepspeed_tpu_torch.ops.kernels.optimizers import (fused_adam_step,
                                                        fused_adam_step_plain)
from deepspeed_tpu_torch.runtime.lr_schedules import WarmupLR

SHAPES = [(33, 17), (7, ), (5, 3, 2), (130, )]   # deliberately unaligned
FP32 = dict(rtol=1e-6, atol=1e-7)


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


def _state(seed):
    rng = np.random.default_rng(seed)
    g = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    p = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    m = [0.1 * rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    v = [0.01 * np.abs(rng.standard_normal(s)).astype(np.float32)
         for s in SHAPES]
    return g, p, m, v


@pytest.mark.parametrize("adam_w_mode,count,bias_correction,grad_bf16", [
    (True, 1, True, False), (True, 3, True, False), (False, 3, True, False),
    (True, 3, False, False), (False, 1, True, True), (True, 2, True, "fp16")],
    ids=["adamw-1", "adamw-3", "l2-3", "no-bias-correction", "l2-bf16-grad",
         "adamw-fp16-grad-and-copy"])
def test_flat_step_matches_pallas_per_leaf(adam_w_mode, count,
                                           bias_correction, grad_bf16):
    """``grad_bf16="fp16"``: an fp16 gradient and an fp16 parameter copy."""
    g, p, m, v = _state(count + 10 * adam_w_mode)
    hyper = dict(lr=1e-2, beta1=0.9, beta2=0.999, eps=1e-8,
                 weight_decay=0.01, count=count, adam_w_mode=adam_w_mode,
                 bias_correction=bias_correction)
    bufs = [_flat(x)[0] for x in (g, p, m, v)]
    offs = _flat(g)[1]
    low = (torch.float16, jnp.float16, 2**-11) if grad_bf16 == "fp16" else \
        (torch.bfloat16, jnp.bfloat16, 2**-8)
    gt, pt, mt, vt = (torch.from_numpy(b.copy()) for b in bufs)
    if grad_bf16:
        gt = gt.to(low[0])
    out = torch.zeros(pt.numel(), dtype=low[0])
    fused_adam_step(gt, pt, mt, vt, out, **hyper)
    for i, (o, n) in enumerate(offs):
        gj = jnp.asarray(g[i])
        if grad_bf16:
            gj = gj.astype(low[1])
        bf, pw, mw, vw = pallas_adam_step(
            gj, jnp.asarray(p[i]), jnp.asarray(m[i]), jnp.asarray(v[i]),
            out_dtype=low[1], **hyper)
        shape = SHAPES[i]
        np.testing.assert_allclose(pt[o:o + n].view(shape), pw, **FP32)
        np.testing.assert_allclose(mt[o:o + n].view(shape), mw, **FP32)
        np.testing.assert_allclose(vt[o:o + n].view(shape), vw, **FP32)
        np.testing.assert_allclose(out[o:o + n].view(shape).float(),
                                   np.asarray(bf, np.float32), rtol=low[2],
                                   atol=0)
    # the padding between leaves stays zero (a fixed point of the update)
    pad = np.ones(pt.numel(), bool)
    for o, n in offs:
        pad[o:o + n] = False
    assert not pt.numpy()[pad].any() and not mt.numpy()[pad].any()


def test_plain_per_leaf_equals_flat():
    g, p, m, v = _state(5)
    hyper = dict(lr=3e-3, beta1=0.9, beta2=0.95, eps=1e-6, weight_decay=0.1,
                 count=2, grad_scale=torch.tensor(0.5))
    flat = [torch.from_numpy(_flat(x)[0]) for x in (g, p, m, v)]
    offs = _flat(g)[1]
    leaves = [[torch.from_numpy(a.copy()) for a in x] for x in (g, p, m, v)]
    fused_adam_step(*flat, **hyper)
    fused_adam_step_plain(*leaves, **hyper)
    for (o, n), pl in zip(offs, leaves[1]):
        assert torch.equal(flat[1][o:o + n], pl.reshape(-1))


def test_wrapper_checks_buffers():
    x = torch.zeros(8)
    with pytest.raises(ValueError, match="flat buffer"):
        fused_adam_step(x, x.view(2, 4), x, x, lr=1e-3, beta1=0.9,
                        beta2=0.999, eps=1e-8, weight_decay=0.0, count=1)


def test_fused_adam_matches_jax_over_five_updates():
    """WarmupLR schedule evaluated at the 1-based count, an lr_override
    written before update 3 and cleared (NaN) before update 5."""
    rng = np.random.default_rng(0)
    params = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in SHAPES]
             for _ in range(5)]
    sched = dict(warmup_min_lr=0.0, warmup_max_lr=1e-2, warmup_num_steps=4)
    kw = dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=0.05)

    jtr = jax_fused_adam(lr=1e-3, lr_fn=JaxWarmupLR(**sched).get_lr, **kw)
    jp = [jnp.asarray(x) for x in params]
    jstate = jtr.init(jp)

    ptr = FusedAdam(lr=1e-3, lr_fn=WarmupLR(**sched).get_lr, **kw)
    buf, offs = _flat(params)
    target = torch.from_numpy(buf)
    pstate = ptr.init(target)
    for step, gs in enumerate(grads, start=1):
        if step == 3:
            jstate = jstate._replace(lr_override=jnp.float32(2e-3))
            pstate.lr_override = 2e-3
        if step == 5:
            jstate = jstate._replace(lr_override=jnp.float32(np.nan))
            pstate.lr_override = float("nan")
        upd, jstate = jtr.update([jnp.asarray(g) for g in gs], jstate, jp)
        jp = [p + u for p, u in zip(jp, upd)]
        ptr.step(torch.from_numpy(_flat(gs)[0]), pstate, target)
    assert pstate.count == int(jstate.count) == 5
    for (o, n), want, shape in zip(offs, jp, SHAPES):
        np.testing.assert_allclose(target[o:o + n].view(shape), want,
                                   rtol=1e-6, atol=1e-6)
