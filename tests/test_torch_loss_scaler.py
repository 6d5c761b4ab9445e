"""The port's loss scaling and fp16/guard config against the JAX package:
``DynamicLossScaler`` over a scripted overflow pattern gives the same scale,
growth tracker and hysteresis after every step (exactly: both keep the
scale in fp32 and it only ever doubles or halves), ``create_loss_scaler``
picks the same scaler, and the fp16 and ``resilience.check_finite_grads``
sections parse to the same derived fields, errors included."""

import jax.numpy as jnp
import numpy as np
import pytest

from deepspeed_tpu.runtime import loss_scaler as jax_scaler
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
from deepspeed_tpu_torch.runtime import loss_scaler as port_scaler
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig as PortConfig
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfigError


def _pattern(seed, n=60):
    """Runs of overflows and clean steps, long enough to shrink, grow and
    hit the floor."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        out += [True] * int(rng.integers(1, 5)) + \
            [False] * int(rng.integers(1, 9))
    return out[:n]


SCALERS = {
    "defaults": dict(),
    "hysteresis2": dict(delayed_shift=2),
    "hysteresis3_window3": dict(delayed_shift=3, scale_window=3),
    "window2_min4": dict(scale_window=2, min_scale=4.0, init_scale=2**6),
    "consecutive_hysteresis": dict(delayed_shift=2, scale_window=4,
                                   consecutive_hysteresis=True),
    "factor4_min_half": dict(scale_factor=4.0, scale_window=5,
                             min_scale=0.5, init_scale=2**4),
}


@pytest.mark.parametrize("case", sorted(SCALERS))
def test_dynamic_scaler_matches_jax(case):
    kw = SCALERS[case]
    js = jax_scaler.DynamicLossScaler(**kw)
    ps = port_scaler.DynamicLossScaler(**kw)
    jstate, pstate = js.init(), ps.init()
    seen = set()
    for i, overflow in enumerate(_pattern(len(case))):
        jstate = js.update(jstate, jnp.asarray(overflow))
        pstate = ps.update(pstate, overflow)
        assert (pstate.scale, pstate.growth_tracker, pstate.hysteresis) == (
            float(jstate.scale), int(jstate.growth_tracker),
            int(jstate.hysteresis)), (case, i)
        seen.add(pstate.scale)
    assert len(seen) > 2          # the pattern moved the scale both ways


def test_static_scaler_and_factory_match_jax():
    for args in [(False, ), (True, 128.0), (True, 0.0, {"init_scale": 2**8,
                                                          "delayed_shift": 2,
                                                          "scale_window": 7,
                                                          "min_scale": 2.0})]:
        j = jax_scaler.create_loss_scaler(*args)
        p = port_scaler.create_loss_scaler(*args)
        assert type(p).__name__ == type(j).__name__
        assert p.dynamic == j.dynamic
        assert p.init().scale == float(j.init().scale)
        assert p.init().hysteresis == int(j.init().hysteresis)
        if p.dynamic:
            assert (p.scale_window, p.min_scale, p.delayed_shift) == (
                j.scale_window, j.min_scale, j.delayed_shift)
        for overflow in (True, False):
            if not p.dynamic:
                assert p.update(p.init(), overflow) == p.init()
    from deepspeed_tpu_torch.runtime.fp16 import loss_scaler as fp16_ls
    assert fp16_ls.LossScaler is port_scaler.StaticLossScaler
    assert fp16_ls.DynamicLossScaler is port_scaler.DynamicLossScaler


FP16_CONFIGS = {
    "defaults": {"fp16": {"enabled": True}},
    "power32_window": {"fp16": {"enabled": True, "initial_scale_power": 32,
                                "loss_scale_window": 50, "hysteresis": 1,
                                "min_loss_scale": 2.0}},
    "static": {"fp16": {"enabled": True, "loss_scale": 512.0}},
    "disabled": {"fp16": {"enabled": False, "initial_scale_power": 8}},
    "guard": {"resilience": {"check_finite_grads": {
        "enabled": True, "max_consecutive_skips": 3,
        "grad_norm_spike_factor": 10.0, "spike_warmup_steps": 2}}},
    "fp16_and_bf16": {"fp16": {"enabled": True}, "bf16": {"enabled": True}},
    "negative_hysteresis": {"fp16": {"enabled": True, "hysteresis": 0}},
    "fp16_grad_accum": {"fp16": {"enabled": True},
                        "data_types": {"grad_accum_dtype": "fp16"}},
}


@pytest.mark.parametrize("case", sorted(FP16_CONFIGS))
def test_fp16_and_guard_config_match_jax(case):
    raw = {"train_micro_batch_size_per_gpu": 1, **FP16_CONFIGS[case]}
    try:
        want = JaxConfig(dict(raw))
    except Exception as e:                       # noqa: BLE001
        with pytest.raises(DeepSpeedConfigError):
            PortConfig(dict(raw))
        assert "fp16" in str(e) or "hysteresis" in str(e)
        return
    got = PortConfig(dict(raw))
    for key in ("fp16_enabled", "bfloat16_enabled", "loss_scale",
                "initial_dynamic_scale", "dynamic_loss_scale_args",
                "gradient_accumulation_dtype", "fp16_auto_cast"):
        assert getattr(got, key) == getattr(want, key), key
    jg = want.resilience_config.check_finite_grads
    pg = got.finite_grads_config
    for key in ("enabled", "max_consecutive_skips", "grad_norm_spike_factor",
                "spike_warmup_steps"):
        assert getattr(pg, key) == getattr(jg, key), key


def test_has_overflow_on_each_precision():
    import torch
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        g = torch.ones(5, dtype=dt)
        assert not bool(port_scaler.has_overflow([g]))
        g[2] = float("nan")
        assert bool(port_scaler.has_overflow([torch.ones(3), g]))
    big = torch.tensor([60000.0], dtype=torch.float16) * 2   # inf in fp16
    assert bool(port_scaler.has_overflow([big]))
