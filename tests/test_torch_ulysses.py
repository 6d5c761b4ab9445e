"""Ulysses sequence parallelism of the port (``sequence/layer.py``, the sp
axis of ``utils/groups.py`` and the base engine) against the JAX package
on the 8-device CPU mesh, fp32, inputs and weights from numpy seeds.

* ``DistributedAttention`` at sp = 2 (two gloo processes, rank r holding
  the r-th half of the sequence) against JAX's on an sp-2 mesh of two
  devices: the output and the gradients of ``sum(out ** 2)`` at 1e-5, for
  causal, non-causal, GQA with kv 1 (the routed reshard) and kv = sp (the
  all-to-all and the local repeat), and uneven heads (H 3 over sp 2: q
  padded, kv routed);
* sp = 1 is the local attention; an invalid GQA ratio raises;
* the base engine at dp 1 × sp 2 on ``gpt2_tiny(use_ulysses=True)`` and
  on a GQA ``llama_tiny(use_ulysses=True)`` with a loss mask against the
  JAX engine on the same mesh and the same global batches: losses at
  1e-5, the final master at 1e-5 relative plus lr/20 absolute, the rule
  of ``test_torch_zero.py`` (Adam's normalized update moves an element
  whose gradient is rounding noise by up to lr: one element in a few
  thousand is 1.3-3 % of lr apart here; GPT-2's key biases, whose
  gradient is 0 up to rounding, left out).  The shifted loss crosses the
  ranks' chunks; RoPE and ``wpe`` run at the chunks' global positions;
* the config keys and refusals: ``sequence_parallel_size``/``mesh.sp``/
  ``mesh_param`` parse; GPT-2 has no ring backend, and the ring refuses a
  sliding window.

Every multi-process leg runs in ONE spawn of the two processes.
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu.comm as jax_dist
from deepspeed_tpu.models import gpt2 as jax_gpt2
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu.sequence.layer import DistributedAttention as JaxDA
from deepspeed_tpu.sequence.layer import _default_attention
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch.models import gpt2 as port_gpt2
from deepspeed_tpu_torch.models import llama as port_llama
from deepspeed_tpu_torch.sequence.layer import DistributedAttention
from test_torch_gpt2_training import _flax_tree as gpt2_tree
from test_torch_llama_training import _flax_tree as llama_tree
from torch_dist_worker import spawn

SP, SEQ, ROWS, LR = 2, 16, 2, 2e-3
# (name, H, kv heads, causal)
ATTN = [("causal", 4, 4, True), ("noncausal", 4, 4, False),
        ("gqa_kv1", 4, 1, True), ("gqa_kv_sp", 4, 2, True),
        ("uneven_h3", 3, 3, True), ("uneven_h3_kv1", 3, 1, True)]
GPT2 = dict(dtype="float32", remat=False, use_ulysses=True)
LLAMA = dict(dtype="float32", remat=False, use_ulysses=True,
             num_key_value_heads=2)


def _qkv(H, kv, seed, B=2, S=SEQ, D=16):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, S, H, D), (B, S, kv, D), (B, S, kv, D)))


def _config():
    return {"train_micro_batch_size_per_gpu": ROWS,
            "optimizer": {"type": "fusedadam", "params": {"lr": LR}},
            "zero_optimization": {"stage": 1},
            "sequence_parallel_size": SP}


def _batches(n, seed, mask=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, 256, size=(ROWS, SEQ)).astype(np.int32)
        if not mask:
            out.append((ids, ids))
            continue
        m = (rng.random((ROWS, SEQ)) < 0.6).astype(np.int32)
        m[:, :2] = 1
        out.append((ids, ids, m))
    return out


def _legs():
    legs = {}
    for i, (name, H, kv, causal) in enumerate(ATTN):
        q, k, v = _qkv(H, kv, seed=10 + i)
        legs[f"attn_{name}"] = dict(kind="ulysses", q=q, k=k, v=v,
                                    causal=causal)
    legs["gpt2_sp2"] = dict(
        kind="train", model="gpt2", cfg=GPT2, tree=gpt2_tree(7),
        config=_config(), batches=_batches(3, 21))
    legs["llama_gqa_sp2"] = dict(
        kind="train", model="llama", cfg=LLAMA,
        tree=llama_tree(jax_llama.llama_tiny(**dict(LLAMA)), seed=8),
        config=_config(), batches=_batches(3, 22, mask=True))
    return legs


def _jax_mesh():
    groups.reset_mesh()
    groups.initialize_mesh(dp=1, sp=SP, devices=jax.devices()[:SP])


def _jax_attention(leg):
    _jax_mesh()
    try:
        attn = JaxDA()
        q, k, v = (jnp.asarray(leg[x]) for x in "qkv")

        def loss(q, k, v):
            return jnp.sum(attn(q, k, v, causal=leg["causal"]) ** 2)

        out = attn(q, k, v, causal=leg["causal"])
        grads = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
        return dict(out=np.asarray(out),
                    **{f"d{x}": np.asarray(g) for x, g in zip("qkv", grads)})
    finally:
        groups.reset_mesh()


def _jax_train(leg):
    _jax_mesh()
    try:
        model = (jax_gpt2.GPT2Model(jax_gpt2.gpt2_tiny(**leg["cfg"]))
                 if leg["model"] == "gpt2" else
                 jax_llama.LlamaModel(jax_llama.llama_tiny(**leg["cfg"])))
        eng = deepspeed_tpu.initialize(
            model=model, model_parameters=jax.tree_util.tree_map(
                jnp.asarray, leg["tree"]), config=dict(leg["config"]))[0]
        assert eng.seq_parallel_world_size == SP
        losses = []
        for batch in leg["batches"]:
            loss = eng(*eng.shard_batch(*batch))
            eng.backward(loss)
            eng.step()
            losses.append(float(loss))
        master = jax.tree_util.tree_map(np.asarray, eng.get_fp32_param())
        return dict(losses=losses, master=master)
    finally:
        groups.reset_mesh()
        jax_dist.destroy_process_group()
        gc.collect()   # the engine's cycles: no JAX garbage for later tests


def _port_master(leg, flat, names):
    got = {n: flat[o:o + k].reshape(s) for n, o, k, s in names}
    if leg["model"] == "gpt2":
        want = port_gpt2.params_from_flax
        cfg = port_gpt2.gpt2_tiny(**leg["cfg"])
    else:
        want = port_llama.params_from_flax
        cfg = port_llama.llama_tiny(**leg["cfg"])
    return got, lambda tree: {n: t.numpy() for n, t in
                              want(tree, cfg, dtype="float32").items()}


@pytest.fixture(scope="module")
def runs():
    legs = _legs()
    want = {n: (_jax_attention(leg) if leg["kind"] == "ulysses"
                else _jax_train(leg)) for n, leg in legs.items()}
    got = spawn(SP, [dict(leg, name=n) for n, leg in legs.items()],
                timeout=300)
    return {n: (want[n], got[n]) for n in legs}


@pytest.mark.parametrize("case", [a[0] for a in ATTN])
def test_distributed_attention_matches_jax(runs, case):
    want, got = runs[f"attn_{case}"]
    for key in ("out", "dq", "dk", "dv"):
        full = np.concatenate([r[key] for r in got], axis=1)
        np.testing.assert_allclose(full, want[key], rtol=1e-5, atol=1e-5,
                                   err_msg=key)


@pytest.mark.parametrize("leg", ["gpt2_sp2", "llama_gqa_sp2"])
def test_engine_dp1_sp2_matches_jax(runs, leg):
    want, got = runs[leg]
    for r in got:
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=1e-5)
    spec = _legs()[leg]
    port, convert = _port_master(spec, got[0]["master"], got[0]["names"])
    ref = convert(want["master"])
    assert set(port) == set(ref)
    for n in ref:
        if n.endswith("k_proj.bias"):
            continue
        np.testing.assert_allclose(port[n], ref[n], rtol=1e-5,
                                   atol=LR / 20, err_msg=n)
    # both sp ranks hold the same master (ZeRO 1 over dp × sp)
    np.testing.assert_array_equal(got[0]["master"], got[1]["master"])


def test_sp1_is_local_attention():
    """A group of one rank: kv repeated for GQA, then the local core
    (JAX's ``_align_gqa_local``)."""
    q, k, v = _qkv(4, 2, seed=3)
    from deepspeed_tpu_torch.comm import ProcessGroup
    local = ProcessGroup(("sp", ), local=True)
    out = DistributedAttention(sequence_process_group=local)(
        *(torch.from_numpy(a) for a in (q, k, v)))
    rep = lambda a: np.repeat(a, 2, axis=2)  # noqa: E731
    ref = _default_attention(jnp.asarray(q), jnp.asarray(rep(k)),
                             jnp.asarray(rep(v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def test_invalid_gqa_ratio_raises():
    with pytest.raises(ValueError, match="GQA"):
        DistributedAttention._check_gqa_heads(6, 4)
    DistributedAttention._check_gqa_heads(8, 4)
    q, k, v = (torch.from_numpy(a) for a in _qkv(6, 4, seed=1))
    with pytest.raises(ValueError, match="GQA"):
        DistributedAttention()._align_gqa_local(q, k, v)


def test_ring_backend_names_its_item():
    """The ring backend is Llama's (tests/test_torch_ring_attention.py):
    GPT-2 has Ulysses only, as in JAX, and the ring refuses a sliding
    window with JAX's NotImplementedError."""
    with pytest.raises(ValueError, match="Ulysses only"):
        port_gpt2.gpt2_tiny(dtype="float32", use_ulysses=True,
                            sp_backend="ring")
    model = port_llama.LlamaModel(port_llama.llama_tiny(
        dtype="float32", use_ulysses=True, sp_backend="ring",
        sliding_window=4), device="cpu")
    ids = torch.zeros(1, 8, dtype=torch.long)
    with pytest.raises(NotImplementedError, match="sliding_window"):
        model(ids, ids)


def test_sp_keys_parse_and_need_a_world():
    """``sequence_parallel_size``, ``mesh.sp`` and ``mesh_param=(dp, sp)``
    no longer raise at parse; at one rank sp = 2 has no world to split
    over."""
    from deepspeed_tpu_torch.runtime.config import (DeepSpeedConfig,
                                                    DeepSpeedConfigError)
    assert DeepSpeedConfig({"sequence_parallel_size": 2}).mesh_sp == 2
    assert DeepSpeedConfig({"mesh": {"sp": 4}}).mesh_sp == 4
    with pytest.raises(DeepSpeedConfigError, match="disagree"):
        DeepSpeedConfig({"mesh": {"sp": 4}, "sequence_parallel_size": 2})
    import deepspeed_tpu_torch
    cfg = port_gpt2.gpt2_tiny(dtype="float32", use_ulysses=True)
    for kw in (dict(config={"sequence_parallel_size": 2}),
               dict(config={}, mesh_param=(1, 2))):
        with pytest.raises(ValueError, match="sp=2"):
            deepspeed_tpu_torch.initialize(
                model=port_gpt2.GPT2Model(cfg, device="meta"),
                device="cpu", **kw)
