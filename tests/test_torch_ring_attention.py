"""Ring attention of the port (``sequence/ring_attention.py`` over
``sequence/blockwise.py``) against the JAX package on the 8-device CPU
mesh, fp32, inputs and weights from numpy seeds.

* ``ring_attention_local`` at sp 2 and 4, causal and not, on gloo ranks
  (rank r holding the r-th sequence block; at sp 2 the four ranks are two
  dp replicas) against JAX's ``ring_attention_local`` under ``shard_map``
  on sp devices (its ``test_ring_attention.py:_run_ring``): the output and
  the gradients of ``sum(out ** 2)`` at 2e-5 (the same fp32 arithmetic in
  another order: B1's plain version a pair, merged in fp32, where JAX
  folds an online softmax);
* GQA with one kv head at sp 4 (k/v circulate at their own width, JAX
  repeats them);
* the one-device ring (``ring_attention_blocks``: the exchange replaced
  by indexing) equal to the gloo ranks' at 1e-6;
* Llama with ``sp_backend="ring"`` through the engine at dp 1 × sp 4 against
  JAX's engine on an sp-4 mesh and against the port's Ulysses on the same
  batches: losses at 1e-5 (JAX's ``test_llama_ring_backend_matches_
  ulysses``), the final master at 1e-5 relative plus lr/20;
* sp = 1 is the local core; the pair cutting of a causal mask.

Every multi-process leg runs in ONE spawn of four processes.
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import deepspeed_tpu
import deepspeed_tpu.comm as jax_dist
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu.sequence import ring_attention_local as jax_ring
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch.comm import ProcessGroup
from deepspeed_tpu_torch.models import llama as port_llama
from deepspeed_tpu_torch.ops.kernels.flash_attention import \
    flash_attention_plain
from deepspeed_tpu_torch.sequence import RingAttention
from deepspeed_tpu_torch.sequence.blockwise import causal_pairs
from deepspeed_tpu_torch.sequence.ring_attention import ring_attention_blocks
from test_torch_llama_training import _flax_tree as llama_tree
from torch_dist_worker import spawn

WORLD, SEQ, ROWS, LR = 4, 32, 2, 2e-3
B, H, D = 2, 4, 8
# (name, sp, kv heads, causal)
ATTN = [("sp2_causal", 2, H, True), ("sp2_noncausal", 2, H, False),
        ("sp4_causal", 4, H, True), ("sp4_noncausal", 4, H, False),
        ("sp4_kv1", 4, 1, True)]
LLAMA = dict(dtype="float32", remat=False, use_ulysses=True,
             num_key_value_heads=2)


def _qkv(kv, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, SEQ, H, D), (B, SEQ, kv, D), (B, SEQ, kv, D)))


def _batches(n, seed):
    rng = np.random.default_rng(seed)
    return [(ids, ids) for ids in (rng.integers(
        0, 256, size=(ROWS, SEQ)).astype(np.int32) for _ in range(n))]


def _train_leg(backend, tree, batches):
    return dict(kind="train", model="llama",
                cfg=dict(LLAMA, sp_backend=backend), tree=tree,
                config={"train_micro_batch_size_per_gpu": ROWS,
                        "optimizer": {"type": "fusedadam",
                                      "params": {"lr": LR}},
                        "zero_optimization": {"stage": 1},
                        "sequence_parallel_size": WORLD},
                batches=batches)


def _legs():
    legs = {}
    for i, (name, sp, kv, causal) in enumerate(ATTN):
        q, k, v = _qkv(kv, seed=30 + i)
        legs[name] = dict(kind="ring_attn", sp=sp, q=q, k=k, v=v,
                          causal=causal)
    tree = llama_tree(jax_llama.llama_tiny(**LLAMA), seed=9)
    batches = _batches(3, 23)
    for backend in ("ring", "ulysses"):
        legs[f"llama_{backend}"] = _train_leg(backend, tree, batches)
    return legs


def _jax_ring(leg):
    sp = leg["sp"]
    mesh = Mesh(np.array(jax.devices()[:sp]).reshape(sp), ("sp", ))
    spec = P(None, "sp", None, None)
    ring = jax.shard_map(
        lambda a, b, c: jax_ring(a, b, c, "sp", causal=leg["causal"]),
        mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec,
        check_vma=False)
    q, k, v = (jnp.asarray(leg[x]) for x in "qkv")
    out = jax.jit(ring)(q, k, v)
    grads = jax.jit(jax.grad(lambda *a: jnp.sum(ring(*a) ** 2),
                             argnums=(0, 1, 2)))(q, k, v)
    return dict(out=np.asarray(out),
                **{f"d{x}": np.asarray(g) for x, g in zip("qkv", grads)})


def _jax_train(leg):
    groups.reset_mesh()
    groups.initialize_mesh(dp=1, sp=WORLD, devices=jax.devices()[:WORLD])
    try:
        model = jax_llama.LlamaModel(jax_llama.llama_tiny(**leg["cfg"]))
        eng = deepspeed_tpu.initialize(
            model=model, model_parameters=jax.tree_util.tree_map(
                jnp.asarray, leg["tree"]), config=dict(leg["config"]))[0]
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
        gc.collect()


@pytest.fixture(scope="module")
def runs():
    legs = _legs()
    want = {n: _jax_ring(leg) for n, leg in legs.items()
            if leg["kind"] == "ring_attn"}
    want["llama_ring"] = _jax_train(legs["llama_ring"])
    got = spawn(WORLD, [dict(leg, name=n) for n, leg in legs.items()],
                timeout=300)
    return want, got


def _gathered(ranks, key, sp):
    """The sequence blocks of the first sp ranks (one dp replica; the
    mesh is (dp, sp) with sp innermost) joined."""
    return np.concatenate([ranks[r][key] for r in range(sp)], axis=1)


@pytest.mark.parametrize("case", [a[0] for a in ATTN])
def test_ring_matches_jax(runs, case):
    want, got = runs
    sp = next(a[1] for a in ATTN if a[0] == case)
    for key in ("out", "dq", "dk", "dv"):
        full = _gathered(got[case], key, sp)
        np.testing.assert_allclose(full, want[case][key], rtol=2e-5,
                                   atol=2e-5, err_msg=key)
        if sp < WORLD:      # the other dp replica computed the same
            np.testing.assert_array_equal(
                full, _gathered(got[case][sp:], key, sp), err_msg=key)


@pytest.mark.parametrize("case", [a[0] for a in ATTN])
def test_one_device_ring_equals_ranks(runs, case):
    _, got = runs
    sp = next(a[1] for a in ATTN if a[0] == case)
    local = got[case][0]["one_device"]
    for key in ("out", "dq", "dk", "dv"):
        np.testing.assert_allclose(local[key], _gathered(got[case], key, sp),
                                   rtol=1e-6, atol=1e-6, err_msg=key)


def test_llama_ring_matches_jax_engine(runs):
    want, got = runs
    for r in got["llama_ring"]:
        np.testing.assert_allclose(r["losses"], want["llama_ring"]["losses"],
                                   rtol=1e-5)
    rank0 = got["llama_ring"][0]
    port = {n: rank0["master"][o:o + k].reshape(s)
            for n, o, k, s in rank0["names"]}
    cfg = port_llama.llama_tiny(**LLAMA)
    ref = {n: t.numpy() for n, t in port_llama.params_from_flax(
        want["llama_ring"]["master"], cfg, dtype="float32").items()}
    assert set(port) == set(ref)
    for n in ref:
        np.testing.assert_allclose(port[n], ref[n], rtol=1e-5,
                                   atol=LR / 20, err_msg=n)


def test_llama_ring_matches_ulysses(runs):
    _, got = runs
    for ring, uly in zip(got["llama_ring"], got["llama_ulysses"]):
        np.testing.assert_allclose(ring["losses"], uly["losses"], rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(got["llama_ring"][0]["master"],
                               got["llama_ulysses"][0]["master"], rtol=1e-5,
                               atol=LR / 20)


@pytest.mark.parametrize("kv", [H, 2])
def test_sp1_is_local_attention(kv):
    """A group of one rank: the inherited path, kv repeated for GQA and
    the local core (JAX's ``attend_local`` at sp 1)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(kv, seed=5))
    local = ProcessGroup(("sp", ), local=True)
    out = RingAttention(sequence_process_group=local)(q, k, v)
    rep = H // kv
    want = flash_attention_plain(q, k.repeat_interleave(rep, 2),
                                 v.repeat_interleave(rep, 2), causal=True)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_causal_pairs_cover_the_mask():
    """Every (query, key) pair a causal mask keeps is attended exactly
    once, by B1's bottom-right mask on each sub-pair, for blocks of any
    sizes and offsets."""
    for q0, q1, k0, k1 in ((0, 8, 0, 8), (8, 16, 0, 8), (0, 8, 8, 16),
                           (0, 32, 8, 16), (16, 24, 0, 32), (4, 12, 8, 20)):
        seen = np.zeros((q1 - q0, k1 - k0), dtype=int)
        for qa, qb, ka, kb, causal in causal_pairs(q0, q1, k0, k1, True):
            rows = np.arange(qb - qa)[:, None]
            cols = np.arange(kb - ka)[None, :]
            vis = (rows + (kb - ka) - (qb - qa) >= cols) if causal else \
                np.ones((qb - qa, kb - ka), dtype=bool)
            seen[qa:qb, ka:kb] += vis
        want = (np.arange(q0, q1)[:, None] >= np.arange(k0, k1)[None, :])
        np.testing.assert_array_equal(seen, want.astype(int))


def test_one_device_ring_launch_plan():
    """A causal ring of four folds 10 pairs (rank r: r + 1 blocks), the
    count ``chip_smoke.py`` stage 34 holds B1's launches to."""
    n = 4
    pairs = sum(len(causal_pairs(r * 8, (r + 1) * 8, s * 8, (s + 1) * 8,
                                 True))
                for r in range(n) for s in ((r - t) % n for t in range(n)))
    assert pairs == 10
    q, k, v = (torch.from_numpy(a) for a in _qkv(H, seed=6))
    got = ring_attention_blocks(q, k, v, n)
    np.testing.assert_allclose(
        got.numpy(), flash_attention_plain(q, k, v, causal=True).numpy(),
        rtol=1e-5, atol=1e-6)
