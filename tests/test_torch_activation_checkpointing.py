"""Activation checkpointing of the port (``runtime/activation_checkpointing``
and ``LlamaConfig.remat_policy``) against the JAX package on the CPU,
fp32, from numpy seeds.

* the API on JAX's ``tests/unit/runtime/test_activation_checkpointing.py``
  cases: ``checkpoint`` and ``non_reentrant_checkpoint`` keep values and
  gradients (against JAX's ``checkpoint``), under each configured
  flag (partitioned, CPU, contiguous) and each policy of the table,
  inside a loop of checkpointed layers (1e-5: XLA's and torch's fp32
  tanh differ in the last bits), and bit-equal to the same function
  without a checkpoint; the RNG tracker's fork semantics
  (no random values are compared: torch and JAX draw differently) and
  ``model_parallel_rng_seed``;
* every ``remat_policy`` of the table on Llama: the loss and every
  gradient against JAX's model under the same ``jax.checkpoint_policies``
  entry at 1e-5 and against ``remat=False`` at 1e-6; under the dots
  policies B1's forward runs once a layer (its outputs kept), under the
  others twice with remat;
* ``partition_activations`` at tp 2 (two gloo processes): the loss and
  gradients equal to tp 1's bit for bit, each saved activation kept as
  this rank's half and gathered whole;
* ``cpu_checkpointing`` keeps gradients bit-equal; the engine configures
  the module from the ``activation_checkpointing`` block.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu.runtime import activation_checkpointing as jax_ac
import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import llama as port_llama
from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
from deepspeed_tpu_torch.runtime.activation_checkpointing import (
    RNGStatesTracker, checkpoint, checkpointing, configure, get_policy,
    get_rng_tracker, is_configured, model_parallel_rng_seed,
    non_reentrant_checkpoint, reset)
from test_torch_llama_training import _flax_tree as llama_tree
from torch_dist_worker import spawn

POLICIES = ["nothing_saveable", "none", "dots_saveable", "checkpoint_dots",
            "dots_with_no_batch_dims_saveable",
            "checkpoint_dots_with_no_batch_dims", "everything_saveable"]
DOTS = ("dots_saveable", "checkpoint_dots",
        "dots_with_no_batch_dims_saveable",
        "checkpoint_dots_with_no_batch_dims")


@pytest.fixture(autouse=True)
def _reset_cfg():
    yield
    reset()
    jax_ac.reset()


def _wx(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((8, 8)).astype(np.float32),
            rng.standard_normal((4, 8)).astype(np.float32))


def _jax_block(w):
    return lambda x: jnp.sum(jnp.tanh(x @ jnp.asarray(w)) ** 2)


def _port(fn_of_x, x, **kw):
    xt = torch.from_numpy(x).requires_grad_()
    val = fn_of_x(xt, **kw)
    val.backward()
    return val.item(), xt.grad.numpy()


def _check(w, x, run):
    f = _jax_block(w)
    want = (float(jax_ac.checkpoint(f, jnp.asarray(x))),
            np.asarray(jax.grad(lambda y: jax_ac.checkpoint(f, y))(
                jnp.asarray(x))))
    wt = torch.from_numpy(w)
    f = lambda a: torch.tanh(a @ wt).square().sum()   # noqa: E731
    got = _port(lambda y: run(f, y), x)
    # XLA's and torch's fp32 tanh differ in the last bits
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-6)
    # and the checkpoint changes nothing of the port's own arithmetic
    plain = _port(f, x)
    assert got[0] == plain[0]
    np.testing.assert_array_equal(got[1], plain[1])


@pytest.mark.parametrize("fn", ["checkpoint", "non_reentrant_checkpoint"])
def test_checkpoint_preserves_values_and_grads(fn):
    w, x = _wx(0)
    run = checkpoint if fn == "checkpoint" else non_reentrant_checkpoint
    _check(w, x, run)


@pytest.mark.parametrize("flags", [{"partition_activations": True},
                                   {"checkpoint_in_cpu": True},
                                   {"contiguous_checkpointing": True}])
def test_configured_policies_still_correct(flags):
    configure(**flags)
    jax_ac.configure(**flags)
    assert is_configured()
    w, x = _wx(1)
    _check(w, x, checkpoint)


@pytest.mark.parametrize("policy", POLICIES)
def test_each_policy_keeps_values_and_grads(policy):
    w, x = _wx(2)
    _check(w, x, lambda f, y: checkpoint(f, y, policy=policy))


def test_checkpoint_in_a_loop_of_layers():
    """JAX's remat inside jit + scan: here checkpointed layers in a loop,
    the same values and gradients as the JAX scan."""
    w = np.eye(8, dtype=np.float32) * 0.5
    x = np.ones((2, 8), np.float32)

    def stacked(x):
        def body(c, _):
            return jax_ac.checkpoint(lambda a: jnp.tanh(a @ w), c), None
        return jnp.sum(jax.lax.scan(body, x, None, length=4)[0])

    want = (float(stacked(jnp.asarray(x))),
            np.asarray(jax.grad(stacked)(jnp.asarray(x))))
    wt = torch.from_numpy(w)

    def port_stacked(h):
        for _ in range(4):
            h = checkpoint(lambda a: torch.tanh(a @ wt), h)
        return h.sum()

    got = _port(port_stacked, x)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-6)


def test_policy_names_resolve_like_jax():
    assert get_policy().name() == "nothing_saveable"
    configure(contiguous_checkpointing=True)
    assert get_policy().name() == "dots_with_no_batch_dims_saveable"
    configure(checkpoint_in_cpu=True)
    assert get_policy().name() == "nothing_saveable"
    for name in POLICIES:
        assert name in jax_ac.checkpointing._POLICIES or hasattr(
            jax.checkpoint_policies, name)
    for name in ("save_only_these_names", "no_such_policy"):
        with pytest.raises(ValueError, match="unknown remat policy"):
            checkpointing.policy_ops(name)


def test_rng_tracker_fork_deterministic():
    def draw(tr, name="model-parallel-rng"):
        with tr.fork(name) as gen:
            return torch.randn(4, generator=gen)

    tr = RNGStatesTracker()
    tr.add("model-parallel-rng", 42)
    tr2 = RNGStatesTracker()
    tr2.add("model-parallel-rng", 42)
    a, b = draw(tr), draw(tr2)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.allclose(a, draw(tr))        # the next fork differs
    saved = tr.get_states()
    nxt = draw(tr)
    tr.set_states(saved)
    torch.testing.assert_close(draw(tr), nxt, rtol=0, atol=0)
    with pytest.raises(Exception):
        tr.add("model-parallel-rng", 1)
    with pytest.raises(Exception):
        with tr.fork("missing"):
            pass


def test_model_parallel_rng_seed():
    tr = model_parallel_rng_seed(1234)
    assert tr is get_rng_tracker()
    states = tr.get_states()
    assert "default" in states and "model-parallel-rng" in states
    assert states["model-parallel-rng"][0] == 1234 + 2718


def _flash_forwards(monkeypatch):
    calls = []
    plain = fa._plain_fwd

    def counting(*a, **k):
        calls.append(1)
        return plain(*a, **k)

    monkeypatch.setattr(fa, "_plain_fwd", counting)
    return calls


@pytest.mark.parametrize("policy", POLICIES)
def test_llama_remat_policy_matches_jax(policy, monkeypatch):
    over = dict(dtype="float32", num_key_value_heads=2)
    jcfg = jax_llama.llama_tiny(remat=True, remat_policy=policy, **over)
    tree = llama_tree(jcfg, seed=21)
    ids = np.random.default_rng(22).integers(0, 256, (2, 16)).astype(
        np.int32)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jax_llama.LlamaModel(jcfg).apply(
            {"params": p}, jnp.asarray(ids), jnp.asarray(ids)))(
        jax.tree_util.tree_map(jnp.asarray, tree))
    got = {}
    for remat in (True, False):
        pcfg = port_llama.llama_tiny(remat=remat, remat_policy=policy, **over)
        model = port_llama.LlamaModel(pcfg, device="meta").load_weights(
            port_llama.params_from_flax(tree, pcfg, dtype="float32").items(),
            device="cpu")
        model.requires_grad_(True)
        calls = _flash_forwards(monkeypatch)
        t = torch.from_numpy(ids)
        loss = model(t, t, use_kernel=False)
        loss.backward()
        got[remat] = (loss.item(), {n: p.grad.numpy() for n, p in
                                    model.named_parameters()}, len(calls))
    loss, grads, forwards = got[True]
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5, atol=1e-5)
    want = port_llama.params_from_flax(jax.tree_util.tree_map(
        np.asarray, jgrads), port_llama.llama_tiny(**over), dtype="float32")
    for name, g in want.items():
        np.testing.assert_allclose(grads[name], g.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
        np.testing.assert_allclose(grads[name], got[False][1][name],
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    L = jcfg.num_hidden_layers
    recomputed = policy not in DOTS and policy != "everything_saveable"
    assert forwards == (2 * L if recomputed else L)
    assert got[False][2] == L


def test_partition_activations_tp2_equals_tp1():
    rng = np.random.default_rng(30)
    leg = dict(name="ac", kind="ac_partition",
               x=rng.standard_normal((8, 16)).astype(np.float32),
               ws=[(0.3 * rng.standard_normal((16, 16))).astype(np.float32)
                   for _ in range(2)])
    got = spawn(2, [leg], timeout=200)["ac"]
    # tp 1: the same model in this process, no mesh, flag on
    configure(partition_activations=True)
    x = torch.from_numpy(leg["x"]).requires_grad_()
    ws = [torch.from_numpy(w).requires_grad_() for w in leg["ws"]]
    h = x
    for w in ws:
        h = checkpoint(lambda a, b: torch.tanh(a @ b), h, w)
    loss = (h ** 2).sum()
    loss.backward()
    for rank in got:
        for flag in (False, True):
            r = rank[flag]
            assert r["loss"] == loss.item()
            np.testing.assert_array_equal(r["dx"], x.grad.numpy())
            for a, w in zip(r["dws"], ws):
                np.testing.assert_array_equal(a, w.grad.numpy())
        assert rank["packed_shape"] == (8, 8)
        np.testing.assert_array_equal(rank["unpacked"], leg["x"])


def test_cpu_checkpointing_keeps_grads():
    w, x = _wx(3)
    wt = torch.from_numpy(w)
    f = lambda a: torch.tanh(a @ wt).square().sum()   # noqa: E731
    plain = _port(lambda y: checkpoint(f, y), x)
    configure(checkpoint_in_cpu=True)
    host = _port(lambda y: checkpoint(f, y), x)
    assert plain[0] == host[0]
    np.testing.assert_array_equal(plain[1], host[1])


def test_engine_configures_checkpointing():
    assert not is_configured()
    cfg = port_llama.llama_tiny(dtype="float32", remat=False)
    deepspeed_tpu_torch.initialize(
        model=port_llama.LlamaModel(cfg, device="cpu"),
        config={"train_batch_size": 1,
                "activation_checkpointing": {"cpu_checkpointing": True,
                                             "number_checkpoints": 4}},
        device="cpu")
    assert is_configured()
    pol = get_policy()
    assert pol.cpu_checkpointing and pol.number_checkpoints == 4
    assert deepspeed_tpu_torch.checkpointing is checkpointing
