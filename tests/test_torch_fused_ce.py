"""The fused chunked head + loss of the port (``sequence/cross_entropy.py:
fused_linear_cross_entropy`` and the models' ``loss_chunk_vocab``)
against the JAX package on the CPU, fp32 unless stated, from numpy seeds.

* ``fused_linear_cross_entropy`` against JAX's: even and uneven
  vocabulary chunks and a chunk at least V (JAX's ``test_fused_ce.py``
  cases), per-token losses at 1e-5, the gradients in x and w at 1e-5; in
  bf16 logits at bf16's rounding (2^-7 relative); no op of the forward or
  the backward makes an [N, V] tensor;
* Llama (untied, tied, GQA with a loss mask), GPT-2 (tied, fp32 as JAX's)
  and Mixtral with ``loss_chunk_vocab``: the loss and every gradient
  against JAX's model with the same option at 1e-5 (Mixtral's gradients
  1e-4, as its own parity test), and the loss equal to the full-logits
  path's;
* Llama with ``loss_chunk_vocab`` and a loss mask at sp 2 through the
  engine (two gloo processes) against JAX's engine on an sp-2 mesh: the
  shifted targets cross the ranks' chunks (the global shift, not a local
  ``[:, :-1]``); losses at 1e-5, the final master at 1e-5 relative plus
  lr/20; in the same spawn, ZeRO 3 × tp 2 with the head sharded on its
  vocabulary (JAX's ``test_chunked_loss_composes_with_zero3_tp``) against
  JAX's engine on a tp-2 mesh by the same rule;
* one rank's slice of a padded vocabulary (``tp=(None, start, vocab)``):
  pad columns -inf, the unpadded loss and gradients.
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import deepspeed_tpu
import deepspeed_tpu.comm as jax_dist
from deepspeed_tpu.models import gpt2 as jax_gpt2
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu.models import mixtral as jax_mixtral
from deepspeed_tpu.sequence.cross_entropy import \
    fused_linear_cross_entropy as jax_fused
from deepspeed_tpu.sequence.cross_entropy import \
    vocab_sequence_parallel_cross_entropy as jax_vocab_sp_ce
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch.models import gpt2 as port_gpt2
from deepspeed_tpu_torch.models import llama as port_llama
from deepspeed_tpu_torch.models import mixtral as port_mixtral
from deepspeed_tpu_torch.comm import ProcessGroup
from deepspeed_tpu_torch.sequence.cross_entropy import (
    fused_linear_cross_entropy, softmax_cross_entropy_with_logits,
    vocab_sequence_parallel_cross_entropy)
from test_torch_gpt2_training import _flax_tree as gpt2_tree
from test_torch_llama_training import _flax_tree as llama_tree
from test_torch_mixtral_training import _flax_tree as mixtral_tree
from torch_dist_worker import spawn

SEQ, LR = 16, 2e-3


def _inputs(n, d, v, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(dtype),
            (0.3 * rng.standard_normal((d, v))).astype(dtype),
            rng.integers(0, v, size=n).astype(np.int32))


@pytest.mark.parametrize("v,chunk", [(64, 16), (60, 16), (64, 64),
                                     (64, 128)])
def test_fused_ce_matches_jax(v, chunk):
    x, w, labels = _inputs(24, 32, v, seed=0)
    want, gwant = jax.value_and_grad(
        lambda x, w: jnp.mean(jax_fused(x, w, jnp.asarray(labels), chunk)),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    per_token = jax_fused(jnp.asarray(x), jnp.asarray(w),
                          jnp.asarray(labels), chunk)
    xt, wt = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    got = fused_linear_cross_entropy(xt, wt, torch.from_numpy(labels), chunk)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(per_token),
                               rtol=1e-5, atol=1e-5)
    got.mean().backward()
    for g, w_ in zip((xt.grad, wt.grad), gwant):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=1e-5,
                                   atol=1e-6)


def test_fused_ce_bf16_logits_match_jax():
    """bf16 products with fp32 logits: within bf16's rounding of JAX's
    (both round x and w to bf16 and accumulate in fp32)."""
    x, w, labels = _inputs(32, 64, 100, seed=1)
    want = jax_fused(jnp.asarray(x), jnp.asarray(w), jnp.asarray(labels), 32,
                     logit_dtype=jnp.bfloat16)
    got = fused_linear_cross_entropy(torch.from_numpy(x), torch.from_numpy(w),
                                     torch.from_numpy(labels), 32,
                                     logit_dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2.0**-7,
                               atol=1e-2)


class _Shapes(TorchDispatchMode):

    def __init__(self):
        super().__init__()
        self.shapes = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out, )):
            if isinstance(t, torch.Tensor):
                self.shapes.add(tuple(t.shape))
        return out


def test_fused_ce_makes_no_full_logits():
    """JAX's ``test_fused_ce_no_full_logits_in_jaxpr``: no op of the
    forward or the backward returns an [N, V] tensor (dw, [D, V], is the
    gradient itself)."""
    n, d, v, chunk = 8, 16, 512, 64
    x, w, labels = _inputs(n, d, v, seed=2)
    xt, wt = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    with _Shapes() as mode:
        fused_linear_cross_entropy(xt, wt, torch.from_numpy(labels),
                                   chunk).mean().backward()
    assert (n, v) not in mode.shapes and (n, chunk) in mode.shapes
    with _Shapes() as dense:
        softmax_cross_entropy_with_logits(xt @ wt, torch.from_numpy(labels))
    assert (n, v) in dense.shapes          # the probe sees the full logits


@pytest.mark.parametrize("reduction", ["mean", "none"])
def test_vocab_sequence_parallel_cross_entropy_matches_jax(reduction):
    """Outside a sharded region (JAX: no sp axis; here no group or a
    group of one rank) the per-token losses and their mean."""
    rng = np.random.default_rng(9)
    logits = rng.standard_normal((2, 8, 40)).astype(np.float32)
    labels = rng.integers(0, 40, (2, 8)).astype(np.int32)
    want = jax_vocab_sp_ce(jnp.asarray(logits), jnp.asarray(labels),
                           reduction=reduction)
    for group in (None, ProcessGroup(("sp", ), local=True)):
        got = vocab_sequence_parallel_cross_entropy(
            torch.from_numpy(logits), torch.from_numpy(labels),
            sp_group=group, reduction=reduction)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)


def _grads_match(model, want, rtol):
    params = dict(model.named_parameters())
    assert set(want) == set(params)
    for name, g in want.items():
        np.testing.assert_allclose(params[name].grad.numpy(), g.numpy(),
                                   rtol=rtol, atol=1e-5, err_msg=name)


LLAMA_CASES = {"untied": dict(), "tied": dict(tie_word_embeddings=True),
               "gqa_mask": dict(num_key_value_heads=2)}


@pytest.mark.parametrize("case", sorted(LLAMA_CASES))
def test_llama_chunked_loss_matches_jax(case):
    over = dict(dict(dtype="float32", remat=False, num_key_value_heads=4),
                **LLAMA_CASES[case])
    chunk = 16 if case == "tied" else 48          # 48: V = 256 does not tile
    jcfg = jax_llama.llama_tiny(loss_chunk_vocab=chunk, **over)
    tree = llama_tree(jcfg, seed=11)
    ids = np.random.default_rng(3).integers(0, 256, (2, SEQ)).astype(
        np.int32)
    mask = None
    if case == "gqa_mask":
        mask = (np.random.default_rng(4).random(ids.shape) > 0.3).astype(
            np.int32)
    jmask = None if mask is None else jnp.asarray(mask)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jax_llama.LlamaModel(jcfg).apply(
            {"params": p}, jnp.asarray(ids), jnp.asarray(ids), jmask))(
        jax.tree_util.tree_map(jnp.asarray, tree))
    losses = {}
    for c in (chunk, 0):
        pcfg = port_llama.llama_tiny(loss_chunk_vocab=c, **over)
        model = port_llama.LlamaModel(pcfg, device="meta").load_weights(
            port_llama.params_from_flax(tree, pcfg, dtype="float32").items(),
            device="cpu")
        model.tie_weights()
        model.requires_grad_(True)
        t = torch.from_numpy
        loss = model(t(ids), t(ids), None if mask is None else t(mask))
        losses[c] = loss.item()
        if c:
            loss.backward()
            np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5,
                                       atol=1e-5)
            _grads_match(model, port_llama.params_from_flax(
                jax.tree_util.tree_map(np.asarray, jgrads), pcfg,
                dtype="float32"), 1e-5)
    np.testing.assert_allclose(losses[chunk], losses[0], rtol=1e-5)


def test_gpt2_chunked_loss_matches_jax():
    jcfg = jax_gpt2.gpt2_tiny(dtype="float32", remat=False,
                              loss_chunk_vocab=64)
    pcfg = port_gpt2.gpt2_tiny(dtype="float32", remat=False,
                               loss_chunk_vocab=64)
    tree = gpt2_tree(5)
    ids = np.random.default_rng(6).integers(0, 256, (2, SEQ)).astype(
        np.int32)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jax_gpt2.GPT2Model(jcfg).apply(
            {"params": p}, jnp.asarray(ids), jnp.asarray(ids)))(
        jax.tree_util.tree_map(jnp.asarray, tree))
    model = port_gpt2.GPT2Model(pcfg)
    state = port_gpt2.params_from_flax(tree, pcfg)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(state[name])
    model.requires_grad_(True)
    t = torch.from_numpy(ids)
    loss = model(t, t)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5,
                               atol=1e-5)
    _grads_match(model, port_gpt2.params_from_flax(
        jax.tree_util.tree_map(np.asarray, jgrads), pcfg), 1e-5)


def test_mixtral_chunked_loss_matches_jax():
    jcfg = jax_mixtral.mixtral_tiny(dtype="float32", remat=False,
                                    loss_chunk_vocab=32)
    pcfg = port_mixtral.mixtral_tiny(dtype="float32", remat=False,
                                     loss_chunk_vocab=32)
    tree = mixtral_tree(jcfg, seed=7)
    ids = np.random.default_rng(8).integers(0, jcfg.vocab_size,
                                            (2, SEQ)).astype(np.int32)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jax_mixtral.MixtralModel(jcfg).apply(
            {"params": p}, jnp.asarray(ids), jnp.asarray(ids)))(
        jax.tree_util.tree_map(jnp.asarray, tree))
    model = port_mixtral.MixtralModel(pcfg, device="meta").load_weights(
        port_mixtral.params_from_flax(tree, pcfg, dtype="float32").items(),
        device="cpu")
    model.requires_grad_(True)
    t = torch.from_numpy(ids)
    loss = model(t, t)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    _grads_match(model, port_mixtral.params_from_flax(
        jax.tree_util.tree_map(np.asarray, jgrads), pcfg, dtype="float32"),
        1e-4)


# ------------------------------------------------------------------- sp 2
SP_CFG = dict(dtype="float32", remat=False, use_ulysses=True,
              num_key_value_heads=2, loss_chunk_vocab=48)


def _sp_leg():
    rng = np.random.default_rng(12)
    batches = []
    for _ in range(3):
        ids = rng.integers(0, 256, size=(2, SEQ)).astype(np.int32)
        m = (rng.random((2, SEQ)) < 0.7).astype(np.int32)
        m[:, SEQ // 2 - 1:SEQ // 2 + 1] = 1       # the chunk boundary
        batches.append((ids, ids, m))
    return dict(kind="train", model="llama", cfg=SP_CFG,
                tree=llama_tree(jax_llama.llama_tiny(**SP_CFG), seed=13),
                config={"train_micro_batch_size_per_gpu": 2,
                        "optimizer": {"type": "fusedadam",
                                      "params": {"lr": LR}},
                        "zero_optimization": {"stage": 1},
                        "sequence_parallel_size": 2},
                batches=batches)


TP_CFG = dict(dtype="float32", remat=False, loss_chunk_vocab=32)


def _tp_leg():
    """JAX's ``test_chunked_loss_composes_with_zero3_tp`` at two ranks:
    ``llama_tiny`` with ``loss_chunk_vocab`` 32 under ZeRO 3 × tp 2 (the
    head sharded on its vocabulary: 128 columns, four chunks a rank), in
    fp32 so that it can be held to JAX's engine."""
    rng = np.random.default_rng(14)
    batches = [(ids, ids) for ids in (
        rng.integers(0, 256, size=(2, 32)).astype(np.int32)
        for _ in range(3))]
    return dict(kind="train", model="llama", cfg=TP_CFG,
                tree=llama_tree(jax_llama.llama_tiny(**TP_CFG), seed=15),
                config={"train_micro_batch_size_per_gpu": 2,
                        "optimizer": {"type": "fusedadam",
                                      "params": {"lr": LR}},
                        "zero_optimization": {
                            "stage": 3,
                            "stage3_param_persistence_threshold": 0},
                        "mesh": {"tp": 2}},
                tp_rules=port_llama.tp_rules(port_llama.llama_tiny(
                    **TP_CFG)),
                batches=batches)


def _jax_sp_train(leg, tp=1):
    groups.reset_mesh()
    groups.initialize_mesh(dp=1, sp=2 // tp, tp=tp,
                           devices=jax.devices()[:2])
    try:
        jcfg = jax_llama.llama_tiny(**leg["cfg"])
        kw = {} if tp == 1 else dict(tp_rules=jax_llama.tp_rules(jcfg))
        eng = deepspeed_tpu.initialize(
            model=jax_llama.LlamaModel(jcfg),
            model_parameters=jax.tree_util.tree_map(jnp.asarray,
                                                    leg["tree"]),
            config=dict(leg["config"]), **kw)[0]
        losses = []
        for batch in leg["batches"]:
            loss = eng(*eng.shard_batch(*batch))
            eng.backward(loss)
            eng.step()
            losses.append(float(loss))
        return dict(losses=losses, master=jax.tree_util.tree_map(
            np.asarray, eng.get_fp32_param()))
    finally:
        groups.reset_mesh()
        jax_dist.destroy_process_group()
        gc.collect()


@pytest.fixture(scope="module")
def w2():
    """The world-2 legs, one spawn: (leg, JAX's run, the port's ranks) by
    name."""
    legs = {"sp2": (_sp_leg(), 1), "z3_tp2": (_tp_leg(), 2)}
    want = {n: _jax_sp_train(leg, tp) for n, (leg, tp) in legs.items()}
    got = spawn(2, [dict(leg, name=n) for n, (leg, _) in legs.items()],
                timeout=300)
    return {n: (legs[n][0], want[n], got[n]) for n in legs}


def _check_w2(leg, want, got):
    for r in got:
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=1e-5)
    rank0 = got[0]
    port = {n: rank0["master"][o:o + k].reshape(s)
            for n, o, k, s in rank0["names"]}
    ref = {n: t.numpy() for n, t in port_llama.params_from_flax(
        want["master"], port_llama.llama_tiny(**leg["cfg"]),
        dtype="float32").items()}
    assert set(port) == set(ref)
    for n in ref:
        np.testing.assert_allclose(port[n], ref[n], rtol=1e-5,
                                   atol=LR / 20, err_msg=n)


def test_llama_chunked_loss_sp2_matches_jax_engine(w2):
    _check_w2(*w2["sp2"])


def test_chunked_loss_composes_with_zero3_tp(w2):
    """The chunked head + loss on a vocabulary-sharded head: each rank's
    columns chunk by chunk, the rows' max and sum-exp combined over tp
    once; losses and master as JAX's engine at tp 2, and the loss falls."""
    leg, want, got = w2["z3_tp2"]
    _check_w2(leg, want, got)
    assert got[0]["losses"][-1] < got[0]["losses"][0]


@pytest.mark.parametrize("chunk", (16, 40))
def test_fused_ce_on_a_padded_vocabulary_slice(chunk):
    """One rank's view (``tp=(None, start, vocab)``): the columns past the
    vocabulary are pad (-inf), labels outside the slice are another
    rank's.  At start 0 with 3 pad columns: the unpadded loss and
    gradients at 1e-6, the pad columns' gradient 0."""
    rng = np.random.default_rng(21)
    N, D, V = 12, 16, 61
    x = torch.from_numpy(rng.standard_normal((N, D)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((D, V)).astype(np.float32))
    lab = torch.from_numpy(rng.integers(0, V, N))
    wp = torch.cat([w, torch.zeros(D, 3)], dim=1)
    x1, w1 = x.clone().requires_grad_(), w.clone().requires_grad_()
    x2, w2_ = x.clone().requires_grad_(), wp.clone().requires_grad_()
    want = fused_linear_cross_entropy(x1, w1, lab, chunk)
    got = fused_linear_cross_entropy(x2, w2_, lab, chunk, tp=(None, 0, V))
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               rtol=1e-6)
    want.sum().backward()
    got.sum().backward()
    np.testing.assert_allclose(x2.grad.numpy(), x1.grad.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(w2_.grad[:, :V].numpy(), w1.grad.numpy(),
                               rtol=1e-5, atol=1e-6)
    assert not w2_.grad[:, V:].any()
    from deepspeed_tpu_torch.sequence.cross_entropy import \
        vocab_parallel_cross_entropy
    logits = x @ wp
    np.testing.assert_allclose(
        vocab_parallel_cross_entropy(logits, lab, 0, V, None).numpy(),
        softmax_cross_entropy_with_logits(x @ w, lab).numpy(), rtol=1e-6)
