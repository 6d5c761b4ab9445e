"""The port's BERT (``deepspeed_tpu_torch.models.bert``) against the JAX
package's flax ``BertModel``, on the CPU at ``bert_tiny`` size, from the
same numpy weights (a flax tree, through ``params_from_flax``) and the same
numpy batches (15 % of the tokens labelled, the rest -100).

* the loss and the logits, with and without ``attention_mask``, with and
  without the ``mlm_transform`` head: rtol 1e-5, atol 1e-5 (the same fp32
  arithmetic summed in another order);
* the gradients of every leaf at the same tolerance;
* 3 ZeRO-0 fp32 ``fusedadam`` steps through both packages' ``initialize()``
  (BASELINE config 1's engine): losses rtol 1e-5, the final master rtol
  2e-5 plus lr/20 absolute (``test_torch_llama_training.py``'s rule) on all
  but 0.1 % of a leaf's elements, whose gradient is at the level of fp32
  noise (Adam moves them by ±lr whatever their size), and those within
  Adam's largest move; the key biases, whose gradient is all noise, within
  that move of the start.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu.comm as jax_dist
import deepspeed_tpu_torch
from deepspeed_tpu.models import bert as jax_bert
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch.models import bert as port_bert

SEQ = 16


def flax_tree(cfg, seed):
    """A numpy param tree in the flax layout of ``jax_bert.BertModel``."""
    rng = np.random.default_rng(seed)
    D, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    H, Dh = cfg.num_attention_heads, cfg.head_dim

    def w(*shape, fan_in):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
            np.float32)

    def ln():
        return {"scale": (1 + 0.1 * rng.standard_normal(D)).astype(
            np.float32), "bias": 0.1 * w(D, fan_in=1)}

    tree = {"word_embeddings": {"embedding": w(V, D, fan_in=D)},
            "position_embeddings": {
                "embedding": w(cfg.max_position_embeddings, D, fan_in=D)},
            "token_type_embeddings": {
                "embedding": w(cfg.type_vocab_size, D, fan_in=D)},
            "embeddings_ln": ln()}
    for i in range(cfg.num_hidden_layers):
        tree[f"layer_{i}"] = {
            **{p: {"kernel": w(D, H, Dh, fan_in=D),
                   "bias": 0.1 * w(H, Dh, fan_in=1)}
               for p in ("query", "key", "value")},
            "attention_output": {"kernel": w(H, Dh, D, fan_in=D),
                                 "bias": 0.1 * w(D, fan_in=1)},
            "attention_ln": ln(),
            "intermediate": {"kernel": w(D, I, fan_in=D),
                             "bias": 0.1 * w(I, fan_in=1)},
            "output": {"kernel": w(I, D, fan_in=I),
                       "bias": 0.1 * w(D, fan_in=1)},
            "output_ln": ln()}
    if cfg.mlm_transform:
        tree["mlm_dense"] = {"kernel": w(D, D, fan_in=D),
                             "bias": 0.1 * w(D, fan_in=1)}
        tree["mlm_ln"] = ln()
        tree["mlm_bias"] = 0.1 * w(V, fan_in=1)
    return tree


def mlm_batch(B, seed, vocab=256, rate=0.15):
    """Token ids, MLM labels (-100 where not labelled) and a padding mask."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, size=(B, SEQ)).astype(np.int32)
    labels = np.where(rng.random((B, SEQ)) < rate, ids, -100).astype(
        np.int32)
    labels[:, 0] = ids[:, 0]          # at least one counted token a row
    mask = (rng.random((B, SEQ)) > 0.2).astype(np.int32)
    mask[:, 0] = 1
    return ids, labels, mask


CASES = {"plain": dict(), "mask": dict(), "mlm_transform":
         dict(mlm_transform=True), "mask_mlm_transform":
         dict(mlm_transform=True)}


def _both(case, seed):
    cfg_kw = CASES[case]
    jcfg = jax_bert.bert_tiny(**cfg_kw)
    pcfg = port_bert.bert_tiny(**cfg_kw)
    tree = flax_tree(jcfg, seed)
    ids, labels, mask = mlm_batch(3, seed + 1)
    if "mask" not in case:
        mask = None
    return jcfg, pcfg, tree, ids, labels, mask


def _port_model(pcfg, tree):
    model = port_bert.BertModel(pcfg, device="meta")
    model.load_state_dict(port_bert.params_from_flax(tree, pcfg),
                          assign=True)
    return model.requires_grad_(True)


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_flax(case):
    jcfg, pcfg, tree, ids, labels, mask = _both(case, seed=len(case))
    jmodel = jax_bert.BertModel(jcfg)
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    jm = None if mask is None else jnp.asarray(mask)
    jloss = jmodel.apply({"params": jt}, jnp.asarray(ids),
                         jnp.asarray(labels), jm)
    jlogits = jmodel.apply({"params": jt}, jnp.asarray(ids), None, jm)
    model = _port_model(pcfg, tree)
    t = torch.from_numpy
    pm = None if mask is None else t(mask)
    with torch.no_grad():
        loss = model(t(ids), t(labels), pm)
        logits = model(t(ids), None, pm)
        total, count = model(t(ids), t(labels), pm,
                             loss_reduction="sum_count")
    assert logits.shape == (3, SEQ, pcfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5,
                               atol=1e-5)
    assert count.item() == float((labels >= 0).sum())
    np.testing.assert_allclose((total / count).item(), float(jloss),
                               rtol=1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_grads_match_flax(case):
    jcfg, pcfg, tree, ids, labels, mask = _both(case, seed=3 * len(case))
    jmodel = jax_bert.BertModel(jcfg)
    jm = None if mask is None else jnp.asarray(mask)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jmodel.apply({"params": p}, jnp.asarray(ids),
                               jnp.asarray(labels), jm)
    )(jax.tree_util.tree_map(jnp.asarray, tree))
    model = _port_model(pcfg, tree)
    t = torch.from_numpy
    loss = model(t(ids), t(labels), None if mask is None else t(mask))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = port_bert.params_from_flax(
        jax.tree_util.tree_map(np.asarray, jgrads), pcfg)
    params = dict(model.named_parameters())
    assert set(want) == set(params)
    for name, g in want.items():
        np.testing.assert_allclose(params[name].grad.numpy(), g.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_remat_and_token_types_match_flax():
    jcfg = jax_bert.bert_tiny(remat=True)
    pcfg = port_bert.bert_tiny(remat=True)
    tree = flax_tree(jcfg, seed=5)
    ids, labels, mask = mlm_batch(2, 6)
    tt = (np.arange(SEQ)[None] >= SEQ // 2).astype(np.int32).repeat(2, 0)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jax_bert.BertModel(jcfg).apply(
            {"params": p}, jnp.asarray(ids), jnp.asarray(labels),
            jnp.asarray(mask), jnp.asarray(tt))
    )(jax.tree_util.tree_map(jnp.asarray, tree))
    model = _port_model(pcfg, tree)
    t = torch.from_numpy
    loss = model(t(ids), t(labels), t(mask), t(tt))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    g = jgrads["token_type_embeddings"]["embedding"]
    np.testing.assert_allclose(
        model.token_type_embeddings.embedding.grad.numpy(), np.asarray(g),
        rtol=1e-5, atol=1e-5)


def test_configs_and_param_count():
    for name in ("bert_base", "bert_large", "bert_tiny"):
        j, p = getattr(jax_bert, name)(), getattr(port_bert, name)()
        for f in ("vocab_size", "hidden_size", "num_hidden_layers",
                  "num_attention_heads", "intermediate_size",
                  "max_position_embeddings", "layer_norm_eps", "dtype"):
            assert getattr(j, f) == getattr(p, f), (name, f)
    for kw in (dict(), dict(mlm_transform=True)):
        cfg = port_bert.bert_tiny(**kw)
        n = sum(p.numel() for p in
                port_bert.BertModel(cfg, device="meta").parameters())
        assert n == port_bert.param_count(cfg)
    # BERT-base: the flax model's own leaves, by shape only
    shapes = jax.eval_shape(jax_bert.BertModel(jax_bert.bert_base()).init,
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))
    assert port_bert.param_count(port_bert.bert_base()) == sum(
        int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes))
    with pytest.raises(KeyError, match="does not fit"):
        port_bert.params_from_flax(flax_tree(jax_bert.bert_tiny(), 0),
                                   port_bert.bert_tiny(mlm_transform=True))


@pytest.fixture
def one_device_mesh():
    groups.initialize_mesh(dp=1, devices=jax.devices()[:1])
    yield
    groups.reset_mesh()
    jax_dist.destroy_process_group()


def test_zero0_fp32_fusedadam_steps_match_jax(one_device_mesh):
    """BASELINE config 1's engine (ZeRO 0, fp32, fusedadam) for 3 steps."""
    lr = 1e-3
    config = {"train_micro_batch_size_per_gpu": 4,
              "optimizer": {"type": "fusedadam", "params": {"lr": lr}},
              "zero_optimization": {"stage": 0}}
    jcfg, pcfg = jax_bert.bert_tiny(), port_bert.bert_tiny()
    tree = flax_tree(jcfg, seed=11)
    jeng, *_ = deepspeed_tpu.initialize(
        model=jax_bert.BertModel(jcfg),
        model_parameters=jax.tree_util.tree_map(jnp.asarray, tree),
        config=dict(config))
    peng, *_ = deepspeed_tpu_torch.initialize(
        model=port_bert.BertModel(pcfg, device="meta"),
        model_parameters=port_bert.params_from_flax(tree, pcfg),
        config=dict(config), device="cpu")
    jl, pl = [], []
    for step in range(3):
        ids, labels, mask = mlm_batch(4, 20 + step)
        for eng, out in ((jeng, jl), (peng, pl)):
            loss = eng(ids, labels, mask)
            eng.backward(loss)
            eng.step()
            out.append(float(loss))
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    want = port_bert.params_from_flax(
        jax.tree_util.tree_map(np.asarray, jeng.get_fp32_param()), pcfg)
    assert set(want) == set(peng.parameter_names())
    start = port_bert.params_from_flax(tree, pcfg)
    for name, w in want.items():
        got = peng.get_fp32_param(name)
        if name.endswith("key.bias"):
            # the key bias adds one constant to a query's logits, which the
            # softmax removes: its gradient is rounding noise in both
            # packages, and Adam turns noise into moves of up to lr a step
            for side in (got, w):
                assert (side - start[name]).abs().max() <= 3 * lr * 1.01
            continue
        # Adam's first move is lr·sign(g): an element whose gradient is at
        # the level of fp32 summation noise may move either way (1 of
        # layer 0's 8,192 output-kernel elements does here); a wrong update
        # is off on most elements
        diff = (got - w).abs()
        apart = diff > 2e-5 * w.abs() + lr / 20
        assert apart.float().mean().item() <= 1e-3, name
        assert diff.max().item() <= 2 * 3 * lr, name
