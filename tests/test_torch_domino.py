"""Domino's µ-streams in the port (``runtime/domino/``, the engine's
``domino`` block) against the JAX package on the CPU.

* ``split_microstreams``: the loss and gradients of a two-layer MLP equal
  JAX's ``split_microstreams`` on the same numpy weights and batch (fp32,
  rtol 1e-5) and the unsplit batch's; an odd batch is refused with JAX's
  error.
* The Llama family's interleaved µ-streams (``forward_microstreams``,
  ``domino_layer``): loss and every gradient equal the unsplit batch's at
  rtol 1e-5 (JAX's ``test_split_microstreams_loss_and_grad_parity``), with
  remat and with the engine's ``sum_count`` loss under a padding mask.
* ``domino_ab``'s winner follows JAX's decision rule on the same overlap
  counts (JAX's ``measure_tp_overlap`` replaced by the counts).
* ``analyze_trace_overlap`` on a synthetic trace: a start → compute →
  wait window counts as an overlapped pair, a bare collective as one
  collective (JAX's ``test_analyze_hlo_overlap_detects_async_windows``).
* The engine with ``domino`` against JAX's engine with ``domino``: at one
  rank (JAX's ``test_engine_domino_config_trains_with_parity`` setting on
  ``llama_tiny``) and, in one gloo spawn of two ranks, at tp 2, per-step
  losses at rtol 2e-4 / atol 1e-5 and the final master at rtol 2e-5 +
  lr/20 (``tests/test_torch_tp.py``'s tolerances); the same spawn's
  ``domino_ab`` report at tp 2: the plain forward's reduces are
  synchronous, each µ-stream block starts its four reduces async, and
  three of every four have compute inside their window.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu.comm as jax_dist
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu.runtime.domino import transformer as jax_domino
from deepspeed_tpu.utils import groups as jax_groups
import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import llama as port_llama
from deepspeed_tpu_torch.runtime import domino
from deepspeed_tpu_torch.runtime.domino import overlap as port_overlap
from deepspeed_tpu_torch.runtime.domino import transformer as port_domino
from test_torch_llama_training import _flax_tree as llama_tree
from torch_dist_worker import spawn

CFG = dict(dtype="float32", remat=False)
JCFG, PCFG = jax_llama.llama_tiny(**CFG), port_llama.llama_tiny(**CFG)
TREE = llama_tree(JCFG, seed=13)
SEQ, ROWS, LR = 16, 8, 1e-3


def _batches(n, seed):
    rng = np.random.default_rng(seed)
    return [(x, x) for x in (rng.integers(0, 256, size=(ROWS, SEQ))
                             .astype(np.int32) for _ in range(n))]


BATCHES = _batches(3, 31)


# ------------------------------------------------------ split_microstreams
def _mlp(rng):
    return {"w1": rng.standard_normal((16, 32)).astype(np.float32),
            "w2": rng.standard_normal((32, 16)).astype(np.float32)}


def test_split_microstreams_matches_jax_and_the_unsplit_batch():
    rng = np.random.default_rng(0)
    params = _mlp(rng)
    x = rng.standard_normal((8, 16)).astype(np.float32)
    y = rng.standard_normal((8, 16)).astype(np.float32)

    def jax_apply(p, x, y):
        return jnp.mean((jnp.tanh(x @ p["w1"]) @ p["w2"] - y) ** 2)

    jl, jg = jax.value_and_grad(
        jax_domino.split_microstreams(jax_apply, 2))(params, x, y)
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}

    def apply(x, y):
        return torch.mean((torch.tanh(x @ tp["w1"]) @ tp["w2"] - y) ** 2)

    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    plain = apply(xt, yt)
    pg = torch.autograd.grad(plain, list(tp.values()))
    split = port_domino.split_microstreams(apply, 2)(xt, yt)
    sg = torch.autograd.grad(split, list(tp.values()))
    np.testing.assert_allclose(float(split), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(split), float(plain), rtol=1e-5)
    for k, a, b in zip(tp, sg, pg):
        np.testing.assert_allclose(a.numpy(), np.asarray(jg[k]), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)
    with pytest.raises(ValueError, match="n_streams"):
        port_domino.split_microstreams(apply, 2)(xt[:7], yt[:7])
    assert port_domino.split_microstreams(apply, 1) is apply


def _llama(remat=False):
    cfg = port_llama.llama_tiny(dtype="float32", remat=remat)
    model = port_llama.LlamaModel(cfg, device="meta")
    named = port_llama.params_from_flax(TREE, cfg, dtype="float32")
    for name, t in named.items():
        mod, _, leaf = name.rpartition(".")
        setattr(model.get_submodule(mod), leaf,
                torch.nn.Parameter(t.clone(), requires_grad=True))
    return model


@pytest.mark.parametrize("remat", (False, True))
def test_llama_microstreams_equal_the_unsplit_batch(remat):
    model = _llama(remat)
    params = [p for p in model.parameters()]
    ids = torch.from_numpy(BATCHES[0][0]).long()
    plain = model(ids, labels=ids)
    pg = torch.autograd.grad(plain, params)
    split = port_domino.split_microstreams(model, 2)(ids, labels=ids)
    sg = torch.autograd.grad(split, params)
    np.testing.assert_allclose(float(split), float(plain), rtol=1e-5)
    for (name, _), a, b in zip(model.named_parameters(), sg, pg):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=name)


def test_llama_microstreams_sum_count_is_exact_under_a_mask():
    model = _llama()
    params = list(model.parameters())
    ids = torch.from_numpy(BATCHES[1][0]).long()
    mask = torch.ones_like(ids)
    mask[:3, 10:] = 0                  # uneven rows: the means differ
    tot, cnt = model(ids, labels=ids, attention_mask=mask,
                     loss_reduction="sum_count")
    pg = torch.autograd.grad(tot / cnt, params)
    stot, scnt = port_domino.split_microstreams(model, 4)(
        ids, labels=ids, attention_mask=mask, loss_reduction="sum_count")
    sg = torch.autograd.grad(stot / scnt, params)
    assert float(scnt) == float(cnt)
    np.testing.assert_allclose(float(stot), float(tot), rtol=1e-5)
    for a, b in zip(sg, pg):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-7)


def test_split_block_microstreams_is_the_block():
    model = _llama()
    layer = model.model.layers[0]
    cos, sin = port_llama.rope_tables(PCFG.head_dim,
                                      PCFG.max_position_embeddings,
                                      PCFG.rope_theta, None, "cpu")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (4, SEQ, PCFG.hidden_size)).astype(np.float32))
    with torch.no_grad():
        want = layer(x, cos, sin)
        got = port_domino.split_block_microstreams(layer, 2)(x, cos, sin)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)
    assert isinstance(domino.DominoTransformerLayer(torch.nn.Linear, 2, 3),
                      torch.nn.Linear)


# ------------------------------------------------------ the decision rule
COUNTS = [((0, 0, 0), (0, 0, 0)), ((4, 4, 4), (8, 8, 8)),
          ((4, 4, 2), (8, 8, 6)), ((4, 4, 2), (8, 8, 2)),
          ((4, 0, 0), (8, 8, 5)), ((2, 2, 0), (4, 4, 0))]


@pytest.mark.parametrize("plain,split", COUNTS)
def test_domino_ab_winner_follows_jax_rule(monkeypatch, plain, split):
    def rep(c):
        return dict(zip(("collectives", "async_pairs", "overlapped_pairs"),
                        c))

    reports = iter([rep(plain), rep(split)])
    monkeypatch.setattr(jax_domino, "measure_tp_overlap",
                        lambda *a, **k: next(reports))
    want = jax_domino.domino_ab(lambda p, x: x, None, 0)["winner"]
    assert port_domino.decide(rep(plain), rep(split)) == want


class _Ev:

    def __init__(self, name, start, end):
        self.name = name
        self.device_type = torch.autograd.DeviceType.CPU

        class R:
            pass

        self.time_range = R()
        self.time_range.start, self.time_range.end = start, end


def test_analyze_trace_overlap_detects_async_windows():
    from deepspeed_tpu_torch.comm.functional import ASYNC_START, ASYNC_WAIT
    events = [_Ev(ASYNC_START, 0, 2), _Ev("c10d::allreduce_", 0.5, 1.5),
              _Ev("aten::mm", 3, 4), _Ev(ASYNC_WAIT, 5, 6),
              _Ev(ASYNC_START, 7, 8), _Ev("c10d::allreduce_", 7.2, 7.8),
              _Ev(ASYNC_WAIT, 9, 10), _Ev("c10d::allreduce_", 11, 12),
              _Ev("aten::add", 8.5, 8.6)]
    rep = port_overlap.analyze_trace_overlap(events)
    assert rep["collectives"] == 3
    assert rep["async_pairs"] == 2
    assert rep["overlapped_pairs"] == 1
    assert rep["device_overlapped"] is None


# ------------------------------------------------------ the engine
def _config(tp, world, **extra):
    return {"train_micro_batch_size_per_gpu": ROWS // (world // tp),
            "optimizer": {"type": "adam", "params": {"lr": LR}},
            "zero_optimization": {"stage": 1}, "mesh": {"tp": tp},
            "domino": {"enabled": True, "n_streams": 2}, **extra}


def _jax_run(tp, world, domino_on=True):
    jax_groups.initialize_mesh(tp=tp, dp=world // tp,
                               devices=jax.devices()[:world])
    try:
        config = dict(_config(tp, world), mesh={"tp": tp,
                                                "dp": world // tp})
        if not domino_on:
            config.pop("domino")
        eng = deepspeed_tpu.initialize(
            model=jax_llama.LlamaModel(JCFG),
            model_parameters=jax.tree_util.tree_map(jnp.asarray, TREE),
            tp_rules=jax_llama.tp_rules(JCFG), config=config)[0]
        losses = []
        for batch in BATCHES:
            loss = eng(*batch)
            eng.backward(loss)
            eng.step()
            losses.append(float(loss))
        master = port_llama.params_from_flax(jax.tree_util.tree_map(
            np.asarray, eng.get_fp32_param()), PCFG, dtype="float32")
        return dict(losses=losses, master=master)
    finally:
        jax_groups.reset_mesh()
        jax_dist.destroy_process_group()


def _check(got, want, names):
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-4,
                               atol=1e-5)
    leaves = {n: got["master"][o:o + k].reshape(s) for n, o, k, s in names}
    assert set(leaves) == set(want["master"])
    for name, t in want["master"].items():
        np.testing.assert_allclose(leaves[name], t.numpy(), rtol=2e-5,
                                   atol=LR / 20, err_msg=name)


def test_engine_domino_trains_as_jax_at_one_rank():
    """JAX's ``test_engine_domino_config_trains_with_parity`` on
    ``llama_tiny``: the domino engine's losses equal the plain engine's
    at rtol 1e-5, and JAX's domino engine at the training tolerances."""
    def run(domino_on):
        config = _config(1, 1)
        if not domino_on:
            config.pop("domino")
        model = port_llama.LlamaModel(PCFG, device="meta")
        eng = deepspeed_tpu_torch.initialize(
            model=model, config=config, device="cpu",
            model_parameters=port_llama.params_from_flax(
                TREE, PCFG, dtype="float32"))[0]
        losses = []
        for x, y in BATCHES:
            loss = eng(torch.from_numpy(x).long(), torch.from_numpy(y).long())
            eng.backward(loss)
            eng.step()
            losses.append(float(loss))
        layout, numel = eng.global_layout()
        return dict(losses=losses, master=eng.fp32_params()[:numel].numpy(),
                    names=layout)

    on, off = run(True), run(False)
    np.testing.assert_allclose(on["losses"], off["losses"], rtol=1e-5)
    _check(on, _jax_run(1, 1), on["names"])


@pytest.fixture(scope="module")
def tp2():
    """(JAX's domino run at tp 2, the port's runs by leg) from one spawn."""
    ids = np.asarray(BATCHES[0][0][:4])
    legs = [dict(name="domino_tp2", kind="train", model="llama", cfg=CFG,
                 tree=TREE, config=_config(2, 2), batches=BATCHES,
                 tp_rules=port_llama.tp_rules(PCFG)),
            dict(name="overlap_tp2", kind="domino_overlap", model="llama",
                 cfg=CFG, tree=TREE, config=_config(2, 2), ids=ids,
                 tp_rules=port_llama.tp_rules(PCFG))]
    return _jax_run(2, 2), spawn(2, legs, timeout=300)


def test_engine_domino_at_tp2_matches_jax(tp2):
    want, got = tp2
    for r in got["domino_tp2"]:
        _check(r, want, got["domino_tp2"][0]["names"])
    assert got["domino_tp2"][1]["losses"] == got["domino_tp2"][0]["losses"]


def test_overlap_report_at_tp2(tp2):
    L = PCFG.num_hidden_layers
    for rep in tp2[1]["overlap_tp2"]:
        plain, split = rep["plain"], rep["domino"]
        assert plain["backend"] == split["backend"] == "gloo"
        # plain: the 2 reduces a block (and the embedding's) run in place
        assert plain["async_pairs"] == 0 and not plain["overlapped"]
        assert plain["collectives"] >= 2 * L
        # two streams × (attention, MLP) reduces a block, all async; the
        # last stream's MLP reduce of a block has nothing left to hide it
        assert split["async_pairs"] == 4 * L
        assert split["overlapped_pairs"] == 3 * L
        assert split["collectives"] >= 4 * L
        assert rep["winner"] == "domino"
