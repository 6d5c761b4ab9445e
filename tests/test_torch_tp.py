"""Tensor parallelism in the port (``module_inject/``, the ``tp`` axis of
``utils/groups.py``, the engine at ``mesh.tp`` > 1), on the CPU at
``llama_tiny`` width against the JAX package on its 8-device CPU mesh.

* Groups: the port's rank coordinates, tp group and data group at (tp 2,
  dp 2), (tp 4) and over a device subset equal JAX's ``initialize_mesh``
  on the same devices; a subset that splits a tp group is refused.
* AutoTP: ``derive_rules`` equals JAX's on the llama, gpt2, bert and
  mixtral tiny trees; for every leaf at tp 2 and 4 the slice
  ``shard_params_for_tp`` keeps equals the shard JAX's ``NamedSharding``
  puts on that device (the kv kernels tp 4 does not divide stay whole,
  with JAX's warning); the tp-1 replacement is the model bit for bit.
* tp_parser: the port's classification of its four tiny models equals
  JAX's ``TpParser().parse`` by flax name, and the rules it derives equal
  ``llama.tp_rules`` (JAX's ``test_dataflow_parser_matches_hand_rules``).
* Training, one gloo spawn of four ranks: tp 2 × dp 2 at ZeRO 0-3 against
  the JAX engine at tp 2 × dp 2 (``tests/unit/model_parallelism/
  test_tp.py:_run``'s setting: fp32, Adam at lr 1e-3): per-step losses at
  rtol 2e-4 / atol 1e-5 (JAX's ``test_tp_matches_no_tp``), the final
  master at rtol 2e-5 + lr/20 (``tests/test_torch_zero.py``'s); with
  ``gradient_clipping`` far below the norm; with the rules derived
  (``tp_rules=None``); at tp 4, whose 2 kv heads stay whole on every rank;
  a non-finite gradient on one tp rank makes every rank skip.
* Checkpoints: a tp 2 × dp 2 ZeRO-3 tag resumes at tp 1, tp 4 and another
  stage with the master and moments equal, and its universal directory
  holds JAX's leaves (JAX's engine at tp 1 on the same batches) at the
  training tolerances.
* GPT-2 (its hand rules, the 257-row vocabulary padded to a multiple of
  tp) at tp 2 and 4 and BERT (derived rules) at tp 2 against JAX's engine
  on the same mesh; a tp-2 GPT-2 tag keeps 257 rows in its module and
  universal form and loads at tp 1 and 4 bit-equal.
* Refusals: tp with ep and Mixtral training at tp (item 8b); tp with pp
  or sp, GPT-2 and BERT at tp and ``generic_injection``, refused until
  item 9b's last part, now work.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu.comm as jax_dist
from deepspeed_tpu.checkpoint import convert_to_universal as jax_convert
from deepspeed_tpu.models import bert as jax_bert
from deepspeed_tpu.models import gpt2 as jax_gpt2
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu.models import mixtral as jax_mixtral
from deepspeed_tpu.module_inject import auto_tp as jax_auto_tp
from deepspeed_tpu.module_inject.tp_parser import TpParser as JaxParser
from deepspeed_tpu.module_inject.tp_parser import \
    derive_tp_rules_from_dataflow as jax_derive
from deepspeed_tpu.utils import groups as jax_groups
from deepspeed_tpu_torch import module_inject
from deepspeed_tpu_torch.checkpoint import convert_to_universal
from deepspeed_tpu_torch.models import bert as port_bert
from deepspeed_tpu_torch.models import gpt2 as port_gpt2
from deepspeed_tpu_torch.models import llama as port_llama
from deepspeed_tpu_torch.models import mixtral as port_mixtral
from deepspeed_tpu_torch.module_inject import auto_tp as port_auto_tp
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.utils.logging import logger as port_logger
from test_torch_llama_training import _flax_tree as llama_tree
from torch_dist_worker import spawn

WORLD, SEQ, ROWS, LR = 4, 16, 16, 1e-3
CFG = dict(dtype="float32", remat=False)
JCFG, PCFG = jax_llama.llama_tiny(**CFG), port_llama.llama_tiny(**CFG)
TREE = llama_tree(JCFG, seed=11)
Z3 = {"stage": 3, "stage3_param_persistence_threshold": 0}


def _config(stage, tp, **extra):
    zero = Z3 if stage == 3 else {"stage": stage}
    return {"train_micro_batch_size_per_gpu": ROWS // (WORLD // tp),
            "optimizer": {"type": "adam", "params": {"lr": LR}},
            "zero_optimization": zero, "mesh": {"tp": tp}, **extra}


def _batches(n, seed):
    rng = np.random.default_rng(seed)
    return [(x, x) for x in (rng.integers(0, 256, size=(ROWS, SEQ))
                             .astype(np.int32) for _ in range(n))]


BATCHES = _batches(4, 21)
HAND = port_llama.tp_rules(PCFG)


def _legs():
    """{name: (leg, JAX run or None)}."""
    legs = {}
    for stage in (0, 1, 2, 3):
        legs[f"tp2_z{stage}"] = dict(config=_config(stage, 2), tp=2)
    legs["tp2_clip"] = dict(config=_config(1, 2, gradient_clipping=0.05),
                            tp=2)
    legs["tp2_derived"] = dict(config=_config(1, 2), tp=2, derived=True)
    legs["tp4_z0"] = dict(config=_config(0, 4), tp=4)
    legs["tp2_poison"] = dict(config=_config(0, 2, resilience={
        "check_finite_grads": {"enabled": True}}), tp=2, poison={1: 1},
        port_only=True)
    out = {}
    for name, spec in legs.items():
        leg = dict(name=name, kind="train", model="llama", cfg=CFG,
                   tree=TREE, config=spec["config"], batches=BATCHES,
                   tp_rules=None if spec.get("derived") else HAND)
        if "poison" in spec:
            leg["poison"] = spec["poison"]
        out[name] = (leg, spec)
    return out


def _jax_run(spec):
    tp = spec["tp"]
    jax_groups.initialize_mesh(tp=tp, dp=WORLD // tp,
                               devices=jax.devices()[:WORLD])
    try:
        config = dict(spec["config"], mesh={"tp": tp, "dp": WORLD // tp})
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


def _ckpt_leg(tmp):
    return dict(name="ckpt", kind="ckpt", model="llama", cfg=CFG, tree=TREE,
                config=_config(3, 2), batches=BATCHES, k=2, dir=tmp,
                tp_rules=HAND, resume={"tp1_z0": _config(0, 1),
                                       "tp4_z1": _config(1, 4),
                                       "tp2_z2": _config(2, 2)})


MESHES = [dict(tp=2, dp=2), dict(tp=4), dict(tp=2, devices=[2, 3])]
INIT = [(1, 0), (2, 0), (4, 0), (2, 3)]
_R = np.random.default_rng(17)
FUNCTIONAL = dict(x=_R.standard_normal((WORLD, 8)),
                  c=_R.standard_normal((WORLD, 32)),
                  w1=_R.standard_normal((4 * WORLD, 8)),
                  w1_b=_R.standard_normal(4 * WORLD),
                  w2=_R.standard_normal((8, 4 * WORLD)),
                  w2_b=_R.standard_normal(8),
                  table=_R.standard_normal((4 * WORLD, 8)),
                  X=_R.standard_normal((3, 8)), C=_R.standard_normal((3, 8)),
                  ids=_R.integers(0, 4 * WORLD, (2, 5)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX results by leg, the port's results by leg, the tag dir)."""
    tmp = str(tmp_path_factory.mktemp("tp_ckpt"))
    legs = _legs()
    want = {n: None if spec.get("port_only") else _jax_run(spec)
            for n, (_, spec) in legs.items()}
    extra = [dict(name="groups", kind="groups", meshes=MESHES),
             dict(name="bad_subset", kind="groups",
                  meshes=[dict(tp=2, devices=[1, 2])], expect_error=True),
             _ckpt_leg(tmp)]
    extra.append(dict(name="functional", kind="functional", **FUNCTIONAL))
    extra += [dict(name=f"init_tp{tp}_z{z}", kind="train", model="llama",
                   cfg=CFG, tree=None, init_seed=5, batches=BATCHES[:2],
                   config=_config(z, tp), tp_rules=HAND)
              for tp, z in INIT]
    extra += [dict(name=f"refuse_{m}", kind="refuse", model=m,
                   cfg=dict(dtype="float32", remat=False) if m != "bert"
                   else dict(dtype="float32"), tree=tree,
                   config=_config(0, 2)) for m, tree in _refusal_trees()]
    others = _other_legs()
    want.update({n: _jax_other(leg, spec) for n, (leg, spec)
                 in others.items()})
    extra += [leg for leg, _ in others.values()]
    extra.append(_gpt2_ckpt_leg(tmp))
    got = spawn(WORLD, [leg for leg, _ in legs.values()] + extra,
                timeout=600)
    return want, got, tmp


# GPT-2 with a vocabulary no tp > 1 divides: the port pads it
GPT2_CFG = dict(dtype="float32", remat=False, vocab_size=257)
BERT_CFG = dict(dtype="float32")


def _gpt2_tree(cfg, seed):
    """A numpy flax tree of ``jax_gpt2.GPT2Model(cfg)`` (the scales around
    1, kernels by fan-in, biases small)."""
    params = jax.eval_shape(jax_gpt2.GPT2Model(cfg).init,
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, 4), jnp.int32))["params"]
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        noise = rng.standard_normal(a.shape).astype(np.float32)
        if jax.tree_util.keystr(path).endswith("['scale']"):
            return (1.0 + 0.1 * noise).astype(np.float32)
        return (0.05 * noise if len(a.shape) == 1 else
                noise / np.sqrt(np.prod(a.shape[:-1]))).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, params)


def _other_legs():
    """{name: (leg, JAX spec)}: GPT-2 on its hand rules at tp 2 and 4 with
    the padded 257-row vocabulary, BERT at tp 2 on the derived rules."""
    from test_torch_bert import flax_tree as bert_tree
    gtree = _gpt2_tree(jax_gpt2.gpt2_tiny(**GPT2_CFG), 23)
    btree = bert_tree(jax_bert.bert_tiny(**BERT_CFG), seed=29)
    grules = port_gpt2.tp_rules(port_gpt2.gpt2_tiny(**GPT2_CFG))
    out = {}
    for tp in (2, 4):
        out[f"gpt2_tp{tp}"] = (
            dict(name=f"gpt2_tp{tp}", kind="train", model="gpt2",
                 cfg=GPT2_CFG, tree=gtree, config=_config(1, tp),
                 batches=BATCHES, tp_rules=grules),
            dict(model="gpt2", tp=tp))
    out["bert_tp2"] = (
        dict(name="bert_tp2", kind="train", model="bert", cfg=BERT_CFG,
             tree=btree, config=_config(1, 2), batches=BATCHES,
             tp_rules=None),
        dict(model="bert", tp=2))
    return out


def _jax_other(leg, spec):
    """JAX's engine on the leg's model, weights and batches at tp
    (GPT-2's hand rules; BERT's derived from the dataflow)."""
    tp = spec["tp"]
    mod, cls, make = {"gpt2": (jax_gpt2, "GPT2Model", "gpt2_tiny"),
                      "bert": (jax_bert, "BertModel", "bert_tiny")}[
                          spec["model"]]
    jcfg = getattr(mod, make)(**leg["cfg"])
    pmod = {"gpt2": port_gpt2, "bert": port_bert}[spec["model"]]
    pcfg = getattr(pmod, make)(**leg["cfg"])
    jax_groups.initialize_mesh(tp=tp, dp=WORLD // tp,
                               devices=jax.devices()[:WORLD])
    try:
        config = dict(leg["config"], mesh={"tp": tp, "dp": WORLD // tp})
        kw = ({} if spec["model"] == "bert"
              else dict(tp_rules=jax_gpt2.tp_rules(jcfg)))
        eng = deepspeed_tpu.initialize(
            model=getattr(mod, cls)(jcfg),
            model_parameters=jax.tree_util.tree_map(jnp.asarray,
                                                    leg["tree"]),
            config=config, **kw)[0]
        losses = []
        for batch in leg["batches"]:
            loss = eng(*batch)
            eng.backward(loss)
            eng.step()
            losses.append(float(loss))
        master = pmod.params_from_flax(jax.tree_util.tree_map(
            np.asarray, eng.get_fp32_param()), pcfg, dtype="float32")
        return dict(losses=losses, master=master)
    finally:
        jax_groups.reset_mesh()
        jax_dist.destroy_process_group()


def _gpt2_ckpt_leg(tmp):
    leg = _other_legs()["gpt2_tp2"][0]
    return dict(leg, name="gpt2_ckpt", kind="ckpt", k=2,
                dir=os.path.join(tmp, "gpt2_tag"),
                resume={"tp1_z0": _config(0, 1), "tp4_z1": _config(1, 4)})


def _refusal_trees():
    from test_torch_bert import flax_tree as bert_tree
    from test_torch_gpt2_training import _flax_tree as gpt2_tree
    from test_torch_mixtral_training import _flax_tree as mixtral_tree
    return [("gpt2", gpt2_tree(7)),
            ("bert", bert_tree(jax_bert.bert_tiny(), seed=9)),
            ("mixtral", mixtral_tree(jax_mixtral.mixtral_tiny(**CFG), 5))]


def _leaves(res):
    return {n: res["master"][o:o + k].reshape(s)
            for n, o, k, s in res["names"]}


# ------------------------------------------------------------------ groups
def _jax_groups(kw):
    """{world rank: (coord, tp group ranks, data group ranks)} of JAX's
    mesh over the same devices."""
    devs = jax.devices()[:WORLD]
    sub = kw.get("devices")
    jax_groups.initialize_mesh(
        tp=kw["tp"], dp=kw.get("dp"),
        devices=[devs[r] for r in sub] if sub else devs)
    try:
        grid = jax_groups.get_global_mesh().devices
        names = ("pp", "dp", "ep", "sp", "tp")
        out = {}
        for idx in np.ndindex(grid.shape):
            rank = grid[idx].id
            coord = dict(zip(names, idx))

            def members(axes):
                sl = tuple(slice(None) if n in axes else i
                           for n, i in zip(names, idx))
                return sorted(d.id for d in np.ravel(grid[sl]))

            out[rank] = (coord, members(("tp", )), members(("dp", "ep")))
        return out
    finally:
        jax_groups.reset_mesh()


@pytest.mark.parametrize("i", range(len(MESHES)))
def test_groups_match_jax(runs, i):
    want = _jax_groups(MESHES[i])
    got = runs[1]["groups"]
    for rank in range(WORLD):
        mine = got[rank][i]
        if rank not in want:
            assert not mine["member"], rank
            assert mine["tp"]["size"] == mine["data"]["size"] == 1
            continue
        coord, tp, data = want[rank]
        assert mine["member"]
        assert {k: int(v) for k, v in mine["coord"].items()} == \
            {k: int(v) for k, v in coord.items()}, rank
        assert mine["tp"]["members"] == tp, rank
        assert mine["data"]["members"] == data, rank
        assert mine["tp"]["rank"] == tp.index(rank)


def test_subset_must_name_whole_tp_groups(runs):
    for r in runs[1]["bad_subset"]:
        assert r[0]["error"] == "ValueError"
        assert "whole tp groups" in r[0]["message"]


def _functional_want(name, r):
    """(output, input gradient) rank r gets: the JAX collective's value and
    the gradient its transpose gives (Megatron's for the tp-region
    operators)."""
    x, c = FUNCTIONAL["x"], FUNCTIONAL["c"]
    n = x.shape[1]
    if name in ("psum", "copy_to", "reduce_from"):
        y = x.sum(0) if name != "copy_to" else x[r]
        g = c[:, :n].sum(0) if name != "reduce_from" else c[r, :n]
        return y, g
    if name == "pmean":
        return x.mean(0), c[:, :n].sum(0) / WORLD
    if name in ("pmax", "pmin"):
        y = x.max(0) if name == "pmax" else x.min(0)
        return y, c[:, :n].sum(0) * (x[r] == y)
    if name in ("all_gather", "gather_from"):
        y = x.reshape(-1)
        block = slice(r * n, (r + 1) * n)
        g = c[:, block].sum(0) if name == "all_gather" else c[r, block]
        return y, g
    k = n // WORLD                                     # reduce_scatter
    return x.sum(0)[r * k:(r + 1) * k], c[:, :k].reshape(-1)


@pytest.mark.parametrize("name", ("psum", "pmean", "pmax", "pmin",
                                  "all_gather", "reduce_scatter", "copy_to",
                                  "reduce_from", "gather_from"))
def test_functional_collectives(runs, name):
    for r, res in enumerate(runs[1]["functional"]):
        y, g = res[name]
        want_y, want_g = _functional_want(name, r)
        np.testing.assert_allclose(y, want_y, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(g, want_g, rtol=1e-12, atol=1e-12)


def test_parallel_layers_compute_the_whole_layers(runs):
    f = FUNCTIONAL
    X = torch.from_numpy(f["X"]).requires_grad_()
    h = torch.tanh(X @ torch.from_numpy(f["w1"]).T +
                   torch.from_numpy(f["w1_b"]))
    Y = h @ torch.from_numpy(f["w2"]).T + torch.from_numpy(f["w2_b"])
    (Y * torch.from_numpy(f["C"])).sum().backward()
    for r, res in enumerate(runs[1]["functional"]):
        y, g = res["mlp"]
        np.testing.assert_allclose(y, Y.detach().numpy(), rtol=1e-12)
        np.testing.assert_allclose(g, X.grad.numpy(), rtol=1e-12)
        np.testing.assert_array_equal(res["embedding"],
                                      f["table"][f["ids"]])
        assert res["vocab_start"] == 4 * r


# ------------------------------------------------------------------ AutoTP
def _trees():
    ids = jnp.zeros((2, 16), jnp.int32)
    out = {}
    for name, mod, cfg in (
            ("llama", jax_llama, jax_llama.llama_tiny(**CFG)),
            ("gpt2", jax_gpt2, jax_gpt2.gpt2_tiny(**CFG)),
            ("bert", jax_bert, jax_bert.bert_tiny(dtype="float32")),
            ("mixtral", jax_mixtral, jax_mixtral.mixtral_tiny(**CFG))):
        cls = {"llama": "LlamaModel", "gpt2": "GPT2Model",
               "bert": "BertModel", "mixtral": "MixtralModel"}[name]
        m = getattr(mod, cls)(cfg)
        out[name] = (m, jax.eval_shape(m.init, jax.random.PRNGKey(0),
                                       ids)["params"], ids)
    return out


TREES = _trees()


def _norm(spec):
    """A spec as a tuple of axis tuples (JAX's and the port's alike)."""
    return tuple(() if a is None else (a if isinstance(a, tuple) else (a, ))
                 for a in tuple(spec))


@pytest.mark.parametrize("model", sorted(TREES))
def test_derive_rules_match_jax(model):
    _, params, _ = TREES[model]
    want = jax_auto_tp.AutoTP.derive_rules(params)
    shapes = jax.tree_util.tree_map(lambda x: np.zeros(x.shape, np.int8),
                                    params)
    got = port_auto_tp.AutoTP.derive_rules(shapes)
    assert set(got) == set(want)
    for key, spec in want.items():
        assert _norm(got[key]) == _norm(spec), key
    if model in ("llama", "mixtral"):
        # the same rules from the port's model (its tp_leaf_info)
        from_model = port_auto_tp.AutoTP.derive_rules(_port_twin(model))
        assert {k: _norm(v) for k, v in from_model.items()} == \
            {k: _norm(v) for k, v in want.items()}


def _port_model(model, tree):
    if model == "llama":
        return port_llama.LlamaModel(PCFG, device="cpu"), \
            port_llama.params_from_flax(tree, PCFG, dtype="float32")
    cfg = port_mixtral.mixtral_tiny(**CFG)
    return port_mixtral.MixtralModel(cfg, device="cpu"), \
        port_mixtral.params_from_flax(tree, cfg, dtype="float32")


class _Rank:
    """A tp group stand-in for sharding alone (no collective runs)."""

    def __init__(self, size, rank):
        self._size, self._rank = size, rank

    def size(self):
        return self._size

    def rank(self):
        return self._rank


def _to_flax(a, dims, shape):
    """A port slice in the flax layout: its torch dims in flax order, then
    the flax shape."""
    order = [d for d in dims if d is not None]
    return np.transpose(a, order).reshape(shape)


@pytest.mark.parametrize("tp", (2, 4))
@pytest.mark.parametrize("model", ("llama", "mixtral"))
def test_shard_slices_match_named_sharding(model, tp, caplog):
    from jax.sharding import Mesh
    jmod = jax_llama if model == "llama" else jax_mixtral
    jcfg = JCFG if model == "llama" else jax_mixtral.mixtral_tiny(**CFG)
    tree = llama_tree(jcfg, 3) if model == "llama" else \
        _refusal_trees()[2][1]
    mesh = Mesh(np.array(jax.devices()[:tp]), ("tp", ))
    rules = jmod.tp_rules(jcfg)
    placed = jax_auto_tp.shard_params_for_tp(
        jax.tree_util.tree_map(jnp.asarray, tree), mesh, rules)
    flat = {"/".join(str(getattr(k, "key", k)) for k in kp): leaf
            for kp, leaf in jax.tree_util.tree_leaves_with_path(placed)}
    pmod = port_llama if model == "llama" else port_mixtral
    for t in range(tp):
        m, start = _port_model(model, tree)
        m.load_weights(start.items())
        caplog.clear()
        # the port's logger does not propagate: hand caplog its records
        port_logger.addHandler(caplog.handler)
        try:
            module_inject.shard_params_for_tp(m, pmod.tp_rules(m.config),
                                              group=_Rank(tp, t))
        finally:
            port_logger.removeHandler(caplog.handler)
        if model == "llama" and tp == 4:
            # llama_tiny's 2 kv heads do not split over 4 ranks
            warned = [r.getMessage() for r in caplog.records
                      if "not divisible" in r.getMessage()]
            assert any("k_proj/kernel" in w and "replicating" in w
                       for w in warned), warned
        for name, p in m.named_parameters():
            info = pmod.tp_leaf_info(name, tuple(p.shape), m.config)
            if info is None:
                continue
            path, _, dims = info
            leaf = flat["/".join(path)]
            shard = [s for s in leaf.addressable_shards
                     if s.device == mesh.devices[t]][0]
            want = np.asarray(shard.data)
            got = _to_flax(p.detach().numpy(), dims, want.shape)
            np.testing.assert_array_equal(got, want, err_msg=name)
            # a slice is its own contiguous tensor (B7's TMA route needs
            # 16-byte-aligned, dense expert slices)
            assert p.is_contiguous(), name
            split = m.tp_splits.get(name)
            assert (split is not None) == (want.shape != leaf.shape), name


def test_tp1_replacement_is_bit_equal():
    tree = llama_tree(JCFG, 4)
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2, SEQ)))
    outs = []
    for replace in (False, True):
        m, start = _port_model("llama", tree)
        m.load_weights(start.items())
        if replace:
            module_inject.shard_params_for_tp(m, HAND, group=_Rank(1, 0))
            assert isinstance(m.model.layers[0].self_attn.q_proj,
                              module_inject.ColumnParallelLinear)
            assert isinstance(m.model.layers[0].mlp.down_proj,
                              module_inject.RowParallelLinear)
            assert isinstance(m.model.embed_tokens,
                              module_inject.VocabParallelEmbedding)
        outs.append((m(ids).detach(), m(ids, ids).detach()))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


# ---------------------------------------------------------------- tp_parser
def _port_twin(model):
    mod, cfg_fn, cls = {
        "llama": (port_llama, "llama_tiny", "LlamaModel"),
        "gpt2": (port_gpt2, "gpt2_tiny", "GPT2Model"),
        "bert": (port_bert, "bert_tiny", "BertModel"),
        "mixtral": (port_mixtral, "mixtral_tiny", "MixtralModel")}[model]
    cfg = getattr(mod, cfg_fn)(**(CFG if model != "bert"
                                  else dict(dtype="float32")))
    return getattr(mod, cls)(cfg, device="meta")


@pytest.mark.parametrize("model", sorted(TREES))
def test_parser_classes_match_jax(model):
    jm, params, ids = TREES[model]
    want = JaxParser().parse(lambda p, x: jm.apply({"params": p}, x),
                             params, ids)
    got = module_inject.TpParser().parse(
        _port_twin(model), torch.zeros((2, 16), dtype=torch.long,
                                       device="meta"))
    assert {k: sorted(v) for k, v in got.items()} == \
        {k: sorted(v) for k, v in want.items()}


def test_derived_rules_match_hand_rules():
    ids = torch.zeros((2, 16), dtype=torch.long, device="meta")
    got = module_inject.derive_tp_rules_from_dataflow(_port_twin("llama"),
                                                      ids)
    for key, spec in HAND.items():
        assert _norm(got[key]) == _norm(spec), key
    jm, params, jids = TREES["llama"]
    want = jax_derive(lambda p, x: jm.apply({"params": p}, x), params, jids,
                      with_zero_pin=False)
    assert {k: _norm(v) for k, v in got.items()} == \
        {k: _norm(v) for k, v in want.items()}
    pinned = module_inject.derive_tp_rules_from_dataflow(
        _port_twin("llama"), ids, with_zero_pin=True)
    assert {k: _norm(v) for k, v in pinned.items()} == {
        k: _norm(v) for k, v in jax_derive(
            lambda p, x: jm.apply({"params": p}, x), params, jids).items()}


# ----------------------------------------------------------------- training
TRAIN = [n for n in _legs() if n != "tp2_poison"]


@pytest.mark.parametrize("leg", TRAIN)
def test_training_matches_jax(runs, leg):
    want, got, _ = runs
    w = want[leg]
    for r in got[leg]:
        np.testing.assert_allclose(r["losses"], w["losses"], rtol=2e-4,
                                   atol=1e-5)
    leaves = _leaves(got[leg][0])
    assert set(leaves) == set(w["master"])
    for name, t in w["master"].items():
        np.testing.assert_allclose(leaves[name], t.numpy(), rtol=2e-5,
                                   atol=LR / 20, err_msg=name)
    for r in got[leg][1:]:
        assert r["losses"] == got[leg][0]["losses"]
        np.testing.assert_array_equal(r["master"], got[leg][0]["master"])


def test_derived_rules_train_as_the_hand_rules(runs):
    got = runs[1]
    assert got["tp2_derived"][0]["losses"] == got["tp2_z1"][0]["losses"]
    np.testing.assert_array_equal(got["tp2_derived"][0]["master"],
                                  got["tp2_z1"][0]["master"])


def test_nonfinite_gradient_on_one_tp_rank_skips_everywhere(runs):
    res = runs[1]["tp2_poison"]
    for r in res:
        assert r["skips"] == [False, True, False, False]
        np.testing.assert_array_equal(r["master"], res[0]["master"])
    assert all(np.isfinite(r["master"]).all() for r in res)


@pytest.mark.parametrize("tp,stage", INIT[1:])
def test_initialize_parameters_draws_the_same_weights_at_any_tp(runs, tp,
                                                                 stage):
    """``initialize_parameters(seed)`` draws every leaf whole, leaf by
    leaf, and keeps the rank's slice: tp 2 and 4 (and ZeRO 3) start from
    tp 1's weights, so their losses are tp 1's up to the order of sums."""
    got = runs[1]
    want = got["init_tp1_z0"][0]["losses"]
    for r in got[f"init_tp{tp}_z{stage}"]:
        np.testing.assert_allclose(r["losses"], want, rtol=1e-6)


# -------------------------------------------------------------- checkpoints
@pytest.mark.parametrize("target", ("tp1_z0", "tp4_z1", "tp2_z2"))
def test_tp_tag_resumes_anywhere(runs, target):
    res = runs[1]["ckpt"]
    for r in res:
        got = r["resumed"][target]
        for field in ("master", "exp_avg", "exp_avg_sq"):
            for name, want in r["saved"][field].items():
                np.testing.assert_array_equal(got["loaded"][field][name],
                                              want, err_msg=name)
        assert got["loaded"]["count"] == r["saved"]["count"]
        np.testing.assert_allclose(got["losses"], r["losses"], rtol=1e-6)


def test_tp_tag_files_and_universal_form_match_jax(runs, tmp_path):
    tag = os.path.join(runs[2], "t")
    names = sorted(os.listdir(tag))
    for t in (0, 1):
        assert f"mp_rank_{t:02d}_model_states.pt" in names
        for d in (0, 1):
            assert f"zero_pp_rank_{d}_mp_rank_{t:02d}_optim_states.pt" in \
                names
    out = str(tmp_path / "port_universal")
    convert_to_universal(runs[2], out, tag="t")
    # the JAX engine at tp 1 over the same two batches
    jax_groups.initialize_mesh(dp=1, devices=jax.devices()[:1])
    try:
        eng = deepspeed_tpu.initialize(
            model=jax_llama.LlamaModel(JCFG),
            model_parameters=jax.tree_util.tree_map(jnp.asarray, TREE),
            config=dict(_config(0, 1), train_micro_batch_size_per_gpu=ROWS,
                        mesh={"tp": 1}))[0]
        for batch in BATCHES[:2]:
            eng.backward(eng(*batch))
            eng.step()
        eng.save_checkpoint(str(tmp_path / "jax"), tag="t")
        jax_out = str(tmp_path / "jax_universal")
        jax_convert(str(tmp_path / "jax"), jax_out, tag="t")
    finally:
        jax_groups.reset_mesh()
        jax_dist.destroy_process_group()
    for field in ("fp32", "exp_avg", "exp_avg_sq"):
        got, want = _npy(out, field), _npy(jax_out, field)
        assert set(got) == set(want), field
        for name, w in want.items():
            assert got[name].shape == w.shape, name
            tol = dict(rtol=2e-5, atol=LR / 20) if field == "fp32" else \
                dict(rtol=2e-3, atol=1e-7)
            np.testing.assert_allclose(got[name], w, err_msg=name, **tol)


def _npy(root, field):
    zero = os.path.join(root, "zero")
    out = {}
    for dirpath, _, files in os.walk(zero):
        if f"{field}.npy" in files:
            out[os.path.relpath(dirpath, zero)] = np.load(
                os.path.join(dirpath, f"{field}.npy"))
    return out


# ------------------------------------------------------ GPT-2 and BERT
OTHER = ("gpt2_tp2", "gpt2_tp4", "bert_tp2")


@pytest.mark.parametrize("leg", OTHER)
def test_other_models_train_at_tp_as_jax(runs, leg):
    """GPT-2 (hand rules, its 257-row vocabulary padded to a multiple of
    tp, the loss vocabulary-parallel) and BERT (rules derived from the
    dataflow) against JAX's engine on the same mesh: losses at rtol 2e-4 /
    atol 1e-5, the master by ``test_torch_infinity.py``'s noisy rule (an
    element whose gradient is fp32 noise may take Adam's step of the
    other sign: at most 0.1 % of a leaf beyond rtol 2e-5 + lr/20; the key
    biases left out, whose gradient is zero up to that noise: the softmax
    over keys does not see a bias every key shares)."""
    want, got, _ = runs
    w = want[leg]
    for r in got[leg]:
        np.testing.assert_allclose(r["losses"], w["losses"], rtol=2e-4,
                                   atol=1e-5)
    leaves = _leaves(got[leg][0])
    assert set(leaves) == set(w["master"])
    for name, t in w["master"].items():
        assert leaves[name].shape == tuple(t.shape), name
        if name.endswith(("k_proj.bias", "key.bias")):
            continue
        apart = np.abs(leaves[name] - t.numpy()) > \
            2e-5 * np.abs(t.numpy()) + LR / 20
        assert apart.mean() <= 1e-3, name
    for r in got[leg][1:]:
        assert r["losses"] == got[leg][0]["losses"]


def test_gpt2_tp_tag_keeps_the_vocabulary_and_loads_anywhere(runs):
    """A tp-2 GPT-2 tag (the padded vocabulary) holds 257 rows in its
    whole module and its universal form, and loads at tp 1 and tp 4 with
    the master and moments bit-equal to the gathered ones."""
    res = runs[1]["gpt2_ckpt"]
    tag = os.path.join(runs[2], "gpt2_tag")
    sd = torch.load(os.path.join(tag, "t", "mp_rank_00_model_states.pt"),
                    map_location="cpu", weights_only=False)
    assert tuple(sd["module"]["wte.embedding"].shape) == (257, 64)
    for r in res:
        assert r["saved"]["master"]["wte.embedding"].shape == (257, 64)
        for target in ("tp1_z0", "tp4_z1"):
            got = r["resumed"][target]
            for field in ("master", "exp_avg", "exp_avg_sq"):
                for name, want in r["saved"][field].items():
                    np.testing.assert_array_equal(
                        got["loaded"][field][name], want, err_msg=name)
            np.testing.assert_allclose(got["losses"], r["losses"],
                                       rtol=1e-5)


def test_gpt2_tp_universal_keeps_the_vocabulary(runs, tmp_path):
    out = str(tmp_path / "gpt2_universal")
    convert_to_universal(os.path.join(runs[2], "gpt2_tag"), out, tag="t")
    from test_torch_universal_checkpoint import _npy
    a = _npy(out, "fp32")["wte/embedding"]
    assert a.shape == (257, 64)
    np.testing.assert_array_equal(
        a, runs[1]["gpt2_ckpt"][0]["saved"]["master"]["wte.embedding"])


@pytest.mark.parametrize("chunk", (0, 64))
def test_gpt2_padded_vocabulary_route_at_tp1(chunk):
    """``gpt2.pad_vocab``: 3 zero rows appended to ``wte`` put one rank
    on the route a tp rank with pad rows takes (pad columns -inf, the
    vocabulary-parallel loss, chunked or not): the loss and every
    gradient of the unpadded model at rtol 1e-5, the pad rows' gradient
    0."""
    cfg = port_gpt2.gpt2_tiny(dtype="float32", remat=False,
                              loss_chunk_vocab=chunk)
    named = port_gpt2.params_from_flax(_gpt2_tree(
        jax_gpt2.gpt2_tiny(dtype="float32"), 31), cfg)
    ids = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, (2, SEQ)))

    def run(pad):
        model = port_gpt2.GPT2Model(cfg, device="meta")
        start = port_gpt2.pad_vocab(model, 3, named) if pad else named
        for name, t in start.items():
            mod, _, leaf = name.rpartition(".")
            setattr(model.get_submodule(mod), leaf,
                    torch.nn.Parameter(t.clone()))
        loss = model(ids, labels=ids)
        loss.backward()
        return loss, {n: p.grad for n, p in model.named_parameters()}

    (want, gw), (got, gg) = run(False), run(True)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    for name, g in gw.items():
        h = gg[name][:g.shape[0]] if name == "wte.embedding" else gg[name]
        np.testing.assert_allclose(h.numpy(), g.numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=name)
    assert not gg["wte.embedding"][256:].any()


# ---------------------------------------------------------------- refusals
@pytest.mark.parametrize("model,item", (("gpt2", "9b"), ("bert", "9b"),
                                        ("mixtral", "8b")))
def test_training_other_models_at_tp_refused(runs, model, item):
    """Refused until items 9b (GPT-2, BERT) and 8b (Mixtral, with
    ``mixtral.tp_rules``): each now builds at tp 2
    (``tests/test_torch_mixtral_parallel.py`` trains Mixtral there against
    JAX)."""
    for r in runs[1][f"refuse_{model}"]:
        assert r["error"] is None, r


@pytest.mark.parametrize("mesh,item", (({"tp": 2, "pp": 2}, "9b"),
                                       ({"tp": 2, "sp": 2}, "9b"),
                                       ({"tp": 2, "ep": 2}, "8b")))
def test_tp_with_other_axes_refused(mesh, item):
    """Refused until items 9b (tp with pp or sp) and 8b (tp with ep): each
    now parses (``tests/test_torch_tp_compose.py`` and
    ``tests/test_torch_mixtral_parallel.py`` train them)."""
    config = {"train_micro_batch_size_per_gpu": 1, "mesh": mesh}
    got = DeepSpeedConfig(config)
    assert got.mesh_tp == 2 and 2 in (got.mesh_pp, got.mesh_sp, got.mesh_ep)


def test_diffusers_injection_refused():
    """Refused until item 9b's last part: ``generic_injection`` and
    ``fused_attention`` now return the injection's context manager
    (``tests/test_torch_diffusers_injection.py`` holds it to JAX's)."""
    for fn in (module_inject.generic_injection,
               module_inject.fused_attention):
        with fn() as icpt:
            assert "CLIPAttention" in icpt.policies


def test_injection_policies_cover_jax_table():
    """The port's policies and the types it refuses are JAX's table; each
    refusal names its item; a config dict builds the port's model."""
    from deepspeed_tpu.module_inject import containers as jax_containers
    from deepspeed_tpu_torch.module_inject import containers
    assert set(containers.POLICIES) | set(containers.UNPORTED) == \
        set(jax_containers.POLICIES)
    assert module_inject.policy_for("llama").model_type == "llama"
    assert module_inject.policy_for(
        {"model_type": "mixtral"}).model_type == "mixtral"
    assert module_inject.policy_for("no_such_arch") is None
    for arch, item in (("falcon", "S5"), ("bloom", "11")):
        with pytest.raises(NotImplementedError, match=rf"item {item}\)"):
            module_inject.policy_for(arch)
    cfg = dict(model_type="llama", vocab_size=64, hidden_size=32,
               intermediate_size=64, num_hidden_layers=1,
               num_attention_heads=4, num_key_value_heads=2)
    model, params = module_inject.replace_transformer_layer(
        "llama", config=cfg, dtype="float32")
    assert params is None and isinstance(model, port_llama.LlamaModel)
    assert model.config.num_key_value_heads == 2
    assert module_inject.revert_transformer_layer(model) is model
