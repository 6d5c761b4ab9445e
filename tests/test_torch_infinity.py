"""ZeRO-Infinity parameter streaming of the port (``InfinityEngine``,
``runtime/zero/infinity.py``) against the JAX package's
(``tests/unit/runtime/test_infinity.py``) on the CPU, from the same flax
weights and batches, the JAX engine on a one-device mesh.

* Llama (4 layers, hidden 32) after 3 steps at gas 1 and at gas 2 with
  clipping: losses rtol 1e-5, master rtol 2e-5 plus lr/20 (the same host
  Adam on gradients summed in another order; ``test_torch_zero.py``'s
  rule); against the port's own ZeRO-0 engine, rtol 2e-3 (the JAX test's:
  the host Adam and the fused Adam round differently);
* GPT-2 streaming parity, the same way (its key biases left out and at
  most 0.1 % of a leaf's elements beyond the master's bound, as
  ``test_torch_zero.py`` holds BERT: gradients at fp32 noise);
* NVMe parameters and state against host memory, exactly; blocks on the
  device ≤ 3; the block-by-block init trains; eval logits;
* the refusals (fp16, a model without ``streaming_parts``, LAMB);
* ``infinity_state.pkl`` saved by each package loads in the other (the
  next steps within the parity tolerance), a port resume exactly, and
  ``save_16bit_model``;
* at world size 2 (two gloo ranks, ``torch_dist_worker.py``, one spawn for
  the module): streaming against JAX's on a dp-2 mesh, with and without
  clipping (the one-rank rule, with the GPT-2 test's allowance of 0.1 %
  of a leaf's elements: a gradient at fp32 noise, summed over two ranks,
  can take Adam's step of the other sign); a world-2 tag resumes exactly and loads at
  one rank (the same state bit for bit, then the steps within rtol 1e-5:
  the one rank sums the batch in another order), a world-1 tag loads at
  two ranks; the universal bridge both ways: JAX's streamed tag through
  JAX's converter into the port (at one rank, then JAX's next steps within
  rtol 1e-5), the port's world-2 tag through the port's converter into
  JAX's dp-2 streaming engine (the next losses rtol 1e-5, the master by
  the one-rank rule), and a world-1 tag through universal into ZeRO 3 and
  back into streaming, bit for bit; streaming under Ulysses at sp 2
  against JAX's streaming engine on an sp-2 mesh (losses at 1e-5, the
  master by the dp-2 rule).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu.comm as jax_dist
import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt2 as jax_gpt2
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch.models import gpt2 as port_gpt2
from deepspeed_tpu_torch.models import llama as port_llama
from deepspeed_tpu_torch.runtime.infinity_engine import InfinityEngine
from test_torch_gpt2_training import _flax_tree as gpt2_tree
from test_torch_llama_training import _flax_tree as llama_tree
from torch_dist_worker import spawn

LR = 0.01
CFG = dict(vocab_size=128, hidden_size=32, intermediate_size=64,
           num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=4,
           max_position_embeddings=64, dtype="float32", remat=False,
           tie_word_embeddings=False)
GPT2 = dict(dtype="float32", remat=False)


def _config(offload="cpu", gas=1, clip=0.0, opt="adam", nvme_path=None,
            stage=3, **extra):
    zero = {"stage": stage}
    if offload is not None:
        zero["offload_param"] = {"device": offload}
        if nvme_path:
            zero["offload_param"]["nvme_path"] = str(nvme_path)
    return {"train_micro_batch_size_per_gpu": 2,
            "gradient_accumulation_steps": gas,
            "optimizer": {"type": opt, "params": {"lr": LR}},
            "gradient_clipping": clip, "zero_optimization": zero, **extra}


def _data(vocab, n=8, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(2, 16)).astype(np.int32)
            for _ in range(n)]


def _train(engine, data, steps, start=0):
    losses, i = [], start
    for _ in range(steps):
        for _ in range(engine.gradient_accumulation_steps()):
            ids = data[i % len(data)]
            i += 1
            if isinstance(engine, InfinityEngine) or \
                    hasattr(engine, "zero_plan"):
                ids = torch.from_numpy(ids)
            loss = engine(ids, ids)
            engine.backward(loss)
            engine.step()
            losses.append(float(loss))
    return losses


@pytest.fixture
def one_device_mesh():
    groups.initialize_mesh(dp=1, devices=jax.devices()[:1])
    yield
    groups.reset_mesh()
    jax_dist.destroy_process_group()


def _llama(**over):
    return (jax_llama.LlamaConfig(**dict(CFG, **over)),
            port_llama.LlamaConfig(**dict(CFG, **over)))


def _port(pcfg, tree, config, mod=port_llama, cls=None):
    cls = cls or mod.LlamaModel
    return deepspeed_tpu_torch.initialize(
        model=cls(pcfg, device="meta"),
        model_parameters=mod.params_from_flax(tree, pcfg, dtype="float32"),
        config=config, device="cpu")[0]


def _jax(jcfg, tree, config, cls=jax_llama.LlamaModel):
    return deepspeed_tpu.initialize(
        model=cls(jcfg), model_parameters=jax.tree_util.tree_map(
            jnp.asarray, tree), config=config)[0]


def _jax_master(jeng, pcfg, mod=port_llama):
    return mod.params_from_flax(jax.tree_util.tree_map(
        np.asarray, jeng.get_fp32_param()), pcfg, dtype="float32")


def _check_master(got, want, noisy=False):
    """rtol 2e-5 plus lr/20 on every element; ``noisy`` (GPT-2, whose
    key biases and some other elements get gradients at the level of fp32
    summation noise, ``test_torch_gpt2_training.py``): key biases left
    out, and at most 0.1 % of a leaf's elements beyond it, as
    ``test_torch_zero.py`` holds BERT."""
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        if not noisy:
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=2e-5,
                                       atol=LR / 20, err_msg=name)
        elif not name.endswith("k_proj.bias"):
            apart = (g - w).abs() > 2e-5 * w.abs() + LR / 20
            assert apart.float().mean().item() <= 1e-3, name


@pytest.mark.parametrize("gas,clip", [(1, 0.0), (2, 1.0)])
def test_streaming_matches_jax(one_device_mesh, gas, clip):
    jcfg, pcfg = _llama()
    tree = llama_tree(jcfg, seed=3)
    data = _data(128)
    jeng = _jax(jcfg, tree, _config(gas=gas, clip=clip))
    eng = _port(pcfg, tree, _config(gas=gas, clip=clip))
    assert isinstance(eng, InfinityEngine)
    want = _train(jeng, data, 3)
    got = _train(eng, data, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _check_master(eng.get_fp32_param(), _jax_master(jeng, pcfg))


def test_streaming_matches_the_port_zero0_engine():
    _, pcfg = _llama()
    tree = llama_tree(jax_llama.LlamaConfig(**CFG), seed=4)
    data = _data(128)
    ref = _train(_port(pcfg, tree, _config(None, stage=0)), data, 6)
    got = _train(_port(pcfg, tree, _config()), data, 6)
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-4)


def test_gpt2_streaming_matches_jax(one_device_mesh):
    jcfg, pcfg = jax_gpt2.gpt2_tiny(**GPT2), port_gpt2.gpt2_tiny(**GPT2)
    tree = gpt2_tree(5)
    data = _data(256)
    jeng = _jax(jcfg, tree, _config(), cls=jax_gpt2.GPT2Model)
    eng = _port(pcfg, tree, _config(), mod=port_gpt2,
                cls=port_gpt2.GPT2Model)
    want = _train(jeng, data, 3)
    got = _train(eng, data, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _check_master(eng.get_fp32_param(), _jax_master(jeng, pcfg, port_gpt2),
                  noisy=True)


def test_nvme_params_and_state_match_host_memory(tmp_path):
    _, pcfg = _llama()
    tree = llama_tree(jax_llama.LlamaConfig(**CFG), seed=6)
    data = _data(128)
    cpu = _port(pcfg, tree, _config())
    nv_cfg = _config("nvme", nvme_path=tmp_path)
    nv_cfg["zero_optimization"]["offload_optimizer"] = {
        "device": "nvme", "nvme_path": str(tmp_path)}
    nv = _port(pcfg, tree, nv_cfg)
    assert nv._store.param_device == nv._store.state_device == "nvme"
    assert _train(nv, data, 3) == _train(cpu, data, 3)
    a, b = cpu.get_fp32_param(), nv.get_fp32_param()
    for name in a:
        assert torch.equal(a[name], b[name]), name
    swp = list(tmp_path.rglob("*.swp"))
    # cache, master and both moments of each block and the resident group
    assert len(swp) >= 4 * (pcfg.num_hidden_layers + 1)


def test_cpu_params_nvme_state_update_the_fetched_weights(tmp_path):
    """fp32 wire, the cache in host memory, the state on NVMe: the sweep
    copies the new master into the cache the next fetch reads."""
    _, pcfg = _llama(num_hidden_layers=2)
    c = _config()
    c["zero_optimization"]["offload_optimizer"] = {
        "device": "nvme", "nvme_path": str(tmp_path)}
    eng = deepspeed_tpu_torch.initialize(
        model=port_llama.LlamaModel(pcfg, device="meta"), config=c,
        device="cpu")[0]
    eng.initialize_parameters(0)
    key = eng._spec.block_keys[0]
    before = eng._store._cache[key].clone()
    losses = _train(eng, _data(128), 3)
    assert not torch.equal(before, eng._store._cache[key])
    assert np.isfinite(losses).all()


def test_blocks_on_the_device_stay_bounded():
    _, pcfg = _llama(num_hidden_layers=6)
    eng = deepspeed_tpu_torch.initialize(
        model=port_llama.LlamaModel(pcfg, device="meta"),
        config=_config(gas=2), device="cpu")[0]
    eng.initialize_parameters(0)
    _train(eng, _data(128), 3)
    assert 0 < eng.max_resident_blocks <= 3, eng.max_resident_blocks
    assert eng.hbm_param_bytes() == 0     # all released at the boundary
    assert eng.params is None and eng.master is None and \
        eng.opt_state is None and eng.grad_acc is None


def test_blockwise_init_trains_and_eval_gives_logits():
    _, pcfg = _llama()
    eng = deepspeed_tpu_torch.initialize(
        model=port_llama.LlamaModel(pcfg, device="meta"),
        config=_config(), device="cpu")[0]
    with pytest.raises(RuntimeError, match="no parameters"):
        eng(torch.zeros(2, 16, dtype=torch.long))
    eng.initialize_parameters(0)
    losses = _train(eng, _data(128, n=1), 10)     # one batch, learnt
    assert losses[-1] < losses[0] * 0.9, losses
    eng.eval()
    ids = torch.from_numpy(_data(128, 1)[0])
    logits = eng(ids)
    assert logits.shape == (2, 16, 128)
    assert np.isfinite(float(eng(ids, ids)))


# ---------------------------------------------------------------- refusals
def _build(config, model=None):
    _, pcfg = _llama()
    return deepspeed_tpu_torch.initialize(
        model=model or port_llama.LlamaModel(pcfg, device="meta"),
        config=config, device="cpu")[0]


def test_fp16_refused():
    with pytest.raises(ValueError, match="bf16/fp32"):
        _build(_config(fp16={"enabled": True}))


def test_model_without_streaming_parts_refused():
    from deepspeed_tpu_torch.models import bert
    with pytest.raises(TypeError, match="streaming_parts"):
        _build(_config(), bert.BertModel(bert.bert_tiny(), device="meta"))


def test_lamb_refused_as_in_jax():
    with pytest.raises(ValueError, match="no host kernel"):
        _build(_config(opt="lamb"))


# ------------------------------------------------------------ world 2
W2_ROWS = 4     # the global batch: 2 rows a rank


def _w2_data(n, seed):
    rng = np.random.default_rng(seed)
    return [(ids, ids) for ids in (
        rng.integers(0, 128, size=(W2_ROWS, 16)).astype(np.int32)
        for _ in range(n))]


def _w2_jax(tree, config, batches, load=None, universal=None):
    """JAX's streaming engine on a dp-2 mesh: the losses and the master
    (port names), after loading ``load`` (a tag dir) or ``universal``."""
    jcfg, pcfg = _llama()
    groups.initialize_mesh(dp=2, devices=jax.devices()[:2])
    try:
        eng = _jax(jcfg, tree, dict(config))
        if load:
            eng.load_checkpoint(load)
        if universal:
            # JAX's streaming engine reads its own tags only; its universal
            # loader takes the directory (universal_checkpoint.py:28)
            from deepspeed_tpu.checkpoint.universal_checkpoint import \
                load_universal_checkpoint
            load_universal_checkpoint(eng, universal)
        losses = []
        for batch in batches:
            loss = eng(*batch)
            eng.backward(loss)
            eng.step()
            losses.append(float(loss))
        return losses, _jax_master(eng, pcfg)
    finally:
        groups.reset_mesh()
        jax_dist.destroy_process_group()


@pytest.fixture(scope="module")
def w2(tmp_path_factory):
    """Every world-2 leg in one spawn, and what the one-rank side saved
    and loaded around it."""
    jcfg, pcfg = _llama()
    tree = llama_tree(jcfg, seed=11)
    tmp = tmp_path_factory.mktemp("w2")
    data = _w2_data(6, 12)
    # a world-1 tag for the world-2 ranks to load
    one = _port(pcfg, tree, _config())
    _train(one, [b[0] for b in data[:2]] * 1, 1)
    one.save_checkpoint(str(tmp / "w1"), tag="t")
    w1_master = one.get_fp32_param()
    # a JAX streamed tag, converted by JAX, for the port to load
    groups.initialize_mesh(dp=1, devices=jax.devices()[:1])
    try:
        jeng = _jax(jcfg, tree, _config())
        _train(jeng, [b[0][:2] for b in data[:2]], 2)
        jeng.save_checkpoint(str(tmp / "jax"), tag="t")
        from deepspeed_tpu.checkpoint import convert_to_universal as jconv
        jconv(str(tmp / "jax"), str(tmp / "jax_uni"), tag="t")
        jax_next = _train(jeng, [b[0][:2] for b in data[2:4]], 2)
    finally:
        groups.reset_mesh()
        jax_dist.destroy_process_group()
    legs = [dict(kind="stream", name=f"gas{gas}_clip{clip}", model="llama",
                 cfg=CFG, tree=tree, config=_config(gas=gas, clip=clip),
                 batches=data[:3 * gas])
            for gas, clip in ((1, 0.0), (2, 1.0))]
    legs.append(dict(kind="stream", name="ckpt", model="llama", cfg=CFG,
                     tree=tree, config=_config(clip=1.0), batches=data[:5],
                     save_at=2, dir=str(tmp / "w2")))
    legs.append(dict(kind="stream", name="from_w1", model="llama", cfg=CFG,
                     tree=tree, config=_config(), load=str(tmp / "w1"),
                     batches=data[2:4]))
    legs.append(dict(kind="stream", name="from_jax_universal",
                     model="llama", cfg=CFG, tree=tree, config=_config(),
                     universal=str(tmp / "jax_uni"), batches=[]))
    legs.append(dict(kind="stream", name="sp2", model="llama",
                     cfg=dict(CFG, use_ulysses=True), tree=tree,
                     config=_config(clip=1.0, sequence_parallel_size=2),
                     batches=[(b[0][:2], b[1][:2]) for b in data[:3]]))
    got = spawn(2, legs, timeout=300)
    return dict(got=got, legs={leg["name"]: leg for leg in legs}, tmp=tmp,
                tree=tree, data=data, w1_master=w1_master,
                jax_next=jax_next)


@pytest.mark.parametrize("gas,clip", [(1, 0.0), (2, 1.0)])
def test_streaming_at_world_two_matches_jax(w2, gas, clip):
    """Two gloo ranks, each holding half of every group, against JAX's
    streaming engine on a dp-2 mesh (the rule of the one-rank test)."""
    leg = w2["legs"][f"gas{gas}_clip{clip}"]
    got = w2["got"][leg["name"]]
    want, master = _w2_jax(leg["tree"], leg["config"], leg["batches"])
    assert got[0]["losses"] == got[1]["losses"]
    np.testing.assert_allclose(got[0]["losses"], want, rtol=1e-5)
    # an element whose gradient is fp32 noise, summed over the ranks in
    # another order than JAX's, takes Adam's step of the other sign: at
    # most 0.1 % of a leaf beyond the rule (the GPT-2 test's allowance)
    for r in range(2):
        _check_master({n: torch.from_numpy(a) for n, a in
                       got[r]["master"].items()}, master, noisy=True)
    # each rank holds half of each group, 16 · 2 aligned
    sizes = got[0]["store_numel"]
    assert sizes == got[1]["store_numel"] and all(
        n % 16 == 0 for n in sizes.values())


def test_streaming_at_sp2_matches_jax(w2):
    """Streaming under Ulysses at sp 2 (two gloo ranks, each its half of
    the sequence; each streamed block's forward and recompute run
    DistributedAttention; the store sharded over the dp × sp group)
    against JAX's streaming engine on an sp-2 mesh: losses at rtol 1e-5,
    the master by the noisy rule of the dp-2 test."""
    leg = w2["legs"]["sp2"]
    got = w2["got"]["sp2"]
    jcfg, pcfg = _llama(use_ulysses=True)
    groups.initialize_mesh(dp=1, sp=2, devices=jax.devices()[:2])
    try:
        eng = _jax(jcfg, leg["tree"], dict(leg["config"]))
        want = _train(eng, [b[0] for b in leg["batches"]], len(
            leg["batches"]))
        master = _jax_master(eng, pcfg)
    finally:
        groups.reset_mesh()
        jax_dist.destroy_process_group()
    assert got[0]["losses"] == got[1]["losses"]
    np.testing.assert_allclose(got[0]["losses"], want, rtol=1e-5)
    for r in range(2):
        _check_master({n: torch.from_numpy(a) for n, a in
                       got[r]["master"].items()}, master, noisy=True)


def test_world_two_tag_resumes_exactly_and_loads_at_world_one(w2):
    res = w2["got"]["ckpt"]
    for r in res:
        assert r["resumed"] == r["losses"][3:]
        for name, a in r["saved"].items():
            np.testing.assert_array_equal(r["resumed_master"][name], a)
    # the same tag at one rank: the same state, then the same steps
    _, pcfg = _llama()
    one = deepspeed_tpu_torch.initialize(
        model=port_llama.LlamaModel(pcfg, device="meta"),
        config=_config(clip=1.0), device="cpu")[0]
    one.load_checkpoint(str(w2["tmp"] / "w2"))
    for name, t in one.get_fp32_param().items():
        np.testing.assert_array_equal(t.numpy(), res[0]["saved"][name])
    assert one.global_steps == 3
    got = _train(one, [b[0] for b in w2["data"][3:5]], 2)
    np.testing.assert_allclose(got, res[0]["losses"][3:], rtol=1e-5)


def test_world_one_tag_loads_at_world_two(w2):
    res = w2["got"]["from_w1"]
    for r in res:
        assert r["steps"] == 1 + len(w2["legs"]["from_w1"]["batches"])
        for name, t in w2["w1_master"].items():
            np.testing.assert_array_equal(r["loaded"][name], t.numpy())
    # the next steps are the one-rank engine's, to the reduction order
    _, pcfg = _llama()
    one = _port(pcfg, w2["tree"], _config())
    one.load_checkpoint(str(w2["tmp"] / "w1"))
    want = _train(one, [b[0] for b in w2["data"][2:4]], 2)
    np.testing.assert_allclose(res[0]["losses"], want, rtol=1e-5)


def test_jax_streamed_tag_reaches_the_port_through_universal(w2):
    """JAX's ``infinity_state.pkl`` → JAX's converter → a port streaming
    engine: at two ranks (each its slices) and at one, which then trains
    as JAX's engine went on (rtol 1e-5)."""
    jcfg, pcfg = _llama()
    res = w2["got"]["from_jax_universal"]
    one = deepspeed_tpu_torch.initialize(
        model=port_llama.LlamaModel(pcfg, device="meta"),
        config=_config(checkpoint={"load_universal": True}),
        device="cpu")[0]
    one.load_checkpoint(str(w2["tmp"] / "jax_uni"))
    assert one.global_steps == 2 and res[0]["steps"] == 2
    master = one.get_fp32_param()
    for r in res:
        for name, t in master.items():
            np.testing.assert_array_equal(r["loaded"][name], t.numpy())
    got = _train(one, [b[0][:2] for b in w2["data"][2:4]], 2)
    np.testing.assert_allclose(got, w2["jax_next"], rtol=1e-5)


def test_port_world_two_tag_reaches_jax_through_universal(w2):
    """The port's world-2 tag → the port's converter → JAX's streaming
    engine on a dp-2 mesh, which trains as the port's ranks went on."""
    from deepspeed_tpu_torch.checkpoint import convert_to_universal
    out = w2["tmp"] / "port_uni"
    convert_to_universal(str(w2["tmp"] / "w2"), str(out), tag="t")
    res = w2["got"]["ckpt"][0]
    leg = w2["legs"]["ckpt"]
    want, master = _w2_jax(w2["tree"], leg["config"],
                           leg["batches"][3:], universal=str(out))
    np.testing.assert_allclose(want, res["losses"][3:], rtol=1e-5)
    _check_master({n: torch.from_numpy(a) for n, a in
                   res["master"].items()}, master, noisy=True)


def test_streamed_tag_and_universal_round_trip_at_one_rank(tmp_path):
    """A world-1 tag → universal → a ZeRO-3 engine and back into a
    streaming engine: the master bit for bit, the counters, the
    scheduler."""
    from deepspeed_tpu_torch.checkpoint import convert_to_universal
    _, pcfg = _llama()
    sched = {"type": "WarmupLR", "params": {"warmup_num_steps": 10}}
    eng = _port(pcfg, llama_tree(jax_llama.LlamaConfig(**CFG), seed=13),
                _config(scheduler=sched))
    _train(eng, _data(128), 3)
    eng.save_checkpoint(str(tmp_path / "s"), tag="t",
                        client_state={"epoch": 4})
    convert_to_universal(str(tmp_path / "s"), str(tmp_path / "u"), tag="t")
    z3 = deepspeed_tpu_torch.initialize(
        model=port_llama.LlamaModel(pcfg, device="meta"),
        config=_config(None, scheduler=sched,
                       checkpoint={"load_universal": True}),
        device="cpu")[0]
    _, client = z3.load_checkpoint(str(tmp_path / "u"))
    assert client == {"epoch": 4} and z3.global_steps == 3
    assert z3.get_lr() == eng.get_lr()
    master = eng.get_fp32_param()
    for name, t in master.items():
        assert torch.equal(z3.get_fp32_param(name), t), name
    back = deepspeed_tpu_torch.initialize(
        model=port_llama.LlamaModel(pcfg, device="meta"),
        config=_config(scheduler=sched, checkpoint={"load_universal": True}),
        device="cpu")[0]
    back.load_checkpoint(str(tmp_path / "u"))
    for name, t in back.get_fp32_param().items():
        assert torch.equal(t, master[name]), name
    assert _train(back, _data(128), 2, start=3) == \
        _train(eng, _data(128), 2, start=3)


# ------------------------------------------------------------ checkpoints
@pytest.mark.parametrize("writer", ("jax", "port"))
def test_infinity_state_crosses_packages(one_device_mesh, tmp_path, writer):
    jcfg, pcfg = _llama()
    tree = llama_tree(jcfg, seed=8)
    data = _data(128)
    jeng = _jax(jcfg, tree, _config())
    peng = _port(pcfg, tree, _config())
    _train(jeng, data, 2)
    _train(peng, data, 2)
    src = jeng if writer == "jax" else peng
    src.save_checkpoint(str(tmp_path), tag="t")
    assert os.path.exists(tmp_path / "t" / "infinity_state.pkl")
    if writer == "jax":
        dst = deepspeed_tpu_torch.initialize(
            model=port_llama.LlamaModel(pcfg, device="meta"),
            config=_config(), device="cpu")[0]
    else:
        dst = _jax(jcfg, llama_tree(jcfg, seed=9), _config())
    dst.load_checkpoint(str(tmp_path))
    assert dst.global_steps == 2
    got = _train(dst, data, 2, start=2)
    want = _train(src, data, 2, start=2)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    port = dst if writer == "jax" else src
    other = src if writer == "jax" else dst
    _check_master(port.get_fp32_param(), _jax_master(other, pcfg))


def test_resume_is_exact_and_async_save_commits(tmp_path):
    _, pcfg = _llama()
    tree = llama_tree(jax_llama.LlamaConfig(**CFG), seed=10)
    data = _data(128)
    eng = _port(pcfg, tree, _config())
    _train(eng, data, 3)
    eng.save_checkpoint(str(tmp_path), async_save=True)
    cont = _train(eng, data, 3, start=3)
    eng.wait_for_checkpoint()
    with open(tmp_path / "latest") as f:
        assert f.read() == "global_step3"
    fresh = deepspeed_tpu_torch.initialize(
        model=port_llama.LlamaModel(pcfg, device="meta"),
        config=_config(), device="cpu")[0]
    fresh.load_checkpoint(str(tmp_path))
    assert fresh.global_steps == 3
    assert _train(fresh, data, 3, start=3) == cont
    a, b = eng.get_fp32_param(), fresh.get_fp32_param()
    for name in a:
        assert torch.equal(a[name], b[name]), name


def test_save_16bit_model_from_the_host_store(tmp_path):
    _, pcfg = _llama(dtype="bfloat16")
    eng = deepspeed_tpu_torch.initialize(
        model=port_llama.LlamaModel(pcfg, device="meta"),
        config=_config(bf16={"enabled": True},
                       zero_optimization={
                           "stage": 3, "offload_param": {"device": "cpu"},
                           "stage3_gather_16bit_weights_on_model_save":
                               True}),
        device="cpu")[0]
    eng.initialize_parameters(0)
    _train(eng, _data(128), 1)
    assert eng.save_16bit_model(str(tmp_path))
    sd = torch.load(tmp_path / "pytorch_model.bin")
    master = eng.get_fp32_param()
    assert list(sd) == [n for n, _ in eng.module.named_parameters()]
    for name, t in sd.items():
        assert t.dtype == torch.bfloat16
        assert torch.equal(t, master[name].to(torch.bfloat16)), name
