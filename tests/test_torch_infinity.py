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
* the refusals (fp16, a model without ``streaming_parts``, LAMB, world
  size > 1, the universal checkpoint);
* ``infinity_state.pkl`` saved by each package loads in the other (the
  next steps within the parity tolerance), a port resume exactly, and
  ``save_16bit_model``.
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


def test_world_above_one_names_its_item(monkeypatch):
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine

    def two_ranks(self, *a):
        self.dp_world_size, self.dp_rank = 2, 0

    monkeypatch.setattr(DeepSpeedEngine, "_init_comm", two_ranks)
    with pytest.raises(NotImplementedError, match=r"queue A, item 10\)"):
        _build(_config())


def test_universal_checkpoint_names_its_item(tmp_path):
    eng = _build(_config(checkpoint={"load_universal": True}))
    with pytest.raises(NotImplementedError, match=r"queue A, item 10\)"):
        eng.load_checkpoint(str(tmp_path))
    from deepspeed_tpu_torch.checkpoint import convert_to_universal
    plain = _build(_config())
    plain.initialize_parameters(0)
    plain.save_checkpoint(str(tmp_path / "ck"), tag="t")
    with pytest.raises(NotImplementedError, match=r"queue A, item 10\)"):
        convert_to_universal(str(tmp_path / "ck"), str(tmp_path / "u"),
                             tag="t")


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
