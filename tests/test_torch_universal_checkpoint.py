"""Checkpoints across the two packages, on the CPU at ``llama_tiny`` width:
the same numpy weights go to the JAX engine as a flax tree and to the port
through ``params_from_flax``, the same numpy batches to both.

* JAX → port: the JAX engine trains, saves (orbax) and
  ``convert_to_universal`` writes the universal layout; the port loads it
  with ``checkpoint.load_universal`` at ZeRO 0 and 3 (its state just after
  the load equals the ``.npy`` files exactly) and continues; its losses
  match JAX's own continuation from its native tag at rtol 1e-5 (fp32),
  the master at rtol 2e-5 + lr/20 (``tests/test_torch_zero.py``'s
  tolerances).
* Port → JAX: the port saves and its ``convert_to_universal`` writes JAX
  names and shapes; JAX's ``load_universal_checkpoint`` loads the result
  and continues, at the same tolerances against the port's uninterrupted
  run.  JAX's ``migrate_torch_checkpoint`` reads the port's native tag
  (``params_to_flax`` as its ``transform``) into the same files, and JAX's
  ``verify_checkpoint_tag`` calls a port tag valid, then corrupt once a
  file is truncated.
* Upstream DeepSpeed tags, stage 2 (``param_slice_mappings``) and stage 3
  (``fp32_flat_groups``) at dp 2, written as
  ``tests/unit/checkpoint/test_torch_migration.py:66, :214`` writes them:
  the port loads them natively at world 1 and holds what JAX's
  ``migrate_torch_checkpoint`` makes of the same files.
* ``zero_to_fp32`` and ``save_16bit_model`` against the JAX exports of the
  same training, after the name map; the recovery script copied into
  ``save_dir`` runs in a subprocess; a stage-3 16-bit export gathers unit
  by unit and equals stage 0's.
* ``params_to_flax`` is the exact inverse of ``params_from_flax``.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu.comm as jax_dist
import deepspeed_tpu_torch
from deepspeed_tpu.checkpoint import convert_to_universal as jax_convert
from deepspeed_tpu.checkpoint import zero_to_fp32 as jax_z2f
from deepspeed_tpu.checkpoint.torch_migration import migrate_torch_checkpoint
from deepspeed_tpu.models import bert as jax_bert
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu.runtime.checkpoint_engine import \
    verify_checkpoint_tag as jax_verify
from deepspeed_tpu.runtime.utils import load_16bit_npz
from deepspeed_tpu.utils import groups
from deepspeed_tpu.utils.fault_injection import truncate_file_in_tag
from deepspeed_tpu_torch.checkpoint import (
    DeepSpeedCheckpoint, convert_to_universal,
    get_fp32_state_dict_from_zero_checkpoint)
from deepspeed_tpu_torch.checkpoint.torch_migration import (
    load_torch_deepspeed_checkpoint)
from deepspeed_tpu_torch.checkpoint.torch_migration import \
    migrate_torch_checkpoint as migrate_port
from deepspeed_tpu_torch.models import bert as port_bert
from deepspeed_tpu_torch.models import gpt2 as port_gpt2
from deepspeed_tpu_torch.models import llama as port_llama
from test_torch_bert import flax_tree as bert_tree
from test_torch_gpt2_training import _flax_tree as gpt2_tree
from test_torch_llama_training import _flax_tree as llama_tree
from torch_dist_worker import gathered_state
from tests.unit.checkpoint.test_torch_migration import (
    _write_fixture, _write_stage3_fixture)

SEQ, LR = 16, 2e-3
LLAMA = dict(dtype="float32", remat=False, num_key_value_heads=2)
JCFG, PCFG = jax_llama.llama_tiny(**LLAMA), port_llama.llama_tiny(**LLAMA)
TREE = llama_tree(JCFG, seed=13)


@pytest.fixture
def one_device_mesh():
    groups.initialize_mesh(dp=1, devices=jax.devices()[:1])
    yield
    groups.reset_mesh()
    jax_dist.destroy_process_group()


def _config(stage=0, **extra):
    zero = ({"stage": 3, "stage3_param_persistence_threshold": 0}
            if stage == 3 else {"stage": stage})
    return {"train_micro_batch_size_per_gpu": 2,
            "optimizer": {"type": "fusedadam", "params": {"lr": LR}},
            "zero_optimization": zero, **extra}


def _batches(n, seed=17):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(2, SEQ)).astype(np.int32)
            for _ in range(n)]


def _jax_engine(config, tree=TREE):
    return deepspeed_tpu.initialize(
        model=jax_llama.LlamaModel(JCFG),
        model_parameters=jax.tree_util.tree_map(jnp.asarray, tree),
        config=dict(config))[0]


def _port_engine(config, weights=True):
    start = port_llama.params_from_flax(TREE, PCFG, dtype="float32")
    return deepspeed_tpu_torch.initialize(
        model=port_llama.LlamaModel(PCFG, device="meta"),
        model_parameters=start if weights else None, config=dict(config),
        device="cpu")[0]


def _train(engine, batches):
    out = []
    for ids in batches:
        loss = engine(ids, ids)
        engine.backward(loss)
        engine.step()
        out.append(float(loss))
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _check_master(port_engine, jax_tree):
    want = port_llama.params_from_flax(
        jax.tree_util.tree_map(np.asarray, jax_tree), PCFG, dtype="float32")
    got = gathered_state(port_engine)["master"]
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w.numpy(), rtol=2e-5,
                                   atol=LR / 20, err_msg=name)


def _npy(root, field):
    zero = os.path.join(root, "zero")
    out = {}
    for dirpath, _, files in os.walk(zero):
        if f"{field}.npy" in files:
            out[os.path.relpath(dirpath, zero)] = np.load(
                os.path.join(dirpath, f"{field}.npy"))
    return out


# ---------------------------------------------------------- JAX → port
@pytest.mark.parametrize("stage", (0, 3))
def test_jax_tag_resumes_in_the_port(stage, tmp_path, one_device_mesh):
    batches = _batches(6)
    jeng = _jax_engine(_config())
    _train(jeng, batches[:3])
    jeng.save_checkpoint(str(tmp_path / "jax"), tag="t")
    uni = str(tmp_path / "universal")
    jax_convert(str(tmp_path / "jax"), uni, tag="t")
    # JAX's own continuation from its native tag
    jres = _jax_engine(_config())
    jres.load_checkpoint(str(tmp_path / "jax"), tag="t")
    want = _train(jres, batches[3:])

    peng = _port_engine(_config(stage, checkpoint={"load_universal": True}),
                        weights=False)
    peng.load_checkpoint(uni)
    loaded = gathered_state(peng)
    assert loaded["count"] == 3 and loaded["steps"] == 3
    for field, key in (("fp32", "master"), ("exp_avg", "exp_avg"),
                       ("exp_avg_sq", "exp_avg_sq")):
        files = port_llama.params_from_flax(
            jax_llama_tree(_npy(uni, field)), PCFG, dtype="float32")
        for name, w in files.items():
            np.testing.assert_array_equal(loaded[key][name], w.numpy(),
                                          err_msg=f"{field} {name}")
    got = _train(peng, batches[3:])
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _check_master(peng, jres.get_fp32_param())


def jax_llama_tree(flat):
    tree = {}
    for path, a in flat.items():
        node = tree
        *parents, last = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = a
    return tree


# ---------------------------------------------------------- port → JAX
def test_port_tag_resumes_in_jax(tmp_path, one_device_mesh):
    batches = _batches(6, seed=18)
    peng = _port_engine(_config(1))
    _train(peng, batches[:3])
    peng.save_checkpoint(str(tmp_path / "port"), tag="t")
    want = _train(peng, batches[3:])
    uni = str(tmp_path / "universal")
    convert_to_universal(str(tmp_path / "port"), uni, tag="t")
    # the universal files hold JAX names and shapes
    fp32 = _npy(uni, "fp32")
    assert set(fp32) == set(_flat(TREE))
    for path, a in _flat(TREE).items():
        assert fp32[path].shape == a.shape

    jeng = _jax_engine(_config(checkpoint={"load_universal": True}))
    jeng.load_checkpoint(uni)
    assert jeng.global_steps == 3
    assert int(jeng.opt_state.count) == 3
    got = _train(jeng, batches[3:])
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _check_master(peng, jeng.get_fp32_param())

    # JAX's migration reads the port's native tag into the same files
    def transform(name, arr):
        (path, a), = _flat(port_llama.params_to_flax({name: arr},
                                                     PCFG)).items()
        return path, a

    mig = str(tmp_path / "migrated")
    migrate_torch_checkpoint(str(tmp_path / "port"), mig, tag="t",
                             transform=transform)
    for field in ("fp32", "exp_avg", "exp_avg_sq"):
        a, b = _npy(uni, field), _npy(mig, field)
        assert set(a) == set(b)
        for path in a:
            np.testing.assert_array_equal(a[path], b[path])


def test_jax_verifies_a_port_tag(tmp_path):
    peng = _port_engine(_config(2))
    _train(peng, _batches(1))
    peng.save_checkpoint(str(tmp_path), tag="t")
    assert jax_verify(str(tmp_path / "t")) == ("valid", "ok")
    truncate_file_in_tag(str(tmp_path / "t"),
                         "zero_pp_rank_0_mp_rank_00_optim_states.pt")
    assert jax_verify(str(tmp_path / "t"))[0] == "corrupt"


# ------------------------------------------------------- upstream tags
D, H = 8, 12


class MLP(torch.nn.Module):
    """The upstream fixtures' model: ``fc1`` [H, D], ``fc2`` [D, H]."""

    def __init__(self):
        super().__init__()
        self.fc1 = torch.nn.Linear(D, H)
        self.fc2 = torch.nn.Linear(H, D)

    def forward(self, x, y):
        return ((self.fc2(torch.relu(self.fc1(x))) - y) ** 2).mean()


@pytest.mark.parametrize("stage", (2, 3))
def test_upstream_tag_loads_natively(stage, tmp_path):
    ckpt = str(tmp_path / "torch_ckpt")
    write = _write_fixture if stage == 2 else _write_stage3_fixture
    params, moments = write(ckpt)
    mig = str(tmp_path / "migrated")
    migrate_torch_checkpoint(ckpt, mig)
    engine = deepspeed_tpu_torch.initialize(
        model=MLP(), config={"train_micro_batch_size_per_gpu": 4,
                             "optimizer": {"type": "adam",
                                           "params": {"lr": 1e-3}},
                             "zero_optimization": {"stage": 1}},
        device="cpu")[0]
    if stage == 2:
        root, _ = engine.load_checkpoint(ckpt)
    else:
        root, _ = load_torch_deepspeed_checkpoint(engine, ckpt)
    assert root is not None
    got = gathered_state(engine)
    # the port's migration keeps the torch names: the same arrays as JAX's
    port_mig = str(tmp_path / "port_migrated")
    migrate_port(ckpt, port_mig)
    for field in ("fp32", "exp_avg", "exp_avg_sq"):
        jax_files, port_files = _npy(mig, field), _npy(port_mig, field)
        for name in params:
            mod, leaf = name.split(".")
            w = jax_files[f"{mod}/kernel"].T if leaf == "weight" else \
                jax_files[f"{mod}/bias"]
            np.testing.assert_array_equal(port_files[name], w)
    steps = 5 if stage == 2 else 9
    assert got["steps"] == steps and got["count"] == steps
    for field, key in (("fp32", "master"), ("exp_avg", "exp_avg"),
                       ("exp_avg_sq", "exp_avg_sq")):
        files = _npy(mig, field)
        for name in params:
            mod, leaf = name.split(".")
            w = files[f"{mod}/kernel"].T if leaf == "weight" else \
                files[f"{mod}/bias"]
            np.testing.assert_array_equal(got[key][name], w)
            src = params if field == "fp32" else moments[field]
            np.testing.assert_array_equal(got[key][name], src[name])
    # the parameters: the module's weights at stage 2, the master's cast at
    # stage 3 (whose model states hold placeholders)
    for name in params:
        np.testing.assert_array_equal(got["params"][name], params[name])
    # the moments are live: a step moves the weights
    x = np.ones((4, D), np.float32)
    engine.backward(engine(x, x))
    engine.step()
    assert engine.opt_state.count == steps + 1
    assert not np.array_equal(gathered_state(engine)["master"]["fc1.weight"],
                              params["fc1.weight"])


# ------------------------------------------------- exports against JAX
def test_zero_to_fp32_and_16bit_exports_match_jax(tmp_path, one_device_mesh):
    batches = _batches(2, seed=19)
    jeng, peng = _jax_engine(_config()), _port_engine(_config(1))
    _train(jeng, batches)
    _train(peng, batches)
    jeng.save_checkpoint(str(tmp_path / "jax"), tag="t")
    peng.save_checkpoint(str(tmp_path / "port"), tag="t")
    want = port_llama.params_from_flax(jax_llama_tree(
        jax_z2f.get_fp32_state_dict_from_zero_checkpoint(
            str(tmp_path / "jax"))), PCFG, dtype="float32")
    got = get_fp32_state_dict_from_zero_checkpoint(str(tmp_path / "port"))
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=2e-5,
                                   atol=LR / 20, err_msg=name)
    np.testing.assert_array_equal(
        torch.cat([t.reshape(-1) for t in got.values()]).numpy(),
        np.concatenate([gathered_state(peng)["master"][n].reshape(-1)
                        for n in got]))

    jpath = jeng.save_16bit_model(str(tmp_path / "jax16"))
    assert peng.save_16bit_model(str(tmp_path / "port16"))
    w16 = port_llama.params_from_flax(jax_llama_tree(load_16bit_npz(jpath)),
                                      PCFG, dtype="float32")
    g16 = torch.load(tmp_path / "port16" / "pytorch_model.bin")
    assert list(g16) == [n for n, *_ in peng._layout]
    for name, w in w16.items():
        assert g16[name].dtype == torch.float32
        np.testing.assert_allclose(g16[name].numpy(), w.numpy(), rtol=2e-5,
                                   atol=LR / 20, err_msg=name)

    # the recovery script beside the tags runs alone, outside the repo
    out = tmp_path / "recovered.pt"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, str(tmp_path / "port" /
                                        "zero_to_fp32.py"),
                    str(tmp_path / "port"), str(out)], check=True,
                   cwd=str(tmp_path), env=env, capture_output=True)
    rec = torch.load(out)
    assert list(rec) == list(got)
    for name, t in got.items():
        assert torch.equal(rec[name], t)


def test_stage3_16bit_export_gathers_unit_by_unit(tmp_path):
    bf16 = {"bf16": {"enabled": True}}
    z0 = _port_engine(_config(0, **bf16))
    z3 = _port_engine(dict(_config(3, **bf16), zero_optimization={
        "stage": 3, "stage3_param_persistence_threshold": 0,
        "stage3_gather_16bit_weights_on_model_save": True}))
    off = _port_engine(_config(3, **bf16))
    for eng in (z0, z3, off):
        _train(eng, _batches(2, seed=20))
    assert not off.save_16bit_model(str(tmp_path / "off"))
    assert not os.path.exists(tmp_path / "off")
    z3._coord.peak_live_elems = z3._coord.live_elems
    assert z3.save_16bit_model(str(tmp_path / "z3"), "model.bin")
    biggest = max(z3.zero_plan.unit_numel)
    assert z3._coord.peak_live_elems - z3._coord.live_elems <= biggest
    z0.save_16bit_model(str(tmp_path / "z0"), "model.bin")
    a = torch.load(tmp_path / "z3" / "model.bin")
    b = torch.load(tmp_path / "z0" / "model.bin")
    assert set(a) == set(b)
    for name in b:
        assert a[name].dtype == torch.bfloat16
        assert torch.equal(a[name], b[name]), name


def test_inspection_of_a_port_tag_and_its_universal_form(tmp_path):
    peng = _port_engine(_config(2))
    _train(peng, _batches(2, seed=21))
    peng.save_checkpoint(str(tmp_path / "port"))
    uni = str(tmp_path / "universal")
    convert_to_universal(str(tmp_path / "port"), uni)
    tag = DeepSpeedCheckpoint(str(tmp_path / "port"))
    assert not tag.is_universal and tag.get_iteration() == 2
    assert tag.zero_stage == 2 and tag.dp_degree == 1
    state = gathered_state(peng)
    name = "model.layers.0.self_attn.q_proj.weight"
    assert tag.parameter_shapes()[name] == (64, 64)
    np.testing.assert_array_equal(tag.get_parameter(name, "exp_avg"),
                                  state["exp_avg"][name])
    u = DeepSpeedCheckpoint(uni)
    assert u.is_universal and u.get_iteration() == 2
    path = "layers_0/self_attn/q_proj/kernel"
    assert u.parameter_shapes()[path] == (64, 4, 16)
    np.testing.assert_array_equal(
        u.get_parameter(path, "exp_avg"),
        state["exp_avg"][name].T.reshape(64, 4, 16))


# ------------------------------------------------------- params_to_flax
@pytest.mark.parametrize("model", ("llama", "gpt2", "bert"))
def test_params_to_flax_inverts_params_from_flax(model):
    if model == "llama":
        cases = [(llama_tree(jax_llama.llama_tiny(**over), seed=3),
                  port_llama, port_llama.llama_tiny(**over))
                 for over in (dict(LLAMA, attention_bias=True),
                              dict(LLAMA, tie_word_embeddings=True))]
    elif model == "gpt2":
        cases = [(gpt2_tree(3), port_gpt2, port_gpt2.gpt2_tiny())]
    else:
        cases = [(bert_tree(jax_bert.bert_tiny(), seed=3), port_bert,
                  port_bert.bert_tiny())]
    for tree, mod, cfg in cases:
        back = _flat(mod.params_to_flax(
            mod.params_from_flax(tree, cfg, dtype="float32"), cfg))
        want = _flat(tree)
        assert set(back) == set(want)
        for path, a in want.items():
            assert back[path].shape == a.shape and back[path].dtype == \
                np.float32
            np.testing.assert_array_equal(back[path], a)
