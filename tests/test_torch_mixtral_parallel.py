"""Mixtral trained expert- and tensor-parallel by the port against the JAX
engine on the same mesh of the 8-device CPU mesh, from the same numpy
weights (``test_torch_mixtral_training.py``'s flax tree) and batches, at
``mixtral_tiny`` size in fp32.

* ep 2 and tp 2 (world 2), tp 2 × ep 2, dp 2 × ep 2 and ep 2 × sp 2
  (Ulysses on the attention, the exchange over ep on each rank's
  sequence chunk; world 4), each at ZeRO 1 and 3, four SGD steps with clipping (as ``test_torch_moe.py``'s,
  whose master tolerance Adam's sign-like updates of near-zero gradients
  would not keep): the losses, the gradient norms and the final master
  equal JAX's (losses and norms rtol 1e-5; the master rtol 1e-5 plus 1e-6,
  ``test_torch_moe.py``'s);
* one micro-step at tp 2 (ZeRO 0): every leaf's gradient, the router's
  above all (the sum over tp of its partial gradients), against
  ``jax.grad`` of the flax model, ``test_torch_mixtral_training.py``'s
  model-gradient tolerance (rtol 1e-4 plus 1e-5); every tp rank routes
  alike; B7's plain version sees the E/ep and I/tp stacks;
* a tag saved at tp 2 × ep 2 loads at tp 1 × ep 1 and trains on as the
  saving run, and its universal form is leaf for leaf the JAX engine's at
  tp 1 after the same steps.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import deepspeed_tpu
import deepspeed_tpu.comm as jax_dist
from deepspeed_tpu.checkpoint import convert_to_universal as jax_convert
from deepspeed_tpu.models import mixtral as jax_mixtral
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch.checkpoint import convert_to_universal
from deepspeed_tpu_torch.models import mixtral as port_mixtral
from test_torch_mixtral_training import _batches, _flax_tree
from test_torch_tp import _npy
from torch_dist_worker import spawn

CFG = dict(dtype="float32", remat=False)
JCFG = jax_mixtral.mixtral_tiny(**CFG)
PCFG = port_mixtral.mixtral_tiny(**CFG)
TREE = _flax_tree(JCFG, seed=7)
ROWS, STEPS, LR = 4, 4, 2e-3
BATCHES = [(b, b) for b in _batches(STEPS, ROWS, seed=11)]
RULES = port_mixtral.tp_rules(PCFG)
# name: (world, mesh)
MESHES = {"ep2": (2, {"ep": 2}), "tp2": (2, {"tp": 2}),
          "tp2ep2": (4, {"tp": 2, "ep": 2}), "dp2ep2": (4, {"ep": 2}),
          "ep2sp2": (4, {"ep": 2, "sp": 2})}
LEGS = [f"{m}_z{z}" for m in MESHES for z in (1, 3)]
# Ulysses on the attention where the mesh has sp
ULYSSES = dict(use_ulysses=True)


def _cfg(mesh):
    return dict(CFG, **ULYSSES) if mesh.get("sp", 1) > 1 else CFG


def _config(stage, mesh, opt="sgd"):
    zero = {"stage": stage}
    if stage == 3:
        # the tiny leaves sit below the default persistence threshold
        zero["stage3_param_persistence_threshold"] = 0
    lr = {"sgd": 0.1, "fusedadam": LR}[opt]
    return {"train_batch_size": ROWS, "gradient_clipping": 1.0,
            "optimizer": {"type": opt, "params": {"lr": lr}},
            "zero_optimization": zero, "mesh": dict(mesh)}


def _port_names(tree):
    return {n: t.numpy() for n, t in port_mixtral.params_from_flax(
        jax.tree_util.tree_map(np.asarray, tree), PCFG,
        dtype="float32").items()}


def _jax_engine(world, mesh, config):
    tp, ep, sp = mesh.get("tp", 1), mesh.get("ep", 1), mesh.get("sp", 1)
    groups.initialize_mesh(dp=world // (tp * sp), ep=ep, sp=sp, tp=tp,
                           devices=jax.devices()[:world])
    return deepspeed_tpu.initialize(
        model=jax_mixtral.MixtralModel(jax_mixtral.mixtral_tiny(
            **_cfg(mesh))),
        model_parameters=jax.tree_util.tree_map(jnp.asarray, TREE),
        config=config, tp_rules=jax_mixtral.tp_rules(JCFG))[0]


def _jax_run(world, mesh, stage):
    """The JAX engine on ``world`` devices at ``mesh``: losses, gradient
    norms and the final master by port name."""
    try:
        eng = _jax_engine(world, mesh, _config(stage, mesh))
        losses, gnorms = [], []
        report = eng._report_step_metrics     # sees each boundary's norm

        def record(gnorm):
            gnorms.append(float(gnorm))
            report(gnorm)

        eng._report_step_metrics = record
        for batch in BATCHES:
            loss = eng(*batch)
            eng.backward(loss)
            eng.step()
            losses.append(float(loss))
        return dict(losses=losses, gnorms=gnorms,
                    master=_port_names(eng.get_fp32_param()))
    finally:
        groups.reset_mesh()
        jax_dist.destroy_process_group()


def _leg(name, **kw):
    mesh = MESHES[name.split("_")[0]][1]
    stage = int(name.rsplit("_z", 1)[1]) if "_z" in name else 0
    return dict(dict(name=name, kind="train", model="mixtral",
                     cfg=_cfg(mesh),
                     tree=TREE, config=_config(stage, mesh),
                     batches=BATCHES,
                     tp_rules=RULES if "tp" in mesh else None), **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both spawns (worlds 2 and 4) and the JAX runs, once a module."""
    ckpt = str(tmp_path_factory.mktemp("mixtral_tp2ep2"))
    two = [_leg(n) for n in LEGS if MESHES[n.split("_")[0]][0] == 2]
    two += [dict(_leg(f"{m}_grads"), kind="mixtral_grads",
                 batch=BATCHES[0]) for m in ("ep2", "tp2")]
    four = [_leg(n) for n in LEGS if MESHES[n.split("_")[0]][0] == 4]
    four.append(dict(_leg("tp2ep2_grads"), kind="mixtral_grads",
                     batch=BATCHES[0]))
    four.append(dict(_leg("tp2ep2_z1"), name="ckpt", kind="ckpt", k=2,
                     dir=ckpt, config=_config(1, MESHES["tp2ep2"][1],
                                              "fusedadam"),
                     resume={"tp1ep1": _config(1, {}, "fusedadam")}))
    out = spawn(2, two)
    out.update(spawn(4, four))
    out["ckpt_dir"] = ckpt
    for name in LEGS:
        world, mesh = MESHES[name.split("_")[0]]
        out["jax_" + name] = _jax_run(world, mesh, int(name[-1]))
    return out


@pytest.mark.parametrize("leg", LEGS)
def test_mixtral_parallel_matches_the_jax_engine(runs, leg):
    """Every rank reports the global loss; the losses, the gradient norms
    (each expert and each tp slice counted once) and the final master are
    JAX's on the same mesh."""
    want = runs["jax_" + leg]
    for r in runs[leg]:
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=1e-5)
        np.testing.assert_allclose(r["gnorms"], want["gnorms"], rtol=1e-5)
    got = {n: runs[leg][0]["master"][o:o + k].reshape(s)
           for n, o, k, s in runs[leg][0]["names"]}
    assert set(got) == set(want["master"])
    for n, w in want["master"].items():
        np.testing.assert_allclose(got[n], w, rtol=1e-5, atol=1e-6,
                                   err_msg=n)
    assert want["losses"][-1] < want["losses"][0]


def _jax_grads(batch):
    jmodel = jax_mixtral.MixtralModel(JCFG)
    ids = jnp.asarray(batch[0])

    def loss(p):
        return jmodel.apply({"params": p}, ids, ids)

    grads = jax.grad(loss)(jax.tree_util.tree_map(jnp.asarray, TREE))
    return _port_names(grads)


@pytest.mark.parametrize("mesh", ["tp2", "ep2", "tp2ep2"])
def test_one_micro_step_gradients_match_jax(runs, mesh):
    """Every leaf's gradient after one micro-step (ZeRO 0; at tp 2 the
    router ``gate``'s is the sum over tp of the partial gradients its top-k
    weights receive, a missed sum showing as 1/tp of JAX's; at ep > 1 the
    data ranks' parts, summed, are the whole batch's) against
    ``jax.grad``."""
    want = _jax_grads(BATCHES[0])
    # the data ranks of tp coordinate 0 (tp is the innermost axis): their
    # dense gradients are each its rows' part of the batch's, while an
    # expert stack gathered whole is already the whole batch's (each rank's
    # experts saw every token of its ep group, here every data rank)
    data = runs[f"{mesh}_grads"][::2 if "tp" in mesh else 1]
    got = {n: (data[0]["grads"][n] if n.endswith(("w1", "w2", "w3"))
               else sum(r["grads"][n] for r in data)) for n in want}
    assert set(got) == set(want)
    for n, w in want.items():
        np.testing.assert_allclose(got[n], w, rtol=1e-4, atol=1e-5,
                                   err_msg=n)
    gates = [n for n in want if n.endswith("block_sparse_moe.gate")]
    assert gates and all(np.abs(want[n]).max() > 1e-3 for n in gates)


def test_tp_ranks_route_alike(runs):
    """Each tp rank computes the router from the same input bits: the
    top-k ids agree across the tp group, layer by layer."""
    for mesh in ("tp2", "tp2ep2"):
        res = runs[f"{mesh}_grads"]
        for a, b in zip(res[0::2], res[1::2]):
            for ta, tb in zip(a["topi"], b["topi"]):
                np.testing.assert_array_equal(ta, tb)


@pytest.mark.parametrize("mesh,local", [
    ("ep2", (2, 64, 128)), ("tp2", (4, 64, 64)), ("tp2ep2", (2, 64, 64))])
def test_b7_sees_the_local_stacks(runs, mesh, local):
    """Each rank holds and runs E/ep experts of I/tp columns: B7's plain
    version is called with [E/ep, D, I/tp] and [E/ep, I/tp, D] stacks
    only."""
    E, D, I = local
    for r in runs[f"{mesh}_grads"]:
        assert r["gmm_w_shapes"] == sorted({(E, D, I), (E, I, D)})
        assert r["local_shapes"]["model.layers.0.block_sparse_moe.w1"] == \
            (E, D, I)
        assert r["local_shapes"]["model.layers.0.block_sparse_moe.w2"] == \
            (E, I, D)
        assert r["local_shapes"][
            "model.layers.0.block_sparse_moe.gate"] == (D, 4)


def test_tp2ep2_tag_resumes_at_tp1_ep1(runs):
    """The tag holds the whole leaves: saved at tp 2 × ep 2 (ZeRO 1) and
    loaded at tp 1 × ep 1 (dp 4), the master loaded is the one saved, and
    the next steps are the saving run's."""
    for r in runs["ckpt"]:
        got = r["resumed"]["tp1ep1"]
        for n, w in r["saved"]["master"].items():
            np.testing.assert_array_equal(got["loaded"]["master"][n], w,
                                          err_msg=n)
        np.testing.assert_allclose(got["losses"], r["losses"], rtol=1e-5)


def test_tp2ep2_tag_universal_form_matches_jax(runs, tmp_path):
    """The universal form of the tp 2 × ep 2 tag is leaf for leaf the JAX
    engine's at tp 1 after the same two Adam steps: the names and shapes
    exactly; the master at rtol 2e-5 plus lr/20 with at most 0.1 % of a
    leaf's elements beyond (``test_torch_infinity.py``'s rule for
    gradients at the level of fp32 summation noise, which Adam moves by
    about lr whatever their sign), the moments at 2e-3 plus 1e-7
    (``test_torch_tp.py``'s)."""
    tag = os.path.join(runs["ckpt_dir"], "t")
    names = sorted(os.listdir(tag))
    for t in (0, 1):
        assert f"mp_rank_{t:02d}_model_states.pt" in names
    out = str(tmp_path / "port_universal")
    convert_to_universal(runs["ckpt_dir"], out, tag="t")
    try:
        eng = _jax_engine(1, {}, _config(1, {}, "fusedadam"))
        for batch in BATCHES[:2]:
            eng.backward(eng(*batch))
            eng.step()
        eng.save_checkpoint(str(tmp_path / "jax"), tag="t")
        jax_out = str(tmp_path / "jax_universal")
        jax_convert(str(tmp_path / "jax"), jax_out, tag="t")
    finally:
        groups.reset_mesh()
        jax_dist.destroy_process_group()
    for field in ("fp32", "exp_avg", "exp_avg_sq"):
        got, want = _npy(out, field), _npy(jax_out, field)
        assert set(got) == set(want), field
        for name, w in want.items():
            assert got[name].shape == w.shape, name
            if field == "fp32":
                apart = np.abs(got[name] - w) > 2e-5 * np.abs(w) + LR / 20
                assert apart.mean() <= 1e-3, name
            else:
                np.testing.assert_allclose(got[name], w, rtol=2e-3,
                                           atol=1e-7, err_msg=name)
