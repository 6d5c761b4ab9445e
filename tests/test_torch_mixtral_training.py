"""The port's Mixtral training path against the JAX package's, on the CPU
at ``mixtral_tiny`` size, from the same numpy weights (a flax tree, handed
to the port through ``params_from_flax``) and the same numpy batches.

* the grouped matmul's gradient: the port's backward (on CPU tensors the
  plain versions of the dx and dw kernels) against ``jax.grad`` of
  ``lax.ragged_dot``, with an empty group; fp32 within 1e-5 (one product
  summed in another order), bf16 within one bf16 ulp of |ref| (each output
  is one rounding of an fp32 sum);
* the model's loss (which, as JAX's, excludes the aux loss) and gradients
  against flax ``value_and_grad``, remat on and off, fp32 within 1e-4
  (attention, routing and three products a layer summed in another
  order); the kept router logits and ``aux_loss_from_vars`` against JAX's
  sown collection, 1e-5;
* ``params_to_flax`` as the exact inverse of ``params_from_flax``;
* a 4-step engine trajectory at ZeRO 0 and 3 against
  ``deepspeed_tpu.initialize`` on a one-device mesh: losses 1e-5 relative,
  the fp32 master rtol 2e-5 plus lr/20 (the rule of
  ``test_torch_llama_training.py``);
* the ZeRO 3 units are the decoder layers; Mixtral under an ep mesh it
  was not split for computes as at ep 1, and what stays refused (the
  parameter stream, as JAX's; telemetry, item 12) raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu.comm as jax_dist
import deepspeed_tpu_torch
from deepspeed_tpu.models import mixtral as jax_mixtral
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch.models import mixtral as port_mixtral
from deepspeed_tpu_torch.ops.kernels import grouped_matmul as gm

SEQ = 16


def _flax_tree(cfg, seed):
    """Random Mixtral weights in the flax layout, scaled so that logits
    are O(1) and the router's top-2 choices are not near ties."""
    rng = np.random.default_rng(seed)
    D, I, V, E = (cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size,
                  cfg.num_local_experts)
    H, Hkv, Dh = (cfg.num_attention_heads, cfg.num_key_value_heads,
                  cfg.head_dim)

    def w(*shape, fan_in):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
            np.float32)

    def norm():
        return (1.0 + 0.1 * rng.standard_normal(D)).astype(np.float32)

    tree = {"embed_tokens": {"embedding": w(V, D, fan_in=1)},
            "norm": {"weight": norm()},
            "lm_head": {"kernel": w(D, V, fan_in=D)}}
    for i in range(cfg.num_hidden_layers):
        tree[f"layers_{i}"] = {
            "self_attn": {"q_proj": {"kernel": w(D, H, Dh, fan_in=D)},
                          "k_proj": {"kernel": w(D, Hkv, Dh, fan_in=D)},
                          "v_proj": {"kernel": w(D, Hkv, Dh, fan_in=D)},
                          "o_proj": {"kernel": w(H * Dh, D, fan_in=H * Dh)}},
            "moe": {"gate": {"kernel": w(D, E, fan_in=1)},
                    "w1": w(E, D, I, fan_in=D), "w3": w(E, D, I, fan_in=D),
                    "w2": w(E, I, D, fan_in=I)},
            "input_layernorm": {"weight": norm()},
            "post_attention_layernorm": {"weight": norm()}}
    return tree


def _configs(**over):
    return (jax_mixtral.mixtral_tiny(**over),
            port_mixtral.mixtral_tiny(**over))


def _batches(n, B, seed, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(B, SEQ)).astype(np.int32)
            for _ in range(n)]


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t).astype(jnp.float32))


# ------------------------------------------------- B7's gradient (plain)
@pytest.mark.parametrize("sizes,past", [([40, 0, 24, 77], 2),
                                        ([5, 3, 0, 0], 2), ([21, 11], 96)],
                         ids=["empty_mid", "empty_tail", "ep_gathered"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gmm_grad_matches_ragged_dot(sizes, past, dtype):
    """dx and dw of the port's ``gmm`` (autograd through
    :class:`GroupedMatmul`, whose backward on CPU tensors is the plain
    ``gmm_dx``/``gmm_dw``) against ``jax.vjp`` of ``lax.ragged_dot`` on the
    same cotangent, with ``past`` rows past the sizes (``ep_gathered``:
    three quarters of them, as Mixtral's exchange at ep 4 hands a rank
    its gathered copies): their outputs and dx exactly zero; an empty
    group's dw is exactly zero."""
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    r = np.random.default_rng(3)
    T, K, N, E = sum(sizes) + past, 48, 40, len(sizes)

    def pair(a):
        j = jnp.asarray(a, jdt)
        return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)

    xj, xt = pair(r.standard_normal((T, K)))
    wj, wt = pair(r.standard_normal((E, K, N)) / np.sqrt(K))
    dyj, dyt = pair(r.standard_normal((T, N)))
    gsj = jnp.asarray(sizes, jnp.int32)
    _, vjp = jax.vjp(lambda x, w: jax.lax.ragged_dot(x, w, gsj), xj, wj)
    want_dx, want_dw = vjp(dyj)
    xt.requires_grad_(True)
    wt.requires_grad_(True)
    y = gm.gmm(xt, wt, torch.tensor(sizes, dtype=torch.int32))
    got_dx, got_dw = torch.autograd.grad(y, (xt, wt), dyt)
    assert got_dx.dtype == tdt and got_dw.dtype == tdt
    for got, want in ((got_dx, want_dx), (got_dw, want_dw)):
        got, want = _np(got), _np(want)
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        else:
            assert np.all(np.abs(got - want) <=
                          2.0**-7 * np.abs(want) + 1e-6)
    for e, n in enumerate(sizes):
        if n == 0:
            assert not got_dw[e].any()
    assert not y[sum(sizes):].any() and not got_dx[sum(sizes):].any()
    # the backward launches only what needs a gradient
    x2 = xt.detach()
    y2 = gm.gmm(x2, wt, torch.tensor(sizes, dtype=torch.int32))
    (dw2, ) = torch.autograd.grad(y2, (wt, ), dyt)
    assert torch.equal(dw2, got_dw)


def test_backward_routes_are_a_function_of_shapes():
    """dx takes wgmma + TMA at Mixtral's widths (64-row tiles at decode
    sizes), the CUDA cores where TMA cannot take the shapes or for fp32;
    dw takes wgmma + TMA at Mixtral's widths, mma.sync for the other
    16-bit shapes (K or N not a multiple of 8, x or dy unaligned), the
    CUDA cores for fp32."""
    bf, fp16 = torch.bfloat16, torch.float16
    assert gm.BWD_ROUTES["dw"] == ("wgmma_tma", "mma_sync", "simt")
    for K, N in ((4096, 14336), (14336, 4096)):
        assert gm.gmm_bwd_route("dx", 16384, K, N, bf, 0, 0) == "wgmma_tma"
        assert gm.gmm_bwd_route("dx", 64, K, N, bf, 0, 0) == "wgmma_tma_64"
        for T, dt in ((16384, bf), (64, bf), (16384, fp16)):
            assert gm.gmm_bwd_route("dw", T, K, N, dt, 0, 0) == "wgmma_tma"
        assert gm.gmm_bwd_route("dx", 16, K, N, torch.float32, 0, 0) == \
            "simt"
        assert gm.gmm_bwd_route("dw", 16384, K, N, torch.float32, 0, 0) == \
            "simt"
    assert gm.gmm_bwd_route("dx", 512, 4096, 14340, bf, 0, 0) == "simt"
    assert gm.gmm_bwd_route("dx", 512, 4100, 4096, bf, 0, 0) == "simt"
    assert gm.gmm_bwd_route("dx", 512, 4096, 4096, bf, 8, 0) == "simt"
    for K, N, x_addr, dy_addr in ((4096, 14340, 0, 0), (4100, 4096, 0, 0),
                                  (4096, 4096, 8, 0), (4096, 4096, 0, 2)):
        assert gm.gmm_bwd_route("dw", 512, K, N, bf, x_addr, dy_addr) == \
            "mma_sync"
    with pytest.raises(ValueError, match="'dx' or 'dw'"):
        gm.gmm_bwd_route("dz", 1, 8, 8, bf, 0, 0)
    before = (gm.gmm_dx.launches, gm.gmm_dw.launches)
    x = torch.ones(6, 8, requires_grad=True)
    w = torch.ones(2, 8, 4, requires_grad=True)
    gm.gmm(x, w, torch.tensor([3, 3], dtype=torch.int32)).sum().backward()
    assert (gm.gmm_dx.launches, gm.gmm_dw.launches) == before


def _dw_in_boxes(x, dy, sizes, box=64):
    """The order of the wgmma dw kernel, in plain PyTorch: per expert,
    boxes of ``box`` rows from its own first row (rows past T read as
    zeros, as TMA fills them), the rows of a box past the expert zeroed in
    both operands, the boxes' products summed in fp32, one rounding to
    x's dtype at the end."""
    T, K = x.shape
    N = dy.shape[1]
    xz = torch.cat([x.float(), torch.zeros(box, K)])
    dyz = torch.cat([dy.float(), torch.zeros(box, N)])
    dw = torch.zeros(len(sizes), K, N, dtype=x.dtype)
    start = 0
    for e, n in enumerate(sizes):
        end = min(start + n, T)
        acc = torch.zeros(K, N)
        for r0 in range(start, end, box):
            xb, dyb = xz[r0:r0 + box].clone(), dyz[r0:r0 + box].clone()
            xb[end - r0:] = 0
            dyb[end - r0:] = 0
            acc += xb.t() @ dyb
        dw[e] = acc.to(x.dtype)
        start += n
    return dw


DW_BOX_CASES = {
    # an expert starting mid-box, one shorter than a box, an empty one, an
    # expert of exactly one box starting mid-box, rows past the sizes
    "mid_box_start": ([37, 100, 0, 64, 5], 0),
    "short_and_empty": ([20, 0, 9, 150], 0),
    "rows_past": ([70, 0, 45], 23),
    "one_short": ([3], 40),
}


@pytest.mark.parametrize("case", sorted(DW_BOX_CASES))
@pytest.mark.parametrize("poison", [False, True], ids=["clean", "inf"])
def test_dw_box_order_matches_ragged_dot(case, poison):
    """The wgmma dw kernel's order (:func:`_dw_in_boxes`) against
    ``jax.vjp`` of ``lax.ragged_dot`` at bf16, with the tolerance of
    :func:`test_gmm_grad_matches_ragged_dot`; an empty expert's dw is
    exactly zero.  ``inf``: +inf planted in the dy rows of every other
    expert (the ones whose rows share a box with their predecessor's last
    rows) and past the sizes: each remaining expert's dw stays finite and
    equal to the clean reference, which holds only because the box's
    foreign rows are zeroed in dy too (0 · inf is NaN)."""
    sizes, extra = DW_BOX_CASES[case]
    r = np.random.default_rng(9)
    T, K, N, E = sum(sizes) + extra, 24, 40, len(sizes)

    def pair(a):
        j = jnp.asarray(a, jnp.bfloat16)
        return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
            torch.bfloat16)

    xj, xt = pair(r.standard_normal((T, K)))
    wj, _ = pair(r.standard_normal((E, K, N)) / np.sqrt(K))
    dyj, dyt = pair(r.standard_normal((T, N)))
    gsj = jnp.asarray(sizes, jnp.int32)
    _, vjp = jax.vjp(lambda x, w: jax.lax.ragged_dot(x, w, gsj), xj, wj)
    want = _np(vjp(dyj)[1])
    starts = np.cumsum([0] + sizes[:-1])
    bad = [e for e, n in enumerate(sizes) if n][1::2] if poison else []
    if poison:
        for e in bad:
            dyt[starts[e]:starts[e] + sizes[e]] = float("inf")
        dyt[sum(sizes):] = float("inf")
    got = _dw_in_boxes(xt, dyt, sizes)
    assert got.dtype == torch.bfloat16 and got.shape == (E, K, N)
    for e in range(E):
        if e in bad:
            assert not got[e].isfinite().all()
            continue
        g = _np(got[e])
        assert np.isfinite(g).all()
        assert np.all(np.abs(g - want[e]) <= 2.0**-7 * np.abs(want[e]) +
                      1e-6)
        if sizes[e] == 0:
            assert not got[e].any()
    if poison:
        # the foreign rows are zeroed in dy as well as in x: with x's alone
        # zeroed, 0 · inf would make the expert's sum NaN
        xz = torch.cat([xt.float(), torch.zeros(64, K)])
        dyz = torch.cat([dyt.float(), torch.zeros(64, N)])
        hit = 0
        for e, n in enumerate(sizes):
            if not n or e in bad:
                continue
            r0 = starts[e] + (n - 1) // 64 * 64
            xb = xz[r0:r0 + 64].clone()
            xb[starts[e] + n - r0:] = 0
            if not dyz[r0:r0 + 64].isfinite().all():
                hit += 1
                assert not (xb.t() @ dyz[r0:r0 + 64]).isfinite().all()
        assert hit


# ------------------------------------------------------------- the model
def _port_model(pcfg, tree):
    model = port_mixtral.MixtralModel(pcfg, device="meta")
    state = port_mixtral.params_from_flax(tree, pcfg, dtype="float32")
    model.load_weights(state.items(), device="cpu")
    for p in model.parameters():
        p.requires_grad_(True)
    return model


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_model_loss_grads_and_aux_match_flax(remat):
    jcfg, pcfg = _configs(dtype="float32", remat=remat)
    tree = _flax_tree(jcfg, seed=1)
    ids = _batches(1, 2, seed=2)[0]
    jmodel = jax_mixtral.MixtralModel(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, tree)

    def jloss(p):
        return jmodel.apply({"params": p}, jnp.asarray(ids),
                            jnp.asarray(ids))

    want, jgrads = jax.value_and_grad(jloss)(params)
    _, jvars = jmodel.apply({"params": params}, jnp.asarray(ids),
                            mutable=["intermediates"])
    model = _port_model(pcfg, tree)
    t = torch.from_numpy(ids)
    loss = model(t, t)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    want_g = port_mixtral.params_from_flax(
        jax.tree_util.tree_map(np.asarray, jgrads), pcfg, dtype="float32")
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[name].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    # the loss is the LM loss alone; the aux loss is the caller's to add
    with torch.no_grad():
        model(t)
    inter = model.intermediates()
    assert sorted(inter["intermediates"]) == ["layers_0", "layers_1"]
    for i in range(jcfg.num_hidden_layers):
        np.testing.assert_allclose(
            inter["intermediates"][f"layers_{i}"]["moe"]["router_logits"]
            [0].numpy(),
            np.asarray(jvars["intermediates"][f"layers_{i}"]["moe"]
                       ["router_logits"][0]), rtol=1e-5, atol=1e-5)
    k, coef = jcfg.num_experts_per_tok, jcfg.router_aux_loss_coef
    np.testing.assert_allclose(
        float(port_mixtral.aux_loss_from_vars(inter, k, coef)),
        float(jax_mixtral.aux_loss_from_vars(jvars, k, coef)), rtol=1e-5)


def test_params_to_flax_inverts_params_from_flax():
    jcfg, pcfg = _configs(dtype="float32")
    tree = _flax_tree(jcfg, seed=4)
    back = port_mixtral.params_to_flax(
        port_mixtral.params_from_flax(tree, pcfg, dtype="float32"), pcfg)
    flat_want = jax.tree_util.tree_leaves_with_path(tree)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_want) == len(flat_got)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(flat_got[path], leaf)


@pytest.fixture
def one_device_mesh():
    groups.initialize_mesh(dp=1, devices=jax.devices()[:1])
    yield
    groups.reset_mesh()
    jax_dist.destroy_process_group()


_OPT = {"type": "fusedadam", "params": {"lr": 2e-3}}
ENGINE_CASES = {
    "zero0": dict(stage=0, remat=False),
    "zero3_remat": dict(stage=3, remat=True),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_trajectory_matches_jax(case, one_device_mesh):
    spec = ENGINE_CASES[case]
    steps = 4
    jcfg, pcfg = _configs(dtype="float32", remat=spec["remat"])
    tree = _flax_tree(jcfg, seed=7)
    zero = {"stage": spec["stage"]}
    if spec["stage"] == 3:
        # the tiny leaves sit below the default persistence threshold
        zero["stage3_param_persistence_threshold"] = 0
    config = {"train_micro_batch_size_per_gpu": 2, "optimizer": _OPT,
              "gradient_clipping": 1.0, "zero_optimization": zero}
    jeng, *_ = deepspeed_tpu.initialize(
        model=jax_mixtral.MixtralModel(jcfg),
        model_parameters=jax.tree_util.tree_map(jnp.asarray, tree),
        config=dict(config))
    start = port_mixtral.params_from_flax(tree, pcfg, dtype="float32")
    peng, *_ = deepspeed_tpu_torch.initialize(
        model=port_mixtral.MixtralModel(pcfg, device="meta"),
        model_parameters=start, config=dict(config), device="cpu")
    if spec["stage"] == 3:
        units = [u.module for u in peng._coord.units
                 if u.module is not None]
        assert units == list(peng.module.model.layers)
    jl, pl = [], []
    for ids in _batches(steps, 2, seed=11):
        for eng, out in ((jeng, jl), (peng, pl)):
            loss = eng(ids, ids)
            eng.backward(loss)
            eng.step()
            out.append(float(loss))
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    assert pl[-1] < pl[0]
    want = port_mixtral.params_from_flax(
        jax.tree_util.tree_map(np.asarray, jeng.get_fp32_param()), pcfg,
        dtype="float32")
    assert set(want) == set(peng.parameter_names())
    for name, w in want.items():
        np.testing.assert_allclose(peng.get_fp32_param(name).numpy(),
                                   w.numpy(), rtol=2e-5, atol=2e-3 / 20,
                                   err_msg=name)


def test_what_is_left_of_item_8_raises_8b():
    """Refused until item 8b; now a Mixtral model under an ep > 1 mesh it
    was not split for computes as at ep 1 (the engine localizes the
    stacks and hands each block its ep group:
    ``tests/test_torch_mixtral_parallel.py``).  What stays refused: the
    offload_param stream, as JAX's, which has no streaming view of
    Mixtral, and the routing statistics' telemetry sink (item 12)."""
    from deepspeed_tpu_torch.utils import groups as port_groups
    _, pcfg = _configs(dtype="float32", remat=False)
    model = port_mixtral.MixtralModel(pcfg, device="cpu").init_weights(
        torch.Generator().manual_seed(0))
    ids = torch.zeros(1, 4, dtype=torch.long)
    want = model(ids, ids)
    port_groups.reset_mesh()
    try:
        port_groups._mesh_state = port_groups.MeshState(
            mesh=port_groups.Mesh(pp=1, dp=1, ep=2, sp=1, tp=1), pp=1, dp=2,
            sp=1, tp=1, ep=2)
        assert torch.equal(model(ids, ids), want)
    finally:
        port_groups.reset_mesh()
    assert want.isfinite()
    stream = {"train_batch_size": 1, "zero_optimization": {
        "stage": 3, "offload_param": {"device": "cpu"}}}
    with pytest.raises(TypeError, match="streaming_parts"):
        deepspeed_tpu_torch.initialize(
            model=port_mixtral.MixtralModel(pcfg, device="meta"),
            config=dict(stream), device="cpu")
    jcfg, _ = _configs(dtype="float32", remat=False)
    groups.initialize_mesh(dp=1, devices=jax.devices()[:1])
    try:
        # the JAX engine refuses it for the same reason
        with pytest.raises(TypeError, match="streaming_parts"):
            deepspeed_tpu.initialize(model=jax_mixtral.MixtralModel(jcfg),
                                     config=dict(stream))
    finally:
        groups.reset_mesh()
        jax_dist.destroy_process_group()
    with pytest.raises(NotImplementedError, match="item 12"):
        deepspeed_tpu_torch.initialize(
            model=port_mixtral.MixtralModel(pcfg, device="meta"),
            config={"train_batch_size": 1, "moe": {"enabled": True},
                    "telemetry": {"enabled": True}}, device="cpu")
