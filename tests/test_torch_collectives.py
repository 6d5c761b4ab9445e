"""The port's collectives engine (``deepspeed_tpu_torch/comm/collectives``)
against the JAX package's (``deepspeed_tpu/comm/collectives``).

* Every wire codec (int8, int4, fp8, fp6, fp12; groups of 128 and 2048;
  fp32 and bf16 inputs whose length is not a multiple of the group) gives
  JAX's XLA codec's codes and scales bit for bit, on the groups that hold
  data (JAX pads the group count to its Pallas row block, the port only
  the last group), and the same decode.
* The four primitives run on a gloo world of 2 and of 4 processes
  (``torch_dist_worker.py``, one spawn a world for the whole module) on
  rank r's row of a seeded array, and JAX's under ``shard_map`` on the
  8-device CPU mesh over the same rows: ``quantized_all_gather``,
  ``all_to_all_quant_reduce`` (mean and sum), ``quantized_all_to_all``
  and ``hierarchical_quant_reduce_scatter`` (inner-major: the rank at
  (o, i) holds chunk i·n_outer + o).  Bit-equal at world 2, where every
  sum has two terms; rtol 1e-6 at world 4, where gloo's and XLA's orders
  of four fp32 terms may differ.  JAX's programs are compiled without
  XLA's algebraic simplifier and fusion, as JAX's eager run computes them
  (:func:`_smap`).  The straight-through gather's gradient
  is the exact reduce-scatter of the cotangent, bit-equal to JAX's.
* The facade with an engine installed: the twins of
  ``tests/unit/comm/test_collectives.py`` (hierarchy, pass-through of
  MIN/MAX/PRODUCT, the error bounds of the quantized gathers and
  reduce-scatters, each rank's 2-hop slice against the flat reduce of the
  same gradients, declines, coalesced helpers, the comms logger's variant
  and wire bytes, the wire ladder), and ``test_qwz_fp_wire_format``.
* The ladder functions, the wire-byte arithmetic, the row-wise codec, the
  config validation and the topology probe against JAX's.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from deepspeed_tpu.comm.collectives import engine as jax_engine
from deepspeed_tpu.comm.collectives import quantized as JQ
from deepspeed_tpu.comm.collectives import topology as jax_topology
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
from deepspeed_tpu.runtime.config import \
    DeepSpeedConfigError as JaxConfigError
from deepspeed_tpu_torch import comm as port_dist
from deepspeed_tpu_torch.comm import collectives as C
from deepspeed_tpu_torch.comm.collectives import quantized as Q
from deepspeed_tpu_torch.comm.collectives import topology as port_topology
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig as PortConfig
from deepspeed_tpu_torch.runtime.config import \
    DeepSpeedConfigError as PortConfigError
from test_torch_fp_quantizer import _codes_apart_at_jax_exp2_margin
from torch_dist_worker import spawn

WORLDS = (2, 4)
FORMATS = ("int8", "int4", "fp8", "fp6", "fp12")
GS = 128


def _np(x):
    return np.asarray(x)


# ------------------------------------------------------------- the codecs
def _codec_input(dtype, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32) * 3
    x[: n // 7] *= 1e-3           # groups of very different scales
    x[5] = 0.0
    return x if dtype == "float32" else x.astype(jnp.bfloat16)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("gs", (128, 2048))
@pytest.mark.parametrize("fmt", FORMATS)
def test_wire_codec_matches_jax_xla_codec(fmt, gs, dtype):
    x = _codec_input(dtype, 3 * gs + 77, seed=len(fmt) + gs)
    jq, jdq = JQ.wire_codec(fmt, gs)
    pq, pdq = Q.wire_codec(fmt, gs)
    tx = torch.from_numpy(np.asarray(x, np.float32))
    if dtype == "bfloat16":
        tx = tx.to(torch.bfloat16)
    q_j, s_j, meta_j = jq(jnp.asarray(x))
    q_p, s_p, meta_p = pq(tx)
    groups = meta_p[2]
    assert groups == meta_j[2] == -(-x.size // Q.effective_group_size(gs))
    if fmt in ("int8", "int4"):
        np.testing.assert_array_equal(q_p.numpy(), _np(q_j)[:groups])
        np.testing.assert_array_equal(s_p.numpy(), _np(s_j)[:groups])
    else:
        # the fp formats pad the group count as JAX does; fp12's codes
        # may differ only at JAX's inexact exp2(-13), held exactly (ROADMAP
        # queue C; tests/test_torch_fp_quantizer.py)
        np.testing.assert_array_equal(s_p.numpy(), _np(s_j))
        bits, man = Q._FP_FORMATS[fmt]
        _codes_apart_at_jax_exp2_margin(q_p, q_j, s_p, tx, bits, man,
                                        Q.effective_group_size(gs))
        q_j = jnp.asarray(q_p.numpy())    # decode the same bytes below
    back_j = _np(jdq(q_j, s_j, meta_j)).astype(np.float32)
    back_p = pdq(q_p, s_p, meta_p).float().numpy()
    np.testing.assert_array_equal(back_p, back_j)


def test_dequantize_writes_into_out():
    x = torch.from_numpy(_codec_input("float32", 1000, 3))
    for fmt in ("int8", "fp6"):
        quant, dequant = Q.wire_codec(fmt, GS)
        q, s, meta = quant(x)
        out = torch.empty_like(x)
        got = dequant(q, s, meta, out=out)
        assert got.data_ptr() == out.data_ptr()
        assert torch.equal(out, dequant(q, s, meta))


def test_per_block_scales():
    x = torch.cat([torch.full((GS, ), 1e-3), torch.full((GS, ), 1e3)])
    q, s, meta = Q.wire_codec("int8", GS)[0](x)
    assert meta[2] == 2
    np.testing.assert_allclose(s.numpy(), np.array([1e-3, 1e3]) / 127,
                               rtol=1e-5)
    back = Q.wire_codec("int8", GS)[1](q, s, meta)
    rel = ((back - x).abs() / x).max().item()
    assert rel <= 1 / 127 + 1e-6


@pytest.mark.parametrize("fmt", FORMATS + ("fp32", ))
def test_wire_bytes_match_jax(fmt):
    for n in (1, 127, 128, 1024, 3000, 1 << 20):
        for gs in (100, 128, 200, 2048):
            assert Q.quantized_wire_bytes(n, fmt, gs) == \
                JQ.quantized_wire_bytes(n, fmt, gs), (n, gs)
    assert Q.effective_group_size(200) == JQ.effective_group_size(200)
    assert Q.PAYLOAD_BYTES == JQ.PAYLOAD_BYTES
    assert Q.WIRE_FORMATS == JQ.WIRE_FORMATS
    assert Q.quantized_wire_bytes(1024, "int8", 128) == 1024 + 8 * 4


@pytest.mark.parametrize("fmt", ("int8", "fp8"))
def test_rowwise_codec_matches_jax(fmt):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((6, 4, 32)).astype(np.float32)
    x[2] = 0.0
    je, jd = JQ.rowwise_codec(fmt)
    pe, pd = Q.rowwise_codec(fmt)
    qj, sj = je(jnp.asarray(x))
    qp, sp = pe(torch.from_numpy(x))
    assert qp.dtype == Q.rowwise_storage_dtype(fmt)
    np.testing.assert_array_equal(qp.float().numpy(),
                                  _np(qj).astype(np.float32))
    np.testing.assert_array_equal(sp.numpy(), _np(sj))
    np.testing.assert_array_equal(pd(qp, sp).numpy(), _np(jd(qj, sj)))


# ----------------------------------------------------------------- ladder
LADDERS = [None, [], [[None, "int8"], [4096, "fp32"]],
           [{"max_bytes": 4096, "wire_dtype": "fp8"}],
           [[8192, "fp8"], [None, "int4"]], [[8192, "fp8"]],
           [[4096, "int7"]], [[4096, "fp8"], [4096, "int8"]],
           [[None, "fp8"], [None, "int8"]], [[0, "fp8"]], [[4096]]]


@pytest.mark.parametrize("i", range(len(LADDERS)))
def test_wire_ladder_matches_jax(i):
    raw = LADDERS[i]
    try:
        want = jax_engine.build_wire_ladder(raw)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            C.build_wire_ladder(raw)
        assert str(got.value) == str(e)
        return
    got = C.build_wire_ladder(raw)
    assert got == want
    for nbytes in (1, 4096, 4097, 8192, 8193, 1 << 30):
        assert C.resolve_in_ladder(got, nbytes, "int8") == \
            jax_engine.resolve_in_ladder(want, nbytes, "int8")


def test_bad_wire_dtype_rejected():
    with pytest.raises(ValueError, match="wire_dtype"):
        C.CollectivesEngine(C.CommOptimizations(enabled=True,
                                                wire_dtype="int7"))
    eng = C.CollectivesEngine(C.CommOptimizations(
        enabled=True, quantized_weights=True, wire_dtype="fp8"))
    assert eng._ladder is None
    assert all(eng.resolve_wire_dtype(n) == "fp8" for n in (1, 1 << 30))


def test_engine_declines_on_a_group_of_one():
    eng = C.CollectivesEngine(C.CommOptimizations(
        enabled=True, quantized_weights=True, quantized_gradients=True,
        intra_node_size=2))
    g = port_dist.ProcessGroup(("dp", ), local=True)
    x = torch.ones(64)
    assert eng.dispatch("all_gather", x, g) is None
    assert eng.dispatch("reduce_scatter", x, g) is None
    assert eng.dispatch("all_reduce", x, g) is None
    assert eng.dispatch("all_gather", x, g, wire_format="int8") is None
    assert dict(eng.counts) == {"all_gather/flat_fallback": 2,
                                "reduce_scatter/flat_fallback": 1,
                                "all_reduce/flat_fallback": 1}


# ----------------------------------------------------------------- config
CONFIGS = [
    {"wire_dtype": "bf7"},
    {"wire_dtype_by_size": [[4096, "bf7"]]},
    {"zero_mode": "manual"},
    {"enabled": True, "wire_dtype": "fp8", "zero_mode": "flat_manual"},
    {"enabled": True, "quantized_weights": True,
     "wire_dtype_by_size": [[4096, "fp8"], [None, "int8"]]},
]


@pytest.mark.parametrize("i", range(len(CONFIGS)))
def test_comm_optimizations_config_matches_jax(i):
    block = CONFIGS[i]
    raw = {"train_micro_batch_size_per_gpu": 1, "comm_optimizations": block}
    try:
        want = JaxConfig(dict(raw)).comm_optimizations_config
    except (JaxConfigError, ValueError) as e:
        with pytest.raises(PortConfigError) as got:
            PortConfig(dict(raw))
        # the JAX pydantic model wraps a validator's message
        assert str(got.value) in str(e)
        return
    got = PortConfig(dict(raw)).comm_optimizations_config
    for key in ("enabled", "wire_dtype", "zero_mode", "quantized_weights",
                "quantization_group_size", "hierarchical_allreduce"):
        assert getattr(got, key) == getattr(want, key), key
    assert got.overlap.bucket_mb == want.overlap.bucket_mb
    assert got.overlap.prefetch.max_inflight == \
        want.overlap.prefetch.max_inflight


def test_config_block_installs_engine():
    port_dist.init_distributed(dist_backend="gloo", verbose=False)
    try:
        assert port_dist.get_collectives_engine() is None or True
        cfg = PortConfig({"train_micro_batch_size_per_gpu": 1,
                          "comm_optimizations": {"enabled": True,
                                                 "quantized_gradients": True,
                                                 "wire_dtype": "fp8",
                                                 "wire_dtype_by_size": [
                                                     [4096, "fp8"],
                                                     [None, "int8"]]}})
        port_dist.init_distributed(config=cfg)
        eng = port_dist.get_collectives_engine()
        assert eng is not None and eng.enabled and eng.opts.wire_dtype == \
            "fp8"
        assert eng.resolve_wire_dtype(4096) == "fp8"
        assert eng.resolve_wire_dtype(4097) == "int8"
        port_dist.init_distributed(config=PortConfig(
            {"train_micro_batch_size_per_gpu": 1}))
        assert port_dist.get_collectives_engine() is None
    finally:
        port_dist.set_collectives_engine(None)


def test_overlap_block_drives_the_schedulers():
    cfg = PortConfig({"train_micro_batch_size_per_gpu": 1,
                      "zero_optimization": {"stage": 3},
                      "comm_optimizations": {"overlap": {
                          "enabled": True, "max_inflight": 3,
                          "prefetch": {"enabled": True, "bucket_mb": 0,
                                       "max_inflight": 4}}}})
    assert cfg.overlap_comm_enabled and cfg.overlap_max_inflight == 3
    assert cfg.prefetch_enabled and cfg.prefetch_max_inflight == 4
    assert cfg.prefetch_bucket_mb == 32.0      # the overlap block's bucket
    # an explicit overlap block wins over overlap_comm
    off = PortConfig({"train_micro_batch_size_per_gpu": 1,
                      "zero_optimization": {"stage": 2,
                                            "overlap_comm": True},
                      "comm_optimizations": {"overlap": {"enabled": False}}})
    assert not off.overlap_comm_enabled
    with pytest.raises(PortConfigError, match="max_inflight"):
        PortConfig({"train_micro_batch_size_per_gpu": 1,
                    "comm_optimizations": {"overlap": {"max_inflight": 0}}})


# --------------------------------------------------------------- topology
@pytest.mark.parametrize("env", ("4", "x", "-1"))
def test_intra_node_size_env_matches_jax(monkeypatch, env):
    monkeypatch.setenv("DS_TPU_INTRA_NODE_SIZE", env)
    try:
        want = jax_topology.detect_intra_node_size(None, "dp")
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            port_topology.detect_intra_node_size()
        assert str(got.value) == str(e)
        return
    assert port_topology.detect_intra_node_size() == want
    assert port_topology.detect_intra_node_size(override=2) == 2


def test_node_probe(monkeypatch):
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert port_topology.probe_node_size(4, ["a", "a", "b", "b"]) == 2
    assert port_topology.probe_node_size(4, ["a"] * 4) == 0
    assert port_topology.probe_node_size(4, ["a", "a", "a", "b"]) == 0
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert port_topology.probe_node_size(8) == 2
    g = port_dist.ProcessGroup(("dp", ), local=True)
    assert port_topology.factor_group(g, intra_node_size=2) is None


# ------------------------------------------------- the primitives, spawned
def _rows(n, shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, ) + shape) * 2).astype(dtype)


PRIMS = ([("qag", fmt, 0) for fmt in FORMATS + ("fp32", )]
         + [("qag", "int8", 1)]
         + [("a2a_reduce", fmt, mean) for fmt in FORMATS + ("fp32", )
            for mean in (True, False)]
         + [("hier", fmt) for fmt in ("int8", "fp8", "fp6", "fp32")]
         + [("qa2a", fmt, concat) for fmt in ("int8", "fp6", "fp32")
            for concat in (0, 1)]
         + [("st_grad", fmt) for fmt in ("int8", "fp8")])


def _prim_case(n, case):
    kind, fmt = case[0], case[1]
    seed = zlib.crc32(repr((n, case)).encode()) % 1000
    if kind == "qag":
        dim = case[2]
        a = _rows(n, (3, 200) if dim == 0 else (200, 3), seed)
        return a, ("qag", fmt, GS, dim)
    if kind == "a2a_reduce":
        return _rows(n, (n * 150, ), seed), ("a2a_reduce", fmt, GS, case[2])
    if kind == "hier":
        return _rows(n, (n * 150, ), seed), ("hier", fmt, GS, 2, True)
    if kind == "qa2a":
        return _rows(n, (n * 2, 130), seed), ("qa2a", 0, case[2], fmt, GS)
    return _rows(n, (2, 150), seed), ("st_grad", fmt, GS)


def _smap(fn, n, in_spec, out_spec, shape=None, names=("dp", )):
    """JAX's ``fn`` under ``shard_map``, compiled as written, as JAX runs it
    eagerly: without XLA's algebraic simplifier, which rewrites the codecs'
    ``absmax / qmax`` into ``absmax · fl(1/qmax)``, and without its
    fusion, which contracts the dequantizing product into the sum of the
    parts (one rounding instead of two).  Either moves results by an ulp
    from what JAX's code says and the port computes."""
    devs = np.array(jax.devices()[:n]).reshape(shape or (n, ))
    mesh = Mesh(devs, names)
    jitted = jax.jit(shard_map(fn, mesh=mesh, in_specs=(in_spec, ),
                               out_specs=out_spec, check_vma=False))

    def run(x):
        return jitted.lower(x).compile(compiler_options={
            "xla_disable_hlo_passes": "algsimp,fusion"})(x)

    return run


def _jax_prim(n, a, op):
    """JAX's result for each of n ranks, rank r's input being a[r]."""
    kind = op[0]
    if kind == "qag":
        _, fmt, gs, dim = op
        spec = [None] * (a.ndim - 1)
        spec[dim] = "dp"
        fn = _smap(lambda t: JQ.quantized_all_gather(t, ("dp", ), dim, fmt,
                                                     gs), n, P(*spec), P())
        out = _np(fn(jnp.asarray(np.concatenate(list(a), axis=dim))))
        return [out] * n
    if kind == "a2a_reduce":
        _, fmt, gs, mean = op
        fn = _smap(lambda g: JQ.all_to_all_quant_reduce(
            g[0], ("dp", ), 0, n, wire_format=fmt, group_size=gs, mean=mean),
            n, P("dp"), P("dp"))
        out = _np(fn(jnp.asarray(a)))
        c = out.size // n
        return [out[r * c:(r + 1) * c] for r in range(n)]
    if kind == "hier":
        _, fmt, gs, n_in, mean = op
        n_out = n // n_in
        fn = _smap(lambda g: JQ.hierarchical_quant_reduce_scatter(
            g[0], ("i", ), ("o", ), 0, n_in, n_out, wire_format=fmt,
            group_size=gs, mean=mean), n, P(("o", "i")), P(("i", "o")),
            shape=(n_out, n_in), names=("o", "i"))
        out = _np(fn(jnp.asarray(a)))
        c = out.size // n
        # the rank at (o, i) holds chunk i · n_outer + o
        return [out[((r % n_in) * n_out + r // n_in) * c:][:c]
                for r in range(n)]
    if kind == "qa2a":
        _, split, concat, fmt, gs = op
        fn = _smap(lambda t: JQ.quantized_all_to_all(
            t, ("dp", ), split, concat, n, fmt, gs), n, P("dp"), P("dp"))
        out = _np(fn(jnp.asarray(np.concatenate(list(a), axis=0))))
        rows = out.shape[0] // n
        return [out[r * rows:(r + 1) * rows] for r in range(n)]
    _, fmt, gs = op

    def body(t):
        return jax.grad(lambda v: jnp.sum(JQ.qdq_all_gather_st(
            v, ("dp", ), 0, fmt, gs) ** 2))(t)

    fn = _smap(body, n, P("dp"), P("dp"))
    out = _np(fn(jnp.asarray(np.concatenate(list(a), axis=0))))
    rows = out.shape[0] // n
    return [out[r * rows:(r + 1) * rows] for r in range(n)]


def _facade_cases(n):
    """{key: (opts, fn, extra, per-rank rows)}: the JAX engine tests'
    cases through the facade."""
    rng = np.random.default_rng(100 + n)
    f = lambda *s: rng.standard_normal((n, ) + s).astype(np.float32)  # noqa
    ints = np.stack([np.arange(16, dtype=np.float32) + r for r in range(n)])
    q8 = dict(quantized_weights=True, quantized_gradients=True,
              quantization_group_size=GS)
    return {
        "hier_all_reduce": (dict(intra_node_size=2), "all_reduce", "SUM",
                            ints),
        "hier_all_reduce_avg": (dict(intra_node_size=2), "all_reduce",
                                "AVG", f(16)),
        "max_passthrough": (dict(q8, intra_node_size=2), "all_reduce",
                            "MAX", f(8)),
        "min_passthrough": (dict(q8, intra_node_size=2), "all_reduce",
                            "MIN", f(8)),
        "product_passthrough": (dict(q8, intra_node_size=2), "all_reduce",
                                "PRODUCT", (1 + 0.1 * f(8)).astype(
                                    np.float32)),
        "quant_all_gather_int8": (q8, "all_gather", None, f(64 // n, 32)),
        "quant_all_gather_fp8": (dict(q8, wire_dtype="fp8"), "all_gather",
                                 None, f(64 // n, 32)),
        "quant_reduce_scatter": (dict(q8, hierarchical_allreduce=False),
                                 "reduce_scatter", None, f(1024)),
        "hier_quant_reduce_scatter": (dict(q8, intra_node_size=2),
                                      "reduce_scatter", None, f(1024)),
        "coalesced": (q8, "all_gather_coalesced", None, f(128)),
        "allgather_fn_async": (q8, "allgather_fn", None, f(128)),
        "reduce_scatter_fn": (q8, "reduce_scatter_fn", None, f(1024)),
        "logger_wire": (dict(q8, hierarchical_allreduce=False),
                        "reduce_scatter", None,
                        np.ones((n, 1024), np.float32)),
        "ladder_small": (dict(q8, hierarchical_allreduce=False,
                              wire_dtype_by_size=[[8192, "fp8"],
                                                  [None, "int4"]]),
                         "all_gather", None, f(64 // n, 32)),
        "ladder_big": (dict(q8, hierarchical_allreduce=False,
                            wire_dtype_by_size=[[8192, "fp8"],
                                                [None, "int4"]]),
                       "all_gather", None, f(128 // n, 32)),
        "ladder_above_rungs": (dict(q8, hierarchical_allreduce=False,
                                    wire_dtype_by_size=[[8192, "fp8"]]),
                               "all_gather", None, f(128 // n, 32)),
        "ladder_fp32_rung": (dict(q8, hierarchical_allreduce=False,
                                  wire_dtype_by_size=[[8192, "fp32"],
                                                      [None, "int8"]]),
                             "all_gather", None, f(64 // n, 32)),
        "min_message_size": (dict(q8, min_message_size=1 << 20),
                             "all_gather", None, f(64)),
        "disabled": (dict(q8, enabled=False), "reduce_scatter", None,
                     f(1024)),
        "qwz_fp6": (dict(quantized_weights=True, wire_dtype="fp6"),
                    "all_gather", None, _rows(n, (4 // n if n <= 4 else 1,
                                                  256), 4)),
    }


@pytest.fixture(scope="module")
def spawned():
    """{n: {key: (JAX's results per rank or None, the port's per rank)}}:
    one spawn of n gloo processes for every case of the module."""
    out = {}
    for n in WORLDS:
        arrays, ops, want = {}, [], {}
        for case in PRIMS:
            key = "/".join(map(str, case))
            a, op = _prim_case(n, case)
            arrays[key] = a
            ops.append((key, op))
            want[key] = _jax_prim(n, a, op)
        for key, (opts, fn, extra, a) in _facade_cases(n).items():
            arrays[key] = a
            ops.append((key, ("facade", opts, fn, extra)))
            want[key] = None
        got = spawn(n, [dict(name="coll", kind="coll", ops=ops,
                             arrays=arrays)])["coll"]
        out[n] = {k: (want[k], [got[r][k] for r in range(n)], arrays[k])
                  for k in arrays}
    return out


@pytest.mark.parametrize("case", ["/".join(map(str, c)) for c in PRIMS])
@pytest.mark.parametrize("world", WORLDS)
def test_primitive_matches_jax(spawned, world, case):
    want, got, _ = spawned[world][case]
    for r in range(world):
        assert got[r].shape == want[r].shape, (case, r)
        if world == 2:
            np.testing.assert_array_equal(got[r], want[r], err_msg=case)
        else:
            np.testing.assert_allclose(got[r], want[r], rtol=1e-6,
                                       atol=1e-6, err_msg=case)


def _facade(spawned, world, key):
    _, got, a = spawned[world][key]
    return got, a


@pytest.mark.parametrize("world", WORLDS)
def test_hierarchical_all_reduce(spawned, world):
    got, a = _facade(spawned, world, "hier_all_reduce")
    variant = "hier" if world == 4 else "flat_fallback"
    for r in range(world):
        # small-int sums are exact in any association
        np.testing.assert_array_equal(got[r]["result"], a.sum(0))
        assert got[r]["counts"] == {f"all_reduce/{variant}": 1}
    got, a = _facade(spawned, world, "hier_all_reduce_avg")
    for r in range(world):
        np.testing.assert_allclose(got[r]["result"], a.mean(0), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("world", WORLDS)
def test_minmaxprod_passthrough(spawned, world):
    for key, fn in (("max", np.max), ("min", np.min),
                    ("product", np.prod)):
        got, a = _facade(spawned, world, f"{key}_passthrough")
        for r in range(world):
            np.testing.assert_allclose(got[r]["result"], fn(a, axis=0),
                                       rtol=1e-6)
            assert got[r]["counts"] == {"all_reduce/flat_fallback": 1}


@pytest.mark.parametrize("world", WORLDS)
def test_quantized_all_gather_error_bounds(spawned, world):
    for key, bound, fmt in (("int8", 127, "int8"), ("fp8", 16, "fp8")):
        got, a = _facade(spawned, world, f"quant_all_gather_{key}")
        x = np.concatenate(list(a))
        for r in range(world):
            err = np.abs(got[r]["result"] - x).max()
            assert 0 < err <= np.abs(x).max() / bound
            assert got[r]["counts"] == {f"all_gather/q_{fmt}": 1}


@pytest.mark.parametrize("world", WORLDS)
def test_quantized_reduce_scatter_against_flat(spawned, world):
    """Each rank's slice (its own on every variant; the 2-hop input is put
    in inner-major order first) against the flat reduce of the same
    gradients, within n ranks' grid error."""
    for key, variant in (("quant_reduce_scatter", "q_int8"),
                         ("hier_quant_reduce_scatter",
                          "hier_q_int8" if world == 4 else "q_int8")):
        got, a = _facade(spawned, world, key)
        flat = a.sum(0)
        c = flat.size // world
        tol = world * np.abs(a).max() / 127
        for r in range(world):
            err = np.abs(got[r]["result"] - flat[r * c:(r + 1) * c]).max()
            assert 0 < err <= tol, (key, r, err, tol)
            assert got[r]["counts"] == {f"reduce_scatter/{variant}": 1}
    got, a = _facade(spawned, world, "reduce_scatter_fn")
    flat = a.sum(0)
    c = flat.size // world
    for r in range(world):
        assert np.abs(got[r]["result"] - flat[r * c:(r + 1) * c]).max() <= \
            world * np.abs(a).max() / 127


@pytest.mark.parametrize("world", WORLDS)
def test_helpers_ride_the_dispatch(spawned, world):
    got, a = _facade(spawned, world, "coalesced")
    x = np.concatenate(list(a))
    for r in range(world):
        res = got[r]["result"]
        assert 0 < np.abs(res[0] - x).max() <= np.abs(x).max() / 127
        assert got[r]["counts"] == {"all_gather/q_int8": 2}
    got, a = _facade(spawned, world, "allgather_fn_async")
    for r in range(world):
        assert 0 < np.abs(got[r]["result"] - a.reshape(-1)).max() <= \
            np.abs(a).max() / 127
        row = got[r]["summary"]["ops"]["allgather_fn[q_int8]"]
        assert row["count"] == 1
        # the rank's 128 fp32 values as 128 codes and one scale
        assert row["msg_sizes"][512]["wire_bytes_per_call"] == \
            JQ.quantized_wire_bytes(128, "int8", GS) == 132


@pytest.mark.parametrize("world", WORLDS)
def test_comms_logger_reports_wire_bytes_and_variant(spawned, world):
    got, _ = _facade(spawned, world, "logger_wire")
    for r in range(world):
        ops = got[r]["summary"]["ops"]
        row = ops["reduce_scatter[q_int8]"]
        assert row["variant"] == "q_int8" and row["base_op"] == \
            "reduce_scatter"
        (msg, per), = row["msg_sizes"].items()
        assert msg == 4096      # the logical fp32 bytes
        assert per["wire_bytes_per_call"] == \
            JQ.quantized_wire_bytes(1024, "int8", GS) < msg
        assert got[r]["summary"]["totals"]["reduce_scatter"][
            "variants"] == ["q_int8"]


@pytest.mark.parametrize("world", WORLDS)
def test_wire_ladder_routes_each_size(spawned, world):
    """The JAX tests' global sizes: 64 × 32 fp32 = 8192 bytes gathered (the
    first rung, inclusive), 128 × 32 the catch-all or the global wire."""
    for key, variant in (("ladder_small", "q_fp8"), ("ladder_big", "q_int4"),
                         ("ladder_above_rungs", "q_int8"),
                         ("ladder_fp32_rung", "flat_fallback"),
                         ("min_message_size", "flat_fallback")):
        got, a = _facade(spawned, world, key)
        x = np.concatenate(list(a))
        for r in range(world):
            assert got[r]["counts"] == {f"all_gather/{variant}": 1}, key
            if variant == "flat_fallback":
                np.testing.assert_array_equal(got[r]["result"], x)


@pytest.mark.parametrize("world", WORLDS)
def test_disabled_engine_is_bit_exact(spawned, world):
    got, a = _facade(spawned, world, "disabled")
    flat = a.sum(0)
    c = flat.size // world
    for r in range(world):
        np.testing.assert_allclose(got[r]["result"], flat[r * c:(r + 1) * c],
                                   rtol=1e-6, atol=1e-6)
        assert got[r]["counts"] == {}


@pytest.mark.parametrize("world", WORLDS)
def test_qwz_fp_wire_format(spawned, world):
    """``tests/unit/ops/test_fp_quantizer.py::test_qwz_fp_wire_format``'s
    case: a qwZ gather on the fp6 wire reconstructs within the format's
    error, and equals JAX's gather of the same rows bit for bit."""
    got, a = _facade(spawned, world, "qwz_fp6")
    x = np.concatenate(list(a))
    fn = _smap(lambda t: JQ.quantized_all_gather(t, ("dp", ), 0, "fp6",
                                                 2048), world, P("dp"), P())
    want = _np(fn(jnp.asarray(x)))
    for r in range(world):
        out = got[r]["result"]
        np.testing.assert_array_equal(out, want)
        assert np.median(np.abs(out - x) / np.maximum(np.abs(x), 1e-3)) \
            < 0.2
        assert got[r]["counts"] == {"all_gather/q_fp6": 1}
