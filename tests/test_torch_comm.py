"""The port's comm layer (``deepspeed_tpu_torch.comm`` on
``torch.distributed``) against the JAX facade (``deepspeed_tpu.comm`` on
the 8-device CPU mesh).

The same global numpy array goes to both: the JAX collective runs over a
dp group of n devices (``groups.initialize_mesh(dp=n)``), and rank r of an
n-process gloo world (``torch_dist_worker.py``, one spawn of n processes for
every op of this module) holds block r of it.  Each rank's result must be
the JAX facade's result for that rank: the whole reduced or gathered array
on every rank, block r of a reduce-scatter or an all-to-all.  Exact for
MAX, MIN, the gathers, broadcast and all-to-all; rtol 1e-6 for the sums,
the mean and the product (another order of the same fp32 operations).
``allgather_fn``, ``reduce_scatter_fn`` and ``all_reduce`` also run with
``async_op=True``: the handle's result equals the synchronous call's (in the
worker) and the JAX facade's; the comms logger records each async op once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu.comm as jax_dist
from deepspeed_tpu.comm import ReduceOp as JaxReduceOp
from deepspeed_tpu.utils import groups as jax_groups
from deepspeed_tpu_torch import comm as port_dist
from deepspeed_tpu_torch.comm import ReduceOp
from torch_dist_worker import spawn

WORLDS = (2, 4)
REDUCE_OPS = ("SUM", "MAX", "MIN", "AVG", "PRODUCT")


def _cases(n):
    """{key: (op, global array)}: every op of the module at world n."""
    rng = np.random.default_rng(n)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    cases = {f"all_reduce_{o}": (("all_reduce", o), f(2 * n, 3))
             for o in REDUCE_OPS}
    # PRODUCT over values near 1, so the product stays well scaled
    cases["all_reduce_PRODUCT"] = (("all_reduce", "PRODUCT"),
                                   (1 + 0.1 * f(2 * n, 3)).astype(np.float32))
    cases.update({
        "all_gather_axis0": (("all_gather", 0), f(2 * n, 3)),
        "all_gather_axis1": (("all_gather", 1), f(2, 3 * n)),
        "reduce_scatter": (("reduce_scatter", "same"), f(2 * n, 3)),
        "reduce_scatter_distinct": (("reduce_scatter", "distinct"),
                                    f(2 * n, 3)),
        "broadcast": (("broadcast", 1), f(2 * n, 3)),
        "all_to_all_single": (("all_to_all", 0, 0), f(2 * n * n, 3)),
        "all_to_all_split0_concat1": (("all_to_all", 0, 1), f(2 * n, 3 * n)),
        "all_gather_stacked": (("all_gather_stacked", ), f(2 * n, 3)),
        "allgather_fn_in_place": (("allgather_fn", ), f(4 * n)),
        "reduce_scatter_fn": (("reduce_scatter_fn", ), f(4 * n)),
        "async_allgather_fn": (("async_allgather_fn", ), f(4 * n)),
        "async_reduce_scatter_fn": (("async_reduce_scatter_fn", ),
                                    f(4 * n)),
        "async_all_reduce": (("async_all_reduce", ), f(4 * n)),
        "barrier": (("barrier", ), np.zeros(1, np.float32)),
        "ranks": (("ranks", ), np.zeros(1, np.float32)),
    })
    return cases


def _jax_result(op, g, n):
    """The JAX facade's result for each of n ranks (an async op's is its
    synchronous counterpart's)."""
    if op[0] == "async_allgather_fn":
        op = ("allgather_fn", )
    elif op[0] == "async_all_reduce":
        op = ("all_reduce", "SUM")
    elif op[0] == "async_reduce_scatter_fn":
        op = ("reduce_scatter", "distinct")
    grp = jax_dist.new_group(("dp", ))
    x = jnp.asarray(g)
    block = lambda a, axis, r: np.take(  # noqa: E731
        a, range(r * (a.shape[axis] // n), (r + 1) * (a.shape[axis] // n)),
        axis=axis)
    if op[0] == "all_reduce":
        out = np.asarray(jax_dist.all_reduce(x, op=JaxReduceOp[op[1]],
                                             group=grp))
        return [out] * n
    if op[0] == "all_gather":
        return [np.asarray(jax_dist.all_gather(x, group=grp,
                                               axis=op[1]))] * n
    if op[0] == "reduce_scatter":
        if op[1] == "distinct":
            # each rank's tensor differs: the JAX facade cannot feed that
            # (its input is replicated); the sum is held against numpy
            total = sum(g * (r + 1) for r in range(n))
            return [block(total, 0, r) for r in range(n)]
        out = np.asarray(jax_dist.reduce_scatter(x, group=grp))
        return [block(out, 0, r) for r in range(n)]
    if op[0] == "all_gather_stacked":
        # tiled=False (the backend's; the JAX facade passes tiled=True):
        # the blocks stacked on a new dim 0, held against numpy
        return [np.stack([block(g, 0, r) for r in range(n)])] * n
    if op[0] == "allgather_fn":
        return [np.asarray(jax_dist.allgather_fn(None, x, group=grp))] * n
    if op[0] == "reduce_scatter_fn":
        out = np.asarray(jax_dist.reduce_scatter_fn(None, x, group=grp))
        return [block(out, 0, r) for r in range(n)]
    if op[0] == "broadcast":
        return [np.asarray(jax_dist.broadcast(x, src=op[1], group=grp))] * n
    if op[0] == "all_to_all":
        out = np.asarray(jax_dist.all_to_all_single(
            x, group=grp, split_axis=op[1], concat_axis=op[2]))
        return [block(out, op[1], r) for r in range(n)]
    if op[0] == "barrier":
        jax_dist.barrier(group=grp)
        return [np.array(n)] * n
    if op[0] == "ranks":
        return [np.array([r, n, n - 1, *range(n)]) for r in range(n)]
    raise ValueError(op)


@pytest.fixture(scope="module")
def results():
    """{n: {key: (JAX results per rank, port results per rank)}}: one
    spawn of n gloo processes for every op."""
    out = {}
    for n in WORLDS:
        cases = _cases(n)
        jax_groups.initialize_mesh(dp=n, devices=jax.devices()[:n])
        jax_dist.init_distributed()
        try:
            want = {k: _jax_result(op, g, n) for k, (op, g) in cases.items()}
        finally:
            jax_groups.reset_mesh()
            jax_dist.destroy_process_group()
        leg = dict(name="comm", kind="comm",
                   ops=[(k, op) for k, (op, _) in cases.items()],
                   arrays={k: g for k, (_, g) in cases.items()})
        got = spawn(n, [leg, dict(name="comm_log", kind="comm_log")])
        out[n] = {k: (want[k], [got["comm"][r][k] for r in range(n)])
                  for k in cases}
        out[n]["comm_log"] = got["comm_log"]
    return out


EXACT = ("MAX", "MIN", "all_gather", "allgather_fn", "broadcast",
         "all_to_all", "barrier", "ranks")


@pytest.mark.parametrize("key", sorted(_cases(2)))
@pytest.mark.parametrize("world", WORLDS)
def test_collective_matches_jax_facade(results, world, key):
    want, got = results[world][key]
    for r in range(world):
        assert got[r].shape == want[r].shape, (key, r)
        if any(e in key for e in EXACT):
            np.testing.assert_array_equal(got[r], want[r], err_msg=key)
        else:
            np.testing.assert_allclose(got[r], want[r], rtol=1e-6,
                                       atol=1e-6, err_msg=key)


@pytest.mark.parametrize("world", WORLDS)
def test_async_ops_are_logged_once(results, world):
    for r in results[world]["comm_log"]:
        assert r["counts"] == {"allgather_fn": 1, "reduce_scatter_fn": 1,
                               "all_reduce": 2}


def test_async_handle_of_a_local_group_is_complete():
    group = port_dist.ProcessGroup(("dp", ), local=True)
    x = torch.arange(8, dtype=torch.float32)
    handle = port_dist.allgather_fn(torch.empty(8), x, group=group,
                                    async_op=True)
    assert handle.is_completed()
    assert torch.equal(handle.wait(), x)
    out = torch.empty(8)
    handle = port_dist.reduce_scatter_fn(out, x, group=group, async_op=True)
    assert handle.wait() is out and torch.equal(out, x)
    assert torch.equal(port_dist.all_reduce(x.clone(), group=group,
                                            async_op=True).wait(), x)


def test_init_distributed_without_env_is_a_one_rank_world(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                "OMPI_COMM_WORLD_RANK"):
        monkeypatch.delenv(var, raising=False)
    cdb = port_dist.init_distributed(dist_backend="gloo", verbose=False)
    assert port_dist.is_initialized() and cdb.name == "gloo"
    assert port_dist.get_rank() == 0 and port_dist.get_world_size() == 1
    assert port_dist.get_all_ranks_from_group() == [0]
    x = torch.arange(4, dtype=torch.float32)
    assert torch.equal(port_dist.all_gather(x), x)
    assert torch.equal(port_dist.reduce_scatter(x.clone()), x)
    # a group over axes of size 1 holds only this rank
    tp = port_dist.new_group(("tp", ))
    assert tp.size() == 1 and tp.local
    with pytest.raises(RuntimeError, match="runs gloo"):
        port_dist.init_distributed(dist_backend="nccl")


def test_mpi_discovery_reads_ompi_env(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("OMPI_COMM_WORLD_RANK", "3")
    monkeypatch.setenv("OMPI_COMM_WORLD_SIZE", "4")
    monkeypatch.setenv("OMPI_COMM_WORLD_LOCAL_RANK", "1")
    monkeypatch.setenv("OMPI_COMM_WORLD_LOCAL_SIZE", "2")
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        port_dist.mpi_discovery(verbose=False)
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    assert port_dist.mpi_discovery(distributed_port=29611, verbose=False)
    import os
    assert (os.environ["RANK"], os.environ["WORLD_SIZE"],
            os.environ["LOCAL_RANK"], os.environ["MASTER_PORT"]) == \
        ("3", "4", "1", "29611")


def test_set_collectives_engine_installs_and_removes():
    from deepspeed_tpu_torch.comm.collectives import (CollectivesEngine,
                                                      CommOptimizations)
    port_dist.init_distributed(dist_backend="gloo", verbose=False)
    eng = CollectivesEngine(CommOptimizations(enabled=True))
    try:
        port_dist.set_collectives_engine(eng)
        assert port_dist.get_collectives_engine() is eng
    finally:
        port_dist.set_collectives_engine(None)
    assert port_dist.get_collectives_engine() is None
    # the host object channel (ported with the pipeline): to this rank
    port_dist.send_obj({"shape": (2, 3)}, 0, tag=5)
    port_dist.send_obj([1], 0, tag=5)
    assert port_dist.recv_obj(0, tag=5) == {"shape": (2, 3)}
    assert port_dist.recv_obj(0, tag=5, timeout_s=5) == [1]
    with pytest.raises(RuntimeError):       # nothing sent: the timeout
        port_dist.recv_obj(0, tag=6, timeout_s=0.2)


def test_comms_logger_counts_ops():
    port_dist.init_distributed(dist_backend="gloo", verbose=False)
    logger = port_dist.comms_logger
    logger.reset()
    port_dist.configure(enabled=True, prof_all=True)
    try:
        x = torch.ones(8)
        for _ in range(3):
            port_dist.all_reduce(x)
        port_dist.all_gather(x)
        port_dist.reduce_scatter(x, log_name="grads_rs")
        counts = logger.counts()
        summary = logger.get_summary_dict()["ops"]
    finally:
        port_dist.configure(enabled=False)
        logger.reset()
    assert counts == {"all_reduce": 3, "all_gather": 1, "grads_rs": 1}
    assert summary["all_reduce"]["total_msg_bytes"] == 3 * 32
    assert summary["all_reduce"]["total_latency_ms"] >= 0


def test_reduce_op_maps_onto_torch():
    import torch.distributed as tdist
    from deepspeed_tpu_torch.comm.reduce_op import torch_op
    assert [o.name for o in ReduceOp] == [o.name for o in JaxReduceOp]
    for name in REDUCE_OPS:
        assert torch_op(ReduceOp[name]) == getattr(tdist.ReduceOp, name)
    with pytest.raises(ValueError):
        torch_op(ReduceOp.UNUSED)
