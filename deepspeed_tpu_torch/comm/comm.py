"""deepspeed_tpu_torch.comm — the communication facade (the port of
``deepspeed_tpu/comm/comm.py``; reference ``deepspeed/comm/comm.py``).

``init_distributed`` brings up a ``torch.distributed`` world (NCCL on the
card, gloo on the CPU; rendezvous through ``MASTER_ADDR``/``MASTER_PORT``/
``RANK``/``WORLD_SIZE``, or ``OMPI_COMM_WORLD_*`` under mpirun; with none
of them set, a one-rank world, as the JAX facade builds a one-process
mesh).  The collectives keep the JAX facade's names, aliases and per-rank
results (``backend.py``).  Every collective is wrapped by :func:`timed_op`,
which feeds the comms logger when the ``comms_logger`` config enables it.
``all_reduce``, ``allgather_fn`` and ``reduce_scatter_fn`` honour
``async_op=True``: they return an :class:`~.backend.AsyncHandle` whose
``wait()`` makes the current stream wait for the collective (a one-rank
group's handle is already complete).

The collectives engine (``comm/collectives``, JAX ``comm.py:49-73`` and
``:305-322``): ``configure`` installs one from the config's enabled
``comm_optimizations`` block (``set_collectives_engine`` by hand), and
one dispatch point, :func:`_dispatch`, offers it every ``all_reduce``,
``all_gather``, ``reduce_scatter``, ``allgather_fn``,
``reduce_scatter_fn`` and coalesced call, except over a ``flat`` group;
the comms logger records the variant it ran and its wire bytes.  The
``allgather_fn``/``reduce_scatter_fn`` of ZeRO++ name their own engine
and wire (``runtime/zero/zeropp.py``).

``send_obj``/``recv_obj`` (JAX ``comm.py:436-441``, ``:522-529``) are the
pipeline's host object channel: a pickled object posted under a key of the
world's rendezvous store (the JAX package posts it to its coordination
service's key-value store) and read, then deleted, by the receiver, which
waits up to ``timeout_s``.  A send never blocks, so a stage can announce a
shape before the tick whose exchange needs it.
"""

import datetime
import functools
import inspect
import os

import torch
import torch.distributed as dist

from ..utils.comms_logging import CommsLogger, get_msg_size_from_args
from ..utils.logging import logger
from .backend import AsyncHandle, ProcessGroup, TorchBackend
from .reduce_op import ReduceOp

cdb = None  # the current backend (reference comm/comm.py:41)
comms_logger = CommsLogger()

# the installed collectives engine (None: every op flat)
_engine = None
# (variant, wire bytes) of the collective the engine just ran, for
# timed_op's record
_last_dispatch = None


def is_initialized():
    return cdb is not None and cdb.initialized


def _assert_initialized():
    if not is_initialized():
        init_distributed()


# a local group's collectives touch no torch.distributed world
_local_backend = TorchBackend(name="local")


def _backend(group):
    """The backend that runs a collective over ``group``: a local (one-rank)
    group needs no world; any other brings the world up if it is not."""
    if group is not None and group.local:
        return _local_backend
    _assert_initialized()
    return cdb


def env_world_size():
    """The world size the environment describes (a launcher's
    ``WORLD_SIZE``, or mpirun's ``OMPI_COMM_WORLD_SIZE``); 1 without
    either."""
    env = os.environ
    return int(env.get("WORLD_SIZE", env.get("OMPI_COMM_WORLD_SIZE", "1")))


def world_is_up(backend):
    """Whether a ``torch.distributed`` world is up that an engine on
    ``backend`` must join: one on that backend, or one of more than one
    rank on any (which :func:`init_distributed` then refuses)."""
    if not dist.is_initialized():
        return False
    return dist.get_backend() == backend or dist.get_world_size() > 1


def set_collectives_engine(engine):
    """Install (None: remove) the collectives engine that :func:`_dispatch`
    offers every eager collective to.  With a world up, its subgroups are
    made now: every rank installs it, as every rank builds the mesh."""
    global _engine
    _engine = engine
    if engine is not None and is_initialized():
        engine.prepare()


def get_collectives_engine():
    return _engine


def configure(config=None, enabled=None, prof_all=None, prof_ops=None,
              verbose=None, debug=None):
    """Comms-logger settings, and the collectives engine of an enabled
    ``comm_optimizations`` block (none when it is disabled), from a parsed
    config; the logger's by keyword."""
    if config is not None and getattr(config, "comms_config", None) \
            is not None:
        comms_logger.configure(config.comms_config)
    co = getattr(config, "comm_optimizations_config", None) \
        if config is not None else None
    if co is not None:
        if co.enabled:
            from .collectives import CollectivesEngine
            set_collectives_engine(CollectivesEngine(co))
        else:
            set_collectives_engine(None)
    if enabled is not None:
        comms_logger.enabled = enabled
    if prof_all is not None:
        comms_logger.prof_all = prof_all
    if prof_ops is not None:
        comms_logger.prof_ops = prof_ops
    if verbose is not None:
        comms_logger.verbose = verbose
    if debug is not None:
        comms_logger.debug = debug


def _event(x):
    from ..accelerator import accelerator_for
    ev = accelerator_for(x.device).Event(enable_timing=True)
    ev.record()
    return ev


def timed_op(func):
    """Record the op in the comms logger when it is on for this op's name:
    events around the launch, the message size and the group's size.  An
    async op is recorded once, at its launch; its end event is recorded
    when its handle is first waited on (so its time runs from the launch to
    that wait)."""
    sig = inspect.signature(func)

    @functools.wraps(func)
    def wrapper(*args, log_name=None, **kwargs):
        global _last_dispatch
        name = log_name or func.__name__
        if not comms_logger.should_log(name):
            return func(*args, **kwargs)
        bound = sig.bind_partial(*args, **kwargs).arguments
        x = bound.get("tensor", bound.get("input_tensor"))  # *_fn's input
        if not isinstance(x, torch.Tensor):
            return func(*args, **kwargs)
        start = _event(x)
        _last_dispatch = None
        result = func(*args, **kwargs)
        variant, wire = _last_dispatch or (None, None)
        _last_dispatch = None
        handle = result if isinstance(result, AsyncHandle) else None
        end = None if handle is not None else _event(x)
        group = bound.get("group")
        ws = group.size() if group is not None else get_world_size()
        entry = comms_logger.record(name, get_msg_size_from_args(x), ws,
                                    start, end, wire_size=wire,
                                    variant=variant)
        if handle is not None:
            handle.on_wait(lambda: entry.__setitem__(4, _event(x)))
        return result

    return wrapper


def mpi_discovery(distributed_port=29500, verbose=True):
    """Rank, world size and local rank from mpirun's ``OMPI_COMM_WORLD_*``
    variables, written to ``RANK``/``WORLD_SIZE``/``LOCAL_RANK``
    (reference ``comm/comm.py:688``).  ``MASTER_ADDR`` must come from the
    environment unless every rank is on this host (then 127.0.0.1);
    ``MASTER_PORT`` defaults to ``distributed_port``.  Returns False when
    mpirun's variables are absent."""
    env = os.environ
    if "OMPI_COMM_WORLD_RANK" not in env:
        return False
    rank = int(env["OMPI_COMM_WORLD_RANK"])
    world = int(env["OMPI_COMM_WORLD_SIZE"])
    local_rank = int(env.get("OMPI_COMM_WORLD_LOCAL_RANK", 0))
    local_size = int(env.get("OMPI_COMM_WORLD_LOCAL_SIZE", world))
    if "MASTER_ADDR" not in env:
        if local_size != world:
            raise RuntimeError(
                "launched under mpirun across hosts without MASTER_ADDR: "
                "export MASTER_ADDR=<rank-0 host> (mpirun -x MASTER_ADDR)")
        env["MASTER_ADDR"] = "127.0.0.1"
    env.setdefault("MASTER_PORT", str(distributed_port))
    env["RANK"], env["WORLD_SIZE"] = str(rank), str(world)
    env["LOCAL_RANK"] = str(local_rank)
    if verbose:
        logger.info(f"mpi_discovery: rank {rank} of {world} (local "
                    f"{local_rank}) @ {env['MASTER_ADDR']}:"
                    f"{env['MASTER_PORT']}")
    return True


def _timeout(timeout):
    if timeout is None or isinstance(timeout, datetime.timedelta):
        return timeout
    return datetime.timedelta(seconds=float(timeout))


def init_distributed(dist_backend=None, auto_mpi_discovery=True,
                     distributed_port=29500, verbose=True, timeout=None,
                     init_method=None, dist_init_required=None, config=None,
                     rank=-1, world_size=-1, mesh=None):
    """Bring up the ``torch.distributed`` world and the backend over it
    (reference ``comm/comm.py:619``).  ``dist_backend``: "nccl" or "gloo"
    (default: the accelerator's, ``get_accelerator()
    .communication_backend_name()``).  A world torch already has is
    adopted; ``dist_init_required=False`` requires one.  A failed init
    raises: nothing falls back to another backend.  ``mesh``: a
    ``utils.groups.Mesh`` (or a dict of axis sizes) whose groups are made
    over the world; every rank passes the same."""
    global cdb
    if is_initialized():
        if dist_backend is not None and dist_backend != cdb.name:
            raise RuntimeError(f"the comm world runs {cdb.name}; "
                               f"{dist_backend} asked for")
        if mesh is not None:
            _install_mesh(mesh)
        configure(config=config)
        return cdb
    if not dist.is_initialized():
        if dist_init_required is False:
            raise RuntimeError("init_distributed(dist_init_required=False) "
                               "but torch.distributed has no process group")
        if dist_backend is None:
            from ..accelerator import get_accelerator
            dist_backend = get_accelerator().communication_backend_name()
        env = os.environ
        if auto_mpi_discovery and "RANK" not in env and rank < 0:
            mpi_discovery(distributed_port=distributed_port, verbose=verbose)
        if rank < 0:
            rank = int(env.get("RANK", 0))
        if world_size < 0:
            world_size = int(env.get("WORLD_SIZE", 1))
        if dist_backend == "nccl":
            torch.cuda.set_device(int(env.get("LOCAL_RANK", 0)))
        kw = dict(rank=rank, world_size=world_size)
        if timeout is not None:
            kw["timeout"] = _timeout(timeout)
        if world_size == 1 and init_method is None:
            # a one-rank world needs no rendezvous
            dist.init_process_group(dist_backend, store=dist.HashStore(),
                                    **kw)
        else:
            if init_method is None:
                addr = env.get("MASTER_ADDR", "127.0.0.1")
                port = env.get("MASTER_PORT", str(distributed_port))
                init_method = f"tcp://{addr}:{port}"
            dist.init_process_group(dist_backend, init_method=init_method,
                                    **kw)
        if verbose:
            logger.info(f"init_distributed: {dist_backend}, rank {rank} of "
                        f"{world_size}")
    elif dist_backend is not None and dist.get_backend() != dist_backend:
        raise RuntimeError(f"torch.distributed runs {dist.get_backend()}; "
                           f"{dist_backend} asked for")
    cdb = TorchBackend(name=dist.get_backend())
    from ..utils import groups
    if mesh is not None:
        _install_mesh(mesh)
    elif not groups.mesh_is_initialized():
        groups.initialize_mesh(user_built=False)
    configure(config=config)
    return cdb


def _install_mesh(mesh):
    """``init_distributed(mesh=...)``: the mesh of those axis sizes."""
    from ..utils import groups
    sizes = mesh.shape if isinstance(mesh, groups.Mesh) else dict(mesh)
    groups.initialize_mesh(**sizes)


def initialize_mesh_device(mesh_shape, mesh_axis_names=None):
    """Reference ``comm/comm.py:603``: the (dp, sp, ...) mesh by shape."""
    from ..utils import groups
    if mesh_axis_names is None:
        mesh_axis_names = ("dp", "sp")[:len(mesh_shape)]
    unknown = set(mesh_axis_names) - {"dp", "sp", "pp", "tp"}
    if unknown:
        raise ValueError(f"unknown mesh axis names {sorted(unknown)}; "
                         "supported: ['dp', 'pp', 'sp', 'tp']")
    sizes = dict(zip(mesh_axis_names, mesh_shape))
    _assert_initialized()
    return groups.initialize_mesh(
        dp=sizes.get("dp"), sp=sizes.get("sp", 1), pp=sizes.get("pp", 1),
        tp=sizes.get("tp", 1)).mesh


def get_world_group():
    _assert_initialized()
    return cdb.world_group


def new_group(axis_names=None, ranks=None):
    """A group over mesh axes (``new_group(("dp",))``, as in JAX) or, as in
    torch, over a list of ranks (every rank must call it)."""
    _assert_initialized()
    if ranks is not None:
        return ProcessGroup(("ranks", ), pg=dist.new_group(list(ranks)))
    from ..utils import groups
    axis_names = (axis_names, ) if isinstance(axis_names, str) else \
        tuple(axis_names)
    for a in axis_names:
        if a not in groups.AXES:
            raise ValueError(f"axis {a!r} not in mesh axes {groups.AXES}")
    return groups._pg(axis_names)


def get_rank(group=None):
    if not is_initialized():
        if dist.is_initialized():
            return dist.get_rank()
        return int(os.environ.get("RANK", "0"))
    return group.rank() if group is not None else cdb.rank()


def get_world_size(group=None):
    if not is_initialized():
        if dist.is_initialized():
            return dist.get_world_size()
        return int(os.environ.get("WORLD_SIZE", "1"))
    return group.size() if group is not None else cdb.world_size()


def get_local_rank():
    return int(os.environ.get("LOCAL_RANK", "0"))


# ------------------------------------------------------------ collectives
def _dispatch(op_name, tensor, op=ReduceOp.SUM, group=None, axis=0,
              engine=None, **route):
    """THE dispatch point: the op offered to ``engine`` (default: the
    installed one, unless ``group`` is ``flat``).  Returns the engine's
    result, with ``(variant, wire bytes)`` left for :func:`timed_op`, or
    None: the caller runs the flat op."""
    global _last_dispatch
    _last_dispatch = None
    if engine is None and (group is None or not group.flat):
        engine = _engine
    if engine is None or not engine.enabled:
        return None
    if group is None or not group.local:
        _assert_initialized()
    g = group if group is not None else cdb.world_group
    hit = engine.dispatch(op_name, tensor, g, reduce_op=op, axis=axis,
                          **route)
    if hit is None:
        return None
    result, variant, wire = hit
    _last_dispatch = (variant, wire)
    return result


@timed_op
def all_reduce(tensor, op=ReduceOp.SUM, group=None, async_op=False):
    """The reduction over the ranks, in place on every rank; returns it (or,
    with ``async_op``, its handle)."""
    hit = _dispatch("all_reduce", tensor, op=op, group=group,
                    async_op=async_op)
    if hit is not None:
        return hit
    return _backend(group).all_reduce(tensor, op=op, group=group,
                                      async_op=async_op)


@timed_op
def all_gather(tensor, group=None, axis=0, tiled=True, async_op=False):
    """The ranks' blocks concatenated along ``axis`` (stacked on a new dim
    0 when ``tiled=False``)."""
    if tiled:
        hit = _dispatch("all_gather", tensor, group=group, axis=axis)
        if hit is not None:
            return hit
    return _backend(group).all_gather(tensor, group=group, axis=axis,
                                      tiled=tiled)


all_gather_into_tensor = all_gather


@timed_op
def reduce_scatter(tensor, op=ReduceOp.SUM, group=None, axis=0,
                   async_op=False):
    """Block r (along ``axis``) of the reduction of the ranks' tensors."""
    hit = _dispatch("reduce_scatter", tensor, op=op, group=group, axis=axis)
    if hit is not None:
        return hit
    return _backend(group).reduce_scatter(tensor, op=op, group=group,
                                          axis=axis)


reduce_scatter_tensor = reduce_scatter


@timed_op
def all_to_all_single(tensor, group=None, split_axis=0, concat_axis=0,
                      async_op=False):
    return _backend(group).all_to_all(tensor, group=group,
                                      split_axis=split_axis,
                                      concat_axis=concat_axis)


all_to_all = all_to_all_single


@timed_op
def broadcast(tensor, src=0, group=None, async_op=False):
    """Rank ``src``'s tensor, in place on every rank; returns it."""
    return _backend(group).broadcast(tensor, src=src, group=group)


def barrier(group=None):
    return _backend(group).barrier(group=group)


def monitored_barrier(group=None, timeout=None, wait_all_ranks=False):
    """A barrier that warns when it took longer than ``timeout`` seconds."""
    import time
    t0 = time.perf_counter()
    barrier(group=group)
    dt = time.perf_counter() - t0
    if timeout is not None and dt > float(timeout):
        logger.warning(f"monitored_barrier took {dt:.3f}s (timeout "
                       f"{timeout}s)")


@timed_op
def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, async_op=False):
    """As in the JAX facade, the reduced value lands on every rank."""
    hit = _dispatch("all_reduce", tensor, op=op, group=group)
    if hit is not None:
        return hit
    return _backend(group).all_reduce(tensor, op=op, group=group)


@timed_op
def gather(tensor, gather_list=None, dst=0, group=None, axis=0,
           async_op=False):
    """As in the JAX facade, the gathered value lands on every rank."""
    hit = _dispatch("all_gather", tensor, group=group, axis=axis)
    if hit is not None:
        return hit
    return _backend(group).all_gather(tensor, group=group, axis=axis)


inference_all_reduce = all_reduce


def all_gather_coalesced(tensors, group=None, async_op=False):
    return [all_gather(t, group=group) for t in tensors]


def all_reduce_coalesced(tensors, op=ReduceOp.SUM, group=None,
                         async_op=False):
    return [all_reduce(t, op=op, group=group) for t in tensors]


@timed_op
def allgather_fn(output_tensor, input_tensor, group=None, async_op=False,
                 debug=None, engine=None, wire_format=None):
    """All-gather of ``input_tensor`` into the flat ``output_tensor``
    (torch's ``all_gather_into_tensor`` argument order); ``input_tensor``
    may be ``output_tensor``'s own block, gathered in place.  Returns the
    output (or, with ``async_op``, its handle).  ``engine`` and
    ``wire_format``: the collectives engine and the quantized wire ZeRO++
    asks for (``runtime/zero/zeropp.py``)."""
    hit = _dispatch("all_gather", input_tensor, group=group, engine=engine,
                    out=output_tensor.reshape(-1), async_op=async_op,
                    wire_format=wire_format)
    if hit is not None:
        return hit
    return _backend(group).all_gather_into(output_tensor, input_tensor,
                                           group=group, async_op=async_op)


@timed_op
def reduce_scatter_fn(output_tensor, input_tensor, op=ReduceOp.SUM,
                      group=None, async_op=False, debug=None, engine=None,
                      wire_format=None, hierarchy=None):
    """Reduce-scatter of ``input_tensor`` into ``output_tensor`` (rank r's
    block of the reduction).  Returns the output (or, with ``async_op``,
    its handle).  ``engine``, ``wire_format`` and ``hierarchy``: ZeRO++'s
    collectives engine, quantized wire and 2-hop groups."""
    flat = input_tensor.reshape(-1)
    hit = _dispatch("reduce_scatter", flat, op=op, group=group,
                    engine=engine, out=output_tensor, async_op=async_op,
                    wire_format=wire_format, hierarchy=hierarchy)
    if hit is not None:
        return hit
    return _backend(group).reduce_scatter(flat, op=op, group=group,
                                          out=output_tensor,
                                          async_op=async_op)


@timed_op
def send(tensor, dst, group=None, tag=0):
    _backend(group).send(tensor, dst, group=group, tag=tag)


@timed_op
def recv(tensor, src, group=None, tag=0):
    return _backend(group).recv(tensor, src, group=group, tag=tag)


def isend(tensor, dst, group=None, tag=0):
    _assert_initialized()
    return dist.isend(tensor, dst, group=(group or cdb.world_group).pg,
                      tag=tag)


def irecv(tensor, src, group=None, tag=0):
    _assert_initialized()
    return dist.irecv(tensor, src, group=(group or cdb.world_group).pg,
                      tag=tag)


_obj_send_seq = {}      # (dst, tag) → next sequence number
_obj_recv_seq = {}      # (src, tag) → next sequence number


def _obj_store():
    _assert_initialized()
    return dist.distributed_c10d._get_default_store()


def send_obj(obj, dst, tag=0):
    """Send a picklable object to rank ``dst`` (reference ``pipe/p2p.py``
    ``send_obj``): posted to the world's store, read by :func:`recv_obj`.
    Does not block."""
    import pickle
    me = get_rank()
    seq = _obj_send_seq.get((dst, tag), 0)
    _obj_send_seq[(dst, tag)] = seq + 1
    _obj_store().set(f"ds_p2p/{me}->{dst}/t{tag}/s{seq}",
                     pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL))


def recv_obj(src, tag=0, timeout_s=300):
    """The next object rank ``src`` sent this rank with ``tag``; waits up
    to ``timeout_s`` seconds for it, then raises."""
    import pickle
    me = get_rank()
    seq = _obj_recv_seq.get((src, tag), 0)
    key = f"ds_p2p/{src}->{me}/t{tag}/s{seq}"
    store = _obj_store()
    store.wait([key], datetime.timedelta(seconds=timeout_s))
    _obj_recv_seq[(src, tag)] = seq + 1
    payload = store.get(key)
    # consumed: free the store's copy (a long run would keep every one)
    store.delete_key(key)
    return pickle.loads(payload)


def scatter(tensor, scatter_list=None, src=0, group=None, async_op=False):
    raise NotImplementedError(
        "eager scatter has no counterpart in the JAX facade either: feed "
        "each rank its rows with engine.shard_batch")


# ------------------------------------------------------- capability probes
def is_available():
    return dist.is_available()


def has_all_gather_into_tensor():
    return True


def has_reduce_scatter_tensor():
    return True


def has_all_reduce_coalesced():
    return True


def has_coalescing_manager():
    return False


def get_global_rank(group=None, group_rank=0):
    """The world rank of the group's ``group_rank``-th member."""
    _assert_initialized()
    g = group if group is not None else cdb.world_group
    if not 0 <= group_rank < g.size():
        raise IndexError(f"group_rank {group_rank} out of range for group "
                         f"of size {g.size()}")
    if g.local:
        return cdb.rank()
    return group_rank if g.pg is None else dist.get_global_rank(g.pg,
                                                                group_rank)


def get_all_ranks_from_group(group=None):
    _assert_initialized()
    g = group if group is not None else cdb.world_group
    if g.local:
        return [cdb.rank()]
    return (list(range(cdb.world_size())) if g.pg is None
            else dist.get_process_group_ranks(g.pg))


def log_summary(show_straggler=False):
    """Reference ``comm/comm.py:422``: the comms logger's table."""
    return comms_logger.log_all(print_log=True,
                                show_straggler=show_straggler)


def destroy_process_group():
    """Tear the world down (and the mesh with it)."""
    global cdb
    from ..utils import groups
    cdb = None
    groups.reset_mesh()   # the hierarchy subgroups go with it
    if dist.is_initialized():
        dist.destroy_process_group()
