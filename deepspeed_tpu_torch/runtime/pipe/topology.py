"""Process topology (the port of ``deepspeed_tpu/runtime/pipe/
topology.py``; reference ``runtime/pipe/topology.py``: ProcessTopology
``:12``, PipeDataParallelTopology ``:232``, PipeModelDataParallelTopology
``:244``, PipelineParallelGrid ``:251``).

The groups themselves are ``utils/groups.py``'s, made at mesh init; this
is the reference's rank-grid calculus (axis and coordinate mapping,
filtered rank queries), a copy of the JAX file, since checkpoint layouts
and user code are written in its terms."""

from collections import namedtuple
from itertools import product


class ProcessTopology:
    """Cartesian product of named axes → rank mapping (reference ``:12``)."""

    def __init__(self, axes, dims):
        self.axes = list(axes)
        self.dims = list(dims)
        self.ProcessCoord = namedtuple("ProcessCoord", axes)
        self.mapping = {}
        ranges = [range(d) for d in dims]
        for global_rank, coord in enumerate(product(*ranges)):
            key = dict(zip(axes, coord))
            self.mapping[self.ProcessCoord(**key)] = global_rank

    def get_rank(self, **coord_kwargs):
        if len(coord_kwargs) != len(self.axes):
            raise ValueError(f"expected all axes {self.axes}, got {coord_kwargs}")
        return self.mapping[self.ProcessCoord(**coord_kwargs)]

    def get_axis_names(self):
        return self.axes

    def get_rank_repr(self, rank, omit_axes=("data", ), inner_sep="_",
                      outer_sep="-"):
        omit_axes = list(omit_axes)
        axes = [a for a in self.axes if a not in omit_axes]
        names = []
        for ax in axes:
            ax_rank = getattr(self.get_coord(rank=rank), ax)
            names.append(f"{ax}{inner_sep}{ax_rank:02d}")
        return outer_sep.join(names)

    def get_dim(self, axis):
        if axis not in self.axes:
            return 0
        return self.dims[self.axes.index(axis)]

    def get_coord(self, rank):
        for coord, r in self.mapping.items():
            if r == rank:
                return coord
        raise ValueError(f"rank {rank} not in topology")

    def get_axis_comm_lists(self, axis):
        """Groups of ranks that vary only along ``axis`` (reference ``:142``)."""
        if axis not in self.axes:
            return []
        other_axes = [a for a in self.axes if a != axis]
        lists = []
        ranges = [range(self.get_dim(a)) for a in other_axes]
        for coord in product(*ranges):
            other = dict(zip(other_axes, coord))
            ranks = [self.get_rank(**{axis: i}, **other)
                     for i in range(self.get_dim(axis))]
            lists.append(ranks)
        return lists

    def filter_match(self, **filter_kwargs):
        def match(coord):
            return all(getattr(coord, k) == v for k, v in filter_kwargs.items())
        return [rank for coord, rank in self.mapping.items() if match(coord)]

    def get_axis_list(self, axis, idx):
        return self.filter_match(**{axis: idx})

    def world_size(self):
        return len(self.mapping)

    def __str__(self):
        return str(self.mapping)


class PipeDataParallelTopology(ProcessTopology):
    """Reference ``:232``: (pipe, data) grid."""

    def __init__(self, num_pp, num_dp):
        super().__init__(axes=["pipe", "data"], dims=[num_pp, num_dp])


class PipeModelDataParallelTopology(ProcessTopology):
    """Reference ``:244``: (pipe, data, model) grid."""

    def __init__(self, num_pp, num_mp, num_dp):
        super().__init__(axes=["pipe", "data", "model"],
                         dims=[num_pp, num_dp, num_mp])


class PipelineParallelGrid:
    """Reference ``:251``: axis-degree accessors over the mesh
    (``utils/groups.py``, whose groups are made at mesh init); the stage
    and data-parallel ids and sizes."""

    def __init__(self, topology=None, process_id=0):
        from ...utils import groups
        if topology is None:
            st = groups.get_mesh_state()
            topology = PipeDataParallelTopology(num_pp=st.pp, num_dp=st.dp *
                                                st.sp * st.tp)
        self._topo = topology
        self.global_rank = process_id
        self.world_size = topology.world_size()
        self.pipe_parallel_size = topology.get_dim("pipe")
        self.data_parallel_size = topology.get_dim("data")
        self.model_parallel_size = max(1, topology.get_dim("model"))
        coord = topology.get_coord(self.global_rank)
        self.stage_id = getattr(coord, "pipe", 0)
        self.data_parallel_id = getattr(coord, "data", 0)

    def get_stage_id(self):
        return self.stage_id

    def get_data_parallel_id(self):
        return self.data_parallel_id

    def get_pipe_parallel_rank(self):
        return self.stage_id

    def get_pipe_parallel_world_size(self):
        return self.pipe_parallel_size

    def get_data_parallel_rank(self):
        return self.data_parallel_id

    def get_data_parallel_world_size(self):
        return self.data_parallel_size

    def get_model_parallel_rank(self):
        return 0

    def get_model_parallel_world_size(self):
        return self.model_parallel_size

    def get_global_rank(self):
        return self.global_rank

    def topology(self):
        return self._topo

    def is_first_stage(self):
        return self.stage_id == 0

    def is_last_stage(self):
        return self.stage_id == self.pipe_parallel_size - 1

    def stage_to_global(self, stage_id, **kwargs):
        coord = self._topo.get_coord(self.global_rank)
        d = coord._asdict()
        d.update(kwargs)
        d["pipe"] = stage_id
        return self._topo.get_rank(**d)
