"""The comm layer on ``torch.distributed`` (the port of
``deepspeed_tpu/comm``).  ``functional.py`` holds the collectives that run
inside a forward and backward: Ulysses' differentiable all-to-all and the
ring shifts."""

from .backend import AsyncHandle, ProcessGroup, TorchBackend
from .comm import (all_gather, all_gather_coalesced, all_gather_into_tensor,
                   all_reduce, all_reduce_coalesced, all_to_all,
                   all_to_all_single, allgather_fn, barrier, broadcast,
                   comms_logger, configure, destroy_process_group,
                   env_world_size, gather,
                   get_all_ranks_from_group, get_collectives_engine,
                   get_global_rank, get_local_rank, get_rank,
                   get_world_group, get_world_size,
                   has_all_gather_into_tensor, has_all_reduce_coalesced,
                   has_coalescing_manager, has_reduce_scatter_tensor,
                   inference_all_reduce, init_distributed,
                   initialize_mesh_device, irecv, is_available,
                   is_initialized, isend, log_summary, monitored_barrier,
                   mpi_discovery, new_group, recv, recv_obj, reduce,
                   reduce_scatter, reduce_scatter_fn, reduce_scatter_tensor,
                   scatter, send, send_obj, set_collectives_engine, timed_op,
                   world_is_up)
from .reduce_op import ReduceOp
