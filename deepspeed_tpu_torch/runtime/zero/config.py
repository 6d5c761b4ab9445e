"""The ``zero_optimization`` block (the port of
``deepspeed_tpu/runtime/zero/config.py``; reference
``runtime/zero/config.py:344``), on the port's dataclass base.

Stages 0-3 are ported, with ``overlap_comm`` (stages 2-3) and the stage-3
knobs ``stage3_prefetch_bucket_size``, ``stage3_param_persistence_threshold``
and ``stage3_max_live_parameters`` (``runtime/zero/overlap.py``), and the
offload sections (JAX ``runtime/zero/config.py:25-66``):
``offload_optimizer`` (``device`` cpu: the master and moments in pinned
host memory; nvme: on disk between steps, ``runtime/engine.py``) and
``offload_param`` (cpu or nvme: parameter streaming,
``runtime/infinity_engine.py``).  The deprecated ``cpu_offload`` and
``cpu_offload_param`` (with ``cpu_offload_use_pin_memory``) become
``offload_optimizer``/``offload_param`` of device cpu, as upstream
DeepSpeed maps them, unless the new key is given.  ZeRO++ and MiCS are
``runtime/zero/{zeropp,mics}.py``.  ``reduce_bucket_size``,
``allgather_bucket_size``,
``contiguous_gradients`` and the other bucket knobs parse: the port reduces
and gathers the whole flat buffer in one collective each, or one block of
the model at a time (``runtime/zero/partition.py``), so it ignores them.
It ignores as well ``stage3_max_reuse_distance``,
``stage3_model_persistence_threshold``, ``overlap_comm`` at stages 0-1 and
the stage-3 knobs below stage 3; ``ZeroPartitionPlan.describe()`` lists
what it ignored.  ``stage3_gather_16bit_weights_on_model_save`` lets
``save_16bit_model`` gather a stage-3 model unit by unit.
"""

from ...utils.logging import logger
from ..config_utils import DeepSpeedConfigModel

OFFLOAD_DEVICES = ("none", "cpu", "nvme")

# the JSON aliases of the stage-3 knobs (the JAX model's ``alias=``)
STAGE3_ALIASES = {
    "stage3_prefetch_bucket_size": "prefetch_bucket_size",
    "stage3_param_persistence_threshold": "param_persistence_threshold",
    "stage3_model_persistence_threshold": "model_persistence_threshold",
    "stage3_max_live_parameters": "max_live_parameters",
    "stage3_max_reuse_distance": "max_reuse_distance",
    "stage3_gather_16bit_weights_on_model_save":
        "gather_16bit_weights_on_model_save",
}
# knobs the port parses and does not act on
IGNORED_KNOBS = ("contiguous_gradients", "reduce_scatter",
                 "reduce_bucket_size", "use_multi_rank_bucket_allreduce",
                 "allgather_partitions", "allgather_bucket_size",
                 "round_robin_gradients", "sub_group_size",
                 "max_reuse_distance", "model_persistence_threshold")
# the stage-3 knobs the port acts on at stage 3 only
STAGE3_KNOBS = ("prefetch_bucket_size", "param_persistence_threshold",
                "max_live_parameters", "gather_16bit_weights_on_model_save")


class DeepSpeedZeroOffloadParamConfig(DeepSpeedConfigModel):
    """Reference ``offload_config.py``'s param section."""
    device: str = "none"
    nvme_path: str = None
    buffer_count: int = 5
    buffer_size: int = int(1e8)
    max_in_cpu: int = int(1e9)
    pin_memory: bool = False


class DeepSpeedZeroOffloadOptimizerConfig(DeepSpeedConfigModel):
    device: str = "none"
    nvme_path: str = None
    buffer_count: int = 4
    pin_memory: bool = False
    pipeline_read: bool = False
    pipeline_write: bool = False
    fast_init: bool = False
    ratio: float = 1.0


def _check_offload(name, section):
    if section is None:
        return
    dev = str(section.device).split(".")[-1]   # OffloadDeviceEnum.cpu
    if dev not in OFFLOAD_DEVICES:
        raise ValueError(f"zero_optimization.{name}.device must be one of "
                         f"{OFFLOAD_DEVICES}, got {section.device!r}")
    section.device = dev
    for key in ("buffer_count", "buffer_size", "max_in_cpu"):
        if getattr(section, key, 0) < 0:
            raise ValueError(f"zero_optimization.{name}.{key} must be >= 0")
    if not 0.0 <= getattr(section, "ratio", 1.0) <= 1.0:
        raise ValueError(f"zero_optimization.{name}.ratio must be in [0, 1]")


class DeepSpeedZeroConfig(DeepSpeedConfigModel):
    stage: int = 0
    contiguous_gradients: bool = True
    reduce_scatter: bool = True
    reduce_bucket_size: int = int(5e8)
    use_multi_rank_bucket_allreduce: bool = True
    allgather_partitions: bool = True
    allgather_bucket_size: int = int(5e8)
    overlap_comm: bool = None
    load_from_fp32_weights: bool = True
    elastic_checkpoint: bool = False
    offload_param: DeepSpeedZeroOffloadParamConfig = None
    offload_optimizer: DeepSpeedZeroOffloadOptimizerConfig = None
    sub_group_size: int = int(1e9)
    cpu_offload_param: bool = None
    cpu_offload_use_pin_memory: bool = None
    cpu_offload: bool = None
    prefetch_bucket_size: int = int(5e7)
    param_persistence_threshold: int = int(1e5)
    model_persistence_threshold: int = int(1e14)
    max_live_parameters: int = int(1e9)
    max_reuse_distance: int = int(1e9)
    gather_16bit_weights_on_model_save: bool = False
    ignore_unused_parameters: bool = True
    legacy_stage1: bool = False
    round_robin_gradients: bool = False
    zero_hpz_partition_size: int = 1
    zero_quantized_weights: bool = False
    zero_quantized_weights_format: str = "int8"
    zero_quantized_nontrainable_weights: bool = False
    zero_quantized_gradients: bool = False
    mics_shard_size: int = -1
    mics_hierarchical_params_gather: bool = False
    memory_efficient_linear: bool = True

    @classmethod
    def from_dict(cls, section):
        """Parse the JSON block: stage-3 aliases map onto their fields."""
        section = dict(section or {})
        stage3 = sorted(k for k in section if k in STAGE3_ALIASES)
        for key in stage3:
            section[STAGE3_ALIASES[key]] = section.pop(key)
        pin = bool(section.get("cpu_offload_use_pin_memory"))
        for old, new in (("cpu_offload", "offload_optimizer"),
                         ("cpu_offload_param", "offload_param")):
            if old in section:
                logger.warning(f"Config parameter {old} is deprecated use "
                               f"{new} instead")
                if section[old] and section.get(new) is None:
                    section[new] = {"device": "cpu", "pin_memory": pin}
        cfg = cls(**section)
        cfg.given = frozenset(section)
        if not isinstance(cfg.stage, int) or not 0 <= cfg.stage <= 3:
            raise ValueError(f"zero_optimization.stage must be 0-3, got "
                             f"{cfg.stage!r}")
        for key in ("reduce_bucket_size", "allgather_bucket_size",
                    "sub_group_size", "prefetch_bucket_size",
                    "param_persistence_threshold", "max_live_parameters"):
            if getattr(cfg, key) < 0:
                raise ValueError(f"zero_optimization.{key} must be >= 0")
        _check_offload("offload_param", cfg.offload_param)
        _check_offload("offload_optimizer", cfg.offload_optimizer)
        return cfg

    @property
    def offload_optimizer_device(self):
        """"none", "cpu" or "nvme"."""
        oo = self.offload_optimizer
        return "none" if oo is None else oo.device

    @property
    def offload_param_device(self):
        op = self.offload_param
        return "none" if op is None else op.device

    @property
    def bucketed(self):
        """Whether the plan is one of the model's blocks (stage 3, and
        stage 2 with ``overlap_comm``) rather than one flat buffer."""
        return self.stage == 3 or (self.stage == 2 and
                                   bool(self.overlap_comm))

    def ignored(self):
        """{knob: value} of the knobs the config set that the port does
        not act on."""
        given = getattr(self, "given", ())
        knobs = IGNORED_KNOBS
        if self.stage < 3:
            knobs += STAGE3_KNOBS
        out = {k: getattr(self, k) for k in knobs if k in given}
        if self.stage < 2 and self.overlap_comm:
            out["overlap_comm"] = self.overlap_comm
        return out
