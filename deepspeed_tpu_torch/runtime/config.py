"""DeepSpeed JSON config, the training subset (the port of
``deepspeed_tpu/runtime/config.py``: ``DeepSpeedConfig``).

Same key names as the JAX package: the batch trinity
(``train_batch_size``, ``train_micro_batch_size_per_gpu``,
``gradient_accumulation_steps``), ``bf16``/``bfloat16``, ``fp16`` (with
dynamic loss scaling), ``optimizer``, ``scheduler``,
``gradient_clipping``, ``zero_optimization`` (stages 0-3,
``runtime/zero/config.py``), ``steps_per_print``,
``data_types.grad_accum_dtype``, ``resilience.check_finite_grads``,
``resilience.checkpoint_integrity``, ``checkpoint`` (``load_universal``,
``use_node_local_storage``), ``comms_logger``, ``comm_optimizations``
(the collectives engine, its wire ladder, ``zero_mode`` and the
``overlap``/``prefetch`` schedulers, with JAX's validation),
``wall_clock_breakdown``, ``mesh`` (``pp``, ``dp``, ``sp``, ``ep``,
``tp``), ``sequence_parallel_size``, ``domino`` (``enabled``,
``n_streams``), ``pipeline`` (JAX's ``PipelineConfig``),
``sequence_length`` and ``seed``.

A key that turns on a feature this port does not have yet raises
``NotImplementedError`` naming its ROADMAP queue-A item
(:data:`_UNPORTED`); none is silently ignored.  Keys that configure a
feature without turning it on (bucket sizes) parse.
"""

import hashlib
import json
import os
from dataclasses import field

from ..utils.logging import logger
from ..utils.not_ported import not_ported
from .config_utils import DeepSpeedConfigModel
from .zero.config import DeepSpeedZeroConfig

ADAM_OPTIMIZER = "adam"
ADAMW_OPTIMIZER = "adamw"
FUSED_ADAM_OPTIMIZER = "fusedadam"
LAMB_OPTIMIZER = "lamb"
FUSED_LAMB_OPTIMIZER = "fusedlamb"
LION_OPTIMIZER = "lion"
SGD_OPTIMIZER = "sgd"
ONEBIT_ADAM_OPTIMIZER = "onebitadam"
ZERO_ONE_ADAM_OPTIMIZER = "zerooneadam"
ONEBIT_LAMB_OPTIMIZER = "onebitlamb"
ONEBIT_OPTIMIZERS = (ONEBIT_ADAM_OPTIMIZER, ZERO_ONE_ADAM_OPTIMIZER,
                     ONEBIT_LAMB_OPTIMIZER)
ADAM_OPTIMIZERS = (ADAM_OPTIMIZER, ADAMW_OPTIMIZER, FUSED_ADAM_OPTIMIZER)
PORTED_OPTIMIZERS = ADAM_OPTIMIZERS + (LAMB_OPTIMIZER, FUSED_LAMB_OPTIMIZER,
                                       LION_OPTIMIZER, SGD_OPTIMIZER) + \
    ONEBIT_OPTIMIZERS
# the JAX package's other optimizers → the queue-A item that brings each
_UNPORTED_OPTIMIZERS = {"muon": 11, "adagrad": 11}
GRAD_ACCUM_DTYPES = (None, "fp32", "bf16", "fp16")
MB = 1 << 20
# comm_optimizations.zero_mode: the JAX package's two qgZ micro-steps
ZERO_MODES = ("gspmd", "flat_manual")


class DeepSpeedConfigError(Exception):
    pass


class FP16Config(DeepSpeedConfigModel):
    """Reference fp16 section (``config.py:45-55``; ``loss_scale`` 0 means
    dynamic scaling)."""
    enabled: bool = False
    auto_cast: bool = False
    loss_scale: float = 0.0
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    consecutive_hysteresis: bool = False
    min_loss_scale: float = 1.0
    fp16_master_weights_and_grads: bool = False


class BF16Config(DeepSpeedConfigModel):
    enabled: bool = False


class FiniteGradsConfig(DeepSpeedConfigModel):
    """The finite-grad step guard (``config.py:369``): a step whose
    gradients are non-finite, or whose norm exceeds
    ``grad_norm_spike_factor`` times the running mean of recent healthy
    norms (after ``spike_warmup_steps``), is skipped through the fp16 skip
    path in every precision; ``max_consecutive_skips`` skips in a row
    abort.  Enabling it syncs the skip flag to the host each boundary."""
    enabled: bool = False
    max_consecutive_skips: int = 5
    grad_norm_spike_factor: float = 0.0
    spike_warmup_steps: int = 10


class DataTypesConfig(DeepSpeedConfigModel):
    grad_accum_dtype: str = None


class CheckpointConfig(DeepSpeedConfigModel):
    """The ``checkpoint`` block (``config.py:338``): ``load_universal``
    sends ``load_checkpoint`` to the universal layout; with
    ``use_node_local_storage`` every rank commits (and resolves) its own
    tag.  ``tag_validation`` and ``parallel_write`` parse, as in JAX."""
    tag_validation: str = "Warn"
    load_universal: bool = False
    use_node_local_storage: bool = False
    parallel_write: dict = None


class CheckpointIntegrityConfig(DeepSpeedConfigModel):
    """``resilience.checkpoint_integrity`` (``config.py:359``): a
    ``manifest.json`` (file list, sizes, CRC32s, config hash) committed
    after every file of a tag; ``load_checkpoint`` verifies it and falls
    back to the newest valid tag.  ``keep_n`` valid tags are kept (0: all);
    a failed write is retried ``save_retries`` times, ``retry_backoff``
    seconds doubling."""
    enabled: bool = True
    keep_n: int = 0
    save_retries: int = 3
    retry_backoff: float = 0.25


class PipelineConfig(DeepSpeedConfigModel):
    """The ``pipeline`` block (JAX ``config.py:314``).  ``stages`` (an int)
    gives the pipeline degree where ``mesh.pp`` does not; the rest parse,
    as in JAX, whose engine reads none of them (the ``PipelineModule``
    carries its own ``activation_checkpoint_interval``)."""
    stages: object = "auto"
    partition: str = "best"
    seed_layers: bool = False
    activation_checkpoint_interval: int = 0
    pipe_partitioned: bool = True
    grad_partitioned: bool = True
    schedule: str = "1f1b"


class ActivationCheckpointingConfig(DeepSpeedConfigModel):
    """The ``activation_checkpointing`` block (JAX ``config.py:304``);
    ``runtime/activation_checkpointing/checkpointing.py:configure`` reads
    it."""
    partition_activations: bool = False
    contiguous_memory_optimization: bool = False
    cpu_checkpointing: bool = False
    number_checkpoints: object = None
    synchronize_checkpoint_boundary: bool = False
    profile: bool = False


class CommsLoggerConfig(DeepSpeedConfigModel):
    """The ``comms_logger`` block (``config.py:63``)."""
    enabled: bool = False
    verbose: bool = False
    prof_all: bool = True
    debug: bool = False
    prof_ops: list = None

    def __init__(self, strict=False, **data):
        super().__init__(strict=strict, **data)
        self.prof_ops = list(self.prof_ops or [])


class CommsConfig(DeepSpeedConfigModel):
    comms_logger: CommsLoggerConfig = None

    def __init__(self, strict=False, **data):
        super().__init__(strict=strict, **data)
        if self.comms_logger is None:
            self.comms_logger = CommsLoggerConfig()

    @property
    def comms_logger_enabled(self):
        return self.comms_logger.enabled


class PrefetchConfig(DeepSpeedConfigModel):
    """``comm_optimizations.overlap.prefetch`` (``config.py:83``): stage
    3's forward gather prefetch, its own gate.  ``bucket_mb`` 0: the
    overlap block's ``bucket_mb``; an explicit
    ``stage3_prefetch_bucket_size`` arms it when this block does not say."""
    enabled: bool = False
    bucket_mb: float = 0.0
    max_inflight: int = 2


class OverlapConfig(DeepSpeedConfigModel):
    """``comm_optimizations.overlap`` (``config.py:102``): the bucketed
    gradient reduce.  ``max_inflight`` bounds the reduce-scatters in
    flight; the port's reduce bucket is a unit of the plan (a block), so
    ``bucket_mb`` is the prefetch's default bucket."""
    enabled: bool = False
    bucket_mb: float = 32.0
    max_inflight: int = 2
    prefetch: PrefetchConfig = field(default_factory=PrefetchConfig)


class CommOptimizationsConfig(DeepSpeedConfigModel):
    """``comm_optimizations`` (``config.py:124``): the collectives engine
    (``comm/collectives``).  Disabled (the default) every collective is
    flat; enabled, the facade's collectives dispatch to the hierarchical
    and quantized variants, and ZeRO's gathers (``quantized_weights``)
    and reduce-scatters (``quantized_gradients``) take the quantized
    wire."""
    enabled: bool = False
    hierarchical_allreduce: bool = True
    quantized_weights: bool = False
    quantized_gradients: bool = False
    wire_dtype: str = "int8"
    wire_dtype_by_size: list = None
    quantization_group_size: int = 2048
    intra_node_size: int = 0
    min_message_size: int = 0
    zero_mode: str = "gspmd"
    overlap: OverlapConfig = field(default_factory=OverlapConfig)


class DominoConfig(DeepSpeedConfigModel):
    """Domino µ-streams (JAX ``config.py:293``; ``runtime/domino/``): each
    micro-batch runs as ``n_streams`` independent parts whose tp reduces
    are started async under the other parts' compute."""
    enabled: bool = False
    n_streams: int = 2


class MoeConfig(DeepSpeedConfigModel):
    """``moe`` (``config.py:183``): the expert-parallel dispatch
    (``moe/engine.py``).  ``quantized_dispatch`` moves the exchange over
    ep on a quantized wire; with ``hierarchical_dispatch`` and an
    ``intra_node_size`` that splits the ep group it runs in two hops.
    ``gating_seed`` seeds the noisy gates' generator the engine threads
    (default: the config's ``seed``)."""
    enabled: bool = False
    quantized_dispatch: bool = False
    wire_dtype: str = "int8"
    quantization_group_size: int = 2048
    hierarchical_dispatch: bool = True
    intra_node_size: int = 0
    gating_seed: int = None


def _check_moe(mc):
    """JAX's validators (``config.py:207-213``, ``:615-625``)."""
    from ..comm.collectives import WIRE_FORMATS
    wires = ("fp32", ) + tuple(WIRE_FORMATS)
    if mc.wire_dtype not in wires:
        raise DeepSpeedConfigError(
            f"moe.wire_dtype {mc.wire_dtype!r} unknown (have "
            f"{', '.join(wires)})")
    if int(mc.quantization_group_size) < 128 or int(mc.intra_node_size) < 0:
        raise DeepSpeedConfigError(
            "moe: quantization_group_size >= 128 and intra_node_size >= 0")


def _check_comm_optimizations(co):
    """The JAX model's bounds and validators (``config.py:140-178``,
    ``:557-571``)."""
    from ..comm.collectives import WIRE_FORMATS, build_wire_ladder
    if co.wire_dtype not in WIRE_FORMATS:
        raise DeepSpeedConfigError(
            f"comm_optimizations.wire_dtype {co.wire_dtype!r} unknown "
            f"(have {', '.join(WIRE_FORMATS)})")
    try:
        build_wire_ladder(co.wire_dtype_by_size)
    except ValueError as e:
        raise DeepSpeedConfigError(
            f"comm_optimizations.wire_dtype_by_size invalid: {e}") from e
    if co.zero_mode not in ZERO_MODES:
        raise DeepSpeedConfigError(
            f"comm_optimizations.zero_mode {co.zero_mode!r} unknown (have "
            f"{', '.join(ZERO_MODES)})")
    for key, low in (("quantization_group_size", 128),
                     ("intra_node_size", 0), ("min_message_size", 0)):
        if getattr(co, key) < low:
            raise DeepSpeedConfigError(
                f"comm_optimizations.{key} must be >= {low}")
    ov = co.overlap
    if not ov.bucket_mb > 0 or ov.max_inflight < 1:
        raise DeepSpeedConfigError(
            "comm_optimizations.overlap: bucket_mb > 0 and max_inflight "
            ">= 1")
    if ov.prefetch.bucket_mb < 0 or ov.prefetch.max_inflight < 1:
        raise DeepSpeedConfigError(
            "comm_optimizations.overlap.prefetch: bucket_mb >= 0 and "
            "max_inflight >= 1")


def _on(section, *keys):
    """True when ``section`` (a dict or None) has any of ``keys`` set to a
    true value other than "none"."""
    section = section or {}
    return any(section.get(k) not in (None, False, 0, "none", {}, [])
               for k in keys)


def _check_fp16(cfg):
    """The bounds the JAX package's pydantic model puts on the fp16
    section (``config.py:45-55``)."""
    for key, low in (("loss_scale", 0.0), ("initial_scale_power", 0),
                     ("loss_scale_window", 1), ("hysteresis", 1),
                     ("min_loss_scale", 0.0)):
        value = getattr(cfg, key)
        if not isinstance(value, (int, float)) or value < low:
            raise DeepSpeedConfigError(f"fp16.{key} must be >= {low}, got "
                                       f"{value!r}")


def _check_finite_grads(cfg):
    if cfg.max_consecutive_skips < 1 or cfg.grad_norm_spike_factor < 0 or \
            cfg.spike_warmup_steps < 0:
        raise DeepSpeedConfigError(
            "resilience.check_finite_grads: max_consecutive_skips >= 1, "
            "grad_norm_spike_factor >= 0 and spike_warmup_steps >= 0")


def _check_integrity(cfg):
    if cfg.keep_n < 0 or cfg.save_retries < 0 or cfg.retry_backoff < 0:
        raise DeepSpeedConfigError(
            "resilience.checkpoint_integrity: keep_n, save_retries and "
            "retry_backoff must be >= 0")


def _mesh_dims(pd):
    """The mesh axes sizes the config asks for: ``mesh.tp`` with
    ``tensor_parallel.tp_size`` as its default (JAX ``config.py:671-672``)
    and ``sequence_parallel_size`` folded in."""
    mesh = dict(pd.get("mesh") or {})
    tp = (pd.get("tensor_parallel") or {}).get("tp_size", 1)
    if tp not in (None, 1):
        mesh.setdefault("tp", tp)
    if pd.get("sequence_parallel_size", 1) not in (None, 1):
        mesh["sp"] = pd["sequence_parallel_size"]
    return mesh


# (what, queue-A item, predicate on the raw config dict)
_UNPORTED = (
    ("resilience.watchdog", 12,
     lambda pd: _on((pd.get("resilience") or {}).get("watchdog"),
                    "enabled")),
    ("telemetry", 12, lambda pd: _on(pd.get("telemetry"), "enabled")),
    ("progressive_layer_drop", 12,
     lambda pd: _on(pd.get("progressive_layer_drop"), "enabled")),
    ("curriculum_learning / data_efficiency", 12,
     lambda pd: _on(pd.get("curriculum_learning"), "enabled") or
     _on(pd.get("data_efficiency"), "enabled")),
    ("hybrid_engine", 12, lambda pd: _on(pd.get("hybrid_engine"), "enabled")),
    ("eigenvalue", 11, lambda pd: _on(pd.get("eigenvalue"), "enabled")),
    ("compression_training", 11, lambda pd: bool(
        pd.get("compression_training"))),
    ("flops_profiler", 12, lambda pd: _on(pd.get("flops_profiler"),
                                          "enabled")),
    ("monitors (tensorboard, wandb, csv_monitor, comet)", 12,
     lambda pd: any(_on(pd.get(k), "enabled") for k in
                    ("tensorboard", "wandb", "csv_monitor", "comet"))),
    ("autotuning", 12, lambda pd: _on(pd.get("autotuning"), "enabled")),
    ("elasticity", 12, lambda pd: _on(pd.get("elasticity"), "enabled")),
)


class DeepSpeedConfig:
    """Parsed training config (reference ``runtime/config.py:706``)."""

    def __init__(self, config):
        if config is None:
            config = {}
        if isinstance(config, str):
            if not os.path.exists(config):
                raise DeepSpeedConfigError(
                    f"DeepSpeed config path does not exist: {config}")
            with open(config) as f:
                config = json.load(f)
        elif isinstance(config, DeepSpeedConfig):
            config = config._param_dict
        elif not isinstance(config, dict):
            raise DeepSpeedConfigError(
                f"Expected a string path or dict, got {type(config)}")
        self._param_dict = dict(config)
        self._initialize_params(self._param_dict)

    def _initialize_params(self, pd):
        zo = pd.get("zero_optimization") or {}
        co = pd.get("comm_optimizations") or {}
        qgz = bool(zo.get("zero_quantized_gradients")) or bool(
            co.get("enabled") and co.get("quantized_gradients"))
        if qgz and (pd.get("sequence_parallel_size", 1) not in (None, 1) or
                    _mesh_dims(pd).get("sp") not in (None, 1) or
                    _mesh_dims(pd).get("pp") not in (None, 1) or
                    (pd.get("pipeline") or {}).get("stages", "auto")
                    not in ("auto", 1)):
            # the JAX engine's refusal (zeropp.py build_manual_dp_micro)
            from .zero.zeropp import QGZ_SP_PP
            raise ValueError(QGZ_SP_PP)
        for what, item, turned_on in _UNPORTED:
            if turned_on(pd):
                raise not_ported(f"config: {what}", item)
        if pd.get("sparse_gradients", False):
            raise ValueError(
                "sparse_gradients is a torch sparse-embedding optimization "
                "the JAX package rejects too (embedding grads are dense); "
                "remove the key")
        self._raw_batch = (pd.get("train_batch_size"),
                           pd.get("train_micro_batch_size_per_gpu"),
                           pd.get("gradient_accumulation_steps"))
        (self.train_batch_size, self.train_micro_batch_size_per_gpu,
         self.gradient_accumulation_steps) = self._raw_batch
        self.steps_per_print = pd.get("steps_per_print", 10)
        self.sequence_length = pd.get("sequence_length")
        if self.sequence_length is not None and (
                not isinstance(self.sequence_length, int)
                or self.sequence_length <= 0):
            raise DeepSpeedConfigError(
                f"sequence_length must be a positive int, got "
                f"{self.sequence_length!r}")
        self.seed = pd.get("seed", 1234)

        self.zero_config = DeepSpeedZeroConfig.from_dict(
            pd.get("zero_optimization"))
        self.zero_optimization_stage = self.zero_config.stage
        self.zero_enabled = self.zero_optimization_stage > 0
        self.comms_config = CommsConfig(
            comms_logger=pd.get("comms_logger") or {})
        self.comm_optimizations_config = CommOptimizationsConfig(
            **(pd.get("comm_optimizations") or {}))
        _check_comm_optimizations(self.comm_optimizations_config)
        self.wall_clock_breakdown = bool(pd.get("wall_clock_breakdown",
                                                False))
        mesh = pd.get("mesh") or {}
        self.mesh_dp = mesh.get("dp")
        self.mesh_ep = int(mesh.get("ep") or 1)
        self.mesh_tp = int(_mesh_dims(pd).get("tp") or 1)
        self.moe_config = MoeConfig(**pd.get("moe", {}) or {})
        self.domino_config = DominoConfig(**pd.get("domino", {}) or {})
        _check_moe(self.moe_config)
        sps = {int(v) for v in (mesh.get("sp"),
                                pd.get("sequence_parallel_size"))
               if v not in (None, 1)}
        if len(sps) > 1:
            raise DeepSpeedConfigError(
                f"mesh.sp={mesh.get('sp')} and sequence_parallel_size="
                f"{pd.get('sequence_parallel_size')} disagree")
        self.mesh_sp = sps.pop() if sps else 1
        self.pipeline_config = PipelineConfig(**pd.get("pipeline", {}) or {})
        self.activation_checkpointing_config = ActivationCheckpointingConfig(
            **pd.get("activation_checkpointing", {}) or {})
        stages = self.pipeline_config.stages
        self.mesh_pp = int(mesh.get("pp") or 1)
        if isinstance(stages, int) and stages > 1:
            if self.mesh_pp not in (1, stages):
                raise DeepSpeedConfigError(
                    f"mesh.pp={self.mesh_pp} and pipeline.stages={stages} "
                    "disagree")
            self.mesh_pp = stages
        self.fp16_config = FP16Config(**pd.get("fp16", {}) or {})
        self.bf16_config = BF16Config(
            **pd.get("bfloat16", pd.get("bf16", {})) or {})
        self.fp16_enabled = self.fp16_config.enabled
        self.bfloat16_enabled = self.bf16_config.enabled
        if self.fp16_enabled and self.bfloat16_enabled:
            raise DeepSpeedConfigError("fp16 and bf16 cannot both be enabled")
        self._zero_schedulers(pd)
        _check_fp16(self.fp16_config)
        self.fp16_auto_cast = self.fp16_config.auto_cast
        self.loss_scale = self.fp16_config.loss_scale
        self.initial_dynamic_scale = 2**self.fp16_config.initial_scale_power
        self.dynamic_loss_scale_args = {
            "init_scale": 2**self.fp16_config.initial_scale_power,
            "scale_window": self.fp16_config.loss_scale_window,
            "min_scale": self.fp16_config.min_loss_scale,
            "delayed_shift": self.fp16_config.hysteresis,
        }
        resilience = pd.get("resilience") or {}
        self.finite_grads_config = FiniteGradsConfig(
            **resilience.get("check_finite_grads", {}) or {})
        _check_finite_grads(self.finite_grads_config)
        self.checkpoint_integrity = CheckpointIntegrityConfig(
            **resilience.get("checkpoint_integrity", {}) or {})
        _check_integrity(self.checkpoint_integrity)
        self.checkpoint_config = CheckpointConfig(
            **pd.get("checkpoint", {}) or {})
        self.load_universal_checkpoint = self.checkpoint_config.load_universal
        self.use_node_local_storage = \
            self.checkpoint_config.use_node_local_storage

        grad_clip = pd.get("gradient_clipping", 0.0)
        self.gradient_clipping = float(grad_clip) if grad_clip else 0.0

        self.optimizer_name = None
        self.optimizer_params = None
        opt = pd.get("optimizer")
        if opt:
            self.optimizer_name = str(opt.get("type", "")).lower()
            self.optimizer_params = opt.get("params", {})
            if self.optimizer_name in _UNPORTED_OPTIMIZERS:
                raise not_ported(f"optimizer {self.optimizer_name!r}",
                                 _UNPORTED_OPTIMIZERS[self.optimizer_name])
            if self.optimizer_name not in PORTED_OPTIMIZERS:
                raise ValueError(f"unsupported optimizer "
                                 f"{self.optimizer_name!r} (have: "
                                 f"{', '.join(PORTED_OPTIMIZERS)})")

        self.scheduler_name = None
        self.scheduler_params = None
        sched = pd.get("scheduler")
        if sched:
            self.scheduler_name = sched.get("type")
            self.scheduler_params = sched.get("params", {})

        self.data_types_config = DataTypesConfig(
            **pd.get("data_types", {}) or {})
        self.gradient_accumulation_dtype = \
            self.data_types_config.grad_accum_dtype
        if self.gradient_accumulation_dtype not in GRAD_ACCUM_DTYPES:
            raise DeepSpeedConfigError(
                f"data_types.grad_accum_dtype "
                f"{self.gradient_accumulation_dtype!r} unknown (have fp32, "
                f"bf16, fp16)")

    def _zero_schedulers(self, pd):
        """The JAX package's arming rules (``config.py:572-600``): the
        ``comm_optimizations.overlap`` block, or ``overlap_comm`` when the
        block does not say, arms the bucketed gradient reduce (stages 2-3
        here); the ``overlap.prefetch`` block, or an EXPLICIT
        ``stage3_prefetch_bucket_size`` > 0 when the block does not say,
        arms the forward gather prefetch at stage 3.  That knob is an
        element count, turned into bytes by the compute dtype's item size
        (its default must not size buckets).  ``overlap.max_inflight`` and
        ``prefetch.max_inflight`` bound each scheduler's window."""
        zc = self.zero_config
        ov = self.comm_optimizations_config.overlap
        ov_user = (pd.get("comm_optimizations") or {}).get("overlap") or {}
        if "enabled" in ov_user:
            zc.overlap_comm = bool(ov.enabled)
        else:
            ov.enabled = bool(zc.overlap_comm)
        self.overlap_comm_enabled = bool(zc.overlap_comm) and zc.stage >= 2
        self.overlap_max_inflight = int(ov.max_inflight)
        pf, pf_user = ov.prefetch, ov_user.get("prefetch") or {}
        zo = pd.get("zero_optimization") or {}
        explicit = ("stage3_prefetch_bucket_size" in zo
                    or "prefetch_bucket_size" in zo)
        itemsize = 2 if (self.fp16_enabled or self.bfloat16_enabled) else 4
        if "enabled" in pf_user:
            if explicit and zc.stage >= 3:
                logger.warning(
                    "zero_optimization.stage3_prefetch_bucket_size is "
                    "overridden by the explicit comm_optimizations.overlap."
                    "prefetch block (prefetch stays %s)",
                    "enabled" if pf.enabled else "disabled")
            bucket_mb = pf.bucket_mb or ov.bucket_mb
        else:
            pf.enabled = explicit and zc.prefetch_bucket_size > 0
            bucket_mb = (pf.bucket_mb if "bucket_mb" in pf_user else
                         zc.prefetch_bucket_size * itemsize / float(MB))
        self.prefetch_enabled = bool(pf.enabled) and zc.stage >= 3
        self.prefetch_bucket_mb = (float(bucket_mb) if self.prefetch_enabled
                                   else 0.0)
        self.prefetch_max_inflight = int(pf.max_inflight)

    def config_hash(self):
        """Content hash of the user config (``config.py:766-773``, the same
        hash for the same dict in both packages): each checkpoint's
        manifest records it, and a resume under another config warns."""
        blob = json.dumps(self._param_dict, sort_keys=True, default=str)
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    def resolve_batch_sizes(self, dp_world_size):
        """Complete the trinity given the data-parallel degree
        (``config.py:705``, with its errors)."""
        tb, mb, gas = self._raw_batch
        if tb is not None and mb is not None and gas is not None:
            if tb != mb * gas * dp_world_size:
                raise DeepSpeedConfigError(
                    f"train_batch_size ({tb}) != micro_batch ({mb}) * "
                    f"grad_accum ({gas}) * dp_world ({dp_world_size})")
        elif tb is not None and mb is not None:
            gas = tb // (mb * dp_world_size)
            if gas == 0 or tb % (mb * dp_world_size) != 0:
                raise DeepSpeedConfigError(
                    f"train_batch_size ({tb}) not divisible by micro_batch*dp "
                    f"({mb}*{dp_world_size})")
        elif tb is not None and gas is not None:
            if tb % (gas * dp_world_size) != 0:
                raise DeepSpeedConfigError(
                    f"train_batch_size ({tb}) not divisible by gas*dp")
            mb = tb // (gas * dp_world_size)
        elif tb is not None:
            gas = 1
            if tb % dp_world_size != 0:
                raise DeepSpeedConfigError(
                    f"train_batch_size ({tb}) not divisible by dp "
                    f"({dp_world_size})")
            mb = tb // dp_world_size
        elif mb is not None:
            gas = gas or 1
            tb = mb * gas * dp_world_size
        else:
            raise DeepSpeedConfigError(
                "At least train_batch_size or train_micro_batch_size_per_gpu "
                "must be set in the config")
        self.train_batch_size = tb
        self.train_micro_batch_size_per_gpu = mb
        self.gradient_accumulation_steps = gas
        return tb, mb, gas
