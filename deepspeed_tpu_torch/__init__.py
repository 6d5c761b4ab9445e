"""deepspeed_tpu_torch — the PyTorch/CUDA port of deepspeed_tpu for NVIDIA
Hopper (H100).

It sits beside the JAX package, with the same sub-paths, and imports
nothing of it (nor JAX).  Plain tensor code is PyTorch; every Pallas TPU
kernel on a ported path is a kernel written by hand for ``sm_90a`` under
``csrc/``, built with nvcc at first use.  Entry points run on the CUDA card
unless the caller passes ``device="cpu"``.

Ported so far: FastGen-v2 serving of the Llama family and Mixtral
(``inference.v2.build_hf_engine``, with the paged-attention and
grouped-matmul kernels; int8/int4 weights with the blockwise quantizer);
training of Llama, GPT-2 and BERT through :func:`initialize` at ZeRO
stages 0-3 over ``torch.distributed`` (the comm layer, ``comm/``), in bf16,
fp16 (dynamic loss scaling) or fp32 (with the flash-attention, fused-Adam,
LAMB and Lion kernels), with checkpoints in upstream DeepSpeed's per-rank
files that load at any world size and stage and convert to and from the
JAX package's universal layout (``checkpoint/``), and offload: optimizer
state in pinned host memory or on NVMe with the host optimizers, and
ZeRO-Infinity parameter streaming (``runtime/infinity_engine.py``);
pipeline parallelism (``runtime/pipe/``: ``PipelineModule`` and the 1F1B
``PipelineEngine`` on NCCL point-to-point) and Ulysses sequence
parallelism (``sequence/layer.py``, the pp and sp mesh axes);
Evoformer attention (the
bias flash kernels); block-sparse attention (``ops.sparse_attention``, the
block-sparse kernel); FP6/FP12 weight quantization (``ops.fp_quantizer``,
``linear``, the FP grid quantize kernel).  Every Pallas kernel of the JAX
package has its counterpart here.
"""

__version__ = "0.1.0"

from .comm import init_distributed  # noqa: E402  (JAX __init__.py:206)


def initialize(args=None, model=None, optimizer=None, model_parameters=None,
               training_data=None, lr_scheduler=None, distributed_port=29500,
               mesh_param=None, dist_init_required=None, collate_fn=None,
               config=None, mpu=None, config_params=None, device=None,
               tp_rules=None):
    """Build the training engine (reference ``deepspeed/__init__.py:69``;
    the JAX package's ``initialize``).  Returns ``(engine, optimizer,
    training_dataloader, lr_scheduler)``; the dataloader is None.

    ``model``: a ``torch.nn.Module`` whose ``forward`` returns the loss when
    given labels (``models.llama.LlamaModel``, ``models.gpt2.GPT2Model``,
    ``models.bert.BertModel``), or a ``runtime.pipe.PipelineModule``, which
    gives a ``runtime.pipe.engine.PipelineEngine`` (JAX
    ``__init__.py:56-80``; ``offload_param`` is refused there, as in JAX).
    ``optimizer``: None (the config's), or the port's ``FusedAdam``,
    ``FusedLamb``, ``FusedLion`` or ``sgd`` transform.  ``model_parameters``: an
    optional ``{name: tensor}`` of initial (fp32) weights; without it the
    module's own values are used, or, for a module built on the meta
    device, ``engine.initialize_parameters(seed)`` draws them.
    ``device``: None means the CUDA card (raises without one); the CPU runs
    only when named.  The comm world comes up through
    :func:`init_distributed` (NCCL on the card, gloo on the CPU;
    ``distributed_port`` is its default ``MASTER_PORT``) when
    ``dist_init_required=True``, when ``WORLD_SIZE`` (or mpirun's) says
    more than one rank, or when a world on the device's backend is up;
    ``dist_init_required=False`` needs a world already up.  Otherwise the
    engine is one rank on a local group and pins no backend.
    ``mesh_param``: ``(dp, sp)`` as in JAX.  ``mpu`` is accepted and unused,
    as in JAX.  ``collate_fn`` (the dataloader) raises.
    ``zero_optimization.offload_param`` of cpu or nvme builds the
    parameter-streaming ``runtime.infinity_engine.InfinityEngine``.
    ``tp_rules`` (JAX ``__init__.py:41``): the tensor-parallel rule table
    (flax path suffix → ``module_inject.Spec``) at ``mesh.tp`` > 1; None
    takes ``model.tp_sharding_rules`` or derives the rules from the
    model's dataflow (``module_inject/tp_parser.py``)."""
    from .runtime.config import DeepSpeedConfig
    from .runtime.engine import DeepSpeedEngine
    from .runtime.pipe.module import PipelineModule

    if config is None:
        config = config_params
    if config is None and args is not None:
        config = getattr(args, "deepspeed_config", None)
    ds_config = DeepSpeedConfig(config)
    cls = DeepSpeedEngine
    streaming = ds_config.zero_config.offload_param_device in ("cpu", "nvme")
    if isinstance(model, PipelineModule):
        if streaming:
            raise ValueError(
                "offload_param (ZeRO-Infinity param streaming) does not "
                "compose with PipelineModule — the pipeline needs its stage "
                "weights resident")
        from .runtime.pipe.engine import PipelineEngine as cls
    elif streaming:
        # ZeRO-Infinity parameter streaming, at any stage (JAX
        # __init__.py:65-94)
        from .runtime.infinity_engine import InfinityEngine as cls
    if streaming and ds_config.mesh_tp > 1:
        # JAX's InfinityEngine places every fetched block replicated over
        # the whole mesh (infinity_engine.py:_rep_sharding, P()): tp there
        # shards nothing and saves nothing
        raise ValueError("parameter streaming (offload_param) with tensor "
                         "parallelism: the reference replicates the streamed "
                         "blocks over tp (a block lives whole on every "
                         "rank); stream at tp 1, over dp or sp")
    kw = {} if tp_rules is None else dict(tp_rules=tp_rules)
    engine = cls(args=args, model=model, optimizer=optimizer,
                 model_parameters=model_parameters,
                 training_data=training_data, lr_scheduler=lr_scheduler,
                 collate_fn=collate_fn, config=ds_config, mpu=mpu,
                 device=device, mesh_param=mesh_param,
                 dist_init_required=dist_init_required,
                 distributed_port=distributed_port, **kw)
    return (engine, engine.optimizer, engine.training_dataloader,
            engine.lr_scheduler)


def __getattr__(name):
    # ``deepspeed_tpu_torch.checkpointing``: the activation-checkpointing
    # module, as reference ``deepspeed.checkpointing`` (JAX
    # __init__.py:212-215); imported on first use
    if name == "checkpointing":
        from .runtime.activation_checkpointing import checkpointing
        return checkpointing
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
