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
training of Llama and GPT-2 through :func:`initialize` at ZeRO stage 0, in
bf16, fp16 (dynamic loss scaling) or fp32 (with the flash-attention,
fused-Adam, LAMB and Lion kernels); Evoformer attention (the bias flash
kernels); block-sparse attention (``ops.sparse_attention``, the
block-sparse kernel); FP6/FP12 weight quantization (``ops.fp_quantizer``,
``linear``, the FP grid quantize kernel).  Every Pallas kernel of the JAX
package has its counterpart here.
"""

__version__ = "0.1.0"


def initialize(args=None, model=None, optimizer=None, model_parameters=None,
               training_data=None, lr_scheduler=None, distributed_port=29500,
               mesh_param=None, dist_init_required=None, collate_fn=None,
               config=None, mpu=None, config_params=None, device=None):
    """Build the training engine (reference ``deepspeed/__init__.py:69``;
    the JAX package's ``initialize``).  Returns ``(engine, optimizer,
    training_dataloader, lr_scheduler)``; the dataloader is None.

    ``model``: a ``torch.nn.Module`` whose ``forward`` returns the loss when
    given labels (``models.llama.LlamaModel``, ``models.gpt2.GPT2Model``).
    ``optimizer``: None (the config's), or the port's ``FusedAdam``,
    ``FusedLamb``, ``FusedLion`` or ``sgd`` transform.  ``model_parameters``: an
    optional ``{name: tensor}`` of initial (fp32) weights; without it the
    module's own values are used, or, for a module built on the meta
    device, ``engine.initialize_parameters(seed)`` draws them.
    ``device``: None means the CUDA card (raises without one); the CPU runs
    only when named.  ``mesh_param``, ``dist_init_required=True`` and a
    ``distributed_port`` other than the default concern the distributed
    layer, and ``collate_fn`` the dataloader, which this port does not
    have yet: they raise."""
    from .runtime.config import DeepSpeedConfig
    from .runtime.engine import DeepSpeedEngine
    from .utils.not_ported import not_ported

    if mesh_param is not None or dist_init_required or \
            distributed_port != 29500:
        raise not_ported("initialize(mesh_param=..., dist_init_required="
                         "True, distributed_port=...)", 2)
    if config is None:
        config = config_params
    if config is None and args is not None:
        config = getattr(args, "deepspeed_config", None)
    engine = DeepSpeedEngine(args=args, model=model, optimizer=optimizer,
                             model_parameters=model_parameters,
                             training_data=training_data,
                             lr_scheduler=lr_scheduler,
                             collate_fn=collate_fn,
                             config=DeepSpeedConfig(config), mpu=mpu,
                             device=device)
    return (engine, engine.optimizer, engine.training_dataloader,
            engine.lr_scheduler)
