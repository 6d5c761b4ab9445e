"""Engine factory (reference ``inference/v2/engine_factory.py``:
``build_hf_engine``, ``build_engine_from_ds_checkpoint``).

``build_hf_engine(path)`` turns a local HF checkpoint directory into a
serving-ready :class:`InferenceEngineV2` on the CUDA card — config.json →
model config, safetensors or ``pytorch_model.bin`` → weights, ragged step
selected by architecture.  ``device="cpu"`` serves on the CPU instead.
"""

from typing import Optional, Union

from ...accelerator import resolve_device
from .checkpoint import CheckpointEngineBase, HuggingFaceCheckpointEngine
from .config_v2 import RaggedInferenceEngineConfig
from .engine_v2 import InferenceEngineV2
from .model_implementations import build_model_and_params


def build_hf_engine(path: str,
                    engine_config: Optional[Union[
                        dict, RaggedInferenceEngineConfig]] = None,
                    debug_level: int = 0, device=None,
                    **kwargs) -> InferenceEngineV2:
    """Serve a HuggingFace checkpoint directory (config.json + safetensors
    or .bin)."""
    if engine_config is None:
        engine_config = RaggedInferenceEngineConfig(**kwargs)
    elif isinstance(engine_config, dict):
        engine_config = RaggedInferenceEngineConfig(**{**engine_config,
                                                       **kwargs})
    device = resolve_device(device)
    checkpoint = HuggingFaceCheckpointEngine(path)
    model, params = build_model_and_params(
        checkpoint, dtype=engine_config.dtype, device=device,
        tp_size=int(engine_config.tensor_parallel.tp_size or 1))
    return InferenceEngineV2(model, params=params, config=engine_config,
                             device=device)


class _ConfiguredCheckpoint(CheckpointEngineBase):
    """Pairs any checkpoint engine with an explicit model config."""

    def __init__(self, inner, model_config):
        self._inner = inner
        self.model_config = model_config

    def parameters(self):
        return self._inner.parameters()


def build_engine_from_checkpoint(checkpoint: CheckpointEngineBase,
                                 model_config: dict,
                                 engine_config: Optional[Union[
                                     dict, RaggedInferenceEngineConfig]] = None,
                                 device=None) -> InferenceEngineV2:
    """Build from any checkpoint engine + an HF-style config dict."""
    if engine_config is None:
        engine_config = RaggedInferenceEngineConfig()
    elif isinstance(engine_config, dict):
        engine_config = RaggedInferenceEngineConfig(**engine_config)
    device = resolve_device(device)
    model, params = build_model_and_params(
        _ConfiguredCheckpoint(checkpoint, model_config),
        dtype=engine_config.dtype, device=device,
        tp_size=int(engine_config.tensor_parallel.tp_size or 1))
    return InferenceEngineV2(model, params=params, config=engine_config,
                             device=device)
