"""Back-compat import path: reference tutorials spell
``from deepspeed.pipe import PipelineModule, LayerSpec``
(``deepspeed/pipe/__init__.py`` re-exports from ``runtime.pipe``)."""

from .runtime.pipe import (LayerSpec, PipelineModule,  # noqa: F401
                           TiedLayerSpec)
