from .module import LayerSpec, PipelineModule, TiedLayerSpec
from .topology import (PipeDataParallelTopology, PipelineParallelGrid,
                       PipeModelDataParallelTopology, ProcessTopology)
from . import schedule
