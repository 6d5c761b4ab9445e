"""HuggingFace checkpoint ingestion (reference
``inference/v2/checkpoint/huggingface_engine.py``).

Reads a *local* HF model directory (no hub downloads) and yields
``(name, CPU tensor)`` pairs from, in preference order:

1. ``model.safetensors.index.json`` → sharded safetensors
2. ``model.safetensors`` (or any ``*.safetensors`` glob)
3. ``pytorch_model.bin[.index.json]`` → ``torch.load(weights_only=True)``

The safetensors format is parsed here, without the ``safetensors``
package: an 8-byte little-endian header length, a JSON header mapping each
name to ``{dtype, shape, data_offsets}``, then the raw bytes.  The file is
memory-mapped (private, copy on write) and each tensor is a
``torch.frombuffer`` view of its bytes (bf16 included), so a loader that
keeps a slice of a tensor (a tensor-parallel rank's) reads only the pages
of that slice.
"""

import glob
import json
import mmap
import os
import struct
from typing import Iterable, Tuple

import torch

from ....utils.logging import logger
from .base_engine import CheckpointEngineBase

_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool, "F8_E4M3": torch.float8_e4m3fn,
    "F8_E5M2": torch.float8_e5m2,
}


def read_safetensors(path) -> Iterable[Tuple[str, torch.Tensor]]:
    """Yield ``(name, tensor)`` from one ``.safetensors`` file: views of
    the file's private mapping (each keeps the mapping alive)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data_start = 8 + n
        size = os.fstat(f.fileno()).st_size
        mm = (mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
              if size > data_start else None)
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has unsupported "
                             f"safetensors dtype {info['dtype']!r}")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        if end == begin:
            yield name, torch.empty(shape, dtype=dtype)
            continue
        if data_start + end > size:
            raise ValueError(f"{path}: truncated data for {name!r}")
        item = torch.empty((), dtype=dtype).element_size()
        yield name, torch.frombuffer(
            mm, dtype=dtype, count=(end - begin) // item,
            offset=data_start + begin).reshape(shape)


class HuggingFaceCheckpointEngine(CheckpointEngineBase):

    def __init__(self, model_name_or_path: str, auth_token: str = None,
                 **hf_kwargs):
        if not os.path.isdir(model_name_or_path):
            raise ValueError(
                f"{model_name_or_path!r} is not a local directory — hub "
                "downloads are not supported; download the checkpoint first")
        self.model_name_or_path = model_name_or_path
        self._config = None

    @property
    def model_config(self) -> dict:
        """Parsed ``config.json``."""
        if self._config is None:
            path = os.path.join(self.model_name_or_path, "config.json")
            with open(path) as f:
                self._config = json.load(f)
        return self._config

    def _checkpoint_files(self):
        root = self.model_name_or_path
        for index_name, kind in (("model.safetensors.index.json", "st"),
                                 ("pytorch_model.bin.index.json", "pt")):
            index = os.path.join(root, index_name)
            if os.path.exists(index):
                with open(index) as f:
                    weight_map = json.load(f)["weight_map"]
                files = sorted({os.path.join(root, v)
                                for v in weight_map.values()})
                return files, kind
        st = sorted(glob.glob(os.path.join(root, "*.safetensors")))
        if st:
            return st, "st"
        pt = sorted(glob.glob(os.path.join(root, "pytorch_model*.bin")))
        if pt:
            return pt, "pt"
        raise FileNotFoundError(
            f"no safetensors or pytorch_model.bin under {root}")

    def parameters(self) -> Iterable[Tuple[str, torch.Tensor]]:
        files, kind = self._checkpoint_files()
        logger.info(f"HF checkpoint: {len(files)} {kind} shard(s) from "
                    f"{self.model_name_or_path}")
        for path in files:
            if kind == "st":
                yield from read_safetensors(path)
            else:
                state = torch.load(path, map_location="cpu",
                                   weights_only=True)
                for name, tensor in state.items():
                    yield name, tensor.detach()
