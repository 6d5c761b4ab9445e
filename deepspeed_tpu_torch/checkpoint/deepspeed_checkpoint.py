"""Checkpoint inspection (the port of
``deepspeed_tpu/checkpoint/deepspeed_checkpoint.py``; reference
``checkpoint/deepspeed_checkpoint.py``): a read-only view of a tag of the
port or of upstream DeepSpeed, or of a universal directory, without an
engine.
"""

import json
import os

import numpy as np

from .constants import UNIVERSAL_META, ZERO_FILE_PREFIX
from .zero_to_fp32 import assemble, read_zero_tag, resolve_tag


class DeepSpeedCheckpoint:
    """Names, shapes, iteration and per-parameter state of a checkpoint."""

    def __init__(self, ckpt_dir, tag=None):
        self.dir = ckpt_dir
        self.tag = resolve_tag(ckpt_dir, tag)
        self.root = os.path.join(ckpt_dir, self.tag) if self.tag else \
            ckpt_dir
        self._universal = os.path.exists(os.path.join(self.root,
                                                      UNIVERSAL_META))
        self._meta = self._state = None
        self._zero = None    # lazy: (shapes, sources), one read serves all
        if self._universal:
            with open(os.path.join(self.root, UNIVERSAL_META)) as f:
                self._meta = json.load(f)
            self._state = self._meta.get("engine_state", {})
        else:
            es = os.path.join(self.root, "engine_state.json")
            if os.path.exists(es):
                with open(es) as f:
                    self._state = json.load(f)

    @property
    def is_universal(self):
        return self._universal

    def get_iteration(self):
        return (self._state or {}).get("global_steps", 0)

    @property
    def zero_stage(self):
        return (self._state or {}).get("zero_stage", 0)

    @property
    def dp_degree(self):
        return (self._state or {}).get("dp_world_size", 1)

    def _tag(self):
        if self._zero is None:
            _, shapes, sources, _ = read_zero_tag(self.root)
            self._zero = shapes, sources
        return self._zero

    def parameter_names(self):
        if self._universal:
            return sorted(self._meta.get("params", {}))
        return sorted(self._tag()[0])

    def parameter_shapes(self):
        if self._universal:
            return {k: tuple(v["shape"])
                    for k, v in self._meta.get("params", {}).items()}
        return dict(self._tag()[0])

    def get_parameter(self, name, key="fp32"):
        """One parameter's ``key`` (fp32, exp_avg or exp_avg_sq) as a numpy
        array."""
        if self._universal:
            path = os.path.join(self.root, ZERO_FILE_PREFIX, name,
                                f"{key}.npy")
            if not os.path.exists(path):
                raise KeyError(f"{name}/{key} not in checkpoint")
            return np.load(path)
        shapes, sources = self._tag()
        if name not in shapes:
            raise KeyError(name)
        if not any(key in flats for _, flats in sources):
            raise KeyError(f"{name}/{key} not in checkpoint")
        return assemble({name: shapes[name]}, sources, key)[name].numpy()

    def show(self):
        names = self.parameter_names()
        print(f"checkpoint {self.root} (universal={self._universal}) "
              f"iteration={self.get_iteration()} params={len(names)}")
        for n in names:
            print(f"  {n}")
