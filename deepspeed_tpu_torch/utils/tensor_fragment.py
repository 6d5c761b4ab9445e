"""``fragment_address`` under upstream torch DeepSpeed's import path (the
part of ``deepspeed_tpu/utils/tensor_fragment.py`` and of the unpickling
shim of ``deepspeed_tpu/checkpoint/torch_migration.py:56`` that the port's
checkpoints need).

A ZeRO optim file maps each parameter to its fragment of the rank's flat
partition with ``deepspeed.utils.tensor_fragment.fragment_address(numel,
start)``.  The port pickles its own namedtuple under that name, so its files
are upstream's in structure: :func:`pickled_as_upstream` registers the
module in ``sys.modules`` while a file is written (scoped: a lingering fake
``deepspeed`` breaks later ``importlib.util.find_spec("deepspeed")``
probes).  Reading maps the name back without touching ``sys.modules``
(:func:`load_file`, from the standalone recovery script).
"""

import contextlib
import sys
import threading
import types

from ..checkpoint.zero_to_fp32 import (UPSTREAM_FRAGMENT, fragment_address,
                                       load_file)

__all__ = ["fragment_address", "load_file", "pickled_as_upstream"]

_LOCK = threading.Lock()
_USERS = [0]
_NAMES = ("deepspeed", "deepspeed.utils", UPSTREAM_FRAGMENT[0])


@contextlib.contextmanager
def pickled_as_upstream():
    """While active, ``fragment_address`` pickles as upstream's class (the
    async writer's thread and the caller may nest it)."""
    with _LOCK:
        if _USERS[0] == 0:
            if any(n in sys.modules for n in _NAMES):
                raise RuntimeError("a 'deepspeed' package is imported: the "
                                   "port cannot pickle under its name")
            for name in _NAMES:
                sys.modules[name] = types.ModuleType(name)
            sys.modules[UPSTREAM_FRAGMENT[0]].fragment_address = \
                fragment_address
        _USERS[0] += 1
    try:
        yield
    finally:
        with _LOCK:
            _USERS[0] -= 1
            if _USERS[0] == 0:
                for name in _NAMES:
                    sys.modules.pop(name, None)
