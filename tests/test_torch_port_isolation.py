"""The port stands alone: importing ``deepspeed_tpu_torch`` loads no JAX,
no flax and nothing of the JAX package ``deepspeed_tpu`` (beware the
prefix: ``deepspeed_tpu_torch`` starts with ``deepspeed_tpu``), and its
entry points run on the CUDA card unless told otherwise."""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.accelerator import resolve_device
from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                              RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.models import llama

_PKG_DIR = os.path.dirname(deepspeed_tpu_torch.__file__)
_REPO = os.path.dirname(_PKG_DIR)


def _forbidden(name):
    return (name in ("jax", "flax", "deepspeed_tpu")
            or name.startswith(("jax.", "flax.", "deepspeed_tpu.")))


def _all_modules():
    return [m.name for m in pkgutil.walk_packages(
        [_PKG_DIR], prefix="deepspeed_tpu_torch.")]


def test_import_loads_no_jax():
    mods = _all_modules()
    for name in ("ops.kernels.paged_attention", "ops.kernels.flash_attention",
                 "ops.kernels.optimizers", "ops.attention", "ops.adam",
                 "runtime.config", "runtime.engine", "runtime.lr_schedules",
                 "runtime.utils", "runtime.loss_scaler",
                 "runtime.fp16.loss_scaler", "ops.lamb", "ops.lion",
                 "sequence.cross_entropy", "models.llama", "models.gpt2",
                 "models.mixtral", "ops.kernels.grouped_matmul",
                 "ops.kernels.quantizer", "ops.quantizer",
                 "inference.config", "inference.quant_serving",
                 "ops.kernels.flash_bias",
                 "ops.deepspeed4science.evoformer_attn", "ops._use_kernels",
                 "ops.sparse_attention.sparsity_config",
                 "ops.sparse_attention.sparse_self_attention",
                 "ops.kernels.block_sparse_attention", "ops.fp_quantizer",
                 "ops.kernels.fp_quantizer", "compression.quantizers",
                 "linear.config", "linear.quantization",
                 "linear.optimized_linear", "comm", "comm.comm",
                 "comm.backend", "comm.reduce_op", "utils.groups",
                 "utils.comms_logging", "utils.timer", "runtime.zero",
                 "runtime.zero.config", "runtime.zero.partition",
                 "accelerator.abstract_accelerator",
                 "accelerator.cuda_accelerator",
                 "accelerator.cpu_accelerator", "models.bert",
                 "comm.collectives", "comm.collectives.config",
                 "comm.collectives.quantized", "comm.collectives.topology",
                 "comm.collectives.engine", "runtime.zero.zeropp",
                 "runtime.zero.mics", "runtime.zero.overlap",
                 "comm.functional", "sequence", "sequence.layer", "pipe",
                 "runtime.pipe", "runtime.pipe.schedule",
                 "runtime.pipe.topology", "runtime.pipe.module",
                 "runtime.pipe.p2p", "runtime.pipe.engine",
                 "runtime.comm", "runtime.comm.compressed",
                 "runtime.fp16.onebit", "runtime.fp16.onebit.common",
                 "runtime.fp16.onebit.adam", "runtime.fp16.onebit.lamb",
                 "runtime.fp16.onebit.zoadam"):
        assert f"deepspeed_tpu_torch.{name}" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m in ('jax', 'flax', "
            "'deepspeed_tpu') or m.startswith(('jax.', 'flax.', "
            "'deepspeed_tpu.'))]\n"
            "print('BAD', bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=_REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def _sources():
    """Every .py file of the port, chip_smoke.py and zero_multicard.py."""
    paths = [os.path.join(_REPO, "chip_smoke.py"),
             os.path.join(_REPO, "zero_multicard.py")]
    for root, _, files in os.walk(_PKG_DIR):
        paths += [os.path.join(root, fn) for fn in files
                  if fn.endswith(".py")]
    return paths


# the port's copies of the JAX package's host C++ (offload)
HOST_SOURCES = {"cpu_optimizers.cpp": "optimizers", "ds_aio.cpp": "aio",
                "ds_aio_uring.cpp": "aio"}


def test_host_builder_reads_nothing_of_the_jax_package():
    from deepspeed_tpu_torch.ops.op_builder import ALL_OPS, HostOpBuilder
    jax_dir = os.path.join(_REPO, "deepspeed_tpu") + os.sep
    hosts = [c for c in ALL_OPS.values() if issubclass(c, HostOpBuilder)]
    assert {os.path.basename(s) for c in hosts for s in c().sources()} == \
        set(HOST_SOURCES)
    for cls in hosts:
        b = cls()
        for path in [*b.sources(), *b.command("out.so")]:
            assert not os.path.abspath(path).startswith(jax_dir), path
            if path.endswith(".cpp"):
                assert path.startswith(os.path.join(_PKG_DIR, "csrc",
                                                    "host"))


@pytest.mark.parametrize("name", sorted(HOST_SOURCES))
def test_host_sources_equal_the_reference_byte_for_byte(name):
    """A change to the copies is made on purpose, in both places."""
    with open(os.path.join(_PKG_DIR, "csrc", "host", name), "rb") as f:
        mine = f.read()
    with open(os.path.join(_REPO, "deepspeed_tpu", "csrc",
                           HOST_SOURCES[name], name), "rb") as f:
        assert mine == f.read()


def test_source_imports_nothing_of_jax():
    """AST scan of every import statement in the package (comm/ and
    comm/collectives/, runtime/comm/ and runtime/fp16/onebit/,
    runtime/zero/ with zeropp.py and mics.py,
    accelerator/ and models/bert.py included), in chip_smoke.py and in
    zero_multicard.py."""
    bad = []
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [(path, n) for n in names if _forbidden(n)]
    assert not bad


def test_default_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = llama.LlamaModel(llama.llama_tiny(dtype="float32"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngineV2(model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deepspeed_tpu_torch.initialize(
            model=llama.LlamaModel(llama.llama_tiny(dtype="float32")),
            config={"train_batch_size": 1})


def test_default_device_raises_whatever_ds_accelerator_says(monkeypatch):
    """``DS_ACCELERATOR`` picks the accelerator singleton (the comm
    backend's name, events, memory statistics), not where an entry point
    runs: with it set to cpu, ``device=None`` still means the card."""
    from deepspeed_tpu_torch.accelerator import real_accelerator
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("DS_ACCELERATOR", "cpu")
    monkeypatch.setattr(real_accelerator, "_accelerator", None)
    acc = real_accelerator.get_accelerator()
    assert acc.communication_backend_name() == "gloo"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deepspeed_tpu_torch.initialize(
            model=llama.LlamaModel(llama.llama_tiny(dtype="float32")),
            config={"train_batch_size": 1})
    monkeypatch.setenv("DS_ACCELERATOR", "tpu")
    monkeypatch.setattr(real_accelerator, "_accelerator", None)
    with pytest.raises(ValueError, match="DS_ACCELERATOR"):
        real_accelerator.get_accelerator()


def test_config_nested_dicts_auto_and_extra_keys():
    cfg = RaggedInferenceEngineConfig(
        dtype="auto", state_manager={"block_size": 16, "num_blocks": "auto"},
        tensor_parallel={"tp_size": 1}, some_future_key=3)
    assert cfg.dtype == "bfloat16"                  # "auto" → default
    assert cfg.state_manager.block_size == 16
    assert cfg.state_manager.num_blocks is None
    assert cfg.state_manager.max_context == 8192
    assert cfg["decode_burst"] == 16 and cfg.get("missing", 7) == 7
    assert cfg.some_future_key == 3
    assert RaggedInferenceEngineConfig(strict=True, dtype="auto").dtype == \
        "auto"
