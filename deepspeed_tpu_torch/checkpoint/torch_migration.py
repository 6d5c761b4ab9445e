"""Upstream torch DeepSpeed checkpoints in the port (the port of
``deepspeed_tpu/checkpoint/torch_migration.py``).

The JAX package migrates upstream ZeRO 0-3 tags into the universal layout
before its engine can read them.  The port's own tags are upstream's in
structure, so its reader is upstream's reader: stage ≤ 2 content
(``param_slice_mappings``) and stage-3 content (``fp32_flat_groups``, each
parameter in ceil(numel/dp) slices, the walk of ``torch_migration.py:198
_assemble_stage3``) become fill sources
(``zero_to_fp32.read_zero_tag``), and ``engine.load_checkpoint`` loads an
upstream tag at any world size and stage with no conversion.  An upstream
tag has no ``engine_state.json``: its counters and lr scheduler come from
the model states.
"""

from .ds_to_universal import convert_to_universal


def migrate_torch_checkpoint(checkpoint_dir, output_dir, tag=None):
    """An upstream ZeRO 0-3 tag → the universal layout (the module's torch
    names: an upstream tag records no model the port knows)."""
    return convert_to_universal(checkpoint_dir, output_dir, tag=tag)


def load_torch_deepspeed_checkpoint(engine, checkpoint_dir, tag=None,
                                    **kwargs):
    """Resume ``engine`` from an upstream tag: a native load."""
    return engine.load_checkpoint(checkpoint_dir, tag=tag, **kwargs)
