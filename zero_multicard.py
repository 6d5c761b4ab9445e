#!/usr/bin/env python3
"""ZeRO stages 0-3 across the cards of one host, one process a card.

    python3 zero_multicard.py [--model gpt2|llama|llama7b] [--world N]
                              [--json PATH] [--device cpu] [--checkpoint]
    python3 zero_multicard.py --offload [--world N] [--json PATH]
                              [--device cpu]
    python3 zero_multicard.py --zeropp [--world N] [--json PATH]
                              [--device cpu]
    python3 zero_multicard.py --pipe [--world N] [--json PATH]
                              [--device cpu]
    python3 zero_multicard.py --onebit [--world N] [--json PATH]
                              [--device cpu]
    python3 zero_multicard.py --moe [--world 4] [--json PATH]
                              [--device cpu]
    python3 zero_multicard.py --tp [--world 4] [--json PATH]
                              [--device cpu]
    python3 zero_multicard.py --ring [--world 4] [--steps N] [--json PATH]
                              [--device cpu]
    python3 zero_multicard.py --domino|--tp-compose [--world 4] [--steps N]
                              [--json PATH] [--device cpu]

BASELINE config 2 (``--model gpt2``: GPT-2 350M, fp16 from a scale of
2^16, remat, ``fusedadam``, 8 rows of 1024 tokens a rank) or config 3
(``--model llama``: the Llama-2-7B-width model cut to 8 layers as
``chip_smoke.py`` stage 8 cuts it, bf16, accumulation 2, 4 rows of 2048 a
rank a micro-step), random weights from the seed, through
``deepspeed_tpu_torch.initialize()`` on an NCCL world of ``--world``
ranks (default: every card).  Each rank feeds its rows of one global
batch (``engine.shard_batch``), and every stage runs 1 warm-up and 3
timed steps from the same weights and data; ZeRO 3 with ``overlap_comm``
and the gather prefetch armed at the reference's default bucket (5e7
elements).  ``--model llama7b`` is full-depth Llama-2-7B (32 layers,
hidden 4096, 32 heads, FFN 11008, vocab 32000), bf16, remat
``nothing_saveable``, 4 rows of 2048 a rank, ``fusedadam``, at ZeRO 3
only.  Rank 0 prints, a stage: the losses, step ms, tokens/s over the
world, MFU (6N + 12·L·S·D a token over 989 TFLOP/s bf16, or fp16), each
rank's peak memory and the collectives a step (comms logger); then the
largest loss difference from ZeRO 0. It fails when a loss is not finite,
when the ranks disagree on a loss, when a stage leaves ZeRO 0's losses by
more than 2^-7 relative (bf16/fp16 training: the reduce-scatter and the
all-reduce sum the ranks' gradients in other orders), or when a stage's
peak memory is above the stage before it.  ``--device cpu`` runs gloo
processes on the CPU at the models' tiny sizes (a rehearsal).

``--checkpoint`` (``--model llama`` or ``llama7b``, ZeRO 3) checks save
and resume across the cards instead: 2 steps, ``save_checkpoint`` into a
temporary directory on local disk (removed at the end), 2 more steps; a
fresh engine loads the tag and takes the same 2 steps, which must be
bit-equal (losses, and the master just after the load and after the
steps).  With ``--model llama`` a world of half the ranks then loads the
same tag, and its master must hash as the saved one did.  Rank 0 prints
the bytes each rank wrote, the save's and the load's seconds and the free
disk before the save; a depth the disk cannot hold is cut, widths kept,
and the cut printed.

``--offload`` runs the runnable half of BASELINE config 4 instead:
Llama-2-13B at full size (40 layers, hidden 5120, 40 heads, FFN 13824,
vocab 32000), ZeRO 3 with ``overlap_comm`` and ``offload_optimizer:
cpu`` (each rank's fp32 master and moments in pinned host memory, which
B3 updates in place), ``fusedlamb``, bf16, remat, 4 rows of 2048 a rank:
1 warm-up and ``--steps`` timed steps.  Each rank pins 12 bytes an
element of its shard (3.25 G elements at world 4), in blocks the pinned
allocator rounds up to a power of two; where 0.7 × ``MemAvailable``
cannot hold that, the depth is cut, widths kept, and the cut printed.
Rank 0 prints each rank's peak memory, step ms, tokens/s and MFU, then
the same config at 2 layers with and without offload, 2 steps each,
whose losses must agree within 2^-7 relative.  (Config 4's param offload
with LAMB is refused by the JAX package and the port alike: the host has
no LAMB kernel.)  Then its param-offload half with Adam: Llama-2-13B
streamed (``offload_param`` and ``offload_optimizer`` cpu, ZeRO-Infinity;
the host store sharded over the ranks, each rank's host Adam on its
slice, on cores / ranks threads), at the depth whose store fits 0.7 ×
``MemAvailable`` over the world, 1 warm-up and ``--steps`` timed steps:
step ms, tokens/s, MFU, the host sweep's share of the steps, each rank's
host RSS, store bytes and pinned bytes, peak HBM; then 2 layers streamed
against ZeRO 3 with its state pinned (``fusedadam``) from the streamed
engine's weights, 2 steps each, within 2^-7 relative.

``--zeropp`` runs ZeRO++ and MiCS on ``--model llama7b``'s setting
(full-depth Llama-2-7B, ZeRO 3 with ``overlap_comm`` and the prefetch,
bf16, remat, ``fusedadam``, 4 rows of 2048 a rank), 1 warm-up and
``--steps`` timed steps a configuration, in one world: plain ZeRO 3,
qwZ + qgZ on the int8 wire (``zero_quantized_weights``/``gradients``),
and hierarchical qgZ (``comm_optimizations`` with ``intra_node_size: 2``:
an fp reduce-scatter over pairs of cards, the int8 all-to-all across the
pairs) at full depth; then at stage 25's 8-layer cut (widths kept, to fit
the call's time; the printout says so) plain ZeRO 3 again, hpZ
(``zero_hpz_partition_size: 2``), MiCS (``mics_shard_size: 2``) and qwZ on
the fp6 wire.  Rank 0 prints, a configuration: step ms, tokens/s, MFU,
each rank's peak HBM, the wire bytes a step by op and variant (comms
logger), the collectives engine's picks and the launches of B5's quantize
and dequantize and of B6.  It fails when a loss is not finite or the
ranks disagree, when hpZ is not plain ZeRO 3 bit for bit (losses and
master), MiCS not within 2e-4 relative, or a quantized run's final loss
not within 1e-2 relative of its plain run's.  Then hpZ and MiCS (zp 2)
at 4 layers, widths kept: 2 steps, ``save_checkpoint`` into a temporary
directory on local disk, 2 more steps; a fresh engine of the same config
and one of plain ZeRO 3 load the tag and take the same 2 steps (the same
config bit-equal, losses and the gathered master's digest; plain ZeRO 3
from a master bit-equal to the saved one, its losses bit-equal after hpZ
and within 2e-4 after MiCS); and the first 2 steps with the optimizer
state pinned on the host, bit-equal to the run without.

``--pipe`` runs BASELINE config 5's shape (GPT-3 13B, ``PipelineEngine``
+ ZeRO 1 + Ulysses) as far as the world allows:
``models/gpt2.pipeline_module(gpt3_13b())`` (40 layers, d_model 5120, 40
heads of 128, vocabulary 50257, S 2048, the embedding tied to the head,
remat a block), bf16, ``fusedadam``, ZeRO 1, random weights from the seed
(each layer from its own seed, so every split starts equal), one global
batch of M microbatches, labels the next tokens.  (a) pp 4 × sp 1 at full
depth, M 8; (b) pp 2 × sp 2 (the Ulysses all-to-all over NCCL) at the
depth its ZeRO-1 state and activations fit (12 bytes a parameter: bf16
parameters, the fp32 accumulator and a half of the fp32 master and
moments; each depth cut is printed); (c) at 4 blocks, full width, 4
microbatches of 4 rows: pp 2, pp 4, sp 2, sp 4 and pp 2 × sp 2 against
the base engine on the same module (``to_module()``) at dp = world, each
step's loss within 2^-7 of it.  1 warm-up and ``--steps`` timed steps a
run.  Rank 0 prints, a run: step ms, tokens/s, MFU (6N + 12·L·S·D a token
over 989 TFLOP/s a card), each rank's peak, the point-to-point MB each
rank sent a step, the all-to-all MB and ms a step (comms logger), and each
rank's idle share of a step (1 − its forward and backward time, CUDA
events, over the step) beside the 1F1B bubble (pp − 1)/(M + pp − 1).  It
fails when a loss is not finite, the ranks disagree, or a parity run
leaves the base engine's losses.  pp 4 × sp 2, the config's own shape,
needs eight cards.

Under ZeRO 3 (``--pipe``): (d) pp 2 × dp 2 at full depth if its
ZeRO-3 state fits (18 bytes a parameter over the data world, a gathered
block and the outer unit with their fp32 gradient scratch), M 8 of 2
rows; (e) pp 2 × sp 2 as deep as that fits; at 4 blocks ``pp2_dp2_z3``
and ``pp2_dp2_z2_overlap`` (ZeRO 2 with ``overlap_comm``) each against
the base engine at the same ZeRO; and a checkpoint leg: ``pp2_dp2_z3``
saves a tag after its steps and runs 2 more, and fresh engines at pp 4
and at pp 1 × dp 4 load it and run the same 2, each step's loss within
2^-7 of the saver's, the save and load seconds printed.

``--onebit`` runs BASELINE config 2's model (GPT-2 350M, fp16 from a scale
of 2^16, 8 rows of 1024 a rank) at ZeRO 0 with ``onebitadam`` (lr 1e-4,
``freeze_step`` 10) and with ``fusedadam``, 30 steps each from the same
weights and batches: step ms in the warmup and in the compressed phase,
the message bytes a step by op (comms logger) and what a ring sends a rank
(the 1-bit exchange's formula against the fp32 all-reduce's), and the
final-loss gap.  It fails when a loss is not finite or the ranks disagree.

``--moe`` (four ranks) runs what exists only across cards for MoE
training.  (i) The MoE layer in the MoE tests' model
(``tests/unit/moe/test_moe.py:53``: in_proj, MoE, out_proj) at hidden
4096, 8 ``ExpertFFN`` experts of 4 × 4096, top-2, capacity factor 1.25,
bf16, ZeRO 2, ``fusedadam``, 8192 tokens a rank of one global batch, 1
warm-up and ``--steps`` timed steps: dp 4 × ep 1, ep 4, dp 2 × ep 2, and
ep 4 with the int8 ``quantized_dispatch``; rank 0 prints each run's
losses and their largest relative difference from dp 4 × ep 1 (gate 2^-7;
1e-2 for the int8 run, ``tools/moe_smoke.py``'s), step ms, the exchange's
bytes on the wire a forward and its ms timed alone, and each rank's peak.
The 2-hop int8 run (ep 4, ``intra_node_size`` 2) is also held within
1e-2 of the 1-hop int8 run.  (ii) Mixtral-8x7B width (hidden 4096, FFN
14336, 32/8 heads, 8 experts, top-2, vocab 32000), ZeRO 3 with
``overlap_comm``, bf16, remat, the fused chunked head + loss,
``fusedadam``, one global batch of 16 rows of 2048: dp 4 and ep 4 at 6 of
32 layers (plain ZeRO 3 at dp 4 fits no more), then ep 4, tp 4 and
tp 2 × ep 2 at 8, and ep 4 at 8 again with the batch's rows rotated over
the data ranks (the same function, its sums in another order: ep 4's own
bf16 spread, the witness beside the split legs' gaps).  Each: step ms,
tokens/s, MFU on the active parameters (6·N_active + 12·L·S·D a token,
N_active = N − L·(E − k)·3·D·I), each rank's peak, the exchange's bytes
and ms a layer's forward, the rows routed to each rank at step 1, whether
each tp group routed alike, and B7's launches by route.  Legs of equal
depth must agree within 2^-7 of the losses' scale.  It fails when a loss
is not finite, the ranks disagree, a tp group routes apart, or a run
leaves its gate.

``--tp`` (four ranks) runs tensor parallelism, which exists only across
cards: NCCL takes no two ranks on one GPU.  Random bf16 weights from
``--seed`` are made on the card leaf by leaf (leaf i from its own
generator; the whole leaf is drawn and this rank's slice kept), so every
tp degree holds the same weights.  Serving, through
``build_engine_from_checkpoint`` with ``tensor_parallel.tp_size``, the
requests of ``chip_smoke.py`` stage 4 (8 prompts of 128-2048 tokens, 64
greedy tokens each): (a) Llama-2-7B at full depth at tp 4 against tp 1
(every rank serving alone); (b) Mistral-7B width (32 layers, GQA 32/8:
2 kv heads a rank) at tp 4 against tp 1; (c) Mixtral-8x7B at full depth
(32 layers, 46.7 G parameters, 93.4 GB: more than one card holds) at tp
4, 4 of the prompts, and its parity at 8 layers against tp 1.  The
kernels are built first, on rank 0.  Each parity run is made twice more
in fp32 from the same (bf16-rounded) weights.  Rank 0 prints, a run: the
largest difference of the first step's (prefill) logits from tp 1's,
the greedy tokens that match tp 1's before the first that differs (bf16
all-reduce sums in another order than one card's products, which can
move a near tie), the same in fp32, how far bf16's logits sit from
fp32's at tp 1 and at tp 4, prefill and decode tokens/s, TTFT, each
rank's peak memory and B4's and B7's launches a rank.  It fails when
logits are not finite, the ranks disagree on a token, the first tokens
differ, the bf16 prefill logits leave tp 1's by more than 2^-3 (bf16
logits of about unit size, summed over 4096 products in another order),
or the fp32 ones by more than 1e-3.  Training,
Llama-2-7B width, bf16, ``fusedadam``, remat, 4 rows of 2048 a data rank:
(d) at full depth tp 2 × dp 2 at ZeRO 1, tp 2 × dp 2 at ZeRO 3 and tp 4
at ZeRO 0, step ms, tokens/s, MFU (6N + 12·L·S·D a token over 989
TFLOP/s a card), each rank's peak and B1's and B2's launches a rank a
step; and at 8 layers on one global batch
of 16 rows tp 2 × dp 2 and tp 4 against tp 1 × dp 4, each step's loss
within 2^-7; (e) at 4 layers a tp 2 × dp 2 ZeRO-3 tag, resumed at tp 4
(ZeRO 1) and at tp 1 × dp 4 (ZeRO 0): the loaded master's digest equal to
the saved one, the next step's loss within 2^-7 of the saver's.

``--ring`` trains Llama-2-7B (32 layers, random weights from the seed) at
sp = the world (dp 1), ZeRO 3 over the dp × sp data group, remat, bf16,
``fusedadam``, one row of 32768 tokens (8192 a rank at world 4): with
``sp_backend="ring"`` and with ``"ulysses"`` on the same weights and
batch, 1 warm-up and ``--steps`` timed steps each, the ring's losses
within 2^-7 of Ulysses'; then the ring at 131072 tokens (32768 a rank),
8 layers, ``loss_chunk_vocab`` 4096.  Rank 0 prints each run's losses,
step ms, tokens/s, MFU (6N + 12·L·S·D a token at the run's S, over 989
TFLOP/s a card), B1's and B2's launches a rank a step and each rank's
peak.  ``--device cpu`` rehearses it at ``llama_tiny`` on gloo ranks
(64 and 256 tokens).

``--domino`` trains Llama-2-7B width (32 layers, bf16, remat,
``fusedadam``, 4 rows of 2048) at tp = the world, ZeRO 1, plain and with
``domino`` (two µ-streams: each block's row-parallel reduces started
async under the other stream's products), 1 warm-up and ``--steps`` timed
steps each from the same weights and batch: losses (within 2^-7 of the
plain run's scale), step ms, tokens/s, MFU, each rank's peak, B1's and
B2's launches a rank a step, and ``runtime/domino``'s overlap report of
one forward of each form (collectives, async pairs, pairs with compute
called inside their window, NCCL kernels running beside another kernel).

``--tp-compose`` trains Llama-2-7B width (32 layers, ZeRO 3, remat,
Ulysses) on one row of 8192 tokens at tp 2 × sp 2, tp 4 and sp 4 from
the same weights: each run's losses within 2^-7 of the others' scale,
step ms, MFU, peak and launches; then GPT-2 350M (fp16 from 2^16,
``fusedlamb``, ``gpt2.tp_rules``, its 50257-row vocabulary padded to a
multiple of tp) at tp = the world against tp 1 × dp = the world on one
batch of 8 rows of 1024: losses within 2^-7, the same skipped steps, step
ms and peak; the tp tag's ``wte`` at 50257 rows, loaded at tp 1 with the
master digest equal; then GPT-3 13B width (8 layers, bf16, ZeRO 1,
remat) through the ``PipelineEngine`` at pp 2 × tp 2 against pp 1 × tp 2
× dp 2 (``gpt2.pipeline_tp_rules``, 4 microbatches of 2 × 2048), and
Llama-2-13B width (8 layers) streamed on 4 rows of 8192 tokens at sp =
the world against sp 1 × dp = the world, each pair's losses within 2^-7
of their scale, step ms (the streamed runs' host sweep share) and peak.
Both rehearse on gloo ranks with ``--device cpu``.
"""

import argparse
import gc
import json
import math
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
STAGES = {"gpt2": (0, 1, 2, 3), "llama": (0, 1, 2, 3), "llama7b": (3, )}
LAMB = {"type": "fusedlamb", "params": {"lr": 1e-4, "weight_decay": 0.01}}
ADAM = {"type": "fusedadam", "params": {"lr": 1e-4}}
STREAMED = {"stage": 3, "offload_param": {"device": "cpu"},
            "offload_optimizer": {"device": "cpu"}}
ZERO3 = {"stage": 3, "overlap_comm": True,
         "stage3_prefetch_bucket_size": int(5e7)}
PEAK_FLOPS = 989e12        # H100 SXM dense bf16 (and fp16) tensor rate


def _config(model, stage):
    common = {"optimizer": {"type": "fusedadam", "params": {"lr": 1e-4}},
              "zero_optimization": ZERO3 if stage == 3 else {"stage": stage},
              "comms_logger": {"enabled": True}}
    if model == "llama7b":
        return dict(common, train_micro_batch_size_per_gpu=4,
                    gradient_accumulation_steps=1, bf16={"enabled": True})
    if model == "gpt2":
        return dict(common, train_micro_batch_size_per_gpu=8,
                    gradient_accumulation_steps=1,
                    fp16={"enabled": True, "initial_scale_power": 16})
    return dict(common, train_micro_batch_size_per_gpu=4,
                gradient_accumulation_steps=2, bf16={"enabled": True})


def _model(model, tiny):
    from deepspeed_tpu_torch.models import gpt2, llama
    if model == "gpt2":
        cfg = (gpt2.gpt2_tiny(dtype="float16", max_position_embeddings=1024)
               if tiny else gpt2.gpt2_350m(dtype="float16"))
        return gpt2.GPT2Model(cfg, device="meta"), cfg, 1024
    remat = dict(remat=model == "llama7b", remat_policy="nothing_saveable")
    if tiny:
        cfg = llama.llama_tiny(dtype="bfloat16", max_position_embeddings=2048,
                               **remat)
    else:
        cfg = llama.llama_7b(head_dtype="bfloat16", **remat,
                             **({} if model == "llama7b" else
                                {"num_hidden_layers": 8}))
    return llama.LlamaModel(cfg, device="meta"), cfg, 2048


def _flops_per_token(model, cfg, S):
    from deepspeed_tpu_torch.models import gpt2, llama
    n = (gpt2 if model == "gpt2" else llama).param_count(cfg)
    return 6 * n + 12 * cfg.num_hidden_layers * S * cfg.hidden_size


def run_rank(args):
    import numpy as np
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm
    torch.set_num_threads(1)
    cpu = args.device == "cpu"
    device = "cpu" if cpu else None
    rows = []
    for stage in STAGES[args.model]:
        model, cfg, S = _model(args.model, cpu)
        engine = deepspeed_tpu_torch.initialize(
            model=model, config=_config(args.model, stage),
            device=device)[0]
        engine.initialize_parameters(args.seed)
        world, rank = engine.dp_world_size, engine.dp_rank
        B = engine.train_micro_batch_size_per_gpu() * world
        gbatch = np.random.default_rng(args.seed + 1).integers(
            0, cfg.vocab_size, size=(B, S))
        (ids, ) = engine.shard_batch(gbatch)
        gas = engine.gradient_accumulation_steps()
        sync = (lambda: None) if cpu else torch.cuda.synchronize
        losses, times = [], []
        for i in range(1 + args.steps):
            if i == 1:
                sync()
                comm.comms_logger.reset()
                if not cpu:
                    torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            for _ in range(gas):
                loss = engine(ids, ids)
                engine.backward(loss)
                engine.step()
                losses.append(loss.item())
            sync()
            if i >= 1:
                times.append(time.perf_counter() - t)
        peak = 0 if cpu else torch.cuda.max_memory_allocated()
        calls = comm.comms_logger.counts()
        mine = torch.tensor([float(peak)] + losses,
                            device="cpu" if cpu else "cuda")
        every = comm.all_gather(mine, tiled=False).cpu()
        step_s = sum(times) / len(times)
        rows.append(dict(
            stage=stage, world=world, losses=losses,
            rank_losses_equal=bool((every[:, 1:] == every[0, 1:]).all()),
            step_ms=[t * 1e3 for t in times], step_ms_mean=step_s * 1e3,
            tokens_per_s=B * S * gas / step_s,
            mfu=B * S * gas / step_s * _flops_per_token(args.model, cfg, S)
            / (PEAK_FLOPS * world),
            peak_bytes_by_rank=[int(x) for x in every[:, 0].tolist()],
            calls_per_step={k: v / args.steps for k, v in calls.items()},
            shard_numel=engine.zero_plan.shard_numel,
            padded_numel=engine.zero_plan.padded_numel,
            skipped=engine.skipped_steps))
        del engine, model, loss
        gc.collect()
        if not cpu:
            torch.cuda.empty_cache()
    if rank == 0:
        with open(args.out_rank0, "w") as f:
            json.dump(rows, f)
    comm.destroy_process_group()


# (name, depth: full or the 8-layer cut, extra zero_optimization keys,
#  comm_optimizations block)
ZEROPP_RUNS = (
    ("zero3", None, {}, None),
    ("qwz_qgz_int8", None, {"zero_quantized_weights": True,
                            "zero_quantized_gradients": True}, None),
    ("hier_qgz_int8", None, {}, {"enabled": True,
                                 "quantized_gradients": True,
                                 "intra_node_size": 2}),
    ("zero3_8l", 8, {}, None),
    ("hpz2_8l", 8, {"zero_hpz_partition_size": 2}, None),
    ("mics2_8l", 8, {"mics_shard_size": 2}, None),
    ("qwz_fp6_8l", 8, {"zero_quantized_weights": True,
                       "zero_quantized_weights_format": "fp6"}, None),
)


# --zeropp's checkpoint and offload legs: cut to 4 layers, widths kept,
# for the disk and the call's time
ZEROPP_CKPT_LAYERS = 4


def _zp_counters():
    from deepspeed_tpu_torch.ops.kernels import fp_quantizer, quantizer
    return {"quantize_blockwise": quantizer.quantize_blockwise,
            "dequantize_blockwise": quantizer.dequantize_blockwise,
            "quantize_fp_packed": fp_quantizer.quantize_fp_packed}


def _shard_digest(torch, flat):
    """A digest of this rank's fp32 master shard, on the card: the sum,
    modulo 2^62, of each element's bits times a weight that follows its
    place (a changed or moved element changes it)."""
    v = flat.reshape(-1).view(torch.int32)
    acc = 0
    for i in range(0, v.numel(), 1 << 26):
        c = v[i:i + (1 << 26)].to(torch.int64)
        w = torch.arange(i, i + c.numel(), device=c.device,
                         dtype=torch.int64) % 65521 + 1
        acc = (acc + int((c * w).sum().item())) % (1 << 62)
    return acc


def run_zeropp_rank(args):
    """``--zeropp``: each configuration of :data:`ZEROPP_RUNS` in turn
    (module docstring)."""
    import dataclasses
    import numpy as np
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models import llama
    cpu = args.device == "cpu"
    sync = (lambda: None) if cpu else torch.cuda.synchronize
    rows = []
    for name, layers, zero, co in ZEROPP_RUNS:
        model, cfg, S = _model("llama7b", cpu)
        if layers is not None and not cpu:
            cfg = dataclasses.replace(cfg, num_hidden_layers=layers)
        config = _config("llama7b", 3)
        config["zero_optimization"] = dict(ZERO3, **zero)
        if co is not None:
            config["comm_optimizations"] = co
        engine = deepspeed_tpu_torch.initialize(
            model=llama.LlamaModel(cfg, device="meta"), config=config,
            device="cpu" if cpu else None)[0]
        engine.initialize_parameters(args.seed)
        world = engine.dp_world_size
        B = engine.train_micro_batch_size_per_gpu() * world
        gbatch = np.random.default_rng(args.seed + 1).integers(
            0, cfg.vocab_size, size=(B, S))
        (ids, ) = engine.shard_batch(gbatch)
        counters = _zp_counters()
        losses, times = [], []
        for i in range(1 + args.steps):
            if i == 1:
                sync()
                comm.comms_logger.reset()
                for fn in counters.values():
                    fn.launches = 0
                if not cpu:
                    torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            loss = engine(ids, ids)
            engine.backward(loss)
            engine.step()
            losses.append(loss.item())
            sync()
            if i >= 1:
                times.append(time.perf_counter() - t)
        peak = 0 if cpu else torch.cuda.max_memory_allocated()
        summary = comm.comms_logger.get_summary_dict()["ops"]
        launches = {k: fn.launches for k, fn in counters.items()}
        mine = torch.tensor([float(peak)] + losses,
                            device="cpu" if cpu else "cuda")
        every = comm.all_gather(mine, tiled=False).cpu()
        # each rank's master shard (hpZ keeps ZeRO 3's world slices)
        digests = comm.all_gather(torch.tensor(
            [_shard_digest(torch, engine._target())], dtype=torch.int64,
            device="cpu" if cpu else "cuda"), tiled=False).cpu()
        step_s = sum(times) / len(times)
        rows.append(dict(
            name=name, layers=cfg.num_hidden_layers, world=world,
            losses=losses, variant=engine._micro_variant(),
            rank_losses_equal=bool((every[:, 1:] == every[0, 1:]).all()),
            step_ms=[t * 1e3 for t in times], step_ms_mean=step_s * 1e3,
            tokens_per_s=B * S / step_s,
            mfu=B * S / step_s * _flops_per_token("llama7b", cfg, S)
            / (PEAK_FLOPS * world),
            peak_bytes_by_rank=[int(x) for x in every[:, 0].tolist()],
            wire_bytes_per_step={k: v["total_wire_bytes"] / args.steps
                                 for k, v in summary.items()},
            msg_bytes_per_step={k: v["total_msg_bytes"] / args.steps
                                for k, v in summary.items()},
            calls_per_step={k: v["count"] / args.steps
                            for k, v in summary.items()},
            dispatch=engine.zeropp_dispatch_counts(),
            launches_per_step={k: v / args.steps
                               for k, v in launches.items()},
            param_numel=int(engine.params.numel()),
            master_digests=[int(x) for x in digests.reshape(-1)]))
        del engine, model, loss
        gc.collect()
        if not cpu:
            torch.cuda.empty_cache()
    legs = _zeropp_ckpt_legs(args, cpu, sync)
    if comm.get_rank() == 0:
        with open(args.out_rank0, "w") as f:
            json.dump(dict(rows=rows, legs=legs), f)
    comm.destroy_process_group()


def _zeropp_ckpt_legs(args, cpu, sync):
    """hpZ and MiCS at ``ZEROPP_CKPT_LAYERS`` layers: 2 steps, a save, 2
    more; a fresh engine of the same config and one of plain ZeRO 3 load
    the tag and take the same 2 steps; the same 2 first steps with the
    optimizer state pinned on the host.  Losses and master digests."""
    import dataclasses
    import shutil
    import numpy as np
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models import llama

    def build(zero):
        _, cfg, S = _model("llama7b", cpu)
        if not cpu:
            cfg = dataclasses.replace(cfg,
                                      num_hidden_layers=ZEROPP_CKPT_LAYERS)
        config = _config("llama7b", 3)
        config["zero_optimization"] = dict(ZERO3, **zero)
        engine = deepspeed_tpu_torch.initialize(
            model=llama.LlamaModel(cfg, device="meta"), config=config,
            device="cpu" if cpu else None)[0]
        B = engine.train_micro_batch_size_per_gpu() * engine.dp_world_size
        gbatch = np.random.default_rng(args.seed + 1).integers(
            0, cfg.vocab_size, size=(B, S))
        return engine, engine.shard_batch(gbatch)[0]

    def steps(engine, ids, n):
        out = []
        for _ in range(n):
            loss = engine(ids, ids)
            engine.backward(loss)
            engine.step()
            out.append(loss.item())
        sync()
        return out

    def digests(engine):
        """Every rank's digest of the whole fp32 master (gathered, so two
        layouts of the same values agree)."""
        flat = engine.fp32_params()
        return _shard_digest(torch, flat[:engine.zero_plan.numel])

    def free(engine):
        del engine
        gc.collect()
        if not cpu:
            torch.cuda.empty_cache()
            empty = getattr(torch._C, "_host_emptyCache", None)
            if empty is not None:
                empty()

    legs = []
    for kind, zp in (("hpz", {"zero_hpz_partition_size": 2}),
                     ("mics", {"mics_shard_size": 2})):
        root = os.path.join(args.ckpt_dir, kind)
        engine, ids = build(zp)
        engine.initialize_parameters(args.seed)
        first = steps(engine, ids, 2)
        at_save = digests(engine)
        t0 = time.perf_counter()
        engine.save_checkpoint(root, tag="t")
        save_s = time.perf_counter() - t0
        then = steps(engine, ids, 2)
        after = digests(engine)
        free(engine)
        row = dict(kind=kind, first=first, then=then, save_s=save_s,
                   digest_at_save=at_save, digest_after=after)
        for name, zero in (("same", zp), ("zero3", {})):
            eng, ids = build(zero)
            t0 = time.perf_counter()
            eng.load_checkpoint(root)
            row[f"load_s_{name}"] = time.perf_counter() - t0
            row[f"loaded_digest_{name}"] = digests(eng)
            row[f"then_{name}"] = steps(eng, ids, 2)
            row[f"digest_after_{name}"] = digests(eng)
            free(eng)
        if comm.get_rank() == 0:
            shutil.rmtree(root, ignore_errors=True)
        eng, ids = build(dict(zp, offload_optimizer={
            "device": "cpu", "pin_memory": True}))
        eng.initialize_parameters(args.seed)
        row["first_offload"] = steps(eng, ids, 2)
        row["digest_offload"] = digests(eng)
        row["placement_offload"] = eng.state_placement()
        free(eng)
        comm.barrier()
        legs.append(row)
    return legs


def _zeropp_main(args, world, smi, out):
    import shutil
    import tempfile
    ckpt = tempfile.mkdtemp(prefix="zero_multicard_zeropp_")
    try:
        rcs = _spawn(world, sys.argv[1:] + ["--out-rank0", out,
                                            "--ckpt-dir", ckpt])
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    if any(rcs):
        print(f"zero_multicard: ranks exited {rcs}", file=sys.stderr)
        return 1
    with open(out) as f:
        got = json.load(f)
    rows = {r["name"]: r for r in got["rows"]}
    os.remove(out)
    ok = True
    for r in rows.values():
        cut = ("" if r["layers"] == rows["zero3"]["layers"] else
               f" (cut to {r['layers']} layers, widths kept, for the "
               "call's time)")
        print(f"[zeropp] {r['name']}{cut}, world {r['world']}, "
              f"{r['variant']}: losses " + ", ".join(
                  f"{x:.4f}" for x in r["losses"])
              + f" | step ms {r['step_ms_mean']:.1f}, "
              f"{r['tokens_per_s']:.1f} tokens/s over the world, MFU "
              f"{r['mfu']:.4f} | peak GiB by rank " + ", ".join(
                  f"{b / 2**30:.2f}" for b in r["peak_bytes_by_rank"])
              + f" | parameter shard {r['param_numel']:,} elements | wire "
              "MB a step " + ", ".join(
                  f"{k} {v / 1e6:.1f} (of {r['msg_bytes_per_step'][k] / 1e6:.1f})"
                  for k, v in sorted(r["wire_bytes_per_step"].items()))
              + f" | engine picks {r['dispatch']} | launches a step "
              f"{r['launches_per_step']} | {smi}", flush=True)
        ok &= r["rank_losses_equal"] and all(
            map(math.isfinite, r["losses"]))
    checks = []
    for name, ref, rule in (("hpz2_8l", "zero3_8l", "bit"),
                            ("mics2_8l", "zero3_8l", 2e-4),
                            ("qwz_qgz_int8", "zero3", 1e-2),
                            ("hier_qgz_int8", "zero3", 1e-2),
                            ("qwz_fp6_8l", "zero3_8l", 1e-2)):
        a, b = rows[name], rows[ref]
        if rule == "bit":
            good = (a["losses"] == b["losses"] and
                    a["master_digests"] == b["master_digests"])
            what = "losses and master bit-equal"
        elif rule == 2e-4:
            rel = max(abs(x - y) / abs(y) for x, y in zip(a["losses"],
                                                          b["losses"]))
            good, what = rel <= rule, f"losses within {rel:.2e} relative"
        else:
            rel = abs(a["losses"][-1] - b["losses"][-1]) / abs(
                b["losses"][-1])
            good = rel <= rule
            what = f"final loss {rel:.2e} relative from"
        checks.append(dict(run=name, ref=ref, ok=good, what=what))
        print(f"[zeropp] {name}: {what} {ref} (limit {rule}) -> "
              f"{'ok' if good else 'FAILED'}", flush=True)
        ok &= good
    for leg in got["legs"]:
        rel = max(abs(a - b) / abs(b) for a, b in zip(leg["then_zero3"],
                                                      leg["then"]))
        limit = 0.0 if leg["kind"] == "hpz" else 2e-4
        good = {
            "resume bit-equal": leg["then_same"] == leg["then"] and
            leg["loaded_digest_same"] == leg["digest_at_save"] and
            leg["digest_after_same"] == leg["digest_after"],
            "loads into ZeRO 3 bit-equal": leg["loaded_digest_zero3"] ==
            leg["digest_at_save"],
            f"ZeRO 3's next losses within {limit}": rel <= limit,
            "pinned offload bit-equal": leg["first_offload"] ==
            leg["first"] and leg["digest_offload"] ==
            leg["digest_at_save"] and
            leg["placement_offload"].get("master") == "host",
        }
        print(f"[zeropp] {leg['kind']} (zp 2) at {ZEROPP_CKPT_LAYERS} "
              f"layers: losses {leg['first']} then {leg['then']}; resumed "
              f"{leg['then_same']}, as ZeRO 3 {leg['then_zero3']} "
              f"({rel:.2e} relative); with pinned state "
              f"{leg['first_offload']}; save {leg['save_s']:.1f} s, loads "
              f"{leg['load_s_same']:.1f} and {leg['load_s_zero3']:.1f} s | "
              + ", ".join(f"{k}: {'ok' if v else 'FAILED'}"
                          for k, v in good.items()) + f" | {smi}",
              flush=True)
        checks.append(dict(run=leg["kind"], ok=all(good.values()),
                           what=good))
        ok &= all(good.values())
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(card=smi, runs=list(rows.values()),
                           legs=got["legs"], checks=checks), f, indent=1)
    if not ok:
        print("zero_multicard: a ZeRO++ check failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "model": "llama7b", "world": world,
                      "zeropp": True}))
    return 0


# --pipe: (name, pp, sp, layers (None: as deep as fits), microbatches,
#          global rows a microbatch, the run it is compared with, ZeRO)
Z1, Z3 = {"stage": 1}, {"stage": 3}
Z2_OVERLAP = {"stage": 2, "overlap_comm": True}
PIPE_RUNS = (
    ("a_pp4_full", 4, 1, None, 8, 1, None, Z1),
    ("b_pp2_sp2", 2, 2, None, 8, 1, None, Z1),
    ("base", 1, 1, 4, 4, 4, None, Z1),
    ("pp2", 2, 1, 4, 4, 4, "base", Z1),
    ("pp4", 4, 1, 4, 4, 4, "base", Z1),
    ("sp2", 1, 2, 4, 4, 4, "base", Z1),
    ("sp4", 1, 4, 4, 4, 4, "base", Z1),
    ("pp2_sp2", 2, 2, 4, 4, 4, "base", Z1),
    ("d_pp2_dp2_z3_full", 2, 1, None, 8, 2, None, Z3),
    ("e_pp2_sp2_z3", 2, 2, None, 8, 1, None, Z3),
    ("base_z3", 1, 1, 4, 4, 4, None, Z3),
    ("pp2_dp2_z3", 2, 1, 4, 4, 4, "base_z3", Z3),
    ("base_z2_overlap", 1, 1, 4, 4, 4, None, Z2_OVERLAP),
    ("pp2_dp2_z2_overlap", 2, 1, 4, 4, 4, "base_z2_overlap", Z2_OVERLAP),
)
# the checkpoint leg: the tag pp2_dp2_z3 writes after its steps, loaded at
# these (pp, dp) splits, each then running CKPT_STEPS steps as it did
CKPT_SAVER, CKPT_STEPS = "pp2_dp2_z3", 2
CKPT_LOADS = (("ckpt_pp4", 4), ("ckpt_pp1_dp4", 1))


def _pipe_depth(cfg, pp, sp, world, total_bytes, zero=1):
    """The deepest stack (a multiple of ``pp`` blocks, at most the
    model's) whose busiest stage's state fits 0.85 of the card, with 3 GB
    of activations.  ZeRO 1: 2 (bf16) + 4 (fp32 accumulator) + 12 / data
    world (master, moments) bytes a parameter, and the step's fp32 shard
    (none in a data group of one rank, which reduces in place).  ZeRO 3:
    (2 + 4 + 12) / data world bytes a parameter (every state sharded),
    one block and the outer unit gathered in bf16, and their fp32
    gradient scratch (the outer unit's held through the step when it
    holds the tied embedding)."""
    from deepspeed_tpu_torch.models import gpt2
    D, V, P = cfg.hidden_size, cfg.vocab_size, cfg.max_position_embeddings
    block = gpt2.param_count(gpt2.GPT2Config(
        vocab_size=0, hidden_size=D, num_hidden_layers=1,
        max_position_embeddings=0)) - 2 * D
    embed = (V + P) * D
    data = world // pp
    for L in range(cfg.num_hidden_layers, 0, -pp):
        n = -(-L // pp) * block + embed
        if zero >= 3:
            need = n * 18 / data + (2 + 4) * (block + embed) + 3e9
        else:
            need = n * (2 + 4 + 12 / data) + (4 * n / data if data > 1 else
                                              0) + 3e9
        if need <= 0.85 * total_bytes:
            return L
    raise RuntimeError("not one block a stage fits the card")


def run_pipe_rank(args):
    """``--pipe``: each run of :data:`PIPE_RUNS` in turn (module
    docstring)."""
    import dataclasses
    import numpy as np
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.ops.kernels import optimizers as opt
    cpu = args.device == "cpu"
    torch.set_num_threads(1)
    sync = (lambda: None) if cpu else torch.cuda.synchronize
    dev = "cpu" if cpu else "cuda"
    full = (gpt2.gpt2_tiny(num_hidden_layers=8, max_position_embeddings=64)
            if cpu else gpt2.gpt3_13b())
    S = full.max_position_embeddings
    counters = {"flash_fwd": fa.flash_attention_fwd,
                "flash_dq": fa.flash_attention_bwd_dq,
                "flash_dkv": fa.flash_attention_bwd_dkv,
                "adam": opt.fused_adam_step}
    rows, ckpt = [], None
    deepspeed_tpu_torch.init_distributed(
        dist_backend="gloo" if cpu else "nccl", verbose=False)
    world = comm.get_world_size()
    for name, pp, sp, layers, M, R, compare, zero in PIPE_RUNS:
        if layers is None:
            layers = (full.num_hidden_layers if cpu else _pipe_depth(
                full, pp, sp, world, torch.cuda.mem_get_info()[1],
                zero["stage"]))
        cfg = dataclasses.replace(full, num_hidden_layers=layers,
                                  use_ulysses=sp > 1)
        dp = world // (pp * sp)

        def build(pp, dp):
            pm = gpt2.pipeline_module(cfg, activation_checkpoint_interval=1)
            config = {"train_micro_batch_size_per_gpu": R // dp,
                      "gradient_accumulation_steps": M,
                      "optimizer": {"type": "fusedadam",
                                    "params": {"lr": 1e-4}},
                      "bf16": {"enabled": True},
                      "zero_optimization": dict(zero),
                      "mesh": {"pp": pp, "sp": sp},
                      "comms_logger": {"enabled": True, "prof_all": True}}
            model = (pm.to_module(device="meta") if name.startswith("base")
                     else pm)
            return deepspeed_tpu_torch.initialize(
                model=model, config=config, device=dev if cpu else None)[0]

        engine = build(pp, dp)
        engine.initialize_parameters(args.seed)
        rng = np.random.default_rng(args.seed + 1)
        batches = []
        for _ in range(M):
            ids = rng.integers(0, cfg.vocab_size, size=(R, S))
            batches.append((ids, np.roll(ids, -1, axis=1)))
        pipeline = not name.startswith("base")
        losses, times, compute, p2p = [], [], [], []
        for i in range(1 + args.steps):
            if i == 1:
                sync()
                comm.comms_logger.reset()
                for fn in counters.values():
                    fn.launches = 0
                if not cpu:
                    torch.cuda.reset_peak_memory_stats()
                if pipeline:
                    engine.instruction_timing = True
            t = time.perf_counter()
            if pipeline:
                loss = engine.train_batch(iter(batches))
            else:
                micro = []
                for x, y in batches:
                    out = engine(*engine.shard_batch(x, y))
                    engine.backward(out)
                    engine.step()
                    micro.append(out.detach().float())
                loss = torch.stack(micro).mean()
            losses.append(loss.item())
            sync()
            if i >= 1:
                times.append(time.perf_counter() - t)
                if pipeline:
                    st = engine.last_step_stats
                    compute.append(st["compute_ms"])
                    p2p.append(st["p2p_bytes"])
        peak = 0 if cpu else torch.cuda.max_memory_allocated()
        summary = comm.comms_logger.get_summary_dict()["ops"]
        a2a = summary.get("all_to_all_single", {})
        step_ms = sum(times) / len(times) * 1e3
        idle = (1 - sum(compute) / len(compute) / step_ms) if compute else 0
        mine = torch.tensor([float(peak), idle,
                             sum(p2p) / max(1, len(p2p))] + losses,
                            device=dev)
        every = comm.all_gather(mine, tiled=False).cpu()
        tokens = R * S * M
        launches = {k: fn.launches / args.steps for k, fn in counters.items()}
        if name == CKPT_SAVER and args.ckpt_dir:
            ckpt = _pipe_checkpoint(args, engine, build, batches, dp * pp,
                                    sync)
        rows.append(dict(
            name=name, pp=pp, sp=sp, dp=dp, layers=layers, M=M, zero=zero,
            full_layers=full.num_hidden_layers,
            global_rows=R, world=world, compare=compare, losses=losses,
            rank_losses_equal=bool((every[:, 3:] == every[0, 3:]).all()),
            step_ms=[t * 1e3 for t in times], step_ms_mean=step_ms,
            tokens_per_s=tokens / step_ms * 1e3,
            mfu=tokens / step_ms * 1e3 * (
                6 * gpt2.param_count(cfg) +
                12 * layers * S * cfg.hidden_size) / (PEAK_FLOPS * world),
            peak_bytes_by_rank=[int(x) for x in every[:, 0].tolist()],
            idle_share_by_rank=[float(x) for x in every[:, 1].tolist()],
            bubble=(pp - 1) / (M + pp - 1),
            p2p_mb_by_rank=[float(x) / 1e6 for x in every[:, 2].tolist()],
            a2a_mb_per_step=a2a.get("total_msg_bytes", 0) / 1e6 / args.steps,
            a2a_ms_per_step=a2a.get("total_latency_ms", 0.0) / args.steps,
            a2a_calls_per_step=a2a.get("count", 0) / args.steps,
            launches_per_step=launches, param_numel=engine.zero_plan.numel))
        del engine, loss
        gc.collect()
        if not cpu:
            torch.cuda.empty_cache()
    if args.rank == 0:
        with open(args.out_rank0, "w") as f:
            json.dump(dict(rows=rows, ckpt=ckpt), f)
    comm.destroy_process_group()


def _pipe_checkpoint(args, engine, build, batches, world, sync):
    """The checkpoint leg (:data:`CKPT_LOADS`): ``engine`` saves a tag and
    runs :data:`CKPT_STEPS` more steps; a fresh engine at each other split
    loads the tag and runs the same steps.  Every split's losses, the save
    and load seconds and the tag's bytes."""
    import torch
    t = time.perf_counter()
    engine.save_checkpoint(args.ckpt_dir, tag="t")
    sync()
    save_s = time.perf_counter() - t

    def steps(eng):
        return [float(eng.train_batch(iter(batches)).item())
                for _ in range(CKPT_STEPS)]

    out = dict(save_s=save_s, after={"saver": steps(engine)}, load_s={})
    root = os.path.join(args.ckpt_dir, "t")
    out["tag_bytes"] = sum(os.path.getsize(os.path.join(root, f))
                           for f in os.listdir(root))
    for name, pp in CKPT_LOADS:
        fresh = build(pp, world // pp)
        sync()
        t = time.perf_counter()
        fresh.load_checkpoint(args.ckpt_dir)
        sync()
        out["load_s"][name] = time.perf_counter() - t
        out["after"][name] = steps(fresh)
        del fresh
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return out


def _pipe_main(args, world, smi, out):
    import shutil
    import tempfile
    ckpt_dir = tempfile.mkdtemp(prefix="zero_multicard_pipe_")
    try:
        rcs = _spawn(world, sys.argv[1:] + ["--out-rank0", out,
                                            "--ckpt-dir", ckpt_dir])
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    if any(rcs):
        print(f"zero_multicard: ranks exited {rcs}", file=sys.stderr)
        return 1
    with open(out) as f:
        got = json.load(f)
    rows = {r["name"]: r for r in got["rows"]}
    os.remove(out)
    ok = True
    for r in rows.values():
        line = (f"[pipe] {r['name']}: pp {r['pp']} × sp {r['sp']} × dp "
                f"{r['dp']}, ZeRO {r['zero']}, {r['layers']} layers, M "
                f"{r['M']} of "
                f"{r['global_rows']} rows: losses " + ", ".join(
                    f"{x:.5f}" for x in r["losses"])
                + f" | step ms {r['step_ms_mean']:.1f}, "
                f"{r['tokens_per_s']:.1f} tokens/s, MFU {r['mfu']:.4f} | "
                "peak GiB by rank " + ", ".join(
                    f"{b / 2**30:.2f}" for b in r["peak_bytes_by_rank"])
                + " | p2p MB sent a step by rank " + ", ".join(
                    f"{x:.1f}" for x in r["p2p_mb_by_rank"])
                + f" | all-to-all {r['a2a_mb_per_step']:.1f} MB, "
                f"{r['a2a_ms_per_step']:.1f} ms, "
                f"{r['a2a_calls_per_step']:.0f} calls a step | idle share "
                "by rank " + ", ".join(
                    f"{x:.3f}" for x in r["idle_share_by_rank"])
                + f" (1F1B bubble {r['bubble']:.3f}) | launches a step "
                f"{r['launches_per_step']} | {smi}")
        ok &= r["rank_losses_equal"] and all(
            map(math.isfinite, r["losses"]))
        if r["compare"] is not None:
            base = rows[r["compare"]]
            scale = max(abs(x) for x in base["losses"])
            diff = max(abs(a - b) for a, b in zip(r["losses"],
                                                  base["losses"]))
            r["max_loss_diff_vs_base"] = diff
            good = diff <= 2.0**-7 * scale
            ok &= good
            line += (f" | largest loss difference from {r['compare']} "
                     f"{diff:.3e} (limit 2^-7 × {scale:.4f}) -> "
                     f"{'ok' if good else 'FAILED'}")
        print(line, flush=True)
    for key in ("a_pp4_full", "b_pp2_sp2", "d_pp2_dp2_z3_full",
                "e_pp2_sp2_z3"):
        print(f"[pipe] {key}: depth {rows[key]['layers']} of the "
              f"model's {rows[key]['full_layers']} (the deepest whose "
              f"ZeRO-{rows[key]['zero']['stage']} state fits 0.85 of a "
              "card; widths kept)", flush=True)
    ck = got["ckpt"]
    ref = ck["after"]["saver"]
    scale = max(abs(x) for x in ref)
    for name, losses in ck["after"].items():
        diff = max(abs(a - b) for a, b in zip(losses, ref))
        good = diff <= 2.0**-7 * scale
        ok &= good and all(map(math.isfinite, losses))
        load = ("" if name == "saver" else
                f", load {ck['load_s'][name]:.2f} s")
        print(f"[pipe] checkpoint: {CKPT_SAVER} saved "
              f"{ck['tag_bytes'] / 1e9:.2f} GB in {ck['save_s']:.2f} s"
              f"{load}; {name} then {CKPT_STEPS} steps: losses "
              + ", ".join(f"{x:.5f}" for x in losses)
              + f" | largest difference from the saver's "
              f"{diff:.3e} (limit 2^-7 × {scale:.4f}) -> "
              f"{'ok' if good else 'FAILED'} | {smi}", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(card=smi, runs=list(rows.values()),
                           checkpoint=ck), f, indent=1)
    if not ok:
        print("zero_multicard: a pipeline check failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "model": "gpt3_13b", "world": world,
                      "pipe": True}))
    return 0


def _master_digest(engine):
    """sha256 of the whole fp32 master, leaf by leaf in name order (the
    same at any world size; a collective), on rank 0 (None elsewhere)."""
    import hashlib
    flat = engine.fp32_params()
    if engine.dp_rank:
        return None
    h = hashlib.sha256()
    for name, off, n, _ in sorted(engine._layout):
        h.update(flat[off:off + n].cpu().numpy().tobytes())
    return h.hexdigest()


def _ckpt_layers(model, free):
    """The largest depth (at most the model's) whose tag, 14 bytes an
    element, fits ``free`` bytes of disk."""
    from deepspeed_tpu_torch.models import llama
    L = 32 if model == "llama7b" else 8
    while L > 1 and 14 * llama.param_count(llama.llama_7b(
            num_hidden_layers=L)) * 1.05 > free:
        L -= 1
    return L


def run_checkpoint_rank(args):
    """``--checkpoint``: save and resume at ZeRO 3 (module docstring)."""
    import dataclasses
    import numpy as np
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models import llama
    cpu = args.device == "cpu"
    device = "cpu" if cpu else None
    sync = (lambda: None) if cpu else torch.cuda.synchronize
    model, cfg, S = _model(args.model, cpu)
    if not cpu:
        cfg = dataclasses.replace(cfg, num_hidden_layers=args.ckpt_layers)
    config = _config(args.model, 3)

    def make():
        engine = deepspeed_tpu_torch.initialize(
            model=llama.LlamaModel(cfg, device="meta"), config=config,
            device=device)[0]
        engine.initialize_parameters(args.seed)
        return engine

    def train(engine, batches):
        out = []
        for ids in batches:
            for _ in range(engine.gradient_accumulation_steps()):
                loss = engine(ids, ids)
                engine.backward(loss)
                engine.step()
                out.append(loss.item())
        sync()
        return out

    row = dict(world=None, layers=cfg.num_hidden_layers)
    if args.ckpt_phase == "load":
        engine = make()
        t = time.perf_counter()
        engine.load_checkpoint(args.ckpt_dir)
        sync()
        row.update(world=engine.dp_world_size,
                   load_s=time.perf_counter() - t,
                   digest=_master_digest(engine))
    else:
        engine = make()
        world, rank = engine.dp_world_size, engine.dp_rank
        B = engine.train_micro_batch_size_per_gpu() * world
        rng = np.random.default_rng(args.seed + 1)
        batches = [engine.shard_batch(rng.integers(
            0, cfg.vocab_size, size=(B, S)))[0] for _ in range(4)]
        train(engine, batches[:2])
        saved = engine._target().to("cpu", copy=True)
        # the other world's load compares against it (--model llama)
        digest = _master_digest(engine) if args.model == "llama" else None
        sync()
        t = time.perf_counter()
        engine.save_checkpoint(args.ckpt_dir, tag="t")
        save_s = time.perf_counter() - t
        stats = engine.last_checkpoint.stats()
        losses = train(engine, batches[2:])
        after = engine._target().to("cpu", copy=True)
        del engine
        gc.collect()
        if not cpu:
            torch.cuda.empty_cache()
        engine = make()
        t = time.perf_counter()
        engine.load_checkpoint(args.ckpt_dir)
        sync()
        load_s = time.perf_counter() - t
        loaded = torch.equal(engine._target().cpu(), saved)
        resumed = train(engine, batches[2:])
        same = torch.equal(engine._target().cpu(), after)
        mine = torch.tensor([float(loaded and same), save_s, load_s,
                             float(sum(stats["bytes"].values()))] +
                            losses + resumed,
                            device="cpu" if cpu else "cuda")
        every = comm.all_gather(mine, tiled=False).cpu()
        row.update(world=world, losses=losses, losses_resumed=resumed,
                   equal_by_rank=[bool(x) for x in every[:, 0].tolist()],
                   save_s_by_rank=every[:, 1].tolist(),
                   load_s_by_rank=every[:, 2].tolist(),
                   bytes_by_rank=[int(x) for x in every[:, 3].tolist()],
                   stage_s=stats["stage_s"], write_s=stats["write_s"],
                   commit_s=stats["commit_s"], digest=digest,
                   rank_losses_equal=bool(
                       (every[:, 4:] == every[0, 4:]).all()))
    if engine.dp_rank == 0:
        with open(args.out_rank0, "w") as f:
            json.dump(row, f)
    comm.destroy_process_group()


def _pinned_bytes(n):
    """Bytes the pinned allocator takes for ``n`` (a power of two)."""
    return 1 << max(0, int(n - 1).bit_length())


def _mem_available():
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def _rss_bytes():
    """This process's resident host memory."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    return 0


def _stream_layers(world, avail):
    """The most layers (at most 40) whose streamed host store fits 0.7 ×
    ``avail`` over the world: each rank's slice of every group, 12 bytes
    an element of fp32 state and its pinned bf16 cache and stash in
    power-of-two blocks."""
    from deepspeed_tpu_torch.models import llama
    cfg = llama.llama_13b()
    D, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    block, res = 4 * D * D + 3 * D * I + 2 * D, 2 * V * D + D

    def rank_bytes(n):
        s = -(-n // (16 * world)) * 16
        return 12 * s + 2 * _pinned_bytes(2 * s)

    L = 40
    while L > 1 and world * (L * rank_bytes(block) + rank_bytes(res)) > \
            0.7 * avail:
        L -= 1
    return L


def _offload_layers(world, avail):
    """The most layers (at most 40) whose pinned state on the host, every
    rank's master and two moments, fits 0.7 × ``avail`` bytes."""
    from deepspeed_tpu_torch.models import llama
    L = 40
    while L > 1 and world * 3 * _pinned_bytes(4 * math.ceil(
            llama.param_count(llama.llama_13b(num_hidden_layers=L)) /
            world)) > 0.7 * avail:
        L -= 1
    return L


def run_offload_rank(args):
    """``--offload``: the 13B run with its state pinned, then the 2-layer
    pair with and without offload (module docstring)."""
    import numpy as np
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models import llama
    cpu = args.device == "cpu"
    sync = (lambda: None) if cpu else torch.cuda.synchronize
    S = 2048
    tiny = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                num_attention_heads=4, num_key_value_heads=4,
                max_position_embeddings=S) if cpu else {}
    remat = dict(remat=True, remat_policy="nothing_saveable")

    def run(layers, offload, steps, opt=LAMB, weights=None):
        cfg = llama.llama_13b(**{**dict(num_hidden_layers=layers,
                                        head_dtype="bfloat16"),
                                 **remat, **tiny})
        zero = dict(ZERO3)
        if offload:
            zero["offload_optimizer"] = {"device": "cpu", "pin_memory": True}
        t0 = time.perf_counter()
        engine = deepspeed_tpu_torch.initialize(
            model=llama.LlamaModel(cfg, device="meta"),
            model_parameters=weights,
            config=dict(_config("llama7b", 3), optimizer=opt,
                        zero_optimization=zero),
            device="cpu" if cpu else None)[0]
        if weights is None:
            engine.initialize_parameters(args.seed)
        build_s = time.perf_counter() - t0
        world = engine.dp_world_size
        B = engine.train_micro_batch_size_per_gpu() * world
        rng = np.random.default_rng(args.seed + 1)
        batches = [engine.shard_batch(rng.integers(
            0, cfg.vocab_size, size=(B, S)))[0] for _ in range(2)]
        losses, times = [], []
        for i in range(steps):
            if i == 1:
                sync()
                if not cpu:
                    torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            loss = engine(batches[i % 2], batches[i % 2])
            engine.backward(loss)
            engine.step()
            losses.append(loss.item())
            sync()
            times.append(time.perf_counter() - t)
        peak = 0 if cpu else torch.cuda.max_memory_allocated()
        pinned = engine.offload_stats
        mine = torch.tensor([float(peak), pinned["pin_seconds"],
                             float(pinned["pinned_bytes"])] + losses,
                            device="cpu" if cpu else "cuda")
        every = comm.all_gather(mine, tiled=False).cpu()
        step_s = sum(times[1:]) / max(1, len(times) - 1)
        row = dict(layers=layers, offload=offload, world=world,
                   losses=losses, step_ms=[t * 1e3 for t in times],
                   build_s=build_s, step_ms_mean=step_s * 1e3,
                   tokens_per_s=B * S / step_s,
                   mfu=B * S / step_s * _flops_per_token("llama", cfg, S) /
                   (PEAK_FLOPS * world),
                   peak_bytes_by_rank=[int(x) for x in every[:, 0]],
                   pin_s_by_rank=every[:, 1].tolist(),
                   pinned_bytes_by_rank=[int(x) for x in every[:, 2]],
                   rank_losses_equal=bool((every[:, 3:] ==
                                           every[0, 3:]).all()),
                   placement=engine.state_placement())
        del engine
        gc.collect()
        if not cpu:
            torch.cuda.empty_cache()
            empty = getattr(torch._C, "_host_emptyCache", None)
            if empty is not None:
                empty()
        return row

    def stream(layers, steps, weights_out=None):
        """ZeRO-Infinity parameter streaming: this rank's quarter of the
        host store, the host Adam.  ``weights_out``: a dict that gets the
        initial fp32 weights (a collective)."""
        cfg = llama.llama_13b(**{**dict(num_hidden_layers=layers,
                                        head_dtype="bfloat16"),
                                 **remat, **tiny})
        t0 = time.perf_counter()
        engine = deepspeed_tpu_torch.initialize(
            model=llama.LlamaModel(cfg, device="meta"),
            config=dict(_config("llama7b", 3), optimizer=ADAM,
                        zero_optimization=STREAMED),
            device="cpu" if cpu else None)[0]
        engine.initialize_parameters(args.seed)
        build_s = time.perf_counter() - t0
        if weights_out is not None:
            weights_out.update(engine.get_fp32_param())
        world = engine.dp_world_size
        B = engine.train_micro_batch_size_per_gpu() * world
        rng = np.random.default_rng(args.seed + 1)
        batches = [engine.shard_batch(rng.integers(
            0, cfg.vocab_size, size=(B, S)))[0] for _ in range(2)]
        losses, times = [], []
        for i in range(steps):
            if i == 1:
                sync()
                if not cpu:
                    torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            loss = engine(batches[i % 2], batches[i % 2])
            engine.backward(loss)
            engine.step()
            losses.append(loss.item())
            sync()
            times.append(time.perf_counter() - t)
        store = engine._store
        peak = 0 if cpu else torch.cuda.max_memory_allocated()
        # the cache and the stash are pinned, in power-of-two blocks
        pinned = 0 if cpu else 2 * sum(_pinned_bytes(
            2 * store.shard_numel(k)) for k in store.keys())
        sweep = engine.sweep_seconds[1:]
        mine = torch.tensor([float(peak), float(_rss_bytes()),
                             float(store.host_bytes()), float(pinned),
                             float(store.threads)] + losses,
                            device="cpu" if cpu else "cuda")
        every = comm.all_gather(mine, tiled=False).cpu()
        step_s = sum(times[1:]) / max(1, len(times) - 1)
        row = dict(layers=layers, streamed=True, world=world,
                   losses=losses, step_ms=[t * 1e3 for t in times],
                   build_s=build_s, step_ms_mean=step_s * 1e3,
                   tokens_per_s=B * S / step_s,
                   mfu=B * S / step_s * _flops_per_token("llama", cfg, S) /
                   (PEAK_FLOPS * world),
                   sweep_s=sweep,
                   sweep_share=sum(sweep) / max(1e-9, sum(times[1:])),
                   peak_bytes_by_rank=[int(x) for x in every[:, 0]],
                   rss_bytes_by_rank=[int(x) for x in every[:, 1]],
                   store_bytes_by_rank=[int(x) for x in every[:, 2]],
                   pinned_bytes_by_rank=[int(x) for x in every[:, 3]],
                   host_threads=int(every[0, 4]),
                   rank_losses_equal=bool((every[:, 5:] ==
                                           every[0, 5:]).all()))
        del engine
        gc.collect()
        if not cpu:
            torch.cuda.empty_cache()
            empty = getattr(torch._C, "_host_emptyCache", None)
            if empty is not None:
                empty()
        return row

    rows = [run(args.offload_layers, True, 1 + args.steps),
            run(2, True, 2), run(2, False, 2),
            stream(args.stream_layers, 1 + args.steps)]
    # the pair starts from the streamed engine's weights (its host init
    # draws each leaf from its own generator)
    weights = {}
    rows.append(stream(2, 2, weights))
    rows.append(run(2, True, 2, opt=ADAM, weights=weights))
    del weights
    if comm.get_rank() == 0:
        with open(args.out_rank0, "w") as f:
            json.dump(rows, f)
    comm.destroy_process_group()


def _offload_main(args, world, smi, out):
    avail = _mem_available()
    layers = _offload_layers(world, avail)
    streamed = _stream_layers(world, avail)
    print(f"[offload] MemAvailable {avail / 1e9:.1f} GB; Llama-2-13B's "
          f"pinned state at world {world}: 12 bytes × its shard a rank, in "
          f"power-of-two blocks; 0.7 × MemAvailable holds {layers} of 40 "
          "layers" + ("" if layers == 40 else " (cut, widths kept)")
          + f"; its streamed host store (each rank a slice of every group: "
          f"12 bytes an element and the pinned cache and stash) holds "
          f"{streamed} of 40" + ("" if streamed == 40 else
                                 " (cut, widths kept)"), flush=True)
    rcs = _spawn(world, sys.argv[1:] + ["--out-rank0", out,
                                        "--offload-layers", str(layers),
                                        "--stream-layers", str(streamed)])
    if any(rcs):
        print(f"zero_multicard: ranks exited {rcs}", file=sys.stderr)
        return 1
    with open(out) as f:
        main_run, off2, plain2, st, st2, off2_adam = json.load(f)
    os.remove(out)
    r = main_run
    print(f"[offload] Llama-2-13B, {r['layers']} layers, ZeRO 3 + "
          f"offload_optimizer cpu + fusedlamb, bf16, remat, world "
          f"{r['world']}: losses " + ", ".join(
              f"{x:.4f}" for x in r["losses"])
          + f" | built in {r['build_s']:.1f} s, pinned GB by rank " +
          ", ".join(f"{b / 1e9:.2f}" for b in r["pinned_bytes_by_rank"])
          + " in s " + ", ".join(f"{x:.1f}" for x in r["pin_s_by_rank"])
          + f" | step ms (after the warm-up) " + ", ".join(
              f"{t:.1f}" for t in r["step_ms"][1:])
          + f", mean {r['step_ms_mean']:.1f}, {r['tokens_per_s']:.1f} "
          f"tokens/s over the world, MFU {r['mfu']:.4f} | peak GiB by rank "
          + ", ".join(f"{b / 2**30:.2f}" for b in r["peak_bytes_by_rank"])
          + f" | placement {r['placement']} | {smi}", flush=True)
    rel = max(abs(a - b) / abs(b) for a, b in zip(off2["losses"],
                                                  plain2["losses"]))
    print(f"[offload] 2 layers with and without offload: losses "
          f"{off2['losses']} and {plain2['losses']} (largest relative "
          f"difference {rel:.2e}, limit 2^-7); peak GiB by rank "
          + ", ".join(f"{b / 2**30:.2f}" for b in off2["peak_bytes_by_rank"])
          + " and " + ", ".join(f"{b / 2**30:.2f}" for b in
                                plain2["peak_bytes_by_rank"])
          + f" | {smi}", flush=True)
    print(f"[offload] streamed Llama-2-13B, {st['layers']} layers, "
          f"offload_param + offload_optimizer cpu, the host Adam on "
          f"{st['host_threads']} threads a rank, bf16, remat, world "
          f"{st['world']}: losses " + ", ".join(
              f"{x:.4f}" for x in st["losses"])
          + f" | built in {st['build_s']:.1f} s | step ms (after the "
          "warm-up) " + ", ".join(f"{t:.1f}" for t in st["step_ms"][1:])
          + f", mean {st['step_ms_mean']:.1f}, {st['tokens_per_s']:.1f} "
          f"tokens/s over the world, MFU {st['mfu']:.4f} | host sweep s "
          + ", ".join(f"{x:.2f}" for x in st["sweep_s"])
          + f" ({st['sweep_share']:.3f} of the steps) | host RSS GB by "
          "rank " + ", ".join(f"{b / 1e9:.1f}" for b in
                              st["rss_bytes_by_rank"])
          + ", store GB " + ", ".join(f"{b / 1e9:.1f}" for b in
                                      st["store_bytes_by_rank"])
          + ", pinned GB " + ", ".join(f"{b / 1e9:.1f}" for b in
                                       st["pinned_bytes_by_rank"])
          + " | peak HBM GiB by rank " + ", ".join(
              f"{b / 2**30:.2f}" for b in st["peak_bytes_by_rank"])
          + f" | {smi}", flush=True)
    rel_st = max(abs(a - b) / abs(b) for a, b in zip(st2["losses"],
                                                     off2_adam["losses"]))
    print(f"[offload] 2 layers streamed against ZeRO 3 with pinned state, "
          f"fusedadam, world {st2['world']}: losses {st2['losses']} and "
          f"{off2_adam['losses']} (largest relative difference "
          f"{rel_st:.2e}, limit 2^-7) | {smi}", flush=True)
    ok = (all(x["rank_losses_equal"] for x in (r, off2, plain2, st, st2,
                                               off2_adam)) and
          all(map(math.isfinite, r["losses"] + st["losses"])) and
          rel <= 2.0**-7 and rel_st <= 2.0**-7 and
          r["placement"].get("master") == "host")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(card=smi, mem_available=avail, layers=layers,
                           stream_layers=streamed,
                           offload=[r, off2, plain2],
                           streamed=[st, st2, off2_adam]), f, indent=1)
    if not ok:
        print("zero_multicard: an offload check failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "model": "llama13b", "world": world,
                      "offload": True}))
    return 0


# --onebit: (name, optimizer), both at ZeRO 0
ONEBIT_RUNS = (
    ("onebitadam", {"type": "onebitadam",
                    "params": {"lr": 1e-4, "freeze_step": 10}}),
    ("fusedadam", {"type": "fusedadam", "params": {"lr": 1e-4}}),
)
ONEBIT_STEPS = 30


def _sent_bytes(summary):
    """{op: message bytes} of the comms logger's summary."""
    return {k: v["total_msg_bytes"] for k, v in summary["ops"].items()}


def run_onebit_rank(args):
    """``--onebit``: GPT-2 350M in fp16 with OnebitAdam and with FusedAdam
    at ZeRO 0, the same weights and batches (module docstring)."""
    import numpy as np
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.runtime.comm import compressed
    cpu = args.device == "cpu"
    sync = (lambda: None) if cpu else torch.cuda.synchronize
    rows = []
    for name, opt in ONEBIT_RUNS:
        model, cfg, S = _model("gpt2", cpu)
        config = dict(_config("gpt2", 0), optimizer=opt)
        engine = deepspeed_tpu_torch.initialize(
            model=model, config=config, device="cpu" if cpu else None)[0]
        engine.initialize_parameters(args.seed)
        world = engine.dp_world_size
        B = engine.train_micro_batch_size_per_gpu() * world
        rng = np.random.default_rng(args.seed + 1)
        batches = [engine.shard_batch(rng.integers(
            0, cfg.vocab_size, size=(B, S)))[0] for _ in range(4)]
        losses, times, sent, skipped = [], [], [], []
        comm.comms_logger.reset()
        before = {}
        for i in range(ONEBIT_STEPS):
            ids = batches[i % len(batches)]
            sync()
            t = time.perf_counter()
            loss = engine(ids, ids)
            engine.backward(loss)
            engine.step()
            losses.append(loss.item())
            sync()
            times.append(time.perf_counter() - t)
            skipped.append(bool(engine._last_skipped))
            now = _sent_bytes(comm.comms_logger.get_summary_dict())
            sent.append({k: v - before.get(k, 0) for k, v in now.items()
                         if v - before.get(k, 0)})
            before = now
        onebit = getattr(engine, "_onebit", False)
        leaves = [k for _, k in engine.opt_state.leaves] if onebit else []
        mine = torch.tensor(losses, device="cpu" if cpu else "cuda")
        every = comm.all_gather(mine, tiled=False).cpu()
        rows.append(dict(
            name=name, world=world, losses=losses, skipped=skipped,
            step_ms=[t * 1e3 for t in times],
            freeze_step=opt["params"].get("freeze_step"),
            msg_bytes_by_step=sent,
            # what a ring sends a rank: the 1-bit scheme (its formula) or
            # the all-reduce of the fp32 accumulator
            ring_bytes_compressed=compressed.wire_bytes(leaves, world),
            ring_bytes_dense_fp32=2 * (world - 1) / world * 4 *
            int(engine.grad_acc.numel()),
            numel=int(engine.grad_acc.numel()),
            rank_losses_equal=bool((every == every[0]).all())))
        del engine, model
        gc.collect()
        if not cpu:
            torch.cuda.empty_cache()
    if comm.get_rank() == 0:
        with open(args.out_rank0, "w") as f:
            json.dump(rows, f)
    comm.destroy_process_group()


def _onebit_main(args, world, smi, out):
    rcs = _spawn(world, sys.argv[1:] + ["--out-rank0", out])
    if any(rcs):
        print(f"zero_multicard: ranks exited {rcs}", file=sys.stderr)
        return 1
    with open(out) as f:
        rows = {r["name"]: r for r in json.load(f)}
    os.remove(out)
    ob, dense = rows["onebitadam"], rows["fusedadam"]
    k = ob["freeze_step"]
    ok = True
    for r in rows.values():
        phases = ((("warmup", 1, k), ("compressed", k, ONEBIT_STEPS))
                  if r is ob else (("all", 1, ONEBIT_STEPS), ))
        for phase, a, b in phases:
            ms = r["step_ms"][a:b]
            sent = [sum(x.values()) for x in r["msg_bytes_by_step"][a:b]]
            by_op = {}
            for x in r["msg_bytes_by_step"][a:b]:
                for op, v in x.items():
                    by_op[op] = by_op.get(op, 0) + v / len(ms)
            print(f"[onebit] {r['name']}, GPT-2 350M fp16, world "
                  f"{r['world']}, ZeRO 0, {phase} steps {a + 1}-{b}: step ms "
                  f"mean {sum(ms) / len(ms):.1f} (min {min(ms):.1f}, max "
                  f"{max(ms):.1f}) | comms-logger message MB a step "
                  f"{sum(sent) / len(sent) / 1e6:.2f}: " + ", ".join(
                      f"{op} {v / 1e6:.2f}" for op, v in sorted(
                          by_op.items())) + f" | {smi}", flush=True)
        ok &= r["rank_losses_equal"] and all(map(math.isfinite,
                                                 r["losses"]))
    gap = abs(ob["losses"][-1] - dense["losses"][-1]) / abs(
        dense["losses"][-1])
    ratio = ob["ring_bytes_compressed"] / dense["ring_bytes_dense_fp32"]
    print(f"[onebit] a rank's ring bytes a step: compressed "
          f"{ob['ring_bytes_compressed'] / 1e6:.2f} MB against the fp32 "
          f"all-reduce's {dense['ring_bytes_dense_fp32'] / 1e6:.2f} MB "
          f"({ratio:.4f}; 1/32 is {1 / 32:.4f}, of an fp16 all-reduce "
          f"{2 * ratio:.4f}) | losses onebitadam " + ", ".join(
              f"{x:.4f}" for x in ob["losses"]) + " | fusedadam " +
          ", ".join(f"{x:.4f}" for x in dense["losses"])
          + f" | final-loss gap {gap:.4f} relative | skipped "
          f"{sum(ob['skipped'])} and {sum(dense['skipped'])} | {smi}",
          flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(card=smi, runs=list(rows.values()),
                           final_loss_gap=gap, wire_ratio=ratio), f,
                      indent=1)
    if not ok:
        print("zero_multicard: a 1-bit check failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "model": "gpt2", "world": world,
                      "onebit": True}))
    return 0


# ------------------------------------------------------------------ --moe
MOE_HIDDEN, MOE_EXPERTS, MOE_K, MOE_CF = 4096, 8, 2, 1.25
MOE_TOKENS = 8192          # a rank's rows a step
MOE_RUNS = (("dp4", 1, None), ("ep4", 4, None), ("dp2ep2", 2, None),
            ("ep4_int8", 4, "int8"), ("ep4_int8_2hop", 4, "int8"))
MIXTRAL_LAYERS = 6         # of 32: plain ZeRO 3 at dp 4 (8 would not
                           # leave room for a gathered layer's gradients)
MIXTRAL_SPLIT_LAYERS = 8   # ep 4, tp 4, tp 2 × ep 2: a rank holds 1/4 of
                           # each layer's experts (PERF.md §6's estimate)
MIXTRAL_LOSS_CHUNK = 4000  # the fused chunked head + loss: at tp 4 a rank's
                           # 32768 tokens' whole-vocabulary fp32 logits
                           # (3.9 GiB) did not fit beside 8 layers


def _mixtral_legs(args, cpu):
    """(name, layers, mesh) of (ii): ZeRO 3 at dp 4 and ep 4 at the plain
    depth, then ep 4, tp 4 and tp 2 × ep 2 at the split depth, and ep 4
    there again on the batch's rows rotated over the data ranks
    (``_rot``)."""
    base = 2 if cpu else MIXTRAL_LAYERS
    deep = 3 if cpu else MIXTRAL_SPLIT_LAYERS
    return (("dp4", base, {}), ("ep4", base, {"ep": 4}),
            ("ep4_deep", deep, {"ep": 4}), ("tp4_deep", deep, {"tp": 4}),
            ("tp2ep2_deep", deep, {"tp": 2, "ep": 2}),
            ("ep4_deep_rot", deep, {"ep": 4}))


def moe_layer_model(torch, D, seed, device="cuda", dtype="bfloat16"):
    """The MoE tests' model (``tests/unit/moe/test_moe.py:53``: in_proj,
    a residual ``MoE``, out_proj; MSE plus 0.01 × the aux loss) at hidden
    ``D``: 8 ``ExpertFFN`` experts of 4·D, top-2, capacity factor 1.25,
    computing in ``dtype``.  Returns (model, fp32 weights from ``seed``:
    kernels normal / sqrt(fan in), biases zero)."""
    from deepspeed_tpu_torch.moe import MoE
    from deepspeed_tpu_torch.moe.experts import Dense

    class MoEModel(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.in_proj = Dense(D, D, dtype=dtype, device="meta")
            self.moe = MoE(D, num_experts=MOE_EXPERTS, k=MOE_K,
                           capacity_factor=MOE_CF, dtype=dtype,
                           device="meta")
            self.out_proj = Dense(D, D, dtype=dtype, device="meta")

        def forward(self, x, y):
            h = self.in_proj(x)
            moe_out, l_aux, _ = self.moe(h)
            out = self.out_proj(h + moe_out)
            return torch.mean((out.float() - y) ** 2) + 0.01 * l_aux

    model = MoEModel()
    gen = torch.Generator(device=device).manual_seed(seed)
    start = {}
    for name, p in model.named_parameters():
        t = torch.zeros(p.shape, dtype=torch.float32, device=device)
        if p.dim() >= 2:
            t.normal_(0.0, p.shape[-2] ** -0.5, generator=gen)
        start[name] = t
    return model, start


def _exchange_bytes(E, C, D, dtype_bytes, ep):
    """(bytes of one dispatch or return exchange as they go on the wire:
    the [E, C, D] buffer at its own element size on the flat rung, the
    codes and scales on a quantized one; 0 at ep 1, where nothing is
    exchanged), (JAX ``expert_dispatch_wire_bytes``'s figure, 4 bytes an
    element on the flat rung)."""
    from deepspeed_tpu_torch.comm.collectives import quantized as Q
    from deepspeed_tpu_torch.moe import engine as moe_engine
    wire, gs, _, jax_formula = moe_engine.exchange_plan(E, C, D)
    if ep <= 1:
        return 0, jax_formula
    n = E * C * D
    moved = n * dtype_bytes if wire == Q.LADDER_FP else \
        Q.quantized_wire_bytes(n, wire, gs)
    return moved, jax_formula


def _exchange_ms(torch, E, C, D, dtype, reps=5):
    """One forward dispatch (reduce-scatter over ep) and return
    (all-gather) of an [E, C, D] buffer, timed alone with CUDA events."""
    from deepspeed_tpu_torch.moe import engine as moe_engine
    ep_group = moe_engine._ep_group()
    if ep_group is None:
        return 0.0
    wire, gs, split, _ = moe_engine.exchange_plan(E, C, D)
    buf = torch.randn(E, C, D, device="cuda").to(dtype)
    hier = moe_engine.ep_hierarchy(split=split) if split else None

    def once():
        local = moe_engine._Exchange.apply(buf, ep_group, wire, gs, hier)
        moe_engine._Collect.apply(local, ep_group, wire, gs, hier)

    once()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        once()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def run_moe_rank(args):
    """``--moe``: (i) the MoE layer at ep 1, 4 and 2 (and ep 4 with the
    int8 dispatch) on the same global batch; (ii) Mixtral-8x7B width at
    ZeRO 3 (module docstring)."""
    import numpy as np
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.moe.utils import is_moe_param
    from deepspeed_tpu_torch.utils import groups
    cpu = args.device == "cpu"
    dev = "cpu" if cpu else "cuda"
    sync = (lambda: None) if cpu else torch.cuda.synchronize
    D = 64 if cpu else MOE_HIDDEN
    T = 64 if cpu else MOE_TOKENS
    out = dict(layer=[], mixtral=None)
    for name, ep, wire in MOE_RUNS:
        model, start = moe_layer_model(torch, D, args.seed, device=dev,
                                       dtype="float32" if cpu else
                                       "bfloat16")
        moe = {"enabled": True}
        if wire:
            moe.update(quantized_dispatch=True, wire_dtype=wire)
        if name.endswith("2hop"):
            moe["intra_node_size"] = 2
        config = {"train_micro_batch_size_per_gpu": T,
                  "optimizer": ADAM, "zero_optimization": {"stage": 2},
                  "mesh": {"dp": -1, "ep": ep}, "moe": moe}
        if not cpu:
            config["bf16"] = {"enabled": True}
        engine = deepspeed_tpu_torch.initialize(
            model=model, model_parameters=start, config=config,
            device=dev if cpu else None)[0]
        del start
        world = engine.dp_world_size
        rng = np.random.default_rng(args.seed + 1)
        x = torch.from_numpy(rng.standard_normal((T * world, D)).astype(
            np.float32))
        batch = engine.shard_batch(x, torch.tanh(x * 0.5))
        if not cpu:
            torch.cuda.reset_peak_memory_stats()
        losses, times = [], []
        for _ in range(1 + args.steps):
            sync()
            t = time.perf_counter()
            loss = engine(*batch)
            engine.backward(loss)
            engine.step()
            losses.append(loss.item())
            sync()
            times.append(time.perf_counter() - t)
        C = max(int(T * world * MOE_K * MOE_CF / MOE_EXPERTS), 4)
        ep_now = groups._get_expert_parallel_world_size()
        wire_bytes, jax_bytes = _exchange_bytes(
            MOE_EXPERTS, C, D, 4 if cpu else 2, ep_now)
        ex_ms = 0.0 if cpu else _exchange_ms(torch, MOE_EXPERTS, C, D,
                                             torch.bfloat16)
        from deepspeed_tpu_torch.moe import engine as moe_engine
        two_hop = moe_engine.ep_hierarchy() is not None
        peak = 0 if cpu else torch.cuda.max_memory_allocated()
        mine = torch.tensor(losses + [peak], dtype=torch.float64,
                            device=dev)
        every = comm.all_gather(mine, tiled=False).cpu()
        out["layer"].append(dict(
            name=name, ep=ep_now, world=world, wire=wire or "flat",
            two_hop=two_hop,
            losses=losses, step_ms=[t * 1e3 for t in times[1:]],
            exchange_wire_bytes=wire_bytes,
            exchange_bytes_jax_formula=jax_bytes, exchange_ms=ex_ms,
            expert_state_elems=sum(
                k for _, k, _, i in engine.zero_plan.pieces(engine._layout)
                if is_moe_param(engine._layout[i][0])),
            shard_elems=engine.zero_plan.shard_numel,
            peak_bytes_by_rank=[int(v) for v in every[:, -1].tolist()],
            rank_losses_equal=bool((every[:, :-1] == every[0, :-1]).all())))
        del engine, model, batch
        gc.collect()
        if not cpu:
            torch.cuda.empty_cache()
    out["mixtral"] = []
    for name, layers, mesh in _mixtral_legs(args, cpu):
        if comm.get_rank() == 0:
            print(f"[moe] Mixtral leg {name} ({layers} layers, mesh {mesh})"
                  " starts", flush=True)
        out["mixtral"].append(_moe_mixtral(args, torch, np, cpu, dev, sync,
                                           name, layers, mesh))
        if comm.get_rank() == 0:
            # kept in the output should a later leg fail
            print("[moe] leg " + json.dumps(out["mixtral"][-1]), flush=True)
    if comm.get_rank() == 0:
        with open(args.out_rank0, "w") as f:
            json.dump(out, f)
    comm.destroy_process_group()


def _mixtral_exchange_ms(torch, engine, T, D, k, reps=5):
    """One layer's forward exchange alone (the gather of the tokens and of
    the routing, the reduce-scatter of the outputs), timed with CUDA
    events; 0 where the model has no ep group."""
    from deepspeed_tpu_torch.comm.functional import all_gather, \
        reduce_scatter
    block = engine.module.model.layers[0].block_sparse_moe
    group = block.ep_group
    if group is None or group.size() == 1:
        return 0.0
    x = torch.randn(T, D, device="cuda").to(torch.bfloat16)
    meta = torch.randn(T, 2 * k, device="cuda")
    out = torch.randn(group.size() * T, D, device="cuda").to(torch.bfloat16)

    def once():
        all_gather(x, group, 0)
        all_gather(meta, group, 0)
        reduce_scatter(out, group, 0)

    once()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        once()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _moe_mixtral(args, torch, np, cpu, dev, sync, name, layers, mesh,
                 zero=None):
    """(ii): one leg at Mixtral-8x7B width (``mesh``: the config's
    ``mesh``; ``tp`` legs take ``mixtral.tp_rules``), ``layers`` of 32,
    ZeRO 3 with ``overlap_comm`` (``zero``: another block), bf16, remat,
    the fused chunked head + loss (``MIXTRAL_LOSS_CHUNK`` columns),
    ``fusedadam``, one global batch of 16 rows of 2048 (4 a rank at dp or
    ep 4, 16 at tp 4, 8 at tp 2 × ep 2; a ``_rot`` leg gives data rank r
    the rows of rank r + 1: the same loss, summed in another order).  Also
    the exchange's bytes
    and ms a layer's forward, each rank's routed rows at step 1, whether
    every tp rank routed alike at step 1, and B7's launches by route."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models import mixtral
    from deepspeed_tpu_torch.ops.kernels import grouped_matmul as gm
    from deepspeed_tpu_torch.utils import groups
    if cpu:
        cfg = mixtral.mixtral_tiny(dtype="float32", num_hidden_layers=layers,
                                   loss_chunk_vocab=32)
        rows, S = 8, 32
    else:
        cfg = mixtral.MixtralConfig(
            vocab_size=32000, hidden_size=4096, intermediate_size=14336,
            num_hidden_layers=layers, num_attention_heads=32,
            num_key_value_heads=8, max_position_embeddings=4096,
            rope_theta=1e6, num_local_experts=8, num_experts_per_tok=2,
            dtype="bfloat16", head_dtype="bfloat16", remat=True,
            loss_chunk_vocab=MIXTRAL_LOSS_CHUNK)
        rows, S = 16, 2048
    config = {"train_batch_size": rows, "optimizer": ADAM,
              "zero_optimization": dict(zero or ZERO3),
              "mesh": dict(mesh)}
    if not cpu:
        config["bf16"] = {"enabled": True}
    tp = mesh.get("tp", 1)
    engine = deepspeed_tpu_torch.initialize(
        model=mixtral.MixtralModel(cfg, device="meta"), config=config,
        device=dev if cpu else None,
        tp_rules=mixtral.tp_rules(cfg) if tp > 1 else None)[0]
    engine.initialize_parameters(args.seed)
    data = engine.dp_world_size
    world = comm.get_world_size()
    B = rows // data
    rng = np.random.default_rng(args.seed + 2)
    ids = rng.integers(0, cfg.vocab_size, size=(rows, S))
    if name.endswith("_rot"):
        ids = np.roll(ids, -B, axis=0)
    ids = engine.shard_batch(ids)[0]
    if not cpu:
        torch.cuda.reset_peak_memory_stats()
    for fn in (gm.gmm, gm.gmm_dx, gm.gmm_dw):
        fn.route_launches = dict.fromkeys(fn.route_launches, 0)
    losses, times = [], []
    rows = routed_alike = None
    for i in range(1 + args.steps):
        sync()
        t = time.perf_counter()
        loss = engine(ids, ids)
        if i == 0:
            blocks = [m.block_sparse_moe for m in engine.module.model.layers]
            rows = [int(b.routed_rows.sum()) for b in blocks]
            k = cfg.num_experts_per_tok
            topi = torch.stack([torch.topk(b.router_logits, k, dim=-1)
                                .indices for b in blocks])
            tpg = groups._get_tensor_parallel_group().as_flat()
            every = comm.all_gather(topi, group=tpg, tiled=False) \
                if tp > 1 else topi[None]
            routed_alike = bool((every == every[0]).all())
        engine.backward(loss)
        engine.step()
        losses.append(loss.item())
        sync()
        times.append(time.perf_counter() - t)
    routes = {fn.__name__: {r: n for r, n in fn.route_launches.items()
                            if n} for fn in (gm.gmm, gm.gmm_dx, gm.gmm_dw)}
    L, D, I, E = (cfg.num_hidden_layers, cfg.hidden_size,
                  cfg.intermediate_size, cfg.num_local_experts)
    k = cfg.num_experts_per_tok
    n_total = mixtral.param_count(cfg)
    n_active = n_total - L * (E - k) * 3 * D * I
    step_s = sum(times[1:]) / len(times[1:])
    tok_s = B * S * data / step_s
    flops_tok = 6 * n_active + 12 * L * S * D
    ep = groups._get_expert_parallel_world_size() if world > 1 else 1
    T = B * S
    esz = 4 if cpu else 2
    # a layer's forward: the gathered tokens and routing in, the reduce-
    # scattered outputs out, (ep - 1) · T rows each way a rank
    ex_in = (ep - 1) * T * (D * esz + 2 * k * 4)
    ex_out = (ep - 1) * T * D * esz
    ex_ms = 0.0 if cpu else _mixtral_exchange_ms(torch, engine, T, D, k)
    peak = 0 if cpu else torch.cuda.max_memory_allocated()
    mine = torch.tensor(losses + [peak] + rows + [float(routed_alike)],
                        dtype=torch.float64, device=dev)
    every = comm.all_gather(mine, tiled=False).cpu()
    n = len(losses)
    row = dict(name=name, mesh=mesh, layers=L, world=world, data=data,
               rows=B, seq=S,
               n_params=n_total, n_active=n_active, losses=losses,
               step_ms=[t * 1e3 for t in times[1:]],
               step_ms_mean=step_s * 1e3, tokens_per_s=tok_s,
               mfu_active=tok_s * flops_tok / world / PEAK_FLOPS,
               flops_per_token=flops_tok,
               peak_bytes_by_rank=[int(v) for v in every[:, n].tolist()],
               routed_rows_by_rank=[[int(v) for v in r[n + 1:n + 1 + L]]
                                    for r in every.tolist()],
               tp_routed_alike=bool(every[:, -1].all()),
               exchange_bytes_in=ex_in, exchange_bytes_out=ex_out,
               exchange_ms=ex_ms, route_launches=routes,
               rank_losses_equal=bool((every[:, :n] ==
                                       every[0, :n]).all()))
    del engine
    gc.collect()
    if not cpu:
        torch.cuda.empty_cache()
    return row


def _moe_main(args, world, smi, out):
    rcs = _spawn(world, sys.argv[1:] + ["--out-rank0", out])
    if any(rcs):
        print(f"zero_multicard: ranks exited {rcs}", file=sys.stderr)
        return 1
    with open(out) as f:
        res = json.load(f)
    os.remove(out)
    runs = {r["name"]: r for r in res["layer"]}
    base = runs["dp4"]["losses"]
    ok = True
    for r in res["layer"]:
        diff = max(abs(a - b) / abs(b) for a, b in zip(r["losses"], base))
        r["max_rel_loss_diff_vs_dp4"] = diff
        gate = 1e-2 if r["wire"] != "flat" else 2.0**-7
        ok &= (r["rank_losses_equal"] and diff <= gate and
               all(map(math.isfinite, r["losses"])))
        if r["name"].endswith("2hop"):
            # the 2-hop exchange against the 1-hop one on the same wire
            one = runs["ep4_int8"]["losses"]
            r["max_rel_loss_diff_vs_1hop"] = hop = max(
                abs(a - b) / abs(b) for a, b in zip(r["losses"], one))
            ok &= r["two_hop"] and hop <= 1e-2
            print(f"[moe] {r['name']}: 2-hop taken {r['two_hop']}, largest "
                  f"relative loss difference from 1-hop int8 {hop:.3e} "
                  "(gate 1e-2)", flush=True)
        ms = r["step_ms"]
        print(f"[moe] MoE layer (hidden {MOE_HIDDEN}, {MOE_EXPERTS} experts "
              f"of 4×{MOE_HIDDEN}, top-{MOE_K}, cf {MOE_CF}, bf16, "
              f"{MOE_TOKENS} tokens a rank, ZeRO 2) {r['name']}: ep "
              f"{r['ep']} of world {r['world']}, wire {r['wire']} | losses "
              + ", ".join(f"{x:.5f}" for x in r["losses"])
              + f" | largest relative loss difference from dp 4 × ep 1 "
              f"{diff:.3e} (gate {gate:g}) | step ms mean "
              f"{sum(ms) / len(ms):.1f} | exchange "
              f"{2 * r['exchange_wire_bytes'] / 1e6:.2f} MB a forward on "
              f"the wire (dispatch + return; JAX's 4-byte-an-element "
              f"figure {2 * r['exchange_bytes_jax_formula'] / 1e6:.2f}), "
              f"{r['exchange_ms']:.3f} ms timed alone | expert state "
              f"{r['expert_state_elems'] / 1e6:.1f} M of the rank's "
              f"{r['shard_elems'] / 1e6:.1f} M master elements | peak "
              f"GiB by rank "
              + ", ".join(f"{b / 2**30:.2f}" for b in r["peak_bytes_by_rank"])
              + f" | {smi}", flush=True)
    legs = {m["name"]: m for m in res["mixtral"]}
    # equal depth: ep 4 against dp 4, and the split legs against one
    # another, within 2^-7 of the losses' scale (bf16 sums in other
    # orders; ep4_deep_rot is ep 4's own spread under another order)
    for names in (("dp4", "ep4"), ("ep4_deep", "tp4_deep", "tp2ep2_deep",
                                   "ep4_deep_rot")):
        ref = legs[names[0]]["losses"]
        scale = max(abs(x) for x in ref)
        for name in names[1:]:
            m = legs[name]
            m["loss_diff_by_step_vs_" + names[0]] = gaps = [
                abs(a - b) for a, b in zip(m["losses"], ref)]
            m["max_loss_diff_vs_" + names[0]] = diff = max(gaps)
            m["loss_gate"] = 2.0**-7 * scale
            ok &= diff <= m["loss_gate"]
    for m in res["mixtral"]:
        ok &= (m["rank_losses_equal"] and m["tp_routed_alike"] and
               all(map(math.isfinite, m["losses"])))
        gap = next((f" | loss differences from {k[len('max_loss_diff_vs_'):]} "
                    f"by step " + ", ".join(
                        f"{d:.3e}" for d in
                        m["loss_diff_by_step_vs_"
                          + k[len("max_loss_diff_vs_"):]])
                    + f", largest {v:.3e} (gate {m['loss_gate']:.3e})"
                    for k, v in m.items() if k.startswith("max_loss_diff")),
                   "")
        print(f"[moe] Mixtral-8x7B width {m['name']} (mesh {m['mesh']}), "
              f"{m['layers']} of 32 layers ({m['n_params'] / 1e9:.2f} G "
              f"elements, {m['n_active'] / 1e9:.2f} G active a token), "
              f"ZeRO 3 overlap_comm, bf16, remat, fusedadam, world "
              f"{m['world']} ({m['data']} data ranks), {m['rows']} × "
              f"{m['seq']} tokens a data rank: losses "
              + ", ".join(f"{x:.4f}" for x in m["losses"]) + gap
              + f" | step ms mean {m['step_ms_mean']:.1f}, "
              f"{m['tokens_per_s']:.1f} tokens/s over the world, MFU "
              f"{m['mfu_active']:.4f} on the active parameters (6·N_active "
              f"+ 12·L·S·D a token, 989 TFLOP/s a card) | peak GiB by rank "
              + ", ".join(f"{b / 2**30:.2f}" for b in m["peak_bytes_by_rank"])
              + f" | exchange a layer's forward {m['exchange_bytes_in'] / 2**20:.1f}"
              f" MiB in, {m['exchange_bytes_out'] / 2**20:.1f} MiB out, "
              f"{m['exchange_ms']:.3f} ms timed alone | routed rows at step "
              f"1 by rank (a layer each) {m['routed_rows_by_rank']} | tp "
              f"ranks routed alike {m['tp_routed_alike']} | B7 launches by "
              f"route {m['route_launches']} | {smi}", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(card=smi, **res), f, indent=1)
    if not ok:
        print("zero_multicard: a MoE check failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "world": world, "moe": True}))
    return 0


TP_SERVE = dict(
    dtype="bfloat16", decode_burst=16,
    state_manager=dict(block_size=128, num_blocks=160, max_context=4096,
                       max_ragged_sequence_count=16, max_tracked_sequences=16,
                       max_ragged_batch_size=768, prefill_atom_size=16))
TINY_HF = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
               num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=4, max_position_embeddings=4096)
TP_LOGIT_GATE = 2.0**-3
# fp32 at tp 4 against fp32 at tp 1: the same products, the row-parallel
# ones' partial sums added in another order
TP_FP32_GATE = 1e-3


def _tp_serve_runs():
    """(name, HF config, layers, prompts) of (a), (b) and (c)'s parity
    run, on ``chip_smoke.py``'s configs (Mistral-7B: Llama-2-7B's with
    its FFN, GQA 32/8 and window)."""
    from chip_smoke import LLAMA2_7B_HF, MIXTRAL_8X7B_HF
    mistral = dict(LLAMA2_7B_HF, model_type="mistral",
                   intermediate_size=14336, num_key_value_heads=8,
                   max_position_embeddings=32768, sliding_window=4096)
    return (("llama7b", LLAMA2_7B_HF, 32, 8), ("mistral7b", mistral, 32, 8),
            ("mixtral8x7b_8l", MIXTRAL_8X7B_HF, 8, 8))


class _SeededCheckpoint:
    """HF-named weights drawn on ``device`` leaf by leaf: leaf i from a
    generator seeded with (seed, i), in fp32, rounded to bf16 and handed
    over in ``dtype`` (so the bf16 and fp32 runs hold the same values),
    whole (the loader keeps this rank's slice and frees the rest)."""

    def __init__(self, hf, seed, device, dtype, std=0.02):
        self.model_config = hf
        self._seed, self._device, self._dtype = seed, device, dtype
        self._std = std

    def parameters(self):
        import torch
        from chip_smoke import _hf_shapes
        for i, (name, shape) in enumerate(_hf_shapes(self.model_config)):
            t = torch.empty(shape, dtype=torch.float32,
                            device=self._device)
            if name.endswith("norm.weight"):
                t.fill_(1.0)
            else:
                gen = torch.Generator(device=self._device).manual_seed(
                    self._seed * 1_000_003 + i)
                t.normal_(0.0, self._std, generator=gen)
            yield name, t.to(torch.bfloat16).to(self._dtype)


def _tp_prompts(seed, cpu):
    import numpy as np
    rng = np.random.default_rng(seed)
    lo, hi, vocab = (8, 33, 256) if cpu else (128, 2049, 32000)
    lengths = rng.integers(lo, hi, size=8).tolist()
    return [rng.integers(0, vocab, size=n).tolist() for n in lengths]


def _tp_serve(torch, hf, tp, prompts, new_tokens, seed, cpu, sync,
              fp32=False):
    """One serving run at ``tp`` (bf16, or ``fp32``): tokens, the first
    step's logits, rates, TTFT, peak memory and B4's and B7's launches on
    this rank."""
    from deepspeed_tpu_torch.inference.v2 import build_engine_from_checkpoint
    from deepspeed_tpu_torch.ops.kernels import grouped_matmul as gm
    from deepspeed_tpu_torch.ops.kernels import paged_attention as pa
    dev = "cpu" if cpu else "cuda"
    dtype = torch.float32 if cpu or fp32 else torch.bfloat16
    config = dict(TP_SERVE, tensor_parallel=dict(tp_size=tp),
                  dtype=str(dtype).split(".")[-1])
    if cpu:
        config = dict(config, state_manager=dict(
            TP_SERVE["state_manager"], block_size=16, max_context=256,
            max_ragged_batch_size=64, num_blocks=160))
    if not cpu:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = build_engine_from_checkpoint(
        _SeededCheckpoint(hf, seed, dev, dtype), hf, config,
        device=dev if cpu else None)
    sync()
    build_s = time.perf_counter() - t0
    first = []
    step_fn = eng._step_fn

    def probed(*args, **kwargs):
        logits, kv = step_fn(*args, **kwargs)
        if not first:
            first.append(logits.float().clone())
        return logits, kv

    eng._step_fn = probed
    first_token = {}
    schedule = eng.schedule_step

    def timed_schedule(*args, **kwargs):
        out = schedule(*args, **kwargs)
        now = time.perf_counter()
        for uid in out:
            first_token.setdefault(uid, now)
        return out

    eng.schedule_step = timed_schedule
    for fn in (pa.paged_attention, pa.paged_attention_atoms, gm.gmm):
        fn.launches = 0
    sync()
    start = time.perf_counter()
    outs = eng.generate(prompts, max_new_tokens=new_tokens)
    sync()
    wall = time.perf_counter() - start
    ttft = [first_token[u] - start for u in range(len(prompts))]
    n_gen = sum(len(o) for o in outs)
    prefill_end = max(ttft)
    row = dict(outs=outs, logits=first[0], build_s=build_s, wall_s=wall,
               prefill_tok_s=sum(map(len, prompts)) / prefill_end,
               decode_tok_s=(n_gen - len(prompts)) / max(
                   wall - prefill_end, 1e-9),
               ttft_mean_s=sum(ttft) / len(ttft), ttft_max_s=prefill_end,
               peak=0 if cpu else torch.cuda.max_memory_allocated(),
               b4=pa.paged_attention.launches +
               pa.paged_attention_atoms.launches, b7=gm.gmm.launches,
               finite=bool(torch.isfinite(first[0]).all()))
    del eng
    gc.collect()
    if not cpu:
        torch.cuda.empty_cache()
    return row


def _tp_gathered(torch, comm, dev, values):
    """Every rank's list of numbers, as [world, n] on the host."""
    t = torch.tensor(values, dtype=torch.float64, device=dev)
    return comm.all_gather(t, tiled=False).cpu()


def _tp_first_diff(x, y):
    """How many greedy tokens match before the first that differs, a
    prompt."""
    return [next((i for i, (a, b) in enumerate(zip(p, q)) if a != b),
                 len(p)) for p, q in zip(x, y)]


def _tp_serving_legs(args, torch, comm, cpu, dev, sync):
    """(a), (b), (c): each serving run at tp 1 (every rank alone) and at
    tp 4, in bf16 and in fp32, compared on rank 0."""
    out = []
    prompts = _tp_prompts(args.seed, cpu)
    world = comm.get_world_size()
    for name, hf, layers, n_prompts in _tp_serve_runs():
        hf = dict(TINY_HF if cpu else hf, num_hidden_layers=2 if cpu else
                  layers, model_type=hf["model_type"])
        if hf["model_type"] == "mixtral" and cpu:
            hf.update(num_local_experts=4, num_experts_per_tok=2)
        if hf["model_type"] == "mistral" and cpu:
            hf.update(num_key_value_heads=8 if not cpu else 4,
                      sliding_window=16)
        new = 8 if cpu else 64
        one = _tp_serve(torch, hf, 1, prompts[:n_prompts], new, args.seed,
                        cpu, sync)
        many = _tp_serve(torch, hf, world, prompts[:n_prompts], new,
                         args.seed, cpu, sync)
        # the same weights in fp32: what tp changes without bf16's
        # roundings, and how far bf16 itself sits from fp32
        one32 = _tp_serve(torch, hf, 1, prompts[:n_prompts], new,
                          args.seed, cpu, sync, fp32=True)
        many32 = _tp_serve(torch, hf, world, prompts[:n_prompts], new,
                           args.seed, cpu, sync, fp32=True)
        diff = (one["logits"] - many["logits"]).abs().max().item()
        match = _tp_first_diff(one["outs"], many["outs"])
        fp32 = dict(
            logit_max_abs_diff=(one32["logits"] -
                                many32["logits"]).abs().max().item(),
            tokens_matching=_tp_first_diff(one32["outs"], many32["outs"]),
            bf16_tp1_vs_fp32=(one["logits"] -
                              one32["logits"]).abs().max().item(),
            bf16_tpn_vs_fp32=(many["logits"] -
                              one32["logits"]).abs().max().item(),
            bf16_tp1_tokens_matching_fp32=_tp_first_diff(one32["outs"],
                                                         one["outs"]),
            tp1={k: v for k, v in one32.items() if k not in ("outs",
                                                             "logits")},
            tpn={k: v for k, v in many32.items() if k not in ("outs",
                                                              "logits")})
        toks = torch.tensor(sum(many["outs"], []), dtype=torch.float64,
                            device=dev)
        every = comm.all_gather(toks, tiled=False).cpu()
        stats = _tp_gathered(torch, comm, dev, [many["peak"], many["b4"],
                                                many["b7"]])
        out.append(dict(
            name=name, layers=hf["num_hidden_layers"], tp=world,
            prompts=n_prompts, new_tokens=new, logit_max_abs_diff=diff,
            logit_max_abs_tp1=one["logits"].abs().max().item(),
            tokens_matching=match,
            first_tokens_equal=all(m > 0 for m in match),
            ranks_agree=bool((every == every[0]).all()),
            finite=one["finite"] and many["finite"],
            tp1={k: v for k, v in one.items() if k not in ("outs",
                                                           "logits")},
            tpn={k: v for k, v in many.items() if k not in ("outs",
                                                            "logits")},
            fp32=fp32,
            peak_bytes_by_rank=[int(v) for v in stats[:, 0].tolist()],
            b4_launches_by_rank=[int(v) for v in stats[:, 1].tolist()],
            b7_launches_by_rank=[int(v) for v in stats[:, 2].tolist()]))
    if not cpu:
        # (c) at full depth: 93.4 GB in bf16, a quarter a rank
        hf = dict(_tp_serve_runs()[2][1], num_hidden_layers=32)
        many = _tp_serve(torch, hf, world, prompts[:4], 64, args.seed, cpu,
                         sync)
        stats = _tp_gathered(torch, comm, dev, [many["peak"], many["b4"],
                                                many["b7"]])
        out.append(dict(
            name="mixtral8x7b_full", layers=32, tp=world, prompts=4,
            new_tokens=64, finite=many["finite"],
            tpn={k: v for k, v in many.items() if k not in ("outs",
                                                            "logits")},
            peak_bytes_by_rank=[int(v) for v in stats[:, 0].tolist()],
            b4_launches_by_rank=[int(v) for v in stats[:, 1].tolist()],
            b7_launches_by_rank=[int(v) for v in stats[:, 2].tolist()]))
    return out


def _tp_train_config(stage, tp, rows, cpu):
    config = {"train_micro_batch_size_per_gpu": rows, "optimizer": ADAM,
              "zero_optimization": dict(ZERO3) if stage == 3
              else {"stage": stage}, "mesh": {"tp": tp}}
    if not cpu:
        config["bf16"] = {"enabled": True}
    return config


def _tp_train_run(torch, np, args, cpu, dev, sync, tp, stage, layers, rows,
                  steps, global_rows=None, sp=1, seq=None, domino=False):
    """One training run: the engine from the seed, ``steps`` steps (the
    first a warm-up) on one global batch; losses, step ms, peak.  ``sp``
    > 1: Ulysses over ``sp`` ranks, each its chunk of the ``seq`` tokens;
    ``domino``: two µ-streams, and the overlap report of one forward of
    each form (``runtime/domino``)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.models import llama
    S = seq or (64 if cpu else 2048)
    cfg = (llama.llama_tiny(dtype="bfloat16", max_position_embeddings=S,
                            num_hidden_layers=layers, num_key_value_heads=4,
                            use_ulysses=sp > 1)
           if cpu else llama.llama_7b(num_hidden_layers=layers,
                                      head_dtype="bfloat16", remat=True,
                                      max_position_embeddings=max(S, 4096),
                                      use_ulysses=sp > 1))
    if not cpu:
        torch.cuda.reset_peak_memory_stats()
    config = _tp_train_config(stage, tp, rows, cpu)
    if sp > 1:
        config["mesh"]["sp"] = sp
    if domino:
        config["domino"] = {"enabled": True, "n_streams": 2}
    engine = deepspeed_tpu_torch.initialize(
        model=llama.LlamaModel(cfg, device="meta"), config=config,
        device=dev if cpu else None, tp_rules=llama.tp_rules(cfg))[0]
    engine.initialize_parameters(args.seed)
    total = global_rows or rows * engine.dp_world_size
    rng = np.random.default_rng(args.seed + 5)
    ids = engine.shard_batch(rng.integers(0, cfg.vocab_size,
                                          size=(total, S)))[0]
    overlap = None
    if tp > 1 and getattr(args, "domino", False):
        from deepspeed_tpu_torch.runtime.domino import (measure_tp_overlap,
                                                        split_microstreams)
        fn = split_microstreams(engine.module, 2) if domino else \
            engine.module
        with torch.no_grad():
            # a first call builds and warms up, the second is traced
            fn(ids, labels=ids)
            overlap = measure_tp_overlap(fn, ids, labels=ids)
    counters = _tp_train_counters()
    for fn in counters:
        fn.launches = 0
    losses, times = [], []
    for _ in range(steps):
        sync()
        t = time.perf_counter()
        loss = engine(ids, ids)
        engine.backward(loss)
        engine.step()
        losses.append(loss.item())
        sync()
        times.append(time.perf_counter() - t)
    step_s = sum(times[1:]) / max(len(times) - 1, 1)
    tok_s = total * S / step_s
    flops = 6 * llama.param_count(cfg) + 12 * layers * S * cfg.hidden_size
    world = comm.get_world_size()
    launches = [fn.launches / steps for fn in counters]
    stats = _tp_gathered(torch, comm, dev, losses + launches + [
        0 if cpu else torch.cuda.max_memory_allocated()])
    n = len(losses)
    row = dict(tp=tp, dp=engine.dp_world_size, sp=sp, seq=S,
               stage=stage, layers=layers, domino=bool(domino),
               overlap=overlap, rows_global=total, losses=losses,
               step_ms=[t * 1e3 for t in times[1:]],
               step_ms_mean=step_s * 1e3, tokens_per_s=tok_s,
               mfu=tok_s * flops / world / PEAK_FLOPS,
               peak_bytes_by_rank=[int(v) for v in stats[:, -1].tolist()],
               launches_a_step=dict(zip(
                   ("flash_fwd", "flash_dq", "flash_dkv", "adam"),
                   stats[0, n:n + len(counters)].tolist())),
               ranks_agree=bool((stats[:, :-1] == stats[0, :-1]).all()))
    del engine
    gc.collect()
    if not cpu:
        torch.cuda.empty_cache()
    return row


def _tp_train_counters():
    """B1's three kernels and B2: their wrappers, whose ``launches``
    count on the card."""
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.ops.kernels import optimizers as opt
    return (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
            fa.flash_attention_bwd_dkv, opt.fused_adam_step)


def _tp_digest(engine):
    """sha256 of the whole fp32 master, leaf by leaf in name order, at its
    global shapes (the same at any tp and dp; a collective)."""
    import hashlib
    flat = engine.fp32_params()
    h = hashlib.sha256()
    for name, off, n, _ in sorted(engine.global_layout()[0]):
        h.update(flat[off:off + n].float().cpu().numpy().tobytes())
    return h.hexdigest()


def _tp_checkpoint_leg(torch, np, args, cpu, dev, sync):
    """(e): a tp 2 × dp 2 ZeRO-3 tag at 4 layers, resumed at tp 4 and at
    tp 1 × dp 4."""
    import shutil
    import tempfile
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.models import llama
    layers, S = (2, 64) if cpu else (4, 2048)
    cfg = (llama.llama_tiny(dtype="bfloat16", max_position_embeddings=2048,
                            num_hidden_layers=layers, num_key_value_heads=4)
           if cpu else llama.llama_7b(num_hidden_layers=layers,
                                      head_dtype="bfloat16", remat=True))
    world = comm.get_world_size()
    rng = np.random.default_rng(args.seed + 7)
    batch = rng.integers(0, cfg.vocab_size, size=(16, S))
    root = tempfile.mkdtemp(prefix="zero_multicard_tp_") \
        if comm.get_rank() == 0 else None
    box = [root]
    import torch.distributed as tdist
    tdist.broadcast_object_list(box, src=0)
    root = box[0]

    def make(tp, stage):
        eng = deepspeed_tpu_torch.initialize(
            model=llama.LlamaModel(cfg, device="meta"),
            config=_tp_train_config(stage, tp, 16 // (world // tp), cpu),
            device=dev if cpu else None, tp_rules=llama.tp_rules(cfg))[0]
        return eng

    def step(eng):
        ids = eng.shard_batch(batch)[0]
        loss = eng(ids, ids)
        eng.backward(loss)
        eng.step()
        return loss.item()

    try:
        saver = make(2, 3)
        saver.initialize_parameters(args.seed)
        for _ in range(2):
            step(saver)
        sync()
        t = time.perf_counter()
        saver.save_checkpoint(root, tag="t")
        save_s = time.perf_counter() - t
        digest = _tp_digest(saver)
        nxt = step(saver)
        del saver
        gc.collect()
        rows = []
        for tp, stage in ((world, 1), (1, 0)):
            eng = make(tp, stage)
            sync()
            t = time.perf_counter()
            eng.load_checkpoint(root)
            load_s = time.perf_counter() - t
            same = _tp_digest(eng) == digest
            loss = step(eng)
            rows.append(dict(tp=tp, stage=stage, load_s=load_s,
                             digest_equal=same, next_loss=loss,
                             rel_diff=abs(loss - nxt) / abs(nxt)))
            del eng
            gc.collect()
            if not cpu:
                torch.cuda.empty_cache()
        nbytes = sum(os.path.getsize(os.path.join(dp, f))
                     for dp, _, fs in os.walk(root) for f in fs)
    finally:
        comm.barrier()
        if comm.get_rank() == 0:
            shutil.rmtree(root, ignore_errors=True)
    return dict(layers=layers, save_s=save_s, tag_bytes=nbytes,
                next_loss=nxt, resumed=rows)


def _tp_prebuild(comm):
    """The kernels of the tp paths built once, on rank 0 (one nvcc a
    source, started together), before anything is timed."""
    from deepspeed_tpu_torch.ops.op_builder import (FlashAttentionBuilder,
                                                    GroupedMatmulBuilder,
                                                    OptimizersBuilder,
                                                    PagedAttentionBuilder)
    if comm.get_rank() == 0:
        procs = [(b, b.start_build()) for b in (
            PagedAttentionBuilder(), GroupedMatmulBuilder(),
            FlashAttentionBuilder(), OptimizersBuilder())]
        for b, proc in procs:
            b.finish_build(proc)
    comm.barrier()


def run_tp_rank(args):
    """``--tp`` (module docstring)."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch import comm
    cpu = args.device == "cpu"
    dev = "cpu" if cpu else "cuda"
    sync = (lambda: None) if cpu else torch.cuda.synchronize
    comm.init_distributed(dist_backend="gloo" if cpu else "nccl",
                          verbose=False)
    if not cpu:
        _tp_prebuild(comm)
    world = comm.get_world_size()
    out = {}

    def record(key, value):
        # rank 0 rewrites the file after each leg: a later leg's failure
        # leaves the earlier legs' figures to print
        out[key] = value
        if comm.get_rank() == 0:
            with open(args.out_rank0, "w") as f:
                json.dump(out, f)

    record("serve", _tp_serving_legs(args, torch, comm, cpu, dev, sync))
    full, cut = (2, 2) if cpu else (32, 8)
    rows = 2 if cpu else 4
    record("train", [
        _tp_train_run(torch, np, args, cpu, dev, sync, tp, stage, full,
                      rows, 1 + args.steps)
        for tp, stage in ((2, 1), (2, 3), (world, 0))])
    record("parity", [
        _tp_train_run(torch, np, args, cpu, dev, sync, tp, 1, cut,
                      16 // (world // tp), 3, global_rows=16)
        for tp in (1, 2, world)])
    record("checkpoint", _tp_checkpoint_leg(torch, np, args, cpu, dev,
                                            sync))
    comm.destroy_process_group()


def _tp_main(args, world, smi, out):
    rcs = _spawn(world, sys.argv[1:] + ["--out-rank0", out])
    ok = not any(rcs)
    if not ok:
        print(f"zero_multicard: ranks exited {rcs}", file=sys.stderr)
    if not os.path.exists(out):
        return 1
    with open(out) as f:
        res = json.load(f)
    os.remove(out)
    for r in res.get("serve", []):
        gib = ", ".join(f"{b / 2**30:.2f}" for b in r["peak_bytes_by_rank"])
        t = r["tpn"]
        line = (f"[tp] serve {r['name']} ({r['layers']} layers) at tp "
                f"{r['tp']}, {r['prompts']} prompts × {r['new_tokens']} "
                f"tokens: prefill {t['prefill_tok_s']:.1f} tok/s, decode "
                f"{t['decode_tok_s']:.1f} tok/s, TTFT mean "
                f"{t['ttft_mean_s']:.3f} s max {t['ttft_max_s']:.3f} s, "
                f"build {t['build_s']:.1f} s | peak GiB by rank {gib} | B4 "
                f"launches by rank {r['b4_launches_by_rank']}, B7 "
                f"{r['b7_launches_by_rank']}")
        ok &= r["finite"]
        if "tp1" in r:
            o = r["tp1"]
            line += (f" | tp 1: prefill {o['prefill_tok_s']:.1f} tok/s, "
                     f"decode {o['decode_tok_s']:.1f} tok/s, peak "
                     f"{o['peak'] / 2**30:.2f} GiB | prefill logits max "
                     f"|tp {r['tp']} − tp 1| {r['logit_max_abs_diff']:.4e} "
                     f"(max |logit| {r['logit_max_abs_tp1']:.3f}; gate "
                     f"{TP_LOGIT_GATE:g}) | greedy tokens matching tp 1 "
                     f"before the first difference {r['tokens_matching']} "
                     f"of {r['new_tokens']} | ranks agree "
                     f"{r['ranks_agree']}")
            ok &= (r["ranks_agree"] and r["first_tokens_equal"] and
                   r["logit_max_abs_diff"] <= TP_LOGIT_GATE)
            f = r["fp32"]
            line += (f" | fp32, the same weights: max |tp {r['tp']} − tp 1| "
                     f"{f['logit_max_abs_diff']:.4e} (gate "
                     f"{TP_FP32_GATE:g}), tokens matching "
                     f"{f['tokens_matching']}; bf16 from fp32 at tp 1 "
                     f"{f['bf16_tp1_vs_fp32']:.4e} (tokens matching "
                     f"{f['bf16_tp1_tokens_matching_fp32']}), at tp "
                     f"{r['tp']} {f['bf16_tpn_vs_fp32']:.4e}; fp32 decode "
                     f"{f['tpn']['decode_tok_s']:.1f} tok/s at tp "
                     f"{r['tp']}, {f['tp1']['decode_tok_s']:.1f} at tp 1")
            ok &= f["logit_max_abs_diff"] <= TP_FP32_GATE
        print(line + f" | {smi}", flush=True)
    for r in res.get("train", []):
        ok &= r["ranks_agree"] and all(map(math.isfinite, r["losses"]))
        print(f"[tp] train Llama-2-7B width, {r['layers']} layers, tp "
              f"{r['tp']} × dp {r['dp']}, ZeRO {r['stage']}: losses "
              + ", ".join(f"{x:.4f}" for x in r["losses"])
              + f" | step ms mean {r['step_ms_mean']:.1f}, "
              f"{r['tokens_per_s']:.1f} tokens/s over the world, MFU "
              f"{r['mfu']:.4f} | peak GiB by rank " + ", ".join(
                  f"{b / 2**30:.2f}" for b in r["peak_bytes_by_rank"])
              + f" | launches a rank a step {r['launches_a_step']}"
              + f" | {smi}", flush=True)
    for r in res.get("parity", []):
        base = res["parity"][0]
        diff = max(abs(a - b) / abs(b)
                   for a, b in zip(r["losses"], base["losses"]))
        r["max_rel_loss_diff_vs_tp1"] = diff
        ok &= r["ranks_agree"] and diff <= 2.0**-7
        print(f"[tp] parity {r['layers']} layers, {r['rows_global']} rows, "
              f"ZeRO 1, tp {r['tp']} × dp {r['dp']}: losses " + ", ".join(
                  f"{x:.5f}" for x in r["losses"])
              + f" | largest relative loss difference from tp 1 × dp "
              f"{base['dp']} {diff:.3e} (gate 2^-7) | {smi}", flush=True)
    c = res.get("checkpoint", {"resumed": []})
    for r in c["resumed"]:
        ok &= r["digest_equal"] and r["rel_diff"] <= 2.0**-7
        print(f"[tp] checkpoint {c['layers']} layers: tp 2 × dp 2 ZeRO 3 "
              f"tag ({c['tag_bytes'] / 1e9:.2f} GB, saved in "
              f"{c['save_s']:.1f} s) loaded at tp {r['tp']} ZeRO "
              f"{r['stage']} in {r['load_s']:.1f} s: master digest equal "
              f"{r['digest_equal']}, next loss {r['next_loss']:.5f} against "
              f"the saver's {c['next_loss']:.5f} (relative "
              f"{r['rel_diff']:.2e}, gate 2^-7) | {smi}", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(card=smi, **res), f, indent=1)
    if not ok:
        print("zero_multicard: a tp check failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "world": world, "tp": True}))
    return 0


def run_domino_rank(args):
    """``--domino`` (module docstring)."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch import comm
    cpu = args.device == "cpu"
    dev = "cpu" if cpu else "cuda"
    sync = (lambda: None) if cpu else torch.cuda.synchronize
    comm.init_distributed(dist_backend="gloo" if cpu else "nccl",
                          verbose=False)
    if not cpu:
        _tp_prebuild(comm)
    world = comm.get_world_size()
    layers, rows = (2, 2) if cpu else (32, 4)
    res = {name: _tp_train_run(torch, np, args, cpu, dev, sync, world, 1,
                               layers, rows, 1 + args.steps, domino=dom)
           for name, dom in (("plain", False), ("domino", True))}
    if comm.get_rank() == 0:
        with open(args.out_rank0, "w") as f:
            json.dump(res, f)
    comm.destroy_process_group()


def _busy(report):
    """The device's busy share of a traced call and its kernel time by
    kind, as text."""
    if report.get("span_ms") is None:
        return "not measured"
    return (f"{report['device_busy_ms'] / report['span_ms']:.3f} "
            f"({report['device_busy_ms']:.1f} of {report['span_ms']:.1f} "
            f"ms; kernels: NCCL {report['nccl_kernel_ms']:.1f} ms, the "
            f"rest {report['other_kernel_ms']:.1f} ms)")


def _domino_main(args, world, smi, out):
    rcs = _spawn(world, sys.argv[1:] + ["--out-rank0", out])
    if any(rcs) or not os.path.exists(out):
        print(f"zero_multicard: ranks exited {rcs}", file=sys.stderr)
        return 1
    with open(out) as f:
        res = json.load(f)
    os.remove(out)
    plain, dom = res["plain"], res["domino"]
    # relative to the losses' scale (they fall from 11 to 0.04, where
    # bf16 differences of the order of the steps become large relative
    # ones; the --ring rule)
    scale = max(abs(x) for x in plain["losses"])
    diff = max(abs(a - b) for a, b in zip(dom["losses"],
                                          plain["losses"])) / scale
    ok = plain["ranks_agree"] and dom["ranks_agree"] and diff <= 2.0**-7
    for name, r in res.items():
        o = r["overlap"]
        print(f"[domino] {name}: Llama-2-7B width, {r['layers']} layers, "
              f"tp {r['tp']}, {r['rows_global']} rows of {r['seq']}: losses "
              + ", ".join(f"{x:.5f}" for x in r["losses"])
              + f" | step ms mean {r['step_ms_mean']:.1f}, "
              f"{r['tokens_per_s']:.1f} tokens/s, MFU {r['mfu']:.4f} | peak "
              f"GiB by rank " + ", ".join(
                  f"{b / 2**30:.2f}" for b in r["peak_bytes_by_rank"])
              + f" | launches a rank a step {r['launches_a_step']} | one "
              f"forward's overlap report (rank 0): {o} | {smi}", flush=True)
    ok &= (dom["overlap"]["async_pairs"] == 4 * dom["layers"] and
           plain["overlap"]["async_pairs"] == 0)
    print(f"[domino] domino / plain step ms "
          f"{dom['step_ms_mean'] / plain['step_ms_mean']:.3f}; largest "
          f"loss difference {diff:.3e} of the losses' scale (gate 2^-7); "
          f"of the "
          f"{2 * plain['layers']} row-parallel reduces of a plain forward "
          f"none is async; the µ-stream forward starts "
          f"{dom['overlap']['async_pairs']} async, "
          f"{dom['overlap']['overlapped_pairs']} with compute called "
          f"inside their window, NCCL kernels running beside another "
          f"kernel {dom['overlap']['device_overlapped']} (plain "
          f"{plain['overlap']['device_overlapped']}); the device busy "
          f"{_busy(dom['overlap'])} of the µ-stream forward, "
          f"{_busy(plain['overlap'])} of the plain one | {smi}", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(card=smi, **res), f, indent=1)
    if not ok:
        print("zero_multicard: a domino check failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "world": world, "domino": True}))
    return 0


def _gpt2_tp_leg(torch, np, args, cpu, dev, sync):
    """GPT-2 350M (fp16 from 2^16, ``fusedlamb``, the 50257-row vocabulary
    padded to a multiple of tp) at tp = world against tp 1 × dp = world on
    one global batch of 8 rows of 1024; the tp-world tag loaded at tp 1."""
    import shutil
    import tempfile
    import torch.distributed as tdist
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.models import gpt2
    world = comm.get_world_size()
    cfg = (gpt2.gpt2_tiny(dtype="float16", vocab_size=257) if cpu
           else gpt2.gpt2_350m(dtype="float16"))
    S, total = (32, 8) if cpu else (1024, 8)
    batch = np.random.default_rng(args.seed + 11).integers(
        0, cfg.vocab_size, size=(total, S))
    box = [tempfile.mkdtemp(prefix="zero_multicard_gpt2_tp_")
           if comm.get_rank() == 0 else None]
    tdist.broadcast_object_list(box, src=0)
    root = box[0]

    def make(tp):
        config = {"train_micro_batch_size_per_gpu": total // (world // tp),
                  "optimizer": {"type": "fusedlamb", "params": {"lr": 1e-3}},
                  "fp16": {"enabled": True, "initial_scale_power": 16},
                  "zero_optimization": {"stage": 0}, "mesh": {"tp": tp}}
        return deepspeed_tpu_torch.initialize(
            model=gpt2.GPT2Model(cfg, device="meta"), config=config,
            device=dev if cpu else None, tp_rules=gpt2.tp_rules(cfg))[0]

    runs = {}
    try:
        for tp in (world, 1):
            if not cpu:
                torch.cuda.reset_peak_memory_stats()
            eng = make(tp)
            eng.initialize_parameters(args.seed)
            ids = eng.shard_batch(batch)[0]
            losses, skips, times = [], [], []
            for _ in range(1 + args.steps):
                sync()
                t = time.perf_counter()
                loss = eng(ids, ids)
                eng.backward(loss)
                eng.step()
                losses.append(loss.item())
                sync()
                times.append(time.perf_counter() - t)
                skips.append(bool(eng._last_skipped))
            row = dict(tp=tp, losses=losses, skipped=skips,
                       step_ms_mean=sum(times[1:]) / len(times[1:]) * 1e3,
                       peak_bytes=0 if cpu else
                       torch.cuda.max_memory_allocated(),
                       vocab=cfg.vocab_size)
            if tp == world:
                eng.save_checkpoint(root, tag="t")
                row["digest"] = _tp_digest(eng)
                row["wte_global"] = [list(sh) for n, _, _, sh in
                                     eng.global_layout()[0]
                                     if n == "wte.embedding"][0]
            runs[f"tp{tp}"] = row
            del eng
            gc.collect()
            if not cpu:
                torch.cuda.empty_cache()
        eng = make(1)
        eng.load_checkpoint(root)
        runs["loaded_at_tp1"] = dict(digest_equal=_tp_digest(eng) ==
                                     runs[f"tp{world}"]["digest"])
        del eng
        gc.collect()
    finally:
        comm.barrier()
        if comm.get_rank() == 0:
            shutil.rmtree(root, ignore_errors=True)
    return runs


def _pipe_tp_leg(torch, np, args, cpu, dev, sync):
    """GPT-3 13B width (``gpt2.gpt3_13b``, 8 layers, bf16, ``fusedadam``,
    ZeRO 1, remat) through the ``PipelineEngine`` on
    ``gpt2.pipeline_tp_rules``: pp 2 × tp 2 against pp 1 × tp 2 × dp 2,
    4 microbatches of 2 × 2048 from the same weights."""
    import dataclasses
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.models import gpt2
    world = comm.get_world_size()
    full = (gpt2.gpt2_tiny(max_position_embeddings=64) if cpu
            else gpt2.gpt3_13b())
    cfg = dataclasses.replace(full, num_hidden_layers=4 if cpu else 8)
    S, M, R = full.max_position_embeddings, 4, 2
    rng = np.random.default_rng(args.seed + 13)
    batches = []
    for _ in range(M):
        ids = rng.integers(0, cfg.vocab_size, size=(R, S))
        batches.append((ids, np.roll(ids, -1, axis=1)))
    rows = []
    for pp in (2, 1):
        dp = world // (pp * 2)
        config = {"train_micro_batch_size_per_gpu": R // dp,
                  "gradient_accumulation_steps": M,
                  "optimizer": {"type": "fusedadam", "params": {"lr": 1e-4}},
                  "bf16": {"enabled": True},
                  "zero_optimization": {"stage": 1},
                  "mesh": {"pp": pp, "tp": 2}}
        if not cpu:
            torch.cuda.reset_peak_memory_stats()
        engine = deepspeed_tpu_torch.initialize(
            model=gpt2.pipeline_module(cfg, activation_checkpoint_interval=1),
            config=config, device=dev if cpu else None,
            tp_rules=gpt2.pipeline_tp_rules(cfg))[0]
        engine.initialize_parameters(args.seed)
        losses, times = [], []
        for _ in range(1 + args.steps):
            sync()
            t = time.perf_counter()
            losses.append(engine.train_batch(iter(batches)).item())
            sync()
            times.append(time.perf_counter() - t)
        peak = 0 if cpu else torch.cuda.max_memory_allocated()
        every = comm.all_gather(torch.tensor([float(peak)] + losses,
                                             device=dev), tiled=False).cpu()
        rows.append(dict(pp=pp, tp=2, dp=dp, layers=cfg.num_hidden_layers,
                         losses=losses,
                         step_ms_mean=sum(times[1:]) / len(times[1:]) * 1e3,
                         peak_bytes_by_rank=[int(x) for x in every[:, 0]],
                         ranks_agree=bool((every[:, 1:] ==
                                           every[0, 1:]).all())))
        del engine
        gc.collect()
        if not cpu:
            torch.cuda.empty_cache()
    return rows


def _stream_sp_leg(torch, np, args, cpu, dev, sync):
    """Llama-2-13B width (8 layers) streamed (ZeRO-Infinity: the host
    store sharded over the data group, the host Adam), 4 rows of 8192
    tokens: sp = world (each rank its chunk of every row) against sp 1 ×
    dp = world (each rank a row), the same weights and tokens."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.models import llama
    world = comm.get_world_size()
    S, rows_global = (64, 4) if cpu else (8192, 4)
    tiny = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                num_attention_heads=4, num_key_value_heads=4) if cpu else {}
    ids = np.random.default_rng(args.seed + 17).integers(
        0, tiny.get("vocab_size", 32000), size=(rows_global, S))
    rows = []
    for sp in (world, 1):
        cfg = llama.llama_13b(**{**dict(
            num_hidden_layers=2 if cpu else 8, head_dtype="bfloat16",
            remat=True, remat_policy="nothing_saveable",
            max_position_embeddings=S, use_ulysses=sp > 1), **tiny})
        config = dict(_config("llama7b", 3), optimizer=ADAM,
                      zero_optimization=STREAMED,
                      train_micro_batch_size_per_gpu=rows_global * sp //
                      world, mesh={"sp": sp})
        if not cpu:
            torch.cuda.reset_peak_memory_stats()
        engine = deepspeed_tpu_torch.initialize(
            model=llama.LlamaModel(cfg, device="meta"), config=config,
            device=dev if cpu else None)[0]
        engine.initialize_parameters(args.seed)
        x = engine.shard_batch(ids)[0]
        losses, times = [], []
        for _ in range(1 + args.steps):
            sync()
            t = time.perf_counter()
            loss = engine(x, x)
            engine.backward(loss)
            engine.step()
            losses.append(loss.item())
            sync()
            times.append(time.perf_counter() - t)
        sweep = engine.sweep_seconds[1:]
        peak = 0 if cpu else torch.cuda.max_memory_allocated()
        every = comm.all_gather(torch.tensor([float(peak)] + losses,
                                             device=dev), tiled=False).cpu()
        rows.append(dict(sp=sp, dp=world // sp, layers=cfg.num_hidden_layers,
                         seq=S, losses=losses,
                         step_ms_mean=sum(times[1:]) / len(times[1:]) * 1e3,
                         sweep_share=sum(sweep) / max(1e-9, sum(times[1:])),
                         peak_bytes_by_rank=[int(x) for x in every[:, 0]],
                         ranks_agree=bool((every[:, 1:] ==
                                           every[0, 1:]).all())))
        del engine
        gc.collect()
        if not cpu:
            torch.cuda.empty_cache()
    return rows


def run_tp_compose_rank(args):
    """``--tp-compose`` (module docstring)."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch import comm
    cpu = args.device == "cpu"
    dev = "cpu" if cpu else "cuda"
    sync = (lambda: None) if cpu else torch.cuda.synchronize
    comm.init_distributed(dist_backend="gloo" if cpu else "nccl",
                          verbose=False)
    if not cpu:
        _tp_prebuild(comm)
    world = comm.get_world_size()
    out = {}

    def record(key, value):
        out[key] = value
        if comm.get_rank() == 0:
            with open(args.out_rank0, "w") as f:
                json.dump(out, f)

    layers, seq = (2, 64) if cpu else (32, 8192)
    record("tp_sp", [
        _tp_train_run(torch, np, args, cpu, dev, sync, tp, 3, layers, 1,
                      1 + args.steps, global_rows=1, sp=sp, seq=seq)
        for tp, sp in ((2, world // 2), (world, 1), (1, world))])
    record("gpt2_tp", _gpt2_tp_leg(torch, np, args, cpu, dev, sync))
    record("pipe_tp", _pipe_tp_leg(torch, np, args, cpu, dev, sync))
    record("stream_sp", _stream_sp_leg(torch, np, args, cpu, dev, sync))
    comm.destroy_process_group()


def _tp_compose_main(args, world, smi, out):
    rcs = _spawn(world, sys.argv[1:] + ["--out-rank0", out])
    ok = not any(rcs)
    if not ok:
        print(f"zero_multicard: ranks exited {rcs}", file=sys.stderr)
    if not os.path.exists(out):
        return 1
    with open(out) as f:
        res = json.load(f)
    os.remove(out)
    runs = res.get("tp_sp", [])
    for r in runs:
        ok &= r["ranks_agree"] and all(map(math.isfinite, r["losses"]))
        rel = [max(abs(a - b) for a, b in zip(r["losses"], o["losses"])) /
               max(abs(x) for x in o["losses"]) for o in runs[1:]]
        ok &= max(rel) <= 2.0**-7
        print(f"[tp-compose] Llama-2-7B width, {r['layers']} layers, 1 row "
              f"of {r['seq']}, ZeRO 3, tp {r['tp']} × sp {r['sp']}: losses "
              + ", ".join(f"{x:.5f}" for x in r["losses"])
              + f" | largest difference from tp {world} × sp 1 and from "
              f"tp 1 × sp {world}, of their losses' scale: " + ", ".join(
                  f"{x:.3e}" for x in rel) + f" (gate 2^-7) | step ms mean "
              f"{r['step_ms_mean']:.1f}, {r['tokens_per_s']:.1f} tokens/s, "
              f"MFU {r['mfu']:.4f} | peak GiB by rank " + ", ".join(
                  f"{b / 2**30:.2f}" for b in r["peak_bytes_by_rank"])
              + f" | launches a rank a step {r['launches_a_step']} | {smi}",
              flush=True)
    g = res.get("gpt2_tp")
    if g:
        a, b = g[f"tp{world}"], g["tp1"]
        rel = max(abs(x - y) / abs(y) for x, y in zip(a["losses"],
                                                       b["losses"]))
        ok &= (rel <= 2.0**-7 and a["skipped"] == b["skipped"] and
               g["loaded_at_tp1"]["digest_equal"] and
               a["wte_global"][0] == a["vocab"])
        print(f"[tp-compose] GPT-2 350M, fp16, fusedlamb, 8 rows of 1024, "
              f"the vocabulary padded to a multiple of tp: tp {world} losses "
              + ", ".join(f"{x:.5f}" for x in a["losses"]) + " against tp 1 "
              "× dp " + str(world) + " " + ", ".join(
                  f"{x:.5f}" for x in b["losses"]) + f" (largest relative "
              f"{rel:.3e}, gate 2^-7), skipped {a['skipped']} / "
              f"{b['skipped']} | step ms {a['step_ms_mean']:.1f} against "
              f"{b['step_ms_mean']:.1f} | peak {a['peak_bytes'] / 2**30:.2f}"
              f" / {b['peak_bytes'] / 2**30:.2f} GiB | wte in the tag "
              f"{a['wte_global']}; the tp-{world} tag loaded at tp 1: "
              f"master digest equal {g['loaded_at_tp1']['digest_equal']} | "
              f"{smi}", flush=True)
    for key, what in (("pipe_tp", "GPT-3 13B width through the "
                       "PipelineEngine, 4 microbatches of 2 × 2048, ZeRO 1"),
                      ("stream_sp", "Llama-2-13B width streamed, 4 rows")):
        runs = res.get(key, [])
        if len(runs) < 2:
            continue
        a, b = runs
        rel = max(abs(x - y) for x, y in zip(a["losses"], b["losses"])) / \
            max(abs(y) for y in b["losses"])
        ok &= a["ranks_agree"] and b["ranks_agree"] and rel <= 2.0**-7
        for r in runs:
            line = (f"[tp-compose] {what}, {r['layers']} layers, "
                    + (f"pp {r['pp']} × tp {r['tp']} × dp {r['dp']}"
                       if key == "pipe_tp" else
                       f"{r['seq']} tokens, sp {r['sp']} × dp {r['dp']}")
                    + ": losses " + ", ".join(f"{x:.5f}" for x in
                                              r["losses"])
                    + f" | step ms mean {r['step_ms_mean']:.1f}")
            if key == "stream_sp":
                line += f", host sweep share {r['sweep_share']:.3f}"
            print(line + " | peak GiB by rank " + ", ".join(
                f"{x / 2**30:.2f}" for x in r["peak_bytes_by_rank"])
                + f" | {smi}", flush=True)
        print(f"[tp-compose] {what}: largest loss difference {rel:.3e} of "
              f"the losses' scale (gate 2^-7) | {smi}", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(card=smi, **res), f, indent=1)
    if not ok:
        print("zero_multicard: a tp-compose check failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "world": world, "tp_compose": True}))
    return 0


# --ring: (name, layers, global sequence, backend, extra config);
# Llama-2-7B widths, sp over every rank, ZeRO 3, remat, 1 row
RING_RUNS = (
    ("ring_32k", None, 32768, "ring", {}),
    ("ulysses_32k", None, 32768, "ulysses", {}),
    ("ring_128k_8l", 8, 131072, "ring", {"loss_chunk_vocab": 4096}),
)
RING_TINY_SEQ = {32768: 64, 131072: 256}


def run_ring_rank(args):
    """``--ring``: Llama-2-7B at sp = the world, ZeRO 3 over the dp × sp
    data group, remat: the ring against Ulysses on the same weights and
    batches, then the ring at 128K tokens (module docstring)."""
    import numpy as np
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models import llama
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.ops.kernels import optimizers as opt
    torch.set_num_threads(1)
    cpu = args.device == "cpu"
    dev = "cpu" if cpu else "cuda"
    sync = (lambda: None) if cpu else torch.cuda.synchronize
    counters = {"flash_attention": fa.flash_attention_fwd,
                "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
                "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv,
                "fused_adam_step": opt.fused_adam_step}
    world = int(os.environ["WORLD_SIZE"])
    out = []
    for name, layers, S, backend, extra in RING_RUNS:
        S = RING_TINY_SEQ[S] if cpu else S
        over = dict(use_ulysses=True, sp_backend=backend, remat=True,
                    max_position_embeddings=S, **extra)
        if cpu:
            cfg = llama.llama_tiny(dtype="bfloat16", **over)
        else:
            cfg = llama.llama_7b(head_dtype="bfloat16", **over, **(
                {} if layers is None else {"num_hidden_layers": layers}))
        config = {"train_micro_batch_size_per_gpu": 1,
                  "optimizer": ADAM, "bf16": {"enabled": True},
                  "sequence_parallel_size": world,
                  "zero_optimization": {"stage": 3} if not cpu else {
                      "stage": 3, "stage3_param_persistence_threshold": 0}}
        engine = deepspeed_tpu_torch.initialize(
            model=llama.LlamaModel(cfg, device="meta"), config=config,
            device=dev if cpu else None)[0]
        engine.initialize_parameters(args.seed)
        ids = np.random.default_rng(args.seed + 1).integers(
            0, cfg.vocab_size, size=(1, S))
        (chunk, ) = engine.shard_batch(ids)
        losses, times = [], []
        for i in range(1 + args.steps):
            if i == 1:
                sync()
                for fn in counters.values():
                    fn.launches = 0
                if not cpu:
                    torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            loss = engine(chunk, chunk)
            engine.backward(loss)
            engine.step()
            losses.append(loss.item())
            sync()
            if i >= 1:
                times.append(time.perf_counter() - t)
        peak = 0 if cpu else torch.cuda.max_memory_allocated()
        mine = torch.tensor([float(peak)] + losses, dtype=torch.float64,
                            device=dev)
        every = comm.all_gather(mine, tiled=False).cpu()
        step_s = sum(times) / len(times)
        flops = 6 * llama.param_count(cfg) + 12 * cfg.num_hidden_layers * \
            S * cfg.hidden_size
        out.append(dict(
            name=name, layers=cfg.num_hidden_layers, seq=S, backend=backend,
            world=world, sp=engine.seq_parallel_world_size, losses=losses,
            rank_losses_equal=bool((every[:, 1:] == every[0, 1:]).all()),
            step_ms=[t * 1e3 for t in times], step_ms_mean=step_s * 1e3,
            tokens_per_s=S / step_s, flops_per_token=flops,
            mfu=S / step_s * flops / (PEAK_FLOPS * world),
            launches_per_step={k: fn.launches / args.steps
                               for k, fn in counters.items()},
            peak_bytes_by_rank=[int(x) for x in every[:, 0].tolist()]))
        del engine, loss
        gc.collect()
        if not cpu:
            torch.cuda.empty_cache()
        if comm.get_rank() == 0:
            with open(args.out_rank0, "w") as f:
                json.dump(out, f)
    comm.destroy_process_group()


def _ring_main(args, world, smi, out):
    rcs = _spawn(world, sys.argv[1:] + ["--out-rank0", out])
    res = []
    if os.path.exists(out):
        with open(out) as f:
            res = json.load(f)
        os.remove(out)
    runs = {r["name"]: r for r in res}
    ok = not any(rcs) and len(runs) == len(RING_RUNS)
    for r in res:
        print(f"[ring] {r['name']}: Llama-2-7B widths, {r['layers']} layers,"
              f" sp {r['sp']} of world {r['world']}, {r['seq']} tokens (1 "
              f"row), {r['backend']}, ZeRO 3, remat, bf16 | losses "
              + ", ".join(f"{x:.5f}" for x in r["losses"])
              + f" | step ms mean {r['step_ms_mean']:.1f}, "
              f"{r['tokens_per_s']:.1f} tokens/s, MFU {r['mfu']:.4f} (6N + "
              f"12·L·S·D = {r['flops_per_token'] / 1e9:.2f} GFLOP a token, "
              f"989 TFLOP/s a card) | launches a rank a step "
              f"{r['launches_per_step']} | peak GiB by rank "
              + ", ".join(f"{b / 2**30:.2f}" for b in r["peak_bytes_by_rank"])
              + f" | {smi}", flush=True)
        ok &= r["rank_losses_equal"] and all(map(math.isfinite,
                                                 r["losses"]))
    if "ring_32k" in runs and "ulysses_32k" in runs:
        a, b = runs["ring_32k"]["losses"], runs["ulysses_32k"]["losses"]
        diff = max(abs(x - y) / abs(y) for x, y in zip(a, b))
        print(f"[ring] ring against Ulysses at 32K: largest relative loss "
              f"difference {diff:.3e} (gate 2^-7)", flush=True)
        ok &= diff <= 2.0**-7
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(card=smi, runs=res), f, indent=1)
    if not ok:
        print(f"zero_multicard: a ring check failed (ranks exited {rcs})",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "world": world, "ring": True}))
    return 0


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(world, argv):
    """Run this script's ranks (``argv`` plus ``--rank r``) on a fresh NCCL
    or gloo world of ``world``; their exit codes."""
    port = str(_free_port())
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=port)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), *argv,
             "--rank", str(rank)], env=env))
    try:
        return [p.wait(timeout=1800) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _checkpoint_main(args, world, smi, out):
    """``--checkpoint``: the save-and-resume world, then (``--model
    llama``) a world of half the ranks loading the same tag."""
    import shutil
    import tempfile
    if args.model not in ("llama", "llama7b"):
        print("zero_multicard: --checkpoint takes --model llama or llama7b",
              file=sys.stderr)
        return 2
    ckpt = tempfile.mkdtemp(prefix="zero_multicard_ckpt_")
    free = shutil.disk_usage(ckpt).free
    layers = _ckpt_layers(args.model, free)
    if args.device == "cuda" and layers != (32 if args.model == "llama7b"
                                            else 8):
        print(f"[checkpoint] {args.model} cut to {layers} layers (widths "
              f"kept): {free / 1e9:.1f} GB of disk free", flush=True)
    phases = [(world, "save")]
    if args.model == "llama" and world > 1:
        phases.append((world // 2, "load"))
    rows = []
    try:
        for w, phase in phases:
            rcs = _spawn(w, sys.argv[1:] + [
                "--out-rank0", out, "--ckpt-dir", ckpt, "--ckpt-phase", phase,
                "--ckpt-layers", str(layers)])
            if any(rcs):
                print(f"zero_multicard: {phase} ranks exited {rcs}",
                      file=sys.stderr)
                return 1
            with open(out) as f:
                rows.append(dict(json.load(f), phase=phase))
            os.remove(out)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    save = rows[0]
    ok = (save["losses"] == save["losses_resumed"] and
          all(save["equal_by_rank"]) and save["rank_losses_equal"] and
          all(map(math.isfinite, save["losses"])))
    print(f"[checkpoint] {args.model} ({save['layers']} layers), ZeRO 3, "
          f"world {save['world']}: free disk {free / 1e9:.1f} GB before "
          "the save; bytes by rank " + ", ".join(
              f"{b / 1e9:.2f} GB" for b in save["bytes_by_rank"])
          + "; save s by rank " + ", ".join(
              f"{x:.1f}" for x in save["save_s_by_rank"])
          + f" (rank 0: host copies {save['stage_s']:.1f}, writes "
          f"{save['write_s']:.1f}, commit {save['commit_s']:.1f}); load s "
          "by rank " + ", ".join(f"{x:.1f}" for x in save["load_s_by_rank"])
          + f" | losses {save['losses']} resumed {save['losses_resumed']}; "
          f"master bit-equal by rank {save['equal_by_rank']} | {smi}",
          flush=True)
    for r in rows[1:]:
        same = r["digest"] == save["digest"]
        ok &= same
        print(f"[checkpoint] the world-{save['world']} tag loaded at world "
              f"{r['world']} in {r['load_s']:.1f} s: master equal to the "
              f"saved one {same} | {smi}", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(card=smi, model=args.model, free_disk_bytes=free,
                           checkpoint=rows), f, indent=1)
    if not ok:
        print("zero_multicard: a checkpoint check failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "model": args.model, "world": world,
                      "checkpoint": True}))
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=tuple(STAGES), default="gpt2")
    ap.add_argument("--world", type=int, default=None)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--json", help="also write every number to this file")
    ap.add_argument("--checkpoint", action="store_true",
                    help="save and resume at ZeRO 3 (llama, llama7b)")
    ap.add_argument("--offload", action="store_true",
                    help="Llama-2-13B at ZeRO 3 with its optimizer state "
                         "pinned on the host, fusedlamb")
    ap.add_argument("--zeropp", action="store_true",
                    help="ZeRO++ (qwZ, qgZ, hierarchical qgZ, hpZ) and "
                         "MiCS against plain ZeRO 3 on Llama-2-7B")
    ap.add_argument("--pipe", action="store_true",
                    help="GPT-3 13B through the PipelineEngine and Ulysses "
                         "(pp, sp) against the base engine")
    ap.add_argument("--onebit", action="store_true",
                    help="GPT-2 350M with OnebitAdam against FusedAdam at "
                         "ZeRO 0")
    ap.add_argument("--moe", action="store_true",
                    help="the MoE layer expert-parallel (ep 4, dp 2 × ep 2) "
                         "against dp 4, and Mixtral-8x7B width at ZeRO 3")
    ap.add_argument("--tp", action="store_true",
                    help="tensor parallelism: Llama-2-7B, Mistral-7B and "
                         "Mixtral-8x7B serving at tp 4 against tp 1, "
                         "Llama-2-7B-width training at tp 2 × dp 2 and tp 4, "
                         "and a tp checkpoint resumed at other tp")
    ap.add_argument("--ring", action="store_true",
                    help="long-context training: Llama-2-7B at sp = world "
                         "with ring attention against Ulysses at 32K "
                         "tokens, then the ring at 128K (8 layers, fused "
                         "chunked loss)")
    ap.add_argument("--domino", action="store_true",
                    help="Domino µ-streams: Llama-2-7B width at tp = world "
                         "against the plain step, with the overlap report")
    ap.add_argument("--tp-compose", action="store_true",
                    help="tp with sp (Llama-2-7B width at 8192 tokens: tp 2 "
                         "× sp 2 against tp 4 and sp 4), GPT-2 350M at tp = "
                         "world on its padded vocabulary, pp 2 × tp 2, and "
                         "streaming at sp = world")
    ap.add_argument("--offload-layers", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--stream-layers", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--out-rank0", help=argparse.SUPPRESS)
    ap.add_argument("--ckpt-dir", help=argparse.SUPPRESS)
    ap.add_argument("--ckpt-phase", help=argparse.SUPPRESS)
    ap.add_argument("--ckpt-layers", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    if args.rank is not None:
        (run_offload_rank if args.offload else run_checkpoint_rank
         if args.checkpoint else run_zeropp_rank if args.zeropp
         else run_pipe_rank if args.pipe else run_onebit_rank
         if args.onebit else run_moe_rank if args.moe else run_tp_rank
         if args.tp else run_ring_rank if args.ring else run_domino_rank
         if args.domino else run_tp_compose_rank if args.tp_compose
         else run_rank)(args)
        return 0
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("zero_multicard: torch sees no CUDA device", file=sys.stderr)
        return 2
    world = args.world or (torch.cuda.device_count()
                           if args.device == "cuda" else 4)
    smi = ("CPU rehearsal" if args.device == "cpu" else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().replace("\n", "; "))
    out = os.path.join(os.environ.get("TMPDIR", "/tmp"),
                       f"zero_multicard_{os.getpid()}.json")
    if args.checkpoint:
        return _checkpoint_main(args, world, smi, out)
    if args.offload:
        return _offload_main(args, world, smi, out)
    if args.zeropp:
        return _zeropp_main(args, world, smi, out)
    if args.pipe:
        return _pipe_main(args, world, smi, out)
    if args.onebit:
        return _onebit_main(args, world, smi, out)
    if args.moe:
        return _moe_main(args, world, smi, out)
    if args.tp:
        return _tp_main(args, world, smi, out)
    if args.ring:
        return _ring_main(args, world, smi, out)
    if args.domino:
        return _domino_main(args, world, smi, out)
    if args.tp_compose:
        return _tp_compose_main(args, world, smi, out)
    rcs = _spawn(world, sys.argv[1:] + ["--out-rank0", out])
    if any(rcs):
        print(f"zero_multicard: ranks exited {rcs}", file=sys.stderr)
        return 1
    with open(out) as f:
        rows = json.load(f)
    os.remove(out)
    base = rows[0]
    ok = True
    for r in rows:
        diff = max(abs(a - b) for a, b in zip(r["losses"], base["losses"]))
        scale = max(abs(x) for x in base["losses"])
        r["max_loss_diff_vs_zero0"] = diff
        print(f"[zero {r['stage']}] {args.model}, world {r['world']}: "
              f"losses " + ", ".join(f"{x:.4f}" for x in r["losses"])
              + f" | step ms {r['step_ms_mean']:.1f}, "
              f"{r['tokens_per_s']:.1f} tokens/s over the world, MFU "
              f"{r['mfu']:.4f} | peak "
              "GiB by rank " + ", ".join(
                  f"{b / 2**30:.2f}" for b in r["peak_bytes_by_rank"])
              + f" | shard {r['shard_numel']:,} of {r['padded_numel']:,} "
              f"elements | collectives a step {r['calls_per_step']} | "
              f"largest loss difference from ZeRO 0 {diff:.3e} | {smi}",
              flush=True)
        ok &= all(math.isfinite(x) for x in r["losses"])
        ok &= r["rank_losses_equal"] and diff <= 2.0**-7 * scale
    peaks = [max(r["peak_bytes_by_rank"]) for r in rows]
    ok &= all(b <= a for a, b in zip(peaks, peaks[1:]))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(card=smi, model=args.model, rows=rows), f,
                      indent=1)
    if not ok:
        print("zero_multicard: a check failed (see the lines above)",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "model": args.model, "world": world}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
