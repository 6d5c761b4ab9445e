#!/usr/bin/env python3
"""Drive deepspeed_tpu_torch on one NVIDIA card, end to end.

    python3 chip_smoke.py [--seed N] [--json PATH] [--profile DIR]

Stages, run in the order 1-36; any failure exits non-zero:

1. environment: torch/CUDA/nvcc versions, the card's name and power limit;
2. build: every ``deepspeed_tpu_torch/csrc/*.cu`` with nvcc for sm_90a
   (one nvcc per source, started together), with ``ptxas -v``; for the
   32 tensor-core paged attention kernels (bf16, fp16 × tiles of head dim
   64, 128, each filled or padded × 1, 2, 4, 8 row tiles) and their two
   split merges: registers, spills
   (any fails), stack, dynamic shared memory and blocks an SM; for each
   of the twelve tensor-core flash kernels (forward, dq, dk/dv × bf16,
   fp16 × head dim 64, 128), the 48 tensor-core flash-bias kernels
   (forward, dq, dk/dv, dbias × bf16, fp16 × a bias in the input type or
   fp32 × head dim 32, 64, 128), the 8 tensor-core block-sparse kernels
   (bf16, fp16 × head dim 16-128) and the 4 wgmma/TMA grouped-matmul
   kernels (bf16, fp16 × 64 or 128 rows a tile) its registers, spill
   bytes, stack and (flash) dynamic shared memory on a line of its own;
   the registers of the one-pass group kernels of B5's quantize (27) and
   B6 (81), a line per input type and encoder (spills fail);
3. paged attention (B4) against its plain PyTorch version in bf16 at the
   shapes stage 4 gives it (16 decode rows; 47 atom-16 tiles, also in
   fp16), and at Llama-2-7B (H=Hkv=32, Dh=128, block 128) and Mistral-7B
   GQA (H=32, Hkv=8, window 4096) shapes: decode (atom 1, 64 tokens,
   contexts 1-4096) and prefill (atom 16, 8 tiles), plus two fp32 cases,
   and decode and prefill at head widths the 128-wide tile pads (Phi-2's
   80, OpenLLaMA-3B's 100); each case on its route (``launch_plan``:
   ``decode_split``, ``atom_mma`` or ``fp32``), run twice, bit for bit;
   times of the kernel,
   the plain version and ``scaled_dot_product_attention`` on
   already-gathered K/V, the bound, the share of it and TFLOP/s; the
   tensor-core kernels' registers, spills and HMMA count in ``cuobjdump
   -sass`` (none fails);
4. serving at full width: Llama-2-7B, random bf16 weights made on the card
   from the seed, built through ``build_engine_from_checkpoint``; 8 requests
   of 128-2048 prompt tokens, 64 greedy tokens each, through ``generate``;
   the kernel's launch counts are read around this run (every decode call
   on ``decode_split``, every prefill atom call on ``atom_mma``), and the
   same requests run again, untimed, to check every step's logits are
   finite;
5. one prefill ragged step at full width and depth 2, kernel against the
   plain gather path, then teacher-forced decode steps, in bf16 and in
   fp16; then one request through ``generate`` on each engine;
6. a small HF directory (config.json + pytorch_model.bin, fp32, Dh 64,
   GQA) served through ``build_hf_engine`` on the card and on the CPU;
7. the training kernels against their plain versions: flash attention's
   forward, dq and dk/dv kernels (each on the same inputs as its plain
   version) in bf16 at the training shapes [4, 2048, 32, 128] causal, with
   GQA 32/8 and a 1024 window, with sq < sk, and in fp32 at a smaller
   size; each flash kernel run twice on the same inputs, every output
   (o, lse, dq, delta, dk, dv) bit-equal; the fused Adam step over the
   flat buffer of the 8-layer Llama-2-7B-width model's leaves; times of
   each kernel, its plain version, a library call
   (``scaled_dot_product_attention``, ``torch.optim.AdamW(fused=True)``)
   and the bound; each flash kernel's achieved TFLOP/s (useful products
   over the live pairs) and share of the bound, and its count of HMMA
   (tensor-core) and FFMA instructions in ``cuobjdump -sass`` of the built
   library (no HMMA, or no cuobjdump beside nvcc, fails the stage);
8. training at full width: Llama-2-7B width, 8 layers, bf16, random
   weights from ``initialize_parameters(seed)``, through
   ``deepspeed_tpu_torch.initialize`` with bench.py's config (micro batch
   4, fusedadam lr 1e-4, ZeRO 0); one batch [4, 2048] from the seed, 2
   warm-up and 6 timed steps: losses, step time, tokens/s, MFU, peak
   memory and each kernel's launches in the timed steps (8/8/8 flash and 1
   Adam per step, exactly);
9. one training step at full width and depth 2 (B=2, S=2048), kernels
   against their plain versions from the same weights: loss, gradients,
   grad norm and the master after the step;
10. the kernels of the GPT-2 slice against their plain versions: both LAMB
    phases and the Lion step over GPT-2 350M's flat layout (354,823,168
    elements, 388 leaves) with fp32 and fp16 gradients (m, v, u and Lion's
    outputs bit for bit, LAMB's per-leaf sums and ratios within 1e-5, two
    runs of phase 1 bit-identical), flash attention in fp16 at GPT-2's
    [8, 1024, 16, 64] causal and at a GQA/window case (bit-equal over two
    runs, TFLOP/s, share of the bound and SASS as in stage 7), the Adam
    step with an fp16 gradient and copy; times of each kernel, its plain
    version, a library call where there is one, and the bound;
11. GPT-2 350M training at full width and depth through ``initialize()``:
    fp16 with dynamic loss scaling (``initial_scale_power`` 16), remat,
    B=8, S=1024, ZeRO 0 (bench.py's stage 1 needs the comm layer, not
    ported yet), ``fusedlamb`` lr 1e-3, one fixed batch, 2 warm-up and 8
    timed steps: every step's loss, scale and skip, step time, tokens/s,
    MFU, peak memory and exact launch counts; then 3 steps each with
    ``fusedadam`` and ``lion``;
12. overflow and guard semantics on the card: a depth-2 GPT-2 from
    ``initial_scale_power`` 32 (every overflowed step leaves master,
    moments and fp16 parameters bit-unchanged, counts in ``skipped_steps``,
    does not advance the optimizer's count or lr, and halves the scale only
    when the hysteresis of 2 runs out), and a bf16 run with
    ``check_finite_grads`` whose poisoned step is skipped;
13. the kernels of the MoE and quantized-serving slice against their plain
    versions: the grouped matmul in bf16 at Mixtral-8x7B's expert shapes
    (K=4096, N=14336 and K=14336, N=4096, E=8) for decode (16 rows, 2 per
    expert) and prefill (1,536 rows, uneven, one expert empty), on the
    mma.sync kernel at prefill's rows with K=4064 and with x 8 bytes off,
    and in fp32 at K=1000, N=1003 (within 2^-7·|ref| + 1e-4 in bf16);
    blockwise
    quantize and dequantize over one layer's w1 stack (469,762,048
    elements), int8 and int4, groups of 128 and 2048, bf16 and fp32 input,
    on the contiguous route, and quantize of ``p.t()`` of Llama-2-7B's
    bf16 gate projection [11008, 4096] as the int8 build passes it, on the
    transposed route (beside it a contiguous copy and the kernel), then
    every bf16 and fp16 value at random scales and exact ties on both
    routes (all bit for bit); times of each kernel, its plain version, a
    library call for the grouped matmul (``torch._grouped_mm`` where this
    torch has it, else a per-expert ``torch.matmul`` loop) and the bound;
    each grouped
    matmul case's route (Mixtral's shapes must take wgmma + TMA: 64-row
    tiles for decode, 128 for prefill; shapes TMA cannot take mma.sync;
    fp32 the CUDA cores), TFLOP/s and share of the bound, and for the
    tensor-core kernels their registers, spills and SASS counts (HGMMA and
    UTMALDG of wgmma/TMA, HMMA of mma.sync; a count of 0 fails);
14. Mixtral serving at full width: Mixtral-8x7B's published config cut
    from 32 to 16 layers (32 do not fit in 80 GB in bf16), random bf16
    weights made on the card one tensor at a time as the checkpoint
    streams them into the expert stacks (``build_engine_from_checkpoint``);
    stage 4's engine config and requests: rates, TTFT, peak memory, the
    grouped matmul's launches (exactly 3 × 16 × ragged steps, all on the
    wgmma/TMA routes, counted by route) and paged attention's, finite
    logits;
15. Llama-2-7B at full width and depth with ``quantization_mode="int8"``:
    quantize launches at build (one per weight; every ``nn.Linear`` weight
    on the transposed route, none copied), ``quantize_tree``'s wall time
    and the device time of its kernels (``torch.profiler``), dequantize
    launches
    (weights × ragged steps, exactly), resident weight bytes, rates, and a
    serving peak below stage 4's bf16 peak in the same run; then an int4
    engine for one short request;
16. one ragged step (a prefill, then two teacher-forced decode steps) at
    full width and depth 2, kernels against their plain versions: Mixtral
    (a flipped top-2 routing choice reruns the plain step with the kernel
    run's router logits, and says so), then Llama-2-7B in int8;
17. the bias-operand flash kernels (forward, dq, dk/dv, dbias) against
    their plain versions at AlphaFold2's Evoformer widths: MSA row
    attention of the fine-tuning crop in bf16 (Q/K/V [512, 384, 8, 32],
    pair bias [1, 8, 384, 384] over 512 MSA rows, a 0 / -1e9 key mask with
    one row masked whole), triangle attention in bf16 ([384, 384, 4, 32],
    pair bias over 384 rows), the training crop in fp16 ([128, 256, 8,
    32]) and a small causal fp32 case with Bb > 1 and Hb < H; dbias twice,
    bit for bit; times of each kernel, its plain version,
    ``scaled_dot_product_attention`` with the biases as a float
    ``attn_mask`` (forward, and forward+backward where it gives the mask a
    gradient) and the bound; for each bf16/fp16 kernel its registers and
    spills, its HMMA count in ``cuobjdump -sass`` (none fails the stage),
    its TFLOP/s of useful work, and beside the bound the time its
    exponentials alone take at the MUFU rate;
18. the Evoformer path at full width: ``DS4Sci_EvoformerAttention`` forward
    and backward in bf16 (Q, K, V and the pair bias require grad) at the
    MSA-row and triangle shapes, 2 warm-up and 8 timed calls each: ms per
    forward and per forward+backward, exact launches (one of each kernel
    per call), peak memory against the plain route's and, at the MSA-row
    shape, at most the CUDA-core kernels' 0.111 GiB above the inputs plus
    the dbias split's scratch, the kernel route against the plain route, finite
    values, no mask gradient; then one MSA-column call (no pair bias: the
    chunked path, no launch);
19. the block-sparse attention kernel against its plain version: (a)
    BigBird-base (google/bigbird-roberta-base: 12 heads × 64, block 64, 3
    random blocks, 4096 positions) with B=4 in bf16; (b) DeepSpeed's
    "fixed" sparsity defaults (block 16, 4 local blocks, 1 global, 4
    global patterns over the heads) at BERT-large width (16 heads × 64),
    B=2, S=4096, bf16; (c) (b) unidirectional in fp16; times of the
    kernel, the plain version and ``scaled_dot_product_attention`` with
    the dense boolean mask the layout expands to, and the bound; the
    kernel's TFLOP/s and share of the bound, its registers, spills and
    HMMA count (none fails) and its row groups;
20. ``SparseSelfAttention`` forward and backward at (a) and (c) through its
    [B, H, S, D] entry: ms per forward and per forward+backward, exactly
    one kernel launch per forward, peak memory above the inputs, the
    output and gradients against the gather formulation;
21. the FP6/FP12 quantize kernel (it packs its codes) against its plain
    version, packed bytes and scales bit for bit, at Llama-2-7B's MLP leaf
    [4096, 11008] and embedding [32000, 4096] in bf16 and fp32 (groups of
    512), with the byte bound of the packed output and the issue time of
    the SASS instructions the kernel runs for a whole group (above the
    kernel's time fails); every bf16 and fp16
    value at random scales; then ``linear.quantize_param_tree`` over
    Llama-2-7B's whole bf16 tree in the JAX layout (random from the seed)
    in FP6, FP12 and fp8: launches (one per leaf of two or more dims; none
    for fp8), ``pack_codes`` never called, wall and device time, resident
    bytes and the worst relative error of ``dequantized()``;
22. BERT-base (BASELINE config 1) at full width and depth through
    ``initialize()``: fp32 (products in full fp32), ZeRO 0, ``fusedadam``
    lr 1e-4, B=64, S=128, 15 % of the tokens labelled, random weights and
    data from the seed; the first step's update with the fused Adam kernel
    against its plain version from the same state (one fp32 ulp), then 2
    warm-up and 8 timed steps: losses, step ms, samples/s, TFLOP/s (6N +
    12·L·S·D a token), MFU of 67 TFLOP/s fp32, peak memory, and launches
    (the Adam kernel once a step, no other kernel);
23. GPT-2 350M (BASELINE config 2) at ZeRO 1 on the NCCL world of one rank
    (``init_distributed``): bench.py's config (B=8, S=1024, fp16 from a
    scale of 2^16, remat, ``fusedadam``), 2 warm-up and 8 timed steps, and
    the same config, seed and data at ZeRO 0 in the same process: losses
    against ZeRO 0 (largest difference), step ms, tokens/s, MFU, peak
    memory beside ZeRO 0's, skipped steps, the reduce-scatter and
    all-gather calls a step from the comms logger, exact launches;
24. Llama-2-7B width cut to stage 8's 8 layers (BASELINE config 3) at
    ZeRO 2, bf16, gradient accumulation 2 (B=4, S=2048 a micro-step), on
    NCCL: 1 warm-up and 3 timed steps, and the same at ZeRO 0: losses
    against ZeRO 0, step ms, tokens/s, MFU, peak memory beside ZeRO 0's
    and stage 8's, collectives and exact launches (flash 8 a micro-step,
    Adam once a step);
25. stage 24's model and data at ZeRO 3 with ``overlap_comm`` and the
    gather prefetch armed (``stage3_prefetch_bucket_size``, one block a
    bucket) and the default persistence threshold (the norms whole), 1
    warm-up and 3 timed steps: losses and the fp32 master bit-equal to
    stage 24's ZeRO-0 run, step ms, tokens/s, MFU and peak beside ZeRO 0's,
    the all-gathers and reduce-scatters a step from the comms logger equal
    to the plan's (each micro-step one gather a block and of the outer unit
    in forward, one a block in backward, one reduce-scatter a unit; the
    persistent unit gathered after the step), exact launches (flash 8 a
    micro-step, Adam once a step); then 2 steps of ``fusedlamb`` at ZeRO 3
    and at ZeRO 0, bit-equal, LAMB's two phases once a step;
26. save and resume (``runtime/checkpoint_engine.py``), into a temporary
    directory on local disk that the stage removes: (a) stage 23's GPT-2
    350M, fp16, ZeRO 1: 3 steps, ``save_checkpoint(async_save=True)``, 3
    more steps; (b) stage 25's model at ZeRO 3 (``overlap_comm``,
    prefetch), bf16: 2 steps, a synchronous save, 2 more steps.  Each time a
    fresh engine from the same config and seed loads the tag and takes the
    same steps: losses bit-equal, loss scale, skipped steps and lr equal,
    the fp32 master ``torch.equal`` (just after the load to the saved one,
    after the steps to the first run's), the same flash and Adam launches.
    (b) then writes ``save_16bit_model`` (one unit gathered at a time: the
    peak beyond the memory before it at most the largest unit) and holds
    ``zero_to_fp32``'s consolidation of the tag to the saved master bit for
    bit.  Printed a configuration: free disk before the save, bytes of
    each file, the seconds the save took to return, to write and to commit
    (wait), the CRC verification's and the load's seconds, and GB/s.  (b)
    is cut in depth, full width kept, when the disk cannot hold its tag.
27. offload, in this order: (a) ZeRO-Infinity parameter streaming at
    Llama-2-13B width (``offload_param`` and ``offload_optimizer`` cpu,
    the host Adam, bf16, B=4, S=2048), its depth the most blocks whose
    host state fits 0.7 × ``MemAvailable`` (the reckoning printed): 1
    warm-up and 3 timed steps, step ms, tokens/s, MFU, peak HBM, host
    bytes, the host sweep's and the H2D/D2H copies' seconds,
    ``max_resident_blocks`` ≤ 3, exact B1 launches (2 forwards a block a
    step: the backward recomputes); then 2 blocks at that width streamed
    and through the ordinary engine at ZeRO 0 from the same weights and
    data, losses within 2^-7 relative; (b) the same width with
    ``offload_optimizer: nvme`` in a temporary directory on local disk
    (cut to what 0.7 of the free disk holds at 12 bytes an element, and
    to one block for the time limit): 2 steps, the aio engine that ran,
    the bytes swapped a step and GB/s; (c) stage 25's model at ZeRO 3
    (``overlap_comm``), bf16, 2 steps of 2 micro-steps with
    ``offload_optimizer: cpu`` and without, FusedLamb (B3) and FusedAdam
    (B2): losses, the fp32 master and the launches bit-equal, the master
    and moments ``is_pinned()``, peak HBM of the second step at least 0.95
    × 12 bytes an element lower; (d) in the Adam offload run,
    ``offload_states()`` then ``reload_states()`` after the first step:
    the freed HBM printed, the next step bit-equal to the run without the
    round trip.  ``MemAvailable`` (after each run) and the free disk are
    printed, and after each ZeRO-3 engine of (c) the card memory still
    allocated and the live CUDA tensors above 256 MB (ROADMAP queue C3);
28. ZeRO++ on one card: (a) the wire codecs (``comm/collectives/
    quantized.py``) on one 7B-width block's flat bf16 buffer (202,383,360
    elements from the seed): int8 and int4 (B5's quantize, contiguous
    route, and dequantize), fp8 (the e4m3fn cast, no kernel), fp6 and
    fp12 (B6 and the plain decode), at groups of 2048 and 128; codes,
    scales and decode bit-equal to the plain versions on the card; ms
    against the bytes bound, launches by route, and ``quantized_wire_bytes``
    against the bf16 bytes; (b) ``quantized_all_gather``,
    ``all_to_all_quant_reduce``, ``hierarchical_quant_reduce_scatter``
    (a 1 × 1 hierarchy) and ``quantized_all_to_all`` on the NCCL world of
    one rank, where each exchange is a copy, bit-equal to the plain
    composition of codec, copy and decode; (c) stage 25's ZeRO-3 engine
    with ``zero_quantized_weights`` and ``zero_quantized_gradients``:
    every quantized collective declines at one rank (as in JAX), so its 4
    steps are stage 25's bit for bit (losses, the master's digest,
    launches), and its dispatch counters are all ``flat_fallback``;
29. pipeline and Ulysses at GPT-3 13B width (d_model 5120, 40 heads of
    128, vocabulary 50257): (a) ``sequence/layer.py:DistributedAttention``
    at sp = 1 on bf16 [1, 2048, 40, 128], forward and backward: exactly
    one launch of each B1 kernel, the output bit-equal to B1's forward and
    the output and dq, dk, dv within B1's tolerance of the plain version
    (the backward's on the kernel's o and lse); B1 at the shape Ulysses
    hands it at sp = 2, [1, 2048, 20, 128], against its plain version,
    SDPA and the bound; (b) ``models/gpt2.pipeline_module`` cut to 4
    blocks (tied embedding and head, remat a block) through
    ``initialize()`` → ``PipelineEngine`` at pp = 1 on the NCCL world of
    one rank, M = 4 microbatches of [1, 2048], ZeRO 1, bf16, fusedadam,
    3 steps, against the base engine on ``to_module()`` of the same
    module: losses and master digest bit-equal, and exactly 2·4·4, 4·4,
    4·4 B1 launches and one B2 launch a step in each;
30. the universal bridge of streaming and the 1-bit optimizers on one
    card: (a) a ZeRO-Infinity streamed engine at Llama-2-7B width cut to 2
    blocks (bf16, B=4, S=2048, the host Adam) takes 2 steps and saves its
    tag, which ``convert_to_universal`` turns into the universal layout;
    a ZeRO-3 engine on the card and a fresh streamed engine each load it
    and take the next 2 steps: their losses within 2e-3 relative of the
    streamed engine that went on without stopping, B1 launched in each
    (B2 in the ZeRO-3 one); the save's, the conversion's and each load's
    seconds and the universal bytes; (b) the 1-bit codec
    (``runtime/comm/compressed.py``) on a 7B block's 202,383,360 fp32
    elements from the seed: ``pack_signs``, ``unpack_signs`` and one
    rank's compression (corrected input, scale, packed signs, new worker
    error) bit-equal to the same functions on the CPU copy, with their ms
    beside the bytes bound; (c) OnebitAdam, OnebitLamb and ZeroOneAdam
    through ``initialize()`` at one rank on GPT-2 350M in fp16 (B=8,
    S=1024, one fixed batch, warm-up of 2 steps), 5 steps each: finite
    losses that fall, B1 as the model's attention and no optimizer kernel
    launched (the 1-bit leaf updates are plain PyTorch), and an injected
    fp16 overflow that leaves every piece of the state bit-unchanged
    (digests before and after) and is counted as skipped.
31. MoE training on one card: (a) B7's backward at Mixtral-8x7B's
    products, T = 16,384 token copies (B=4, S=2048, top-2) routed by a
    random router over 8 experts with one forced empty: ``gmm_dx`` and
    ``gmm_dw`` for w1 [8, 4096, 14336] and w2 [8, 14336, 4096] against
    their plain versions (one bf16 ulp of |ref| plus 2^-10 of the
    product's rms: both sum thousands of fp32 products in other orders),
    two reruns bit-equal, ms beside the flop bound, TFLOP/s, the plain
    versions' and ``torch._grouped_mm``'s ms (a yardstick only), the SASS
    counts (HGMMA and UTMALDG: both on wgmma + TMA), and w1's ``gmm_dw``
    again on ``route="mma_sync"`` (HMMA: the kernel of the 16-bit shapes
    TMA cannot take); (b) Mixtral-8x7B width (hidden 4096, FFN 14336, 32/8
    heads, 8 experts, top-2, vocab 32000) cut to 1 layer, bf16, B=4,
    S=2048, ZeRO 0, ``fusedadam``, remat, through ``initialize()``: 4
    steps whose losses are finite and fall, the launches of B7 (forward
    twice a layer under remat, dx, dw, by route), B1 and B2 counted from
    0 around them, step ms, tokens/s, MFU
    on the active parameters (6·N_active + 12·L·S·D a token, N_active = N
    − L·(E − k)·3·D·I), peak; then one step at a narrow width (hidden
    1024, 2 layers) in bf16 with the kernels, in bf16 with every plain
    version and in fp32 with the plain versions: loss and norm within
    2^-7 of the plain bf16 step, and each leaf's gradient no further from
    the fp32 step's than twice the plain bf16 step's plus 2^-7 (L2,
    relative); (c) the MoE layer of the MoE tests' model at hidden 4096
    (8 experts of 4 × 4096, top-2, capacity factor 1.25, 8192 tokens,
    bf16) through engine steps on the NCCL world of one rank, with
    ``moe`` off and with the int8 ``quantized_dispatch``: bit-equal (one
    rank exchanges nothing, as in JAX).

32. pipeline ZeRO: stage 29 (b)'s model and batches (GPT-3 13B width,
    4 blocks, M = 4 microbatches of 1 × 2048, bf16, ``fusedadam``, remat,
    NCCL world 1) through the ``PipelineEngine`` at pp = 1 under ZeRO 3,
    ZeRO 2 with ``overlap_comm`` and ZeRO 1 with ``offload_optimizer:
    cpu`` (master and moments pinned on the host, B2 updating them in
    place), each against the base engine on ``to_module()`` at the same
    configuration: 3 steps, losses and master digest bit-equal, B1's and
    B2's launches (counted from 0 around each run) those the schedule
    implies, step ms and peak; the ZeRO-3 pipeline engine saves a tag
    after step 2 (seconds, GB, files), a fresh engine loads it (seconds)
    and its step 3 equals the unbroken run's, loss and master digest.

33. tensor parallelism at one rank: (a) stage 8's model, config, weights
    and batch with its linears and embedding replaced by
    ``module_inject``'s parallel modules (``shard_params_for_tp`` over a
    tp group of one rank, ``llama.tp_rules``): 2 + 2 steps whose losses
    are bit-equal to stage 8's first four, B1's and B2's launches counted;
    (b) stage 4's Llama-2-7B weights loaded into a model cut by
    ``shard_params_for_tp`` at tp 1 before the load (the order the tp path
    takes) and served with ``tensor_parallel.tp_size`` 1: stage 4's
    requests give stage 4's greedy tokens bit for bit, B4's launches
    counted on their routes; (c) B4 at the heads a tp rank holds (Llama-2-
    7B at tp 4: H = Hkv = 8; Mistral-7B at tp 4: H = 8, Hkv = 2; Llama-2-
    70B at tp 8: H = 8, Hkv = 1, the shape of replicated-kv GQA) and B7 at
    Mixtral-8x7B's expert slices at tp 4 (w1 [8, 4096, 3584], w2 [8,
    3584, 4096]), decode and prefill, each against its plain version on
    its route (B7 ``wgmma_tma``/``wgmma_tma_64``).

34. long-context training, every fold on B1: (a) ring attention's own
    function with the sp = 4 blocks of one card in the ring's order (the
    exchange replaced by indexing; ``ring_attention_blocks``) at
    Llama-2-7B width, [1, 32768, 32, 128] bf16, causal, forward and
    backward, against B1 over the whole sequence and, at S = 4096, against
    the plain version (o, dq, dk, dv within 2^-7 of each tensor's norm and
    2^-5 of its largest element), B1's launches exactly 10 / 10 / 10 (the
    10 live pairs of a causal ring of four), ms beside B1 whole and SDPA,
    peak; again with Hkv = 8 (k/v at their own width); (b) FPDT's
    host-streamed attention (bench.py's card shape: B 1, H 8, D 128,
    chunks of 8192 to 131072 positions): every stored chunk pinned, the
    16 outputs against B1 over all positions, tokens/s with and without
    ``double_buffer``, a call's working set at 64K and 128K context flat
    within one chunk pair, 136 B1 launches a stream; ``chunked_attention``
    forward and backward at [1, 32768, 32, 128], chunks of 4096, against
    B1 whole (launches 72 / 36 / 36: the checkpoint reruns the forward);
    (c) the fused chunked head + loss at Llama-2-7B's head (N 8192, D
    4096, V 32000, chunks of 4096) against the full-logits loss: loss,
    dx, dw, ms and a lower peak; (d) stage 8's model and batch with
    ``loss_chunk_vocab`` 4096 (losses within 2^-7 of the scale of stage
    8's, as they fall from 11 to 0.003) and with
    ``remat_policy="dots_saveable"`` (bit-equal to stage 8's; B1's
    forward kept, so launches stay 8 / 8 / 8 a step): 4 steps each, step
    ms, peak, B1 and B2 launches; and a two-block user model through
    ``deepspeed_tpu_torch.checkpointing.checkpoint`` with
    ``cpu_checkpointing`` (an input projection, two MLP blocks, an LM head
    over 32000): gradients bit-equal to the plain checkpoint's, a lower
    peak.

35. item 9b's remainder at one rank: (a) stage 8's step with ``domino``
    (two µ-streams of 2 rows): 4 steps, losses within 2^-7 of the scale
    of stage 8's first four, step ms beside stage 8's, B1's launches twice stage 8's
    at half the batch, and ``measure_tp_overlap``'s report at tp 1, where
    no tp collective exists; (b) GPT-2 350M (stage 11's fp16 ``fusedlamb``
    step) with its model cut by ``shard_params_for_tp`` at tp 1 on
    ``gpt2.tp_rules``: 3 steps bit-equal to stage 11's first three; then
    the padded-vocabulary route (3 zero rows appended to ``wte``, the
    vocabulary-parallel loss) from the same weights, losses within 2^-7;
    BERT-base (stage 22's config and batch) cut at tp 1 on the rules
    derived from its dataflow, under PyTorch's deterministic algorithms:
    3 steps' losses and the master bit-equal to the plain model's (the
    plain model run twice beside them); B1, B2, B3 launches counted; (c)
    ``fused_attention`` over a CLIP ViT-L/14 text encoder (12 layers, 12 heads of 64, 77
    tokens, causal, fp16) and Stable Diffusion 2.1's top UNet attention
    (320 channels, 5 heads of 64, a 96 × 96 latent: 9216 tokens), port
    modules with transformers' and diffusers' class names and layouts:
    outputs against the module's own attention and against B1's plain
    version through the same injection (2^-7 of the norm, 2^-5 of the
    largest element), B1 launches and the fused / fallback counts, ms and
    peak of each; a cross-attention call (77 tokens of width 1024) takes
    the counted fallback, bit-equal to the module; a forced kernel failure
    raises; (d) the vocabulary-parallel chunked loss at tp 1 on GPT-2
    350M's tied head padded by 3 rows (N 8192, V 50257, fp32) against the
    full logits: loss, dx, dw within 1e-4 of the norm, the pad rows'
    gradient 0, ms and peak.
36. Item 8b (MoE's remainder) at one rank: (a) B7's forward, dx and dw at
    the shapes Mixtral-8x7B's training gives them at tp 2 and tp 4 (the
    stacks cut on I: [8, 4096, 7168], [8, 7168, 4096], [8, 4096, 3584],
    [8, 3584, 4096]) and at ep 4 (a rank's two experts, [2, 4096, 14336],
    [2, 14336, 4096]), T 16,384, one expert empty, and at ep 4 as the
    exchange hands them over (65,536 gathered copies of four ranks' 8192
    tokens, about a quarter routed to the rank's two experts, the rest
    past the sizes: zero out of the forward and dx, unread by dw), each
    against its plain version with its ms, bound and
    ``torch._grouped_mm``'s ms; then the expert FFN forward and backward
    on those gathered copies against their live rows alone (ms and peak:
    what the rows past the sizes cost a layer a step); (b) stage
    31 (b)'s Mixtral through the tp code at tp 1 (``tp_rules`` over a
    one-rank group) and the ep code at ep 1 (each block localized over a
    one-rank ep group, its gathers and reduce-scatter the identity):
    losses and B7's launches by route bit-equal to stage 31 (b)'s; (c) the
    MoE layer under qgZ with the 2-hop int8 dispatch asked for, on the
    NCCL world of one rank: the qgZ micro's per-rank path and the 2-hop
    split each decline once (counted), the loss the flat run's.

``--profile DIR`` adds ``torch.profiler`` windows over serving (stages 4,
14 and 15), over two training steps of stage 8, of stage 11, of stage 22
and of each ZeRO stage of stages 23-25, and
over three MSA-row Evoformer calls (stage 18's first shape, run right
after the build, as the process's first window): device time by kind and
the idle share.  A window that kept fewer device records of a kernel than
its wrappers launched reports its breakdown as not measured.

Prints a ``{"kernels": [...]}`` line, then, last, the device line
``{"ok": true, "device": {...}}``.  Exits non-zero without a result when
torch sees no CUDA device, the package is not beside this script, or
``DS_TPU_DISABLE_PALLAS_ATTN`` or ``DS_TPU_DISABLE_PALLAS_PAGED`` (which
turn the attention kernels and the paged one off) is set.
"""

import argparse
import gc
import json
import math
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
# one Llama-2-7B block's elements: 4 · 4096² + 3 · 4096 · 11008 + 2 · 4096
BLOCK_7B = 202_383_360
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor rate
# kernel vs plain, elementwise: both accumulate in fp32 and round the
# output once, so in bf16 they may differ by one ulp of |ref| (at most
# 2^-7·|ref|) plus the fp32 differences of another summation order
BF16_RTOL, BF16_ATOL = 2.0**-7, 1e-4
FP16_RTOL = 2.0**-10             # the same, for fp16's 11 significant bits
FP32_ATOL = 1e-4
# fp32 outputs of the flash kernels (lse, delta, the fp32 case): the same
# fp32 arithmetic in another summation order
FP32_RTOL = 1e-5
# the fused Adam kernel and its plain version do the same fp32 operations
# in the same order (none contracted into an FMA): equal up to one fp32 ulp
# for master/m/v, one bf16 ulp for the bf16 copy
ADAM_RTOL, ADAM_BF16_RTOL = 2.0**-23, 2.0**-8


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, iters, warmup=2):
    """Mean milliseconds per call over ``iters`` calls, CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _free(torch):
    """Return the card memory of what was just deleted: an engine holds
    reference cycles (its optimizer facade points back at it), so ``del``
    alone leaves it to a later garbage collection, which would then land
    inside another stage's timed steps and memory figures."""
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- stage 1
def stage_environment():
    import torch
    nvcc = "nvcc not found"
    from deepspeed_tpu_torch.ops.op_builder import find_nvcc
    try:
        out = subprocess.run([find_nvcc(), "--version"], capture_output=True,
                             text=True, timeout=60).stdout
        nvcc = out.strip().splitlines()[-1]
    except (RuntimeError, OSError) as e:
        nvcc = f"nvcc unavailable: {e}"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} | {nvcc}")
    log(f"[env] card: {torch.cuda.get_device_name(0)} "
        f"(count {torch.cuda.device_count()})")
    return smi


# ---------------------------------------------------------------- stage 2
FB_PASSES = ("fwd", "dq", "dkv", "dbias")


def stage_build():
    from deepspeed_tpu_torch.ops.op_builder import build_all
    t0 = time.perf_counter()
    results = build_all()
    for name, (secs, out) in results.items():
        log(f"[build] {name}: {secs:.1f} s")
        for line in out.splitlines():
            if "ptxas" in line and ("registers" in line or "spill" in line
                                    or "Compiling" in line):
                log(f"[build]   {line.strip()}")
    from deepspeed_tpu_torch.ops.op_builder import PagedAttentionBuilder
    lib = PagedAttentionBuilder().load()
    log("[build]   paged_attention fp32 route, dynamic shared memory per "
        "block (bytes): " + ", ".join(
            f"Dh{dh}/rows{rm} {lib.ds_paged_attention_smem_bytes(0, dh, rm)}"
            for dh in (64, 128) for rm in (1, 4, 16)))
    usage = _ptxas_usage(results["paged_attention"][1], _pa_key)
    for key, u in sorted(usage.items()):
        kind, dtype, dh, rt, pad = key
        extra = ""
        if kind == "mma":
            code = 1 if dtype == "bf16" else 2
            # a padded kernel's occupancy, asked for a head it pads
            head = dh - 2 * pad
            extra = (f", {lib.ds_paged_attention_smem_bytes(1, dh, rt)} B "
                     f"dynamic shared memory, "
                     f"{lib.ds_paged_attention_blocks_per_sm(code, head, rt)}"
                     f" blocks an SM")
        log(f"[build]   paged_attention {kind} {dtype}"
            + (f" Dh{dh}{' padded' if pad else ''} row tiles {rt}"
               if kind == "mma" else "")
            + f": {u.get('registers', '?')} registers, "
            f"{u.get('spill_stores', '?')} B spill stores, "
            f"{u.get('spill_loads', '?')} B spill loads, "
            f"{u.get('stack', '?')} B stack{extra}")
    if len(usage) != 34:
        raise AssertionError(f"ptxas -v reported {len(usage)} of the 34 "
                             f"tensor-core and merge paged_attention "
                             f"kernels")
    spilled = [k for k, u in usage.items()
               if u.get("spill_stores") or u.get("spill_loads")]
    if spilled:
        raise AssertionError(f"paged_attention kernels spill: {spilled}")
    from deepspeed_tpu_torch.ops.op_builder import FlashAttentionBuilder
    from deepspeed_tpu_torch.ops.kernels.flash_attention import (
        FP32_ROUTE_PASS)
    flib = FlashAttentionBuilder().load()
    log("[build]   flash_attention fp32 route, dynamic shared memory per "
        "block (bytes): " + ", ".join(
            f"{name}/D{d} {flib.ds_flash_smem_bytes(FP32_ROUTE_PASS + i, d)}"
            for i, name in enumerate(("fwd", "dq", "dkv"))
            for d in (64, 128)))
    usage = _ptxas_usage(results["flash_attention"][1])
    for (kernel, dtype, dp), u in sorted(usage.items()):
        smem = flib.ds_flash_smem_bytes(("fwd", "dq", "dkv").index(kernel),
                                        dp)
        log(f"[build]   flash_attention tensor-core {kernel} {dtype} D{dp}: "
            f"{u.get('registers', '?')} registers, "
            f"{u.get('spill_stores', '?')} B spill stores, "
            f"{u.get('spill_loads', '?')} B spill loads, "
            f"{u.get('stack', '?')} B stack, {smem} B dynamic shared memory")
    if len(usage) != 12:
        raise AssertionError(f"ptxas -v reported {len(usage)} of the 12 "
                             f"tensor-core flash kernels")
    from deepspeed_tpu_torch.ops.op_builder import FlashBiasBuilder
    from deepspeed_tpu_torch.ops.kernels.flash_bias import (
        FP32_ROUTE_PASS, MMA_FP32_BIAS_PASS)
    blib = FlashBiasBuilder().load()
    log("[build]   flash_bias fp32 route, dynamic shared memory per block "
        "(bytes): " + ", ".join(
            f"{name}/D{d} "
            f"{blib.ds_flash_bias_smem_bytes(FP32_ROUTE_PASS + i, d)}"
            for i, name in enumerate(FB_PASSES) for d in (32, 128)))
    usage = _ptxas_usage(results["flash_bias"][1], _fb_mma_key)
    for (kernel, dtype, bdtype, dp), u in sorted(usage.items()):
        route = MMA_FP32_BIAS_PASS if bdtype == "fp32" else 0
        smem = blib.ds_flash_bias_smem_bytes(
            route + FB_PASSES.index(kernel), dp)
        log(f"[build]   flash_bias tensor-core {kernel} {dtype} bias "
            f"{bdtype} D{dp}: {u.get('registers', '?')} registers, "
            f"{u.get('spill_stores', '?')} B spill stores, "
            f"{u.get('spill_loads', '?')} B spill loads, "
            f"{u.get('stack', '?')} B stack, {smem} B dynamic shared memory")
    if len(usage) != 48:
        raise AssertionError(f"ptxas -v reported {len(usage)} of the 48 "
                             f"tensor-core flash bias kernels")
    from deepspeed_tpu_torch.ops.op_builder import \
        BlockSparseAttentionBuilder
    slib = BlockSparseAttentionBuilder().load()
    log("[build]   block_sparse_attention dynamic shared memory per block "
        "(bytes), fp32 route: " + ", ".join(
            f"block{b}/D{d} "
            f"{slib.ds_block_sparse_attention_smem_bytes(b, d, 0)}"
            for b in (16, 64) for d in (64, 128)) + "; tensor cores: " +
        ", ".join(f"D{d} {slib.ds_block_sparse_attention_smem_bytes(16, d, 1)}"
                  for d in (16, 32, 64, 128)))
    for name, key_fn, want in (("block_sparse_attention", _bsa_mma_key, 8),
                               ("grouped_matmul", _gmm_tma_key, 4),
                               ("grouped_matmul", _gmm_dx_key, 4),
                               ("grouped_matmul", _gmm_dw_key, 6)):
        usage = _ptxas_usage(results[name][1], key_fn)
        for key, u in sorted(usage.items()):
            log(f"[build]   {name} {key}: {u.get('registers', '?')} "
                f"registers, {u.get('spill_stores', '?')} B spill stores, "
                f"{u.get('spill_loads', '?')} B spill loads, "
                f"{u.get('stack', '?')} B stack")
        if len(usage) != want:
            raise AssertionError(f"ptxas -v reported {len(usage)} of the "
                                 f"{want} new {name} kernels")
    # the one-pass group kernels of B5's quantize and B6: one line per
    # input type and encoder, a kernel per units a lane holds (0: read
    # twice), "w" for whole, aligned groups
    for name, want in (("quantizer", 27), ("fp_quantizer", 81)):
        usage = _ptxas_usage(results[name][1], _gq_key)
        lines = {}
        for (dtype, units, whole, enc), u in sorted(
                usage.items(), key=lambda kv: str(kv[0])):
            lines.setdefault((dtype, enc), []).append(
                f"{units}{'w' if whole else ''} "
                f"{u.get('registers', '?')}"
                + (f" (spills {u.get('spill_stores')}/"
                   f"{u.get('spill_loads')} B)"
                   if u.get("spill_stores") or u.get("spill_loads") else ""))
        for (dtype, enc), parts in sorted(lines.items(), key=str):
            log(f"[build]   {name} group_kernel {dtype} {enc}: registers "
                f"by units a lane: " + ", ".join(parts))
        if len(usage) != want:
            raise AssertionError(f"ptxas -v reported {len(usage)} of the "
                                 f"{want} {name} group kernels")
        spilled = [k for k, u in usage.items()
                   if u.get("spill_stores") or u.get("spill_loads")]
        if spilled:
            raise AssertionError(f"{name} group kernels spill: {spilled}")
    log(f"[build] all kernels: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------- stage 3
def _paged_case(torch, gen, *, H, Hkv, atom, n_tiles, max_ctx, window,
                min_ctx=1, table_ctx=None, Dh=128, bs=128, dtype="bfloat16"):
    """Tiles of one sequence each, on distinct pages: tile i holds
    ``atom`` consecutive positions ending at a context drawn in
    [max(min_ctx, atom), max_ctx]; block tables cover ``table_ctx``
    tokens (default ``max_ctx``)."""
    dtype = getattr(torch, dtype)
    dev = "cuda"
    maxb = -(-(table_ctx or max_ctx) // bs)
    T = n_tiles * atom
    nb = 1 + n_tiles * maxb
    q = torch.randn(T, H, Dh, device=dev, generator=gen).to(dtype)
    kc = torch.randn(nb, bs, Hkv, Dh, device=dev, generator=gen).to(dtype)
    vc = torch.randn(nb, bs, Hkv, Dh, device=dev, generator=gen).to(dtype)
    pages = 1 + torch.randperm(nb - 1, device=dev, generator=gen).int()
    ends = torch.randint(max(min_ctx, atom), max_ctx + 1, (n_tiles, ),
                         device=dev, generator=gen)
    tables = pages.view(n_tiles, maxb).repeat_interleave(atom, dim=0)
    pos = (ends.repeat_interleave(atom) - atom
           + torch.arange(atom, device=dev).repeat(n_tiles)).int()
    return q, kc, vc, tables.contiguous(), pos.contiguous()


def _bound(q, kc, tables, pos, atom, window):
    """Least time on the card: bytes of q, of the K and V rows of every key
    some row of a tile attends to (each cache slot read once, found through
    the tile's first row's table) and of the output, against the score and
    P·V flops the positions need, at the published H100 peaks."""
    T, H, Dh = q.shape
    _, bs, Hkv, _ = kc.shape
    pos_h = pos.cpu().tolist()
    tab_h = tables.cpu().tolist()
    slots = set()
    for t0 in range(0, T, atom):
        tile = pos_h[t0:t0 + atom]
        lo = max(0, min(tile) - window + 1) if window else 0
        table = tab_h[t0]
        slots.update((table[k // bs], k % bs)
                     for k in range(lo, max(tile) + 1))
    esz = q.element_size()
    slot_bytes = 2 * Hkv * Dh * esz                      # K and V
    nbytes = 2 * q.numel() * esz + len(slots) * slot_bytes
    keys = sum(min(p + 1, window) if window else p + 1 for p in pos_h)
    flops = 4 * Dh * H * keys
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _plain(pa, q, kc, vc, first, pos, window, rows=64):
    """The plain version, ``rows`` query rows at a time (its gather holds
    [rows, table context, Hkv, Dh] K and V in fp32)."""
    import torch
    return torch.cat([
        pa.paged_attention_plain(q[i:i + rows], kc, vc, first[i:i + rows],
                                 pos[i:i + rows], window)
        for i in range(0, q.shape[0], rows)])


def _sdpa_ms(torch, q, kc, vc, tables, pos, atom, window):
    """One library call computing the same function on K/V already
    gathered per tile (the gather is outside the timing)."""
    import torch.nn.functional as F
    T, H, Dh = q.shape
    _, bs, Hkv, _ = kc.shape
    n = T // atom
    first = tables[::atom].long()                       # [n, maxb]
    ctx = first.shape[1] * bs

    def gather(cache):
        kv = cache[first].reshape(n, ctx, Hkv, Dh).transpose(1, 2)
        return kv.repeat_interleave(H // Hkv, dim=1).contiguous()

    k, v = gather(kc), gather(vc)
    qq = q.view(n, atom, H, Dh).transpose(1, 2).contiguous()
    col = torch.arange(ctx, device=q.device)
    p = pos.view(n, atom).long()[:, :, None]
    mask = col <= p
    if window:
        mask &= col > p - window
    mask = mask[:, None]                                 # [n, 1, atom, ctx]

    def run():
        return F.scaled_dot_product_attention(qq, k, v, attn_mask=mask)

    ms = cuda_ms(run, 10)
    out = run().transpose(1, 2).reshape(T, H, Dh)
    del k, v
    return ms, out


def _pa_flops(q, pos, window):
    """Useful flops of a paged attention call: 4·Dh per (query row, key it
    attends to), over every head."""
    T, H, Dh = q.shape
    keys = sum(min(p + 1, window) if window else p + 1
               for p in pos.cpu().tolist())
    return 4 * Dh * H * keys


def _paged_row(torch, gen, pa, name, wrapper, line, shape):
    """One paged attention case: the launch must take the route
    ``launch_plan`` gives these shapes, twice bit for bit, within the
    tolerance of the plain version; the times of the kernel, the plain
    version, SDPA and the bound."""
    q, kc, vc, tables, pos = _paged_case(torch, gen, **shape)
    atom, window = shape["atom"], shape["window"]
    fn = getattr(pa, wrapper)
    args = (q, kc, vc, tables, pos) + ((atom, ) if atom > 1 else ())
    route, splits, span, row_tiles = pa.launch_plan(
        q.dtype, q.shape[0], shape["H"], shape["Hkv"], tables.shape[1],
        atom)
    before = dict(fn.route_launches)
    got = fn(*args, window=window)
    again = fn(*args, window=window)
    torch.cuda.synchronize()
    taken = {r: n - before[r] for r, n in fn.route_launches.items()
             if n != before[r]}
    if taken != {route: 2}:
        raise AssertionError(f"{name}: launches by route {taken}, want "
                             f"two on {route}")
    bit_equal = torch.equal(got, again)
    first = pa._first_row_tables(tables, atom)
    ref = _plain(pa, q, kc, vc, first, pos, window)
    low = {torch.bfloat16: "bf16", torch.float16: "fp16"}.get(q.dtype)
    diff = (got.float() - ref.float()).abs()
    if low is None:
        tol, tol_text = FP32_ATOL, f"{FP32_ATOL:g}"
    else:
        rtol = FP16_RTOL if low == "fp16" else BF16_RTOL
        tol = rtol * ref.float().abs() + BF16_ATOL
        tol_text = (f"2^-{10 if low == 'fp16' else 7}·|ref| + "
                    f"{BF16_ATOL:g}")
    err = diff.max().item()
    worst = (diff / tol).max().item()
    ms = cuda_ms(lambda: fn(*args, window=window), 20)
    plain_ms = cuda_ms(lambda: _plain(pa, q, kc, vc, first, pos,
                                      window), 3, warmup=1)
    lib_ms, lib_out = _sdpa_ms(torch, q, kc, vc, tables, pos, atom,
                               window)
    lib_err = (lib_out.float() - ref.float()).abs().max().item()
    bound_ms, bound_by = _bound(q, kc, tables, pos, atom, window)
    tflops = _pa_flops(q, pos, window) / ms / 1e9
    plan = (f"route {route}" + (f", {splits} splits of {span} pages"
                                if route == "decode_split" else "")
            + (f", {row_tiles} row tiles" if route != "fp32" else ""))
    log(f"[kernel] {name}: T={q.shape[0]} H={shape['H']} "
        f"Hkv={shape['Hkv']} atom={atom} window={window} "
        f"ctx<={shape['max_ctx']} table={tables.shape[1] * kc.shape[1]}: "
        f"{shape.get('dtype', 'bfloat16')}, {plan}: max_abs_err "
        f"{err:.3e}, worst |err| / ({tol_text}) {worst:.3f}, rerun "
        f"bit-equal {bit_equal} | kernel {ms:.4f} ms ({tflops:.1f} "
        f"TFLOP/s, {bound_ms / ms:.3f} of the bound), plain "
        f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms (err {lib_err:.2e}), "
        f"bound {bound_ms:.4f} ms by {bound_by}")
    if not worst <= 1.0:
        raise AssertionError(f"{name}: kernel differs from its plain "
                             f"version by {worst} × ({tol_text})")
    if not bit_equal:
        raise AssertionError(f"{name}: two runs on the same inputs "
                             f"differ")
    dh = q.shape[2]
    tile = 64 if dh <= 64 else 128
    key = ("mma", low, tile, row_tiles, dh != tile) if low else None
    row = dict(key=key, case=name, wrapper=wrapper, line=line, err=err,
               err_over_tol=worst, route=route, splits=splits, span=span,
               row_tiles=row_tiles, ms=ms, plain_ms=plain_ms,
               library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
               share_of_bound=bound_ms / ms, tflops=tflops)
    del q, kc, vc, tables, pos, got, again, ref, lib_out, diff, tol
    _free(torch)
    return row


def stage_kernels(seed):
    import torch
    from deepspeed_tpu_torch.ops.kernels import paged_attention as pa
    from deepspeed_tpu_torch.ops.op_builder import PagedAttentionBuilder
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cases = [
        # (name, wrapper, replaces line, shape args); the serve_* cases
        # have the shapes stage 4 gives each wrapper (16 rows per decode
        # step, 47 atom tiles in a 768-token budget, 4096-token tables)
        # and go into the kernels line
        ("serve_decode", "paged_attention", 29,
         dict(H=32, Hkv=32, atom=1, n_tiles=16, min_ctx=128, max_ctx=2112,
              table_ctx=4096, window=0)),
        ("serve_prefill", "paged_attention_atoms", 120,
         dict(H=32, Hkv=32, atom=16, n_tiles=47, max_ctx=2048,
              table_ctx=4096, window=0)),
        ("llama7b_decode", "paged_attention", 29,
         dict(H=32, Hkv=32, atom=1, n_tiles=64, max_ctx=4096, window=0)),
        ("llama7b_prefill", "paged_attention_atoms", 120,
         dict(H=32, Hkv=32, atom=16, n_tiles=8, max_ctx=4096, window=0)),
        ("mistral7b_decode", "paged_attention", 29,
         dict(H=32, Hkv=8, atom=1, n_tiles=64, max_ctx=6144, window=4096)),
        ("mistral7b_prefill", "paged_attention_atoms", 120,
         dict(H=32, Hkv=8, atom=16, n_tiles=8, max_ctx=6144, window=4096)),
        ("llama7b_decode_fp32", "paged_attention", 29,
         dict(H=32, Hkv=32, atom=1, n_tiles=16, max_ctx=4096, window=0,
              dtype="float32")),
        ("mistral7b_prefill_fp32", "paged_attention_atoms", 120,
         dict(H=32, Hkv=8, atom=16, n_tiles=4, max_ctx=6144, window=4096,
              dtype="float32")),
        # last, so that the cases above draw the inputs they drew before
        ("serve_prefill_fp16", "paged_attention_atoms", 120,
         dict(H=32, Hkv=32, atom=16, n_tiles=47, max_ctx=2048,
              table_ctx=4096, window=0, dtype="float16")),
        # head widths the 128-column tile pads (after the cases above, for
        # the same reason): Phi-2's 80 (32 heads of 2560) and OpenLLaMA-
        # 3B's 100 (32 heads of 3200)
        ("phi2_decode_dh80", "paged_attention", 29,
         dict(H=32, Hkv=32, atom=1, n_tiles=16, min_ctx=128, max_ctx=2048,
              window=0, Dh=80)),
        ("phi2_prefill_dh80", "paged_attention_atoms", 120,
         dict(H=32, Hkv=32, atom=16, n_tiles=16, max_ctx=2048, window=0,
              Dh=80)),
        ("openllama3b_decode_dh100", "paged_attention", 29,
         dict(H=32, Hkv=32, atom=1, n_tiles=16, min_ctx=128, max_ctx=2048,
              window=0, Dh=100)),
        ("openllama3b_prefill_dh100", "paged_attention_atoms", 120,
         dict(H=32, Hkv=32, atom=16, n_tiles=16, max_ctx=2048, window=0,
              Dh=100)),
    ]
    rows = [_paged_row(torch, gen, pa, *case) for case in cases]
    reports = {}
    for key in sorted({r["key"] for r in rows if r["key"]}):
        report, counts = _kernel_report(PagedAttentionBuilder(), _pa_key,
                                        key, (" HMMA.", ))
        log(f"[kernel] paged_attention_mma_kernel {key[1:]}: "
            f"{report['registers']} registers, {report['spill_stores']} / "
            f"{report['spill_loads']} B spill stores / loads, SASS "
            f"{counts[0]} HMMA")
        if not counts[0]:
            raise AssertionError(f"no HMMA in the SASS of "
                                 f"paged_attention_mma_kernel {key}")
        reports[key] = report
    for r in rows:
        r["kernel"] = reports.get(r.pop("key"))
    return rows


# ---------------------------------------------------------------- stage 4
LLAMA2_7B_HF = dict(model_type="llama", vocab_size=32000, hidden_size=4096,
                    intermediate_size=11008, num_hidden_layers=32,
                    num_attention_heads=32, num_key_value_heads=32,
                    max_position_embeddings=4096, rms_norm_eps=1e-5,
                    rope_theta=10000.0)


def _check_paged_routes(tag, launches, routes):
    """Every bf16 paged attention launch of a serving run on the tensor-core
    routes: decode calls on decode_split, prefill atoms on atom_mma."""
    want = {"paged_attention": "decode_split",
            "paged_attention_atoms": "atom_mma"}
    by_route = {w: {r: n for r, n in routes[w].items() if n} for w in want}
    log(f"[{tag}] paged attention launches by route: {by_route}")
    for wrapper, route in want.items():
        if routes[wrapper][route] != launches[wrapper]:
            raise AssertionError(f"{tag}: {wrapper} launched "
                                 f"{launches[wrapper]} times, "
                                 f"{routes[wrapper][route]} on {route}")


def _random_hf_state(torch, hf_cfg, gen, std=0.02):
    """bf16 weights under HF names, made on the card from ``gen``."""
    from deepspeed_tpu_torch.inference.v2.model_implementations.hf_builders \
        import _llama_config_from_hf
    from deepspeed_tpu_torch.models.llama import LlamaModel
    shapes = LlamaModel(_llama_config_from_hf(hf_cfg, "bfloat16"),
                        device="meta").named_parameters()
    state = {}
    for name, p in shapes:
        t = torch.empty(p.shape, dtype=torch.bfloat16, device="cuda")
        if name.endswith("norm.weight"):
            t.fill_(1.0)
        else:
            t.normal_(0.0, std, generator=gen)
        state[name] = t
    return state


def stage_serve(seed, smi, profile_dir=None):
    import numpy as np
    import torch
    from deepspeed_tpu_torch.inference.v2 import build_engine_from_checkpoint
    from deepspeed_tpu_torch.inference.v2.checkpoint import \
        InMemoryModelEngine
    from deepspeed_tpu_torch.ops.kernels import paged_attention as pa

    gen = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    state = _random_hf_state(torch, LLAMA2_7B_HF, gen)
    engine_config = dict(
        dtype="bfloat16", decode_burst=16,
        state_manager=dict(block_size=128, num_blocks=160, max_context=4096,
                           max_ragged_sequence_count=16,
                           max_tracked_sequences=16,
                           max_ragged_batch_size=768, prefill_atom_size=16))
    eng = build_engine_from_checkpoint(InMemoryModelEngine(state),
                                       LLAMA2_7B_HF, engine_config)
    del state
    torch.cuda.synchronize()
    log(f"[serve] Llama-2-7B engine built in "
        f"{time.perf_counter() - t0:.1f} s, weights "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB incl. KV pool")

    rng = np.random.default_rng(seed)
    lengths = rng.integers(128, 2049, size=8).tolist()
    prompts = [rng.integers(0, 32000, size=n).tolist() for n in lengths]
    new_tokens = 64

    # the timed run's hooks do host work only (a count, a clock read):
    # they add no device work and no synchronisation to the engine
    steps = [0]
    step_fn = eng._step_fn

    def counted_step(*args, **kwargs):
        steps[0] += 1
        return step_fn(*args, **kwargs)

    eng._step_fn = counted_step
    first_token = {}
    schedule = eng.schedule_step

    def timed_schedule(*args, **kwargs):
        out = schedule(*args, **kwargs)
        now = time.perf_counter()
        for uid in out:
            first_token.setdefault(uid, now)
        return out

    eng.schedule_step = timed_schedule
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    for fn in (pa.paged_attention, pa.paged_attention_atoms):
        fn.launches = 0
        fn.route_launches = dict.fromkeys(pa.ROUTES, 0)
    start = time.perf_counter()
    outs = eng.generate(prompts, max_new_tokens=new_tokens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches = {"paged_attention": pa.paged_attention.launches,
                "paged_attention_atoms": pa.paged_attention_atoms.launches}
    routes = {"paged_attention": dict(pa.paged_attention.route_launches),
              "paged_attention_atoms":
                  dict(pa.paged_attention_atoms.route_launches)}
    peak = torch.cuda.max_memory_allocated()
    bursts = getattr(eng, "burst_steps", 0)
    del eng.schedule_step               # the class's method again

    # every step's logits finite: the same requests again, untimed
    finite = torch.ones((), dtype=torch.bool, device="cuda")

    def probed_step(*args, **kwargs):
        logits, kv = step_fn(*args, **kwargs)
        finite.logical_and_(torch.isfinite(logits).all())
        return logits, kv

    eng._step_fn = probed_step
    again = eng.generate(prompts, max_new_tokens=new_tokens)
    eng._step_fn = step_fn

    ttft = [first_token[u] - start for u in range(len(prompts))]
    prefill_end = max(ttft)
    n_gen = sum(len(o) for o in outs)
    log(f"[serve] prompts {lengths} (sum {sum(lengths)}), {new_tokens} new "
        f"tokens each, {steps[0]} ragged steps, "
        f"{bursts} bursts")
    log(f"[serve] wall {wall:.3f} s | prefill {sum(lengths) / prefill_end:.1f}"
        f" tok/s (prompt tokens / time to the last first token) | decode "
        f"{(n_gen - len(prompts)) / (wall - prefill_end):.1f} tok/s (later "
        f"tokens / the rest) | TTFT mean {np.mean(ttft):.3f} s max "
        f"{prefill_end:.3f} s | peak memory {peak / 2**30:.2f} GiB | {smi}")
    log(f"[serve] kernel launches in this run: {launches}")
    _check_paged_routes("serve", launches, routes)
    log(f"[serve] untimed rerun with a finiteness probe: logits finite "
        f"{bool(finite)}, same tokens as the timed run {again == outs}")
    bad = [t for o in outs for t in o if not 0 <= t < 32000]
    if any(len(o) != new_tokens for o in outs) or bad:
        raise AssertionError(f"generate gave wrong lengths or tokens {bad}")
    if not bool(finite):
        raise AssertionError("non-finite logits in the serving run")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    if eng.state_manager.free_blocks != eng.kv_cache.num_blocks - 1:
        raise AssertionError("blocks leaked after generate")
    result = dict(outs=outs, wall_s=wall,
                  prefill_tok_s=sum(lengths) / prefill_end,
                  decode_tok_s=(n_gen - len(prompts)) / (wall - prefill_end),
                  ttft_mean_s=float(np.mean(ttft)), ttft_max_s=prefill_end,
                  peak_bytes=peak, steps=steps[0], bursts=bursts,
                  launches=launches, route_launches=routes,
                  prompt_lengths=lengths)
    if profile_dir:
        prompts = [rng.integers(0, 32000, size=n).tolist() for n in lengths]
        result["profile"] = profile_serve(eng, prompts, profile_dir, smi)
    del eng
    _free(torch)
    return result


def _profile_window(stem, body, kind, out_dir, smi, expect=None):
    """``torch.profiler`` over ``body()``: device time by kernel, summed by
    ``kind(kernel name)``, and the device's idle share as 1 - busy / wall
    of the window (profiling slows the host, so the share is an upper
    bound).  Writes the top kernels to ``out_dir/<stem>.txt``.  ``expect``
    ({kind: launches}, or a callable giving it after the body): when the
    profiler kept fewer device records of a kind than were launched, the
    breakdown is "not measured" (None), never a partial one."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        body()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        k = kernels.setdefault(e.key, [0.0, 0])
        k[0] += us
        k[1] += e.count
    busy = sum(v[0] for v in kernels.values())
    if not busy:
        log(f"[profile] {stem}: the profiler recorded no device time: busy "
            f"time and idle share not measured")
    by_kind, records = {}, {}
    for key, (us, n) in kernels.items():
        by_kind[kind(key)] = by_kind.get(kind(key), 0.0) + us
        records[kind(key)] = records.get(kind(key), 0) + n
    expect = expect() if callable(expect) else expect
    short = {k: (records.get(k, 0), n) for k, n in (expect or {}).items()
             if records.get(k, 0) < n}
    if short:
        log(f"[profile] {stem}: the profiler kept fewer device records "
            f"than launches (kept, launched) {short}: breakdown not "
            f"measured")
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{stem}.txt"), "w") as f:
        f.write(f"{smi}\nwindow {stem}: wall {wall_us / 1e3:.3f} ms, "
                f"device busy {busy / 1e3:.3f} ms\n")
        for key, (us, n) in top:
            f.write(f"{us / 1e3:12.3f} ms {n:8d}  {key[:150]}\n")
    measured = busy and not short
    out = dict(wall_ms=wall_us / 1e3,
               busy_ms=busy / 1e3 if measured else None,
               idle_share=1 - busy / wall_us if measured else None,
               by_kind_ms=({k: v / 1e3 for k, v in by_kind.items()}
                           if measured else None),
               records=records, expected=expect)
    if not measured:
        log(f"[profile] {stem}: wall {out['wall_ms']:.1f} ms; busy time, "
            f"idle share and breakdown not measured")
        return out
    log(f"[profile] {stem}: wall {out['wall_ms']:.1f} ms, device busy "
        f"{out['busy_ms']:.1f} ms (idle share {out['idle_share']:.3f}),"
        f" by kind (ms) " + ", ".join(
            f"{k} {v:.1f}" for k, v in sorted(out["by_kind_ms"].items()))
        + (f"; records {records}" if expect else ""))
    return out


def _is_matmul(name):
    return any(k in name.lower() for k in ("gemm", "cutlass", "xmma",
                                           "sm90_", "nvjet"))


def profile_serve(eng, prompts, out_dir, smi, stem="serve"):
    """Where the serving time goes: a prefill window (``schedule_step``
    until every prompt has its first token) and a decode window (two
    16-token ``burst_decode`` calls)."""

    def kind(name):
        for k in ("paged_attention", "gmm", "dequantize"):
            if k in name:
                return k
        return "matmul" if _is_matmul(name) else "other"

    uids = list(range(100, 100 + len(prompts)))
    eng.put(uids, prompts)
    started = set()

    def prefill():
        while len(started) < len(uids):
            for uid, tok in eng.schedule_step().items():
                started.add(uid)
                eng.state_manager.get_sequence(uid).tokens.append(tok)

    def decode():
        for _ in range(2):
            eng.burst_decode(uids, max_tokens=16)

    result = dict(
        prefill=_profile_window(f"{stem}_profile_prefill", prefill, kind,
                                out_dir, smi),
        decode=_profile_window(f"{stem}_profile_decode", decode, kind,
                               out_dir, smi))
    eng.flush(uids)
    return result


# ---------------------------------------------------------------- stage 5
def stage_step_vs_plain(seed):
    """Stage 5 in bf16, then in fp16: the fp16 engine runs its kernels on
    the card (bf16 and fp16 take the same routes) and serves a request."""
    return {dtype: _step_vs_plain(seed, dtype)
            for dtype in ("bfloat16", "float16")}


def _step_vs_plain(seed, dtype):
    import numpy as np
    import torch
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    from deepspeed_tpu_torch.inference.v2.ragged_forward import \
        llama_ragged_step
    from deepspeed_tpu_torch.models.llama import LlamaModel, llama_7b
    from deepspeed_tpu_torch.ops.kernels import paged_attention as pa

    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    cfg = llama_7b(num_hidden_layers=2, dtype=dtype)
    model = LlamaModel(cfg, device="cuda").init_weights(gen)
    engine_config = dict(
        dtype=dtype, decode_burst=0,
        state_manager=dict(block_size=128, num_blocks=8, max_context=512,
                           max_ragged_sequence_count=4,
                           max_tracked_sequences=4,
                           max_ragged_batch_size=288,
                           prefill_atom_size=16))
    eng = InferenceEngineV2(model, config=engine_config)
    prompt = np.random.default_rng(seed).integers(0, 32000, 256).tolist()
    eng.put([0], [prompt])
    caches = {True: eng._kv.clone(), False: eng._kv.clone()}
    seq = eng.state_manager.get_sequence(0)
    report = []
    for step in range(5):
        toks, pos, slots, last_idx, finishing, layout = eng._build_batch()
        args = [eng._to_device(a) for a in
                (toks, pos, slots, eng.state_manager.block_table, last_idx)]
        logits = {}
        for use_kernel, kv in caches.items():
            out, _ = llama_ragged_step(
                model, kv, *args, cfg=cfg, block_size=128, layout=layout,
                use_kernel=use_kernel)
            logits[use_kernel] = out[seq.slot]
        k, p = logits[True], logits[False]
        err = (k - p).abs().max().item()
        # the paths differ only in the order of fp32 sums inside attention,
        # whose bf16 (fp16) outputs then differ by about an ulp; two layers
        # carry that to the fp32 logits
        tol = 0.02 * max(1.0, p.abs().max().item())
        top = torch.topk(k, 2).values
        margin = (top[0] - top[1]).item()
        tok = int(torch.argmax(k))
        agree = tok == int(torch.argmax(p))
        report.append((layout, err, tol, margin, agree))
        log(f"[step] {dtype} {'prefill' if step == 0 else 'decode'} layout "
            f"{layout}: logits max|kernel - plain| {err:.4e} (tol "
            f"{tol:.3e}), top-2 margin {margin:.4f}, greedy tokens agree: "
            f"{agree}")
        if not err <= tol:
            raise AssertionError(f"ragged step logits differ by {err}")
        if not agree and margin > 2 * tol:
            raise AssertionError("greedy tokens differ at a clear margin")
        seq.tokens.append(tok)          # teacher-force the kernel's token
    del eng, caches
    # one request through generate on a fresh engine of the same model
    eng = InferenceEngineV2(model, config=engine_config)
    for fn in (pa.paged_attention, pa.paged_attention_atoms):
        fn.launches = 0
        fn.route_launches = dict.fromkeys(pa.ROUTES, 0)
    out = eng.generate([prompt[:200]], max_new_tokens=8)[0]
    torch.cuda.synchronize()
    launches = {"paged_attention": pa.paged_attention.launches,
                "paged_attention_atoms": pa.paged_attention_atoms.launches}
    routes = {"paged_attention": dict(pa.paged_attention.route_launches),
              "paged_attention_atoms":
                  dict(pa.paged_attention_atoms.route_launches)}
    log(f"[step] {dtype} engine, one 200-token request through generate: "
        f"8 tokens {out}; paged attention launches {launches}")
    if len(out) != 8 or not all(0 <= t < 32000 for t in out) or \
            min(launches.values()) <= 0:
        raise AssertionError(f"the {dtype} engine did not serve: {out}, "
                             f"{launches}")
    _check_paged_routes("step", launches, routes)
    del eng, model
    _free(torch)
    return dict(steps=report, tokens=out, launches=launches,
                route_launches=routes)


# ---------------------------------------------------------------- stage 6
def stage_hf_dir(seed):
    import numpy as np
    import torch
    from deepspeed_tpu_torch.inference.v2 import build_hf_engine
    from deepspeed_tpu_torch.models.llama import LlamaModel, llama_tiny

    root = os.path.join(REPO, "build", "chip_smoke", "hf_tiny")
    os.makedirs(root, exist_ok=True)
    hf_cfg = dict(model_type="llama", vocab_size=1024, hidden_size=256,
                  intermediate_size=512, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2,
                  max_position_embeddings=256, rms_norm_eps=1e-5,
                  rope_theta=10000.0)
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump(hf_cfg, f)
    cfg = llama_tiny(**{k: v for k, v in hf_cfg.items()
                        if k != "model_type"}, dtype="float32")
    model = LlamaModel(cfg, device="cpu").init_weights(
        torch.Generator().manual_seed(seed), std=0.08)
    torch.save(model.state_dict(), os.path.join(root, "pytorch_model.bin"))
    engine_config = dict(dtype="float32", decode_burst=8,
                         state_manager=dict(
                             block_size=16, num_blocks=64, max_context=128,
                             max_ragged_sequence_count=4,
                             max_tracked_sequences=4,
                             max_ragged_batch_size=64, prefill_atom_size=16))
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, 1024, size=n).tolist() for n in (40, 17, 3)]
    outs = {}
    for device in (None, "cpu"):
        eng = build_hf_engine(root, dict(engine_config), device=device)
        outs[str(eng.device)] = eng.generate(prompts, max_new_tokens=8)
    cuda_out, cpu_out = outs["cuda:0"], outs["cpu"]
    log(f"[hf] tiny HF dir (Dh 64, GQA, fp32): card {cuda_out} | cpu "
        f"{cpu_out}")
    if cuda_out != cpu_out:
        raise AssertionError("the card's greedy tokens differ from the CPU's")


# ---------------------------------------------------------------- stage 7
_FLASH_MMA = re.compile(r"flash_(fwd|bwd_dq|bwd_dkv)_mma_kernelI"
                        r"(13__nv_bfloat16|6__half)Li(64|128)E")


def _flash_mma_key(symbol):
    """(kernel, dtype, padded D) of a tensor-core flash kernel's mangled
    name, else None."""
    m = _FLASH_MMA.search(symbol)
    if not m:
        return None
    kernel = {"fwd": "fwd", "bwd_dq": "dq", "bwd_dkv": "dkv"}[m.group(1)]
    return (kernel, "bf16" if "bfloat16" in m.group(2) else "fp16",
            int(m.group(3)))


_FB_MMA = re.compile(r"fb_(fwd|dq|dkv|dbias)_mma_kernelILi(\d)ELi(\d)"
                     r"ELi(\d+)E")
_TYPE_CODES = {"0": "fp32", "1": "bf16", "2": "fp16"}


def _fb_mma_key(symbol):
    """(kernel, dtype, bias dtype, padded D) of a tensor-core B10 kernel's
    mangled name (templated on type codes), else None."""
    m = _FB_MMA.search(symbol)
    if not m:
        return None
    return (m.group(1), _TYPE_CODES[m.group(2)], _TYPE_CODES[m.group(3)],
            int(m.group(4)))


def _ptxas_usage(out, key_fn=_flash_mma_key):
    """{key: {registers, spill_stores, spill_loads, stack}} of the kernels
    ``key_fn`` names (by default B1's tensor-core kernels), from nvcc's
    ``-Xptxas -v`` output."""
    usage, key = {}, None
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            key = key_fn(m.group(1))
            if key:
                usage[key] = {}
            continue
        if key is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            usage[key].update(stack=int(m.group(1)),
                              spill_stores=int(m.group(2)),
                              spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage[key]["registers"] = int(m.group(1))
    return usage


_SASS_LINES = {}


def _flash_sass(builder=None, key_fn=_flash_mma_key,
                ops=(" HMMA.", " FFMA")):
    """{key: [count of each of ``ops``]} of the kernels ``key_fn`` names in
    a built library's SASS (``cuobjdump -sass``, which ships beside nvcc);
    by default B1's tensor-core kernels in the flash library, their HMMA
    and FFMA counts."""
    from deepspeed_tpu_torch.ops.op_builder import (FlashAttentionBuilder,
                                                    find_nvcc)
    tool = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        raise FileNotFoundError(f"no cuobjdump beside nvcc ({tool})")
    lib = (builder or FlashAttentionBuilder()).lib_path()
    if lib not in _SASS_LINES:
        # a library's path names its sources' hash: one disassembly a run
        _SASS_LINES[lib] = subprocess.run(
            [tool, "-sass", lib], capture_output=True, text=True,
            timeout=300).stdout.splitlines()
    counts, key = {}, None
    for line in _SASS_LINES[lib]:
        m = re.search(r"Function : (\S+)", line)
        if m:
            key = key_fn(m.group(1))
            if key:
                counts[key] = [0] * len(ops)
        elif key is not None:
            for i, op in enumerate(ops):
                counts[key][i] += op in line
    return counts


_PA_MMA = re.compile(r"paged_attention_mma_kernelI(13__nv_bfloat16|6__half)"
                     r"Li(\d+)ELi(\d)ELb([01])E")
_PA_MERGE = re.compile(r"paged_attention_merge_kernelI"
                       r"(13__nv_bfloat16|6__half)E")


def _pa_key(symbol):
    """("mma", dtype, tile Dh, row tiles, padded) of a tensor-core B4
    kernel's mangled name, ("merge", dtype, 0, 0, False) of its split
    merge, else None."""
    m = _PA_MMA.search(symbol)
    if m:
        return ("mma", "bf16" if "bfloat16" in m.group(1) else "fp16",
                int(m.group(2)), int(m.group(3)), m.group(4) == "1")
    m = _PA_MERGE.search(symbol)
    return m and ("merge", "bf16" if "bfloat16" in m.group(1) else "fp16",
                  0, 0, False)


_BSA_MMA = re.compile(r"bsa_fwd_mma_kernelI(13__nv_bfloat16|6__half)Li(\d+)E")
_GMM_TMA = re.compile(r"gmm_tma_kernelI(13__nv_bfloat16|6__half)Li(\d)E"
                      r"Lb([01])E")
_GMM_MMA = re.compile(r"gmm_mma_kernelI(13__nv_bfloat16|6__half)Lb([01])E")
_GMM_DW = re.compile(r"gmm_dw_(mma|tma)_kernelI(13__nv_bfloat16|6__half)"
                     r"(?:Lb([01])E)?")


def _bsa_mma_key(symbol):
    """(dtype, padded D) of a tensor-core B9 kernel's mangled name."""
    m = _BSA_MMA.search(symbol)
    return m and ("bf16" if "bfloat16" in m.group(1) else "fp16",
                  int(m.group(2)))


def _gmm_tma_key(symbol):
    """(dtype, consumer warpgroups) of a wgmma/TMA B7 forward kernel's
    name."""
    m = _GMM_TMA.search(symbol)
    if not m or m.group(3) != "0":
        return None
    return ("bf16" if "bfloat16" in m.group(1) else "fp16", int(m.group(2)))


def _gmm_dx_key(symbol):
    """(dtype, consumer warpgroups) of B7's wgmma/TMA dx kernel."""
    m = _GMM_TMA.search(symbol)
    if not m or m.group(3) != "1":
        return None
    return ("bf16" if "bfloat16" in m.group(1) else "fp16", int(m.group(2)))


def _gmm_dw_key(symbol):
    """(dtype, "wgmma_tma") of B7's wgmma/TMA dw kernel, (dtype,
    "mma_sync", 16-byte copies) of its mma.sync one."""
    m = _GMM_DW.search(symbol)
    if not m:
        return None
    dtype = "bf16" if "bfloat16" in m.group(2) else "fp16"
    return ((dtype, "wgmma_tma") if m.group(1) == "tma" else
            (dtype, "mma_sync", m.group(3) == "1"))


def _gmm_mma_key(symbol):
    """(dtype, 16-byte copies) of an mma.sync B7 kernel's mangled name."""
    m = _GMM_MMA.search(symbol)
    return m and ("bf16" if "bfloat16" in m.group(1) else "fp16",
                  m.group(2) == "1")


def _kernel_report(builder, key_fn, key, ops):
    """Registers and spills (``ptxas -v``, kept beside the library) and the
    SASS counts of ``ops`` of one kernel; (dict, counts)."""
    usage = _ptxas_usage(builder.finish_build(None)[1], key_fn).get(key, {})
    counts = _flash_sass(builder, key_fn, ops).get(key, [0] * len(ops))
    return dict(registers=usage.get("registers"),
                spill_stores=usage.get("spill_stores"),
                spill_loads=usage.get("spill_loads"),
                **{op.strip(" ."): n for op, n in zip(ops, counts)}), counts


FP32_FLOPS = 67e12               # H100 SXM fp32 outside the tensor cores


def _live_pairs(sq, sk, causal, window):
    """(query, key) pairs the attention mask keeps."""
    import numpy as np
    if not causal:
        return sq * sk
    r = np.arange(sq) + (sk - sq)
    hi = np.minimum(r, sk - 1)
    lo = np.maximum(r - window + 1, 0) if window else np.zeros_like(r)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def _roofline(nbytes, flops, peak):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _compare(torch, got, ref, low):
    """(max |err|, worst |err| / tol): bf16 outputs (``low`` True or
    "bf16") within one bf16 ulp of |ref| plus BF16_ATOL, fp16 outputs
    (``low`` "fp16") within one fp16 ulp plus BF16_ATOL, fp32 outputs
    within FP32_ATOL + FP32_RTOL·|ref|."""
    diff = (got.float() - ref.float()).abs()
    if low:
        rtol = FP16_RTOL if low == "fp16" else BF16_RTOL
        tol = rtol * ref.float().abs() + BF16_ATOL
    else:
        tol = FP32_ATOL + FP32_RTOL * ref.float().abs()
    return diff.max().item(), (diff / tol).max().item()


def _flash_case(torch, gen, name, B, sq, sk, Hq, Hkv, D, window, dtype,
                timed=False):
    """The three flash kernels, each against its plain version on the same
    inputs (the backward ones on the forward kernel's o and lse)."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.randn(B, s, h, D, device="cuda", generator=gen)
                   .to(dt) for s, h in ((sq, Hq), (sk, Hkv), (sk, Hkv),
                                        (sq, Hq)))
    scale, kw = D**-0.5, dict(causal=True, window=window)
    fwd = lambda: fa.flash_attention_fwd(q, k, v, scale, **kw)  # noqa: E731
    o, lse = fwd()
    dq_fn = lambda: fa.flash_attention_bwd_dq(  # noqa: E731
        q, k, v, o, do, lse, scale, **kw)
    dq, delta = dq_fn()
    dkv_fn = lambda: fa.flash_attention_bwd_dkv(  # noqa: E731
        q, k, v, do, lse, delta, scale, **kw)
    dk, dv = dkv_fn()
    # a second run of each kernel on the same inputs: no atomics and a
    # fixed summation order, so every output is bit-equal
    again = dict(zip(("o", "lse"), fwd()))
    again.update(zip(("dq", "delta"), dq_fn()))
    again.update(zip(("dk", "dv"), dkv_fn()))
    torch.cuda.synchronize()
    first = dict(o=o, lse=lse, dq=dq, delta=delta, dk=dk, dv=dv)
    differ = [w for w, t in again.items() if not torch.equal(t, first[w])]
    del again
    if differ:
        raise AssertionError(f"{name}: a second run of the flash kernels "
                             f"differs in {differ}")
    bf16 = {torch.bfloat16: "bf16", torch.float16: "fp16"}.get(dt, False)
    errs = {}
    o_ref, lse_ref = fa._plain_fwd(q, k, v, scale, **kw)
    errs["o"] = _compare(torch, o, o_ref, bf16)
    errs["lse"] = _compare(torch, lse, lse_ref, False)
    del o_ref, lse_ref
    dq_ref, delta_ref = fa._plain_bwd_dq(q, k, v, o, do, lse, scale, **kw)
    errs["dq"] = _compare(torch, dq, dq_ref, bf16)
    errs["delta"] = _compare(torch, delta, delta_ref, False)
    del dq_ref, delta_ref
    dk_ref, dv_ref = fa._plain_bwd_dkv(q, k, v, do, lse, delta, scale, **kw)
    errs["dk"] = _compare(torch, dk, dk_ref, bf16)
    errs["dv"] = _compare(torch, dv, dv_ref, bf16)
    del dk_ref, dv_ref
    _free(torch)
    tol_text = (f"2^-{7 if bf16 == 'bf16' else 10}·|ref| + {BF16_ATOL:g}"
                if bf16 else f"{FP32_ATOL:g} + {FP32_RTOL:g}·|ref|")
    log(f"[train-kernel] {name}: q [{B},{sq},{Hq},{D}] k/v [{B},{sk},{Hkv},"
        f"{D}] causal window={window} {dtype}: " + ", ".join(
            f"{w} {e:.2e} ({r:.3f})" for w, (e, r) in errs.items())
        + f" — max_abs_err (worst |err| / tol), tol {tol_text} for "
        f"{dtype} outputs, {FP32_ATOL:g} + {FP32_RTOL:g}·|ref| for lse and "
        f"delta; a second run bit-equal in all six")
    bad = {w: r for w, (e, r) in errs.items() if not r <= 1.0}
    if bad:
        raise AssertionError(f"{name}: flash kernels differ from their plain "
                             f"versions beyond tolerance: {bad}")
    row = dict(case=name, err_fwd=errs["o"][0],
               err_bwd=max(errs[w][0] for w in ("dq", "dk", "dv")),
               worst=max(r for _, r in errs.values()))
    if not timed:
        return row
    row["ms_fwd"] = cuda_ms(fwd, 10)
    row["ms_dq"] = cuda_ms(dq_fn, 10)
    row["ms_dkv"] = cuda_ms(dkv_fn, 10)
    row["plain_ms_fwd"] = cuda_ms(lambda: fa._plain_fwd(q, k, v, scale, **kw),
                                  3, warmup=1)

    def plain_bwd():
        fa._plain_bwd_dq(q, k, v, o, do, lse, scale, **kw)
        fa._plain_bwd_dkv(q, k, v, do, lse, delta, scale, **kw)

    row["plain_ms_bwd"] = cuda_ms(plain_bwd, 3, warmup=1)
    _free(torch)
    # library yardstick: SDPA on [B, H, S, D] (same shapes, sq == sk here)
    qh, kh, vh, doh = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qh, kh, vh, is_causal=True)
    row["library_ms_fwd"] = cuda_ms(sdpa, 10)
    for t in (qh, kh, vh):
        t.requires_grad_(True)

    def sdpa_fwd_bwd():
        sdpa().backward(doh)

    row["library_ms_fwd_bwd"] = cuda_ms(sdpa_fwd_bwd, 10)
    row["library_ms_bwd"] = row["library_ms_fwd_bwd"] - row["library_ms_fwd"]
    pairs = _live_pairs(sq, sk, True, window)
    flop = 2 * B * Hq * D * pairs            # one product over live pairs
    nb = lambda *ts: sum(t.numel() * t.element_size() for t in ts)  # noqa
    row["bound_fwd"] = _roofline(nb(q, k, v, o, lse), 2 * flop, BF16_FLOPS)
    row["bound_bwd"] = _roofline(nb(q, k, v, o, do, lse, dq, dk, dv), 5 * flop,
                              BF16_FLOPS)
    row["gflop_fwd"], row["gflop_bwd"] = 2 * flop / 1e9, 5 * flop / 1e9
    # achieved rate of the useful products (2 forward, 5 backward; the
    # split's extra products and the recomputed S, dP are not counted)
    row["tflops_fwd"] = 2 * flop / row["ms_fwd"] / 1e9
    row["tflops_bwd"] = 5 * flop / (row["ms_dq"] + row["ms_dkv"]) / 1e9
    log(f"[train-kernel] {name} achieved: fwd {row['tflops_fwd']:.1f} "
        f"TFLOP/s ({row['bound_fwd'][0] / row['ms_fwd']:.3f} of the bound), "
        f"dq + dk/dv {row['tflops_bwd']:.1f} TFLOP/s ("
        f"{row['bound_bwd'][0] / (row['ms_dq'] + row['ms_dkv']):.3f} of the "
        f"bound); dense bf16/fp16 peak {BF16_FLOPS / 1e12:.0f} TFLOP/s")
    if bf16:
        _log_sass(name, bf16, D)
    log(f"[train-kernel] {name} times (ms): fwd {row['ms_fwd']:.4f}, dq "
        f"{row['ms_dq']:.4f}, dk/dv {row['ms_dkv']:.4f} | plain fwd "
        f"{row['plain_ms_fwd']:.3f}, plain bwd {row['plain_ms_bwd']:.3f} | "
        f"sdpa fwd {row['library_ms_fwd']:.4f}, fwd+bwd "
        f"{row['library_ms_fwd_bwd']:.4f} | bound fwd "
        f"{row['bound_fwd'][0]:.4f} ({row['gflop_fwd']:.1f} GFLOP), bwd "
        f"{row['bound_bwd'][0]:.4f} ({row['gflop_bwd']:.1f} GFLOP) by "
        f"{row['bound_bwd'][1]}")
    return row


def _log_sass(name, dtype, D):
    """Print, and require, the HMMA instructions of the three tensor-core
    flash kernels this case ran."""
    counts = _flash_sass()
    dp = 64 if D <= 64 else 128
    got = {kern: counts.get((kern, dtype, dp), (0, 0))
           for kern in ("fwd", "dq", "dkv")}
    log(f"[train-kernel] {name} SASS ({dtype}, D{dp}, cuobjdump -sass): " +
        ", ".join(f"{kern} {h} HMMA / {f} FFMA"
                  for kern, (h, f) in got.items()))
    missing = [kern for kern, (h, _) in got.items() if not h]
    if missing:
        raise AssertionError(f"{name}: no HMMA in the SASS of {missing}")


def _adam_case(torch, gen, seed):
    """Fused Adam over the flat buffer of the 8-layer Llama-2-7B-width
    model's leaves (the engine's layout), against its plain version leaf by
    leaf on the same state."""
    from deepspeed_tpu_torch.models.llama import LlamaModel, llama_7b
    from deepspeed_tpu_torch.ops.kernels import optimizers as opt
    from deepspeed_tpu_torch.runtime.engine import flat_layout
    model = LlamaModel(llama_7b(num_hidden_layers=8), device="meta")
    layout, n = flat_layout((name, p.shape)
                            for name, p in model.named_parameters())
    leaves = [(o, k) for _, o, k, _ in layout]
    dev = "cuda"
    grad = torch.empty(n, device=dev).normal_(0.0, 1e-3, generator=gen)
    master = torch.empty(n, device=dev).normal_(0.0, 0.02, generator=gen)
    m = torch.empty(n, device=dev).normal_(0.0, 1e-4, generator=gen)
    v = torch.empty(n, device=dev).uniform_(0.0, 1e-6, generator=gen)
    out = torch.empty(n, dtype=torch.bfloat16, device=dev)
    hyper = dict(lr=1e-4, beta1=0.9, beta2=0.999, eps=1e-8,
                 weight_decay=0.0, count=3, adam_w_mode=True)
    refs = [t.clone() for t in (master, m, v)]
    out_ref = torch.empty_like(out)
    opt.fused_adam_step(grad, master, m, v, out, **hyper)
    views = lambda t: [t[o:o + k] for o, k in leaves]  # noqa: E731
    opt.fused_adam_step_plain(views(grad), *map(views, refs), views(out_ref),
                              **hyper)
    torch.cuda.synchronize()
    err, worst = 0.0, 0.0
    for got_buf, ref_buf, rtol in ((master, refs[0], ADAM_RTOL),
                                   (m, refs[1], ADAM_RTOL),
                                   (v, refs[2], ADAM_RTOL),
                                   (out, out_ref, ADAM_BF16_RTOL)):
        for got, ref in zip(views(got_buf), views(ref_buf)):
            d = (got.float() - ref.float()).abs()
            tol = rtol * ref.float().abs()
            err = max(err, d.max().item())
            worst = max(worst, torch.where(d == 0, 0.0, d / tol).max().item())
    del refs, out_ref
    _free(torch)
    log(f"[train-kernel] fused_adam_step: {len(leaves)} leaves, {n:,} "
        f"elements (flat, 16-element aligned): max_abs_err {err:.3e}, worst "
        f"|err| / tol {worst:.3f} (tol 2^-23·|ref| for master/m/v, 2^-8·|ref|"
        f" for the bf16 copy: the same fp32 operations in the same order)")
    if not worst <= 1.0:
        raise AssertionError(f"fused Adam differs from its plain version by "
                             f"{worst} × tol")
    row = dict(case="adam_8L_7b", err=err, worst=worst, elements=n,
               leaves=len(leaves))
    row["ms"] = cuda_ms(lambda: opt.fused_adam_step(grad, master, m, v, out,
                                                    **hyper), 5)
    row["plain_ms"] = cuda_ms(
        lambda: opt.fused_adam_step_plain(views(grad), views(master),
                                          views(m), views(v), views(out),
                                          **hyper), 2, warmup=1)
    p = torch.nn.Parameter(master)
    p.grad = grad
    lib = torch.optim.AdamW([p], lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.0, fused=True)

    def library():
        lib.step()
        out.copy_(p.detach())

    row["library_ms"] = cuda_ms(library, 5)
    row["bound"] = _roofline(n * (4 + 12 + 12 + 2), n * 20, FP32_FLOPS)
    log(f"[train-kernel] fused_adam_step times (ms): kernel {row['ms']:.3f} "
        f"| plain {row['plain_ms']:.3f} | AdamW(fused=True) + bf16 copy "
        f"{row['library_ms']:.3f} | bound {row['bound'][0]:.3f} by "
        f"{row['bound'][1]} (30 B per element)")
    del p, lib, grad, master, m, v, out
    _free(torch)
    return row


def stage_train_kernels(seed):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    cases = [
        # (name, B, sq, sk, Hq, Hkv, D, window, dtype, timed): "train" has
        # the training path's shapes (8 layers of these per step)
        ("train", 4, 2048, 2048, 32, 32, 128, 0, "bfloat16", True),
        ("gqa_window", 2, 2048, 2048, 32, 8, 128, 1024, "bfloat16", False),
        ("sq_lt_sk", 2, 512, 2048, 32, 32, 128, 0, "bfloat16", False),
        ("fp32", 1, 512, 512, 8, 8, 128, 0, "float32", False),
    ]
    rows = []
    for *args, timed in cases:
        rows.append(_flash_case(torch, gen, *args, timed=timed))
        _free(torch)
    rows.append(_adam_case(torch, gen, seed))
    return rows


# ---------------------------------------------------------------- stage 8
# bench.py:160-166 (its B, optimizer, precision and ZeRO stage)
TRAIN_CONFIG = {"train_micro_batch_size_per_gpu": 4,
                "gradient_accumulation_steps": 1,
                "optimizer": {"type": "fusedadam", "params": {"lr": 1e-4}},
                "bf16": {"enabled": True},
                "zero_optimization": {"stage": 0}}


def _train_launches():
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.ops.kernels import optimizers as opt
    return {"flash_attention": fa.flash_attention_fwd,
            "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
            "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv,
            "fused_adam_step": opt.fused_adam_step}


def stage_train(seed, smi, profile_dir=None):
    import numpy as np
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import (LlamaModel, llama_7b,
                                                  param_count)
    B, S, L, warmup, timed = 4, 2048, 8, 2, 6
    cfg = llama_7b(num_hidden_layers=L, remat=False, head_dtype="bfloat16")
    t0 = time.perf_counter()
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=LlamaModel(cfg, device="meta"), config=dict(TRAIN_CONFIG))
    engine.initialize_parameters(seed)
    torch.cuda.synchronize()
    log(f"[train] Llama-2-7B width, {L} layers, {param_count(cfg):,} params,"
        f" bf16 + fp32 master/moments/grad accumulator: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB of state, built in "
        f"{time.perf_counter() - t0:.1f} s")
    ids = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(B, S))).cuda()

    def one_step():
        loss = engine(ids, ids)
        engine.backward(loss)
        engine.step()
        return loss

    losses = [one_step().item() for _ in range(warmup)]
    counters = _train_launches()
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(timed):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = one_step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        losses.append(loss.item())
    launches = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    step_s = float(np.mean(times))
    tok_s = B * S / step_s
    flops_tok = 6 * param_count(cfg) + 12 * L * S * cfg.hidden_size
    mfu = tok_s * flops_tok / BF16_FLOPS
    log(f"[train] losses (2 warm-up, then 6 timed): "
        + ", ".join(f"{x:.4f}" for x in losses))
    log(f"[train] step ms " + ", ".join(f"{t * 1e3:.1f}" for t in times)
        + f" | mean {step_s * 1e3:.1f} ms, {tok_s:.1f} tokens/s, MFU "
        f"{mfu:.4f} ({flops_tok / 1e9:.2f} GFLOP/token = 6N + 12·L·S·D, "
        f"989 TFLOP/s) | peak memory {peak / 2**30:.2f} GiB | {smi}")
    log(f"[train] kernel launches in the {timed} timed steps: {launches}")
    want = {"flash_attention": L * timed, "flash_attention_bwd_dq": L * timed,
            "flash_attention_bwd_dkv": L * timed, "fused_adam_step": timed}
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, want {want}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite and falling: {losses}")
    result = dict(losses=losses, step_ms=[t * 1e3 for t in times],
                  step_ms_mean=step_s * 1e3, tokens_per_s=tok_s, mfu=mfu,
                  peak_bytes=peak, launches=launches,
                  flops_per_token=flops_tok)
    if profile_dir:
        def kind(name):
            if "flash_fwd" in name:
                return "flash_fwd"
            if "flash_bwd" in name:
                return "flash_bwd"
            if "adam_kernel" in name:
                return "adam"
            return "matmul" if _is_matmul(name) else "other"

        result["profile"] = _profile_window(
            "train_profile", lambda: [one_step() for _ in range(2)], kind,
            profile_dir, smi)
    del engine
    _free(torch)
    return result


# ---------------------------------------------------------------- stage 9
def stage_train_step_vs_plain(seed):
    """One training step at full width and depth 2 from the same weights,
    with the kernels and with their plain versions."""
    import numpy as np
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LlamaModel, llama_7b
    cfg = llama_7b(num_hidden_layers=2, remat=False, head_dtype="bfloat16")
    config = dict(TRAIN_CONFIG, train_micro_batch_size_per_gpu=2)
    lr = config["optimizer"]["params"]["lr"]
    ids = torch.from_numpy(np.random.default_rng(seed + 2).integers(
        0, cfg.vocab_size, size=(2, 2048))).cuda()
    res = {}
    for use_kernel in (True, False):
        eng, _, _, _ = deepspeed_tpu_torch.initialize(
            model=LlamaModel(cfg, device="meta"), config=dict(config))
        eng.initialize_parameters(seed + 3)
        loss = eng(ids, ids, use_kernel=use_kernel)
        eng.backward(loss)
        grad = eng.grad_acc.clone()
        layout = eng._layout
        eng.step(use_kernel=use_kernel)
        res[use_kernel] = (loss.item(), float(eng._last_gnorm), grad,
                           eng.master.clone())
        del eng, loss
        _free(torch)
    (lk, nk, gk, mk), (lp, npl, gp, mp) = res[True], res[False]
    loss_rel = abs(lk - lp) / abs(lp)
    norm_rel = abs(nk - npl) / npl
    grad_rel = ((gk - gp).abs().max() / gp.abs().max()).item()
    leaf_rel, leaf_name = max(
        (((gk[o:o + n] - gp[o:o + n]).abs().max() /
          gp[o:o + n].abs().max()).item(), name)
        for name, o, n, _ in layout)
    apart = (mk - mp).abs() > lr / 2
    flipped = apart.float().mean().item()
    leaf_flipped, flipped_name = max(
        (apart[o:o + n].float().mean().item(), name)
        for name, o, n, _ in layout)
    log(f"[train-step] depth 2, B=2, S=2048, kernels vs plain: loss {lk:.6f}"
        f" vs {lp:.6f} (rel {loss_rel:.2e}, tol 2^-7), grad norm {nk:.6f} vs "
        f"{npl:.6f} (rel {norm_rel:.2e}, tol 2^-7), max|Δgrad| / max|grad| "
        f"{grad_rel:.2e} (tol 2^-5), worst leaf {leaf_rel:.2e} ({leaf_name}, "
        f"tol 2^-4), master after the step: share moved apart by more than "
        f"lr/2 {flipped:.2e} overall, worst leaf {leaf_flipped:.2e} "
        f"({flipped_name}, tol 1e-2)")
    # bf16 activations: a flash output that rounds the other way is one
    # bf16 ulp (2^-8..2^-7 relative) apart, and the mean loss, the norm and
    # the largest gradient move by less than that; after one Adam step each
    # master element moves by lr·g/(|g|+eps), about lr, so only elements
    # whose gradient sign differs between the paths (those near 0) end up
    # more than lr/2 apart, while a leaf whose update went wrong is apart
    # on most of its elements: the share is held per leaf
    if not (loss_rel <= 2.0**-7 and norm_rel <= 2.0**-7 and
            grad_rel <= 2.0**-5 and leaf_rel <= 2.0**-4 and
            leaf_flipped <= 1e-2):
        raise AssertionError("training step: kernels differ from the plain "
                             "path beyond tolerance")
    return dict(loss=(lk, lp), grad_norm=(nk, npl), loss_rel=loss_rel,
                norm_rel=norm_rel, grad_rel=grad_rel, leaf_rel=leaf_rel,
                leaf=leaf_name, flipped_share=flipped,
                leaf_flipped_share=leaf_flipped, leaf_flipped=flipped_name)


# --------------------------------------------------------------- stage 10
GPT2_LAYOUT_ELEMENTS = 354_823_168


def _gpt2_layout():
    """The flat layout of GPT-2 350M's 388 leaves, as the engine builds it."""
    from deepspeed_tpu_torch.models.gpt2 import GPT2Model, gpt2_350m
    from deepspeed_tpu_torch.runtime.engine import flat_layout
    model = GPT2Model(gpt2_350m(dtype="float16"), device="meta")
    layout, n = flat_layout((name, p.shape)
                            for name, p in model.named_parameters())
    return [(o, k) for _, o, k, _ in layout], n


def _opt_buffers(torch, gen, n, leaves, grad_dtype):
    """Gradient, master, m and v over the flat buffer, zero in the gaps
    between leaves (as the engine keeps them)."""
    dev = "cuda"
    live = torch.zeros(n, dtype=torch.bool, device=dev)
    for o, k in leaves:
        live[o:o + k] = True
    grad = torch.empty(n, device=dev).normal_(0.0, 1e-3, generator=gen)
    master = torch.empty(n, device=dev).normal_(0.0, 0.02, generator=gen)
    m = torch.empty(n, device=dev).normal_(0.0, 1e-4, generator=gen)
    v = torch.empty(n, device=dev).uniform_(0.0, 1e-6, generator=gen)
    for t in (grad, master, m, v):
        t.mul_(live)
    return grad.to(grad_dtype), master, m, v, live


def _lamb_case(torch, gen, leaves, n, grad_dtype, timed):
    """Both LAMB phases over the flat layout against their plain versions
    leaf by leaf, on the same inputs; two runs of phase 1."""
    from deepspeed_tpu_torch.ops.kernels import optimizers as opt
    grad, master, m, v, live = _opt_buffers(torch, gen, n, leaves,
                                            grad_dtype)
    table = opt.LambTable(leaves, device="cuda")
    out = torch.empty(n, dtype=torch.float16, device="cuda")
    hyper = dict(beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01,
                 count=3, grad_scale=torch.tensor(2.0**-16, device="cuda"))
    lr = 1e-3
    ref = [t.clone() for t in (master, m, v)]
    u, u_ref = torch.zeros_like(master), torch.zeros_like(master)
    m2, v2, u2 = m.clone(), v.clone(), torch.zeros_like(master)
    partials = opt.fused_lamb_phase1(grad, master, m, v, u, table, **hyper)
    again = opt.fused_lamb_phase1(grad, master, m2, v2, u2, table, **hyper)
    stats = opt.fused_lamb_phase2(master, u, out, table, partials, lr=lr)
    torch.cuda.synchronize()
    stable = bool(torch.equal(partials, again) and torch.equal(u, u2) and
                  torch.equal(m, m2))
    del m2, v2, u2, again
    views = table.views
    sums = opt.fused_lamb_phase1_plain(views(grad), views(ref[0]),
                                       views(ref[1]), views(ref[2]),
                                       views(u_ref), **hyper)
    exact = {name: (a - b).abs().max().item() for name, a, b in
             (("m", m, ref[1]), ("v", v, ref[2]), ("u", u, u_ref))}
    # per-leaf sums against a float64 reduction of the plain u and old p
    sums64 = torch.stack([torch.stack([(p.double() ** 2).sum(),
                                       (w.double() ** 2).sum()])
                          for p, w in zip(views(ref[0]), views(u_ref))])
    sum_rel = ((stats[:, :2].double() - sums64).abs() /
               sums64.clamp_min(1e-300)).max().item()
    ratios = opt.fused_lamb_phase2_plain(views(ref[0]), views(u_ref), None,
                                         sums, lr=lr)
    ratio_rel = ((stats[:, 2] - ratios).abs() / ratios).max().item()
    worst_master = 0.0
    for i, (o, k) in enumerate(leaves):
        d = (master[o:o + k] - ref[0][o:o + k]).abs()
        slack = (lr * ((stats[i, 2] - ratios[i]).abs() + 2.0**-22 *
                       ratios[i]) * u_ref[o:o + k].abs() +
                 2.0**-23 * ref[0][o:o + k].abs())
        worst_master = max(worst_master, torch.where(
            d == 0, 0.0, d / slack).max().item())
    master_err = (master - ref[0]).abs().max().item()
    gaps_zero = not bool(master[~live].any() or u[~live].any() or
                         m[~live].any())
    gname = str(grad_dtype).replace("torch.", "")
    log(f"[gpt2-kernel] fused_lamb {gname} grad over {len(leaves)} leaves, "
        f"{n:,} elements: m/v/u max |kernel - plain| {exact['m']:.1e} / "
        f"{exact['v']:.1e} / {exact['u']:.1e} (bit for bit wanted), "
        f"per-leaf sums vs float64 worst rel {sum_rel:.2e} (tol 1e-5), "
        f"ratios worst rel {ratio_rel:.2e} (tol 1e-5), master max |err| "
        f"{master_err:.2e}, worst |err| / (lr·|Δratio|·|u| + ulps) "
        f"{worst_master:.3f}, phase 1 twice bit-identical {stable}, gaps "
        f"zero {gaps_zero}")
    if not (max(exact.values()) == 0 and sum_rel <= 1e-5 and
            ratio_rel <= 1e-5 and worst_master <= 1.0 and stable and
            gaps_zero):
        raise AssertionError("LAMB kernels differ from their plain versions")
    row = dict(case=f"lamb_{gname}", err_phase1=max(exact.values()),
               err_phase2=master_err, sum_rel=sum_rel, ratio_rel=ratio_rel,
               worst_master=worst_master, stable=stable)
    if timed:
        row["ms_phase1"] = cuda_ms(lambda: opt.fused_lamb_phase1(
            grad, master, m, v, u, table, **hyper), 10)
        row["ms_phase2"] = cuda_ms(lambda: opt.fused_lamb_phase2(
            master, u, out, table, partials, lr=lr), 10)
        row["plain_ms_phase1"] = cuda_ms(lambda: opt.fused_lamb_phase1_plain(
            views(grad), views(master), views(m), views(v), views(u),
            **hyper), 2, warmup=1)
        row["plain_ms_phase2"] = cuda_ms(lambda: opt.fused_lamb_phase2_plain(
            views(master), views(u), views(out), sums, lr=lr), 2, warmup=1)
        g = grad.element_size()
        row["bound_phase1"] = _roofline(n * (g + 12 + 12), n * 24,
                                        FP32_FLOPS)
        row["bound_phase2"] = _roofline(n * (8 + 4 + 2), n * 2, FP32_FLOPS)
        log(f"[gpt2-kernel] fused_lamb times (ms): phase 1 "
            f"{row['ms_phase1']:.3f} (plain {row['plain_ms_phase1']:.2f}, "
            f"bound {row['bound_phase1'][0]:.3f} by "
            f"{row['bound_phase1'][1]}, {g + 24} B per element), phase 2 "
            f"{row['ms_phase2']:.3f} (plain {row['plain_ms_phase2']:.2f}, "
            f"bound {row['bound_phase2'][0]:.3f} by "
            f"{row['bound_phase2'][1]}, 14 B per element); no PyTorch call "
            f"computes LAMB")
    del grad, master, m, v, u, u_ref, ref, out, live
    _free(torch)
    return row


def _lion_case(torch, gen, leaves, n, grad_dtype, timed):
    from deepspeed_tpu_torch.ops.kernels import optimizers as opt
    grad, master, m, _, live = _opt_buffers(torch, gen, n, leaves,
                                            grad_dtype)
    out = torch.empty(n, dtype=torch.float16, device="cuda")
    hyper = dict(lr=1e-4, beta1=0.9, beta2=0.99, weight_decay=0.1,
                 grad_scale=torch.tensor(2.0**-16, device="cuda"))
    ref = [master.clone(), m.clone(), out.clone()]
    opt.fused_lion_step(grad, master, m, out, **hyper)
    views = lambda t: [t[o:o + k] for o, k in leaves]  # noqa: E731
    opt.fused_lion_step_plain(views(grad), views(ref[0]), views(ref[1]),
                              views(ref[2]), **hyper)
    torch.cuda.synchronize()
    err = max((a[live].float() - b[live].float()).abs().max().item()
              for a, b in ((master, ref[0]), (m, ref[1]), (out, ref[2])))
    gname = str(grad_dtype).replace("torch.", "")
    log(f"[gpt2-kernel] fused_lion {gname} grad over {len(leaves)} leaves: "
        f"master/m/fp16 copy max |kernel - plain| {err:.1e} (bit for bit "
        f"wanted)")
    if err != 0:
        raise AssertionError("Lion kernel differs from its plain version")
    row = dict(case=f"lion_{gname}", err=err)
    if timed:
        row["ms"] = cuda_ms(lambda: opt.fused_lion_step(grad, master, m, out,
                                                        **hyper), 10)
        row["plain_ms"] = cuda_ms(lambda: opt.fused_lion_step_plain(
            views(grad), views(master), views(m), views(out), **hyper), 2,
            warmup=1)
        row["bound"] = _roofline(n * (grad.element_size() + 8 + 8 + 2),
                                 n * 10, FP32_FLOPS)
        log(f"[gpt2-kernel] fused_lion times (ms): kernel {row['ms']:.3f} | "
            f"plain {row['plain_ms']:.2f} | bound {row['bound'][0]:.3f} by "
            f"{row['bound'][1]} (22 B per element); no PyTorch call "
            f"computes Lion")
    del grad, master, m, out, ref, live
    _free(torch)
    return row


def _adam_fp16_case(torch, gen, leaves, n):
    """Adam with an fp16 gradient and an fp16 copy, over the GPT-2 layout:
    bit for bit against its plain version."""
    from deepspeed_tpu_torch.ops.kernels import optimizers as opt
    grad, master, m, v, live = _opt_buffers(torch, gen, n, leaves,
                                            torch.float16)
    out = torch.empty(n, dtype=torch.float16, device="cuda")
    hyper = dict(lr=1e-4, beta1=0.9, beta2=0.999, eps=1e-8,
                 weight_decay=0.01, count=3,
                 grad_scale=torch.tensor(2.0**-16, device="cuda"))
    ref = [t.clone() for t in (master, m, v, out)]
    opt.fused_adam_step(grad, master, m, v, out, **hyper)
    views = lambda t: [t[o:o + k] for o, k in leaves]  # noqa: E731
    opt.fused_adam_step_plain(views(grad), *map(views, ref), **hyper)
    torch.cuda.synchronize()
    err = max((a[live].float() - b[live].float()).abs().max().item()
              for a, b in zip((master, m, v, out), ref))
    ms = cuda_ms(lambda: opt.fused_adam_step(grad, master, m, v, out,
                                             **hyper), 10)
    log(f"[gpt2-kernel] fused_adam fp16 grad + fp16 copy over "
        f"{len(leaves)} leaves: max |kernel - plain| {err:.1e} (bit for bit "
        f"wanted), kernel {ms:.3f} ms")
    if err != 0:
        raise AssertionError("Adam kernel (fp16) differs from its plain "
                             "version")
    del grad, master, m, v, out, ref, live
    _free(torch)
    return dict(case="adam_fp16", err=err, ms=ms)


def stage_gpt2_kernels(seed):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed + 10)
    leaves, n = _gpt2_layout()
    assert sum(k for _, k in leaves) == GPT2_LAYOUT_ELEMENTS
    rows = [_lamb_case(torch, gen, leaves, n, torch.float32, True),
            _lamb_case(torch, gen, leaves, n, torch.float16, False),
            _lion_case(torch, gen, leaves, n, torch.float32, True),
            _lion_case(torch, gen, leaves, n, torch.float16, False),
            _adam_fp16_case(torch, gen, leaves, n)]
    for args in (("gpt2_fp16", 8, 1024, 1024, 16, 16, 64, 0, "float16",
                  True),
                 ("gqa_window_fp16", 2, 1024, 1024, 16, 4, 64, 256,
                  "float16", False)):
        rows.append(_flash_case(torch, gen, *args[:-1], timed=args[-1]))
        _free(torch)
    return rows


# --------------------------------------------------------------- stage 11
# bench.py:302-319's GPT-2 workload (B, S, precision, remat), with
# FusedLamb (BASELINE config 4's optimizer) and ZeRO stage 0
GPT2_CONFIG = {"train_micro_batch_size_per_gpu": 8,
               "gradient_accumulation_steps": 1,
               "optimizer": {"type": "fusedlamb", "params": {"lr": 1e-3}},
               "fp16": {"enabled": True, "initial_scale_power": 16},
               "zero_optimization": {"stage": 0}}


def _gpt2_launches():
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.ops.kernels import optimizers as opt
    return {"flash_attention": fa.flash_attention_fwd,
            "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
            "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv,
            "fused_lamb_phase1": opt.fused_lamb_phase1,
            "fused_lamb_phase2": opt.fused_lamb_phase2,
            "fused_adam_step": opt.fused_adam_step,
            "fused_lion_step": opt.fused_lion_step}


def _gpt2_engine(torch, seed, config_over=None, **over):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2Model, gpt2_350m
    cfg = gpt2_350m(dtype="float16", **over)
    config = dict(GPT2_CONFIG, **(config_over or {}))
    engine = deepspeed_tpu_torch.initialize(
        model=GPT2Model(cfg, device="meta"), config=config)[0]
    engine.initialize_parameters(seed)
    return engine, cfg


def _run_steps(torch, engine, ids, n, timed=False):
    """n steps on one batch: (losses, scales after each step, skipped
    flags, host seconds of each step)."""
    losses, scales, skips, times = [], [], [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = engine(ids, ids)
        engine.backward(loss)
        engine.step()
        if timed:
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        losses.append(loss.item())
        scales.append(engine.cur_scale)
        skips.append(engine._last_skipped)
    return losses, scales, skips, times


def stage_gpt2_train(seed, smi, profile_dir=None):
    import numpy as np
    import torch
    from deepspeed_tpu_torch.models.gpt2 import param_count
    B, S, warmup, timed = 8, 1024, 2, 8
    t0 = time.perf_counter()
    engine, cfg = _gpt2_engine(torch, seed)
    torch.cuda.synchronize()
    N, L, D = param_count(cfg), cfg.num_hidden_layers, cfg.hidden_size
    log(f"[gpt2] GPT-2 350M ({L} layers, hidden {D}, {N:,} params in "
        f"{len(engine._layout)} leaves), fp16 + fp32 master/m/v/u/grad "
        f"accumulator: {torch.cuda.memory_allocated() / 2**30:.2f} GiB of "
        f"state, built in {time.perf_counter() - t0:.1f} s; ZeRO stage 0 "
        f"(bench.py runs stage 1, which needs the comm layer, ROADMAP queue "
        f"A item 2)")
    ids = torch.from_numpy(np.random.default_rng(seed + 11).integers(
        0, cfg.vocab_size, size=(B, S))).cuda()
    counters = _gpt2_launches()
    w_loss, w_scale, w_skip, _ = _run_steps(torch, engine, ids, warmup)
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    losses, scales, skips, times = _run_steps(torch, engine, ids, timed,
                                              timed=True)
    launches = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    step_s = float(np.mean(times))
    tok_s = B * S / step_s
    flops_tok = 6 * N + 12 * L * S * D
    mfu = tok_s * flops_tok / BF16_FLOPS
    stepped = timed - sum(skips)
    log("[gpt2] steps (loss, scale after, skipped): " + ", ".join(
        f"{x:.4f}/{s:g}/{int(k)}" for x, s, k in
        zip(w_loss + losses, w_scale + scales, w_skip + skips)))
    log(f"[gpt2] step ms " + ", ".join(f"{t * 1e3:.1f}" for t in times)
        + f" | mean {step_s * 1e3:.1f} ms, {tok_s:.1f} tokens/s, MFU "
        f"{mfu:.4f} ({flops_tok / 1e9:.3f} GFLOP/token = 6N + 12·L·S·D, "
        f"989 TFLOP/s fp16) | peak memory {peak / 2**30:.2f} GiB | "
        f"{stepped} of {timed} timed steps not skipped | {smi}")
    log(f"[gpt2] kernel launches in the {timed} timed steps: {launches}")
    want = dict(flash_attention=2 * L * timed,        # remat: twice a layer
                flash_attention_bwd_dq=L * timed,
                flash_attention_bwd_dkv=L * timed,
                fused_lamb_phase1=stepped, fused_lamb_phase2=stepped,
                fused_adam_step=0, fused_lion_step=0)
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, want {want}")
    if not all(np.isfinite(w_loss + losses)) or stepped < 4 or \
            not losses[-1] < w_loss[0]:
        raise AssertionError(f"losses not finite and falling, or fewer than "
                             f"4 steps taken: {w_loss + losses}, {skips}")
    result = dict(losses=w_loss + losses, scales=w_scale + scales,
                  skipped=w_skip + skips, step_ms=[t * 1e3 for t in times],
                  step_ms_mean=step_s * 1e3, tokens_per_s=tok_s, mfu=mfu,
                  peak_bytes=peak, launches=launches,
                  flops_per_token=flops_tok, params=N,
                  leaves=len(engine._layout))
    if profile_dir:
        def kind(name):
            if "flash_fwd" in name:
                return "flash_fwd"
            if "flash_bwd" in name:
                return "flash_bwd"
            if "lamb_phase" in name:
                return "lamb"
            return "matmul" if _is_matmul(name) else "other"

        result["profile"] = _profile_window(
            "gpt2_profile", lambda: _run_steps(torch, engine, ids, 2), kind,
            profile_dir, smi)
    del engine
    _free(torch)
    # bench.py's own optimizer, and Lion, on the same path
    for name, optimizer, key in (
            ("fusedadam", {"type": "fusedadam", "params": {"lr": 1e-4}},
             "fused_adam_step"),
            ("lion", {"type": "lion", "params": {"lr": 1e-4}},
             "fused_lion_step")):
        engine, _ = _gpt2_engine(torch, seed, {"optimizer": optimizer})
        for fn in counters.values():
            fn.launches = 0
        o_loss, o_scale, o_skip, _ = _run_steps(torch, engine, ids, 3)
        n_launch = {k: fn.launches for k, fn in counters.items()
                    if fn.launches}
        log(f"[gpt2] {name}: 3 steps (loss, scale, skipped) " + ", ".join(
            f"{x:.4f}/{s:g}/{int(k)}" for x, s, k in
            zip(o_loss, o_scale, o_skip)) + f" | launches {n_launch}")
        if n_launch.get(key, 0) != 3 - sum(o_skip) or \
                n_launch.get(key, 0) < 1 or not all(np.isfinite(o_loss)):
            raise AssertionError(f"{name}: {key} launched "
                                 f"{n_launch.get(key, 0)} times for "
                                 f"{3 - sum(o_skip)} steps taken")
        result[name] = dict(losses=o_loss, skipped=o_skip,
                            launches=n_launch)
        del engine
        _free(torch)
    return result


# --------------------------------------------------------------- stage 12
def stage_overflow_and_guard(seed):
    import numpy as np
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2Model, gpt2_350m
    ids = torch.from_numpy(np.random.default_rng(seed + 12).integers(
        0, 50257, size=(2, 512))).cuda()
    engine, _ = _gpt2_engine(
        torch, seed, {"train_micro_batch_size_per_gpu": 2,
                      "fp16": {"enabled": True, "initial_scale_power": 32}},
        num_hidden_layers=2)
    scales = []
    for step in range(4):
        snap = [t.clone() for t in (engine.master, engine.params,
                                    engine.opt_state.exp_avg,
                                    engine.opt_state.exp_avg_sq)]
        count = engine.opt_state.count
        lr = engine._transform.current_lr(count + 1, engine.opt_state)
        loss = engine(ids, ids)
        engine.backward(loss)
        engine.step()
        now = (engine.master, engine.params, engine.opt_state.exp_avg,
               engine.opt_state.exp_avg_sq)
        unchanged = all(torch.equal(a, b) for a, b in zip(snap, now))
        scales.append(engine.cur_scale)
        if not (engine._last_skipped and unchanged and
                engine.skipped_steps == step + 1 and
                engine.opt_state.count == count and
                engine._transform.current_lr(count + 1, engine.opt_state)
                == lr):
            raise AssertionError(f"overflowed step {step + 1}: skipped "
                                 f"{engine._last_skipped}, state unchanged "
                                 f"{unchanged}, skipped_steps "
                                 f"{engine.skipped_steps}")
        del snap
    want = [2.0**32, 2.0**31, 2.0**31, 2.0**30]
    log(f"[overflow] depth-2 GPT-2, fp16 from 2^32, hysteresis 2: 4 steps "
        f"all skipped with master, m, v and fp16 params bit-unchanged, "
        f"optimizer count {engine.opt_state.count}, skipped_steps "
        f"{engine.skipped_steps}, scale after each step "
        f"{[f'2^{int(np.log2(s))}' for s in scales]}")
    if scales != want:
        raise AssertionError(f"scales {scales}, want {want}")
    del engine
    _free(torch)

    cfg = gpt2_350m(dtype="bfloat16", num_hidden_layers=2)
    engine = deepspeed_tpu_torch.initialize(
        model=GPT2Model(cfg, device="meta"),
        config={"train_micro_batch_size_per_gpu": 2,
                "optimizer": {"type": "fusedlamb", "params": {"lr": 1e-3}},
                "bf16": {"enabled": True},
                "resilience": {"check_finite_grads": {
                    "enabled": True, "max_consecutive_skips": 3}}})[0]
    engine.initialize_parameters(seed)
    report = []
    for step, poison in enumerate((False, True, False)):
        snap = engine.master.clone()
        loss = engine(ids, ids)
        engine.backward(loss)
        if poison:
            engine.grad_acc[12345] = float("nan")
        engine.step()
        unchanged = bool(torch.equal(snap, engine.master))
        report.append((poison, engine._last_skipped, unchanged,
                       engine._consecutive_skips))
        if engine._last_skipped != poison or unchanged != poison:
            raise AssertionError(f"guard step {step + 1}: {report[-1]}")
    log(f"[guard] bf16 depth-2 GPT-2 with check_finite_grads: (poisoned, "
        f"skipped, master unchanged, consecutive skips) per step {report}")
    del engine
    _free(torch)
    return dict(scales=scales, guard=report)


# --------------------------------------------------------------- stage 13
def _gmm_case(torch, gen, name, sizes, K, N, dtype, route, x_offset=0,
              rows=None):
    """The grouped matmul on the shapes of one Mixtral expert product:
    kernel against its plain version on the same inputs, with the times of
    both, of a library call and the bound; the launch must take ``route``
    (its kernel's registers, spills and SASS counts: HGMMA and UTMALDG on
    a wgmma/TMA route, HMMA on mma.sync, none of either failing).  x
    starts ``x_offset`` elements into its buffer.  ``rows``: x's rows where
    more than the sizes' sum (the ep exchange's gathered copies: the rows
    past the sum hold other ranks' tokens and must come out zero)."""
    from deepspeed_tpu_torch.ops.kernels import grouped_matmul as gm
    from deepspeed_tpu_torch.ops.op_builder import GroupedMatmulBuilder
    dt = getattr(torch, dtype)
    live, E = sum(sizes), len(sizes)
    T = rows or live
    x = torch.randn(T * K + x_offset, device="cuda", generator=gen).to(dt)
    x = x[x_offset:].view(T, K)
    w = (torch.randn(E, K, N, device="cuda", generator=gen)
         / K**0.5).to(dt)
    gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
    gm.gmm.route_launches = dict.fromkeys(gm.ROUTES, 0)
    got = gm.gmm(x, w, gs)
    torch.cuda.synchronize()
    routes = {r: n for r, n in gm.gmm.route_launches.items() if n}
    if routes != {route: 1}:
        raise AssertionError(f"gmm {name}: launches by route {routes}, want "
                             f"one on {route}")
    ref = gm.gmm_plain(x, w, gs)
    err, worst = _compare(torch, got, ref, dt != torch.float32)
    dead_zero = bool((got[live:] == 0).all())
    ms = cuda_ms(lambda: gm.gmm(x, w, gs), 10)
    plain_ms = cuda_ms(lambda: gm.gmm_plain(x, w, gs), 3, warmup=1)
    lib_kind = None
    offs = torch.cumsum(gs, 0, dtype=torch.int32)
    grouped = getattr(torch, "_grouped_mm", None)
    if grouped is not None and dt == torch.bfloat16:
        # [E, K, N] as it lies, then the column-major copy some builds ask
        # for (outside the timing)
        for b in (w, w.transpose(1, 2).contiguous().transpose(1, 2)):
            try:
                lib_out = grouped(x, b, offs=offs)
            except RuntimeError as e:
                log(f"[moe-kernel] torch._grouped_mm refused {name} "
                    f"(w strides {b.stride()}): "
                    f"{str(e).splitlines()[0][:120]}")
                continue
            lib_kind = f"torch._grouped_mm (w strides {b.stride()})"
            lib = lambda b=b: grouped(x, b, offs=offs)  # noqa: E731
            break
    if lib_kind is None:
        def lib():
            out, s = [], 0
            for e, n in enumerate(sizes):
                out.append(torch.matmul(x[s:s + n], w[e]))
                s += n
            return torch.cat(out)

        lib_out, lib_kind = lib(), "per-expert torch.matmul loop"
    lib_ms = cuda_ms(lib, 10)
    lib_err = (lib_out[:live].float() - ref[:live].float()).abs().max().item()
    active = sum(1 for n in sizes if n > 0)
    esz = x.element_size()
    # the live rows read, every output row written
    nbytes = (active * K * N + live * K + T * N) * esz
    flops = 2 * live * K * N
    bound = _roofline(nbytes, flops,
                      BF16_FLOPS if dt != torch.float32 else FP32_FLOPS)
    tol_text = ("2^-7·|ref| + 1e-4" if dt != torch.float32
                else f"{FP32_ATOL:g} + {FP32_RTOL:g}·|ref|")
    row = dict(case=name, err=err, err_over_tol=worst, ms=ms,
               plain_ms=plain_ms, library_ms=lib_ms, library=lib_kind,
               bound_ms=bound[0], bound_by=bound[1], rows=T, live_rows=live,
               dead_rows_zero=dead_zero, K=K, N=N,
               route=route, tflops=flops / ms / 1e9,
               share_of_bound=bound[0] / ms,
               library_tflops=flops / lib_ms / 1e9)
    log(f"[moe-kernel] gmm {name}: x [{T},{K}] w [{E},{K},{N}] {dtype} "
        f"groups {sizes if len(set(sizes)) > 1 else f'{E}×{sizes[0]}'}"
        + (f" ({T - live} rows past them, zero {dead_zero})"
           if T > live else "") + ", "
        f"route {route}: max_abs_err {err:.3e}, worst |err| / ({tol_text}) "
        f"{worst:.3f} | kernel {ms:.4f} ms ({row['tflops']:.1f} TFLOP/s, "
        f"{row['share_of_bound']:.3f} of the bound), plain {plain_ms:.4f} "
        f"ms, {lib_kind} {lib_ms:.4f} ms ({row['library_tflops']:.1f} "
        f"TFLOP/s, err {lib_err:.2e}) | bound {bound[0]:.4f} ms by "
        f"{bound[1]}")
    if not (worst <= 1.0 and dead_zero):
        raise AssertionError(f"gmm {name}: kernel differs from its plain "
                             f"version by {worst} × ({tol_text}), rows past "
                             f"the sizes zero {dead_zero}")
    tag = "bf16" if dt == torch.bfloat16 else "fp16"
    if route.startswith("wgmma_tma"):
        kernel, key_fn, ops = "gmm_tma_kernel", _gmm_tma_key, (" HGMMA.",
                                                                " UTMALDG")
        key = (tag, 1 if route == "wgmma_tma_64" else 2)
    elif route == "mma_sync":
        kernel, key_fn, ops = "gmm_mma_kernel", _gmm_mma_key, (" HMMA.", )
        key = (tag, K % 8 == 0 and N % 8 == 0 and x.data_ptr() % 16 == 0
               and w.data_ptr() % 16 == 0)      # launch_mma's 16-byte rule
    else:
        return row
    report, counts = _kernel_report(GroupedMatmulBuilder(), key_fn, key, ops)
    row["kernel"] = report
    log(f"[moe-kernel] gmm {name}: {kernel} {key}: {report['registers']} "
        f"registers, {report['spill_stores']} / {report['spill_loads']} B "
        f"spill stores / loads, SASS " + " / ".join(
            f"{n} {op.strip(' .')}" for op, n in zip(ops, counts)))
    if not all(counts):
        raise AssertionError(f"gmm {name}: no {' or no '.join(ops)} in the "
                             f"SASS of {kernel} {key}")
    return row


def _quant_route_of(qz, fn):
    """fn() and the quantize routes it counted."""
    before = dict(qz.quantize_blockwise.route_launches)
    out = fn()
    return out, {r: n - before[r] for r, n in
                 qz.quantize_blockwise.route_launches.items()
                 if n != before[r]}


def _quant_case(torch, gen, dtype, bits, group_size):
    """Both quantizer kernels over one Mixtral layer's w1 stack, each bit
    for bit against its plain version, with times and bounds."""
    from deepspeed_tpu_torch.ops.kernels import quantizer as qz
    dt = getattr(torch, dtype)
    x = (torch.randn(8, 4096, 14336, device="cuda", generator=gen)
         * 0.02).to(dt)
    (q, s, meta), taken = _quant_route_of(
        qz, lambda: qz.quantize_blockwise(x, bits, group_size))
    torch.cuda.synchronize()
    if taken != {"contiguous": 1}:
        raise AssertionError(f"quantize took {taken}, want one launch on "
                             f"the contiguous route")
    q_ref, s_ref, meta_ref = qz.quantize_blockwise_plain(x, bits, group_size)
    q_ok = (meta == meta_ref and torch.equal(q, q_ref)
            and torch.equal(s, s_ref))
    q_err = (q.int() - q_ref.int()).abs().max().item()
    del q_ref, s_ref
    _free(torch)
    out = qz.dequantize_blockwise(q, s, meta)
    ref = qz.dequantize_blockwise_plain(q, s, meta)
    d_ok = torch.equal(out, ref)
    d_err = (out.float() - ref.float()).abs().max().item()
    del out, ref
    _free(torch)
    row = dict(case=f"{dtype}_int{bits}_g{group_size}", elements=x.numel(),
               route="contiguous")
    row["ms_q"] = cuda_ms(lambda: qz.quantize_blockwise(x, bits, group_size),
                          10)
    row["plain_ms_q"] = cuda_ms(
        lambda: qz.quantize_blockwise_plain(x, bits, group_size), 2,
        warmup=1)
    _free(torch)
    row["ms_d"] = cuda_ms(lambda: qz.dequantize_blockwise(q, s, meta), 10)
    row["plain_ms_d"] = cuda_ms(
        lambda: qz.dequantize_blockwise_plain(q, s, meta), 2, warmup=1)
    n, groups, esz = x.numel(), meta[2], x.element_size()
    row["bound_q"] = _roofline(n * esz + n + 4 * groups, 0, BF16_FLOPS)
    row["bound_d"] = _roofline(n + 4 * groups + n * esz, 0, BF16_FLOPS)
    row.update(err_q=q_err, err_d=d_err, bit_equal=q_ok and d_ok)
    log(f"[quant-kernel] {row['case']} over {n:,} elements ({groups:,} "
        f"groups): q, scales {'bit-equal' if q_ok else 'DIFFER'} (max |Δq| "
        f"{q_err}), dequantized {'bit-equal' if d_ok else 'DIFFER'} | "
        f"quantize {row['ms_q']:.4f} ms (plain {row['plain_ms_q']:.3f}, "
        f"bound {row['bound_q'][0]:.4f}), dequantize {row['ms_d']:.4f} ms "
        f"(plain {row['plain_ms_d']:.3f}, bound {row['bound_d'][0]:.4f}), "
        f"bounds by bytes")
    if not (q_ok and d_ok):
        raise AssertionError(f"quantizer {row['case']}: kernels differ from "
                             f"their plain versions")
    del x, q, s
    _free(torch)
    return row


def _crafted_quant_input(torch, dtype, rounds=64, seed=0):
    """Groups of exact rounding ties of int8 (absmax 127 · 2^e, the other
    values (k + 0.5) · 2^e for k in [-127, 126], e in [-12, 8]: normal in
    bf16 and fp16), then every finite value of ``dtype`` (bf16 or fp16),
    each ``rounds`` times in a random order (groups take random scales)."""
    bits = torch.arange(65536, dtype=torch.int32).to(torch.int16)
    vals = bits.view(dtype)
    vals = vals[torch.isfinite(vals.float())]
    g = torch.Generator().manual_seed(seed)
    mixed = torch.cat([vals[torch.randperm(vals.numel(), generator=g)]
                       for _ in range(rounds)])
    k = torch.arange(-127, 127, dtype=torch.float32) + 0.5
    ties = [torch.cat([torch.tensor([127.0]), k, torch.zeros(1)])
            * 2.0 ** e for e in range(-12, 9)]         # 256 a group
    x = torch.cat([torch.cat(ties), mixed.float()])
    return x.to(dtype).to("cuda")


def _quant_crafted_case(torch):
    """B5's quantize bit for bit over every bf16 and fp16 value at random
    scales and over exact ties, int8 and int4, groups of 128 and 256,
    contiguous and transposed."""
    from deepspeed_tpu_torch.ops.kernels import quantizer as qz
    checked = 0
    for dtype in (torch.bfloat16, torch.float16):
        x = _crafted_quant_input(torch, dtype)
        x = x[:x.numel() // 16384 * 16384]       # [8k, 2048] views
        for bits in (8, 4):
            for gs in (128, 256):
                for view in (x, x.view(-1, 2048).t().contiguous().t()):
                    q, s, meta = qz.quantize_blockwise(view, bits, gs)
                    ref = qz.quantize_blockwise_plain(view, bits, gs)
                    if not (torch.equal(q, ref[0])
                            and torch.equal(s, ref[1])):
                        raise AssertionError(
                            f"quantize {dtype} int{bits} g{gs} "
                            f"{tuple(view.stride())}: differs from its "
                            f"plain version on crafted values")
                    checked += view.numel()
    log(f"[quant-kernel] crafted: every finite bf16 and fp16 value 64 "
        f"times at random scales and exact ties, int8/int4, groups of "
        f"128/256, contiguous and transposed: {checked:,} values bit-equal")
    return checked


def _quant_t_case(torch, gen, bits=8, group_size=128):
    """B5's quantize as the int8 serving build calls it on Llama-2-7B's
    gate projection: ``p.t()`` of the bf16 [11008, 4096] nn.Linear weight,
    on the transposed route, bit for bit against the plain version of the
    same view; beside it the contiguous copy the route no longer makes."""
    from deepspeed_tpu_torch.ops.kernels import quantizer as qz
    p = (torch.randn(11008, 4096, device="cuda", generator=gen)
         * 0.02).to(torch.bfloat16)
    x = p.t()
    (q, s, meta), taken = _quant_route_of(
        qz, lambda: qz.quantize_blockwise(x, bits, group_size))
    torch.cuda.synchronize()
    if taken != {"transposed": 1}:
        raise AssertionError(f"quantize of p.t() took {taken}, want one "
                             f"launch on the transposed route")
    q_ref, s_ref, meta_ref = qz.quantize_blockwise_plain(x, bits, group_size)
    ok = (meta == meta_ref and torch.equal(q, q_ref)
          and torch.equal(s, s_ref))
    err = (q.int() - q_ref.int()).abs().max().item()
    del q_ref, s_ref
    _free(torch)
    n, groups = x.numel(), meta[2]
    row = dict(case=f"gate_proj_t_int{bits}_g{group_size}", elements=n,
               route="transposed", err_q=err, bit_equal=ok)
    row["ms_q"] = cuda_ms(lambda: qz.quantize_blockwise(x, bits, group_size),
                          10)
    row["plain_ms_q"] = cuda_ms(
        lambda: qz.quantize_blockwise_plain(x, bits, group_size), 2,
        warmup=1)
    # what the serving build paid before the transposed route: a
    # contiguous copy of p.t(), then the contiguous kernel on the copy
    row["ms_copy_then_q"] = cuda_ms(
        lambda: qz.quantize_blockwise(x.contiguous(), bits, group_size), 10)
    row["bound_q"] = _roofline(n * 2 + n + 4 * groups, 0, BF16_FLOPS)
    log(f"[quant-kernel] {row['case']} (p.t() of bf16 [11008, 4096], "
        f"{groups:,} groups): q, scales "
        f"{'bit-equal' if ok else 'DIFFER'} (max |Δq| {err}), route "
        f"transposed | quantize {row['ms_q']:.4f} ms (plain "
        f"{row['plain_ms_q']:.3f}, bound {row['bound_q'][0]:.4f}, "
        f"{row['bound_q'][0] / row['ms_q']:.2f} of it); a contiguous copy "
        f"then the contiguous kernel {row['ms_copy_then_q']:.4f} ms")
    if not ok:
        raise AssertionError(f"quantizer {row['case']}: the transposed "
                             f"route differs from the plain version")
    del p, x, q, s
    _free(torch)
    return row


def stage_moe_quant_kernels(seed):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed + 13)
    D, I, E = 4096, 14336, 8
    prefill = [96, 0, 412, 230, 318, 57, 269, 154]      # 1,536 rows
    gmm_rows = []
    for name, sizes, route in (("decode", [2] * E, "wgmma_tma_64"),
                               ("prefill", prefill, "wgmma_tma")):
        for proj, K, N in (("w1", D, I), ("w2", I, D)):
            gmm_rows.append(_gmm_case(torch, gen, f"{name}_{proj}", sizes,
                                      K, N, "bfloat16", route))
            _free(torch)
    # shapes TMA cannot take keep the mma.sync kernel: a K that is not a
    # multiple of 64 (16-byte copies), and w1 with x 8 bytes off (element
    # copies)
    for name, K, off in (("mma_k4064_w1", D - 32, 0),
                         ("mma_unaligned_w1", D, 4)):
        gmm_rows.append(_gmm_case(torch, gen, name, prefill, K, I,
                                  "bfloat16", "mma_sync", x_offset=off))
        _free(torch)
    gmm_rows.append(_gmm_case(torch, gen, "fp32_ragged", [37, 0, 91, 5],
                              1000, 1003, "float32", "fp32"))
    _free(torch)
    quant_rows = [_quant_case(torch, gen, dtype, bits, gs)
                  for dtype in ("bfloat16", "float32") for bits in (8, 4)
                  for gs in (128, 2048)]
    quant_rows.append(_quant_t_case(torch, gen))
    crafted = _quant_crafted_case(torch)
    _free(torch)
    return dict(gmm=gmm_rows, quant=quant_rows, quant_crafted=crafted)


# --------------------------------------------------------------- stage 14
MIXTRAL_8X7B_HF = dict(model_type="mixtral", vocab_size=32000,
                       hidden_size=4096, intermediate_size=14336,
                       num_hidden_layers=32, num_attention_heads=32,
                       num_key_value_heads=8, max_position_embeddings=32768,
                       rms_norm_eps=1e-5, rope_theta=1e6,
                       num_local_experts=8, num_experts_per_tok=2,
                       router_aux_loss_coef=0.02, sliding_window=None,
                       tie_word_embeddings=False)
SERVE_ENGINE = dict(
    dtype="bfloat16", decode_burst=16,
    state_manager=dict(block_size=128, num_blocks=160, max_context=4096,
                       max_ragged_sequence_count=16, max_tracked_sequences=16,
                       max_ragged_batch_size=768, prefill_atom_size=16))


def _hf_shapes(hf):
    """(name, shape) of every HF tensor of a llama or mixtral config, in
    checkpoint order (one tensor per expert for mixtral)."""
    D, V, L = hf["hidden_size"], hf["vocab_size"], hf["num_hidden_layers"]
    I = hf["intermediate_size"]
    H, Hkv = hf["num_attention_heads"], hf["num_key_value_heads"]
    Dh = D // H
    yield "model.embed_tokens.weight", (V, D)
    for i in range(L):
        p = f"model.layers.{i}."
        yield p + "self_attn.q_proj.weight", (H * Dh, D)
        yield p + "self_attn.k_proj.weight", (Hkv * Dh, D)
        yield p + "self_attn.v_proj.weight", (Hkv * Dh, D)
        yield p + "self_attn.o_proj.weight", (D, H * Dh)
        if hf["model_type"] == "mixtral":
            E = hf["num_local_experts"]
            yield p + "block_sparse_moe.gate.weight", (E, D)
            for e in range(E):
                q = p + f"block_sparse_moe.experts.{e}."
                yield q + "w1.weight", (I, D)
                yield q + "w3.weight", (I, D)
                yield q + "w2.weight", (D, I)
        else:
            yield p + "mlp.gate_proj.weight", (I, D)
            yield p + "mlp.up_proj.weight", (I, D)
            yield p + "mlp.down_proj.weight", (D, I)
        yield p + "input_layernorm.weight", (D, )
        yield p + "post_attention_layernorm.weight", (D, )
    yield "model.norm.weight", (D, )
    yield "lm_head.weight", (V, D)


class _RandomCheckpoint:
    """A checkpoint engine whose ``parameters()`` makes each bf16 HF tensor
    on the card from the generator as it is asked for (norms 1, the rest
    normal(0, std)), so that no complete state exists beside the model."""

    def __init__(self, torch, hf, gen, std=0.02):
        self.torch, self.hf, self.gen, self.std = torch, hf, gen, std

    def parameters(self):
        for name, shape in _hf_shapes(self.hf):
            t = self.torch.empty(shape, dtype=self.torch.bfloat16,
                                 device="cuda")
            if name.endswith("norm.weight"):
                t.fill_(1.0)
            else:
                t.normal_(0.0, self.std, generator=self.gen)
            yield name, t


def _serve_run(eng, prompts, new_tokens, counters):
    """``generate`` timed as stage 4 times it, with each counter in
    ``counters`` (name → wrapper) set to 0 just before and read just
    after; then the same requests again, untimed, with every step's logits
    checked finite."""
    import numpy as np
    import torch
    steps = [0]
    step_fn = eng._step_fn

    def counted_step(*args, **kwargs):
        steps[0] += 1
        return step_fn(*args, **kwargs)

    eng._step_fn = counted_step
    first_token = {}
    schedule = eng.schedule_step

    def timed_schedule(*args, **kwargs):
        out = schedule(*args, **kwargs)
        now = time.perf_counter()
        for uid in out:
            first_token.setdefault(uid, now)
        return out

    eng.schedule_step = timed_schedule
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
        if hasattr(fn, "route_launches"):
            fn.route_launches = dict.fromkeys(fn.route_launches, 0)
    start = time.perf_counter()
    outs = eng.generate(prompts, max_new_tokens=new_tokens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches = {name: fn.launches for name, fn in counters.items()}
    routes = {name: dict(fn.route_launches) for name, fn in counters.items()
              if hasattr(fn, "route_launches")}
    peak = torch.cuda.max_memory_allocated()
    bursts = getattr(eng, "burst_steps", 0)
    del eng.schedule_step
    finite = torch.ones((), dtype=torch.bool, device="cuda")

    def probed_step(*args, **kwargs):
        logits, kv = step_fn(*args, **kwargs)
        finite.logical_and_(torch.isfinite(logits).all())
        return logits, kv

    eng._step_fn = probed_step
    again = eng.generate(prompts, max_new_tokens=new_tokens)
    eng._step_fn = step_fn
    lengths = [len(p) for p in prompts]
    ttft = [first_token[u] - start for u in range(len(prompts))]
    prefill_end = max(ttft)
    n_gen = sum(len(o) for o in outs)
    vocab = eng.model_config.vocab_size
    bad = [t for o in outs for t in o if not 0 <= t < vocab]
    if any(len(o) != new_tokens for o in outs) or bad:
        raise AssertionError(f"generate gave wrong lengths or tokens {bad}")
    if not bool(finite):
        raise AssertionError("non-finite logits in the serving run")
    if eng.state_manager.free_blocks != eng.kv_cache.num_blocks - 1:
        raise AssertionError("blocks leaked after generate")
    return dict(wall_s=wall, prefill_tok_s=sum(lengths) / prefill_end,
                decode_tok_s=(n_gen - len(prompts)) / (wall - prefill_end),
                ttft_mean_s=float(np.mean(ttft)), ttft_max_s=prefill_end,
                peak_bytes=peak, steps=steps[0], bursts=bursts,
                launches=launches, route_launches=routes,
                prompt_lengths=lengths, same_tokens_rerun=again == outs)


def _serve_line(tag, r, smi):
    log(f"[{tag}] prompts {r['prompt_lengths']} (sum "
        f"{sum(r['prompt_lengths'])}), {r['steps']} ragged steps, "
        f"{r['bursts']} bursts | wall {r['wall_s']:.3f} s | prefill "
        f"{r['prefill_tok_s']:.1f} tok/s | decode {r['decode_tok_s']:.1f} "
        f"tok/s | TTFT mean {r['ttft_mean_s']:.3f} s max "
        f"{r['ttft_max_s']:.3f} s | peak memory {r['peak_bytes'] / 2**30:.2f}"
        f" GiB | {smi}")
    log(f"[{tag}] kernel launches in this run: {r['launches']}; untimed "
        f"rerun: logits finite, same tokens {r['same_tokens_rerun']}")


def _serve_prompts(seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    lengths = rng.integers(128, 2049, size=8).tolist()
    return [rng.integers(0, 32000, size=n).tolist() for n in lengths]


def stage_mixtral_serve(seed, smi, profile_dir=None):
    import torch
    from deepspeed_tpu_torch.inference.v2 import build_engine_from_checkpoint
    from deepspeed_tpu_torch.models.mixtral import param_count
    from deepspeed_tpu_torch.ops.kernels import grouped_matmul as gm
    from deepspeed_tpu_torch.ops.kernels import paged_attention as pa

    hf = dict(MIXTRAL_8X7B_HF, num_hidden_layers=16)
    gen = torch.Generator(device="cuda").manual_seed(seed + 14)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = build_engine_from_checkpoint(_RandomCheckpoint(torch, hf, gen), hf,
                                       dict(SERVE_ENGINE))
    torch.cuda.synchronize()
    cfg = eng.model_config
    log(f"[mixtral] Mixtral-8x7B width, {cfg.num_hidden_layers} of 32 "
        f"layers ({param_count(cfg) / 1e9:.2f} B params), streamed through "
        f"build_engine_from_checkpoint in {time.perf_counter() - t0:.1f} s;"
        f" build peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"resident {torch.cuda.memory_allocated() / 2**30:.2f} GiB incl. KV")
    counters = {"gmm": gm.gmm, "paged_attention": pa.paged_attention,
                "paged_attention_atoms": pa.paged_attention_atoms}
    r = _serve_run(eng, _serve_prompts(seed), 64, counters)
    _serve_line("mixtral", r, smi)
    want = 3 * cfg.num_hidden_layers * r["steps"]
    if r["launches"]["gmm"] != want:
        raise AssertionError(f"gmm launched {r['launches']['gmm']} times, "
                             f"want 3 × {cfg.num_hidden_layers} × "
                             f"{r['steps']} = {want}")
    if min(r["launches"].values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{r['launches']}")
    _check_paged_routes("mixtral", r["launches"], r["route_launches"])
    log(f"[mixtral] gmm launches {r['launches']['gmm']} = 3 × "
        f"{cfg.num_hidden_layers} layers × {r['steps']} ragged steps "
        f"(decode-burst steps counted each); by route "
        f"{r['route_launches']['gmm']}")
    tma = sum(n for route, n in r["route_launches"]["gmm"].items()
              if route.startswith("wgmma_tma"))
    if tma != r["launches"]["gmm"]:
        raise AssertionError(f"Mixtral's gmm launches did not all take the "
                             f"wgmma/TMA routes: {r['route_launches']}")
    if profile_dir:
        r["profile"] = profile_serve(eng, _serve_prompts(seed + 1),
                                     profile_dir, smi, stem="mixtral")
    del eng
    _free(torch)
    return r


# --------------------------------------------------------------- stage 15
def device_time(torch, body):
    """``body()`` under ``torch.profiler`` (CUDA activity only): (its
    result, wall ms between synchronizes, the summed time of the device
    kernels it ran in ms, or None where the profiler kept no device record,
    and the number of kernel records)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = body()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    us, records = 0.0, 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t = getattr(e, "self_device_time_total", None)
            us += e.self_cuda_time_total if t is None else t
            records += e.count
    return out, wall, (us / 1e3 if records else None), records


def stage_quant_serve(seed, smi, bf16_peak, profile_dir=None):
    import numpy as np
    import torch
    from deepspeed_tpu_torch.inference import quant_serving
    from deepspeed_tpu_torch.inference.v2 import build_engine_from_checkpoint
    from deepspeed_tpu_torch.inference.v2 import engine_v2
    from deepspeed_tpu_torch.ops.kernels import paged_attention as pa
    from deepspeed_tpu_torch.ops.kernels import quantizer as qz

    gen = torch.Generator(device="cuda").manual_seed(seed + 15)
    qz.quantize_blockwise.launches = 0
    qz.quantize_blockwise.route_launches = dict.fromkeys(qz.ROUTES, 0)
    torch.cuda.reset_peak_memory_stats()
    tree_times = {}

    def quantize_tree(*args):
        out, wall, dev, records = device_time(
            torch, lambda: quant_serving.quantize_tree(*args))
        # every launch must have its record, or the sum is not the device
        # time
        launched = qz.quantize_blockwise.launches
        tree_times.update(wall_ms=wall, device_ms=(
            dev if records >= launched else None), records=records)
        return out

    engine_v2.quantize_tree = quantize_tree
    try:
        t0 = time.perf_counter()
        eng = build_engine_from_checkpoint(
            _RandomCheckpoint(torch, LLAMA2_7B_HF, gen), LLAMA2_7B_HF,
            dict(SERVE_ENGINE, quantization_mode="int8"))
        torch.cuda.synchronize()
    finally:
        engine_v2.quantize_tree = quant_serving.quantize_tree
    n_leaves = len(eng._quant_meta)
    built = qz.quantize_blockwise.launches
    routes = dict(qz.quantize_blockwise.route_launches)
    linears = sum(isinstance(m, torch.nn.Linear)
                  for m in eng.module.modules())
    resident = quant_serving.resident_bytes(eng.module)
    log(f"[quant] Llama-2-7B int8 engine built in "
        f"{time.perf_counter() - t0:.1f} s: {n_leaves} weights quantized "
        f"(quantize launches {built}, by route {routes}; {linears} "
        f"nn.Linear), quantize_tree {tree_times['wall_ms']:.1f} ms wall "
        f"under the profiler, "
        f"device (kernels, {tree_times['records']} profiler records) "
        + (f"{tree_times['device_ms']:.2f} ms"
           if tree_times["device_ms"] is not None else "not measured")
        + f", resident weights "
        f"{resident / 2**30:.3f} GiB (int8 + fp32 scales + norms), build "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if built != n_leaves:
        raise AssertionError(f"quantize launched {built} times for "
                             f"{n_leaves} weights")
    if routes["transposed"] != linears or routes["copy"]:
        raise AssertionError(f"quantize routes {routes}: want every one of "
                             f"the {linears} nn.Linear weights on the "
                             f"transposed route and none copied")
    counters = {"dequantize_blockwise": qz.dequantize_blockwise,
                "paged_attention": pa.paged_attention,
                "paged_attention_atoms": pa.paged_attention_atoms}
    r = _serve_run(eng, _serve_prompts(seed), 64, counters)
    _serve_line("quant", r, smi)
    want = n_leaves * r["steps"]
    if r["launches"]["dequantize_blockwise"] != want:
        raise AssertionError(f"dequantize launched "
                             f"{r['launches']['dequantize_blockwise']} "
                             f"times, want {n_leaves} × {r['steps']}")
    if min(r["launches"].values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{r['launches']}")
    _check_paged_routes("quant", r["launches"], r["route_launches"])
    log(f"[quant] dequantize launches {want} = {n_leaves} weights × "
        f"{r['steps']} ragged steps; peak {r['peak_bytes'] / 2**30:.2f} GiB "
        f"against stage 4's bf16 peak {bf16_peak / 2**30:.2f} GiB in this "
        f"run")
    if not r["peak_bytes"] < bf16_peak:
        raise AssertionError("the int8 engine's serving peak is not below "
                             "the bf16 engine's")
    r.update(quantize_launches=built, quantized_weights=n_leaves,
             quantize_routes=routes, quantize_tree_ms=tree_times,
             resident_bytes=resident)
    if profile_dir:
        r["profile"] = profile_serve(eng, _serve_prompts(seed + 1),
                                     profile_dir, smi, stem="quant")
    del eng
    _free(torch)

    # int4, one short request: finite logits, valid tokens
    eng = build_engine_from_checkpoint(
        _RandomCheckpoint(torch, LLAMA2_7B_HF, gen), LLAMA2_7B_HF,
        dict(SERVE_ENGINE, quantization_mode="int4"))
    finite = torch.ones((), dtype=torch.bool, device="cuda")
    step_fn = eng._step_fn

    def probed_step(*args, **kwargs):
        logits, kv = step_fn(*args, **kwargs)
        finite.logical_and_(torch.isfinite(logits).all())
        return logits, kv

    eng._step_fn = probed_step
    prompt = np.random.default_rng(seed + 4).integers(0, 32000, 200).tolist()
    out = eng.generate([prompt], max_new_tokens=16)[0]
    ok = bool(finite) and len(out) == 16 and all(0 <= t < 32000 for t in out)
    log(f"[quant] int4 engine, one 200-token request: 16 tokens {out}, "
        f"logits finite {bool(finite)}")
    if not ok:
        raise AssertionError("int4 serving gave non-finite logits or bad "
                             "tokens")
    r["int4_tokens"] = out
    del eng
    _free(torch)
    return r


# --------------------------------------------------------------- stage 16
def _step_pair(torch, eng, step_fn, prompt, n_decode, tag):
    """One prefill and ``n_decode`` teacher-forced decode steps of ``eng``,
    each run with the kernels and with their plain versions on copies of
    the same cache; logits compared.  Mixtral: where a top-2 choice flips
    between the runs, the plain run is redone with the kernel run's router
    logits and that comparison is the one held to the tolerance."""
    from deepspeed_tpu_torch.inference.v2 import ragged_forward as rf
    eng.put([0], [prompt])
    caches = {True: eng._kv.clone(), False: eng._kv.clone()}
    seq = eng.state_manager.get_sequence(0)
    real_moe = rf.moe_apply
    report = []
    for step in range(1 + n_decode):
        toks, pos, slots, last_idx, finishing, layout = eng._build_batch()
        args = [eng._to_device(a) for a in
                (toks, pos, slots, eng.state_manager.block_table, last_idx)]
        cfg = eng.model_config
        routed = {True: [], False: []}

        def run(use_kernel, kv, feed=None):
            def moe(x, logits, *a, **kw):
                routed[use_kernel].append(logits)
                return real_moe(x, feed.pop(0) if feed else logits, *a, **kw)

            rf.moe_apply = moe
            try:
                out, _ = step_fn(eng.module, kv, *args, cfg=cfg,
                                 block_size=128, layout=layout,
                                 use_kernel=use_kernel)
            finally:
                rf.moe_apply = real_moe
            return out[seq.slot]

        kv_plain = caches[False].clone()
        k = run(True, caches[True])
        p = run(False, caches[False])
        flips = 0
        for a, b in zip(routed[True], routed[False]):
            n = getattr(cfg, "num_experts_per_tok", 0)
            ta = torch.topk(a, n, dim=-1).indices.sort(dim=-1).values
            tb = torch.topk(b, n, dim=-1).indices.sort(dim=-1).values
            flips += int((ta != tb).any(dim=-1).sum())
        if flips:
            routed[False].clear()
            p = run(False, kv_plain, feed=list(routed[True]))
        caches[False] = kv_plain if flips else caches[False]
        err = (k - p).abs().max().item()
        tol = 0.02 * max(1.0, p.abs().max().item())
        top = torch.topk(k, 2).values
        margin = (top[0] - top[1]).item()
        tok = int(torch.argmax(k))
        agree = tok == int(torch.argmax(p))
        report.append(dict(layout=layout, err=err, tol=tol, margin=margin,
                           agree=agree, routing_flips=flips))
        log(f"[step16] {tag} {'prefill' if step == 0 else 'decode'} layout "
            f"{layout}: logits max|kernel - plain| {err:.4e} (tol "
            f"{tol:.3e}), top-2 margin {margin:.4f}, greedy tokens agree: "
            f"{agree}"
            + (f"; {flips} token routing choice(s) flipped between the runs,"
               f" so the plain run was redone with the kernel run's router "
               f"logits" if flips else ""))
        if not err <= tol:
            raise AssertionError(f"{tag}: ragged step logits differ by {err}")
        if not agree and margin > 2 * tol:
            raise AssertionError(f"{tag}: greedy tokens differ at a clear "
                                 f"margin")
        seq.tokens.append(tok)
    eng.flush([0])
    return report


def stage_moe_quant_step_vs_plain(seed):
    import numpy as np
    import torch
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    from deepspeed_tpu_torch.inference.v2.ragged_forward import (
        llama_ragged_step, mixtral_ragged_step)
    from deepspeed_tpu_torch.inference.v2.model_implementations.hf_builders \
        import _mixtral_config_from_hf
    from deepspeed_tpu_torch.models.llama import LlamaModel, llama_7b
    from deepspeed_tpu_torch.models.mixtral import MixtralModel

    gen = torch.Generator(device="cuda").manual_seed(seed + 16)
    engine_config = dict(
        dtype="bfloat16", decode_burst=0,
        state_manager=dict(block_size=128, num_blocks=8, max_context=512,
                           max_ragged_sequence_count=4,
                           max_tracked_sequences=4,
                           max_ragged_batch_size=288, prefill_atom_size=16))
    prompt = np.random.default_rng(seed).integers(0, 32000, 256).tolist()
    cfg = _mixtral_config_from_hf(dict(MIXTRAL_8X7B_HF, num_hidden_layers=2),
                                  "bfloat16")
    model = MixtralModel(cfg, device="cuda").init_weights(gen)
    eng = InferenceEngineV2(model, config=dict(engine_config))
    mixtral = _step_pair(torch, eng, mixtral_ragged_step, prompt, 2,
                         "mixtral")
    del eng, model
    _free(torch)
    model = LlamaModel(llama_7b(num_hidden_layers=2, dtype="bfloat16"),
                       device="cuda").init_weights(gen)
    eng = InferenceEngineV2(model, config=dict(engine_config,
                                               quantization_mode="int8"))
    llama = _step_pair(torch, eng, llama_ragged_step, prompt, 2,
                       "llama_int8")
    del eng, model
    _free(torch)
    return dict(mixtral=mixtral, llama_int8=llama)


# --------------------------------------------------------------- stage 17
# AlphaFold2's Evoformer widths (Jumper et al., Nature 2021, Suppl.
# Algorithms 7 and 13-14; OpenFold's config.py has the same): MSA row
# attention with pair bias 8 heads × 32, triangle attention 4 heads × 32;
# fine-tuning crop N_res 384, N_seq 512; training crop N_res 256, N_seq 128
EVO_CASES = [
    # (name, B·N folded batch, Gb = rows one bias row serves, L, H, Hb, D,
    #  mask, causal, dtype, timed)
    ("msa_row_finetune", 512, 512, 384, 8, 8, 32, True, False, "bfloat16",
     True),
    ("triangle_finetune", 384, 384, 384, 4, 4, 32, False, False, "bfloat16",
     True),
    ("msa_row_train_fp16", 128, 128, 256, 8, 8, 32, True, False, "float16",
     True),
    ("causal_grouped_fp32", 4, 2, 100, 4, 2, 32, True, True, "float32",
     False),
]


def _evo_mask(torch, gen, rows, L):
    """OpenFold's mask bias -1e9·(1 - mask), fp32 [rows, 1, 1, L]: about
    one key in ten masked, and row 1 (an MSA row of padding) masked
    whole."""
    keep = (torch.rand(rows, 1, 1, L, device="cuda", generator=gen)
            > 0.1).float()
    keep[1] = 0
    return -1e9 * (1 - keep)


def _evo_bound(flops, peak, *tensors):
    """(ms, what binds): each tensor read or written once (None skipped)
    at 3.35 TB/s against ``flops`` at ``peak``."""
    nb = sum(t.numel() * t.element_size() for t in tensors if t is not None)
    return _roofline(nb, flops, peak)


def _evo_case(torch, gen, name, BN, Gb, L, H, Hb, D, mask, causal, dtype,
              timed):
    """B10's four kernels, each against its plain version on the same
    inputs (the backward ones on the forward kernel's o and lse and the dq
    kernel's delta); dbias twice, bit for bit; times, SDPA with the biases
    as a float ``attn_mask``, and bounds."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.kernels import flash_bias as fb
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.randn(BN, L, H, D, device="cuda", generator=gen)
                   .to(dt) for _ in range(4))
    bias = (torch.randn(BN // Gb, Hb, L, L, device="cuda", generator=gen)
            * 0.5).to(dt)
    m = _evo_mask(torch, gen, BN, L) if mask else None
    args = (bias, m, D**-0.5, causal)
    fwd = lambda: fb.flash_bias_fwd(q, k, v, *args)  # noqa: E731
    o, lse = fwd()
    dq_fn = lambda: fb.flash_bias_bwd_dq(q, k, v, o, do, lse, *args)  # noqa
    dq, delta = dq_fn()
    dkv_fn = lambda: fb.flash_bias_bwd_dkv(  # noqa: E731
        q, k, v, do, lse, delta, *args)
    dk, dv = dkv_fn()
    dbias_fn = lambda: fb.flash_bias_bwd_dbias(  # noqa: E731
        q, k, v, do, lse, delta, *args)
    dbias, again = dbias_fn(), dbias_fn()
    torch.cuda.synchronize()
    identical = torch.equal(dbias, again)
    del again
    low = {torch.bfloat16: "bf16", torch.float16: "fp16"}.get(dt, False)
    errs = {}
    o_ref, lse_ref = fb._plain_fwd(q, k, v, *args)
    errs["o"] = _compare(torch, o, o_ref, low)
    errs["lse"] = _compare(torch, lse, lse_ref, False)
    del o_ref, lse_ref
    _free(torch)
    dq_ref, delta_ref = fb._plain_bwd_dq(q, k, v, o, do, lse, *args)
    errs["dq"] = _compare(torch, dq, dq_ref, low)
    errs["delta"] = _compare(torch, delta, delta_ref, False)
    del dq_ref, delta_ref
    _free(torch)
    dk_ref, dv_ref = fb._plain_bwd_dkv(q, k, v, do, lse, delta, *args)
    errs["dk"] = _compare(torch, dk, dk_ref, low)
    errs["dv"] = _compare(torch, dv, dv_ref, low)
    del dk_ref, dv_ref
    _free(torch)
    dbias_ref = fb._plain_bwd_dbias(q, k, v, do, lse, delta, *args)
    errs["dbias"] = _compare(torch, dbias, dbias_ref, False)
    del dbias_ref
    _free(torch)
    tol_text = (f"2^-{7 if low == 'bf16' else 10}·|ref| + {BF16_ATOL:g}"
                if low else f"{FP32_ATOL:g} + {FP32_RTOL:g}·|ref|")
    log(f"[evo-kernel] {name}: q/k/v [{BN},{L},{H},{D}] bias "
        f"{list(bias.shape)} mask {None if m is None else list(m.shape)} "
        f"causal={causal} {dtype}: " + ", ".join(
            f"{w} {e:.2e} ({r:.3f})" for w, (e, r) in errs.items())
        + f" — max_abs_err (worst |err| / tol), tol {tol_text} for "
        f"{dtype} outputs, {FP32_ATOL:g} + {FP32_RTOL:g}·|ref| for lse, "
        f"delta and the fp32 dbias; dbias bit-identical across two runs: "
        f"{identical}")
    bad = {w: r for w, (e, r) in errs.items() if not r <= 1.0}
    if bad or not identical:
        raise AssertionError(f"{name}: flash bias kernels differ from their "
                             f"plain versions beyond tolerance {bad}, or "
                             f"dbias differs between runs ({identical})")
    row = dict(case=name, shape=[BN, L, H, D], bias=list(bias.shape),
               dtype=dtype, causal=causal, errs=errs,
               dbias_bit_identical=identical,
               worst=max(r for _, r in errs.values()))
    if not timed:
        del q, k, v, do, o, dq, dk, dv, dbias
        _free(torch)
        return row
    for w, fn in (("fwd", fwd), ("dq", dq_fn), ("dkv", dkv_fn),
                  ("dbias", dbias_fn)):
        row[f"ms_{w}"] = cuda_ms(fn, 10)
    row["plain_ms_fwd"] = cuda_ms(lambda: fb._plain_fwd(q, k, v, *args), 3,
                                  warmup=1)
    _free(torch)
    row["plain_ms_dq"] = cuda_ms(
        lambda: fb._plain_bwd_dq(q, k, v, o, do, lse, *args), 3, warmup=1)
    _free(torch)
    row["plain_ms_dkv"] = cuda_ms(
        lambda: fb._plain_bwd_dkv(q, k, v, do, lse, delta, *args), 3,
        warmup=1)
    _free(torch)
    row["plain_ms_dbias"] = cuda_ms(
        lambda: fb._plain_bwd_dbias(q, k, v, do, lse, delta, *args), 3,
        warmup=1)
    _free(torch)
    # library yardstick: SDPA on [B·N, H, L, D] with the pair bias and the
    # mask added into one float attn_mask [B·N, H, L, L] outside the timing
    qh, kh, vh, doh = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    # (fp16 cannot hold -1e9: its mask is clamped to -3e4)
    am = bias.repeat_interleave(Gb, dim=0).repeat_interleave(H // Hb, dim=1)
    if m is not None:
        am = am + m.clamp(min=-3e4 if dt == torch.float16 else -1e9).to(dt)
    am = am.contiguous()
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qh, kh, vh, attn_mask=am)
    row["library_ms_fwd"] = cuda_ms(sdpa, 10)
    for t in (qh, kh, vh, am):
        t.requires_grad_(True)
    try:
        sdpa().backward(doh)
        row["library_bias_grad"] = am.grad is not None
    except RuntimeError as e:      # the yardstick only: the port never runs it
        log(f"[evo-kernel] {name}: SDPA backward with a float attn_mask "
            f"raised: {e}")
        row["library_bias_grad"] = False
    if row["library_bias_grad"]:
        def sdpa_fwd_bwd():
            for t in (qh, kh, vh, am):
                t.grad = None
            sdpa().backward(doh)

        row["library_ms_fwd_bwd"] = cuda_ms(sdpa_fwd_bwd, 10)
        row["library_ms_bwd"] = (row["library_ms_fwd_bwd"]
                                 - row["library_ms_fwd"])
    else:
        row["library_ms_fwd_bwd"] = row["library_ms_bwd"] = None
    del qh, kh, vh, doh, am
    _free(torch)
    pairs = _live_pairs(L, L, causal, 0)
    flop = 2 * BN * H * D * pairs            # one product over live pairs
    peak = FP32_FLOPS if dt == torch.float32 else BF16_FLOPS
    row["bound_fwd"] = _evo_bound(2 * flop, peak, q, k, v, bias, m, o, lse)
    row["bound_dq"] = _evo_bound(3 * flop, peak, q, k, v, o, do, lse, bias,
                                 m, dq, delta)
    row["bound_dkv"] = _evo_bound(4 * flop, peak, q, k, v, do, lse, delta,
                                  bias, m, dk, dv)
    row["bound_dbias"] = _evo_bound(2 * flop, peak, q, k, v, do, lse, delta,
                                    bias, m, dbias)
    # the three backward kernels as one function: 5 products for dq and
    # dk/dv, 2 for dbias
    row["bound_bwd"] = _evo_bound(7 * flop, peak, q, k, v, o, do, lse, bias,
                                  m, dq, dk, dv, dbias)
    row["gflop_product"] = flop / 1e9
    log(f"[evo-kernel] {name} times (ms): fwd {row['ms_fwd']:.4f}, dq "
        f"{row['ms_dq']:.4f}, dk/dv {row['ms_dkv']:.4f}, dbias "
        f"{row['ms_dbias']:.4f} | plain fwd {row['plain_ms_fwd']:.3f}, dq "
        f"{row['plain_ms_dq']:.3f}, dk/dv {row['plain_ms_dkv']:.3f}, dbias "
        f"{row['plain_ms_dbias']:.3f} | sdpa+attn_mask fwd "
        f"{row['library_ms_fwd']:.4f}, fwd+bwd "
        + (f"{row['library_ms_fwd_bwd']:.4f}" if row["library_bias_grad"]
           else "none (this torch's SDPA gives attn_mask no gradient)")
        + " | bound fwd {:.4f} ({}), dq {:.4f}, dk/dv {:.4f}, dbias {:.4f}, "
        "whole backward {:.4f} ({}); {:.2f} GFLOP per product".format(
            row["bound_fwd"][0], row["bound_fwd"][1], row["bound_dq"][0],
            row["bound_dkv"][0], row["bound_dbias"][0], row["bound_bwd"][0],
            row["bound_bwd"][1], row["gflop_product"]))
    if low:
        _log_fb_kernels(row, name, low, low, D, BN * H * pairs)
    del q, k, v, do, o, dq, dk, dv, dbias, lse, delta
    _free(torch)
    return row


MUFU_EX2_PER_CLOCK = 16          # ex2 results a clock per SM (sm_90)
H100_SMS = 132
_FB_PRODUCTS = {"fwd": 2, "dq": 3, "dkv": 4, "dbias": 2}  # products a pass


def _max_sm_clock_hz():
    """The card's maximum SM clock from nvidia-smi (H100 SXM: 1980 MHz
    when it cannot be read)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30).stdout.split()
        return float(out[0]) * 1e6
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return 1980e6


def _log_fb_kernels(row, name, dtype, bias_dtype, D, scores):
    """Per tensor-core B10 kernel of this case: registers and spills from
    ``ptxas -v``, the HMMA count of its SASS (none fails the stage), the
    achieved TFLOP/s of useful work (2, 3, 4 and 2 products of 2·D flops
    a live score for fwd, dq, dk/dv and dbias), and beside the bound the
    time the exponentials alone take at the MUFU rate (one ex2 a score in
    each kernel: each recomputes P)."""
    from deepspeed_tpu_torch.ops.op_builder import FlashBiasBuilder
    dp = 32 if D <= 32 else 64 if D <= 64 else 128
    builder = FlashBiasBuilder()
    usage = _ptxas_usage(builder.finish_build(None)[1], _fb_mma_key)
    sass = _flash_sass(builder, _fb_mma_key)
    clock = _max_sm_clock_hz()
    exp_ms = scores / (MUFU_EX2_PER_CLOCK * H100_SMS * clock) * 1e3
    row["exp_ms"], row["sm_clock_hz"] = exp_ms, clock
    row["kernels"] = {}
    for kern, products in _FB_PRODUCTS.items():
        key = (kern, dtype, bias_dtype, dp)
        u = usage.get(key, {})
        hmma, ffma = sass.get(key, (0, 0))
        tflops = products * 2 * D * scores / row[f"ms_{kern}"] / 1e9
        row["kernels"][kern] = dict(
            registers=u.get("registers"), spill_stores=u.get("spill_stores"),
            spill_loads=u.get("spill_loads"), hmma=hmma, ffma=ffma,
            tflops=tflops)
        log(f"[evo-kernel] {name} {kern} ({dtype}, bias {bias_dtype}, "
            f"D{dp}): {u.get('registers', '?')} registers, "
            f"{u.get('spill_stores', '?')} / {u.get('spill_loads', '?')} B "
            f"spill stores / loads, SASS {hmma} HMMA / {ffma} FFMA; "
            f"{row[f'ms_{kern}']:.4f} ms, {tflops:.1f} TFLOP/s of useful "
            f"work; bound {row[f'bound_{kern}'][0]:.4f} ms "
            f"({row[f'bound_{kern}'][1]}), exponentials alone "
            f"{exp_ms:.4f} ms ({scores / 1e6:.1f} M ex2 at "
            f"{MUFU_EX2_PER_CLOCK} a clock on {H100_SMS} SMs at "
            f"{clock / 1e6:.0f} MHz)")
    missing = [k for k, v in row["kernels"].items() if not v["hmma"]]
    if missing:
        raise AssertionError(f"{name}: no HMMA in the SASS of the B10 "
                             f"kernels {missing}")


def stage_evoformer_kernels(seed):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed + 17)
    rows = []
    for case in EVO_CASES:
        rows.append(_evo_case(torch, gen, *case))
        _free(torch)
    return rows


# --------------------------------------------------------------- stage 18
EVO_PATH_SHAPES = [
    # (name, [B, N, L, H, D] of Q/K/V, mask, pair bias)
    ("msa_row_finetune", (1, 512, 384, 8, 32), True, True),
    ("triangle_finetune", (1, 384, 384, 4, 32), True, True),
    # MSA column attention: N_res rows of N_seq keys, mask only
    ("msa_column_finetune", (1, 384, 512, 8, 32), True, False),
]


def _flash_bias_counts():
    from deepspeed_tpu_torch.ops.kernels import flash_bias as fb
    return {f.__name__: f for f in (fb.flash_bias_fwd, fb.flash_bias_bwd_dq,
                                    fb.flash_bias_bwd_dkv,
                                    fb.flash_bias_bwd_dbias)}


def _evo_inputs(torch, gen, shape, mask, pair):
    """bf16 Q, K, V, dO [B, N, L, H, D] and the biases, Q/K/V and the pair
    bias requiring grad (OpenFold's pair bias is a projection of z); the
    mask bias requires grad too, to show the route gives it none."""
    B, N, L, H, D = shape
    q, k, v, do = (torch.randn(*shape, device="cuda", generator=gen)
                   .to(torch.bfloat16) for _ in range(4))
    biases = []
    if mask:
        biases.append(_evo_mask(torch, gen, B * N, L).view(B, N, 1, 1, L)
                      .to(torch.bfloat16))
    if pair:
        biases.append((torch.randn(B, 1, H, L, L, device="cuda",
                                   generator=gen) * 0.5).to(torch.bfloat16))
    leaves = [t.requires_grad_(True) for t in (q, k, v, *biases)]
    return leaves, do


def _evo_step(attn, leaves, do):
    for t in leaves:
        t.grad = None
    out = attn(*leaves[:3], leaves[3:])
    out.backward(do)
    return out


def _plain_route(Q, K, V, biases):
    """The routed call with each kernel replaced by its plain version:
    the peak-memory yardstick on the card."""
    from deepspeed_tpu_torch.ops.kernels import flash_bias as fb
    mask, pair = biases
    B, N, L, H, D = Q.shape
    out = fb.flash_attention_bias_plain(
        Q.reshape(B * N, L, H, D), K.reshape(B * N, L, H, D),
        V.reshape(B * N, L, H, D), pair.reshape(B, H, L, L),
        mask.reshape(B * N, 1, 1, L))
    return out.reshape(B, N, L, H, D)


def _peak(torch, fn):
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


# the routed MSA-row call's peak above its inputs with the CUDA-core B10
# kernels (PERF.md): the tensor-core ones may add only the dbias scratch
CUDA_CORE_PEAK_GIB = 0.111


def _dbias_scratch_bytes(shape):
    """The dbias split's scratch for one routed call of ``shape``."""
    from deepspeed_tpu_torch.ops.kernels.flash_bias import dbias_splits
    B, N, L, H, _ = shape
    splits = dbias_splits(B * N, H, L, L, B, H)
    return splits, (splits * B * H * L * L * 4 if splits > 1 else 0)


def _evo_kind(key):
    for k in FB_KINDS:
        if k in key:
            return k
    return "matmul" if _is_matmul(key) else "other"


FB_KINDS = tuple(f"fb_{p}" for p in FB_PASSES)   # B10's kernel names


def profile_evoformer(seed, smi, out_dir):
    """Where the Evoformer call's device time goes: three MSA-row calls
    (stage 18's first shape, forward and backward) under the profiler.
    Run as the process's first profiler window: later in a full run,
    after the serving and training windows, the profiler kept 1 of about
    15 of this window's device records.  The breakdown counts only when
    every B10 launch left a record."""
    import torch
    from deepspeed_tpu_torch.ops.deepspeed4science import \
        DS4Sci_EvoformerAttention
    gen = torch.Generator(device="cuda").manual_seed(seed + 18)
    counters = _flash_bias_counts()
    _, shape, mask, pair = EVO_PATH_SHAPES[0]
    leaves, do = _evo_inputs(torch, gen, shape, mask, pair)
    for _ in range(2):
        _evo_step(DS4Sci_EvoformerAttention, leaves, do)
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0

    def three_calls():
        for _ in range(3):
            _evo_step(DS4Sci_EvoformerAttention, leaves, do)

    def launched():
        return {kind: c.launches for kind, c in zip(FB_KINDS,
                                                    counters.values())}

    out = _profile_window("evoformer_msa_row_profile", three_calls,
                          _evo_kind, out_dir, smi, expect=launched)
    del leaves, do
    _free(torch)
    return out


def stage_evoformer(seed):
    import torch
    from deepspeed_tpu_torch.ops.deepspeed4science import \
        DS4Sci_EvoformerAttention
    gen = torch.Generator(device="cuda").manual_seed(seed + 18)
    counters = _flash_bias_counts()
    results, launches = {}, {n: 0 for n in counters}
    for name, shape, mask, pair in EVO_PATH_SHAPES:
        leaves, do = _evo_inputs(torch, gen, shape, mask, pair)
        routed = pair
        for _ in range(2):
            _evo_step(DS4Sci_EvoformerAttention, leaves, do)
        torch.cuda.synchronize()
        iters = 8 if routed else 2
        for c in counters.values():
            c.launches = 0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            out = _evo_step(DS4Sci_EvoformerAttention, leaves, do)
        end.record()
        torch.cuda.synchronize()
        got = {n: c.launches for n, c in counters.items()}
        r = dict(shape=list(shape), routed=routed, iters=iters,
                 ms_fwd_bwd=start.elapsed_time(end) / iters, launches=got)
        for n in launches:
            launches[n] += got[n]
        with torch.no_grad():
            r["ms_fwd"] = cuda_ms(lambda: DS4Sci_EvoformerAttention(
                *leaves[:3], leaves[3:]), iters)
        finite = bool(torch.isfinite(out).all()) and all(
            bool(torch.isfinite(t.grad).all()) for t in leaves
            if t.grad is not None)
        r["finite"] = finite
        r["mask_grad"] = (None if leaves[3].grad is None
                          else float(leaves[3].grad.abs().max()))
        want = iters if routed else 0
        r["peak_bytes"] = _peak(torch, lambda: _evo_step(
            DS4Sci_EvoformerAttention, leaves, do))
        if routed:
            kernel_grads = [out.detach()] + [
                None if t.grad is None else t.grad.detach().clone()
                for t in leaves]
            r["plain_peak_bytes"] = _peak(torch, lambda: _evo_step(
                _plain_route, leaves, do))
            with torch.no_grad():
                plain_out = _plain_route(*leaves[:3], leaves[3:])
            # the plain route's own forward, so its o (and delta) differ
            # from the kernels' by a bf16 ulp: held to 2 % of max |ref|
            refs = [plain_out.detach()] + [
                None if t.grad is None else t.grad for t in leaves]
            r["vs_plain"] = {}
            for w, a, b in zip(("out", "dQ", "dK", "dV", "dMask", "dPair"),
                               kernel_grads, refs):
                if a is None or b is None:
                    continue
                err = (a.float() - b.float()).abs().max().item()
                tol = 0.02 * b.float().abs().max().item()
                r["vs_plain"][w] = (err, tol)
            del plain_out, refs, kernel_grads
        if routed:
            r["dbias_splits"], r["scratch_bytes"] = _dbias_scratch_bytes(
                shape)
        log(f"[evoformer] {name}: Q/K/V {list(shape)} bf16, "
            f"{'routed (mask + pair bias)' if routed else 'chunked (mask only)'}: "
            f"fwd {r['ms_fwd']:.3f} ms, fwd+bwd {r['ms_fwd_bwd']:.3f} ms "
            f"({iters} timed after 2 warm-up), launches {got}, peak "
            f"{r['peak_bytes'] / 2**30:.3f} GiB above the inputs"
            + (f" (plain route {r['plain_peak_bytes'] / 2**30:.3f} GiB; "
               f"dbias scratch {r['scratch_bytes'] / 2**30:.3f} GiB in "
               f"{r['dbias_splits']} chunks; the CUDA-core kernels "
               f"peaked {CUDA_CORE_PEAK_GIB} GiB at the MSA-row shape)"
               if routed else "")
            + f", finite {finite}, mask grad {r['mask_grad']}"
            + ("" if not routed else ", vs plain route (max|err|, tol): "
               + ", ".join(f"{w} {e:.3e}/{t:.3e}"
                           for w, (e, t) in r["vs_plain"].items())))
        if any(v != want for v in got.values()):
            raise AssertionError(f"{name}: flash bias launches {got}, want "
                                 f"{want} each")
        if not finite:
            raise AssertionError(f"{name}: non-finite output or gradient")
        if name == "msa_row_finetune" and r["peak_bytes"] > (
                (CUDA_CORE_PEAK_GIB + 0.0005) * 2**30 + r["scratch_bytes"]):
            raise AssertionError(f"{name}: peak {r['peak_bytes']} B above "
                                 f"the inputs exceeds {CUDA_CORE_PEAK_GIB} "
                                 f"GiB plus the dbias scratch")
        if routed and r["mask_grad"] not in (None, 0.0):
            raise AssertionError(f"{name}: the routed mask bias got a "
                                 f"gradient")
        bad = {w: e for w, (e, t) in r.get("vs_plain", {}).items()
               if not e <= t}
        if bad:
            raise AssertionError(f"{name}: kernel route differs from the "
                                 f"plain route: {bad}")
        results[name] = r
        del leaves, do, out
        _free(torch)
    return dict(shapes=results, launches=launches)


# --------------------------------------------------------------- stage 19
# (a) google/bigbird-roberta-base's published config.json: 12 heads × 64,
# block_size 64, num_random_blocks 3, max_position_embeddings 4096 (the
# package's BigBird layout: a 3-block window, 2 global blocks first);
# (b) DeepSpeed's documented sparse_attention "fixed" defaults at BERT-large
# widths (16 heads × 64); (c) (b) unidirectional, in fp16
SPARSE_CASES = [
    # (name, config class, config kwargs, B, S, dtype)
    ("bigbird_base", "BigBirdSparsityConfig",
     dict(num_heads=12, block=64, num_random_blocks=3,
          num_sliding_window_blocks=3, num_global_blocks=2), 4, 4096,
     "bfloat16"),
    ("fixed_bert_large", "FixedSparsityConfig",
     dict(num_heads=16, block=16, num_local_blocks=4, num_global_blocks=1,
          different_layout_per_head=True, num_different_global_patterns=4),
     2, 4096, "bfloat16"),
    ("fixed_bert_large_causal", "FixedSparsityConfig",
     dict(num_heads=16, block=16, num_local_blocks=4, num_global_blocks=1,
          different_layout_per_head=True, num_different_global_patterns=4,
          attention="unidirectional"), 2, 4096, "float16"),
]


def _sparse_config(name):
    from deepspeed_tpu_torch.ops import sparse_attention as sa
    _, cls, kw, B, S, dtype = next(c for c in SPARSE_CASES if c[0] == name)
    return getattr(sa, cls)(**kw), B, S, dtype


def _sparse_work(layout, block, causal, B, D, itemsize):
    """(live blocks per head, bytes, flops): q and o, the k/v blocks some
    row uses, each once; two products over the live (row, key) pairs."""
    import numpy as np
    H, nb, _ = layout.shape
    pairs_per_block = block * (block + 1) // 2 if causal else block * block
    diag = np.trace(layout, axis1=1, axis2=2).sum() if causal else 0
    live = int(layout.sum())
    pairs = ((live - diag) * block * block + diag * pairs_per_block)
    used_kv = int(layout.any(axis=1).sum())          # k blocks any row uses
    nbytes = itemsize * D * B * (2 * H * nb * block + 2 * used_kv * block)
    return live / H, nbytes, 2 * 2 * B * D * int(pairs)


def _sparse_case(torch, gen, name):
    """B9 against its plain version at one of SPARSE_CASES; times of the
    kernel, the plain version and SDPA with the dense boolean mask the
    layout expands to; the bound."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops import sparse_attention as sa
    from deepspeed_tpu_torch.ops.kernels import block_sparse_attention as bs
    from deepspeed_tpu_torch.ops.op_builder import \
        BlockSparseAttentionBuilder
    cfg, B, S, dtype = _sparse_config(name)
    dt = getattr(torch, dtype)
    H, D, block = cfg.num_heads, 64, cfg.block
    causal = getattr(cfg, "attention", "") == "unidirectional"
    # immutable (on a bytes buffer), as SparseSelfAttention hands its
    # layouts over: the kernel's tables are then found by identity, not by
    # hashing the layout's contents (1 MB at block 16, about 1 ms of host
    # time a call)
    layout = sa.SparseSelfAttention(cfg).layout(S)
    q, k, v = (torch.randn(B, S, H, D, device="cuda", generator=gen).to(dt)
               for _ in range(3))
    fwd = lambda: bs.block_sparse_attention_fwd(  # noqa: E731
        q, k, v, layout, block, causal=causal)
    o = fwd()
    ref = bs.block_sparse_attention_plain(q, k, v, layout, block,
                                          causal=causal)
    low = "fp16" if dt == torch.float16 else "bf16"
    err, worst = _compare(torch, o, ref, low)
    del ref
    _free(torch)
    row = dict(case=name, shape=[B, S, H, D], block=block, causal=causal,
               dtype=dtype, err=err, worst=worst)
    row["ms"] = cuda_ms(fwd, 10)
    row["plain_ms"] = cuda_ms(lambda: bs.block_sparse_attention_plain(
        q, k, v, layout, block, causal=causal), 3, warmup=1)
    _free(torch)
    # yardstick: SDPA with the layout expanded to a dense [H, S, S] mask
    full = torch.from_numpy(layout.copy()).to("cuda").repeat_interleave(
        block, dim=1).repeat_interleave(block, dim=2)
    if causal:
        full &= torch.ones(S, S, dtype=torch.bool, device="cuda").tril()
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qh, kh, vh, attn_mask=full[None])
    row["library_ms"] = cuda_ms(sdpa, 10)
    row["sdpa_vs_kernel"] = (sdpa().transpose(1, 2).float()
                             - o.float()).abs().max().item()
    del full, qh, kh, vh
    _free(torch)
    live, nbytes, flops = _sparse_work(layout, block, causal, B, D,
                                       q.element_size())
    row["live_blocks_per_head"] = live
    row["density"] = live / (S // block) ** 2
    row["gflop"] = flops / 1e9
    row["bound_ms"], row["bound_by"] = _roofline(nbytes, flops, BF16_FLOPS)
    row["tflops"] = flops / row["ms"] / 1e9
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    tol_text = f"2^-{7 if low == 'bf16' else 10}·|ref| + {BF16_ATOL:g}"
    log(f"[sparse-kernel] {name}: q/k/v [{B},{S},{H},{D}] {dtype} block "
        f"{block} causal={causal}: {live:.1f} live blocks per head of "
        f"{(S // block) ** 2} (density {row['density']:.4f}), "
        f"{row['gflop']:.2f} GFLOP | max_abs_err {err:.3e} (worst "
        f"{worst:.3f} of tol {tol_text}) | kernel {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.3f}, sdpa+bool mask {row['library_ms']:.4f} "
        f"(max |sdpa - kernel| {row['sdpa_vs_kernel']:.3e}), bound "
        f"{row['bound_ms']:.4f} ({row['bound_by']})")
    groups = bs.row_group_tables(layout, H, block)[0]
    row["row_groups"] = len(groups)
    row["split_groups"] = int((groups[:, 3:7] < 0).any(axis=1).sum())
    report, counts = _kernel_report(BlockSparseAttentionBuilder(),
                                    _bsa_mma_key, (low, 64), (" HMMA.",))
    row["kernel"] = report
    log(f"[sparse-kernel] {name}: {row['tflops']:.1f} TFLOP/s of useful "
        f"work, {row['share_of_bound']:.3f} of the bound | "
        f"bsa_fwd_mma_kernel ({low}, D64): {report['registers']} registers, "
        f"{report['spill_stores']} / {report['spill_loads']} B spill stores "
        f"/ loads, SASS {counts[0]} HMMA | {len(groups)} row groups of 64 "
        f"rows ({row['split_groups']} with idle warps)")
    if not worst <= 1.0 or not torch.isfinite(o).all():
        raise AssertionError(f"{name}: block-sparse kernel differs from its "
                             f"plain version beyond tolerance ({worst})")
    if not counts[0]:
        raise AssertionError(f"{name}: no HMMA in the SASS of "
                             f"bsa_fwd_mma_kernel ({low}, D64)")
    del q, k, v, o
    _free(torch)
    return row


def stage_sparse_kernels(seed):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed + 19)
    return [_sparse_case(torch, gen, c[0]) for c in SPARSE_CASES]


# --------------------------------------------------------------- stage 20
def stage_sparse_attention(seed, smi):
    """``SparseSelfAttention`` forward and backward through its [B, H, S, D]
    entry at cases (a) and (c): ms per forward and per forward+backward,
    exactly one B9 launch per forward, peak memory above the inputs, the
    output and gradients against the gather formulation's."""
    import torch
    from deepspeed_tpu_torch.ops import sparse_attention as sa
    from deepspeed_tpu_torch.ops.kernels import block_sparse_attention as bs
    gen = torch.Generator(device="cuda").manual_seed(seed + 20)
    results, launches = {}, 0
    for name in ("bigbird_base", "fixed_bert_large_causal"):
        cfg, B, S, dtype = _sparse_config(name)
        dt = getattr(torch, dtype)
        H, D = cfg.num_heads, 64
        attn = sa.SparseSelfAttention(cfg)
        leaves = [torch.randn(B, H, S, D, device="cuda", generator=gen)
                  .to(dt).requires_grad_(True) for _ in range(3)]
        do = torch.randn(B, H, S, D, device="cuda", generator=gen).to(dt)

        def step():
            for t in leaves:
                t.grad = None
            out = attn(*leaves)
            out.backward(do)
            return out

        for _ in range(2):
            step()
        torch.cuda.synchronize()
        iters = 5
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        bs.block_sparse_attention_fwd.launches = 0
        start.record()
        for _ in range(iters):
            out = step()
        end.record()
        torch.cuda.synchronize()
        ms_fwd_bwd = start.elapsed_time(end) / iters
        with torch.no_grad():
            start.record()
            for _ in range(iters):
                attn(*leaves)
            end.record()
            torch.cuda.synchronize()
        ms_fwd = start.elapsed_time(end) / iters
        got = bs.block_sparse_attention_fwd.launches
        launches += got
        grads = [t.grad.detach().clone() for t in leaves]
        peak = _peak(torch, step)
        # the gather formulation on the same inputs (what the backward runs)
        ref_leaves = [t.detach().clone().requires_grad_(True)
                      for t in leaves]
        ref = sa.sparse_attention(
            *(t.transpose(1, 2) for t in ref_leaves), attn.layout(S),
            cfg.block, causal=getattr(cfg, "attention", "") ==
            "unidirectional").transpose(1, 2)
        ref.backward(do)
        low = "fp16" if dt == torch.float16 else "bf16"
        vs = {"out": _compare(torch, out.detach(), ref.detach(), low)}
        # the same autograd graph; its index backward sums with atomics
        for w, a, b in zip(("dq", "dk", "dv"), grads, ref_leaves):
            vs[w] = _compare(torch, a, b.grad, low)
        finite = bool(torch.isfinite(out).all()) and all(
            bool(torch.isfinite(g).all()) for g in grads)
        r = dict(shape=[B, H, S, D], dtype=dtype, iters=iters,
                 ms_fwd=ms_fwd, ms_fwd_bwd=ms_fwd_bwd, launches=got,
                 peak_bytes=peak, finite=finite, vs_gather=vs)
        log(f"[sparse] {name}: SparseSelfAttention [{B},{H},{S},{D}] {dtype}"
            f": fwd {ms_fwd:.3f} ms, fwd+bwd {ms_fwd_bwd:.3f} ms ({iters} "
            f"timed of each after 2 warm-up), B9 launches {got} for "
            f"{2 * iters} forwards, peak {peak / 2**30:.3f} GiB above the "
            f"inputs, finite {finite}, vs the gather formulation "
            f"(max|err|, worst/tol): "
            + ", ".join(f"{w} {e:.2e}/{t:.3f}" for w, (e, t) in vs.items()))
        if got != 2 * iters:
            raise AssertionError(f"{name}: {got} B9 launches for "
                                 f"{2 * iters} forwards")
        bad = {w: t for w, (_, t) in vs.items() if not t <= 1.0}
        if bad or not finite:
            raise AssertionError(f"{name}: sparse attention differs from the "
                                 f"gather formulation {bad} or is not "
                                 f"finite")
        results[name] = r
        del leaves, do, out, grads, ref_leaves, ref
        _free(torch)
    return dict(cases=results, launches=launches)


# --------------------------------------------------------------- stage 21
FPQ_SHAPES = [("mlp_4096x11008", (4096, 11008)),
              ("embed_32000x4096", (32000, 4096))]
FPQ_FORMATS = {"fp6": (6, 2), "fp12": (12, 7)}


_GQ_KERNEL = re.compile(r"group_kernelI(13__nv_bfloat16|6__half|f)"
                        r"Li(\d)ELb([01])EN\w*?(FpEncILi(\d+)E|Int8Enc)")


def _gq_key(symbol):
    """(dtype, units a lane holds (0: read twice), whole groups, encoder:
    B6's bits or "int8", B5's) of a one-pass group kernel's mangled name
    (``csrc/group_quant.cuh``)."""
    m = _GQ_KERNEL.search(symbol)
    return m and ({"f": "fp32", "6__half": "fp16"}.get(m.group(1), "bf16"),
                  int(m.group(2)), m.group(3) == "1",
                  int(m.group(5)) if m.group(5) else "int8")


_SLOW_CALL_SPAN = 8   # a division's slow-path call: a branch over this many


def _sass_loop_instructions(builder, key_fn):
    """{key: dict(path, span, total, skipped, ops)} of the kernels
    ``key_fn`` names in a built library's SASS (``cuobjdump -sass``).  The
    loop is the span of the backward branch that reaches furthest back
    (the warps' stride over the groups).  ``path`` counts its instructions
    less those a forward branch skips to leave out a CALL (the IEEE
    division's slow path, which nvcc calls out of line and quotients of
    finite, normal operands never take): in a kernel built for whole,
    aligned groups that is the code one trip runs, its inner loops
    (the team's shuffle reduction) counted once, so at least what it
    issues.  ``ops`` counts ``path``'s instructions by opcode."""
    from deepspeed_tpu_torch.ops.op_builder import find_nvcc
    tool = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        raise FileNotFoundError(f"no cuobjdump beside nvcc ({tool})")
    out = subprocess.run([tool, "-sass", builder.lib_path()],
                         capture_output=True, text=True, timeout=300).stdout
    return _loop_paths(out, key_fn)


def _loop_paths(out, key_fn):
    """``_sass_loop_instructions`` of ``cuobjdump -sass`` output."""
    funcs, key = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            key = key_fn(m.group(1))
            if key:
                funcs[key] = dict(ins=[], labels={})
            continue
        if key is None:
            continue
        f = funcs[key]
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            f["labels"][m.group(1)] = len(f["ins"])
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m:
            f["ins"].append(m.group(2))
    result = {}
    for key, f in funcs.items():
        ins, branches = f["ins"], []
        lo, hi = 0, len(ins) - 1          # no loop: the whole function
        loop = -1
        for i, text in enumerate(ins):
            m = re.search(r"BRA\s+`?\(?(\.L_x_\d+|0x[0-9a-f]+)", text)
            if not m:
                continue
            t = m.group(1)
            target = (f["labels"].get(t) if t.startswith(".L")
                      else int(t, 16) // 16)
            if target is None:
                continue
            branches.append((i, target))
            if target <= i and i - target > loop:
                lo, hi, loop = target, i, i - target
        skip = set()
        for i, target in branches:
            body = range(i + 1, target)
            if (lo <= i and target <= hi + 1
                    and 0 < len(body) <= _SLOW_CALL_SPAN
                    and any("CALL" in ins[j] for j in body)
                    and not any("BRA" in ins[j] for j in body)):
                skip.update(body)
        path = [ins[j] for j in range(lo, hi + 1) if j not in skip]
        ops = {}
        for text in path:
            op = re.sub(r"^@!?U?P\w+\s+", "", text).split()[0].split(".")[0]
            ops[op] = ops.get(op, 0) + 1
        result[key] = dict(path=len(path), span=hi - lo + 1, total=len(ins),
                           skipped=len(skip), ops=ops)
    return result


def _fpq_case(torch, gen, shape_name, shape, fmt, dtype, sass):
    """B6 against its plain version, packed bytes and scales bit for bit,
    with times, the packed-byte bound and the issue time of the SASS
    instructions the kernel runs for a whole group (at least what it
    issues: a second bound)."""
    from deepspeed_tpu_torch.ops import fp_quantizer as fq
    from deepspeed_tpu_torch.ops.fp_quantizer import fp_groups
    from deepspeed_tpu_torch.ops.kernels import fp_quantizer as kfq
    q_bits, man = FPQ_FORMATS[fmt]
    x = (torch.randn(*shape, device="cuda", generator=gen) * 0.02).to(
        getattr(torch, dtype))
    run = lambda: kfq.quantize_fp_packed(x, q_bits, man, 512)  # noqa: E731
    before = kfq.quantize_fp_packed.launches
    packed, scales = run()
    launched = kfq.quantize_fp_packed.launches - before
    ref, ref_scales = kfq.quantize_fp_packed_plain(x, q_bits, man, 512)
    equal = (launched == 1 and torch.equal(packed, ref)
             and torch.equal(scales, ref_scales))
    err = (packed.int() - ref.int()).abs().max().item()
    del ref, ref_scales
    _free(torch)
    row = dict(case=f"{shape_name}_{fmt}_{dtype}", shape=list(shape),
               fmt=fmt, dtype=dtype, bit_equal=equal, err=err)
    row["ms"] = cuda_ms(run, 10)
    row["plain_ms"] = cuda_ms(lambda: kfq.quantize_fp_packed_plain(
        x, q_bits, man, 512), 3, warmup=1)
    row["ms_quantize_fp"] = cuda_ms(
        lambda: fq.quantize_fp(x, q_bits, man, 512), 10)
    _free(torch)
    n = x.numel()
    nbytes = (n * x.element_size() + packed.numel()
              + 4 * scales.numel())
    row["bound_ms"], row["bound_by"] = _roofline(nbytes, 0, BF16_FLOPS)
    # the issue time of the instructions a whole group runs: groups of 512
    # are one 16-element unit a lane in teams of 32, in the kernel built
    # for whole, aligned groups (the case asserts both facts); 4 warp
    # instructions a clock an SM at the card's highest SM clock
    gs, _, padded = fp_groups(n, 512)
    if padded * gs != n or x.data_ptr() % 16:
        raise AssertionError(f"{row['case']}: groups not whole or input "
                             f"not aligned: not the kernel counted")
    key = ({"float32": "fp32", "bfloat16": "bf16"}[dtype], 1, True, q_bits)
    got = sass.get(key)
    if not got:
        raise AssertionError(f"{row['case']}: no SASS for the B6 kernel "
                             f"{key}")
    clock = _max_sm_clock_hz()
    top = sorted(got["ops"].items(), key=lambda kv: -kv[1])[:8]
    row.update(sass_path_instructions=got["path"],
               sass_loop_span=got["span"], sass_instructions=got["total"],
               per_code=got["path"] / 16, sm_clock_hz=clock,
               issue_ms=n / 512 * got["path"] / (4 * H100_SMS * clock)
               * 1e3)
    log(f"[fp-quant-kernel] {row['case']}: {n:,} elements, "
        f"{scales.numel():,} groups of 512: packed bytes and scales "
        f"{'bit-equal' if equal else 'DIFFER'} (max |Δbyte| {err}, "
        f"{launched} launch) | kernel {row['ms']:.4f} ms, quantize_fp "
        f"{row['ms_quantize_fp']:.4f} ms, plain {row['plain_ms']:.3f}, "
        f"bound {row['bound_ms']:.4f} ({row['bound_by']}: input, "
        f"{packed.numel():,} packed bytes, scales; "
        f"{row['bound_ms'] / row['ms']:.2f} of it); SASS: "
        f"{got['path']} instructions a trip on the path a whole group runs "
        f"(loop span {got['span']}, {got['skipped']} of it slow-path "
        f"calls; {got['total']} in the kernel) = {got['path'] / 16:.1f} a "
        f"code: {row['issue_ms']:.4f} ms of issue at 4 a clock on "
        f"{H100_SMS} SMs at {clock / 1e6:.0f} MHz "
        f"({row['issue_ms'] / row['ms']:.2f} of the kernel's time); "
        f"opcodes {dict(top)}")
    if not equal:
        raise AssertionError(f"{row['case']}: FP quantize kernel differs "
                             f"from its plain version")
    if row["issue_ms"] > row["ms"]:
        raise AssertionError(f"{row['case']}: issue time {row['issue_ms']}"
                             f" ms above the kernel's {row['ms']} ms: the "
                             f"count is not of the path the kernel runs")
    del x, packed, scales
    _free(torch)
    return row


def _fpq_crafted_case(torch):
    """B6 bit for bit over every bf16 and fp16 value at random scales and
    over exact ties of the int8 grid, FP6 and FP12, groups of 128/512."""
    from deepspeed_tpu_torch.ops.kernels import fp_quantizer as kfq
    checked = 0
    for dtype in (torch.bfloat16, torch.float16):
        x = _crafted_quant_input(torch, dtype, rounds=16)
        for q_bits, man in FPQ_FORMATS.values():
            for gs in (128, 512):
                got = kfq.quantize_fp_packed(x, q_bits, man, gs)
                ref = kfq.quantize_fp_packed_plain(x, q_bits, man, gs)
                if not (torch.equal(got[0], ref[0])
                        and torch.equal(got[1], ref[1])):
                    raise AssertionError(f"FP quantize {dtype} {q_bits} "
                                         f"bits g{gs}: differs from its "
                                         f"plain version on crafted values")
                checked += x.numel()
    log(f"[fp-quant-kernel] crafted: every finite bf16 and fp16 value 16 "
        f"times at random scales and exact ties, FP6/FP12, groups of "
        f"128/512: {checked:,} values, packed bytes and scales bit-equal")
    return checked


def stage_fp_quant_kernels(seed):
    """Stage 21's kernel cases alone (``kernel_ab.py`` times them)."""
    import torch
    from deepspeed_tpu_torch.ops.op_builder import FPQuantizerBuilder
    gen = torch.Generator(device="cuda").manual_seed(seed + 21)
    sass = _sass_loop_instructions(FPQuantizerBuilder(), _gq_key)
    rows = [_fpq_case(torch, gen, sn, shape, fmt, dtype, sass)
            for sn, shape in FPQ_SHAPES for fmt in FPQ_FORMATS
            for dtype in ("bfloat16", "float32")]
    _fpq_crafted_case(torch)
    return rows


def _llama_jax_tree(torch, gen, L=32, D=4096, H=32, Dh=128, I=11008,
                    V=32000):
    """Llama-2-7B's parameter tree in the JAX package's flax layout, bf16,
    random from ``gen`` (norms 1): 2 + 7 × L leaves of two or more dims."""
    def w(*shape):
        return (torch.randn(*shape, device="cuda", generator=gen)
                * 0.02).to(torch.bfloat16)

    ones = lambda: torch.ones(D, device="cuda", dtype=torch.bfloat16)  # noqa
    tree = {"embed_tokens": {"embedding": w(V, D)},
            "norm": {"weight": ones()}, "lm_head": {"kernel": w(D, V)}}
    for i in range(L):
        tree[f"layers_{i}"] = {
            "self_attn": {"q_proj": {"kernel": w(D, H, Dh)},
                          "k_proj": {"kernel": w(D, H, Dh)},
                          "v_proj": {"kernel": w(D, H, Dh)},
                          "o_proj": {"kernel": w(H * Dh, D)}},
            "mlp": {"gate_proj": {"kernel": w(D, I)},
                    "up_proj": {"kernel": w(D, I)},
                    "down_proj": {"kernel": w(I, D)}},
            "input_layernorm": {"weight": ones()},
            "post_attention_layernorm": {"weight": ones()}}
    return tree


def _tree_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tree_leaves(v)
    else:
        yield tree


def stage_fp_quant(seed, smi):
    """B6 against its plain version at Llama-2-7B's largest leaves, then
    ``quantize_param_tree`` over the whole bf16 tree in FP6, FP12 and fp8:
    launches (one per leaf of two or more dims, none for fp8), wall time,
    resident bytes, and the worst relative error of ``dequantized()``."""
    import torch
    from deepspeed_tpu_torch.linear import (QuantizationConfig,
                                            QuantizedParameter,
                                            quantize_param_tree)
    from deepspeed_tpu_torch.ops import fp_quantizer as fq
    from deepspeed_tpu_torch.ops.fp_quantizer import _fmt
    from deepspeed_tpu_torch.ops.kernels import fp_quantizer as kfq
    rows = stage_fp_quant_kernels(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 121)
    tree = _llama_jax_tree(torch, gen)
    leaves = list(_tree_leaves(tree))
    n_values = sum(t.numel() for t in leaves)
    want = sum(t.dim() >= 2 for t in leaves)
    trees = {}
    packs = []
    pack_codes = fq.pack_codes

    def counted_pack(*a, **k):      # the card path packs in the kernel
        packs.append(1)
        return pack_codes(*a, **k)

    for fmt, q_bits in (("fp6", 6), ("fp12", 12), ("fp8", 8)):
        torch.cuda.synchronize()
        kfq.quantize_fp_packed.launches = 0
        packs.clear()
        fq.pack_codes = kfq.pack_codes = counted_pack
        run = lambda: quantize_param_tree(  # noqa: E731
            tree, QuantizationConfig(q_dtype="fp", q_bits=q_bits))
        try:
            t0 = time.perf_counter()
            qt = run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = kfq.quantize_fp_packed.launches
            # again under the profiler, for the device time of its kernels
            _, _, dev_ms, _ = device_time(torch, run)
        finally:
            fq.pack_codes = kfq.pack_codes = pack_codes
        qleaves = list(_tree_leaves(qt))
        resident = sum(
            t.numel() * t.element_size() for leaf in qleaves
            for t in ((leaf.q, leaf.scales)
                      if isinstance(leaf, QuantizedParameter) else (leaf, )))
        worst = 0.0
        for x, qp in zip(leaves, qleaves):
            if isinstance(qp, QuantizedParameter):
                d = qp.dequantized()
                worst = max(worst, ((d.float() - x.float()).abs().max()
                                    / x.float().abs().max()).item())
                del d
        man = {6: 2, 12: 7, 8: 3}[q_bits]
        _, _, max_unb, maxv = _fmt(q_bits, man)
        top = 448.0 if q_bits == 8 else maxv     # e4m3fn stops at 448
        # half the top binade's step over the grid max, plus the bf16
        # rounding of the dequantized value
        bound = 2.0 ** (max_unb - man - 1) / top + 2.0 ** -9
        r = dict(launches=got, want=want if q_bits != 8 else 0, wall_s=wall,
                 device_ms=dev_ms, pack_codes_calls=len(packs),
                 resident_bytes=resident,
                 bytes_per_value=resident / n_values, worst_rel_err=worst,
                 err_bound=bound)
        log(f"[fp-quant] quantize_param_tree over Llama-2-7B's {len(leaves)}"
            f"-leaf bf16 tree ({n_values:,} values) in {fmt}: {got} kernel "
            f"launches for {want} leaves of 2+ dims, {wall:.3f} s wall, "
            + (f"{dev_ms:.2f} ms of device kernels" if dev_ms is not None
               else "device time not measured") + f", resident "
            f"{resident / 2**30:.3f} GiB ({r['bytes_per_value']:.4f} B a "
            f"value; bf16 2), worst max|dequantized - x| / max|x| over the "
            f"leaves {worst:.4e} (bound {bound:.4e}); pack_codes called "
            f"{len(packs)} times")
        if packs:
            raise AssertionError(f"{fmt}: pack_codes ran on the card path "
                                 f"{len(packs)} times")
        if got != r["want"]:
            raise AssertionError(f"{fmt}: {got} FP quantize launches, want "
                                 f"{r['want']}")
        if not worst <= bound:
            raise AssertionError(f"{fmt}: dequantized error {worst} above "
                                 f"{bound}")
        trees[fmt] = r
        del qt, qleaves
        _free(torch)
    del tree, leaves
    _free(torch)
    return dict(kernels=rows, trees=trees)


# ------------------------------------------------------------------ main
# ----------------------------------------------------------- stages 22-24
FP32_FLOPS = 67e12               # H100 SXM dense fp32 (no tensor cores)


def _all_launches():
    """Every kernel wrapper's launch counter, by wrapper name."""
    from deepspeed_tpu_torch.ops.kernels import (block_sparse_attention,
                                                 flash_attention, flash_bias,
                                                 fp_quantizer,
                                                 grouped_matmul, optimizers,
                                                 paged_attention, quantizer)
    fns = [flash_attention.flash_attention_fwd,
           flash_attention.flash_attention_bwd_dq,
           flash_attention.flash_attention_bwd_dkv,
           optimizers.fused_adam_step, optimizers.fused_lamb_phase1,
           optimizers.fused_lamb_phase2, optimizers.fused_lion_step,
           paged_attention.paged_attention,
           paged_attention.paged_attention_atoms, grouped_matmul.gmm,
           grouped_matmul.gmm_dx, grouped_matmul.gmm_dw,
           quantizer.quantize_blockwise, quantizer.dequantize_blockwise,
           flash_bias.flash_bias_fwd, flash_bias.flash_bias_bwd_dq,
           flash_bias.flash_bias_bwd_dkv, flash_bias.flash_bias_bwd_dbias,
           block_sparse_attention.block_sparse_attention_fwd,
           fp_quantizer.quantize_fp_packed]
    return {fn.__name__: fn for fn in fns}


def _timed_steps(torch, engine, batches, warmup, timed):
    """Warm-up and timed optimizer steps (each of ``gas`` micro-steps),
    micro-step j on ``batches[j % len(batches)]``, with every launch
    counter set to 0 just before: (losses of every micro-step, host seconds
    of each timed step, launches, peak bytes over the timed steps)."""
    counters = _all_launches()
    gas = engine.gradient_accumulation_steps()
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    losses, times = [], []
    for i in range(warmup + timed):
        if i == warmup:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        for _ in range(gas):
            loss = engine(*batches[len(losses) % len(batches)])
            engine.backward(loss)
            engine.step()
            losses.append(loss)
        torch.cuda.synchronize()
        if i >= warmup:
            times.append(time.perf_counter() - t)
    launches = {k: fn.launches for k, fn in counters.items() if fn.launches}
    return ([x.item() for x in losses], times, launches,
            torch.cuda.max_memory_allocated())


def _train_kind(name):
    """A training window's kernel kinds (stages 22-24)."""
    if "flash_fwd" in name:
        return "flash_fwd"
    if "flash_bwd" in name:
        return "flash_bwd"
    if "adam_kernel" in name:
        return "adam"
    if "nccl" in name.lower():
        return "nccl"
    return "matmul" if _is_matmul(name) else "other"


def _profile_steps(torch, engine, batches, stem, profile_dir, smi):
    """Two optimizer steps under ``torch.profiler``."""
    def body():
        for j in range(2 * engine.gradient_accumulation_steps()):
            engine.backward(engine(*batches[j % len(batches)]))
            engine.step()
    return _profile_window(stem, body, _train_kind, profile_dir, smi)


def _rates(cfg_n, L, S, D, tokens_per_step, times, peak_flops):
    step_s = sum(times) / len(times)
    flops_tok = 6 * cfg_n + 12 * L * S * D
    tok_s = tokens_per_step / step_s
    return step_s, tok_s, tok_s * flops_tok / 1e12, \
        tok_s * flops_tok / peak_flops, flops_tok


BERT_CONFIG = {"train_micro_batch_size_per_gpu": 64,
               "gradient_accumulation_steps": 1,
               "optimizer": {"type": "fusedadam", "params": {"lr": 1e-4}},
               "zero_optimization": {"stage": 0}}


def stage_bert_train(seed, smi, profile_dir=None):
    """BASELINE config 1: BERT-base, ZeRO 0, fp32, fusedadam."""
    import numpy as np
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.bert import (BertModel, bert_base,
                                                 param_count)
    B, S, warmup, timed = 64, 128, 2, 8
    cfg = bert_base()
    t0 = time.perf_counter()
    engine = deepspeed_tpu_torch.initialize(
        model=BertModel(cfg, device="meta"), config=dict(BERT_CONFIG))[0]
    engine.initialize_parameters(seed)
    rng = np.random.default_rng(seed + 22)
    ids = rng.integers(0, cfg.vocab_size, size=(B, S))
    labels = np.where(rng.random((B, S)) < 0.15, ids, -100)
    batch = (torch.from_numpy(ids).cuda(), torch.from_numpy(labels).cuda())
    N = param_count(cfg)
    log(f"[bert] BERT-base ({cfg.num_hidden_layers} × {cfg.hidden_size}, "
        f"{cfg.num_attention_heads} heads, FFN {cfg.intermediate_size}, "
        f"vocab {cfg.vocab_size}, {N:,} params), fp32, ZeRO 0: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB of state, built "
        f"in {time.perf_counter() - t0:.1f} s; B={B}, S={S}, "
        f"{int((labels >= 0).sum())} of {B * S} tokens labelled")
    # the first step's update, kernel against plain, from the same state
    loss = engine(*batch)
    engine.backward(loss)
    st = engine.opt_state
    snap = [t.clone() for t in (engine.params, st.exp_avg, st.exp_avg_sq)]
    count = st.count
    engine.step(use_kernel=True)
    kern = engine.params.clone()
    for t, v in zip((engine.params, st.exp_avg, st.exp_avg_sq), snap):
        t.copy_(v)
    st.count = count
    engine.micro_steps -= 1
    engine.global_steps -= 1
    engine.global_samples -= engine.train_batch_size()
    engine._acc_fresh = False
    engine.step(use_kernel=False)
    plain = engine.params
    err = (kern - plain).abs().max().item()
    ok = bool(((kern - plain).abs() <= ADAM_RTOL * plain.abs()).all())
    log(f"[bert] first step: loss {loss.item():.6f}; master after the B2 "
        f"step against the plain step: max |Δ| {err:.3e} (tol 2^-23·|ref|, "
        f"{'held' if ok else 'FAILED'})")
    if not ok:
        raise AssertionError("BERT step: B2 differs from its plain version")
    del snap, kern
    losses, times, launches, peak = _timed_steps(torch, engine, [batch],
                                                 warmup, timed)
    step_s, tok_s, tflops, mfu, flops_tok = _rates(
        N, cfg.num_hidden_layers, S, cfg.hidden_size, B * S, times,
        FP32_FLOPS)
    log(f"[bert] losses (2 warm-up, then {timed} timed): "
        + ", ".join(f"{x:.4f}" for x in losses))
    log(f"[bert] step ms " + ", ".join(f"{t * 1e3:.1f}" for t in times)
        + f" | mean {step_s * 1e3:.2f} ms, {B / step_s:.1f} samples/s, "
        f"{tflops:.2f} TFLOP/s ({flops_tok / 1e9:.4f} GFLOP/token = 6N + "
        f"12·L·S·D), MFU {mfu:.4f} of 67 TFLOP/s fp32 | peak memory "
        f"{peak / 2**30:.2f} GiB | {smi}")
    log(f"[bert] kernel launches in the {warmup + timed} steps: {launches}")
    want = {"fused_adam_step": warmup + timed}
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, want {want}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite and falling: {losses}")
    result = dict(losses=losses, step_ms=[t * 1e3 for t in times],
                  step_ms_mean=step_s * 1e3, samples_per_s=B / step_s,
                  tflops=tflops, mfu=mfu, peak_bytes=peak,
                  launches=launches, flops_per_token=flops_tok,
                  first_step_err=err)
    if profile_dir:
        result["profile"] = _profile_steps(torch, engine, [batch],
                                           "bert_profile", profile_dir, smi)
    del engine, plain
    _free(torch)
    return result


def _digest(torch, engine, flat):
    """A digest of ``flat`` (a fp32 buffer of ``engine``'s layout), leaf by
    leaf in name order, so that two layouts of the same values agree: the
    sum, wrapping in int64, of each element's bits times a weight that
    follows its place in the leaf (a moved or changed element changes
    it)."""
    acc = 0
    for _, off, n, _ in sorted(engine._layout):
        v = flat[off:off + n].view(torch.int32)
        for i in range(0, n, 1 << 26):
            c = v[i:i + (1 << 26)].to(torch.int64)
            w = torch.arange(i, i + c.numel(), device=c.device,
                             dtype=torch.int64) % 65521 + 1
            acc = (acc + int((c * w).sum().item())) % (1 << 64)
    return acc


def _zero_pair(torch, make, batches, stages, warmup, timed, label, smi,
               profile_dir=None, ref=None):
    """The same config, seed and data (micro-step j on ``batches[j %
    len(batches)]``) at each ZeRO stage in ``stages`` (the first is
    measured): losses, times, launches, peak, comm calls, the fp32 master
    after the timed steps, on the host (and, with ``profile_dir``, two
    profiled steps of each).  ``ref``: an earlier run of the second stage
    (its result, with its master under ``"master"``), which is then not run
    again.  Returns them, the largest loss difference and whether the two
    masters are equal bit for bit."""
    from deepspeed_tpu_torch import comm
    out, masters = {}, {}
    if ref is not None:
        out[stages[1]] = ref
        masters[stages[1]] = ref["master"]
    for stage in stages:
        if stage in out:
            continue
        engine = make(stage)
        comm.comms_logger.reset()
        losses, times, launches, peak = _timed_steps(torch, engine, batches,
                                                     warmup, timed)
        calls = comm.comms_logger.counts()
        master = engine.fp32_params()[:engine.zero_plan.numel]
        digest = _digest(torch, engine, master)
        masters[stage] = master.cpu()
        del master
        out[stage] = dict(losses=losses, times=times, launches=launches,
                          digest=digest,
                          peak=peak, calls=calls,
                          skipped=engine.skipped_steps,
                          plan=engine.zero_plan.describe(
                              param_bytes=engine.params.element_size(),
                              grad_bytes=engine.grad_acc.element_size(),
                              master=engine.master is not None),
                          per_step=engine.zero_plan.collectives_per_step(
                              engine.gradient_accumulation_steps()),
                          names={n: (o, k) for n, o, k, _ in engine._layout})
        if engine._coord is not None:
            out[stage]["peak_live_elems"] = engine._coord.peak_live_elems
        if profile_dir:
            out[stage]["profile"] = _profile_steps(
                torch, engine, batches, f"{label}_zero{stage}_profile",
                profile_dir, smi)
        del engine
        _free(torch)
    a, b = out[stages[0]], out[stages[1]]
    diff = max(abs(x - y) for x, y in zip(a["losses"], b["losses"]))
    # leaf by leaf: stage 3 lays the leaves out block by block
    ma, mb = masters[stages[0]], masters[stages[1]]
    same = a["names"].keys() == b["names"].keys() and all(
        torch.equal(ma[o:o + k], mb[b["names"][n][0]:b["names"][n][0] + k])
        for n, (o, k) in a["names"].items())
    log(f"[{label}] ZeRO {stages[0]} against ZeRO {stages[1]}, same config,"
        f" seed and data ({len(batches)} batches in turn): largest loss "
        f"difference {diff:.3e} over {len(a['losses'])} micro-steps; fp32 "
        f"masters after the last step "
        f"{'bit-equal' if same else 'DIFFER'} | {smi}")
    b["master"] = masters[stages[1]]
    return out, diff, same


def stage_gpt2_zero1(seed, smi, profile_dir=None):
    """BASELINE config 2: GPT-2 350M, ZeRO 1, fp16, fusedadam, on NCCL."""
    import numpy as np
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models.gpt2 import gpt2_350m, param_count
    B, S, warmup, timed = 8, 1024, 2, 8
    cfg = gpt2_350m()
    cdb = deepspeed_tpu_torch.init_distributed(dist_backend="nccl")
    if cdb.name != "nccl" or comm.get_world_size() != 1:
        raise AssertionError(f"comm world {cdb.name}, "
                             f"{comm.get_world_size()} ranks")
    config = dict(GPT2_CONFIG, optimizer={"type": "fusedadam",
                                          "params": {"lr": 1e-4}},
                  comms_logger={"enabled": True})
    rng = np.random.default_rng(seed + 23)
    batches = [(ids, ids) for ids in (torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(B, S))).cuda() for _ in range(2))]

    def make(stage):
        return _gpt2_engine(torch, seed, dict(
            config, zero_optimization={"stage": stage}))[0]

    runs, diff, same = _zero_pair(torch, make, batches, (1, 0), warmup,
                                  timed, "gpt2-zero1", smi, profile_dir)
    z = runs[1]
    N, L, D = param_count(cfg), cfg.num_hidden_layers, cfg.hidden_size
    step_s, tok_s, tflops, mfu, flops_tok = _rates(N, L, S, D, B * S,
                                                   z["times"], BF16_FLOPS)
    steps = warmup + timed
    per_step = {k: v / steps for k, v in z["calls"].items()}
    log(f"[gpt2-zero1] GPT-2 350M, fp16, ZeRO 1 on NCCL (world "
        f"{comm.get_world_size()}), fusedadam: losses "
        + ", ".join(f"{x:.4f}" for x in z["losses"]))
    log(f"[gpt2-zero1] step ms " + ", ".join(f"{t * 1e3:.1f}"
                                            for t in z["times"])
        + f" | mean {step_s * 1e3:.1f} ms, {tok_s:.1f} tokens/s, MFU "
        f"{mfu:.4f} (989 TFLOP/s fp16) | peak memory "
        f"{z['peak'] / 2**30:.2f} GiB (ZeRO 0: "
        f"{runs[0]['peak'] / 2**30:.2f}) | {z['skipped']} of {steps} steps "
        f"skipped | collectives a step {per_step} | {smi}")
    log(f"[gpt2-zero1] launches in {steps} steps: {z['launches']}; plan "
        f"{z['plan']['shard_numel']:,} elements a shard, sharded "
        f"{z['plan']['sharded_bytes'] / 2**30:.2f} GiB, replicated "
        f"{z['plan']['replicated_bytes'] / 2**30:.2f} GiB")
    stepped = steps - z["skipped"]
    want = dict(flash_attention_fwd=2 * L * steps,   # remat: twice a layer
                flash_attention_bwd_dq=L * steps,
                flash_attention_bwd_dkv=L * steps, fused_adam_step=stepped)
    if z["launches"] != want:
        raise AssertionError(f"kernel launches {z['launches']}, want {want}")
    if z["calls"].get("reduce_scatter_fn") != steps or \
            z["calls"].get("allgather_fn") != stepped:
        raise AssertionError(f"collectives {z['calls']} for {steps} steps")
    # one rank: the reduce-scatter and the in-place gather are copies, so
    # ZeRO 1 is ZeRO 0 bit for bit (runtime/engine.py)
    if not all(np.isfinite(z["losses"])) or diff != 0 or not same:
        raise AssertionError(f"ZeRO 1 apart from ZeRO 0: losses by {diff}, "
                             f"masters bit-equal {same}")
    return dict(losses=z["losses"], losses_zero0=runs[0]["losses"],
                max_loss_diff=diff, masters_equal=same,
                step_ms=[t * 1e3 for t in z["times"]],
                step_ms_mean=step_s * 1e3, tokens_per_s=tok_s, mfu=mfu,
                peak_bytes=z["peak"], peak_bytes_zero0=runs[0]["peak"],
                skipped=z["skipped"], calls_per_step=per_step,
                launches=z["launches"], plan=z["plan"],
                step_ms_zero0=sum(runs[0]["times"]) / timed * 1e3,
                profile={s: r.get("profile") for s, r in runs.items()})


def stage_llama_zero2(seed, smi, zero0_peak, profile_dir=None):
    """BASELINE config 3 at stage 8's cut: Llama-2-7B width, 8 layers,
    ZeRO 2, bf16, gradient accumulation 2."""
    import numpy as np
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models.llama import (LlamaModel, llama_7b,
                                                  param_count)
    B, S, L, gas, warmup, timed = 4, 2048, 8, 2, 1, 3
    cfg = llama_7b(num_hidden_layers=L, remat=False, head_dtype="bfloat16")
    config = dict(TRAIN_CONFIG, gradient_accumulation_steps=gas,
                  comms_logger={"enabled": True})
    rng = np.random.default_rng(seed + 24)
    # a different batch for each micro-step of a step
    batches = [(ids, ids) for ids in (torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(B, S))).cuda() for _ in range(gas))]

    def make(stage):
        engine = deepspeed_tpu_torch.initialize(
            model=LlamaModel(cfg, device="meta"),
            config=dict(config, zero_optimization={"stage": stage}))[0]
        engine.initialize_parameters(seed)
        return engine

    runs, diff, same = _zero_pair(torch, make, batches, (2, 0), warmup,
                                  timed, "llama-zero2", smi, profile_dir)
    z = runs[2]
    steps = warmup + timed
    step_s, tok_s, tflops, mfu, flops_tok = _rates(
        param_count(cfg), L, S, cfg.hidden_size, gas * B * S, z["times"],
        BF16_FLOPS)
    log(f"[llama-zero2] Llama-2-7B width, {L} layers, bf16, ZeRO 2 on NCCL "
        f"(world {comm.get_world_size()}), gradient accumulation {gas}: "
        f"losses " + ", ".join(f"{x:.4f}" for x in z["losses"]))
    log(f"[llama-zero2] step ms (2 micro-steps) " + ", ".join(
        f"{t * 1e3:.1f}" for t in z["times"])
        + f" | mean {step_s * 1e3:.1f} ms, {tok_s:.1f} tokens/s, MFU "
        f"{mfu:.4f} | peak memory {z['peak'] / 2**30:.2f} GiB (ZeRO 0 with "
        f"the same accumulation {runs[0]['peak'] / 2**30:.2f}, stage 8's "
        f"ZeRO 0 without it {zero0_peak / 2**30:.2f}) | collectives "
        f"{z['calls']} in {steps} steps | {smi}")
    log(f"[llama-zero2] launches in {steps} steps: {z['launches']}")
    want = {"flash_attention_fwd": L * gas * steps,
            "flash_attention_bwd_dq": L * gas * steps,
            "flash_attention_bwd_dkv": L * gas * steps,
            "fused_adam_step": steps}
    if z["launches"] != want:
        raise AssertionError(f"kernel launches {z['launches']}, want {want}")
    if z["calls"].get("reduce_scatter_fn") != gas * steps or \
            z["calls"].get("allgather_fn") != steps:
        raise AssertionError(f"collectives {z['calls']} for {steps} steps")
    # one rank: each micro-step's reduce-scatter is a copy added in fp32
    # as ZeRO 0 adds it, so ZeRO 2 is ZeRO 0 bit for bit
    if not all(np.isfinite(z["losses"])) or diff != 0 or not same:
        raise AssertionError(f"ZeRO 2 apart from ZeRO 0: losses by {diff}, "
                             f"masters bit-equal {same}")
    return dict(losses=z["losses"], losses_zero0=runs[0]["losses"],
                max_loss_diff=diff, masters_equal=same,
                step_ms=[t * 1e3 for t in z["times"]],
                step_ms_mean=step_s * 1e3, tokens_per_s=tok_s, mfu=mfu,
                peak_bytes=z["peak"], peak_bytes_zero0=runs[0]["peak"],
                calls=z["calls"], launches=z["launches"], plan=z["plan"],
                step_ms_zero0=sum(runs[0]["times"]) / timed * 1e3,
                profile={s: r.get("profile") for s, r in runs.items()},
                zero0=runs[0])


ZERO3 = {"stage": 3, "overlap_comm": True,
         # an explicit size arms the prefetch: 2e8 bf16 elements a bucket,
         # so one 7B-width block (202,375,168 elements less its norms)
         "stage3_prefetch_bucket_size": int(2e8)}


def stage_llama_zero3(seed, smi, zero0, profile_dir=None):
    """Stage 24's model and data at ZeRO 3 with ``overlap_comm`` and the
    prefetch armed, against stage 24's ZeRO-0 run (``zero0``); then
    ``fusedlamb`` at ZeRO 3 and ZeRO 0."""
    import numpy as np
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models.llama import (LlamaModel, llama_7b,
                                                  param_count)
    B, S, L, gas, warmup, timed = 4, 2048, 8, 2, 1, 3
    cfg = llama_7b(num_hidden_layers=L, remat=False, head_dtype="bfloat16")
    config = dict(TRAIN_CONFIG, gradient_accumulation_steps=gas,
                  comms_logger={"enabled": True})
    rng = np.random.default_rng(seed + 24)      # stage 24's batches
    batches = [(ids, ids) for ids in (torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(B, S))).cuda() for _ in range(gas))]

    def make(stage, optimizer=None):
        c = dict(config, zero_optimization=ZERO3 if stage == 3 else
                 {"stage": stage})
        if optimizer:
            c["optimizer"] = optimizer
        engine = deepspeed_tpu_torch.initialize(
            model=LlamaModel(cfg, device="meta"), config=c)[0]
        engine.initialize_parameters(seed)
        return engine

    runs, diff, same = _zero_pair(torch, make, batches, (3, 0), warmup,
                                  timed, "llama-zero3", smi, profile_dir,
                                  ref=zero0)
    z, z0 = runs[3], runs[0]
    steps = warmup + timed
    step_s, tok_s, tflops, mfu, flops_tok = _rates(
        param_count(cfg), L, S, cfg.hidden_size, gas * B * S, z["times"],
        BF16_FLOPS)
    step_s0 = sum(z0["times"]) / len(z0["times"])
    plan = z["plan"]
    log(f"[llama-zero3] Llama-2-7B width, {L} layers, bf16, ZeRO 3 on NCCL "
        f"(world {comm.get_world_size()}), overlap_comm, prefetch "
        f"{plan['prefetch_bucket_mb']:.1f} MB buckets, gradient "
        f"accumulation {gas}: losses "
        + ", ".join(f"{x:.4f}" for x in z["losses"]))
    log(f"[llama-zero3] units {plan['unit_kinds']}, persistent "
        f"{plan['persistent_numel']:,} elements, sharded "
        f"{plan['sharded_bytes'] / 2**30:.2f} GiB, replicated "
        f"{plan['replicated_bytes'] / 2**30:.4f} GiB; peak gathered "
        f"{z['peak_live_elems']:,} elements")
    log(f"[llama-zero3] step ms (2 micro-steps) " + ", ".join(
        f"{t * 1e3:.1f}" for t in z["times"])
        + f" | mean {step_s * 1e3:.1f} ms ({step_s / step_s0 - 1:+.2%} of "
        f"ZeRO 0's {step_s0 * 1e3:.1f}), {tok_s:.1f} tokens/s (ZeRO 0 "
        f"{gas * B * S / step_s0:.1f}), MFU {mfu:.4f} (ZeRO 0 "
        f"{mfu * step_s / step_s0:.4f}) | peak memory "
        f"{z['peak'] / 2**30:.2f} GiB (ZeRO 0 {z0['peak'] / 2**30:.2f}) | "
        f"collectives {z['calls']} in {steps} steps | {smi}")
    log(f"[llama-zero3] launches in {steps} steps: {z['launches']}")
    want = {"flash_attention_fwd": L * gas * steps,
            "flash_attention_bwd_dq": L * gas * steps,
            "flash_attention_bwd_dkv": L * gas * steps,
            "fused_adam_step": steps}
    if z["launches"] != want:
        raise AssertionError(f"kernel launches {z['launches']}, want {want}")
    # per micro-step: the outer unit and each block gathered in forward,
    # each block again in backward, every unit reduce-scattered; the
    # persistent unit gathered after each step
    per_step = z["per_step"]
    if per_step != {"allgather_fn": gas * (1 + 2 * L) + 1,
                    "reduce_scatter_fn": gas * (L + 2)} or \
            {k: z["calls"].get(k) for k in per_step} != \
            {k: n * steps for k, n in per_step.items()}:
        raise AssertionError(f"collectives {z['calls']} for {steps} steps, "
                             f"the plan's {per_step} a step")
    # one rank: gathers and reduce-scatters are copies, the gradients the
    # same ops on the same values
    if not all(np.isfinite(z["losses"])) or diff != 0 or not same:
        raise AssertionError(f"ZeRO 3 apart from ZeRO 0: losses by {diff}, "
                             f"masters bit-equal {same}")
    # B3 on the stage-3 shard: 2 steps at ZeRO 3 and at ZeRO 0
    lamb = {"type": "fusedlamb", "params": {"lr": 1e-4,
                                            "weight_decay": 0.01}}
    lruns, ldiff, lsame = _zero_pair(
        torch, lambda st: make(st, lamb), batches, (3, 0), 0, 2,
        "llama-zero3-lamb", smi)
    lz = lruns[3]
    lwant = {"flash_attention_fwd": L * gas * 2,
             "flash_attention_bwd_dq": L * gas * 2,
             "flash_attention_bwd_dkv": L * gas * 2,
             "fused_lamb_phase1": 2, "fused_lamb_phase2": 2}
    log(f"[llama-zero3] fusedlamb at ZeRO 3, 2 steps: losses "
        + ", ".join(f"{x:.4f}" for x in lz["losses"]) + f", launches "
        f"{lz['launches']}, peak {lz['peak'] / 2**30:.2f} GiB (ZeRO 0 "
        f"{lruns[0]['peak'] / 2**30:.2f}) | {smi}")
    if lz["launches"] != lwant or lruns[0]["launches"] != lwant:
        raise AssertionError(f"LAMB launches {lz['launches']}, ZeRO 0 "
                             f"{lruns[0]['launches']}, want {lwant}")
    if ldiff != 0 or not lsame:
        raise AssertionError(f"LAMB at ZeRO 3 apart from ZeRO 0: losses by "
                             f"{ldiff}, masters bit-equal {lsame}")
    return dict(losses=z["losses"], losses_zero0=z0["losses"],
                max_loss_diff=diff, masters_equal=same,
                step_ms=[t * 1e3 for t in z["times"]],
                step_ms_mean=step_s * 1e3, step_ms_zero0=step_s0 * 1e3,
                tokens_per_s=tok_s, mfu=mfu, peak_bytes=z["peak"],
                peak_bytes_zero0=z0["peak"], calls=z["calls"],
                per_step=per_step, launches=z["launches"], plan=plan,
                peak_live_elems=z["peak_live_elems"],
                digest=z["digest"], batches=batches, config=config,
                lamb=dict(losses=lz["losses"],
                          losses_zero0=lruns[0]["losses"],
                          max_loss_diff=ldiff, masters_equal=lsame,
                          launches=lz["launches"], peak_bytes=lz["peak"],
                          peak_bytes_zero0=lruns[0]["peak"]),
                profile=z.get("profile"))


def _counted_steps(torch, engine, batches):
    """One micro-step a batch (optimizer steps at the accumulation
    boundaries), every launch counter set to 0 just before: (losses,
    launches)."""
    counters = _all_launches()
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    losses = []
    for batch in batches:
        loss = engine(*batch)
        engine.backward(loss)
        engine.step()
        losses.append(loss)
    torch.cuda.synchronize()
    return ([x.item() for x in losses],
            {k: fn.launches for k, fn in counters.items() if fn.launches})


def _host_state(engine):
    return dict(master=engine.fp32_params().to("cpu", copy=True),
                scale=float(engine.cur_scale),
                skipped=engine.skipped_steps, lr=engine.get_lr(),
                count=engine.opt_state.count, steps=engine.global_steps)


def _save_resume(torch, tag, make, pre, post, save_dir, async_save, smi):
    """Train ``pre``, save, train ``post`` (the first run); a fresh engine
    loads the tag and trains ``post``.  Returns (the fresh engine, the
    master at the save on the host, the numbers)."""
    import shutil
    from deepspeed_tpu_torch.runtime import checkpoint_engine as ce
    a = make()
    _counted_steps(torch, a, pre)
    free = shutil.disk_usage(save_dir).free
    saved = a.fp32_params().to("cpu", copy=True)
    t = time.perf_counter()
    a.save_checkpoint(save_dir, tag=tag, async_save=async_save)
    save_s = time.perf_counter() - t
    losses, launches = _counted_steps(torch, a, post)
    t = time.perf_counter()
    a.wait_for_checkpoint()
    wait_s = time.perf_counter() - t
    stats = a.last_checkpoint.stats()
    first = _host_state(a)
    del a
    _free(torch)
    root = os.path.join(save_dir, tag)
    files = {f: os.path.getsize(os.path.join(root, f))
             for f in sorted(os.listdir(root))}
    total = sum(files.values())
    b = make()
    verify_s = []
    verify = ce.verify_checkpoint_tag

    def timed_verify(path):
        t0 = time.perf_counter()
        out = verify(path)
        verify_s.append(time.perf_counter() - t0)
        return out

    ce.verify_checkpoint_tag = timed_verify
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        b.load_checkpoint(save_dir)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
    finally:
        ce.verify_checkpoint_tag = verify
    loaded_equal = torch.equal(b.fp32_params().cpu(), saved)
    losses_b, launches_b = _counted_steps(torch, b, post)
    second = _host_state(b)
    r = dict(free_disk_bytes=free, file_bytes=files, tag_bytes=total,
             save_return_s=save_s, wait_s=wait_s,
             stage_s=stats["stage_s"], write_s=stats["write_s"],
             commit_s=stats["commit_s"], verify_s=sum(verify_s),
             load_s=load_s, write_gb_s=total / stats["write_s"] / 1e9,
             load_gb_s=total / load_s / 1e9, losses=losses,
             losses_resumed=losses_b, launches=launches,
             launches_resumed=launches_b, loaded_master_equal=loaded_equal,
             master_equal=torch.equal(first["master"], second["master"]),
             scale=(first["scale"], second["scale"]),
             skipped=(first["skipped"], second["skipped"]),
             lr=(first["lr"], second["lr"]),
             count=(first["count"], second["count"]))
    log(f"[save-resume] {tag}: free disk {free / 1e9:.1f} GB before the "
        f"save; files " + ", ".join(f"{f} {n:,} B" for f, n in files.items())
        + f" ({total / 1e9:.2f} GB); save returned in {save_s:.2f} s "
        f"({'async' if async_save else 'sync'}: host copies "
        f"{stats['stage_s']:.2f} s, writes {stats['write_s']:.2f} s = "
        f"{r['write_gb_s']:.2f} GB/s, commit {stats['commit_s']:.2f} s), "
        f"wait_for_checkpoint {wait_s:.2f} s; load {load_s:.2f} s = "
        f"{r['load_gb_s']:.2f} GB/s, of which CRC verify "
        f"{r['verify_s']:.2f} s | {smi}")
    log(f"[save-resume] {tag}: losses {losses} | resumed {losses_b}; "
        f"scale {r['scale']}, skipped {r['skipped']}, lr {r['lr']}, "
        f"count {r['count']}; master bit-equal after the load "
        f"{loaded_equal}, after the steps {r['master_equal']}; launches "
        f"{launches} | resumed {launches_b}")
    bad = [k for k in ("scale", "skipped", "lr", "count")
           if r[k][0] != r[k][1]]
    if losses != losses_b or bad or not loaded_equal or \
            not r["master_equal"] or launches != launches_b:
        raise AssertionError(f"{tag}: the resumed run left the first "
                             f"(losses {losses} vs {losses_b}, unequal "
                             f"{bad}, master after load {loaded_equal}, "
                             f"after the steps {r['master_equal']}, "
                             f"launches {launches} vs {launches_b})")
    for k in ("flash_attention_fwd", "flash_attention_bwd_dq",
              "flash_attention_bwd_dkv", "fused_adam_step"):
        if not launches.get(k):
            raise AssertionError(f"{tag}: {k} never launched")
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"{tag}: losses {losses}")
    return b, saved, r


def stage_save_resume(seed, smi):
    """Stage 26: save and resume at ZeRO 1 (GPT-2 350M, fp16, async save)
    and ZeRO 3 (Llama-2-7B width, bf16, sync save), then the 16-bit export
    and ``zero_to_fp32`` of the ZeRO-3 tag."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.checkpoint import \
        get_fp32_state_dict_from_zero_checkpoint
    from deepspeed_tpu_torch.models.gpt2 import gpt2_350m
    from deepspeed_tpu_torch.models.llama import (LlamaModel, llama_7b,
                                                  param_count)
    save_dir = tempfile.mkdtemp(prefix="ds_ckpt_")
    out = {}
    try:
        # (a) stage 23's config and batch shape, async save
        rng = np.random.default_rng(seed + 26)
        B, S = 8, 1024
        gcfg = gpt2_350m()
        batches = [(ids, ids) for ids in (torch.from_numpy(rng.integers(
            0, gcfg.vocab_size, size=(B, S))).cuda() for _ in range(6))]
        config = dict(GPT2_CONFIG, optimizer={"type": "fusedadam",
                                              "params": {"lr": 1e-4}},
                      zero_optimization={"stage": 1})
        eng, _, out["gpt2_zero1"] = _save_resume(
            torch, "gpt2_zero1", lambda: _gpt2_engine(torch, seed,
                                                      config)[0],
            batches[:3], batches[3:], save_dir, True, smi)
        del eng
        _free(torch)
        shutil.rmtree(os.path.join(save_dir, "gpt2_zero1"))
        # (b) stage 25's model at ZeRO 3, sync save; depth cut to the disk
        free = shutil.disk_usage(save_dir).free
        L, gas = 8, 2
        while L > 1 and 16 * param_count(llama_7b(num_hidden_layers=L)) \
                * 1.1 > free:
            L //= 2
        if L != 8:
            log(f"[save-resume] llama_zero3 cut to {L} layers: "
                f"{free / 1e9:.1f} GB free")
        cfg = llama_7b(num_hidden_layers=L, remat=False,
                       head_dtype="bfloat16")
        zero = dict(ZERO3, stage3_gather_16bit_weights_on_model_save=True)
        lconfig = dict(TRAIN_CONFIG, gradient_accumulation_steps=gas,
                       zero_optimization=zero)
        rng = np.random.default_rng(seed + 2626)
        mb = [(ids, ids) for ids in (torch.from_numpy(rng.integers(
            0, cfg.vocab_size, size=(4, 2048))).cuda() for _ in range(8))]

        def make():
            engine = deepspeed_tpu_torch.initialize(
                model=LlamaModel(cfg, device="meta"), config=lconfig)[0]
            engine.initialize_parameters(seed)
            return engine

        eng, saved, r = _save_resume(torch, "llama_zero3", make, mb[:4],
                                     mb[4:], save_dir, False, smi)
        r["layers"] = L
        step_peak = torch.cuda.max_memory_allocated()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t = time.perf_counter()
        if not eng.save_16bit_model(os.path.join(save_dir, "export16")):
            raise AssertionError("save_16bit_model wrote nothing")
        r["save_16bit_s"] = time.perf_counter() - t
        r["save_16bit_extra_bytes"] = torch.cuda.max_memory_allocated() - \
            before
        unit = 2 * max(eng.zero_plan.unit_numel)
        layout = list(eng._layout)
        del eng
        _free(torch)
        t = time.perf_counter()
        sd = get_fp32_state_dict_from_zero_checkpoint(save_dir,
                                                      tag="llama_zero3")
        r["zero_to_fp32_s"] = time.perf_counter() - t
        r["zero_to_fp32_equal"] = all(
            torch.equal(sd[n].reshape(-1), saved[o:o + k])
            for n, o, k, _ in layout) and len(sd) == len(layout)
        log(f"[save-resume] llama_zero3 ({L} layers): save_16bit_model "
            f"{r['save_16bit_s']:.2f} s, "
            f"{os.path.getsize(os.path.join(save_dir, 'export16', 'pytorch_model.bin')) / 1e9:.2f}"
            f" GB, peak {r['save_16bit_extra_bytes'] / 2**30:.3f} GiB "
            f"beyond the memory before it (largest unit "
            f"{unit / 2**30:.3f} GiB; the steps' peak "
            f"{step_peak / 2**30:.2f} GiB); zero_to_fp32 "
            f"{r['zero_to_fp32_s']:.2f} s, equal to the saved master "
            f"{r['zero_to_fp32_equal']} | {smi}")
        if r["save_16bit_extra_bytes"] > unit or \
                not r["zero_to_fp32_equal"]:
            raise AssertionError("16-bit export above one unit, or "
                                 "zero_to_fp32 apart from the master")
        out["llama_zero3"] = r
        return out
    finally:
        shutil.rmtree(save_dir, ignore_errors=True)


# ----------------------------------------------------------- stage 27
def _mem_available():
    """The kernel's ``MemAvailable`` in bytes."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def _free_all(torch, label):
    """:func:`_free`, and the pinned blocks PyTorch's host allocator keeps
    cached (an offload run leaves tens of GB there); logs
    ``MemAvailable`` after."""
    _free(torch)
    empty = getattr(torch._C, "_host_emptyCache", None)
    if empty is not None:
        empty()
    log(f"[offload] after {label}: MemAvailable "
        f"{_mem_available() / 1e9:.1f} GB (host cache emptied: "
        f"{empty is not None})")


def _report_left(torch, label):
    """After an engine is deleted and collected: the card memory still
    allocated, and each live CUDA tensor whose storage is above 256 MB
    with the types of what refers to it (ROADMAP queue C3).  Returns the
    bytes allocated."""
    left = torch.cuda.memory_allocated()
    found = []
    for obj in gc.get_objects():
        try:
            big = (isinstance(obj, torch.Tensor) and obj.is_cuda and
                   obj.untyped_storage().nbytes() > (256 << 20))
        except Exception:   # objects that fail isinstance probes
            continue
        if big:
            refs = sorted({type(r).__name__ for r in gc.get_referrers(obj)
                           if r is not found})
            found.append((tuple(obj.shape), str(obj.dtype),
                          obj.untyped_storage().nbytes(), refs[:6]))
    log(f"[offload] after {label}: {left / 1e9:.2f} GB of the card still "
        f"allocated; live CUDA tensors above 256 MB: {found or 'none'}")
    return left


def _pinned_bytes(n):
    """Bytes PyTorch's pinned allocator takes for ``n`` bytes (it rounds a
    block up to a power of two)."""
    return 1 << max(0, int(n - 1).bit_length())


def _offload_run(torch, engine, batches, steps, mid=None):
    """``steps`` optimizer steps (``gas`` micro-steps each, micro-step j
    on ``batches[j % len]``), launch counters set to 0 just before;
    ``mid(engine)`` after the first step, then the peak reset: the peak is
    the later steps'.  Returns losses, launches, peak, step seconds and
    the fp32 master on the host."""
    counters = _all_launches()
    gas = engine.gradient_accumulation_steps()
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    losses, times, extra = [], [], {}
    for s in range(steps):
        t = time.perf_counter()
        for _ in range(gas):
            loss = engine(*batches[len(losses) % len(batches)])
            engine.backward(loss)
            engine.step()
            losses.append(loss)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        if s == 0:
            if mid is not None:
                extra = mid(engine)
            torch.cuda.reset_peak_memory_stats()
    launches = {k: fn.launches for k, fn in counters.items() if fn.launches}
    peak = torch.cuda.max_memory_allocated()
    master = engine.fp32_params()[:engine.zero_plan.numel].cpu()
    return dict(losses=[x.item() for x in losses], launches=launches,
                peak=peak, times=times, master=master, **extra)


def _round_trip(torch):
    """(d): ``offload_states()`` then ``reload_states()`` mid-run."""
    def mid(engine):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        engine.offload_states()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        freed = before - torch.cuda.memory_allocated()
        where = engine.state_placement()
        offloaded = sorted(engine._host_offloaded)
        engine.reload_states()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if set(where.values()) != {"host"} or \
                torch.cuda.memory_allocated() != before:
            raise AssertionError(f"offload_states left {where}, or reload "
                                 f"did not refill what it freed")
        return dict(freed_bytes=freed, offload_s=t1 - t0,
                    reload_s=t2 - t1, offloaded=offloaded)
    return mid


def _offload_zero3(torch, seed, smi):
    """(c) and (d): stage 25's model at ZeRO 3 with and without
    ``offload_optimizer: cpu``, FusedLamb (B3) and FusedAdam (B2), 2 steps
    each; the Adam offload run takes (d)'s round trip after its first
    step."""
    import numpy as np
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import (LlamaModel, llama_7b,
                                                  param_count)
    B, S, L, gas, steps = 4, 2048, 8, 2, 2
    cfg = llama_7b(num_hidden_layers=L, remat=False, head_dtype="bfloat16")
    rng = np.random.default_rng(seed + 24)      # stage 24's batches
    batches = [(ids, ids) for ids in (torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(B, S))).cuda() for _ in range(gas))]
    out = {}
    for opt, params in (("fusedlamb", {"lr": 1e-4, "weight_decay": 0.01}),
                        ("fusedadam", {"lr": 1e-4})):
        runs = {}
        for off in (False, True):
            zero = dict(ZERO3)
            if off:
                zero["offload_optimizer"] = {"device": "cpu",
                                             "pin_memory": True}
            t0 = time.perf_counter()
            engine = deepspeed_tpu_torch.initialize(
                model=LlamaModel(cfg, device="meta"), config=dict(
                    TRAIN_CONFIG, gradient_accumulation_steps=gas,
                    optimizer={"type": opt, "params": params},
                    zero_optimization=zero))[0]
            engine.initialize_parameters(seed)
            build_s = time.perf_counter() - t0
            mid = _round_trip(torch) if off and opt == "fusedadam" else None
            r = _offload_run(torch, engine, batches, steps, mid)
            r["build_s"] = build_s
            if off:
                state = {"master": engine.master,
                         **engine._moments()}
                r["pinned"] = {k: t.is_pinned() for k, t in state.items()}
                r["placement"] = engine.state_placement()
                r["pin_seconds"] = engine.offload_stats["pin_seconds"]
                r["pinned_bytes"] = engine.offload_stats["pinned_bytes"]
            runs[off] = r
            del engine
            _free_all(torch, f"{opt}{' offload' if off else ''}")
            r["left_bytes"] = _report_left(torch, f"{opt}"
                                           f"{' offload' if off else ''}")
        a, b = runs[True], runs[False]
        same = torch.equal(a.pop("master"), b.pop("master"))
        drop = b["peak"] - a["peak"]
        kern = ({"fused_lamb_phase1": steps, "fused_lamb_phase2": steps}
                if opt == "fusedlamb" else {"fused_adam_step": steps})
        want = dict({f"flash_attention_{k}": L * gas * steps
                     for k in ("fwd", "bwd_dq", "bwd_dkv")}, **kern)
        log(f"[offload-z3] {opt}, ZeRO 3, offload_optimizer cpu, 8-layer "
            f"7B width, {steps} steps of {gas} micro-steps: losses "
            + ", ".join(f"{x:.4f}" for x in a["losses"])
            + f" (without offload " + ", ".join(
                f"{x:.4f}" for x in b["losses"]) + f"); master "
            f"{'bit-equal' if same else 'DIFFERS'}; step ms "
            + ", ".join(f"{t * 1e3:.1f}" for t in a["times"])
            + " (without " + ", ".join(f"{t * 1e3:.1f}" for t in b["times"])
            + f"); peak HBM {a['peak'] / 2**30:.2f} GiB (without "
            f"{b['peak'] / 2**30:.2f}: {drop / 1e9:.2f} GB less); pinned "
            f"{a['pinned_bytes'] / 1e9:.2f} GB in {a['pin_seconds']:.2f} s, "
            f"is_pinned {a['pinned']}; launches {a['launches']} | {smi}")
        if "freed_bytes" in a:
            log(f"[offload-z3] (d) offload_states() after step 1 freed "
                f"{a['freed_bytes'] / 1e9:.2f} GB of HBM ({a['offloaded']}) "
                f"in {a['offload_s']:.2f} s, reload_states() "
                f"{a['reload_s']:.2f} s; the next step bit-equal: "
                f"{a['losses'] == b['losses'] and same} | {smi}")
        if a["losses"] != b["losses"] or not same:
            raise AssertionError(f"{opt}: offload apart from no offload")
        if a["launches"] != want or b["launches"] != want:
            raise AssertionError(f"{opt} launches {a['launches']}, without "
                                 f"offload {b['launches']}, want {want}")
        if not all(a["pinned"].values()) or \
                set(a["placement"][k] for k in a["pinned"]) != {"host"}:
            raise AssertionError(f"state not pinned on the host: "
                                 f"{a['pinned']} {a['placement']}")
        # the master and two moments, 12 bytes an element, leave the card
        # (no earlier engine's shard left behind: ROADMAP queue C3)
        floor = 0.95 * 12 * param_count(cfg)
        if drop < floor:
            raise AssertionError(f"peak HBM fell by {drop / 1e9:.2f} GB, "
                                 f"under {floor / 1e9:.2f}")
        a["peak_drop_bytes"] = drop
        out[opt] = dict(offload=a, plain=b, masters_equal=same)
    return out


def _stream_steps(torch, engine, batches, warmup, timed):
    """Warm-up and timed steps of a streaming engine, counters set to 0
    just before: losses, step seconds, launches, peak over the timed
    steps, sweep and copy seconds a timed step."""
    counters = _all_launches()
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    losses, times, sweep, copies = [], [], [], []
    store = engine._store
    for i in range(warmup + timed):
        if i == warmup:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            store.transfer_seconds()
        t = time.perf_counter()
        loss = engine(*batches[i % len(batches)])
        engine.backward(loss)
        engine.step()
        losses.append(loss)
        torch.cuda.synchronize()
        if i >= warmup:
            times.append(time.perf_counter() - t)
            sweep.append(engine.sweep_seconds[-1])
            copies.append(store.transfer_seconds())
    launches = {k: fn.launches for k, fn in counters.items() if fn.launches}
    return dict(losses=[x.item() for x in losses], times=times,
                launches=launches, peak=torch.cuda.max_memory_allocated(),
                sweep_s=sweep, h2d_s=[c["h2d"] for c in copies],
                d2h_s=[c["d2h"] for c in copies])


def _stream_engine(cfg, seed, zero, model_parameters=None):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LlamaModel
    t0 = time.perf_counter()
    engine = deepspeed_tpu_torch.initialize(
        model=LlamaModel(cfg, device="meta"),
        model_parameters=model_parameters,
        config=dict(TRAIN_CONFIG, zero_optimization=zero))[0]
    if model_parameters is None:
        engine.initialize_parameters(seed)
    return engine, time.perf_counter() - t0


def _stream_depth(spec_block, spec_res, budget, per_elem):
    """The most blocks whose host state fits ``budget``."""
    L = 0
    while per_elem(spec_block * (L + 1) + spec_res, L + 1) <= budget:
        L += 1
    return L


def stage_offload(seed, smi):
    """Stage 27: (a) ZeRO-Infinity parameter streaming at Llama-2-13B width
    with its state on the host (first: its depth is what the host's
    memory holds), its 2-block parity with the ordinary engine, (b) the
    optimizer state on NVMe, then (c) and (d) at ZeRO 3."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from deepspeed_tpu_torch.models.llama import llama_13b
    out = {}
    _free_all(torch, "the earlier stages")

    # (a) ZeRO-Infinity at 13B width: depth from the host's memory
    B, S, warmup, timed = 4, 2048, 1, 3
    full = llama_13b(dtype="bfloat16", head_dtype="bfloat16")
    D, I, V = full.hidden_size, full.intermediate_size, full.vocab_size
    n_block = 4 * D * D + 3 * D * I + 2 * D           # 317.2 M
    n_res = 2 * V * D + D                             # 327.7 M
    avail = _mem_available()
    budget = 0.7 * avail
    # the formula: 16 bytes an element (master, m, v, bf16 cache and
    # stash); what PyTorch takes: the cache and stash of each group
    # rounded up to a power of two by the pinned allocator
    L16 = _stream_depth(n_block, n_res, budget, lambda n, L: 16 * n)
    L = _stream_depth(n_block, n_res, budget, lambda n, L: 12 * n + 2 * (
        L * _pinned_bytes(2 * n_block) + _pinned_bytes(2 * n_res)))
    L = max(1, min(L, full.num_hidden_layers))
    n = n_block * L + n_res
    log(f"[infinity] MemAvailable {avail / 1e9:.1f} GB, budget 0.7 × = "
        f"{budget / 1e9:.1f} GB; 16 bytes × ({n_block / 1e6:.1f} M · L + "
        f"{n_res / 1e6:.1f} M) fits L = {L16}; with the pinned allocator's "
        f"power-of-two blocks L = {L} ({n / 1e9:.3f} G elements, "
        f"{16 * n / 1e9:.1f} GB of host state by the formula); full depth "
        f"{full.num_hidden_layers} would need "
        f"{16 * (n_block * full.num_hidden_layers + n_res) / 1e9:.0f} GB")
    cfg = llama_13b(num_hidden_layers=L, dtype="bfloat16",
                    head_dtype="bfloat16")
    zero = {"stage": 3, "offload_param": {"device": "cpu"},
            "offload_optimizer": {"device": "cpu"}}
    rng = np.random.default_rng(seed + 27)
    batches = [(ids, ids) for ids in (torch.from_numpy(rng.integers(
        0, V, size=(B, S))).cuda() for _ in range(2))]
    engine, build_s = _stream_engine(cfg, seed, zero)
    # the store's master, moments and cache, and a step's bf16 stash
    host = engine._store.host_bytes() + 2 * n
    r = _stream_steps(torch, engine, batches, warmup, timed)
    steps = warmup + timed
    step_s = sum(r["times"]) / timed
    tok_s = B * S / step_s
    flops_tok = 6 * n + 12 * L * S * D
    mfu = tok_s * flops_tok / BF16_FLOPS
    a = dict(r, layers=L, layers_formula=L16, mem_available=avail,
             build_s=build_s, host_bytes=host,
             max_resident_blocks=engine.max_resident_blocks,
             hbm_param_bytes_after=engine.hbm_param_bytes(),
             transfer_bytes=dict(engine._store.transfer),
             step_ms_mean=step_s * 1e3, tokens_per_s=tok_s, mfu=mfu)
    log(f"[infinity] Llama-2-13B width, {L} layers, bf16, offload_param and "
        f"offload_optimizer cpu, host fusedadam, B={B} S={S}: built in "
        f"{build_s:.1f} s (host init); losses "
        + ", ".join(f"{x:.4f}" for x in r["losses"]))
    log(f"[infinity] step ms " + ", ".join(f"{t * 1e3:.1f}" for t in
                                           r["times"])
        + f" | mean {step_s * 1e3:.1f} ms, {tok_s:.1f} tokens/s, MFU "
        f"{mfu:.4f} | host sweep s " + ", ".join(
            f"{t:.2f}" for t in r["sweep_s"]) + " | H2D s " + ", ".join(
            f"{t:.3f}" for t in r["h2d_s"]) + " | D2H s " + ", ".join(
            f"{t:.3f}" for t in r["d2h_s"])
        + f" | peak HBM {r['peak'] / 2**30:.2f} GiB | host bytes "
        f"{a['host_bytes'] / 1e9:.1f} GB | max_resident_blocks "
        f"{engine.max_resident_blocks}, hbm_param_bytes after the step "
        f"{engine.hbm_param_bytes()} | copied {engine._store.transfer} in "
        f"{steps} steps | {smi}")
    log(f"[infinity] launches in {steps} steps: {r['launches']}")
    want = {"flash_attention_fwd": 2 * L * steps,
            "flash_attention_bwd_dq": L * steps,
            "flash_attention_bwd_dkv": L * steps}
    if r["launches"] != want:
        raise AssertionError(f"streaming launches {r['launches']}, want "
                             f"{want}")
    if not 0 < engine.max_resident_blocks <= 3 or \
            engine.hbm_param_bytes() != 0 or \
            not all(np.isfinite(r["losses"])):
        raise AssertionError("streaming: more than 3 blocks on the card, "
                             "a block left after the step, or a non-finite "
                             "loss")
    del engine
    _free_all(torch, "(a)")

    # the same width at 2 blocks, streamed and through the ordinary engine
    # at ZeRO 0, from the same weights and data
    cfg2 = llama_13b(num_hidden_layers=2, dtype="bfloat16",
                     head_dtype="bfloat16", remat=False)
    streamed, _ = _stream_engine(cfg2, seed, zero)
    weights = streamed.get_fp32_param()
    rs = _stream_steps(torch, streamed, batches, 0, 2)
    del streamed
    _free_all(torch, "the 2-block streamed run")
    plain, _ = _stream_engine(cfg2, seed, {"stage": 0}, weights)
    del weights
    rp = _offload_run(torch, plain, batches, 2)
    del plain, rp["master"]
    _free_all(torch, "the 2-block ZeRO-0 run")
    rel = [abs(x - y) / abs(y) for x, y in zip(rs["losses"], rp["losses"])]
    log(f"[infinity] 2 blocks at 13B width, streamed (host Adam) against "
        f"ZeRO 0 (B2), same weights and data: losses "
        + ", ".join(f"{x:.5f}" for x in rs["losses"]) + " against "
        + ", ".join(f"{x:.5f}" for x in rp["losses"])
        + f"; largest relative difference {max(rel):.2e} (limit 2^-7) | "
        f"{smi}")
    if max(rel) > 2.0**-7:
        raise AssertionError(f"streamed apart from ZeRO 0: {rel}")
    a["parity"] = dict(streamed=rs["losses"], zero0=rp["losses"],
                       max_rel=max(rel))
    out["infinity"] = a

    # (b) the optimizer state on NVMe, on the local disk
    swap = tempfile.mkdtemp(prefix="ds_nvme_")
    try:
        free = shutil.disk_usage(swap).free
        Ld = _stream_depth(n_block, n_res, 0.7 * free, lambda n, L: 12 * n)
        # one block: two steps move 4 × 7.7 GB through a disk of about
        # 1.2 GB/s (stage 26), inside the script's time limit
        Lb = max(1, min(Ld, 1))
        log(f"[nvme] free disk under {swap}: {free / 1e9:.1f} GB; 12 bytes "
            f"× ({n_block / 1e6:.1f} M · L + {n_res / 1e6:.1f} M) ≤ 0.7 × "
            f"fits L = {Ld}; cut to L = {Lb} for the time limit")
        cfgb = llama_13b(num_hidden_layers=Lb, dtype="bfloat16",
                         head_dtype="bfloat16")
        zb = {"stage": 3, "offload_param": {"device": "cpu"},
              "offload_optimizer": {"device": "nvme", "nvme_path": swap}}
        engine, build_s = _stream_engine(cfgb, seed, zb)
        rb = _stream_steps(torch, engine, batches, 0, 2)
        nb = n_block * Lb + n_res
        moved = 2 * 12 * nb     # the state read and written in a sweep
        aio = engine._store._swapper.aio.engine
        gbs = [moved / t / 1e9 for t in rb["sweep_s"]]
        log(f"[nvme] {Lb} layer(s) at 13B width, offload_optimizer nvme "
            f"(aio engine {aio}), 2 steps: losses " + ", ".join(
                f"{x:.4f}" for x in rb["losses"]) + f"; built (state written)"
            f" in {build_s:.1f} s; step ms " + ", ".join(
                f"{t * 1e3:.1f}" for t in rb["times"]) + f"; swapped "
            f"{moved / 1e9:.2f} GB a step in the host sweep (s " + ", ".join(
                f"{t:.2f}" for t in rb["sweep_s"]) + "): " + ", ".join(
                f"{g:.2f}" for g in gbs) + " GB/s over the sweep (its host "
            f"Adam included); launches {rb['launches']}"
            f" | {smi}")
        if not all(np.isfinite(rb["losses"])):
            raise AssertionError("NVMe offload: a non-finite loss")
        out["nvme"] = dict(rb, layers=Lb, layers_disk=Ld, free_disk=free,
                           aio_engine=aio, bytes_per_step=moved, gbps=gbs,
                           build_s=build_s)
        del engine
        _free_all(torch, "(b)")
    finally:
        shutil.rmtree(swap, ignore_errors=True)
    out["zero3"] = _offload_zero3(torch, seed, smi)
    return out


# ----------------------------------------------------------- stage 28
ZP_FORMATS = ("int8", "int4", "fp8", "fp6", "fp12")


def _zp_launches():
    """B5's and B6's counters (B5's quantize by route)."""
    from deepspeed_tpu_torch.ops.kernels import fp_quantizer, quantizer
    q = quantizer.quantize_blockwise
    return dict(quantize_blockwise=q.launches,
                dequantize_blockwise=quantizer.dequantize_blockwise.launches,
                quantize_fp_packed=fp_quantizer.quantize_fp_packed.launches,
                **{f"quantize_blockwise_{r}": n
                   for r, n in q.route_launches.items()})


def _zp_diff(before, after):
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def _zp_plain(torch, fmt, gs):
    """The plain versions of ``fmt``'s codec: (quantize, dequantize)."""
    from deepspeed_tpu_torch.comm.collectives import quantized as Q
    from deepspeed_tpu_torch.ops import fp_quantizer as fpq
    from deepspeed_tpu_torch.ops.kernels import fp_quantizer as kfp
    from deepspeed_tpu_torch.ops.kernels import quantizer as qz
    egs = Q.effective_group_size(gs)
    if fmt in ("int8", "int4"):
        bits = 8 if fmt == "int8" else 4
        return ((lambda x: qz.quantize_blockwise_plain(x, bits, gs)),
                qz.dequantize_blockwise_plain)
    if fmt == "fp8":        # the codec is a cast: its own plain version
        return Q.wire_codec(fmt, gs)[0], fpq.dequantize_fp
    bits, man = Q._FP_FORMATS[fmt]

    def quant(x):
        packed, scales = kfp.quantize_fp_packed_plain(x, bits, man, egs)
        _, groups, _ = fpq.fp_groups(x.numel(), egs)
        return packed, scales, (tuple(x.shape), x.dtype, groups, bits, man,
                                egs)
    return quant, fpq.dequantize_fp


def _zp_codec_case(torch, x, fmt, gs):
    """(a): one codec on the block buffer against its plain version."""
    from deepspeed_tpu_torch.comm.collectives import quantized as Q
    quant, dequant = Q.wire_codec(fmt, gs)
    pquant, pdequant = _zp_plain(torch, fmt, gs)
    n = x.numel()
    before = _zp_launches()
    q, sc, meta = quant(x)
    back = dequant(q, sc, meta)
    torch.cuda.synchronize()
    launched = _zp_diff(before, _zp_launches())
    q_ref, s_ref, meta_ref = pquant(x)
    same = (tuple(meta) == tuple(meta_ref) and torch.equal(q, q_ref)
            and torch.equal(sc, s_ref))
    del q_ref, s_ref
    back_ref = pdequant(q, sc, meta)
    err = (back.float() - back_ref.float()).abs().max().item()
    same_back = torch.equal(back, back_ref)
    del back_ref
    ms_q = cuda_ms(lambda: quant(x), 5)
    ms_d = cuda_ms(lambda: dequant(q, sc, meta, out=back), 5)
    payload = q.numel() * q.element_size() + sc.numel() * 4
    # bytes the work must move: the bf16 input read once, the codes and
    # scales written once (and the reverse to decode)
    bound_q = (n * x.element_size() + payload) / HBM_BYTES_PER_S * 1e3
    bound_d = (payload + n * x.element_size()) / HBM_BYTES_PER_S * 1e3
    wire = Q.quantized_wire_bytes(n, fmt, gs)
    route = {"int8": "B5", "int4": "B5", "fp8": "cast (no kernel)",
             "fp6": "B6 + plain decode", "fp12": "B6 + plain decode"}[fmt]
    del q, sc, back
    return dict(fmt=fmt, group_size=gs, route=route, equal=same,
                equal_decode=same_back, err=err, ms_q=ms_q, ms_d=ms_d,
                bound_q=bound_q, bound_d=bound_d, wire_bytes=wire,
                bf16_bytes=2 * n, launches=launched)


def _zp_primitives(torch, x):
    """(b): the primitives on the NCCL world of one rank, against the plain
    codec, a copy and the plain decode."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.comm.collectives import quantized as Q
    from deepspeed_tpu_torch.utils import groups
    comm.init_distributed(dist_backend="nccl", verbose=False)
    g = comm.get_world_group()
    inner, outer = groups.factor_groups(1)
    rows = []
    before = _zp_launches()
    for fmt in ("int8", "fp6"):
        gs = 2048
        pquant, pdequant = _zp_plain(torch, fmt, gs)
        q, sc, meta = pquant(x)
        plain = pdequant(q, sc, meta)
        plain32 = pdequant(q, sc, (meta[0], torch.float32) + tuple(meta[2:]))
        got = {
            "quantized_all_gather": (Q.quantized_all_gather(
                x, g, 0, fmt, gs), plain),
            "all_to_all_quant_reduce": (Q.all_to_all_quant_reduce(
                x, g, 0, 1, wire_format=fmt, group_size=gs, mean=False),
                plain32),
            "hierarchical_quant_reduce_scatter": (
                Q.hierarchical_quant_reduce_scatter(
                    x, inner, outer, 0, 1, 1, wire_format=fmt,
                    group_size=gs, mean=True), plain32),
            "quantized_all_to_all": (Q.quantized_all_to_all(
                x, g, 0, 0, 1, fmt, gs), plain),
        }
        torch.cuda.synchronize()
        for name, (a, b) in got.items():
            rows.append(dict(fn=name, fmt=fmt, equal=torch.equal(a, b),
                             dtype=str(a.dtype)))
        del q, sc, plain, plain32, got
    launched = _zp_diff(before, _zp_launches())
    return rows, launched


def stage_zeropp(seed, smi, zero3):
    """Stage 28: (a) the wire codecs at a real size, (b) the primitives at
    world 1, (c) stage 25's engine with qwZ and qgZ (module docstring).
    ``zero3``: stage 25's result."""
    import numpy as np
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LlamaModel, llama_7b
    t0 = time.perf_counter()
    _free(torch)
    gen = torch.Generator(device="cuda").manual_seed(seed + 28)
    x = torch.randn(BLOCK_7B, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    x[:4096] = 0                                   # all-zero groups
    codecs = []
    for gs in (2048, 128):
        for fmt in ZP_FORMATS:
            r = _zp_codec_case(torch, x, fmt, gs)
            codecs.append(r)
            log(f"[zeropp] (a) {fmt} wire, groups of {gs}, on one 7B-width "
                f"block ({BLOCK_7B:,} bf16 elements), {r['route']}: codes "
                f"and scales {'bit-equal' if r['equal'] else 'DIFFER'} to "
                f"the plain version, decode "
                f"{'bit-equal' if r['equal_decode'] else 'DIFFERS'} "
                f"(max |diff| {r['err']:.3e}) | encode {r['ms_q']:.3f} ms "
                f"(bound {r['bound_q']:.3f}, bytes), decode "
                f"{r['ms_d']:.3f} ms (bound {r['bound_d']:.3f}, bytes) | "
                f"wire {r['wire_bytes']:,} bytes against {r['bf16_bytes']:,}"
                f" in bf16 ({r['wire_bytes'] / r['bf16_bytes']:.4f}) | "
                f"launches {r['launches']} | {smi}")
            _free(torch)
    want = {"int8": {"quantize_blockwise": 1, "dequantize_blockwise": 1,
                     "quantize_blockwise_contiguous": 1},
            "fp8": {}, "fp6": {"quantize_fp_packed": 1}}
    want["int4"], want["fp12"] = want["int8"], want["fp6"]
    bad = [(r["fmt"], r["group_size"]) for r in codecs
           if not (r["equal"] and r["equal_decode"]) or
           r["launches"] != want[r["fmt"]]]
    if bad:
        raise AssertionError(f"wire codecs apart from their plain versions "
                             f"or launching other kernels: {bad}")
    prims, prim_launches = _zp_primitives(torch, x[:(1 << 24) + 1000])
    del x
    _free(torch)
    log(f"[zeropp] (b) at world 1 (each exchange a copy): " + ", ".join(
        f"{r['fn']} {r['fmt']} {'bit-equal' if r['equal'] else 'DIFFERS'}"
        for r in prims) + f" to the plain codec, copy and decode | "
        f"launches {prim_launches} | {smi}")
    if not all(r["equal"] for r in prims):
        raise AssertionError(f"primitives apart from the plain composition: "
                             f"{prims}")
    # (c) stage 25's engine with qwZ and qgZ: every collective declines
    cfg = llama_7b(num_hidden_layers=8, remat=False, head_dtype="bfloat16")
    engine = deepspeed_tpu_torch.initialize(
        model=LlamaModel(cfg, device="meta"), config=dict(
            zero3["config"], zero_optimization=dict(
                ZERO3, zero_quantized_weights=True,
                zero_quantized_gradients=True)))[0]
    engine.initialize_parameters(seed)
    losses, times, launches, peak = _timed_steps(torch, engine,
                                                 zero3["batches"], 1, 3)
    digest = _digest(torch, engine,
                     engine.fp32_params()[:engine.zero_plan.numel])
    counts = engine.zeropp_dispatch_counts()
    variant = engine._micro_variant()
    del engine
    _free(torch)
    same = losses == zero3["losses"] and digest == zero3["digest"]
    log(f"[zeropp] (c) stage 25's ZeRO 3 with zero_quantized_weights and "
        f"zero_quantized_gradients at one rank ({variant}): losses "
        + ", ".join(f"{v:.4f}" for v in losses) + f"; losses and master "
        f"digest {'bit-equal' if same else 'DIFFER from'} stage 25's; "
        f"dispatch {counts}; launches {launches}; peak "
        f"{peak / 2**30:.2f} GiB (stage 25 {zero3['peak_bytes'] / 2**30:.2f})"
        f" | {smi}")
    if not same or launches != zero3["launches"] or not counts or \
            any(not k.endswith("/flat_fallback") for k in counts):
        raise AssertionError(f"ZeRO++ at one rank apart from stage 25: "
                             f"losses {losses} vs {zero3['losses']}, "
                             f"digest equal {digest == zero3['digest']}, "
                             f"dispatch {counts}")
    seconds = time.perf_counter() - t0
    log(f"[zeropp] stage 28 took {seconds:.1f} s")
    return dict(codecs=codecs, primitives=prims,
                primitive_launches=prim_launches,
                engine=dict(losses=losses, dispatch=counts, variant=variant,
                            launches=launches, peak_bytes=peak,
                            step_ms=[t * 1e3 for t in times]),
                seconds=seconds)


# --------------------------------------------------------------- stage 29
PIPE_LAYERS, PIPE_M = 4, 4


def _pipe_config():
    return {"train_micro_batch_size_per_gpu": 1,
            "gradient_accumulation_steps": PIPE_M,
            "optimizer": {"type": "fusedadam", "params": {"lr": 1e-4}},
            "bf16": {"enabled": True},
            "zero_optimization": {"stage": 1}}


def _pipe_steps(torch, engine, batches, steps, pipeline):
    """``steps`` optimizer steps on ``batches`` (a step's ``PIPE_M``
    microbatches), every launch counter set to 0 just before: (each
    step's loss, host seconds a step, launches)."""
    counters = _all_launches()
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    losses, times = [], []
    for _ in range(steps):
        t = time.perf_counter()
        if pipeline:
            loss = engine.train_batch(iter(batches))
        else:
            micro = []
            for x, y in batches:
                out = engine(x, y)
                engine.backward(out)
                engine.step()
                micro.append(out.detach().float())
            loss = torch.stack(micro).mean()
        losses.append(loss.item())
        times.append(time.perf_counter() - t)
    launches = {k: fn.launches for k, fn in counters.items() if fn.launches}
    return losses, times, launches


def stage_pipeline(seed, smi):
    """Stage 29: (a) Ulysses' ``DistributedAttention`` at sp = 1 at GPT-3
    13B width, forward and backward through B1, against the plain version;
    B1 at the sp = 2 shape against its plain version, SDPA and the bound;
    (b) the ``PipelineEngine`` at pp = 1 over NCCL against the base engine
    on the same module (module docstring)."""
    import numpy as np
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models.gpt2 import gpt3_13b, pipeline_module
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.sequence.layer import DistributedAttention
    t0 = time.perf_counter()
    _free(torch)
    cdb = deepspeed_tpu_torch.init_distributed(dist_backend="nccl")
    if cdb.name != "nccl" or comm.get_world_size() != 1:
        raise AssertionError(f"comm world {cdb.name}, "
                             f"{comm.get_world_size()} ranks")
    gen = torch.Generator(device="cuda").manual_seed(seed + 29)
    cfg = gpt3_13b(num_hidden_layers=PIPE_LAYERS)
    B, S, H, Dh = 1, 2048, cfg.num_attention_heads, cfg.head_dim
    # (a) DistributedAttention at sp = 1: the passthrough onto B1
    q, k, v, do = (torch.randn(B, S, H, Dh, device="cuda", generator=gen)
                   .to(torch.bfloat16) for _ in range(4))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    counters = _all_launches()
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    out = DistributedAttention()(q, k, v, causal=True)
    out.backward(do)
    torch.cuda.synchronize()
    launches_a = {n: fn.launches for n, fn in counters.items()
                  if fn.launches}
    want = dict(flash_attention_fwd=1, flash_attention_bwd_dq=1,
                flash_attention_bwd_dkv=1)
    if launches_a != want:
        raise AssertionError(f"DistributedAttention launched {launches_a}, "
                             f"want {want}")
    scale = Dh**-0.5
    with torch.no_grad():
        o, lse = fa.flash_attention_fwd(q, k, v, scale, causal=True)
        errs = {"o": _compare(torch, out, fa._plain_fwd(
            q, k, v, scale, causal=True)[0], "bf16")}
        same_o = torch.equal(out, o)
        dq_ref, delta = fa._plain_bwd_dq(q, k, v, o, do, lse, scale,
                                         causal=True)
        dk_ref, dv_ref = fa._plain_bwd_dkv(q, k, v, do, lse, delta, scale,
                                           causal=True)
        for name, got, ref in (("dq", q.grad, dq_ref), ("dk", k.grad, dk_ref),
                               ("dv", v.grad, dv_ref)):
            errs[name] = _compare(torch, got, ref, "bf16")
    log(f"[pipeline] (a) DistributedAttention, sp = 1, q/k/v [{B},{S},{H},"
        f"{Dh}] bf16 causal, forward and backward: launches {launches_a}; "
        f"output {'bit-equal to' if same_o else 'APART from'} B1's forward "
        f"on the same inputs; against the plain version (dq, dk, dv on the "
        f"kernel's o and lse): " + ", ".join(
            f"{n} {e:.2e} ({r:.3f})" for n, (e, r) in errs.items())
        + f" — max_abs_err (worst |err| / tol), tol 2^-7·|ref| + "
        f"{BF16_ATOL:g} | {smi}")
    if not same_o or any(not r <= 1.0 for _, r in errs.values()):
        raise AssertionError(f"DistributedAttention apart from B1's plain "
                             f"version: {errs}, same o {same_o}")
    del q, k, v, do, out, o, lse, dq_ref, dk_ref, dv_ref, delta
    _free(torch)
    # B1 at the shape Ulysses gives it at sp = 2: H/2 heads, the whole
    # sequence
    ulysses = _flash_case(torch, gen, "ulysses_sp2", B, S, S, H // 2, H // 2,
                          Dh, 0, "bfloat16", timed=True)
    _free(torch)
    # (b) the pipeline at pp = 1 over NCCL against the base engine
    rng = np.random.default_rng(seed + 290)
    batches = []
    for _ in range(PIPE_M):
        ids = rng.integers(0, cfg.vocab_size, size=(B, S))
        batches.append((torch.from_numpy(ids).cuda(),
                        torch.from_numpy(np.roll(ids, -1, axis=1)).cuda()))
    runs = {}
    for kind in ("pipeline", "base"):
        pm = pipeline_module(cfg, activation_checkpoint_interval=1)
        model = pm if kind == "pipeline" else pm.to_module(device="meta")
        engine = deepspeed_tpu_torch.initialize(
            model=model, config=_pipe_config(), dist_init_required=True)[0]
        engine.initialize_parameters(seed)
        losses, times, launches = _pipe_steps(torch, engine, batches, 3,
                                              kind == "pipeline")
        runs[kind] = dict(
            losses=losses, times=times, launches=launches,
            type=type(engine).__name__,
            digest=_digest(torch, engine,
                           engine.fp32_params()[:engine.zero_plan.numel]),
            params=engine.zero_plan.numel,
            peak=torch.cuda.max_memory_allocated())
        del engine
        _free(torch)
    p, b = runs["pipeline"], runs["base"]
    same = p["losses"] == b["losses"] and p["digest"] == b["digest"]
    L, steps = PIPE_LAYERS, len(p["losses"])
    want = dict(flash_attention_fwd=2 * L * PIPE_M * steps,  # remat
                flash_attention_bwd_dq=L * PIPE_M * steps,
                flash_attention_bwd_dkv=L * PIPE_M * steps,
                fused_adam_step=steps)
    log(f"[pipeline] (b) GPT-3 13B width, {L} blocks, tied embedding and "
        f"head, {p['params']:,} parameters, S={S}, M={PIPE_M} microbatches "
        f"of {B}, ZeRO 1, bf16, fusedadam, remat, NCCL world 1: "
        f"{p['type']} (pp = 1) losses " + ", ".join(
            f"{x:.6f}" for x in p["losses"]) + f"; the base engine on "
        f"to_module() " + ", ".join(f"{x:.6f}" for x in b["losses"])
        + f"; losses and master digest "
        f"{'bit-equal' if same else 'DIFFER'} | step ms " + ", ".join(
            f"{t * 1e3:.1f}" for t in p["times"]) + f" (base " + ", ".join(
            f"{t * 1e3:.1f}" for t in b["times"]) + f") | launches "
        f"{p['launches']} | {smi}")
    if p["type"] != "PipelineEngine" or not same or \
            not all(np.isfinite(p["losses"])):
        raise AssertionError(f"pipeline at pp = 1 apart from the base "
                             f"engine: {p['losses']} vs {b['losses']}, "
                             f"digest equal {p['digest'] == b['digest']}")
    if p["launches"] != want or b["launches"] != want:
        raise AssertionError(f"launches {p['launches']} (base "
                             f"{b['launches']}), want {want}")
    seconds = time.perf_counter() - t0
    log(f"[pipeline] stage 29 took {seconds:.1f} s")
    return dict(attention=dict(launches=launches_a,
                               errs={n: e for n, (e, _) in errs.items()}),
                ulysses=ulysses, pipeline=p, base=b, seconds=seconds)


# ----------------------------------------------------------- stage 32
PIPE_ZERO = {
    "zero3": {"stage": 3},
    "zero2_overlap": {"stage": 2, "overlap_comm": True},
    "zero1_offload": {"stage": 1, "offload_optimizer": {"device": "cpu"}},
}


def stage_pipeline_zero(seed, smi):
    """Stage 32: the ``PipelineEngine`` at pp = 1 under ZeRO 3, bucketed
    ZeRO 2 and optimizer offload against the base engine, and a resume of
    the ZeRO-3 pipeline from its tag (module docstring)."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models.gpt2 import gpt3_13b, pipeline_module
    t0 = time.perf_counter()
    _free(torch)
    deepspeed_tpu_torch.init_distributed(dist_backend="nccl")
    if comm.get_world_size() != 1:
        raise AssertionError(f"{comm.get_world_size()} ranks")
    cfg = gpt3_13b(num_hidden_layers=PIPE_LAYERS)
    B, S, L = 1, 2048, PIPE_LAYERS
    rng = np.random.default_rng(seed + 290)      # stage 29 (b)'s batches
    batches = []
    for _ in range(PIPE_M):
        ids = rng.integers(0, cfg.vocab_size, size=(B, S))
        batches.append((torch.from_numpy(ids).cuda(),
                        torch.from_numpy(np.roll(ids, -1, axis=1)).cuda()))

    def make(kind, zero):
        pm = pipeline_module(cfg, activation_checkpoint_interval=1)
        model = pm if kind == "pipeline" else pm.to_module(device="meta")
        engine = deepspeed_tpu_torch.initialize(
            model=model, config=dict(_pipe_config(), zero_optimization=zero),
            dist_init_required=True)[0]
        engine.initialize_parameters(seed)
        return engine

    def digest(engine):
        flat = engine.fp32_params()[:engine.zero_plan.numel]
        return _digest(torch, engine, flat.to("cuda"))

    def want(steps):
        return dict(flash_attention_fwd=2 * L * PIPE_M * steps,  # remat
                    flash_attention_bwd_dq=L * PIPE_M * steps,
                    flash_attention_bwd_dkv=L * PIPE_M * steps,
                    fused_adam_step=steps)

    save_dir = tempfile.mkdtemp(prefix="ds_pipe_ckpt_")
    runs, resume = {}, None
    try:
        for name, zero in PIPE_ZERO.items():
            pair = {}
            for kind in ("pipeline", "base"):
                torch.cuda.reset_peak_memory_stats()
                engine = make(kind, zero)
                pipeline = kind == "pipeline"
                if name == "zero3" and pipeline:
                    losses, times, launches = _pipe_steps(
                        torch, engine, batches, 2, True)
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    engine.save_checkpoint(save_dir, tag="t")
                    save_s = time.perf_counter() - t
                    more, more_t, more_l = _pipe_steps(torch, engine,
                                                       batches, 1, True)
                    losses, times = losses + more, times + more_t
                    launches = {k: launches.get(k, 0) + more_l.get(k, 0)
                                for k in set(launches) | set(more_l)}
                else:
                    losses, times, launches = _pipe_steps(
                        torch, engine, batches, 3, pipeline)
                pair[kind] = dict(
                    losses=losses, times=times, launches=launches,
                    type=type(engine).__name__, digest=digest(engine),
                    params=engine.zero_plan.numel,
                    placement=engine.state_placement(),
                    peak=torch.cuda.max_memory_allocated())
                del engine
                _free(torch)
                if name == "zero3" and pipeline:
                    root = os.path.join(save_dir, "t")
                    files = {f: os.path.getsize(os.path.join(root, f))
                             for f in sorted(os.listdir(root))}
                    fresh = deepspeed_tpu_torch.initialize(
                        model=pipeline_module(
                            cfg, activation_checkpoint_interval=1),
                        config=dict(_pipe_config(), zero_optimization=zero),
                        dist_init_required=True)[0]
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    fresh.load_checkpoint(save_dir)
                    torch.cuda.synchronize()
                    load_s = time.perf_counter() - t
                    r_losses, _, r_launches = _pipe_steps(torch, fresh,
                                                          batches, 1, True)
                    resume = dict(save_s=save_s, load_s=load_s,
                                  files=files, tag_bytes=sum(files.values()),
                                  losses=r_losses, launches=r_launches,
                                  digest=digest(fresh))
                    del fresh
                    _free(torch)
                    shutil.rmtree(root, ignore_errors=True)
            p, b = pair["pipeline"], pair["base"]
            same = p["losses"] == b["losses"] and p["digest"] == b["digest"]
            log(f"[pipeline-zero] {name} ({zero}): GPT-3 13B width, {L} "
                f"blocks, {p['params']:,} parameters, S={S}, M={PIPE_M} "
                f"microbatches of {B}, bf16, fusedadam, remat, NCCL world "
                f"1: {p['type']} (pp = 1) losses " + ", ".join(
                    f"{x:.6f}" for x in p["losses"]) + "; the base engine "
                "on to_module() " + ", ".join(
                    f"{x:.6f}" for x in b["losses"]) + f"; losses and "
                f"master digest {'bit-equal' if same else 'DIFFER'} | step "
                f"ms " + ", ".join(f"{t * 1e3:.1f}" for t in p["times"])
                + " (base " + ", ".join(f"{t * 1e3:.1f}" for t in b["times"])
                + f") | peak {p['peak'] / 2**30:.2f} GiB (base "
                f"{b['peak'] / 2**30:.2f}) | state {p['placement']} | "
                f"launches {p['launches']} (base {b['launches']}) | {smi}")
            if p["type"] != "PipelineEngine" or not same or \
                    not all(np.isfinite(p["losses"])):
                raise AssertionError(
                    f"{name}: the pipeline apart from the base engine: "
                    f"{p['losses']} vs {b['losses']}, digest equal "
                    f"{p['digest'] == b['digest']}")
            if p["launches"] != want(3) or b["launches"] != want(3):
                raise AssertionError(f"{name}: launches {p['launches']} "
                                     f"(base {b['launches']}), want "
                                     f"{want(3)}")
            if name == "zero1_offload" and \
                    p["placement"].get("master") != "host":
                raise AssertionError(f"{name}: state {p['placement']}")
            runs[name] = pair
    finally:
        shutil.rmtree(save_dir, ignore_errors=True)
    z3 = runs["zero3"]["pipeline"]
    ok = (resume["losses"] == z3["losses"][2:] and
          resume["digest"] == z3["digest"] and resume["launches"] == want(1))
    log(f"[pipeline-zero] zero3 resume: save after step 2 "
        f"{resume['save_s']:.2f} s, {resume['tag_bytes'] / 1e9:.2f} GB ("
        + ", ".join(f"{f} {n:,} B" for f, n in resume["files"].items())
        + f"); load {resume['load_s']:.2f} s; step 3 from the tag "
        f"{resume['losses']} against the unbroken run's {z3['losses'][2:]}"
        f", master digest {'equal' if ok else 'DIFFERS'}; launches "
        f"{resume['launches']} | {smi}")
    if not ok:
        raise AssertionError(f"the resumed ZeRO-3 pipeline left the "
                             f"unbroken run: {resume}")
    seconds = time.perf_counter() - t0
    log(f"[pipeline-zero] stage 32 took {seconds:.1f} s")
    return dict(runs=runs, resume=resume, seconds=seconds)


# ----------------------------------------------------------- stage 30
def _state_digests(torch, tensors):
    """A digest a tensor (bits × place, wrapping in int64), to tell
    whether a state changed without keeping a copy of it."""
    out = []
    for t in tensors:
        v = t.detach().reshape(-1)
        v = v.view(torch.int32) if v.element_size() == 4 else \
            v.view(torch.int16).to(torch.int32)
        acc = 0
        for i in range(0, v.numel(), 1 << 26):
            c = v[i:i + (1 << 26)].to(torch.int64)
            w = torch.arange(i, i + c.numel(), device=c.device,
                             dtype=torch.int64) % 65521 + 1
            acc = (acc + int((c * w).sum().item())) % (1 << 63)
        out.append(acc)
    return out


def _universal_bridge(torch, seed, smi):
    """Stage 30 (a): a streamed engine's tag → universal → a ZeRO-3 engine
    on the card, and → a streamed engine again; each resumed run's next
    two losses against the streamed engine that did not stop."""
    import shutil
    import tempfile
    import numpy as np
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.checkpoint import convert_to_universal
    from deepspeed_tpu_torch.models.llama import LlamaModel, llama_7b
    B, S, L = 4, 2048, 2
    cfg = llama_7b(num_hidden_layers=L, dtype="bfloat16",
                   head_dtype="bfloat16")
    streamed = {"stage": 3, "offload_param": {"device": "cpu"},
                "offload_optimizer": {"device": "cpu"}}
    rng = np.random.default_rng(seed + 30)
    batches = [(ids, ids) for ids in (torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(B, S))).cuda() for _ in range(4))]

    def build(zero, universal=False):
        config = dict(TRAIN_CONFIG, zero_optimization=zero)
        if universal:
            config["checkpoint"] = {"load_universal": True}
        return deepspeed_tpu_torch.initialize(
            model=LlamaModel(cfg, device="meta"), config=config)[0]

    root = tempfile.mkdtemp(prefix="ds_universal_")
    out = {}
    try:
        src = build(streamed)
        src.initialize_parameters(seed)
        first, _ = _counted_steps(torch, src, batches[:2])
        t0 = time.perf_counter()
        src.save_checkpoint(os.path.join(root, "tag"), tag="t")
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        convert_to_universal(os.path.join(root, "tag"),
                             os.path.join(root, "uni"), tag="t")
        convert_s = time.perf_counter() - t0
        files = sum(os.path.getsize(os.path.join(d, f))
                    for d, _, fs in os.walk(os.path.join(root, "uni"))
                    for f in fs)
        want, _ = _counted_steps(torch, src, batches[2:])
        del src
        _free_all(torch, "the streamed source")
        for name, zero in (("zero3", {"stage": 3}), ("streamed", streamed)):
            eng = build(zero, universal=True)
            t0 = time.perf_counter()
            eng.load_checkpoint(os.path.join(root, "uni"))
            load_s = time.perf_counter() - t0
            got, launches = _counted_steps(torch, eng, batches[2:])
            rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
            log(f"[universal] Llama-2-7B width, {L} blocks, bf16: a "
                f"streamed tag ({save_s:.1f} s to save, {convert_s:.1f} s "
                f"to convert, {files / 1e9:.2f} GB of universal files) "
                f"loaded into {name} in {load_s:.1f} s: next losses "
                + ", ".join(f"{x:.6f}" for x in got) + " against the "
                "streamed engine that did not stop " + ", ".join(
                    f"{x:.6f}" for x in want)
                + f"; largest relative difference {rel:.2e} (limit 2e-3); "
                f"launches {launches} | {smi}")
            if rel > 2e-3 or not all(np.isfinite(got)):
                raise AssertionError(f"universal → {name}: {got} vs {want}")
            if launches.get("flash_attention_fwd", 0) < L * 2:
                raise AssertionError(f"universal → {name}: B1 not launched "
                                     f"({launches})")
            out[name] = dict(losses=got, launches=launches, load_s=load_s,
                             max_rel=rel)
            del eng
            _free_all(torch, f"the {name} engine")
        out.update(reference=want, first=first, save_s=save_s,
                   convert_s=convert_s, universal_bytes=files)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def _onebit_codec(torch, seed, smi):
    """Stage 30 (b): the 1-bit codec on a 7B-width block's flat buffer,
    bit-equal to the same functions on the CPU copy."""
    from deepspeed_tpu_torch.runtime.comm import compressed as c
    gen = torch.Generator(device="cuda").manual_seed(seed + 301)
    x = torch.randn(BLOCK_7B, generator=gen, device="cuda")
    err = torch.randn(BLOCK_7B, generator=gen, device="cuda") * 0.1
    bits = x >= 0
    dev = dict(packed=c.pack_signs(bits))
    dev["unpacked"] = c.unpack_signs(dev["packed"])
    (dev["corrected"], dev["scale"], dev["packed2"],
     dev["error"]) = c.compress(x, err)
    torch.cuda.synchronize()
    xc, ec = x.cpu(), err.cpu()
    host = dict(packed=c.pack_signs(xc >= 0))
    host["unpacked"] = c.unpack_signs(host["packed"])
    (host["corrected"], host["scale"], host["packed2"],
     host["error"]) = c.compress(xc, ec)
    equal = {k: bool(torch.equal(dev[k].cpu(), host[k])) for k in dev}
    ms = dict(pack=cuda_ms(lambda: c.pack_signs(bits), 5),
              unpack=cuda_ms(lambda: c.unpack_signs(dev["packed"]), 5),
              compress=cuda_ms(lambda: c.compress(x, err), 5))
    n = BLOCK_7B
    # bytes each must move, read once and written once
    moved = dict(pack=n + n // 8, unpack=n // 8 + 4 * n,
                 compress=8 * n + 8 * n + n // 8)
    bound = {k: v / HBM_BYTES_PER_S * 1e3 for k, v in moved.items()}
    log(f"[onebit] codec on {n:,} fp32 elements (a 7B block): card vs CPU "
        f"bit-equal {equal}; scale {float(dev['scale']):.9g} | ms "
        + ", ".join(f"{k} {v:.3f} (bytes bound {bound[k]:.3f})"
                    for k, v in ms.items()) + f" | {smi}")
    if not all(equal.values()):
        raise AssertionError(f"1-bit codec: card and CPU differ {equal}")
    del x, err, bits, dev
    _free(torch)
    return dict(equal=equal, ms=ms, bound_ms=bound, elements=n)


ONEBIT_CONFIGS = {
    "onebitadam": {"lr": 1e-4, "freeze_step": 2},
    "onebitlamb": {"lr": 1e-3, "freeze_step": 2},
    "zerooneadam": {"lr": 1e-4, "var_freeze_step": 2,
                    "local_step_scaler": 2, "var_update_scaler": 1},
}


def _onebit_optimizers(torch, seed, smi):
    """Stage 30 (c): the three 1-bit optimizers through ``initialize()``
    at one rank on GPT-2 350M in fp16, 5 steps each, then an injected
    overflow that must leave every piece of state as it was."""
    import numpy as np
    out = {}
    for name, params in ONEBIT_CONFIGS.items():
        engine, cfg = _gpt2_engine(torch, seed, config_over={
            "optimizer": {"type": name, "params": params}})
        ids = torch.from_numpy(np.random.default_rng(seed + 302).integers(
            0, cfg.vocab_size, size=(8, 1024))).cuda()
        losses, launches = _counted_steps(torch, engine, [(ids, ids)] * 5)
        st = engine.opt_state
        state = [engine.fp32_params(), engine.params, st.exp_avg,
                 st.exp_avg_sq, st.worker_error, st.server_error,
                 *st.extra.values()]
        before = _state_digests(torch, state) + [st.count,
                                                 engine.global_steps]
        skipped, scale = engine.skipped_steps, engine.cur_scale
        gnorm = float(engine._last_gnorm)
        loss = engine(ids, ids)
        engine.backward(loss)
        engine.grad_acc[3] = float("inf")
        engine.step()
        after = _state_digests(torch, state) + [st.count,
                                                engine.global_steps - 1]
        kept = before == after and engine.skipped_steps == skipped + 1 \
            and engine.cur_scale <= scale
        log(f"[onebit] {name} {params}, GPT-2 350M fp16, B=8 S=1024, one "
            f"rank, 5 steps: losses " + ", ".join(
                f"{x:.4f}" for x in losses)
            + f"; skipped {skipped}; the synced momentum's norm "
            f"{gnorm:.4g}; launches {launches}; an "
            f"injected overflow kept every piece of state: {kept} | {smi}")
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise AssertionError(f"{name}: losses {losses}")
        if launches.get("flash_attention_fwd", 0) == 0 or any(
                k.startswith("fused_") for k in launches):
            raise AssertionError(f"{name}: launches {launches}")
        if not kept:
            raise AssertionError(f"{name}: the overflow changed the state "
                                 f"({before} → {after})")
        out[name] = dict(losses=losses, launches=launches, kept=kept,
                         skipped=skipped)
        del engine, st, state
        _free(torch)
    return out


def stage_universal_onebit(seed, smi):
    """Stage 30: (a) the universal bridge of a streamed tag on the card,
    (b) the 1-bit codec, card against CPU, (c) the 1-bit optimizers."""
    import torch
    _free_all(torch, "the earlier stages")
    t0 = time.perf_counter()
    out = dict(universal=_universal_bridge(torch, seed, smi),
               codec=_onebit_codec(torch, seed, smi),
               optimizers=_onebit_optimizers(torch, seed, smi))
    out["seconds"] = time.perf_counter() - t0
    log(f"[stage 30] {out['seconds']:.1f} s")
    return out


# --------------------------------------------------------------- stage 31
MIXTRAL_TRAIN = dict(vocab_size=32000, hidden_size=4096,
                     intermediate_size=14336, num_attention_heads=32,
                     num_key_value_heads=8, max_position_embeddings=4096,
                     rms_norm_eps=1e-5, rope_theta=1e6, num_local_experts=8,
                     num_experts_per_tok=2, dtype="bfloat16",
                     head_dtype="bfloat16", remat=True)


def _routed_sizes(torch, gen, tokens, E, k, empty):
    """Group sizes of ``tokens`` × k copies routed by a random router over
    E experts, expert ``empty`` never chosen."""
    logits = torch.randn(tokens, E, device="cuda", generator=gen)
    logits[:, empty] = -float("inf")
    topi = torch.topk(logits, k, dim=-1).indices.reshape(-1)
    return torch.bincount(topi, minlength=E).tolist()


def _grouped_mm_ms(torch, kind, a, b, gs, name):
    """``torch._grouped_mm``'s time on the same product (a yardstick the
    port never calls), or None where this torch has none or refuses."""
    grouped = getattr(torch, "_grouped_mm", None)
    if grouped is None:
        return None, "none in this torch"
    offs = torch.cumsum(gs, 0, dtype=torch.int32)
    try:
        if kind == "dx":
            fn = lambda: grouped(a, b.transpose(1, 2), offs=offs)  # noqa
        else:
            fn = lambda: grouped(a.t(), b, offs=offs)  # noqa: E731
        fn()
    except RuntimeError as e:
        log(f"[moe-train] torch._grouped_mm refused {name}: "
            f"{str(e).splitlines()[0][:120]}")
        return None, "refused"
    return cuda_ms(fn, 5), "torch._grouped_mm"


def _gmm_bwd_case(torch, gen, kind, proj, sizes, K, N, route=None,
                  rows=None):
    """One backward kernel of B7 at Mixtral's width, on ``route`` (default
    :func:`gmm_bwd_route`'s): against its plain version (one bf16 ulp of
    |ref| + 2^-10 of its rms), two launches bit-equal, its time beside the
    plain version's, ``torch._grouped_mm``'s and the bound, and its SASS
    counts.  ``rows``: the inputs' rows where more than the sizes' sum
    (random past it: dx must be zero there, dw must not read them)."""
    from deepspeed_tpu_torch.ops.kernels import grouped_matmul as gm
    from deepspeed_tpu_torch.ops.op_builder import GroupedMatmulBuilder
    dt = torch.bfloat16
    live, E = sum(sizes), len(sizes)
    T = rows or live
    gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
    dy = torch.randn(T, N, device="cuda", generator=gen).to(dt)
    # the live rows read, every output element written
    if kind == "dx":
        w = (torch.randn(E, K, N, device="cuda", generator=gen)
             / K**0.5).to(dt)
        a, b, fn, plain = dy, w, gm.gmm_dx, gm.gmm_dx_plain
        nbytes = (live * N + sum(1 for n in sizes if n) * K * N
                  + T * K) * 2
    else:
        x = torch.randn(T, K, device="cuda", generator=gen).to(dt)
        a, b, fn, plain = x, dy, gm.gmm_dw, gm.gmm_dw_plain
        nbytes = (live * K + live * N + E * K * N) * 2
    route = route or gm.gmm_bwd_route(kind, T, K, N, dt, a.data_ptr(),
                                      b.data_ptr())
    before = dict(fn.route_launches)
    got, again = fn(a, b, gs, route), fn(a, b, gs, route)
    torch.cuda.synchronize()
    taken = {r: n - before[r] for r, n in fn.route_launches.items()
             if n != before[r]}
    if taken != {route: 2}:
        raise AssertionError(f"gmm_{kind} {proj}: launches by route "
                             f"{taken}, want 2 on {route}")
    bit_equal = torch.equal(got, again)
    dead_zero = kind != "dx" or bool((got[live:] == 0).all())
    ref = plain(a, b, gs).float()
    # both sum thousands of fp32 products, in other orders, then round
    # once to bf16: one bf16 ulp of |ref| plus the fp32 order's spread,
    # held at 2^-10 of the product's rms (a row dropped or doubled moves
    # every element of its expert by about the rms over sqrt(rows))
    atol = 2.0**-10 * ref.square().mean().sqrt().item()
    diff = (got.float() - ref).abs()
    err = diff.max().item()
    worst = (diff / (BF16_RTOL * ref.abs() + atol)).max().item()
    del again, ref, diff
    ms = cuda_ms(lambda: fn(a, b, gs, route), 5)
    plain_ms = cuda_ms(lambda: plain(a, b, gs), 1, warmup=1)
    lib_ms, lib = _grouped_mm_ms(torch, kind, a, b, gs, f"{kind} {proj}")
    # gmm_dx's time includes the zero fill of dx (rows past the sizes stay
    # zero): the fill alone, on the same shape
    fill_ms = (cuda_ms(lambda: torch.zeros(T, K, dtype=dt, device="cuda"), 5)
               if kind == "dx" else None)
    flops = 2 * live * K * N
    bound = _roofline(nbytes, flops, BF16_FLOPS)
    ops = (" HGMMA.", " UTMALDG")
    if kind == "dx":
        key_fn, key = _gmm_dx_key, ("bf16", 2 if route == "wgmma_tma" else 1)
    elif route == "wgmma_tma":
        key_fn, key = _gmm_dw_key, ("bf16", "wgmma_tma")
    else:
        # PR 19's mma.sync dw, with 16-byte copies where the shapes and
        # addresses allow them
        key_fn, ops = _gmm_dw_key, (" HMMA.",)
        key = ("bf16", "mma_sync", K % 8 == 0 and N % 8 == 0 and
               a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0)
    report, counts = _kernel_report(GroupedMatmulBuilder(), key_fn, key, ops)
    case = f"{kind}_{proj}" + (f"_{route}" if route == "mma_sync" else "")
    row = dict(case=case, kind=kind, route=route, rows=T, live_rows=live,
               dead_rows_zero=dead_zero, K=K,
               N=N, sizes=sizes, err=err, err_over_tol=worst, atol=atol,
               bit_equal=bit_equal, ms=ms, plain_ms=plain_ms,
               zero_fill_ms=fill_ms, library_ms=lib_ms, library=lib,
               bound_ms=bound[0], bound_by=bound[1], tflops=flops / ms / 1e9,
               share_of_bound=bound[0] / ms, kernel=report)
    past = ""
    if T > live:
        past = f", {T - live} rows past them" + (
            f", dx zero there {dead_zero}" if kind == "dx" else "")
    log(f"[moe-train] gmm_{kind} {proj}: T {T} (groups {sizes}{past}), K "
        f"{K}, N {N}, route {route}: max_abs_err {err:.3e}, worst |err| / "
        f"(2^-7·|ref| + {atol:.3g}, 2^-10 of the rms) {worst:.3f}, reruns "
        f"bit-equal "
        f"{bit_equal} | kernel {ms:.4f} ms ({row['tflops']:.1f} TFLOP/s, "
        f"{row['share_of_bound']:.3f} of the bound), plain {plain_ms:.4f} "
        f"ms, {lib} {lib_ms} ms"
        + ("" if fill_ms is None else f", dx's zero fill {fill_ms:.4f} ms")
        + f" | bound {bound[0]:.4f} ms by {bound[1]} | "
        f"{report['registers']} registers, {report['spill_stores']} B "
        f"spills, SASS " + " / ".join(f"{n} {op.strip(' .')}"
                                      for op, n in zip(ops, counts)))
    if not (worst <= 1.0 and bit_equal and all(counts) and dead_zero):
        raise AssertionError(f"gmm_{kind} {proj}: worst {worst}, bit-equal "
                             f"{bit_equal}, SASS {counts}, rows past the "
                             f"sizes zero {dead_zero}")
    return row


def _mixtral_parameters(torch, cfg, seed, gate_std):
    """Random fp32 weights of a MixtralModel (``init_leaf``'s normal(0,
    0.02) and unit norms), the router at ``gate_std`` so that its top-2
    choices are decided."""
    from deepspeed_tpu_torch.models.llama import init_leaf
    from deepspeed_tpu_torch.models.mixtral import MixtralModel
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = {}
    for name, p in MixtralModel(cfg, device="meta").named_parameters():
        t = torch.empty(p.shape, dtype=torch.float32, device="cuda")
        init_leaf(name, t, gen)
        if name.endswith("block_sparse_moe.gate"):
            t.normal_(0.0, gate_std, generator=gen)
        out[name] = t
    return out


def _mixtral_step_vs_plain(torch, seed):
    """One step at a narrow width (hidden 1024, FFN 2048, 8 experts, 2
    layers, B=2, S=512) from the same weights three ways: bf16 with the
    kernels, bf16 with every plain version, and fp32 with the plain
    versions (the reference both bf16 runs are measured against)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.mixtral import (MixtralConfig,
                                                    MixtralModel)
    narrow = dict(MIXTRAL_TRAIN, vocab_size=8192, hidden_size=1024,
                  intermediate_size=2048, num_attention_heads=8,
                  num_key_value_heads=2, num_hidden_layers=2, remat=False)
    ids = torch.from_numpy(__import__("numpy").random.default_rng(
        seed + 31).integers(0, narrow["vocab_size"], size=(2, 512))).cuda()
    res = {}
    for run, use_kernel, dtype in (("kernels", True, "bfloat16"),
                                   ("plain", False, "bfloat16"),
                                   ("fp32", False, "float32")):
        cfg = MixtralConfig(**dict(narrow, dtype=dtype, head_dtype=dtype))
        config = dict(TRAIN_CONFIG, train_micro_batch_size_per_gpu=2)
        if dtype == "float32":
            config.pop("bf16")
        start = _mixtral_parameters(torch, cfg, seed + 32,
                                    cfg.hidden_size ** -0.5)
        eng = deepspeed_tpu_torch.initialize(
            model=MixtralModel(cfg, device="meta"), model_parameters=start,
            config=config)[0]
        del start
        loss = eng(ids, ids, use_kernel=use_kernel)
        eng.backward(loss)
        grad = eng.grad_acc.float().clone()
        layout = eng._layout
        eng.step(use_kernel=use_kernel)
        res[run] = (loss.item(), float(eng._last_gnorm), grad)
        del eng, loss
        _free(torch)
    (lk, nk, gk), (lp, npl, gp), (_, _, g32) = (res["kernels"],
                                                 res["plain"], res["fp32"])
    loss_rel, norm_rel = abs(lk - lp) / abs(lp), abs(nk - npl) / npl

    def err(g, o, n):
        return ((g[o:o + n] - g32[o:o + n]).norm() /
                g32[o:o + n].norm().clamp_min(1e-30)).item()

    leaves = [(err(gk, o, n), err(gp, o, n), name)
              for name, o, n, _ in layout]
    excess, worst = max((ek - 2 * ep, (ek, ep, name))
                        for ek, ep, name in leaves)
    log(f"[moe-train] narrow step, kernels vs plain (bf16): loss {lk:.6f} "
        f"vs {lp:.6f} (rel {loss_rel:.2e}, tol 2^-7), grad norm {nk:.6f} "
        f"vs {npl:.6f} (rel {norm_rel:.2e}, tol 2^-7); each leaf's "
        f"gradient against the fp32 step's, ||Δ|| / ||g||: worst leaf "
        f"{worst[2]} kernels {worst[0]:.2e}, plain {worst[1]:.2e} (tol "
        f"2 × plain + 2^-7)")
    # bf16 rounds activations and gradients, and a token whose top-2
    # scores nearly tie may go to another expert: the router's gradient,
    # a sum over tokens that cancels, moves by several percent between two
    # bf16 runs.  So each leaf is held against the fp32 step: the kernels'
    # error may not exceed twice the plain bf16 run's (plus 2^-7), where a
    # wrong kernel is off by a large part of the gradient
    if not (loss_rel <= 2.0**-7 and norm_rel <= 2.0**-7 and
            excess <= 2.0**-7):
        raise AssertionError("Mixtral step: kernels differ from the plain "
                             "path beyond tolerance")
    return dict(loss=(lk, lp), grad_norm=(nk, npl), loss_rel=loss_rel,
                norm_rel=norm_rel, worst_leaf=worst[2],
                worst_leaf_err_kernels=worst[0],
                worst_leaf_err_plain=worst[1],
                leaf_errs={name: (ek, ep) for ek, ep, name in leaves})


def _moe_layer_nccl(torch, seed, smi):
    """(c) The MoE layer (the shape of ``zero_multicard.py --moe``) in
    engine steps on the NCCL world of one rank, with ``moe`` off and with
    ``quantized_dispatch`` on: at ep 1 nothing is exchanged, so the runs
    are bit-equal, as in JAX."""
    import numpy as np
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm
    from zero_multicard import moe_layer_model
    cdb = deepspeed_tpu_torch.init_distributed(dist_backend="nccl")
    if cdb.name != "nccl" or comm.get_world_size() != 1:
        raise AssertionError(f"comm world {cdb.name}, "
                             f"{comm.get_world_size()} ranks")
    D, T, steps = 4096, 8192, 2
    rng = np.random.default_rng(seed + 33)
    x = torch.from_numpy(rng.standard_normal((T, D)).astype(
        np.float32)).cuda()
    y = torch.tanh(x * 0.5)
    runs = {}
    for name, moe in (("flat", {"enabled": False}),
                      ("int8", {"enabled": True, "quantized_dispatch": True,
                                "wire_dtype": "int8"})):
        model, start = moe_layer_model(torch, D, seed + 34)
        eng = deepspeed_tpu_torch.initialize(
            model=model, model_parameters=start, config=dict(
                TRAIN_CONFIG, train_micro_batch_size_per_gpu=T, moe=moe))[0]
        del start
        losses, times = [], []
        for _ in range(steps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss = eng(x, y)
            eng.backward(loss)
            eng.step()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            losses.append(loss.item())
        runs[name] = dict(losses=losses, step_ms=[t * 1e3 for t in times],
                          master=eng.master.clone())
        del eng, model
        _free(torch)
    same = runs["flat"]["losses"] == runs["int8"]["losses"] and \
        torch.equal(runs["flat"]["master"], runs["int8"]["master"])
    for r in runs.values():
        r.pop("master")
    log(f"[moe-train] MoE layer (hidden {D}, 8 experts of 4×{D}, top-2, "
        f"cf 1.25, {T} tokens, bf16) on NCCL world 1: losses "
        f"{runs['flat']['losses']} flat, {runs['int8']['losses']} with "
        f"int8 quantized_dispatch (bit-equal {same}); step ms "
        f"{runs['flat']['step_ms']} | {smi}")
    if not same or not all(np.isfinite(runs["flat"]["losses"])):
        raise AssertionError(f"MoE layer at ep 1: quantized_dispatch "
                             f"changed the run: {runs}")
    return dict(runs=runs, bit_equal=same)


def stage_moe_train_kernels(seed):
    """Stage 31 (a): B7's dx and dw at Mixtral-8x7B's products (T = 16,384
    token copies routed over 8 experts, one empty), each against its plain
    version, and w1's dw once more on the mma.sync route (the kernel of the
    16-bit shapes TMA cannot take); the list of ``_gmm_bwd_case`` rows
    (``kernel_ab.py`` runs this alone)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed + 31)
    B, S, D, I, E, k = 4, 2048, 4096, 14336, 8, 2
    sizes = _routed_sizes(torch, gen, B * S, E, k, empty=2)
    rows = []
    for kind in ("dx", "dw"):
        for proj, K, N in (("w1", D, I), ("w2", I, D)):
            rows.append(_gmm_bwd_case(torch, gen, kind, proj, sizes, K, N))
            _free(torch)
    rows.append(_gmm_bwd_case(torch, gen, "dw", "w1", sizes, D, I,
                              "mma_sync"))
    _free(torch)
    return rows


def stage_moe_train(seed, smi):
    """Stage 31: B7's backward kernels at Mixtral-8x7B's width, Mixtral
    training at full width cut to one layer, a narrow step against every
    plain version, and the MoE layer on one NCCL rank."""
    import numpy as np
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.mixtral import (MixtralConfig,
                                                    MixtralModel,
                                                    param_count)
    from deepspeed_tpu_torch.ops.kernels import grouped_matmul as gm
    t_stage = time.perf_counter()
    B, S, D, I, E, k = 4, 2048, 4096, 14336, 8, 2
    rows = stage_moe_train_kernels(seed)
    sizes = rows[0]["sizes"]
    # (b) Mixtral-8x7B width, one layer, through initialize()
    cfg = MixtralConfig(**dict(MIXTRAL_TRAIN, num_hidden_layers=1))
    L = cfg.num_hidden_layers
    t0 = time.perf_counter()
    engine = deepspeed_tpu_torch.initialize(
        model=MixtralModel(cfg, device="meta"), config=dict(TRAIN_CONFIG))[0]
    engine.initialize_parameters(seed)
    torch.cuda.synchronize()
    n_total = param_count(cfg)
    n_active = n_total - L * (E - k) * 3 * D * I
    log(f"[moe-train] Mixtral-8x7B width, {L} layer, {n_total:,} params "
        f"({n_active:,} active a token), bf16 + fp32 master/moments/grad "
        f"accumulator: {torch.cuda.memory_allocated() / 2**30:.2f} GiB of "
        f"state, built in {time.perf_counter() - t0:.1f} s")
    ids = torch.from_numpy(np.random.default_rng(seed + 31).integers(
        0, cfg.vocab_size, size=(B, S))).cuda()
    steps = 4
    for fn in ("gmm", "gmm_dx", "gmm_dw"):
        getattr(gm, fn).route_launches = dict.fromkeys(
            getattr(gm, fn).route_launches, 0)
    losses, times, launches, peak = _timed_steps(torch, engine, [(ids, ids)],
                                                 1, steps - 1)
    routes = {fn: {r: n for r, n in getattr(gm, fn).route_launches.items()
                   if n} for fn in ("gmm", "gmm_dx", "gmm_dw")}
    for fn, by_route in routes.items():
        if sum(by_route.values()) != launches.get(fn, 0):
            raise AssertionError(f"{fn}: launches by route {by_route} do "
                                 f"not sum to its {launches.get(fn, 0)}")
    step_s, tok_s, tflops, mfu, flops_tok = _rates(n_active, L, S, D, B * S,
                                                   times, BF16_FLOPS)
    log(f"[moe-train] losses {losses} | step ms "
        + ", ".join(f"{t * 1e3:.1f}" for t in times)
        + f" | mean {step_s * 1e3:.1f} ms, {tok_s:.1f} tokens/s, MFU "
        f"{mfu:.4f} on the active parameters ({flops_tok / 1e9:.2f} "
        f"GFLOP/token = 6·N_active + 12·L·S·D, N_active = N − L·(E−k)·3·D·I"
        f"; 989 TFLOP/s) | peak memory {peak / 2**30:.2f} GiB | {smi}")
    log(f"[moe-train] launches in the {steps} steps: {launches}")
    # remat: each layer's forward runs twice a step (3 products each), the
    # backward once (dx and dw of each product)
    want = dict(gmm=6 * L * steps, gmm_dx=3 * L * steps,
                gmm_dw=3 * L * steps, flash_attention_fwd=2 * L * steps,
                flash_attention_bwd_dq=L * steps,
                flash_attention_bwd_dkv=L * steps, fused_adam_step=steps)
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, want {want}")
    del engine
    _free(torch)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite and falling: {losses}")
    step = _mixtral_step_vs_plain(torch, seed)
    layer = _moe_layer_nccl(torch, seed, smi)
    seconds = time.perf_counter() - t_stage
    log(f"[moe-train] stage 31 took {seconds:.1f} s")
    return dict(kernels=rows, sizes=sizes, losses=losses,
                step_ms=[t * 1e3 for t in times], step_ms_mean=step_s * 1e3,
                tokens_per_s=tok_s, mfu_active=mfu, tflops=tflops,
                flops_per_token=flops_tok, n_params=n_total,
                n_active=n_active, peak_bytes=peak, launches=launches,
                route_launches=routes, step_vs_plain=step, moe_layer=layer,
                seconds=seconds)


# --------------------------------------------------------------- stage 33
TP_PAGED_CASES = [
    # (name, wrapper, replaces line, shape args): the heads one tp rank
    # holds, at stage 3's token counts and contexts
    ("tp4_llama7b_decode", "paged_attention", 29,
     dict(H=8, Hkv=8, atom=1, n_tiles=16, min_ctx=128, max_ctx=2112,
          table_ctx=4096, window=0)),
    ("tp4_llama7b_prefill", "paged_attention_atoms", 120,
     dict(H=8, Hkv=8, atom=16, n_tiles=47, max_ctx=2048, table_ctx=4096,
          window=0)),
    ("tp4_mistral7b_decode", "paged_attention", 29,
     dict(H=8, Hkv=2, atom=1, n_tiles=64, max_ctx=6144, window=4096)),
    ("tp4_mistral7b_prefill", "paged_attention_atoms", 120,
     dict(H=8, Hkv=2, atom=16, n_tiles=8, max_ctx=6144, window=4096)),
    ("tp8_llama70b_decode_kv1", "paged_attention", 29,
     dict(H=8, Hkv=1, atom=1, n_tiles=16, min_ctx=128, max_ctx=4096,
          window=0)),
]
TP_GMM_SLICE = 14336 // 4        # Mixtral-8x7B's FFN over 4 tp ranks


def _local_tp_group():
    from deepspeed_tpu_torch.comm.backend import ProcessGroup
    return ProcessGroup(("tp", ), local=True)


def _tp_train(torch, np, seed, train):
    """(a): stage 8 with ``module_inject``'s modules in place."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import (LlamaModel, llama_7b,
                                                  tp_rules)
    from deepspeed_tpu_torch.module_inject import (ColumnParallelLinear,
                                                   RowParallelLinear,
                                                   VocabParallelEmbedding,
                                                   shard_params_for_tp)
    B, S, L = 4, 2048, 8
    cfg = llama_7b(num_hidden_layers=L, remat=False, head_dtype="bfloat16")
    model = shard_params_for_tp(LlamaModel(cfg, device="meta"),
                                tp_rules(cfg), group=_local_tp_group())
    kinds = {type(model.model.layers[0].self_attn.q_proj),
             type(model.model.layers[0].mlp.down_proj),
             type(model.model.embed_tokens), type(model.lm_head)}
    if kinds != {ColumnParallelLinear, RowParallelLinear,
                 VocabParallelEmbedding}:
        raise AssertionError(f"tp-1 model holds {kinds}")
    engine = deepspeed_tpu_torch.initialize(model=model,
                                            config=dict(TRAIN_CONFIG))[0]
    engine.initialize_parameters(seed)
    ids = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(B, S))).cuda()
    counters = _train_launches()
    for fn in counters.values():
        fn.launches = 0
    losses = []
    for _ in range(4):
        loss = engine(ids, ids)
        engine.backward(loss)
        engine.step()
        losses.append(loss.item())
    launches = {k: fn.launches for k, fn in counters.items()}
    equal = losses == train["losses"][:4]
    log(f"[tp] (a) stage 8's step through shard_params_for_tp at tp 1 "
        f"(ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding "
        f"in place): losses " + ", ".join(f"{x:.6f}" for x in losses)
        + f" | bit-equal to stage 8's first four {equal} | launches in 4 "
        f"steps {launches}")
    want = {"flash_attention": 4 * L, "flash_attention_bwd_dq": 4 * L,
            "flash_attention_bwd_dkv": 4 * L, "fused_adam_step": 4}
    if not equal:
        raise AssertionError(f"tp-1 losses {losses} != stage 8's "
                             f"{train['losses'][:4]}")
    if launches != want:
        raise AssertionError(f"tp-1 launches {launches}, want {want}")
    del engine, model
    _free(torch)
    return dict(losses=losses, launches=launches)


def _tp_serve(torch, np, seed, serve):
    """(b): stage 4's weights and requests on a model cut at tp 1."""
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    from deepspeed_tpu_torch.inference.v2.model_implementations \
        .hf_builders import _ingest_llama, _llama_config_from_hf
    from deepspeed_tpu_torch.models.llama import LlamaModel, tp_rules
    from deepspeed_tpu_torch.module_inject import (ColumnParallelLinear,
                                                   RowParallelLinear,
                                                   VocabParallelEmbedding,
                                                   shard_params_for_tp)
    from deepspeed_tpu_torch.ops.kernels import paged_attention as pa
    gen = torch.Generator(device="cuda").manual_seed(seed)
    state = _random_hf_state(torch, LLAMA2_7B_HF, gen)
    cfg = _llama_config_from_hf(LLAMA2_7B_HF, "bfloat16")
    model = shard_params_for_tp(LlamaModel(cfg, device="meta"),
                                tp_rules(cfg), group=_local_tp_group())
    model.load_weights(_ingest_llama(cfg, state.items()), device="cuda")
    del state
    layer = model.model.layers[0]
    if not (isinstance(layer.self_attn.q_proj, ColumnParallelLinear) and
            isinstance(layer.self_attn.o_proj, RowParallelLinear) and
            isinstance(model.model.embed_tokens, VocabParallelEmbedding) and
            isinstance(model.lm_head, ColumnParallelLinear)):
        raise AssertionError("the tp-1 serving model was not cut")
    config = dict(
        dtype="bfloat16", decode_burst=16, tensor_parallel=dict(tp_size=1),
        state_manager=dict(block_size=128, num_blocks=160, max_context=4096,
                           max_ragged_sequence_count=16,
                           max_tracked_sequences=16,
                           max_ragged_batch_size=768, prefill_atom_size=16))
    eng = InferenceEngineV2(model, config=config)
    rng = np.random.default_rng(seed)
    lengths = rng.integers(128, 2049, size=8).tolist()
    prompts = [rng.integers(0, 32000, size=n).tolist() for n in lengths]
    for fn in (pa.paged_attention, pa.paged_attention_atoms):
        fn.launches = 0
        fn.route_launches = dict.fromkeys(pa.ROUTES, 0)
    torch.cuda.synchronize()
    t = time.perf_counter()
    outs = eng.generate(prompts, max_new_tokens=64)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {"paged_attention": pa.paged_attention.launches,
                "paged_attention_atoms": pa.paged_attention_atoms.launches}
    routes = {"paged_attention": dict(pa.paged_attention.route_launches),
              "paged_attention_atoms":
                  dict(pa.paged_attention_atoms.route_launches)}
    equal = outs == serve["outs"]
    log(f"[tp] (b) Llama-2-7B cut at tp 1 before the load, "
        f"tensor_parallel.tp_size 1: stage 4's 8 requests in {wall:.2f} s, "
        f"greedy tokens bit-equal to stage 4's {equal} | B4 launches "
        f"{launches}")
    _check_paged_routes("tp", launches, routes)
    if not equal:
        raise AssertionError("tp-1 serving tokens differ from stage 4's")
    if min(launches.values()) <= 0:
        raise AssertionError(f"B4 never launched at tp 1: {launches}")
    del eng, model
    _free(torch)
    return dict(wall_s=wall, launches=launches, route_launches=routes)


def stage_tp(seed, smi, train, serve):
    import numpy as np
    import torch
    from deepspeed_tpu_torch.ops.kernels import paged_attention as pa
    t0 = time.perf_counter()
    out = dict(train=_tp_train(torch, np, seed, train),
               serve=_tp_serve(torch, np, seed, serve))
    gen = torch.Generator(device="cuda").manual_seed(seed + 33)
    out["paged"] = [_paged_row(torch, gen, pa, *case)
                    for case in TP_PAGED_CASES]
    for row in out["paged"]:
        row.pop("key")
    D, I, E = 4096, TP_GMM_SLICE, 8
    prefill = [96, 0, 412, 230, 318, 57, 269, 154]
    out["gmm"] = []
    for name, sizes, route in (("decode", [2] * E, "wgmma_tma_64"),
                               ("prefill", prefill, "wgmma_tma")):
        for proj, K, N in (("w1", D, I), ("w2", I, D)):
            out["gmm"].append(_gmm_case(torch, gen, f"tp4_{name}_{proj}",
                                        sizes, K, N, "bfloat16", route))
            _free(torch)
    out["seconds"] = time.perf_counter() - t0
    log(f"[tp] stage 33 took {out['seconds']:.1f} s | {smi}")
    return out



# ---------------------------------------------------------------- stage 34
# bf16 against bf16: the ring and the chunked attention merge the pairs'
# bf16 outputs in fp32 and round once more, and sum the pairs' bf16
# gradients in fp32, where one B1 call over the whole sequence rounds
# once; the difference stays within a bf16 rounding of the tensor (2^-7 of
# its norm) and within 2^-5 of its largest element everywhere
LONG_NORM_RTOL, LONG_MAX_RTOL = 2.0**-7, 2.0**-5
RING = dict(B=1, S=32768, H=32, D=128, sp=4)       # Llama-2-7B width
FPDT = dict(B=1, H=8, D=128, chunk=8192, context=131072)   # bench.py:667
CHUNKED = dict(B=1, S=32768, H=32, D=128, chunk=4096)
HEAD = dict(N=8192, D=4096, V=32000, chunk=4096)   # Llama-2-7B's head
USER_CKPT = dict(B=8, S=4096, D=4096, I=11008, V=32000)   # (d)


def _flash_counters():
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    return {"fwd": fa.flash_attention_fwd, "dq": fa.flash_attention_bwd_dq,
            "dkv": fa.flash_attention_bwd_dkv}


def _zeroed(counters):
    import torch
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    return counters


def _counts(counters):
    return {k: fn.launches for k, fn in counters.items()}


def _hold(torch, tag, pairs):
    """{name: (norm-relative, max-relative) error} of each (got, ref) pair;
    outside LONG_NORM_RTOL / LONG_MAX_RTOL fails."""
    errs = {}
    for name, (got, ref) in pairs.items():
        d, r = got.float() - ref.float(), ref.float()
        errs[name] = ((d.norm() / r.norm()).item(),
                      (d.abs().max() / r.abs().max()).item())
    bad = {n: e for n, e in errs.items()
           if not (e[0] <= LONG_NORM_RTOL and e[1] <= LONG_MAX_RTOL)}
    if bad:
        raise AssertionError(f"{tag}: outside 2^-7 of the norm / 2^-5 of "
                             f"the largest element: {bad}")
    return errs


def _fmt_errs(errs):
    return ", ".join(f"{k} {a:.2e}/{b:.2e}" for k, (a, b) in errs.items())


def _attention_flops(B, H, S, D, passes):
    """Products of causal attention over S positions: ``passes`` × 2·D a
    live (query, key) pair (2 forward, 5 backward)."""
    return passes * 2 * B * H * D * _live_pairs(S, S, True, 0)


def _fwd_bwd(fn, leaves, do):
    import torch
    out = fn(*leaves)
    return out, torch.autograd.grad(out, leaves, do)


def _ring_case(torch, gen, Hkv):
    """(a): the ring of four on one card against B1 over the whole
    sequence, and against the plain version at S = 4096."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.sequence.ring_attention import \
        ring_attention_blocks
    B, S, H, D, sp = (RING[k] for k in ("B", "S", "H", "D", "sp"))

    def inputs(S):
        return [torch.randn(B, S, h, D, device="cuda", generator=gen).to(
            torch.bfloat16).requires_grad_(i < 3)
            for i, h in enumerate((H, Hkv, Hkv, H))]

    ring = lambda q, k, v: ring_attention_blocks(q, k, v, sp)  # noqa: E731
    whole = lambda q, k, v: fa.flash_attention(q, k, v)  # noqa: E731
    q, k, v, do = inputs(S)
    counters = _zeroed(_flash_counters())
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out, grads = _fwd_bwd(ring, (q, k, v), do)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    launches = _counts(counters)
    ref, rgrads = _fwd_bwd(whole, (q, k, v), do)
    errs = _hold(torch, f"ring Hkv {Hkv}", dict(
        o=(out, ref), **{f"d{n}": (g, r) for n, g, r in zip("qkv", grads,
                                                             rgrads)}))
    del out, grads, ref, rgrads
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _fwd_bwd(whole, (q, k, v), do)
    torch.cuda.synchronize()
    whole_peak = torch.cuda.max_memory_allocated() - base
    with torch.no_grad():
        kr, vr = (t.repeat_interleave(H // Hkv, dim=2).transpose(1, 2)
                  for t in (k, v))
        ms = dict(ring_fwd=cuda_ms(lambda: ring(q, k, v), 3),
                  whole_fwd=cuda_ms(lambda: whole(q, k, v), 3),
                  sdpa_fwd=cuda_ms(lambda: F.scaled_dot_product_attention(
                      q.transpose(1, 2), kr, vr, is_causal=True), 3))
        del kr, vr
    ms["ring_fwd_bwd"] = cuda_ms(lambda: _fwd_bwd(ring, (q, k, v), do), 2)
    ms["whole_fwd_bwd"] = cuda_ms(lambda: _fwd_bwd(whole, (q, k, v), do), 2)
    del q, k, v, do
    _free(torch)
    # the plain version (fp32 scores of the whole sequence) at S = 4096
    q, k, v, do = inputs(S // 8)
    out, grads = _fwd_bwd(lambda q, k, v: ring_attention_blocks(q, k, v, sp),
                          (q, k, v), do)
    ref, rgrads = _fwd_bwd(fa.flash_attention_plain, (q, k, v), do)
    plain_errs = _hold(torch, f"ring Hkv {Hkv} vs plain", dict(
        o=(out, ref), **{f"d{n}": (g, r) for n, g, r in zip("qkv", grads,
                                                             rgrads)}))
    del q, k, v, do, out, grads, ref, rgrads
    _free(torch)
    want = {"fwd": 10, "dq": 10, "dkv": 10}
    fwd_tf = _attention_flops(B, H, S, D, 2) / ms["ring_fwd"] / 1e9
    # the forward's bound: q, k, v read and o written once, against the
    # two products over the live (causal) pairs
    bound = _roofline((2 * H + 2 * Hkv) * B * S * D * 2,
                      _attention_flops(B, H, S, D, 2), BF16_FLOPS)
    log(f"[long] (a) ring of {sp} on one card, [{B}, {S}, {H}, {D}] bf16, "
        f"Hkv {Hkv}, causal, blocks of {S // sp}: B1 launches {launches} "
        f"(want {want}) | vs B1 over the whole sequence (norm/max "
        f"relative): {_fmt_errs(errs)} | vs the plain version at S = "
        f"{S // 8}: {_fmt_errs(plain_errs)} | ms: ring fwd "
        f"{ms['ring_fwd']:.3f} ({fwd_tf:.1f} TFLOP/s), fwd+bwd "
        f"{ms['ring_fwd_bwd']:.3f}; B1 whole fwd {ms['whole_fwd']:.3f}, "
        f"fwd+bwd {ms['whole_fwd_bwd']:.3f}; SDPA fwd {ms['sdpa_fwd']:.3f} "
        f"| peak above the inputs: ring {peak / 2**30:.3f} GiB, B1 whole "
        f"{whole_peak / 2**30:.3f} GiB | forward bound {bound[0]:.4f} ms "
        f"by {bound[1]}")
    if launches != want:
        raise AssertionError(f"ring launches {launches}, want {want}")
    return dict(Hkv=Hkv, launches=launches, errs=errs, plain_errs=plain_errs,
                ms=ms, peak_bytes=peak, whole_peak_bytes=whole_peak,
                fwd_tflops=fwd_tf, bound_ms=bound[0], bound_by=bound[1])


def _fpdt_stream(torch, q, k, v, double_buffer):
    """Every block of ``q``/``k``/``v`` through one
    ``FPDTHostOffloadAttention`` in order (each attends the stored chunks
    and itself, causally, then is stored): (attention, outputs, seconds,
    each call's working set above what it started with)."""
    from deepspeed_tpu_torch.sequence.fpdt_layer import \
        FPDTHostOffloadAttention
    ch = FPDT["chunk"]
    attn = FPDTHostOffloadAttention(chunk_size=ch,
                                    double_buffer=double_buffer)
    outs, work = [], []
    torch.cuda.synchronize()
    t = time.perf_counter()
    for lo in range(0, q.shape[1], ch):
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        sl = slice(lo, lo + ch)
        outs.append(attn.attend(q[:, sl], k[:, sl], v[:, sl]))
        work.append(torch.cuda.max_memory_allocated() - before)
    torch.cuda.synchronize()
    return attn, outs, time.perf_counter() - t, work


def _fpdt_case(torch, gen):
    """(b): FPDT's host-streamed attention over 128K positions, and
    ``chunked_attention`` at [1, 32768, 32, 128]."""
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.sequence.fpdt_layer import chunked_attention
    with torch.no_grad():
        B, H, D, ch, n = (FPDT[k] for k in ("B", "H", "D", "chunk",
                                            "context"))
        q, k, v = (torch.randn(B, n, H, D, device="cuda", generator=gen)
                   .to(torch.bfloat16) for _ in range(3))
        _fpdt_stream(torch, q[:, :2 * ch], k[:, :2 * ch], v[:, :2 * ch],
                     True)                                    # warm-up
        runs = {}
        for db in (False, True):
            counters = _zeroed(_flash_counters())
            attn, outs, secs, work = _fpdt_stream(torch, q, k, v, db)
            runs[db] = dict(launches=_counts(counters), seconds=secs,
                            tokens_per_s=n / secs, work=work)
        pinned = all(c.k.is_pinned() and c.v.is_pinned()
                     for c in attn.chunks)
        errs = _hold(torch, "fpdt stream", dict(
            o=(torch.cat(outs, dim=1), fa.flash_attention(q, k, v))))
        del attn, outs, q, k, v
    _free(torch)
    blocks = n // ch
    want = {"fwd": blocks + blocks * (blocks - 1) // 2, "dq": 0, "dkv": 0}
    pair = 2 * B * ch * H * D * 2          # one stored chunk's k and v
    work = runs[True]["work"]
    half = blocks // 2 - 1                 # the call that sees 64K
    flat = work[-1] - work[half] <= pair
    log(f"[long] (b) FPDT host streaming, B {B}, H {H}, D {D}, chunks of "
        f"{ch}, {blocks} blocks to {n} positions, bf16: every stored chunk "
        f"pinned {pinned} ({blocks} chunks) | "
        f"vs B1 over all {n} positions: {_fmt_errs(errs)} | tokens/s "
        f"double_buffer {runs[True]['tokens_per_s']:.1f}, without "
        f"{runs[False]['tokens_per_s']:.1f} | B1 launches a stream "
        f"{runs[True]['launches']} (want {want}) | a call's working set "
        f"above its start: at 64K context {work[half] / 2**20:.1f} MiB, at "
        f"128K {work[-1] / 2**20:.1f} MiB, flat within one chunk pair "
        f"({pair / 2**20:.1f} MiB) {flat}")
    for db, r in runs.items():
        if r["launches"] != want:
            raise AssertionError(f"fpdt (double_buffer {db}) launches "
                                 f"{r['launches']}, want {want}")
    if not pinned or not flat:
        raise AssertionError(f"fpdt: chunks pinned {pinned}, working set "
                             f"flat {flat} ({work})")
    out = dict(launches=runs[True]["launches"], errs=errs,
               tokens_per_s=runs[True]["tokens_per_s"],
               tokens_per_s_no_double_buffer=runs[False]["tokens_per_s"],
               work_bytes_64k=work[half], work_bytes_128k=work[-1],
               pinned=pinned)
    # chunked_attention, forward and backward
    B, S, H, D, ch = (CHUNKED[k] for k in ("B", "S", "H", "D", "chunk"))
    q, k, v, do = (torch.randn(B, S, H, D, device="cuda", generator=gen)
                   .to(torch.bfloat16).requires_grad_(i < 3)
                   for i in range(4))
    chunked = lambda q, k, v: chunked_attention(  # noqa: E731
        q, k, v, q_chunk=ch, kv_chunk=ch)
    counters = _zeroed(_flash_counters())
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got, grads = _fwd_bwd(chunked, (q, k, v), do)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    launches = _counts(counters)
    ref, rgrads = _fwd_bwd(fa.flash_attention, (q, k, v), do)
    cerrs = _hold(torch, "chunked_attention", dict(
        o=(got, ref), **{f"d{n}": (g, r) for n, g, r in zip("qkv", grads,
                                                             rgrads)}))
    del got, grads, ref, rgrads
    ms = cuda_ms(lambda: _fwd_bwd(chunked, (q, k, v), do), 2)
    m = S // ch
    pairs = m * (m + 1) // 2
    cwant = {"fwd": 2 * pairs, "dq": pairs, "dkv": pairs}
    log(f"[long] (b) chunked_attention [{B}, {S}, {H}, {D}] bf16, chunks "
        f"of {ch}, causal, each q chunk under checkpoint: B1 launches "
        f"{launches} (want {cwant}: the forward again in the backward) | "
        f"vs B1 over the whole sequence: {_fmt_errs(cerrs)} | fwd+bwd "
        f"{ms:.3f} ms | peak above the inputs {peak / 2**30:.3f} GiB")
    if launches != cwant:
        raise AssertionError(f"chunked launches {launches}, want {cwant}")
    del q, k, v, do
    _free(torch)
    out["chunked"] = dict(launches=launches, errs=cerrs, ms=ms,
                          peak_bytes=peak)
    return out


def _head_case(torch, gen):
    """(c): the fused chunked head + loss against the full-logits loss."""
    from deepspeed_tpu_torch.sequence.cross_entropy import (
        fused_linear_cross_entropy, softmax_cross_entropy_with_logits)
    N, D, V, ch = (HEAD[k] for k in ("N", "D", "V", "chunk"))
    x = torch.randn(N, D, device="cuda", generator=gen).to(
        torch.bfloat16).requires_grad_()
    w = (0.02 * torch.randn(V, D, device="cuda", generator=gen)).to(
        torch.bfloat16).requires_grad_()
    labels = torch.randint(0, V, (N, ), device="cuda", generator=gen)
    paths = {
        "fused": lambda: fused_linear_cross_entropy(
            x, w.t(), labels, ch, torch.bfloat16).mean(),
        "full": lambda: softmax_cross_entropy_with_logits(
            x @ w.t(), labels).mean()}
    res = {}
    for name, fn in paths.items():
        _free(torch)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        loss = fn()
        dx, dw = torch.autograd.grad(loss, (x, w))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        ms = cuda_ms(lambda: torch.autograd.grad(fn(), (x, w)), 3)
        res[name] = dict(loss=loss.item(), dx=dx, dw=dw, peak_bytes=peak,
                         ms=ms)
    f, p = res["fused"], res["full"]
    errs = _hold(torch, "fused head + loss", dict(dx=(f["dx"], p["dx"]),
                                                  dw=(f["dw"], p["dw"])))
    loss_rel = abs(f["loss"] - p["loss"]) / abs(p["loss"])
    log(f"[long] (c) fused head + loss, N {N}, D {D}, V {V}, chunks of "
        f"{ch}, bf16 products: loss {f['loss']:.6f} against the full "
        f"logits' {p['loss']:.6f} (relative {loss_rel:.2e}) | "
        f"{_fmt_errs(errs)} | fwd+bwd {f['ms']:.3f} ms against "
        f"{p['ms']:.3f} | peak above the inputs {f['peak_bytes'] / 2**30:.3f}"
        f" GiB against {p['peak_bytes'] / 2**30:.3f} (the fp32 logits alone "
        f"{N * V * 4 / 2**30:.3f} GiB)")
    if loss_rel > LONG_NORM_RTOL or not f["peak_bytes"] < p["peak_bytes"]:
        raise AssertionError(f"fused loss {f['loss']} vs {p['loss']}, peaks "
                             f"{f['peak_bytes']} vs {p['peak_bytes']}")
    for r in res.values():
        del r["dx"], r["dw"]
    del x, w
    _free(torch)
    return dict(errs=errs, loss_rel=loss_rel, **res)


def _long_train(torch, np, seed, train):
    """(d): stage 8's model and batch with ``loss_chunk_vocab`` 4096, then
    with ``remat_policy="dots_saveable"``."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LlamaModel, llama_7b
    B, S, L, steps = 4, 2048, 8, 4
    runs = {}
    for name, over in (("chunked_loss", dict(remat=False,
                                              loss_chunk_vocab=4096)),
                       ("dots_saveable", dict(remat=True,
                                              remat_policy="dots_saveable"))):
        cfg = llama_7b(num_hidden_layers=L, head_dtype="bfloat16", **over)
        engine = deepspeed_tpu_torch.initialize(
            model=LlamaModel(cfg, device="meta"),
            config=dict(TRAIN_CONFIG))[0]
        engine.initialize_parameters(seed)
        ids = torch.from_numpy(np.random.default_rng(seed).integers(
            0, cfg.vocab_size, size=(B, S))).cuda()
        counters = _train_launches()
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        losses, times = [], []
        for _ in range(steps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss = engine(ids, ids)
            engine.backward(loss)
            engine.step()
            losses.append(loss.item())
            times.append(time.perf_counter() - t)
        runs[name] = dict(losses=losses, step_ms=[t * 1e3 for t in times],
                          launches={k: fn.launches
                                    for k, fn in counters.items()},
                          peak_bytes=torch.cuda.max_memory_allocated())
        del engine
        _free(torch)
    ref = train["losses"][:steps]
    want = {"flash_attention": L * steps, "flash_attention_bwd_dq": L * steps,
            "flash_attention_bwd_dkv": L * steps, "fused_adam_step": steps}
    for name, r in runs.items():
        r["max_rel_loss_diff"] = max(abs(a - b) / abs(b)
                                     for a, b in zip(r["losses"], ref))
        log(f"[long] (d) stage 8's model and batch with {name}: losses "
            + ", ".join(f"{x:.6f}" for x in r["losses"])
            + f" | largest difference from stage 8's "
            f"{max(abs(a - b) for a, b in zip(r['losses'], ref)):.3e} "
            f"(relative {r['max_rel_loss_diff']:.3e}) | step ms "
            + ", ".join(f"{t:.1f}" for t in r["step_ms"])
            + f" | peak {r['peak_bytes'] / 2**30:.2f} GiB (stage 8 "
            f"{train['peak_bytes'] / 2**30:.2f}) | launches {r['launches']}")
        if r["launches"] != want:
            raise AssertionError(f"{name} launches {r['launches']}, want "
                                 f"{want}")
    # bf16 training from sums in another order: within 2^-7 of the losses'
    # scale (zero_multicard.py's gate), as they fall from 11 to 0.003
    scale = max(abs(x) for x in ref)
    chunked = runs["chunked_loss"]
    chunked["max_abs_loss_diff"] = max(
        abs(a - b) for a, b in zip(chunked["losses"], ref))
    if chunked["max_abs_loss_diff"] > 2.0**-7 * scale:
        raise AssertionError("the chunked loss left stage 8's losses")
    if runs["dots_saveable"]["losses"] != ref:
        raise AssertionError("dots_saveable's losses are not stage 8's")
    return runs


def _cpu_checkpointing(torch, gen):
    """(d): a two-block user model (an input projection, two checkpointed
    MLP blocks, an LM head and its loss) through ``deepspeed_tpu_torch.
    checkpointing.checkpoint``, plain and with ``cpu_checkpointing``: the
    blocks' saved inputs are what the host takes off the card while the
    head runs."""
    import torch.nn.functional as F
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.sequence.cross_entropy import \
        softmax_cross_entropy_with_logits
    ac = deepspeed_tpu_torch.checkpointing
    B, S, D, I, V = (USER_CKPT[k] for k in ("B", "S", "D", "I", "V"))
    inp = torch.randn(B, S, D, device="cuda", generator=gen).to(
        torch.bfloat16)
    labels = torch.randint(0, V, (B, S), device="cuda", generator=gen)
    ws = [(torch.randn(*shape, device="cuda", generator=gen) / shape[0]
           ** 0.5).to(torch.bfloat16).requires_grad_()
          for shape in ((D, D), (D, I), (I, D), (D, I), (I, D), (D, V))]

    def block(h, w1, w2):
        return h + F.silu(h @ w1) @ w2

    def run(cpu):
        ac.reset()
        if cpu:
            ac.configure(checkpoint_in_cpu=True)
        _free(torch)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        h = ac.checkpoint(block, inp @ ws[0], ws[1], ws[2])
        h = ac.checkpoint(block, h, ws[3], ws[4])
        loss = softmax_cross_entropy_with_logits(h @ ws[5], labels).mean()
        del h
        grads = torch.autograd.grad(loss, ws)
        torch.cuda.synchronize()
        return loss.item(), grads, torch.cuda.max_memory_allocated() - base

    plain, host = run(False), run(True)
    ac.reset()
    equal = plain[0] == host[0] and all(
        torch.equal(a, b) for a, b in zip(plain[1], host[1]))
    log(f"[long] (d) two blocks of [{B}, {S}, {D}] bf16 (MLP {I}, head "
        f"{V}) through checkpointing.checkpoint: gradients with "
        f"cpu_checkpointing "
        f"bit-equal to the plain checkpoint's {equal} | peak above the "
        f"inputs {host[2] / 2**30:.3f} GiB against {plain[2] / 2**30:.3f}")
    if not equal or not host[2] < plain[2]:
        raise AssertionError(f"cpu_checkpointing: equal {equal}, peaks "
                             f"{host[2]} vs {plain[2]}")
    del inp, ws, labels
    _free(torch)
    return dict(equal=equal, peak_bytes=host[2], plain_peak_bytes=plain[2])


def stage_long_context(seed, smi, train):
    import numpy as np
    import torch
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed + 34)
    out = dict(ring=[_ring_case(torch, gen, Hkv) for Hkv in (32, 8)])
    out["fpdt"] = _fpdt_case(torch, gen)
    out["head"] = _head_case(torch, gen)
    out["train"] = _long_train(torch, np, seed, train)
    out["cpu_checkpointing"] = _cpu_checkpointing(torch, gen)
    out["seconds"] = time.perf_counter() - t0
    log(f"[long] stage 34 took {out['seconds']:.1f} s | {smi}")
    return out


# ---------------------------------------------------------------- stage 35
# (b): the padded-vocabulary route runs the tied head at another width
# (50260 columns), for which cuBLAS may pick another fp16 kernel; its
# losses stay within an fp16 head's rounding of the unpadded run's
PAD_ROWS, PAD_LOSS_RTOL = 3, 2.0**-7
# (c): the text encoder's and the UNet's fp16 outputs, fused against the
# module's own attention: B1 keeps P in fp16 and sums in fp32 where the
# module rounds the softmax to fp16 first, over 12 layers
INJECT_NORM_RTOL, INJECT_MAX_RTOL = 2.0**-7, 2.0**-5
CLIP_L14 = dict(vocab=49408, D=768, L=12, H=12, I=3072, S=77, B=2)
UNET_TOP = dict(C=320, H=5, side=96, ctx=77, ctx_dim=1024, B=2)
GPT2_HEAD = dict(N=8192, D=1024, V=50257, chunk=4096)
# (d): fp32 products in full fp32, another summation order
HEAD_FP32_RTOL = 1e-4


def _domino_case(torch, np, seed, train, smi):
    """(a): stage 8's step with ``domino`` (two µ-streams)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import llama as llama_mod
    from deepspeed_tpu_torch.models.llama import LlamaModel, llama_7b
    from deepspeed_tpu_torch.runtime.domino import (measure_tp_overlap,
                                                    split_microstreams)
    B, S, L, steps = 4, 2048, 8, 4
    cfg = llama_7b(num_hidden_layers=L, remat=False, head_dtype="bfloat16")
    config = dict(TRAIN_CONFIG, domino={"enabled": True, "n_streams": 2})
    engine = deepspeed_tpu_torch.initialize(
        model=LlamaModel(cfg, device="meta"), config=config)[0]
    engine.initialize_parameters(seed)
    ids = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(B, S))).cuda()
    rows = []
    core = llama_mod.attention_core

    def spy(q, *a, **k):
        rows.append(q.shape[0])
        return core(q, *a, **k)

    counters = _train_launches()
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    llama_mod.attention_core = spy
    losses, times = [], []
    try:
        for _ in range(steps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss = engine(ids, ids)
            engine.backward(loss)
            engine.step()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            losses.append(loss.item())
    finally:
        llama_mod.attention_core = core
    launches = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        report = measure_tp_overlap(split_microstreams(engine.module, 2),
                                    ids, labels=ids)
    plain = train["losses"][:steps]
    # relative to the losses' scale: they fall from 11 to 0.003 here,
    # where bf16 differences of the order of the steps become large
    # relative ones (stage 34 (d)'s rule)
    scale = max(abs(x) for x in plain)
    rel = [abs(a - b) / scale for a, b in zip(losses, plain)]
    step_ms = float(np.mean(times[1:])) * 1e3
    log(f"[tp-compose] (a) stage 8's step with domino (2 µ-streams of "
        f"{B // 2} rows): losses " + ", ".join(f"{x:.6f}" for x in losses)
        + " against stage 8's " + ", ".join(f"{x:.6f}" for x in plain)
        + f" (largest difference {max(rel):.2e} of their scale, tol 2^-7) "
        f"| step ms "
        + ", ".join(f"{t * 1e3:.1f}" for t in times) + f" | mean of the "
        f"last {steps - 1} {step_ms:.1f} ms against stage 8's "
        f"{train['step_ms_mean']:.1f} ms | peak {peak / 2**30:.2f} GiB | "
        f"launches in {steps} steps {launches}; B1's batch dim "
        f"{sorted(set(rows))} | overlap report at tp 1 {report} (no tp "
        f"collective exists at tp 1: the µ-streams run one after the "
        f"other) | {smi}")
    want = {"flash_attention": 2 * L * steps,
            "flash_attention_bwd_dq": 2 * L * steps,
            "flash_attention_bwd_dkv": 2 * L * steps,
            "fused_adam_step": steps}
    if launches != want or set(rows) != {B // 2}:
        raise AssertionError(f"domino launches {launches} (want {want}), "
                             f"B1 batch dims {set(rows)}")
    if max(rel) > 2.0**-7 or not all(np.isfinite(losses)):
        raise AssertionError(f"domino losses {losses} vs {plain}")
    if report["collectives"] or report["async_pairs"]:
        raise AssertionError(f"tp-1 overlap report {report}")
    del engine
    _free(torch)
    return dict(losses=losses, plain_losses=plain, max_rel=max(rel),
                step_ms=[t * 1e3 for t in times], step_ms_mean=step_ms,
                plain_step_ms_mean=train["step_ms_mean"], peak_bytes=peak,
                launches=launches, overlap=report)


def _named_master(engine):
    layout, _ = engine.global_layout()
    flat = engine.fp32_params()
    return {n: flat[o:o + k].view(s).clone() for n, o, k, s in layout}


def _gpt2_tp1(torch, np, seed, gpt2):
    """(b) GPT-2 350M: stage 11's engine with its model cut at tp 1, then
    the padded-vocabulary route from the same weights."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import (GPT2Model, gpt2_350m,
                                                 pad_vocab, tp_rules)
    from deepspeed_tpu_torch.module_inject import shard_params_for_tp
    B, S, steps = 8, 1024, 3
    cfg = gpt2_350m(dtype="float16")
    model = shard_params_for_tp(GPT2Model(cfg, device="meta"),
                                tp_rules(cfg), group=_local_tp_group())
    if getattr(model.h[0].q_proj, "tp_group", None) is None or \
            getattr(model.wte, "tp_group", None) is None:
        raise AssertionError("the tp-1 GPT-2 model was not cut")
    engine = deepspeed_tpu_torch.initialize(model=model,
                                            config=dict(GPT2_CONFIG))[0]
    engine.initialize_parameters(seed)
    named = _named_master(engine)
    ids = torch.from_numpy(np.random.default_rng(seed + 11).integers(
        0, cfg.vocab_size, size=(B, S))).cuda()
    counters = _gpt2_launches()
    out = {}
    for name in ("tp1", "padded"):
        if name == "padded":
            del engine
            _free(torch)
            model = GPT2Model(cfg, device="meta")
            start = pad_vocab(model, PAD_ROWS, named)
            engine = deepspeed_tpu_torch.initialize(
                model=model, model_parameters=start,
                config=dict(GPT2_CONFIG))[0]
            del start
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        losses, _, skips, times = _run_steps(torch, engine, ids, steps,
                                             timed=True)
        out[name] = dict(losses=losses, skipped=skips,
                         step_ms=[t * 1e3 for t in times],
                         launches={k: fn.launches for k, fn in
                                   counters.items() if fn.launches})
    del engine, named
    _free(torch)
    equal = out["tp1"]["losses"] == gpt2["losses"][:steps]
    rel = max(abs(a - b) / abs(b) for a, b in
              zip(out["padded"]["losses"], out["tp1"]["losses"]))
    out.update(bit_equal=equal, padded_max_rel=rel)
    log(f"[tp-compose] (b) GPT-2 350M through the tp code at tp 1 "
        f"(fp16, fusedlamb): losses " + ", ".join(
            f"{x:.6f}" for x in out["tp1"]["losses"]) +
        f" | bit-equal to stage 11's first {steps} {equal}; padded "
        f"vocabulary ({cfg.vocab_size} + {PAD_ROWS} rows, the "
        f"vocabulary-parallel loss): " + ", ".join(
            f"{x:.6f}" for x in out["padded"]["losses"]) +
        f" (largest relative {rel:.2e}, tol 2^-7), skipped "
        f"{out['padded']['skipped']} vs {out['tp1']['skipped']} | launches "
        f"{out['tp1']['launches']} | padded {out['padded']['launches']}")
    want_b1 = 2 * cfg.num_hidden_layers * steps      # remat: twice a layer
    for name in ("tp1", "padded"):
        r = out[name]
        stepped = steps - sum(r["skipped"])
        want = dict(flash_attention=want_b1,
                    flash_attention_bwd_dq=want_b1 // 2,
                    flash_attention_bwd_dkv=want_b1 // 2)
        if stepped:
            want.update(fused_lamb_phase1=stepped,
                        fused_lamb_phase2=stepped)
        if r["launches"] != want:
            raise AssertionError(f"GPT-2 {name} launches {r['launches']}, "
                                 f"want {want}")
    if not equal:
        raise AssertionError(f"GPT-2 tp-1 losses {out['tp1']['losses']} != "
                             f"stage 11's {gpt2['losses'][:steps]}")
    if rel > PAD_LOSS_RTOL or out["padded"]["skipped"] != \
            out["tp1"]["skipped"]:
        raise AssertionError(f"padded GPT-2 {out['padded']} vs "
                             f"{out['tp1']}")
    return out


def _bert_tp1(torch, np, seed):
    """(b) BERT-base: stage 22's config and batch, the plain model against
    the model cut at tp 1 on the rules derived from its dataflow: losses
    and masters bit-equal.  The three runs take PyTorch's deterministic
    algorithms: the default backward of the token-type lookup (8192 ids,
    all 0, into a table of 2 rows) sums in another order each run, which
    once moved the third step's loss by one ulp."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.bert import BertModel, bert_base
    from deepspeed_tpu_torch.module_inject import (
        derive_tp_rules_from_dataflow, shard_params_for_tp)
    B, S, steps = 64, 128, 3
    cfg = bert_base()
    rng = np.random.default_rng(seed + 22)
    ids = rng.integers(0, cfg.vocab_size, size=(B, S))
    labels = np.where(rng.random((B, S)) < 0.15, ids, -100)
    batch = (torch.from_numpy(ids).cuda(), torch.from_numpy(labels).cuda())
    rules = derive_tp_rules_from_dataflow(
        BertModel(cfg, device="meta"),
        torch.zeros((1, 8), dtype=torch.long, device="meta"))
    counters = _train_launches()
    out = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for name in ("plain", "tp1", "plain_again"):
            model = BertModel(cfg, device="meta")
            if name == "tp1":
                model = shard_params_for_tp(model, rules,
                                            group=_local_tp_group())
            engine = deepspeed_tpu_torch.initialize(
                model=model, config=dict(BERT_CONFIG))[0]
            engine.initialize_parameters(seed)
            torch.cuda.synchronize()
            for fn in counters.values():
                fn.launches = 0
            losses = []
            for _ in range(steps):
                loss = engine(*batch)
                engine.backward(loss)
                engine.step()
                losses.append(loss.item())
            out[name] = dict(losses=losses, launches={
                k: fn.launches for k, fn in counters.items() if fn.launches})
            master = _named_master(engine)
            if name == "plain":
                plain_master = master
            else:
                out[name]["leaves_equal"] = sum(
                    torch.equal(t, plain_master[n])
                    for n, t in master.items())
                out[name]["leaves"] = len(master)
            del engine, model, master
            _free(torch)
    finally:
        torch.use_deterministic_algorithms(False)
    del plain_master
    # the gate: the losses and, the runs being deterministic, every leaf
    # of the master (beside those of the plain model run twice)
    equal = out["tp1"]["losses"] == out["plain"]["losses"]
    out["bit_equal"] = equal
    masters = out["tp1"]["leaves_equal"] == out["tp1"]["leaves"]
    log(f"[tp-compose] (b) BERT-base through the tp code at tp 1 ({len(rules)} "
        f"rules derived from the dataflow): losses " + ", ".join(
            f"{x:.6f}" for x in out["tp1"]["losses"]) + " against the "
        f"plain model's " + ", ".join(f"{x:.6f}" for x in
                                      out["plain"]["losses"]) +
        f" | losses bit-equal {equal}; master leaves bit-equal after the "
        f"steps {out['tp1']['leaves_equal']} of {out['tp1']['leaves']} "
        f"(the plain model run again: "
        f"{out['plain_again']['leaves_equal']}, losses bit-equal "
        f"{out['plain_again']['losses'] == out['plain']['losses']}) | "
        f"launches "
        f"{out['tp1']['launches']}")
    if not (equal and masters) or \
            out["tp1"]["launches"] != {"fused_adam_step": steps}:
        raise AssertionError(f"BERT tp-1 {out}")
    return out


def _clip_modules(torch):
    """A CLIP text encoder (transformers' layout and class names:
    ``CLIPAttention`` with q/k/v/out_proj, ``num_heads``, ``scale``) and
    a diffusers ``Attention`` (to_q/k/v, to_out), each with its library's
    eager attention; the card has neither library."""
    from torch import nn

    class CLIPAttention(nn.Module):
        def __init__(self, D, H):
            super().__init__()
            self.num_heads, self.head_dim = H, D // H
            self.scale, self.dropout = self.head_dim ** -0.5, 0.0
            self.q_proj, self.k_proj = nn.Linear(D, D), nn.Linear(D, D)
            self.v_proj, self.out_proj = nn.Linear(D, D), nn.Linear(D, D)

        def forward(self, hidden_states, attention_mask=None,
                    causal_attention_mask=None, output_attentions=False):
            B, S, D = hidden_states.shape
            q, k, v = (p(hidden_states).view(B, S, self.num_heads, -1)
                       .transpose(1, 2) for p in (self.q_proj, self.k_proj,
                                                  self.v_proj))
            w = (q @ k.transpose(-1, -2)) * self.scale
            for m in (causal_attention_mask, attention_mask):
                if m is not None:
                    w = w + m
            w = torch.softmax(w, dim=-1, dtype=torch.float32).to(q.dtype)
            out = (w @ v).transpose(1, 2).reshape(B, S, D)
            return self.out_proj(out), (w if output_attentions else None)

    class CLIPEncoderLayer(nn.Module):
        def __init__(self, D, H, I):
            super().__init__()
            self.self_attn = CLIPAttention(D, H)
            self.layer_norm1, self.layer_norm2 = (nn.LayerNorm(D),
                                                  nn.LayerNorm(D))
            self.fc1, self.fc2 = nn.Linear(D, I), nn.Linear(I, D)

        def forward(self, x, causal):
            x = x + self.self_attn(self.layer_norm1(x),
                                   causal_attention_mask=causal)[0]
            h = self.fc1(self.layer_norm2(x))
            return x + self.fc2(h * torch.sigmoid(1.702 * h))  # quick_gelu

    class CLIPTextTransformer(nn.Module):
        def __init__(self, vocab, D, L, H, I, S):
            super().__init__()
            self.token_embedding = nn.Embedding(vocab, D)
            self.position_embedding = nn.Embedding(S, D)
            self.layers = nn.ModuleList(CLIPEncoderLayer(D, H, I)
                                        for _ in range(L))
            self.final_layer_norm = nn.LayerNorm(D)

        def forward(self, ids):
            B, S = ids.shape
            x = self.token_embedding(ids) + self.position_embedding(
                torch.arange(S, device=ids.device))[None]
            low = torch.finfo(x.dtype).min
            causal = torch.full((S, S), low, dtype=x.dtype,
                                device=x.device).triu(1)[None, None]
            causal = causal.expand(B, 1, S, S)
            for layer in self.layers:
                x = layer(x, causal)
            return self.final_layer_norm(x)

    class Attention(nn.Module):
        def __init__(self, dim, heads, dim_head, cross_dim=None):
            super().__init__()
            inner = heads * dim_head
            self.heads, self.scale = heads, dim_head ** -0.5
            self.group_norm = self.spatial_norm = None
            self.residual_connection, self.rescale_output_factor = (False,
                                                                    1.0)
            self.to_q = nn.Linear(dim, inner, bias=False)
            self.to_k = nn.Linear(cross_dim or dim, inner, bias=False)
            self.to_v = nn.Linear(cross_dim or dim, inner, bias=False)
            self.to_out = nn.ModuleList([nn.Linear(inner, dim),
                                         nn.Dropout(0.0)])

        def forward(self, hidden_states, encoder_hidden_states=None,
                    attention_mask=None, **cross_attention_kwargs):
            B, S, _ = hidden_states.shape
            ctx = hidden_states if encoder_hidden_states is None \
                else encoder_hidden_states
            q = self.to_q(hidden_states).view(B, S, self.heads, -1)
            k = self.to_k(ctx).view(B, ctx.shape[1], self.heads, -1)
            v = self.to_v(ctx).view(B, ctx.shape[1], self.heads, -1)
            q, k, v = (t.transpose(1, 2) for t in (q, k, v))
            w = torch.softmax((q @ k.transpose(-1, -2)) * self.scale,
                              dim=-1, dtype=torch.float32).to(q.dtype)
            out = (w @ v).transpose(1, 2).reshape(B, S, -1)
            for m in self.to_out:
                out = m(out)
            return out

    return CLIPTextTransformer, Attention


def _call_stats(torch, fn, iters=3):
    """(output, ms a call, peak bytes above what was allocated before)."""
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with torch.no_grad():
        out = fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        ms = cuda_ms(fn, iters, warmup=1)
    return out, ms, peak


def _injection_case(torch, gen, smi):
    """(c): ``generic_injection`` over the CLIP text encoder and the UNet's
    top-level attention."""
    import functools
    from deepspeed_tpu_torch import module_inject
    from deepspeed_tpu_torch.module_inject import diffusers_injection as di
    from deepspeed_tpu_torch.ops.attention import attention_core
    CLIP, Attention = _clip_modules(torch)
    c = CLIP_L14
    enc = CLIP(c["vocab"], c["D"], c["L"], c["H"], c["I"], c["S"]).to(
        "cuda", torch.float16).eval()
    with torch.no_grad():
        for p in enc.parameters():
            p.copy_(0.02 * torch.randn(p.shape, device="cuda",
                                       generator=gen))
    ids = torch.randint(0, c["vocab"], (c["B"], c["S"]), device="cuda",
                        generator=gen)
    fa = _flash_counters()
    plain_core = functools.partial(attention_core, use_kernel=False)
    res = {}

    def run(tag, module, call, plain=False):
        count = {}
        if plain:
            di.attention_core = plain_core
        try:
            with module_inject.fused_attention(counter=count, module=module):
                _zeroed(fa)
                out, ms, peak = _call_stats(torch, call)
                launches = _counts(fa)
        finally:
            di.attention_core = attention_core
        res[tag] = dict(ms=ms, peak_bytes=peak, launches=launches,
                        counts=count)
        return out

    clip_ref, ms, peak = _call_stats(torch, lambda: enc(ids))
    res["clip_unfused"] = dict(ms=ms, peak_bytes=peak)
    clip_fused = run("clip_fused", enc, lambda: enc(ids))
    clip_plain = run("clip_plain", enc, lambda: enc(ids), plain=True)
    u = UNET_TOP
    tokens = u["side"] * u["side"]
    attn1 = Attention(u["C"], u["H"], u["C"] // u["H"]).to(
        "cuda", torch.float16).eval()
    attn2 = Attention(u["C"], u["H"], u["C"] // u["H"],
                      cross_dim=u["ctx_dim"]).to("cuda", torch.float16).eval()
    with torch.no_grad():
        for p in list(attn1.parameters()) + list(attn2.parameters()):
            p.copy_(0.05 * torch.randn(p.shape, device="cuda",
                                       generator=gen))
    x = torch.randn(u["B"], tokens, u["C"], device="cuda", generator=gen,
                    dtype=torch.float16)
    ctx = torch.randn(u["B"], u["ctx"], u["ctx_dim"], device="cuda",
                      generator=gen, dtype=torch.float16)
    unet_ref, ms, peak = _call_stats(torch, lambda: attn1(x))
    res["unet_unfused"] = dict(ms=ms, peak_bytes=peak)
    unet_fused = run("unet_fused", attn1, lambda: attn1(x))
    unet_plain = run("unet_plain", attn1, lambda: attn1(x), plain=True)
    cross_ref, ms, peak = _call_stats(torch, lambda: attn2(x, ctx))
    res["cross_unfused"] = dict(ms=ms, peak_bytes=peak)
    cross = run("cross", attn2, lambda: attn2(x, ctx))
    errs = _hold(torch, "injection", {
        "clip_vs_module": (clip_fused, clip_ref),
        "clip_vs_plain": (clip_fused, clip_plain),
        "unet_vs_module": (unet_fused, unet_ref),
        "unet_vs_plain": (unet_fused, unet_plain)})
    cross_equal = torch.equal(cross, cross_ref)
    calls = 5     # _call_stats: one call, then 1 warm-up and 3 timed
    log(f"[tp-compose] (c) injection, fp16: CLIP ViT-L/14 text encoder "
        f"({c['L']} layers, {c['H']} heads of {c['D'] // c['H']}, "
        f"{c['S']} tokens, causal, B {c['B']}) fused "
        f"{res['clip_fused']['ms']:.3f} ms (peak "
        f"{res['clip_fused']['peak_bytes'] / 2**20:.1f} MiB) against the "
        f"module's own {res['clip_unfused']['ms']:.3f} ms "
        f"({res['clip_unfused']['peak_bytes'] / 2**20:.1f} MiB), counts "
        f"{res['clip_fused']['counts']}, B1 launches "
        f"{res['clip_fused']['launches']} | SD 2.1 UNet top self-attention "
        f"({u['C']} channels, {u['H']} heads of {u['C'] // u['H']}, "
        f"{tokens} tokens, B {u['B']}) fused {res['unet_fused']['ms']:.3f} "
        f"ms (peak {res['unet_fused']['peak_bytes'] / 2**20:.1f} MiB) "
        f"against {res['unet_unfused']['ms']:.3f} ms "
        f"({res['unet_unfused']['peak_bytes'] / 2**20:.1f} MiB), counts "
        f"{res['unet_fused']['counts']}, B1 launches "
        f"{res['unet_fused']['launches']} | cross-attention to "
        f"{u['ctx']} × {u['ctx_dim']}: counts {res['cross']['counts']}, "
        f"bit-equal to the module {cross_equal} | {_fmt_errs(errs)} "
        f"(tol 2^-7 of the norm, 2^-5 of the largest) | {smi}")
    want = {"clip_fused": {"fused": c["L"] * calls},
            "unet_fused": {"fused": calls}, "cross": {"fallback": calls}}
    for tag, counts in want.items():
        if res[tag]["counts"] != counts:
            raise AssertionError(f"{tag}: counts {res[tag]['counts']}, "
                                 f"want {counts}")
    if res["clip_fused"]["launches"]["fwd"] != c["L"] * calls or \
            res["unet_fused"]["launches"]["fwd"] != calls or \
            res["cross"]["launches"]["fwd"] or \
            res["unet_plain"]["launches"]["fwd"] or not cross_equal:
        raise AssertionError(f"injection launches {res}")
    # a kernel that fails raises: no fallback around the fused path
    def broken(*a, **k):
        raise RuntimeError("forced kernel failure")

    di.attention_core = broken
    try:
        with module_inject.fused_attention(module=attn1):
            attn1(x[:, :256])
        raised = False
    except RuntimeError:
        raised = True
    finally:
        di.attention_core = attention_core
    if not raised:
        raise AssertionError("a failing fused attention did not raise")
    res["errs"] = errs
    res["forced_failure_raised"] = raised
    del enc, attn1, attn2, x, ctx
    _free(torch)
    return res


def _gpt2_head_case(torch, gen):
    """(d): the vocabulary-parallel chunked loss at tp 1 on GPT-2 350M's
    tied head, padded by :data:`PAD_ROWS` rows, in fp32 (GPT-2's chunked
    loss runs in fp32, JAX ``gpt2.py:118-122``)."""
    from deepspeed_tpu_torch.sequence.cross_entropy import (
        fused_linear_cross_entropy, softmax_cross_entropy_with_logits)
    N, D, V, ch = (GPT2_HEAD[k] for k in ("N", "D", "V", "chunk"))
    x = torch.randn(N, D, device="cuda", generator=gen).requires_grad_()
    w = torch.cat([0.02 * torch.randn(V, D, device="cuda", generator=gen),
                   torch.zeros(PAD_ROWS, D, device="cuda")]).requires_grad_()
    labels = torch.randint(0, V, (N, ), device="cuda", generator=gen)
    from deepspeed_tpu_torch.accelerator import full_fp32_matmul

    def full():
        with full_fp32_matmul():
            return softmax_cross_entropy_with_logits(
                x @ w[:V].t(), labels).mean()

    paths = {"padded_chunked": lambda: fused_linear_cross_entropy(
        x, w.t(), labels, ch, torch.float32, tp=(None, 0, V)).mean(),
             "full": full}
    res = {}
    for name, fn in paths.items():
        _free(torch)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        loss = fn()
        dx, dw = torch.autograd.grad(loss, (x, w))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        ms = cuda_ms(lambda: torch.autograd.grad(fn(), (x, w)), 3)
        res[name] = dict(loss=loss.item(), dx=dx, dw=dw, peak_bytes=peak,
                         ms=ms)
    f, p = res["padded_chunked"], res["full"]
    rel = {k: ((f[k] - p[k]).norm() / p[k].norm()).item()
           for k in ("dx", "dw")}
    rel["loss"] = abs(f["loss"] - p["loss"]) / abs(p["loss"])
    pad_grad = f["dw"][V:].abs().max().item()
    log(f"[tp-compose] (d) vocabulary-parallel chunked loss at tp 1, GPT-2 "
        f"350M's head (N {N}, D {D}, V {V} + {PAD_ROWS} pad rows, chunks of "
        f"{ch}, fp32): loss {f['loss']:.6f} against the full logits' "
        f"{p['loss']:.6f} | relative to the norm: " + ", ".join(
            f"{k} {v:.2e}" for k, v in rel.items()) + f" (tol 1e-4) | pad "
        f"rows' gradient max {pad_grad} | fwd+bwd {f['ms']:.3f} ms against "
        f"{p['ms']:.3f} | peak above the inputs "
        f"{f['peak_bytes'] / 2**30:.3f} GiB against "
        f"{p['peak_bytes'] / 2**30:.3f}")
    if max(rel.values()) > HEAD_FP32_RTOL or pad_grad != 0.0:
        raise AssertionError(f"padded chunked loss {rel}, pad grad "
                             f"{pad_grad}")
    for r in res.values():
        del r["dx"], r["dw"]
    del x, w
    _free(torch)
    return dict(rel=rel, **res)


def stage_tp_compose(seed, smi, train, gpt2):
    import numpy as np
    import torch
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed + 35)
    out = dict(domino=_domino_case(torch, np, seed, train, smi))
    out["gpt2_tp1"] = _gpt2_tp1(torch, np, seed, gpt2)
    out["bert_tp1"] = _bert_tp1(torch, np, seed)
    out["injection"] = _injection_case(torch, gen, smi)
    out["gpt2_head"] = _gpt2_head_case(torch, gen)
    out["seconds"] = time.perf_counter() - t0
    log(f"[tp-compose] stage 35 took {out['seconds']:.1f} s | {smi}")
    return out


# ---------------------------------------------------------------- stage 36
def _ep_local_sizes(torch, gen, tokens, E, k, ep):
    """The group sizes on ep rank 0 of Mixtral's exchange: ep × ``tokens``
    gathered tokens routed top-k by a random router over E experts, the
    copies that reach rank 0's E/ep experts (``moe_apply``'s ``mine``)."""
    logits = torch.randn(ep * tokens, E, device="cuda", generator=gen)
    topi = torch.topk(logits, k, dim=-1).indices.reshape(-1)
    return torch.bincount(topi, minlength=E)[:E // ep].tolist()


def _ffn_dead_rows(torch, gen, sizes, rows, D, I):
    """(a), the rows past the sizes: one layer's expert FFN
    (``moe_expert_ffn``: B7 on w1 and w3, SwiGLU, B7 on w2, and their
    backward) on ep rank 0's gathered copies at ep 4 ([rows, D], the live
    ones first) against the same live rows alone.  Forward ms, forward +
    backward ms and the peak bytes above the inputs of each; the live
    rows' outputs and gradients of the two within one bf16 ulp, the dead
    rows' outputs and input gradients zero.  Under remat a layer runs its
    forward twice, so the dead rows cost Δforward + Δ(forward + backward)
    a layer a step."""
    from deepspeed_tpu_torch.models.mixtral import moe_expert_ffn
    dt = torch.bfloat16
    live, E = sum(sizes), len(sizes)
    gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
    ws = [(torch.randn(E, a, b, device="cuda", generator=gen) / a**0.5)
          .to(dt).requires_grad_() for a, b in ((D, I), (I, D), (D, I))]
    x_all = torch.randn(rows, D, device="cuda", generator=gen).to(dt)
    # the main path's output gradient: zero past the sizes (their
    # routing weights are zero)
    dy_all = torch.randn(rows, D, device="cuda", generator=gen).to(dt)
    dy_all[live:] = 0
    res, grads = {}, {}
    for tag, n in (("gathered", rows), ("live", live)):
        x = x_all[:n].clone().requires_grad_()
        dy = dy_all[:n].contiguous()

        def fwd():
            with torch.no_grad():
                return moe_expert_ffn(x, gs, *ws)

        def step():
            y = moe_expert_ffn(x, gs, *ws)
            return (y, ) + torch.autograd.grad(y, [x] + ws, dy)

        fwd_ms = cuda_ms(fwd, 5)
        step_ms = cuda_ms(step, 3)
        _free(torch)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        grads[tag] = step()
        torch.cuda.synchronize()
        res[tag] = dict(rows=n, fwd_ms=fwd_ms, fwd_bwd_ms=step_ms,
                        peak_bytes=torch.cuda.max_memory_allocated() - base)
        del x, dy
    (yg, dxg, *dwg), (yl, dxl, *dwl) = grads["gathered"], grads["live"]
    worst = max(_compare(torch, a[:live], b, True)[1]
                for a, b in ((yg, yl), (dxg, dxl)))
    worst = max([worst] + [_compare(torch, a, b, True)[1]
                           for a, b in zip(dwg, dwl)])
    dead_zero = bool((yg[live:] == 0).all() and (dxg[live:] == 0).all())
    del grads, yg, dxg, dwg, yl, dxl, dwl, ws, x_all, dy_all
    _free(torch)
    g, lv = res["gathered"], res["live"]
    out = dict(sizes=sizes, rows=rows, live_rows=live, gathered=g, live=lv,
               worst_over_tol=worst, dead_rows_zero=dead_zero,
               extra_ms_a_layer_step=(g["fwd_ms"] - lv["fwd_ms"])
               + (g["fwd_bwd_ms"] - lv["fwd_bwd_ms"]),
               extra_peak_bytes=g["peak_bytes"] - lv["peak_bytes"])
    log(f"[moe-parallel] expert FFN at ep 4, rank 0's gathered copies "
        f"[{rows}, {D}] (groups {sizes}, {rows - live} rows past them) "
        f"against the {live} live rows alone: forward {g['fwd_ms']:.4f} "
        f"against {lv['fwd_ms']:.4f} ms, forward + backward "
        f"{g['fwd_bwd_ms']:.4f} against {lv['fwd_bwd_ms']:.4f} ms, peak "
        f"above the inputs {g['peak_bytes'] / 2**30:.3f} against "
        f"{lv['peak_bytes'] / 2**30:.3f} GiB | the dead rows cost "
        f"{out['extra_ms_a_layer_step']:.4f} ms a layer a step under remat "
        f"(Δforward + Δ(forward + backward)) and "
        f"{out['extra_peak_bytes'] / 2**30:.3f} GiB | live rows within "
        f"{worst:.3f} of one bf16 ulp, dead rows zero {dead_zero}")
    if not (worst <= 1.0 and dead_zero):
        raise AssertionError(f"the expert FFN on rows past the sizes: worst "
                             f"{worst}, dead rows zero {dead_zero}")
    return out


def stage_moe_parallel_kernels(seed):
    """Stage 36 (a): B7's forward, dx and dw at the shapes Mixtral-8x7B's
    training gives them at tp 2 and tp 4 ([8, 4096, 14336 / tp] and
    [8, 14336 / tp, 4096], T = 16,384 token copies over 8 experts, one
    empty), at ep 4 on compact rows (a rank's 2 experts, [2, 4096, 14336]
    and [2, 14336, 4096], T = 16,384, one of the two empty) and at ep 4 as
    the exchange hands them over (``ep4main``: the 65,536 gathered copies
    of 4 ranks' 8192 tokens, about a quarter of them routed to this
    rank's experts by a random router, the rest past the sizes), each
    against its plain version (``_gmm_case``, ``_gmm_bwd_case``); then the
    whole expert FFN on those gathered rows against the live ones alone
    (:func:`_ffn_dead_rows`)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed + 36)
    D, I, E, k, tokens, ep = 4096, 14336, 8, 2, 8192, 4
    sizes8 = _routed_sizes(torch, gen, tokens, E, k, empty=2)
    main = _ep_local_sizes(torch, gen, tokens, E, k, ep)
    shapes = [("tp2", sizes8, I // 2, None), ("tp4", sizes8, I // 4, None),
              ("ep4", [tokens * k, 0], I, None),
              ("ep4main", main, I, ep * tokens * k)]
    rows = []
    for tag, sizes, inner, n in shapes:
        for proj, K, N in (("w1", D, inner), ("w2", inner, D)):
            rows.append(dict(_gmm_case(torch, gen, f"{tag}_{proj}", sizes,
                                       K, N, "bfloat16", "wgmma_tma",
                                       rows=n), kind="fwd"))
            _free(torch)
            for kind in ("dx", "dw"):
                row = _gmm_bwd_case(torch, gen, kind, proj, sizes, K, N,
                                    rows=n)
                row["case"] = f"{tag}_{row['case']}"
                rows.append(row)
                _free(torch)
    ffn = _ffn_dead_rows(torch, gen, main, ep * tokens * k, D, I)
    return rows, ffn


def _mixtral_split_codes(torch, np, seed, moe_train):
    """(b): stage 31 (b)'s Mixtral (full width, one layer, B=4, S=2048,
    the same seed and ids) with each MoE block cut by ``tp_rules`` over a
    one-rank tp group and localized to all its experts over a one-rank ep
    group, so that the exchange's code runs (its gathers and its
    reduce-scatter the identity, the copies routed elsewhere none): the
    losses and the B7 launches by route must be stage 31 (b)'s."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.comm.backend import ProcessGroup
    from deepspeed_tpu_torch.models.mixtral import (MixtralConfig,
                                                    MixtralModel, tp_rules)
    from deepspeed_tpu_torch.module_inject import shard_params_for_tp
    from deepspeed_tpu_torch.ops.kernels import grouped_matmul as gm
    B, S = 4, 2048
    cfg = MixtralConfig(**dict(MIXTRAL_TRAIN, num_hidden_layers=1))
    model = shard_params_for_tp(MixtralModel(cfg, device="meta"),
                                tp_rules(cfg), group=_local_tp_group())
    ep_group = ProcessGroup(("ep", ), local=True)
    for layer in model.model.layers:
        layer.block_sparse_moe.localize(0, cfg.num_local_experts, ep_group)
    engine = deepspeed_tpu_torch.initialize(model=model,
                                            config=dict(TRAIN_CONFIG))[0]
    engine.initialize_parameters(seed)
    ids = torch.from_numpy(np.random.default_rng(seed + 31).integers(
        0, cfg.vocab_size, size=(B, S))).cuda()
    for fn in ("gmm", "gmm_dx", "gmm_dw"):
        getattr(gm, fn).route_launches = dict.fromkeys(
            getattr(gm, fn).route_launches, 0)
    steps = len(moe_train["losses"])
    losses, times, launches, peak = _timed_steps(torch, engine, [(ids, ids)],
                                                 1, steps - 1)
    routes = {fn: {r: n for r, n in getattr(gm, fn).route_launches.items()
                   if n} for fn in ("gmm", "gmm_dx", "gmm_dw")}
    rows = [int(n) for n in
            engine.module.model.layers[0].block_sparse_moe.routed_rows]
    del engine, model
    _free(torch)
    same = losses == moe_train["losses"]
    log(f"[moe-parallel] Mixtral-8x7B width, one layer, through the tp code "
        f"at tp 1 and the ep code at ep 1: losses {losses} (stage 31 (b): "
        f"{moe_train['losses']}, bit-equal {same}) | step ms "
        + ", ".join(f"{t * 1e3:.1f}" for t in times)
        + f" | routed rows a local expert at the last step {rows} | launches "
        f"{launches}, by route {routes}")
    if not same or launches != moe_train["launches"] or \
            routes != moe_train["route_launches"]:
        raise AssertionError(
            f"the ep and tp code at 1 rank changed stage 31 (b)'s run: "
            f"losses {losses}, launches {launches} by route {routes}")
    return dict(losses=losses, step_ms=[t * 1e3 for t in times],
                launches=launches, route_launches=routes, peak_bytes=peak,
                routed_rows=rows)


def _moe_declines(torch, np, seed):
    """(c): the MoE layer under qgZ with the 2-hop int8 dispatch asked for,
    on the NCCL world of one rank: the per-rank path (a token group of one
    rank) and the 2-hop split (no ep group to split) both decline, each
    counted once, and the run is the flat one's."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.moe import engine as moe_engine
    from zero_multicard import moe_layer_model
    D, T = 1024, 2048
    rng = np.random.default_rng(seed + 36)
    x = torch.from_numpy(rng.standard_normal((T, D)).astype(
        np.float32)).cuda()
    y = torch.tanh(x * 0.5)
    runs = {}
    for name, extra in (
            ("flat", {}),
            ("asked", dict(moe={"enabled": True, "quantized_dispatch": True,
                                "wire_dtype": "int8", "intra_node_size": 2},
                           zero_optimization={
                               "stage": 2,
                               "zero_quantized_gradients": True}))):
        before = dict(moe_engine.declines)
        model, start = moe_layer_model(torch, D, seed + 36)
        eng = deepspeed_tpu_torch.initialize(
            model=model, model_parameters=start, config=dict(
                TRAIN_CONFIG, train_micro_batch_size_per_gpu=T,
                **extra))[0]
        loss = eng(x, y)
        eng.backward(loss)
        eng.step()
        runs[name] = dict(loss=loss.item(), declines={
            k: moe_engine.declines[k] - before[k] for k in before})
        del eng, model, start
        _free(torch)
    moe_engine.reset()
    log(f"[moe-parallel] MoE layer (hidden {D}, {T} tokens) under qgZ with "
        f"the 2-hop int8 dispatch asked for, NCCL world 1: declines "
        f"{runs['asked']['declines']}, loss {runs['asked']['loss']} against "
        f"the flat run's {runs['flat']['loss']}")
    if runs["asked"]["declines"] != {"per_rank": 1, "two_hop": 1} or \
            runs["asked"]["loss"] != runs["flat"]["loss"]:
        raise AssertionError(f"the per-rank and 2-hop paths at world 1: "
                             f"{runs}")
    return runs


def stage_moe_parallel(seed, smi, moe_train):
    """Stage 36: item 8b on one card.  (a) B7 at the tp-local and ep-local
    shapes; (b) stage 31 (b)'s Mixtral through the tp and ep code at one
    rank, bit-equal; (c) the qgZ micro's per-rank path and the 2-hop
    dispatch declining at world 1."""
    import numpy as np
    import torch
    t0 = time.perf_counter()
    kernels, ffn = stage_moe_parallel_kernels(seed)
    out = dict(kernels=kernels, dead_rows=ffn,
               split_codes=_mixtral_split_codes(torch, np, seed, moe_train),
               declines=_moe_declines(torch, np, seed))
    out["seconds"] = time.perf_counter() - t0
    log(f"[moe-parallel] stage 36 took {out['seconds']:.1f} s | {smi}")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", help="also write every number to this file")
    ap.add_argument("--profile", metavar="DIR",
                    help="also profile a prefill and a decode window of "
                         "each serving engine and two steps of each training "
                         "path; write kernel tables to DIR")
    args = ap.parse_args()

    if not os.path.isdir(os.path.join(REPO, "deepspeed_tpu_torch")):
        print("chip_smoke: deepspeed_tpu_torch is not beside this script",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    for var, what in (("DS_TPU_DISABLE_PALLAS_ATTN", "attention kernels"),
                      ("DS_TPU_DISABLE_PALLAS_PAGED",
                       "paged attention kernel")):
        if os.environ.get(var):
            # the user's switch that turns kernels off: the launch counts
            # below would fail for a reason not the code's
            print(f"chip_smoke: unset {var}, which turns the {what} off",
                  file=sys.stderr)
            return 2
    sys.path.insert(0, REPO)
    t_start = time.perf_counter()

    smi = stage_environment()
    stage_build()
    # the Evoformer window first: late in the process the profiler kept
    # only a few of its records (profile_evoformer)
    evo_profile = (profile_evoformer(args.seed, smi, args.profile)
                   if args.profile else None)
    kernels = stage_kernels(args.seed)
    serve = stage_serve(args.seed, smi, args.profile)
    step = stage_step_vs_plain(args.seed)
    stage_hf_dir(args.seed)
    train_kernels = stage_train_kernels(args.seed)
    train = stage_train(args.seed, smi, args.profile)
    train_step = stage_train_step_vs_plain(args.seed)
    gpt2_kernels = stage_gpt2_kernels(args.seed)
    gpt2 = stage_gpt2_train(args.seed, smi, args.profile)
    overflow = stage_overflow_and_guard(args.seed)
    moe_quant_kernels = stage_moe_quant_kernels(args.seed)
    mixtral = stage_mixtral_serve(args.seed, smi, args.profile)
    quant = stage_quant_serve(args.seed, smi, serve["peak_bytes"],
                              args.profile)
    moe_quant_step = stage_moe_quant_step_vs_plain(args.seed)
    evo_kernels = stage_evoformer_kernels(args.seed)
    evo = stage_evoformer(args.seed)
    if args.profile:
        evo["profile"] = evo_profile
    sparse_kernels = stage_sparse_kernels(args.seed)
    sparse = stage_sparse_attention(args.seed, smi)
    fpq = stage_fp_quant(args.seed, smi)
    bert = stage_bert_train(args.seed, smi, args.profile)
    gpt2_zero1 = stage_gpt2_zero1(args.seed, smi, args.profile)
    llama_zero2 = stage_llama_zero2(args.seed, smi, train["peak_bytes"],
                                    args.profile)
    llama_zero3 = stage_llama_zero3(args.seed, smi,
                                    llama_zero2.pop("zero0"), args.profile)
    save_resume = stage_save_resume(args.seed, smi)
    offload = stage_offload(args.seed, smi)
    zeropp = stage_zeropp(args.seed, smi, llama_zero3)
    pipe = stage_pipeline(args.seed, smi)
    uni_onebit = stage_universal_onebit(args.seed, smi)
    moe_train = stage_moe_train(args.seed, smi)
    pipe_zero = stage_pipeline_zero(args.seed, smi)
    tp = stage_tp(args.seed, smi, train, serve)
    long_ctx = stage_long_context(args.seed, smi, train)
    tp_compose = stage_tp_compose(args.seed, smi, train, gpt2)
    moe_parallel = stage_moe_parallel(args.seed, smi, moe_train)

    entries = []
    for wrapper, case in (("paged_attention", "serve_decode"),
                          ("paged_attention_atoms", "serve_prefill")):
        row = next(r for r in kernels if r["case"] == case)
        # launches_by_route: stage 4's run; kernel_route: this case's
        entries.append(dict(
            name=wrapper, route="cuda",
            source="deepspeed_tpu_torch/csrc/paged_attention.cu",
            replaces=f"deepspeed_tpu/ops/pallas/paged_attention.py:"
                     f"{row['line']}",
            launches=serve["launches"][wrapper], max_abs_err=row["err"],
            ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"], kernel_route=row["route"],
            launches_by_route=serve["route_launches"][wrapper],
            tflops=row["tflops"]))
    flash = next(r for r in train_kernels if r["case"] == "train")
    adam = next(r for r in train_kernels if r["case"] == "adam_8L_7b")
    src = "deepspeed_tpu/ops/pallas/"
    launches = train["launches"]
    entries += [
        dict(name="flash_attention", route="cuda",
             source="deepspeed_tpu_torch/csrc/flash_attention.cu",
             replaces=src + "flash_attention.py:185",
             launches=launches["flash_attention"],
             max_abs_err=flash["err_fwd"], ms=flash["ms_fwd"],
             plain_ms=flash["plain_ms_fwd"], bound_ms=flash["bound_fwd"][0],
             bound_by=flash["bound_fwd"][1],
             library_ms=flash["library_ms_fwd"], tflops=flash["tflops_fwd"]),
        # dq (:321) and dk/dv (:348): two launches per backward; ms is
        # their sum, library_ms SDPA's forward+backward less its forward
        dict(name="flash_attention_bwd", route="cuda",
             source="deepspeed_tpu_torch/csrc/flash_attention.cu",
             replaces=src + "flash_attention.py:321",
             replaces_dkv=src + "flash_attention.py:348",
             launches=(launches["flash_attention_bwd_dq"] +
                       launches["flash_attention_bwd_dkv"]),
             launches_dq=launches["flash_attention_bwd_dq"],
             launches_dkv=launches["flash_attention_bwd_dkv"],
             max_abs_err=flash["err_bwd"],
             ms=flash["ms_dq"] + flash["ms_dkv"], ms_dq=flash["ms_dq"],
             ms_dkv=flash["ms_dkv"], plain_ms=flash["plain_ms_bwd"],
             bound_ms=flash["bound_bwd"][0], bound_by=flash["bound_bwd"][1],
             library_ms=flash["library_ms_bwd"], tflops=flash["tflops_bwd"]),
        # launches: stage 8's run; the BERT (stage 22), ZeRO-1 (23) and
        # ZeRO-2 (24) paths' counts under their own keys, each counted
        # from 0 around its run
        dict(name="fused_adam_step", route="cuda",
             source="deepspeed_tpu_torch/csrc/optimizers.cu",
             replaces=src + "optimizers.py:100",
             launches=launches["fused_adam_step"], max_abs_err=adam["err"],
             ms=adam["ms"], plain_ms=adam["plain_ms"],
             bound_ms=adam["bound"][0], bound_by=adam["bound"][1],
             library_ms=adam["library_ms"],
             launches_bert=bert["launches"]["fused_adam_step"],
             launches_gpt2_zero1=gpt2_zero1["launches"]["fused_adam_step"],
             launches_llama_zero2=llama_zero2["launches"][
                 "fused_adam_step"],
             launches_llama_zero3=llama_zero3["launches"][
                 "fused_adam_step"]),
    ]
    for key, run in (("launches_llama_zero2", llama_zero2),
                     ("launches_llama_zero3", llama_zero3)):
        entries[-3][key] = run["launches"]["flash_attention_fwd"]
        entries[-2][key] = (run["launches"]["flash_attention_bwd_dq"] +
                            run["launches"]["flash_attention_bwd_dkv"])
    # stage 26: both runs after each save, both configurations
    resumed = {}
    for r in save_resume.values():
        for counts in (r["launches"], r["launches_resumed"]):
            for k, n in counts.items():
                resumed[k] = resumed.get(k, 0) + n
    entries[-3]["launches_save_resume"] = resumed["flash_attention_fwd"]
    entries[-2]["launches_save_resume"] = (
        resumed["flash_attention_bwd_dq"] +
        resumed["flash_attention_bwd_dkv"])
    entries[-1]["launches_save_resume"] = resumed["fused_adam_step"]
    # stage 27: B1 in (a)'s streamed steps, B2 and B3 in (c)'s runs on
    # pinned state
    streamed = offload["infinity"]["launches"]
    entries[-3]["launches_offload"] = streamed["flash_attention_fwd"]
    entries[-2]["launches_offload"] = (streamed["flash_attention_bwd_dq"] +
                                       streamed["flash_attention_bwd_dkv"])
    entries[-1]["launches_offload"] = offload["zero3"]["fusedadam"][
        "offload"]["launches"]["fused_adam_step"]
    # stage 29: B1 under DistributedAttention (a) and B1, B2 in the
    # pipeline's steps (b), each counted from 0 around its run; B1 at the
    # sp = 2 Ulysses shape [1, 2048, 20, 128] under *_ulysses
    counted, ul = pipe["pipeline"]["launches"], pipe["ulysses"]
    entries[-3].update(
        launches_pipeline=counted["flash_attention_fwd"],
        launches_ulysses=pipe["attention"]["launches"]["flash_attention_fwd"],
        ms_ulysses=ul["ms_fwd"], plain_ms_ulysses=ul["plain_ms_fwd"],
        bound_ms_ulysses=ul["bound_fwd"][0], library_ms_ulysses=ul[
            "library_ms_fwd"], max_abs_err_ulysses=ul["err_fwd"])
    entries[-2].update(
        launches_pipeline=(counted["flash_attention_bwd_dq"] +
                           counted["flash_attention_bwd_dkv"]),
        launches_ulysses=(
            pipe["attention"]["launches"]["flash_attention_bwd_dq"] +
            pipe["attention"]["launches"]["flash_attention_bwd_dkv"]),
        ms_ulysses=ul["ms_dq"] + ul["ms_dkv"],
        plain_ms_ulysses=ul["plain_ms_bwd"],
        bound_ms_ulysses=ul["bound_bwd"][0],
        library_ms_ulysses=ul["library_ms_bwd"],
        max_abs_err_ulysses=ul["err_bwd"])
    entries[-1]["launches_pipeline"] = counted["fused_adam_step"]
    # stage 32: B1 and B2 in each pipeline ZeRO run's three steps, counted
    # from 0 around each run (the ZeRO-3 run's around its two legs about
    # the save), summed over the runs
    pz = [r["pipeline"]["launches"] for r in pipe_zero["runs"].values()]
    entries[-3]["launches_pipeline_zero"] = sum(
        c["flash_attention_fwd"] for c in pz)
    entries[-2]["launches_pipeline_zero"] = sum(
        c["flash_attention_bwd_dq"] + c["flash_attention_bwd_dkv"]
        for c in pz)
    entries[-1]["launches_pipeline_zero"] = sum(c["fused_adam_step"]
                                                for c in pz)
    # stage 30: B1 and B2 in the ZeRO-3 engine's two steps from the
    # universal tag, B1 in the streamed engine's, and B1 under the three
    # 1-bit optimizers' five steps each, each counted from 0 around its run
    z3u = uni_onebit["universal"]["zero3"]["launches"]
    stu = uni_onebit["universal"]["streamed"]["launches"]
    ob = uni_onebit["optimizers"]
    entries[-3].update(
        launches_universal_zero3=z3u["flash_attention_fwd"],
        launches_universal_streamed=stu["flash_attention_fwd"],
        launches_onebit=sum(r["launches"]["flash_attention_fwd"]
                            for r in ob.values()))
    entries[-2].update(
        launches_universal_zero3=(z3u["flash_attention_bwd_dq"] +
                                  z3u["flash_attention_bwd_dkv"]),
        launches_universal_streamed=(stu["flash_attention_bwd_dq"] +
                                     stu["flash_attention_bwd_dkv"]),
        launches_onebit=sum(r["launches"]["flash_attention_bwd_dq"] +
                            r["launches"]["flash_attention_bwd_dkv"]
                            for r in ob.values()))
    entries[-1]["launches_universal_zero3"] = z3u["fused_adam_step"]
    lamb = next(r for r in gpt2_kernels if r["case"] == "lamb_float32")
    lion = next(r for r in gpt2_kernels if r["case"] == "lion_float32")
    opt_src = "deepspeed_tpu_torch/csrc/optimizers.cu"
    # no PyTorch call computes LAMB or Lion: library_ms is null
    entries += [
        dict(name="fused_lamb_phase1", route="cuda", source=opt_src,
             replaces=src + "optimizers.py:224",
             launches=gpt2["launches"]["fused_lamb_phase1"],
             max_abs_err=lamb["err_phase1"], ms=lamb["ms_phase1"],
             plain_ms=lamb["plain_ms_phase1"],
             bound_ms=lamb["bound_phase1"][0],
             bound_by=lamb["bound_phase1"][1], library_ms=None,
             launches_llama_zero3=llama_zero3["lamb"]["launches"][
                 "fused_lamb_phase1"],
             launches_offload=offload["zero3"]["fusedlamb"]["offload"][
                 "launches"]["fused_lamb_phase1"]),
        dict(name="fused_lamb_phase2", route="cuda", source=opt_src,
             replaces=src + "optimizers.py:250",
             launches=gpt2["launches"]["fused_lamb_phase2"],
             max_abs_err=lamb["err_phase2"], ms=lamb["ms_phase2"],
             plain_ms=lamb["plain_ms_phase2"],
             bound_ms=lamb["bound_phase2"][0],
             bound_by=lamb["bound_phase2"][1], library_ms=None,
             launches_llama_zero3=llama_zero3["lamb"]["launches"][
                 "fused_lamb_phase2"],
             launches_offload=offload["zero3"]["fusedlamb"]["offload"][
                 "launches"]["fused_lamb_phase2"]),
        dict(name="fused_lion_step", route="cuda", source=opt_src,
             replaces=src + "optimizers.py:150",
             launches=gpt2["lion"]["launches"]["fused_lion_step"],
             max_abs_err=lion["err"], ms=lion["ms"],
             plain_ms=lion["plain_ms"], bound_ms=lion["bound"][0],
             bound_by=lion["bound"][1], library_ms=None),
    ]
    gmm_rows = {r["case"]: r for r in moe_quant_kernels["gmm"]}
    dec, pre = gmm_rows["decode_w1"], gmm_rows["prefill_w1"]
    qrow = next(r for r in moe_quant_kernels["quant"]
                if r["case"] == "bfloat16_int8_g128")
    qt_row = next(r for r in moe_quant_kernels["quant"]
                  if r["route"] == "transposed")
    qsrc = "deepspeed_tpu_torch/csrc/quantizer.cu"
    # gmm: the decode case (16 rows, w1's shape: most of the serving run's
    # launches); the prefill case's numbers ride along under *_prefill.
    # No PyTorch call quantizes blockwise: library_ms is null for B5.
    entries += [
        dict(name="gmm", route="cuda",
             source="deepspeed_tpu_torch/csrc/grouped_matmul.cu",
             replaces=src + "grouped_matmul.py:100",
             launches=mixtral["launches"]["gmm"], max_abs_err=dec["err"],
             ms=dec["ms"], plain_ms=dec["plain_ms"],
             bound_ms=dec["bound_ms"], bound_by=dec["bound_by"],
             library_ms=dec["library_ms"], library=dec["library"],
             launches_by_route=mixtral["route_launches"]["gmm"],
             ms_prefill=pre["ms"], plain_ms_prefill=pre["plain_ms"],
             bound_ms_prefill=pre["bound_ms"],
             bound_by_prefill=pre["bound_by"],
             library_ms_prefill=pre["library_ms"],
             **{f"{k}_{case}": gmm_rows[case][k]
                for case in ("decode_w2", "prefill_w2", "mma_k4064_w1",
                             "mma_unaligned_w1")
                for k in ("ms", "bound_ms", "library_ms")}),
    ]
    # stage 31: B7's backward, w1's products (w2's under *_w2); launches
    # from stage 31(b)'s Mixtral training steps; the forward's launches
    # there under launches_training
    bwd = {r["case"]: r for r in moe_train["kernels"]}
    for kind, wrapper in (("dx", "gmm_dx"), ("dw", "gmm_dw")):
        r, r2 = bwd[f"{kind}_w1"], bwd[f"{kind}_w2"]
        entries.append(dict(
            name=wrapper, route="cuda",
            source="deepspeed_tpu_torch/csrc/grouped_matmul.cu",
            replaces=src + "grouped_matmul.py:100",
            replaces_note="the gradient of the grouped matmul, which JAX "
                          "takes from XLA's transpose of lax.ragged_dot",
            launches=moe_train["launches"][wrapper],
            launches_by_route=moe_train["route_launches"][wrapper],
            max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], library=r["library"],
            tflops=r["tflops"], kernel_route=r["route"],
            max_abs_err_w2=r2["err"],
            **{f"{k}_w2": r2[k] for k in ("ms", "plain_ms", "bound_ms",
                                          "library_ms", "tflops")}))
    # dw's mma.sync route (the 16-bit shapes TMA cannot take), at w1
    r = bwd["dw_w1_mma_sync"]
    entries[-1].update(max_abs_err_mma_sync_w1=r["err"], **{
        f"{k}_mma_sync_w1": r[k] for k in ("ms", "plain_ms", "bound_ms",
                                           "library_ms", "tflops")})
    for e in entries:
        if e["name"] == "gmm":
            e.update(launches_training=moe_train["launches"]["gmm"],
                     launches_training_by_route=moe_train[
                         "route_launches"]["gmm"])
        elif e["name"] == "flash_attention":
            e["launches_mixtral_training"] = moe_train["launches"][
                "flash_attention_fwd"]
        elif e["name"] == "flash_attention_bwd":
            e["launches_mixtral_training"] = (
                moe_train["launches"]["flash_attention_bwd_dq"] +
                moe_train["launches"]["flash_attention_bwd_dkv"])
        elif e["name"] == "fused_adam_step":
            e["launches_mixtral_training"] = moe_train["launches"][
                "fused_adam_step"]
    entries += [
        # the Mixtral stack (contiguous route); the serving build's
        # p.t() of Llama-2-7B's gate projection under *_transposed
        dict(name="quantize_blockwise", route="cuda", source=qsrc,
             replaces=src + "quantizer.py:91",
             launches=quant["quantize_launches"],
             launches_by_route=quant["quantize_routes"],
             max_abs_err=qrow["err_q"],
             ms=qrow["ms_q"], plain_ms=qrow["plain_ms_q"],
             bound_ms=qrow["bound_q"][0], bound_by=qrow["bound_q"][1],
             library_ms=None, max_abs_err_transposed=qt_row["err_q"],
             ms_transposed=qt_row["ms_q"],
             plain_ms_transposed=qt_row["plain_ms_q"],
             bound_ms_transposed=qt_row["bound_q"][0],
             bound_by_transposed=qt_row["bound_q"][1],
             library_ms_transposed=None,
             quantize_tree_ms=quant["quantize_tree_ms"]),
        dict(name="dequantize_blockwise", route="cuda", source=qsrc,
             replaces=src + "quantizer.py:121",
             launches=quant["launches"]["dequantize_blockwise"],
             max_abs_err=qrow["err_d"], ms=qrow["ms_d"],
             plain_ms=qrow["plain_ms_d"], bound_ms=qrow["bound_d"][0],
             bound_by=qrow["bound_d"][1], library_ms=None),
    ]
    erow = next(r for r in evo_kernels if r["case"] == "msa_row_finetune")
    fsrc = "deepspeed_tpu_torch/csrc/flash_bias.cu"
    # launches: stage 18's timed calls; library_ms of the backward kernels
    # is SDPA's backward with the attn_mask gradient (fwd+bwd less fwd),
    # which computes dq, dk, dv and the bias gradient together
    entries.append(dict(
        name="flash_bias_fwd", route="cuda", source=fsrc,
        replaces=src + "flash_bias.py:261",
        launches=evo["launches"]["flash_bias_fwd"],
        max_abs_err=erow["errs"]["o"][0], ms=erow["ms_fwd"],
        plain_ms=erow["plain_ms_fwd"], bound_ms=erow["bound_fwd"][0],
        bound_by=erow["bound_fwd"][1], library_ms=erow["library_ms_fwd"]))
    for wrapper, line, key, errs in (
            ("flash_bias_bwd_dq", 302, "dq", ("dq", )),
            ("flash_bias_bwd_dkv", 315, "dkv", ("dk", "dv")),
            ("flash_bias_bwd_dbias", 337, "dbias", ("dbias", ))):
        entries.append(dict(
            name=wrapper, route="cuda", source=fsrc,
            replaces=src + f"flash_bias.py:{line}",
            launches=evo["launches"][wrapper],
            max_abs_err=max(erow["errs"][e][0] for e in errs),
            ms=erow[f"ms_{key}"], plain_ms=erow[f"plain_ms_{key}"],
            bound_ms=erow[f"bound_{key}"][0],
            bound_by=erow[f"bound_{key}"][1],
            library_ms=erow["library_ms_bwd"],
            library="SDPA backward with attn_mask grad (dq, dk, dv, dbias "
                    "together)"))
    bsa = {r["case"]: r for r in sparse_kernels}
    entry = dict(name="block_sparse_attention", route="cuda",
                 source="deepspeed_tpu_torch/csrc/block_sparse_attention.cu",
                 replaces=src + "block_sparse_attention.py:102",
                 launches=sparse["launches"])
    # case (a)'s numbers; (b)'s and (c)'s under suffixed keys; library_ms
    # is SDPA with the dense boolean mask the layout expands to
    for case, sfx in (("bigbird_base", ""), ("fixed_bert_large", "_fixed"),
                      ("fixed_bert_large_causal", "_fixed_causal")):
        r = bsa[case]
        entry.update({f"max_abs_err{sfx}": r["err"], f"ms{sfx}": r["ms"],
                      f"plain_ms{sfx}": r["plain_ms"],
                      f"bound_ms{sfx}": r["bound_ms"],
                      f"bound_by{sfx}": r["bound_by"],
                      f"library_ms{sfx}": r["library_ms"]})
    entries.append(entry)
    fq = {r["case"]: r for r in fpq["kernels"]}
    entry = dict(name="quantize_fp", route="cuda",
                 source="deepspeed_tpu_torch/csrc/fp_quantizer.cu",
                 replaces="deepspeed_tpu/ops/fp_quantizer.py:188",
                 launches=fpq["trees"]["fp6"]["launches"],
                 launches_fp12=fpq["trees"]["fp12"]["launches"])
    # the MLP leaf [4096, 11008] in bf16: fp6, fp12 suffixed.  No PyTorch
    # call computes this function: library_ms is null
    for fmt, sfx in (("fp6", ""), ("fp12", "_fp12")):
        r = fq[f"mlp_4096x11008_{fmt}_bfloat16"]
        entry.update({f"max_abs_err{sfx}": float(r["err"]),
                      f"ms{sfx}": r["ms"], f"plain_ms{sfx}": r["plain_ms"],
                      f"bound_ms{sfx}": r["bound_ms"],
                      f"bound_by{sfx}": r["bound_by"],
                      f"issue_ms{sfx}": r["issue_ms"],
                      f"library_ms{sfx}": None})
    entry.update(tree_s=fpq["trees"]["fp6"]["wall_s"],
                 tree_s_fp12=fpq["trees"]["fp12"]["wall_s"])
    entries.append(entry)
    # stage 28: B5 and B6 as ZeRO++'s wire codecs on a 7B-width block, (a)
    # and (b) counted from 0 around each call
    zp = {}
    for counts in [r["launches"] for r in zeropp["codecs"]] + [
            zeropp["primitive_launches"]]:
        for k, n in counts.items():
            zp[k] = zp.get(k, 0) + n
    block = {(r["fmt"], r["group_size"]): r for r in zeropp["codecs"]}
    for e in entries:
        if e["name"] == "quantize_blockwise":
            r = block[("int8", 2048)]
            e.update(launches_zeropp=zp.get("quantize_blockwise", 0),
                     launches_zeropp_by_route={
                         k[len("quantize_blockwise_"):]: n
                         for k, n in zp.items()
                         if k.startswith("quantize_blockwise_")},
                     ms_zeropp_block=r["ms_q"],
                     bound_ms_zeropp_block=r["bound_q"])
        elif e["name"] == "dequantize_blockwise":
            r = block[("int8", 2048)]
            e.update(launches_zeropp=zp.get("dequantize_blockwise", 0),
                     ms_zeropp_block=r["ms_d"],
                     bound_ms_zeropp_block=r["bound_d"])
        elif e["name"] == "quantize_fp":
            r = block[("fp6", 2048)]
            e.update(launches_zeropp=zp.get("quantize_fp_packed", 0),
                     ms_zeropp_block=r["ms_q"],
                     bound_ms_zeropp_block=r["bound_q"])
            r = block.get(("fp12", 2048))
            if r is not None:
                e.update(ms_zeropp_block_fp12=r["ms_q"],
                         bound_ms_zeropp_block_fp12=r["bound_q"])
    # stage 33: the tp-1 paths' launches, and the kernels' cases at the
    # tp-local shapes under *_<case> (route, error, ms, plain, library,
    # bound)
    keys = ("route", "err", "ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by")
    for e in entries:
        if e["name"] in ("paged_attention", "paged_attention_atoms"):
            e["launches_tp1_serve"] = tp["serve"]["launches"][e["name"]]
            for r in tp["paged"]:
                if r["wrapper"] == e["name"]:
                    e.update({f"{k}_{r['case']}": r[k] for k in keys})
        elif e["name"] == "gmm":
            for r in tp["gmm"]:
                e.update({f"{k}_{r['case']}": r[k] for k in keys})
        elif e["name"] == "flash_attention":
            e["launches_tp1_train"] = tp["train"]["launches"][
                "flash_attention"]
        elif e["name"] == "flash_attention_bwd":
            e["launches_tp1_train"] = (
                tp["train"]["launches"]["flash_attention_bwd_dq"] +
                tp["train"]["launches"]["flash_attention_bwd_dkv"])
        elif e["name"] == "fused_adam_step":
            e["launches_tp1_train"] = tp["train"]["launches"][
                "fused_adam_step"]
    # stage 34: B1 under the ring of four on one card (both cases), the
    # FPDT stream (double-buffered), chunked_attention, and B1 and B2 in
    # the two training runs (d), each counted from 0 around its run
    ring_n = [r["launches"] for r in long_ctx["ring"]]
    fpdt_n, chunk_n = (long_ctx["fpdt"]["launches"],
                       long_ctx["fpdt"]["chunked"]["launches"])
    lt = [r["launches"] for r in long_ctx["train"].values()]
    ring_ms = long_ctx["ring"][0]["ms"]
    for e in entries:
        if e["name"] == "flash_attention":
            e.update(launches_ring=sum(c["fwd"] for c in ring_n),
                     launches_fpdt=fpdt_n["fwd"],
                     launches_chunked=chunk_n["fwd"],
                     launches_long_context_train=sum(
                         c["flash_attention"] for c in lt),
                     ms_ring_32k=ring_ms["ring_fwd"],
                     ms_whole_32k=ring_ms["whole_fwd"],
                     library_ms_32k=ring_ms["sdpa_fwd"],
                     bound_ms_32k=long_ctx["ring"][0]["bound_ms"],
                     bound_by_32k=long_ctx["ring"][0]["bound_by"])
        elif e["name"] == "flash_attention_bwd":
            e.update(launches_ring=sum(c["dq"] + c["dkv"] for c in ring_n),
                     launches_fpdt=fpdt_n["dq"] + fpdt_n["dkv"],
                     launches_chunked=chunk_n["dq"] + chunk_n["dkv"],
                     launches_long_context_train=sum(
                         c["flash_attention_bwd_dq"] +
                         c["flash_attention_bwd_dkv"] for c in lt),
                     ms_ring_32k=ring_ms["ring_fwd_bwd"] - ring_ms[
                         "ring_fwd"],
                     ms_whole_32k=ring_ms["whole_fwd_bwd"] - ring_ms[
                         "whole_fwd"])
        elif e["name"] == "fused_adam_step":
            e["launches_long_context_train"] = sum(c["fused_adam_step"]
                                                   for c in lt)
    # stage 35: B1 and B2 in the domino steps (a), B2 in BERT's tp-1 run
    # and B1, B3 in GPT-2's tp-1 and padded runs (b), B1 under the
    # injection (c: the CLIP encoder's and the UNet's fused calls), each
    # counted from 0 around its run
    dom = tp_compose["domino"]["launches"]
    g2 = [tp_compose["gpt2_tp1"][k]["launches"] for k in ("tp1", "padded")]
    inj = tp_compose["injection"]
    for e in entries:
        if e["name"] == "flash_attention":
            e.update(launches_domino=dom["flash_attention"],
                     launches_gpt2_tp1=sum(c["flash_attention"]
                                           for c in g2),
                     launches_injection=(inj["clip_fused"]["launches"]["fwd"]
                                         + inj["unet_fused"]["launches"][
                                             "fwd"]))
        elif e["name"] == "flash_attention_bwd":
            e.update(launches_domino=(dom["flash_attention_bwd_dq"] +
                                      dom["flash_attention_bwd_dkv"]),
                     launches_gpt2_tp1=sum(
                         c["flash_attention_bwd_dq"] +
                         c["flash_attention_bwd_dkv"] for c in g2))
        elif e["name"] == "fused_adam_step":
            e.update(launches_domino=dom["fused_adam_step"],
                     launches_bert_tp1=tp_compose["bert_tp1"]["tp1"][
                         "launches"]["fused_adam_step"])
        elif e["name"] in ("fused_lamb_phase1", "fused_lamb_phase2"):
            e["launches_gpt2_tp1"] = sum(c.get(e["name"], 0) for c in g2)
    # stage 36: B7 in the tp/ep code's run at one rank (b), counted from 0
    # around it, and its cases at the tp-local and ep-local shapes under
    # *_<case>
    split = moe_parallel["split_codes"]["launches"]
    for e in entries:
        kind = {"gmm": "fwd", "gmm_dx": "dx", "gmm_dw": "dw"}.get(e["name"])
        if kind is None:
            continue
        e["launches_split_codes"] = split.get(e["name"], 0)
        for r in moe_parallel["kernels"]:
            if r["kind"] == kind:
                e.update({f"{k}_{r['case']}": r[k] for k in keys})
    llama_zero3.pop("batches")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(card=smi, kernels=kernels, serve=serve,
                           step=step, train_kernels=train_kernels,
                           train=train, train_step=train_step,
                           gpt2_kernels=gpt2_kernels, gpt2=gpt2,
                           overflow=overflow,
                           moe_quant_kernels=moe_quant_kernels,
                           mixtral=mixtral, quant=quant,
                           moe_quant_step=moe_quant_step,
                           evo_kernels=evo_kernels, evoformer=evo,
                           sparse_kernels=sparse_kernels, sparse=sparse,
                           fp_quant=fpq, bert=bert, gpt2_zero1=gpt2_zero1,
                           llama_zero2=llama_zero2,
                           llama_zero3=llama_zero3,
                           save_resume=save_resume, offload=offload,
                           zeropp=zeropp, pipeline=pipe,
                           universal_onebit=uni_onebit,
                           moe_train=moe_train, pipeline_zero=pipe_zero,
                           tp=tp, long_context=long_ctx,
                           tp_compose=tp_compose,
                           moe_parallel=moe_parallel,
                           seconds=time.perf_counter() - t_start),
                      f, indent=1, default=str)
    from deepspeed_tpu_torch import comm
    comm.destroy_process_group()
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
