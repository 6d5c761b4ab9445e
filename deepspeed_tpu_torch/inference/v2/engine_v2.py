"""InferenceEngineV2 — FastGen-style continuous batching (reference
``inference/v2/engine_v2.py``: ``put``/``query``/``flush`` over a ragged
batch + blocked KV cache); the port of
``deepspeed_tpu/inference/v2/engine_v2.py`` for a full-precision KV cache,
with full-precision or weight-only int8/int4 (``quantization_mode``)
weights, on one rank or over a tp group (``tensor_parallel.tp_size``).

Each engine iteration packs a **fixed token budget** with a mix of decode
tokens (one per running sequence) and prefill chunks, runs ONE ragged step
(``ragged_forward.py``), and samples next tokens for every sequence whose
pending tokens were fully consumed.  Prefills longer than the budget stream
across iterations (chunked prefill).  The host-side scheduling is the JAX
engine's, line for line, so that every token lands in the same buffer row,
block and tile.

Tensor parallelism (S1; JAX ``engine_v2.py:53-157``): every rank of the
world runs this engine with the same requests, the model holds the rank's
slices (the model's ``tp_rules`` through ``module_inject``), and the KV
cache holds the rank's Hkv/tp kv heads.  GQA with fewer kv heads than
ranks (``n_kv % tp != 0``, ``tp % n_kv == 0``, ``n_q % tp == 0``) keeps
the k/v projections whole on every rank, and each rank caches the one kv
head its q heads read.  Any other shape tp does not divide raises JAX's
``ValueError``.  The host schedule is the same on every rank and the
logits are all-gathered, so every rank emits the same tokens.
"""

import numpy as np
import torch

from ...accelerator import resolve_device
from ...models.llama import torch_dtype
from ...module_inject.layers import attention_heads
from ...utils.logging import logger
from ...utils.not_ported import not_ported
from ..quant_serving import quantize_tree, resolve_mode
from .config_v2 import RaggedInferenceEngineConfig
from .ragged import BlockedKVCache, DSStateManager, KVCacheExhausted
from .ragged_forward import RAGGED_FORWARDS, decode_burst


class InferenceEngineV2:

    def __init__(self, model, params=None, config=None, device=None):
        """``model``: a ``models.llama.LlamaModel`` or
        ``models.mixtral.MixtralModel`` (its weights, or ``params`` —
        ``(name, tensor)`` pairs or a dict — to install).  ``device``: None
        means the CUDA card and raises without one; the CPU runs only when
        asked for (``device="cpu"``).  With ``quantization_mode`` the
        model's weights are quantized in place on the device (the model is
        then for serving only)."""
        if isinstance(model, tuple):
            model, params = model
        if config is None:
            config = RaggedInferenceEngineConfig()
        elif isinstance(config, dict):
            config = RaggedInferenceEngineConfig(**config)
        self._config = config
        self.device = resolve_device(device)
        name = type(model).__name__
        if name not in RAGGED_FORWARDS:
            raise not_ported(f"the ragged step for {name}", "S5")
        tp = int(config.tensor_parallel.tp_size or 1)
        # weight-only quantized serving (reference quantization_mode):
        # resident weights in int8/int4 wire format, each dequantized inside
        # the ragged step just before its product (quant_serving.weight)
        self._quant_bits = resolve_mode(config.quantization_mode)
        if self._quant_bits is not None and tp > 1:
            raise NotImplementedError(
                "quantization_mode does not compose with tensor "
                "parallelism yet (quant grouping is laid out pre-shard)")
        if config.kv_cache_dtype is not None:
            raise not_ported("kv_cache_dtype", "S3")
        if config.decode_burst_sampling:
            raise not_ported("decode_burst_sampling", "S4")
        if tp > 1 and getattr(model, "tp_splits", None) is None:
            shard_for_serving(model, tp, self.device)
        self._step_fn = RAGGED_FORWARDS[name]
        if params is not None:
            items = params.items() if isinstance(params, dict) else params
            model.load_weights(items, device=self.device)
        elif model.device != self.device:
            model.to(self.device)
        self._quant_meta = {}
        if self._quant_bits is not None:
            self._quant_meta = quantize_tree(model, self._quant_bits,
                                             torch_dtype(config.dtype))
        self.module = model
        cfg = model.config
        self.model_config = cfg

        sm = config.state_manager
        block_size = sm.block_size
        max_blocks_per_seq = -(-sm.max_context // block_size)
        num_blocks = sm.num_blocks
        if num_blocks is None:
            # enough for half the tracked sequences at full context (+1
            # garbage block) — the reference sizes from free memory
            num_blocks = 1 + max(sm.max_ragged_sequence_count,
                                 (sm.max_tracked_sequences *
                                  max_blocks_per_seq) // 2)
        attn = model.model.layers[0].self_attn
        # this rank's kv heads (all of them at tp 1)
        _, kv_heads, _, _ = attention_heads(attn.q_proj, attn.k_proj, cfg)
        self.kv_cache = BlockedKVCache(
            cfg.num_hidden_layers, num_blocks, block_size,
            kv_heads, cfg.head_dim,
            dtype=torch_dtype(config.dtype), device=self.device)
        self.state_manager = DSStateManager(sm, self.kv_cache)
        self._budget = int(sm.max_ragged_batch_size)
        self._kv = self.kv_cache.data
        logger.info(
            f"InferenceEngineV2: budget={self._budget} blocks={num_blocks}"
            f"×{block_size} max_seqs={self.state_manager.max_seqs} "
            f"device={self.device}")

    def _to_device(self, arr):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    # ------------------------------------------------------------- put/query
    def put(self, batch_uids, batch_tokens, do_schedule=False):
        """Queue prompt (or continuation) tokens; ``do_schedule=True`` also
        runs one step.  An unknown uid starts a NEW sequence; a uid whose
        sequence already finished raises (flush it first).  The check runs
        over the whole batch BEFORE any sequence mutates."""
        batch_uids = list(batch_uids)
        for uid in batch_uids:
            seq = self.state_manager.get_sequence(uid)
            if seq is not None and seq.done:
                raise ValueError(
                    f"put() on finished uid {uid!r} — flush it first "
                    "(continuing a done sequence would silently reuse its "
                    "KV prefix and token history)")
        for uid, toks in zip(batch_uids, batch_tokens):
            toks = [int(t) for t in np.asarray(toks).reshape(-1)]
            seq = self.state_manager.get_or_create_sequence(uid)
            seq.tokens.extend(toks)
        if do_schedule:
            return self.schedule_step()
        return {}

    def query(self, uid):
        """Latest state of a sequence."""
        seq = self.state_manager.get_sequence(uid)
        if seq is None:
            return None
        return {"uid": uid, "length": seq.cur_length,
                "seen": seq.seen_tokens, "done": seq.done,
                "tokens": list(seq.tokens)}

    def flush(self, uids):
        """Release sequences."""
        for uid in uids:
            self.state_manager.flush_sequence(uid)

    # -------------------------------------------------------------- schedule
    def _atom_layout(self):
        """Static (decode_cap, atom) region split used on prefill-heavy
        steps: [0, decode_cap) single decode tokens (one row per tile),
        [decode_cap, T) prefill runs aligned to ``atom`` tiles."""
        sm = self._config.state_manager
        atom = sm.prefill_atom_size
        if not atom:
            return (0, 0)
        decode_cap = min(sm.max_ragged_sequence_count, self._budget // 2)
        if self._budget - decode_cap < atom:
            return (0, 0)  # no room for a prefill region
        # the prefill region must be a whole number of atom tiles — grow
        # the decode region to absorb the remainder
        decode_cap = self._budget - (self._budget - decode_cap) // atom * atom
        return (decode_cap, atom)

    def _pick_layout(self):
        """Per-step layout choice: atom regions only when prefill dominates
        (a decode-heavy step keeps the flat layout)."""
        decode_cap, atom = self._atom_layout()
        if not atom:
            return (0, 0)
        n_decode = n_prefill = 0
        for seq in self.state_manager.tracked_sequences.values():
            if seq.done:
                continue
            p = len(seq.tokens) - seq.seen_tokens
            if p == 1:
                n_decode += 1
            elif p > 1:
                n_prefill += p
        if n_prefill >= max(atom, n_decode):
            return (decode_cap, atom)
        return (0, 0)

    def _build_batch(self):
        """Pack the token budget: decode tokens first (latency), then
        prefill chunks (throughput).  With an atom layout, decode tokens
        fill the decode region and prefill runs are atom-aligned in the
        prefill region."""
        T = self._budget
        sm = self.state_manager
        decode_cap, atom = layout = self._pick_layout()
        toks = np.zeros(T, np.int32)
        pos = np.zeros(T, np.int32)
        slots = np.zeros(T, np.int32)  # slot 0 → garbage block
        finishing = []  # (seq, buffer index of its last scheduled token)
        placed = 0
        deferred = 0        # sequences the KV pool could not grow this step
        deferred_want = 0   # blocks those sequences needed and couldn't get

        d_cur = 0                      # decode-region cursor
        p_cur = decode_cap             # prefill-region cursor (atom-aligned)
        order = sorted(sm.tracked_sequences.values(),
                       key=lambda s: len(s.pending()))
        for seq in order:
            if seq.done:
                continue
            pending = seq.pending()
            if not pending:
                continue
            if atom:
                if len(pending) == 1 and d_cur < decode_cap:
                    start, room = d_cur, 1
                else:
                    start = p_cur
                    room = T - p_cur
                    if room <= 0 and d_cur < decode_cap:
                        # prefill region exhausted but decode rows are free:
                        # advance this sequence by ONE token through a spare
                        # decode row (exact: keys are masked by position)
                        start, room = d_cur, 1
                if room <= 0:
                    continue
            else:
                start = d_cur
                room = T - d_cur
                if room <= 0:
                    break
            take = min(len(pending), room)
            # KV-pool pressure: schedule only what the free blocks can hold
            take = min(take, sm.schedulable_tokens(
                seq, seq.seen_tokens + take))
            if take <= 0:
                deferred += 1
                deferred_want += max(
                    1, self.kv_cache.blocks_for(seq.seen_tokens + 1)
                    - len(seq.blocks))
                continue
            sm.ensure_capacity(seq, seq.seen_tokens + take)
            toks[start:start + take] = pending[:take]
            pos[start:start + take] = np.arange(
                seq.seen_tokens, seq.seen_tokens + take)
            slots[start:start + take] = seq.slot
            if take == len(pending):
                finishing.append((seq, start + take - 1))
            seq.seen_tokens += take
            placed += take
            if atom:
                if start < decode_cap:   # landed in the decode region
                    d_cur += 1
                else:
                    # advance to the next atom boundary (intra-atom pads)
                    p_cur = start + (-(-take // atom)) * atom
            else:
                d_cur += take
        if placed == 0:
            if deferred:
                # nothing schedulable AND nothing in flight to free blocks
                raise KVCacheExhausted(
                    deferred_want, sm.free_blocks,
                    detail=f"{deferred} sequence(s) deferred with 0 "
                    f"schedulable tokens and no other work in flight — "
                    f"raise state_manager.num_blocks, lower concurrency, "
                    f"preempt, or flush finished sequences")
            return None
        last_idx = np.zeros(sm.max_seqs, dtype=np.int32)
        for seq, idx in finishing:
            last_idx[seq.slot] = idx
        return toks, pos, slots, last_idx, finishing, layout

    @staticmethod
    def _sample_row(row, temperature, top_k, top_p, rng):
        """Host-side categorical sampling (temperature / top-k / nucleus
        top-p)."""
        logits = row.astype(np.float64) / max(temperature, 1e-6)
        if top_k:
            kth = np.partition(logits, -int(top_k))[-int(top_k)]
            logits = np.where(logits < kth, -np.inf, logits)
        p = np.exp(logits - logits.max())
        p /= p.sum()
        if top_p and top_p < 1.0:
            order = np.argsort(-p)
            csum = np.cumsum(p[order])
            # smallest prefix whose mass reaches top_p (always ≥ 1 token)
            keep = csum - p[order] < top_p
            mask = np.zeros_like(p, dtype=bool)
            mask[order[keep]] = True
            p = np.where(mask, p, 0.0)
            p /= p.sum()
        return int(rng.choice(len(p), p=p))

    def schedule_step(self, do_sample=False, temperature=1.0, rng=None,
                      top_k=0, top_p=1.0):
        """One ragged iteration.  Returns {uid: sampled_next_token} for every
        sequence whose pending tokens were fully consumed this step.

        ``rng`` may be a ``np.random.Generator`` or a seed; the Generator is
        created once and advances across tokens and steps."""
        if do_sample:
            if isinstance(rng, np.random.Generator):
                self._rng = rng
                self._rng_seed = None
            elif (getattr(self, "_rng", None) is None
                  or (rng is not None and rng != getattr(self, "_rng_seed", None))):
                self._rng = np.random.default_rng(rng)
                self._rng_seed = rng
        batch = self._build_batch()
        if batch is None:
            return {}
        toks, pos, slots, last_idx, finishing, layout = batch
        logits, self._kv = self._step_fn(
            self.module, self._kv, self._to_device(toks),
            self._to_device(pos), self._to_device(slots),
            self._to_device(self.state_manager.block_table),
            self._to_device(last_idx), cfg=self.model_config,
            block_size=self.kv_cache.block_size, layout=layout,
            use_kernel=True)
        out = {}
        if finishing:
            if do_sample:
                # fetch ONLY the finishing rows ([F, V]), not every slot
                rows = self._to_device(
                    np.asarray([seq.slot for seq, _ in finishing]))
                lg = logits[rows.long()].cpu().numpy()
                for i, (seq, _) in enumerate(finishing):
                    out[seq.uid] = self._sample_row(
                        lg[i], temperature, top_k, top_p, self._rng)
            else:
                # greedy: argmax on the device, fetch one int per slot
                toks = torch.argmax(logits, dim=-1).cpu().numpy()
                for seq, _ in finishing:
                    out[seq.uid] = int(toks[seq.slot])
        return out

    # ---------------------------------------------------------- decode burst
    def _decode_burst_step(self, active_uids, produced, max_new_tokens,
                           cap):
        """Run up to ``cap`` greedy decode iterations back to back on the
        device.  Eligible only when EVERY active sequence has exactly one
        pending token.  Returns {uid: [k tokens]} or None if not eligible."""
        sm = self.state_manager
        seqs = []
        for uid in active_uids:
            seq = sm.get_sequence(uid)
            if len(seq.tokens) - seq.seen_tokens != 1:
                return None
            seqs.append(seq)
        if not seqs:
            return None
        k = min(cap, min(max_new_tokens - len(produced[s.uid])
                         for s in seqs))
        if k < 2:
            return None
        return self._run_burst(seqs, k)

    def burst_decode(self, uids=None, max_tokens=16, do_sample=False,
                     temperature=1.0, top_k=0, top_p=1.0, rng=None):
        """Public fused-decode entry: run up to ``max_tokens`` greedy decode
        iterations on the device for the given sequences and return
        ``{uid: [tokens]}``.  Every targeted sequence must be in pure decode
        (exactly one pending token) — raises otherwise."""
        if do_sample:
            raise not_ported("burst_decode sampling", "S4")
        sm = self.state_manager
        if uids is None:
            uids = [s.uid for s in sm.tracked_sequences.values()
                    if not s.done]
        seqs = []
        for uid in uids:
            seq = sm.get_sequence(uid)
            if seq is None or seq.done:
                raise ValueError(f"uid {uid!r} is not an active sequence")
            if len(seq.tokens) - seq.seen_tokens != 1:
                raise ValueError(
                    f"uid {uid!r} is not in pure decode "
                    f"({len(seq.pending())} pending tokens) — run "
                    "schedule_step until prefill drains")
            seqs.append(seq)
        k = int(max_tokens)
        cap = int(self._config.decode_burst or 0)
        if cap > 1:   # an explicit call may exceed a DISABLED config, not
            k = min(k, cap)   # a configured cap
        if not seqs or k < 2:
            return {}
        # None = the KV pool can't afford a burst right now → empty result
        return self._run_burst(seqs, k) or {}

    def _run_burst(self, seqs, k):
        sm = self.state_manager
        # KV-pool pressure: a burst pre-allocates k positions per sequence
        # from the SHARED free pool — shrink k until the new-block demand
        # fits, falling back to the per-step scheduler below 2

        def _new_blocks(kk):
            return sum(
                max(0, sm.kv_cache.blocks_for(s.seen_tokens + kk)
                    - len(s.blocks)) for s in seqs)

        while k >= 2 and _new_blocks(k) > sm.free_blocks:
            k //= 2
        if k < 2:
            return None
        # the floor power of two, as the JAX engine (its k is a static
        # program size) — the same bursts give the same tokens
        k = 1 << (k.bit_length() - 1)
        n = sm.max_seqs
        tok0 = np.zeros(n, np.int32)
        pos0 = np.zeros(n, np.int32)
        act = np.zeros(n, bool)
        for seq in seqs:
            sm.ensure_capacity(seq, seq.seen_tokens + k)
            tok0[seq.slot] = seq.tokens[seq.seen_tokens]
            pos0[seq.slot] = seq.seen_tokens
            act[seq.slot] = True
        toks_out, self._kv = decode_burst(
            self.module, self._kv, self._to_device(tok0),
            self._to_device(pos0), self._to_device(act),
            self._to_device(sm.block_table), step_fn=self._step_fn,
            cfg=self.model_config, block_size=self.kv_cache.block_size, k=k,
            use_kernel=True)
        toks_out = toks_out.cpu().numpy()     # ONE fetch for k×seqs tokens
        self.burst_steps = getattr(self, "burst_steps", 0) + 1
        out = {}
        for seq in seqs:
            # k tokens scheduled on device: t0 (the pending one) + the k-1
            # fed-back generations; the newest generation stays pending
            seq.seen_tokens += k
            col = toks_out[:, seq.slot]
            seq.tokens.extend(int(t) for t in col)
            out[seq.uid] = [int(t) for t in col]
        return out

    # ------------------------------------------------------------- generate
    def _mark_done(self, uid, produced, tok, eos_token_id, max_new_tokens):
        """Record one generated token and apply the completion rule (EOS or
        the max-new-tokens budget) — the ONE place both the per-step loop
        and the burst path decide a sequence is finished."""
        produced[uid].append(tok)
        if (eos_token_id is not None and tok == eos_token_id) or \
                len(produced[uid]) >= max_new_tokens:
            self.state_manager.get_sequence(uid).done = True
            return True
        return False

    def generate(self, prompts, max_new_tokens=32, eos_token_id=None,
                 do_sample=False, temperature=1.0, top_k=0, top_p=1.0,
                 rng=None):
        """Continuous-batching loop: all prompts in flight at once, chunked
        prefill + interleaved decode.  Sampling runs on the host per step
        (no decode bursts)."""
        uids = list(range(len(prompts)))
        self.put(uids, prompts)
        produced = {u: [] for u in uids}
        active = set(uids)
        burst_cap = 0 if do_sample else int(self._config.decode_burst or 0)
        while active:
            if burst_cap > 1:
                burst = self._decode_burst_step(active, produced,
                                                max_new_tokens, burst_cap)
                if burst is not None:
                    for uid, toks in burst.items():
                        for tok in toks:
                            if self._mark_done(uid, produced, tok,
                                               eos_token_id,
                                               max_new_tokens):
                                active.discard(uid)
                                break
                    continue
            next_tokens = self.schedule_step(do_sample=do_sample,
                                             temperature=temperature,
                                             top_k=top_k, top_p=top_p,
                                             rng=rng)
            if not next_tokens:
                # a chunked prefill step consumes budget without finishing
                # any sequence — keep going while work remains
                if any(self.state_manager.get_sequence(u).pending()
                       for u in active):
                    continue
                break
            for uid, tok in next_tokens.items():
                if self._mark_done(uid, produced, tok, eos_token_id,
                                   max_new_tokens):
                    active.discard(uid)
                else:
                    self.state_manager.get_sequence(uid).tokens.append(tok)
        self.flush(uids)
        return [produced[u] for u in uids]


def serving_tp_group(tp, device):
    """The tp group of ``tp`` ranks serving together: the world comes up
    (NCCL on the card, gloo on the CPU) if it is not, and the mesh is
    (dp = world / tp, tp), every rank building it (a collective)."""
    from ...comm import comm as dist
    from ...utils import groups
    world = (dist.get_world_size() if dist.is_initialized()
             else dist.env_world_size())
    if world % tp:
        raise ValueError(f"tp_size={tp} must divide the world size "
                         f"({world}): launch tp ranks")
    if not dist.is_initialized():
        dist.init_distributed(
            dist_backend="nccl" if device.type == "cuda" else "gloo",
            verbose=False)
    st = groups.get_mesh_state() if groups.mesh_is_initialized() else None
    if st is None or st.tp != tp or (st.pp, st.sp, st.ep) != (1, 1, 1) \
            or st.ranks is not None:
        groups.initialize_mesh(tp=tp, user_built=False)
    return groups._get_tensor_parallel_group().as_flat()


def check_tp_shape(cfg, tp):
    """Whether the kv heads are replicated at ``tp`` (GQA with fewer kv
    heads than ranks); raises JAX's ``ValueError`` for a shape tp divides
    neither way."""
    n_kv = cfg.num_key_value_heads
    n_q = cfg.num_attention_heads
    replicated = n_kv % tp != 0 and tp % n_kv == 0 and n_q % tp == 0
    if n_kv % tp and not replicated:
        raise ValueError(
            f"tp_size={tp} must divide the device count and either "
            f"num_key_value_heads ({n_kv}) or — for replicated-kv GQA — be "
            f"a multiple of it with num_attention_heads ({n_q}) divisible "
            "by tp")
    return replicated


def shard_for_serving(model, tp, device):
    """Cut a Llama or Mixtral model to this rank's slices over the serving
    tp group with its module's ``tp_rules`` (the ``ep`` and ``zero``
    entries dropped); with replicated kv the k/v projections stay whole.
    A meta model stays meta (its loader then cuts whole tensors)."""
    import sys
    from ...module_inject.auto_tp import Spec, shard_params_for_tp
    replicated = check_tp_shape(model.config, tp)
    group = serving_tp_group(tp, device)
    rules = dict(sys.modules[type(model).__module__].tp_rules(model.config))
    if replicated:
        for key in list(rules):
            if "k_proj" in key or "v_proj" in key:
                rules[key] = Spec()
    return shard_params_for_tp(model, rules, group=group)
