"""Paged (blocked-KV) attention: the hand-written CUDA kernels' wrappers and
their plain PyTorch version.

Replaces the Pallas TPU kernel ``deepspeed_tpu/ops/pallas/paged_attention.py``
— ``paged_attention`` (:29, one query row per tile, for decode) and
``paged_attention_atoms`` (:120, ``atom`` rows of one sequence per tile, for
prefill), one kernel body ``_atom_kernel`` (:41).  The kernels are
``csrc/paged_attention.cu``, built by ``ops/op_builder.py`` with nvcc for
``sm_90a`` and called through ctypes on PyTorch's current stream.

What bounds them on an H100: the bytes of the live K/V pages.  Decode reads
each live page once per (token, kv head) and does 4·Dh flops per key, far
below the ~295 flops per byte where bf16 compute would bind; a prefill atom
reuses each page for ``atom·H/Hkv`` query rows, which raises the flops per
byte sixteen-fold at atom=16 but still leaves it under the line.

Routes (:func:`launch_plan`, a function of host-known shapes and the dtype,
handed to the C entry, which launches that route or refuses it):
``decode_split`` (bf16/fp16, atom 1) and ``atom_mma`` (bf16/fp16, atom > 1)
run one tensor-core kernel that holds all the rows sharing a kv head (up to
128) in one block, streams the tile's live keys through a cp.async ring and
runs both products on ``mma.sync`` with P fed as hi + lo; where the grid
would be small (decode, or a prefill of a few tiles) it splits each tile's
table into spans (split-KV) whose states a second kernel merges in split
order.  ``fp32`` runs the CUDA-core kernel.  Every route takes an even head
width Dh up to 128: Dh <= 64 runs in the kernels' 64-column tile, a wider
one in the 128-column tile, zero-filled past Dh.
:func:`_emulate_split_kv_tensor_cores` is the tensor-core route's arithmetic
in plain PyTorch, for the tests.

On a CPU tensor each wrapper returns its kernel's plain version; on a CUDA
tensor it launches the kernel or raises.  ``paged_attention.launches`` and
``paged_attention_atoms.launches`` count kernel launches (one per call that
launched), ``.route_launches`` the same by route.
"""

import torch

from ..op_builder import PagedAttentionBuilder
from .flash_attention import P_SCALE

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
ROUTES = ("fp32", "decode_split", "atom_mma")  # C route codes
# decode is split into at most this many blocks (a few waves over 132
# SMs), prefill atoms into at most one wave of two blocks an SM
SPLIT_TARGET_BLOCKS = 4096
ATOM_SPLIT_TARGET_BLOCKS = 264
MAX_ROW_TILES = 8       # 16-row tiles a block: 128 rows
KEYS_A_TILE = 64        # keys a staged K/V tile
# head widths: even, up to 128 (tiles of 64 and 128 columns, zero-padded
# past Dh; B1 stops at 128 too)
MAX_HEAD_DIM = 128
LOG2E = 1.4426950408889634


def paged_attention_plain(q, k_cache, v_cache, tables_t, positions,
                          window=0):
    """The gather version (``deepspeed_tpu/inference/v2/ragged_forward.py:
    82-107``): each row gathers its own block run ``[maxb·bs]`` of the
    cache, masks by position with ``finfo.min`` and takes an fp32 softmax.

    q: [T, H, Dh]; caches: [num_blocks, bs, Hkv, Dh]; tables_t: [T, maxb]
    int32; positions: [T] int32 → [T, H, Dh] in q's dtype."""
    T, H, Dh = q.shape
    _, bs, Hkv, _ = k_cache.shape
    ctx = tables_t.shape[1] * bs
    idx = tables_t.long()
    k_ctx = k_cache[idx].reshape(T, ctx, Hkv, Dh).float()
    v_ctx = v_cache[idx].reshape(T, ctx, Hkv, Dh).float()
    qg = q.reshape(T, Hkv, H // Hkv, Dh).float()
    scores = torch.einsum("tkgd,tckd->tkgc", qg, k_ctx) * (Dh**-0.5)
    pos_ctx = torch.arange(ctx, device=q.device)[None, None, None, :]
    pos_q = positions.long()[:, None, None, None]
    mask = pos_ctx <= pos_q
    if window:
        mask &= pos_ctx > pos_q - window
    scores = scores.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("tkgc,tckd->tkgd", probs, v_ctx)
    return out.reshape(T, H, Dh).to(q.dtype)


def _first_row_tables(tables_t, atom):
    """Every row of an atom tile reads pages through the tile's first
    row's table (the kernel's streaming rule)."""
    T, maxb = tables_t.shape
    return (tables_t.reshape(T // atom, atom, maxb)[:, :1]
            .expand(T // atom, atom, maxb).reshape(T, maxb))


def _check(q, k_cache, v_cache, tables_t, positions, atom):
    T, H, Dh = q.shape
    if T % atom:
        raise ValueError(f"token count {T} not a multiple of atom {atom}")
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"caches must be [num_blocks, bs, Hkv, Dh] and "
                         f"alike, got {tuple(k_cache.shape)} and "
                         f"{tuple(v_cache.shape)}")
    Hkv = k_cache.shape[2]
    if k_cache.shape[3] != Dh or H % Hkv:
        raise ValueError(f"q heads {H}×{Dh} do not fit cache heads "
                         f"{Hkv}×{k_cache.shape[3]}")
    if tables_t.dim() != 2 or tables_t.shape[0] != T or \
            tuple(positions.shape) != (T, ):
        raise ValueError("tables_t must be [T, maxb] and positions [T]")
    devices = {t.device for t in (q, k_cache, v_cache, tables_t, positions)}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")
    return q.device.type


def launch_plan(dtype, T, H, Hkv, maxb, atom):
    """How the kernel runs a call, from host-known shapes alone (no device
    value: decode is host-bound, and a sync would cost more than the kernel
    saves) → (route, splits, span, row_tiles).

    route: "fp32" for fp32, else "decode_split" (atom 1) or "atom_mma".
    row_tiles: 16-row tiles a block, the least power of two covering the
    M = atom·H/Hkv rows of a (tile, kv head), at most 8 (beyond 128 rows
    they come in groups).  splits: the table's ``maxb`` pages are cut into
    spans of ``span`` pages while the (tile, kv head, row group, span)
    blocks stay within SPLIT_TARGET_BLOCKS for decode, or
    ATOM_SPLIT_TARGET_BLOCKS for atoms (a prefill of a few tiles)."""
    if dtype == torch.float32:
        return "fp32", 1, maxb, 1
    tiles16 = -(-atom * (H // Hkv) // 16)
    row_tiles = min(MAX_ROW_TILES, 1 << (tiles16 - 1).bit_length())
    blocks = T // atom * Hkv * -(-tiles16 // row_tiles)
    route, target = "atom_mma", ATOM_SPLIT_TARGET_BLOCKS
    if atom == 1:
        route, target = "decode_split", SPLIT_TARGET_BLOCKS
    span = -(-maxb // min(maxb, max(1, target // blocks)))
    return route, -(-maxb // span), span, row_tiles


def _tile_keys(pos_tile, split, span, bs, maxb, window):
    """[k_start, k_stop) of one split of an atom tile whose rows sit at
    ``pos_tile``: the span's pages, cut to the window's first key and the
    tile's last position (the kernel's live keys)."""
    lo, hi = min(pos_tile), max(pos_tile)
    key_lo = max(0, lo - window + 1) if window > 0 else 0
    page_lo = max(key_lo // bs, split * span)
    page_hi = min(hi // bs, maxb - 1, (split + 1) * span - 1)
    return max(page_lo * bs, key_lo), min((page_hi + 1) * bs, hi + 1)


def _emulate_split_kv_tensor_cores(q, k_cache, v_cache, tables_t, positions,
                                   atom, window=0, keep_lo=True):
    """The bf16/fp16 kernel's arithmetic step by step in plain PyTorch, for
    the tests: :func:`launch_plan`'s splits and row tiles, 64-key tiles from
    each split's first live key, each warp's key slice of a tile with its
    own online softmax (fp32 scores (q·k)·scale from the exact inputs,
    exponentials of (s - m)·log2 e, P fed to P·V as hi + lo of P·kP in q's
    dtype, or rounded once where ``keep_lo`` is False), the slices merged
    in warp order, the splits in split order (empty ones skipped), the
    output rounded once to q's dtype.  Inputs on the CPU."""
    dtype = q.dtype
    T, H, Dh = q.shape
    _, bs, Hkv, _ = k_cache.shape
    maxb, g = tables_t.shape[1], H // Hkv
    _, splits, span, row_tiles = launch_plan(dtype, T, H, Hkv, maxb, atom)
    slices = max(4, row_tiles) // row_tiles
    keys = KEYS_A_TILE // slices        # a warp's keys of a tile
    kp, scale = P_SCALE[dtype], Dh**-0.5
    qf = q.float()
    kf = k_cache.float().reshape(-1, Hkv, Dh)
    vf = v_cache.float().reshape(-1, Hkv, Dh)
    pos, tab = positions.tolist(), tables_t.tolist()
    out = torch.zeros(T, H, Dh)

    def rnd(x):
        return x.to(dtype).float()

    def merge(states):                  # [(m [R], l [R], acc [R, Dh])]
        m = torch.stack([s[0] for s in states]).amax(0)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(states[0][2])
        for ms, ls, accs in states:
            f = torch.where(ms == float("-inf"), 0.0,
                            torch.exp2((ms - m) * LOG2E))
            l = l + f * ls
            acc = acc + f[:, None] * accs
        return m, l, acc

    for tile in range(T // atom):
        first = tile * atom
        trow = tab[first]
        for kh in range(Hkv):
            for row0 in range(0, atom * g, 16 * row_tiles):
                rows = range(row0, min(atom * g, row0 + 16 * row_tiles))
                toks = [first + r // g for r in rows]
                qr = qf[toks, [kh * g + r % g for r in rows]]     # [R, Dh]
                p = torch.tensor([pos[t] for t in toks])[:, None]
                R, states = len(rows), []
                for split in range(splits):
                    k_start, k_stop = _tile_keys(pos[first:first + atom],
                                                 split, span, bs, maxb,
                                                 window)
                    sl = [[torch.full((R, ), float("-inf")), torch.zeros(R),
                           torch.zeros(R, Dh)] for _ in range(slices)]
                    for t0 in range(k_start, k_stop, KEYS_A_TILE):
                        key = torch.arange(t0, t0 + KEYS_A_TILE)
                        live = key < k_stop
                        crow = torch.tensor(
                            [trow[k // bs] * bs + k % bs if k < k_stop else 0
                             for k in key.tolist()])
                        kt = torch.where(live[:, None], kf[crow, kh], 0.0)
                        vt = torch.where(live[:, None], vf[crow, kh], 0.0)
                        ok = live[None, :] & (key[None, :] <= p)
                        if window > 0:
                            ok &= key[None, :] > p - window
                        s = torch.where(ok, (qr @ kt.T) * scale,
                                        float("-inf"))
                        for w, st in enumerate(sl):
                            cols = slice(w * keys, (w + 1) * keys)
                            m_old, l_old, acc = st
                            m_new = torch.maximum(m_old, s[:, cols].amax(1))
                            msafe = torch.where(m_new == float("-inf"), 0.0,
                                                m_new)
                            alpha = torch.where(
                                m_old == float("-inf"), 0.0,
                                torch.exp2((m_old - msafe) * LOG2E))
                            pr = torch.exp2((s[:, cols] - msafe[:, None])
                                            * LOG2E)
                            hi = rnd(kp * pr)
                            pv = hi @ vt[cols]
                            if keep_lo:
                                pv = rnd(kp * pr - hi) @ vt[cols] + pv
                            st[:] = [m_new, alpha * l_old + pr.sum(1),
                                     acc * alpha[:, None] + pv]
                    states.append(merge([(m, l, acc / kp)
                                         for m, l, acc in sl]))
                _, l, acc = merge(states)
                o = acc / torch.where(l == 0, 1.0, l)[:, None]
                out[toks, [kh * g + r % g for r in rows]] = o
    return out.to(dtype)


def _launch(q, k_cache, v_cache, tables_t, positions, atom, window):
    """One launch on :func:`launch_plan`'s route; returns (out, the route,
    or None where T = 0 launched nothing)."""
    T, H, Dh = q.shape
    if q.dtype not in _DTYPE_CODES or k_cache.dtype != q.dtype or \
            v_cache.dtype != q.dtype:
        raise TypeError(f"paged attention kernel takes fp32, bf16 or fp16 q "
                        f"and caches of q's dtype, got {q.dtype}, "
                        f"{k_cache.dtype}, {v_cache.dtype}")
    if tables_t.dtype != torch.int32 or positions.dtype != torch.int32:
        raise TypeError("tables_t and positions must be int32")
    if Dh % 2 or not 2 <= Dh <= MAX_HEAD_DIM:
        raise ValueError(f"paged attention kernel takes an even head_dim "
                         f"of at most {MAX_HEAD_DIM}, got {Dh}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("tables_t", tables_t), ("positions", positions)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name in ("q", "k_cache", "v_cache") and t.data_ptr() % 16:
            raise ValueError(f"{name} must start at a 16-byte aligned "
                             f"address")
    out = torch.empty_like(q)
    if T == 0:
        return out, None
    _, bs, Hkv, _ = k_cache.shape
    maxb = tables_t.shape[1]
    route, splits, span, row_tiles = launch_plan(q.dtype, T, H, Hkv, maxb,
                                                 atom)
    part = (torch.empty(splits * T * H * (Dh + 2), dtype=torch.float32,
                        device=q.device) if splits > 1 else None)
    lib = PagedAttentionBuilder().load()
    with torch.cuda.device(q.device):
        err = lib.ds_paged_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            tables_t.data_ptr(), positions.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), T, H, Hkv, Dh, bs,
            maxb, atom, int(window), Dh**-0.5, _DTYPE_CODES[q.dtype],
            ROUTES.index(route), splits, span, row_tiles,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged attention kernel launch failed ({route}): "
                           f"{lib.ds_cuda_error_string(err).decode()} "
                           f"({err})")
    return out, route


def _count(wrapper, route):
    if route is not None:
        wrapper.launches += 1
        wrapper.route_launches[route] += 1


def paged_attention(q, k_cache, v_cache, tables_t, positions,
                    block_size=None, window=0):
    """One query row per tile (decode).  q: [T, H, Dh]; caches:
    [num_blocks, bs, Hkv, Dh]; tables_t: [T, maxb] int32; positions: [T]
    int32 → [T, H, Dh].  Equal to ``paged_attention_atoms(..., atom=1)``."""
    device = _check(q, k_cache, v_cache, tables_t, positions, 1)
    if device == "cpu":
        return paged_attention_plain(q, k_cache, v_cache, tables_t,
                                     positions, window)
    if device != "cuda":
        raise ValueError(f"paged attention runs on cpu or cuda, not {device}")
    out, route = _launch(q, k_cache, v_cache, tables_t, positions, 1, window)
    _count(paged_attention, route)
    return out


paged_attention.launches = 0
paged_attention.route_launches = dict.fromkeys(ROUTES, 0)


def paged_attention_atoms(q, k_cache, v_cache, tables_t, positions, atom,
                          block_size=None, window=0):
    """Atom-tiled variant for prefill regions: every aligned run of
    ``atom`` rows shares one sequence (pads allowed, position 0, outputs
    discarded).  Pages are streamed through each tile's FIRST row's table;
    each row masks by its own position.  T must be a multiple of ``atom``."""
    device = _check(q, k_cache, v_cache, tables_t, positions, atom)
    if device == "cpu":
        return paged_attention_plain(q, k_cache, v_cache,
                                     _first_row_tables(tables_t, atom),
                                     positions, window)
    if device != "cuda":
        raise ValueError(f"paged attention runs on cpu or cuda, not {device}")
    out, route = _launch(q, k_cache, v_cache, tables_t, positions, atom,
                         window)
    _count(paged_attention_atoms, route)
    return out


paged_attention_atoms.launches = 0
paged_attention_atoms.route_launches = dict.fromkeys(ROUTES, 0)
