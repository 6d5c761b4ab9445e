"""Fused optimizer steps: the hand-written CUDA kernels' wrappers and their
plain PyTorch versions.

Replaces the Pallas TPU kernels of ``deepspeed_tpu/ops/pallas/
optimizers.py``:

* B2, ``fused_adam_step`` (:79, kernel body ``_adam_kernel`` :60): one pass
  that reads the gradient and the fp32 master, m and v, and writes master,
  m, v and the low-precision copy of the parameter;
* B8, ``fused_lion_step`` (:137, ``_lion_kernel`` :126): the same for Lion
  (master and m);
* B3, ``fused_lamb_step`` (:202): phase 1 (``_lamb_phase1_kernel`` :173,
  launched at :224) writes m, v and the update u and sums p·p and u·u per
  leaf; the trust ratio is formed between the phases (:243-248); phase 2
  (``_lamb_phase2_kernel`` :195, :250) applies p −= lr·ratio·u and writes
  the copy.

The kernels are ``csrc/optimizers.cu``, built by ``ops/op_builder.py`` and
called through ctypes on PyTorch's current stream.  Where the Pallas
kernels run once per leaf, the port's step is one launch (per phase) over
ALL leaves: the engine keeps every leaf's state in one flat buffer per kind
(``runtime/engine.py``).  Adam and Lion need no leaf table; LAMB's per-leaf
norms come from a chunk table (:class:`LambTable`) built once from the
engine's layout.  What bounds them on an H100: bytes (30, 22 and 28 + 14
per element with an fp32 gradient).

On CPU tensors each wrapper computes its plain version; on CUDA tensors it
launches the kernel or raises.  Offloaded optimizer state (the engine's
``offload_optimizer: cpu``) is pinned host memory beside a gradient on the
card: the kernel then reads and writes it in place through its
device-mapped address (unified addressing: the host pointer is valid on
the card), so a pinned host buffer takes the kernel route, never the
plain one; a pageable host buffer beside a card's buffer raises.  ``fused_adam_step.launches``,
``fused_lion_step.launches``, ``fused_lamb_phase1.launches`` and
``fused_lamb_phase2.launches`` count kernel launches.
"""

import numpy as np
import torch

from ..op_builder import OptimizersBuilder

_GRAD_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_OUT_CODES = {torch.bfloat16: 1, torch.float16: 2}
LAMB_CHUNK = 32768    # elements per block of the LAMB kernels (multiple of 4)


def bias_corrections(beta1, beta2, count, bias_correction=True):
    """(c1, c2) = (1 - beta1**count, 1 - beta2**count) in fp32, as
    ``fused_adam_step`` forms them (1 when bias correction is off)."""
    if not bias_correction:
        return 1.0, 1.0
    one, cf = np.float32(1.0), np.float32(count)
    return (float(one - np.float32(beta1)**cf),
            float(one - np.float32(beta2)**cf))


def _scalars(device, *xs):
    """0-dim fp32 tensors on ``device``: PyTorch divides by a host scalar as
    a product with its reciprocal, by a tensor exactly."""
    return (torch.tensor(x, dtype=torch.float32, device=device) for x in xs)


def _scaled_grad(g, grad_scale, device):
    g = g.float()
    return g if grad_scale is None else g * grad_scale.to(device)


# ------------------------------------------------------------------ plain
def fused_adam_step_plain(grads, masters, exp_avgs, exp_avg_sqs,
                          params_out=None, *, lr, beta1, beta2, eps,
                          weight_decay, count, adam_w_mode=True,
                          bias_correction=True, grad_scale=None):
    """The Adam kernel's step, leaf by leaf, in place: lists of gradients
    (fp32, bf16 or fp16), fp32 masters, m and v, and optionally the tensors
    that get the new master in their own dtype.  Every product and sum is
    its own fp32 op, in ``_adam_kernel``'s order (so the kernel, which
    contracts nothing into FMAs, gives the same bits).  ``grad_scale``: a
    0-dim fp32 tensor that multiplies the gradient, or None."""
    c1, c2 = bias_corrections(beta1, beta2, count, bias_correction)
    outs = params_out if params_out is not None else [None] * len(grads)
    for g, p, m, v, out in zip(grads, masters, exp_avgs, exp_avg_sqs, outs):
        b1, b2, lr_, eps_, wd, c1_, c2_ = _scalars(
            p.device, beta1, beta2, lr, eps, weight_decay, c1, c2)
        g = _scaled_grad(g, grad_scale, p.device)
        if not adam_w_mode:
            g = g + wd * p
        m.copy_(b1 * m + (1.0 - b1) * g)
        v.copy_(b2 * v + ((1.0 - b2) * g) * g)
        step = (m / c1_) / (torch.sqrt(v / c2_) + eps_)
        if adam_w_mode:
            step = step + wd * p
        p.copy_(p - lr_ * step)
        if out is not None:
            out.copy_(p)


def fused_lion_step_plain(grads, masters, exp_avgs, params_out=None, *, lr,
                          beta1, beta2, weight_decay, grad_scale=None):
    """The Lion kernel's step (``_lion_kernel``'s order), leaf by leaf, in
    place on the fp32 masters and m; ``params_out`` as for Adam."""
    outs = params_out if params_out is not None else [None] * len(grads)
    for g, p, m, out in zip(grads, masters, exp_avgs, outs):
        b1, b2, lr_, wd = _scalars(p.device, beta1, beta2, lr, weight_decay)
        g = _scaled_grad(g, grad_scale, p.device)
        update = torch.sign(b1 * m + (1.0 - b1) * g)
        p.copy_(p - lr_ * (update + wd * p))
        m.copy_(b2 * m + (1.0 - b2) * g)
        if out is not None:
            out.copy_(p)


def lamb_trust_ratio(p_sq, u_sq, max_coeff=10.0, min_coeff=0.01):
    """``fused_lamb_step``'s ratio (:243-248) from fp32 sums of p·p and
    u·u: clip(|p| / |u|, min_coeff, max_coeff), 1 where either norm is 0."""
    pn, un = torch.sqrt(p_sq), torch.sqrt(u_sq)
    ratio = torch.clamp(pn / un, min_coeff, max_coeff)
    return torch.where((pn > 0) & (un > 0), ratio, torch.ones_like(ratio))


def fused_lamb_phase1_plain(grads, masters, exp_avgs, exp_avg_sqs, updates,
                            *, beta1, beta2, eps, weight_decay, count,
                            bias_correction=True, grad_scale=None):
    """LAMB phase 1, leaf by leaf (``_lamb_phase1_kernel``'s order): m and v
    in place, the update u written into ``updates``; returns the fp32 sums
    of p·p (the master before the step) and u·u, one row per leaf."""
    c1, c2 = bias_corrections(beta1, beta2, count, bias_correction)
    sums = []
    for g, p, m, v, u in zip(grads, masters, exp_avgs, exp_avg_sqs,
                             updates):
        b1, b2, eps_, wd, c1_, c2_ = _scalars(
            p.device, beta1, beta2, eps, weight_decay, c1, c2)
        g = _scaled_grad(g, grad_scale, p.device)
        m.copy_(b1 * m + (1.0 - b1) * g)
        v.copy_(b2 * v + ((1.0 - b2) * g) * g)
        u.copy_((m / c1_) / (torch.sqrt(v / c2_) + eps_) + wd * p)
        sums.append(torch.stack([(p * p).sum(), (u * u).sum()]))
    return torch.stack(sums) if sums else torch.zeros(0, 2)


def fused_lamb_phase2_plain(masters, updates, params_out, sums, *, lr,
                            max_coeff=10.0, min_coeff=0.01):
    """LAMB phase 2, leaf by leaf: each leaf's ratio from its row of
    ``sums``, then p −= (lr·ratio)·u and the copy.  Returns the ratios."""
    ratios = lamb_trust_ratio(sums[:, 0], sums[:, 1], max_coeff, min_coeff)
    outs = params_out if params_out is not None else [None] * len(masters)
    for i, (p, u, out) in enumerate(zip(masters, updates, outs)):
        lr_, = _scalars(p.device, lr)
        p.copy_(p - (lr_ * ratios[i].to(p.device)) * u)
        if out is not None:
            out.copy_(p)
    return ratios


def fused_lamb_step_plain(grads, masters, exp_avgs, exp_avg_sqs,
                          params_out=None, updates=None, *, lr, beta1, beta2,
                          eps, weight_decay, count, bias_correction=True,
                          max_coeff=10.0, min_coeff=0.01, grad_scale=None):
    """Both LAMB phases leaf by leaf; returns [leaves, 3] fp32 (sum p·p, sum
    u·u, ratio) like the kernels.  ``updates``: tensors for u (default:
    temporaries)."""
    if updates is None:
        updates = [torch.empty_like(p) for p in masters]
    sums = fused_lamb_phase1_plain(
        grads, masters, exp_avgs, exp_avg_sqs, updates, beta1=beta1,
        beta2=beta2, eps=eps, weight_decay=weight_decay, count=count,
        bias_correction=bias_correction, grad_scale=grad_scale)
    ratios = fused_lamb_phase2_plain(masters, updates, params_out, sums,
                                     lr=lr, max_coeff=max_coeff,
                                     min_coeff=min_coeff)
    return torch.cat([sums, ratios[:, None]], dim=1)


# ---------------------------------------------------------------- checks
def _check_flat(named, n):
    """Checks the flat buffers; returns the card the kernel launches on, or
    None for the plain version (every buffer on the CPU).  A host buffer
    beside one on the card must be pinned (module docstring)."""
    for name, t in named:
        if t.dim() != 1 or t.numel() != n:
            raise ValueError(f"{name} must be a flat buffer of {n} elements, "
                             f"got {tuple(t.shape)}")
    kinds = {t.device.type for _, t in named}
    if kinds - {"cpu", "cuda"}:
        raise ValueError(f"the optimizer kernels run on cpu or cuda, not "
                         f"{sorted(kinds - {'cpu', 'cuda'})}")
    cards = {t.device for _, t in named if t.device.type == "cuda"}
    if not cards:
        return None
    if len(cards) > 1:
        raise ValueError(f"buffers on several cards: {cards}")
    for name, t in named:
        if t.device.type == "cpu" and not t.is_pinned():
            raise ValueError(
                f"{name} lies in pageable host memory beside buffers on the "
                "card: offloaded optimizer state must be pinned")
    return cards.pop()


def _check_kernel_args(what, grad, fp32_bufs, param_out, grad_scale, device):
    if grad.dtype not in _GRAD_CODES:
        raise TypeError(f"fused {what} kernel takes an fp32, bf16 or fp16 "
                        f"gradient, got {grad.dtype}")
    for name, t in fp32_bufs:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be fp32, got {t.dtype}")
    if param_out is not None and param_out.dtype not in _OUT_CODES:
        raise TypeError(f"param_out must be bf16 or fp16, got "
                        f"{param_out.dtype}")
    bufs = [("grad", grad), *fp32_bufs]
    if param_out is not None:
        bufs.append(("param_out", param_out))
    for name, t in bufs:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if grad_scale is not None and (grad_scale.numel() != 1 or
                                   grad_scale.dtype != torch.float32 or
                                   grad_scale.device != device):
        raise ValueError("grad_scale must be one fp32 value on the card")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _out_code(param_out):
    return 0 if param_out is None else _OUT_CODES[param_out.dtype]


def _raise_on(lib, err, what):
    if err:
        raise RuntimeError(f"fused {what} kernel launch failed: "
                           f"{lib.ds_cuda_error_string(err).decode()} ({err})")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


# ------------------------------------------------------------------ Adam
def fused_adam_step(grad, master, exp_avg, exp_avg_sq, param_out=None, *,
                    lr, beta1, beta2, eps, weight_decay, count,
                    adam_w_mode=True, bias_correction=True, grad_scale=None):
    """One Adam(W) (or L2, ``adam_w_mode=False``) step over flat 1-D
    buffers, in place.  ``grad``: fp32, bf16 or fp16; ``master``,
    ``exp_avg``, ``exp_avg_sq``: fp32; ``param_out``: bf16 or fp16 buffer
    that gets the new master (or None); ``count``: the 1-based step;
    ``grad_scale``: a 0-dim fp32 tensor on the same device multiplying the
    gradient, or None."""
    bufs = [("grad", grad), ("master", master), ("exp_avg", exp_avg),
            ("exp_avg_sq", exp_avg_sq)]
    if param_out is not None:
        bufs.append(("param_out", param_out))
    n = master.numel()
    device = _check_flat(bufs, n)
    hyper = dict(lr=lr, beta1=beta1, beta2=beta2, eps=eps,
                 weight_decay=weight_decay, count=count,
                 adam_w_mode=adam_w_mode, bias_correction=bias_correction,
                 grad_scale=grad_scale)
    if device is None:
        fused_adam_step_plain([grad], [master], [exp_avg], [exp_avg_sq],
                              None if param_out is None else [param_out],
                              **hyper)
        return
    _check_kernel_args("Adam", grad, bufs[1:4], param_out, grad_scale,
                       device)
    if n == 0:
        return
    c1, c2 = bias_corrections(beta1, beta2, count, bias_correction)
    lib = OptimizersBuilder().load()
    with torch.cuda.device(device):
        err = lib.ds_fused_adam(
            grad.data_ptr(), _GRAD_CODES[grad.dtype], master.data_ptr(),
            exp_avg.data_ptr(), exp_avg_sq.data_ptr(), _ptr(param_out),
            _out_code(param_out), _ptr(grad_scale), n, float(lr),
            float(beta1), float(beta2), float(eps), float(weight_decay), c1,
            c2, int(bool(adam_w_mode)), _stream(device))
    _raise_on(lib, err, "Adam")
    fused_adam_step.launches += 1


fused_adam_step.launches = 0


# ------------------------------------------------------------------ Lion
def fused_lion_step(grad, master, exp_avg, param_out=None, *, lr, beta1,
                    beta2, weight_decay, grad_scale=None):
    """One Lion step over flat 1-D buffers, in place (``grad``: fp32, bf16
    or fp16; ``master``, ``exp_avg``: fp32; ``param_out``, ``grad_scale``
    as for :func:`fused_adam_step`)."""
    bufs = [("grad", grad), ("master", master), ("exp_avg", exp_avg)]
    if param_out is not None:
        bufs.append(("param_out", param_out))
    n = master.numel()
    device = _check_flat(bufs, n)
    hyper = dict(lr=lr, beta1=beta1, beta2=beta2, weight_decay=weight_decay,
                 grad_scale=grad_scale)
    if device is None:
        fused_lion_step_plain([grad], [master], [exp_avg],
                              None if param_out is None else [param_out],
                              **hyper)
        return
    _check_kernel_args("Lion", grad, bufs[1:3], param_out, grad_scale,
                       device)
    if n == 0:
        return
    lib = OptimizersBuilder().load()
    with torch.cuda.device(device):
        err = lib.ds_fused_lion(
            grad.data_ptr(), _GRAD_CODES[grad.dtype], master.data_ptr(),
            exp_avg.data_ptr(), _ptr(param_out), _out_code(param_out),
            _ptr(grad_scale), n, float(lr), float(beta1), float(beta2),
            float(weight_decay), _stream(device))
    _raise_on(lib, err, "Lion")
    fused_lion_step.launches += 1


fused_lion_step.launches = 0


# ------------------------------------------------------------------ LAMB
class LambTable:
    """The leaves of a flat buffer, ``[(offset, numel)]`` (offsets multiples
    of 4), cut into chunks of at most ``chunk`` elements: ``rows`` is
    [chunks, 3] int64 (start, length, leaf) and ``leaf_chunks`` [leaves + 1]
    int32, leaf l owning rows ``leaf_chunks[l]`` .. ``leaf_chunks[l+1]-1``.
    Both live on ``device`` once built; the engine builds the table once
    from its layout."""

    def __init__(self, leaves, device="cpu", chunk=LAMB_CHUNK):
        if chunk % 4:
            raise ValueError("chunk must be a multiple of 4")
        self.leaves = [(int(o), int(n)) for o, n in leaves]
        rows, firsts = [], []
        for leaf, (off, n) in enumerate(self.leaves):
            if off % 4:
                raise ValueError(f"leaf {leaf} starts at {off}, not a "
                                 f"multiple of 4")
            firsts.append(len(rows))
            rows += [(off + s, min(chunk, n - s), leaf)
                     for s in range(0, n, chunk)]
        firsts.append(len(rows))
        self.n_chunks = len(rows)
        self.rows = torch.tensor(rows or [(0, 0, 0)], dtype=torch.int64,
                                 device=device)
        self.leaf_chunks = torch.tensor(firsts, dtype=torch.int32,
                                        device=device)

    @property
    def n_leaves(self):
        return len(self.leaves)

    def views(self, t):
        return [t[o:o + n] for o, n in self.leaves]


def _check_table(table, master, device):
    if table.rows.device != device:
        raise ValueError("the LAMB table lies on another device than the "
                         "kernel's")
    end = max((o + n for o, n in table.leaves), default=0)
    if end > master.numel():
        raise ValueError(f"the LAMB table reaches element {end} of a "
                         f"{master.numel()}-element buffer")


def fused_lamb_phase1(grad, master, exp_avg, exp_avg_sq, update, table, *,
                      beta1, beta2, eps, weight_decay, count,
                      bias_correction=True, grad_scale=None):
    """LAMB phase-1 kernel over flat CUDA buffers: m, v in place, u into
    ``update`` (fp32, same size); returns the per-chunk fp32 partial sums
    [chunks, 2] of p·p and u·u for :func:`fused_lamb_phase2`."""
    bufs = [("grad", grad), ("master", master), ("exp_avg", exp_avg),
            ("exp_avg_sq", exp_avg_sq), ("update", update)]
    device = _check_flat(bufs, master.numel())
    if device is None:
        raise ValueError("fused_lamb_phase1 launches the kernel: CUDA "
                         "buffers only")
    _check_kernel_args("LAMB", grad, bufs[1:], None, grad_scale, device)
    _check_table(table, master, device)
    partials = torch.empty(max(table.n_chunks, 1), 2, dtype=torch.float32,
                           device=device)
    if table.n_chunks == 0:
        return partials
    c1, c2 = bias_corrections(beta1, beta2, count, bias_correction)
    lib = OptimizersBuilder().load()
    with torch.cuda.device(device):
        err = lib.ds_lamb_phase1(
            grad.data_ptr(), _GRAD_CODES[grad.dtype], master.data_ptr(),
            exp_avg.data_ptr(), exp_avg_sq.data_ptr(), update.data_ptr(),
            _ptr(grad_scale), table.rows.data_ptr(), table.n_chunks,
            partials.data_ptr(), float(beta1), float(beta2), float(eps),
            float(weight_decay), c1, c2, _stream(device))
    _raise_on(lib, err, "LAMB phase-1")
    fused_lamb_phase1.launches += 1
    return partials


fused_lamb_phase1.launches = 0


def fused_lamb_phase2(master, update, param_out, table, partials, *, lr,
                      max_coeff=10.0, min_coeff=0.01):
    """LAMB phase-2 kernel over flat CUDA buffers: each leaf's trust ratio
    from ``partials`` (reduced in a fixed order inside the kernel), master
    −= (lr·ratio)·u, and the copy into ``param_out`` (bf16, fp16 or None).
    Returns [leaves, 3] fp32: sum p·p, sum u·u, ratio."""
    bufs = [("master", master), ("update", update)]
    if param_out is not None:
        bufs.append(("param_out", param_out))
    device = _check_flat(bufs, master.numel())
    if device is None:
        raise ValueError("fused_lamb_phase2 launches the kernel: CUDA "
                         "buffers only")
    _check_kernel_args("LAMB", master, bufs[1:2], param_out, None, device)
    _check_table(table, master, device)
    if partials.shape[0] < table.n_chunks or \
            partials.dtype != torch.float32:
        raise ValueError("partials must be phase 1's [chunks, 2] fp32 sums")
    stats = torch.zeros(table.n_leaves, 3, dtype=torch.float32,
                        device=device)
    if table.n_chunks == 0:
        return stats
    lib = OptimizersBuilder().load()
    with torch.cuda.device(device):
        err = lib.ds_lamb_phase2(
            master.data_ptr(), update.data_ptr(), _ptr(param_out),
            _out_code(param_out), table.rows.data_ptr(), table.n_chunks,
            table.leaf_chunks.data_ptr(), partials.data_ptr(),
            stats.data_ptr(), float(lr), float(max_coeff), float(min_coeff),
            _stream(device))
    _raise_on(lib, err, "LAMB phase-2")
    fused_lamb_phase2.launches += 1
    return stats


fused_lamb_phase2.launches = 0


def fused_lamb_step(grad, master, exp_avg, exp_avg_sq, update,
                    param_out=None, *, table, lr, beta1, beta2, eps,
                    weight_decay, count, bias_correction=True,
                    max_coeff=10.0, min_coeff=0.01, grad_scale=None):
    """One LAMB step over flat 1-D buffers whose leaves ``table`` lists, in
    place (``update``: fp32 scratch of the master's size that receives u).
    CPU buffers: the plain version leaf by leaf; CUDA buffers: the phase-1
    and phase-2 kernels.  Returns [leaves, 3] fp32 (sum p·p, sum u·u, trust
    ratio)."""
    bufs = [("grad", grad), ("master", master), ("exp_avg", exp_avg),
            ("exp_avg_sq", exp_avg_sq), ("update", update)]
    if param_out is not None:
        bufs.append(("param_out", param_out))
    device = _check_flat(bufs, master.numel())
    ratio_kw = dict(max_coeff=max_coeff, min_coeff=min_coeff)
    hyper = dict(beta1=beta1, beta2=beta2, eps=eps,
                 weight_decay=weight_decay, count=count,
                 bias_correction=bias_correction, grad_scale=grad_scale)
    if device is None:
        v = table.views
        return fused_lamb_step_plain(
            v(grad), v(master), v(exp_avg), v(exp_avg_sq),
            None if param_out is None else v(param_out), v(update), lr=lr,
            **hyper, **ratio_kw)
    partials = fused_lamb_phase1(grad, master, exp_avg, exp_avg_sq, update,
                                 table, **hyper)
    return fused_lamb_phase2(master, update, param_out, table, partials,
                             lr=lr, **ratio_kw)
