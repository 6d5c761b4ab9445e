"""MoE gating (the port of ``deepspeed_tpu/moe/sharded_moe.py``; reference
``deepspeed/moe/sharded_moe.py``: ``top1gating`` :183, ``top2gating``
:290, ``topkgating``, ``TopKGate`` :374, ``MOELayer`` :533).

The gating math is JAX's, which follows GShard and the reference: the
capacity, the load-balance aux loss, the slot of each token in its
expert's buffer by a cumsum in token order.  JAX runs it as one program
over the GLOBAL token array (tokens sharded over ``(dp, ep)``); here each
rank holds its own tokens, so ``group`` (the data-parallel group of the
token ranks, in their global order) makes the same global quantities:

* the capacity comes from the global token count, T · ranks;
* a token's slot is the cumsum in global order: the per-expert counts of
  the ranks before this one (E integers a rank, all-gathered) are added;
* ``me`` (mean router probability) and ``ce`` (mean assignment) of the aux
  loss are global means.  ``me``'s gradient to the rank's own router
  probabilities is scaled by the number of ranks: every rank's loss holds
  the same global aux loss, and the engine averages the ranks' losses, so
  the averaged gradient is JAX's.

Without ``group`` (or with a group of one rank) every function is JAX's on
the rank's tokens.  Noise (RSample's Gumbel draw) comes from an explicit
``torch.Generator``; a test passes ``noise`` (the same numbers as JAX's
draw) instead.
"""

import torch
import torch.nn.functional as F


def _capacity(num_tokens, num_experts, capacity_factor, min_capacity=4):
    cap = int(num_tokens * capacity_factor / num_experts)
    cap = max(cap, min_capacity)
    # clamp at T (sharded_moe.py:29): an expert never receives more than
    # every token
    return min(cap, num_tokens)


class _Tokens:
    """The global view of the rank's tokens over ``group`` (see the module
    docstring); a local view without one."""

    def __init__(self, T, group):
        self.group = group if group is not None and group.size() > 1 \
            else None
        self.n = 1 if self.group is None else self.group.size()
        self.rank = 0 if self.group is None else self.group.rank()
        self.T = T * self.n

    def counts(self, *masks):
        """(prefix, total) of each [T, E] mask's per-expert counts: the
        counts of the ranks before this one, and of all ranks."""
        local = torch.stack([m.sum(dim=0) for m in masks])      # [m, E]
        if self.group is None:
            return [torch.zeros_like(c) for c in local], list(local)
        from .. import comm as dist
        every = dist.all_gather(local.unsqueeze(0).contiguous(),
                                group=self.group, axis=0)       # [n, m, E]
        prefix = every[:self.rank].sum(dim=0)
        total = every.sum(dim=0)
        return list(prefix), list(total)

    def mean(self, x):
        """The global mean over tokens of ``x`` [T, E], whose gradient to
        the local rows is scaled by the number of ranks."""
        local = x.sum(dim=0)
        if self.group is None:
            return local / self.T
        from .. import comm as dist
        total = dist.all_reduce(local.detach().clone(), group=self.group)
        scaled = local * self.n
        return (scaled + (total - scaled).detach()) / self.T

    def sum(self, x):
        if self.group is None:
            return x
        from .. import comm as dist
        return dist.all_reduce(x.clone(), group=self.group)


def _gumbel(shape, generator, device):
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_min(1e-20)))


def top1gating(logits, capacity_factor=1.0, min_capacity=4,
               noisy_gate_policy=None, rng=None, used_token=None,
               group=None, noise=None):
    """Reference ``top1gating``: (l_aux, combine [T,E,C], dispatch
    [T,E,C], exp_counts [E]).  ``rng``: a ``torch.Generator`` for
    RSample's Gumbel noise (``noise``: the noise itself)."""
    T, E = logits.shape
    tok = _Tokens(T, group)
    C = _capacity(tok.T, E, capacity_factor, min_capacity)
    logits_for_sel = logits
    if noisy_gate_policy == "RSample" and (rng is not None
                                           or noise is not None):
        if noise is None:
            noise = _gumbel(logits.shape, rng, logits.device)
        logits_for_sel = logits + noise
    gates = torch.softmax(logits, dim=-1)
    idx = torch.argmax(logits_for_sel, dim=-1)
    mask1 = F.one_hot(idx, E).to(gates.dtype)
    if used_token is not None:
        mask1 = mask1 * used_token[:, None].to(mask1.dtype)
    (prefix, ), (total, ) = tok.counts(mask1)
    me = tok.mean(gates)
    ce = total / tok.T
    l_aux = torch.sum(me * ce) * E
    locations1 = torch.cumsum(mask1, dim=0) - 1.0 + prefix
    mask1 = mask1 * (locations1 < C)
    pos = torch.sum(locations1 * mask1, dim=-1).long()
    gate1 = torch.sum(gates * mask1, dim=-1)
    combine = (gate1[:, None, None] * mask1[:, :, None] *
               F.one_hot(pos, C).to(gates.dtype)[:, None, :])
    dispatch = combine > 0
    exp_counts = tok.sum(mask1.sum(dim=0))
    return l_aux, combine, dispatch, exp_counts


def top2gating(logits, capacity_factor=1.0, min_capacity=4, rng=None,
               group=None):
    """Reference ``top2gating``: top-2, the second expert's jitter
    dropped (deterministic), capacity-bounded."""
    T, E = logits.shape
    tok = _Tokens(T, group)
    C = _capacity(tok.T, E, capacity_factor * 2, min_capacity)
    gates = torch.softmax(logits, dim=-1)
    idx1 = torch.argmax(gates, dim=-1)
    mask1 = F.one_hot(idx1, E).to(gates.dtype)
    logits_wo1 = torch.where(mask1 > 0, torch.full_like(logits, -torch.inf),
                             logits)
    idx2 = torch.argmax(logits_wo1, dim=-1)
    mask2 = F.one_hot(idx2, E).to(gates.dtype)
    (p1, p2), (t1, _) = tok.counts(mask1, mask2)
    me = tok.mean(gates)
    ce = t1 / tok.T
    l_aux = torch.sum(me * ce) * E
    locations1 = torch.cumsum(mask1, dim=0) - 1.0 + p1
    locations2 = torch.cumsum(mask2, dim=0) - 1.0 + p2 + t1[None]
    mask1 = mask1 * (locations1 < C)
    mask2 = mask2 * (locations2 < C)
    pos1 = torch.sum(locations1 * mask1, dim=-1).long()
    pos2 = torch.sum(locations2 * mask2, dim=-1).long()
    g1 = torch.sum(gates * mask1, dim=-1)
    g2 = torch.sum(gates * mask2, dim=-1)
    denom = torch.clamp(g1 + g2, min=torch.finfo(gates.dtype).eps)
    g1, g2 = g1 / denom, g2 / denom
    oh1 = F.one_hot(pos1, C).to(gates.dtype)
    oh2 = F.one_hot(pos2, C).to(gates.dtype)
    combine = (g1[:, None, None] * mask1[:, :, None] * oh1[:, None, :]
               + g2[:, None, None] * mask2[:, :, None] * oh2[:, None, :])
    dispatch = combine > 0
    exp_counts = tok.sum((mask1 + mask2).sum(dim=0))
    return l_aux, combine, dispatch, exp_counts


def topkgating(logits, k, capacity_factor=1.0, min_capacity=4,
               drop_tokens=True, group=None):
    """Reference ``topkgating`` (general k).  ``drop_tokens=False``: the
    capacity is the static worst case, every token (C = T), as in JAX."""
    T, E = logits.shape
    tok = _Tokens(T, group)
    C = _capacity(tok.T, E, capacity_factor * k, min_capacity) \
        if drop_tokens else tok.T
    gates = torch.softmax(logits, dim=-1)
    _, topk_idx = torch.topk(gates, k, dim=-1)
    mask = F.one_hot(topk_idx, E).sum(dim=1).to(gates.dtype)
    (prefix, ), (total, ) = tok.counts(mask)
    me = tok.mean(gates)
    ce = total / tok.T
    l_aux = torch.sum(me * ce) * E / k
    locations = torch.cumsum(mask, dim=0) - 1.0 + prefix
    if drop_tokens:
        mask = mask * (locations < C)
    pos = (locations * mask).long()
    gates_masked = gates * mask
    denom = torch.clamp(gates_masked.sum(dim=-1, keepdim=True),
                        min=torch.finfo(gates.dtype).eps)
    gates_norm = gates_masked / denom
    combine = gates_norm[:, :, None] * mask[:, :, None] * \
        F.one_hot(pos, C).to(gates.dtype)
    dispatch = combine > 0
    return l_aux, combine, dispatch, tok.sum(mask.sum(dim=0))


class TopKGate:
    """Reference ``TopKGate``, functional: ``gate(logits)`` returns
    (l_aux, combine, dispatch, counts)."""

    def __init__(self, k=1, capacity_factor=1.0, eval_capacity_factor=1.0,
                 min_capacity=4, noisy_gate_policy=None, drop_tokens=True):
        self.k = k
        self.capacity_factor = capacity_factor
        self.eval_capacity_factor = eval_capacity_factor
        self.min_capacity = min_capacity
        self.noisy_gate_policy = noisy_gate_policy
        self.drop_tokens = drop_tokens

    def __call__(self, logits, train=True, rng=None, group=None,
                 noise=None):
        cf = self.capacity_factor if train else self.eval_capacity_factor
        if self.drop_tokens:
            if self.k == 1:
                return top1gating(logits, cf, self.min_capacity,
                                  self.noisy_gate_policy if train else None,
                                  rng, group=group, noise=noise)
            if self.k == 2:
                return top2gating(logits, cf, self.min_capacity, rng,
                                  group=group)
        return topkgating(logits, self.k, cf, self.min_capacity,
                          self.drop_tokens, group=group)


def dispatch_combine(x, combine, dispatch, expert_fn):
    """The flat dispatch of one rank that holds every token and every
    expert (``sharded_moe.py:172``): einsum dispatch → experts → einsum
    combine.  x: [T, D]; combine/dispatch: [T, E, C]; expert_fn:
    [E, C, D] → [E, C, D]."""
    dispatched = torch.einsum("tec,td->ecd", dispatch.to(x.dtype), x)
    out = expert_fn(dispatched)
    return torch.einsum("tec,ecd->td", combine.to(x.dtype), out)
