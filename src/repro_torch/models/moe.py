"""Mixture-of-Experts FFN (port of ``repro/models/moe.py``): top-k router
and per-row sort-based capacity dispatch.

Capacity C = int(S*top_k/E * capacity_factor) + 1 per row, in Python
floats; the assignments of a row are sorted by expert with a stable sort
(as ``jnp.argsort``), an assignment ranked C or later in its expert is
dropped (it goes to slot E*C, which is cut off, as ``mode="drop"`` drops
it), and an unfilled slot points at token 0 with weight 0.  The combine
is a scatter-add, so it sums a token's experts in another order than the
reference: equal within a tolerance, not bit for bit.

The router's load-balancing loss ``E * sum_e mean(probs_e) *
mean(onehot_e)`` is a product of two means over the *global* batch, not
a mean over rows.  Under data parallelism (``global_batch(group)``, which
``train.step`` enters) each rank's two means are averaged over the group
with a differentiable all-reduce before the product, so every rank sees
the global batch's loss and its gradient.  The dispatch is per row and
needs nothing of the other ranks.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

#: the process group whose ranks together hold the batch, while
#: ``global_batch`` is entered
_GROUP = None


@contextlib.contextmanager
def global_batch(group):
    """Within the block, the router's statistics are means over the rows
    of every rank of `group` (equal row counts a rank); None: this
    process's rows only."""
    global _GROUP
    outer, _GROUP = _GROUP, group
    try:
        yield
    finally:
        _GROUP = outer


def _group_mean(t):
    """`t` averaged over ``_GROUP``'s ranks (differentiable), or as it is
    without a group."""
    if _GROUP is None:
        return t
    import torch.distributed as dist
    import torch.distributed.nn.functional as dist_nn
    return dist_nn.all_reduce(t, group=_GROUP) / dist.get_world_size(_GROUP)

from ..distributed import model_parallel
from .common import Init, ParamModule, act_fn


class MoE(ParamModule):
    """router (D, E), wg / wu (E, D, Fe), wd (E, Fe, D)."""

    def __init__(self, cfg, init: Init):
        super().__init__()
        D, Fe, E = cfg.d_model, cfg.d_ff, cfg.n_experts
        self.declare(init, "router", (D, E), spec=(None, None))
        self.declare(init, "wg", (E, D, Fe), spec=("model", "data", None))
        self.declare(init, "wu", (E, D, Fe), spec=("model", "data", None))
        self.declare(init, "wd", (E, Fe, D), spec=("model", None, "data"))


def router_topk(x, w_router, cfg):
    """x: (B, S, D) -> (weights (B,S,K), experts (B,S,K), aux scalar).
    Logits and probabilities in float32; the weights go back to x's
    dtype."""
    logits = torch.einsum("bsd,de->bse", x, w_router).float()
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, cfg.top_k, dim=-1)
    if cfg.norm_topk_prob:
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-9)
    E = cfg.n_experts
    me = _group_mean(probs.mean(dim=(0, 1)))
    fe = _group_mean(F.one_hot(idx[..., 0], E).float().mean(dim=(0, 1)))
    aux = E * (me * fe).sum()
    return w.to(x.dtype), idx.to(torch.int32), aux


def moe_ffn(p, x, cfg):
    """p: router (D,E), wg/wu (E, D, Fe), wd (E, Fe, D).  x: (B, S, D).
    Returns (y, aux_loss).

    On a model sharded over ``model`` with the experts split
    (``model_parallel.split``) the routing, sort and dispatch run in full
    on every rank; each rank runs its E/M experts' slots and
    scatter-adds a partial `y` that ``reduce_from_model`` sums.  The
    tokens and the combine weights enter through ``copy_to_model``, so
    their gradients (the router's among them) are the sums over the
    experts of every rank."""
    B, S, D = x.shape
    K, E = cfg.top_k, cfg.n_experts
    C = int(S * K / E * cfg.capacity_factor) + 1
    w, idx, aux = router_topk(x, p["router"], cfg)
    dev = x.device

    # ---- per-row sort-based dispatch ----
    eid = idx.reshape(B, S * K).long()                   # (B, S*K)
    tok = torch.arange(S, device=dev).repeat_interleave(K).expand(B, S * K)
    wgt = w.reshape(B, S * K)
    order = torch.argsort(eid, dim=-1, stable=True)
    eid_s = eid.gather(-1, order)
    tok_s = tok.gather(-1, order)
    wgt_s = wgt.gather(-1, order)
    starts = torch.searchsorted(
        eid_s, torch.arange(E, device=dev).expand(B, E).contiguous())
    rank = torch.arange(S * K, device=dev)[None, :] - starts.gather(-1, eid_s)
    keep = rank < C
    slot = torch.where(keep, eid_s * C + rank, E * C)    # E*C -> dropped

    tok_for = torch.zeros((B, E * C + 1), dtype=torch.long, device=dev) \
        .scatter_(1, slot, tok_s)[:, :E * C]
    wgt_for = torch.zeros((B, E * C + 1), dtype=x.dtype, device=dev) \
        .scatter_(1, slot, wgt_s)[:, :E * C]

    # ---- experts over ``model``: this rank's E/M experts' slots ----
    mp = model_parallel.split(p)
    if mp is not None and not all(p.model_split(n, 0)
                                  for n in ("wg", "wu", "wd")):
        mp.record_path("moe", "gathered")
        mp = None
    read = p.__getitem__
    if mp is not None:
        n_local = E // mp.size["model"]
        mp.record_path("moe", f"split, {n_local} of {E} experts")
        mine = slice(mp.coord["model"] * n_local * C,
                     (mp.coord["model"] + 1) * n_local * C)
        x, E = mp.copy_to_model(x), n_local
        tok_for = tok_for[:, mine]
        wgt_for = mp.copy_to_model(wgt_for)[:, mine]
        read = p.local

    # ---- gather tokens into (B, E, C, D) expert tiles ----
    xe = x.gather(1, tok_for[..., None].expand(B, E * C, D))  # (B, E*C, D)
    xe = xe.reshape(B, E, C, D)
    act = act_fn(cfg.act)
    h = act(torch.einsum("becd,edf->becf", xe, read("wg"))) * \
        torch.einsum("becd,edf->becf", xe, read("wu"))
    ye = torch.einsum("becf,efd->becd", h, read("wd"))
    ye = ye.reshape(B, E * C, D) * wgt_for[..., None]

    # ---- combine: per-row scatter-add back to the tokens ----
    y = torch.zeros((B, S, D), dtype=x.dtype, device=dev).scatter_add_(
        1, tok_for[..., None].expand(B, E * C, D), ye.to(x.dtype))
    if mp is not None:
        y = mp.reduce_from_model(y)
    return y, aux.float()
