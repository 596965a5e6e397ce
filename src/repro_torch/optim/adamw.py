"""AdamW (port of ``repro/optim/adamw.py``) on a name -> tensor mapping of a
model's parameters, with float32 moments ``m``, ``v`` and an int32 step
counter, updated in place under ``torch.no_grad()``.

The arithmetic follows the reference op for op: clip by the global norm
(``+ 1e-9``), ``step + 1``, linear warmup times cosine decay, the bias
corrections ``1 - b ** step`` in float32, the weight-decay term inside the
learning-rate product, the result cast back to the parameter's dtype.
Python constants meet float32 tensors as the reference's weakly typed
scalars do (rounded to float32).  Every value stays on the device: the
metrics are 0-d tensors, read only where the caller wants them.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay at `step` (an integer tensor), as a
    float32 tensor."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0., 1.)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * cos


def init_opt_state(params: dict) -> dict:
    """Zero float32 moments shaped like `params` (on their devices) and a
    0-d int32 step on the first parameter's device."""
    dev = next(iter(params.values())).device
    return {"m": {n: torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for n, p in params.items()},
            "v": {n: torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for n, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(grads: dict) -> torch.Tensor:
    """The float32 L2 norm over every gradient."""
    return torch.sqrt(sum(g.float().square().sum() for g in grads.values()))


def clip_by_global_norm(grads: dict, max_norm: float, norm=global_norm):
    """(float32 gradients scaled so their global norm is at most
    `max_norm`, the norm before clipping); `norm` computes the global
    norm (``ModelParallel.global_norm`` for the blocks of a sharded
    state)."""
    gn = norm(grads)
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return {n: g.float() * scale for n, g in grads.items()}, gn


@torch.no_grad()
def adamw_update(params: dict, grads: dict, opt_state: dict,
                 cfg: AdamWConfig, norm=global_norm) -> dict:
    """One AdamW step: updates `params` (name -> tensor, e.g.
    ``dict(model.named_parameters())``) and `opt_state` (``m``, ``v``,
    ``step``) in place from `grads` (the same names; a missing or None
    gradient counts as zeros, as the reference's gradient of an unused
    weight).  `norm`: see ``clip_by_global_norm``; every other op is
    elementwise, so a sharded state updates its blocks as they are.
    Returns ``{"grad_norm", "lr"}`` as 0-d tensors."""
    grads = {n: torch.zeros_like(p) if grads.get(n) is None else grads[n]
             for n, p in params.items()}
    grads, gn = clip_by_global_norm(grads, cfg.clip_norm, norm)
    step = opt_state["step"] + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(b1, step.float())
    bc2 = 1 - torch.pow(b2, step.float())
    for n, p in params.items():
        g, m, v = grads[n], opt_state["m"][n], opt_state["v"][n]
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * torch.square(g))
        p32 = p.float()
        new = p32 - lr * ((m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
                          + cfg.weight_decay * p32)
        p.copy_(new)
    opt_state["step"].copy_(step)
    return {"grad_norm": gn, "lr": lr}
