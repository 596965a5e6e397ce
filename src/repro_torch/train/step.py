"""Train step factory (port of ``repro/train/step.py``): loss and gradients
(``torch.autograd`` over ``model.loss``) -> clip -> AdamW, with optional
gradient accumulation over micro-batches.

The training state is ``{"model": nn.Module, "opt": {"m", "v", "step"}}``:
the model holds the (float32 master) weights, ``opt`` the AdamW state of
``optim.adamw``, keyed by the model's parameter names.  A step updates
both in place and returns the same state object, so a caller that holds
the state sees the update (the reference returns new arrays).
"""
from __future__ import annotations

import torch

from ..optim.adamw import AdamWConfig, adamw_update, init_opt_state


def make_train_step(model, opt_cfg: AdamWConfig, grad_accum: int = 1):
    """``train_step(state, batch) -> (state, metrics)`` for `model` (the
    state's ``"model"``), metrics ``{"loss", "grad_norm", "lr"}`` as 0-d
    tensors on the device; `batch` holds numpy arrays or tensors.  With
    `grad_accum` > 1 the batch splits along dim 0 into `grad_accum`
    micro-batches whose float32 gradients are summed and divided by
    `grad_accum` (the reference's ``lax.scan``); the loss is their
    mean."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum={grad_accum} must be >= 1")
    params = dict(model.named_parameters())

    def train_step(state, batch):
        for p in params.values():
            p.grad = None
        with torch.enable_grad():
            if grad_accum == 1:
                loss, _ = model.loss(batch)
                loss.backward()
            else:
                n = next(iter(batch.values())).shape[0] // grad_accum
                loss = torch.zeros((), dtype=torch.float32,
                                   device=model.device)
                for i in range(grad_accum):
                    micro, _ = model.loss({k: v[i * n:(i + 1) * n]
                                           for k, v in batch.items()})
                    micro.backward()
                    loss = loss + micro.detach()
                loss = loss / grad_accum
        grads = {name: p.grad if p.grad is None or grad_accum == 1
                 else p.grad.float() / grad_accum
                 for name, p in params.items()}
        for p in params.values():
            p.grad = None
        om = adamw_update(params, grads, state["opt"], opt_cfg)
        return state, {"loss": loss.detach(), **om}

    return train_step


def init_state(model) -> dict:
    """The training state of `model`: the model itself and zero AdamW
    state on its device.  Build the model with ``param_dtype="float32"``
    for the reference's float32 master weights."""
    return {"model": model,
            "opt": init_opt_state(dict(model.named_parameters()))}


def abstract_state(model) -> dict:
    """Names, shapes and dtypes of `model`'s training state, as tensors on
    the ``meta`` device in the state's layout: what
    ``checkpoint.restore_checkpoint`` reads a checkpoint against."""
    def meta(p, dtype):
        return torch.empty(p.shape, dtype=dtype, device="meta")
    params = dict(model.named_parameters())
    return {"model": {n: meta(p, p.dtype) for n, p in params.items()},
            "opt": {"m": {n: meta(p, torch.float32)
                          for n, p in params.items()},
                    "v": {n: meta(p, torch.float32)
                          for n, p in params.items()},
                    "step": torch.empty((), dtype=torch.int32,
                                        device="meta")}}
