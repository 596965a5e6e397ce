"""Shared layers (port of ``repro/models/common.py``): norms, rotary
embeddings (incl. M-RoPE), activations, and parameter declaration.

Dtypes follow the reference cast for cast: ``rms_norm`` works in float32
and casts back, RoPE's angles are float32 and its ``cos`` / ``sin`` are
cast to the activations' dtype before the product.  Where the reference
multiplies a ``bfloat16`` array by a Python float, JAX first rounds the
float to ``bfloat16`` (a weakly typed scalar takes the array's dtype);
PyTorch would multiply by the float32 value, so ``scalar`` rounds it
first.

Parameters are ``nn.Parameter``s of the module that uses them, read as
``p["name"]`` like the reference's dicts (``ParamModule``), declared with
the reference's initialisers (``normal * scale`` with a fan-in scale,
``zeros``, ``ones``), drawn in float32 from an explicit
``torch.Generator`` and held in the parameters' dtype (``Init.dtype``).
The reference keeps float32 weights and casts the tree to the compute
dtype on every call (``cast_tree``).  A read ``p["name"]`` does that
cast where the two dtypes differ (float32 master weights under bfloat16
compute, as training holds them), and autograd carries the gradient back
through it to the float32 weight; where they are equal (serving, and
every model built without ``param_dtype``) the read returns the weight
itself.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
from torch import nn

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def compute_dtype(cfg) -> torch.dtype:
    """The dtype of a model's activations and of its weights as the layers
    read them (``cfg.dtype``)."""
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def as_compute(t, dtype):
    """A weight as a layer reads it: cast to the compute `dtype` where it is
    held in another (the reference's ``cast_tree``), else the weight
    itself; anything that is not a tensor (a submodule) as it is."""
    if isinstance(t, torch.Tensor) and dtype is not None and t.dtype != dtype:
        return t.to(dtype)
    return t


@functools.lru_cache(maxsize=None)
def scalar(c: float, dtype: torch.dtype) -> float:
    """`c` rounded to `dtype`, as JAX rounds a Python scalar that meets an
    array of that dtype."""
    return float(torch.tensor(c, dtype=dtype))


def rms_norm(x, w, eps=1e-6):
    xf = x.float()
    v = xf.square().mean(dim=-1, keepdim=True)
    y = (xf * torch.rsqrt(v + eps)) * (1.0 + w.float())
    return y.to(x.dtype)


def sigmoid(x):
    """``jax.nn.sigmoid`` op for op, ``1 / (1 + exp(-x))``, each op
    rounded to x's dtype (``torch.sigmoid`` rounds once, which differs in
    ``bfloat16``)."""
    return 1.0 / (1.0 + torch.exp(-x))


def silu(x):
    """``jax.nn.silu``: ``x * sigmoid(x)``, with ``sigmoid`` above."""
    return x * sigmoid(x)


def gelu_tanh(x):
    """``jax.nn.gelu(approximate=True)`` op for op (the tanh form of
    ``F.gelu(approximate="tanh")``, with the reference's roundings)."""
    dt = x.dtype
    cdf = scalar(0.5, dt) * (scalar(1.0, dt) + torch.tanh(
        scalar(math.sqrt(2 / math.pi), dt)
        * (x + scalar(0.044715, dt) * (x * (x * x)))))
    return x * cdf


def act_fn(name):
    return {"silu": silu, "gelu": gelu_tanh}[name]


def softcap(x, cap: float):
    if not cap:
        return x
    c = scalar(cap, x.dtype)
    return torch.tanh(x / c) * c


def rope_freqs(head_dim: int, theta: float):
    """Inverse frequencies in float64 numpy, as the reference computes them
    (cast to float32 where they are used)."""
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(head_dim: int, theta: float, device: torch.device):
    """``rope_freqs`` as float32 on `device`, made once: a copy from the
    host on every call would stall each layer of a decode step (made
    outside inference mode, so a training forward may use it too)."""
    with torch.inference_mode(False):
        return torch.as_tensor(
            rope_freqs(head_dim, theta).astype(np.float32), device=device)


def apply_rope(x, positions, theta: float, sections=()):
    """x: (..., S, H, Dh); positions: (B, S) or (3, B, S) for M-RoPE.

    M-RoPE (Qwen2-VL): the Dh/2 rotary frequency slots are partitioned into
    `sections` (t, h, w) groups, each rotated by its own position stream.
    """
    dh = x.shape[-1]
    freqs = _rope_freqs_on(dh, theta, x.device)                  # (Dh/2,)
    if positions.ndim == 3 and sections:
        secs = list(sections)
        if sum(secs) != dh // 2:
            raise ValueError(f"mrope_sections {secs} must sum to "
                             f"head_dim/2 = {dh // 2}")
        parts = []
        start = 0
        for i, s in enumerate(secs):
            parts.append(positions[i].float()[..., None]
                         * freqs[start:start + s])
            start += s
        ang = torch.cat(parts, dim=-1)                           # (B, S, Dh/2)
    else:
        if positions.ndim == 3:
            positions = positions[0]
        ang = positions.float()[..., None] * freqs               # (B, S, Dh/2)
    cos = torch.cos(ang)[..., None, :].to(x.dtype)               # (B,S,1,Dh/2)
    sin = torch.sin(ang)[..., None, :].to(x.dtype)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# ---------------------------------------------------------------- params ----

@dataclasses.dataclass
class Init:
    """Where and how a model's parameters are made: the device and dtype
    they live in, the generator their normal draws come from (on its own
    device; the values are moved to `device`), and the compute dtype a
    read casts them to."""
    device: torch.device
    dtype: torch.dtype
    generator: torch.Generator
    compute_dtype: torch.dtype


def make_param(init: Init, shape, kind: str = "normal",
               scale: float | None = None) -> nn.Parameter:
    """One parameter as the reference's ``ParamSpec`` + ``init_param``
    declare it: ``zeros``, ``ones``, or a float32 standard normal times
    `scale` (default 1/sqrt(fan-in), the fan-in being the second-to-last
    dimension, or the only one), cast to the parameters' dtype.  On the
    ``meta`` device (a dry run's build) it holds the shape and dtype only
    and draws nothing."""
    shape = tuple(int(s) for s in shape)
    if init.device.type == "meta":        # shapes only: no values, no draw
        return nn.Parameter(torch.empty(shape, dtype=init.dtype,
                                        device="meta"))
    if kind == "zeros":
        t = torch.zeros(shape, dtype=init.dtype, device=init.device)
    elif kind == "ones":
        t = torch.ones(shape, dtype=init.dtype, device=init.device)
    else:
        if scale is None:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            scale = 1.0 / math.sqrt(fan_in)
        t = torch.randn(shape, generator=init.generator, dtype=torch.float32,
                        device=init.generator.device) * scale
        t = t.to(device=init.device, dtype=init.dtype)
    return nn.Parameter(t)


class ParamModule(nn.Module):
    """A module whose parameters are read by name, ``p["wq"]``, as the
    reference's functions read their parameter dicts (the functions of
    this package take either), each cast to ``compute_dtype``
    (``as_compute``); on a sharded model each read gathers the weight
    (``weight``) or takes its ``model`` block (``local``).  Every
    parameter carries the reference's logical spec (``ParamSpec.spec``,
    without the stacked layer axis), read back by ``partition_specs``."""

    compute_dtype = None

    def __getitem__(self, name):
        return as_compute(self.weight(name), self.compute_dtype)

    def weight(self, name):
        """Parameter (or submodule) `name` in the dtype it is held in: on
        a model sharded by ``distributed.model_parallel.shard_model`` a
        parameter's whole value, gathered from its blocks
        (differentiable: the gradient goes back to this rank's block)."""
        t = getattr(self, name)
        mp = self.__dict__.get("mp")
        if mp is not None and isinstance(t, nn.Parameter):
            return mp.full(t, self._mp_names[name])
        return t

    def local(self, name):
        """Parameter `name`'s block of the ``model`` axis, gathered over
        ``data`` and cast to ``compute_dtype``: what a layer split over
        ``model`` computes with (``model_parallel.split``)."""
        return as_compute(self.local_weight(name), self.compute_dtype)

    def local_weight(self, name):
        """``local`` in the dtype the parameter is held in."""
        return self.mp.local(getattr(self, name), self._mp_names[name])

    def model_split(self, name, dim: int) -> bool:
        """Whether dimension `dim` of parameter `name` is split over the
        ``model`` axis alone on this module's mesh."""
        mp = self.__dict__.get("mp")
        return mp is not None and mp.model_split(self._mp_names[name], dim)

    def declare(self, init: Init, name: str, shape, kind: str = "normal",
                scale: float | None = None, *, spec: tuple) -> None:
        self.compute_dtype = init.compute_dtype
        self.register(name, make_param(init, shape, kind, scale), spec)

    def register(self, name: str, param: nn.Parameter, spec: tuple) -> None:
        """Register `param` as `name` with its logical `spec`: per
        dimension a mesh-axis name, a tuple of names or None (ValueError
        for another number of entries)."""
        spec = tuple(spec)
        if len(spec) != param.ndim:
            raise ValueError(f"{name}: spec {spec} for a parameter of "
                             f"shape {tuple(param.shape)}")
        self.register_parameter(name, param)
        self.__dict__.setdefault("_specs", {})[name] = spec


def partition_specs(module: nn.Module) -> dict:
    """``{parameter name: spec}`` for every parameter of `module`, keyed
    as ``named_parameters()``; ValueError for a parameter declared
    without a spec."""
    specs = {}
    for prefix, sub in module.named_modules():
        for name, spec in sub.__dict__.get("_specs", {}).items():
            specs[f"{prefix}.{name}" if prefix else name] = spec
    missing = [n for n, _ in module.named_parameters() if n not in specs]
    if missing:
        raise ValueError(f"parameters without a spec: {missing[:8]}")
    return {n: specs[n] for n, _ in module.named_parameters()}
