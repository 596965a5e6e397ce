"""Architecture registry (port of ``repro/models/registry.py``):
``--arch <id>`` -> config and model.  The reference's ``input_specs``
(abstract inputs for ``launch/dryrun.py``) waits for that module's port."""
from __future__ import annotations

import dataclasses
import importlib

import torch

from ..core.aligner import resolve_device
from .common import DTYPES, Init
from .config import SUBQUADRATIC_FAMILIES, ModelConfig
from .transformer import TransformerLM
from .xlstm_lm import XLSTMLM
from .zamba2 import Zamba2LM

ARCH_IDS = (
    "qwen3-moe-235b-a22b", "olmoe-1b-7b", "llama3.2-1b", "granite-3-2b",
    "gemma2-2b", "qwen2.5-14b", "qwen2-vl-2b", "zamba2-2.7b",
    "musicgen-medium", "xlstm-125m",
)

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}

# (seq_len, global_batch, kind)
SHAPES = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}


def get_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def get_model(arch_or_cfg, device="cuda", dtype=None, generator=None):
    """The model of an arch id or a ``ModelConfig``, its parameters drawn
    from `generator` (default: a generator on the model's device seeded
    with 0) and built on ``resolve_device(device)``: the card unless the
    caller asks for the CPU, a RuntimeError where there is no CUDA.
    `dtype` ('float32' / 'bfloat16' or the torch dtype) replaces
    ``cfg.dtype``: the weights and activations are held in it."""
    cfg = get_config(arch_or_cfg) if isinstance(arch_or_cfg, str) \
        else arch_or_cfg
    dev = resolve_device(device)
    if dtype is not None:
        names = {v: k for k, v in DTYPES.items()}
        if names.get(dtype, dtype) not in DTYPES:
            raise ValueError(f"dtype={dtype!r}: the models run in "
                             f"{sorted(DTYPES)}")
        cfg = dataclasses.replace(cfg, dtype=names.get(dtype, dtype))
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    cls = {"hybrid": Zamba2LM, "ssm": XLSTMLM}.get(cfg.family, TransformerLM)
    init = Init(device=dev, dtype=DTYPES[cfg.dtype], generator=generator)
    return cls(cfg, init)


def shape_applicable(cfg: ModelConfig, shape: str) -> bool:
    """long_500k needs sub-quadratic sequence mixing."""
    if shape == "long_500k":
        return cfg.family in SUBQUADRATIC_FAMILIES
    return True


def tiny_config(cfg: ModelConfig, n_layers=2) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    repl = dict(
        n_layers=n_layers, d_model=64, n_heads=4, d_head=16,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_ff=128 if cfg.d_ff else 0, vocab=256,
        sliding_window=min(cfg.sliding_window, 8) if cfg.sliding_window else 0,
        remat=False,
    )
    if cfg.n_experts:
        repl.update(n_experts=4, top_k=2)
    if cfg.family in ("hybrid",):
        repl.update(ssm_state=16, ssm_head_dim=16, shared_attn_every=2,
                    n_kv_heads=4)
    if cfg.family == "ssm":
        repl.update(slstm_every=2, n_layers=max(n_layers, 2))
    if cfg.mrope_sections:
        repl.update(mrope_sections=(2, 3, 3))
    if cfg.n_codebooks:
        repl.update(n_codebooks=2)
    return dataclasses.replace(cfg, **repl)
