"""Architecture registry (port of ``repro/models/registry.py``):
``--arch <id>`` -> config, model and the abstract inputs of a shape cell
(``input_specs``, tensors on the ``meta`` device, for
``launch/dryrun.py``)."""
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


def _dtype_name(dtype, what: str) -> str:
    names = {v: k for k, v in DTYPES.items()}
    if names.get(dtype, dtype) not in DTYPES:
        raise ValueError(f"{what}={dtype!r}: the models run in "
                         f"{sorted(DTYPES)}")
    return names.get(dtype, dtype)


def get_model(arch_or_cfg, device="cuda", dtype=None, generator=None,
              param_dtype=None):
    """The model of an arch id or a ``ModelConfig``, its parameters drawn
    from `generator` (default: a generator on the model's device seeded
    with 0) and built on ``resolve_device(device)``: the card unless the
    caller asks for the CPU, a RuntimeError where there is no CUDA.
    `dtype` ('float32' / 'bfloat16' or the torch dtype) replaces
    ``cfg.dtype``, the compute dtype.  `param_dtype` is the dtype the
    weights are held in, by default the compute dtype; training holds
    them in float32 (the reference's ``init_state(..., dtype=float32)``)
    and every read casts them to the compute dtype.  On ``device="meta"``
    (a dry run) the parameters hold shapes and dtypes only: nothing is
    allocated or drawn."""
    cfg = get_config(arch_or_cfg) if isinstance(arch_or_cfg, str) \
        else arch_or_cfg
    dev = torch.device(device)
    if dev.type != "meta":
        dev = resolve_device(dev)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=_dtype_name(dtype, "dtype"))
    held = DTYPES[_dtype_name(param_dtype or cfg.dtype, "param_dtype")]
    if generator is None and dev.type != "meta":
        generator = torch.Generator(device=dev).manual_seed(0)
    cls = {"hybrid": Zamba2LM, "ssm": XLSTMLM}.get(cfg.family, TransformerLM)
    init = Init(device=dev, dtype=held, generator=generator,
                compute_dtype=DTYPES[cfg.dtype])
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


def input_specs(cfg: ModelConfig, shape: str, *, tiny: bool = False):
    """Stand-ins on the ``meta`` device (shapes and dtypes, no memory) for
    every model input of the shape cell, as the reference's
    ``input_specs``: ``{"batch": ...}``, and for decode also ``"cache"``
    (``abstract_cache`` of the global batch at the cell's length).  A
    decode batch's ``cache_pos`` is a 0-d int32 tensor; `tiny` cuts the
    cell to 8 x 128."""
    S, GB, kind = SHAPES[shape]
    if tiny:
        S, GB = 128, 8
    batch = batch_specs(cfg, S, GB, kind)
    if kind != "decode":
        return {"batch": batch}
    model = get_model(cfg, device="meta")
    return {"batch": batch, "cache": model.abstract_cache(GB, S)}


def batch_specs(cfg: ModelConfig, S: int, GB: int, kind: str) -> dict:
    """``input_specs``'s batch for `GB` rows of `S` tokens of a `kind`
    (train / prefill / decode) step."""
    i32, bf16 = torch.int32, torch.bfloat16

    def meta(*shape_, dtype=i32):
        return torch.empty(shape_, dtype=dtype, device="meta")
    rows = 1 if kind == "decode" else S
    if cfg.family == "audio":
        batch = {"embeds": meta(GB, rows, cfg.d_model, dtype=bf16)}
        if kind == "train":
            batch["labels"] = meta(GB, S, cfg.n_codebooks)
    else:
        batch = {"tokens": meta(GB, rows)}
        if kind == "train":
            batch["labels"] = meta(GB, S)
    if cfg.family == "vlm":
        batch["positions"] = meta(3, GB, rows)
    if kind == "decode":
        batch["cache_pos"] = meta()
    return batch
