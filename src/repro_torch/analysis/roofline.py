"""Roofline terms of one NVIDIA H100 SXM (port of
``repro/analysis/roofline.py``, whose constants are a TPU's).

Each constant names its source: NVIDIA's H100 SXM data sheet for the
HBM3, BF16 and NVLink rates; the Hopper architecture white paper for
the INT32 rate (132 SMs x 64 INT32 lanes x 1.98 GHz boost), the rate the
aligner's integer DP is held against (PERF.md section 6).  The rates
assume the card's full 700 W power limit.
"""
from __future__ import annotations

import torch
from torch.utils import _pytree

PEAK_FLOPS = 989e12        # dense BF16 tensor-core FLOP/s (data sheet)
HBM_BW = 3.35e12           # HBM3 bytes/s (data sheet)
NVLINK_BW = 450e9          # NVLink bytes/s a direction (data sheet: 900 GB/s)
INT32_OPS = 132 * 64 * 1.98e9   # INT32 lane-ops/s (white paper)

# model-FLOPs conventions: 6·N·D train, 2·N·D inference (per generated token)
TRAIN_FACTOR, INFER_FACTOR = 6, 2


def roofline_terms(flops_global: float, bytes_global: float,
                   coll_bytes_per_dev: float, chips: int) -> dict:
    """Compute, memory and collective seconds of a step on `chips` cards
    (BF16 FLOPs and HBM bytes over all cards, collective bytes a card
    over NVLink), the dominant term and its seconds as the bound."""
    compute_t = flops_global / (chips * PEAK_FLOPS)
    memory_t = bytes_global / (chips * HBM_BW)
    coll_t = coll_bytes_per_dev / NVLINK_BW
    terms = {"compute_s": compute_t, "memory_s": memory_t,
             "collective_s": coll_t}
    dom = max(terms, key=terms.get)
    terms["dominant"] = dom.replace("_s", "")
    terms["bound_s"] = terms[dom]
    return terms


def model_flops(n_active_params: float, tokens: float, train: bool) -> float:
    return (TRAIN_FACTOR if train else INFER_FACTOR) * n_active_params * tokens


def useful_fraction(model_fl: float, hlo_flops_global: float) -> float:
    return model_fl / hlo_flops_global if hlo_flops_global else 0.0


def count_params(params) -> int:
    """Elements of an ``nn.Module``'s parameters, or of every tensor in a
    tensor, list, tuple or dict of them (nested)."""
    if isinstance(params, torch.nn.Module):
        params = list(params.parameters())
    return sum(int(p.numel()) for p in _pytree.tree_leaves(params)
               if isinstance(p, torch.Tensor))
