"""KV-cache utilities (port of ``repro/serve/kvcache.py``): pad prefill
caches to serving length, and the greedy decode loop."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.aligner import resolve_device


def pad_cache(cache, to_len: int):
    """Pad the sequence axis (axis 2) of the rank-5 leaves under a ``kv``
    key up to `to_len`; every other leaf as it is."""
    def one(x, under_kv):
        if isinstance(x, dict):
            return {k: one(v, under_kv or k == "kv") for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(one(v, under_kv) for v in x)
        if under_kv and x.ndim == 5 and to_len > x.shape[2]:
            return F.pad(x, (0, 0, 0, 0, 0, to_len - x.shape[2]))
        return x
    with torch.inference_mode():
        return one(cache, False)


@torch.inference_mode()
def greedy_generate(model, tokens, n_new: int, max_len: int):
    """Prefill + `n_new` greedy decode steps on the model's device (which
    ``resolve_device`` checks: a model on CUDA where there is none raises,
    never moving to the CPU).  tokens: (B, S0), a tensor or an array.
    Each step takes the first maximum over the ``[:vocab]`` columns of the
    padded vocabulary, as ``jnp.argmax`` does.  Returns (B, n_new)."""
    dev = resolve_device(model.device)
    if model.cfg.n_codebooks:
        raise ValueError(
            f"{model.cfg.name}: greedy_generate feeds token ids back; an "
            f"audio model's logits are per codebook (the reference's loop "
            f"fails on them too)")
    tokens = torch.as_tensor(tokens, device=dev)
    B, S0 = tokens.shape
    vocab = model.cfg.vocab
    logits, cache = model.prefill({"tokens": tokens})
    cache = pad_cache(cache, max_len)
    out = []
    tok = logits[:, -1, :vocab].argmax(dim=-1)[:, None]
    for i in range(n_new):
        out.append(tok)
        logits, cache = model.decode_step(
            {"tokens": tok.to(torch.int32), "cache_pos": S0 + i}, cache)
        tok = logits[:, -1, :vocab].argmax(dim=-1)[:, None]
    return torch.cat(out, dim=1)
