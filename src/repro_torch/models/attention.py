"""Attention (port of ``repro/models/attention.py``): GQA with RoPE /
M-RoPE, query-chunked (bounded memory at long prefill), sliding-window or
global per layer, logit softcapping, and a decode path over a KV cache.

Plain PyTorch ops mirror the reference's ``jnp`` ones: masked scores are
``NEG = -1e30`` (not ``-inf``), the softcap comes before the mask, the
softmax runs in float32 and is cast back, and the heads of a KV group sit
in ``(KV, G)`` order.
"""
from __future__ import annotations

import torch

from ..distributed import model_parallel
from .common import Init, ParamModule, apply_rope, scalar, softcap

NEG = -1e30
NO_WINDOW = 1 << 30


def attention(q, k, v, q_pos, k_pos, *, window: int, cap: float,
              scale: float, q_chunk: int = 1024):
    """q: (B, Sq, H, Dh); k/v: (B, Sk, KV, Dh); q_pos (Sq,), k_pos (Sk,).
    `window` is an int (NO_WINDOW disables it).  Query-chunked exact
    softmax: above `q_chunk` queries the queries are padded to whole
    chunks (padding at position 0) and each chunk sees every key."""
    B, Sq, H, Dh = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, Dh)

    def chunk_fn(qc, qpos_c):
        s = torch.einsum("bqkgd,bskd->bkgqs", qc, k)
        s = softcap(s * scalar(scale, s.dtype), cap)
        keep = (k_pos[None, :] <= qpos_c[:, None]) & \
               (k_pos[None, :] > qpos_c[:, None] - window)
        s = torch.where(keep, s, scalar(NEG, s.dtype))
        p = torch.softmax(s.float(), dim=-1).to(q.dtype)
        return torch.einsum("bkgqs,bskd->bqkgd", p, v)

    if Sq <= q_chunk:
        out = chunk_fn(qg, q_pos)
    else:
        n_chunks = -(-Sq // q_chunk)
        pad = n_chunks * q_chunk - Sq
        qg_p = torch.nn.functional.pad(qg, (0, 0, 0, 0, 0, 0, 0, pad))
        qp_p = torch.nn.functional.pad(q_pos, (0, pad))
        out = torch.cat([
            chunk_fn(qg_p[:, c * q_chunk:(c + 1) * q_chunk],
                     qp_p[c * q_chunk:(c + 1) * q_chunk])
            for c in range(n_chunks)], dim=1)[:, :Sq]
    return out.reshape(B, Sq, H, Dh)


def _window_for_layer(cfg, layer_is_global) -> int:
    """Effective sliding window of a layer."""
    if cfg.local_global_every:
        return NO_WINDOW if layer_is_global else (cfg.sliding_window
                                                  or NO_WINDOW)
    return cfg.sliding_window or NO_WINDOW


def cache_start(cache_pos, S: int, Sc: int) -> int:
    """Where a decode step writes its `S` rows into a cache of `Sc`:
    ``cache_pos`` clamped to [0, Sc - S], as ``lax.dynamic_update_slice``
    clamps a start that would run past the cache (the rows then overwrite
    the cache's last `S`; the queries keep their unclamped positions)."""
    return min(max(int(cache_pos), 0), Sc - S)


class Attention(ParamModule):
    """wq / wk / wv (D, heads * Dh), wo (H * Dh, D) and, with
    ``qkv_bias``, bq / bk / bv."""

    def __init__(self, cfg, init: Init):
        super().__init__()
        D, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.declare(init, "wq", (D, H * Dh), spec=("data", "model"))
        self.declare(init, "wk", (D, KV * Dh), spec=("data", "model"))
        self.declare(init, "wv", (D, KV * Dh), spec=("data", "model"))
        self.declare(init, "wo", (H * Dh, D), spec=("model", "data"))
        if cfg.qkv_bias:
            self.declare(init, "bq", (H * Dh,), "zeros", spec=("model",))
            self.declare(init, "bk", (KV * Dh,), "zeros", spec=("model",))
            self.declare(init, "bv", (KV * Dh,), "zeros", spec=("model",))


def attn_block(p, x, positions, pos_1d, cfg, layer_is_global=0,
               cache=None, cache_pos=None):
    """positions: (B,S) or (3,B,S) rotary positions; pos_1d: (S,) mask
    positions (shared across batch).  cache: dict(k, v) of (B, Sc, KV, Dh)
    for decode, written in place at `cache_pos` (clamped, ``cache_start``)
    and returned; the reference returns an updated copy.  Returns
    (out, cache_out).

    On a model sharded over ``model`` (``model_parallel.split``) each
    rank computes its H/M query heads and KV/M KV heads from its column
    blocks of wq / wk / wv (and the biases) and its row block of wo,
    between ``copy_to_model`` and ``reduce_from_model``; where the heads
    do not divide (``_heads_split``) it computes every head on the
    gathered weights."""
    B, S, D = x.shape
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    mp = model_parallel.split(p) if cache is None else None
    if mp is not None and not _heads_split(p, cfg, mp):
        mp.record_path("attention", "gathered")
        mp = None
    read = p.local if mp is not None else p.__getitem__
    if mp is not None:              # this rank's H/M query and KV/M heads
        mp.record_path("attention", f"split, {H // mp.size['model']} of "
                                    f"{H} heads")
        H, KV = H // mp.size["model"], KV // mp.size["model"]
        x = mp.copy_to_model(x)
    q = torch.einsum("bsd,dh->bsh", x, read("wq")).reshape(B, S, H, Dh)
    k = torch.einsum("bsd,dh->bsh", x, read("wk")).reshape(B, S, KV, Dh)
    v = torch.einsum("bsd,dh->bsh", x, read("wv")).reshape(B, S, KV, Dh)
    if cfg.qkv_bias:
        q = q + read("bq").reshape(H, Dh)
        k = k + read("bk").reshape(KV, Dh)
        v = v + read("bv").reshape(KV, Dh)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    scale = cfg.attention_multiplier or (1.0 / (Dh ** 0.5))
    window = _window_for_layer(cfg, layer_is_global)

    if cache is None:
        out = attention(q, k, v, pos_1d, pos_1d, window=window,
                        cap=cfg.attn_softcap, scale=scale)
        cache_out = {"k": k, "v": v}
    else:
        ck, cv = cache["k"], cache["v"]
        Sc = ck.shape[1]
        start = cache_start(cache_pos, S, Sc)
        ck[:, start:start + S] = k
        cv[:, start:start + S] = v
        k_pos = torch.arange(Sc, dtype=torch.int32, device=x.device)
        q_pos = int(cache_pos) + torch.arange(S, dtype=torch.int32,
                                              device=x.device)
        out = attention(q, ck, cv, q_pos, k_pos, window=window,
                        cap=cfg.attn_softcap, scale=scale)
        cache_out = {"k": ck, "v": cv}

    y = torch.einsum("bsh,hd->bsd", out.reshape(B, S, H * Dh), read("wo"))
    if mp is not None:
        y = mp.reduce_from_model(y)
    return y, cache_out


def _heads_split(p, cfg, mp) -> bool:
    """Whether attention can run split over ``model``: whole query and KV
    heads a rank (H and KV divide by its size; contiguous blocks keep
    GQA's ``h // G`` pairing) and every weight split over ``model`` on
    its heads.  Else (a split that falls mid-head) the block runs on
    gathered weights."""
    M = mp.size["model"]
    names = [("wq", 1), ("wk", 1), ("wv", 1), ("wo", 0)]
    if cfg.qkv_bias:
        names += [("bq", 0), ("bk", 0), ("bv", 0)]
    return cfg.n_heads % M == 0 and cfg.n_kv_heads % M == 0 and \
        all(p.model_split(n, d) for n, d in names)
