"""Unified decoder LM (port of ``repro/models/transformer.py``) covering
the dense / MoE / VLM / audio architectures (llama3.2, granite3, gemma2,
qwen2.5, qwen3-moe, olmoe, qwen2-vl, musicgen); ``zamba2.py`` and
``xlstm_lm.py`` build on it.

The reference's ``lax.scan`` over stacked ``(L, ...)`` parameters is a
Python loop over an ``nn.ModuleList`` here; gemma2's local/global
alternation is a per-layer flag.  The KV cache keeps the reference's
layout, ``{"kv": {"k", "v"}}`` stacked over layers as
``(L, B, Sc, KV, Dh)``, so the caches compare leaf for leaf.  A decode
step writes its rows into the cache it is given, in place, and returns
that cache (the reference returns an updated copy).

Training (``loss``) runs the train-mode forward with grad enabled; with
``cfg.remat`` each layer runs under ``torch.utils.checkpoint`` (the
reference's ``jax.checkpoint(body)``): its activations are recomputed in
the backward pass instead of kept.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .attention import Attention, attn_block
from .common import (DTYPES, Init, ParamModule, act_fn, compute_dtype,
                     make_param, rms_norm, scalar, softcap)
from .moe import MoE, moe_ffn


class MLP(ParamModule):
    """wg / wu (D, F), wd (F, D)."""

    def __init__(self, cfg, init: Init):
        super().__init__()
        D, F = cfg.d_model, cfg.d_ff
        self.declare(init, "wg", (D, F))
        self.declare(init, "wu", (D, F))
        self.declare(init, "wd", (F, D))


def mlp_ffn(p, x, cfg):
    act = act_fn(cfg.act)
    h = act(torch.einsum("bsd,df->bsf", x, p["wg"])) * \
        torch.einsum("bsd,df->bsf", x, p["wu"])
    return torch.einsum("bsf,fd->bsd", h, p["wd"])


class Block(ParamModule):
    """One decoder layer: ln1, attention, (ln1b), ln2, MLP or MoE,
    (ln2b)."""

    def __init__(self, cfg, init: Init):
        super().__init__()
        D = cfg.d_model
        self.declare(init, "ln1", (D,), "zeros")
        self.declare(init, "ln2", (D,), "zeros")
        self.attn = Attention(cfg, init)
        if cfg.post_block_norm:
            self.declare(init, "ln1b", (D,), "zeros")
            self.declare(init, "ln2b", (D,), "zeros")
        if cfg.n_experts:
            self.moe = MoE(cfg, init)
        else:
            self.mlp = MLP(cfg, init)


def batch_dim(batch):
    for k in ("tokens", "embeds"):
        if k in batch:
            return batch[k].shape[0]
    raise KeyError("batch has neither tokens nor embeds")


class TransformerLM(ParamModule):
    """Dense / MoE / VLM / audio decoder.  ``model(batch, mode, cache)``
    returns ``(logits, aux, new_cache)`` as the reference's
    ``forward(params, batch, mode, cache)`` does; `batch` holds the
    reference's keys (``tokens`` or ``embeds``, optional ``positions``,
    ``cache_pos`` in decode), as tensors or numpy arrays.  Its own
    weights are read as ``self["head"]`` (cast to the compute dtype); the
    embedding lookup casts the rows it takes."""

    def __init__(self, cfg, init: Init):
        super().__init__()
        self.cfg = cfg
        self.build(init)

    def build(self, init: Init) -> None:
        cfg = self.cfg
        D, V = cfg.d_model, cfg.vocab_padded
        self.embed = make_param(init, (V, D), scale=0.02)
        self.layers = nn.ModuleList(Block(cfg, init)
                                    for _ in range(cfg.n_layers))
        self.final_norm = make_param(init, (D,), "zeros")
        if cfg.n_codebooks:
            self.head = make_param(init, (cfg.n_codebooks, D, V))
        elif not cfg.tie_embeddings:
            self.head = make_param(init, (D, V))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def compute_dtype(self) -> torch.dtype:
        return compute_dtype(self.cfg)

    # ----------------------------------------------------------- forward --
    def _is_global(self):
        cfg = self.cfg
        if cfg.local_global_every:
            return (np.arange(cfg.n_layers) % 2 == 1).astype(np.int32)
        return np.zeros(cfg.n_layers, np.int32)

    def _batch(self, batch):
        """`batch` with numpy arrays moved to the model's device."""
        return {k: torch.as_tensor(v, device=self.device)
                if isinstance(v, np.ndarray) else v
                for k, v in batch.items()}

    def _embed(self, batch):
        cfg = self.cfg
        if "embeds" in batch:                       # stub modality frontends
            x = batch["embeds"]
        else:
            # the rows, then the cast: the values of the reference's cast
            # table, and a repeated token's gradient sums in the weight's
            # dtype (float32 masters), not in bfloat16
            x = self.embed[batch["tokens"].long()]
        x = x.to(self.compute_dtype)
        if cfg.scale_embed:
            x = x * scalar(math.sqrt(cfg.d_model), x.dtype)
        return x * scalar(cfg.embedding_multiplier, x.dtype)

    def _positions(self, batch, S, cache_pos=None):
        dev = self.device
        if "positions" in batch:
            return batch["positions"]
        if cache_pos is not None:
            return int(cache_pos) + torch.arange(
                S, dtype=torch.int32, device=dev)[None, :]
        return torch.arange(S, dtype=torch.int32, device=dev).expand(
            batch_dim(batch), S)

    def _block(self, p, x, positions, pos_1d, is_global, cfg, cache,
               cache_pos):
        h = rms_norm(x, p["ln1"], cfg.rms_eps)
        a, cache_out = attn_block(p["attn"], h, positions, pos_1d, cfg,
                                  is_global, cache, cache_pos)
        if cfg.post_block_norm:
            a = rms_norm(a, p["ln1b"], cfg.rms_eps)
        res = scalar(cfg.residual_multiplier, x.dtype)
        x = x + a * res
        h = rms_norm(x, p["ln2"], cfg.rms_eps)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if cfg.n_experts:
            f, aux = moe_ffn(p["moe"], h, cfg)
        else:
            f = mlp_ffn(p["mlp"], h, cfg)
        if cfg.post_block_norm:
            f = rms_norm(f, p["ln2b"], cfg.rms_eps)
        x = x + f * res
        return x, aux, cache_out

    def _remat(self, mode: str) -> bool:
        """Whether the layers run under ``checkpoint``: ``cfg.remat`` in a
        train-mode forward that autograd records."""
        return self.cfg.remat and mode == "train" and torch.is_grad_enabled()

    def forward(self, batch, mode="train", cache=None):
        """mode: train | prefill | decode.  Returns (logits, aux,
        new_cache).  Prefill and decode run under ``inference_mode``."""
        if mode == "train":
            return self._forward(batch, mode, cache)
        with torch.inference_mode():
            return self._forward(batch, mode, cache)

    def _forward(self, batch, mode, cache):
        cfg = self.cfg
        batch = self._batch(batch)
        x = self._embed(batch)
        B, S, D = x.shape
        cache_pos = batch.get("cache_pos") if mode == "decode" else None
        positions = self._positions(batch, S, cache_pos)
        pos_1d = positions[0] if positions.ndim == 2 else positions[0, 0]
        is_global = self._is_global()

        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        caches = []

        def train_body(p, x, ig):
            return self._block(p, x, positions, pos_1d, ig, cfg, None,
                               None)[:2]

        for i, p in enumerate(self.layers):
            if self._remat(mode):
                x, aux_l = checkpoint(train_body, p, x, int(is_global[i]),
                                      use_reentrant=False)
                aux = aux + aux_l
                continue
            layer_cache = None
            if mode == "decode":
                layer_cache = {"k": cache["kv"]["k"][i],
                               "v": cache["kv"]["v"][i]}
            x, aux_l, cache_out = self._block(
                p, x, positions, pos_1d, int(is_global[i]), cfg,
                layer_cache, cache_pos)
            aux = aux + aux_l
            caches.append(cache_out)

        x = rms_norm(x, self["final_norm"], cfg.rms_eps)
        if cfg.n_codebooks:
            logits = torch.einsum("bsd,cdv->bscv", x, self["head"])
        elif cfg.tie_embeddings:
            logits = torch.einsum("bsd,vd->bsv", x, self["embed"])
        else:
            logits = torch.einsum("bsd,dv->bsv", x, self["head"])
        logits = softcap(logits / scalar(cfg.logits_scaling, logits.dtype),
                         cfg.final_softcap)
        new_cache = None
        if mode == "prefill":
            new_cache = {"kv": {n: torch.stack([c[n] for c in caches])
                                for n in ("k", "v")}}
        elif mode == "decode":
            new_cache = cache
        return logits, aux, new_cache

    # ------------------------------------------------------------- steps --
    def loss(self, batch):
        """``(loss, {"ce": ce})`` as the reference's ``loss(params,
        batch)``: float32 logits with the columns past ``cfg.vocab``
        masked to -1e30, the mean of ``logsumexp - true logit`` over
        every label (audio: (B, S, n_codebooks)), plus ``router_aux_coef
        * aux / n_layers``.  The true logit is a ``gather`` (the
        reference's one-hot einsum, there for vocab sharding, gives the
        same value and would cost a float32 (B, S, V) one-hot).  Runs in
        the caller's grad mode."""
        cfg = self.cfg
        batch = self._batch(batch)
        logits, aux, _ = self.forward(batch, mode="train")
        lg = logits.float()
        if cfg.vocab_padded != cfg.vocab:
            pad = torch.arange(cfg.vocab_padded, device=lg.device) >= cfg.vocab
            lg = lg.masked_fill(pad, -1e30)
        lse = torch.logsumexp(lg, dim=-1)
        labels = batch["labels"].long()
        true_logit = lg.gather(-1, labels[..., None])[..., 0]
        ce = (lse - true_logit).mean()
        return ce + cfg.router_aux_coef * aux / cfg.n_layers, {"ce": ce}

    def prefill(self, batch):
        logits, _, cache = self.forward(batch, mode="prefill")
        return logits[:, -1:], cache

    def decode_step(self, batch, cache):
        """batch: tokens (B,1) (or embeds), cache_pos an int (or a 0-d
        tensor).  Writes the step into `cache` and returns it."""
        logits, _, cache = self.forward(batch, mode="decode", cache=cache)
        return logits, cache

    def init_cache(self, batch_size: int, max_len: int,
                   dtype=torch.bfloat16):
        cfg = self.cfg
        L, KV, Dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
        shape = (L, batch_size, max_len, KV, Dh)
        dtype = DTYPES.get(dtype, dtype)
        return {"kv": {n: torch.zeros(shape, dtype=dtype, device=self.device)
                       for n in ("k", "v")}}
