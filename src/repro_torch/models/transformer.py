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
from torch.utils import _pytree
from torch.utils.checkpoint import checkpoint

from ..distributed import model_parallel
from .attention import Attention, attn_block
from .common import (DTYPES, Init, ParamModule, act_fn, as_compute,
                     compute_dtype, make_param, partition_specs, rms_norm,
                     scalar, softcap)
from .moe import MoE, moe_ffn


def _vocab_parallel_ce(split, lg, labels):
    """``(logsumexp, true logit)`` over the whole vocabulary from this
    rank's block of float32 logits `lg` (``_vocab_split``'s `split`)."""
    import torch.distributed as dist
    mp, first, rows = split
    mx = mp.all_reduce(lg.detach().amax(dim=-1), "model",
                       op=dist.ReduceOp.MAX,
                       kind="model_all_reduce")
    se = mp.reduce_from_model(torch.exp(lg - mx[..., None]).sum(dim=-1))
    idx = labels - first
    mine = (idx >= 0) & (idx < rows)
    true = lg.gather(-1, idx.clamp(0, rows - 1)[..., None])[..., 0]
    true = mp.reduce_from_model(torch.where(mine, true, 0.0))
    return torch.log(se) + mx, true


class MLP(ParamModule):
    """wg / wu (D, F), wd (F, D)."""

    def __init__(self, cfg, init: Init):
        super().__init__()
        D, F = cfg.d_model, cfg.d_ff
        self.declare(init, "wg", (D, F), spec=("data", "model"))
        self.declare(init, "wu", (D, F), spec=("data", "model"))
        self.declare(init, "wd", (F, D), spec=("model", "data"))


def mlp_ffn(p, x, cfg):
    """On a model sharded over ``model`` with the hidden columns split
    (``model_parallel.split``) each rank computes its F/M columns of wg /
    wu and its row block of wd, then one ``reduce_from_model``."""
    mp = model_parallel.split(p)
    if mp is not None and not all(p.model_split(n, d) for n, d in (
            ("wg", 1), ("wu", 1), ("wd", 0))):
        mp.record_path("mlp", "gathered")
        mp = None
    read = p.__getitem__
    if mp is not None:
        mp.record_path("mlp", f"split, {cfg.d_ff // mp.size['model']} of "
                              f"{cfg.d_ff} columns")
        x, read = mp.copy_to_model(x), p.local
    act = act_fn(cfg.act)
    h = act(torch.einsum("bsd,df->bsf", x, read("wg"))) * \
        torch.einsum("bsd,df->bsf", x, read("wu"))
    y = torch.einsum("bsf,fd->bsd", h, read("wd"))
    return y if mp is None else mp.reduce_from_model(y)


class Block(ParamModule):
    """One decoder layer: ln1, attention, (ln1b), ln2, MLP or MoE,
    (ln2b)."""

    def __init__(self, cfg, init: Init):
        super().__init__()
        D = cfg.d_model
        self.declare(init, "ln1", (D,), "zeros", spec=(None,))
        self.declare(init, "ln2", (D,), "zeros", spec=(None,))
        self.attn = Attention(cfg, init)
        if cfg.post_block_norm:
            self.declare(init, "ln1b", (D,), "zeros", spec=(None,))
            self.declare(init, "ln2b", (D,), "zeros", spec=(None,))
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
        self.register("embed", make_param(init, (V, D), scale=0.02),
                      ("model", "data"))
        self.layers = nn.ModuleList(Block(cfg, init)
                                    for _ in range(cfg.n_layers))
        self.register("final_norm", make_param(init, (D,), "zeros"),
                      (None,))
        if cfg.n_codebooks:
            self.register("head", make_param(init, (cfg.n_codebooks, D, V)),
                          (None, "data", "model"))
        elif not cfg.tie_embeddings:
            self.register("head", make_param(init, (D, V)),
                          ("data", "model"))

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
        elif self._vocab_split() is not None:
            x = self._embed_split(batch["tokens"].long())
        else:
            # the rows, then the cast: the values of the reference's cast
            # table, and a repeated token's gradient sums in the weight's
            # dtype (float32 masters), not in bfloat16
            x = self._embed_read(local=False)[batch["tokens"].long()]
        x = x.to(self.compute_dtype)
        if cfg.scale_embed:
            x = x * scalar(math.sqrt(cfg.d_model), x.dtype)
        return x * scalar(cfg.embedding_multiplier, x.dtype)

    def _vocab_split(self):
        """``(ModelParallel, first row, rows)`` of this rank's vocabulary
        block where the model computes split over ``model`` and the
        vocabulary dimension of the embedding (and of the head) is split
        over it; else None."""
        mp = model_parallel.split(self)
        head = ("head", 2 if self.cfg.n_codebooks else 1) \
            if "head" in self._parameters else None
        if mp is None or not self.model_split("embed", 0) or (
                head and not self.model_split(*head)):
            if mp is not None:
                mp.record_path("vocabulary", "gathered")
            return None
        rows = self.cfg.vocab_padded // mp.size["model"]
        return mp, mp.coord["model"] * rows, rows

    def _embed_split(self, tokens):
        """The vocabulary-parallel lookup: each rank takes the rows of its
        block (float32), zeros for the tokens outside it, and
        ``reduce_from_model`` sums the one row each token has."""
        mp, first, rows = self._vocab_split()
        mp.record_path("embedding", f"split, {rows} of "
                                    f"{self.cfg.vocab_padded} rows")
        idx = tokens - first
        mine = (idx >= 0) & (idx < rows)
        w = self._embed_read(local=True)
        x = torch.where(mine[..., None], w[idx.clamp(0, rows - 1)], 0.0)
        return mp.reduce_from_model(x)

    def _embed_read(self, local: bool):
        """The embedding in the dtype it is held in, as ``weight`` (or
        ``local_weight``) reads it, read once a forward: a tied model's
        lookup and head share one gather (and, backward, one
        reduce-scatter) on a sharded model."""
        memo = self.__dict__.get("_embed_reads")
        if memo is None or local not in memo:
            w = self.local_weight("embed") if local else self.weight("embed")
            if memo is None:
                return w
            memo[local] = w
        return memo[local]

    def _logits(self, x, vocab_local: bool = False):
        """The head (or the tied embedding) on the final hidden `x`, with
        ``logits_scaling`` and ``final_softcap``.  Split over ``model``
        (``_vocab_split``) each rank computes its vocabulary block's
        logits: returned as they are with `vocab_local` (``loss``'s
        vocabulary-parallel cross-entropy), else gathered."""
        cfg = self.cfg
        split = self._vocab_split()
        read = self.__getitem__
        if split is not None:
            split[0].record_path("head", f"split, {split[2]} of "
                                         f"{cfg.vocab_padded} columns")
            x, read = split[0].copy_to_model(x), self.local
        if cfg.n_codebooks:
            logits = torch.einsum("bsd,cdv->bscv", x, read("head"))
        elif cfg.tie_embeddings:
            w = as_compute(self._embed_read(local=split is not None),
                           self.compute_dtype)
            logits = torch.einsum("bsd,vd->bsv", x, w)
        else:
            logits = torch.einsum("bsd,dv->bsv", x, read("head"))
        logits = softcap(logits / scalar(cfg.logits_scaling, logits.dtype),
                         cfg.final_softcap)
        if split is not None and not vocab_local:
            logits = split[0].gather_from_model(logits, logits.ndim - 1)
        return logits

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

    def forward(self, batch, mode="train", cache=None,
                vocab_local: bool = False):
        """mode: train | prefill | decode.  Returns (logits, aux,
        new_cache).  Prefill and decode run under ``inference_mode``.
        `vocab_local`: see ``_logits``."""
        self.__dict__["_embed_reads"] = {}
        try:
            if mode == "train":
                return self._forward(batch, mode, cache, vocab_local)
            with torch.inference_mode():
                return self._forward(batch, mode, cache)
        finally:
            del self.__dict__["_embed_reads"]

    def _forward(self, batch, mode, cache, vocab_local=False):
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
        logits = self._logits(x, vocab_local)
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
        the caller's grad mode.

        Split over ``model`` (``_vocab_split``) the cross-entropy is
        vocabulary-parallel: each rank holds its block's float32 logits
        only ((B, S, V/M): at Llama-3.2-1B's 128,256 columns, 4 x 256
        tokens, 263 MB a rank at M = 2 against 525 MB gathered), the max
        and the sum of exponentials are all-reduced over ``model``, and
        the true logit comes from the one rank whose block holds it."""
        cfg = self.cfg
        batch = self._batch(batch)
        logits, aux, _ = self.forward(batch, mode="train", vocab_local=True)
        split = self._vocab_split()
        lg = logits.float()
        first, cols = (0, cfg.vocab_padded) if split is None else split[1:]
        if cfg.vocab_padded != cfg.vocab:
            pad = torch.arange(first, first + cols,
                               device=lg.device) >= cfg.vocab
            lg = lg.masked_fill(pad, -1e30)
        labels = batch["labels"].long()
        if split is None:
            lse = torch.logsumexp(lg, dim=-1)
            true_logit = lg.gather(-1, labels[..., None])[..., 0]
        else:
            lse, true_logit = _vocab_parallel_ce(split, lg, labels)
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

    def partition_specs(self) -> dict:
        """``{parameter name: logical spec}`` for every parameter: the
        reference's ``partition_specs()``, keyed by ``named_parameters()``
        (a stacked layer's spec without its leading layer axis)."""
        return partition_specs(self)

    def init_cache(self, batch_size: int, max_len: int,
                   dtype=torch.bfloat16):
        """Zeros in ``abstract_cache``'s layout on the model's device."""
        return _pytree.tree_map(
            lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                  device=self.device),
            self.abstract_cache(batch_size, max_len, dtype))

    def abstract_cache(self, batch_size: int, max_len: int,
                       dtype=torch.bfloat16):
        """The decode cache's layout as tensors on the ``meta`` device
        (shapes and dtypes, no memory): ``{"kv": {"k", "v"}}`` of
        ``(L, B, max_len, KV, Dh)``."""
        cfg = self.cfg
        L, KV, Dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
        shape = (L, batch_size, max_len, KV, Dh)
        dtype = DTYPES.get(dtype, dtype)
        return {"kv": {n: torch.empty(shape, dtype=dtype, device="meta")
                       for n in ("k", "v")}}
