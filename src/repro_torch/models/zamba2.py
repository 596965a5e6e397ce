"""Zamba2-style hybrid LM (port of ``repro/models/zamba2.py``): a Mamba2
backbone plus one *shared* attention block applied after every
`shared_attn_every`-th layer (the layers ``idx % every == every - 1``).
The shared block sees concat(hidden, original embedding) through the
fusion projection ``fuse``.

Its cache is ``{"kv": {"k", "v"} of (A, B, Sc, KV, Dh)`` (one slot an
application of the shared block), ``"ssm": (L, B, H, N, P)``,
``"conv": (L, B, ssm_conv - 1, conv_ch)}``.  In prefill the kv slots start
as zeros of length S and each application writes its own; a decode step
writes its rows into the kv slots in place and stacks fresh ssm / conv
states.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .attention import Attention, attn_block
from .common import DTYPES, Init, ParamModule, make_param, rms_norm
from .mamba2 import Mamba2Layer, mamba2_block
from .transformer import MLP, TransformerLM, mlp_ffn


class SharedBlock(ParamModule):
    """fuse (2D, D), ln1, ln2, attn, mlp: one unstacked parameter set."""

    def __init__(self, cfg, init: Init):
        super().__init__()
        D = cfg.d_model
        self.declare(init, "fuse", (2 * D, D), spec=("data", "model"))
        self.declare(init, "ln1", (D,), "zeros", spec=(None,))
        self.declare(init, "ln2", (D,), "zeros", spec=(None,))
        self.attn = Attention(cfg, init)
        self.mlp = MLP(cfg, init)


class Zamba2LM(TransformerLM):
    def build(self, init: Init) -> None:
        cfg = self.cfg
        D, V = cfg.d_model, cfg.vocab_padded
        self.register("embed", make_param(init, (V, D), scale=0.02),
                      ("model", "data"))
        self.layers = nn.ModuleList(Mamba2Layer(cfg, init)
                                    for _ in range(cfg.n_layers))
        self.shared = SharedBlock(cfg, init)
        self.register("final_norm", make_param(init, (D,), "zeros"),
                      (None,))
        self.register("head", make_param(init, (D, V)), ("data", "model"))

    @property
    def n_apps(self):
        return self.cfg.n_layers // self.cfg.shared_attn_every

    def _shared_block(self, p, x, x0, positions, pos_1d, cfg, cache,
                      cache_pos):
        h = torch.cat([x, x0], dim=-1)
        h = torch.einsum("bsd,df->bsf", h, p["fuse"].to(x.dtype))
        a, cache_out = attn_block(p["attn"],
                                  rms_norm(h, p["ln1"], cfg.rms_eps),
                                  positions, pos_1d, cfg, 0, cache, cache_pos)
        h = h + a
        h = h + mlp_ffn(p["mlp"], rms_norm(h, p["ln2"], cfg.rms_eps), cfg)
        return x + h, cache_out

    def _forward(self, batch, mode, cache, vocab_local=False):
        cfg = self.cfg
        batch = self._batch(batch)
        x = self._embed(batch)
        B, S, D = x.shape
        x0 = x
        cache_pos = batch.get("cache_pos") if mode == "decode" else None
        positions = self._positions(batch, S, cache_pos)
        pos_1d = positions[0] if positions.ndim == 2 else positions[0, 0]
        every = cfg.shared_attn_every

        if mode == "decode":
            kv_all = cache["kv"]            # {'k': (A,B,Sc,KV,Dh), 'v': ...}
        else:
            KV, Dh = cfg.n_kv_heads, cfg.head_dim
            kv_all = {n: torch.zeros((self.n_apps, B, S, KV, Dh),
                                     dtype=x.dtype, device=x.device)
                      for n in ("k", "v")}

        def train_body(idx, p, x):
            h = rms_norm(x, p["ln"], cfg.rms_eps)
            x = x + mamba2_block(p, h, cfg, None, None)[0]
            if idx % every == every - 1:
                x = self._shared_block(self.shared, x, x0, positions,
                                       pos_1d, cfg, None, None)[0]
            return x

        ssm, conv = [], []
        for idx, p in enumerate(self.layers):
            if self._remat(mode):
                x = checkpoint(train_body, idx, p, x, use_reentrant=False)
                continue
            ssm_st = conv_st = None
            if mode == "decode":
                ssm_st, conv_st = cache["ssm"][idx], cache["conv"][idx]
            h = rms_norm(x, p["ln"], cfg.rms_eps)
            m, (ssm_new, conv_new) = mamba2_block(p, h, cfg, ssm_st, conv_st)
            x = x + m
            if idx % every == every - 1:
                a_idx = idx // every
                lc = None
                if mode == "decode":
                    lc = {n: kv_all[n][a_idx] for n in ("k", "v")}
                x, cache_out = self._shared_block(
                    self.shared, x, x0, positions, pos_1d, cfg, lc,
                    cache_pos)
                if mode == "prefill":
                    for n in ("k", "v"):
                        kv_all[n][a_idx] = cache_out[n]
            ssm.append(ssm_new)
            conv.append(conv_new)

        x = rms_norm(x, self["final_norm"], cfg.rms_eps)
        logits = self._logits(x, vocab_local)
        new_cache = None
        if mode in ("prefill", "decode"):
            new_cache = {"kv": kv_all, "ssm": torch.stack(ssm),
                         "conv": torch.stack(conv)}
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return logits, aux, new_cache

    def abstract_cache(self, batch_size: int, max_len: int,
                       dtype=torch.bfloat16):
        cfg = self.cfg
        d_in = cfg.ssm_expand * cfg.d_model
        N, P = cfg.ssm_state, cfg.ssm_head_dim
        H = d_in // P
        conv_ch = d_in + 2 * N
        L, A = cfg.n_layers, self.n_apps
        KV, Dh = cfg.n_kv_heads, cfg.head_dim
        dtype = DTYPES.get(dtype, dtype)

        def meta(*shape):
            return torch.empty(shape, dtype=dtype, device="meta")
        return {
            "kv": {"k": meta(A, batch_size, max_len, KV, Dh),
                   "v": meta(A, batch_size, max_len, KV, Dh)},
            "ssm": meta(L, batch_size, H, N, P),
            "conv": meta(L, batch_size, cfg.ssm_conv - 1, conv_ch),
        }
