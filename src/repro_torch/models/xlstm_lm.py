"""xLSTM LM (port of ``repro/models/xlstm_lm.py``): mLSTM blocks with an
sLSTM block every `slstm_every` layers (xLSTM[7:1]-style).  The layers
are heterogeneous, a tuple in the reference and a ``ModuleList`` here;
the cache is ``{"states": (per-layer state, ...)}``: an mLSTM layer's
(mixer state (B,H,Dh,Dh+1), conv state (B,3,Di)), an sLSTM layer's
(c, n, m, h)."""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .common import DTYPES, Init, make_param, rms_norm
from .transformer import TransformerLM
from .xlstm import MLSTMLayer, SLSTMLayer, mlstm_block, slstm_block


class XLSTMLM(TransformerLM):
    def _kinds(self):
        cfg = self.cfg
        e = cfg.slstm_every
        return ["slstm" if (e and (i % e) == e - 1) else "mlstm"
                for i in range(cfg.n_layers)]

    def build(self, init: Init) -> None:
        cfg = self.cfg
        D, V = cfg.d_model, cfg.vocab_padded
        self.embed = make_param(init, (V, D), scale=0.02)
        self.layers = nn.ModuleList(
            (MLSTMLayer if kind == "mlstm" else SLSTMLayer)(cfg, init)
            for kind in self._kinds())
        self.final_norm = make_param(init, (D,), "zeros")
        self.head = make_param(init, (D, V))

    def _forward(self, batch, mode, cache):
        cfg = self.cfg
        batch = self._batch(batch)
        x = self._embed(batch)
        new_states = []
        for i, (kind, p) in enumerate(zip(self._kinds(), self.layers)):
            st = cache["states"][i] if mode == "decode" else None
            h = rms_norm(x, p["ln"], cfg.rms_eps)
            fn = mlstm_block if kind == "mlstm" else slstm_block
            if self._remat(mode):           # the block alone, as the reference
                out, st_new = checkpoint(fn, p, h, cfg, None,
                                         use_reentrant=False)
            else:
                out, st_new = fn(p, h, cfg, st)
            x = x + out
            new_states.append(st_new)
        x = rms_norm(x, self["final_norm"], cfg.rms_eps)
        logits = torch.einsum("bsd,dv->bsv", x, self["head"])
        new_cache = None
        if mode in ("prefill", "decode"):
            new_cache = {"states": tuple(new_states)}
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return logits, aux, new_cache

    def init_cache(self, batch_size: int, max_len: int,
                   dtype=torch.bfloat16):
        cfg = self.cfg
        D = cfg.d_model
        Di, H = 2 * D, cfg.n_heads
        Dh, Dh_s = Di // H, D // H
        dtype = DTYPES.get(dtype, dtype)

        def zeros(*shape, dt=dtype):
            return torch.zeros(shape, dtype=dt, device=self.device)
        states = []
        for kind in self._kinds():
            if kind == "mlstm":
                states.append((zeros(batch_size, H, Dh, Dh + 1),
                               zeros(batch_size, 3, Di)))
            else:
                states.append(tuple(zeros(batch_size, H, Dh_s,
                                          dt=torch.float32)
                                    for _ in range(3))
                              + (zeros(batch_size, H, Dh_s),))
        return {"states": tuple(states)}
