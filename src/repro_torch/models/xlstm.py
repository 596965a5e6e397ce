"""xLSTM blocks (port of ``repro/models/xlstm.py``): mLSTM (matrix
memory, exponential gating) and sLSTM (scalar memory, recurrent only).

mLSTM is computed as chunked gated linear attention through
``ssd_chunked``: the normaliser n_t = f n_{t-1} + i k_t is carried exactly
by appending a constant-one channel to the value stream, and the output
is ``num / max(|den|, 1)``; input gates are clipped to +-10.  A decode
step runs the same chunked path on one step padded to a whole chunk, as
the reference does.  sLSTM has no parallel form and loops over time,
carrying ``c, n, m`` in float32 and ``h`` in the activations' dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import Init, ParamModule, rms_norm, scalar, sigmoid, silu
from .mamba2 import causal_conv, ssd_chunked

DCONV = 4


class MLSTMLayer(ParamModule):
    """ln, w_up (D, 2*Di), conv_w (4, Di), wq/wk/wv (Di, Di), w_i/w_f
    (Di, H), gn (Di,), w_down (Di, D); Di = 2*D."""

    def __init__(self, cfg, init: Init):
        super().__init__()
        D, H = cfg.d_model, cfg.n_heads
        Di = 2 * D
        self.declare(init, "ln", (D,), "zeros", spec=(None,))
        self.declare(init, "w_up", (D, 2 * Di), spec=("data", "model"))
        self.declare(init, "conv_w", (DCONV, Di), scale=0.5,
                     spec=(None, "model"))
        self.declare(init, "wq", (Di, Di), spec=("data", "model"))
        self.declare(init, "wk", (Di, Di), spec=("data", "model"))
        self.declare(init, "wv", (Di, Di), spec=("data", "model"))
        self.declare(init, "w_i", (Di, H), spec=("model", None))
        self.declare(init, "w_f", (Di, H), spec=("model", None))
        self.declare(init, "gn", (Di,), "zeros", spec=(None,))
        self.declare(init, "w_down", (Di, D), spec=("model", "data"))


class SLSTMLayer(ParamModule):
    """ln, w_gates (D, 4*D), r_gates (H, Dh, 4*Dh), gn (D,), w_down
    (D, D)."""

    def __init__(self, cfg, init: Init):
        super().__init__()
        D, H = cfg.d_model, cfg.n_heads
        Dh = D // H
        self.declare(init, "ln", (D,), "zeros", spec=(None,))
        self.declare(init, "w_gates", (D, 4 * D), spec=("data", "model"))
        self.declare(init, "r_gates", (H, Dh, 4 * Dh), spec=(None, None, None))
        self.declare(init, "gn", (D,), "zeros", spec=(None,))
        self.declare(init, "w_down", (D, D), spec=("data", "model"))


def mlstm_mixer(q, k, v, i_gate, f_gate, chunk: int = 256, state=None):
    """q,k,v: (B, L, H, Dh); i_gate/f_gate: (B, L, H) raw
    (pre-activation).  Returns (h (B,L,H,Dh), final_state
    (B,H,Dh,Dh+1))."""
    B, L, H, Dh = q.shape
    a_log = F.logsigmoid(f_gate.float())                        # log f_t
    ig = torch.clamp(i_gate.float(), -10.0, 10.0)
    k_eff = k * torch.exp(ig)[..., None].to(k.dtype)
    v_ext = torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)
    # per-head B/C streams -> run ssd per head by folding H into batch
    scale = scalar(1.0 / (Dh ** 0.5), q.dtype)
    xh = v_ext.permute(0, 2, 1, 3).reshape(B * H, L, 1, Dh + 1)
    al = a_log.permute(0, 2, 1).reshape(B * H, L, 1)
    Bm = k_eff.permute(0, 2, 1, 3).reshape(B * H, L, Dh)
    Cm = (q * scale).permute(0, 2, 1, 3).reshape(B * H, L, Dh)
    Lp = -(-L // chunk) * chunk
    if Lp != L:
        xh = F.pad(xh, (0, 0, 0, 0, 0, Lp - L))
        al = F.pad(al, (0, 0, 0, Lp - L))
        Bm = F.pad(Bm, (0, 0, 0, Lp - L))
        Cm = F.pad(Cm, (0, 0, 0, Lp - L))
    h0 = None
    if state is not None:
        h0 = state.reshape(B * H, 1, Dh, Dh + 1)
    y, hf = ssd_chunked(xh, al, Bm, Cm, min(chunk, Lp), h0=h0)
    y = y[:, :L, 0].reshape(B, H, L, Dh + 1).permute(0, 2, 1, 3)
    num, den = y[..., :Dh], y[..., Dh:]
    h = num / torch.clamp(den.abs(), min=1.0)
    return h, hf.reshape(B, H, Dh, Dh + 1)


def mlstm_block(p, x, cfg, state=None, chunk: int = 256):
    """x: (B, L, D).  state: (mixer_state (B,H,Dh,Dh+1), conv_state
    (B, 3, Di)) for decode.  Returns (out, (mixer_state, conv_state))."""
    B, L, D = x.shape
    Di = 2 * D
    H = cfg.n_heads
    Dh = Di // H
    u = torch.einsum("bld,de->ble", x, p["w_up"])
    xu, zg = u.chunk(2, dim=-1)                           # (B,L,Di) each
    mixer_state = conv_state = None
    if state is not None:
        mixer_state, conv_state = state
    if conv_state is None:
        hist = F.pad(xu, (0, 0, DCONV - 1, 0))
    else:
        hist = torch.cat([conv_state, xu], dim=1)
    conv = silu(causal_conv(hist, p["conv_w"], L))
    new_conv_state = hist[:, L:L + DCONV - 1]
    q = torch.einsum("ble,ef->blf", conv, p["wq"]).reshape(B, L, H, Dh)
    k = torch.einsum("ble,ef->blf", conv, p["wk"]).reshape(B, L, H, Dh)
    v = torch.einsum("ble,ef->blf", xu, p["wv"]).reshape(B, L, H, Dh)
    ig = torch.einsum("ble,eh->blh", conv, p["w_i"])
    fg = torch.einsum("ble,eh->blh", conv, p["w_f"]) + 3.0      # forget bias
    h, st = mlstm_mixer(q, k, v, ig, fg, chunk=chunk, state=mixer_state)
    h = rms_norm(h.reshape(B, L, Di), p["gn"], cfg.rms_eps)
    out = torch.einsum("ble,ed->bld", h * silu(zg), p["w_down"])
    return out, (st, new_conv_state)


def slstm_block(p, x, cfg, state=None):
    """sLSTM: scalar-memory recurrent cell with exponential gating, H
    heads.  state: (c, n, m, h_prev).  Returns (out, state)."""
    B, L, D = x.shape
    H = cfg.n_heads
    Dh = D // H
    pre = torch.einsum("bld,de->ble", x, p["w_gates"]).reshape(B, L, H, 4 * Dh)

    if state is None:
        z = torch.zeros((B, H, Dh), dtype=torch.float32, device=x.device)
        state = (z, z, z, torch.zeros((B, H, Dh), dtype=x.dtype,
                                      device=x.device))
    c, n, m, h_prev = state
    hs = []
    r_gates = p["r_gates"]
    for t in range(L):
        rec = torch.einsum("bhd,hde->bhe", h_prev, r_gates)
        it, ft, zt, ot = (pre[:, t] + rec).chunk(4, dim=-1)
        it, ft = it.float(), ft.float()
        log_f = F.logsigmoid(ft)
        i_c = torch.clamp(it, -10.0, 10.0)
        m_new = torch.maximum(log_f + m, i_c)
        i_s = torch.exp(i_c - m_new)
        f_s = torch.exp(log_f + m - m_new)
        c = f_s * c + i_s * torch.tanh(zt.float())
        n = f_s * n + i_s
        h_prev = (sigmoid(ot.float()) * c
                  / torch.clamp(n.abs(), min=1.0)).to(x.dtype)
        m = m_new
        hs.append(h_prev)
    h = torch.stack(hs, dim=1).reshape(B, L, D)
    h = rms_norm(h, p["gn"], cfg.rms_eps)
    out = torch.einsum("bld,de->ble", h, p["w_down"])
    return out, (c, n, m, h_prev)
