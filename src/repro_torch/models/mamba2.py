"""Mamba-2 (SSD) block (port of ``repro/models/mamba2.py``):
chunked-parallel for training / prefill, recurrent for decode — the
sequence mixer of the zamba2 hybrid architecture.

Scalar-identity A per head (the SSD restriction).  The chunked algorithm
is the standard 4-part decomposition: intra-chunk (masked quadratic),
chunk states, inter-chunk recurrence (a loop over chunks), state readout.
``dt`` and ``A`` are float32; the scan carries its state in the inputs'
dtype, as the reference's does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import Init, ParamModule, rms_norm, silu


def ssd_chunked(xh, a_log, Bm, Cm, chunk: int, h0=None):
    """xh: (B, L, H, P) inputs (already dt-scaled); a_log: (B, L, H) log
    decay per step (<= 0); Bm/Cm: (B, L, N) shared across heads
    (n_groups = 1).  Returns (y (B,L,H,P), final_state (B,H,N,P))."""
    Bsz, L, H, P = xh.shape
    N = Bm.shape[-1]
    nc = L // chunk
    if nc * chunk != L:
        raise ValueError(f"sequence length {L} is not a multiple of "
                         f"chunk {chunk}")
    xc = xh.reshape(Bsz, nc, chunk, H, P)
    ac = a_log.reshape(Bsz, nc, chunk, H)
    Bc = Bm.reshape(Bsz, nc, chunk, N)
    Cc = Cm.reshape(Bsz, nc, chunk, N)

    la = torch.cumsum(ac, dim=2)                         # (B,nc,Q,H)
    # intra-chunk: scores_iq,jk = C_i.B_j * exp(la_i - la_j), j <= i
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)               # (B,nc,Q,Q)
    dec = la[:, :, :, None, :] - la[:, :, None, :, :]    # (B,nc,Q,Q,H)
    mask = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=xh.device).tril()
    dec = torch.where(mask[None, None, :, :, None], dec, -torch.inf)
    att = cb[..., None] * torch.exp(dec)                 # (B,nc,Q,Q,H)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", att.to(xh.dtype), xc)

    # chunk states: S_c = sum_j exp(la_end - la_j) B_j (x) x_j
    dec_end = torch.exp(la[:, :, -1:, :] - la)           # (B,nc,Q,H)
    Sc = torch.einsum("bcjn,bcjh,bcjhp->bchnp",
                Bc, dec_end.to(xh.dtype), xc)            # (B,nc,H,N,P)

    # inter-chunk recurrence: h_prior[c] is the state entering chunk c
    a_tot = torch.exp(la[:, :, -1, :]).to(xh.dtype)      # (B,nc,H)
    h = h0 if h0 is not None else torch.zeros(
        (Bsz, H, N, P), dtype=xh.dtype, device=xh.device)
    h_prior = []
    for c in range(nc):
        h_prior.append(h)
        h = h * a_tot[:, c, :, None, None] + Sc[:, c]
    h_prior = torch.stack(h_prior, dim=1)                # (B,nc,H,N,P)

    # inter contribution: y_i += C_i . (exp(la_i) * h_prior)
    y_inter = torch.einsum("bcin,bcih,bchnp->bcihp",
                     Cc, torch.exp(la).to(xh.dtype), h_prior)
    y = (y_intra + y_inter).reshape(Bsz, L, H, P)
    return y, h


class Mamba2Layer(ParamModule):
    """One zamba2 backbone layer: ln and the Mamba2 mixer's w_in, conv_w,
    dt_bias, A_log, D, norm_w, w_out."""

    def __init__(self, cfg, init: Init):
        super().__init__()
        D = cfg.d_model
        d_in = cfg.ssm_expand * D
        N, P = cfg.ssm_state, cfg.ssm_head_dim
        H = d_in // P
        conv_ch = d_in + 2 * N
        e_total = 2 * d_in + 2 * N + H
        self.declare(init, "ln", (D,), "zeros", spec=(None,))
        self.declare(init, "w_in", (D, e_total), spec=("data", "model"))
        self.declare(init, "conv_w", (cfg.ssm_conv, conv_ch), scale=0.5,
                     spec=(None, "model"))
        self.declare(init, "dt_bias", (H,), "zeros", spec=("model",))
        self.declare(init, "A_log", (H,), "zeros", spec=("model",))
        self.declare(init, "D", (H,), "ones", spec=("model",))
        self.declare(init, "norm_w", (d_in,), "zeros", spec=("model",))
        self.declare(init, "w_out", (d_in, D), spec=("model", "data"))


def causal_conv(hist, w, L: int):
    """The depthwise causal convolution over the last ``len(w)`` inputs:
    ``hist`` holds ``len(w) - 1`` earlier rows then the `L` new ones."""
    return sum(hist[:, i:i + L] * w[i] for i in range(w.shape[0]))


def mamba2_block(p, x, cfg, state=None, conv_state=None, chunk: int = 256):
    """Full Mamba2 mixer.  p keys: w_in, conv_w, dt_bias, A_log, D,
    norm_w, w_out.  x: (B, L, D).  If state/conv_state given -> recurrent
    decode.  Returns (y, (state, conv_state))."""
    B, L, D = x.shape
    d_in = cfg.ssm_expand * cfg.d_model
    P = cfg.ssm_head_dim
    H = d_in // P
    N = cfg.ssm_state
    dconv = cfg.ssm_conv
    zxbcdt = torch.einsum("bld,de->ble", x, p["w_in"])
    z, xc, Bm, Cm, dt = torch.split(zxbcdt, [d_in, d_in, N, N, H], dim=-1)

    conv_in = torch.cat([xc, Bm, Cm], dim=-1)           # (B,L,d_in+2N)
    if state is None:
        hist = F.pad(conv_in, (0, 0, dconv - 1, 0))
        new_conv_state = hist[:, L:L + dconv - 1]   # last dconv-1 inputs
    else:
        hist = torch.cat([conv_state, conv_in], dim=1)   # (B,dconv,•)
        new_conv_state = hist[:, L:]
    conv = silu(causal_conv(hist, p["conv_w"], L))
    xc, Bm, Cm = torch.split(conv, [d_in, N, N], dim=-1)

    dt = torch.logaddexp(dt.float() + p["dt_bias"],
                         torch.zeros((), device=x.device))  # softplus (B,L,H)
    A = -torch.exp(p["A_log"].float())                         # (H,)
    a_log = dt * A                                             # (B,L,H)
    xh = xc.reshape(B, L, H, P) * dt[..., None].to(x.dtype)

    xh_orig = xh
    if state is None:
        Lp = -(-L // chunk) * chunk
        if Lp != L:
            xh = F.pad(xh, (0, 0, 0, 0, 0, Lp - L))
            a_log = F.pad(a_log, (0, 0, 0, Lp - L))
            Bm = F.pad(Bm, (0, 0, 0, Lp - L))
            Cm = F.pad(Cm, (0, 0, 0, Lp - L))
        y, h_fin = ssd_chunked(xh, a_log, Bm, Cm, min(chunk, Lp))
        y = y[:, :L]
    else:
        # recurrent step(s): h = a*h + B (x) x ; y = C . h
        h = state
        ys = []
        for t in range(L):
            xt = xh[:, t]
            h = h * torch.exp(a_log[:, t])[..., None, None].to(xt.dtype) \
                + torch.einsum("bn,bhp->bhnp", Bm[:, t], xt)
            ys.append(torch.einsum("bn,bhnp->bhp", Cm[:, t], h))
        h_fin = h
        y = torch.stack(ys, dim=1)                             # (B,L,H,P)

    y = y + p["D"][None, None, :, None] * xh_orig
    y = y.reshape(B, L, d_in)
    y = rms_norm(y * silu(z), p["norm_w"], cfg.rms_eps)
    out = torch.einsum("ble,ed->bld", y, p["w_out"])
    return out, (h_fin, new_conv_state)
