"""The LM scaffold's layers in the port (``repro_torch.models``) against
the reference's (``repro.models``), function against function: the same
seeded numpy inputs and parameters through both, in float32.

Tolerance: rtol = atol = 1e-5 on activations of order 1 (1e-4 where a
value is a sum over a 256-step chunk or a 64-wide expert tile).  Both
sides run the same float32 ops; they differ only in the order PyTorch's
and XLA's kernels sum a contraction, about 1e-7 relative a term.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ref_attention
from repro.models import common as ref_common
from repro.models import mamba2 as ref_mamba2
from repro.models import moe as ref_moe
from repro.models import xlstm as ref_xlstm
from repro.models.registry import get_config as ref_get_config
from repro.models.registry import tiny_config as ref_tiny
from repro_torch.convert import model_config_from_reference
from repro_torch.models import attention, common, mamba2, moe, xlstm

TOL = dict(rtol=1e-5, atol=1e-5)
SUM_TOL = dict(rtol=1e-4, atol=1e-4)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _both(a):
    """One seeded numpy array as (jax array, torch tensor)."""
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def _cfgs(arch, **repl):
    ref = dataclasses.replace(ref_tiny(ref_get_config(arch)), dtype="float32",
                              **repl)
    return ref, model_config_from_reference(dataclasses.asdict(ref))


def _params(rng, shapes: dict, scale=0.3):
    """Random parameters as (jax dict, torch dict)."""
    arrs = {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in shapes.items()}
    return ({k: jnp.asarray(v) for k, v in arrs.items()},
            {k: torch.from_numpy(v.copy()) for k, v in arrs.items()})


def test_rms_norm():
    rng = np.random.default_rng(0)
    xj, xt = _both(rng.standard_normal((2, 5, 32)).astype(np.float32) * 3)
    wj, wt = _both(rng.standard_normal(32).astype(np.float32) * 0.1)
    _close(common.rms_norm(xt, wt, 1e-6), ref_common.rms_norm(xj, wj, 1e-6))


@pytest.mark.parametrize("sections", [(), (2, 3, 3)])
def test_apply_rope(sections):
    rng = np.random.default_rng(1)
    xj, xt = _both(rng.standard_normal((2, 7, 4, 16)).astype(np.float32))
    pos = rng.integers(0, 4096, (2, 7)).astype(np.int32)
    if sections:
        pos = np.stack([pos, pos // 3, pos % 5])
    pj, pt = _both(pos)
    _close(common.apply_rope(xt, pt, 500_000.0, sections),
           ref_common.apply_rope(xj, pj, 500_000.0, sections))


@pytest.mark.parametrize("window, cap, q_chunk", [
    (attention.NO_WINDOW, 0.0, 1024),    # one chunk, no window
    (5, 0.0, 4),                         # window, chunked branch (4 < 11)
    (attention.NO_WINDOW, 2.0, 3),       # softcap, chunked, padded queries
])
def test_attention_gqa(window, cap, q_chunk):
    rng = np.random.default_rng(2)
    B, S, H, KV, Dh = 2, 11, 4, 2, 8
    qj, qt = _both(rng.standard_normal((B, S, H, Dh)).astype(np.float32))
    kj, kt = _both(rng.standard_normal((B, S, KV, Dh)).astype(np.float32))
    vj, vt = _both(rng.standard_normal((B, S, KV, Dh)).astype(np.float32))
    pj, pt = _both(np.arange(S, dtype=np.int32))
    kw = dict(window=window, cap=cap, scale=1 / np.sqrt(Dh), q_chunk=q_chunk)
    _close(attention.attention(qt, kt, vt, pt, pt, **kw),
           ref_attention.attention(qj, kj, vj, pj, pj, **kw))


def test_attn_block_decode_clamps_like_dynamic_update_slice():
    """A decode write past the cache's end lands on its last rows, as
    ``lax.dynamic_update_slice`` clamps; the query keeps its position."""
    ref_cfg, cfg = _cfgs("gemma2-2b")
    rng = np.random.default_rng(3)
    D, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pj, pt = _params(rng, {"wq": (D, H * Dh), "wk": (D, KV * Dh),
                           "wv": (D, KV * Dh), "wo": (H * Dh, D)})
    cache = rng.standard_normal((2, 2, 6, KV, Dh)).astype(np.float32)
    xj, xt = _both(rng.standard_normal((2, 1, D)).astype(np.float32))
    for cache_pos in (3, 9):
        pos = np.full((1, 1), cache_pos, np.int32)
        want, want_c = ref_attention.attn_block(
            pj, xj, jnp.asarray(pos), jnp.asarray(pos[0]), ref_cfg, 1,
            {"k": jnp.asarray(cache[0]), "v": jnp.asarray(cache[1])},
            jnp.int32(cache_pos))
        got_c = {"k": torch.from_numpy(cache[0].copy()),
                 "v": torch.from_numpy(cache[1].copy())}
        got, got_c = attention.attn_block(
            pt, xt, torch.from_numpy(pos), torch.from_numpy(pos[0]), cfg, 1,
            got_c, cache_pos)
        _close(got, want)
        for n in ("k", "v"):
            _close(got_c[n], want_c[n])
    assert attention.cache_start(9, 1, 6) == 5


def _moe_inputs(cfg, S, seed):
    rng = np.random.default_rng(seed)
    D, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    pj, pt = _params(rng, {"router": (D, E), "wg": (E, D, F),
                           "wu": (E, D, F), "wd": (E, F, D)})
    # a component every token shares skews the routing toward a few
    # experts, so the default capacity drops assignments
    x = rng.standard_normal((2, S, D)) + 2.0 * rng.standard_normal(D)
    xj, xt = _both(x.astype(np.float32))
    return pj, pt, xj, xt


@pytest.mark.parametrize("capacity_factor", [1.25, 8.0])
def test_moe_ffn(capacity_factor):
    """At the default capacity some assignments are dropped (checked); at
    8x none is.  The combine is a scatter-add in both packages, summing a
    token's experts in another order."""
    ref_cfg, cfg = _cfgs("olmoe-1b-7b", capacity_factor=capacity_factor)
    S = 24
    pj, pt, xj, xt = _moe_inputs(cfg, S, seed=4)
    _, idx, _ = moe.router_topk(xt, pt["router"], cfg)
    C = int(S * cfg.top_k / cfg.n_experts * capacity_factor) + 1
    load = torch.stack([torch.bincount(r.reshape(-1).long(),
                                       minlength=cfg.n_experts)
                        for r in idx])
    assert bool((load > C).any()) == (capacity_factor == 1.25)
    y, aux = moe.moe_ffn(pt, xt, cfg)
    want_y, want_aux = ref_moe.moe_ffn(pj, xj, ref_cfg)
    _close(y, want_y, SUM_TOL)
    _close(aux, want_aux)
    w, idx, _ = moe.router_topk(xt, pt["router"], cfg)
    want_w, want_idx, _ = ref_moe.router_topk(xj, pj["router"], ref_cfg)
    _close(w, want_w)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))


def test_ssd_chunked():
    rng = np.random.default_rng(5)
    B, L, H, P, N = 2, 48, 3, 8, 5
    xj, xt = _both(rng.standard_normal((B, L, H, P)).astype(np.float32))
    aj, at = _both((-np.abs(rng.standard_normal((B, L, H))) * 0.3)
                   .astype(np.float32))
    bj, bt = _both(rng.standard_normal((B, L, N)).astype(np.float32))
    cj, ct = _both(rng.standard_normal((B, L, N)).astype(np.float32))
    hj, ht = _both(rng.standard_normal((B, H, N, P)).astype(np.float32))
    y, h = mamba2.ssd_chunked(xt, at, bt, ct, 16, h0=ht)
    want_y, want_h = ref_mamba2.ssd_chunked(xj, aj, bj, cj, 16, h0=hj)
    _close(y, want_y, SUM_TOL)
    _close(h, want_h, SUM_TOL)


def test_mamba2_block_prefill_then_decode():
    ref_cfg, cfg = _cfgs("zamba2-2.7b")
    rng = np.random.default_rng(6)
    D = cfg.d_model
    d_in = cfg.ssm_expand * D
    N, P = cfg.ssm_state, cfg.ssm_head_dim
    H = d_in // P
    pj, pt = _params(rng, {
        "w_in": (D, 2 * d_in + 2 * N + H), "conv_w": (4, d_in + 2 * N),
        "dt_bias": (H,), "A_log": (H,), "D": (H,), "norm_w": (d_in,),
        "w_out": (d_in, D)})
    xj, xt = _both(rng.standard_normal((2, 21, D)).astype(np.float32))
    # prefill: 20 steps (padded to one chunk of 256, as the reference does)
    y, (h, conv) = mamba2.mamba2_block(pt, xt[:, :20], cfg)
    want_y, (want_h, want_conv) = ref_mamba2.mamba2_block(pj, xj[:, :20],
                                                          ref_cfg)
    for got, want in ((y, want_y), (h, want_h), (conv, want_conv)):
        _close(got, want, SUM_TOL)
    # one recurrent decode step from the prefill's states
    y, (h, conv) = mamba2.mamba2_block(pt, xt[:, 20:], cfg, h, conv)
    want_y, (want_h, want_conv) = ref_mamba2.mamba2_block(
        pj, xj[:, 20:], ref_cfg, want_h, want_conv)
    for got, want in ((y, want_y), (h, want_h), (conv, want_conv)):
        _close(got, want, SUM_TOL)


def test_mlstm_block_with_carried_state():
    ref_cfg, cfg = _cfgs("xlstm-125m")
    rng = np.random.default_rng(7)
    D, H = cfg.d_model, cfg.n_heads
    Di = 2 * D
    pj, pt = _params(rng, {
        "w_up": (D, 2 * Di), "conv_w": (4, Di), "wq": (Di, Di),
        "wk": (Di, Di), "wv": (Di, Di), "w_i": (Di, H), "w_f": (Di, H),
        "gn": (Di,), "w_down": (Di, D)}, scale=0.15)
    xj, xt = _both(rng.standard_normal((2, 13, D)).astype(np.float32))
    out, st = xlstm.mlstm_block(pt, xt[:, :10], cfg, chunk=4)
    want, want_st = ref_xlstm.mlstm_block(pj, xj[:, :10], ref_cfg, chunk=4)
    _close(out, want, SUM_TOL)
    out, st = xlstm.mlstm_block(pt, xt[:, 10:], cfg, st, chunk=4)
    want, want_st = ref_xlstm.mlstm_block(pj, xj[:, 10:], ref_cfg, want_st,
                                          chunk=4)
    _close(out, want, SUM_TOL)
    for got, w in zip(st, want_st):
        _close(got, w, SUM_TOL)


def test_slstm_block_with_carried_state():
    ref_cfg, cfg = _cfgs("xlstm-125m")
    rng = np.random.default_rng(8)
    D, H = cfg.d_model, cfg.n_heads
    Dh = D // H
    pj, pt = _params(rng, {"w_gates": (D, 4 * D),
                           "r_gates": (H, Dh, 4 * Dh), "gn": (D,),
                           "w_down": (D, D)})
    xj, xt = _both(rng.standard_normal((2, 9, D)).astype(np.float32))
    out, st = xlstm.slstm_block(pt, xt[:, :6], cfg)
    want, want_st = ref_xlstm.slstm_block(pj, xj[:, :6], ref_cfg)
    _close(out, want)
    out, st = xlstm.slstm_block(pt, xt[:, 6:], cfg, st)
    want, want_st = ref_xlstm.slstm_block(pj, xj[:, 6:], ref_cfg, want_st)
    _close(out, want)
    for got, w in zip(st, want_st):
        _close(got, w)


@pytest.mark.parametrize("name", ["silu", "gelu_tanh", "sigmoid"])
def test_activations_round_like_the_reference_in_bf16(name):
    """``jax.nn.silu`` / ``gelu`` / ``sigmoid`` are chains of bfloat16 ops,
    each rounded; the port takes the same chain (``F.silu`` rounds once
    and differs in about a quarter of the values)."""
    ref = {"silu": jax.nn.silu, "sigmoid": jax.nn.sigmoid,
           "gelu_tanh": lambda x: jax.nn.gelu(x, approximate=True)}[name]
    x = np.linspace(-8, 8, 4001).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).bfloat16()
    got = getattr(common, name)(xt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), _np(ref(xj)))
