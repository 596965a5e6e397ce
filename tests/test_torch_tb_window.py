"""K1's window form on the CPU (``window_step.genasm_tb_window``: one
main window of the fused loop in one launch of K1): its plain version
``tb_window_plain`` over three windows in a row, the state carried from
one to the next, against the reference's own pieces of its scan body
(``append_main`` in ``repro/core/windowing.py``): ``_slice_rev``, the ops
layer's ``_pad_to_tile`` / ``_to_kernel_layout``, K1, ``_unpack_meta``,
``_append_ops`` and the state's ``jnp.where`` updates, carried the same
way, over ``test_torch_window_step.CASES``' widths (W = 16 .. 1,024).
K1 is the reference's ``genasm_tb_fused_pallas`` in interpret mode at W
<= 64; at W = 288 and 1,024 its compile takes minutes on a CPU (the jnp
path's 50 s and 500 s), so there K1's outputs are the port's plain K1 on
the reference's kernel layout (``tests/test_torch_w512.py`` holds that to
the reference's jnp path) and every other piece is the reference's, and
k is cut to 20 (the port's plain fill costs k + 1 levels a column; the
window's glue is the same at every k).
The lanes include starts that clamp, inactive lanes, windows past k and
lanes already failed; and the kernel's running of the B real lanes alone
(no pad to ``lane_tile``) changes no field.  The kernel itself runs only
on the card (``chip_smoke.py``, phases ``k1_grid`` and ``kernel``).
~45 s on one worker, ~17 s of it the reference's interpret-mode K1
compiles at W = 16, 40, 64 and most of the rest the port's plain K1 at
W = 288 and 1,024."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import windowing as ref_win
from repro.kernels import ops as ref_ops
from repro.kernels.genasm_dc import genasm_tb_fused_pallas
from repro_torch.core import windowing
from repro_torch.kernels import genasm_dc, window_step
from tests.test_torch_config import cfg_pair
from tests.test_torch_window_step import CASES

#: ``CASES`` with k = 20 where the reference's K1 is the port's plain one
TB_CASES = [(W, O, k if W <= 64 else 20, B, tile) for W, O, k, B, tile in CASES]
WINDOWS = 3
STATE = ("read_pos", "ref_pos", "off", "dist", "failed")


def window_batch(cfg, B, seed):
    """Reads long enough for WINDOWS windows, references within ~1 %
    substitutions, and a state whose lanes include each kind a pass
    meets: lane 0 starts past its row (the start clamps), lane 1 within W
    of its read's end (inactive), lane 2's reference lies 2 W further on
    (its window fails), lane 3 has failed already; offsets of which some
    run into the op buffer's drop column; at least five lanes, so that
    one is none of these."""
    B = max(B, 5)
    rng = np.random.default_rng(seed)
    W, stride = cfg.W, cfg.stride
    L = W + (WINDOWS + 1) * stride + 50
    Lr, Lf = windowing.pad_geometry(cfg, L, L, 0)
    bases = rng.integers(0, 4, (B, L)).astype(np.uint8)
    reads = np.full((B, Lr), windowing.SENTINEL_READ, np.uint8)
    reads[:, :L] = bases
    refs = np.full((B, Lf), windowing.SENTINEL_REF, np.uint8)
    refs[:, :L] = np.where(rng.random(bases.shape) < 0.01,
                           rng.integers(0, 4, bases.shape), bases)
    read_len = np.full(B, L, np.int32)
    read_pos = rng.integers(0, 30, B).astype(np.int32)
    ref_pos = np.maximum(read_pos + rng.integers(-2, 3, B), 0)
    budget = windowing.total_op_budget(L, cfg)
    st = {"read_pos": read_pos, "ref_pos": ref_pos.astype(np.int32),
          "off": rng.integers(0, budget, B).astype(np.int32),
          "dist": rng.integers(0, 9, B).astype(np.int32),
          "failed": np.zeros(B, bool),
          "buf": np.full((B, budget), 255, np.uint8)}
    for lane, kind in enumerate(("clamped", "inactive", "fails", "failed")):
        if kind == "clamped":
            st["read_pos"][lane] = st["ref_pos"][lane] = Lr + 5
        elif kind == "inactive":
            st["read_pos"][lane] = L - W + 3
            st["ref_pos"][lane] = L - W + 3
        elif kind == "fails":
            st["ref_pos"][lane] += 2 * W
        else:
            st["failed"][lane] = True
    return reads, refs, read_len, st


def _reference_k1(ref_cfg, tile, cfg):
    """The reference's K1 on kernel-layout (pm, text): its Pallas kernel
    in interpret mode, or (NW >= 9) the port's plain K1 on the same
    layout."""
    kw = dict(commit_limit=cfg.stride, max_ops=cfg.tb_max_ops,
              max_steps=cfg.tb_max_steps)
    if cfg.nw <= genasm_dc.TEMPLATE_NW:
        return jax.jit(partial(genasm_tb_fused_pallas, cfg=ref_cfg, tile=tile,
                               interpret=True, **kw))

    def port(pm, text):
        ops, meta = genasm_dc.tb_fused_plain(
            torch.from_numpy(np.array(pm)), torch.from_numpy(np.array(text)),
            cfg=cfg, **kw)
        return jnp.asarray(ops.numpy()), jnp.asarray(meta.numpy())
    return port


def reference_window(reads, refs, read_len, st, ref_cfg, tile, k1):
    """One main window of the reference's scan body on its state `st`
    (jnp, the buffer without a drop column): the new state and the
    window's level count."""
    W, B = ref_cfg.W, reads.shape[0]
    active = (read_len - st["read_pos"] > W) & ~st["failed"]
    wfull = jnp.full((B,), W, jnp.int32)
    pat = ref_win._slice_rev(reads, st["read_pos"], W, wfull)
    txt = ref_win._slice_rev(refs, st["ref_pos"], W, wfull)
    pm, text = ref_ops._to_kernel_layout(
        *ref_ops._pad_to_tile(pat, txt, tile), ref_cfg)
    ops_k, meta = k1(pm, text)
    tb = ref_ops._unpack_meta(jnp.transpose(ops_k)[:B].astype(jnp.uint8),
                              meta[:, :B], ref_cfg)
    commit = active & tb["solved"]
    new = {"buf": ref_win._append_ops(st["buf"], st["off"], tb["ops"],
                                      jnp.where(commit, tb["n_ops"], 0),
                                      commit),
           "failed": st["failed"] | (active & ~tb["solved"])}
    for key, step in (("read_pos", "read_adv"), ("ref_pos", "ref_adv"),
                      ("off", "n_ops"), ("dist", "cost")):
        new[key] = jnp.where(commit, st[key] + tb[step], st[key])
    return new, int(tb["levels"])


def port_state(st, windows=WINDOWS):
    """The port's pass state from a batch's: the buffer with its drop
    column, the level counts at ``LEVELS_FLOOR``."""
    out = {key: torch.from_numpy(st[key].copy()) for key in STATE}
    out["buf"] = torch.from_numpy(np.pad(st["buf"], ((0, 0), (0, 1)),
                                         constant_values=255))
    out["levels"] = torch.full((windows,), window_step.LEVELS_FLOOR,
                               dtype=torch.int32)
    return out


@pytest.mark.parametrize("W,O,k,B,tile", TB_CASES)
def test_tb_window_plain_equals_reference(W, O, k, B, tile):
    ref_cfg, cfg = cfg_pair(W=W, O=O, k=k, lane_tile=tile)
    reads, refs, read_len, st = window_batch(cfg, B, seed=W + k)
    k1 = _reference_k1(ref_cfg, tile, cfg)
    j = {key: jnp.asarray(v) for key, v in st.items()}
    jreads, jrefs, jlen = map(jnp.asarray, (reads, refs, read_len))
    port = port_state(st)
    args = tuple(map(torch.from_numpy, (reads, refs, read_len)))
    want_levels = []
    for w in range(WINDOWS):
        j, levels = reference_window(jreads, jrefs, jlen, j, ref_cfg, tile,
                                     k1)
        want_levels.append(levels)
        window_step.tb_window_plain(*args, port, cfg=cfg, window=w)
        for key in STATE:
            np.testing.assert_array_equal(port[key].numpy(),
                                          np.asarray(j[key]),
                                          err_msg=f"{key}, window {w}")
        np.testing.assert_array_equal(port["buf"][:, :-1].numpy(),
                                      np.asarray(j["buf"]),
                                      err_msg=f"buf, window {w}")
    assert port["levels"].tolist() == want_levels
    # the inactive lane kept its place, the window past k failed, and
    # the lanes of no kind committed
    assert int(port["read_pos"][1]) == int(st["read_pos"][1])
    assert bool(port["failed"][2])
    assert bool((port["read_pos"][4:] > torch.from_numpy(
        st["read_pos"][4:])).any())


@pytest.mark.parametrize("W,O,k,B,tile", TB_CASES)
def test_pad_lanes_change_no_field(W, O, k, B, tile):
    """``tb_window_plain`` pads the batch to ``cfg.lane_tile`` with
    all-'A' lanes; the kernel runs the B real lanes alone.  Both give
    every field, the level counts and the buffer alike."""
    _, cfg = cfg_pair(W=W, O=O, k=k, lane_tile=tile)
    reads, refs, read_len, st = window_batch(cfg, B, seed=W + k + 1)
    args = tuple(map(torch.from_numpy, (reads, refs, read_len)))
    padded, alone = port_state(st), port_state(st)
    for w in range(WINDOWS):
        window_step.tb_window_plain(*args, padded, cfg=cfg.replace(
            lane_tile=reads.shape[0] + 3), window=w)
        window_step.tb_window_plain(*args, alone, cfg=cfg.replace(
            lane_tile=1), window=w)
    for key in padded:
        assert torch.equal(padded[key], alone[key]), key
