"""The main-window loop's kernels around K1 (``kernels/window_step.py``)
on the CPU: their plain versions against the reference's own pieces of
its scan body (``_slice_rev``, the ops layer's ``_pad_to_tile`` /
``_to_kernel_layout`` / ``_unpack_meta`` and ``_append_ops``, then the
state's ``jnp.where`` updates of ``append_main``), the wrappers' checks
and counts, and the fused pass calling each once a window.  The kernels
themselves run only on the card (``chip_smoke.py``, phase ``kernel``).
~5 s."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import windowing as ref_win
from repro.kernels import ops as ref_ops
from repro_torch.core import windowing
from repro_torch.kernels import genasm_dc, window_step
from tests.test_torch_config import cfg_pair

#: (W, O, k, lanes, lane_tile): narrow and wide windows, a batch padded to
#: its tile and one that fills it
CASES = [(64, 24, 12, 37, 8), (40, 16, 8, 16, 16), (16, 6, 4, 5, 1),
         (288, 96, 60, 9, 4), (1024, 300, 100, 3, 2)]


def _inputs(W, B, rng):
    """Reads and references wider than a window, sentinels in the reads,
    starts that clamp at the end of a row (a pass's starts are never
    negative)."""
    Lr, Lf = W + int(rng.integers(0, 200)), W + int(rng.integers(0, 300))
    reads = rng.integers(0, 5, (B, Lr)).astype(np.uint8)
    reads[reads == 4] = windowing.SENTINEL_READ
    refs = rng.integers(0, 10, (B, Lf)).astype(np.uint8)
    read_pos = rng.integers(0, Lr + 4, B).astype(np.int32)
    ref_pos = rng.integers(0, Lf + 4, B).astype(np.int32)
    return reads, refs, read_pos, ref_pos


@pytest.mark.parametrize("W,O,k,B,tile", CASES)
def test_window_prep_plain_equals_reference(W, O, k, B, tile):
    ref_cfg, cfg = cfg_pair(W=W, O=O, k=k, lane_tile=tile)
    reads, refs, read_pos, ref_pos = _inputs(W, B, np.random.default_rng(W))
    full = jnp.full((B,), W, jnp.int32)
    pat = ref_win._slice_rev(jnp.asarray(reads), jnp.asarray(read_pos), W,
                             full)
    txt = ref_win._slice_rev(jnp.asarray(refs), jnp.asarray(ref_pos), W, full)
    want_pm, want_text = ref_ops._to_kernel_layout(
        *ref_ops._pad_to_tile(pat, txt, tile), ref_cfg)
    pm, text = window_step.window_prep(
        *map(torch.from_numpy, (reads, refs, read_pos, ref_pos)), cfg=cfg)
    assert pm.shape == (5, cfg.nw, B + (-B) % tile)
    np.testing.assert_array_equal(pm.numpy().view(np.uint32),
                                  np.asarray(want_pm).astype(np.uint32))
    np.testing.assert_array_equal(text.numpy(), np.asarray(want_text))


def _k1_outputs(cfg, B, Bp, rng):
    """K1's ops (max_ops, Bp) and meta as the kernel leaves them: some
    windows unsolved, op counts past max_ops."""
    max_ops = cfg.tb_max_ops
    ops = rng.integers(0, 4, (max_ops, Bp)).astype(np.int32)
    meta = np.zeros((genasm_dc.META_ROWS, Bp), np.int32)
    meta[genasm_dc.META_DIST] = rng.integers(0, cfg.k + 4, Bp)
    meta[genasm_dc.META_LVL] = rng.integers(0, cfg.k + 2, Bp)
    meta[genasm_dc.META_NOPS] = rng.integers(0, max_ops + 3, Bp)
    meta[genasm_dc.META_RD] = rng.integers(0, cfg.W, Bp)
    meta[genasm_dc.META_RF] = rng.integers(0, cfg.W, Bp)
    meta[genasm_dc.META_DFIN] = rng.integers(0, 3, Bp)
    meta[genasm_dc.META_OK] = 1
    return ops, meta


@pytest.mark.parametrize("W,O,k,B,tile", CASES)
def test_window_commit_plain_equals_reference(W, O, k, B, tile):
    ref_cfg, cfg = cfg_pair(W=W, O=O, k=k, lane_tile=tile)
    rng = np.random.default_rng(k)
    Bp = B + (-B) % tile
    ops_k, meta = _k1_outputs(cfg, B, Bp, rng)
    budget = int(rng.integers(cfg.tb_max_ops // 2, 3 * cfg.tb_max_ops))
    read_len = rng.integers(0, 3 * W, B).astype(np.int32)
    st = {"read_pos": rng.integers(0, 2 * W, B).astype(np.int32),
          "ref_pos": rng.integers(0, 2 * W, B).astype(np.int32),
          "off": rng.integers(0, budget, B).astype(np.int32),  # some run out
          "dist": rng.integers(0, 50, B).astype(np.int32),
          "failed": rng.random(B) < 0.2,
          "buf": rng.integers(0, 4, (B, budget)).astype(np.uint8)}
    # the reference: its unpacking, its append, append_main's updates
    tb = ref_ops._unpack_meta(jnp.transpose(jnp.asarray(ops_k))[:B].astype(
        jnp.uint8), jnp.asarray(meta)[:, :B], ref_cfg)
    j = {key: jnp.asarray(v) for key, v in st.items()}
    active = (jnp.asarray(read_len) - j["read_pos"] > W) & ~j["failed"]
    commit = active & tb["solved"]
    want = {"buf": ref_win._append_ops(j["buf"], j["off"], tb["ops"],
                                       jnp.where(commit, tb["n_ops"], 0),
                                       commit),
            "read_pos": jnp.where(commit, j["read_pos"] + tb["read_adv"],
                                  j["read_pos"]),
            "ref_pos": jnp.where(commit, j["ref_pos"] + tb["ref_adv"],
                                 j["ref_pos"]),
            "off": jnp.where(commit, j["off"] + tb["n_ops"], j["off"]),
            "dist": jnp.where(commit, j["dist"] + tb["cost"], j["dist"]),
            "failed": j["failed"] | (active & ~tb["solved"])}
    state = {key: torch.from_numpy(v.copy()) for key, v in st.items()}
    state["buf"] = torch.from_numpy(np.pad(st["buf"], ((0, 0), (0, 1))))
    state["levels"] = torch.full((3,), window_step.LEVELS_FLOOR,
                                 dtype=torch.int32)
    window_step.window_commit(torch.from_numpy(ops_k), torch.from_numpy(meta),
                              state, torch.from_numpy(read_len), cfg=cfg,
                              window=1)
    state["buf"] = state["buf"][:, :budget]
    for key, value in want.items():
        np.testing.assert_array_equal(state[key].numpy(), np.asarray(value),
                                      err_msg=key)
    assert state["levels"].tolist() == [
        window_step.LEVELS_FLOOR, int(np.asarray(tb["levels"])),
        window_step.LEVELS_FLOOR]


def test_wrappers_check_their_inputs_and_count_plain_calls():
    _, cfg = cfg_pair(W=16, O=6, k=4, lane_tile=4)
    reads, refs, read_pos, ref_pos = map(torch.from_numpy, _inputs(
        16, 6, np.random.default_rng(1)))
    genasm_dc.reset_counts()
    window_step.window_prep(reads, refs, read_pos, ref_pos, cfg=cfg)
    assert window_step.PLAIN_CALLS == {"window_prep": 1, "window_commit": 0}
    assert set(window_step.LAUNCHES.values()) == {0}
    with pytest.raises(ValueError, match="reads must be torch.uint8"):
        window_step.window_prep(reads.long(), refs, read_pos, ref_pos,
                                cfg=cfg)
    with pytest.raises(ValueError, match="read_pos must be torch.int32"):
        window_step.window_prep(reads, refs, read_pos.long(), ref_pos,
                                cfg=cfg)
    with pytest.raises(ValueError, match="no kernel and no plain version"):
        window_step.window_prep(*(t.to("meta") for t in (
            reads, refs, read_pos, ref_pos)), cfg=cfg)
    genasm_dc.reset_counts()
    assert set(window_step.PLAIN_CALLS.values()) == {0}


def test_counts_pass_through_captures_and_replays():
    """A window kernel's launch inside ``recording_launches`` is recorded,
    not counted; ``add_launches`` counts it in ``window_step.LAUNCHES``
    and the template kernels' in ``genasm_dc.LAUNCHES``."""
    genasm_dc.reset_counts()
    with genasm_dc.recording_launches() as rec:
        genasm_dc._count_launch("window_commit", window_step.LAUNCHES)
        genasm_dc._count_launch("tb_fused")
    assert rec["window_commit"] == rec["tb_fused"] == 1
    assert set(window_step.LAUNCHES.values()) == {0}
    genasm_dc.add_launches(rec)
    genasm_dc.add_launches(rec)
    assert window_step.LAUNCHES == {"window_prep": 0, "window_commit": 2}
    assert genasm_dc.LAUNCHES["tb_fused"] == 2
    genasm_dc.reset_counts()
    assert set(window_step.LAUNCHES.values()) == {0}
    assert set(genasm_dc.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("backend", ["fused", "split"])
def test_pass_runs_each_window_kernel_once_a_window(backend):
    """The fused pass calls the prep and the commit once a main window
    (their plain versions here), beside K1; the split pass neither."""
    _, cfg = cfg_pair(W=16, O=6, k=4, lane_tile=4)
    cfg = cfg.replace(backend=backend)
    rng = np.random.default_rng(2)
    L = 90
    Lr, Lf = windowing.pad_geometry(cfg, L, L + 8, 0)
    reads = np.full((3, Lr), windowing.SENTINEL_READ, np.uint8)
    refs = np.full((3, Lf), windowing.SENTINEL_REF, np.uint8)
    reads[:, :L] = rng.integers(0, 4, (3, L))
    refs[:, :L] = reads[:, :L]
    lens = torch.full((3,), L, dtype=torch.int32)
    genasm_dc.reset_counts()
    out = windowing.shard_rung(torch.from_numpy(reads), lens,
                               torch.from_numpy(refs), lens, cfg, L)
    nm = windowing.n_main_windows(L, cfg)
    per_window = nm if backend == "fused" else 0
    assert window_step.PLAIN_CALLS == dict.fromkeys(window_step.KERNELS,
                                                    per_window)
    assert genasm_dc.PLAIN_CALLS["tb_fused"] == per_window
    assert out["levels"].shape == (nm,) and bool((out["levels"] >= 0).all())
    assert not out["failed"].any()
    genasm_dc.reset_counts()
