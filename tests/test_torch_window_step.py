"""The main-window loop around K1 (``kernels/window_step.py``) on the
CPU: the plain pieces of K1's window form against the reference's own
pieces of its scan body (``_slice_rev``, the ops layer's
``_pad_to_tile`` / ``_to_kernel_layout`` / ``_unpack_meta`` and
``_append_ops``, then the state's ``jnp.where`` updates of
``append_main``), the window entry's checks and counts (one K1 launch or
plain call a window, through captures and replays), and the fused pass
calling it once a window.  ``tests/test_torch_tb_window.py`` holds the
whole window form to the reference over several windows; the kernel
itself runs only on the card (``chip_smoke.py``, phases ``k1_grid`` and
``kernel``).  ~25 s on one worker, most of it the reference's jit."""
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
    pm, text = window_step.window_prep_plain(
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
    window_step.window_commit_plain(torch.from_numpy(ops_k),
                                    torch.from_numpy(meta), state,
                                    torch.from_numpy(read_len), cfg=cfg,
                                    window=1)
    state["buf"] = state["buf"][:, :budget]
    for key, value in want.items():
        np.testing.assert_array_equal(state[key].numpy(), np.asarray(value),
                                      err_msg=key)
    assert state["levels"].tolist() == [
        window_step.LEVELS_FLOOR, int(np.asarray(tb["levels"])),
        window_step.LEVELS_FLOOR]


def _window_args(W=16, O=6, k=4, B=6, seed=1):
    """The window entry's arguments: a batch of `B` lanes at its first
    window and a fresh pass state (two level counts)."""
    _, cfg = cfg_pair(W=W, O=O, k=k, lane_tile=4)
    reads, refs, read_pos, ref_pos = map(torch.from_numpy, _inputs(
        W, B, np.random.default_rng(seed)))
    budget = 3 * cfg.tb_max_ops
    state = {"read_pos": read_pos, "ref_pos": ref_pos,
             "off": torch.zeros(B, dtype=torch.int32),
             "dist": torch.zeros(B, dtype=torch.int32),
             "failed": torch.zeros(B, dtype=torch.bool),
             "buf": torch.full((B, budget + 1), 255, dtype=torch.uint8),
             "levels": torch.full((2,), window_step.LEVELS_FLOOR,
                                  dtype=torch.int32)}
    read_len = torch.full((B,), reads.shape[1], dtype=torch.int32)
    return cfg, reads, refs, read_len, state


def test_wrappers_check_their_inputs_and_count_plain_calls():
    """The window entry on CPU tensors: its plain version, counted as one
    plain call of K1 (no launch, and no count of any other kernel); on
    wrong dtypes, shapes, devices or windows it raises."""
    cfg, reads, refs, read_len, state = _window_args()
    genasm_dc.reset_counts()
    window_step.genasm_tb_window(reads, refs, read_len, state, cfg=cfg,
                                 window=0)
    assert genasm_dc.PLAIN_CALLS == {**dict.fromkeys(genasm_dc.KERNELS, 0),
                                     "tb_fused": 1}
    assert set(genasm_dc.LAUNCHES.values()) == {0}
    assert int(state["levels"][0]) >= 1
    call = window_step.genasm_tb_window
    with pytest.raises(ValueError, match="reads must be torch.uint8"):
        call(reads.long(), refs, read_len, state, cfg=cfg, window=1)
    with pytest.raises(ValueError, match="read_len must be torch.int32"):
        call(reads, refs, read_len.long(), state, cfg=cfg, window=1)
    with pytest.raises(ValueError, match="failed must be torch.bool"):
        call(reads, refs, read_len, {**state, "failed": state["failed"].int()},
             cfg=cfg, window=1)
    with pytest.raises(ValueError, match="off has shape"):
        call(reads, refs, read_len, {**state, "off": state["off"][:-1]},
             cfg=cfg, window=1)
    with pytest.raises(ValueError, match="window 2 of 2"):
        call(reads, refs, read_len, state, cfg=cfg, window=2)
    with pytest.raises(ValueError, match="for W=16"):
        call(reads[:, :15].contiguous(), refs, read_len, state, cfg=cfg,
             window=1)
    with pytest.raises(ValueError, match="must be contiguous"):
        call(reads, refs, read_len, {**state, "buf": state["buf"].T.
                                     contiguous().T}, cfg=cfg, window=1)
    with pytest.raises(ValueError, match="no kernel and no plain version"):
        call(*(t.to("meta") for t in (reads, refs, read_len)),
             {key: t.to("meta") for key, t in state.items()}, cfg=cfg,
             window=1)
    assert genasm_dc.PLAIN_CALLS["tb_fused"] == 1
    genasm_dc.reset_counts()
    assert set(genasm_dc.PLAIN_CALLS.values()) == {0}


@pytest.mark.parametrize("W,O,k", [(16, 6, 4), (288, 96, 20)])
def test_counts_pass_through_captures_and_replays(monkeypatch, W, O, k):
    """The window entry's launch, on the card's branch (tensors that say
    they are on the card, a stand-in for the library's launch and the
    band store here), is one launch of K1's window entry point
    counted under K1's name: inside ``recording_launches`` it is recorded,
    not counted; ``add_launches`` counts it in ``genasm_dc.LAUNCHES``.
    Where K1 runs the wide family (``genasm_dc.kernel_family``) its entry
    point.  No other kernel's count."""
    cfg, reads, refs, read_len, state = _window_args(W, O, k, B=5)
    called = []

    def launch(name, *tensors, ints, block=(), entry=None):
        genasm_dc._count_launch(name)
        called.append((name, entry, tensors, ints, block))

    def xwide_launch(name, cfg, tensors, ints, n_text=None, *, B=None,
                     entry=None):
        launch(name, *tensors, ints=ints, entry=entry)

    monkeypatch.setattr(genasm_dc, "_launch", launch)
    monkeypatch.setattr(genasm_dc, "_xwide_launch", xwide_launch)
    monkeypatch.setattr(genasm_dc, "_store", lambda B, words, device:
                        torch.empty((B, words), dtype=torch.int32))
    cuda = torch.device("cuda")
    monkeypatch.setattr(torch.Tensor, "device", property(lambda t: cuda))
    genasm_dc.reset_counts()
    with genasm_dc.recording_launches() as rec:
        window_step.genasm_tb_window(reads, refs, read_len, state, cfg=cfg,
                                     window=1)
    monkeypatch.undo()
    assert rec == {**dict.fromkeys(genasm_dc.KERNELS, 0), "tb_fused": 1}
    assert set(genasm_dc.LAUNCHES.values()) == {0}
    [(name, entry, tensors, ints, block)] = called
    wide = genasm_dc.kernel_family(cfg, "tb_fused") == "xwide"
    assert (name, entry) == ("tb_fused", "tb_window_xwide" if wide
                             else "tb_window")
    assert tensors[9].data_ptr() == state["levels"][1:].data_ptr()
    assert ints == (5, reads.shape[1], refs.shape[1], state["buf"].shape[1],
                    W, cfg.nw, k, cfg.nwb, cfg.ncols_band, 1, cfg.stride,
                    cfg.tb_max_ops, cfg.tb_max_steps)
    if not wide:
        geo = genasm_dc.tb_fused_geometry(cfg, window=True)
        assert block[-1] == geo.shared_bytes == genasm_dc.tb_fused_geometry(
            cfg).shared_bytes + 4 * geo.lanes * genasm_dc.k1_window_words(
                cfg.nw)
    genasm_dc.add_launches(rec)
    genasm_dc.add_launches(rec)
    assert genasm_dc.LAUNCHES == {**dict.fromkeys(genasm_dc.KERNELS, 0),
                                  "tb_fused": 2}
    assert set(genasm_dc.PLAIN_CALLS.values()) == {0}
    genasm_dc.reset_counts()
    assert set(genasm_dc.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("backend", ["fused", "split"])
def test_pass_runs_each_window_kernel_once_a_window(backend):
    """The fused pass calls K1's window form once a main window (its
    plain version here) and no other kernel in the loop but the tail's;
    the split pass never (K3 once a window instead)."""
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
    tail = "tail_banded" if cfg.tail_banded else "tail_full"
    assert genasm_dc.PLAIN_CALLS == {
        **dict.fromkeys(genasm_dc.KERNELS, 0),
        **({"tb_fused": nm, tail: 1} if backend == "fused"
           else {"dc_band": nm})}
    assert set(genasm_dc.LAUNCHES.values()) == {0}
    assert out["levels"].shape == (nm,) and bool((out["levels"] >= 0).all())
    assert not out["failed"].any()
    genasm_dc.reset_counts()
