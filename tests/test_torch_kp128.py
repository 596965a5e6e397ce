"""The level capacity KP = 128 (k >= 64 at W = 96 and 128): the plain
versions of K1, K4 (and K2 with the whole vector as its band) and K3
against the JAX reference, B = 5 lanes: three within k, one past it, one
exact or cut short.

The reference's Pallas kernels take 41.7 s (K1, K3) at W = 96, k = 64 in
interpret mode on a CPU and 152 s (K1) at W = 128, k = 127, so K1 and
K3 are held to the reference's jnp path, which its own tests hold equal
to the kernels (``tests/test_kernel_fused.py``, ``tests/test_kernels.py``):
the square window's ``dc_dmajor`` + band ``traceback`` for K1,
``dc_dmajor``'s band below its level count for K3, the tail's
``dc_jmajor`` + 'and' ``traceback`` for K2 / K4.

The reference runs once, in a subprocess whose XLA skips its ``fusion``
pass (``REF_XLA_FLAGS``, ``run_reference``): compiling ``dc_jmajor``'s
scan (k levels unrolled in its body) grows steeply with k under that
pass; the integer results are the same.  The subprocess starts with the
module's first test and runs beside the port's plain versions
(``BackgroundReference``); the port pads to 8 lanes, not 128."""
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.bitops import SENTINEL_TEXT
from repro_torch.kernels import genasm_dc
from repro_torch.kernels.ops import (genasm_dc_op, genasm_tail_fused_op,
                                     genasm_tb_fused_op)
from tests.conftest import mutate_seq
from tests.test_torch_config import cfg_pair

B = 5
GEOMETRIES = [(96, 36, 64), (96, 36, 95), (128, 48, 127)]
TB_FIELDS = ("ops", "n_ops", "read_adv", "ref_adv", "cost", "d_final")
#: the tail's geometry (W, O, k): 'auto' resolves to K4 and 'band' to K2
#: with the whole vector as its band
TAIL = (96, 36, 64)
#: the port's pad unit here (the default 128 lanes would multiply its
#: plain fills' work by 25)
LANE_TILE = 8
ROOT = Path(__file__).resolve().parents[1]
#: XLA flags of the reference's subprocess (this module's docstring)
REF_XLA_FLAGS = "--xla_disable_hlo_passes=fusion"
REF_TIMEOUT_S = 600


def run_reference(target: str, out: Path) -> None:
    """Run ``tests.<module>.<target>(out)`` in a subprocess on the CPU
    with ``REF_XLA_FLAGS``; raises with its output if it fails."""
    module, fn = target.rsplit(".", 1)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(XLA_FLAGS=REF_XLA_FLAGS, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run(
        [sys.executable, "-c", f"import sys; from {module} import {fn}; "
         f"{fn}(sys.argv[1])", str(out)], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=REF_TIMEOUT_S)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]


#: torch's threads while a module of these tests runs.  The port's plain
#: fills are thousands of small ops: on every core (8 here) they burn 3x
#: the CPU for 1.1x less wall (the W = 512 ladder: 135.8 CPU-s in 20.8 s
#: at 8 threads, 43.6 in 23.7 s at 2), which the suite's six workers,
#: sharing the cores, pay for
PORT_THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """``PORT_THREADS`` torch threads for the module, restored after it
    (modules that import this fixture get it too)."""
    before = torch.get_num_threads()
    torch.set_num_threads(PORT_THREADS)
    yield
    torch.set_num_threads(before)


def save_case(out_dir: str, tag: str, arrays: dict) -> None:
    """One case's reference outputs into `out_dir`/`tag`.npz, whole or not
    at all (``BackgroundReference.get`` reads it as soon as it exists)."""
    path = Path(out_dir) / f"{tag}.npz"
    tmp = path.with_name(f"{tag}.tmp.npz")
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


class BackgroundReference:
    """``run_reference(target, out_dir)`` on a thread started at once, the
    target writing each case as it is done (``save_case``); ``get(tag)``
    waits for that case only and returns its arrays (raising what the run
    raised if it ended without it), so the port's side of each test runs
    beside the reference's later cases."""

    def __init__(self, target: str, out_dir: Path):
        self._dir, self._failed = out_dir, []
        self._thread = threading.Thread(target=self._run, args=(target,))
        self._thread.start()

    def _run(self, target):
        try:
            run_reference(target, self._dir)
        except BaseException as exc:         # re-raised by get()
            self._failed.append(exc)

    def get(self, tag: str) -> dict:
        path = self._dir / f"{tag}.npz"
        while not path.exists() and self._thread.is_alive():
            time.sleep(0.05)
        if not path.exists():
            self._thread.join()
            if self._failed:
                raise self._failed[0]
            raise FileNotFoundError(path)
        with np.load(path) as f:
            return dict(f)


def _square(rng, W, k):
    """Windows within k (lanes 0-2), far past it (3: an all-sentinel text),
    and exact (4)."""
    pats = rng.integers(0, 4, (B, W)).astype(np.uint8)
    txts = []
    for b, p in enumerate(pats):
        t = mutate_seq(p, int(rng.integers(1, k + 1)), rng, extend_to=W)
        txts.append(np.full(W, SENTINEL_TEXT, np.uint8) if b == 3 else
                    p.copy() if b == 4 else t)
    return pats, np.stack(txts)


def _tails(rng, W, k):
    """Ragged tails: m_len in (W/2, W], texts within k (lanes 0-2), one of
    W sentinels against W pattern chars (3: W > k edits), one cut short
    (4); sentinel-padded to n_text = W + 4k."""
    n_text = W + 4 * k
    pats = np.full((B, W), 255, np.uint8)
    txts = np.full((B, n_text), 9, np.uint8)
    m_len, n_len = np.zeros(B, np.int32), np.zeros(B, np.int32)
    for b in range(B):
        m = W if b == 3 else int(rng.integers(W // 2 + 1, W + 1))
        p = rng.integers(0, 4, m).astype(np.uint8)
        t = mutate_seq(p, int(rng.integers(0, k // 4)), rng)[:n_text]
        if b == 3:
            t = np.full(W, 9, np.uint8)
        if b == 4:
            t = t[:len(t) - 5]
        pats[b, :m], txts[b, :len(t)] = p, t
        m_len[b], n_len[b] = m, len(t)
    return pats, txts, m_len, n_len


def _count_plain(name):
    before = genasm_dc.PLAIN_CALLS[name]
    return lambda: genasm_dc.PLAIN_CALLS[name] - before


def square_reference(arrays: dict, tag: str, pat, txt, ref_cfg, cfg,
                     rb: bool = True) -> None:
    """The reference's square window on (pat, txt) into `arrays` under
    `tag`: ``dc_dmajor``'s dist, level count and band below it, and its
    band ``traceback``'s fields (`rb` False: the fill only)."""
    import jax.numpy as jnp

    from repro.core.genasm import dc_dmajor
    from repro.core.traceback import traceback
    res = dc_dmajor(jnp.asarray(pat), jnp.asarray(txt), cfg=ref_cfg)
    arrays[f"{tag}_dist"] = np.asarray(res.dist)
    arrays[f"{tag}_levels"] = np.asarray(res.levels_run)
    L = int(res.levels_run)
    arrays[f"{tag}_band"] = np.asarray(res.store["Rb"])[:L].astype(np.int64)
    if rb:
        wl = jnp.full((pat.shape[0],), cfg.W, jnp.int32)
        ref = traceback(res.store, jnp.asarray(pat), jnp.asarray(txt), wl,
                        wl, res.dist, jnp.int32(cfg.stride), cfg=ref_cfg,
                        mode="band", max_ops=cfg.tb_max_ops,
                        max_steps=cfg.tb_max_steps)
        arrays.update({f"{tag}_{key}": np.asarray(ref[key])
                       for key in TB_FIELDS})


def tail_reference(arrays: dict, tag: str, pat, txt, m_len, n_len, n_text,
                   kw, ref_cfg) -> None:
    """The reference's tail on its jnp path (``dc_jmajor`` + the 'and'
    ``traceback``) into `arrays` under `tag`."""
    import jax.numpy as jnp

    from repro.core.genasm import dc_jmajor
    from repro.core.traceback import traceback
    res = dc_jmajor(jnp.asarray(pat), jnp.asarray(txt), jnp.asarray(m_len),
                    jnp.asarray(n_len), k=ref_cfg.k, n=n_text,
                    nw=ref_cfg.nw, store="and")
    ref = traceback(res.store, jnp.asarray(pat), jnp.asarray(txt),
                    jnp.asarray(m_len), jnp.asarray(n_len), res.dist,
                    jnp.int32(kw["commit_limit"]), cfg=ref_cfg, mode="and",
                    max_ops=kw["max_ops"], max_steps=kw["max_steps"])
    ref = {**ref, "dist": res.dist, "solved": res.solved}
    arrays.update({f"{tag}_{key}": np.asarray(ref[key])
                   for key in TB_FIELDS + ("dist", "solved")})


def _tail_case(W, k):
    pat, txt, m_len, n_len = _tails(np.random.default_rng(3 * k + W), W, k)
    n_text = W + 4 * k
    kw = dict(commit_limit=2 * (W + n_text), max_ops=W + n_text,
              max_steps=W + n_text + 4)
    return pat, txt, m_len, n_len, n_text, kw


def reference_outputs(out_dir: str) -> None:
    """Every reference output of this module's cases, one npz a case in
    `out_dir`, in the tests' order (run in the subprocess of the ``ref``
    fixture)."""
    for tests, rng_of, rb in (("k1", lambda W, k: W + k, True),
                              ("k3", lambda W, k: 2 * W + k, False)):
        for W, O, k in GEOMETRIES:
            ref_cfg, cfg = cfg_pair(W=W, O=O, k=k)
            arrays, tag = {}, f"{tests}_{W}_{k}"
            square_reference(arrays, tag,
                             *_square(np.random.default_rng(rng_of(W, k)),
                                      W, k), ref_cfg, cfg, rb=rb)
            save_case(out_dir, tag, arrays)
    W, O, k = TAIL
    pat, txt, m_len, n_len, n_text, kw = _tail_case(W, k)
    arrays = {}
    tail_reference(arrays, "tail", pat, txt, m_len, n_len, n_text, kw,
                   cfg_pair(W=W, O=O, k=k)[0])
    save_case(out_dir, "tail", arrays)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return BackgroundReference("tests.test_torch_kp128.reference_outputs",
                               tmp_path_factory.mktemp("kp128"))


@pytest.mark.parametrize("W,O,k", GEOMETRIES)
def test_k1_plain_equals_reference_jnp_band_path(W, O, k, ref):
    _, cfg = cfg_pair(W=W, O=O, k=k, lane_tile=LANE_TILE)
    assert genasm_dc.levels_bucket(k) == 128
    pat, txt = _square(np.random.default_rng(W + k), W, k)
    calls = _count_plain("tb_fused")
    port = genasm_tb_fused_op(torch.from_numpy(pat), torch.from_numpy(txt),
                              cfg=cfg, commit_limit=cfg.stride,
                              max_ops=cfg.tb_max_ops,
                              max_steps=cfg.tb_max_steps)
    assert calls() == 1
    tag = f"k1_{W}_{k}"
    want = ref.get(tag)
    np.testing.assert_array_equal(port["dist"].numpy(), want[f"{tag}_dist"])
    assert int(port["levels"]) == int(want[f"{tag}_levels"])
    for key in TB_FIELDS:
        np.testing.assert_array_equal(port[key].numpy(),
                                      want[f"{tag}_{key}"], err_msg=key)
    solved = port["solved"].numpy()
    assert solved[4] and not solved[3]


@pytest.mark.parametrize("W,O,k", GEOMETRIES)
def test_k3_plain_equals_reference_dc_dmajor(W, O, k, ref):
    """K3's band equals dc_dmajor's below its level count (dc_dmajor
    leaves the levels above at zero); dist and the level count equal."""
    _, cfg = cfg_pair(backend="pallas", W=W, O=O, k=k, lane_tile=LANE_TILE)
    pat, txt = _square(np.random.default_rng(2 * W + k), W, k)
    calls = _count_plain("dc_band")
    dist, band, levels = genasm_dc_op(torch.from_numpy(pat),
                                      torch.from_numpy(txt), cfg=cfg)
    assert calls() == 1
    tag = f"k3_{W}_{k}"
    want = ref.get(tag)
    L = int(want[f"{tag}_levels"])
    assert int(levels) == L
    np.testing.assert_array_equal(dist.numpy(), want[f"{tag}_dist"])
    assert band.shape == (k + 1, cfg.ncols_band, B, cfg.nwb)
    np.testing.assert_array_equal(band[:L].numpy(), want[f"{tag}_band"])


def test_k4_and_k2_plain_equal_reference_tail(ref):
    """At W = 96, k = 64 'auto' resolves to K4 and 'band' to K2 with the
    whole vector as its band; both equal the reference's tail on its jnp
    path (``dc_jmajor`` + the 'and' traceback).  Its tail kernel in
    interpret mode takes 143 s on these lanes (138 s of it the lane past
    k); at W = 128 the tails at KP = 128 are held to the reference
    through the aligner (``test_torch_kp128_ladder.py``, k = 120)."""
    W, O, k = TAIL
    pat, txt, m_len, n_len, n_text, kw = _tail_case(W, k)
    for tail_store, kernel in (("auto", "tail_full"), ("band", "tail_banded")):
        ref_cfg, cfg = cfg_pair(W=W, O=O, k=k, tail_store=tail_store,
                                lane_tile=LANE_TILE)
        assert cfg.tail_banded == (kernel == "tail_banded") == \
            ref_cfg.tail_banded
        calls = _count_plain(kernel)
        port = genasm_tail_fused_op(
            torch.from_numpy(pat), torch.from_numpy(txt),
            torch.from_numpy(m_len), torch.from_numpy(n_len), cfg=cfg,
            n_text=n_text, **kw)
        assert calls() == 1
        want = ref.get("tail")
        for key in TB_FIELDS + ("dist", "solved"):
            np.testing.assert_array_equal(port[key].numpy(),
                                          want[f"tail_{key}"],
                                          err_msg=f"{kernel} {key}")
        solved = port["solved"].numpy()
        assert solved[:3].all() and not solved[3]
