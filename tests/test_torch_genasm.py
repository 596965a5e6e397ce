"""The port's GenASM-DC fills (``repro_torch.core.genasm``) against the
reference's on the same seeded inputs: the text-major fill with both full
stores on ragged lengths, the level-major band fill with and without
early termination, and the ``dc`` dispatch.  The DP is integer bitvector
arithmetic, so every output must be equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import genasm as ref
from repro_torch.core import genasm as port
from tests.conftest import mutate_seq
from tests.test_torch_config import cfg_pair

B = 13


def _eq(port_out, ref_out, what):
    np.testing.assert_array_equal(
        port_out.numpy(), np.asarray(ref_out).astype(port_out.numpy().dtype),
        err_msg=what)


def _ragged(rng, W, k):
    """Patterns of length 0..W (sentinel 255 past m_len) and texts a few
    edits away (some far past k), sentinel 9 past n_len <= n."""
    n = W + 4
    pats = np.full((B, W), 255, np.uint8)
    txts = np.full((B, n), 9, np.uint8)
    m_len = np.zeros(B, np.int32)
    n_len = np.zeros(B, np.int32)
    for b in range(B):
        m = int(rng.integers(0, W + 1)) if b else 0
        p = rng.integers(0, 4, m).astype(np.uint8)
        edits = 2 * k + 3 if b % 4 == 3 else int(rng.integers(0, k + 2))
        t = mutate_seq(p, edits, rng)[:n]
        pats[b, :m], txts[b, :len(t)] = p, t
        m_len[b], n_len[b] = m, len(t)
    return pats, txts, m_len, n_len


def _square(rng, W, k, n_pairs=B):
    pats = rng.integers(0, 4, (n_pairs, W)).astype(np.uint8)
    txts = np.stack([mutate_seq(p, int(rng.integers(0, k + 3)), rng,
                                extend_to=W) for p in pats])
    return pats, txts


@pytest.mark.parametrize("W,k", [(16, 3), (32, 9), (40, 7)])
@pytest.mark.parametrize("store", ["and", "edges4"])
def test_dc_jmajor_equals_reference(W, k, store):
    """Ragged m_len / n_len, frozen columns past n_len; NW = 2 at W = 40."""
    pats, txts, m_len, n_len = _ragged(np.random.default_rng(W * k), W, k)
    nw, n = -(-W // 32), txts.shape[1]
    want = ref.dc_jmajor(jnp.asarray(pats), jnp.asarray(txts),
                         jnp.asarray(m_len), jnp.asarray(n_len), k=k, n=n,
                         nw=nw, store=store)
    got = port.dc_jmajor(torch.from_numpy(pats), torch.from_numpy(txts),
                         torch.from_numpy(m_len), torch.from_numpy(n_len),
                         k=k, n=n, nw=nw, store=store)
    _eq(got.dist, want.dist, "dist")
    _eq(got.solved, want.solved, "solved")
    _eq(got.r_final, want.r_final, "r_final")
    assert int(got.levels_run) == int(want.levels_run) == k + 1
    assert set(got.store) == set(want.store)
    for key in got.store:
        _eq(got.store[key], want.store[key], key)
    assert 0 < int(got.solved.sum()) < B


@pytest.mark.parametrize("W,k", [(16, 3), (32, 9), (64, 12)])
@pytest.mark.parametrize("early_term", [True, False])
def test_dc_dmajor_equals_reference(W, k, early_term):
    """dist, the ET loop's exit level and the band up to it."""
    ref_cfg, cfg = cfg_pair(backend="jnp", W=W, O=W // 3, k=k,
                            early_term=early_term)
    pats, txts = _square(np.random.default_rng(W + k), W, k)
    want = ref.dc_dmajor(jnp.asarray(pats), jnp.asarray(txts), cfg=ref_cfg)
    got = port.dc_dmajor(torch.from_numpy(pats), torch.from_numpy(txts),
                         cfg=cfg)
    _eq(got.dist, want.dist, "dist")
    _eq(got.solved, want.solved, "solved")
    levels = int(want.levels_run)
    assert int(got.levels_run) == levels
    assert levels == (int(np.asarray(want.dist).max(initial=0).clip(max=k))
                      + 1 if early_term else k + 1)
    _eq(got.store["Rb"][:levels], np.asarray(want.store["Rb"])[:levels], "Rb")
    assert not got.store["Rb"][levels:].any()


def test_dc_dmajor_stops_at_level_one_when_all_match():
    """Identical windows solve at level 0: ET stops after it."""
    _, cfg = cfg_pair(backend="jnp", W=32, O=12, k=12)
    p = torch.from_numpy(np.random.default_rng(1).integers(
        0, 4, (4, 32)).astype(np.uint8))
    assert int(port.dc_dmajor(p, p, cfg=cfg).levels_run) == 1
    assert int(port.dc_dmajor(p, p, cfg=cfg.replace(early_term=False))
               .levels_run) == 13


@pytest.mark.parametrize("backend,store", [
    ("plain", "band"), ("split", "band"), ("plain", "and"),
    ("plain", "edges4")])
def test_dc_dispatch_equals_reference(backend, store):
    """``dc`` routes each (backend, store) to the fill the reference's
    ``dc`` runs for its counterpart; the band from K3's plain version and
    from dc_dmajor agree with the reference up to the level count."""
    ref_backend = {"plain": "jnp", "split": "pallas"}[backend]
    ref_cfg, cfg = cfg_pair(backend=ref_backend, W=32, O=10, k=7,
                            store=store, lane_tile=8)
    assert (cfg.backend, cfg.store) == (backend, store)
    pats, txts = _square(np.random.default_rng(5), 32, 7, n_pairs=11)
    wl = np.full(11, 32, np.int32)
    want = ref.dc(jnp.asarray(pats), jnp.asarray(txts), jnp.asarray(wl),
                  jnp.asarray(wl), ref_cfg)
    got = port.dc(torch.from_numpy(pats), torch.from_numpy(txts),
                  torch.from_numpy(wl), torch.from_numpy(wl), cfg)
    _eq(got.dist, want.dist, "dist")
    _eq(got.solved, want.solved, "solved")
    levels = int(want.levels_run)
    assert int(got.levels_run) == levels
    for key in want.store:
        _eq(got.store[key][:levels] if key == "Rb" else got.store[key],
            np.asarray(want.store[key])[:levels] if key == "Rb"
            else want.store[key], key)


def test_boundary_pm_and_dist_helpers_equal_reference():
    rng = np.random.default_rng(9)
    pm = rng.integers(0, 2**32, (7, 5, 2), dtype=np.uint64).astype(np.uint32)
    codes = np.array([0, 1, 2, 3, 4, 9, 255], np.int32)
    _eq(port._lookup_pm(torch.from_numpy(pm.astype(np.int64)),
                        torch.from_numpy(codes)),
        ref._lookup_pm(jnp.asarray(pm), jnp.asarray(codes)), "lookup_pm")
    d = np.arange(5)
    for j in range(6):
        for a, b in zip(port._boundary_bits(j, torch.from_numpy(d)),
                        ref._boundary_bits(j, jnp.asarray(d))):
            _eq(a.long(), b, f"boundary bits j={j}")
    r_final = rng.integers(0, 2**32, (7, 5, 2),
                           dtype=np.uint64).astype(np.uint32)
    m_len = np.array([0, 1, 17, 32, 33, 63, 64], np.int32)
    for a, b in zip(port._dist_from_final(
            torch.from_numpy(r_final.astype(np.int64)),
            torch.from_numpy(m_len), 4),
            ref._dist_from_final(jnp.asarray(r_final), jnp.asarray(m_len), 4)):
        _eq(a, b, "dist_from_final")
