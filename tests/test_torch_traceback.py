"""The port's traceback (``repro_torch.core.traceback``) against the
reference's, in all three store modes, on the same stores: the reference's
fills make them and both walks read them.  The full walk and the
committed walk (``commit_limit = stride``, the windowed pipeline's) are
covered, and the ragged 'and' walk of the tail window.  Every output key
must be equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import genasm as ref_genasm
from repro.core.traceback import traceback as ref_traceback
from repro_torch.core.traceback import traceback
from tests.conftest import mutate_seq
from tests.test_torch_config import cfg_pair
from tests.test_torch_genasm import _ragged

W, O, K, B = 32, 10, 9, 16
KEYS = ("ops", "n_ops", "read_adv", "ref_adv", "cost", "ok", "d_final")


def _to_torch(store):
    return {key: torch.from_numpy(np.asarray(v).astype(np.int64))
            for key, v in store.items()}


def _assert_equal(port, ref):
    assert set(port) == set(ref)
    for key in KEYS:
        want = np.asarray(ref[key])
        np.testing.assert_array_equal(port[key].numpy(), want, err_msg=key)
        assert port[key].numpy().dtype == want.dtype, key


def _square_batch():
    rng = np.random.default_rng(77)
    pats = rng.integers(0, 4, (B, W)).astype(np.uint8)
    txts = np.stack([mutate_seq(p, int(rng.integers(0, K + 2))
                                if b % 5 else K + 6, rng, extend_to=W)
                     for b, p in enumerate(pats)])
    return pats, txts


@pytest.mark.parametrize("mode", ["edges4", "and", "band"])
@pytest.mark.parametrize("walk", ["full", "committed"])
def test_traceback_equals_reference(mode, walk):
    ref_cfg, cfg = cfg_pair(backend="jnp", W=W, O=O, k=K, store=mode)
    pats, txts = _square_batch()
    pat, txt = jnp.asarray(pats), jnp.asarray(txts)
    wl = jnp.full((B,), W, jnp.int32)
    if mode == "band":
        res = ref_genasm.dc_dmajor(pat, txt, cfg=ref_cfg)
    else:
        res = ref_genasm.dc_jmajor(pat, txt, wl, wl, k=K, n=W, nw=cfg.nw,
                                   store=mode)
    limit = 10**6 if walk == "full" else cfg.stride
    max_ops, max_steps = 2 * W + K, 2 * W + K + 4
    want = ref_traceback(res.store, pat, txt, wl, wl, res.dist,
                         jnp.int32(limit), cfg=ref_cfg, mode=mode,
                         max_ops=max_ops, max_steps=max_steps)
    wl_t = torch.full((B,), W, dtype=torch.int32)
    got = traceback(_to_torch(res.store), torch.from_numpy(pats),
                    torch.from_numpy(txts), wl_t, wl_t,
                    torch.from_numpy(np.array(res.dist)), limit, cfg=cfg,
                    mode=mode, max_ops=max_ops, max_steps=max_steps)
    _assert_equal(got, want)
    solved = np.asarray(res.dist) <= K
    assert solved.any() and not solved.all()
    if walk == "committed":
        assert (got["read_adv"].numpy()[solved] == cfg.stride).all()


def test_traceback_and_ragged_tail_equals_reference():
    """The tail window's walk: ragged m_len / n_len, commit_limit past any
    walk, op budget W + n."""
    ref_cfg, cfg = cfg_pair(backend="jnp", W=W, O=O, k=K)
    pats, txts, m_len, n_len = _ragged(np.random.default_rng(12), W, K)
    n = txts.shape[1]
    res = ref_genasm.dc_jmajor(jnp.asarray(pats), jnp.asarray(txts),
                               jnp.asarray(m_len), jnp.asarray(n_len), k=K,
                               n=n, nw=cfg.nw, store="and")
    kw = dict(mode="and", max_ops=W + n, max_steps=W + n + 4)
    want = ref_traceback(res.store, jnp.asarray(pats), jnp.asarray(txts),
                         jnp.asarray(m_len), jnp.asarray(n_len), res.dist,
                         jnp.int32(2 * (W + n)), cfg=ref_cfg, **kw)
    got = traceback(_to_torch(res.store), torch.from_numpy(pats),
                    torch.from_numpy(txts), torch.from_numpy(m_len),
                    torch.from_numpy(n_len),
                    torch.from_numpy(np.array(res.dist)), 2 * (W + n),
                    cfg=cfg, **kw)
    _assert_equal(got, want)
