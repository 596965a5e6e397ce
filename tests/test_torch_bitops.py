"""The port's bitvector primitives against the reference's on seeded
random words, with the top bit set and word-aligned bases included."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitops as ref
from repro.core.genasm import build_pm_ext as ref_build_pm_ext
from repro_torch.core import bitops as port


def _words(rng, shape):
    w = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    w.reshape(-1)[::3] |= np.uint32(0x80000000)          # top bit set
    return w


def _eq(port_out, ref_out):
    np.testing.assert_array_equal(
        port_out.numpy(), np.asarray(ref_out).astype(np.int64))


def test_constants_match():
    for name in ("WORD_BITS", "N_SYMBOLS", "SENTINEL_PAT", "SENTINEL_TEXT"):
        assert getattr(port, name) == getattr(ref, name), name
    for m in (1, 31, 32, 33, 64, 65):
        assert port.n_words(m) == ref.n_words(m)


@pytest.mark.parametrize("nw", [1, 2, 3])
@pytest.mark.parametrize("carry", [0, 1])
def test_shift1(nw, carry):
    w = _words(np.random.default_rng(nw), (17, nw))
    _eq(port.shift1(torch.from_numpy(w.astype(np.int64)), carry),
        ref.shift1(jnp.asarray(w), carry))


@pytest.mark.parametrize("nw", [1, 2, 3])
def test_ones_below(nw):
    d = np.arange(0, 32 * nw + 3)
    _eq(port.ones_below(torch.from_numpy(d), nw), ref.ones_below(d, nw))


@pytest.mark.parametrize("m,nw", [(5, 1), (32, 1), (40, 2), (64, 2), (70, 3)])
def test_build_pm_and_ext(m, nw):
    rng = np.random.default_rng(m)
    codes = rng.integers(0, 4, (9, m)).astype(np.uint8)
    codes[::2, m // 2:] = ref.SENTINEL_PAT               # ragged patterns
    t = torch.from_numpy(codes)
    _eq(port.build_pm(t, nw), ref.build_pm(jnp.asarray(codes), nw))
    _eq(port.build_pm_ext(t, nw), ref_build_pm_ext(jnp.asarray(codes), nw))


@pytest.mark.parametrize("nw,nwb", [(1, 1), (2, 1), (2, 2), (3, 1), (3, 2)])
def test_extract_window(nw, nwb):
    rng = np.random.default_rng(10 * nw + nwb)
    w = _words(rng, (40, nw))
    hi = 32 * (nw - nwb)
    base = rng.integers(0, hi + 1, 40)
    base[:hi // 32 + 1] = np.arange(0, hi + 1, 32)        # base % 32 == 0
    _eq(port.extract_window(torch.from_numpy(w.astype(np.int64)),
                            torch.from_numpy(base), nwb),
        ref.extract_window(jnp.asarray(w), jnp.asarray(base), nwb))


def test_bits32_round_trip():
    w = _words(np.random.default_rng(0), (64,)).astype(np.int64)
    bits = port.to_bits32(torch.from_numpy(w))
    assert bits.dtype == torch.int32
    np.testing.assert_array_equal(bits.numpy().view(np.uint32), w)
    np.testing.assert_array_equal(port.from_bits32(bits).numpy(), w)


@pytest.mark.parametrize("nw", [1, 2, 3])
def test_get_bit(nw):
    """Every in-range index, plus the reference gather's edges: negative
    indices count from the top word, indices past it read ones."""
    rng = np.random.default_rng(20 + nw)
    idx = np.arange(-32 * nw - 40, 32 * nw + 40)
    w = _words(rng, (len(idx), nw))
    _eq(port.get_bit(torch.from_numpy(w.astype(np.int64)),
                     torch.from_numpy(idx)),
        ref.get_bit(jnp.asarray(w), jnp.asarray(idx, jnp.int32)))


@pytest.mark.parametrize("nw,nwb", [(1, 1), (2, 1), (2, 2), (3, 2)])
def test_window_bit(nw, nwb):
    rng = np.random.default_rng(30 + 10 * nw + nwb)
    w = _words(rng, (50, nw))
    base = rng.integers(0, 32 * (nw - nwb) + 1, 50)
    idx = base + rng.integers(0, 32 * nwb, 50)
    win = ref.extract_window(jnp.asarray(w), jnp.asarray(base), nwb)
    _eq(port.window_bit(torch.from_numpy(np.asarray(win).astype(np.int64)),
                        torch.from_numpy(base), torch.from_numpy(idx)),
        ref.window_bit(win, jnp.asarray(base), jnp.asarray(idx)))
