"""The port's baselines (``repro_torch.baselines``) against the
reference's on the same seeded inputs: the Edlib-like Myers distance and
its word-parallel carry, the KSW2-like banded affine DP with unit and
affine costs (band exceeded included), and both host tracebacks.  All
integer arithmetic: every output must be equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.baselines import dp as ref_dp
from repro.baselines import myers as ref_myers
from repro.core.oracle import levenshtein
from repro_torch.baselines import dp, myers
from repro_torch.core.bitops import shift1
from repro_torch.core.oracle import validate_cigar
from tests._hyp import given, settings, st
from tests.conftest import mutate_seq

seq = st.lists(st.integers(0, 3), min_size=1, max_size=70)


def _batch(pairs, m_pad, n_pad):
    """(pat, txt, m_len, n_len) numpy int32: pattern padded with 255, text
    with 9."""
    pat = np.full((len(pairs), m_pad), 255, np.int32)
    txt = np.full((len(pairs), n_pad), 9, np.int32)
    ml = np.zeros(len(pairs), np.int32)
    nl = np.zeros(len(pairs), np.int32)
    for b, (p, t) in enumerate(pairs):
        pat[b, :len(p)], txt[b, :len(t)] = p, t
        ml[b], nl[b] = len(p), len(t)
    return pat, txt, ml, nl


def _myers_both(pairs, nw, n):
    pat, txt, ml, nl = _batch(pairs, 32 * nw, n)
    want = np.asarray(ref_myers.myers_distance(
        jnp.array(pat), jnp.array(txt), jnp.array(ml), jnp.array(nl),
        nw=nw, n=n))
    got = myers.myers_distance(torch.from_numpy(pat), torch.from_numpy(txt),
                               torch.from_numpy(ml), torch.from_numpy(nl),
                               nw=nw, n=n)
    assert got.dtype == torch.int32 and got.shape == (len(pairs),)
    return got.numpy(), want


@given(seq, seq)
@settings(max_examples=50, deadline=None)
def test_myers_equals_reference(p, t):
    got, want = _myers_both([(p, t)], nw=3, n=96)
    np.testing.assert_array_equal(got, want)
    assert int(got[0]) == levenshtein(np.array(p), np.array(t))


@pytest.mark.parametrize("nw", [1, 2, 3, 4])
def test_myers_multiword_batches_equal_reference(nw):
    """Pattern lengths at and across word edges, texts shorter, equal and
    longer than the pattern, and runs of >= 32 matches (identical pairs,
    single-symbol pairs) so the carries of the addition cross words."""
    rng = np.random.default_rng(100 + nw)
    n = 32 * nw + 16
    pairs = []
    for m in (1, 31, 32, 33, 64, 95, 96):
        if m > 32 * nw:
            continue
        p = rng.integers(0, 4, m).astype(np.uint8)
        pairs += [
            (p, p),
            (np.zeros(m, np.uint8), np.zeros(min(n, m + 5), np.uint8)),
            (p, mutate_seq(p, 3, rng)[:n]),
            (p, p[:max(1, m // 2)]),
            (p, np.concatenate([p, rng.integers(0, 4, 12)])[:n]),
            (p, rng.integers(0, 4, int(rng.integers(1, n + 1)))),
        ]
    got, want = _myers_both(pairs, nw, n)
    np.testing.assert_array_equal(got, want)
    assert got.tolist() == [levenshtein(np.asarray(p), np.asarray(t))
                            for p, t in pairs]


@pytest.mark.parametrize("nw", [1, 2, 3, 4, 5])
def test_add_carry_and_shift1_equal_reference(nw):
    """Random words, and carry chains that run across every word (all-ones
    plus one, all-ones plus all-ones, a generate under propagates); the
    reference's ``_shift1`` is the port's ``core.bitops.shift1``."""
    rng = np.random.default_rng(nw)
    full = np.uint32(0xFFFFFFFF)
    a = rng.integers(0, 2 ** 32, (40, nw), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2 ** 32, (40, nw), dtype=np.uint64).astype(np.uint32)
    a[0], b[0] = full, 0
    b[0, 0] = 1
    a[1], b[1] = full, full
    a[2], b[2] = full, 0
    a[2, 0], b[2, 0] = np.uint32(0x80000000), np.uint32(0x80000000)
    a[3], b[3] = full - 1, 1
    a[4, :] = full
    want = np.asarray(ref_myers._add_carry(jnp.array(a), jnp.array(b)))
    got = myers._add_carry(torch.from_numpy(a.astype(np.int64)),
                           torch.from_numpy(b.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    for cin in (0, 1):
        want = np.asarray(ref_myers._shift1(jnp.array(a), cin))
        got = shift1(torch.from_numpy(a.astype(np.int64)), cin)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_build_peq_equals_reference():
    rng = np.random.default_rng(3)
    pat, _, _, _ = _batch([(rng.integers(0, 4, m), [0]) for m in
                           (1, 32, 50, 64)], 64, 1)
    want = np.asarray(ref_myers.build_peq(jnp.array(pat), 2))
    got = myers.build_peq(torch.from_numpy(pat), 2)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def _ops_of_run(nw, n):
    pat, txt, ml, nl = _batch([([1] * 20, [1, 2] * 6)] * 3, 32 * nw, n)
    with _CountOps() as count:
        myers.myers_distance(torch.from_numpy(pat), torch.from_numpy(txt),
                             torch.from_numpy(ml), torch.from_numpy(nl),
                             nw=nw, n=n)
    return count.n


def test_myers_ops_per_column_do_not_grow_with_nw():
    """A text column runs the same tensor operations at 1 word and at 32
    (the reference's unrolled carry chain: ~6 a word)."""
    per_col = {nw: (_ops_of_run(nw, 24) - _ops_of_run(nw, 16)) / 8
               for nw in (1, 4, 32)}
    assert per_col[1] == per_col[4] == per_col[32] > 0


def _dp_both(pairs, m, n, **kw):
    pat, txt, ml, nl = _batch(pairs, m, n)
    want = np.asarray(ref_dp.banded_affine_dist(
        jnp.array(pat), jnp.array(txt), jnp.array(ml), jnp.array(nl),
        m=m, **kw))
    got = dp.banded_affine_dist(torch.from_numpy(pat), torch.from_numpy(txt),
                                torch.from_numpy(ml), torch.from_numpy(nl),
                                m=m, **kw)
    assert got.dtype == torch.int32 and got.shape == (len(pairs),)
    return got.numpy(), want


@given(seq, seq)
@settings(max_examples=40, deadline=None)
def test_banded_dp_unit_costs_equal_reference(p, t):
    got, want = _dp_both([(p, t)], 70, 70, bw=70)
    np.testing.assert_array_equal(got, want)
    assert int(got[0]) == levenshtein(np.array(p), np.array(t))


@pytest.mark.parametrize("costs", [dict(), dict(sub=4, gapo=6, gape=2)],
                         ids=["unit", "affine"])
def test_banded_dp_batches_equal_reference(costs):
    """Seeded pairs inside the band, a path forced out of the band with
    |n - m| <= bw (the INF-ish costs, E grown past INF), and |n - m| > bw
    (INF)."""
    rng = np.random.default_rng(7)
    m, n, bw = 48, 64, 6
    pairs = []
    for _ in range(10):
        p = rng.integers(0, 4, int(rng.integers(20, m + 1))).astype(np.uint8)
        pairs.append((p, mutate_seq(p, int(rng.integers(0, 5)), rng)[:n]))
    p = rng.integers(0, 4, 40).astype(np.uint8)
    pairs += [(p, np.concatenate([p[20:], p[:20]])),        # out of band
              (p, np.concatenate([p, p[:bw + 1]])),          # |n - m| > bw
              (p[:30], np.concatenate([p[:30], p[:bw]])),     # |n - m| == bw
              (p, p[:40 - bw - 2])]
    got, want = _dp_both(pairs, m, n, bw=bw, **costs)
    np.testing.assert_array_equal(got, want)
    assert got[-3] == dp.INF and got[-1] == dp.INF


def test_affine_costs_prefer_long_gaps():
    p = [0, 1, 2, 3, 0, 1, 2, 3]
    t = [0, 1, 2, 3, 2, 2, 0, 1, 2, 3]
    got, want = _dp_both([(p, t)], 16, 16, bw=8, sub=4, gapo=6, gape=2)
    assert int(got[0]) == int(want[0]) == 10


def test_tracebacks_equal_reference(rng):
    """Equal distances and op arrays on seeded pairs, and (None, None)
    where the reference gives it: the distance past k, |n - m| past bw."""
    for _ in range(6):
        p = rng.integers(0, 4, 50).astype(np.uint8)
        t = mutate_seq(p, int(rng.integers(1, 8)), rng)
        for k in (3, 12):
            got = myers.banded_traceback(p, t, k=k)
            want = ref_myers.banded_traceback(p, t, k=k)
            assert got[0] == want[0]
            if want[0] is None:
                assert got[1] is None
            else:
                np.testing.assert_array_equal(got[1], want[1])
                validate_cigar(p, t, got[1], got[0])
        for bw, costs in ((12, {}), (12, dict(sub=4, gapo=6, gape=2)),
                          (1, {})):
            got = dp.affine_traceback(p, t, bw=bw, **costs)
            want = ref_dp.affine_traceback(p, t, bw=bw, **costs)
            assert got[0] == want[0]
            if want[0] is None:
                assert got[1] is None
            else:
                np.testing.assert_array_equal(got[1], want[1])
    p = rng.integers(0, 4, 30).astype(np.uint8)
    assert dp.affine_traceback(p, p[:20], bw=4) == (None, None) \
        == ref_dp.affine_traceback(p, p[:20], bw=4)
    assert myers.banded_traceback(p, p[:20], k=4) == (None, None) \
        == ref_myers.banded_traceback(p, p[:20], k=4)


def test_affine_traceback_is_a_linear_gap_dp():
    """Both tracebacks charge gapo on every gap base (no extension state),
    so they equal the DP only at gapo=0: one gap of 2 costs the DP
    6 + 2*2 = 10 and the traceback 2 * (6 + 2) = 16."""
    p = np.array([0, 1, 2, 3, 0, 1, 2, 3], np.uint8)
    t = np.array([0, 1, 2, 3, 2, 2, 0, 1, 2, 3], np.uint8)
    affine = dict(sub=4, gapo=6, gape=2)
    got, want = _dp_both([(p, t)], 16, 16, bw=8, **affine)
    assert int(got[0]) == int(want[0]) == 10
    for mod in (dp, ref_dp):
        cost, ops = mod.affine_traceback(p, t, bw=8, **affine)
        assert cost == 16 and list(ops).count(3) == 2
        assert mod.affine_traceback(p, t, bw=8)[0] == 2
