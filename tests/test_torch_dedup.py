"""The port's near-duplicate operator (``repro_torch.data.dedup``)
against the reference's on the CPU: the token hash, the near-duplicate
records and the kept indices, on a seeded corpus with planted
near-duplicates (token edits), an unrelated sequence and one whose length
ratio keeps it out of every pair."""
import numpy as np
import pytest

from repro.core.config import AlignerConfig as RefConfig
from repro.data import dedup as ref
from repro_torch.core.config import AlignerConfig
from repro_torch.data import dedup as port


def test_tokens_to_dna_equals_reference():
    rng = np.random.default_rng(0)
    for tokens in (np.arange(5000), rng.integers(0, 2 ** 31, 4000),
                   np.array([0, 1, 2 ** 40, 2 ** 63 - 1], np.int64),
                   np.zeros(0, np.int64)):
        got = port.tokens_to_dna(tokens)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, ref.tokens_to_dna(tokens))


def _corpus(seed=11, n_base=4, length=180):
    """n_base unrelated sequences, a near-duplicate of the first two (token
    substitutions, one insertion, one deletion), and a short outlier."""
    rng = np.random.default_rng(seed)
    base = [rng.integers(0, 30_000, length) for _ in range(n_base)]
    near = []
    for b, rate in ((base[0], 0.02), (base[1], 0.05)):
        s = b.copy()
        hit = rng.random(length) < rate
        s[hit] = rng.integers(0, 30_000, int(hit.sum()))
        s = np.insert(s, 40, 7)
        near.append(np.delete(s, 90))
    return base + near + [rng.integers(0, 30_000, length // 2)]


@pytest.mark.parametrize("max_rate", [0.15, 0.02])
def test_near_duplicates_and_filter_equal_reference(max_rate):
    seqs = _corpus()
    ref_cfg = RefConfig(W=64, O=24, k=12, backend="jnp")
    want = ref.near_duplicates(seqs, max_rate=max_rate, cfg=ref_cfg)
    got = port.near_duplicates(seqs, max_rate=max_rate, device="cpu")
    assert got == want
    if max_rate == 0.15:
        assert {(i, j) for i, j, _ in got} == {(0, 4), (1, 5)}
    assert port.dedup_filter(seqs, max_rate=max_rate, device="cpu") == \
        ref.dedup_filter(seqs, max_rate=max_rate, cfg=ref_cfg)


def test_near_duplicates_take_a_config_and_no_pairs():
    seqs = _corpus(seed=3, n_base=2, length=120)
    cfg = AlignerConfig(W=32, O=12, k=8, backend="plain")
    want = ref.near_duplicates(seqs, cfg=RefConfig(W=32, O=12, k=8))
    assert port.near_duplicates(seqs, cfg=cfg, device="cpu") == want
    assert port.near_duplicates(seqs[:1], device="cpu") == []
    assert port.dedup_filter(seqs[:1], device="cpu") == [0]
