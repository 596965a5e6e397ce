"""The port's AlignerConfig against the reference's: every derived
property equal over a grid, the same ValueErrors, each reference backend
mapped to its counterpart, and ``n_symbols`` ignored as the reference
ignores it.  The gateway's policy and the mapper's configuration convert
from the reference's values, and the policy refuses what the reference
refuses.  Also holds the helper the
other port tests share: ``cfg_pair``."""
import dataclasses

import numpy as np
import pytest

from repro.core.aligner import GenASMAligner as RefAligner
from repro.core.config import AlignerConfig as RefConfig
from repro_torch.convert import BACKEND_MAP, config_from_reference
from repro_torch.core.aligner import GenASMAligner
from repro_torch.core.config import BACKENDS, AlignerConfig, resolve_config
from repro_torch.data import genome

DERIVED = ("nw", "m_pad", "nwb", "stride", "tb_max_ops", "tb_max_steps",
           "ncols_band", "tail_band_supported", "tail_banded")


def cfg_pair(backend="pallas_fused", **fields):
    """(reference config on `backend` (the fused Pallas path by default),
    the port's config made from it) for the same knobs."""
    ref = RefConfig(backend=backend, **fields)
    return ref, config_from_reference(dataclasses.asdict(ref))


GRID = [dict(W=W, O=O, k=k, tail_store=ts, early_term=et)
        for W, O, k in ((16, 6, 4), (32, 10, 15), (48, 16, 20), (64, 24, 12),
                        (64, 24, 24), (64, 24, 48), (64, 40, 63))
        for ts in ("auto", "band", "full")
        for et in (True, False)]


@pytest.mark.parametrize("fields", GRID, ids=lambda f: "-".join(
    str(v) for v in f.values()))
def test_derived_properties_equal(fields):
    ref, port = cfg_pair(**fields)
    for name in DERIVED:
        assert getattr(port, name) == getattr(ref, name), name
    assert port.early_term == ref.early_term
    assert port.lane_tile == ref.lane_tile
    for j in range(port.W + 1):
        assert port.band_base(j) == ref.band_base(j), j
        assert port.band_base(j, 2 * port.m_pad) == \
            ref.band_base(j, 2 * ref.m_pad), j


@pytest.mark.parametrize("bad", [dict(O=0), dict(O=64), dict(k=0),
                                 dict(k=64), dict(lane_tile=0),
                                 dict(tail_store="diag"),
                                 dict(store="sene")])
def test_same_value_errors(bad):
    with pytest.raises(ValueError) as ref_err:
        RefConfig(**bad)
    with pytest.raises(ValueError) as port_err:
        AlignerConfig(**bad)
    assert str(port_err.value) == str(ref_err.value)


@pytest.mark.parametrize("n_symbols", [2, 5, 20])
def test_unported_reference_configs_raise(n_symbols):
    """``n_symbols`` no longer raises: the reference declares the field and
    never reads it, so the converted config is the one for 4 symbols and a
    small batch aligns as the reference aligns it."""
    ref = RefConfig(W=32, O=12, k=6, backend="pallas_fused",
                    n_symbols=n_symbols)
    cfg = config_from_reference(dataclasses.asdict(ref))
    assert cfg == config_from_reference(dataclasses.asdict(
        dataclasses.replace(ref, n_symbols=4)))
    rng = np.random.default_rng(n_symbols)
    reads = [rng.integers(0, 4, 90).astype(np.uint8) for _ in range(2)]
    refs = [np.concatenate([r[:40], r[43:], [1, 2]]).astype(np.uint8)
            for r in reads]
    want = RefAligner(ref, rescue_rounds=0).align(reads, refs)
    got = GenASMAligner(cfg, rescue_rounds=0, device="cpu").align(reads,
                                                                  refs)
    _assert_same(got, want)


def _reads(n_reads, read_len):
    """Simulated reads at 8 % error and their true reference segments."""
    g = genome.synth_genome(40_000, seed=7)
    rs = genome.simulate_reads(g, n_reads, genome.ReadSimConfig(
        read_len=read_len, error_rate=0.08, seed=13))
    return rs.reads, rs.ref_segments


def _assert_same(got, want):
    for field in ("dist", "failed", "k_used", "read_consumed",
                  "ref_consumed"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)
    assert got.cigars == want.cigars and not got.failed.any()


@pytest.mark.parametrize("fields,n_reads,read_len", [
    (dict(W=32, O=12, k=8, lane_tile=2816), 2, 150),
    (dict(W=96, O=36, k=24), 2, 300)])
def test_configs_the_card_refused_align_as_the_reference(fields, n_reads,
                                                         read_len):
    """lane_tile=2816 (what the reference's lane_tile='auto' gives; the
    CUDA blocks once came from it) and W=96 (NW=3) convert and align, on
    the fused backend's plain path, as the reference's fused backend
    aligns them."""
    ref = RefConfig(backend="pallas_fused", **fields)
    cfg = config_from_reference(dataclasses.asdict(ref))
    assert (cfg.lane_tile, cfg.W, cfg.backend) == (ref.lane_tile, ref.W,
                                                   "fused")
    reads, refs = _reads(n_reads, read_len)
    want = RefAligner(ref, rescue_rounds=1).align(reads, refs)
    got = GenASMAligner(cfg, rescue_rounds=1, device="cpu").align(reads,
                                                                  refs)
    _assert_same(got, want)


@pytest.mark.parametrize("backend,port_backend", [
    ("jnp", "plain"), ("pallas", "split"), ("pallas_fused", "fused"),
    ("pallas_gpu", "fused")])
def test_reference_backends_map(backend, port_backend):
    assert BACKEND_MAP[backend] == port_backend
    ref = RefConfig(W=32, O=10, k=8, backend=backend, lane_tile=64)
    assert config_from_reference(dataclasses.asdict(ref)) == AlignerConfig(
        W=32, O=10, k=8, backend=port_backend, lane_tile=64)


@pytest.mark.parametrize("store", ["edges4", "and", "band"])
def test_store_passes_through_on_plain(store):
    ref, port = cfg_pair(backend="jnp", W=32, O=10, k=8, store=store)
    assert (port.backend, port.store) == ("plain", store)


@pytest.mark.parametrize("backend,store", [
    ("split", "and"), ("split", "edges4"), ("fused", "and"),
    ("fused", "edges4")])
def test_kernel_backends_require_band_store(backend, store):
    """As the reference: a kernel backend with an unimproved store raises,
    naming both knobs."""
    ref_backend = {"split": "pallas", "fused": "pallas_fused"}[backend]
    with pytest.raises(ValueError) as ref_err:
        RefConfig(backend=ref_backend, store=store)
    with pytest.raises(ValueError) as port_err:
        AlignerConfig(backend=backend, store=store)
    want = str(ref_err.value).replace(ref_backend, backend).replace(
        "Pallas kernels", "CUDA kernels")
    assert str(port_err.value) == want


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match=r"backend='pallas' is not one of"):
        AlignerConfig(backend="pallas")
    assert set(BACKENDS) == set(BACKEND_MAP.values())


def test_resolve_config_and_fingerprint():
    cfg = resolve_config(None, k=20, tail_store=None)
    assert cfg == AlignerConfig(k=20)
    assert cfg.fingerprint() == AlignerConfig(k=20).fingerprint()
    assert cfg.fingerprint() != AlignerConfig().fingerprint()
    assert cfg.replace(k=12) == AlignerConfig()
    split = resolve_config(cfg, backend="split", store=None)
    assert split == AlignerConfig(k=20, backend="split")
    assert split.fingerprint() != cfg.fingerprint()
    assert resolve_config(None, store="and", backend="plain").fingerprint() \
        != resolve_config(None, backend="plain").fingerprint()
    with pytest.raises(TypeError, match="n_symbols"):
        resolve_config(None, n_symbols=None)


@pytest.mark.parametrize("fields", [
    {}, dict(capacity=96, shed_frac=(1.0, 0.6), linger_s=0.0,
             service_margin_s=0.25)])
def test_policy_from_reference_round_trips(fields):
    from repro.api import GatewayPolicy as RefPolicy
    from repro_torch.api import GatewayPolicy
    from repro_torch.convert import policy_from_reference
    ref = RefPolicy(**fields)
    port = policy_from_reference(dataclasses.asdict(ref))
    assert port == GatewayPolicy(**fields)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    for p in range(4):
        assert port.frac_for(p) == ref.frac_for(p)


@pytest.mark.parametrize("fields", [
    {}, dict(k=11, w=6, max_occ=16, min_anchors=2, max_candidates=3,
             prefilter=False, seg_len=96, band=4, x_drop=12,
             min_score_frac=0.4)])
def test_mapper_config_from_reference_round_trips(fields):
    from repro.mapper import MapperConfig as RefMapperConfig
    from repro_torch.convert import mapper_config_from_reference
    from repro_torch.mapper import MapperConfig
    ref = RefMapperConfig(**fields)
    port = mapper_config_from_reference(dataclasses.asdict(ref))
    assert port == MapperConfig(**fields)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


@pytest.mark.parametrize("bad", [
    dict(capacity=0), dict(shed_frac=()), dict(shed_frac=(1.0, 0.0)),
    dict(shed_frac=(1.5,)), dict(linger_s=-0.1),
    dict(service_margin_s=-1.0)])
def test_gateway_policy_refuses_what_the_reference_refuses(bad):
    """The reference validates GatewayPolicy with bare asserts; the port
    keeps them, so both refuse each bad value with AssertionError."""
    from repro.api import GatewayPolicy as RefPolicy
    from repro_torch.api import GatewayPolicy
    with pytest.raises(AssertionError):
        RefPolicy(**bad)
    with pytest.raises(AssertionError):
        GatewayPolicy(**bad)
