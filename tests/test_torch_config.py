"""The port's AlignerConfig against the reference's: every derived
property equal over a grid, the same ValueErrors, and the reference
configs the port does not run refused by name.  Also holds the helper the
other port tests share: ``cfg_pair``."""
import dataclasses

import pytest

from repro.core.config import AlignerConfig as RefConfig
from repro_torch.convert import config_from_reference
from repro_torch.core.config import AlignerConfig, resolve_config

DERIVED = ("nw", "m_pad", "nwb", "stride", "tb_max_ops", "tb_max_steps",
           "ncols_band", "tail_band_supported", "tail_banded")


def cfg_pair(**fields):
    """(reference config on the fused Pallas path, the port's config made
    from it) for the same knobs."""
    ref = RefConfig(backend="pallas_fused", **fields)
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


@pytest.mark.parametrize("bad", [dict(O=0), dict(O=64), dict(k=0),
                                 dict(k=64), dict(lane_tile=0),
                                 dict(tail_store="diag")])
def test_same_value_errors(bad):
    with pytest.raises(ValueError) as ref_err:
        RefConfig(**bad)
    with pytest.raises(ValueError) as port_err:
        AlignerConfig(**bad)
    assert str(port_err.value) == str(ref_err.value)


@pytest.mark.parametrize("fields,item", [
    (dict(backend="pallas"), "K3"),
    (dict(store="edges4"), "item 3"),
    (dict(store="and"), "item 3"),
])
def test_unported_reference_configs_raise(fields, item):
    with pytest.raises(NotImplementedError, match=item):
        config_from_reference(dataclasses.asdict(RefConfig(**fields)))


@pytest.mark.parametrize("backend", ["jnp", "pallas_fused", "pallas_gpu"])
def test_fused_band_backends_map_to_one_config(backend):
    ref = RefConfig(W=32, O=10, k=8, backend=backend, lane_tile=64)
    assert config_from_reference(dataclasses.asdict(ref)) == AlignerConfig(
        W=32, O=10, k=8, lane_tile=64)


def test_resolve_config_and_fingerprint():
    cfg = resolve_config(None, k=20, tail_store=None)
    assert cfg == AlignerConfig(k=20)
    assert cfg.fingerprint() == AlignerConfig(k=20).fingerprint()
    assert cfg.fingerprint() != AlignerConfig().fingerprint()
    assert cfg.replace(k=12) == AlignerConfig()
    with pytest.raises(TypeError, match="backend"):
        resolve_config(None, backend=None)
