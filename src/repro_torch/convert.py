"""What carries over from the JAX reference package to this port.

There are no learned weights: the state shared by both packages is the
aligner configuration and the encoded inputs.  The inputs (``uint8`` read
and ref codes, see ``core.aligner.encode`` / ``encode_ref``) are numpy
arrays both packages take as they are.  The configuration maps with
``config_from_reference``.
"""
from __future__ import annotations

from .core.config import AlignerConfig

#: reference backends that run the fused band path, bit-identical to each
#: other in the reference and to this port
FUSED_BAND_BACKENDS = ("jnp", "pallas_fused", "pallas_gpu")


def config_from_reference(fields: dict) -> AlignerConfig:
    """Port config from ``dataclasses.asdict`` of a reference AlignerConfig.

    Accepts the backends of FUSED_BAND_BACKENDS with ``store='band'``.
    Raises NotImplementedError for what the port does not run yet, naming
    the ROADMAP item that ports it."""
    fields = dict(fields)
    backend = fields.pop("backend", "jnp")
    store = fields.pop("store", "band")
    n_symbols = fields.pop("n_symbols", 4)
    if backend == "pallas":
        raise NotImplementedError(
            "backend='pallas' (split DC kernel + host traceback) needs the "
            "DC-only kernel K3, still to be ported: ROADMAP.md Queue 2, K3")
    if backend not in FUSED_BAND_BACKENDS:
        raise ValueError(f"backend={backend!r} is not a reference backend "
                         f"the port maps ({FUSED_BAND_BACKENDS})")
    if store != "band":
        raise NotImplementedError(
            f"store={store!r} (the unimproved / SENE-only DP) is still to "
            f"be ported: ROADMAP.md Queue 1, item 3 (core/genasm.py + "
            f"core/traceback.py)")
    if n_symbols != 4:
        raise NotImplementedError(
            f"n_symbols={n_symbols}: the kernels are written for the DNA "
            f"alphabet (4 symbols) only")
    return AlignerConfig(**fields)
