"""What carries over from the JAX reference package to this port.

There are no learned weights: the state shared by both packages is the
aligner configuration and the encoded inputs.  The inputs (``uint8`` read
and ref codes, see ``core.aligner.encode`` / ``encode_ref``) are numpy
arrays both packages take as they are.  The configuration maps with
``config_from_reference``.
"""
from __future__ import annotations

from .core.config import AlignerConfig

#: reference backend -> the port backend that runs the same path
BACKEND_MAP = {
    "pallas_fused": "fused",
    "pallas_gpu": "fused",
    "pallas": "split",
    "jnp": "plain",
}


def config_from_reference(fields: dict) -> AlignerConfig:
    """Port config from ``dataclasses.asdict`` of a reference AlignerConfig.

    The backend maps through BACKEND_MAP and every other knob passes
    through.  Raises NotImplementedError for an alphabet other than DNA,
    which the kernels are not written for."""
    fields = dict(fields)
    backend = fields.pop("backend", "jnp")
    n_symbols = fields.pop("n_symbols", 4)
    if backend not in BACKEND_MAP:
        raise ValueError(f"backend={backend!r} is not a reference backend "
                         f"the port maps ({tuple(BACKEND_MAP)})")
    if n_symbols != 4:
        raise NotImplementedError(
            f"n_symbols={n_symbols}: the kernels are written for the DNA "
            f"alphabet (4 symbols) only")
    return AlignerConfig(backend=BACKEND_MAP[backend], **fields)
