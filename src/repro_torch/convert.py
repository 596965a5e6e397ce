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
    through, except ``n_symbols``, which is dropped: the reference declares
    it and never reads it (its DP takes the DNA alphabet from a constant),
    so every value aligns as 4 does."""
    fields = dict(fields)
    backend = fields.pop("backend", "jnp")
    fields.pop("n_symbols", None)
    if backend not in BACKEND_MAP:
        raise ValueError(f"backend={backend!r} is not a reference backend "
                         f"the port maps ({tuple(BACKEND_MAP)})")
    return AlignerConfig(backend=BACKEND_MAP[backend], **fields)
