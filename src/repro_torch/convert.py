"""What carries over from the JAX reference package to this port.

There are no learned weights: the state shared by both packages is the
aligner configuration and the encoded inputs.  The inputs (``uint8`` read
and ref codes, see ``core.aligner.encode`` / ``encode_ref``) are numpy
arrays both packages take as they are.  The configuration maps with
``config_from_reference``, a session's spec with ``spec_from_reference``,
a gateway's policy with ``policy_from_reference`` and a mapper's
configuration with ``mapper_config_from_reference``.
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


def spec_from_reference(fields: dict, mesh=None):
    """Port AlignSpec from ``dataclasses.asdict`` of a reference AlignSpec:
    ``cfg`` (a dict of the reference config's fields) through
    ``config_from_reference``, every session knob as it is.

    The reference's mesh holds JAX devices, which the port cannot take
    (nor can ``dataclasses.asdict`` copy it: put the reference's mesh
    object back into the dict).  Where the reference spec has one, the
    caller passes the port's
    ``launch.mesh.DeviceMesh`` as `mesh`: its ``axis_names`` and ``shape``
    must equal the reference mesh's (read by attribute, no JAX import),
    else ValueError, as for a reference mesh with no `mesh` or a `mesh`
    for a reference spec that has none.  An object that is not a
    DeviceMesh raises TypeError."""
    from .api.session import AlignSpec
    from .distributed.sharding import check_mesh
    check_mesh(mesh)
    fields = dict(fields)
    ref_mesh = fields.get("mesh")
    if (ref_mesh is None) != (mesh is None):
        raise ValueError(f"the reference spec's mesh is {ref_mesh!r} but "
                         f"the port's mesh is {mesh!r}: pass the port's "
                         f"DeviceMesh exactly where the reference has a "
                         f"mesh")
    if mesh is not None:
        ref = (tuple(ref_mesh.axis_names), list(dict(ref_mesh.shape).items()))
        port = (tuple(mesh.axis_names), list(mesh.shape.items()))
        if ref != port:
            raise ValueError(f"the port's mesh {port} has other axes or "
                             f"sizes than the reference's {ref}")
    return AlignSpec(**{**fields, "cfg": config_from_reference(fields["cfg"]),
                        "mesh": mesh})


def policy_from_reference(fields: dict):
    """Port GatewayPolicy from ``dataclasses.asdict`` of a reference
    GatewayPolicy: every knob as it is."""
    from .api.gateway import GatewayPolicy
    return GatewayPolicy(**fields)


def mapper_config_from_reference(fields: dict):
    """Port MapperConfig from ``dataclasses.asdict`` of a reference
    MapperConfig: every knob as it is.  The mapper's other state is the
    genome (the same ``uint8`` codes in both packages) and the minimizer
    index built from it."""
    from .mapper.pipeline import MapperConfig
    return MapperConfig(**fields)
