"""What carries over from the JAX reference package to this port.

For the aligner there are no learned weights: the state shared by both
packages is the aligner configuration and the encoded inputs.  The inputs
(``uint8`` read and ref codes, see ``core.aligner.encode`` /
``encode_ref``) are numpy arrays both packages take as they are.  The
configuration maps with ``config_from_reference``, a session's spec with
``spec_from_reference``, a gateway's policy with
``policy_from_reference`` and a mapper's configuration with
``mapper_config_from_reference``.

The language models have weights.  A reference ``ModelConfig`` maps with
``model_config_from_reference``, and the reference's parameter tree (its
leaves as numpy arrays, stacked over layers) loads into a port model with
``params_from_reference``; a reference training state (parameters and
AdamW state) becomes the port's with ``state_from_reference``.
"""
from __future__ import annotations

import numpy as np

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


def model_config_from_reference(fields: dict):
    """Port ModelConfig from ``dataclasses.asdict`` of a reference
    ModelConfig: every field as it is."""
    from .models.config import ModelConfig
    fields = dict(fields)
    fields["mrope_sections"] = tuple(fields.get("mrope_sections", ()))
    return ModelConfig(**fields)


def _rows(leaf):
    arr = np.asarray(leaf)
    return [arr[i] for i in range(arr.shape[0])]


def _reference_leaves(tree, path=(), leaf=np.asarray, unstack=_rows):
    """(dotted name, ``leaf(value)``) for each leaf of the reference's
    parameter tree; the leaves of a dict ``layers`` (stacked over layers,
    the reference's ``lax.scan`` layout) split into ``layers.<i>.<name>``
    by ``unstack`` (default: the rows of the array), the entries of a
    tuple ``layers`` (xLSTM) are ``layers.<i>``.  This is the one map of
    the reference's paths onto the port's ``named_parameters()``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            if path == () and k == "layers" and isinstance(v, dict):
                for name, stacked in _reference_leaves(v, (), lambda x: x,
                                                       unstack):
                    for i, one in enumerate(unstack(stacked)):
                        yield f"layers.{i}.{name}", leaf(one)
            else:
                yield from _reference_leaves(v, path + (str(k),), leaf,
                                             unstack)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _reference_leaves(v, path + (str(i),), leaf, unstack)
    else:
        yield ".".join(path), leaf(tree)


def specs_from_reference(param_specs) -> dict:
    """``{port parameter name: spec tuple}`` from the reference's
    ``model.param_specs()`` (its ``ParamSpec`` leaves, read through their
    ``.shape`` and ``.spec``): a stacked layer's spec loses its leading
    layer axis, as the port's per-layer parameters have none."""
    return dict(_reference_leaves(
        param_specs,
        leaf=lambda ps: tuple(ps.spec) if hasattr(ps, "spec") else ps,
        unstack=lambda ps: [tuple(ps.spec[1:])] * ps.shape[0]))


def _leaves_like(model, tree, what: str) -> dict:
    """name -> numpy array of a reference tree shaped like the model's
    parameters; ValueError where the names or shapes differ."""
    state = dict(model.named_parameters())
    leaves = dict(_reference_leaves(tree))
    missing = sorted(set(state) - set(leaves))
    extra = sorted(set(leaves) - set(state))
    if missing or extra:
        raise ValueError(f"the reference {what} does not match "
                         f"{type(model).__name__}({model.cfg.name}): "
                         f"missing {missing[:8]}, unexpected {extra[:8]}")
    bad = [(k, leaves[k].shape, tuple(p.shape)) for k, p in state.items()
           if leaves[k].shape != tuple(p.shape)]
    if bad:
        raise ValueError(f"{what}: shapes differ (name, reference, port): "
                         f"{bad[:8]}")
    return leaves


def params_from_reference(model, tree):
    """Load the reference's parameter tree (``model.init(...)`` of the
    matching reference model, leaves as numpy arrays, float32) into the
    port `model`, cast to its parameters' dtype, and return the model.
    Raises ValueError, and loads nothing, where the names or shapes
    differ from the model's own parameters."""
    import torch
    leaves = _leaves_like(model, tree, "tree")
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(torch.from_numpy(
                np.ascontiguousarray(leaves[k].astype(np.float32))))
    return model


def state_from_reference(model, state_tree):
    """The port's training state (``train.step.init_state``'s layout) from
    the reference's ``{"params", "opt": {"m", "v", "step"}}`` (numpy
    leaves, layers stacked on axis 0, as ``restore_checkpoint`` or
    ``jax.device_get`` give it): the parameters load into `model`
    (``params_from_reference``), the float32 moments and the int32 step
    are made on the model's device.  Raises ValueError, loading nothing,
    where a name or shape differs."""
    import torch
    opt = state_tree["opt"]
    moments = {part: _leaves_like(model, opt[part], f"opt.{part}")
               for part in ("m", "v")}
    params_from_reference(model, state_tree["params"])
    dev = model.device

    def tensor(a, dtype):
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev)
    opt_state = {part: {k: tensor(moments[part][k], torch.float32)
                        for k, _ in model.named_parameters()}
                 for part in ("m", "v")}
    opt_state["step"] = tensor(np.asarray(opt["step"]), torch.int32)
    return {"model": model, "opt": opt_state}
