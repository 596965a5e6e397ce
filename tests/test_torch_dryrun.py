"""The LM dry run in the port (``repro_torch.launch.dryrun``, the registry's
``input_specs``, the models' ``abstract_cache``) against the reference's,
on the CPU and on the ``meta`` device (nothing allocated).

``input_specs`` and ``abstract_cache`` give the reference's shapes and
dtypes for every architecture x shape cell, tiny and full;
``_active_params`` and ``model_flops`` equal the reference's at full
size; ``FlopCounterMode`` counts a matmul exactly, and a full-depth count
equals the reference's two-point extrapolation where the depth is a
whole number of depth units (xLSTM-125M's 12 layers over a unit of 8 is
not, and there the extrapolation misses the exact count); ``run_cell``
finishes for every tiny cell, ``long_500k`` skipped as in the reference.
"""
import json

import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils import _pytree
from torch.utils.flop_counter import FlopCounterMode

from test_torch_reshard import ref_dryrun

from repro.analysis import roofline as ref_roofline
from repro.models import registry as ref_registry
from repro_torch.analysis import roofline
from repro_torch.launch import dryrun
from repro_torch.models import registry

DTYPES = {jnp.int32: torch.int32, jnp.bfloat16: torch.bfloat16,
          jnp.float32: torch.float32}
CELLS = [(a, s) for a in registry.ARCH_IDS for s in registry.SHAPES]


def _leaves(tree, flatten, keystr):
    return {keystr(p).replace("'", "").replace('"', "").replace(".", ""):
            (tuple(t.shape), t.dtype) for p, t in flatten(tree)[0]}


@pytest.mark.parametrize("tiny", [False, True], ids=["full", "tiny"])
@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_equal_the_reference(arch, shape, tiny):
    cfg = registry.get_config(arch)
    ref_cfg = ref_registry.get_config(arch)
    if not registry.shape_applicable(cfg, shape):
        assert not ref_registry.shape_applicable(ref_cfg, shape)
        return
    got = registry.input_specs(cfg, shape, tiny=tiny)
    want = ref_registry.input_specs(ref_cfg, shape, tiny=tiny)
    assert set(got) == set(want)
    assert set(got["batch"]) == set(want["batch"])
    for k, t in got["batch"].items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(want["batch"][k].shape), k
        assert t.dtype == DTYPES[want["batch"][k].dtype.type], k
    if "cache" in want:
        g = _leaves(got["cache"], _pytree.tree_flatten_with_path,
                    _pytree.keystr)
        w = _leaves(want["cache"], jax.tree_util.tree_flatten_with_path,
                    jax.tree_util.keystr)
        assert {k: s for k, (s, _) in g.items()} == \
            {k: s for k, (s, _) in w.items()}
        assert {k: d for k, (_, d) in g.items()} == \
            {k: DTYPES[d.type] for k, (_, d) in w.items()}
        assert all(t.device.type == "meta"
                   for t in _pytree.tree_leaves(got["cache"]))


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_active_params_and_model_flops_equal_the_reference(arch):
    rd = ref_dryrun()
    cfg = registry.get_config(arch)
    model = registry.get_model(cfg, device="meta")
    ref_cfg = ref_registry.get_config(arch)
    want = rd._active_params(ref_registry.get_model(ref_cfg), ref_cfg)
    got = dryrun._active_params(model, cfg)
    assert got == want
    assert roofline.count_params(model) == ref_roofline.count_params(
        ref_registry.get_model(ref_cfg).abstract_params())
    for train in (True, False):
        assert roofline.model_flops(got, 4096 * 256, train) == \
            ref_roofline.model_flops(want, 4096 * 256, train)


def test_flop_counter_counts_a_matmul_exactly():
    a = torch.empty((64, 128), device="meta")
    b = torch.empty((128, 32), device="meta")
    with FlopCounterMode(display=False) as fc:
        torch.einsum("mk,kn->mn", a, b)
    assert fc.get_total_flops() == 2 * 64 * 128 * 32


@pytest.mark.parametrize("arch,shape", [("llama3.2-1b", "train_4k"),
                                        ("gemma2-2b", "prefill_32k"),
                                        ("zamba2-2.7b", "decode_32k"),
                                        ("xlstm-125m", "decode_32k")])
def test_full_depth_flops_equal_the_two_point_extrapolation(arch, shape):
    """At full size: the exact full-depth count against the reference's
    two-point extrapolation from ``depth_unit`` and twice it."""
    rec = dryrun.run_cell(arch, shape)
    roof = rec["roofline"]
    full, extrap = rec["cost_per_card"]["flops"], roof["extrapolated_flops"]
    cfg = registry.get_config(arch)
    assert full > 0 and len(roof["cost_points"]) == 2
    if cfg.n_layers % dryrun.depth_unit(cfg) == 0:
        assert extrap == full
    else:
        assert extrap != full
    assert roof["flops_global"] == full * rec["cards"]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_run_cell_finishes_on_meta_for_every_tiny_cell(arch, shape, tmp_path):
    rec = dryrun.run_cell(arch, shape, out_dir=tmp_path, tiny=True)
    saved = json.loads((tmp_path / f"{arch}__{shape}.json").read_text())
    assert saved == json.loads(json.dumps(rec))
    if not registry.shape_applicable(registry.get_config(arch), shape):
        assert rec == ref_dryrun().run_cell(arch, shape)
        return
    roof, mem = rec["roofline"], rec["memory"]
    assert roof["dominant"] in ("compute", "memory", "collective")
    assert roof["bound_s"] == max(roof["compute_s"], roof["memory_s"],
                                  roof["collective_s"])
    assert rec["cost_per_card"]["flops"] > 0
    assert rec["cost_per_card"]["bytes_upper_bound"] > 0
    for part in ("replicated", "sharded"):
        assert mem[part]["total_bytes"] > 0
        assert mem["fits"][part] is (mem[part]["total_bytes"] <= 80e9)
    assert mem["sharded"]["total_bytes"] <= mem["replicated"]["total_bytes"]
    if rec["kind"] == "train":
        assert roof["coll_wire_bytes_per_card"] == pytest.approx(
            2 * 7 / 8 * 4 * roof["n_params"])
        assert roof["int8_ring_bytes_per_card"] < \
            roof["coll_wire_bytes_per_card"] / 3
    else:
        assert roof["coll_wire_bytes_per_card"] == 0


@pytest.mark.parametrize("arch,shape", [("llama3.2-1b", "train_4k"),
                                        ("olmoe-1b-7b", "prefill_32k"),
                                        ("granite-3-2b", "decode_32k")])
def test_roofline_memory_term_is_a_lower_bound(arch, shape):
    """The roofline's memory term is the bytes a card's step must move at
    the least (train: AdamW's 7 x 4 B a parameter; serving: the bfloat16
    weights a token meets and the card's cache once; the batch shard
    once), so ``bound_s`` is a lower bound on the step; the unfused
    dispatch count stays outside it, as ``memory_upper_s``."""
    rec = dryrun.run_cell(arch, shape, tiny=True)
    roof = rec["roofline"]
    lower = roof["bytes_lower_bound"]
    if rec["kind"] == "train":
        assert lower["state_bytes"] == 28 * roof["n_params"]
    else:
        assert lower["weight_bytes"] == 2 * roof["n_active_params"]
        assert lower["cache_bytes"] > 0
    assert lower["batch_bytes"] > 0
    assert lower["total_bytes"] == sum(v for k, v in lower.items()
                                       if k != "total_bytes")
    assert roof["memory_s"] == pytest.approx(
        lower["total_bytes"] / roofline.HBM_BW)
    assert roof["memory_upper_s"] == pytest.approx(
        roof["bytes_upper_bound_global"] / (rec["cards"] * roofline.HBM_BW))
    assert lower["total_bytes"] < rec["cost_per_card"]["bytes_upper_bound"]
    assert roof["bound_s"] == max(roof["compute_s"], roof["memory_s"],
                                  roof["collective_s"])
