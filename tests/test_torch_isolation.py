"""The port stands alone: importing it (or chip_smoke) pulls in neither JAX
nor the reference package; its entry points run on the card unless the
caller asks for the CPU (the gateway, the engine, the mapper and the
near-duplicate operator too); a kernel wrapper raises on a device it has
neither a kernel nor a plain version for."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.api import plan
from repro_torch.core.aligner import GenASMAligner
from repro_torch.core.config import AlignerConfig
from repro_torch.data.dedup import near_duplicates
from repro_torch.data.genome import synth_genome
from repro_torch.kernels import genasm_dc
from repro_torch.kernels.ops import _to_kernel_layout
from repro_torch.mapper import ReadMapper, xdrop_extend
from repro_torch.serve.engine import AlignmentEngine

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
MODULES = sorted(
    ".".join(p.relative_to(PORT.parent).with_suffix("").parts)
    .removesuffix(".__init__") for p in PORT.rglob("*.py"))

_PROBE = """
import importlib, json, sys
sys.path.insert(0, {src!r})
for name in {modules!r}:
    importlib.import_module(name)
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "repro"))))
"""


def _foreign_modules(modules, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(src=str(ROOT / "src"),
                                             modules=modules)],
        cwd=cwd, env=env, capture_output=True, text=True, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_port_imports_neither_jax_nor_reference():
    assert "repro_torch.kernels.genasm_dc" in MODULES and len(MODULES) >= 14
    assert {"repro_torch.api.session", "repro_torch.obs.metrics",
            "repro_torch.serve.align_step",
            "repro_torch.distributed.sharding", "repro_torch.api.gateway",
            "repro_torch.serve.engine", "repro_torch.mapper",
            "repro_torch.mapper.index", "repro_torch.mapper.chain",
            "repro_torch.mapper.prefilter",
            "repro_torch.mapper.pipeline", "repro_torch.baselines",
            "repro_torch.baselines.myers", "repro_torch.baselines.dp",
            "repro_torch.core.counting", "repro_torch.core.oracle",
            "repro_torch.data.dedup", "repro_torch.serve.graphs",
            "repro_torch.configs.genasm", "repro_torch.analysis.roofline",
            "repro_torch.launch.dryrun_aligner"} <= set(MODULES)
    assert _foreign_modules(MODULES, ROOT) == []


def test_chip_smoke_imports_neither_jax_nor_reference():
    assert _foreign_modules(["chip_smoke"], ROOT) == []


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GenASMAligner()
    with pytest.raises(RuntimeError):
        GenASMAligner(AlignerConfig(), device="cuda")
    assert GenASMAligner(device="cpu").device == torch.device("cpu")


def test_plan_default_device_is_cuda_and_never_falls_back(monkeypatch):
    """The session front door runs on the card unless asked: plan() with
    no device raises where there is no CUDA, before building anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        plan()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        plan(W=16, O=6, k=4, backend="split", device="cuda")
    assert plan(device="cpu").device == torch.device("cpu")


def test_engine_and_mapper_default_to_cuda_and_never_fall_back(
        monkeypatch):
    """AlignmentEngine(), ReadMapper(genome) and near_duplicates(seqs) with
    no device run on the card and raise where there is none; the gateway
    runs on its session's device; the pre-filter refuses the card too."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    genome = synth_genome(20_000, seed=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AlignmentEngine()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ReadMapper(genome)
    reads = np.zeros((2, 8), np.uint8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        xdrop_extend(reads, np.zeros((2, 12), np.uint8), band=4)
    tokens = [np.arange(40), np.arange(40)]
    for seqs in (tokens, []):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            near_duplicates(seqs)
    assert near_duplicates(tokens, device="cpu") == [(0, 1, 0)]
    eng = AlignmentEngine(device="cpu")
    assert eng.aligner.device == torch.device("cpu")
    with eng.gateway() as gw:
        assert gw.session.device == torch.device("cpu")
    with ReadMapper(genome, device="cpu") as m:
        assert m.session.device == torch.device("cpu")
    eng.close()


def _inputs(device="cpu"):
    cfg = AlignerConfig(W=16, O=6, k=4, lane_tile=4)
    codes = torch.zeros((4, 16), dtype=torch.uint8)
    pm, text = _to_kernel_layout(codes, codes, cfg)
    return cfg, pm.to(device), text.to(device)


def test_wrapper_raises_on_unsupported_device():
    cfg, pm, text = _inputs("meta")
    kw = dict(cfg=cfg, commit_limit=cfg.stride, max_ops=cfg.tb_max_ops,
              max_steps=cfg.tb_max_steps)
    before = (dict(genasm_dc.LAUNCHES), dict(genasm_dc.PLAIN_CALLS))
    with pytest.raises(ValueError, match="device meta"):
        genasm_dc.genasm_tb_fused(pm, text, **kw)
    with pytest.raises(ValueError, match="device meta"):
        genasm_dc.genasm_dc(pm, text, cfg=cfg)
    lens = torch.ones((1, 4), dtype=torch.int32, device="meta")
    for wrapper in (genasm_dc.genasm_tail_banded, genasm_dc.genasm_tail_full):
        with pytest.raises(ValueError, match="device meta"):
            wrapper(pm, torch.zeros((32, 4), dtype=torch.int32,
                                    device="meta"), lens, lens, cfg=cfg,
                    n_text=32, commit_limit=64, max_ops=48, max_steps=52)
    assert (dict(genasm_dc.LAUNCHES), dict(genasm_dc.PLAIN_CALLS)) == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity", "devices"])
def test_wrapper_checks_its_inputs(bad):
    cfg, pm, text = _inputs()
    if bad == "dtype":
        pm = pm.to(torch.int64)
    elif bad == "shape":
        text = text[:-1]
    elif bad == "contiguity":
        text = text.T.contiguous().T
    else:
        text = text.to("meta")
    with pytest.raises(ValueError):
        genasm_dc.genasm_tb_fused(pm, text, cfg=cfg, commit_limit=cfg.stride,
                                  max_ops=cfg.tb_max_ops,
                                  max_steps=cfg.tb_max_steps)


def test_cpu_tensors_take_the_plain_version_only():
    cfg, pm, text = _inputs()
    genasm_dc.reset_counts()
    ops, meta = genasm_dc.genasm_tb_fused(pm, text, cfg=cfg,
                                          commit_limit=cfg.stride,
                                          max_ops=cfg.tb_max_ops,
                                          max_steps=cfg.tb_max_steps)
    assert genasm_dc.PLAIN_CALLS == {"tb_fused": 1, "tail_banded": 0,
                                     "tail_full": 0, "dc_band": 0}
    assert set(genasm_dc.LAUNCHES.values()) == {0}
    assert meta[genasm_dc.META_DIST].tolist() == [0, 0, 0, 0]
    assert ops.dtype == meta.dtype == torch.int32
