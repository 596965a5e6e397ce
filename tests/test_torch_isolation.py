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
from repro_torch.data.tokens import TokenStream, to_device
from repro_torch.models.registry import (ARCH_IDS, get_config, get_model,
                                         tiny_config)
from repro_torch.serve.kvcache import greedy_generate
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
            "repro_torch.launch.dryrun_aligner",
            "repro_torch.models.config", "repro_torch.models.common",
            "repro_torch.models.attention", "repro_torch.models.moe",
            "repro_torch.models.transformer", "repro_torch.models.mamba2",
            "repro_torch.models.zamba2", "repro_torch.models.xlstm",
            "repro_torch.models.xlstm_lm", "repro_torch.models.registry",
            "repro_torch.serve.kvcache", "repro_torch.data.tokens",
            "repro_torch.configs.granite_3_2b",
            "repro_torch.configs.zamba2_2_7b", "repro_torch.optim.adamw",
            "repro_torch.train.step", "repro_torch.checkpoint.ckpt",
            "repro_torch.runtime.ft", "repro_torch.runtime.elastic",
            "repro_torch.launch.train",
            "repro_torch.distributed.collectives",
            "repro_torch.launch.dryrun"} <= set(MODULES)
    assert {f"repro_torch.configs.{a.replace('-', '_').replace('.', '_')}"
            for a in ARCH_IDS} <= set(MODULES)
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


def test_lm_serving_defaults_to_cuda_and_never_falls_back(monkeypatch):
    """get_model() and to_device() with no device build on the card and
    raise where there is none; greedy_generate runs on its model's
    device and raises for a model on a card that is not there, never
    moving to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_config(get_config("llama3.2-1b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model("granite-3-2b", device="cuda")
    batch = TokenStream(cfg.vocab, 2, 6).batch_at(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        to_device(batch)
    model = get_model(cfg, device="cpu")
    assert model.device == torch.device("cpu")
    out = greedy_generate(model, batch["tokens"], n_new=2, max_len=8)
    assert out.device == torch.device("cpu") and out.shape == (2, 2)
    monkeypatch.setattr(type(model), "device",
                        property(lambda self: torch.device("cuda", 0)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        greedy_generate(model, batch["tokens"], n_new=2, max_len=8)


def test_lm_training_defaults_to_cuda_and_never_falls_back(monkeypatch,
                                                          tmp_path):
    """``python -m repro_torch.launch.train`` without ``--device cpu``
    and ``make_elastic_mesh()`` without devices run on the card and raise
    where there is none, before building or writing anything."""
    from repro_torch.launch.train import main as train_main
    from repro_torch.runtime.elastic import make_elastic_mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--tiny", "--steps", "1", "--ckpt-dir", str(tmp_path / "ck")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_main(argv)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_elastic_mesh()
    assert not (tmp_path / "ck").exists()
    assert make_elastic_mesh(devices=["cpu"]).shape == {"data": 1,
                                                        "model": 1}


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
