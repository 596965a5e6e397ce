"""The aligner's dry run in the port (``repro_torch.launch.dryrun_aligner``)
on the CPU: its analytic terms equal hand-computed values and the
reference's integer-op model (``repro/launch/dryrun_aligner.py``:
``(batch / chips) * windows * avg_levels * W * words * OPS_PER_CELL``) at
the same inputs, with the H100's INT32 and HBM3 rates; the memory term is
the step's inputs and outputs; and the command writes its JSON.  The
reference module is read, not imported: importing it sets XLA_FLAGS for
the whole process."""
import ast
import json
from pathlib import Path

import pytest

from repro.core.config import AlignerConfig as RefConfig
from repro.core.windowing import n_main_windows as ref_n_main_windows
from repro_torch.core.config import AlignerConfig
from repro_torch.launch import dryrun_aligner

REF = Path(__file__).resolve().parents[1] / "src/repro/launch/dryrun_aligner.py"
INT32_OPS = 132 * 64 * 1.98e9


def _ref_constants() -> dict:
    tree = ast.parse(REF.read_text())
    return {t.id: ast.literal_eval(node.value) for node in tree.body
            if isinstance(node, ast.Assign) for t in node.targets
            if isinstance(t, ast.Name) and t.id in ("OPS_PER_CELL",
                                                    "VPU_INT_OPS")}


def _ref_ops(batch, chips, read_len, ref_cfg, banded):
    """The reference's integer-op model, as aligner_cell computes it."""
    n_win = ref_n_main_windows(read_len, ref_cfg) + 1
    avg = 7.0 if ref_cfg.early_term else ref_cfg.k + 1
    nw = ref_cfg.nwb if banded else ref_cfg.nw
    return (batch / chips) * n_win * avg * ref_cfg.W * nw * \
        _ref_constants()["OPS_PER_CELL"]


def test_ops_per_cell_is_the_reference_s():
    assert dryrun_aligner.OPS_PER_CELL == _ref_constants()["OPS_PER_CELL"] \
        == 14


@pytest.mark.parametrize("fields", [{}, dict(early_term=False),
                                    dict(W=128, O=48, k=24)])
@pytest.mark.parametrize("banded", [False, True])
def test_analytic_terms_equal_the_reference_model(fields, banded):
    cfg, ref_cfg = AlignerConfig(**fields), RefConfig(**fields)
    t = dryrun_aligner.analytic_terms(512, 10_000, cfg, banded)
    ops = _ref_ops(131_072, 256, 10_000, ref_cfg, banded)
    assert t["int_ops_per_chip"] == pytest.approx(ops, rel=1e-12)
    assert t["compute_s"] == pytest.approx(ops / INT32_OPS, rel=1e-12)
    assert t["collective_s"] == 0.0
    assert t["windows_per_pair"] == ref_n_main_windows(10_000, ref_cfg) + 1


def test_analytic_terms_by_hand():
    """W=64, k=12, ET: 250 windows of a 10 kbp read, 7 levels, 2 words
    (the band: 1 word); 2 cards halve the per-card work."""
    cfg = AlignerConfig()
    t = dryrun_aligner.analytic_terms(512, 10_000, cfg)
    assert t["int_ops_per_chip"] == 512 * 250 * 7 * 64 * 2 * 14
    tb = dryrun_aligner.analytic_terms(512, 10_000, cfg, banded_compute=True,
                                       chips=2)
    assert tb["int_ops_per_chip"] == 256 * 250 * 7 * 64 * 1 * 14
    # inputs: reads (512, 10,065) and refs (512, 13,000 + 64 + 112 + 1)
    # uint8, two int32 lengths; outputs: the op budget and 17 B a lane
    budget = 249 * (40 + 12) + 64 + 112
    want = 512 * (10_065 + 13_177 + 8) + 512 * (budget + 17)
    assert dryrun_aligner.step_bytes(512, 10_000, cfg) == want
    assert t["memory_s"] == pytest.approx(want / 3.35e12, rel=1e-12)
    assert t["dominant"] == "compute"


def test_dry_run_writes_its_record(tmp_path, capsys):
    dryrun_aligner.main(["--device", "cpu", "--batch", "128", "--read-len",
                         "300", "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "genasm-aligner__cpu.json").read_text())
    assert rec["shape"] == "b128_L300" and rec["chips"] == 1
    assert rec["memory"]["temp_bytes"] is None      # no graph on the CPU
    assert rec["memory"]["argument_bytes"] == 128 * (300 + 65 + 390 + 177) \
        + 2 * 128 * 4
    assert rec["roofline"]["collective_s"] == 0.0
    assert "[ok] aligner b128_L300" in capsys.readouterr().out
