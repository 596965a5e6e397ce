"""The port's example twins (``examples/torch_*.py``) run end to end on
the CPU at a tiny size (``--device cpu``, a small batch pad unit), each
in this process, with its own asserts: the quickstart aligns every read,
the long-read driver aligns every true locus and builds nothing in its
steady pass, the mapper keeps ``map_reads.py``'s floors (recall >= 95 %,
no read at a decoy, kill rate > 0.2), the service demo serves its
stream and its two gateway tenants with nothing expired, and the LM
trainer takes a few supervised steps."""
import runpy
import sys
from pathlib import Path

import pytest

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"

TILE = ["--lane-tile", "4"]
RUNS = {
    "torch_quickstart.py": [*TILE, "--reads", "2", "--len", "300"],
    "torch_align_longreads.py": [*TILE, "--reads", "2", "--len", "300",
                                 "--genome", "50000", "--W", "32"],
    "torch_map_reads.py": [*TILE, "--fast"],
    "torch_serve_alignment.py": [*TILE, "--fast", "--requests", "6",
                                 "--len", "200", "--gateway",
                                 "--metrics-dump"],
    "torch_train_lm.py": ["--steps", "3"],
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_example_runs_on_the_cpu(name, monkeypatch, capsys):
    argv = [name, "--device", "cpu", *RUNS[name]]
    monkeypatch.setattr(sys, "argv", argv)
    runpy.run_path(str(EXAMPLES / name), run_name="__main__")
    out = capsys.readouterr().out
    assert "on cpu" in out
    if name == "torch_map_reads.py":
        assert out.rstrip().endswith("OK")
    if name == "torch_train_lm.py":
        assert "done: 3 steps, 0 restarts" in out
    if name == "torch_serve_alignment.py":
        assert "session_requests_total" in out
        assert "gateway_completed_total" in out
