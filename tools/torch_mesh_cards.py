"""The fused main path on a mesh of every card of the host, against the
same batch unsharded, in one process.

    python3 tools/torch_mesh_cards.py

Builds the kernels, simulates the main path's batch (2,048 x 10 kbp,
``chip_smoke.long_reads``), aligns it unsharded (``chip_smoke``'s phase
``main_path``), then on ``make_test_mesh((n,), ("data",))`` over the
host's n cards and on one card listed n times (``chip_smoke``'s leg (a)
of phase ``mesh``): each equal to the unsharded run field for field,
levels included, one upload and one download, every kernel launched n
times its unsharded count.  Prints the first card's name and power
limit, then ``chip_smoke``'s JSON lines (one a leg: ``ladder_s``,
``decode_s``, pairs/s).  Needs at least two CUDA cards.
"""
from __future__ import annotations

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs                                        # noqa: E402
from repro_torch.launch.mesh import make_test_mesh             # noqa: E402


def main() -> None:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        raise SystemExit(f"torch_mesh_cards: {n} CUDA card(s); needs two "
                         f"or more")
    print(cs.phase_device(), flush=True)
    cs.phase_build()
    cuda = torch.device("cuda", 0)
    rs = cs.long_reads()
    fused, res = cs.phase_main_path(cuda, rs)
    cs._mesh_align(cuda, rs, make_test_mesh((n,), ("data",)), fused, res,
                   f"{n} cards")
    cs._mesh_align(cuda, rs, make_test_mesh((n,), ("data",),
                                            devices=[cuda] * n),
                   fused, res, f"{n} x {cuda}")


if __name__ == "__main__":
    main()
