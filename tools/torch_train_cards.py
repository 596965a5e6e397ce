"""Data-parallel training over every card of the host, one rank a card
over NCCL, against a world of one.

    python3 tools/torch_train_cards.py

Starts the same ranks (``chip_smoke.py --train-dp-child cards`` under
``torch.distributed.run --standalone``) at world 1 and at world n over the
host's n cards.  Each world first sums one float32 vector of 2^28
elements with ``dist.all_reduce`` and with the int8 ring of
``distributed.collectives`` (device ms, median of 5): the ring's error
against the exact sum within the reference test's 0.05, and both bus
rates (2 (n - 1) / n of the bytes each carries over the time) beside the
card's NVLink rate.  Then it trains ``chip_smoke.DP_CARDS_ARGS`` through
``launch.train.main``: Llama-3.2-1B at full width and depth in float32
compute, 4 steps of a global 8 x 512 tokens, which 1, 2, 4 and 8 ranks
divide.  World n's losses are held within 1e-5 relative of world 1's
(the other sum order of the gradients, float32 rounding only; leg (b) of
phase ``train_dp`` holds the same bound), and every rank's replica is
bit-identical (``train.step.replica_digest``).  Then the model axis
(``chip_smoke.py --train-dp-child cards_mp``): the same run with
``--model-parallel M`` for each M of ``chip_smoke.mp_cards_axes`` ((1, 4)
and (2, 2) on four cards), the state sharded and the compute split over
``model``, each held to world 1's losses within the same bound, the
ranks that hold a block bit-identical (``train.step.replicas_agree``),
each rank's state bytes equal to the dry run's ``sharded.state_bytes``,
with the ``model`` all-reduce's bus GB/s (one activation, a data rank's
tokens x d_model in float32, median of 5) and each step's collective
ms.  Prints the first card's name and power limit, then one JSON line a
leg.  Refuses to run on fewer than two cards.
"""
from __future__ import annotations

import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs                                        # noqa: E402
from repro_torch.train.step import replicas_agree              # noqa: E402

#: world n's losses against world 1's, float32 compute
LOSS_RTOL = cs.DP_TOL["rtol"]


def run(device: torch.device, n: int, tiny: bool = False) -> None:
    """The two legs on `n` ranks of `device` (the CPU with `tiny`: a
    rehearsal over gloo)."""
    with tempfile.TemporaryDirectory() as tmp:
        one = cs._run_leg("cards", 1, Path(tmp), device, tiny)["a"]
    with tempfile.TemporaryDirectory() as tmp:
        many = cs._run_leg("cards", n, Path(tmp), device, tiny)
    ring, a = many["ring"], many["a"]
    cs.emit("train_cards", leg="ring", world=n, **ring)
    want, got = cs._losses(one), cs._losses(a)
    rel = cs._max_rel(got, want)
    same = all(d == a["digests"][0] for d in a["digests"])
    warm = sorted(a["step_ms"][1:])[len(a["step_ms"][1:]) // 2]
    tokens = a["tokens"] // len(a["step_ms"])
    cs.emit("train_cards", leg="a", world=n, losses=got, world1_losses=want,
            loss_rel_err=rel, tol=LOSS_RTOL, replicas_bit_identical=same,
            step_ms=a["step_ms"], warm_step_ms=warm,
            tokens_per_s=tokens / warm * 1e3, sync_ms=a["sync_ms"],
            peak_memory_bytes=a["peak_memory_bytes"],
            world1_step_ms=one["step_ms"])
    if rel > LOSS_RTOL or not same or ring["rel_err"] >= 0.05:
        raise SystemExit("torch_train_cards: a check failed")
    with tempfile.TemporaryDirectory() as tmp:
        mp = cs._run_leg("cards_mp", n, Path(tmp), device, tiny)
    bad = []
    for mesh, row in mp.items():
        if not isinstance(row, dict):       # the leg's seconds
            continue
        run_ = row.pop("run")
        got = cs._losses(run_)
        rel = cs._max_rel(got, want)
        agree = replicas_agree(run_["digests"])
        cs.emit("train_cards", leg="model_axis", mesh=run_["mesh"],
                losses=got, world1_losses=want, loss_rel_err=rel,
                tol=LOSS_RTOL, replicas_agree=agree,
                state_bytes=run_["state_bytes"],
                dryrun_state_bytes=run_["dryrun_state_bytes"],
                step_ms=run_["step_ms"],
                collective_ms=run_["collective_ms"], paths=run_["paths"],
                peak_memory_bytes=run_["peak_memory_bytes"], **row)
        if rel > LOSS_RTOL or not agree or \
                run_["state_bytes"] != run_["dryrun_state_bytes"]:
            bad.append(mesh)
    if bad:
        raise SystemExit(f"torch_train_cards: model axis {bad} failed")


def main() -> None:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        raise SystemExit(f"torch_train_cards: {n} CUDA card(s); needs two "
                         f"or more")
    print(cs.phase_device(), flush=True)
    run(torch.device("cuda"), n)


if __name__ == "__main__":
    main()
