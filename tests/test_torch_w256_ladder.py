"""The aligner's W = 256 ladder k = 30 -> 60 -> 120 -> 240 (O = 96,
``rescue_rounds=3``; KP = 32, 64, 128, 256 at NW = 8), against the
reference: one read carries a 128-base insertion that only k = 240
aligns (``rounds_run == 4``).  The reference runs its jnp backend (its
Pallas kernels in interpret mode take minutes at these k; its own tests
hold the two equal) in a subprocess whose XLA skips its ``fusion`` pass
(``test_torch_kp128.REF_XLA_FLAGS``: its tail's fill at k = 240 would
otherwise take many minutes to compile), while the port's CPU plain path
runs here.  About 70 s on one worker: the reference's subprocess, the
port's ladder beside it."""
import json
import threading
from types import SimpleNamespace

import numpy as np

from repro_torch.core.aligner import GenASMAligner
from repro_torch.data.genome import ReadSimConfig, simulate_reads, synth_genome
from repro_torch.kernels import genasm_dc
from tests.test_torch_aligner import assert_results_equal
from tests.test_torch_config import cfg_pair
from tests.test_torch_kp128 import (few_torch_threads,  # noqa: F401
                                    run_reference)

ROUNDS = 3
RESULT_FIELDS = ("dist", "failed", "k_used", "read_consumed", "ref_consumed")


def _pairs():
    """3 reads of 400 bp; read 1 with a 128-base insertion."""
    rs = simulate_reads(synth_genome(200_000, seed=7), 3,
                        ReadSimConfig(read_len=400, seed=11))
    reads, refs = list(rs.reads), list(rs.ref_segments)
    burst = np.random.default_rng(5).integers(0, 4, 128).astype(np.uint8)
    mid = len(reads[1]) // 2
    reads[1] = np.concatenate([reads[1][:mid], burst, reads[1][mid:]])
    return reads, refs


def _cfgs():
    return cfg_pair(W=256, O=96, k=30, backend="jnp", lane_tile=4)


def ladder_reference(out: str, reads, refs, ref_cfg, rounds: int) -> None:
    """The reference's jnp aligner on (reads, refs) at `ref_cfg`, through
    its own entry point (``GenASMAligner.align``: its padding, its one
    ``align_pairs_rescued`` call, its decode), into the npz `out` (run in
    a subprocess).  ``rounds_run`` and ``levels_run_total`` are read off
    that same call's output, kept by a spy on the aligner module's
    ``align_pairs_rescued``, so the ladder runs once."""
    from repro.core import aligner as ref_aligner
    outputs = []
    run = ref_aligner.align_pairs_rescued

    def spy(*args, **kwargs):
        outputs.append(run(*args, **kwargs))
        return outputs[-1]
    ref_aligner.align_pairs_rescued = spy
    try:
        res = ref_aligner.GenASMAligner(ref_cfg, rescue_rounds=rounds).align(
            reads, refs)
    finally:
        ref_aligner.align_pairs_rescued = run
    (want,) = outputs
    np.savez(out, **{f: np.asarray(getattr(res, f)) for f in RESULT_FIELDS},
             **{f"ops{i}": np.asarray(o) for i, o in enumerate(res.ops)},
             cigars=json.dumps(res.cigars),
             rounds_run=int(want["rounds_run"]),
             levels_run_total=int(want["levels_run_total"]))


def assert_ladder_equals_reference(target: str, out, reads, refs, cfg,
                                   rounds: int, lane: int, k: int) -> None:
    """Run the reference's ladder (``tests.<target>(out)``, a
    ``ladder_reference``) in its subprocess while the port's fused
    aligner runs the same pairs here on the CPU; every ``AlignResult``
    field, ``rounds_run`` (rounds + 1) and ``levels_run_total`` equal,
    K1, K2 and K4's plain versions called, and the burst read `lane`
    aligned at the last rung's `k`."""
    failed = []

    def reference():
        try:
            run_reference(target, out)
        except BaseException as exc:        # re-raised below
            failed.append(exc)
    thread = threading.Thread(target=reference)
    thread.start()
    aligner = GenASMAligner(cfg.replace(backend="fused"),
                            rescue_rounds=rounds, device="cpu")
    before = dict(genasm_dc.PLAIN_CALLS)
    port = aligner.align(reads, refs)
    thread.join()
    if failed:
        raise failed[0]
    assert all(genasm_dc.PLAIN_CALLS[name] > before[name]
               for name in ("tb_fused", "tail_banded", "tail_full"))
    with np.load(out) as f:
        ref = dict(f)
    ref_result = SimpleNamespace(
        **{key: ref[key] for key in RESULT_FIELDS},
        cigars=json.loads(str(ref["cigars"])),
        ops=[ref[f"ops{i}"] for i in range(len(reads))])
    assert_results_equal(port, ref_result)
    assert port.k_used[lane] == k and not port.failed.any()
    assert aligner.last_run["rounds_run"] == int(ref["rounds_run"]) == \
        rounds + 1
    assert aligner.last_run["levels_run_total"] == \
        int(ref["levels_run_total"])


def reference_ladder(out: str) -> None:
    """``ladder_reference`` of this module's pairs and configuration."""
    ladder_reference(out, *_pairs(), _cfgs()[0], ROUNDS)


def test_w256_ladder_to_k240_equals_reference(tmp_path):
    assert_ladder_equals_reference(
        "tests.test_torch_w256_ladder.reference_ladder",
        tmp_path / "ref.npz", *_pairs(), _cfgs()[1], ROUNDS, 1, 240)
