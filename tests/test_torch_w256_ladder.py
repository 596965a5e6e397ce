"""The aligner's W = 256 ladder k = 30 -> 60 -> 120 -> 240 (O = 96,
``rescue_rounds=3``; KP = 32, 64, 128, 256 at NW = 8), against the
reference: one read carries a 128-base insertion that only k = 240
aligns (``rounds_run == 4``).  The reference runs its jnp backend (its
Pallas kernels in interpret mode take minutes at these k; its own tests
hold the two equal) in a subprocess whose XLA skips its ``fusion`` pass
(``test_torch_w256.REF_XLA_FLAGS``: its tail's fill at k = 240 would
otherwise take many minutes to compile), while the port's CPU plain path
runs here.  About 70 s on one worker: the reference's subprocess, the
port's ladder beside it."""
import json
import threading
from types import SimpleNamespace

import numpy as np

from repro_torch.core import windowing
from repro_torch.core.aligner import GenASMAligner
from repro_torch.data.genome import ReadSimConfig, simulate_reads, synth_genome
from repro_torch.kernels import genasm_dc
from tests.test_torch_aligner import assert_results_equal
from tests.test_torch_config import cfg_pair
from tests.test_torch_w256 import run_reference

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


def reference_ladder(out: str) -> None:
    """The reference's jnp aligner on ``_pairs`` and its
    ``align_pairs_rescued`` counts, into the npz `out` (run in a
    subprocess)."""
    import jax.numpy as jnp

    from repro.core import windowing as ref_win
    from repro.core.aligner import GenASMAligner as RefAligner
    reads, refs = _pairs()
    ref_cfg, cfg = _cfgs()
    res = RefAligner(ref_cfg, rescue_rounds=ROUNDS).align(reads, refs)
    max_len = max(len(r) for r in reads)
    Lr, Lf = windowing.pad_geometry(cfg, max_len, max(len(f) for f in refs),
                                    ROUNDS)
    arrays = (*GenASMAligner._pad(reads, Lr, windowing.SENTINEL_READ),
              *GenASMAligner._pad(refs, Lf, windowing.SENTINEL_REF))
    want = ref_win.align_pairs_rescued(*map(jnp.asarray, arrays),
                                       cfg=ref_cfg, max_read_len=max_len,
                                       rescue_rounds=ROUNDS)
    np.savez(out, **{f: np.asarray(getattr(res, f)) for f in RESULT_FIELDS},
             **{f"ops{i}": np.asarray(o) for i, o in enumerate(res.ops)},
             cigars=json.dumps(res.cigars),
             rounds_run=int(want["rounds_run"]),
             levels_run_total=int(want["levels_run_total"]))


def test_w256_ladder_to_k240_equals_reference(tmp_path):
    out = tmp_path / "ref.npz"
    failed = []

    def reference():
        try:
            run_reference("tests.test_torch_w256_ladder.reference_ladder",
                          out)
        except BaseException as exc:        # re-raised below
            failed.append(exc)
    thread = threading.Thread(target=reference)
    thread.start()
    reads, refs = _pairs()
    _, cfg = _cfgs()
    aligner = GenASMAligner(cfg.replace(backend="fused"),
                            rescue_rounds=ROUNDS, device="cpu")
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
    assert port.k_used[1] == 240 and not port.failed.any()
    assert aligner.last_run["rounds_run"] == int(ref["rounds_run"]) == 4
    assert aligner.last_run["levels_run_total"] == \
        int(ref["levels_run_total"])
