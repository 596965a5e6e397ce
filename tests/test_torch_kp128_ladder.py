"""The aligner's W = 128 ladder k = 15 -> 30 -> 60 -> 120 (O = 42,
``rescue_rounds=3``), whose last rung runs at the level capacity KP =
128, against the reference: one read carries a 64-base insertion that
only k = 120 aligns (``rounds_run == 4``).  The reference runs its jnp
backend (its Pallas kernels at k = 120 take minutes in interpret mode; its
own tests hold the two equal).  About 100 s on one worker: 78 s of it the
reference's jit of the four-rung ladder, 19 s the port's CPU ladder."""
import jax.numpy as jnp
import numpy as np

from repro.core import windowing as ref_win
from repro.core.aligner import GenASMAligner as RefAligner
from repro_torch.core import windowing
from repro_torch.core.aligner import GenASMAligner
from repro_torch.data.genome import ReadSimConfig, simulate_reads, synth_genome
from repro_torch.kernels import genasm_dc
from tests.test_torch_aligner import assert_results_equal
from tests.test_torch_config import cfg_pair


def test_w128_ladder_to_k120_equals_reference():
    rs = simulate_reads(synth_genome(200_000, seed=7), 3,
                        ReadSimConfig(read_len=250, seed=10))
    reads, refs = list(rs.reads), list(rs.ref_segments)
    burst = np.random.default_rng(5).integers(0, 4, 64).astype(np.uint8)
    mid = len(reads[1]) // 2
    reads[1] = np.concatenate([reads[1][:mid], burst, reads[1][mid:]])
    ref_cfg, cfg = cfg_pair(W=128, O=42, k=15, backend="jnp", lane_tile=4)
    ref = RefAligner(ref_cfg, rescue_rounds=3).align(reads, refs)
    aligner = GenASMAligner(cfg.replace(backend="fused"), rescue_rounds=3,
                            device="cpu")
    before = dict(genasm_dc.PLAIN_CALLS)
    port = aligner.align(reads, refs)
    assert all(genasm_dc.PLAIN_CALLS[name] > before[name]
               for name in ("tb_fused", "tail_banded", "tail_full"))
    assert_results_equal(port, ref)
    assert port.k_used[1] == 120 and not port.failed.any()
    max_len = max(len(r) for r in reads)
    Lr, Lf = windowing.pad_geometry(cfg, max_len, max(len(f) for f in refs),
                                    3)
    arrays = (*GenASMAligner._pad(reads, Lr, windowing.SENTINEL_READ),
              *GenASMAligner._pad(refs, Lf, windowing.SENTINEL_REF))
    want = ref_win.align_pairs_rescued(*map(jnp.asarray, arrays),
                                       cfg=ref_cfg, max_read_len=max_len,
                                       rescue_rounds=3)
    assert aligner.last_run["rounds_run"] == int(want["rounds_run"]) == 4
    assert aligner.last_run["levels_run_total"] == \
        int(want["levels_run_total"])
