"""The port's CIGAR helpers and transfer counts against the reference:
``pack_ops`` / ``unpack_ops`` equal ``repro.core.cigar``'s, ``decode_batch``
with and without ``k_used`` (``default_k``) equals the reference's, and
the process-wide transfer counts of the port's ``GenASMAligner`` and
session follow the reference's contract: one upload and one download per
device-mode batch however many rescue rounds run, one of each per executed
round of the host loop, and in the session one of each per dispatch plus
one of each per compacted rescue-rung dispatch."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import plan as ref_plan
from repro.core import transfer as ref_transfer
from repro.core.aligner import GenASMAligner as RefAligner
from repro.core.cigar import decode_batch as ref_decode_batch
from repro.core.cigar import pack_ops as ref_pack_ops
from repro.core.cigar import records_from_state as ref_records
from repro.core.cigar import unpack_ops as ref_unpack_ops
from repro_torch.api import plan
from repro_torch.convert import config_from_reference
from repro_torch.core import transfer
from repro_torch.core.aligner import GenASMAligner
from repro_torch.core.cigar import (decode_batch, pack_ops,
                                    records_from_state, unpack_ops)
from repro_torch.core.oracle import OP_NONE
from tests.test_rescue import CFG as RCFG, _mk_corpus

RESCUE_ROUNDS = 1       # the decoy fails k=2 and k=4: both rounds run


@pytest.mark.parametrize("width", [1, 15, 16, 17, 80])
def test_pack_unpack_equal_reference(width):
    rng = np.random.default_rng(width)
    B = 6
    n_ops = rng.integers(0, width + 1, B)
    rows = np.full((B, width), OP_NONE, np.uint8)
    for i, n in enumerate(n_ops):
        rows[i, :n] = rng.integers(0, 4, n)
    packed = pack_ops(torch.from_numpy(rows))
    ref = np.asarray(ref_pack_ops(jnp.asarray(rows)))
    assert packed.dtype == torch.uint32
    np.testing.assert_array_equal(packed.numpy(), ref)
    out = unpack_ops(packed.numpy(), n_ops)
    for a, b, row, n in zip(out, ref_unpack_ops(ref, n_ops), rows, n_ops):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, row[:n])


@pytest.mark.parametrize("with_k_used", [True, False])
def test_decode_batch_equals_reference(with_k_used):
    """A downloaded output dict of 7 lanes (2 failed), decoded for its
    first 5: the same state and the same records; without ``k_used`` the
    solved lanes take ``default_k``."""
    rng = np.random.default_rng(3)
    B, width = 7, 20
    host = {"ops": rng.integers(0, 4, (B, width)).astype(np.uint8),
            "n_ops": rng.integers(0, width + 1, B).astype(np.int32),
            "dist": rng.integers(0, 9, B).astype(np.int32),
            "failed": np.array([0, 1, 0, 0, 1, 0, 1], bool),
            "read_consumed": rng.integers(0, 50, B).astype(np.int32),
            "ref_consumed": rng.integers(0, 50, B).astype(np.int32)}
    if with_k_used:
        host["k_used"] = rng.integers(1, 9, B).astype(np.int32)
    port = decode_batch(host, 5, 12)
    ref = ref_decode_batch(host, 5, 12)
    for a, b in zip(port[:5], ref[:5]):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    for a, b in zip(port[5], ref[5]):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    if not with_k_used:
        assert list(port[2]) == [12, 0, 12, 12, 0]
    recs, ref_recs = records_from_state(*port), ref_records(*ref)
    for a, b in zip(recs, ref_recs):
        np.testing.assert_array_equal(a.pop("ops"), b.pop("ops"))
        assert a == b


@pytest.fixture(scope="module")
def corpus():
    reads, refs = _mk_corpus(seed=5, n=4)
    return reads + [reads[0]], refs + [refs[-1]]


def _counts(stats):
    return stats.h2d_calls, stats.d2h_calls


def test_aligner_transfers_follow_reference_contract(corpus):
    reads, refs = corpus
    cfg = config_from_reference(dataclasses.asdict(RCFG))
    counts = {}
    for mode in ("device", "host"):
        ref_transfer.reset()
        RefAligner(RCFG, rescue_rounds=RESCUE_ROUNDS,
                   rescue_mode=mode).align(reads, refs)
        transfer.reset()
        aligner = GenASMAligner(cfg, rescue_rounds=RESCUE_ROUNDS,
                                rescue_mode=mode, device="cpu")
        aligner.align(reads, refs)
        port = transfer.stats()
        assert _counts(port) == _counts(ref_transfer.stats())
        # the aligner's own counts feed the same process-wide family
        assert (port.h2d_calls, port.h2d_bytes, port.d2h_calls,
                port.d2h_bytes) == (aligner.transfers.h2d_calls,
                                    aligner.transfers.h2d_bytes,
                                    aligner.transfers.d2h_calls,
                                    aligner.transfers.d2h_bytes)
        counts[mode] = _counts(port)
    assert counts == {"device": (1, 1), "host": (2, 2)}


@pytest.mark.parametrize("rescue_mode", ["device", "bucket"])
def test_session_transfers_follow_reference_contract(corpus, rescue_mode):
    """One dispatch of the 5 pairs: 1 upload + 1 download in device mode;
    in bucket mode one more of each per rescue-rung dispatch (the decoy
    keeps both rungs of the ladder alive)."""
    reads, refs = corpus
    kw = dict(rescue_rounds=RESCUE_ROUNDS, rescue_mode=rescue_mode,
              batch_lanes=len(reads), cache="private")
    ref_transfer.reset()
    ref_s = ref_plan(RCFG, **kw)
    ref_res = ref_s.align(reads, refs)
    ref_counts = _counts(ref_transfer.stats())
    transfer.reset()
    s = plan(config_from_reference(dataclasses.asdict(RCFG)), device="cpu",
             **kw)
    res = s.align(reads, refs)
    assert _counts(transfer.stats()) == ref_counts
    n = s.stats["dispatches"] + s.stats["rescue_dispatches"]
    assert ref_counts == (n, n)
    assert s.stats["dispatches"] == 1
    assert s.stats["rescue_dispatches"] == \
        (RESCUE_ROUNDS if rescue_mode == "bucket" else 0)
    assert res.cigars == ref_res.cigars and res.failed[-1]
