"""The port's int8-compressed all-reduce (``repro_torch.distributed
.collectives``) against the reference's, on the CPU.

The port runs in 4 ``gloo`` processes (``run_ranks``, each with its own
timeout), the reference in one subprocess over 4 virtual JAX devices
(``run_jax``: ``XLA_FLAGS`` set there only, never in this process).
Both sum the same (4, 4097) float32 rows (4,097 pads to 4,100: the
padding path).  Expected: equal element for element (both quantise in
the same float32 order, round half to even); failing that, every
differing element off by at most one quantum of its chunk's scale, with
the count reported.  Both meet the reference's bound against the exact
sum (relative error < 0.05).

``run_ranks`` and ``run_jax`` are the shared helpers of the port's
multi-process tests (``test_torch_train_dp.py``, ``test_torch_reshard.py``).
"""
import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
RANK_TIMEOUT_S = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(code: str, n: int, out_dir, timeout: float = RANK_TIMEOUT_S,
              env: dict | None = None) -> list:
    """Run `code` in `n` processes that form a ``torch.distributed``
    world (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` /
    ``MASTER_PORT`` set; ``OUT`` = `out_dir`), one thread each; every
    process is waited on with `timeout` and killed past it.  Asserts
    every rank exits 0 (its output in the message) and returns their
    standard outputs."""
    base = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS",)}
    base.update(PYTHONPATH=str(ROOT / "src"), MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(_free_port()), WORLD_SIZE=str(n),
                OUT=str(out_dir), OMP_NUM_THREADS="1", **(env or {}))
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(code)], cwd=ROOT,
        env={**base, "RANK": str(r), "LOCAL_RANK": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)]
    outs, failed = [], []
    for r, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
            failed.append((r, "timeout", out[-3000:]))
            continue
        outs.append(out)
        if p.returncode != 0:
            failed.append((r, p.returncode, out[-3000:]))
    assert not failed, failed
    return outs


def run_jax(code: str, n_dev: int, timeout: float = RANK_TIMEOUT_S) -> str:
    """Run reference `code` in a subprocess with `n_dev` virtual CPU
    devices; returns its standard output."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(XLA_FLAGS=f"--xla_force_host_platform_device_count={n_dev}",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=timeout)
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout


N, COLS = 4, 4097


def rows():
    return np.random.default_rng(0).standard_normal((N, COLS)) \
        .astype(np.float32)


_PORT = """
import os, numpy as np, torch, torch.distributed as dist
from repro_torch.distributed.collectives import (compressed_allreduce,
                                                 make_compressed_grad_sync)
dist.init_process_group("gloo")
r = dist.get_rank()
x = np.random.default_rng(0).standard_normal((4, 4097)).astype(np.float32)
out = compressed_allreduce(torch.from_numpy(x[r].copy()))
grads = {"w": torch.from_numpy(x[r, :4096].reshape(64, 64).copy()),
         "b": torch.from_numpy(x[r, :7].copy())}
synced = make_compressed_grad_sync()(grads)
sums = {k: compressed_allreduce(v) for k, v in grads.items()}
pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
pair = compressed_allreduce(torch.from_numpy(x[r].copy()), pairs[r // 2])
torch.save({"out": out, "synced": synced, "sums": sums, "pair": pair},
           os.path.join(os.environ["OUT"], f"rank{r}.pt"))
dist.destroy_process_group()
"""

_REFERENCE = """
import numpy as np, jax
from jax.sharding import PartitionSpec as P
from repro.distributed.collectives import compressed_allreduce
from repro.launch.mesh import make_test_mesh, shard_map
x = np.random.default_rng(0).standard_normal((4, 4097)).astype('f4')
out = []
for n, rows in ((4, x), (2, x[:2]), (2, x[2:])):
    mesh = make_test_mesh((n,), ('data',))
    f = jax.jit(shard_map(
        lambda xs: compressed_allreduce(xs[0], 'data')[None], mesh=mesh,
        in_specs=P('data', None), out_specs=P('data', None), check=False))
    out.append(np.asarray(f(rows)))
np.save(OUT_PATH, np.concatenate(out))
"""


@pytest.fixture(scope="module")
def outcome(tmp_path_factory):
    d = tmp_path_factory.mktemp("collectives")
    run_ranks(_PORT, N, d)
    port = [torch.load(d / f"rank{r}.pt") for r in range(N)]
    ref_path = d / "ref.npy"
    run_jax(_REFERENCE.replace("OUT_PATH", repr(str(ref_path))), N)
    ref = np.load(ref_path)        # the world of 4's rows, then each pair's
    return port, ref[:N], ref[N:]


def test_compressed_allreduce_equals_the_reference(outcome):
    """Every rank's result against the reference's on the device of the
    same index: equal, or (reported) off by at most one quantum of the
    chunk's scale."""
    port, ref, _ = outcome
    x = rows()
    chunk = -(-COLS // N)
    want = x.sum(0)
    for r in range(N):
        got = port[r]["out"].numpy()
        assert got.shape == (COLS,) and got.dtype == np.float32
        diff = got != ref[r]
        if diff.any():
            # one quantum: the all-gathered chunk's scale, max|chunk|/127
            scale = np.repeat([np.abs(want[c * chunk:(c + 1) * chunk])
                               .max() / 127 for c in range(N)], chunk)[:COLS]
            off = np.abs(got - ref[r])[diff] / scale[diff]
            assert off.max() <= 1.0 + 1e-3, (int(diff.sum()), off.max())
            pytest.fail(f"rank {r}: {int(diff.sum())} of {COLS} elements "
                        f"differ (each within one quantum)")
    # every rank gathers the same shards
    for r in range(1, N):
        assert torch.equal(port[r]["out"], port[0]["out"])


def test_compressed_allreduce_meets_the_reference_bound(outcome):
    port, ref, _ = outcome
    want = rows().sum(0)
    for got in [p["out"].numpy() for p in port] + list(ref):
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err < 0.05, err


def test_compressed_grad_sync_averages(outcome):
    """``make_compressed_grad_sync`` gives each gradient's compressed sum
    over the ranks divided by their number, equal on every rank, within
    the ring's bound of the exact mean."""
    port, _, _ = outcome
    x = rows()
    exact = {"w": x[:, :4096].reshape(N, 64, 64).mean(0),
             "b": x[:, :7].mean(0)}
    for p in port:
        for k in ("w", "b"):
            assert torch.equal(p["synced"][k], p["sums"][k] / N)
            assert torch.equal(p["synced"][k], port[0]["synced"][k])
            err = np.abs(p["synced"][k].numpy() - exact[k]).max() \
                / np.abs(exact[k]).max()
            assert err < 0.05, (k, err)


def test_compressed_allreduce_over_a_subgroup(outcome):
    """Two groups of two ranks each ring over their own ranks (the group's
    neighbours by global rank): each result equals the reference over two
    devices holding the same rows."""
    port, _, pairs = outcome
    for r in range(N):
        np.testing.assert_array_equal(port[r]["pair"].numpy(), pairs[r])


@pytest.mark.parametrize("shape", [(7,), (3, 4097), (5, 1)])
def test_quant_dequant_equal_the_reference(shape):
    """``_quant`` / ``_dequant`` on the same float32 input: the same int8
    values and scales, bit for bit, as the reference compiles them (its
    ring only ever runs compiled; XLA turns ``/ 127.0`` into a product
    with the float32 reciprocal)."""
    import jax
    from repro.distributed import collectives as ref
    from repro_torch.distributed import collectives as port
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    x[..., 0] *= 300.0
    q, s = port._quant(torch.from_numpy(x))
    rq, rs = jax.jit(ref._quant)(x)
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(port._dequant(q, s).numpy(),
                                  np.asarray(jax.jit(ref._dequant)(rq, rs)))


def test_a_world_of_one_quantises_once():
    """Over one rank the ring has no hop: the result is ``_dequant`` of
    ``_quant`` of the input (what chip_smoke holds the card to)."""
    code = """
    import os, torch, torch.distributed as dist
    from repro_torch.distributed.collectives import (_dequant, _quant,
                                                     compressed_allreduce)
    dist.init_process_group("gloo")
    x = torch.randn(1000, generator=torch.Generator().manual_seed(3))
    assert torch.equal(compressed_allreduce(x), _dequant(*_quant(x)))
    print("OK")
    """
    assert "OK" in run_ranks(code, 1, ROOT)[0]
