"""Fault tolerance (port of ``repro/runtime/ft.py``): a supervised training
loop with checkpoint/restart, failure injection (for tests), and a
step-time straggler watchdog.

Any exception inside a step restores the last checkpoint and replays from
it.  The port's training state is updated in place, so a restore loads
the checkpoint into the model's and optimizer's own tensors
(``checkpoint.restore_checkpoint``); a failure before the first
checkpoint restarts the count at step 0 with the state as it is, as the
reference does.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

from ..checkpoint.ckpt import latest_step, restore_checkpoint, save_checkpoint


class FailureInjector:
    """Deterministically fail at given steps (once each) — tests/demo."""

    def __init__(self, fail_at=()):
        self.fail_at = set(fail_at)
        self.fired = set()

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise RuntimeError(f"[ft-test] injected worker failure @ step {step}")


@dataclasses.dataclass
class Watchdog:
    """Flags steps slower than `factor` x the running median."""
    factor: float = 3.0
    history: list = dataclasses.field(default_factory=list)
    stragglers: list = dataclasses.field(default_factory=list)

    def record(self, step: int, dt: float):
        self.history.append(dt)
        if len(self.history) >= 8:
            med = sorted(self.history[-50:])[len(self.history[-50:]) // 2]
            if dt > self.factor * med:
                self.stragglers.append((step, dt, med))
                return True
        return False


def supervise(train_step: Callable, state, data, *, steps: int,
              ckpt_dir, ckpt_every: int = 50,
              injector: FailureInjector | None = None,
              log_every: int = 10, max_restarts: int = 5):
    """Run `steps` optimizer steps with checkpoint/restart supervision.

    `data` must be indexable by step: a callable step->batch or an object
    with .batch_at(step) (a free-running iterator would desynchronize from
    the step counter after a restore).  Metrics are read (``float``) only
    on log steps.  Returns (state, log: list of dicts, restarts)."""
    data_fn = data.batch_at if hasattr(data, "batch_at") else data
    wd = Watchdog()
    log = []
    step = latest_step(ckpt_dir) or 0
    if step:
        state, step = restore_checkpoint(ckpt_dir, state)
    restarts = 0
    while step < steps:
        try:
            t0 = time.time()
            batch = data_fn(step)
            if injector:
                injector.maybe_fail(step)
            state, metrics = train_step(state, batch)
            # host time: on the card a step returns once its kernels are
            # queued, so dt is this step's dispatch plus whatever wait the
            # batch's upload makes for earlier steps, not its device time
            dt = time.time() - t0
            slow = wd.record(step, dt)
            step += 1
            if step % log_every == 0 or slow:
                rec = {"step": step, "dt": round(dt, 4),
                       **{k: float(v) for k, v in metrics.items()}}
                if slow:
                    rec["straggler"] = True
                log.append(rec)
            if step % ckpt_every == 0:
                save_checkpoint(ckpt_dir, state, step, async_save=False)
        except Exception as e:  # worker failure -> restore and continue
            restarts += 1
            if restarts > max_restarts:
                raise
            last = latest_step(ckpt_dir)
            log.append({"step": step, "event": f"restart({e})",
                        "restored_to": last or 0})
            if last:
                state, step = restore_checkpoint(ckpt_dir, state)
            else:
                step = 0
    return state, log, restarts
