"""Fault-tolerant training-loop harness, the JAX package's
``checkpoint/fault_tolerance.py`` over the port's ``ckpt``.

``run_resilient`` drives a step function with:
  * periodic checkpointing (ckpt.save, atomic),
  * automatic restart-from-latest on failure (any exception from the step
    fn, or injected via ``FailureInjector`` in tests),
  * a bounded restart budget,
  * straggler mitigation by construction: the data pipeline is
    counter-based (data/pipeline.py), so a restarted job replays step
    k's exact global batch with no data-loader state.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from . import ckpt

__all__ = ["FailureInjector", "RunReport", "run_resilient"]


class FailureInjector:
    """Deterministically raise at the given step numbers (once each)."""

    def __init__(self, fail_at=()):
        self.fail_at = set(fail_at)
        self.fired = set()

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise RuntimeError(f"injected failure at step {step}")


@dataclass
class RunReport:
    steps_run: int = 0
    restarts: int = 0
    checkpoints: int = 0
    wall_time: float = 0.0
    history: list = field(default_factory=list)


def run_resilient(
    init_state_fn: Callable[[], Any],
    step_fn: Callable[[Any, int], tuple],     # (state, step) -> (state, metrics)
    *,
    n_steps: int,
    ckpt_dir: str,
    ckpt_every: int = 10,
    max_restarts: int = 10,
    injector: Optional[FailureInjector] = None,
    verbose: bool = False,
) -> tuple:
    """Returns (final_state, RunReport)."""
    report = RunReport()
    t0 = time.perf_counter()
    restarts = 0
    while True:
        try:
            latest = ckpt.latest_step(ckpt_dir)
            if latest is not None:
                state = ckpt.restore(ckpt_dir, latest, init_state_fn())
                start = latest
                if verbose:
                    print(f"[ft] restored step {latest}")
            else:
                state = init_state_fn()
                start = 0
            for step in range(start, n_steps):
                if injector is not None:
                    injector.maybe_fail(step)
                state, metrics = step_fn(state, step)
                report.steps_run += 1
                report.history.append((step, metrics))
                if (step + 1) % ckpt_every == 0 or step + 1 == n_steps:
                    ckpt.save(ckpt_dir, step + 1, state)
                    report.checkpoints += 1
            break
        except Exception as e:  # noqa: BLE001 — restart on any step failure
            restarts += 1
            report.restarts = restarts
            if restarts > max_restarts:
                raise RuntimeError(
                    f"exceeded restart budget ({max_restarts})"
                ) from e
            if verbose:
                print(f"[ft] failure: {e}; restarting ({restarts})")
    report.wall_time = time.perf_counter() - t0
    return state, report
