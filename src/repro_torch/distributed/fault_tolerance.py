"""Fault tolerance & fleet hygiene for 1000+ node runs.

* :class:`Supervisor` — checkpoint/restart driver: runs the step function,
  checkpoints every N steps, and on failure (hardware fault, preemption)
  restores the latest checkpoint and replays. The data pipeline is
  counter-based (data/pipeline.py), so restart is exactly-once without
  dataloader state.
* :class:`StragglerMonitor` — per-step wall-time tracker with robust z-score
  outlier detection; at scale this drives hot-swap decisions (here: logged +
  surfaced in metrics, and unit-tested on synthetic timings).
* :class:`PreemptionGuard` — cooperative preemption: a flag file (stand-in
  for a host maintenance-event signal) triggers checkpoint-and-exit at the
  next step boundary.
* :class:`LaunchSupervisor` — the :class:`Supervisor`'s restart discipline
  applied to *serving launches* (serve/async_engine.py): a launch is
  stateless-in/stateless-out, so a failed attempt is replayed verbatim
  (exactly-once without checkpoints), wall times feed a
  :class:`StragglerMonitor`, and repeated failures of the preferred
  (resident) mode flip the engine into degraded windowed execution.
"""
from __future__ import annotations

import os
import statistics
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..checkpoint import ckpt


class SimulatedFault(RuntimeError):
    """Raised by tests / chaos hooks to emulate a node failure."""


@dataclass
class StragglerMonitor:
    window: int = 50
    threshold: float = 4.0         # robust z-score (MAD-based)
    times: list[float] = field(default_factory=list)
    flagged: list[tuple[int, float]] = field(default_factory=list)

    def record(self, step: int, seconds: float) -> bool:
        """Returns True if this step is a straggler."""
        self.times.append(seconds)
        if len(self.times) > self.window:
            self.times.pop(0)
        if len(self.times) < 8:
            return False
        med = statistics.median(self.times)
        mad = statistics.median(abs(t - med) for t in self.times) or 1e-9
        z = 0.6745 * (seconds - med) / mad
        if z > self.threshold:
            self.flagged.append((step, seconds))
            return True
        return False


@dataclass
class PreemptionGuard:
    flag_path: str

    def requested(self) -> bool:
        return os.path.exists(self.flag_path)


@dataclass
class LaunchSupervisor:
    """Retry/degrade driver for serving launches.

    ``run(attempt_fn, mode)`` calls ``attempt_fn(attempt)`` up to
    ``max_retries + 1`` times, re-raising the last error when every attempt
    fails.  Launches are pure functions of their request batch, so a replay
    returns bit-identical results — the engine's retry contract.

    Every failure (and every completed launch that overruns ``timeout_s``)
    is a *strike* against its execution mode; once the ``"resident"`` mode
    collects ``degrade_after`` strikes, :attr:`degraded` latches True and
    the engine falls back to windowed execution (a completed-but-slow
    launch still returns its result — the strike only steers future mode
    choice).  Launch walls feed the :class:`StragglerMonitor`, surfacing
    tail launches in :attr:`log` exactly like training steps.
    """
    max_retries: int = 2
    degrade_after: int = 2
    timeout_s: Optional[float] = None
    monitor: StragglerMonitor = field(default_factory=StragglerMonitor)
    launches: int = 0
    retries: int = 0
    failures: int = 0
    mode_failures: dict = field(default_factory=dict)
    degraded: bool = False
    log: list[str] = field(default_factory=list)

    def strike(self, mode: str, reason: str) -> bool:
        """Record one failure/overrun against ``mode``; returns True when
        this strike latched degraded mode."""
        n = self.mode_failures[mode] = self.mode_failures.get(mode, 0) + 1
        self.log.append(f"{mode} strike {n}: {reason}")
        if mode == "resident" and not self.degraded \
                and n >= self.degrade_after:
            self.degraded = True
            self.log.append(
                f"degraded: resident -> windowed after {n} strikes")
            return True
        return False

    def run(self, attempt_fn: Callable, mode: str = "windowed"):
        last = None
        for attempt in range(self.max_retries + 1):
            try:
                t0 = time.monotonic()
                out = attempt_fn(attempt)
                dt = time.monotonic() - t0
            except Exception as e:          # noqa: BLE001 — replay anything
                last = e
                self.failures += 1
                self.strike(mode, f"attempt {attempt}: {e!r}")
                if attempt == self.max_retries:
                    raise
                self.retries += 1
                continue
            self.launches += 1
            if self.monitor.record(self.launches, dt):
                self.log.append(f"straggler launch {self.launches}: "
                                f"{dt:.3f}s")
            if self.timeout_s is not None and dt > self.timeout_s:
                self.strike(mode, f"launch overran timeout "
                                  f"({dt:.3f}s > {self.timeout_s:.3f}s)")
            return out
        raise last                           # pragma: no cover — unreachable


@dataclass
class Supervisor:
    """Checkpoint/restart training driver.

    ``state`` is any tree of tensors (dicts, lists, tuples: params +
    optimizer + anything else), as ``ckpt.save`` flattens it;
    ``step_fn(state, step) -> state`` runs one step and may raise.
    ``run``'s ``devices`` is where a restore puts the state (``ckpt.restore``:
    ``None`` is the card, ``"cpu"`` the host; or a tree of devices or of
    ``sharding.NamedSharding``s, the reference's ``shardings``).
    """
    ckpt_dir: str
    ckpt_every: int = 50
    max_restarts: int = 10
    keep: int = 3
    monitor: StragglerMonitor = field(default_factory=StragglerMonitor)
    preemption: Optional[PreemptionGuard] = None
    restarts: int = 0
    log: list[str] = field(default_factory=list)

    def run(self, state, step_fn: Callable, n_steps: int,
            start_step: int = 0, devices=None):
        step = start_step
        latest = ckpt.latest_step(self.ckpt_dir)
        if latest is not None and latest > step:
            state = ckpt.restore(self.ckpt_dir, latest, state, devices)
            step = latest
            self.log.append(f"resumed from step {latest}")
        while step < n_steps:
            try:
                t0 = time.monotonic()
                state = step_fn(state, step)
                dt = time.monotonic() - t0
                step += 1
                if self.monitor.record(step, dt):
                    self.log.append(f"straggler at step {step}: {dt:.3f}s")
                if step % self.ckpt_every == 0 or step == n_steps:
                    ckpt.save(self.ckpt_dir, step, state, keep=self.keep)
                if self.preemption and self.preemption.requested():
                    ckpt.save(self.ckpt_dir, step, state, keep=self.keep)
                    self.log.append(f"preempted at step {step}")
                    return state, step
            except SimulatedFault as e:
                self.restarts += 1
                self.log.append(f"fault at step {step}: {e}; restart "
                                f"{self.restarts}/{self.max_restarts}")
                if self.restarts > self.max_restarts:
                    raise
                latest = ckpt.latest_step(self.ckpt_dir)
                if latest is None:
                    step = start_step
                    continue
                state = ckpt.restore(self.ckpt_dir, latest, state, devices)
                step = latest
        return state, step
