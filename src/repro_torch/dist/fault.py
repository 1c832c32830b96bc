"""Fault tolerance (the port of `repro.dist.fault`).

  RestartManager   periodic checkpoints + restart-from-latest; survives
                   kill -9 because every committed save is atomic and the
                   manager never trusts uncommitted state.
  StepWatchdog     flags straggler steps against a running mean.
  reshard_restore  elastic recovery: a checkpoint written under one mesh
                   restores bit-identically onto another (ranks lost or
                   added) by placing the host leaves with the target
                   mesh's DTensor placements (`dist.sharding`).
  HealthTracker    strike/drain/probation/recovery state machine for one
                   replica-like unit, the health primitive behind the
                   `SlotScheduler`'s failover (the serving counterpart of
                   RestartManager's training-side role).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional, Tuple

from repro_torch.convert import tree_map
from repro_torch.dist import checkpoint


@dataclass
class HealthConfig:
    """Knobs for one HealthTracker.

    `max_strikes` failures drain the unit; each success forgives
    `strike_decay` strikes, so transient errors don't accumulate forever.
    A drained unit becomes probe-eligible after `cooldown_s`; every failed
    probe multiplies the cooldown by `cooldown_backoff` (capped at
    `cooldown_max_s`), and after `max_probes` failed probes the unit is
    `exhausted` — permanently out of service (None = keep probing)."""
    max_strikes: int = 2
    strike_decay: int = 1
    cooldown_s: float = 0.25
    cooldown_backoff: float = 2.0
    cooldown_max_s: float = 30.0
    max_probes: Optional[int] = 8


class HealthTracker:
    """HEALTHY -> (strikes) DRAINED -> (cooldown) PROBING -> HEALTHY.

    One tracker per replica-like unit. `record_failure()` adds a strike
    and reports whether the unit just drained; `record_success()` decays
    strikes and, while probing, recovers the unit. `probe_due()` /
    `begin_probe()` gate the single canary a drained unit must pass to
    re-enter service — a unit is never lost forever unless its probe
    budget is exhausted. The clock is injectable so tests can drive the
    state machine deterministically."""

    HEALTHY, DRAINED, PROBING = "healthy", "drained", "probing"

    def __init__(self, cfg: Optional[HealthConfig] = None,
                 clock: Callable[[], float] = time.perf_counter):
        self.cfg = cfg or HealthConfig()
        self.clock = clock
        self.state = self.HEALTHY
        self.strikes = 0
        self.probes = 0              # probes attempted
        self.drains = 0
        self.recoveries = 0
        self._cooldown_s = self.cfg.cooldown_s
        self._next_probe_s = 0.0

    @property
    def healthy(self) -> bool:
        """Fully in service (probing units carry only their canary)."""
        return self.state == self.HEALTHY

    @property
    def exhausted(self) -> bool:
        """Drained with no probe budget left: permanently out."""
        return (self.state == self.DRAINED
                and self.cfg.max_probes is not None
                and self.probes >= self.cfg.max_probes)

    def record_success(self) -> bool:
        """One unit of successful work; returns True when this success
        recovered a probing unit back to HEALTHY."""
        if self.state == self.PROBING:
            self.state = self.HEALTHY
            self.strikes = 0
            self.probes = 0          # fresh probe budget after recovery
            self._cooldown_s = self.cfg.cooldown_s
            self.recoveries += 1
            return True
        self.strikes = max(0, self.strikes - self.cfg.strike_decay)
        return False

    def record_failure(self) -> bool:
        """One failure; returns True when the unit just drained (the
        caller should re-queue its in-flight work). A failure while
        probing always drains and backs off the next probe."""
        if self.state == self.PROBING:
            self._drain(backoff=True)
            return True
        self.strikes += 1
        if self.state == self.HEALTHY and self.strikes >= self.cfg.max_strikes:
            self._drain(backoff=False)
            return True
        return False

    def _drain(self, *, backoff: bool) -> None:
        self.state = self.DRAINED
        self.drains += 1
        if backoff:
            self._cooldown_s = min(self._cooldown_s * self.cfg.cooldown_backoff,
                                   self.cfg.cooldown_max_s)
        self._next_probe_s = self.clock() + self._cooldown_s

    def probe_due(self) -> bool:
        """Drained, cooled down, and probe budget remaining."""
        return (self.state == self.DRAINED and not self.exhausted
                and self.clock() >= self._next_probe_s)

    def begin_probe(self) -> None:
        """Enter PROBING: the unit accepts exactly one canary; the next
        record_success / record_failure resolves it."""
        assert self.state == self.DRAINED, f"probe from {self.state}"
        self.state = self.PROBING
        self.probes += 1


class RestartManager:
    """Checkpoint every `interval` steps; resume from the latest commit.

    `async_save=False` (default) blocks on the disk write inside
    `on_step`, so a kill -9 at any point between steps loses at most
    `interval` steps, the durability contract the kill-at tests assert.
    `async_save=True` overlaps the write with the next steps (the snapshot
    is still taken before `on_step` returns); a crash may lose the
    in-flight save on top of the interval. Restores land on `device`.
    """

    def __init__(self, ckpt_dir: str, interval: int = 50,
                 async_save: bool = False, device="cuda"):
        self.ckpt_dir = ckpt_dir
        self.interval = interval
        self.async_save = async_save
        self.device = device
        self._pending = None

    def maybe_restore(self, state: Any) -> Tuple[Any, int]:
        """(state, first_step_to_run): the restored latest checkpoint and
        its step + 1, or the passed-in state and 0 when none committed."""
        latest = checkpoint.latest_step(self.ckpt_dir)
        if latest is None:
            return state, 0
        return (checkpoint.restore(self.ckpt_dir, latest, state,
                                   self.device), latest + 1)

    def on_step(self, step: int, state: Any) -> None:
        if self.interval <= 0 or step <= 0 or step % self.interval:
            return
        self._save(step, state)

    def finalize(self, step: int, state: Any) -> None:
        """Unconditional blocking save of the final state."""
        self.flush()
        checkpoint.save(self.ckpt_dir, step, state)

    def flush(self) -> None:
        """Wait for any in-flight async save to commit."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _save(self, step: int, state: Any) -> None:
        self.flush()
        if self.async_save:
            self._pending = checkpoint.save(self.ckpt_dir, step, state,
                                            blocking=False)
        else:
            checkpoint.save(self.ckpt_dir, step, state)


class StragglerReport(NamedTuple):
    is_straggler: bool
    step_time_s: float
    mean_s: float
    step: int


class StepWatchdog:
    """start()/stop(step) around each training step; a step slower than
    `factor` x the running mean of healthy steps is flagged. The first
    `warmup` steps only feed the mean (warm-up steps must not trip it),
    and flagged steps are left out of it, so one hung rank cannot drag
    the baseline up and mask the next stall."""

    def __init__(self, factor: float = 3.0, warmup: int = 2,
                 history: int = 64):
        self.factor = factor
        self.warmup = warmup
        self.history = history
        self._times: list = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, step: int) -> StragglerReport:
        assert self._t0 is not None, "stop() without start()"
        dt = time.perf_counter() - self._t0
        self._t0 = None
        mean = (sum(self._times) / len(self._times)) if self._times else dt
        flag = len(self._times) >= self.warmup and dt > self.factor * mean
        if not flag:
            self._times.append(dt)
            if len(self._times) > self.history:
                self._times.pop(0)
        return StragglerReport(flag, dt, mean, step)


def reshard_restore(ckpt_dir: str, like: Any, mesh, specs,
                    step: Optional[int] = None) -> Tuple[Any, int]:
    """Restore the latest (or given) checkpoint onto `mesh`.

    `like` gives the tree's structure and shapes (tensors or meta
    tensors), `specs` the matching logical-axis spec tree. The leaves are
    read on the host and placed as DTensors with the target mesh's
    (shape-pruned) placements, so the values are bit-identical however
    the writing mesh was laid out: the checkpoint format knows no mesh.
    Returns (state, first_step_to_run).
    """
    from repro_torch.dist.sharding import distribute, spec_tree_to_shardings
    if step is None:
        step = checkpoint.latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {ckpt_dir}")
    host = checkpoint.restore_host(ckpt_dir, step, like)
    shardings = spec_tree_to_shardings(mesh, specs, like)
    return tree_map(distribute, host, shardings), step + 1
