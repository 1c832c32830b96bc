"""Replica health for the serving schedulers (the port's copy of
`HealthConfig` and `HealthTracker` from `repro.dist.fault`).

  HealthTracker    strike/drain/probation/recovery state machine for one
                   replica-like unit, the health primitive behind the
                   `SlotScheduler`'s failover.

The reference module's training-side `RestartManager`, `StepWatchdog` and
`reshard_restore` belong to the distributed training stack, which the
port does not have yet.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional


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
