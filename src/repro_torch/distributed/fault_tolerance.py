"""Failure detection and straggler tracking for the async runtime's workers.

Counterpart of ``WorkerState``, ``WorkerInfo`` and ``HeartbeatMonitor`` in
``repro.distributed.fault_tolerance`` (pure Python, no tensors).  The
driver feeds the monitor heartbeats, assignments and completions; a
worker silent past ``dead_after_s`` is dead and its in-flight cohort is
re-issued, and so is a healthy worker's cohort that has run longer than
``straggler_factor`` times the median latency (work stealing with an
at-most-once effect, which the driver's pending set enforces).  The
monitor takes timestamps in and gives decisions out, so tests drive it
with a synthetic clock.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np


class WorkerState(enum.Enum):
    HEALTHY = "healthy"
    SUSPECT = "suspect"
    DEAD = "dead"


@dataclasses.dataclass
class WorkerInfo:
    # None = registered from a timestamp-less message (legacy caller);
    # liveness is unknown until a real heartbeat arrives, so sweep()
    # treats the worker as silent for 0 s rather than fabricating a
    # monotonic-clock age of `now − 0.0` that would kill it on sight.
    last_heartbeat: Optional[float]
    state: WorkerState = WorkerState.HEALTHY
    inflight_cohort: Optional[int] = None
    inflight_since: Optional[float] = None   # assign() timestamp
    completed: int = 0
    ema_latency: float = 0.0


@dataclasses.dataclass
class HeartbeatMonitor:
    """Driver-side liveness + straggler detection."""

    suspect_after_s: float = 30.0
    dead_after_s: float = 120.0
    straggler_factor: float = 3.0     # × median cohort latency ⇒ re-issue
    ema: float = 0.9

    def __post_init__(self):
        self.workers: dict[int, WorkerInfo] = {}

    def register(self, worker: int, now: Optional[float]) -> None:
        self.workers[worker] = WorkerInfo(last_heartbeat=now)

    def _ensure(self, worker: int, now: Optional[float]) -> WorkerInfo:
        """Register-on-first-contact: a restarted driver process observing
        an old worker's heartbeat (or completion) must absorb it, not
        KeyError — the monitor's view of the fleet is rebuilt from the
        messages themselves."""
        w = self.workers.get(worker)
        if w is None:
            self.register(worker, now)
            w = self.workers[worker]
        return w

    def heartbeat(self, worker: int, now: float) -> None:
        w = self._ensure(worker, now)
        w.last_heartbeat = now
        if w.state is not WorkerState.DEAD:
            w.state = WorkerState.HEALTHY

    def record_completion(
        self, worker: int, latency: float, now: Optional[float] = None
    ) -> None:
        # unknown worker and no timestamp: register with the None sentinel
        # (NOT 0.0 — on a monotonic clock that reads as dead_after_s of
        # silence and the next sweep would kill the worker and re-issue
        # its cohort); the next real heartbeat starts liveness tracking
        w = self._ensure(worker, now)
        w.completed += 1
        w.inflight_cohort = None
        w.inflight_since = None
        w.ema_latency = (
            latency if w.ema_latency == 0
            else self.ema * w.ema_latency + (1 - self.ema) * latency
        )

    def assign(
        self, worker: int, cohort: int, now: Optional[float] = None
    ) -> None:
        """Record that ``worker`` started ``cohort`` at ``now`` —
        ``inflight_since`` is what the straggler rule measures against
        (without a timestamp the cohort can only be re-issued on death,
        never as a straggler)."""
        w = self._ensure(worker, now)
        w.inflight_cohort = cohort
        w.inflight_since = now

    def sweep(self, now: float) -> dict:
        """Advance liveness states; return actions."""
        dead, suspects, reissue = [], [], []
        latencies = [w.ema_latency for w in self.workers.values() if w.ema_latency]
        median = float(np.median(latencies)) if latencies else 0.0
        for wid, w in self.workers.items():
            # no real heartbeat yet (timestamp-less registration): liveness
            # is unknowable, not overdue — skip dead/suspect transitions
            # until the first heartbeat; the straggler rule below still
            # applies if assign() carried a real timestamp
            silent = 0.0 if w.last_heartbeat is None else now - w.last_heartbeat
            if silent >= self.dead_after_s and w.state is not WorkerState.DEAD:
                w.state = WorkerState.DEAD
                dead.append(wid)
                if w.inflight_cohort is not None:
                    reissue.append(w.inflight_cohort)
                    w.inflight_cohort = None
                    w.inflight_since = None
            elif silent >= self.suspect_after_s and w.state is WorkerState.HEALTHY:
                w.state = WorkerState.SUSPECT
                suspects.append(wid)
            # straggler: alive but its inflight cohort is way over budget.
            # The rule measures THE COHORT's elapsed time (now −
            # inflight_since), not the worker's historical ema_latency: one
            # slow completed cohort inflates the EMA for ~1/(1−ema) sweeps,
            # and comparing the EMA to the median would re-issue every
            # subsequent cohort from that worker the moment it is assigned
            # — duplicate work for an entire recovery window.
            if (
                w.state is WorkerState.HEALTHY
                and w.inflight_cohort is not None
                and w.inflight_since is not None
                and median > 0
                and (now - w.inflight_since) > self.straggler_factor * median
            ):
                reissue.append(w.inflight_cohort)
                w.inflight_cohort = None
                w.inflight_since = None
        return {"dead": dead, "suspect": suspects, "reissue_cohorts": reissue}

    @property
    def healthy_workers(self) -> list[int]:
        return [
            wid
            for wid, w in self.workers.items()
            if w.state is not WorkerState.DEAD
        ]
