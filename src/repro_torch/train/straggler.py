"""Straggler detection (launcher level).

Counterpart of src/repro/train/straggler.py, host-only code kept as the
port's own copy.  Synchronous SPMD work has no per-task speculative
execution (every rank takes part in every collective), so mitigation
happens at the step granularity:

  * StepMonitor keeps an EMA of step wall time and flags steps slower than
    `threshold`x the EMA: a rank that throttles, a degraded link, a
    preemption notice;
  * ShardMonitor runs one StepMonitor per shard over per-iteration,
    per-shard timing telemetry and names WHICH shard is the straggler; the
    elastic solver loop (core/optim/elastic.ElasticGroup, the serving
    frontend's GroupRunner) feeds it and, when it trips, drops the slow
    shard and re-shards the distributed matrix mid-solve
    (train/elastic.survivor_mesh, remesh_linop);
  * on `trip_limit` consecutive flags the policy callback fires;
  * `deadline_s` turns a hung collective (a dead rank) into a detectable
    failure instead of an infinite stall.

The monitor math does not depend on the rank count; the tests drive it
with the seeded synthetic shard times of train/faults.FaultyLinop, so a
verdict never depends on the host's real speed and is the same on every
rank.  Trips and the per-shard EMAs go to launch/telemetry
(``straggler.trips``, ``straggler.ema_s``).
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable

from repro_torch.launch import telemetry as _tel


@dataclasses.dataclass
class StragglerConfig:
    ema_alpha: float = 0.1
    threshold: float = 2.0          # × EMA → flagged
    trip_limit: int = 3             # consecutive flags → policy fires
    warmup_steps: int = 5           # ignore compile/first-step noise
    deadline_s: float | None = None


class StepMonitor:
    def __init__(self, cfg: StragglerConfig = StragglerConfig(),
                 on_straggler: Callable[[dict], None] | None = None):
        self.cfg = cfg
        self.on_straggler = on_straggler
        self.ema: float | None = None
        self.steps = 0
        self.trips = 0
        self.flags: list[int] = []
        self._t0: float | None = None

    def start(self):
        self._t0 = time.monotonic()

    def stop(self) -> dict:
        assert self._t0 is not None, "start() not called"
        dt = time.monotonic() - self._t0
        self._t0 = None
        return self.observe(dt)

    def observe(self, dt: float) -> dict:
        """Feed one step duration; returns the monitor verdict."""
        self.steps += 1
        verdict = {"step": self.steps, "dt": dt, "flagged": False,
                   "tripped": False, "deadline_exceeded": False}
        if self.cfg.deadline_s is not None and dt > self.cfg.deadline_s:
            # a blown deadline (hung collective / dead host) trips
            # immediately — no EMA evidence needed
            verdict["deadline_exceeded"] = True
            verdict["tripped"] = True
            if self.on_straggler is not None:
                self.on_straggler(dict(verdict, ema=self.ema))
            return verdict
        if self.steps <= self.cfg.warmup_steps:
            self.ema = dt if self.ema is None else self.ema
            return verdict
        if self.ema is None:
            self.ema = dt
            return verdict
        if dt > self.cfg.threshold * self.ema:
            verdict["flagged"] = True
            self.flags.append(self.steps)
            self.trips += 1
        else:
            self.trips = 0
        # only fold non-outliers into the EMA (don't learn the pathology)
        if not verdict["flagged"]:
            self.ema = (1 - self.cfg.ema_alpha) * self.ema \
                + self.cfg.ema_alpha * dt
        if self.trips >= self.cfg.trip_limit or verdict["deadline_exceeded"]:
            verdict["tripped"] = True
            self.trips = 0
            if self.on_straggler is not None:
                self.on_straggler(dict(verdict, ema=self.ema))
        return verdict


class ShardMonitor:
    """Per-shard straggler detection from per-iteration step telemetry.

    One StepMonitor per shard; `observe(shard_times)` feeds each shard its
    own duration.  A shard is named the straggler only when BOTH hold:

      * its own StepMonitor tripped (slower than its own EMA history for
        `trip_limit` consecutive iterations, or past `deadline_s`) — the
        thermal-throttle / degraded-link signature; and
      * it is `threshold`× slower than the median of the OTHER shards this
        iteration — so a uniform slowdown (new kernel shape, host noise)
        never looks like a straggler.  On a 1-shard mesh there are no
        others, so the shard's own trip decides alone.

    The verdict dict mirrors StepMonitor's: `tripped` plus `shard` (the
    flagged shard index, slowest first when several trip together).  After
    an elastic re-mesh the caller `reset(new_nshards)`s the monitor — the
    survivors' history no longer predicts the new shard shapes.
    """

    def __init__(self, nshards: int,
                 cfg: StragglerConfig = StragglerConfig(),
                 on_straggler: Callable[[dict], None] | None = None):
        self.cfg = cfg
        self.on_straggler = on_straggler
        self.reset(nshards)

    def reset(self, nshards: int) -> None:
        self.nshards = nshards
        self.monitors = [StepMonitor(self.cfg) for _ in range(nshards)]

    def observe(self, shard_times) -> dict:
        times = [float(t) for t in shard_times]
        assert len(times) == self.nshards, (len(times), self.nshards)
        verdicts = [m.observe(t) for m, t in zip(self.monitors, times)]
        suspects = []
        for i, (v, t) in enumerate(zip(verdicts, times)):
            if not v["tripped"]:
                continue
            others = times[:i] + times[i + 1:]
            if others and t <= self.cfg.threshold * statistics.median(others):
                continue                     # everybody slowed — not a straggler
            suspects.append((t, i))
        shard = max(suspects)[1] if suspects else None
        verdict = {"tripped": shard is not None, "shard": shard,
                   "times": times,
                   "deadline_exceeded": any(v["deadline_exceeded"]
                                            for v in verdicts),
                   "flagged": [i for i, v in enumerate(verdicts)
                               if v["flagged"] or v["tripped"]]}
        tel = _tel.current()
        if tel.enabled:
            # The per-shard EMAs double as live gauges: the same numbers
            # the trip decision runs on, readable from any snapshot.
            for i, m in enumerate(self.monitors):
                if m.ema is not None:
                    tel.gauge("straggler.ema_s", shard=i).set(m.ema)
            if verdict["tripped"]:
                tel.counter("straggler.trips").inc()
        if verdict["tripped"] and self.on_straggler is not None:
            self.on_straggler(dict(verdict))
        return verdict
