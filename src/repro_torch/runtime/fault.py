"""Fault-tolerant training runtime: restart, stragglers, elastic re-mesh.

The port of ``repro/runtime/fault.py``, unchanged in behaviour; states are
trees of tensors (:mod:`repro_torch.checkpoint.manager`).

Pieces a 1000-node deployment needs around the pure train step:

* :class:`ResumableLoop` — drives the step function with periodic
  (async, atomic) checkpoints and auto-resume: on construction it
  restores the newest intact checkpoint, so a SIGKILL/OOM/preemption
  costs at most ``checkpoint_every`` steps.  Transient step failures
  (a flaky link, say) are retried from the last
  checkpoint up to ``max_retries`` times.
* :class:`StragglerMonitor` — EWMA step-time tracker; steps slower than
  ``threshold`` x EWMA emit structured events.  On a real cluster the event
  hook triggers hot-spare swap / re-shard; here events are recorded and
  surfaced (tested by injecting a slow step).
* :func:`elastic_remesh` — rebuilds state for a different world: template
  shapes stay global and only devices change, so restoring onto a grown or
  shrunken world is the same code path as restart.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable

from ..checkpoint.manager import CheckpointManager

log = logging.getLogger("repro_torch.runtime")

__all__ = [
    "StragglerMonitor",
    "ReplicaHealth",
    "ResumableLoop",
    "elastic_remesh",
]


@dataclasses.dataclass
class StragglerEvent:
    step: int
    duration: float
    ewma: float
    ratio: float


class StragglerMonitor:
    """EWMA-based detection of slow steps (stragglers)."""

    def __init__(self, threshold: float = 2.0, alpha: float = 0.2,
                 warmup: int = 3, on_event: Callable | None = None):
        self.threshold = threshold
        self.alpha = alpha
        self.warmup = warmup
        self.on_event = on_event
        self.ewma: float | None = None
        self.count = 0
        self.events: list[StragglerEvent] = []

    def record(self, step: int, duration: float) -> StragglerEvent | None:
        self.count += 1
        if self.ewma is None:
            self.ewma = duration
            return None
        event = None
        if self.count > self.warmup and duration > self.threshold * self.ewma:
            event = StragglerEvent(
                step, duration, self.ewma, duration / self.ewma
            )
            self.events.append(event)
            log.warning(
                "straggler: step %d took %.3fs (%.1fx EWMA %.3fs)",
                step, duration, event.ratio, self.ewma,
            )
            if self.on_event:
                self.on_event(event)
            # quarantine: do not poison the EWMA with the outlier
            return event
        self.ewma = (1 - self.alpha) * self.ewma + self.alpha * duration
        return event


class ReplicaHealth:
    """Straggler-signal-driven health state for one serving replica.

    Wraps a :class:`StragglerMonitor` with the hysteresis the serving
    router needs: a straggler event marks the replica **degraded** (the
    router stops routing to it and reroutes its queue); ``recovery``
    consecutive clean steps mark it healthy again.  A plain counter
    would flap — one fast step after a stall is not a recovery.

    The boundary is exact — healthy flips back on the ``recovery``-th
    consecutive clean step, never one early or late — and is pinned at
    every reachable state by the layer-0 protocol checker
    (:mod:`repro_torch.analysis.protocol_check`), which asserts the
    post-state of each clean step against ``recovery`` directly.
    """

    def __init__(
        self,
        monitor: StragglerMonitor | None = None,
        *,
        recovery: int = 5,
    ):
        if recovery < 1:
            raise ValueError(f"recovery must be >= 1, got {recovery}")
        self.monitor = monitor or StragglerMonitor()
        self.recovery = recovery
        self.healthy = True
        self._clean = 0
        self.n_degraded = 0  # degradation episodes (router telemetry)

    def record(self, step: int, duration: float) -> bool:
        """Feed one step time; returns the post-update health."""
        event = self.monitor.record(step, duration)
        if event is not None:
            if self.healthy:
                self.n_degraded += 1
            self.healthy = False
            self._clean = 0
        elif not self.healthy:
            self._clean += 1
            if self._clean >= self.recovery:
                self.healthy = True
                self._clean = 0
        return self.healthy


class ResumableLoop:
    """Checkpointed, auto-resuming, retrying training loop driver."""

    def __init__(
        self,
        *,
        step_fn: Callable[[Any, int], tuple[Any, dict]],
        make_state: Callable[[], Any],
        ckpt: CheckpointManager,
        checkpoint_every: int = 50,
        max_retries: int = 2,
        monitor: StragglerMonitor | None = None,
    ):
        self.step_fn = step_fn
        self.ckpt = ckpt
        self.checkpoint_every = checkpoint_every
        self.max_retries = max_retries
        self.monitor = monitor or StragglerMonitor()
        self.metrics_log: list[dict] = []

        template = make_state()
        restored, meta = ckpt.restore_latest(template)
        if restored is not None:
            self.state = restored
            self.start_step = int(meta["step"]) + 1
            log.info("resumed from checkpoint step %d", meta["step"])
        else:
            self.state = template
            self.start_step = 0

    def run(self, until_step: int) -> Any:
        step = self.start_step
        retries = 0
        while step < until_step:
            t0 = time.perf_counter()
            try:
                self.state, metrics = self.step_fn(self.state, step)
            except Exception as e:  # transient failure -> restore + retry
                retries += 1
                log.error("step %d failed (%s); retry %d", step, e, retries)
                if retries > self.max_retries:
                    raise
                restored, meta = self.ckpt.restore_latest(self.state)
                if restored is not None:
                    self.state = restored
                    step = int(meta["step"]) + 1
                continue
            retries = 0
            dt = time.perf_counter() - t0
            self.monitor.record(step, dt)
            self.metrics_log.append({"step": step, "time_s": dt, **metrics})
            if (
                self.checkpoint_every
                and (step + 1) % self.checkpoint_every == 0
            ):
                self.ckpt.save(step, self.state, meta={"loop": "resumable"})
            step += 1
        self.ckpt.wait()
        self.start_step = step
        return self.state


def elastic_remesh(ckpt: CheckpointManager, make_template: Callable[[], Any]):
    """Restore the newest checkpoint into a *new* world's template.

    ``make_template`` builds the state skeleton for the new world (e.g.
    after losing a node or adding one); global shapes do not depend on the
    world, so restore == reshard.  Returns (state, meta) or (None, None).
    """
    return ckpt.restore_latest(make_template())
