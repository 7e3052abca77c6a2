"""Fault-tolerant training runner (``repro.runtime.fault_tolerance``):
checkpoint/restart, failure injection and straggler detection, on one
device or a mesh.

The runner wraps a ``(state, batch) -> (loss, state)`` step with:

* periodic asynchronous checkpoints (every ``ckpt_every`` steps, step 0
  included) and :meth:`FaultTolerantRunner.resume_or_init` from the latest
  commit;
* a retry policy: when a step raises, the last checkpoint is restored and
  the run resumes after its step (without one, the step is retried on
  the state in memory), up to ``max_retries`` consecutive failures;
* a straggler monitor: step wall times feed an EWMA, and a step slower
  than ``straggler_factor`` x the EWMA is counted and reported to
  ``on_straggler``.

``float(loss)`` waits for each step's device work, as the reference's
``jax.block_until_ready`` does, so a step's time includes it and a device
error surfaces inside the step's ``try``.  Counters and the step-time
histogram go through a :class:`~repro_torch.obs.metrics.MetricsRegistry`
under the reference's names (``repro_train_steps_total``,
``repro_train_restarts_total``, ``repro_train_stragglers_total``,
``repro_train_step_seconds``); pass the serving engine's registry to
expose both in one scrape.  A mesh's state (sharded leaves) is saved
whole; a retry restores it onto the same mesh, and
:meth:`FaultTolerantRunner.resume_or_init` with ``shardings=`` onto any
other (the reference's elastic restore).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.obs.metrics import MetricsRegistry


@dataclasses.dataclass
class RunnerConfig:
    ckpt_every: int = 50
    max_retries: int = 3
    straggler_factor: float = 3.0
    ewma_alpha: float = 0.2


@dataclasses.dataclass
class RunnerStats:
    steps: int = 0
    restarts: int = 0
    stragglers: int = 0
    last_loss: float = float("nan")
    step_times: list = dataclasses.field(default_factory=list)


class FaultTolerantRunner:
    def __init__(
        self,
        train_step: Callable,  # (state, batch) -> (loss, state)
        ckpt: CheckpointManager,
        cfg: RunnerConfig = RunnerConfig(),
        *,
        on_straggler: Callable[[int, float], None] | None = None,
        registry: MetricsRegistry | None = None,
    ):
        self.train_step = train_step
        self.ckpt = ckpt
        self.cfg = cfg
        self.stats = RunnerStats()
        self.on_straggler = on_straggler
        self._ewma: float | None = None
        self.registry = registry if registry is not None else MetricsRegistry()
        self._m_steps = self.registry.counter("repro_train_steps_total", "completed training steps")
        self._m_restarts = self.registry.counter("repro_train_restarts_total", "step retries after a raised fault")
        self._m_stragglers = self.registry.counter("repro_train_stragglers_total",
                                                   "steps slower than straggler_factor x the EWMA")
        self._m_step_time = self.registry.histogram("repro_train_step_seconds", "training step wall time")

    def resume_or_init(self, init_state: Any, shardings: Any = None) -> tuple[int, Any]:
        """``(step, state)`` of the latest checkpoint, restored onto
        ``init_state``'s structure and devices (its sharded leaves onto
        their meshes), or onto ``shardings`` (a matching tree of
        ``NamedSharding``); or ``(0, init_state)``."""
        if self.ckpt.latest_step() is None:
            return 0, init_state
        return self.ckpt.restore(init_state, shardings=shardings)

    def run(
        self,
        state: Any,
        batches: Callable[[int], Any],
        n_steps: int,
        *,
        start_step: int = 0,
        failure_injector: Callable[[int], None] | None = None,
    ) -> tuple[Any, RunnerStats]:
        step = start_step
        retries = 0
        while step < n_steps:
            t0 = time.perf_counter()
            try:
                if failure_injector is not None:
                    failure_injector(step)  # may raise to simulate a dead host
                loss, state = self.train_step(state, batches(step))
                loss = float(loss)  # waits for the step's device work
            except Exception:
                retries += 1
                self.stats.restarts += 1
                self._m_restarts.inc()
                if retries > self.cfg.max_retries:
                    raise
                self.ckpt.wait()
                if self.ckpt.latest_step() is not None:
                    step, state = self.ckpt.restore(state)
                    step += 1  # resume after the checkpointed step
                continue
            retries = 0
            dt = time.perf_counter() - t0
            self._straggler_check(step, dt)
            self.stats.steps += 1
            self.stats.last_loss = loss
            self.stats.step_times.append(dt)
            self._m_steps.inc()
            self._m_step_time.observe(dt)
            if step % self.cfg.ckpt_every == 0:
                self.ckpt.save_async(step, state)
            step += 1
        self.ckpt.wait()
        return state, self.stats

    def _straggler_check(self, step: int, dt: float) -> None:
        if self._ewma is None:
            self._ewma = dt
            return
        if dt > self.cfg.straggler_factor * self._ewma:
            self.stats.stragglers += 1
            self._m_stragglers.inc()
            if self.on_straggler is not None:
                self.on_straggler(step, dt)
        a = self.cfg.ewma_alpha
        self._ewma = (1 - a) * self._ewma + a * dt
