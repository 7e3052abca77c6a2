"""A copy of ``repro.serving.chaos`` (pure Python).

Deterministic fault injection (chaos harness) for the serving engine.

Three fault families, each injected at a configurable rate from one
seeded ``numpy`` generator so a run is exactly reproducible (the engine
consults the injector in a fixed order per step under the virtual
clock):

* **step faults** — :meth:`ChaosInjector.before_step` raises
  :class:`InjectedFault` *before* the fused step runs (before its batch
  is staged or its graph replayed), modelling a transient executor/host
  failure.  Because the fault fires before the state is touched, the
  engine can retry the identical step; after
  ``EngineConfig.max_step_retries`` consecutive failures it escalates to
  preempting (and quarantining the slot of) the lowest-progress request,
  exactly the preemption's requeue/replay path.
* **allocation faults** — :meth:`wrap_allocator` returns a proxy whose
  ``alloc`` transiently reports pool exhaustion.  Reserve-mode admission
  just waits a tick; on-demand funding falls into the existing
  preempt-and-retry machinery, so a flaky allocator costs extra
  preemptions, never correctness.
* **NaN-poisoned logits** — :meth:`poison_logits` overwrites the logits
  row of sampling slots with NaN after the step, modelling numerical
  corruption.  The engine's finite-check (always on, not chaos-specific)
  quarantines the slot and requeues the request for token-identical
  replay instead of sampling garbage.

The injector never mutates engine state itself — it only makes the
engine's *own* recovery paths fire, which is what the chaos CI gate
verifies: under rate >= 0.2 of all three families, every non-shed
request must finish token-identical to the fault-free reference with
zero leaked pages or slots.

A traced run (``Engine.run(trace=...)``) sets ``ChaosInjector.trace``:
every counted injection then leaves one ``inject_<family>`` instant in
the trace, which the trace gate reconciles with :meth:`counters`.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.serving.paged_kv import PageAllocator


class InjectedFault(RuntimeError):
    """A chaos-injected transient failure of the fused step."""


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    seed: int = 0
    step_fault_rate: float = 0.0  # P(fused step raises) per attempt
    alloc_fault_rate: float = 0.0  # P(page alloc transiently fails) per call
    nan_rate: float = 0.0  # P(a sampling slot's logits are NaN-poisoned) per step

    def __post_init__(self):
        for f in ("step_fault_rate", "alloc_fault_rate", "nan_rate"):
            v = getattr(self, f)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{f} must be in [0, 1], got {v}")

    @property
    def enabled(self) -> bool:
        return max(self.step_fault_rate, self.alloc_fault_rate, self.nan_rate) > 0


class FlakyPageAllocator:
    """Proxy over a :class:`PageAllocator` whose ``alloc`` transiently
    fails.  Everything else (``free``, ``n_free``, ``assert_no_leaks``,
    ...) delegates, so accounting invariants see the real pool."""

    def __init__(self, inner: PageAllocator, injector: "ChaosInjector"):
        self._inner = inner
        self._injector = injector

    def alloc(self, n: int) -> list[int] | None:
        if n > 0 and self._injector.roll_alloc_fault():
            return None  # indistinguishable from genuine pool exhaustion
        return self._inner.alloc(n)

    def __getattr__(self, name):
        return getattr(self._inner, name)


class ChaosInjector:
    """Seeded fault source; counts every injection for the bench artifact."""

    def __init__(self, cfg: ChaosConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        self.n_step_faults = 0
        self.n_alloc_faults = 0
        self.n_nan_poisoned = 0
        # engine-attached TraceRecorder (or None): every counted injection
        # emits exactly one instant event, so the trace gate can require
        # event count == counters() per family
        self.trace = None

    def _trace_inject(self, family: str, n: int) -> None:
        if self.trace is not None:
            self.trace.instant(f"inject_{family}", n=n, seed=self.cfg.seed)

    def before_step(self) -> None:
        """Call immediately before the fused step: raises InjectedFault at
        ``step_fault_rate`` (state untouched, so the step is retryable)."""
        if self.cfg.step_fault_rate and self.rng.random() < self.cfg.step_fault_rate:
            self.n_step_faults += 1
            self._trace_inject("step", self.n_step_faults)
            raise InjectedFault(f"injected step fault #{self.n_step_faults}")

    def roll_alloc_fault(self) -> bool:
        if self.cfg.alloc_fault_rate and self.rng.random() < self.cfg.alloc_fault_rate:
            self.n_alloc_faults += 1
            self._trace_inject("alloc", self.n_alloc_faults)
            return True
        return False

    def poison_logits(self, logits: np.ndarray, sampling_slots: list[int]) -> list[int]:
        """Overwrite sampling slots' logits rows with NaN at ``nan_rate``.
        ``logits`` must be a writable host copy; returns poisoned slots."""
        victims = []
        if self.cfg.nan_rate:
            for slot in sampling_slots:
                if self.rng.random() < self.cfg.nan_rate:
                    logits[slot, :] = np.nan
                    self.n_nan_poisoned += 1
                    self._trace_inject("nan", self.n_nan_poisoned)
                    victims.append(slot)
        return victims

    def wrap_allocator(self, inner: PageAllocator) -> FlakyPageAllocator:
        return FlakyPageAllocator(inner, self)

    def counters(self) -> dict:
        return {
            "step": self.n_step_faults,
            "alloc": self.n_alloc_faults,
            "nan": self.n_nan_poisoned,
        }
