"""A copy of ``repro.serving.lifecycle`` (pure Python).

Request lifecycle types: SLO classes, deadlines, terminal statuses.

Every request the engine accepts ends in exactly one **terminal status**:

* ``ok``        — completed, `out_tokens` holds the full generation;
* ``cancelled`` — caller asked for cancellation (:meth:`Engine.cancel`),
  honoured cooperatively between fused steps; partial `out_tokens` kept;
* ``shed``      — the engine gave up on the request deterministically:
  its deadline passed (or provably cannot be met), the bounded waiting
  queue overflowed, or the stall watchdog fired; `shed_reason` says why;
* ``failed``    — the fault layer exhausted the per-request retry budget
  (``EngineConfig.max_request_retries``) replaying it through injected
  or real step faults.

Deadlines are **absolute** times on the engine clock (wall seconds for
``run(realtime=True)``, virtual steps for ``realtime=False``).  An
:class:`SLO` carries *relative* budgets and is resolved against the
request's arrival at submit time, so a workload mixes classes without
every caller doing deadline arithmetic.
"""
from __future__ import annotations

import dataclasses

# the only values Request.status may hold once a request leaves the engine
TERMINAL_STATUSES = ("ok", "cancelled", "shed", "failed")


@dataclasses.dataclass(frozen=True)
class SLO:
    """A service-level class: relative latency budgets from arrival.

    ``ttft_budget`` bounds time-to-first-token, ``total_budget`` bounds
    end-to-end completion; either may be None (unbounded).  Units follow
    the engine clock (seconds realtime, steps virtual).
    """

    name: str
    ttft_budget: float | None = None
    total_budget: float | None = None

    def resolve(self, arrival: float) -> tuple[float | None, float | None]:
        """(absolute ttft deadline, absolute total deadline) for a request
        arriving at ``arrival``."""
        ttft = arrival + self.ttft_budget if self.ttft_budget is not None else None
        total = arrival + self.total_budget if self.total_budget is not None else None
        return ttft, total


@dataclasses.dataclass
class Request:
    """One generation request plus its in-flight serving state.

    ``n_fed`` counts tokens pushed through the model this *residency*:
    positions ``0 .. n_fed-1`` of :attr:`seq` are resident in the paged
    cache.  Preemption resets it to 0 (the cache rows are gone) while
    keeping ``out_tokens`` — the replay after re-admission feeds the
    whole ``prompt + out_tokens`` prefix again and only starts sampling
    once the chunk that contains the final prefix token completes.
    """

    rid: int
    prompt: list[int]
    max_new_tokens: int
    arrival: float = 0.0
    # lifecycle (set at submit, read by the engine's policing pass)
    deadline: float | None = None  # absolute: finish by this time or be shed
    ttft_deadline: float | None = None  # absolute: first token by this time
    slo: str | None = None  # SLO class name, for per-class reporting
    # runtime state (engine-owned)
    slot: int = -1
    replica: int = 0  # data-parallel replica shard this request is routed to
    pages: list[int] = dataclasses.field(default_factory=list)
    n_fed: int = 0  # tokens of `seq` resident in the cache (this residency)
    out_tokens: list[int] = dataclasses.field(default_factory=list)
    n_preempted: int = 0
    n_faults: int = 0  # fault-layer strikes (step faults, NaN quarantines)
    cancel_requested: bool = False
    status: str | None = None  # one of TERMINAL_STATUSES once finalized
    shed_reason: str | None = None  # "deadline" | "ttft" | "infeasible" | ...
    t_admit: float | None = None
    t_first_token: float | None = None
    t_finish: float | None = None

    @property
    def seq(self) -> list[int]:
        """Every token that must be resident before the next sample:
        the prompt plus all tokens generated so far.  The engine samples
        only when ``n_fed`` reaches ``len(seq)`` — the step that fed the
        newest token; prefill, replay, and decode all fall out of that
        one rule."""
        return self.prompt + self.out_tokens

    @property
    def done(self) -> bool:
        return len(self.out_tokens) >= self.max_new_tokens

    def n_feed(self, budget: int) -> int:
        """Tokens to feed this step under a per-slot chunk budget: the
        rest of the unfed context, capped — exactly 1 once decoding."""
        return min(budget, len(self.seq) - self.n_fed)

    def next_chunk(self, budget: int) -> tuple[list[int], int]:
        """(tokens to feed this step, position of the first one)."""
        return self.seq[self.n_fed : self.n_fed + self.n_feed(budget)], self.n_fed

    def cancel(self) -> None:
        """Request cooperative cancellation: honoured between fused steps
        (the engine never aborts a step mid-flight), after which the
        request carries status ``cancelled`` with its partial output."""
        self.cancel_requested = True

    def min_steps_left(self, chunk_tokens: int) -> int:
        """Lower bound on engine steps this request still needs: remaining
        unfed context in chunks, then one step per remaining sample (the
        step feeding the last context token also samples)."""
        unfed = max(0, len(self.seq) - self.n_fed)
        chunks = -(-unfed // chunk_tokens) if unfed else 0
        remaining = self.max_new_tokens - len(self.out_tokens)
        # the final context chunk emits the first of the remaining samples
        return max(chunks + max(0, remaining - 1), remaining, 0)
