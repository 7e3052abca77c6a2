"""A copy of ``repro.serving.scheduler`` (pure Python).

Request admission / preemption / eviction under a page-pool budget.

Iteration-level (Orca-style) scheduling: every engine step, each active
slot advances by a *chunk* of tokens — up to ``chunk_tokens`` prompt (or
replayed) tokens while the request is prefilling, exactly one sampled
token once it is decoding — and the scheduler tops the batch back up
whenever a slot frees.  Two admission modes:

* ``admit="reserve"`` (the PR-2 behaviour): a request is admitted only
  when both a slot and its **worst-case** page count (prompt +
  max_new_tokens, rounded up to whole pages) are available, so an
  admitted request can never hit pool exhaustion mid-flight; requests
  that don't fit wait in a FIFO queue.  Safe but pessimistic — the pool
  sits under-reserved because most requests finish early.

* ``admit="on-demand"``: requests are admitted with **no** reservation
  and grow their page list as their position advances
  (:meth:`Scheduler.ensure_pages`).  When the pool runs dry mid-step the
  engine preempts the lowest-progress slot (:meth:`Scheduler.preempt`):
  its pages are freed, its slot recycled, and the request requeued at
  the *head* of the waiting queue with its generated prefix preserved —
  on re-admission it re-prefills ``prompt + out_tokens`` in chunks and
  resumes sampling token-identically (greedy decode over a bit-exact
  paged attention recompute).

``policy="static"`` turns the same machinery into the fixed-batch
baseline: admission happens only when *every* slot is free (gang
admission), so the batch drains fully before any waiting request starts
— the A/B for ``benchmarks/serving_bench.py``.  Static implies reserve.
"""
from __future__ import annotations

from collections import deque
from typing import Iterable

import numpy as np

from repro_torch.serving.lifecycle import Request
from repro_torch.serving.paged_kv import BlockTable, PageAllocator

__all__ = ["Request", "Scheduler"]  # Request lives in lifecycle; re-exported


class Scheduler:
    """Waiting queue + slot/page accounting around a :class:`PageAllocator`."""

    def __init__(
        self,
        n_slots: int,
        allocator: PageAllocator,
        block_table: BlockTable,
        page_size: int,
        *,
        policy: str = "continuous",
        admit: str = "reserve",
    ):
        if policy not in ("continuous", "static"):
            raise ValueError(f"unknown scheduling policy {policy!r}")
        if admit not in ("reserve", "on-demand"):
            raise ValueError(f"unknown admission mode {admit!r}")
        if policy == "static" and admit != "reserve":
            raise ValueError("static gang admission requires admit='reserve'")
        self.n_slots = n_slots
        self.allocator = allocator
        self.block_table = block_table
        self.page_size = page_size
        self.policy = policy
        self.admit_mode = admit
        self.waiting: deque[Request] = deque()
        self.active: dict[int, Request] = {}
        self._free_slots: list[int] = list(range(n_slots - 1, -1, -1))
        self._quarantined: dict[int, float] = {}  # slot -> release tick
        self.n_preemptions = 0
        self.n_quarantines = 0

    # -- queue -------------------------------------------------------------

    def pages_needed(self, req: Request) -> int:
        """Worst-case page count: the whole prompt + generation budget."""
        total = len(req.prompt) + req.max_new_tokens
        return -(-total // self.page_size)

    def submit(self, req: Request) -> None:
        need = self.pages_needed(req)
        if need > self.block_table.n_blocks:
            raise ValueError(
                f"request {req.rid} needs {need} pages > per-slot capacity "
                f"{self.block_table.n_blocks}; raise max_len or shrink the request"
            )
        if need > self.allocator.n_usable:
            raise ValueError(
                f"request {req.rid} needs {need} pages > pool total "
                f"{self.allocator.n_usable}; it could never be admitted"
            )
        self.waiting.append(req)

    def submit_all(self, reqs: Iterable[Request]) -> None:
        for r in reqs:
            self.submit(r)

    # -- admission / eviction ---------------------------------------------

    def admit(self, now: float = 0.0) -> list[Request]:
        """Move waiting requests into free slots while pages allow.

        FIFO without bypass: when the head request can't be placed
        (reserve: its worst-case reservation doesn't fit the free pool;
        on-demand: not even one page is free), admission stops — smaller
        requests behind it wait too, simple and starvation-free.
        """
        if self.policy == "static" and self.active:
            return []
        admitted: list[Request] = []
        while self.waiting and self._free_slots:
            if self.admit_mode == "reserve":
                pages = self.allocator.alloc(self.pages_needed(self.waiting[0]))
                if pages is None:
                    break
            else:
                # on-demand: no reservation — pages are granted step by
                # step (ensure_pages) and reclaimed by preemption; gate on
                # one free page so an admit can at least write position 0
                if self.allocator.n_free < 1:
                    break
                pages = []
            req = self.waiting.popleft()
            req.slot = self._free_slots.pop()
            req.pages = pages
            req.t_admit = now
            self.block_table.assign(req.slot, pages)
            self.active[req.slot] = req
            admitted.append(req)
        return admitted

    def ensure_pages(self, req: Request, upto_pos: int) -> bool:
        """Grow ``req``'s page list to cover position ``upto_pos``
        (on-demand admission).  All-or-nothing: returns False — and
        allocates nothing — when the pool can't supply the missing pages,
        so the engine can pick a preemption victim and retry."""
        need = upto_pos // self.page_size + 1 - len(req.pages)
        if need <= 0:
            return True
        got = self.allocator.alloc(need)
        if got is None:
            return False
        req.pages.extend(got)
        self.block_table.append(req.slot, got)
        return True

    def pick_victim(self) -> Request:
        """Preemption policy: the lowest-progress active slot loses —
        it has the least resident work to replay (ties: youngest rid)."""
        return min(self.active.values(), key=lambda r: (r.n_fed, -r.rid))

    def preempt(self, req: Request, now: float = 0.0) -> None:
        """Evict a *running* request on pool exhaustion: free its pages,
        recycle its slot, and requeue it at the head of the waiting queue
        with the generated prefix intact.  ``n_fed`` resets to 0 — on
        re-admission the request re-prefills ``prompt + out_tokens`` in
        chunks and resumes sampling exactly where it left off."""
        self.allocator.free(req.pages)
        req.pages = []
        self.block_table.clear(req.slot)
        del self.active[req.slot]
        self._free_slots.append(req.slot)
        req.slot = -1
        req.n_fed = 0
        req.n_preempted += 1
        self.n_preemptions += 1
        self.waiting.appendleft(req)

    def finish(self, req: Request, now: float = 0.0) -> None:
        """Evict a completed request: free its pages and recycle the slot."""
        req.t_finish = now
        self.allocator.free(req.pages)
        req.pages = []
        self.block_table.clear(req.slot)
        del self.active[req.slot]
        self._free_slots.append(req.slot)
        req.slot = -1

    def remove_waiting(self, req: Request) -> None:
        """Pull a request out of the waiting queue (cancellation / load
        shedding); the caller finalizes its terminal status."""
        self.waiting.remove(req)

    # -- slot quarantine ---------------------------------------------------

    def quarantine_slot(self, slot: int, until_tick: float) -> None:
        """Withhold a *free* slot from admission until ``until_tick``
        (engine loop ticks).  Called right after preempting a faulting
        request, so a slot that just produced poisoned logits or a step
        fault sits out instead of immediately re-hosting work."""
        self._free_slots.remove(slot)
        self._quarantined[slot] = until_tick
        self.n_quarantines += 1

    def release_quarantined(self, tick: float | None = None) -> list[int]:
        """Return expired quarantined slots to the free list (all of them
        when ``tick`` is None — the end-of-run drain)."""
        released = [
            s for s, until in self._quarantined.items()
            if tick is None or tick >= until
        ]
        for s in released:
            del self._quarantined[s]
            self._free_slots.append(s)
        return released

    @property
    def n_quarantined_slots(self) -> int:
        return len(self._quarantined)

    @property
    def n_free_slots(self) -> int:
        return len(self._free_slots)

    def all_done(self) -> bool:
        return not self.waiting and not self.active

    # -- accounting invariants ---------------------------------------------

    def assert_all_reclaimed(self) -> None:
        """Raise AssertionError unless every slot is accounted for as free
        (or parked in quarantine) and the block table is fully cleared —
        the slot-side twin of :meth:`PageAllocator.assert_no_leaks`."""
        if self.active:
            raise AssertionError(
                f"slot leak: {len(self.active)} slot(s) still active: "
                f"{sorted(self.active)}"
            )
        accounted = len(self._free_slots) + len(self._quarantined)
        if accounted != self.n_slots:
            raise AssertionError(
                f"slot leak: {self.n_slots - accounted} of {self.n_slots} "
                "slot(s) neither free nor quarantined"
            )
        stale = int(np.count_nonzero(self.block_table.as_array()))
        if stale:
            raise AssertionError(
                f"block-table leak: {stale} page entr(ies) not cleared"
            )
