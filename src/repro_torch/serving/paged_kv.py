"""Paged KV cache bookkeeping: physical page allocator + block tables.

A copy of ``repro.serving.paged_kv`` (pure Python).

The device-side pool (``repro_torch.models.transformer.init_paged_state``) is a
preallocated tensor of fixed-size pages; everything here is host-side
accounting deciding *which* pages each sequence owns.  The split mirrors
vLLM's design: the allocator is a free list over physical page ids, and
each serving slot's ordered page list is materialized as one row of a
dense int32 block table that ships to the jitted step every iteration.

Page 0 is reserved as the **null page**: inactive slots keep an all-zero
block-table row, so the (garbage) K/V rows they write inside the fused
step land on page 0 and can never corrupt a live sequence.
"""
from __future__ import annotations

import numpy as np


class PageAllocator:
    """Free-list allocator over physical page ids ``1 .. n_pages-1``.

    Page 0 is the reserved null page and is never handed out.  ``alloc``
    is all-or-nothing: a request either gets every page it asked for or
    ``None`` (so admission can wait without partial reservations leaking).
    """

    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is the reserved null page)")
        self.n_pages = n_pages
        self._free: list[int] = list(range(n_pages - 1, 0, -1))  # pop() -> low ids first

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_usable(self) -> int:
        """Total allocatable pages (pool size minus the null page)."""
        return self.n_pages - 1

    def alloc(self, n: int) -> list[int] | None:
        if n > len(self._free):
            return None
        return [self._free.pop() for _ in range(n)]

    def free(self, pages: list[int]) -> None:
        for p in pages:
            if not 0 < p < self.n_pages:
                raise ValueError(f"freeing invalid page id {p}")
            if p in self._free:
                raise ValueError(f"double free of page {p}")
            self._free.append(p)

    def assert_no_leaks(self) -> None:
        """Raise AssertionError unless every allocatable page is back in
        the free list (and none is duplicated).  The engine asserts this
        after a drained ``run()``; serving tests reuse it instead of
        hand-rolled free-page arithmetic."""
        free = set(self._free)
        if len(free) != len(self._free):
            dupes = sorted(p for p in free if self._free.count(p) > 1)
            raise AssertionError(f"free-list corruption: duplicated page(s) {dupes}")
        leaked = sorted(set(range(1, self.n_pages)) - free)
        if leaked:
            raise AssertionError(
                f"page leak: {len(leaked)} page(s) never returned to the free "
                f"list: {leaked}"
            )


class BlockTable:
    """Dense [n_slots, n_blocks] int32 map from slot to physical pages.

    Unused entries stay 0 (the null page).  The array is plain numpy; the
    engine pushes it to the device once per step alongside the token and
    position vectors.
    """

    def __init__(self, n_slots: int, n_blocks: int):
        self.n_blocks = n_blocks
        self._table = np.zeros((n_slots, n_blocks), np.int32)

    def assign(self, slot: int, pages: list[int]) -> None:
        if len(pages) > self.n_blocks:
            raise ValueError(
                f"{len(pages)} pages exceed the {self.n_blocks}-block slot capacity"
            )
        self._table[slot] = 0
        self._table[slot, : len(pages)] = pages

    def append(self, slot: int, pages: list[int]) -> None:
        """Extend a slot's page list in place (on-demand page growth).

        Rows are dense prefixes of real (>= 1) page ids, so the used
        count is just the nonzero count.
        """
        n_used = int(np.count_nonzero(self._table[slot]))
        if n_used + len(pages) > self.n_blocks:
            raise ValueError(
                f"appending {len(pages)} pages to {n_used} used exceeds the "
                f"{self.n_blocks}-block slot capacity"
            )
        self._table[slot, n_used : n_used + len(pages)] = pages

    def clear(self, slot: int) -> None:
        self._table[slot] = 0

    def as_array(self) -> np.ndarray:
        return self._table
