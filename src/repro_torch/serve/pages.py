"""Host-side page-pool bookkeeping for the paged serving engine.

A copy of ``repro.serve.pages``. The device side
(``repro_torch.models.cache``) sees only a page pool ``(L, n_pages,
page_size, Hkv, D)`` and per-slot block tables ``(max_slots, TW)``; THIS
module owns which physical page backs which (slot, ring-position) pair:

- **admission reservation**: a request is admitted only when its exact
  worst-case page need — ``min(TW, ceil(total_len / page_size))`` ring
  slots, known up front because ``n_new`` is part of the request — fits
  in the unreserved free pool. An admitted sequence can therefore ALWAYS
  get its next page; no mid-decode OOM, no preemption needed.
- **lazy assignment**: physical pages are taken from the free list only
  when a sequence first touches a ring slot (``touch``); once the ring
  wraps (sliding windows), slots are reused in place — zero further
  allocation and zero copy traffic for eviction.
- **defrag**: live pages can be compacted to the low end of the pool
  (``defrag`` returns the old→new permutation; the engine applies it to
  the device pools with one gather) so a long-running server can shrink
  its pool snapshot / restore locality after churn.

Physical page 0 is the TRASH page (``models.cache.TRASH_PAGE``):
never allocated, always a legal DMA target for masked writes.
"""
from __future__ import annotations

import numpy as np

from repro_torch.models.cache import TRASH_PAGE


class PageManager:
    """Allocator for one shared pool of ``n_pages`` pages (page 0 = trash)
    across ``max_slots`` batch slots with ``table_width`` ring slots each.
    """

    def __init__(self, n_pages: int, page_size: int, table_width: int,
                 max_slots: int):
        assert n_pages >= 2, "need at least the trash page + one real page"
        self.n_pages = n_pages
        self.page_size = page_size
        self.table_width = table_width
        self.max_slots = max_slots
        self.tables = np.full((max_slots, table_width), TRASH_PAGE, np.int32)
        self._free = list(range(n_pages - 1, 0, -1))   # stack; 0 reserved
        self._free_slots = list(range(max_slots - 1, -1, -1))
        self._reserved = {}                            # slot -> pages still owed
        self._owned = {s: [] for s in range(max_slots)}

    # ---------------------------------------------------------- queries

    def pages_needed(self, total_len: int) -> int:
        """Exact worst-case ring slots a sequence of ``total_len`` tokens
        (prompt + prefix + n_new) ever occupies."""
        return min(self.table_width,
                   -(-total_len // self.page_size))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def available_pages(self) -> int:
        """Free pages not yet promised to an admitted sequence."""
        return len(self._free) - sum(self._reserved.values())

    def can_admit(self, total_len: int) -> bool:
        return bool(self._free_slots) and \
            self.pages_needed(total_len) <= self.available_pages

    # ------------------------------------------------------- slot lifecycle

    def admit(self, total_len: int) -> int:
        """Reserve a batch slot + its worst-case page budget."""
        if not self.can_admit(total_len):
            raise RuntimeError("admit() without can_admit() — page pool or "
                               "slot budget exhausted")
        slot = self._free_slots.pop()
        self._reserved[slot] = self.pages_needed(total_len)
        return slot

    def touch(self, slot: int, pos: int) -> bool:
        """Ensure the ring slot covering token position ``pos`` is backed
        by a real page. Returns True when a page was newly assigned."""
        j = (pos // self.page_size) % self.table_width
        if self.tables[slot, j] != TRASH_PAGE:
            return False                               # ring reuse in place
        assert self._reserved.get(slot, 0) > 0, \
            f"slot {slot} touching beyond its reservation"
        page = self._free.pop()
        self.tables[slot, j] = page
        self._owned[slot].append(page)
        self._reserved[slot] -= 1
        return True

    def touch_range(self, slot: int, start: int, end: int) -> int:
        """Back every ring slot a prefill of [start, end) will write.
        Only the last ``table_width`` logical pages can survive the ring,
        so earlier pages are skipped entirely. Returns pages assigned."""
        if end <= start:
            return 0
        first_pg = start // self.page_size
        last_pg = (end - 1) // self.page_size
        first_pg = max(first_pg, last_pg - self.table_width + 1)
        n = 0
        for pg in range(first_pg, last_pg + 1):
            n += self.touch(slot, pg * self.page_size)
        return n

    def release(self, slot: int) -> None:
        """Free the slot's pages + remaining reservation."""
        for page in self._owned[slot]:
            self._free.append(page)
        self._owned[slot] = []
        self.tables[slot, :] = TRASH_PAGE
        self._reserved.pop(slot, None)
        self._free_slots.append(slot)

    # ------------------------------------------------------------ defrag

    def defrag(self) -> np.ndarray:
        """Compact live pages to the low indices. Returns ``perm`` with
        ``perm[old] = new`` over all ``n_pages`` (trash stays 0); the
        caller must re-gather its device pools as ``pool[perm_argsort]``
        — i.e. ``new_pool[new] = old_pool[old]`` — for every layer stack.
        Tables are rewritten in place."""
        live = sorted({int(p) for row in self._owned.values() for p in row})
        perm = np.full((self.n_pages,), -1, np.int64)
        perm[TRASH_PAGE] = TRASH_PAGE
        nxt = 1
        for p in live:
            perm[p] = nxt
            nxt += 1
        for p in range(self.n_pages):
            if perm[p] < 0:
                perm[p] = nxt
                nxt += 1
        self.tables = perm[self.tables].astype(np.int32)
        self._owned = {s: [int(perm[p]) for p in row]
                       for s, row in self._owned.items()}
        self._free = [int(perm[p]) for p in self._free]
        self._free.sort(reverse=True)
        return perm
