"""Host-side page-pool accounting for the continuous-batching engine.

The device side is a fixed [L, P, ps, ...] pool per cache leaf
(models/model.make_paged_cache); this module owns which of the P pages
belong to which request.  Page 0 is reserved as the scratch page: free
and still-prefilling slots point at it during a decode tick, so their
masked writes never touch live pages.

Admission is all-or-nothing: a request is admitted only when every page
it can ever need (ceil((prompt + max_new) / ps)) is free, so a running
request never meets an exhausted pool (no preemption).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class PagePool:
    num_pages: int          # total pool pages, page 0 reserved for scratch
    page_size: int

    def __post_init__(self):
        if self.num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the scratch page)")
        # LIFO free list keeps recently freed pages hot
        self._free = list(range(self.num_pages - 1, 0, -1))
        self.in_use = 0
        self.peak_in_use = 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def pages_for(self, tokens: int) -> int:
        return -(-tokens // self.page_size)

    def alloc(self, n: int) -> list[int] | None:
        """n pages, or None (the caller keeps the request queued)."""
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        self.in_use += n
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return pages

    def release(self, pages: list[int]) -> None:
        if 0 in pages:
            raise ValueError("the scratch page is never allocated")
        self._free.extend(pages)
        self.in_use -= len(pages)
