"""Paged KV cache: a free-list page allocator plus the lane page table.

The device side is the model's page pools (``Model.new_paged_cache``): per
layer one K and one V pool of ``n_pages + 1`` fixed-size pages, the last
row the trash page idle writes land on.  All policy lives here on the
host: which physical pages a request owns, and the ``[n_lanes,
pages_per_lane]`` int32 table the device reads them through.

Pages are handed out from a LIFO free list, so a retired request's pages
are recycled by the next admission; a lane's logical pages are in
ascending position order, so logical page index times page size is the
global position.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch


class PageAllocator:
    """Free-list allocator over ``n_pages`` fixed-size pages.

    ``alloc(n)`` returns ``n`` page ids or ``None`` when the pool cannot
    satisfy the request now (the scheduler's signal to queue or shed: page
    exhaustion is a load condition, not a bug).  ``free`` returns pages
    LIFO."""

    def __init__(self, n_pages: int):
        if n_pages < 1:
            raise ValueError(f"n_pages must be >= 1, got {n_pages}")
        self.n_pages = n_pages
        self._free: List[int] = list(range(n_pages - 1, -1, -1))

    @property
    def n_free(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        if n < 1:
            raise ValueError(f"alloc needs n >= 1, got {n}")
        if n > len(self._free):
            return None
        return [self._free.pop() for _ in range(n)]

    def free(self, pages: List[int]) -> None:
        for p in pages:
            if not (0 <= p < self.n_pages):
                raise ValueError(f"freeing unknown page {p}")
            if p in self._free:
                raise ValueError(f"double free of page {p}")
        self._free.extend(reversed(pages))


class PagedKVCache:
    """Host-side owner of the device page pools and the lane page table.

    ``pages_per_lane`` bounds one request's footprint (the table width, a
    shape constant of every step); ``n_pages`` bounds the whole pool.
    ``admit(lane, total_len)`` maps a lane for a request of ``total_len =
    prompt + max_new`` positions, ``release(lane)`` recycles its pages.
    ``table_device()`` uploads the table again only after an admission or
    a retirement changed it.
    """

    def __init__(self, model, n_lanes: int, n_pages: int, page_size: int,
                 pages_per_lane: int):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if pages_per_lane < 1:
            raise ValueError(
                f"pages_per_lane must be >= 1, got {pages_per_lane}")
        self.n_lanes = n_lanes
        self.n_pages = n_pages
        self.page_size = page_size
        self.pages_per_lane = pages_per_lane
        self.device = model.device
        self.pools = model.new_paged_cache(n_pages, page_size)
        self.allocator = PageAllocator(n_pages)
        self.table = np.full((n_lanes, pages_per_lane), -1, np.int32)
        self.lane_pages: List[Optional[List[int]]] = [None] * n_lanes
        self._table_dev: Optional[torch.Tensor] = None

    def pages_needed(self, total_len: int) -> int:
        if total_len < 1:
            # a zero-length request owns no positions and can never be
            # mapped: callers shed it through ``fits_ever``
            raise ValueError(f"total_len must be >= 1, got {total_len}")
        return -(-total_len // self.page_size)

    def fits_ever(self, total_len: int) -> bool:
        """Could this request ever be admitted (empty pool, any lane)?
        False means shed it now: queueing it would deadlock."""
        if total_len < 1:
            return False
        return self.pages_needed(total_len) <= min(self.pages_per_lane,
                                                   self.n_pages)

    def admit(self, lane: int, total_len: int) -> bool:
        """Map ``lane`` for a ``total_len``-position request.  False =
        transient page exhaustion (the caller keeps the request queued).
        An unservable request raises before any allocation, so a failed
        admission never strands pages."""
        if self.lane_pages[lane] is not None:
            raise ValueError(f"lane {lane} already mapped")
        if not self.fits_ever(total_len):
            raise ValueError(
                f"admit of unservable request (total_len={total_len}, "
                f"pages_per_lane={self.pages_per_lane}): shed it via "
                f"fits_ever before admitting")
        pages = self.allocator.alloc(self.pages_needed(total_len))
        if pages is None:
            return False
        self.lane_pages[lane] = pages
        self.table[lane] = -1
        self.table[lane, :len(pages)] = pages
        self._table_dev = None
        return True

    def release(self, lane: int) -> None:
        pages = self.lane_pages[lane]
        if pages is None:
            return
        self.allocator.free(pages)
        self.lane_pages[lane] = None
        self.table[lane] = -1
        self._table_dev = None

    def table_device(self) -> torch.Tensor:
        if self._table_dev is None:
            self._table_dev = torch.from_numpy(self.table.copy()).to(
                self.device)
        return self._table_dev
