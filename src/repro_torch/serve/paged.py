"""Paged KV-cache accounting: fixed-size pages, owner page lists, quotas.

The port's own copy of ``repro.serve.paged``: a free-list ledger of
fixed-size KV-cache pages with per-owner page lists, live per-tenant
quotas and a reserved null page. The physical ``Engine`` keys owners by
batch-slot index and points every inactive row's page table at the null
page. Plain ints and lists; no tensor touches this module.

Conservation invariants are guarded raises (``ServeInvariantError``), not
asserts, so they survive ``python -O``. The error class lives here until
the serve driver is ported, and then moves to ``serve/driver.py``.
"""
from __future__ import annotations

from typing import Callable, Dict, Hashable, List, Optional

__all__ = ["PagedKVAllocator", "ServeInvariantError", "pages_for"]


class ServeInvariantError(RuntimeError):
    """A serving invariant broke: the page ledger and the slots disagree."""


def pages_for(tokens: int, page_size: int) -> int:
    """Pages needed to hold ``tokens`` KV entries (at least one page)."""
    if page_size <= 0:
        raise ValueError("page_size must be positive")
    return max(-(-max(int(tokens), 1) // page_size), 1)


class PagedKVAllocator:
    """Free-list allocator for fixed-size KV pages with per-tenant quotas.

    Parameters
    ----------
    n_pages:
        Total pages in the pool, *including* any reserved null page.
    page_size:
        Tokens per page (recorded for callers; the allocator itself only
        counts pages).
    pages_per_unit:
        Pages that one provider node unit entitles a tenant to. Quota
        checks compare ``tenant_pages(t) <= quota_supplier(t)`` where the
        supplier is typically ``granted_units * pages_per_unit``.
    reserve_null:
        When True, page 0 is reserved as a scratch/null page that is never
        handed out. The physical engine points every inactive batch row's
        page table at it so stray decode writes can never land in a page
        owned by an active slot.
    """

    def __init__(self, n_pages: int, *, page_size: int = 1,
                 pages_per_unit: int = 1, reserve_null: bool = False):
        if n_pages < (2 if reserve_null else 1):
            raise ValueError("paged pool needs at least one allocatable page")
        if page_size <= 0 or pages_per_unit <= 0:
            raise ValueError("page_size and pages_per_unit must be positive")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self.pages_per_unit = int(pages_per_unit)
        self.null_page: Optional[int] = 0 if reserve_null else None
        first = 1 if reserve_null else 0
        # LIFO free list: freshly freed pages are reused first (cache-warm).
        self._free: List[int] = list(range(self.n_pages - 1, first - 1, -1))
        self._owned: Dict[Hashable, List[int]] = {}
        self._tenant_of: Dict[Hashable, Optional[str]] = {}
        self._quota: Dict[str, Callable[[], int]] = {}
        self.peak_used = 0

    # ------------------------------------------------------------- queries
    @property
    def capacity_pages(self) -> int:
        return self.n_pages - (1 if self.null_page is not None else 0)

    @property
    def used_pages(self) -> int:
        return self.capacity_pages - len(self._free)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def pages_of(self, owner: Hashable) -> List[int]:
        return list(self._owned.get(owner, ()))

    def owners(self) -> List[Hashable]:
        return list(self._owned)

    def tenant_pages(self, tenant: str) -> int:
        return sum(len(pages) for owner, pages in self._owned.items()
                   if self._tenant_of.get(owner) == tenant)

    def set_quota(self, tenant: str, supplier: Callable[[], int]) -> None:
        """Register a live page-quota supplier (e.g. granted units * rate)."""
        self._quota[tenant] = supplier

    # ----------------------------------------------------------- lifecycle
    def alloc(self, owner: Hashable, n: int, *,
              tenant: Optional[str] = None) -> List[int]:
        """Allocate ``n`` pages for ``owner``; raises on any ledger breach.

        Allocation failure is an invariant error by design: every caller
        sizes its request from the same ``decode_budget``/``pages_for``
        formulas that sized the pool, so a failed alloc means the slot
        arithmetic and the physical pool disagree.
        """
        if n <= 0:
            raise ServeInvariantError(f"alloc of {n} pages for {owner!r}")
        if owner in self._owned:
            raise ServeInvariantError(f"owner {owner!r} already holds pages")
        if n > len(self._free):
            raise ServeInvariantError(
                f"paged pool exhausted: need {n}, free {len(self._free)} "
                f"of {self.capacity_pages}")
        if tenant is not None and tenant in self._quota:
            quota = self._quota[tenant]()
            if self.tenant_pages(tenant) + n > quota:
                raise ServeInvariantError(
                    f"tenant {tenant!r} page quota exceeded: "
                    f"{self.tenant_pages(tenant)} + {n} > {quota}")
        pages = [self._free.pop() for _ in range(n)]
        self._owned[owner] = pages
        self._tenant_of[owner] = tenant
        self.peak_used = max(self.peak_used, self.used_pages)
        return list(pages)

    def free(self, owner: Hashable) -> List[int]:
        """Return ``owner``'s pages to the free list."""
        if owner not in self._owned:
            raise ServeInvariantError(f"free of unknown owner {owner!r}")
        pages = self._owned.pop(owner)
        self._tenant_of.pop(owner, None)
        self._free.extend(reversed(pages))
        return list(pages)

    # A preemption is physically identical to a finish: the pages come
    # back whole; only the caller's bookkeeping (requeue vs retire)
    # differs. Kept as a named alias so call sites read correctly.
    preempt = free

    # ----------------------------------------------------------- invariant
    def check_conservation(self) -> None:
        """Guarded conservation sweep: raises ``ServeInvariantError``.

        - used + free == capacity (no page leaked or minted),
        - no page double-mapped across owners,
        - the null page is never owned,
        - every tenant with a registered quota is within it.
        """
        seen: Dict[int, Hashable] = {}
        for owner, pages in self._owned.items():
            for p in pages:
                if p in seen:
                    raise ServeInvariantError(
                        f"page {p} double-mapped: {seen[p]!r} and {owner!r}")
                if self.null_page is not None and p == self.null_page:
                    raise ServeInvariantError(
                        f"null page owned by {owner!r}")
                if not 0 <= p < self.n_pages:
                    raise ServeInvariantError(f"page {p} out of range")
                seen[p] = owner
        in_free = set(self._free)
        if len(in_free) != len(self._free):
            raise ServeInvariantError("duplicate pages on the free list")
        if in_free & set(seen):
            raise ServeInvariantError("page both free and owned")
        if len(seen) + len(self._free) != self.capacity_pages:
            raise ServeInvariantError(
                f"page conservation broken: {len(seen)} owned + "
                f"{len(self._free)} free != {self.capacity_pages}")
        for tenant, supplier in self._quota.items():
            used = self.tenant_pages(tenant)
            quota = supplier()
            if used > quota:
                raise ServeInvariantError(
                    f"tenant {tenant!r} over page quota: {used} > {quota}")
