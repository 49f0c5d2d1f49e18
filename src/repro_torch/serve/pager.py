"""Free-list pager for the paged KV cache (vLLM-style block allocator,
now with per-page refcounts for shared-prefix reuse).

The serve engine's linear attention cache leaves are pools of
``num_pages`` physical pages of ``page_size`` token slots (see
``repro_torch.steps.init_paged_slot_cache``).  This module owns the *host-side*
accounting: which physical pages are free, which belong to which
request, and — since the radix prefix cache (``repro_torch.serve.prefix``) —
how many holders each page has.  *How many* pages a request reserves is
a policy decision (``repro_torch.serve.policy``): the default worst-case
policy reserves every page a request could ever touch
(``prompt + max_new - 1`` token slots) at admission — a request that is
admitted can then always run to completion, so admission simply *blocks*
until enough pages free up, deadlock-free.  The on-demand policy
reserves only the prefill extent and grows page by page mid-decode
(``alloc(1)`` per crossing — a speculative verify window can cross
several page boundaries in one tick, so the engine's fault pass may
alloc more than once per slot per tick); exhaustion there is resolved
by eviction, not by waiting.  Either way the pager stays pure mechanism: an all-or-nothing
free list, no partial grants, a freed page immediately reusable by any
slot.

Refcounts and the prefix cache
------------------------------
A page's refcount is its number of *holders*: one per live slot whose
block table points at it (``alloc`` hands pages out at refcount 1;
``share`` adds a holder when a second slot's table points at the same
physical page).  ``release`` drops one hold; the free list only ever
reclaims refcount-0 pages.  Orthogonally, a page can be **cached** —
owned by the radix prefix trie: a cached page at refcount 0 stays
*allocated* (its KV content is the reuse capital) until the trie's LRU
eviction ``uncache``-s it, at which point refcount 0 finally returns it
to the free list.  The two axes never mix silently: ``free`` (sole-owner
teardown, kept for the pre-refcount call sites and tests) raises loudly
on a shared (refcount > 1) or cached page, and a ``release`` past
refcount 0 raises instead of corrupting the free list.

Page 0 is the reserved **garbage page**: it is never handed out.  Dead
slots' block tables and unreserved logical pages point at it, so their
(masked, frozen-position) cache scatters land there instead of on a live
slot's pages.

The pager is plain host state guarded by one lock — it is touched a few
times per *request* (alloc at insert, release at completion), never per
token.
"""
from __future__ import annotations

import threading

GARBAGE_PAGE = 0


class PagePool:
    """Refcounted free-list allocator over pages ``1 .. num_pages - 1``.

    ``alloc`` is all-or-nothing (no partial grants — the engine blocks
    admission instead), ``release`` returns refcount-0 pages in any
    order (fragmentation is irrelevant: the block table gives every slot
    a fully scattered view).  Tracks ``used_peak`` for the benchmark's
    pool-occupancy report and cumulative ``shares`` for the prefix-reuse
    one.
    """

    def __init__(self, num_pages: int, page_size: int):
        assert num_pages >= 2, "need >= 1 usable page + garbage page 0"
        assert page_size >= 1
        self.num_pages = num_pages
        self.page_size = page_size
        # LIFO free list, seeded so the first allocations hand out
        # ascending ids (nicer to read in tests/traces)
        self._free = list(range(num_pages - 1, GARBAGE_PAGE, -1))
        self._ref = [0] * num_pages      # holders per page (slots)
        self._cached = [False] * num_pages   # owned by the prefix trie
        self._lock = threading.Lock()
        self.used_peak = 0
        self.allocs = 0
        self.alloc_failures = 0
        self.shares = 0
        self.debug_validate = False      # consistency scan per mutation

    @property
    def capacity(self) -> int:
        """Usable pages (excludes the garbage page)."""
        return self.num_pages - 1

    @property
    def free_pages(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.capacity - self.free_pages

    @property
    def cached_pages(self) -> int:
        """Pages currently owned by the prefix trie (allocated even at
        refcount 0 — the reclaimable reuse capital)."""
        with self._lock:
            return sum(self._cached)

    @property
    def shared_pages(self) -> int:
        """Pages with more than one holder right now (block tables of
        two or more live slots point at the same physical page)."""
        with self._lock:
            return sum(1 for r in self._ref if r > 1)

    @property
    def live_refs(self) -> int:
        """Total holds across all pages (0 after a clean drain)."""
        with self._lock:
            return sum(self._ref)

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` token slots."""
        return max(0, -(-n_tokens // self.page_size))

    def reserve(self, n_tokens: int) -> list[int] | None:
        """Admission reservation: the pages covering ``n_tokens`` token
        slots, all-or-nothing.  The policy chooses ``n_tokens`` — the
        request's worst case (deadlock-free blocking admission) or just
        its prefill extent (on-demand paging, grown later via
        ``alloc(1)``)."""
        return self.alloc(self.pages_for(n_tokens))

    def alloc(self, n_pages: int) -> list[int] | None:
        """Take ``n_pages`` pages off the free list at refcount 1, or
        ``None`` (and no partial grant) when fewer are free — the caller
        blocks admission / reclaims prefix-cache pages and retries."""
        with self._lock:
            if n_pages > len(self._free):
                self.alloc_failures += 1
                return None
            ids = [self._free.pop() for _ in range(n_pages)]
            for i in ids:
                assert self._ref[i] == 0 and not self._cached[i], (
                    f"page {i} on the free list with ref "
                    f"{self._ref[i]}/cached {self._cached[i]}")
                self._ref[i] = 1
            self.allocs += 1
            used = self.capacity - len(self._free)
            if used > self.used_peak:
                self.used_peak = used
            if self.debug_validate:
                self._validate_locked()
            return ids

    def share(self, ids) -> None:
        """Add one holder to each page in ``ids`` — a second block table
        now points at the same physical page (prefix-cache hit).  Valid
        on any *allocated* page, including a cached page idling at
        refcount 0; a free-list page raises (sharing garbage)."""
        with self._lock:
            for i in ids:
                self._check_id(i)
                assert self._ref[i] > 0 or self._cached[i], (
                    f"share of unallocated page {i}")
                self._ref[i] += 1
                self.shares += 1
            if self.debug_validate:
                self._validate_locked()

    def release(self, ids) -> None:
        """Drop one hold per page.  A page at refcount 0 returns to the
        free list unless the prefix trie owns it (``cached`` — it stays
        allocated, reclaimable via :meth:`uncache`).  Releasing past
        refcount 0 raises loudly — that is a double release, and
        appending the page to the free list twice would hand the same
        physical page to two requests."""
        with self._lock:
            for i in ids:
                self._check_id(i)
                if self._ref[i] <= 0:
                    raise AssertionError(
                        f"double release of page {i} (refcount already 0)")
                self._ref[i] -= 1
                if self._ref[i] == 0 and not self._cached[i]:
                    self._free.append(i)
            if self.debug_validate:
                self._validate_locked()

    def cache_pages(self, ids) -> None:
        """Hand ownership of (already-allocated) pages to the prefix
        trie: they now survive refcount 0 instead of returning to the
        free list.  Idempotent per page."""
        with self._lock:
            for i in ids:
                self._check_id(i)
                assert self._ref[i] > 0 or self._cached[i], (
                    f"caching unallocated page {i}")
                self._cached[i] = True
            if self.debug_validate:
                self._validate_locked()

    def uncache(self, ids) -> int:
        """Trie LRU eviction: withdraw trie ownership; pages already at
        refcount 0 return to the free list *now* (the reclaim), pages a
        live slot still holds return whenever their last holder
        releases.  Returns how many pages were actually freed."""
        freed = 0
        with self._lock:
            for i in ids:
                self._check_id(i)
                assert self._cached[i], f"uncache of uncached page {i}"
                self._cached[i] = False
                if self._ref[i] == 0:
                    self._free.append(i)
                    freed += 1
            if self.debug_validate:
                self._validate_locked()
        return freed

    def free(self, ids) -> None:
        """Sole-owner teardown (the pre-refcount API, kept for direct
        allocator users): each page must have exactly one holder and no
        trie ownership — freeing a shared or cached page would yank KV
        content another block table (or a future prefix hit) still
        reads, so both raise loudly instead of corrupting the list."""
        with self._lock:
            for i in ids:
                self._check_id(i)
                assert i not in self._free, f"double free of page {i}"
                if self._ref[i] > 1:
                    raise AssertionError(
                        f"free of shared page {i} "
                        f"(refcount {self._ref[i]} > 1) — release holds "
                        "instead")
                if self._cached[i]:
                    raise AssertionError(
                        f"free of prefix-cached page {i} — the trie owns "
                        "it; uncache first")
                if self._ref[i] <= 0:
                    raise AssertionError(
                        f"double free of page {i} (refcount already 0)")
                self._ref[i] = 0
                self._free.append(i)
            if self.debug_validate:
                self._validate_locked()

    def refcount(self, page: int) -> int:
        with self._lock:
            return self._ref[page]

    def is_cached(self, page: int) -> bool:
        with self._lock:
            return self._cached[page]

    def _check_id(self, i) -> None:
        assert GARBAGE_PAGE < i < self.num_pages, f"bad page id {i}"

    def _validate_locked(self) -> None:
        free = set(self._free)
        assert len(free) == len(self._free), "free list has duplicates"
        assert GARBAGE_PAGE not in free, "garbage page on the free list"
        for i in range(1, self.num_pages):
            r, c = self._ref[i], self._cached[i]
            assert r >= 0, f"page {i}: negative refcount {r}"
            if i in free:
                assert r == 0 and not c, (
                    f"page {i} free with ref {r}/cached {c}")
            else:
                assert r > 0 or c, (
                    f"page {i} allocated with no holder and no trie "
                    "owner — leaked")

    def debug_validate_now(self) -> None:
        """One-shot refcount/free-list consistency check (tests)."""
        with self._lock:
            self._validate_locked()

    def stats(self) -> dict:
        with self._lock:
            free = len(self._free)
            cached = sum(self._cached)
            shared = sum(1 for r in self._ref if r > 1)
        return {
            "num_pages": self.num_pages,
            "page_size": self.page_size,
            "pages_capacity": self.capacity,
            "pages_free": free,
            "pages_used": self.capacity - free,
            "pages_used_peak": self.used_peak,
            "page_allocs": self.allocs,
            "page_alloc_failures": self.alloc_failures,
            "page_shares": self.shares,
            "pages_cached": cached,
            "shared_pages": shared,
        }

    def __repr__(self):
        return (f"<PagePool {self.used_pages}/{self.capacity} used "
                f"(page_size={self.page_size}, peak={self.used_peak}, "
                f"cached={self.cached_pages})>")
