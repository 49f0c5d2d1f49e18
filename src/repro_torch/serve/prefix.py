"""Radix prefix cache over the refcounted page pool (SGLang-style
RadixAttention on a vLLM-style pager).

A trie keyed on **full-page token runs** maps prompt prefixes to the
physical KV pages that already hold their K/V content: each node is one
page (``page_size`` tokens); a path from the root spells a prefix.  The
node's cache content is a function of the whole path, not the page's own
tokens alone — position embeddings and attention mix every earlier token
into a position's K/V — which is exactly why the key is the *path* (a
trie) and not a flat page-content hash.

Admission matches a prompt's longest cached prefix (full pages, plus a
partial run into the first diverging page — the copy-on-write fork
source) and points the new slot's block table at the shared pages;
prefill then computes only the uncached tail.  A match takes one pager
hold (``PagePool.share``) per page *under the trie lock*, so the LRU
sweep can never reclaim a page between match and admission.

Ownership and eviction
----------------------
Every node's page is ``cached`` in the pager: it survives refcount 0
(no live slot pointing at it) instead of returning to the free list —
idle KV content is the reuse capital.  Reclaim is **LRU over refcount-0
leaves**: only a leaf can go (an interior node's children encode paths
through it), only at refcount 0 (a held page is in some live block
table), oldest ``last_used`` first; evicting a leaf may expose its
parent as the next candidate.  *When* to reclaim is a policy decision
(``SchedulerPolicy.prefix_evict``) — the engine surfaces pool pressure
there exactly like victim selection, and the paper mapping carries over:
a prefix-cache miss that blocks on held pages is a monitored block whose
matching unblock is the release (slot finish/evict) or LRU reclaim that
frees them.

Insertion is first-wins: if a token run already has a node, the existing
physical page is kept and the inserter's private page simply stays
uncached (freed normally when its slot releases it) — retroactive
re-pointing of a live block table is never attempted.
"""
from __future__ import annotations

import heapq
import threading
from dataclasses import dataclass, field

import numpy as np


def _tokens64(tokens):
    """Canonical token-array form for trie keys: int64, contiguous —
    callers hand prompts as lists, int32 arrays or concatenated
    prompt+generated streams, and ``tobytes`` keys must not depend on
    which."""
    return np.ascontiguousarray(np.asarray(tokens), dtype=np.int64)


def _common_prefix_len(a, b) -> int:
    """Length of the common leading run of two token arrays — rows
    compare whole (codebook vectors count as one token)."""
    n = min(len(a), len(b))
    if n == 0:
        return 0
    eq = a[:n] == b[:n]
    if eq.ndim > 1:
        eq = eq.all(axis=tuple(range(1, eq.ndim)))
    diff = np.flatnonzero(~eq)
    return int(diff[0]) if len(diff) else n


class _Node:
    __slots__ = ("key", "tokens", "page", "parent", "children",
                 "last_used")

    def __init__(self, key, tokens, page, parent):
        self.key = key              # tokens.tobytes() — the child-map key
        self.tokens = tokens        # (page_size[, K]) host copy
        self.page = page            # physical page id (cached in pager)
        self.parent = parent        # None once evicted
        self.children: dict = {}
        self.last_used = 0


@dataclass
class PrefixMatch:
    """One admission's reusable prefix.  ``pages`` are fully-matched
    physical pages and ``fork_src`` the partially-matched divergence
    page (``fork_len`` of its tokens are reusable) — every listed page
    carries one pager hold taken at match time: ``pages`` holds become
    the slot's own at admission, the ``fork_src`` hold is dropped once
    its content has been copied (the COW fork)."""
    pages: list = field(default_factory=list)
    tokens: int = 0
    fork_src: int | None = None
    fork_len: int = 0

    @property
    def full_tokens(self) -> int:
        return self.tokens - self.fork_len


class PrefixCache:
    """The radix trie + LRU sweep.  All public methods are serialized by
    one lock (match-and-hold must be atomic against reclaim); the pager
    has its own inner lock and never calls back into the trie."""

    def __init__(self, pager, page_size: int):
        self.pager = pager
        self.page_size = page_size
        self._root = _Node(b"", None, None, parent=self)  # parent: not None
        self._lock = threading.Lock()
        self._clock = 0
        self.lookups = 0
        self.hits = 0
        self.inserted_pages = 0
        self.evicted_pages = 0

    @property
    def n_pages(self) -> int:
        """Pages currently owned by the trie."""
        with self._lock:
            return self._count(self._root)

    def _count(self, node) -> int:
        return sum(1 + self._count(c) for c in node.children.values())

    def _touch(self, node) -> None:
        self._clock += 1
        node.last_used = self._clock

    # ------------------------------------------------------------ match
    def match_and_lock(self, tokens, max_tokens: int) -> PrefixMatch:
        """Longest cached prefix of ``tokens`` capped at ``max_tokens``
        (the caller passes ``len(tokens) - 1`` so at least one position
        is always recomputed — prefill must produce last-token logits).
        Every returned page is shared (one pager hold) before the lock
        drops, so the LRU sweep cannot reclaim it in between."""
        toks = _tokens64(tokens)
        ps = self.page_size
        m = PrefixMatch()
        with self._lock:
            self.lookups += 1
            node = self._root
            while m.tokens + ps <= max_tokens:
                run = toks[m.tokens:m.tokens + ps]
                child = node.children.get(
                    np.ascontiguousarray(run).tobytes())
                if child is None:
                    break
                node = child
                m.pages.append(child.page)
                m.tokens += ps
                self._touch(child)
            # partial run into the first diverging page: the COW fork
            # source — reuse what matches, recompute the rest of the page
            rest = toks[m.tokens:max_tokens]
            if len(rest):
                best, best_d = None, 0
                for child in node.children.values():
                    d = _common_prefix_len(child.tokens, rest)
                    if d > best_d:
                        best, best_d = child, d
                if best is not None:
                    m.fork_src = best.page
                    m.fork_len = best_d
                    m.tokens += best_d
                    self._touch(best)
            if m.tokens:
                self.hits += 1
                held = m.pages + (
                    [m.fork_src] if m.fork_src is not None else [])
                self.pager.share(held)
        return m

    def release(self, m: PrefixMatch) -> None:
        """Drop every hold a match still carries (failure paths: the
        admission that would have adopted them never happened)."""
        held = m.pages + ([m.fork_src] if m.fork_src is not None else [])
        if held:
            self.pager.release(held)
        m.pages, m.fork_src, m.fork_len, m.tokens = [], None, 0, 0

    def release_fork(self, m: PrefixMatch) -> None:
        """Drop the fork-source hold once its content has been copied
        into the admitted slot's private page (the COW fork is done)."""
        if m.fork_src is not None:
            self.pager.release([m.fork_src])
            m.fork_src = None

    # ------------------------------------------------------------ insert
    def insert(self, tokens, page_ids, n_tokens: int) -> int:
        """Cache the full-page runs covering ``tokens[:n_tokens]``,
        backed by ``page_ids`` (physical page per logical page index).
        Only *complete* pages whose content is fully written enter the
        trie — the caller passes ``n_tokens`` = the written extent, and
        the page containing any position the slot may still write is
        never included (floor division drops it).  First-wins on
        existing runs.  Returns pages newly cached."""
        toks = _tokens64(tokens)
        ps = self.page_size
        added = 0
        with self._lock:
            node = self._root
            for p in range(n_tokens // ps):
                run = np.ascontiguousarray(toks[p * ps:(p + 1) * ps])
                key = run.tobytes()
                child = node.children.get(key)
                if child is None:
                    pid = int(page_ids[p])
                    self.pager.cache_pages([pid])
                    child = _Node(key, run.copy(), pid, parent=node)
                    node.children[key] = child
                    added += 1
                self._touch(child)
                node = child
            self.inserted_pages += added
        return added

    # ------------------------------------------------------------ evict
    def evict_lru(self, n_pages: int) -> int:
        """Reclaim up to ``n_pages`` pages: refcount-0 leaves, oldest
        ``last_used`` first; a freed leaf may expose its parent as the
        next candidate.  Returns pages actually freed (pages a live slot
        still holds are skipped — their release is the later unblock)."""
        freed = 0
        with self._lock:
            heap = []
            seq = 0

            def push(node):
                nonlocal seq
                if not node.children:
                    heapq.heappush(heap, (node.last_used, seq, node))
                    seq += 1

            def walk(node):
                for c in node.children.values():
                    walk(c)
                if node is not self._root:
                    push(node)

            walk(self._root)
            while heap and freed < n_pages:
                _, _, node = heapq.heappop(heap)
                if node.parent is None or node.children:
                    continue            # already evicted / grew children
                if self.pager.refcount(node.page) != 0:
                    continue            # held by a live block table
                parent = node.parent
                del parent.children[node.key]
                node.parent = None
                freed += self.pager.uncache([node.page])
                self.evicted_pages += 1
                if parent is not self._root and parent.parent is not None:
                    push(parent)
        return freed

    def clear(self) -> int:
        """Drop the whole trie (engine teardown/tests): uncache every
        node's page.  Returns pages freed now (refcount-0)."""
        freed = 0
        with self._lock:
            stack = list(self._root.children.values())
            self._root.children = {}
            while stack:
                node = stack.pop()
                stack.extend(node.children.values())
                node.parent = None
                node.children = {}
                freed += self.pager.uncache([node.page])
                self.evicted_pages += 1
        return freed

    def stats(self) -> dict:
        with self._lock:
            n = self._count(self._root)
        return {
            "prefix_nodes": n,
            "prefix_lookups": self.lookups,
            "prefix_trie_hits": self.hits,
            "prefix_inserted_pages": self.inserted_pages,
            "prefix_evicted_pages": self.evicted_pages,
        }

    def __repr__(self):
        return (f"<PrefixCache pages={self.n_pages} "
                f"hits={self.hits}/{self.lookups}>")
