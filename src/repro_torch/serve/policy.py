"""Scheduling *policy* for the serve engine — every decision the engine
used to hard-code, factored into one replaceable layer.

Mechanism/policy split (paper mapping)
--------------------------------------
The paper's architecture puts *mechanism* in the kernel (block/unblock
event channels) and *policy* in the user-space runtime that has full
visibility of the task graph; Roca et al.'s follow-up argues the same
separation one level up — runtime mechanism, coordinating-layer policy.
``repro_torch.serve`` now mirrors that split exactly:

* **mechanism** (``engine.py``, ``kvstate.py``, ``pager.py``): the task
  graph, jit dispatch, buffer donation/pinning, block tables and the
  page free-list — how things happen;
* **policy** (this module): *which* request is admitted or deferred, how
  arrival rounds are batched and chunked, and — under memory pressure —
  which victim is evicted so a blocked slot can grow: what happens.

A policy object is a bundle of small pure decision methods; it owns no
device state and never touches the cache.  Each method receives the
engine (for geometry/config) plus the minimal state the decision needs
(:class:`SlotView` snapshots for victim selection).

The two shipped policies
------------------------
:class:`SchedulerPolicy` (``"reserve"``) is the pre-split behaviour:
worst-case page reservation at admission.  A request that is admitted
can always finish, so admission simply *blocks* on pool exhaustion (the
paper's monitored block; the free at completion is the unblock) and
no eviction is ever needed — but every admitted request idles the pages
between its current position and its worst case, exactly like an idle
core idles cycles.

:class:`OnDemandPolicy` (``"ondemand"``) allocates only the pages the
prefill actually writes; a slot's block table then *grows* as decode
crosses page boundaries (``KVState.grow_slot_pages``).  Page exhaustion
mid-decode surfaces as a block the policy resolves by **preemption**:
it picks the youngest live slot as victim, the engine evicts it
(recompute-on-restore, vLLM-style), and the freed pages are the unblock
that lets the older slot grow.  Deadlock-freedom argument: a single
request's worst case is validated against pool capacity at submission,
so a lone live slot can always grow from the free list; with two or
more live slots every victim holds at least one page, so each eviction
strictly frees memory and the *oldest* slot — never the default
victim while others live — always runs to completion.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class SlotView:
    """Read-only snapshot of one live slot for policy decisions.

    ``admit_seq`` orders slots by admission time (higher = younger);
    ``pages_held`` is the physical pages currently bound (0 when dense);
    ``next_pos`` is the cache position the next decode tick will write;
    ``emitted``/``budget`` are tokens generated so far / ``max_new``.
    """
    slot: int
    rid: object
    admit_seq: int
    pages_held: int
    next_pos: int
    emitted: int
    budget: int


class SchedulerPolicy:
    """Default policy: worst-case reservation, FIFO admission, never
    evicts.  Subclass and override individual decisions; instances hold
    no engine state and may be shared across engines."""

    name = "reserve"
    #: admission reserves less than the worst case, so live slots may
    #: page-fault mid-decode and the engine consults ``select_victim``
    on_demand = False

    # ------------------------------------------------- prefill composition
    def prefill_batch_cap(self, eng) -> int | None:
        """Max requests coalesced into one prefill round (None = no cap)."""
        return eng.max_prefill_batch

    def chunk_len(self, eng, total_len: int) -> int | None:
        """Chunk size for a prefill round of ``total_len``-token prompts,
        or None for one-shot prefill.  Only consulted when the engine was
        built with a chunk jit (``prefill_chunk`` set)."""
        if eng.prefill_chunk is not None and total_len > eng.prefill_chunk:
            return eng.prefill_chunk
        return None

    # ------------------------------------------------------------ admission
    def admission_tokens(self, eng, req) -> int:
        """Token slots to reserve pages for when admitting ``req``:
        worst case — every position the request could ever write.  Called
        at insert time, when the prefill wrote positions
        ``[0, total_len)`` and each remaining decode tick (one per token
        still owed; the prefill/restore argmax is already in
        ``out_tokens``) writes one more.  Deadlock-free, utilisation-poor."""
        return req.total_len + (req.max_new - len(req.out_tokens))

    def select_slot(self, eng, free) -> int:
        """Which free slot the admitted request lands in."""
        return int(free[0])

    # ------------------------------------------------- paging / preemption
    def select_victim(self, eng, views: list[SlotView],
                      needy: int | None = None) -> int | None:
        """Victim slot when slot ``needy`` cannot grow (page exhaustion —
        the block this policy must unblock by freeing pages), or None to
        declare no victim.  Worst-case reservation never faults, so the
        base policy is never consulted; returning None from an on-demand
        policy is a hard error (the engine fails loudly rather than
        deadlock)."""
        return None

    def maybe_evict(self, eng, views: list[SlotView]) -> int | None:
        """Unforced preemption hook, consulted once per decode tick —
        None keeps ticking.  The base engine never needs it; tests and
        experimental policies (priority preemption, fairness churn) evict
        through this without touching mechanism."""
        return None

    # ------------------------------------------------ speculative decoding
    #: abandon speculation for a slot whose measured acceptance rate has
    #: fallen below this after ``spec_warmup`` drafted tokens — a stream
    #: the drafter cannot predict should pay 1 dispatch/token, not
    #: 1 dispatch/token *plus* wasted verify lanes
    spec_min_accept = 0.1
    spec_warmup = 16

    def spec_draft_k(self, eng, req) -> int:
        """Draft window length for this slot this tick (0 = plain decode
        tick for the slot).  Speculation is a *policy* decision: how hard
        to speculate is the serving analogue of how much extra work to
        schedule on an idle core — pure upside when drafts hit (several
        committed tokens amortise one dispatch), pure waste when they
        miss (the dispatch still commits exactly one token, slightly
        wider).  Output tokens never depend on it.  The engine clamps
        the return to its static pad width (``eng.spec_k``) and to the
        slot's remaining budget."""
        if (req.spec_drafted >= self.spec_warmup and
                req.spec_accepted < self.spec_min_accept * req.spec_drafted):
            return 0
        return eng.spec_k

    def spec_drafter(self, eng, mode):
        """Drafter instance for engine spec mode ``mode`` — which drafts
        to trust is policy, not mechanism.  Override to swap in a
        model-based drafter without touching the engine."""
        from .spec import make_drafter
        return make_drafter(mode)

    def prefix_evict(self, eng, need_pages: int) -> int:
        """Prefix-cache reclaim decision, consulted when the pool cannot
        cover an allocation (admission reservation or on-demand growth)
        before the block is surfaced — the cheaper sibling of
        ``select_victim``: evicting idle cached pages costs only future
        reuse, evicting a live slot costs recompute.  Returns pages
        actually freed; the engine retries the allocation with them.
        Default: LRU over the trie's refcount-0 leaves, exactly
        ``need_pages`` worth.  Override to keep hot prefixes resident
        (evict-nothing => admission blocks instead, the paper's
        monitored block whose unblock is a later release)."""
        if eng.prefix is None:
            return 0
        return eng.prefix.evict_lru(need_pages)

    def __repr__(self):
        return f"<{type(self).__name__} {self.name!r}>"


class OnDemandPolicy(SchedulerPolicy):
    """On-demand paging with preemption-by-eviction (vLLM-style).

    Admission reserves only the prefill extent; decode grows the block
    table page by page, and on exhaustion the *youngest* live slot is
    evicted (its recompute-on-restore work is the smallest, and sparing
    the oldest guarantees forward progress — see module docstring)."""

    name = "ondemand"
    on_demand = True

    def admission_tokens(self, eng, req) -> int:
        return req.total_len

    def select_victim(self, eng, views, needy=None):
        if not views:
            return None
        return max(views, key=lambda v: v.admit_seq).slot


POLICIES = {p.name: p for p in (SchedulerPolicy, OnDemandPolicy)}


def make_policy(spec) -> SchedulerPolicy:
    """Resolve an engine ``policy=`` argument: None -> the default
    worst-case policy, a name from :data:`POLICIES`, or an instance."""
    if spec is None:
        return SchedulerPolicy()
    if isinstance(spec, str):
        if spec not in POLICIES:
            raise ValueError(f"unknown policy {spec!r}: "
                             f"pick one of {sorted(POLICIES)}")
        return POLICIES[spec]()
    if isinstance(spec, SchedulerPolicy):
        return spec
    raise TypeError(f"policy must be None, a name or a SchedulerPolicy, "
                    f"got {type(spec).__name__}")
