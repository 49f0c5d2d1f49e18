"""Drafters for speculative decoding (draft-and-verify decode).

A :class:`Drafter` proposes up to ``k`` continuation tokens for a live
slot from the slot's own token stream; the engine verifies the whole
window against the target model in one batched dispatch
(``make_verify_step``) and commits the longest agreeing prefix plus the
model's correction — so a drafter can never change *what* is emitted,
only how many device dispatches it takes (committed tokens are argmax
outputs of the target model, bit-identical to tick-by-tick decode by
construction).  A bad drafter costs wasted verify lanes; a good one
amortises the fixed per-dispatch cost over several committed tokens —
the serving-side instance of the paper's "schedule additional useful
work instead of idling the core".

The baseline drafter is n-gram **prompt lookup**: no second model, no
device work — the draft is a continuation copied from the most recent
earlier occurrence of the stream's own suffix n-gram.  It hits exactly
on the workloads speculation is famous for (templated/repetitive text,
code, long copies) and degrades to "no draft" elsewhere, which the
policy layer turns into per-slot abandonment
(:meth:`repro_torch.serve.policy.SchedulerPolicy.spec_draft_k`).
"""
from __future__ import annotations

__all__ = ["Drafter", "NgramDrafter", "DRAFTERS", "make_drafter"]


class Drafter:
    """Interface: propose draft tokens for one slot's stream.

    Stateless across slots by design — the engine calls ``draft`` with
    the slot's full host-side context (prompt + emitted tokens), so one
    drafter instance serves every slot and survives eviction/restore
    (the restored stream is the same list).  A model-based drafter would
    hold its own params/cache and batch across slots; it still only has
    to honour this one method."""

    name = "base"

    def draft(self, ctx: list[int], k: int) -> list[int]:
        """Return up to ``k`` proposed continuation tokens for a stream
        whose tokens so far are ``ctx`` (prompt + emitted, host ints).
        Fewer than ``k`` — including none — is always legal."""
        raise NotImplementedError


class NgramDrafter(Drafter):
    """Prompt-lookup drafting: match the longest suffix n-gram of the
    stream against its most recent earlier occurrence and propose the
    tokens that followed it there.

    Longest match first (``max_ngram`` down to ``min_ngram``), most
    recent occurrence first — both choices bias toward the continuation
    the stream is currently in the middle of repeating."""

    name = "ngram"

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        assert 1 <= min_ngram <= max_ngram
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram

    def draft(self, ctx: list[int], k: int) -> list[int]:
        n_ctx = len(ctx)
        if k <= 0 or n_ctx < self.min_ngram + 1:
            return []
        for n in range(min(self.max_ngram, n_ctx - 1), self.min_ngram - 1,
                       -1):
            tail = ctx[n_ctx - n:]
            for i in range(n_ctx - n - 1, -1, -1):
                if ctx[i:i + n] == tail:
                    # i <= n_ctx-n-1, so at least one continuation token
                    return list(ctx[i + n:i + n + k])
        return []


DRAFTERS = {"ngram": NgramDrafter}


def make_drafter(spec) -> Drafter:
    """'ngram' | 'ngram:max,min' | a Drafter instance (passed through)."""
    if isinstance(spec, Drafter):
        return spec
    name, _, arg = str(spec).partition(":")
    if name not in DRAFTERS:
        raise ValueError(f"unknown drafter {spec!r} "
                         f"(have: {sorted(DRAFTERS)})")
    if arg:
        mx, _, mn = arg.partition(",")
        return DRAFTERS[name](int(mx), int(mn) if mn else 1)
    return DRAFTERS[name]()
