"""Single-owner KV state for the serve engine: the cache tree and, when
paged, the block table (a host copy plus a device mirror) and the page
free list.

Ownership: exactly one live version of the cache exists and
:class:`KVState` holds it.  Every step that rewrites the cache (decode
tick, slot insert) updates the pool in place and hands back the same
tensors; the engine rebinds through :meth:`KVState.commit`.

Why there are no pins here.  The reference pins displaced versions and
dispatch temporaries (``repro/serve/kvstate.py``, ``pin``/``flush``)
because on its JAX backend a buffer whose last Python reference dropped
could be recycled while a dispatched computation still read it
(``examples/repro_buffer_lifetime.py``).  PyTorch's CUDA caching
allocator is stream-ordered: memory freed by Python is handed out again
only to work queued after it on the same stream, so a pending kernel
always reads its inputs before a reuse can write them.  Every task of
the engine, on every UMT worker thread, queues its device work on the
current (default) stream, and no side stream is used, so that guarantee
covers the whole engine.  The one host-to-device hazard left — a mirror
aliasing a numpy buffer the host mutates later — is avoided by making
each device mirror a fresh copy staged through its own pinned buffer
(:meth:`to_dev`); the block-table mirror is rebuilt, never written in
place, at each :meth:`sync_table`.
"""
from __future__ import annotations

import numpy as np
import torch

from ..steps import init_paged_slot_cache, init_slot_cache
from .pager import GARBAGE_PAGE, PagePool


class KVState:
    """Single owner of one slot pool's KV cache (dense or paged)."""

    def __init__(self, cfg, slots: int, cache_len: int, dtype, *,
                 page_size: int | None = None, num_pages: int | None = None,
                 device="cuda"):
        self.cfg = cfg
        self.slots = slots
        self.cache_len = cache_len
        self.page_size = page_size
        self.paged = page_size is not None
        self.device = torch.device(device)
        if self.paged:
            if cache_len % page_size:
                raise ValueError(f"page_size {page_size} must divide "
                                 f"cache_len {cache_len}")
            self.pages_per_slot = cache_len // page_size
            if num_pages is None:
                num_pages = slots * self.pages_per_slot + 1
            self.pager = PagePool(num_pages, page_size)
            self.cache = init_paged_slot_cache(cfg, slots, cache_len, dtype,
                                               page_size, num_pages,
                                               self.device)
            self._table = np.zeros((slots, self.pages_per_slot), np.int32)
            self.table_dev = self.to_dev(self._table)
        else:
            self.pages_per_slot = 0
            self.pager = None
            self.cache = init_slot_cache(cfg, slots, cache_len, dtype,
                                         self.device)
            self._table = None
            self.table_dev = None
        self.version = 0

    def to_dev(self, x) -> torch.Tensor:
        """Host value -> a fresh device copy (never aliases ``x``).  On the
        card the copy goes through pinned memory without blocking: a copy
        from pageable memory would make the host wait for all queued
        device work, a sync point the reference does not have.  PyTorch's
        pinned-memory allocator keeps the staging buffer until the copy
        has run."""
        t = torch.tensor(np.asarray(x))
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t

    # ------------------------------------------------------------ ownership
    def commit(self, new_cache) -> None:
        """Rebind the live cache to the version a step returned."""
        self.cache = new_cache
        self.version += 1

    # ------------------------------------------------------------ block table
    def bind_slot_pages(self, slot: int, ids, *,
                        n_shared: int = 0) -> torch.Tensor:
        """Point ``slot``'s block table at physical pages ``ids``
        (unreserved logical pages at the garbage page), refresh the device
        mirror, and return the slot's table row on the device for the
        insert step.

        ``n_shared`` (prefix-cache hit): the leading ``n_shared`` pages of
        ``ids`` are shared prefix pages.  Decode and the paged kernel read
        them through the real table, but the returned insert row points
        them at the garbage page: the insert scatters every logical page
        of the prefilled row, and writing a shared page would change it
        under every other holder (the row holds the same content there,
        but the insert never needs to write it)."""
        if not 0 <= n_shared <= len(ids):
            raise ValueError(f"n_shared {n_shared} of {len(ids)} pages")
        self._table[slot, :] = GARBAGE_PAGE
        self._table[slot, :len(ids)] = ids
        self.sync_table()
        insert_row = self._table[slot].copy()
        insert_row[:n_shared] = GARBAGE_PAGE
        return self.to_dev(insert_row)

    def release_slot_pages(self, slot: int) -> None:
        """Re-point a finished slot's table row at the garbage page so the
        dead slot's frozen-pos writes land nowhere.  Host-side only; the
        caller refreshes the mirror once per batch of releases."""
        self._table[slot, :] = GARBAGE_PAGE

    def sync_table(self) -> None:
        """Rebuild the device block table from the host copy (a fresh
        tensor: a queued kernel may still read the previous one)."""
        self.table_dev = self.to_dev(self._table)

    # ------------------------------------------------------------ reporting
    def stats(self) -> dict:
        """The reference's keys.  Every commit updates in place (the
        counterpart of a donated commit); nothing is ever pinned."""
        out = {
            "kv_version": self.version,
            "kv_donated_commits": self.version,
            "kv_copied_commits": 0,
            "kv_pins": 0,
            "kv_pin_syncs": 0,
        }
        if self.pager is not None:
            out.update(self.pager.stats())
        return out

    def __repr__(self):
        layout = (f"paged(ps={self.page_size})" if self.paged else "dense")
        return f"<KVState v{self.version} {layout} slots={self.slots}>"
