"""Host-side paged-KV bookkeeping: page allocator, block tables, prefix cache.

Carried over unchanged from ``repro.serve.block_table`` (numpy only);
``tests/test_torch_serve.py`` pins it to the reference on a seeded op
sequence.

The device side of the paged layout (``repro_torch.serve.kv``) is a flat pool of
``(num_pages, page_size)`` KV rows per layer; this module owns everything
that decides *which* pool row a ``(slot, position)`` pair maps to:

* a free-list **page allocator** with per-page reference counts;
* one **block table** per cache slot (logical block ``pos // page_size``
  -> physical page), materialized for the device as a dense
  ``(num_slots, num_blocks)`` int32 array with ``num_pages`` as the
  "unallocated" sentinel (scatter-dropped / mask-hidden on device);
* a **prefix cache**: every fully-written prompt page is registered under
  a chain key (the exact token tuple chain from position 0), so a later
  request whose prompt starts with the same tokens maps the existing
  pages instead of recomputing their KV — prefix sharing;
* **copy-on-write**: a page referenced by more than one slot is never
  written in place; ``prepare_write`` allocates a private copy and
  returns ``(src, dst)`` ops for the device-side page copy (the
  ``fork`` path — engine-driven prefix sharing only ever shares full,
  finished pages, so it never triggers COW).

Reservation accounting makes admission safe: ``admit`` only succeeds when
the pool can cover the request's worst case (prompt + max_new tokens,
minus pages it can share), so decode — which is unconditional in the
scheduler — can never deadlock on an empty pool mid-request.

Pages whose refcount drops to zero but that are registered in the prefix
cache are *retained* (a reclaimable "cached" tier, evicted LRU when the
free list runs dry): a request arriving after its prefix-mate finished
still shares its pages.  Invariants are checked by ``check_invariants``.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class PageError(RuntimeError):
    """Host-side paged-KV bookkeeping violation."""


class OutOfPages(PageError):
    """The pool has no free or reclaimable page left.

    Unreachable through the scheduler (admission reserves worst-case
    pages); reachable through unreserved paths (``fork``/COW) on an
    undersized pool.
    """


#: Interned chain-key id.  The chain key of block ``b`` is logically the
#: whole token prefix ``prompt[:(b+1)*page_size]``; comparing that
#: directly would make probing quadratic in prompt length, so chains are
#: *interned*: ``_key_ids`` maps ``(parent_id, block_tokens)`` to a small
#: int, and by induction two chains get the same id iff their full token
#: prefixes are identical — exact equality (no hash-collision false
#: sharing) at O(page_size) per lookup.
ChainKey = int

#: parent id of a chain's first block
ROOT_KEY: ChainKey = 0


class PagedTables:
    """Block tables + ref-counted page pool + prefix cache for one engine."""

    def __init__(self, num_slots: int, num_blocks: int, num_pages: int, page_size: int):
        if min(num_slots, num_blocks, num_pages, page_size) < 1:
            raise PageError(  # typed, not assert: must survive python -O
                f"PagedTables sizes must be >= 1: slots={num_slots}, "
                f"blocks={num_blocks}, pages={num_pages}, page_size={page_size}"
            )
        self.num_slots = num_slots
        self.num_blocks = num_blocks
        self.num_pages = num_pages
        self.page_size = page_size
        self.tables: List[List[int]] = [[] for _ in range(num_slots)]
        self.ref = [0] * num_pages
        self._free: List[int] = list(range(num_pages - 1, -1, -1))  # pop() -> 0, 1, ...
        self._cached: "OrderedDict[int, ChainKey]" = OrderedDict()  # ref==0, retained
        self._touched: set = set()  # allocated since the last rebaseline
        self._prefix: Dict[ChainKey, int] = {}  # chain-key id -> page
        self._page_key: Dict[int, ChainKey] = {}  # registered page -> chain-key id
        self._reserved = [0] * num_slots
        # chain-key interning: (parent id, block token tuple) -> id.  Ids
        # are append-only — they stay valid across eviction (an evicted
        # chain re-registers under its old id); the table is bounded by
        # distinct (parent, block) pairs ever *registered*, since probes
        # look up without interning.
        self._key_ids: Dict[Tuple[ChainKey, Tuple[int, ...]], ChainKey] = {}
        self._next_key = ROOT_KEY + 1
        # per-slot chain frontier: _chain[slot][b] = chain id of this
        # slot's prompt blocks 0..b — extended incrementally so repeated
        # probes/registrations stay O(new blocks), not O(pos)
        self._chain: List[List[ChainKey]] = [[] for _ in range(num_slots)]

    # -- introspection ------------------------------------------------------

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def cached_pages(self) -> int:
        return len(self._cached)

    @property
    def used_pages(self) -> int:
        """Pages referenced by at least one slot."""
        return self.num_pages - len(self._free) - len(self._cached)

    @property
    def touched_pages(self) -> int:
        """Pages drawn from the free list since the last
        ``reset_touched`` and still holding content."""
        return len(self._touched)

    def reset_touched(self) -> None:
        """Rebaseline the touched-page counter without dropping live or
        prefix-cached pages: subsequent ``touched_pages`` reads count only
        pages allocated after this call (a warmed-up engine's measured run
        records its own page traffic, not the warmup's)."""
        self._touched.clear()

    def available(self) -> int:
        """Pages an ``admit`` may still promise without starving existing
        reservations: free + reclaimable, minus outstanding reservations."""
        return len(self._free) + len(self._cached) - sum(self._reserved)

    def blocks_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def pages_required(self, prompt_len: int, max_new: int) -> int:
        """Distinct pool pages a request's table references at worst case.
        Prefix sharing avoids *allocating* (and recomputing) shared pages
        but they still occupy the pool, so this is the feasibility bound
        against ``num_pages``."""
        return self.blocks_for(prompt_len + max_new)

    # -- chain-key interning ------------------------------------------------

    def _extend_chain(self, slot: int, prompt: Sequence[int], upto_block: int,
                      intern: bool) -> List[ChainKey]:
        """Extend ``slot``'s cached chain ids through block ``upto_block``
        (exclusive).  ``intern=False`` (probing) stops at the first chain
        never registered — nothing can be shared past it anyway;
        ``intern=True`` (registration) mints new ids."""
        ps = self.page_size
        ids = self._chain[slot]
        while len(ids) < upto_block:
            b = len(ids)
            parent = ids[b - 1] if b else ROOT_KEY
            key = (parent, tuple(prompt[b * ps : (b + 1) * ps]))
            kid = self._key_ids.get(key)
            if kid is None:
                if not intern:
                    break
                kid = self._next_key
                self._next_key += 1
                self._key_ids[key] = kid
            ids.append(kid)
        return ids

    # -- admission / sharing ------------------------------------------------

    def _probe_shared(self, slot: int, prompt: Sequence[int], start_block: int) -> List[int]:
        """Pages the prefix cache can supply for ``prompt`` starting at
        ``start_block``.  At least one prompt token is always left for the
        owner to process (its logits feed the first sampled token), so a
        block is shareable only when it ends strictly before the prompt
        does: ``(b+1)*page_size < len(prompt)``."""
        ps = self.page_size
        last = (len(prompt) - 1) // ps  # first non-shareable block
        ids = self._extend_chain(slot, prompt, last, intern=False)
        pages: List[int] = []
        for b in range(start_block, min(len(ids), last)):
            page = self._prefix.get(ids[b])
            if page is None:
                break
            pages.append(page)
        return pages

    def _map_page(self, slot: int, page: int, consume_reservation: bool) -> None:
        if self.ref[page] == 0:
            del self._cached[page]  # reclaimable -> active
        self.ref[page] += 1
        self.tables[slot].append(page)
        if consume_reservation and self._reserved[slot] > 0:
            self._reserved[slot] -= 1

    def admit(self, slot: int, prompt: Sequence[int], max_new: int) -> Optional[int]:
        """Reserve worst-case pages for a request and map its shareable
        prefix.  Returns the number of prompt tokens covered by shared
        pages (the caller skips prefilling them), or ``None`` when the
        pool cannot guarantee the request — leave it queued."""
        if self.tables[slot]:
            raise PageError(f"slot {slot} still holds pages; free it first")
        total = self.blocks_for(len(prompt) + max_new)
        if total > self.num_blocks:
            raise PageError(
                f"request needs {total} blocks > table capacity {self.num_blocks}"
            )
        if total > self.num_pages:
            # returning None would park this request at the queue head
            # forever (FIFO admission) — fail loudly instead
            raise PageError(
                f"request can never fit: it references {total} distinct "
                f"pages (shared or not), pool has {self.num_pages}"
            )
        self._chain[slot] = []
        shared = self._probe_shared(slot, prompt, 0)
        # shared pages sitting in the reclaimable tier leave it when
        # mapped, so they count against availability like fresh pages
        n_reclaim = sum(1 for p in shared if self.ref[p] == 0)
        needed = total - len(shared)
        if self.available() < needed + n_reclaim:
            return None
        self._reserved[slot] = needed
        for page in shared:
            self._map_page(slot, page, consume_reservation=False)
        return len(shared) * self.page_size

    def probe_shareable(self, prompt: Sequence[int]) -> int:
        """Prompt tokens the prefix cache could supply for ``prompt`` right
        now, without touching any slot state.  Admission uses it to dedup
        *in-flight* prefixes: when an active slot is still prefilling a
        prompt that will publish more shareable pages than this, the new
        request is worth parking until those pages land."""
        ps = self.page_size
        last = (len(prompt) - 1) // ps  # first non-shareable block
        parent, n = ROOT_KEY, 0
        for b in range(last):
            kid = self._key_ids.get((parent, tuple(prompt[b * ps : (b + 1) * ps])))
            if kid is None or kid not in self._prefix:
                break
            parent, n = kid, n + 1
        return n * ps

    def try_share(self, slot: int, prompt: Sequence[int], pos: int) -> int:
        """Map any prefix-cache pages covering ``prompt`` from ``pos`` on
        (mid-prefill sharing: an older request may have finished writing
        these pages since the last step).  Returns tokens covered."""
        ps = self.page_size
        if pos % ps != 0 or len(self.tables[slot]) != pos // ps:
            return 0  # mid-block, or the slot already owns this block
        pages = self._probe_shared(slot, prompt, pos // ps)
        for page in pages:
            self._map_page(slot, page, consume_reservation=True)
        return len(pages) * ps

    # -- writes -------------------------------------------------------------

    def _alloc(self, slot: int, consume_reservation: bool = True) -> int:
        if self._free:
            page = self._free.pop()
        elif self._cached:
            page, key = self._cached.popitem(last=False)  # evict LRU
            del self._prefix[key]
            del self._page_key[page]
        else:
            raise OutOfPages(
                f"page pool exhausted ({self.num_pages} pages, "
                f"{self.used_pages} in use)"
            )
        self.ref[page] = 1
        self._touched.add(page)
        if consume_reservation and self._reserved[slot] > 0:
            self._reserved[slot] -= 1
        return page

    def prepare_write(self, slot: int, start: int, n: int) -> List[Tuple[int, int]]:
        """Make positions ``[start, start + n)`` of ``slot`` writable:
        allocate missing blocks and copy-on-write any block shared with
        another slot.  Returns ``(src, dst)`` page-copy ops the caller
        must apply to the device pool *before* the step's scatter."""
        if n <= 0:
            return []
        ps = self.page_size
        table = self.tables[slot]
        ops: List[Tuple[int, int]] = []
        for b in range(start // ps, (start + n - 1) // ps + 1):
            if b < len(table):
                page = table[b]
                if self.ref[page] > 1:  # shared: never write in place
                    dst = self._alloc(slot, consume_reservation=False)
                    self.ref[page] -= 1
                    table[b] = dst
                    ops.append((page, dst))
            else:
                if b != len(table):
                    raise PageError(
                        f"non-contiguous write: slot {slot} block {b}, "
                        f"table has {len(table)}"
                    )
                table.append(self._alloc(slot))
        return ops

    def register_prompt_pages(self, slot: int, prompt: Sequence[int], upto: int) -> None:
        """Publish ``slot``'s fully-written prompt pages (positions
        ``< upto``) into the prefix cache."""
        ps = self.page_size
        table = self.tables[slot]
        n_full = min(min(upto, len(prompt)) // ps, len(table))
        ids = self._extend_chain(slot, prompt, n_full, intern=True)
        for b in range(n_full):
            page, key = table[b], ids[b]
            if page in self._page_key or key in self._prefix:
                continue  # already published (e.g. a page this slot shared in)
            self._prefix[key] = page
            self._page_key[page] = key

    # -- lifecycle ----------------------------------------------------------

    def _decref(self, page: int) -> None:
        if self.ref[page] <= 0:
            raise PageError(f"double free of page {page}")
        self.ref[page] -= 1
        if self.ref[page] == 0:
            key = self._page_key.get(page)
            if key is not None and self._prefix.get(key) == page:
                self._cached[page] = key  # retain for prefix reuse
            else:
                self._free.append(page)
                self._touched.discard(page)

    def free_slot(self, slot: int) -> None:
        """Release everything ``slot`` holds — the normal-completion path
        and the cancellation reclaim path alike.  Works mid-prefill and
        mid-decode: shared prefix pages survive with their other owners
        (refcount > 0), fully-registered prompt pages drop to the
        reclaimable prefix-cache tier (a cancelled request's prefix KV is
        still valid for future prompts), and the partially written tail
        page — never registered — returns straight to the free list.
        Idempotent on an already-empty slot."""
        for page in self.tables[slot]:
            self._decref(page)
        self.tables[slot] = []
        self._reserved[slot] = 0
        self._chain[slot] = []

    def trim(self, slot: int, n_tokens: int) -> int:
        """Drop every block of ``slot`` wholly past ``n_tokens`` kept
        positions — the paged half of speculative-decoding rollback
        (rejected draft tokens wrote KV into blocks the sequence no longer
        reaches).  The block holding the last kept token stays; dropped
        pages are decref'd (shared pages survive with their other owners,
        prefix-registered pages move to the reclaimable tier) and restored
        to the slot's reservation so availability accounting still covers
        its admitted worst case.  Returns the number of blocks dropped."""
        keep = self.blocks_for(n_tokens)
        table = self.tables[slot]
        if keep >= len(table):
            return 0
        dropped = table[keep:]
        del table[keep:]
        for page in dropped:
            self._decref(page)
        self._reserved[slot] += len(dropped)
        return len(dropped)

    def fork(self, parent: int, child: int) -> None:
        """Share every page of ``parent`` with ``child`` (beam-style fork).
        Writes by either slot to a shared block copy-on-write via
        ``prepare_write``.  Fork bypasses reservation accounting: callers
        must size the pool for the copies they may trigger."""
        if self.tables[child]:
            raise PageError(f"fork target slot {child} is not empty")
        for page in self.tables[parent]:
            self.ref[page] += 1
            self.tables[child].append(page)

    # -- device view --------------------------------------------------------

    def device_tables(self) -> np.ndarray:
        """(num_slots, num_blocks) int32; ``num_pages`` marks unallocated
        blocks (out-of-range: scatter-dropped, gather-masked)."""
        arr = np.full((self.num_slots, self.num_blocks), self.num_pages, np.int32)
        for i, t in enumerate(self.tables):
            if t:
                arr[i, : len(t)] = t
        return arr

    # -- invariants (property-tested) ---------------------------------------

    def check_invariants(self) -> None:
        counts = [0] * self.num_pages
        for t in self.tables:
            for p in t:
                counts[p] += 1
        if counts != list(self.ref):
            raise PageError(f"refcount drift: {self.ref} vs table counts {counts}")
        free, cached = set(self._free), set(self._cached)
        if len(self._free) != len(free):
            raise PageError("duplicate page on the free list")
        if free & cached:
            raise PageError(f"pages both free and cached: {free & cached}")
        active = {p for p, r in enumerate(self.ref) if r > 0}
        if active & (free | cached):
            raise PageError("referenced page on the free/cached lists")
        if len(free) + len(cached) + len(active) != self.num_pages:
            raise PageError(
                f"page conservation violated: {len(free)} free + "
                f"{len(cached)} cached + {len(active)} active != {self.num_pages}"
            )
        for page, key in self._cached.items():
            if self._prefix.get(key) != page:
                raise PageError(f"cached page {page} not in the prefix cache")
        for key, page in self._prefix.items():
            if self._page_key.get(page) != key:
                raise PageError(f"prefix entry {key!r} -> {page} not back-linked")
        if any(r < 0 for r in self._reserved):
            raise PageError("negative reservation")
        if self._touched & free:
            raise PageError(f"touched pages on the free list: {self._touched & free}")
