"""Host-side page accounting for the block-paged KV cache: a copy of the
JAX package's ``runtime/paging.py`` (pure Python, unchanged), so the port's
decode loop admits, grows, shares and frees pages exactly as the
reference's does.

The device half (models/gpt.decode_step_packed / prefill_into_slots) is a pure
function over a preallocated page pool and per-slot page tables; THIS
module owns which page holds what:

- :class:`PageAllocator` hands out fixed-size pages from the pool,
  reserves a request's worst-case page budget at admission (so a live
  request can always grow its page table mid-generation — out-of-pages
  can stall ADMISSION, never corrupt a row that already started), and
  recycles pages when requests retire.
- The **prefix cache**: page-aligned prompt prefixes are content-hashed
  per page (a digest CHAIN, so a page's identity includes everything
  before it) and kept after release. A new request whose prompt starts
  with a cached chain reuses those pages copy-on-write: shared pages are
  never written again — a reused prefix always ends on a page boundary
  and the remainder (at least the prompt's final token, which must be
  re-run to produce the first output logits) lands in freshly allocated
  pages, so divergence allocates instead of mutating. Idle cached pages
  are reclaimed LRU-first when the free list runs dry.

Page 0 is the TRASH page: never allocated, the write target of inactive
decode slots (zero-filled page tables). Everything here is plain Python
under the executor's lock, unit-testable in microseconds.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

#: reserved write target for inactive slots; never handed out
TRASH_PAGE = 0


def prefix_digest_chain(tokens: Sequence[int], page_size: int,
                        upto: int) -> List[str]:
    """Chained content digests for the first ``upto`` full pages of
    ``tokens``: page ``k``'s digest folds in every page before it, so a
    digest identifies a whole page-aligned PREFIX, not one page in
    isolation. Module-level because three layers key off the same chain:
    the prefix cache (here), KV handoff integrity (runtime/handoff.py),
    and prefix-affinity routing (gateway/affinity.py) — the gateway must
    hash a prompt exactly the way the replica's cache will."""
    digests, h = [], b""
    for k in range(upto):
        page = [int(t) for t in tokens[k * page_size:(k + 1) * page_size]]
        h = hashlib.sha256(h + repr(page).encode()).digest()
        digests.append(h.hex())
    return digests


class OutOfPages(Exception):
    """The pool cannot cover a new request's worst-case page budget.
    Admission-time only: the caller keeps the request queued and retries
    after retirements free pages."""


@dataclass
class RestoreTicket:
    """In-flight KV-tier restore (:meth:`PageAllocator.restore_begin`):
    drawn-but-unpublished pages plus the ref-pinned resident head of the
    chain being restored. Must be resolved by ``restore_commit`` or
    ``restore_abort`` before the admission pass continues."""

    digests: List[str]
    start: int
    pages: List[int]
    pinned: List[int]


@dataclass
class SlotLease:
    """One admitted request's page holdings: ``pages`` in table order
    (cached prefix first), plus the unallocated remainder of its
    reserved budget."""

    pages: List[int] = field(default_factory=list)
    #: leading entries of ``pages`` reused from the prefix cache —
    #: shared, read-only; the executor never writes positions below
    #: ``cached_pages * page_size``
    cached_pages: int = 0
    #: pages this lease may still draw on demand (reserved at admission)
    reserved: int = 0


class PageAllocator:
    """Fixed pool of ``num_pages`` pages of ``page_size`` tokens.

    Contract (tests/test_paged_kv.py):

    - :meth:`admit` either returns a lease whose reservation covers the
      request's WORST-CASE length (prompt + generation budget) or raises
      :class:`OutOfPages` — a live lease's :meth:`extend` therefore
      always succeeds;
    - pages released by a retiring lease are reusable immediately;
      cache-registered pages stay resident (evictable LRU) so later
      requests with the same prompt prefix skip their prefill;
    - a cached page is shared by refcount and never freed while any
      lease holds it.
    """

    def __init__(self, num_pages: int, page_size: int,
                 prefix_cache: bool = True):
        if num_pages < 2:
            raise ValueError(
                f"need >= 2 pages (trash + 1 usable), got {num_pages}"
            )
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.num_pages = num_pages
        self.page_size = page_size
        self.prefix_cache_enabled = prefix_cache
        self._free: deque = deque(range(1, num_pages))
        self._ref: Dict[int, int] = {}
        self._reserved_total = 0
        # digest-chain key -> page id, LRU order (oldest first); a cached
        # page with refcount 0 is idle storage, evictable on demand
        self._cache: "OrderedDict[str, int]" = OrderedDict()
        self._page_key: Dict[int, str] = {}
        # fault containment: pages held by a FAULTED row are
        # never returned to the free list until verified — a poisoned
        # page must not carry corrupt K/V into a future admission.
        # _quarantined = unreferenced pages awaiting verification;
        # _tainted = poisoned pages still shared with a live lease
        # (diverted into _quarantined at their final release)
        self._quarantined: set = set()
        self._tainted: set = set()
        self.prefix_hits = 0
        self.prefix_misses = 0
        #: idle cached pages reclaimed by :meth:`_evict_idle` (the device
        #: tier's eviction accounting: before the KV
        #: economy these drops were invisible)
        self.evictions = 0
        #: observer invoked BEFORE an idle cached page is dropped, with
        #: ``(digest_key, page_id)`` — the page is still cache-resident
        #: during the call so the host tier (runtime/kvtier) can demote
        #: the whole chain it belongs to. The callback MUST NOT mutate
        #: this allocator (it runs mid-eviction); reads are fine.
        self.on_evict: Optional[Callable[[str, int], None]] = None

    # -- accounting ---------------------------------------------------------

    @property
    def free_pages(self) -> int:
        """Pages immediately on the free list (excludes evictable cache)."""
        return len(self._free)

    @property
    def used_pages(self) -> int:
        """Pages held by leases OR idle in the prefix cache."""
        return self.num_pages - 1 - len(self._free)

    def available(self) -> int:
        """Pages a NEW admission may still claim: free + evictable cached
        idle pages, minus what live leases have reserved but not drawn."""
        idle = sum(1 for p in self._cache.values() if not self._ref.get(p))
        return len(self._free) + idle - self._reserved_total

    # -- prefix cache -------------------------------------------------------

    def _page_digests(self, tokens: Sequence[int], upto: int) -> List[str]:
        """Chained content digests for the first ``upto`` full pages.
        Tokens are normalized to plain ints so a numpy prompt and a list
        prompt with the same content hash identically."""
        return prefix_digest_chain(tokens, self.page_size, upto)

    def match_prefix(self, tokens: Sequence[int]) -> Tuple[List[int], int]:
        """Longest cached page chain covering a PROPER prefix of
        ``tokens`` (at most ``len(tokens) - 1`` — the final prompt token
        is always re-run so the request has first-output logits).
        Returns ``(page_ids, tokens_covered)`` WITHOUT acquiring them —
        :meth:`admit` does the refcounting."""
        if not self.prefix_cache_enabled:
            return [], 0
        k_max = max(len(tokens) - 1, 0) // self.page_size
        matched: List[int] = []
        for key in self._page_digests(tokens, k_max):
            pid = self._cache.get(key)
            if pid is None:
                break
            matched.append(pid)
        return matched, len(matched) * self.page_size

    def cached_chain(self, digests: Sequence[str]) -> List[int]:
        """Resident page ids for the longest cached prefix of a digest
        chain, WITHOUT acquiring them. The KV-tier read path: demotion
        walks it to find what is still exportable, restore walks it to
        find where the device tier ends."""
        pages: List[int] = []
        for key in digests:
            pid = self._cache.get(key)
            if pid is None:
                break
            pages.append(pid)
        return pages

    def cached_keys(self, limit: int = 0) -> List[str]:
        """Digest keys currently in the prefix cache, LRU-oldest first
        (the gateway cache directory's per-replica report; ``limit`` > 0
        keeps only the most-recent tail)."""
        keys = list(self._cache.keys())
        return keys[-limit:] if limit > 0 else keys

    def restore_begin(self, digests: Sequence[str],
                      start: int) -> Optional["RestoreTicket"]:
        """Phase 1 of adopting externally sourced prefix pages (host/peer
        tier restore, runtime/kvtier): draw one page per chain position
        ``start..len(digests)-1``, WITHOUT publishing them. The caller
        scatters the restored K/V into ``ticket.pages``, then
        :meth:`restore_commit` publishes them under their digests (or
        :meth:`restore_abort` returns them untouched). The two-phase
        shape is load-bearing: a dry free list evicts idle cached pages
        through the normal :meth:`_evict_idle` path — whose demotion
        callback may EXPORT any published chain — so pages holding
        not-yet-scattered garbage must stay invisible to the cache until
        their bytes are real. The chain's resident head is ref-pinned
        for the ticket's lifetime so the eviction scan cannot break the
        chain being restored; drawn pages need no pin (eviction only
        sees the cache). Returns ``None`` — side-effect-free — when live
        leases own the whole pool.

        Accounting-neutral once committed: every drawn page becomes an
        idle cached (evictable) page, so :meth:`available` and the
        infallible-:meth:`extend` contract hold. A restore SHUFFLES
        residency (displaced chains demote to host first); it never
        destroys it."""
        need = len(digests) - start
        if need <= 0:
            return None
        pinned: List[int] = []
        for key in digests[:start]:
            pid = self._cache.get(key)
            if pid is not None:
                # touch the head: the whole chain ends up contiguous at
                # the MRU end, aging (and demoting) as one unit
                self._cache.move_to_end(key)
                self._ref[pid] = self._ref.get(pid, 0) + 1
                pinned.append(pid)
        pages: List[int] = []
        while len(pages) < need:
            if not self._free:
                if not any(
                    not self._ref.get(p) for p in self._cache.values()
                ):
                    self._free.extend(pages)
                    self._unpin(pinned)
                    return None
                self._evict_idle()
            pages.append(self._free.popleft())
        return RestoreTicket(
            digests=list(digests), start=start, pages=pages, pinned=pinned
        )

    def restore_commit(self, ticket: "RestoreTicket") -> None:
        """Phase 2: the K/V landed — publish the drawn pages under their
        digests (idle cached, exactly as if a request had prefilled and
        released them) and unpin the head."""
        for key, pid in zip(ticket.digests[ticket.start:], ticket.pages):
            self._cache[key] = pid
            self._page_key[pid] = key
        self._unpin(ticket.pinned)
        ticket.pages = []
        ticket.pinned = []

    def restore_abort(self, ticket: "RestoreTicket") -> None:
        """The scatter failed: return the drawn pages to the free list
        unpublished and unpin the head. No trace remains."""
        self._free.extend(ticket.pages)
        self._unpin(ticket.pinned)
        ticket.pages = []
        ticket.pinned = []

    def _unpin(self, pinned: List[int]) -> None:
        for pid in pinned:
            n = self._ref.get(pid, 0) - 1
            if n > 0:
                self._ref[pid] = n
            else:
                self._ref.pop(pid, None)

    def discard_cached(self, keys: Sequence[str]) -> None:
        """Unpublish idle cache entries (a failed restore rolls back the
        pages it drew; pages shared with a live lease just lose their
        cache identity and free at final release)."""
        for key in keys:
            pid = self._cache.pop(key, None)
            if pid is None:
                continue
            self._page_key.pop(pid, None)
            if not self._ref.get(pid):
                self._free.append(pid)

    def register_prefix(self, tokens: Sequence[int], lease: SlotLease) -> None:
        """Publish the lease's full-page prompt prefixes into the cache
        (called once the prompt's K/V are actually resident — after
        prefill). First writer wins: a concurrent identical prompt that
        registered first keeps its pages; ours simply stay private."""
        if not self.prefix_cache_enabled:
            return
        k_max = max(len(tokens) - 1, 0) // self.page_size
        for k, key in enumerate(self._page_digests(tokens, k_max)):
            if k >= len(lease.pages):
                break
            pid = lease.pages[k]
            cur = self._cache.get(key)
            if cur is not None:
                if cur == pid:
                    self._cache.move_to_end(key)
                continue
            if pid in self._page_key:  # already published under its key
                continue
            self._cache[key] = pid
            self._page_key[pid] = key

    # -- lease lifecycle ----------------------------------------------------

    def admit(self, tokens: Sequence[int], gen_budget: int) -> SlotLease:
        """Reserve the worst-case page budget for ``tokens`` plus
        ``gen_budget`` generated tokens, reusing a cached prefix when one
        matches. Raises :class:`OutOfPages` without side effects when the
        pool cannot cover it.

        ``need_pages`` below — ``ceil((len + max(gen, 1)) / page_size)``
        — is the ONE footprint formula in the system: the attention
        gather's per-row extent is ``pages_per_slot() = ceil(max_len /
        page_size)`` of the same shape (the Pallas seam comment in
        models/transformer.py), and the scheduler's preemption spill
        (runtime/server._spill_locked) re-admits a spilled row through
        this exact method with its REMAINING budget, so spill/restore can
        never free fewer pages than a fresh admission would need."""
        need_pages = -(-(len(tokens) + max(gen_budget, 1)) // self.page_size)
        cached, cached_tokens = self.match_prefix(tokens)
        need_new = need_pages - len(cached)
        # IDLE cached pages this admission is about to acquire stop being
        # evictable the moment it refs them — charge them against
        # available() too, or a prefix-hit admission could over-commit
        # the pool and a later extend() (contractually infallible) would
        # fail mid-generation and poison every in-flight request
        idle_acquired = sum(1 for pid in cached if not self._ref.get(pid))
        if need_new + idle_acquired > self.available():
            raise OutOfPages(
                f"{need_new} pages needed (+{idle_acquired} idle cached "
                f"acquired), {self.available()} available "
                f"({self.num_pages - 1} pool)"
            )
        if cached:
            self.prefix_hits += 1
            for pid in cached:
                self._ref[pid] = self._ref.get(pid, 0) + 1
                key = self._page_key.get(pid)
                if key is not None:
                    self._cache.move_to_end(key)
        elif self.prefix_cache_enabled:
            self.prefix_misses += 1
        self._reserved_total += need_new
        return SlotLease(
            pages=list(cached), cached_pages=len(cached), reserved=need_new
        )

    def extend(self, lease: SlotLease) -> int:
        """Draw the lease's next page from its admission-time reservation
        (the page table grows as the generation crosses page boundaries).
        Always succeeds for a lease admitted by :meth:`admit`."""
        if lease.reserved <= 0:
            raise OutOfPages("lease reservation exhausted — admission bug")
        if not self._free:
            self._evict_idle()
        pid = self._free.popleft()
        lease.reserved -= 1
        self._reserved_total -= 1
        self._ref[pid] = 1
        lease.pages.append(pid)
        return pid

    def release(self, lease: SlotLease) -> None:
        """Retire a lease: drop every page reference and return the
        unused reservation. Unreferenced pages return to the free list
        unless the prefix cache holds them (those stay resident, LRU-
        evictable, so the next same-prefix request hits)."""
        self._reserved_total -= lease.reserved
        lease.reserved = 0
        for pid in lease.pages:
            n = self._ref.get(pid, 0) - 1
            if n > 0:
                self._ref[pid] = n
                continue
            self._ref.pop(pid, None)
            if pid in self._tainted:
                self._tainted.discard(pid)
                self._quarantined.add(pid)
                continue
            if pid not in self._page_key:
                self._free.append(pid)
        lease.pages = []
        lease.cached_pages = 0

    # -- KV handoff (disaggregated prefill/decode) --------------------------

    def export_pages(
        self, lease: SlotLease, tokens: Sequence[int]
    ) -> Tuple[List[int], List[str]]:
        """The prefill side of a KV handoff: the lease's page ids covering
        the PROMPT (in table order — what runtime/handoff.py serializes
        together with the digest chain into a self-describing buffer) plus
        the chained digests of the full prompt pages, which double as the
        buffer's integrity check and the gateway's affinity key. The
        trailing partial page (if the prompt isn't page-aligned) is
        exported too — its live rows are prompt K/V; its tail rows are
        junk the importer's decode never reads (attention is masked to
        positions <= the current one, exactly as on this replica)."""
        ps = self.page_size
        n_prompt = -(-len(tokens) // ps)
        assert len(lease.pages) >= n_prompt, (
            f"lease holds {len(lease.pages)} page(s), prompt needs "
            f"{n_prompt} — export before prefill drew the lease"
        )
        digests = prefix_digest_chain(tokens, ps, len(tokens) // ps)
        return list(lease.pages[:n_prompt]), digests

    def import_pages(self, tokens: Sequence[int], gen_budget: int) -> SlotLease:
        """The decode side of a KV handoff: admit the row exactly like
        :meth:`admit` (worst-case reservation, prefix-cache reuse — a
        repeated session history that is already cached locally is NOT
        re-copied), then draw the remaining prompt pages immediately so
        the imported K/V has somewhere to land BEFORE the row's first
        decode step. The caller copies buffer pages
        ``[lease.cached_pages, ceil(len(tokens)/page_size))`` into
        ``lease.pages[cached_pages:]``. Raises :class:`OutOfPages`
        without side effects when the pool cannot cover the row."""
        lease = self.admit(tokens, gen_budget)
        n_prompt = -(-len(tokens) // self.page_size)
        while len(lease.pages) < n_prompt:
            self.extend(lease)
        return lease

    # -- fault quarantine ---------------------------------------------------

    @property
    def quarantined_pages(self) -> int:
        """Pages held out of circulation pending verification (includes
        tainted pages still pinned by a live lease)."""
        return len(self._quarantined) + len(self._tainted)

    def quarantine(self, lease: SlotLease) -> int:
        """Retire a FAULTED lease: return its unused reservation, but
        hold every page it touched OUT of the free list (and unpublish
        them from the prefix cache) until :meth:`verify_quarantined`
        clears them. A page still shared with another live lease stays
        readable for that lease (its content predates the fault) but is
        tainted — it quarantines at its final release instead of going
        free. Returns the number of pages quarantined or tainted."""
        self._reserved_total -= lease.reserved
        lease.reserved = 0
        n_held = 0
        for pid in lease.pages:
            key = self._page_key.pop(pid, None)
            if key is not None:
                self._cache.pop(key, None)
            n = self._ref.get(pid, 0) - 1
            if n > 0:
                self._ref[pid] = n
                if pid not in self._tainted:
                    self._tainted.add(pid)
                    n_held += 1
                continue
            self._ref.pop(pid, None)
            if pid not in self._quarantined:
                self._quarantined.add(pid)
                n_held += 1
        lease.pages = []
        lease.cached_pages = 0
        return n_held

    def verify_quarantined(self) -> int:
        """Release verified quarantined pages back to the free list (the
        pool's K/V pages are fully overwritten by prefill before any row
        reads them, so verification is an explicit operator/executor
        decision, never implicit). Tainted pages still pinned by live
        leases stay tainted. Returns the number of pages returned."""
        n = len(self._quarantined)
        while self._quarantined:
            self._free.append(self._quarantined.pop())
        return n

    def _evict_idle(self) -> None:
        """Reclaim the LRU idle cached page into the free list. Called
        only when the free list is dry but ``available()`` promised
        capacity, so an idle page must exist."""
        for key, pid in self._cache.items():
            if not self._ref.get(pid):
                if self.on_evict is not None:
                    # page still resident: the host tier can export the
                    # chain this digest belongs to before it disappears
                    self.on_evict(key, pid)
                del self._cache[key]
                del self._page_key[pid]
                self._free.append(pid)
                self.evictions += 1
                return
        raise OutOfPages("no idle cached page to evict — accounting bug")


__all__ = [
    "OutOfPages",
    "PageAllocator",
    "RestoreTicket",
    "SlotLease",
    "TRASH_PAGE",
    "prefix_digest_chain",
]
