"""Plan cache: amortize the cold path (system matrix + partition + bind)
(the port's copy of the reference's ``serve/plan_cache.py``).

The expensive part of serving a reconstruction job is not the solve --
it is everything keyed by the geometry/config fingerprint
(``core.partition.plan_key``): tracing the Siddon system matrix,
compiling it into blocked-ELL shards + winseg copy tables
(``build_plan``), building the exchange tables, and binding the
operator to the card (``Reconstructor``: the upload, the q8/fp8
packing, the scatter passes).  All of that is *identical* for every job
that shares a key (parallel-beam slices share ``A``; same block shape +
dtype ladder + comm/dma mode means the same kernel), so the service
builds it once and hits the cache for the rest of the traffic -- the
warm path's queue-to-first-slab is strictly below the cold path's
(pinned by ``tests/test_torch_serve.py``).

The LRU bound is in *bytes*, not entries, priced with the same
accounting every other layer uses: ``OperatorShards.hbm_bytes`` at the
precision policy's storage width for both operators (the traffic
model's resident-operator term -- what ``suggest_slab`` calls
``fixed``).  Entries pinned by a running batch are never evicted.  An
evicted entry lets go of its plan and its ``Reconstructor`` (whose
operator tensors live on the card): the cache holds the only reference
the service keeps, so the card's memory falls with the eviction and the
byte bound is a bound on what the card holds, not only on paper.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict
from typing import Callable

from ..obs import metrics as obs_metrics

__all__ = ["PlanCache", "PlanEntry"]


@dataclasses.dataclass
class PlanEntry:
    """One cached cold path: the plan and its device-bound solver.

    ``rec`` (a ``core.recon.Reconstructor``) holds the operator bound to
    the card, so a cache hit reuses the upload and packing too, not just
    the partition.  ``bytes`` is the resident operator
    footprint that counts against the cache budget; ``build_seconds``
    is what the hit saved (reported by ``bench_serve``).
    """

    key: str
    plan: object  # core.partition.Plan
    rec: object  # core.recon.Reconstructor
    bytes: int
    build_seconds: float
    pinned: int = 0  # running batches holding this entry


class PlanCache:
    """Byte-bounded LRU over :class:`PlanEntry`, with hit/miss counters.

    ``get_or_build(key, build)`` is the only path in: ``build()`` runs
    at most once per resident key (under the lock -- a second tenant
    asking for the same geometry while the first build runs would
    otherwise duplicate the most expensive operation in the service).
    Counters are the observable the acceptance criteria assert against:
    a warm job must show ``builds`` unchanged.
    """

    def __init__(self, capacity_bytes: int | None = None):
        self.capacity_bytes = capacity_bytes
        self._entries: OrderedDict[str, PlanEntry] = OrderedDict()
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0
        self.builds = 0
        self.evictions = 0

    # ------------------------------------------------------------------ #
    # interrogation
    # ------------------------------------------------------------------ #
    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: str) -> bool:
        return key in self._entries

    @property
    def bytes(self) -> int:
        return sum(e.bytes for e in self._entries.values())

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> dict:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "builds": self.builds,
            "evictions": self.evictions,
            "entries": len(self._entries),
            "bytes": self.bytes,
        }

    def peek(self, key: str) -> PlanEntry | None:
        """Look without touching: no counters, no LRU reorder.

        Admission pricing uses this to price against the *real* cached
        plan when one exists -- a pricing peek must not masquerade as a
        serving hit in the counters the acceptance tests assert on.
        """
        with self._lock:
            return self._entries.get(key)

    # ------------------------------------------------------------------ #
    # the one path in
    # ------------------------------------------------------------------ #
    def get_or_build(
        self, key: str, build: Callable[[], tuple]
    ) -> tuple[PlanEntry, bool]:
        """Return ``(entry, hit)``; ``build()`` -> ``(plan, rec, bytes)``.

        On a miss the new entry is admitted even if it alone exceeds
        the capacity (the service already admission-checked the job;
        a cache too small for one plan should degrade to rebuild-every-
        time, not refuse service) -- everything evictable is evicted
        first.
        """
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self.hits += 1
                obs_metrics.inc("plan_cache_hits_total")
                self._entries.move_to_end(key)  # LRU touch
                return entry, True
            self.misses += 1
            obs_metrics.inc("plan_cache_misses_total")
            t0 = time.perf_counter()
            plan, rec, nbytes = build()
            self.builds += 1
            entry = PlanEntry(
                key=key, plan=plan, rec=rec, bytes=int(nbytes),
                build_seconds=time.perf_counter() - t0,
            )
            self._entries[key] = entry
            self._evict_to_fit()
            return entry, False

    def pin(self, key: str):
        """Mark an entry in use by a running batch (eviction-proof)."""
        with self._lock:
            self._entries[key].pinned += 1

    def unpin(self, key: str):
        with self._lock:
            e = self._entries.get(key)
            if e is not None and e.pinned > 0:
                e.pinned -= 1
                self._evict_to_fit()  # a deferred eviction may now land

    def _evict_to_fit(self):
        """Drop LRU unpinned entries until the byte budget holds.

        The entry just touched/inserted sits at the MRU end, so it is
        the last candidate -- a one-entry cache always keeps the key
        the current batch needs.
        """
        if self.capacity_bytes is None:
            return
        while self.bytes > self.capacity_bytes:
            mru = next(reversed(self._entries))
            victim = next(
                (
                    k
                    for k, e in self._entries.items()  # LRU -> MRU
                    if e.pinned == 0 and k != mru
                ),
                None,
            )
            if victim is None:  # only pinned entries / the MRU one left
                return
            dropped = self._entries.pop(victim)
            # let go of the device tensors now, even if a caller still
            # holds the entry object
            dropped.plan = dropped.rec = None
            self.evictions += 1
            obs_metrics.inc("plan_cache_evictions_total")
