"""Out-of-core slab streaming: reconstruct volumes that don't fit in RAM
(the port's copy of the reference's ``repro.stream``).

``store``     -- chunked, manifest-backed on-disk sinogram/volume stores
                 (slab-aligned shards, atomic tmp+rename publishes);
``scheduler`` -- budget -> slab sizing (``suggest_slab``) and the
                 double-buffered host prefetcher;
``driver``    -- ``reconstruct_streaming``: drain slabs through the
                 in-memory ``Reconstructor`` with a ``ckpt``-backed
                 resume manifest.

``scheduler``'s docstring has the slab-size formula and the overlap
schedule.
"""
from .driver import StreamResult, reconstruct_streaming
from .scheduler import PrefetchError, Prefetcher, SlabPlan, suggest_slab
from .store import SlabStore, simulate_to_store

__all__ = [
    "SlabStore",
    "simulate_to_store",
    "SlabPlan",
    "suggest_slab",
    "Prefetcher",
    "PrefetchError",
    "StreamResult",
    "reconstruct_streaming",
]
