"""Warm program cache: built fleets keyed by equivalence class, the
counterpart of `shadow_tpu.serve.cache`.

Here a "program" is a built `runtime.fleet.Fleet` with its
`HeartbeatHarvest`: the class's engine, its lane-stacked initial state
and its binds, all tensors on the device (there is no compile to keep
warm; the first launch of a class may also build the CUDA kernels). One
fleet fixes every static knob (`runtime.fleet.STATIC_KNOBS`) plus the
fault-bind shapes; everything else — seed, fault schedule values,
latency scale, stop time — is a launch input (`Fleet.make_inputs`). So
two requests can share a fleet iff they agree on the static knobs, and
the cache key (`serve.packer.ClassKey`) is exactly that agreement class.

An entry holds device memory: its fleet's lane-stacked template state,
the build's one-lane state and the binds. One TGen 4,096-host x 4-lane
entry (capacity 768) holds about 1.05 GB on the card: 839,794,896 bytes
of stacked state (chip_smoke.py phase 23 on an H100) and a quarter of
that again for the one-lane state; a launch's working states come on
top while it runs. Eviction drops the cache's reference, the entry's
last one once its launch has returned, so PyTorch's allocator takes
those blocks back.

The cache is a plain LRU over `OrderedDict`: a hit moves the entry to
the back, insertion past `max_programs` evicts the FRONT (least
recently used) — deterministic, pinned in tests/test_serve.py. The
entry factory is injected by the caller, so the LRU/hit/miss mechanics
are testable without compiling anything.

Thread discipline: only the service's single launch worker touches the
cache (`get`), so a factory build never races another build of the same
key. `snapshot()` takes the lock and is safe from handler threads.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable, Hashable


class ProgramCache:
    """LRU cache of warm fleets, with hit/miss/eviction counters
    mirrored into the serve-plane metrics registry."""

    def __init__(self, max_programs: int, *, metrics=None):
        if max_programs < 1:
            raise ValueError(
                f"the cache needs >= 1 program slot, got {max_programs}"
            )
        self.max_programs = int(max_programs)
        self.metrics = metrics
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        # per-key hit counts — the test_serve pin asserts >= 1 hit per
        # equivalence class after warmup
        self.hits_by_key: dict[Hashable, int] = {}
        self._entries: "OrderedDict[Hashable, Any]" = OrderedDict()
        self._lock = threading.Lock()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key: Hashable) -> bool:
        with self._lock:
            return key in self._entries

    def keys(self) -> list:
        """Keys in LRU order (front = next eviction victim)."""
        with self._lock:
            return list(self._entries)

    def get(self, key: Hashable, factory: Callable[[], Any]):
        """The warm-path entry: return the cached program for `key`,
        building it via `factory()` on a miss (evicting LRU if full).

        The factory runs OUTSIDE the lock — a cold build can take
        seconds and must not block `snapshot()` scrapes. Single-worker
        discipline (module docstring) makes that safe.
        """
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                self.hits_by_key[key] = self.hits_by_key.get(key, 0) + 1
                if self.metrics is not None:
                    self.metrics.inc("serve_cache_hits")
                return entry
            self.misses += 1
        if self.metrics is not None:
            self.metrics.inc("serve_cache_misses")
        entry = factory()
        with self._lock:
            self._entries[key] = entry
            self._entries.move_to_end(key)
            while len(self._entries) > self.max_programs:
                self._entries.popitem(last=False)  # the last reference
                self.evictions += 1
                if self.metrics is not None:
                    self.metrics.inc("serve_cache_evictions")
            if self.metrics is not None:
                self.metrics.set("serve_cached_programs",
                                 len(self._entries))
        return entry

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "programs": len(self._entries),
                "max_programs": self.max_programs,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "keys": [str(k) for k in self._entries],
            }
