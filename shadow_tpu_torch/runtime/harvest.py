"""One device-to-host copy per segment for the CLI's run loop: the
counterpart of `shadow_tpu.runtime.harvest`.

At every segment boundary the run loop needs the summary scalars, the
queue fill, the pressure ring counters, the metrics extras, the stats
histograms and, at heartbeats, the tracker's counters, the trace ring
and the packet capture rings. Read one by one, each would be a
device-to-host copy that waits for the card. This module gathers all of
them as device tensors (`extract`, no copy) and brings them to the host
in one copy (`fetch`): every tensor is viewed as bytes, the bytes are
concatenated on the device, copied once into a pinned host buffer and
waited for with one event, then split and viewed back on the host. The read is counted in
the engine's `host_syncs`, as the engine's own reads are, and in this
object's `host_syncs`.

    state', bundle = harvest.extract(state, full=True)
    fetched = harvest.fetch(bundle)       # the segment's only read
    harvest.consume(fetched, sim_ns)      # host-side formatting

The trace ring's reset rides the extraction: the bundle keeps the
pre-reset record columns, and the returned state carries the reset ring.

Sharded (a Simulation with a `mesh`), each rank extracts its shard's
bundle and the fetch makes it global before the copy: the per-host
subtrees (tracker, trace, capture and pressure rows) gather to rank 0 in
one collective, the counters sum over the ranks in another (the clock,
window and sweep counts and the cross-shard count are replicated, the
spill high-water mark takes a max), and the queue fill is the global
valid count times the f32 reciprocal of the global slot count. Every
rank gets the reduced counters, so each takes the same decisions; only
rank 0 gets the per-host rows, the one host read of the segment there.

For a fleet (`runtime.fleet.Fleet`), the bundle holds each lane's
summary counters and queue fill as [L] tensors, read in the same one
copy for all lanes; the per-scenario consumers (tracker, trace, capture,
metrics) are refused, as the reference refuses them.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from shadow_tpu_torch.convert import numpy_dtype
from shadow_tpu_torch.core.timebase import TIME_INVALID


def _flatten(tree, prefix=()) -> list:
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += _flatten(v, prefix + (k,))
        else:
            out.append((prefix + (k,), v))
    return out


def _unflatten(items) -> dict:
    out: dict = {}
    for path, v in items:
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = v
    return out


class _Staging:
    """A pinned host buffer that grows to the largest bundle seen."""

    def __init__(self):
        self.buf: torch.Tensor | None = None

    def take(self, n: int) -> torch.Tensor:
        if self.buf is None or self.buf.numel() < n:
            # a normal tensor even under inference mode, so that a later
            # fetch outside it may still copy into the buffer
            with torch.inference_mode(False):
                self.buf = torch.empty((n,), dtype=torch.uint8,
                                       pin_memory=True)
        return self.buf[:n]


def fetch_tree(tree: dict, staging: _Staging | None = None) -> dict:
    """Copy a nested dict of tensors (all on one device) to numpy in one
    device-to-host copy; returns the same nesting of numpy arrays."""
    items = _flatten(tree)
    if not items:
        return {}
    parts, layout = [], []
    for path, t in items:
        t = t.detach().contiguous()
        layout.append((path, numpy_dtype(t), tuple(t.shape),
                       t.numel() * t.element_size()))
        parts.append(t.reshape(-1).view(torch.uint8))
    flat = torch.cat(parts)
    if flat.is_cuda:
        host = (staging or _Staging()).take(flat.numel())
        host.copy_(flat, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
        raw = host.numpy()
    else:
        raw = flat.numpy()
    out, off = [], 0
    for path, dtype, shape, nbytes in layout:
        # a copy: the pinned buffer is reused by the next fetch
        a = raw[off:off + nbytes].view(dtype).reshape(shape).copy()
        out.append((path, a))
        off += nbytes
    return _unflatten(out)


# bundle subtrees of per-host rows, gathered (not reduced) when sharded
_PER_HOST = ("tracker", "trace", "pcap", "pressure")
# counters every shard holds the same value of (the others are summed;
# the spill ring's high-water mark is a max, but a spill ring runs on one
# shard only)
_REPLICATED = ("now_ns", "windows", "sweeps", "cross_shard",
               "cross_shard_packets")


def _f32_fill(count, numel: int) -> np.float32:
    """`queue_fill_ref` on the host: the valid count (exact in f32 below
    2^24) times the f32 reciprocal of the slot count."""
    return np.float32(count) * (np.float32(1.0) / np.float32(numel))


def reduce_tree(tree: dict, mesh, staging: "_Staging | None" = None
                ) -> dict:
    """A sharded bundle made global, as numpy: per-host subtrees
    (`_PER_HOST`) gathered to rank 0 (absent elsewhere), the rest
    reduced over the ranks on every rank (a sum, or rank 0's value for
    `_REPLICATED`), and "fill_count" turned into the global "fill". Every
    rank must call it; the copy to the host is one per rank."""
    comm = mesh.comm
    items = _flatten(tree)
    gath = [(p, t) for p, t in items if p[0] in _PER_HOST]
    red = [(p, t) for p, t in items if p[0] not in _PER_HOST]
    out = [(p, t) for p, t in red if p[-1] in _REPLICATED]
    sums = [(p, t) for p, t in red if p[-1] not in _REPLICATED]
    if sums:
        if any(t.dtype.is_floating_point for _, t in sums):
            raise TypeError("a sharded bundle sums integer counters only")
        flat = comm.gsum(torch.cat([t.reshape(-1).to(torch.int64)
                                    for _, t in sums]))
        off = 0
        for p, t in sums:
            n = t.numel()
            out.append((p, flat[off:off + n].reshape(t.shape).to(t.dtype)))
            off += n
    got = fetch_tree(_unflatten(out), staging)
    if "fill_count" in got:
        got["fill"] = _f32_fill(int(got.pop("fill_count")),
                                int(got.pop("fill_slots")))
    if gath:
        parts, layout = [], []
        for p, t in gath:
            t = t.detach().contiguous()
            layout.append((p, numpy_dtype(t), tuple(t.shape),
                           t.numel() * t.element_size()))
            parts.append(t.reshape(-1).view(torch.uint8))
        bufs = comm.gather(torch.cat(parts))
        if bufs is not None:
            raws = [b.cpu().numpy() for b in bufs]
            rows, off = [], 0
            for p, dtype, shape, nbytes in layout:
                rows.append((p, np.concatenate(
                    [r[off:off + nbytes].view(dtype).reshape(shape)
                     for r in raws])))
                off += nbytes
            for k, v in _unflatten(rows).items():
                got[k] = v
    return got


def queue_fill_ref(q) -> torch.Tensor:
    """The mean slot occupancy of the queues as a 0-d f32 tensor, as the
    reference computes its `jnp.mean` of the f32 mask: the valid-slot
    count (exact in f32 below 2^24) times the f32 reciprocal of the slot
    count (XLA turns the division by a constant into that product)."""
    n = torch.sum(q.time != TIME_INVALID, dtype=torch.int64)
    recip = np.float32(1.0) / np.float32(q.time.numel())
    return n.to(torch.float32) * torch.full(
        (), float(recip), dtype=torch.float32, device=q.time.device)


def fill_refs(q, mesh=None) -> dict:
    """Device refs of the queue fill: {"fill": queue_fill_ref(q)}, or
    under a mesh the shard's counts, which `reduce_tree` turns into the
    global fill."""
    if mesh is None:
        return {"fill": queue_fill_ref(q)}
    return {"fill_count": torch.sum(q.time != TIME_INVALID,
                                    dtype=torch.int64),
            "fill_slots": torch.full((), q.time.numel(), dtype=torch.int64,
                                     device=q.time.device)}


def fetch_global(tree: dict, mesh=None, staging=None) -> dict:
    """`fetch_tree`, or under a mesh `reduce_tree`."""
    if mesh is None:
        return fetch_tree(tree, staging)
    return reduce_tree(tree, mesh, staging)


class HeartbeatHarvest:
    """Gathers every segment-boundary read into one copy.

    `tracker`, `tdrain`, `pcap` (a `utils.pcap.CaptureDrain`) and
    `metrics` are the CLI's observability consumers (any may be None);
    `sim` provides the pressure controller and the engine whose
    `host_syncs` counts the copy.
    """

    def __init__(self, sim, *, tracker=None, tdrain=None, pcap=None,
                 metrics=None):
        self.sim = sim
        self.tracker = tracker
        self.tdrain = tdrain
        self.pcap = pcap
        # truthy: carry the live-telemetry reductions
        # (obs.metrics.metrics_device_refs) in the bundle
        self.metrics = metrics
        self.host_syncs = 0
        self._staging = _Staging()
        self.mesh = getattr(sim, "mesh", None)
        self.lanes = int(getattr(sim, "lanes", 0) or 0)
        if self.lanes and (tracker is not None or tdrain is not None
                           or pcap is not None or metrics):
            raise ValueError(
                "fleet harvest carries per-lane summaries only; "
                "tracker/trace/pcap/metrics consumers are "
                "per-scenario — attach them to solo runs"
            )

    def rebind(self, sim) -> None:
        """Point at a rebuilt Simulation (the --overflow grow
        re-template)."""
        self.sim = sim

    # -- device half -----------------------------------------------------

    def extract(self, state, *, full: bool):
        """Gather the segment's bundle as device tensors (no copy);
        returns (state, bundle). With `full` (a heartbeat) the bundle
        also holds the tracker's counters, the trace ring's records
        (the returned state has that ring reset) and the capture rings
        (never reset: the drain tracks each host's write counter)."""
        sim = self.sim
        q = state.queues
        if self.lanes:
            from shadow_tpu_torch.runtime.fleet import (
                lane_fill_refs,
                lane_summary_refs,
            )

            return state, {"summary": lane_summary_refs(state),
                           "fill": lane_fill_refs(q, self.lanes)}
        bundle: dict[str, Any] = {
            # core.engine.state_summary's keys and reductions
            "summary": {
                "now_ns": state.now,
                "windows": state.stats.n_windows,
                "executed": state.stats.n_executed.sum(),
                "sweeps": state.stats.n_sweeps,
                "queue_drops": q.drops.sum(),
            },
            # obs.profiler.queue_fill's reduction
            **fill_refs(q, self.mesh),
        }
        if q.spill is not None:
            ring = q.spill
            bundle["summary"]["spilled"] = ring.n_spilled.sum()
            bundle["summary"]["spill_lost"] = ring.n_lost.sum()
            bundle["summary"]["fill_hwm"] = ring.fill_hwm.max()
        if sim.pressure is not None:
            bundle["pressure"] = sim.pressure.gather(state)
        if self.metrics is not None:
            bundle["metrics"] = sim.metrics_refs(state)
        if state.splane is not None:
            from shadow_tpu_torch.obs.stats import stats_device_refs

            bundle["stats"] = stats_device_refs(state.splane)
        if full:
            if self.tracker is not None:
                bundle["tracker"] = self.tracker.gather(state)
                ram = getattr(self.tracker, "_ram_static", None)
                if ram is not None and self.mesh is not None:
                    # the ram rows' bytes per host are the global state's
                    from shadow_tpu_torch.parallel.mesh import global_specs

                    total = sum(int(np.prod(shape)) * dtype.itemsize
                                for _, shape, dtype
                                in global_specs(state, self.mesh))
                    self.tracker._ram_static = ram[:2] + (
                        total // max(len(self.tracker.names), 1),)
            if self.tdrain is not None and state.trace is not None:
                from shadow_tpu_torch.obs.trace import TraceDrain, reset_ring

                bundle["trace"] = TraceDrain.gather(state.trace)
                state = dataclasses.replace(
                    state, trace=reset_ring(state.trace))
            if self.pcap is not None and state.hosts.net.cap is not None:
                from shadow_tpu_torch.utils.pcap import CaptureDrain

                bundle["pcap"] = CaptureDrain.gather(state.hosts.net.cap)
        return state, bundle

    # -- host half -------------------------------------------------------

    def fetch(self, bundle: dict) -> dict:
        """The segment's one device-to-host copy, counted (made global
        first when sharded: `reduce_tree`)."""
        self.host_syncs += 1
        self.sim.engine.host_syncs += 1
        return fetch_global(bundle, self.mesh, self._staging)

    def lane_summaries_from(self, fetched: dict) -> list:
        """Fleet bundles only: per-lane summary dicts, each equal to the
        lane's solo `state_summary`."""
        from shadow_tpu_torch.runtime.fleet import lane_summaries_from

        return lane_summaries_from(fetched["summary"])

    def summary_from(self, fetched: dict) -> dict:
        """`Simulation.summary`'s dict from a fetched bundle (no state
        access, no read); for a fleet, the lanes' aggregate."""
        if self.lanes:
            from shadow_tpu_torch.runtime.fleet import aggregate_summary

            return aggregate_summary(fetched["summary"])
        out = {k: int(v) for k, v in fetched["summary"].items()}
        sim = self.sim
        if sim.profiler is not None:
            out["profile"] = sim.profiler.summary()
        if sim.pressure is not None and "pressure" in fetched:
            snap = sim.pressure.snapshot_from(fetched["pressure"])
            out["refilled"] = snap.get("refilled", 0)
            out["reservoir"] = snap.get("resident", 0)
            out["overdue"] = snap.get("overdue", 0)
        return out

    def consume(self, fetched: dict, sim_ns: int) -> None:
        """Feed a fetched full bundle to every observability consumer.
        Trace first: the tracker's [trace] section reads the drain's
        interval counts."""
        if self.tdrain is not None and "trace" in fetched:
            self.tdrain.ingest(fetched["trace"])
        if self.tracker is not None and "tracker" in fetched:
            self.tracker.heartbeat_from(fetched["tracker"], sim_ns)
        if self.tracker is not None and "stats" in fetched:
            self.tracker.stats_from(fetched["stats"], sim_ns)
        if self.pcap is not None and "pcap" in fetched:
            self.pcap.ingest(fetched["pcap"])
