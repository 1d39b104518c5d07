"""Window-phase wall-clock profiler for the host-side run loop.

The counterpart of `shadow_tpu.obs.profiler`. Everything around the
drain is plain Python: building the simulation, each step call, host
drains, checkpoint writes. `WindowProfiler` times those phases with
`time.perf_counter()` context managers, keeps aggregates (count / total
/ max per phase) and a bounded span list (for the exporter's wall-time
tracks), and samples per-window occupancy (events per sweep, queue fill)
from `state_summary` deltas. A phase's wall time on the card covers the
work the host enqueued and waited for inside it.

Wall-clock numbers are nondeterministic; they stay under
`Simulation.summary()`'s "profile" key.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager

import torch

# Canonical phase names (any string works; these are the reference's, and
# what the exporter turns into wall-time tracks):
#   build      - simulation construction + initial state
#   step       - one window step or run call
#   drain      - host-side drains: tracker snapshot, pcap ring, trace ring
#   pump       - process-tier shim syscall pump
#   checkpoint - checkpoint serialization + write
PHASES = ("build", "step", "drain", "pump", "checkpoint")


class WindowProfiler:
    """Accumulates per-phase wall time + per-window occupancy samples."""

    def __init__(self, max_spans: int = 50_000, max_occ: int = 50_000):
        self._t0 = time.perf_counter()
        self._agg: dict[str, dict] = {}
        self._max_spans = max_spans
        self._max_occ = max_occ
        self._spans_dropped = 0
        self.spans: list[tuple[str, float, float]] = []  # (phase, start, dur)
        self.occupancy: list[dict] = []
        self._last: dict | None = None

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            a = self._agg.setdefault(
                name, {"count": 0, "total_s": 0.0, "max_s": 0.0}
            )
            a["count"] += 1
            a["total_s"] += dt
            a["max_s"] = max(a["max_s"], dt)
            if len(self.spans) < self._max_spans:
                self.spans.append((name, t0 - self._t0, dt))
            else:
                self._spans_dropped += 1

    def observe(self, summary: dict, *, queue_fill: float | None = None,
                stall_margin_s: float | None = None) -> dict:
        """Record one occupancy sample from an engine `state_summary`
        dict (deltas against the previous observation)."""
        last = self._last or {}
        dw = summary["windows"] - last.get("windows", 0)
        de = summary["executed"] - last.get("executed", 0)
        ds = summary["sweeps"] - last.get("sweeps", 0)
        sample = {
            "now_ns": summary["now_ns"],
            "windows_d": dw,
            "events_d": de,
            "sweeps_d": ds,
            "events_per_sweep": (de / ds) if ds else 0.0,
            "queue_fill": queue_fill,
            "stall_margin_s": stall_margin_s,
        }
        if len(self.occupancy) < self._max_occ:
            self.occupancy.append(sample)
        self._last = dict(summary)
        return sample

    def summary(self) -> dict:
        """Aggregate view, merged under Simulation.summary's "profile"
        key (wall-clock numbers)."""
        occ = self.occupancy
        n = len(occ)
        fills = [s["queue_fill"] for s in occ if s["queue_fill"] is not None]
        out = {
            "wall_s": time.perf_counter() - self._t0,
            "phases": {k: dict(v) for k, v in sorted(self._agg.items())},
            "occupancy": {
                "samples": n,
                "events_per_sweep": (
                    sum(s["events_per_sweep"] for s in occ) / n if n else 0.0
                ),
                "queue_fill_mean": (
                    sum(fills) / len(fills) if fills else None
                ),
            },
        }
        if self._spans_dropped:
            out["spans_dropped"] = self._spans_dropped
        return out

    def export(self) -> dict:
        """JSON-able payload for the trace .npz meta: aggregates plus the
        raw span list the exporter turns into per-phase wall tracks."""
        return {
            "phases": {k: dict(v) for k, v in sorted(self._agg.items())},
            "spans": [[n, round(s, 9), round(d, 9)]
                      for n, s, d in self.spans],
            "occupancy": self.occupancy,
        }


def queue_fill(state) -> float:
    """Fraction of event-queue slots holding a live event (one device
    reduction and one scalar copy to the host)."""
    from shadow_tpu_torch.core.timebase import TIME_INVALID

    return float(torch.mean(
        (state.queues.time != TIME_INVALID).to(torch.float32)))


class DeviceTrace:
    """The `--xprof` capture: `torch.profiler` over the CPU and, on the
    card, the CUDA kernels, from construction to `stop`, which writes a
    Chrome trace (`trace.json`) into `out_dir`."""

    FILE = "trace.json"

    def __init__(self, out_dir: str, device):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.path = os.path.join(out_dir, self.FILE)
        os.makedirs(out_dir, exist_ok=True)
        self._prof = profile(activities=acts)
        self._prof.start()

    def stop(self) -> str:
        """End the capture and write the trace; returns its path."""
        self._prof.stop()
        self._prof.export_chrome_trace(self.path)
        return self.path
