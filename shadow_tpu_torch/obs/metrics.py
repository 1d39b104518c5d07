"""Live telemetry plane: metrics registry, flight recorder, health.

The counterpart of `shadow_tpu.obs.metrics`, with the same families,
names and exposition, so a scrape of either package reads the same:

- `MetricsRegistry` declares every counter/gauge the engine already
  computes, once, with provenance, and is populated from the
  `HeartbeatHarvest` bundle (`runtime/harvest.py`): with `--metrics`
  the bundle gains a handful of device-side reductions (net drops,
  fault drops, cross-shard traffic, socket byte totals) that ride the
  segment's one device-to-host copy.
- `render()` emits the OpenMetrics text format (`# TYPE`/`# HELP`
  lines, counters sampled as `<family>_total`, terminated by `# EOF`),
  deterministically: two scrapes between heartbeats are byte-identical.
  `validate_openmetrics` is the syntax checker a scrape is held to.
- `FlightRecorder` keeps a bounded host-side ring of the last K
  fetched heartbeat summaries and supervisor events; every diagnostic
  bundle (exits 70, 75, 76) serializes it.
- `HealthState` is the exit-code-aware `/healthz` state machine:
  ok -> degraded (watchdog near-miss, pressure event, retry relaunch)
  -> failed (an abnormal exit code was chosen).

The HTTP half (`--metrics-port`) lives in `obs/server.py`. The serving
plane (`serve/`) has its own registry, `ServeMetrics` (`SERVE_SPECS`),
whose exposition is the reference's byte for byte.
"""

from __future__ import annotations

import collections
import dataclasses
import re
import threading
import time
from typing import Any


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    """One declared metric family: name (OpenMetrics family, no
    `_total` suffix), kind (counter|gauge), help text, and provenance —
    where in the engine the value actually comes from."""

    name: str
    kind: str  # "counter" | "gauge"
    help: str
    source: str


_P = "shadow_tpu_"

# The full catalog. Every family is populated from values the engine
# already computes: the harvest summary dict, the metrics-on extras
# reductions, or host-side observability state (profiler, watchdog,
# checkpoint counter). Nothing here causes its own device fetch.
SPECS: tuple[MetricSpec, ...] = (
    MetricSpec(_P + "events", "counter",
               "Executed simulation events.",
               "EngineStats.n_executed.sum() via the harvest summary"),
    MetricSpec(_P + "windows", "counter",
               "Completed conservative windows.",
               "EngineStats.n_windows via the harvest summary"),
    MetricSpec(_P + "sweeps", "counter",
               "Drain sweeps across all windows.",
               "EngineStats.n_sweeps via the harvest summary"),
    MetricSpec(_P + "queue_drops", "counter",
               "Events lost to queue overflow (drop mode).",
               "EventQueue.drops.sum() via the harvest summary"),
    MetricSpec(_P + "spilled", "counter",
               "Events evicted into the spill ring (spill/grow modes).",
               "SpillRing.n_spilled.sum() via the harvest summary"),
    MetricSpec(_P + "spill_lost", "counter",
               "Events lost to spill-ring overflow.",
               "SpillRing.n_lost.sum() via the harvest summary"),
    MetricSpec(_P + "pressure_refills", "counter",
               "Events re-seated from the host reservoir.",
               "PressureController refilled counter via the harvest "
               "summary"),
    MetricSpec(_P + "pressure_overdue", "counter",
               "Reservoir events re-seated past their due window.",
               "PressureController overdue counter via the harvest "
               "summary"),
    MetricSpec(_P + "net_dropped", "counter",
               "Packets lost to link reliability rolls.",
               "EngineStats.n_net_dropped.sum(), metrics-on harvest "
               "extras"),
    MetricSpec(_P + "fault_dropped", "counter",
               "Packets lost to fault overlays.",
               "EngineStats.n_fault_dropped.sum(), metrics-on harvest "
               "extras"),
    MetricSpec(_P + "quarantined_events", "counter",
               "Events voided by injected host crashes.",
               "EngineStats.n_quarantined.sum(), metrics-on harvest "
               "extras"),
    MetricSpec(_P + "cross_shard_packets", "counter",
               "Packets delivered across mesh shards (xchg traffic).",
               "EngineStats.n_cross_shard, metrics-on harvest extras"),
    MetricSpec(_P + "rx_bytes", "counter",
               "Payload bytes received across all sockets.",
               "SocketTable.rx_bytes.sum(), metrics-on harvest extras"),
    MetricSpec(_P + "tx_bytes", "counter",
               "Payload bytes sent across all sockets.",
               "SocketTable.tx_bytes.sum(), metrics-on harvest extras"),
    MetricSpec(_P + "heartbeats", "counter",
               "Harvest bundles ingested by the registry.",
               "host-side: one per segment-boundary fetch"),
    MetricSpec(_P + "checkpoints", "counter",
               "Checkpoints written this run.",
               "host-side: SupervisorHeartbeat.checkpoints_written"),
    MetricSpec(_P + "phase_seconds", "counter",
               "Wall-clock seconds per run-loop phase (--profile).",
               "host-side: WindowProfiler phase aggregates"),
    MetricSpec(_P + "phase_calls", "counter",
               "Run-loop phase entries (--profile).",
               "host-side: WindowProfiler phase aggregates"),
    MetricSpec(_P + "sim_seconds", "gauge",
               "Simulated time reached, seconds.",
               "EngineState.now via the harvest summary"),
    MetricSpec(_P + "queue_fill", "gauge",
               "Mean event-queue slot occupancy, 0..1.",
               "harvest bundle fill reduction"),
    MetricSpec(_P + "fill_hwm", "gauge",
               "High-water per-host queue fill (spill/grow modes).",
               "SpillRing.fill_hwm.max() via the harvest summary"),
    MetricSpec(_P + "reservoir_resident", "gauge",
               "Events parked in the host pressure reservoir.",
               "PressureController resident count via the harvest "
               "summary"),
    MetricSpec(_P + "watchdog_margin_seconds", "gauge",
               "Seconds of stall-watchdog deadline left at the last "
               "window boundary.",
               "host-side: runtime.Watchdog.margin_s()"),
    MetricSpec(_P + "health", "gauge",
               "Run health: 0 ok, 1 degraded, 2 failed.",
               "host-side: obs.metrics.HealthState"),
    MetricSpec(_P + "shards", "gauge",
               "Mesh shard count (1 = single device).",
               "build-time --mesh"),
    MetricSpec(_P + "build_info", "gauge",
               "Constant 1; the version label carries the build.",
               "shadow_tpu_torch.__version__"),
)

SPEC_BY_NAME = {s.name: s for s in SPECS}

# harvest-summary key -> family (cumulative counters set directly)
_SUMMARY_COUNTERS = {
    "executed": _P + "events",
    "windows": _P + "windows",
    "sweeps": _P + "sweeps",
    "queue_drops": _P + "queue_drops",
    "spilled": _P + "spilled",
    "spill_lost": _P + "spill_lost",
    "refilled": _P + "pressure_refills",
    "overdue": _P + "pressure_overdue",
}
# metrics-on extras key -> family
_EXTRAS_COUNTERS = {
    "net_dropped": _P + "net_dropped",
    "fault_dropped": _P + "fault_dropped",
    "quarantined": _P + "quarantined_events",
    "cross_shard": _P + "cross_shard_packets",
    "rx_bytes": _P + "rx_bytes",
    "tx_bytes": _P + "tx_bytes",
}
# end-of-run summary key -> family (cli.py's final JSON line uses
# different spellings than the per-segment harvest summary)
_FINAL_COUNTERS = {
    "events": _P + "events",
    "windows": _P + "windows",
    "sweeps": _P + "sweeps",
    "queue_drops": _P + "queue_drops",
    "net_dropped": _P + "net_dropped",
    "fault_dropped": _P + "fault_dropped",
    "quarantined_events": _P + "quarantined_events",
    "cross_shard_packets": _P + "cross_shard_packets",
    "rx_bytes": _P + "rx_bytes",
    "tx_bytes": _P + "tx_bytes",
}

# --stats histogram families (obs.stats.FAMILIES): exposed with the
# standard OpenMetrics histogram triplet — cumulative `_bucket` samples
# with `le` labels, `_sum`, `_count`. Rendered only once a stats bundle
# has been ingested, so a stats-off run's exposition is unchanged.
def _hist_specs():
    from shadow_tpu_torch.obs.stats import FAMILIES

    return tuple(
        (key, MetricSpec(_P + name, "histogram", help_ + ".",
                         f"StatPlane.{key}_n/.{key}_s via the harvest "
                         "stats bundle"))
        for key, name, help_ in FAMILIES
    )


# the [metrics] tracker heartbeat row: cumulative registry totals (NOT
# interval deltas like [node]) so a scrape, the tracker line, and the
# end-of-run summary are directly comparable
METRICS_HEADER = (
    "[shadow-heartbeat] [metrics-header] time-seconds,"
    "events,queue-drops,net-dropped,fault-dropped,cross-shard-packets,"
    "rx-bytes,tx-bytes,queue-fill,heartbeats"
)
METRICS_ROW_FAMILIES = (
    _P + "events", _P + "queue_drops", _P + "net_dropped",
    _P + "fault_dropped", _P + "cross_shard_packets",
    _P + "rx_bytes", _P + "tx_bytes",
)


def metrics_device_refs(state) -> dict:
    """The metrics-on extras: device-side reductions beyond what the
    harvest summary already carries, embedded in the harvest bundle so
    they ride the segment's one device-to-host copy. These are the sums
    the CLI's end-of-run summary reads after the loop; with `--metrics`
    they stream live instead."""
    stats = state.stats
    socks = state.hosts.net.sockets
    return {
        "net_dropped": stats.n_net_dropped.sum(),
        "fault_dropped": stats.n_fault_dropped.sum(),
        "quarantined": stats.n_quarantined.sum(),
        "cross_shard": stats.n_cross_shard,
        "rx_bytes": socks.rx_bytes.sum(),
        "tx_bytes": socks.tx_bytes.sum(),
    }


def _num(v) -> float:
    f = float(v)
    return f


def _fmt(v: float) -> str:
    """OpenMetrics sample value: integers render without a trailing
    .0 so counter lines match the tracker's integer CSV exactly."""
    f = float(v)
    if f.is_integer() and abs(f) < 2**63:
        return str(int(f))
    return repr(f)


class MetricsRegistry:
    """Declared-once metric families populated from the harvest bundle.

    Thread-safe: the run loop ingests from the main thread while the
    HTTP server renders from its handler threads. All mutation happens
    in `ingest`/`observe`/`finalize`; `render`/`totals` only read.
    """

    def __init__(self, *, version: str = "", n_shards: int = 1):
        self._lock = threading.Lock()
        self._v: dict[str, float] = {s.name: 0.0 for s in SPECS
                                     if s.name != _P + "phase_seconds"
                                     and s.name != _P + "phase_calls"}
        self._phases: dict[str, dict] = {}
        # --stats histograms: family key -> (bucket counts [NB], sum).
        # Empty until the first ingest_stats, so stats-off expositions
        # carry no histogram families at all.
        self._hist: dict[str, tuple] = {}
        self._labels = {"version": version or "unknown"}
        self._v[_P + "shards"] = float(max(int(n_shards), 1))
        self._v[_P + "build_info"] = 1.0

    # ------------------------------------------------------------ ingest

    def ingest(self, summary: dict, *, extras: dict | None = None,
               fill: float | None = None) -> None:
        """Fold one fetched segment bundle in: the harvest summary dict
        (cumulative counters, set directly), the metrics-on extras, and
        the queue-fill gauge. Called once per segment boundary — pure
        host arithmetic on an already-fetched bundle."""
        with self._lock:
            for key, fam in _SUMMARY_COUNTERS.items():
                if key in summary:
                    self._v[fam] = _num(summary[key])
            if "now_ns" in summary:
                self._v[_P + "sim_seconds"] = _num(summary["now_ns"]) / 1e9
            if "fill_hwm" in summary:
                self._v[_P + "fill_hwm"] = _num(summary["fill_hwm"])
            if "reservoir" in summary:
                self._v[_P + "reservoir_resident"] = _num(
                    summary["reservoir"])
            if extras:
                for key, fam in _EXTRAS_COUNTERS.items():
                    if key in extras:
                        self._v[fam] = _num(extras[key])
            if fill is not None:
                self._v[_P + "queue_fill"] = _num(fill)
            self._v[_P + "heartbeats"] += 1.0

    def ingest_stats(self, stats_fetched: dict) -> None:
        """Fold one fetched --stats bundle (obs.stats.stats_device_refs
        after device_get) in: cumulative per-family bucket vectors and
        value sums, replacing the previous beat's (the StatPlane
        accumulates on device, so each fetch is already a running
        total)."""
        from shadow_tpu_torch.obs.stats import FAMILY_KEYS

        with self._lock:
            for k in FAMILY_KEYS:
                buckets = [int(v) for v in stats_fetched[f"{k}_bucket"]]
                self._hist[k] = (buckets, int(stats_fetched[f"{k}_sum"]))

    def observe(self, *, watchdog_margin_s: float | None = None,
                checkpoints: int | None = None,
                health: "HealthState | None" = None,
                profiler: Any = None) -> None:
        """Fold in the host-side sources that never touch the device:
        watchdog margin, checkpoint count, health state, and the
        --profile phase aggregates."""
        with self._lock:
            if watchdog_margin_s is not None:
                self._v[_P + "watchdog_margin_seconds"] = _num(
                    watchdog_margin_s)
            if checkpoints is not None:
                self._v[_P + "checkpoints"] = _num(checkpoints)
            if health is not None:
                self._v[_P + "health"] = float(health.code())
            if profiler is not None:
                for name, agg in profiler.summary()["phases"].items():
                    self._phases[name] = {
                        "seconds": _num(agg.get("total_s", 0.0)),
                        "calls": _num(agg.get("count", 0)),
                    }

    def finalize(self, final_summary: dict) -> None:
        """Align the registry with the end-of-run summary line so the
        last scrape equals the printed totals exactly (the summary's
        post-loop fetches are authoritative — they see the final state
        after the trace drain)."""
        with self._lock:
            for key, fam in _FINAL_COUNTERS.items():
                if key in final_summary:
                    self._v[fam] = _num(final_summary[key])
            if "sim_seconds" in final_summary:
                self._v[_P + "sim_seconds"] = _num(
                    final_summary["sim_seconds"])
            pres = final_summary.get("pressure") or {}
            for key, fam in (("spilled", _P + "spilled"),
                             ("spill_lost", _P + "spill_lost"),
                             ("refilled", _P + "pressure_refills"),
                             ("overdue", _P + "pressure_overdue"),
                             ("resident", _P + "reservoir_resident"),
                             ("fill_hwm", _P + "fill_hwm")):
                if key in pres:
                    self._v[fam] = _num(pres[key])

    # -------------------------------------------------------------- read

    def totals(self) -> dict:
        """Plain {family: value} snapshot — the `/summary.json` body,
        the [metrics] tracker row, and what tests reconcile against."""
        with self._lock:
            out = {k: (int(v) if float(v).is_integer() else v)
                   for k, v in sorted(self._v.items())}
            for name, agg in sorted(self._phases.items()):
                out[f"{_P}phase_seconds{{phase={name}}}"] = agg["seconds"]
            if self._hist:
                from shadow_tpu_torch.obs.stats import FAMILIES

                for key, name, _ in FAMILIES:
                    if key in self._hist:
                        buckets, total = self._hist[key]
                        out[f"{_P}{name}_count"] = sum(buckets)
                        out[f"{_P}{name}_sum"] = total
        return out

    def metrics_row(self, t_s: int) -> str:
        """The cumulative [metrics] heartbeat CSV row (METRICS_HEADER
        order). Emitted by the Tracker right after the [node] section
        built from the same extraction program's snapshot, so the two
        reconcile by construction."""
        with self._lock:
            vals = [str(int(self._v[f])) for f in METRICS_ROW_FAMILIES]
            fill = repr(float(self._v[_P + "queue_fill"]))
            hbs = str(int(self._v[_P + "heartbeats"]))
        return f"{t_s}," + ",".join(vals) + f",{fill},{hbs}"

    def render(self) -> str:
        """The OpenMetrics exposition. Deterministic: families in
        catalog order, one `# TYPE` + `# HELP` per family, counters
        sampled as `<family>_total`, `# EOF` terminator. Contains no
        scrape-varying state, so repeated scrapes between ingests are
        byte-identical."""
        with self._lock:
            values = dict(self._v)
            phases = {k: dict(v) for k, v in sorted(self._phases.items())}
            hist = {k: (list(b), s) for k, (b, s) in self._hist.items()}
        lines: list[str] = []
        for spec in SPECS:
            lines.append(f"# TYPE {spec.name} {spec.kind}")
            lines.append(f"# HELP {spec.name} {spec.help}")
            suffix = "_total" if spec.kind == "counter" else ""
            if spec.name == _P + "phase_seconds":
                for ph, agg in phases.items():
                    lines.append(f"{spec.name}{suffix}"
                                 f'{{phase="{ph}"}} {_fmt(agg["seconds"])}')
            elif spec.name == _P + "phase_calls":
                for ph, agg in phases.items():
                    lines.append(f"{spec.name}{suffix}"
                                 f'{{phase="{ph}"}} {_fmt(agg["calls"])}')
            elif spec.name == _P + "build_info":
                lines.append(f'{spec.name}{{version='
                             f'"{self._labels["version"]}"}} 1')
            else:
                lines.append(
                    f"{spec.name}{suffix} {_fmt(values[spec.name])}")
        if hist:
            from shadow_tpu_torch.obs.stats import BUCKET_LE_LABELS

            for key, spec in _hist_specs():
                if key not in hist:
                    continue
                buckets, total_sum = hist[key]
                lines.append(f"# TYPE {spec.name} histogram")
                lines.append(f"# HELP {spec.name} {spec.help}")
                cum = 0
                for le, n in zip(BUCKET_LE_LABELS, buckets):
                    cum += n
                    lines.append(
                        f'{spec.name}_bucket{{le="{le}"}} {cum}')
                lines.append(f"{spec.name}_sum {total_sum}")
                lines.append(f"{spec.name}_count {cum}")
        lines.append("# EOF")
        return "\n".join(lines) + "\n"


# The resident scenario-serving plane (shadow_tpu_torch.serve) exposes its own
# small family catalog through the same exposition machinery. It is a
# SEPARATE registry on purpose: a batch run's /metrics must stay
# byte-stable against serve-plane churn (the --metrics zero-cost pin),
# and a serving process has no harvest summary to ingest — every value
# here is host-side scheduler state. The request-latency histogram rides
# the obs.stats log2-bucket scheme (NB buckets, le = 2^i - 1) so the
# same parse/plot tooling reads both planes.

SERVE_SPECS: tuple[MetricSpec, ...] = (
    MetricSpec(_P + "serve_requests", "counter",
               "Scenario requests accepted by the serving plane.",
               "host-side: SimService.submit"),
    MetricSpec(_P + "serve_results", "counter",
               "Requests completed with a summary.",
               "host-side: launch completion"),
    MetricSpec(_P + "serve_errors", "counter",
               "Requests failed (build/launch errors).",
               "host-side: launch failure path"),
    MetricSpec(_P + "serve_cache_hits", "counter",
               "Program-cache hits (warm compiled fleet reused).",
               "host-side: serve.cache.ProgramCache"),
    MetricSpec(_P + "serve_cache_misses", "counter",
               "Program-cache misses (fresh compile).",
               "host-side: serve.cache.ProgramCache"),
    MetricSpec(_P + "serve_cache_evictions", "counter",
               "Programs evicted LRU at --max-cached-programs.",
               "host-side: serve.cache.ProgramCache"),
    MetricSpec(_P + "serve_launches", "counter",
               "Fleet launches dispatched.",
               "host-side: packer launch loop"),
    MetricSpec(_P + "serve_packed_launches", "counter",
               "Launches that packed >= 2 requests into one fleet.",
               "host-side: packer launch loop"),
    MetricSpec(_P + "serve_lanes", "counter",
               "Fleet lanes occupied by live requests, cumulative.",
               "host-side: packer launch loop"),
    MetricSpec(_P + "serve_queue_depth", "gauge",
               "Requests queued awaiting lane packing.",
               "host-side: LanePacker depth"),
    MetricSpec(_P + "serve_inflight", "gauge",
               "Requests riding the launch currently on device.",
               "host-side: packer launch loop"),
    MetricSpec(_P + "serve_cached_programs", "gauge",
               "Compiled fleet programs resident in the cache.",
               "host-side: serve.cache.ProgramCache"),
    MetricSpec(_P + "serve_last_lanes_packed", "gauge",
               "Live lanes in the most recent launch.",
               "host-side: packer launch loop"),
    MetricSpec(_P + "serve_launch_retries", "counter",
               "Launch attempts retried after an exception or stall.",
               "host-side: _run_batch retry loop"),
    MetricSpec(_P + "serve_bisections", "counter",
               "Batches split in half to isolate a poison request.",
               "host-side: _run_batch bisection"),
    MetricSpec(_P + "serve_timeouts", "counter",
               "Requests returned status=timeout past deadline_ms.",
               "host-side: beat-loop deadline masking"),
    MetricSpec(_P + "serve_snapshots", "counter",
               "Beat-boundary lane snapshots written.",
               "host-side: --snapshot-beats cadence"),
    MetricSpec(_P + "serve_resumes", "counter",
               "Launches resumed from a beat-boundary snapshot.",
               "host-side: snapshot load on retry/restart"),
    MetricSpec(_P + "serve_results_evicted", "counter",
               "Terminal result records evicted (TTL / LRU cap).",
               "host-side: --result-ttl-s / --max-results"),
    MetricSpec(_P + "serve_chaos_injected", "counter",
               "Faults injected by SHADOW_TPU_SERVE_CHAOS.",
               "host-side: serve.chaos.ServeChaos"),
    MetricSpec(_P + "serve_degraded", "gauge",
               "1 while repeated launch failures hold /submit at 503.",
               "host-side: _run_batch failure streak"),
    MetricSpec(_P + "serve_migrations", "counter",
               "Lane batches migrated across a device loss or resize.",
               "host-side: elastic snapshot reshard"),
    MetricSpec(_P + "serve_mesh_generation", "gauge",
               "Mesh generation (0 = as launched; bumps per migration "
               "or resize).",
               "host-side: elastic snapshot reshard"),
)

_SERVE_HIST = _P + "serve_request_latency_ns"

# per-class latency-decomposition histograms (docs/18-Serve-Tracing.md):
# short family key (what ServeTracer feeds via `observe_class`) ->
# (full family name, HELP). Same log2 bucket scheme as the request
# latency histogram; rendered only once a class has observations, so a
# tracer-off exposition is byte-identical to the pre-tracing one.
_SERVE_CLASS_HISTS: tuple[tuple[str, str, str], ...] = (
    ("queue_wait", _P + "serve_queue_wait_ns",
     "Submit->launch queue wait per class, wall nanoseconds."),
    ("pack_wait", _P + "serve_pack_wait_ns",
     "Launch setup (cache/pack/bind) wait per class, wall "
     "nanoseconds."),
    ("beat_wall", _P + "serve_beat_wall_ns",
     "Wall time per harvest beat per class, nanoseconds."),
)


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"')


class ServeMetrics:
    """Thread-safe serve-plane registry: the SERVE_SPECS counters and
    gauges plus one submit->result latency histogram on the obs.stats
    log2-bucket scheme. `render()` is deterministic (family catalog
    order, no scrape-varying state) and passes `validate_openmetrics`
    — chip_smoke.py's serving phase holds a scrape to
    tools/check_openmetrics.
    """

    def __init__(self):
        import threading

        from shadow_tpu_torch.obs.stats import NB

        self._lock = threading.Lock()
        self._v: dict[str, float] = {s.name: 0 for s in SERVE_SPECS}
        self._lat_buckets = [0] * NB
        self._lat_sum = 0
        # (short family, class) -> {"b": [NB counts], "sum": ns,
        #   "ex": {bucket idx: (rid, ns, t_s)}} — the exemplar is the
        # WORST (max ns) request id seen in that bucket
        self._class_h: dict[tuple[str, str], dict] = {}

    def inc(self, family: str, n: float = 1) -> None:
        with self._lock:
            self._v[_P + family] += n

    def set(self, family: str, v: float) -> None:
        with self._lock:
            self._v[_P + family] = v

    def observe_latency_ns(self, ns: int) -> None:
        """Fold one request's submit->result wall latency into the
        histogram. Bucket index = bit_length(ns) clipped, the exact
        host-side mirror of obs.stats.bucket_of."""
        from shadow_tpu_torch.obs.stats import NB

        ns = int(ns)
        idx = 0 if ns <= 0 else min(ns.bit_length(), NB - 1)
        with self._lock:
            self._lat_buckets[idx] += 1
            self._lat_sum += max(ns, 0)

    def observe_class(self, family: str, cls: str, ns: int, *,
                      rid: str | None = None,
                      t_s: float | None = None) -> None:
        """Fold one wait/beat duration into the per-class histogram
        `family` ("queue_wait" | "pack_wait" | "beat_wall"). `rid`
        becomes the bucket's OpenMetrics exemplar when it is the worst
        observation landed there so far; `t_s` is its exemplar
        timestamp (tracer-clock seconds). Fed by `ServeTracer` — a
        tracer-off service never calls this, keeping `render()`
        byte-identical."""
        from shadow_tpu_torch.obs.stats import NB

        if family not in {k for k, _, _ in _SERVE_CLASS_HISTS}:
            raise ValueError(
                f"unknown per-class histogram family {family!r}")
        ns = int(ns)
        idx = 0 if ns <= 0 else min(ns.bit_length(), NB - 1)
        with self._lock:
            h = self._class_h.setdefault(
                (family, str(cls)), {"b": [0] * NB, "sum": 0, "ex": {}})
            h["b"][idx] += 1
            h["sum"] += max(ns, 0)
            ex = h["ex"].get(idx)
            if rid is not None and (ex is None or ns >= ex[1]):
                h["ex"][idx] = (rid, ns, t_s)

    def totals(self) -> dict:
        with self._lock:
            out = {k: (int(v) if float(v).is_integer() else v)
                   for k, v in sorted(self._v.items())}
            out[f"{_SERVE_HIST}_count"] = sum(self._lat_buckets)
            out[f"{_SERVE_HIST}_sum"] = self._lat_sum
            for (fam, cls), h in sorted(self._class_h.items()):
                full = next(f for k, f, _ in _SERVE_CLASS_HISTS
                            if k == fam)
                out[f'{full}_count{{class="{cls}"}}'] = sum(h["b"])
                out[f'{full}_sum{{class="{cls}"}}'] = h["sum"]
        return out

    def render(self) -> str:
        from shadow_tpu_torch.obs.stats import BUCKET_LE_LABELS

        with self._lock:
            values = dict(self._v)
            buckets = list(self._lat_buckets)
            lat_sum = self._lat_sum
            class_h = {k: {"b": list(h["b"]), "sum": h["sum"],
                           "ex": dict(h["ex"])}
                       for k, h in self._class_h.items()}
        lines: list[str] = []
        for spec in SERVE_SPECS:
            lines.append(f"# TYPE {spec.name} {spec.kind}")
            lines.append(f"# HELP {spec.name} {spec.help}")
            suffix = "_total" if spec.kind == "counter" else ""
            lines.append(f"{spec.name}{suffix} {_fmt(values[spec.name])}")
        lines.append(f"# TYPE {_SERVE_HIST} histogram")
        lines.append(f"# HELP {_SERVE_HIST} Submit->result request "
                     "latency, wall nanoseconds.")
        cum = 0
        for le, n in zip(BUCKET_LE_LABELS, buckets):
            cum += n
            lines.append(f'{_SERVE_HIST}_bucket{{le="{le}"}} {cum}')
        lines.append(f"{_SERVE_HIST}_sum {lat_sum}")
        lines.append(f"{_SERVE_HIST}_count {cum}")
        # per-class wait/beat histograms, exemplars on the worst rid
        # per bucket (`# {trace_id="..."} value [ts]`) — families with
        # no observations render nothing, so tracer-off is byte-stable
        for fam, full, help_ in _SERVE_CLASS_HISTS:
            classes = sorted(c for (k, c) in class_h if k == fam)
            if not classes:
                continue
            lines.append(f"# TYPE {full} histogram")
            lines.append(f"# HELP {full} {help_}")
            for cls in classes:
                h = class_h[(fam, cls)]
                lbl = _escape_label(cls)
                cum_c = 0
                for i, (le, n) in enumerate(zip(BUCKET_LE_LABELS,
                                                h["b"])):
                    cum_c += n
                    line = (f'{full}_bucket{{class="{lbl}",le="{le}"}}'
                            f" {cum_c}")
                    ex = h["ex"].get(i)
                    if ex is not None:
                        rid, ns, t_s = ex
                        line += f' # {{trace_id="{rid}"}} {ns}'
                        if t_s is not None:
                            line += f" {_fmt(t_s)}"
                    lines.append(line)
                lines.append(f'{full}_sum{{class="{lbl}"}} {h["sum"]}')
                lines.append(f'{full}_count{{class="{lbl}"}} {cum_c}')
        lines.append("# EOF")
        return "\n".join(lines) + "\n"

# an OpenMetrics exemplar: `# {label="v",...} value [timestamp]`
# appended to a `_bucket` (or counter `_total`) sample line
_EXEMPLAR_RE = re.compile(
    r'^\{(?:[A-Za-z_][A-Za-z0-9_]*="(?:[^"\\]|\\.)*"'
    r'(?:,[A-Za-z_][A-Za-z0-9_]*="(?:[^"\\]|\\.)*")*)?\}'
    r" (\S+)(?: (\S+))?$")


def _check_exemplar(ex: str) -> str | None:
    m = _EXEMPLAR_RE.match(ex)
    if m is None:
        return "malformed exemplar"
    for tok in m.groups():
        if tok is None:
            continue
        try:
            float(tok)
        except ValueError:
            return f"unparseable exemplar value {tok!r}"
    return None


def _series_of(left: str) -> str:
    """The label set of a sample's left-hand side, `le` pair removed —
    the identity of one histogram series (per-class histograms put
    several series under one family)."""
    if "{" not in left:
        return ""
    labels = left.split("{", 1)[1].rsplit("}", 1)[0]
    return re.sub(r'(^|,)le="[^"]*"', "", labels).strip(",")


def validate_openmetrics(text: str) -> list[str]:
    """Minimal OpenMetrics syntax checker (the metrics_smoke gate).
    Returns a list of violations; empty means the exposition is
    well-formed: TYPE-before-samples, known kinds, counter samples
    suffixed `_total`, parseable values, no duplicate samples, and a
    final `# EOF` line. Histogram families get the full semantic
    check PER LABELED SERIES (e.g. one series per `class` label):
    samples only via `_bucket`/`_sum`/`_count` suffixes, `le`-labelled
    buckets in strictly increasing `le` order with non-decreasing
    cumulative counts, a mandatory `+Inf` bucket, and `_count` equal
    to the `+Inf` bucket's value. Exemplars (`# {trace_id="..."} value
    [ts]`) are accepted on `_bucket` and counter `_total` samples only
    and must themselves parse."""
    errors: list[str] = []
    kinds: dict[str, str] = {}
    seen: set[str] = set()
    # (family, series labels) ->
    #   {"buckets": [(le, value)], "sum": x, "count": x}
    hist: dict[tuple[str, str], dict] = {}
    lines = text.split("\n")
    if not lines or lines[-1] != "" or len(lines) < 2 \
            or lines[-2] != "# EOF":
        errors.append("missing terminal '# EOF' line (with newline)")
    for i, line in enumerate(l for l in lines if l):
        if line == "# EOF":
            continue
        if line.startswith("# TYPE "):
            parts = line.split(" ")
            if len(parts) != 4 or parts[3] not in ("counter", "gauge",
                                                   "histogram", "info"):
                errors.append(f"line {i}: malformed TYPE: {line!r}")
            else:
                kinds[parts[2]] = parts[3]
            continue
        if line.startswith("# HELP "):
            if len(line.split(" ", 3)) < 4:
                errors.append(f"line {i}: malformed HELP: {line!r}")
            continue
        if line.startswith("#"):
            errors.append(f"line {i}: unknown comment form: {line!r}")
            continue
        sample, exemplar = line, None
        if " # " in line:
            sample, exemplar = line.split(" # ", 1)
        left, _, value = sample.rpartition(" ")
        name = left.split("{", 1)[0]
        family = name[:-6] if name.endswith("_total") else name
        # histogram samples resolve to their family by suffix
        hist_suffix = None
        for suf in ("_bucket", "_sum", "_count"):
            base = name[:-len(suf)] if name.endswith(suf) else None
            if base and kinds.get(base) == "histogram":
                family, hist_suffix = base, suf
                break
        if family not in kinds:
            errors.append(f"line {i}: sample {name!r} before its TYPE")
            continue
        if kinds[family] == "counter" and not name.endswith("_total"):
            errors.append(f"line {i}: counter sample {name!r} must end "
                          "with _total")
        if kinds[family] == "gauge" and name.endswith("_total"):
            errors.append(f"line {i}: gauge sample {name!r} must not "
                          "end with _total")
        if exemplar is not None:
            if hist_suffix != "_bucket" and not name.endswith("_total"):
                errors.append(
                    f"line {i}: exemplar on a sample that is neither a "
                    f"histogram _bucket nor a counter _total: {line!r}")
            ex_err = _check_exemplar(exemplar)
            if ex_err is not None:
                errors.append(f"line {i}: {ex_err}: {line!r}")
        try:
            val = float(value)
        except ValueError:
            errors.append(f"line {i}: unparseable value {value!r}")
            val = None
        if kinds[family] == "histogram":
            series = _series_of(left)
            h = hist.setdefault(
                (family, series),
                {"buckets": [], "sum": None, "count": None})
            if hist_suffix is None:
                errors.append(
                    f"line {i}: histogram sample {name!r} must use a "
                    "_bucket/_sum/_count suffix")
            elif hist_suffix == "_bucket":
                m = left.split('le="', 1)
                if len(m) != 2 or '"' not in m[1]:
                    errors.append(f"line {i}: histogram bucket without "
                                  f"an le label: {line!r}")
                elif val is not None:
                    le_s = m[1].split('"', 1)[0]
                    le = (float("inf") if le_s == "+Inf"
                          else float(le_s))
                    h["buckets"].append((le, val))
            elif val is not None:
                h[hist_suffix[1:]] = val
        if left in seen:
            errors.append(f"line {i}: duplicate sample {left!r}")
        seen.add(left)
    for family, kind in kinds.items():
        if kind != "histogram":
            continue
        series_set = sorted(s for (f, s) in hist if f == family)
        if not series_set:
            errors.append(f"histogram {family!r} declared but has no "
                          "samples")
            continue
        for series in series_set:
            h = hist[(family, series)]
            label = family if not series else f"{family}{{{series}}}"
            buckets = h["buckets"]
            les = [le for le, _ in buckets]
            if les != sorted(les) or len(set(les)) != len(les):
                errors.append(f"histogram {label!r}: le labels not "
                              "strictly increasing")
            vals = [v for _, v in buckets]
            if vals != sorted(vals):
                errors.append(f"histogram {label!r}: cumulative bucket "
                              "counts decrease")
            if not les or les[-1] != float("inf"):
                errors.append(f"histogram {label!r}: missing mandatory "
                              "+Inf bucket")
            elif h["count"] is not None and h["count"] != vals[-1]:
                errors.append(
                    f"histogram {label!r}: _count {h['count']} != +Inf "
                    f"bucket {vals[-1]}")
            if h["count"] is None:
                errors.append(f"histogram {label!r}: missing _count")
            if h["sum"] is None:
                errors.append(f"histogram {label!r}: missing _sum")
    return errors


# -------------------------------------------------------- flight recorder


class FlightRecorder:
    """Bounded host-side ring of recent heartbeat summaries and
    supervisor events — the run's black box. Always on in the device
    tier (it is two deques of small dicts); every diagnostic bundle
    (stall 75, invariant 70, pressure 76, peer-lost 77) serializes
    `snapshot()` so the post-mortem ships its own recent history."""

    def __init__(self, capacity: int = 32):
        self.capacity = int(capacity)
        self._hb: collections.deque = collections.deque(
            maxlen=self.capacity)
        self._ev: collections.deque = collections.deque(
            maxlen=self.capacity)
        self._lock = threading.Lock()

    def record_heartbeat(self, sim_ns: int, summary: dict) -> None:
        entry = {"sim_seconds": round(int(sim_ns) / 1e9, 6)}
        for k, v in summary.items():
            if isinstance(v, (bool, str)) or v is None:
                entry[k] = v
            elif isinstance(v, (int, float)):
                entry[k] = v
            elif hasattr(v, "item"):  # numpy scalar from a fetch
                entry[k] = v.item()
            # nested dicts (profile) are dropped: the ring records the
            # trajectory, not the full observability payload
        with self._lock:
            self._hb.append(entry)

    def record_event(self, kind: str, **info) -> None:
        entry = {"kind": str(kind), "wall": round(time.time(), 3)}
        entry.update({k: v for k, v in info.items()
                      if isinstance(v, (bool, int, float, str))
                      or v is None})
        with self._lock:
            self._ev.append(entry)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "capacity": self.capacity,
                "heartbeats": list(self._hb),
                "events": list(self._ev),
            }


# ----------------------------------------------------------- health state


class HealthState:
    """The `/healthz` state machine. ok -> degraded on any recorded
    cause (watchdog near-miss, pressure event, retry relaunch);
    -> failed once an abnormal exit code is chosen. Degraded is sticky
    (a run that brushed its deadline stays flagged) and keeps HTTP 200
    so scrapers don't drop a still-progressing run; failed is 503."""

    OK, DEGRADED, FAILED = "ok", "degraded", "failed"
    # a pet that lands with less than this fraction of the deadline
    # left counts as a near-miss
    NEAR_MISS_FRAC = 0.25

    def __init__(self):
        self._lock = threading.Lock()
        self._state = self.OK
        self._causes: list[str] = []
        self.exit_code: int | None = None

    def degrade(self, cause: str) -> None:
        with self._lock:
            if self._state == self.OK:
                self._state = self.DEGRADED
            if cause not in self._causes:
                self._causes.append(cause)

    def observe_margin(self, margin_s: float, timeout_s: float) -> bool:
        """Record a watchdog margin reading; returns True when it was
        a near-miss (the caller logs it to the flight recorder)."""
        if timeout_s <= 0:
            return False
        if margin_s < self.NEAR_MISS_FRAC * timeout_s:
            self.degrade("watchdog-near-miss")
            return True
        return False

    def pressure_event(self) -> None:
        self.degrade("pressure")

    def relaunch(self, attempt: int) -> None:
        self.degrade(f"retry-relaunch-{int(attempt)}")

    def fail(self, exit_code: int) -> None:
        with self._lock:
            self._state = self.FAILED
            self.exit_code = int(exit_code)

    def code(self) -> int:
        """Numeric state for the shadow_tpu_health gauge."""
        with self._lock:
            return {self.OK: 0, self.DEGRADED: 1, self.FAILED: 2}[
                self._state]

    def snapshot(self) -> dict:
        with self._lock:
            return {"status": self._state,
                    "causes": list(self._causes),
                    "exit_code": self.exit_code}

    def http_status(self) -> int:
        with self._lock:
            return 503 if self._state == self.FAILED else 200
