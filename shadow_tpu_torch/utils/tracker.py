"""Per-host heartbeat tracker: node and socket CSV lines per interval.
The counterpart of `shadow_tpu.utils.tracker`; every header and row is
the reference's, letter for letter.

The reference's Tracker emits `[shadow-heartbeat] [node|socket|ram]` CSV
at a configurable interval, splitting bytes into payload/header classes
with retransmission counts (reference: src/main/host/tracker.c:433-561).
Here the equivalents are interval deltas of device-side accumulators:
socket tables carry payload bytes, the NICs carry wire packet/byte
counters (header bytes = wire - payload), the TCBs carry retransmitted
segment counts, and the engine's stats carry executed-event counts.

`gather` reduces on the device and returns tensors; the heartbeat
harvest (`runtime/harvest.py`) copies them with the rest of its bundle
in one copy and hands the numpy result to `heartbeat_from`.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from shadow_tpu_torch.core.timebase import TIME_INVALID

NODE_HEADER = (
    "[shadow-heartbeat] [node-header] time-seconds,name,"
    "recv-bytes,send-bytes,recv-wire-bytes,send-wire-bytes,"
    "recv-packets,send-packets,recv-header-bytes,send-header-bytes,"
    "retrans-segments,events-executed,queue-drops,tail-drops"
)
SOCKET_HEADER = (
    "[shadow-heartbeat] [socket-header] time-seconds,name,slot,"
    "protocol,local-port,peer-host,peer-port,recv-bytes,send-bytes,"
    "retrans-segments"
)
# the reference's [ram] line tracks per-host allocation; the device-array
# analog is occupancy of the host's fixed-capacity state rows
RAM_HEADER = (
    "[shadow-heartbeat] [ram-header] time-seconds,name,"
    "queue-slots-used,queue-capacity,sockets-used,sockets-capacity,"
    "state-bytes"
)
# fault attribution (only emitted when the run has a fault schedule):
# packets lost to fault overlays, events voided by crashes, and seconds
# of scheduled downtime — so runs report what the chaos did
FAULT_HEADER = (
    "[shadow-heartbeat] [fault-header] time-seconds,name,"
    "fault-drops,quarantined-events,downtime-seconds"
)
# supervised-run progress (one line per heartbeat, whole-run not
# per-host): wall-clock window/event rates, how close the run came to
# the watchdog deadline since the last beat, and checkpoints written —
# the operator-facing "is this campaign healthy" row
SUPERVISOR_HEADER = (
    "[shadow-heartbeat] [supervisor-header] time-seconds,"
    "windows,windows-per-sec,events-per-sec,"
    "stall-margin-seconds,checkpoints-written"
)
# exact per-host record counts from the device trace drain (only with
# --trace): unlike the [node] section's interval-sampled counter deltas,
# these come straight from the per-event trace records, so drop and
# retransmit attribution is exact down to the event
TRACE_HEADER = (
    "[shadow-heartbeat] [trace-header] time-seconds,name,"
    "exec-records,send-records,net-drop-records,fault-drop-records,"
    "lost-records"
)
# queue-pressure telemetry (only with --overflow spill/grow): one
# aggregate row per interval — how many hosts hit the spill path, the
# peak queue fill, interval spill/refill counts, events lost to ring
# overflow (0 unless the ring is undersized), events resident in the
# host reservoir, and harvest wall time (stripped from determinism
# diffs by tools/strip_log.py like every wall-clock column)
PRESSURE_HEADER = (
    "[shadow-heartbeat] [pressure-header] time-seconds,"
    "hosts-pressured,fill-hwm,spilled,refilled,spill-lost,"
    "reservoir-resident,overdue,harvest-seconds"
)
# scenario-fleet progress (only with --fleet, which waits for the
# fleets; kept letter for letter): one row per LANE per
# heartbeat, from the harvest bundle's [L]-valued summary reductions —
# per-lane sim clock, window/event totals, the interval's event delta,
# queue drops, and queue fill. Lanes that finished early keep emitting
# rows with a frozen clock (their windows are masked no-ops), which is
# exactly the signal a sweep operator reads lane skew from
FLEET_HEADER = (
    "[shadow-heartbeat] [fleet-header] time-seconds,lane,seed,"
    "now-seconds,windows,events,events-delta,queue-drops,fill"
)


@dataclasses.dataclass
class Snapshot:
    """Host-side copy of the cumulative counters a heartbeat diffs."""

    rx: np.ndarray  # [H] payload bytes
    tx: np.ndarray
    rx_wire: np.ndarray  # [H] wire bytes through the rx NIC
    tx_wire: np.ndarray
    rx_pkts: np.ndarray
    tx_pkts: np.ndarray
    retx: np.ndarray  # [H] retransmitted segments
    events: np.ndarray  # [H]
    drops: np.ndarray  # [H]
    tail_drops: np.ndarray  # [H] NIC receive-buffer drop-tail losses
    fault_drops: np.ndarray  # [H] packets lost to fault overlays
    quarantined: np.ndarray  # [H] events voided by host crashes

    @staticmethod
    def zero(n: int) -> "Snapshot":
        z = lambda: np.zeros((n,), np.int64)
        return Snapshot(z(), z(), z(), z(), z(), z(), z(), z(), z(), z(),
                        z(), z())


def snapshot_refs(st) -> dict:
    """Device tensors (reductions applied, nothing copied) for one
    Snapshot: the gather half of `snapshot`. The heartbeat harvest
    carries this dict in its one copy."""
    net = st.hosts.net
    socks = net.sockets
    retx = (
        net.tcb.n_retx.sum(dim=1)
        if net.tcb is not None
        else torch.zeros((socks.rx_bytes.shape[0],), dtype=torch.int64,
                         device=socks.rx_bytes.device)
    )
    return {
        "rx": socks.rx_bytes.sum(dim=1),
        "tx": socks.tx_bytes.sum(dim=1),
        "rx_wire": net.nic_rx.wire,
        "tx_wire": net.nic_tx.wire,
        "rx_pkts": net.nic_rx.pkts,
        "tx_pkts": net.nic_tx.pkts,
        "retx": retx,
        "events": st.stats.n_executed,
        "drops": st.queues.drops,
        "tail_drops": net.nic_rx.drops,
        "fault_drops": st.stats.n_fault_dropped,
        "quarantined": st.stats.n_quarantined,
    }


def snapshot_from(fetched: dict) -> Snapshot:
    """Build a Snapshot from a fetched (numpy) `snapshot_refs` dict."""
    a = {k: np.asarray(v) for k, v in fetched.items()}
    a["drops"] = a["drops"].astype(np.int64)
    return Snapshot(**a)


def snapshot(st) -> Snapshot:
    """Pull the cumulative counters from an EngineState (one copy)."""
    from shadow_tpu_torch.runtime.harvest import fetch_tree

    return snapshot_from(fetch_tree(snapshot_refs(st)))


class SupervisorHeartbeat:
    """Whole-run supervision heartbeat: windows/sec, events/sec, the
    minimum watchdog stall margin observed since the last beat, and the
    checkpoints-written count.

    The per-host sections above answer "what did the simulated network
    do"; this row answers "is the *run loop* healthy" — the quantity a
    long campaign's operator watches. `observe_margin` is called every
    window boundary (cheap: two float compares); `beat` once per
    heartbeat interval emits the CSV line through the same simtime-
    sorted logger as the other sections.
    """

    def __init__(self, logger: Any, watchdog: Any = None):
        import time

        self.logger = logger
        self.watchdog = watchdog  # runtime.Watchdog or None
        self.checkpoints_written = 0
        self._clock = time.monotonic
        self._last_wall = self._clock()
        self._last_windows = 0
        self._last_events = 0
        self._min_margin: float | None = None
        self._emitted_header = False

    def checkpoint_written(self) -> None:
        self.checkpoints_written += 1

    def observe_margin(self) -> None:
        """Record the watchdog's remaining deadline at a window
        boundary; the beat reports the interval's minimum (the closest
        the run came to being declared stalled)."""
        if self.watchdog is None:
            return
        m = self.watchdog.margin_s()
        if self._min_margin is None or m < self._min_margin:
            self._min_margin = m

    def beat(self, sim_ns: int, summary: dict) -> None:
        """Emit one supervisor line. `summary` is engine.state_summary
        output (windows/executed are cumulative; rates are interval
        deltas over wall time)."""
        if not self._emitted_header:
            self.logger.log(sim_ns, "tracker", "message", SUPERVISOR_HEADER)
            self._emitted_header = True
        wall = self._clock()
        dt = max(wall - self._last_wall, 1e-9)
        windows = int(summary.get("windows", 0))
        events = int(summary.get("executed", 0))
        w_rate = (windows - self._last_windows) / dt
        e_rate = (events - self._last_events) / dt
        margin = (
            "" if self._min_margin is None else f"{self._min_margin:.1f}"
        )
        self.logger.log(
            sim_ns, "supervisor", "message",
            "[shadow-heartbeat] [supervisor] "
            f"{sim_ns // 1_000_000_000},{windows},{w_rate:.1f},"
            f"{e_rate:.1f},{margin},{self.checkpoints_written}",
        )
        self._last_wall = wall
        self._last_windows = windows
        self._last_events = events
        self._min_margin = None


class Tracker:
    """Stateful heartbeat emitter: call heartbeat() once per interval.

    `info_of`/`level_of` hold per-host overrides of which sections a host
    logs (node/socket — the heartbeatloginfo attr) and at which level
    (the heartbeatloglevel attr; default "message") — per host like the
    reference, not globally (tracker.c:433-561).
    """

    def __init__(self, names: list[str], logger: Any,
                 log_info: tuple[str, ...] = ("node",),
                 info_of: dict[str, tuple[str, ...]] | None = None,
                 level_of: dict[str, str] | None = None,
                 faults: Any = None, trace: Any = None,
                 pressure: Any = None, metrics: Any = None):
        self.names = names
        self.logger = logger
        self.log_info = log_info
        self.info_of = info_of or {}
        self.level_of = level_of or {}
        self.faults = faults  # CompiledFaults -> emit the [fault] section
        self.trace = trace  # obs.TraceDrain -> emit the [trace] section
        # runtime.pressure.PressureController -> emit the [pressure]
        # section (cumulative snapshots diffed per interval, like prev)
        self.pressure = pressure
        # obs.metrics.MetricsRegistry -> emit the [metrics] section: the
        # exporter's *cumulative* totals (not interval deltas), so a
        # live /metrics scrape, this row, and the end-of-run summary are
        # directly comparable. The CLI loop ingests the fetched bundle
        # into the registry before consume() runs this heartbeat, so
        # the row and the [node] section describe the same extraction.
        self.metrics = metrics
        self._prev_pressure: dict | None = None
        # --stats: the harvest hands the fetched histogram bundle to
        # stats_from separately (it lives at the bundle top level, next
        # to the [metrics] reductions, not inside the tracker gather)
        self._emitted_stats_header = False
        self._stats_prev_ns: int | None = None
        self.prev = Snapshot.zero(len(names))
        # None until the first heartbeat lands; afterwards the guard in
        # heartbeat() drops zero-length (or backwards) intervals so a
        # caller that fires two beats at the same sim time can't emit
        # all-zero delta rows or divide the interval math by nothing
        self._prev_ns: int | None = None
        self._emitted_headers = False
        # (queue capacity, socket capacity, per-host state bytes) — pure
        # shape math captured by gather() so heartbeat_from is state-free
        self._ram_static: tuple[int, int, int] | None = None

    def _info(self, name: str) -> tuple[str, ...]:
        return self.info_of.get(name, self.log_info)

    def _level(self, name: str) -> str:
        return self.level_of.get(name, "message")

    def gather(self, st) -> dict:
        """Device tensors for everything one heartbeat consumes: node
        counters, and the socket/ram/pressure sections when any host
        enables them. Per-host reductions happen on the device; the
        caller copies the whole dict at once (the heartbeat harvest's
        bundle) and hands the numpy result to `heartbeat_from`."""
        from shadow_tpu_torch.convert import state_tensors

        refs: dict[str, Any] = {"snap": snapshot_refs(st)}
        if any("socket" in self._info(n) for n in self.names):
            net = st.hosts.net
            socks = net.sockets
            refs["socket"] = {
                "proto": socks.proto, "lport": socks.local_port,
                "phost": socks.peer_host, "pport": socks.peer_port,
                "rx": socks.rx_bytes, "tx": socks.tx_bytes,
                "retx": (net.tcb.n_retx if net.tcb is not None
                         else torch.zeros_like(socks.proto)),
            }
        if any("ram" in self._info(n) for n in self.names):
            refs["ram"] = {
                "q_used": torch.sum(st.queues.time != TIME_INVALID, dim=1,
                                    dtype=torch.int32),
                "s_used": torch.sum(st.hosts.net.sockets.proto != 0, dim=1,
                                    dtype=torch.int32),
            }
            # static shape math, not a copy: kept so that heartbeat_from
            # never needs the state
            self._ram_static = (
                int(st.queues.time.shape[1]),
                int(st.hosts.net.sockets.proto.shape[1]),
                sum(t.numel() * t.element_size()
                    for _, t, _ in state_tensors(st))
                // max(len(self.names), 1),
            )
        if self.pressure is not None and (
            getattr(st.queues, "spill", None) is not None
        ):
            refs["pressure"] = self.pressure.gather(st)
        return refs

    def heartbeat(self, st, sim_ns: int) -> None:
        """Gather + copy + emit in one call (one copy). The CLI's loop
        instead puts `gather` in its harvest bundle and calls
        `heartbeat_from` on the copied result."""
        from shadow_tpu_torch.runtime.harvest import fetch_tree

        if self._prev_ns is not None and sim_ns <= self._prev_ns:
            return  # zero-length interval: nothing can have accumulated
        self.heartbeat_from(fetch_tree(self.gather(st)), sim_ns)

    def heartbeat_from(self, fetched: dict, sim_ns: int) -> None:
        """Emit one heartbeat from a fetched (numpy) `gather` dict: pure
        host-side work."""
        if self._prev_ns is not None and sim_ns <= self._prev_ns:
            return  # zero-length interval: nothing can have accumulated
        cur = snapshot_from(fetched["snap"])
        any_socket = any("socket" in self._info(n) for n in self.names)
        if not self._emitted_headers:
            self.logger.log(sim_ns, "tracker", "message", NODE_HEADER)
            if any_socket:
                self.logger.log(sim_ns, "tracker", "message", SOCKET_HEADER)
            if any("ram" in self._info(n) for n in self.names):
                self.logger.log(sim_ns, "tracker", "message", RAM_HEADER)
            if self.faults is not None:
                self.logger.log(sim_ns, "tracker", "message", FAULT_HEADER)
            if self.trace is not None:
                self.logger.log(sim_ns, "tracker", "message", TRACE_HEADER)
            if self.pressure is not None:
                self.logger.log(sim_ns, "tracker", "message",
                                PRESSURE_HEADER)
            if self.metrics is not None:
                from shadow_tpu_torch.obs.metrics import METRICS_HEADER

                self.logger.log(sim_ns, "tracker", "message",
                                METRICS_HEADER)
            self._emitted_headers = True
        t_s = sim_ns // 1_000_000_000
        p = self.prev
        # a crash-restart re-templates the host's state, rewinding its
        # socket/NIC accumulators — a negative interval delta just means
        # "rebooted", so clamp to 0 (the lost remainder is attributed in
        # the [fault] section instead)
        d = lambda a, b: max(int(a) - int(b), 0)
        for i, name in enumerate(self.names):
            if "node" not in self._info(name):
                continue
            rx, tx = d(cur.rx[i], p.rx[i]), d(cur.tx[i], p.tx[i])
            rxw, txw = (
                d(cur.rx_wire[i], p.rx_wire[i]),
                d(cur.tx_wire[i], p.tx_wire[i]),
            )
            self.logger.log(
                sim_ns, name, self._level(name),
                "[shadow-heartbeat] [node] "
                f"{t_s},{name},{rx},{tx},{rxw},{txw},"
                f"{d(cur.rx_pkts[i], p.rx_pkts[i])},"
                f"{d(cur.tx_pkts[i], p.tx_pkts[i])},"
                f"{max(rxw - rx, 0)},{max(txw - tx, 0)},"
                f"{d(cur.retx[i], p.retx[i])},"
                f"{cur.events[i] - p.events[i]},"
                f"{d(cur.drops[i], p.drops[i])},"
                f"{d(cur.tail_drops[i], p.tail_drops[i])}",
            )
        if any_socket and "socket" in fetched:
            self._socket_lines(fetched["socket"], sim_ns, t_s)
        if "ram" in fetched:
            self._ram_lines(fetched["ram"], sim_ns, t_s)
        if self.faults is not None:
            self._fault_lines(cur, sim_ns, t_s)
        if self.trace is not None:
            self._trace_lines(sim_ns, t_s)
        if self.pressure is not None and "pressure" in fetched:
            self._pressure_line(fetched["pressure"], sim_ns, t_s)
        if self.metrics is not None:
            self.logger.log(
                sim_ns, "tracker", "message",
                "[shadow-heartbeat] [metrics] "
                + self.metrics.metrics_row(t_s),
            )
        self.prev = cur
        self._prev_ns = sim_ns

    def stats_from(self, stats_fetched: dict, sim_ns: int) -> None:
        """Emit one `[stats]` row from a fetched --stats histogram
        bundle (obs.stats.stats_device_refs, copied): per
        family the cumulative count, value sum, p50/p95, and the sparse
        bucket spec — enough for parse_shadow/plot_shadow to rebuild
        the full distributions from the log alone. Cumulative like the
        [metrics] row, so the last row reconciles with the end-of-run
        summary."""
        if self._stats_prev_ns is not None and \
                sim_ns <= self._stats_prev_ns:
            return
        from shadow_tpu_torch.obs.stats import (
            STATS_HEADER,
            stats_row,
            summarize,
        )

        if not self._emitted_stats_header:
            self.logger.log(
                sim_ns, "tracker", "message",
                "[shadow-heartbeat] [stats-header] " + STATS_HEADER)
            self._emitted_stats_header = True
        t_s = sim_ns // 1_000_000_000
        self.logger.log(
            sim_ns, "tracker", "message",
            "[shadow-heartbeat] [stats] "
            + stats_row(t_s, summarize(stats_fetched)),
        )
        self._stats_prev_ns = sim_ns

    def _pressure_line(self, fetched: dict, sim_ns: int, t_s: int) -> None:
        """One aggregate queue-pressure row per interval (like the
        [supervisor] section: whole-run, not per-host — pressure is a
        capacity-sizing signal, and the per-host detail lives in the
        trace ops and the validator). Counters are cumulative on the
        controller/ring; this diffs them against the previous beat."""
        cur = self.pressure.snapshot_from(fetched)
        n_spilled = np.asarray(fetched["n_spilled"])
        prev = self._prev_pressure or {}
        prev_sp = prev.get("per_host_spilled")
        d_sp = n_spilled - (prev_sp if prev_sp is not None else 0)
        hosts_pressured = int((d_sp > 0).sum())
        dd = lambda k: int(cur.get(k, 0)) - int(prev.get(k, 0))
        self.logger.log(
            sim_ns, "tracker", "message",
            "[shadow-heartbeat] [pressure] "
            f"{t_s},{hosts_pressured},{cur['fill_hwm']},"
            f"{dd('spilled')},{dd('refilled')},{dd('spill_lost')},"
            f"{cur['resident']},{dd('overdue')},"
            f"{cur['harvest_seconds'] - prev.get('harvest_seconds', 0.0):.3f}",
        )
        cur["per_host_spilled"] = n_spilled
        self._prev_pressure = cur

    def _trace_lines(self, sim_ns: int, t_s: int) -> None:
        """Exact per-host record counts from the device trace drain.
        Skips all-zero rows like the [fault] section; the drain must be
        harvested (TraceDrain.drain_state) before the heartbeat or the
        interval is empty and nothing is emitted."""
        iv = self.trace.take_interval()
        if iv is None:
            return
        g = lambda a, i: int(a[i]) if i < len(a) else 0
        for i, name in enumerate(self.names):
            if "node" not in self._info(name):
                continue
            ex = g(iv["exec"], i)
            snd = g(iv["send"], i)
            drp = g(iv["drop"], i)
            fdrp = g(iv["fault_drop"], i)
            lost = g(iv["lost"], i)
            if ex == 0 and snd == 0 and drp == 0 and fdrp == 0 and lost == 0:
                continue
            self.logger.log(
                sim_ns, name, self._level(name),
                "[shadow-heartbeat] [trace] "
                f"{t_s},{name},{ex},{snd},{drp},{fdrp},{lost}",
            )

    def _fault_lines(self, cur: Snapshot, sim_ns: int, t_s: int) -> None:
        p = self.prev
        downtime = self.faults.downtime_in(self._prev_ns or 0, sim_ns)
        for i, name in enumerate(self.names):
            if "node" not in self._info(name):
                continue
            fd = cur.fault_drops[i] - p.fault_drops[i]
            qr = cur.quarantined[i] - p.quarantined[i]
            dt = downtime[i] if i < len(downtime) else 0.0
            if fd == 0 and qr == 0 and dt == 0.0:
                continue
            self.logger.log(
                sim_ns, name, self._level(name),
                "[shadow-heartbeat] [fault] "
                f"{t_s},{name},{fd},{qr},{dt:.3f}",
            )

    def _ram_lines(self, fetched: dict, sim_ns: int, t_s: int) -> None:
        """Per-host state occupancy (the reference's [ram] allocation
        heartbeat, tracker.c ram section, reinterpreted for fixed-width
        device arrays: used slots vs capacity plus the per-host share of
        the resident state bytes). Occupancy reduces on device in
        `gather`; the static capacities/bytes ride `_ram_static`."""
        used = np.asarray(fetched["q_used"])
        s_used = np.asarray(fetched["s_used"])
        cap, s_cap, state_bytes = self._ram_static
        for i, name in enumerate(self.names):
            if "ram" not in self._info(name):
                continue
            self.logger.log(
                sim_ns, name, self._level(name),
                "[shadow-heartbeat] [ram] "
                f"{t_s},{name},{used[i]},{cap},{s_used[i]},{s_cap},"
                f"{state_bytes}",
            )

    def _socket_lines(self, fetched: dict, sim_ns: int, t_s: int) -> None:
        proto = np.asarray(fetched["proto"])
        lport = np.asarray(fetched["lport"])
        phost = np.asarray(fetched["phost"])
        pport = np.asarray(fetched["pport"])
        rx = np.asarray(fetched["rx"])
        tx = np.asarray(fetched["tx"])
        retx = np.asarray(fetched["retx"])
        pname = {0: "NONE", 1: "UDP", 2: "TCP"}
        for i, name in enumerate(self.names):
            if "socket" not in self._info(name):
                continue
            for s in range(proto.shape[1]):
                if proto[i, s] == 0:
                    continue
                self.logger.log(
                    sim_ns, name, self._level(name),
                    "[shadow-heartbeat] [socket] "
                    f"{t_s},{name},{s},{pname.get(int(proto[i, s]), '?')},"
                    f"{lport[i, s]},{phost[i, s]},{pport[i, s]},"
                    f"{rx[i, s]},{tx[i, s]},{retx[i, s]}",
                )
