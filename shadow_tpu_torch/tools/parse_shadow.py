"""parse_shadow: heartbeat log -> stats.shadow.json.

The reference's parse-shadow.py greps `[shadow-heartbeat]` lines out of
(possibly xz-compressed) simulator logs and writes a per-node JSON time
series consumed by plot-shadow.py (reference: src/tools/parse-shadow.py:
9-40, stats.shadow.json). This tool does the same for shadow_tpu's
heartbeat format (utils/tracker.py): per node, per interval, the
payload/wire/header byte classes, packet counts, retransmissions, events
and drops — plus a run-level ticks series.

Usage:
    python -m shadow_tpu_torch.tools.parse_shadow shadow.log [-o DIR]
    ... | python -m shadow_tpu_torch.tools.parse_shadow -
"""

from __future__ import annotations

import argparse
import json
import lzma
import os
import sys

NODE_FIELDS = (
    "bytes_payload_recv", "bytes_payload_send",
    "bytes_wire_recv", "bytes_wire_send",
    "packets_recv", "packets_send",
    "bytes_header_recv", "bytes_header_send",
    "retrans_segments", "events_executed", "queue_drops", "tail_drops",
)


RAM_FIELDS = (
    "queue_slots_used", "queue_capacity", "sockets_used",
    "sockets_capacity", "state_bytes",
)

# the [fault] section only appears when the run had a fault schedule;
# downtime is fractional seconds, everything else integer counts
FAULT_FIELDS = ("fault_drops", "quarantined_events", "downtime_seconds")

# whole-run [supervisor] rows: wall rates + watchdog margin (the margin
# column may be empty when no watchdog was armed)
SUPERVISOR_FIELDS = (
    "windows", "windows_per_sec", "events_per_sec",
    "stall_margin_seconds", "checkpoints_written",
)

# exact per-host record counts from the --trace drain
TRACE_FIELDS = (
    "exec_records", "send_records", "net_drop_records",
    "fault_drop_records", "lost_records",
)

# whole-run [pressure] rows (only with --overflow spill/grow): one
# aggregate interval row — harvest_seconds is wall clock, the rest are
# event counts / the high-water queue fill
PRESSURE_FIELDS = (
    "hosts_pressured", "fill_hwm", "spilled", "refilled",
    "spill_lost", "reservoir_resident", "overdue", "harvest_seconds",
)

# per-LANE [fleet] rows (only with --fleet): one row per lane per
# heartbeat, keyed by lane index. `seed` is constant per lane, `fill`
# is the lane's mean queue occupancy in [0, 1]; the rest are the lane's
# cumulative solo-equivalent summary counters plus the interval delta
FLEET_FIELDS = ("seed", "now_seconds", "windows", "events",
                "events_delta", "queue_drops", "fill")

# whole-run [metrics] rows (only with --metrics): the telemetry
# registry's CUMULATIVE totals — unlike the interval-delta sections
# above, these columns match a live /metrics scrape and the end-of-run
# summary directly (queue_fill is the 0..1 occupancy gauge)
METRICS_FIELDS = (
    "events", "queue_drops", "net_dropped", "fault_dropped",
    "cross_shard_packets", "rx_bytes", "tx_bytes", "queue_fill",
    "heartbeats",
)

# whole-run [stats] rows (only with --stats): per histogram family the
# CUMULATIVE sample count, value sum, p50/p95, and the sparse bucket
# spec ("idx:count|..."), decoded here into {bucket-index: count} so
# plot_shadow can rebuild the full log2 distributions from the log
# alone. Column names come from the [stats-header] row when present
# (forward-compatible with new families); this is the current default.
STATS_FAMILIES = ("wait", "net", "occ", "qfill", "runlen")
STATS_COLS = tuple(
    f"{k}_{c}" for k in STATS_FAMILIES
    for c in ("count", "sum", "p50", "p95", "hist")
)


def _sort_series(series: dict, key: str = "ticks") -> None:
    """Stable-sort one tick-keyed column store in place. Heartbeat
    sections are buffered independently (and a resumed or sharded run
    may flush them interleaved), so consumers must not assume block
    contiguity — normalize to tick order here, preserving emission
    order within a tick."""
    ticks = series.get(key)
    if not ticks or all(a <= b for a, b in zip(ticks, ticks[1:])):
        return
    order = sorted(range(len(ticks)), key=ticks.__getitem__)
    for k, col in series.items():
        if isinstance(col, list) and len(col) == len(ticks):
            series[k] = [col[i] for i in order]


def parse_lines(lines) -> dict:
    nodes: dict[str, dict] = {}
    sockets: dict[str, list] = {}
    ram: dict[str, dict] = {}
    faults: dict[str, dict] = {}
    trace: dict[str, dict] = {}
    fleet: dict[str, dict] = {}
    supervisor: dict[str, list] = {
        "ticks": [], **{f: [] for f in SUPERVISOR_FIELDS}
    }
    pressure: dict[str, list] = {
        "ticks": [], **{f: [] for f in PRESSURE_FIELDS}
    }
    metrics: dict[str, list] = {
        "ticks": [], **{f: [] for f in METRICS_FIELDS}
    }
    stats: dict[str, list] = {
        "ticks": [], **{f: [] for f in STATS_COLS}
    }
    stats_cols: tuple[str, ...] = STATS_COLS
    for line in lines:
        if "[shadow-heartbeat] [node] " in line:
            csv = line.rsplit("[shadow-heartbeat] [node] ", 1)[1].strip()
            parts = csv.split(",")
            if len(parts) != 2 + len(NODE_FIELDS):
                continue
            t_s, name = int(parts[0]), parts[1]
            node = nodes.setdefault(
                name,
                {"ticks": [], **{f: [] for f in NODE_FIELDS}},
            )
            node["ticks"].append(t_s)
            for f, v in zip(NODE_FIELDS, parts[2:]):
                node[f].append(int(v))
        elif "[shadow-heartbeat] [socket] " in line:
            csv = line.rsplit("[shadow-heartbeat] [socket] ", 1)[1].strip()
            parts = csv.split(",")
            if len(parts) != 10:
                continue
            sockets.setdefault(parts[1], []).append(
                {
                    "time": int(parts[0]),
                    "slot": int(parts[2]),
                    "protocol": parts[3],
                    "local_port": int(parts[4]),
                    "peer_host": int(parts[5]),
                    "peer_port": int(parts[6]),
                    "recv_bytes": int(parts[7]),
                    "send_bytes": int(parts[8]),
                    "retrans_segments": int(parts[9]),
                }
            )
        elif "[shadow-heartbeat] [ram] " in line:
            csv = line.rsplit("[shadow-heartbeat] [ram] ", 1)[1].strip()
            parts = csv.split(",")
            if len(parts) != 2 + len(RAM_FIELDS):
                continue
            node = ram.setdefault(
                parts[1], {"ticks": [], **{f: [] for f in RAM_FIELDS}}
            )
            node["ticks"].append(int(parts[0]))
            for f, v in zip(RAM_FIELDS, parts[2:]):
                node[f].append(int(v))
        elif "[shadow-heartbeat] [fault] " in line:
            csv = line.rsplit("[shadow-heartbeat] [fault] ", 1)[1].strip()
            parts = csv.split(",")
            if len(parts) != 2 + len(FAULT_FIELDS):
                continue
            node = faults.setdefault(
                parts[1], {"ticks": [], **{f: [] for f in FAULT_FIELDS}}
            )
            node["ticks"].append(int(parts[0]))
            node["fault_drops"].append(int(parts[2]))
            node["quarantined_events"].append(int(parts[3]))
            node["downtime_seconds"].append(float(parts[4]))
        elif "[shadow-heartbeat] [trace] " in line:
            csv = line.rsplit("[shadow-heartbeat] [trace] ", 1)[1].strip()
            parts = csv.split(",")
            if len(parts) != 2 + len(TRACE_FIELDS):
                continue
            node = trace.setdefault(
                parts[1], {"ticks": [], **{f: [] for f in TRACE_FIELDS}}
            )
            node["ticks"].append(int(parts[0]))
            for f, v in zip(TRACE_FIELDS, parts[2:]):
                node[f].append(int(v))
        elif "[shadow-heartbeat] [pressure] " in line:
            csv = line.rsplit("[shadow-heartbeat] [pressure] ", 1)[1].strip()
            parts = csv.split(",")
            if len(parts) != 1 + len(PRESSURE_FIELDS):
                continue
            pressure["ticks"].append(int(parts[0]))
            for f, v in zip(PRESSURE_FIELDS[:-1], parts[1:-1]):
                pressure[f].append(int(v))
            # harvest_seconds is wall clock; strip_log may blank it
            pressure["harvest_seconds"].append(
                float(parts[-1]) if parts[-1] else None
            )
        elif "[shadow-heartbeat] [fleet] " in line:
            csv = line.rsplit("[shadow-heartbeat] [fleet] ", 1)[1].strip()
            parts = csv.split(",")
            if len(parts) != 2 + len(FLEET_FIELDS):
                continue
            lane = fleet.setdefault(
                parts[1], {"ticks": [], **{f: [] for f in FLEET_FIELDS}}
            )
            lane["ticks"].append(int(parts[0]))
            for f, v in zip(FLEET_FIELDS, parts[2:]):
                lane[f].append(float(v) if f == "fill" else int(v))
        elif "[shadow-heartbeat] [supervisor] " in line:
            csv = line.rsplit(
                "[shadow-heartbeat] [supervisor] ", 1
            )[1].strip()
            parts = csv.split(",")
            if len(parts) != 1 + len(SUPERVISOR_FIELDS):
                continue
            supervisor["ticks"].append(int(parts[0]))
            supervisor["windows"].append(int(parts[1]))
            supervisor["windows_per_sec"].append(float(parts[2]))
            supervisor["events_per_sec"].append(float(parts[3]))
            supervisor["stall_margin_seconds"].append(
                float(parts[4]) if parts[4] else None
            )
            supervisor["checkpoints_written"].append(int(parts[5]))
        elif "[shadow-heartbeat] [metrics] " in line:
            csv = line.rsplit("[shadow-heartbeat] [metrics] ", 1)[1].strip()
            parts = csv.split(",")
            if len(parts) != 1 + len(METRICS_FIELDS):
                continue
            metrics["ticks"].append(int(parts[0]))
            for f, v in zip(METRICS_FIELDS, parts[1:]):
                metrics[f].append(
                    float(v) if f == "queue_fill" else int(v)
                )
        elif "[shadow-heartbeat] [stats-header] " in line:
            csv = line.rsplit(
                "[shadow-heartbeat] [stats-header] ", 1
            )[1].strip()
            cols = tuple(csv.split(",")[1:])  # drop the t_s column
            if cols and cols != stats_cols:
                stats_cols = cols
                for f in cols:
                    stats.setdefault(f, [])
        elif "[shadow-heartbeat] [stats] " in line:
            csv = line.rsplit("[shadow-heartbeat] [stats] ", 1)[1].strip()
            parts = csv.split(",")
            if len(parts) != 1 + len(stats_cols):
                continue
            stats["ticks"].append(float(parts[0]))
            for f, v in zip(stats_cols, parts[1:]):
                if f.endswith("_hist"):
                    stats[f].append({
                        p.split(":", 1)[0]: int(p.split(":", 1)[1])
                        for p in v.split("|") if p
                    })
                else:
                    stats[f].append(float(v) if "." in v else int(v))
    # tolerate interleaved optional sections: logs from resumed/sharded
    # runs (or concatenated shards) need not keep each section's rows
    # contiguous or tick-ordered
    for series in (supervisor, pressure, metrics, stats):
        _sort_series(series)
    for per_name in (nodes, ram, faults, trace, fleet):
        for series in per_name.values():
            _sort_series(series)
    for rows in sockets.values():
        rows.sort(key=lambda r: r["time"])
    return {"nodes": nodes, "sockets": sockets, "ram": ram,
            "faults": faults, "trace": trace, "fleet": fleet,
            "supervisor": supervisor, "pressure": pressure,
            "metrics": metrics, "stats": stats}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("logpath", help="log file, .xz allowed, or - for stdin")
    ap.add_argument("-o", "--output-dir", default=".",
                    help="directory for stats.shadow_tpu.json")
    args = ap.parse_args(argv)

    if args.logpath == "-":
        stats = parse_lines(sys.stdin)
    elif args.logpath.endswith(".xz"):
        with lzma.open(args.logpath, "rt") as f:
            stats = parse_lines(f)
    else:
        with open(args.logpath) as f:
            stats = parse_lines(f)

    out = os.path.join(args.output_dir, "stats.shadow_tpu.json")
    with open(out, "w") as f:
        json.dump(stats, f)
    print(out)
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
