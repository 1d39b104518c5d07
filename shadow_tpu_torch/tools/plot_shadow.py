"""plot_shadow: stats.shadow_tpu.json -> summary plots.

The reference's plot-shadow.py (src/tools/plot-shadow.py, 1252 lines of
matplotlib) renders per-node time series and distributions from
parse-shadow output. This is its lean shadow_tpu counterpart: one PNG per
figure — aggregate throughput (wire bytes/s in and out), per-node
cumulative goodput, packet and retransmission rates, and event-execution
rates — from the JSON emitted by shadow_tpu_torch.tools.parse_shadow.

Usage:
    python -m shadow_tpu_torch.tools.plot_shadow stats.shadow_tpu.json [-o DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _series(node: dict, field: str) -> tuple[list, list]:
    """(ticks, per-interval values) — heartbeat fields are interval
    deltas already (utils/tracker.py emits per-interval counts)."""
    return node.get("ticks", []), node.get(field, [])


def make_figures(stats: dict, outdir: str, fmt: str = "png") -> list[str]:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    nodes = stats.get("nodes", {})
    written: list[str] = []

    def save(fig, name):
        path = os.path.join(outdir, f"{name}.{fmt}")
        fig.tight_layout()
        fig.savefig(path, dpi=120)
        plt.close(fig)
        written.append(path)

    # 1. aggregate wire throughput
    fig, ax = plt.subplots(figsize=(8, 4.5))
    agg: dict[int, list[float]] = {}
    for direction, field in (("recv", "bytes_wire_recv"),
                             ("send", "bytes_wire_send")):
        totals: dict[int, int] = {}
        interval = None
        for node in nodes.values():
            ticks, deltas = _series(node, field)
            if len(ticks) > 1 and interval is None:
                interval = ticks[1] - ticks[0]
            for t, d in zip(ticks, deltas):
                totals[t] = totals.get(t, 0) + d
        if totals:
            xs = sorted(totals)
            iv = max(interval or 1, 1)
            ax.plot(xs, [totals[x] / iv / 1024 for x in xs],
                    label=f"wire {direction}")
    ax.set_xlabel("sim time (s)")
    ax.set_ylabel("KiB/s")
    ax.set_title("aggregate wire throughput")
    ax.legend()
    save(fig, "shadow_tpu.throughput")

    # 2. per-node cumulative payload received (top 20 by total)
    fig, ax = plt.subplots(figsize=(8, 4.5))
    ranked = sorted(
        nodes.items(),
        key=lambda kv: sum(kv[1].get("bytes_payload_recv") or [0]),
        reverse=True,
    )[:20]
    for name, node in ranked:
        ticks = node.get("ticks", [])
        vals = node.get("bytes_payload_recv", [])
        cum, run = [], 0
        for v in vals:
            run += v
            cum.append(run / 1024)
        if ticks:
            ax.plot(ticks, cum, label=name, alpha=0.7)
    ax.set_xlabel("sim time (s)")
    ax.set_ylabel("cumulative payload recv (KiB)")
    ax.set_title("per-node goodput (top 20)")
    if len(ranked) <= 10:
        ax.legend(fontsize=7)
    save(fig, "shadow_tpu.goodput")

    # 3. packet + retransmission rates
    fig, ax = plt.subplots(figsize=(8, 4.5))
    for field, label in (("packets_recv", "packets in"),
                         ("packets_send", "packets out"),
                         ("retrans_segments", "retransmits")):
        totals = {}
        for node in nodes.values():
            ticks, deltas = _series(node, field)
            for t, d in zip(ticks, deltas):
                totals[t] = totals.get(t, 0) + d
        if totals:
            xs = sorted(totals)
            ax.plot(xs, [totals[x] for x in xs], label=label)
    ax.set_xlabel("sim time (s)")
    ax.set_ylabel("count / interval")
    ax.set_title("packets and retransmissions")
    ax.set_yscale("symlog")
    ax.legend()
    save(fig, "shadow_tpu.packets")

    # 4. event execution rate
    fig, ax = plt.subplots(figsize=(8, 4.5))
    totals = {}
    for node in nodes.values():
        ticks, deltas = _series(node, "events_executed")
        for t, d in zip(ticks, deltas):
            totals[t] = totals.get(t, 0) + d
    if totals:
        xs = sorted(totals)
        ax.plot(xs, [totals[x] for x in xs])
    ax.set_xlabel("sim time (s)")
    ax.set_ylabel("events / interval")
    ax.set_title("simulation event rate")
    save(fig, "shadow_tpu.events")

    # 4b. fleet lanes — only for --fleet runs (the [fleet] section is
    # per-lane cumulative, so the event curves are plotted as interval
    # deltas to match the solo event-rate figure's shape)
    fleet = stats.get("fleet", {})
    if fleet:
        fig, (ax, ax2) = plt.subplots(2, 1, figsize=(8, 6), sharex=True)
        for lane in sorted(fleet, key=lambda k: int(k)):
            series = fleet[lane]
            seed = (series.get("seed") or [None])[0]
            label = f"lane {lane} (seed {seed})"
            # fleet counters are cumulative; events_delta is the
            # tracker-computed interval column
            ticks, deltas = _series(series, "events_delta")
            ax.plot(ticks, deltas, label=label)
            ax2.plot(series.get("ticks", []), series.get("fill", []),
                     label=label)
        ax.set_ylabel("events / interval")
        ax.set_title(f"fleet lanes ({len(fleet)})")
        if len(fleet) <= 16:
            ax.legend(fontsize="x-small", ncol=2)
        ax2.set_xlabel("sim time (s)")
        ax2.set_ylabel("queue fill")
        save(fig, "shadow_tpu.fleet")

    # 5. fault impact timeline — only when the run had a fault schedule
    # (the [fault] heartbeat section is conditional, so this figure is too)
    faults = stats.get("faults", {})
    if faults:
        fig, (ax, ax2) = plt.subplots(
            2, 1, figsize=(8, 6), sharex=True
        )
        for field, label, axis in (
            ("fault_drops", "fault drops", ax),
            ("quarantined_events", "quarantined events", ax),
            ("downtime_seconds", "downtime (s)", ax2),
        ):
            totals = {}
            for node in faults.values():
                for t, d in zip(node.get("ticks", []),
                                node.get(field, [])):
                    totals[t] = totals.get(t, 0) + d
            if totals:
                xs = sorted(totals)
                axis.plot(xs, [totals[x] for x in xs], label=label)
        ax.set_ylabel("count / interval")
        ax.set_title("fault impact")
        ax.legend()
        ax2.set_xlabel("sim time (s)")
        ax2.set_ylabel("downtime (s) / interval")
        save(fig, "shadow_tpu.faults")

    # 6. supervisor progress — wall-clock window/event rates plus the
    # watchdog stall margin (only for supervised runs that beat)
    sup = stats.get("supervisor", {})
    if sup.get("ticks"):
        fig, ax = plt.subplots(figsize=(8, 4.5))
        xs = sup["ticks"]
        ax.plot(xs, sup.get("events_per_sec", []), label="events/s (wall)")
        ax.plot(xs, sup.get("windows_per_sec", []), label="windows/s (wall)")
        margins = [
            (t, m) for t, m in zip(xs, sup.get("stall_margin_seconds", []))
            if m is not None
        ]
        if margins:
            ax2 = ax.twinx()
            ax2.plot(*zip(*margins), color="tab:red", linestyle="--",
                     label="stall margin (s)")
            ax2.set_ylabel("watchdog margin (s)")
        ax.set_xlabel("sim time (s)")
        ax.set_ylabel("rate (wall)")
        ax.set_yscale("symlog")
        ax.set_title("supervisor progress")
        ax.legend(loc="upper left")
        save(fig, "shadow_tpu.supervisor")

    # 7. queue pressure — spill/refill flow and the reservoir footprint
    # (the [pressure] section only appears under --overflow spill/grow,
    # so this figure is conditional like the fault timeline)
    pres = stats.get("pressure", {})
    if pres.get("ticks"):
        fig, (ax, ax2) = plt.subplots(2, 1, figsize=(8, 6), sharex=True)
        xs = pres["ticks"]
        for field, label in (("spilled", "spilled"),
                             ("refilled", "refilled"),
                             ("spill_lost", "ring lost"),
                             ("overdue", "overdue")):
            ys = pres.get(field, [])
            if any(ys):
                ax.plot(xs, ys, label=label)
        ax.set_ylabel("events / interval")
        ax.set_yscale("symlog")
        ax.set_title("queue pressure")
        ax.legend()
        ax2.plot(xs, pres.get("reservoir_resident", []),
                 label="reservoir resident")
        ax2.plot(xs, pres.get("fill_hwm", []), linestyle="--",
                 label="device fill high-water")
        ax2.set_xlabel("sim time (s)")
        ax2.set_ylabel("events")
        ax2.legend()
        save(fig, "shadow_tpu.pressure")

    # 8. exporter-vs-tracker reconciliation — only with --metrics runs.
    # The [metrics] rows are the telemetry registry's cumulative totals
    # (what a live /metrics scrape returns); the [node] rows are the
    # tracker's per-interval deltas. Summing the deltas must land on the
    # registry curve at every heartbeat — any gap means the exporter and
    # the heartbeat log disagree about the same run.
    met = stats.get("metrics", {})
    if met.get("ticks"):
        fig, (ax, ax2) = plt.subplots(2, 1, figsize=(8, 6), sharex=True)
        xs = met["ticks"]
        ax.plot(xs, met.get("events", []), label="registry events",
                color="tab:blue")
        totals = {}
        for node in nodes.values():
            for t, d in zip(node.get("ticks", []),
                            node.get("events_executed", [])):
                totals[t] = totals.get(t, 0) + d
        if totals:
            txs, run, cum = sorted(totals), 0, []
            for t in txs:
                run += totals[t]
                cum.append(run)
            ax.plot(txs, cum, label="tracker cumulative", color="tab:orange",
                    linestyle="--", marker="x")
        ax.set_ylabel("events (cumulative)")
        ax.set_title("exporter vs tracker reconciliation")
        ax.legend()
        gap = []
        if totals and len(xs) == len(met.get("events", [])):
            node_cum = {}
            run = 0
            for t in sorted(totals):
                run += totals[t]
                node_cum[t] = run
            gap = [e - node_cum[t] for t, e in zip(xs, met["events"])
                   if t in node_cum]
        if gap:
            ax2.plot(xs[: len(gap)], gap, color="tab:red")
        ax2.axhline(0.0, color="grey", linewidth=0.8)
        ax2.set_xlabel("sim time (s)")
        ax2.set_ylabel("registry - tracker")
        save(fig, "shadow_tpu.metrics")

    # 9-11. --stats analytics figures — only when the run logged [stats]
    # rows. The rows are cumulative, so the LAST row's sparse bucket
    # specs are the run's final distributions; buckets are log2 with
    # upper bound 2^i - 1 (obs/stats.py's scheme), drawn as bar charts
    # over bucket index with power-of-two tick labels.
    sts = stats.get("stats", {})

    def _last_hist(fam: str) -> dict:
        cells = sts.get(f"{fam}_hist") or []
        return cells[-1] if cells else {}

    def _bars(axis, fam: str, label: str, color=None):
        h = _last_hist(fam)
        if not h:
            return False
        idx = sorted(int(i) for i in h)
        axis.bar(idx, [h[str(i)] for i in idx], width=0.9,
                 label=label, alpha=0.7, color=color)
        return True

    def _log2_ticks(axis):
        lo, hi = axis.get_xlim()
        ticks = [i for i in range(0, 64, 8) if lo <= i <= hi]
        axis.set_xticks(ticks)
        axis.set_xticklabels(
            ["0" if i == 0 else f"2^{i - 1}" for i in ticks])

    if sts.get("ticks"):
        # latency distributions: event wait + network latency
        fig, ax = plt.subplots(figsize=(8, 4.5))
        any_lat = _bars(ax, "wait", "event wait")
        any_lat |= _bars(ax, "net", "net latency")
        if any_lat:
            _log2_ticks(ax)
            ax.set_xlabel("ns (log2 bucket lower bound)")
            ax.set_ylabel("events")
            ax.set_yscale("symlog")
            ax.set_title("sim-time latency distributions")
            ax.legend()
            save(fig, "shadow_tpu.stats_latency")
        else:
            plt.close(fig)

        # occupancy distributions: events/host/window + queue fill
        fig, ax = plt.subplots(figsize=(8, 4.5))
        any_occ = _bars(ax, "occ", "events per host per window")
        any_occ |= _bars(ax, "qfill", "queue fill at pop")
        if any_occ:
            _log2_ticks(ax)
            ax.set_xlabel("count (log2 bucket lower bound)")
            ax.set_ylabel("observations")
            ax.set_yscale("symlog")
            ax.set_title("occupancy distributions")
            ax.legend()
            save(fig, "shadow_tpu.stats_occupancy")
        else:
            plt.close(fig)

        # frontier run length: only frontier-drain runs populate it
        fig, ax = plt.subplots(figsize=(8, 4.5))
        if _bars(ax, "runlen", "frontier run length",
                 color="tab:green"):
            _log2_ticks(ax)
            ax.set_xlabel("positions/round (log2 bucket lower bound)")
            ax.set_ylabel("rounds")
            ax.set_yscale("symlog")
            ax.set_title("frontier-drain run length")
            ax.legend()
            save(fig, "shadow_tpu.stats_runlen")
        else:
            plt.close(fig)

    return written


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("stats", help="stats.shadow_tpu.json from parse_shadow")
    ap.add_argument("-o", "--output-dir", default=".")
    ap.add_argument("--format", default="png", choices=["png", "pdf", "svg"])
    args = ap.parse_args(argv)
    with open(args.stats) as f:
        stats = json.load(f)
    os.makedirs(args.output_dir, exist_ok=True)
    for path in make_figures(stats, args.output_dir, args.format):
        print(path)
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
