"""CLI entry: `python -m shadow_tpu_torch [options] shadow.config.xml`.

The counterpart of `shadow_tpu.cli`, with the same flags and defaults:
a Shadow config (or `--test`, the built-in example) run to its stoptime
on the card, with heartbeat lines, checkpoints and `--resume`,
supervision (`--watchdog`, SIGTERM/SIGINT checkpoint-then-exit, SIGUSR1
checkpoint-now, `--retry` relaunches), queue-pressure modes
(`--overflow`), per-window widths (`--window N|auto`), invariant checks
(`--validate`), packet capture (`logpcap`/`pcapdir`), the event trace,
the stats plane, the phase profiler, a device profiler capture
(`--xprof`) and the live metrics plane, then one summary JSON line with
the reference's keys. The config digest, the heartbeat rows and the
checkpoint files are the reference's, so a checkpoint either package
writes resumes in the other.

`main(argv, device=...)` runs on CUDA unless the caller passes
`device="cpu"` (the tests do); without a card it raises, it never falls
back to the CPU.

`--mesh N` shards the hosts over N ranks (`parallel.mesh.spawn`, one
process per shard, the port's counterpart of the reference's N devices
in one process): NCCL with one card per rank on CUDA, gloo on the CPU,
or gloo on CUDA for ranks that share one card when the caller passes
`backend="gloo"` to `main` (there is no flag). Rank 0 prints the log,
the heartbeats and the summary and writes the global checkpoints; every
rank runs its shard. `--dcn-slices`, `--locality`, `--spmd` and a resume
of a sharded or locality-ordered checkpoint at any `--mesh` run as in
the reference; `--collective-timeout T` ends a rank whose collective
made no progress for T seconds (a lost peer) with a per-shard bundle and
exit 77.

`--fleet SPEC` runs L scenario lanes of the config as one engine
(`runtime.fleet`), with per-lane `[fleet]` heartbeat rows and a summary
with a per-lane `lanes` list, as the reference's fleet run prints them.

`serve` in place of a config starts the resident scenario service
(`serve/`): an HTTP request plane on `--port`, fleets of `--max-lanes`
lanes on the device, drained by SIGTERM/SIGINT (exit 0, the pending
queue persisted to `--queue-file`) and resized by SIGHUP.

A config whose plugins are existing `.so` files runs on the process
tier (`proc/`): the plugins as green threads in the native runtime, the
syscall exchange batched per window, the plugins' log lines and a
summary on stdout, as the reference prints them.

Refused with exit 2, each naming the ROADMAP.md Queue 1 item that will
port it: `--spmd constraint` (item 7b); a `.so` config under `--mesh`
above 1, the process tier on a mesh (item 9b).
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import math
import os
import sys
import time

import numpy as np

from shadow_tpu_torch import __version__
from shadow_tpu_torch.config import parse_config
from shadow_tpu_torch.core.timebase import MILLISECOND, SECOND
from shadow_tpu_torch.examples import example_config


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="shadow_tpu_torch",
        description="discrete-event network simulator on a CUDA device",
    )
    p.add_argument("config", nargs="?", help="shadow.config.xml path")
    p.add_argument("--test", action="store_true",
                   help="run the built-in example config (examples.c)")
    p.add_argument("--seed", "-s", type=int, default=1,
                   help="random seed (options.c --seed)")
    p.add_argument("--stoptime", type=float, default=None,
                   help="override the config's stoptime (seconds)")
    p.add_argument("--bootstrap-end", type=float, default=None,
                   help="override bootstraptime (unlimited-bw phase end)")
    p.add_argument("--heartbeat-frequency", type=float, default=60.0,
                   help="sim seconds between heartbeat lines "
                        "(options.c --heartbeat-frequency)")
    p.add_argument("--sockets", type=int, default=8,
                   help="socket slots per host")
    p.add_argument("--capacity", type=int, default=None,
                   help="event-queue slots per host (default: sized to "
                        "hold a full TCP receive window in flight)")
    p.add_argument("--allow-queue-overflow", action="store_true",
                   help="legacy alias for --overflow drop with counted, "
                        "non-fatal drops")
    p.add_argument("--overflow", default=None,
                   choices=["spill", "strict", "grow", "drop"],
                   help="event-queue overflow handling "
                        "(docs/9-Queue-Pressure.md): 'spill' (default) is "
                        "lossless — evicted events land in a device ring "
                        "and a host reservoir re-inserts them at window "
                        "boundaries; 'strict' aborts with exit 76 and a "
                        "diagnostic bundle at the first would-be drop; "
                        "'grow' spills and doubles --capacity at the first "
                        "sign of pressure; 'drop' keeps the historical "
                        "lossy counted behavior (sharded meshes default "
                        "to drop: spill is unsharded-only for now)")
    p.add_argument("--log-level", "-l", default="message",
                   choices=["error", "critical", "warning", "message",
                            "info", "debug"])
    p.add_argument("--tcp-congestion-control", default="reno",
                   choices=["reno", "cubic", "aimd"],
                   help="congestion-control algorithm for all TCP "
                        "connections (options.c --tcp-congestion-control)")
    p.add_argument("--interface-qdisc", default="fifo",
                   choices=["fifo", "rr"],
                   help="socket send scheduling: creation-order bursts or "
                        "per-packet round-robin (options.c interface-qdisc)")
    p.add_argument("--interface-buffer", type=int, default=1_024_000,
                   help="NIC receive buffer bytes, drop-tail "
                        "(options.c:132; interfacebuffer host attr "
                        "overrides per host)")
    p.add_argument("--router-queue", default="codel",
                   choices=["codel", "static", "single"],
                   help="upstream router queue manager "
                        "(router.c:50-55 QUEUE_MANAGER_*)")
    p.add_argument("--locality", action="store_true",
                   help="reorder hosts at build time so config-visible "
                        "traffic partners share a shard (sharded runs; "
                        "replaces the reference's random host shuffle + "
                        "work stealing)")
    p.add_argument("--mesh", type=int, default=0,
                   help="shard hosts over N devices (0 = single device; "
                        "the device-mesh --workers)")
    p.add_argument("--dcn-slices", type=int, default=1,
                   help="arrange the mesh as M slices joined over DCN "
                        "(multi-slice; the reference's unfinished "
                        "multi-machine design, master.c:414-416)")
    p.add_argument("--spmd", default="auto",
                   choices=("auto", "shard_map", "constraint", "pmap"),
                   help="SPMD execution path for sharded runs: auto, "
                        "shard_map and pmap run one rank per shard; "
                        "constraint is not ported (ROADMAP.md Queue 1 "
                        "item 7b)")
    p.add_argument("--runahead", type=float, default=None,
                   help="override the conservative window width in "
                        "MILLISECONDS (options.c --runahead minTimeJump; "
                        "default: the topology's minimum path latency). "
                        "Wider windows mean fewer barriers but coarser "
                        "cross-host packet timing: arrivals inside a "
                        "window are deferred to its end")
    p.add_argument("--window", default=None, metavar="N|auto",
                   help="conservative-window width chosen per window: a "
                        "number is a fixed width in milliseconds, 'auto' "
                        "lets a deterministic host-side controller retune "
                        "the width between windows. Like --runahead, "
                        "widths past the topology's minimum latency "
                        "coarsen cross-host packet timing; leave the flag "
                        "off for bit-identical default results")
    p.add_argument("--workers", "-w", type=int, default=None,
                   help="ignored (pthread-era flag; kept for compatibility)")
    p.add_argument("--scheduler-policy", "-p", default=None,
                   help="ignored (pthread-era flag; kept for compatibility)")
    p.add_argument("--fault", action="append", default=[],
                   metavar="SPEC",
                   help="append a fault to the schedule; repeatable. SPEC "
                        "is 'TYPE key=value ...', e.g. "
                        "'crash hosts=relay* start=30 end=45' or 'churn "
                        "hosts=relay* start=10 end=60 period=20 downtime=5 "
                        "frac=0.2' (same attrs as the config's <fault> "
                        "element; see docs/6-Fault-Injection.md)")
    p.add_argument("--fleet", default=None, metavar="SPEC",
                   help="run L scenario lanes of this config as ONE "
                        "vmapped program (docs/16-Scenario-Fleets.md). "
                        "SPEC is space-separated 'lanes=L [seed=a:b] "
                        "[fault-file=PATH] [latency-scale=x,y,...]': "
                        "seed=a:b gives lanes seeds a..b-1 (default: "
                        "--seed for every lane); fault-file holds one "
                        "lane per line of ';'-separated fault DSL specs "
                        "(blank line = no faults for that lane); "
                        "latency-scale lists one multiplier per lane. "
                        "Per-lane heartbeat progress prints as [fleet] "
                        "rows; the summary JSON grows a per-lane "
                        "'lanes' list")
    p.add_argument("--port", type=int, default=0, metavar="PORT",
                   help="serve mode: HTTP port for the request plane "
                        "(0 = kernel-assigned ephemeral port, printed "
                        "to stderr). Only with the 'serve' subcommand "
                        "(docs/17-Serving.md)")
    p.add_argument("--max-lanes", type=int, default=8, metavar="L",
                   help="serve mode: fleet lanes per launch — every "
                        "cached program compiles at exactly L lanes; "
                        "short batches pad with inert lanes")
    p.add_argument("--pack-deadline-ms", type=float, default=50.0,
                   metavar="MS",
                   help="serve mode: max time a queued request waits "
                        "for lane-mates before its class launches "
                        "partially packed (deadline-or-full dispatch)")
    p.add_argument("--max-cached-programs", type=int, default=4,
                   metavar="N",
                   help="serve mode: compiled fleet programs kept warm; "
                        "LRU eviction past N (docs/17-Serving.md)")
    p.add_argument("--queue-file", default="shadow_tpu.queue.json",
                   help="serve mode: pending requests persist here on "
                        "graceful SIGTERM drain and reload on the next "
                        "start")
    p.add_argument("--beat-windows", type=int, default=32, metavar="N",
                   help="serve mode: simulation windows per progress "
                        "heartbeat (one single-fetch harvest per beat)")
    p.add_argument("--snapshot-beats", type=int, default=0, metavar="N",
                   help="serve mode: persist the in-flight batch (fleet "
                        "state + manifest) to --snapshot-path every N "
                        "beats; a failed or crashed launch resumes from "
                        "the last snapshot instead of window 0 (0=off; "
                        "docs/17-Serving.md 'Failure semantics')")
    p.add_argument("--snapshot-path",
                   default="shadow_tpu.serve.snapshot.npz",
                   help="serve mode: beat-snapshot file (checkpoint v7 "
                        "with a serve-batch manifest header)")
    p.add_argument("--launch-retries", type=int, default=1, metavar="N",
                   help="serve mode: retries per launch (exponential "
                        "backoff, resuming from the newest snapshot); "
                        "once exhausted a multi-request batch bisects "
                        "to isolate the poison request")
    p.add_argument("--launch-deadline-s", type=float, default=0.0,
                   metavar="S",
                   help="serve mode: per-beat wall deadline — a wedged "
                        "launch aborts the process with the retryable "
                        "stall exit (75) and a diagnostic bundle, so an "
                        "outer --retry relaunch resumes the batch from "
                        "its snapshot (0=off)")
    p.add_argument("--result-ttl-s", type=float, default=0.0, metavar="S",
                   help="serve mode: evict terminal (done/error/timeout) "
                        "result records not polled for S seconds (0 = "
                        "no TTL; queued/running records never evict)")
    p.add_argument("--max-results", type=int, default=65536, metavar="N",
                   help="serve mode: LRU cap on retained terminal result "
                        "records")
    p.add_argument("--degraded-after", type=int, default=3, metavar="N",
                   help="serve mode: consecutive terminal launch "
                        "failures before /healthz reports degraded and "
                        "/submit returns 503 (a later success recovers)")
    p.add_argument("--trace-requests", type=int, default=0, metavar="N",
                   help="serve mode: record request-scoped spans for "
                        "the most recent N requests and serve each span "
                        "tree at GET /trace/<id> (0 = tracing off; "
                        "docs/18-Serve-Tracing.md)")
    p.add_argument("--ledger-file", default=None, metavar="JSONL",
                   help="serve mode: append every trace span/event to "
                        "this JSONL flight ledger (implies tracing; "
                        "flushed per record, so tools/serve_report and "
                        "the merged tools/export_trace view work on "
                        "dead servers)")
    p.add_argument("--checkpoint-interval", type=float, default=0.0,
                   help="write a checkpoint every N sim seconds (0=off). "
                        "Independent of the interval, SIGINT/SIGTERM "
                        "checkpoint-then-exit and SIGUSR1 writes an "
                        "on-demand checkpoint (docs/7-Supervised-Runs.md)")
    p.add_argument("--checkpoint-path", default="shadow_tpu.ckpt.npz",
                   help="checkpoint file path (rotated each write; see "
                        "--checkpoint-keep)")
    p.add_argument("--checkpoint-keep", type=int, default=1, metavar="N",
                   help="checkpoint generations to retain: PATH newest, "
                        "PATH.1..PATH.N-1 older (default 1 = overwrite)")
    p.add_argument("--resume", default=None, metavar="PATH|auto",
                   help="resume from a checkpoint written by the same "
                        "config; 'auto' picks the newest CRC-verified "
                        "candidate of --checkpoint-path (generations, "
                        "the .emergency crash file, complete shard "
                        "sets), falling back past corrupt ones; "
                        "'auto-if-any' (the --retry relaunch mode) "
                        "starts fresh instead of erroring when nothing "
                        "checkpoint-like exists yet")
    p.add_argument("--watchdog", type=float, default=0.0, metavar="SECONDS",
                   help="per-window wall-clock deadline over the run "
                        "loop: on stall, dump all thread stacks + a "
                        "diagnostic bundle into --diag-dir and exit 75 "
                        "instead of hanging (0=off; a first-use kernel "
                        "build does not count against it)")
    p.add_argument("--collective-timeout", type=float, default=0.0,
                   metavar="SECONDS",
                   help="per-window deadline over the sharded step's "
                        "collectives and the heartbeat harvest's "
                        "device_get — the two sites a dead mesh peer "
                        "wedges forever: on expiry, dump a per-shard "
                        "diagnostic bundle into --diag-dir and exit 77 "
                        "(EXIT_PEER_LOST) so a --retry wrapper can "
                        "relaunch on a shrunken mesh "
                        "(docs/13-Elastic-Recovery.md; 0=off)")
    p.add_argument("--retry", type=int, default=0, metavar="N",
                   help="supervise the run in a child process and "
                        "relaunch it up to N times after transient "
                        "failures (stall 75, peer-lost 77, signal "
                        "deaths), resuming from the newest valid "
                        "checkpoint with exponential backoff; a "
                        "peer-lost relaunch halves --mesh "
                        "(docs/13-Elastic-Recovery.md)")
    p.add_argument("--retry-backoff", type=float, default=1.0,
                   metavar="SECONDS",
                   help="base of the --retry exponential backoff "
                        "(SECONDS, 2*SECONDS, 4*SECONDS, ...)")
    p.add_argument("--validate", type=int, default=0, metavar="K",
                   help="check EngineState invariants every K engine "
                        "windows, off the hot path (monotonic clock, "
                        "sorted queue rows, non-negative counters, NaN "
                        "scan); exit 70 naming the offending leaf on "
                        "violation (0=off)")
    p.add_argument("--diag-dir", default=".",
                   help="directory for watchdog stall bundles and stack "
                        "dumps")
    p.add_argument("--trace", nargs="?", const=2048, type=int, default=0,
                   metavar="N",
                   help="device-side event tracing: record every executed "
                        "event and routed send into a per-host ring of N "
                        "records (bare --trace = 2048), drained at "
                        "heartbeat boundaries and written to --trace-out; "
                        "export to Chrome trace-event JSON with "
                        "tools/export_trace.py (docs/8-Tracing-Profiling.md)")
    p.add_argument("--trace-out", default="shadow_tpu.trace.npz",
                   metavar="PATH",
                   help="trace output file (.npz of record arrays + meta)")
    p.add_argument("--profile", action="store_true",
                   help="wall-clock-time the run loop's phases (build, "
                        "step, host drain, checkpoint) "
                        "plus per-window occupancy; adds a 'profile' key "
                        "to the summary line and per-phase tracks to the "
                        "exported trace")
    p.add_argument("--metrics", action="store_true",
                   help="live telemetry registry: fold the heartbeat "
                        "harvest's counters into an OpenMetrics-renderable "
                        "registry and emit a [metrics] heartbeat section "
                        "(docs/14-Telemetry.md). Rides the heartbeat "
                        "harvest's one device-to-host copy per segment")
    p.add_argument("--stats", action="store_true",
                   help="sim-time analytics plane: device-side log2 "
                        "histograms of event wait time, network latency, "
                        "per-window host occupancy, queue fill at pop, "
                        "and frontier run length, accumulated inside the "
                        "window loop and harvested through the heartbeat "
                        "bundle; emits a [stats] heartbeat section and "
                        "OpenMetrics histogram families "
                        "(docs/15-Sim-Analytics.md)")
    p.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                   help="serve /metrics (OpenMetrics), /healthz, and "
                        "/summary.json on 127.0.0.1:PORT from a background "
                        "thread (0 = ephemeral port, printed to stderr); "
                        "implies --metrics")
    p.add_argument("--xprof", default=None, metavar="START:STOP",
                   help="capture a device profiler trace "
                        "(torch.profiler: CPU ops and CUDA kernels) across "
                        "the window segments between sim seconds START and "
                        "STOP, into --xprof-dir as a Chrome trace")
    p.add_argument("--xprof-dir", default="shadow_tpu_xprof",
                   metavar="DIR",
                   help="output directory for the --xprof trace")
    p.add_argument("--show-build-info", action="store_true")
    return p


def _make_observability(cfg, sim, args, trace=None, metrics=None):
    """Logger + tracker honoring the config's per-host loglevel and
    heartbeatloginfo attrs (tracker.c:433-561; shadow_logger.c:102-121)."""
    from shadow_tpu_torch.config import expand_hosts
    from shadow_tpu_torch.utils.logger import ShadowLogger
    from shadow_tpu_torch.utils.tracker import Tracker

    logger = ShadowLogger(default_level=args.log_level)
    info_of: dict[str, tuple[str, ...]] = {}
    level_of: dict[str, str] = {}
    for h in expand_hosts(cfg):
        if h.spec.loglevel:
            logger.set_host_level(h.name, h.spec.loglevel)
        if h.spec.heartbeatloginfo:
            info_of[h.name] = tuple(
                p.strip() for p in h.spec.heartbeatloginfo.split(",")
                if p.strip()
            )
        if h.spec.heartbeatloglevel:
            level_of[h.name] = h.spec.heartbeatloglevel
    tracker = Tracker(
        sim.names, logger, log_info=("node",), info_of=info_of,
        level_of=level_of, faults=sim.faults, trace=trace,
        pressure=sim.pressure, metrics=metrics,
    )
    return logger, tracker


def _make_profiler(args):
    """WindowProfiler when --profile, else None — plus a phase context
    factory that degrades to a no-op so call sites stay unconditional."""
    import contextlib

    if not args.profile:
        return None, (lambda _name: contextlib.nullcontext())
    from shadow_tpu_torch.obs.profiler import WindowProfiler

    prof = WindowProfiler()
    return prof, prof.phase


def _fleet_refusal(args) -> str | None:
    """The message for the first flag a fleet run cannot take, None when
    there is none: the adaptive window and the per-scenario planes."""
    if args.window == "auto":
        return ("--window auto cannot drive a fleet: the adaptive "
                "WindowController is a single host-side policy and cannot "
                "track per-lane queue fill — use a fixed '--window N' "
                "(milliseconds, uniform across lanes) or leave --window "
                "off for bit-identical default windows")
    for on, name in (
        (args.mesh, "--mesh"),
        (args.trace, "--trace"),
        (args.stats, "--stats"),
        (args.resume, "--resume"),
        (args.checkpoint_interval, "--checkpoint-interval"),
        (args.metrics, "--metrics"),
        (args.metrics_port is not None, "--metrics-port"),
        (args.xprof, "--xprof"),
        (args.profile, "--profile"),
    ):
        if on:
            return (f"{name} is per-scenario and cannot ride a fleet run; "
                    "drop it (or run the lanes solo)")
    return None


def _parse_fleet_spec(spec: str, base_seed: int) -> dict:
    """'lanes=L [seed=a:b] [fault-file=PATH] [latency-scale=x,...]' ->
    build_fleet overrides. Raises ValueError with the offending token."""
    kv = {}
    for tok in spec.split():
        k, sep, v = tok.partition("=")
        if not sep:
            raise ValueError(f"expected key=value, got {tok!r}")
        if k in kv:
            raise ValueError(f"duplicate key {k!r}")
        kv[k] = v
    unknown = set(kv) - {"lanes", "seed", "fault-file", "latency-scale"}
    if unknown:
        raise ValueError(
            f"unknown key(s) {sorted(unknown)}; valid keys are lanes, "
            "seed, fault-file, latency-scale"
        )
    if "lanes" not in kv:
        raise ValueError("lanes=L is required")
    lanes = int(kv["lanes"])
    out: dict = {"lanes": lanes}
    if "seed" in kv:
        a, sep, b = kv["seed"].partition(":")
        if not sep:
            raise ValueError(
                f"seed wants a range a:b (one seed per lane), got "
                f"{kv['seed']!r}"
            )
        seeds = tuple(range(int(a), int(b)))
        if len(seeds) != lanes:
            raise ValueError(
                f"seed range {kv['seed']} has {len(seeds)} seeds for "
                f"{lanes} lanes"
            )
        out["seeds"] = seeds
    else:
        out["seeds"] = tuple(base_seed for _ in range(lanes))
    if "fault-file" in kv:
        from shadow_tpu_torch.faults import parse_fault_dsl

        with open(kv["fault-file"]) as f:
            lines = f.read().splitlines()
        lines = [ln for ln in lines if not ln.lstrip().startswith("#")]
        if len(lines) != lanes:
            raise ValueError(
                f"fault-file {kv['fault-file']} has {len(lines)} lane "
                f"lines for {lanes} lanes (blank line = no faults)"
            )
        out["faults"] = tuple(
            tuple(parse_fault_dsl(s) for s in ln.split(";") if s.strip())
            or None
            for ln in lines
        )
    if "latency-scale" in kv:
        scales = tuple(float(s) for s in kv["latency-scale"].split(","))
        if len(scales) != lanes:
            raise ValueError(
                f"latency-scale lists {len(scales)} values for {lanes} "
                "lanes"
            )
        out["latency_scale"] = scales
    return out


def _run_fleet(args, cfg, sim, t0: float, dev,
               run_info: dict | None = None) -> int:
    """The --fleet run: L lanes of one scenario as one engine, driven
    segment by segment through the one-read harvest with per-lane
    [fleet] heartbeat rows; the per-scenario planes (tracker, trace,
    capture, metrics, checkpoints) stay with solo runs."""
    from shadow_tpu_torch.runtime.harvest import HeartbeatHarvest
    from shadow_tpu_torch.sim import build_fleet
    from shadow_tpu_torch.utils.tracker import FLEET_HEADER

    window_fixed_ns = None
    if args.window is not None:
        try:
            window_fixed_ns = int(float(args.window) * MILLISECOND)
        except ValueError:
            print(f"error: --window must be a width in ms (or absent) "
                  f"under --fleet, got {args.window!r}", file=sys.stderr)
            return 2
        if window_fixed_ns < sim.engine.cfg.lookahead:
            print(f"error: --window {args.window} is narrower than the "
                  f"conservative lookahead ({sim.engine.cfg.lookahead} "
                  "ns); it would only add barriers", file=sys.stderr)
            return 2
    try:
        fspec = _parse_fleet_spec(args.fleet, args.seed)
    except (ValueError, OSError) as e:
        print(f"error: --fleet: {e}", file=sys.stderr)
        return 2
    lanes = fspec.pop("lanes")
    try:
        fleet = build_fleet(sim, lanes, **fspec)
    except ValueError as e:
        print(f"error: --fleet: {e}", file=sys.stderr)
        return 2
    harvest = HeartbeatHarvest(fleet)
    eng = fleet.engine
    stop_s = cfg.stoptime
    hb = args.heartbeat_frequency
    print(f"shadow_tpu_torch {__version__} fleet: {lanes} lanes x "
          f"{len(sim.names)} hosts, stoptime {stop_s:.0f}s, one engine "
          f"over every lane's rows, device {dev}", file=sys.stderr)
    # heartbeat rows ride stdout like the solo tracker's
    print(FLEET_HEADER, flush=True)
    t1 = time.perf_counter()
    sim_s = 0.0
    next_hb = hb if hb > 0 else float("inf")
    st = None
    last_events = [0] * lanes
    fetched = None
    segments = 0
    probes = 0
    while sim_s < stop_s:
        nxt = min(next_hb, stop_s)
        stop_i = int(nxt * SECOND)
        if window_fixed_ns is not None:
            # fixed-width windows: one clock probe per window, on the
            # SLOWEST lane (the fleet's segment barrier)
            while True:
                st = fleet.dispatch(stop_i, st, window_ns=window_fixed_ns)
                probes += 1
                if int(eng._fetch(st.now.min())) >= stop_i:
                    break
        else:
            st = fleet.dispatch(stop_i, st)
        st, bundle = harvest.extract(st, full=True)
        fetched = harvest.fetch(bundle)
        segments += 1
        sim_s = nxt
        next_hb = (math.floor(sim_s / hb) + 1) * hb if hb > 0 else (
            float("inf"))
        rows = harvest.lane_summaries_from(fetched)
        t_s = int(sim_s)
        for i, row in enumerate(rows):
            delta = row["executed"] - last_events[i]
            last_events[i] = row["executed"]
            fill = float(fetched["fill"][i])
            print("[shadow-heartbeat] [fleet] "
                  f"{t_s},{i},{fleet.seeds[i]},"
                  f"{row['now_ns'] // 1_000_000_000},{row['windows']},"
                  f"{row['executed']},{delta},{row['queue_drops']},"
                  f"{fill:.4f}", flush=True)
        agg = harvest.summary_from(fetched)
        fleet.check_drops(agg["queue_drops"], agg)
    wall = time.perf_counter() - t1
    rows = harvest.lane_summaries_from(fetched)
    total_events = sum(r["executed"] for r in rows)
    summary = {
        "fleet_lanes": lanes,
        "hosts": len(sim.names),
        "sim_seconds": stop_s,
        "wall_seconds": round(wall, 3),
        "build_seconds": round(t1 - t0, 3),
        "events": total_events,
        "events_per_sec": round(total_events / max(wall, 1e-9), 1),
        "scenarios_per_sec": round(lanes / max(wall, 1e-9), 3),
        "sim_s_per_wall_s": round(stop_s / max(wall, 1e-9), 3),
        "windows": max(r["windows"] for r in rows),
        "queue_drops": sum(r["queue_drops"] for r in rows),
        "seeds": list(fleet.seeds),
        "lanes": rows,
    }
    if run_info is not None:
        run_info.update(segments=segments, window_probes=probes,
                        harvest_reads=harvest.host_syncs,
                        host_syncs=eng.host_syncs, loop_s=wall)
    print(json.dumps(summary), flush=True)
    return 0


def _strip_retry_flags(argv: list[str]) -> list[str]:
    """The child's command line: without the retry flags, so that one
    supervisor owns the run."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
            continue
        if a in ("--retry", "--retry-backoff"):
            skip = True
            continue
        if a.startswith("--retry=") or a.startswith("--retry-backoff="):
            continue
        out.append(a)
    return out


def _parse_xprof(spec: str):
    """START:STOP in sim seconds -> (start, stop), or an error message."""
    try:
        a, sep, b = spec.partition(":")
        if not sep:
            raise ValueError("missing ':'")
        span = (float(a), float(b))
    except ValueError:
        return f"--xprof must be START:STOP in sim seconds, got {spec!r}"
    if span[0] < 0 or span[1] <= span[0]:
        return f"--xprof needs 0 <= START < STOP, got {spec!r}"
    return span


def _refused(args, cfg=None) -> str | None:
    """The message for the first flag (or config) this port does not
    run yet, naming the ROADMAP.md item that will port it; None when
    the run is supported."""
    item = "ROADMAP.md Queue 1 item"
    checks = (
        (args.spmd == "constraint",
         f"--spmd constraint is not ported ({item} 7b, a global engine "
         "partitioned by the compiler)"),
    )
    for on, msg in checks:
        if on:
            return msg
    if cfg is None:
        return None
    if (args.mesh or 0) > 1 and any(_is_shim_plugin(cfg, p)
                                    for p in cfg.plugins):
        return (f"native .so plugins (the process tier) on a mesh of more "
                f"than one shard are not ported ({item} 9b); drop --mesh")
    return None


def _is_shim_plugin(cfg, plugin) -> bool:
    """Whether a <plugin> is a native shared object (the process
    tier's), by its resolved path."""
    from shadow_tpu_torch.config import resolve_path

    path = resolve_path(plugin.path, cfg.base_dir)
    return path.endswith(".so") and os.path.exists(path)


def _mesh_config_refusal(args) -> str | None:
    """`_refused` of the config file, read before `--mesh` starts its
    ranks; None without a config file."""
    if not args.mesh or args.mesh <= 1 or not args.config or args.test:
        return None
    try:
        cfg = parse_config(args.config)
    except (OSError, SyntaxError, ValueError):
        return None  # each rank reports the config's own error
    return _refused(args, cfg)


def _run_proc_tier(args, cfg, overflow: str, dev, mesh) -> int:
    """The process tier's run: plugin log lines and the summary on
    stdout; 0 when every process exited 0."""
    if not all(_is_shim_plugin(cfg, p) for p in cfg.plugins):
        print("error: configs cannot mix native .so plugins with modeled "
              "plugins yet; make every plugin a .so or none",
              file=sys.stderr)
        return 2
    if args.metrics or args.metrics_port is not None or args.xprof:
        print("note: --metrics/--metrics-port/--xprof are device-tier "
              "flags (they ride the heartbeat harvest); the process "
              "tier ignores them", file=sys.stderr)
    unsupported = []
    if args.resume:
        unsupported.append("--resume")
    if args.checkpoint_interval:
        unsupported.append("--checkpoint-interval")
    if unsupported:
        print("error: the process tier (native .so plugins) does not "
              f"support {', '.join(unsupported)} yet; native endpoint "
              "streams are not captured in device checkpoints",
              file=sys.stderr)
        return 2
    from shadow_tpu_torch.proc import ProcessTier
    from shadow_tpu_torch.proc.tier import tier_summary
    from shadow_tpu_torch.runtime.pressure import (
        QueuePressureError,
        pressure_bundle,
    )
    from shadow_tpu_torch.runtime.supervisor import (
        EXIT_PRESSURE,
        Supervisor,
    )

    t0 = time.perf_counter()
    prof, _phase = _make_profiler(args)
    with _phase("build"):
        tier = ProcessTier(
            cfg, device=dev, seed=args.seed, n_sockets=args.sockets,
            capacity=args.capacity,
            strict_overflow=not args.allow_queue_overflow,
            tcp_cc=args.tcp_congestion_control,
            rx_queue=args.router_queue, qdisc=args.interface_qdisc,
            interface_buffer=args.interface_buffer, mesh=mesh,
            locality=args.locality, trace=args.trace, profiler=prof,
            overflow=overflow,
        )
    sup = Supervisor(
        watchdog_timeout=args.watchdog, diag_dir=args.diag_dir,
        label="shadow_tpu_torch.proc",
        info=lambda: {
            "tier": "process",
            "live_pids": tier.live_pids(),
            "exit_codes": {str(k): v for k, v in tier.exit_codes.items()},
        },
    )
    try:
        with sup:
            st = tier.run(supervisor=sup)
        wall = time.perf_counter() - t0
    except QueuePressureError as e:
        path = pressure_bundle(e, diag_dir=args.diag_dir,
                               label="shadow_tpu_torch.proc")
        print(f"shadow_tpu_torch: QUEUE PRESSURE under --overflow strict: "
              f"{e}\ndiagnostic bundle -> {path}", file=sys.stderr)
        return EXIT_PRESSURE
    finally:
        # abnormal exits (a stall abort is os._exit and skips this, but
        # signals and exceptions land here) still print the plugin log
        # lines so far and close the runtime
        for t_ns, pid, msg in tier.logs:
            print(f"[{t_ns / SECOND:.6f}] [pid {pid}] {msg}")
        tier.close()
    summary = {
        "hosts": len(tier.sim.names),
        "sim_seconds": cfg.stoptime,
        "wall_seconds": round(wall, 3),
        "processes": len(tier.pid_host),
        "exit_codes": tier.exit_codes,
        **tier_summary(tier, st),
    }
    if args.trace and st.trace is not None:
        from shadow_tpu_torch.obs.trace import TraceDrain

        tdrain = TraceDrain(args.trace, names=tier.sim.names,
                            kind_names=list(tier.sim.kind_names))
        tdrain.drain(st.trace)
        tdrain.save(args.trace_out,
                    profile=prof.export() if prof is not None else None,
                    extra_meta={"seed": args.seed, "tier": "process"})
        summary["trace"] = {
            "records": tdrain.n_records, "lost": tdrain.lost,
            "truncated": tdrain.truncated, "file": args.trace_out,
        }
        print(f"event trace: {tdrain.n_records} records -> "
              f"{args.trace_out}", file=sys.stderr)
    if prof is not None:
        summary["profile"] = prof.summary()
    print(json.dumps(summary))
    if sup.stop_requested:
        print(f"interrupted by signal {sup.stop_signum}; the process "
              "tier has no checkpoint to write", file=sys.stderr)
        return sup.exit_code()
    return 0 if all(c == 0 for c in tier.exit_codes.values()) else 1


def _build_info(device) -> str:
    import torch

    if device is not None and torch.device(device).type == "cpu":
        name = "cpu"
    elif torch.cuda.is_available():
        name = torch.cuda.get_device_name(0)
    else:
        name = "no CUDA device"
    return (f"shadow_tpu_torch {__version__} (torch {torch.__version__}, "
            f"CUDA {torch.version.cuda}, device {name})")


def _mesh_rank(argv, device, backend):
    """One rank of a `--mesh N` run: `main` inside the group, returning
    (exit code, run_info)."""
    info: dict = {}
    rc = main(argv, device=device, run_info=info, backend=backend)
    return rc, info


def _launch_mesh(argv, args, device, backend, run_info) -> int:
    """`--mesh N` outside a process group: start N ranks, each running
    this command line, and return rank 0's exit code (77 when a rank
    lost its peer; a rank killed by signal s gives 128 + s)."""
    from shadow_tpu_torch.parallel.mesh import (
        GROUP_TIMEOUT_S,
        SpawnError,
        default_backend,
        spawn,
    )
    from shadow_tpu_torch.runtime.supervisor import EXIT_PEER_LOST

    argv = list(argv) if argv is not None else sys.argv[1:]
    backend = backend or default_backend(
        "cuda" if device is None else device)
    # the group's own timeout outlasts --collective-timeout, so that the
    # collective watchdog, not the backend, ends a rank whose peer died
    timeout = max(GROUP_TIMEOUT_S, 2 * args.collective_timeout + 60)
    try:
        rc, info = spawn(_mesh_rank, args.mesh, backend=backend,
                         device=device, args=(argv, device, backend),
                         timeout_s=timeout)
    except SpawnError as e:
        codes = [c for c in e.exit_codes if c]
        if EXIT_PEER_LOST in codes:
            return EXIT_PEER_LOST
        c = codes[0] if codes else 1
        return 128 - c if c < 0 else c
    if run_info is not None:
        run_info.update(info)
    return int(rc)


def _run_serve(args, device=None) -> int:
    """`serve`: the resident scenario service on `device` (None: CUDA).
    The main thread owns the signal plane; the launch worker and the
    HTTP handler threads do the work. SIGTERM / SIGINT trigger the
    graceful drain — finish the launch in flight, persist the pending
    queue to --queue-file, exit 0. SIGHUP is the operator mesh resize:
    it reads the new lane count from `<snapshot-path>.resize` and
    migrates the in-flight batch at the next beat boundary."""
    import signal as _signal

    from shadow_tpu_torch.runtime.supervisor import Supervisor
    from shadow_tpu_torch.serve.http import ServeServer
    from shadow_tpu_torch.serve.service import SimService

    # a relaunch under `--retry` (the elastic outer loop) seeds the mesh
    # generation, so /healthz reports the churn from the first beat
    _attempt = os.environ.get("SHADOW_TPU_RETRY_ATTEMPT")
    generation = int(_attempt) if _attempt and _attempt.isdigit() else 0

    tracer = None
    if args.trace_requests > 0 or args.ledger_file:
        from shadow_tpu_torch.obs.servetrace import ServeTracer

        tracer = ServeTracer(
            max_requests=args.trace_requests or 4096,
            ledger_file=args.ledger_file,
            ledger_meta={"max_lanes": args.max_lanes,
                         "beat_windows": args.beat_windows},
        )
    svc = SimService(
        max_lanes=args.max_lanes,
        pack_deadline_ms=args.pack_deadline_ms,
        max_cached_programs=args.max_cached_programs,
        beat_windows=args.beat_windows,
        queue_file=args.queue_file,
        snapshot_beats=args.snapshot_beats,
        snapshot_path=args.snapshot_path,
        launch_retries=args.launch_retries,
        launch_deadline_s=args.launch_deadline_s,
        result_ttl_s=args.result_ttl_s,
        max_results=args.max_results,
        degraded_after=args.degraded_after,
        diag_dir=args.diag_dir,
        tracer=tracer,
        generation=generation,
        device=device,
    )

    def _on_sighup(_signum, _frame):
        ctl = (args.snapshot_path or "shadow_tpu.serve") + ".resize"
        try:
            with open(ctl) as f:
                lanes = int(f.read().strip())
            os.remove(ctl)
        except (OSError, ValueError) as e:
            print(f"serve: SIGHUP resize ignored — no usable lane "
                  f"count in {ctl!r} ({type(e).__name__}: {e})",
                  file=sys.stderr, flush=True)
            return
        print(f"serve: SIGHUP resize -> {lanes} lane(s)",
              file=sys.stderr, flush=True)
        try:
            svc.resize(lanes)
        except ValueError as e:
            print(f"serve: SIGHUP resize rejected: {e}",
                  file=sys.stderr, flush=True)

    _signal.signal(_signal.SIGHUP, _on_sighup)
    with Supervisor(label="shadow_tpu-serve") as sup:
        # resume BEFORE reloading the drained queue: the crashed batch
        # must reach the worker ahead of any re-packed queue traffic,
        # or a completing queue batch would clear its snapshot
        svc.resume_pending_batch()
        restored = svc.load_queue()
        if restored:
            print(f"serve: restored {restored} pending request(s) from "
                  f"{args.queue_file}", file=sys.stderr, flush=True)
        svc.start()
        srv = ServeServer(svc, port=args.port).start()
        try:
            while not sup.stop_requested:
                time.sleep(0.2)
        finally:
            srv.close()
            report = svc.drain()
            print(f"serve: drained — {report['persisted']} pending "
                  f"request(s) persisted to {report['queue_file']}",
                  file=sys.stderr, flush=True)
            if tracer is not None:
                tracer.close()
            sup.mark_drained()
    return sup.exit_code()


def main(argv=None, *, device=None, run_info: dict | None = None,
         backend: str | None = None) -> int:
    """Run the command line `argv` (sys.argv[1:] by default) on `device`
    (None: CUDA, which must exist; "cpu" for the tests). Returns the exit
    code. A completed run fills `run_info`, when given, with what it
    measured: the segments run, the heartbeat harvest's reads and wall
    seconds (extract + fetch), the engine's reads, the loop's wall
    seconds, the windows dispatched one at a time under `--window` and
    their widths, the capture drain's host seconds and, under `--mesh`,
    rank 0's collectives and the group's backend. `backend` picks the
    `--mesh` group's backend ("nccl" or "gloo"; None: NCCL on CUDA, gloo
    on the CPU)."""
    args = make_parser().parse_args(argv)
    if args.show_build_info:
        print(_build_info(device))
        return 0
    msg = _refused(args)
    if msg is not None:
        print(f"error: {msg}", file=sys.stderr)
        return 2
    if args.fleet:
        msg = _fleet_refusal(args)
        if msg is not None:
            print(f"error: {msg}", file=sys.stderr)
            return 2
    if args.retry > 0:
        # run the simulator as a child in its own process group; on a
        # stall (75), a lost peer (77) or a signal death, reap the group,
        # back off and relaunch with --resume auto-if-any
        from shadow_tpu_torch.runtime.supervisor import run_with_retry

        child = [sys.executable, "-m", "shadow_tpu_torch"] + (
            _strip_retry_flags(list(argv) if argv is not None
                               else sys.argv[1:]))
        report = run_with_retry(child, retries=args.retry,
                                backoff_s=args.retry_backoff)
        print("shadow_tpu_torch: retry report "
              + json.dumps({k: report[k] for k in
                            ("attempts", "recoveries", "exit_code",
                             "exit_history", "mttr_s")}),
              file=sys.stderr, flush=True)
        return int(report["exit_code"])
    if args.config == "serve":
        # the resident scenario service: no config file; scenarios
        # arrive as requests over the HTTP plane
        return _run_serve(args, device)
    if args.dcn_slices > 1 and not args.mesh:
        print("error: --dcn-slices needs --mesh N (total devices across "
              "all slices)", file=sys.stderr)
        return 2
    mesh = None
    if args.mesh:
        import torch.distributed as dist

        if not dist.is_initialized():
            msg = _mesh_config_refusal(args)
            if msg is not None:
                print(f"error: {msg}", file=sys.stderr)
                return 2
            return _launch_mesh(argv, args, device, backend, run_info)
        from shadow_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(args.mesh, dcn_slices=args.dcn_slices,
                         backend=backend, device=device)
        if mesh.rank != 0:
            # one voice: rank 0 prints the log, heartbeats and summary
            sys.stdout = sys.stderr = open(os.devnull, "w")
    if args.workers is not None or args.scheduler_policy is not None:
        print("note: --workers/--scheduler-policy are pthread-era flags; "
              "parallelism is the device here", file=sys.stderr)
    from shadow_tpu_torch.core.device import resolve_device

    dev = mesh.device if mesh is not None else resolve_device(device)
    if args.test:
        cfg = parse_config(example_config())
    elif args.config:
        cfg = parse_config(args.config)
    else:
        print("error: a config file (or --test) is required", file=sys.stderr)
        return 2
    if args.stoptime is not None:
        cfg = dataclasses.replace(cfg, stoptime=args.stoptime)
    if args.bootstrap_end is not None:
        cfg = dataclasses.replace(cfg, bootstraptime=args.bootstrap_end)
    if args.fault:
        # CLI faults append to the config's schedule BEFORE the config
        # digest below: a fault schedule changes every event total, so a
        # checkpoint must be tied to it like any other build input
        from shadow_tpu_torch.faults import parse_fault_dsl

        cfg = dataclasses.replace(
            cfg,
            faults=cfg.faults + tuple(
                parse_fault_dsl(s) for s in args.fault
            ),
        )
    msg = _refused(args, cfg)
    if msg is not None:
        print(f"error: {msg}", file=sys.stderr)
        return 2

    # overflow-mode resolution: lossless spill is the default
    overflow = args.overflow
    if args.allow_queue_overflow:
        if overflow not in (None, "drop"):
            print("error: --allow-queue-overflow conflicts with "
                  f"--overflow {overflow}", file=sys.stderr)
            return 2
        overflow = "drop"
    if overflow is None:
        # the sharded engine does not speak the reservoir's boundary
        # protocol: meshes keep counted drops unless asked otherwise
        overflow = "drop" if args.mesh else "spill"

    # a config whose plugins are real shared objects runs on the process
    # tier: native green threads and the window-batched syscall exchange
    if any(_is_shim_plugin(cfg, p) for p in cfg.plugins):
        return _run_proc_tier(args, cfg, overflow, dev, mesh)

    # --xprof is parsed before the build: a malformed span fails at once
    xprof_span = None
    if args.xprof:
        xprof_span = _parse_xprof(args.xprof)
        if isinstance(xprof_span, str):
            print(f"error: {xprof_span}", file=sys.stderr)
            return 2
    xprof = None  # the live obs.profiler.DeviceTrace
    xprof_done = False

    from shadow_tpu_torch.sim import build_simulation

    t0 = time.perf_counter()
    prof, _phase = _make_profiler(args)

    resume_src = None  # a path, or a list of shard-set member paths
    ckpt_info: dict = {}
    if args.resume:
        from shadow_tpu_torch.utils.checkpoint import (
            find_resume_checkpoint,
            read_header_info,
        )

        resume_src = args.resume
        if resume_src in ("auto", "auto-if-any"):
            try:
                found = find_resume_checkpoint(args.checkpoint_path)
            except ValueError as e:
                print(f"error: --resume auto: {e}", file=sys.stderr)
                return 2
            if found is None:
                if resume_src == "auto-if-any":
                    print("shadow_tpu_torch: --resume auto-if-any: no "
                          "checkpoint yet; starting fresh",
                          file=sys.stderr)
                    found = (None, {}, [])
                else:
                    print("error: --resume auto: no checkpoint "
                          f"generations at {args.checkpoint_path}",
                          file=sys.stderr)
                    return 2
            resume_src, _auto_meta, skipped = found
            for p, reason in skipped:
                print(f"warning: --resume auto: skipping {p}: {reason}",
                      file=sys.stderr)
        if resume_src is not None:
            try:
                ckpt_info = read_header_info(
                    resume_src if isinstance(resume_src, str)
                    else resume_src[0])
            except ValueError as e:
                print(f"error: --resume: {e}", file=sys.stderr)
                return 2
            ckpt_mesh = ckpt_info.get("mesh") or {}
            if ckpt_mesh.get("n_shards") not in (None, args.mesh or 1):
                print(f"shadow_tpu_torch: resharding: checkpoint written "
                      f"at {ckpt_mesh['n_shards']} shard(s), resuming at "
                      f"{args.mesh or 1}", file=sys.stderr)
    # a checkpoint's host permutation is forced on the rebuild: a
    # locality order recomputed for another shard count would scramble
    # the gids against its leaves
    resume_host_order = (ckpt_info.get("mesh") or {}).get("host_order")

    def _build(capacity):
        # one closure for the initial build AND the --overflow grow
        # re-template (doubled capacity, everything else identical)
        return build_simulation(
            cfg, seed=args.seed, n_sockets=args.sockets,
            capacity=capacity, tcp_cc=args.tcp_congestion_control,
            rx_queue=args.router_queue, qdisc=args.interface_qdisc,
            interface_buffer=args.interface_buffer,
            runahead_ns=(
                int(args.runahead * MILLISECOND)
                if args.runahead is not None else None
            ),
            trace=args.trace, stats=int(args.stats), profiler=prof,
            overflow=overflow, device=dev, mesh=mesh, spmd=args.spmd,
            locality=args.locality, host_order=resume_host_order,
        )

    with _phase("build"):
        sim = _build(args.capacity)
    if args.allow_queue_overflow:
        sim.strict_overflow = False
    if args.fleet:
        return _run_fleet(args, cfg, sim, t0, dev, run_info)
    tdrain = None
    if args.trace:
        from shadow_tpu_torch.obs.trace import TraceDrain

        tdrain = TraceDrain(
            args.trace, names=sim.names, kind_names=list(sim.kind_names)
        )
        if sim.pressure is not None:
            # spill/refill are host-side moments: the controller injects
            # synthetic OP_SPILL/OP_REFILL rows into the same drain
            sim.pressure.attach_trace(
                tdrain, len_arg=sim.engine.cfg.trace_len_arg
            )
        print(f"event trace: {args.trace} records/host/interval -> "
              f"{args.trace_out}", file=sys.stderr)
    n_hosts = len(sim.names)
    print(f"shadow_tpu_torch {__version__}: {n_hosts} hosts, "
          f"{sim.topo.n_vertices} topology vertices, "
          f"stoptime {cfg.stoptime:.0f}s, device {dev}"
          + (f", mesh {args.mesh} ({mesh.backend})" if mesh else ""),
          file=sys.stderr)

    # the digest ties a checkpoint to the exact build inputs, as the
    # reference's does (the same repr, so either package's checkpoint
    # passes the other's check): content, not paths, and no stoptime
    cfg_digest = hashlib.sha256(
        repr(
            (
                dataclasses.replace(cfg, base_dir="", stoptime=0.0),
                cfg.topology_source(),
                args.seed,
                args.sockets,
                args.capacity,
                args.tcp_congestion_control,
                args.interface_qdisc,
                args.interface_buffer,
                args.router_queue,
            )
        ).encode()
    ).hexdigest()[:16]

    st = sim.state0
    sim_s = 0.0
    if resume_src is not None:
        from shadow_tpu_torch.utils.checkpoint import (
            load_checkpoint,
            load_shard_set,
            read_extra,
        )

        try:
            if isinstance(resume_src, list):
                st, meta = load_shard_set(resume_src, sim.state0, mesh=mesh)
                extras = {}
            else:
                # reshard=True: leaves are matched by path, so a
                # checkpoint written at S shards restores at this
                # build's S' when its exchange buffer was empty
                st, meta = load_checkpoint(resume_src, sim.state0,
                                           reshard=True, mesh=mesh)
                extras = read_extra(resume_src)
        except ValueError as e:
            print(f"error: --resume: {e}", file=sys.stderr)
            return 2
        resume_name = (f"{len(resume_src)}-member shard set"
                       if isinstance(resume_src, list) else resume_src)
        parked = int(np.size(extras.get("reservoir_time", ())))
        if sim.pressure is not None:
            # mid-pressure resume: the reservoir rides the checkpoint's
            # extra section; restoring it keeps --resume exact
            if extras:
                sim.pressure.restore(extras)
        elif parked:
            print(f"error: checkpoint holds {parked} events parked in the "
                  "pressure reservoir but this run has no controller to "
                  "re-seat them; resume with --overflow spill (or grow)",
                  file=sys.stderr)
            return 2
        if meta.get("seed") is not None and meta["seed"] != args.seed:
            print(f"error: checkpoint was written with --seed {meta['seed']}"
                  f" but this run uses --seed {args.seed}; resume would not "
                  "be bit-exact", file=sys.stderr)
            return 2
        if meta.get("config_digest") not in (None, cfg_digest):
            print("error: checkpoint config digest "
                  f"{meta['config_digest']} != this build's {cfg_digest}; "
                  "it was written from a different config", file=sys.stderr)
            return 2
        sim_s = float(int(st.now)) / SECOND
        print(f"resumed from {resume_name} at sim time {sim_s:.3f}s "
              f"(meta: {meta})", file=sys.stderr)
    stop_s = cfg.stoptime
    # independent sim-time cadences; the run loop steps to whichever event
    # (heartbeat print, checkpoint write, stoptime) comes next. Cadences
    # are absolute interval multiples, so an interrupted+resumed run emits
    # heartbeats/checkpoints at the same sim times as an uninterrupted one
    hb = args.heartbeat_frequency
    ck = args.checkpoint_interval
    next_hb = (math.floor(sim_s / hb) + 1) * hb if hb > 0 else float("inf")
    next_ckpt = (math.floor(sim_s / ck) + 1) * ck if ck > 0 else float("inf")

    # -- live telemetry plane: flight recorder (always on), /healthz
    # state machine, and under --metrics the registry the harvest
    # bundle populates and the tracker's [metrics] row reads
    from shadow_tpu_torch.obs.metrics import (
        FlightRecorder,
        HealthState,
        MetricsRegistry,
    )

    metrics_on = args.metrics or args.metrics_port is not None
    recorder = FlightRecorder()
    health = HealthState()
    _retry_attempt = os.environ.get("SHADOW_TPU_RETRY_ATTEMPT")
    if _retry_attempt:
        # a relaunched child reports degraded while it makes progress
        health.relaunch(int(_retry_attempt))
    registry = None
    if metrics_on:
        registry = MetricsRegistry(version=__version__,
                                   n_shards=args.mesh or 1)
    server = None
    if args.metrics_port is not None and (mesh is None or mesh.rank == 0):
        from shadow_tpu_torch.obs.server import MetricsServer

        try:
            server = MetricsServer(registry, health, recorder,
                                   port=args.metrics_port).start()
        except OSError as e:
            print(f"error: --metrics-port {args.metrics_port}: {e}",
                  file=sys.stderr)
            return 2

    def _close_metrics():
        # SHADOW_TPU_METRICS_LINGER_S keeps the endpoints up briefly
        # after the summary line for a final reconciliation scrape
        if server is None:
            return
        linger_s = float(
            os.environ.get("SHADOW_TPU_METRICS_LINGER_S") or 0)
        if linger_s > 0:
            time.sleep(linger_s)
        server.close()

    logger, tracker = _make_observability(cfg, sim, args, trace=tdrain,
                                          metrics=registry)
    drain = None
    if sim.pcap_gids:
        from shadow_tpu_torch.utils.pcap import CaptureDrain

        # rank 0 writes the files; another rank's drain is inert (its
        # rows reach rank 0 through the harvest's gather)
        gids = sim.pcap_gids if mesh is None or mesh.rank == 0 else ()
        drain = CaptureDrain(
            [sim.names[g] for g in gids], gids, sim.pcap_dir, dns=sim.dns,
        )
        print(f"pcap capture: {len(sim.pcap_gids)} hosts -> {sim.pcap_dir}/",
              file=sys.stderr)
    from shadow_tpu_torch.runtime.harvest import (
        HeartbeatHarvest,
        fetch_global,
        fetch_tree,
        fill_refs,
        reduce_tree,
    )
    from shadow_tpu_torch.runtime.invariants import (
        InvariantViolation,
        validate,
    )
    from shadow_tpu_torch.runtime.pressure import (
        QueuePressureError,
        pressure_bundle,
    )
    from shadow_tpu_torch.runtime.supervisor import (
        EXIT_INVARIANT,
        EXIT_PEER_LOST,
        EXIT_PRESSURE,
        Supervisor,
        Watchdog,
        write_diagnostic_bundle,
    )
    from shadow_tpu_torch.utils.checkpoint import (
        save_checkpoint,
        transfer_state,
    )
    from shadow_tpu_torch.utils.tracker import SupervisorHeartbeat

    sup = Supervisor(
        watchdog_timeout=args.watchdog, diag_dir=args.diag_dir,
        label="shadow_tpu_torch",
        info=lambda: {"tier": "device",
                      "checkpoint_path": args.checkpoint_path,
                      "config_digest": cfg_digest,
                      "flight_recorder": recorder.snapshot()},
    )
    sup_hb = SupervisorHeartbeat(logger, watchdog=sup.watchdog)

    # --collective-timeout: the second deadline (exit 77, not 75), petted
    # by every completed collective and segment: a rank whose collective
    # never completes (a dead peer) writes a bundle naming every shard's
    # hosts and device, then exits 77. A collective that fails outright
    # waits for it (Comm.hold_on_failure), as a wedged one would.
    cwd = None
    last_summary: dict = {}
    if args.collective_timeout > 0:
        n_shards = args.mesh or 1
        per = len(sim.names) // n_shards

        def _peer_info():
            return {
                "tier": "device",
                "mesh_shards": n_shards,
                "dcn_slices": args.dcn_slices,
                "per_shard_hosts": per,
                "rank": mesh.rank if mesh is not None else 0,
                "backend": mesh.backend if mesh is not None else None,
                # each rank knows its own device only
                "shards": [
                    {"shard": r, "hosts": [r * per, (r + 1) * per],
                     "device": (str(dev) if mesh is None or r == mesh.rank
                                else None)}
                    for r in range(n_shards)],
                "checkpoint_path": args.checkpoint_path,
                "config_digest": cfg_digest,
                "last_summary": dict(last_summary),
                "flight_recorder": recorder.snapshot(),
            }

        cwd = Watchdog(args.collective_timeout, diag_dir=args.diag_dir,
                       label="shadow_tpu_torch", kind="peerlost",
                       exit_code=EXIT_PEER_LOST, info=_peer_info,
                       compile_grace=True)
    cwd_armed = False

    # chaos injector (the tests): wedge the next harvest fetch for N
    # seconds once the collective deadline is armed, which is what a
    # lost peer's never-completing collective looks like from here. A
    # marker file beside the checkpoint makes it one-shot across --retry
    # relaunches and, under --mesh, picks the one rank that wedges.
    _chaos_hang_s = float(os.environ.get("SHADOW_TPU_CHAOS_HANG_S") or 0)
    if _chaos_hang_s > 0:
        try:
            os.close(os.open(args.checkpoint_path + ".chaos",
                             os.O_CREAT | os.O_EXCL | os.O_WRONLY))
        except FileExistsError:
            _chaos_hang_s = 0.0

    def _agree(flag: bool) -> bool:
        """A host decision every rank takes together (a signal reaches
        the ranks at different segments): true when any rank's is."""
        if mesh is None:
            return flag
        import torch

        return bool(mesh.comm.gany(torch.tensor(
            bool(flag), device=mesh.device)))

    # --window: a fixed width in ms, or the adaptive controller's
    wctl = None
    window_fixed_ns = None
    if args.window is not None:
        if sim.pressure is not None:
            print("error: --window needs --overflow drop or strict (the "
                  "spill reservoir's boundary harvest steps the static "
                  "window)", file=sys.stderr)
            return 2
        if args.window == "auto":
            from shadow_tpu_torch.runtime.adaptive import WindowController

            wctl = WindowController(
                sim.engine.cfg.lookahead, n_hosts=len(sim.names)
            )
        else:
            try:
                window_fixed_ns = int(float(args.window) * MILLISECOND)
            except ValueError:
                print(f"error: --window must be a width in ms or 'auto', "
                      f"got {args.window!r}", file=sys.stderr)
                return 2
            if window_fixed_ns < sim.engine.cfg.lookahead:
                print(f"error: --window {args.window} is narrower than "
                      f"the conservative lookahead "
                      f"({sim.engine.cfg.lookahead} ns); it would only "
                      "add barriers", file=sys.stderr)
                return 2

    # one device-to-host copy per segment boundary; the host-side half
    # of a heartbeat runs after the next segment is dispatched
    harvest = HeartbeatHarvest(sim, tracker=tracker, tdrain=tdrain,
                               pcap=drain, metrics=registry)
    pending_hb = None  # (fetched bundle, sim_ns, summary) to consume

    def consume_hb():
        nonlocal pending_hb
        if pending_hb is None:
            return
        fetched, hb_ns, hb_summary = pending_hb
        pending_hb = None
        with _phase("drain"):
            harvest.consume(fetched, hb_ns)
            sup_hb.beat(hb_ns, hb_summary)
            logger.flush()

    def write_checkpoint(path=None, **extra_meta):
        # emergency checkpoints go to an explicit side path, NOT into
        # the rotation: a crashing run must never push the last known
        # good generation off the retention horizon
        with _phase("checkpoint"):
            save_checkpoint(
                path or args.checkpoint_path, st,
                meta={"sim_seconds": sim_s, "seed": args.seed,
                      "config_digest": cfg_digest, **extra_meta},
                keep=1 if path else args.checkpoint_keep,
                extra=(sim.pressure.serialize()
                       if sim.pressure is not None else None),
                mesh_info=sim.mesh_info(), mesh=mesh,
            )
        sup_hb.checkpoint_written()
        if cwd_armed:
            # checkpoint IO is a legitimate pause
            cwd.pet(site="checkpoint")
        recorder.record_event("checkpoint", sim_seconds=sim_s,
                              path=path or args.checkpoint_path)

    last_validated_windows = 0
    prev_validated_now = None
    prev_validated_drops = None
    segments, harvest_s, syncs_done = 0, 0.0, 0
    windows_run, widths = 0, set()
    syncs0 = sim.engine.host_syncs
    stopped = False
    t1 = time.perf_counter()
    try:
        with sup:
            while sim_s < stop_s:
                if xprof_span is not None and not xprof_done:
                    # the span's edges are segment boundaries (joined
                    # into `nxt` below): the capture brackets whole
                    # segments
                    if xprof is not None and sim_s >= xprof_span[1]:
                        xprof.stop()
                        xprof, xprof_done = None, True
                        recorder.record_event("xprof-stop",
                                              sim_seconds=sim_s)
                        print(f"xprof: capture stopped at sim "
                              f"{sim_s:.3f}s -> {args.xprof_dir}",
                              file=sys.stderr)
                    elif xprof is None and sim_s >= xprof_span[0]:
                        from shadow_tpu_torch.obs.profiler import DeviceTrace

                        xprof = DeviceTrace(args.xprof_dir, dev)
                        recorder.record_event("xprof-start",
                                              sim_seconds=sim_s,
                                              dir=args.xprof_dir)
                        print(f"xprof: capturing device trace from sim "
                              f"{sim_s:.3f}s -> {args.xprof_dir}",
                              file=sys.stderr)
                nxt = min(next_hb, next_ckpt, stop_s)
                if xprof_span is not None and not xprof_done:
                    edge = (xprof_span[1] if xprof is not None
                            else xprof_span[0])
                    if edge > sim_s:
                        nxt = min(nxt, edge)
                stop_i = int(nxt * SECOND)
                full_hb = nxt >= next_hb
                # -- advance to `nxt`: pressure modes step window by
                # window with the reservoir's boundary refills
                if sim.pressure is not None:
                    st = sim.run(stop_i, state=st)
                elif wctl is not None or window_fixed_ns is not None:
                    # one window per dispatch and one read per window; in
                    # auto mode the read also feeds the controller
                    while True:
                        w = (wctl.window_ns if wctl is not None
                             else window_fixed_ns)
                        widths.add(w)
                        with _phase("step"):
                            st = sim.dispatch(stop_i, st, window_ns=w)
                        windows_run += 1
                        sim.engine.host_syncs += 1
                        if wctl is not None:
                            got = fetch_global({
                                "now_ns": st.now,
                                "executed": st.stats.n_executed.sum(),
                                "drops": st.queues.drops.sum(),
                                **fill_refs(st.queues, mesh)}, mesh)
                            wctl.update(int(got["executed"]),
                                        int(got["drops"]),
                                        float(got["fill"]))
                            now_i = int(got["now_ns"])
                        else:
                            now_i = int(st.now)
                        if now_i >= stop_i:
                            break
                else:
                    st = sim.dispatch(stop_i, st)
                t_h = time.perf_counter()
                st, bundle = harvest.extract(st, full=full_hb)
                t_c = time.perf_counter()
                consume_hb()
                t_f = time.perf_counter()
                if _chaos_hang_s > 0 and (cwd is None or cwd_armed):
                    _hang, _chaos_hang_s = _chaos_hang_s, 0.0
                    print(f"shadow_tpu_torch: CHAOS: wedging the harvest "
                          f"fetch for {_hang:.1f}s", file=sys.stderr,
                          flush=True)
                    time.sleep(_hang)
                with _phase("step"):
                    fetched = harvest.fetch(bundle)
                harvest_s += (t_c - t_h) + (time.perf_counter() - t_f)
                segments += 1
                sim_s = nxt
                if cwd is not None:
                    if cwd_armed:
                        cwd.pet(site="harvest.fetch", sim_seconds=sim_s)
                    else:
                        # armed after the first segment, as the reference's
                        cwd.start()
                        cwd_armed = True
                        if mesh is not None:
                            mesh.comm.pet = cwd.pet
                            mesh.comm.hold_on_failure = True
                if sim.pressure is not None and sim.pressure.grow_wanted:
                    # --overflow grow: rebuild the engine at doubled
                    # capacity, carry the live state across, keep the
                    # SAME controller (reservoir and counters survive; the
                    # tracker holds it), then refill into the new room
                    ctrl = sim.pressure
                    new_cap = sim.engine.cfg.capacity * 2
                    print(f"shadow_tpu_torch: queue pressure under "
                          f"--overflow grow: re-templating at --capacity "
                          f"{new_cap} (sim {sim_s:.3f}s)", file=sys.stderr)
                    syncs_done += sim.engine.host_syncs - syncs0
                    with _phase("build"):
                        sim = _build(new_cap)
                    syncs0 = sim.engine.host_syncs
                    st = transfer_state(st, sim.state0)
                    ctrl.capacity = new_cap
                    ctrl.grow_wanted = False
                    sim.pressure = ctrl
                    st = ctrl.boundary(st, read=sim.engine._read)
                    harvest.rebind(sim)
                    summary_now = sim.summary(st)
                    recorder.record_event("grow-retemplate",
                                          sim_seconds=sim_s,
                                          capacity=new_cap)
                    # the bundle predates the re-template: take the
                    # telemetry extras once more from the new state
                    if metrics_on:
                        sim.engine.host_syncs += 1
                        metrics_extras = fetch_tree(sim.metrics_refs(st))
                    else:
                        metrics_extras = None
                else:
                    summary_now = harvest.summary_from(fetched)
                    last_summary = dict(summary_now)
                    metrics_extras = fetched.get("metrics")
                    if sim.pressure is None:
                        # run()'s loud-overflow probe, from the bundle
                        sim.check_drops(summary_now["queue_drops"],
                                        summary_now)
                # the stall margin BEFORE the pet resets the deadline
                stall_margin = (sup.watchdog.margin_s()
                                if sup.watchdog is not None else None)
                sup.pet(sim_seconds=sim_s, **summary_now)
                sup_hb.observe_margin()
                recorder.record_heartbeat(int(sim_s * SECOND), summary_now)
                if stall_margin is not None and health.observe_margin(
                        stall_margin, args.watchdog):
                    recorder.record_event(
                        "watchdog-near-miss", sim_seconds=sim_s,
                        margin_s=round(stall_margin, 3))
                if health.code() == 0 and (
                        summary_now.get("spilled", 0)
                        or summary_now.get("queue_drops", 0)):
                    health.pressure_event()
                    recorder.record_event(
                        "pressure", sim_seconds=sim_s,
                        spilled=int(summary_now.get("spilled", 0)),
                        queue_drops=int(
                            summary_now.get("queue_drops", 0)))
                if metrics_on:
                    registry.ingest(summary_now, extras=metrics_extras,
                                    fill=float(fetched["fill"]))
                    if "stats" in fetched:
                        registry.ingest_stats(fetched["stats"])
                    registry.observe(
                        watchdog_margin_s=stall_margin,
                        checkpoints=sup_hb.checkpoints_written,
                        health=health, profiler=prof)
                if args.validate > 0 and (
                    summary_now["windows"] - last_validated_windows
                    >= args.validate
                ):
                    prev_validated_now = validate(
                        st, prev_now=prev_validated_now,
                        prev_drops=prev_validated_drops,
                        pressure=sim.pressure,
                    )
                    prev_validated_drops = st.queues.drops.cpu().numpy()
                    last_validated_windows = summary_now["windows"]
                if prof is not None:
                    prof.observe(
                        summary_now, queue_fill=float(fetched["fill"]),
                        stall_margin_s=(
                            sup.watchdog.margin_s()
                            if sup.watchdog is not None else None
                        ),
                    )
                if full_hb:
                    # the host-side half (trace decode, the tracker's
                    # rows) runs after the next segment is dispatched;
                    # the extraction already reset the trace ring
                    pending_hb = (fetched, int(sim_s * SECOND), summary_now)
                    next_hb += hb
                if _agree(sup.take_checkpoint_request()):  # SIGUSR1
                    write_checkpoint(on_demand=True)
                    print("checkpoint written on SIGUSR1 -> "
                          f"{args.checkpoint_path} (sim {sim_s:.3f}s)",
                          file=sys.stderr)
                if _agree(sup.stop_requested):
                    stopped = True
                    # graceful shutdown: checkpoint regardless of
                    # --checkpoint-interval, then exit 128+signum
                    write_checkpoint(interrupted=sup.stop_signum)
                    break
                if sim_s >= next_ckpt:
                    write_checkpoint()
                    next_ckpt += ck
            # the final segment's heartbeat has no next dispatch to
            # overlap with; consume it before the summary
            consume_hb()
    except InvariantViolation as e:
        # deliberately NO checkpoint: the state just failed its own
        # consistency checks; a bundle with the flight recorder instead
        health.fail(EXIT_INVARIANT)
        path = write_diagnostic_bundle(
            args.diag_dir, "shadow_tpu_torch", "invariant",
            {"reason": str(e), "sim_seconds": sim_s,
             "exit_code": EXIT_INVARIANT,
             "flight_recorder": recorder.snapshot()},
        )
        print(f"shadow_tpu_torch: INVARIANT VIOLATION at sim {sim_s:.3f}s"
              f"\n{e}\ndiagnostic bundle -> {path}", file=sys.stderr)
        _close_metrics()
        return EXIT_INVARIANT
    except QueuePressureError as e:
        # --overflow strict: nothing was lost (the run stopped at the
        # first would-be drop), but the no-loss contract is broken
        health.fail(EXIT_PRESSURE)
        path = pressure_bundle(e, diag_dir=args.diag_dir,
                               label="shadow_tpu_torch",
                               extra={"flight_recorder":
                                      recorder.snapshot()})
        print(f"shadow_tpu_torch: QUEUE PRESSURE at sim {sim_s:.3f}s under "
              f"--overflow strict: {e}\ndiagnostic bundle -> {path}",
              file=sys.stderr)
        _close_metrics()
        return EXIT_PRESSURE
    except BaseException as e:
        # unhandled run-loop failure: best-effort emergency checkpoint of
        # the last completed segment, then re-raise
        try:
            epath = args.checkpoint_path + ".emergency"
            write_checkpoint(path=epath, emergency=repr(e)[:200])
            print(f"emergency checkpoint -> {epath} (sim {sim_s:.3f}s)",
                  file=sys.stderr)
        except Exception as e2:
            print(f"emergency checkpoint failed: {e2!r}", file=sys.stderr)
        raise
    finally:
        # interrupted and failed runs keep their observability output:
        # the partial device capture, every pcap file up to the last
        # drain; a deferred heartbeat holds drained trace records whose
        # ring was already reset, so consume it before the trace file
        if xprof is not None:
            try:
                xprof.stop()
            except Exception:
                pass
            xprof = None
        try:
            consume_hb()
        except Exception:
            pass
        logger.flush()
        if drain is not None:
            try:
                if mesh is None:
                    drain.drain(st.hosts.net.cap)
                else:
                    from shadow_tpu_torch.utils.pcap import CaptureDrain

                    got = reduce_tree({"pcap": CaptureDrain.gather(
                        st.hosts.net.cap)}, mesh)
                    if "pcap" in got:
                        drain.ingest(got["pcap"])
            except Exception:
                pass
            drain.close()
            if drain.lost:
                print(f"pcap: {drain.lost} records lost to ring overrun "
                      "(raise --heartbeat-frequency cadence)",
                      file=sys.stderr)
        if tdrain is not None:
            try:
                if mesh is None:
                    st = tdrain.drain_state(st)
                elif st.trace is not None:
                    from shadow_tpu_torch.obs.trace import (
                        TraceDrain,
                        reset_ring,
                    )

                    got = reduce_tree({"trace": TraceDrain.gather(
                        st.trace)}, mesh)
                    if "trace" in got:
                        tdrain.ingest(got["trace"])
                    st = dataclasses.replace(st, trace=reset_ring(st.trace))
            except Exception:
                pass
            if mesh is None or mesh.rank == 0:
                tdrain.save(
                    args.trace_out,
                    profile=prof.export() if prof is not None else None,
                    extra_meta={
                        "seed": args.seed, "tier": "device",
                        # the exported trace names the device capture
                        **({"xprof_dir": args.xprof_dir}
                           if xprof_span is not None else {}),
                    },
                )
            print(f"event trace: {tdrain.n_records} records -> "
                  f"{args.trace_out}"
                  + (f" ({tdrain.lost} lost to ring overrun; raise "
                     "--trace N or the heartbeat cadence)"
                     if tdrain.lost else ""),
                  file=sys.stderr)
    wall = time.perf_counter() - t1
    if cwd_armed:
        cwd.stop()
    if stopped:
        print(f"interrupted by signal {sup.stop_signum}: checkpoint at "
              f"{args.checkpoint_path} (sim {sim_s:.3f}s of {stop_s:.0f}s); "
              "resume with --resume auto", file=sys.stderr)
        _close_metrics()
        return sup.exit_code()

    stats = st.stats
    refs = {
        "events": stats.n_executed.sum(),
        "windows": stats.n_windows,
        "net_dropped": stats.n_net_dropped.sum(),
        "queue_drops": st.queues.drops.sum(),
        "fault_dropped": stats.n_fault_dropped.sum(),
        "quarantined_events": stats.n_quarantined.sum(),
        "sweeps": stats.n_sweeps,
        "cross_shard_packets": stats.n_cross_shard,
        "rx_bytes": st.hosts.net.sockets.rx_bytes.sum(),
        "tx_bytes": st.hosts.net.sockets.tx_bytes.sum(),
        "by_kind": stats.n_by_kind.sum(dim=0),
    }
    if st.splane is not None:
        from shadow_tpu_torch.obs.stats import stats_device_refs

        refs["stats"] = stats_device_refs(st.splane)
    if run_info is not None and mesh is not None:
        # every rank's kernel launches (they launch in their own
        # processes), summed: what the caller cannot count itself
        import torch

        from shadow_tpu_torch.core import merge as kmerge
        from shadow_tpu_torch.transport import cbrt as kcbrt

        counts = mesh.comm.gsum(torch.tensor(
            [kmerge.launches, kcbrt.launches], device=mesh.device)).tolist()
        run_info["kernel_launches"] = dict(zip(("merge", "cbrt"), counts))
    if run_info is not None:
        run_info.update(
            segments=segments, harvest_reads=harvest.host_syncs,
            harvest_s=harvest_s, loop_s=wall,
            host_syncs=syncs_done + sim.engine.host_syncs - syncs0,
            windows_run=windows_run, widths=sorted(widths),
            drain_s=drain.host_s if drain is not None else 0.0,
            collectives=mesh.comm.calls if mesh is not None else 0,
            backend=mesh.backend if mesh is not None else None)
    got = harvest.fetch(refs)
    executed = int(got["events"])
    summary = {
        "hosts": n_hosts,
        "sim_seconds": stop_s,
        "wall_seconds": round(wall, 3),
        "build_seconds": round(t1 - t0, 3),
        "events": executed,
        "windows": int(got["windows"]),
        "events_per_sec": round(executed / max(wall, 1e-9), 1),
        "sim_s_per_wall_s": round(stop_s / max(wall, 1e-9), 3),
        "net_dropped": int(got["net_dropped"]),
        "queue_drops": int(got["queue_drops"]),
        "fault_dropped": int(got["fault_dropped"]),
        "quarantined_events": int(got["quarantined_events"]),
        # scheduler self-profiling (scheduler.c:266-271 analog)
        "sweeps": int(got["sweeps"]),
        "cross_shard_packets": int(got["cross_shard_packets"]),
        "rx_bytes": int(got["rx_bytes"]),
        "tx_bytes": int(got["tx_bytes"]),
        # the reference's ObjectCounter shutdown report
        # (object_counter.c; slave.c:237-241)
        "events_by_kind": {
            name: int(n) for name, n in zip(sim.kind_names, got["by_kind"])
        },
    }
    if sim.pressure is not None:
        summary["pressure"] = sim.pressure.snapshot(st)
        summary["capacity"] = int(sim.engine.cfg.capacity)
    if drain is not None:
        # records per lifecycle stage over the capture rings
        summary["packet_stages"] = {
            k: v for k, v in drain.stage_counts.items() if v
        }
    if tdrain is not None:
        summary["trace"] = {
            "records": tdrain.n_records, "lost": tdrain.lost,
            "truncated": tdrain.truncated, "file": args.trace_out,
        }
    if prof is not None:
        summary["profile"] = prof.summary()
    if "stats" in got:
        from shadow_tpu_torch.obs.stats import FAMILY_KEYS, summarize

        final_stats = summarize(got["stats"])
        summary["stats"] = {
            k: {"count": final_stats[k]["count"],
                "sum": final_stats[k]["sum"],
                "p50": final_stats[k]["p50"],
                "p95": final_stats[k]["p95"]}
            for k in FAMILY_KEYS
        }
        if metrics_on:
            # align the last scrape's histogram families with the
            # printed totals, like registry.finalize below
            registry.ingest_stats(got["stats"])
    if xprof_span is not None:
        summary["xprof"] = {"dir": args.xprof_dir,
                            "start": xprof_span[0],
                            "stop": xprof_span[1],
                            "completed": xprof_done}
    if metrics_on:
        # align the registry with the printed totals, so the last scrape
        # reconciles exactly
        registry.finalize(summary)
        registry.observe(checkpoints=sup_hb.checkpoints_written,
                         health=health, profiler=prof)
    print(json.dumps(summary), flush=True)
    _close_metrics()
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
