"""Export a shadow_tpu_torch event trace to Chrome trace-event JSON.

The port's copy of `shadow_tpu.tools.export_trace`: it reads the .npz
that `obs.trace.TraceDrain.save` writes and emits the Trace Event Format
that Perfetto (ui.perfetto.dev) and chrome://tracing load, byte for byte
what the reference's exporter writes for the same records:

- **pid 0 "sim time"**: one thread track per host (tid = gid, named by
  host name). Every trace record becomes an instant event at its
  simulated time; send->receive deliveries are joined with flow arrows
  ("s" on the OP_SEND record at the source, "f" on the matching OP_EXEC
  record at the destination, id = src<<32 | seq).
- **pid 1 "wall clock"**: one thread track per run-loop phase, "X"
  complete-spans from a WindowProfiler's export, relative to its start.

`--serve-ledger LEDGER.jsonl` merges a serving-plane flight ledger
(`obs/servetrace.py`) into the same file, alone or beside a device .npz:

- **pid 2 "serve wall"**: one thread track per request (submit /
  queue_wait / pack_wait / result) and one per launch (cache / pack /
  beat / snapshot / confirm), "X" spans on the tracer's wall clock;
  retry/resume/bisect/chaos/deadline records render as instants.
- **pid 3 "serve lanes (sim time)"**: one thread track per fleet lane;
  each beat's harvested per-lane progress becomes an instant at its SIM
  time, joined to the beat span that harvested it by a flow arrow.

Timestamps are microseconds: sim nanoseconds / 1e3, wall seconds * 1e6.
Records arrive sorted by (time, src, seq, op, dst) and keys are emitted
in a fixed order, so repeat-run exports diff byte for byte.

    python -m shadow_tpu_torch.tools.export_trace run.npz -o run.trace.json
    python -m shadow_tpu_torch.tools.export_trace --serve-ledger led.jsonl \
        -o serve.trace.json
"""

from __future__ import annotations

import argparse
import json
import sys

from shadow_tpu_torch.obs.trace import OP_EXEC, OP_SEND


def _meta_event(pid: int, tid: int, what: str, name: str) -> dict:
    return {"ph": "M", "pid": pid, "tid": tid, "name": what,
            "args": {"name": name}}


def build_events(recs: dict, meta: dict) -> list[dict]:
    """Pure transform: (records, meta) -> Chrome trace event list."""
    names = meta.get("names") or []
    kind_names = meta.get("kind_names") or []
    op_names = meta.get("op_names") or ["exec", "send", "drop", "fault_drop"]
    host = lambda g: names[g] if 0 <= g < len(names) else f"host{g}"
    kind = lambda k: (
        kind_names[k] if 0 <= k < len(kind_names) else f"kind{k}"
    )

    events: list[dict] = [
        _meta_event(0, 0, "process_name", "sim time"),
        _meta_event(1, 0, "process_name", "wall clock"),
    ]
    n = int(recs["time"].shape[0])
    owners = sorted({int(o) for o in recs["owner"][:n]})
    for g in owners:
        events.append(_meta_event(0, g, "thread_name", host(g)))

    # flow targets: the OP_EXEC record of a delivered send lives on the
    # destination host and keeps the sender's (src, seq) identity
    exec_at: dict[tuple[int, int, int], int] = {}
    for i in range(n):
        if int(recs["op"][i]) == OP_EXEC:
            key = (int(recs["src"][i]), int(recs["seq"][i]),
                   int(recs["owner"][i]))
            exec_at.setdefault(key, i)

    def row(i: int) -> dict:
        return {
            "time": int(recs["time"][i]), "src": int(recs["src"][i]),
            "dst": int(recs["dst"][i]), "kind": int(recs["kind"][i]),
            "plen": int(recs["plen"][i]), "seq": int(recs["seq"][i]),
            "op": int(recs["op"][i]), "owner": int(recs["owner"][i]),
        }

    flows = 0
    for i in range(n):
        r = row(i)
        ts = r["time"] / 1e3  # ns -> us
        op = r["op"]
        label = (
            kind(r["kind"]) if op == OP_EXEC
            else f"{op_names[op] if op < len(op_names) else op}:"
                 f"{kind(r['kind'])}"
        )
        ev = {
            "ph": "i", "pid": 0, "tid": r["owner"], "ts": ts,
            "name": label, "s": "t",
            "args": {"src": host(r["src"]), "dst": host(r["dst"]),
                     "seq": r["seq"], "plen": r["plen"],
                     "op": op_names[op] if op < len(op_names) else str(op)},
        }
        events.append(ev)
        if op == OP_SEND:
            j = exec_at.get((r["src"], r["seq"], r["dst"]))
            if j is None:
                continue  # in flight past stoptime, or exec record lost
            fid = (r["src"] << 32) | r["seq"]
            deliver = f"deliver:{kind(r['kind'])}"
            events.append({
                "ph": "s", "pid": 0, "tid": r["owner"], "ts": ts,
                "id": fid, "name": deliver, "cat": "net",
            })
            events.append({
                "ph": "f", "pid": 0, "tid": int(recs["owner"][j]),
                "ts": int(recs["time"][j]) / 1e3, "id": fid,
                "name": deliver, "cat": "net", "bp": "e",
            })
            flows += 1

    profile = meta.get("profile") or {}
    spans = profile.get("spans") or []
    phase_tid = {}
    for name, start, dur in spans:
        if name not in phase_tid:
            phase_tid[name] = len(phase_tid)
            events.append(
                _meta_event(1, phase_tid[name], "thread_name", name)
            )
        events.append({
            "ph": "X", "pid": 1, "tid": phase_tid[name],
            "ts": float(start) * 1e6, "dur": float(dur) * 1e6,
            "name": name, "cat": "phase",
        })
    return events


# serve-ledger span names that live on a LAUNCH track; everything else
# with a rid lands on that request's track
_LAUNCH_SPANS = ("cache", "pack", "beat", "snapshot", "confirm")
_SERVE_PID = 2  # wall-time serve spans
_LANE_PID = 3  # per-lane sim-time beat progress


def build_serve_events(records: list[dict]) -> list[dict]:
    """Pure transform: flight-ledger records -> Chrome trace events
    (pids 2 and 3; composes with `build_events`' pids 0 and 1).
    Deterministic: tracks are keyed by sorted rid / launch id, events
    follow ledger order, flow ids derive from (launch, beat, lane)."""
    spans = [r for r in records if r.get("kind") in ("span", "event")]
    if not spans:
        return []
    base = min(r.get("t_s", 0.0) for r in spans)
    rids = sorted({r["rid"] for r in spans if "rid" in r}
                  | {x for r in spans for x in r.get("rids", ())})
    launches = sorted({int(r["launch"]) for r in spans
                       if "launch" in r})
    rid_tid = {rid: i for i, rid in enumerate(rids)}
    # launch tracks sit above the request tracks; lane tracks are tiny
    launch_tid = {n: 1000 + n for n in launches}

    events: list[dict] = [
        _meta_event(_SERVE_PID, 0, "process_name", "serve wall"),
        _meta_event(_LANE_PID, 0, "process_name",
                    "serve lanes (sim time)"),
    ]
    for rid in rids:
        events.append(_meta_event(_SERVE_PID, rid_tid[rid],
                                  "thread_name", f"req {rid}"))
    for n in launches:
        events.append(_meta_event(_SERVE_PID, launch_tid[n],
                                  "thread_name", f"launch {n}"))
    lanes_seen: set[int] = set()

    def wall_us(t_s: float) -> float:
        return round((t_s - base) * 1e6, 3)

    for r in spans:
        name = r["name"]
        launch = r.get("launch")
        if name in _LAUNCH_SPANS and launch is not None:
            tid = launch_tid[int(launch)]
        elif r.get("rid") in rid_tid:
            tid = rid_tid[r["rid"]]
        elif launch is not None:
            tid = launch_tid[int(launch)]
        elif r.get("rids"):
            tid = rid_tid[r["rids"][0]]
        else:
            tid = 999  # service-scoped (e.g. chaos) — its own track
        args = {k: v for k, v in sorted(r.items())
                if k not in ("kind", "name", "t_s", "dur_s", "lanes")}
        if r["kind"] == "span" and r.get("dur_s", 0.0) > 0.0:
            events.append({
                "ph": "X", "pid": _SERVE_PID, "tid": tid,
                "ts": wall_us(r["t_s"]), "dur": round(r["dur_s"] * 1e6,
                                                      3),
                "name": name, "cat": "serve", "args": args,
            })
        else:
            events.append({
                "ph": "i", "pid": _SERVE_PID, "tid": tid,
                "ts": wall_us(r["t_s"]), "name": name, "s": "t",
                "cat": "serve", "args": args,
            })
        if name == "beat" and launch is not None:
            beat = int(r.get("beat", 0))
            t_end = wall_us(r["t_s"] + r.get("dur_s", 0.0))
            for entry in r.get("lanes", ()):
                lane = int(entry.get("lane", 0))
                if lane not in lanes_seen:
                    lanes_seen.add(lane)
                    events.append(_meta_event(
                        _LANE_PID, lane, "thread_name", f"lane {lane}"))
                # the harvested lane record at its SIM time, joined to
                # the harvesting beat span by a wall->sim flow arrow
                fid = ((int(launch) * 4096 + beat) * 256) + lane
                events.append({
                    "ph": "i", "pid": _LANE_PID, "tid": lane,
                    "ts": int(entry.get("now_ns", 0)) / 1e3,
                    "name": f"beat {beat}", "s": "t", "cat": "serve",
                    "args": {"rid": entry.get("rid"),
                             "launch": int(launch),
                             "now_ns": int(entry.get("now_ns", 0))},
                })
                events.append({
                    "ph": "s", "pid": _SERVE_PID,
                    "tid": launch_tid[int(launch)], "ts": t_end,
                    "id": fid, "name": "harvest", "cat": "serve-flow",
                })
                events.append({
                    "ph": "f", "pid": _LANE_PID, "tid": lane,
                    "ts": int(entry.get("now_ns", 0)) / 1e3, "id": fid,
                    "name": "harvest", "cat": "serve-flow", "bp": "e",
                })
    return events


def export(in_path: str | None, out_path: str,
           ledger_path: str | None = None) -> dict:
    """Convert one .npz trace file and/or one serve flight ledger;
    returns stats for the caller."""
    events: list[dict] = []
    meta: dict = {}
    n_serve = 0
    if in_path is not None:
        from shadow_tpu_torch.obs.trace import load_trace

        recs, meta = load_trace(in_path)
        events += build_events(recs, meta)
    if ledger_path is not None:
        from shadow_tpu_torch.obs.servetrace import load_ledger

        _, records = load_ledger(ledger_path)
        serve_events = build_serve_events(records)
        events += serve_events
        n_serve = len(records)
    doc = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            k: meta.get(k)
            for k in ("n_records", "lost", "truncated", "seed", "tier",
                      "xprof_dir")
            if k in meta
        },
    }
    if ledger_path is not None:
        doc["otherData"]["serve_ledger"] = ledger_path
    with open(out_path, "w") as f:
        json.dump(doc, f, separators=(",", ":"), sort_keys=True)
        f.write("\n")
    n_flows = sum(1 for e in events if e.get("ph") == "s")
    return {"events": len(events), "flows": n_flows,
            "records": meta.get("n_records", 0),
            "serve_records": n_serve, "out": out_path,
            "xprof_dir": meta.get("xprof_dir")}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="export_trace",
        description="shadow_tpu_torch trace .npz -> Chrome trace-event JSON "
                    "(load in ui.perfetto.dev or chrome://tracing)",
    )
    p.add_argument("trace", nargs="?", default=None,
                   help=".npz written by TraceDrain.save (optional "
                        "when --serve-ledger is given)")
    p.add_argument("--serve-ledger", default=None, metavar="JSONL",
                   help="serve-plane flight ledger (--ledger-file) to "
                        "merge as wall-time span tracks + per-lane "
                        "sim-time records (docs/18-Serve-Tracing.md)")
    p.add_argument("-o", "--out", default=None,
                   help="output JSON path (default: <trace>.json)")
    args = p.parse_args(argv)
    if args.trace is None and args.serve_ledger is None:
        p.error("need a trace .npz, a --serve-ledger, or both")
    src = args.trace or args.serve_ledger
    out = args.out or (
        src[:-4] + ".json" if src.endswith(".npz") else src + ".json"
    )
    stats = export(args.trace, out, ledger_path=args.serve_ledger)
    print(f"wrote {stats['events']} trace events "
          f"({stats['records']} records, {stats['serve_records']} "
          f"serve records, {stats['flows']} flow pairs) "
          f"-> {out}", file=sys.stderr)
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
