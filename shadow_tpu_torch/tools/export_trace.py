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

The reference's serve-ledger input (pids 2 and 3) needs the serving
plane, which is not ported: `--serve-ledger` raises NotImplementedError.

Timestamps are microseconds: sim nanoseconds / 1e3, wall seconds * 1e6.
Records arrive sorted by (time, src, seq, op, dst) and keys are emitted
in a fixed order, so repeat-run exports diff byte for byte.

    python -m shadow_tpu_torch.tools.export_trace run.npz -o run.trace.json
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


def export(in_path: str | None, out_path: str,
           ledger_path: str | None = None) -> dict:
    """Convert one .npz trace file; returns stats for the caller. A serve
    flight ledger (`ledger_path`) raises NotImplementedError."""
    events: list[dict] = []
    meta: dict = {}
    if in_path is not None:
        from shadow_tpu_torch.obs.trace import load_trace

        recs, meta = load_trace(in_path)
        events += build_events(recs, meta)
    if ledger_path is not None:
        raise NotImplementedError(
            "a serve flight ledger needs the serving plane (serve/, "
            "obs/servetrace.py), which is not ported (ROADMAP.md Queue 1 "
            "item 8b)")
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
    with open(out_path, "w") as f:
        json.dump(doc, f, separators=(",", ":"), sort_keys=True)
        f.write("\n")
    n_flows = sum(1 for e in events if e.get("ph") == "s")
    return {"events": len(events), "flows": n_flows,
            "records": meta.get("n_records", 0),
            "serve_records": 0, "out": out_path,
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
                   help="serve-plane flight ledger: not ported (the "
                        "serving plane is not), raises")
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
