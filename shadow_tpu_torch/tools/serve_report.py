"""Operator report over a serve-plane flight ledger: the port's copy of
`shadow_tpu.tools.serve_report`, with the same report for the same
ledger, byte for byte.

Reduces the append-only JSONL ledger a traced `shadow_tpu_torch serve` run
writes (`--ledger-file`, docs/18-Serve-Tracing.md) into the questions
an operator actually asks after the fact: where did each class's
latency go (queue wait vs pack wait vs run, p50/p95/p99), how full were
the launches (pack efficiency = lanes used / max lanes), how warm was
the program cache, and what did failures cost (retry backoff seconds,
bisection rounds, timeouts, chaos injections).

Works on dead servers by construction — the ledger is flushed per
record and `load_ledger` tolerates a torn final line. Rebuilding the
per-request span trees needs no side table: every request-scoped span
carries `rid` (or `rids` for batch-scoped records) and the
launch-linking spans (`pack_wait`, `result`) carry both, so the
rid -> launch association the live tracer keeps is recoverable from the
records alone.

    python -m shadow_tpu_torch.tools.serve_report ledger.jsonl

prints one sorted-keys JSON line (the same artifact discipline as
`serve_client`), diffable run-to-run with `diff_runs --rtol`
since every wall-derived key ends in `_ms`/`_s`.
"""

from __future__ import annotations

import argparse
import json
import sys

from shadow_tpu_torch.obs.servetrace import decompose, load_ledger


def trees_from_ledger(records: list[dict]) -> dict[str, dict]:
    """Rebuild {rid: span tree} in `ServeTracer.trace` shape from the
    flat ledger stream. A record files under every rid it names (`rid`
    or batch `rids`) and under its launch; a rid is associated with a
    launch the first time one record carries both."""
    req: dict[str, dict] = {}
    launches: dict[int, list] = {}
    for rec in records:
        rids = ([rec["rid"]] if "rid" in rec else
                list(rec.get("rids", ())))
        launch = rec.get("launch")
        if launch is not None:
            launches.setdefault(int(launch), []).append(rec)
        for r in rids:
            ent = req.setdefault(
                r, {"cls": None, "launches": [], "spans": []})
            if ent["cls"] is None and "cls" in rec:
                ent["cls"] = rec["cls"]
            ent["spans"].append(rec)
            if launch is not None and int(launch) not in ent["launches"]:
                ent["launches"].append(int(launch))
    return {
        rid: {
            "request_id": rid,
            "class": ent["cls"],
            "spans": ent["spans"],
            "launches": [{"launch": n, "spans": launches.get(n, [])}
                         for n in ent["launches"]],
        }
        for rid, ent in req.items()
    }


def _pct(sorted_vals: list[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(int(q * len(sorted_vals)), len(sorted_vals) - 1)
    return round(sorted_vals[i], 3)


def _percentiles(vals: list[float]) -> dict:
    s = sorted(vals)
    return {"p50": _pct(s, 0.50), "p95": _pct(s, 0.95),
            "p99": _pct(s, 0.99)}


def reduce_ledger(header: dict, records: list[dict]) -> dict:
    """The full operator report as one JSON-safe dict."""
    trees = trees_from_ledger(records)
    by_class: dict[str, list[dict]] = {}
    for tree in trees.values():
        d = decompose(tree)
        by_class.setdefault(tree["class"] or "?", []).append(d)

    classes = {}
    for cls, decomps in sorted(by_class.items()):
        totals = [d["total_ms"] for d in decomps
                  if d["total_ms"] is not None]
        classes[cls] = {
            "requests": len(decomps),
            "done": sum(1 for d in decomps if d["status"] == "done"),
            "timeouts": sum(1 for d in decomps
                            if d["status"] == "timeout"),
            "errors": sum(1 for d in decomps if d["status"] == "error"),
            "queue_wait_ms": _percentiles(
                [d["queue_wait_ms"] for d in decomps]),
            "pack_wait_ms": _percentiles(
                [d["pack_wait_ms"] for d in decomps]),
            "run_ms": _percentiles([d["run_ms"] for d in decomps]),
            "total_ms": _percentiles(totals),
        }

    packs = [r for r in records
             if r.get("kind") == "span" and r.get("name") == "pack"]
    lanes_used = sum(int(r.get("lanes_packed", 0)) for r in packs)
    lanes_avail = sum(int(r.get("max_lanes", 0)) for r in packs)
    caches = [r for r in records
              if r.get("kind") == "span" and r.get("name") == "cache"]
    hits = sum(1 for r in caches if r.get("hit"))
    retries = [r for r in records if r.get("name") == "retry"]
    bisects = [r for r in records if r.get("name") == "bisect"]

    return {
        "ledger_version": header.get("ledger_version"),
        "requests": len(trees),
        "classes": classes,
        "launches": len({int(r["launch"]) for r in records
                         if "launch" in r}),
        "pack_efficiency": round(lanes_used / lanes_avail, 4)
        if lanes_avail else None,
        "cache_lookups": len(caches),
        "cache_hit_ratio": round(hits / len(caches), 4)
        if caches else None,
        "retries": len(retries),
        "retry_backoff_s": round(
            sum(float(r.get("backoff_s", 0.0)) for r in retries), 3),
        "bisections": len(bisects),
        "deadline_exceeded": sum(
            1 for r in records if r.get("name") == "deadline_exceeded"),
        "chaos_injections": sum(
            1 for r in records if r.get("name") == "chaos"),
        "snapshots": sum(
            1 for r in records
            if r.get("kind") == "span" and r.get("name") == "snapshot"),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="serve_report",
        description="reduce a serve flight ledger (--ledger-file) into "
                    "the per-class latency decomposition / pack "
                    "efficiency / cache / failure-cost report "
                    "(docs/18-Serve-Tracing.md)")
    p.add_argument("ledger", help="flight ledger JSONL path")
    args = p.parse_args(argv)

    try:
        header, records = load_ledger(args.ledger)
    except OSError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if not header and not records:
        print(f"error: {args.ledger}: empty ledger", file=sys.stderr)
        return 2
    print(json.dumps(reduce_ledger(header, records), sort_keys=True))
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
