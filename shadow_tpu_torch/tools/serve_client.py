"""Load generator / client for the resident scenario service: the
port's copy of `shadow_tpu.tools.serve_client`, with the same request
stream, artifacts and report.

Submits a mixed-compatible request stream to a running `shadow_tpu_torch
serve` (or `shadow_tpu serve`) instance (stdlib urllib only), polls results, optionally writes
each completed record to a directory (one `<request_id>.json` per
request — the exact artifact `tools/diff_runs.py` diffs against a solo
summary for the bit-identity gate), and prints one machine-readable
JSON line with throughput and latency percentiles.

When the server runs with `--trace-requests` (docs/18-Serve-Tracing.md)
the client also fetches each request's span tree from `/trace/<id>`,
writes it beside the result artifact (`<request_id>.trace.json`), and
the report gains per-class p50/p95/p99 of the queue-wait / pack-wait /
run decomposition. A server without tracing answers 404 there; the
client just skips those fields.

The default mix alternates two static-knob equivalence classes over one
phold shape — a plain seed sweep and a crash-fault class with varied
stop times and latency scales — so a 16-request run exercises lane
packing, inert-lane padding, AND the warm fleet cache (>= 1 hit per
class after the first launch). `--mix plain` keeps one class.

    python -m shadow_tpu_torch.tools.serve_client --url http://127.0.0.1:8421 \
        --requests 16 --out-dir served/
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.error
import urllib.request


def request_docs(n: int, *, mix: str = "mixed", hosts: int = 8,
                 stop_s: float = 1.0, seed0: int = 100) -> list[dict]:
    """The deterministic request stream: request i is a function of
    (i, seed0) only, so a replayed stream packs identically and the
    solo references are reproducible."""
    params = {"hosts": hosts, "capacity": 64, "msgs_per_host": 2}
    docs = []
    for i in range(n):
        doc = {"model": "phold", "params": dict(params),
               "seed": seed0 + i, "stop_s": stop_s}
        if mix == "mixed" and i % 2 == 1:
            # the second equivalence class: crash faults, varied stops
            # and a latency-scaled lane every fourth request
            doc["faults"] = [
                f"crash hosts=host{i % hosts} start=0.2 end=0.5"
            ]
            doc["stop_s"] = stop_s * (0.75 if i % 4 == 1 else 1.0)
            if i % 4 == 3:
                doc["latency_scale"] = 1.5
        docs.append(doc)
    return docs


# Bounded connection retry across a server restart window: an elastic
# server that hits device loss exits and is relaunched by its --retry
# wrapper, so every request in flight from the CLIENT side sees
# connection-refused/reset for a second or two. `_RETRY` is module
# state so the report can surface how often the window was crossed;
# retries=0 (the default) keeps the old fail-fast behavior.
_RETRY = {"retries": 0, "backoff_s": 0.25, "count": 0}


def _http(url: str, data: bytes | None = None, timeout: float = 10.0):
    req = urllib.request.Request(
        url, data=data,
        headers={"Content-Type": "application/json"} if data else {})
    attempt = 0
    while True:
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                return resp.status, json.loads(
                    resp.read().decode("utf-8"))
        except (urllib.error.URLError, ConnectionResetError) as e:
            # RemoteDisconnected subclasses ConnectionResetError and
            # sometimes escapes urllib unwrapped mid-restart
            reason = getattr(e, "reason", e)
            refused = isinstance(
                reason, (ConnectionRefusedError, ConnectionResetError,
                         ConnectionAbortedError))
            if not refused or attempt >= _RETRY["retries"]:
                raise
            attempt += 1
            _RETRY["count"] += 1
            time.sleep(_RETRY["backoff_s"] * (2 ** (attempt - 1)))


def fetch_traces(url: str, rids: list[str]) -> dict[str, dict]:
    """Span trees for completed requests, `{}` when tracing is off
    (the server 404s every /trace/<id> then)."""
    trees: dict[str, dict] = {}
    for rid in rids:
        try:
            status, tree = _http(f"{url}/trace/{rid}")
        except urllib.error.HTTPError as e:
            if e.code == 404:
                continue  # tracing off, or the rid was evicted
            raise
        if status == 200:
            trees[rid] = tree
    return trees


def submit_all(url: str, docs: list[dict]) -> list[str]:
    rids = []
    for doc in docs:
        body = json.dumps(doc).encode("utf-8")
        status, out = _http(url + "/submit", data=body)
        if status != 200:
            raise RuntimeError(f"submit failed ({status}): {out}")
        rids.append(out["request_id"])
    return rids


def poll_results(url: str, rids: list[str], *,
                 timeout_s: float = 600.0,
                 poll_s: float = 0.2) -> dict[str, dict]:
    """Poll every request to completion (done or error)."""
    pending = set(rids)
    recs: dict[str, dict] = {}
    deadline = time.monotonic() + timeout_s
    while pending:
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"{len(pending)} request(s) still pending after "
                f"{timeout_s}s: {sorted(pending)[:4]}...")
        for rid in sorted(pending):
            status, rec = _http(f"{url}/result/{rid}")
            if status == 200:
                recs[rid] = rec
                pending.discard(rid)
        if pending:
            time.sleep(poll_s)
    return recs


def _pct(sorted_vals: list[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(int(q * len(sorted_vals)), len(sorted_vals) - 1)
    return sorted_vals[i]


def _class_decomposition(trees: dict[str, dict]) -> dict:
    """Per-class p50/p95/p99 of queue-wait / pack-wait / run, from the
    span trees (shares `obs.servetrace.decompose` with serve_report)."""
    from shadow_tpu_torch.obs.servetrace import decompose

    by_class: dict[str, list[dict]] = {}
    for tree in trees.values():
        by_class.setdefault(tree.get("class") or "?", []).append(
            decompose(tree))
    out = {}
    for cls, ds in sorted(by_class.items()):
        ent = {}
        for key in ("queue_wait_ms", "pack_wait_ms", "run_ms"):
            vals = sorted(d[key] for d in ds)
            ent[key] = {"p50": _pct(vals, 0.50),
                        "p95": _pct(vals, 0.95),
                        "p99": _pct(vals, 0.99)}
        out[cls] = ent
    return out


def run_load(url: str, docs: list[dict], *, out_dir: str | None = None,
             timeout_s: float = 600.0) -> dict:
    t0 = time.monotonic()
    rids = submit_all(url, docs)
    recs = poll_results(url, rids, timeout_s=timeout_s)
    wall_s = time.monotonic() - t0
    trees = fetch_traces(url, rids)
    if out_dir is not None:
        import os

        os.makedirs(out_dir, exist_ok=True)
        for rid, rec in recs.items():
            with open(os.path.join(out_dir, f"{rid}.json"), "w") as f:
                json.dump(rec, f, sort_keys=True, indent=1)
                f.write("\n")
        for rid, tree in trees.items():
            path = os.path.join(out_dir, f"{rid}.trace.json")
            with open(path, "w") as f:
                json.dump(tree, f, sort_keys=True, indent=1)
                f.write("\n")
    done = [r for r in recs.values() if r["status"] == "done"]
    lat = sorted(r["wall_ms"] for r in done)
    report = {
        "requests": len(docs),
        "done": len(done),
        "errors": len(recs) - len(done),
        "wall_s": round(wall_s, 3),
        "requests_per_sec": round(len(done) / max(wall_s, 1e-9), 3),
        "p50_ms": _pct(lat, 0.50),
        "p95_ms": _pct(lat, 0.95),
        "max_lanes_packed": max((r["lanes_packed"] for r in done),
                                default=0),
        "launches": len({r["launch"] for r in done}),
        "cache_hits_seen": sum(1 for r in done if r.get("cache_hit")),
        "conn_retries": _RETRY["count"],
    }
    if trees:
        report["traced"] = len(trees)
        report["class_decomposition"] = _class_decomposition(trees)
    return report


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="serve_client",
        description="load generator for `shadow_tpu serve` "
                    "(docs/17-Serving.md)")
    p.add_argument("--url", default="http://127.0.0.1:8421",
                   help="server base URL (no trailing slash)")
    p.add_argument("--requests", type=int, default=16)
    p.add_argument("--mix", choices=("mixed", "plain"), default="mixed",
                   help="mixed = two equivalence classes (default); "
                        "plain = one seed-sweep class")
    p.add_argument("--hosts", type=int, default=8)
    p.add_argument("--stop-s", type=float, default=1.0)
    p.add_argument("--seed0", type=int, default=100,
                   help="base seed; request i uses seed0+i")
    p.add_argument("--out-dir", default=None,
                   help="write each result record to DIR/<rid>.json "
                        "(diff_runs-able against solo summaries)")
    p.add_argument("--timeout", type=float, default=600.0)
    p.add_argument("--connect-retries", type=int, default=0,
                   help="bounded connection-refused retries per HTTP "
                        "call — rides out an elastic server's restart "
                        "window (0 = fail fast)")
    p.add_argument("--connect-backoff", type=float, default=0.25,
                   help="base backoff seconds between connection "
                        "retries (doubles per attempt)")
    p.add_argument("--print-docs", action="store_true",
                   help="print the request docs (one JSON per line) "
                        "and exit without contacting the server — for "
                        "generating matching solo references")
    args = p.parse_args(argv)

    _RETRY["retries"] = max(int(args.connect_retries), 0)
    _RETRY["backoff_s"] = max(float(args.connect_backoff), 0.0)
    docs = request_docs(args.requests, mix=args.mix, hosts=args.hosts,
                        stop_s=args.stop_s, seed0=args.seed0)
    if args.print_docs:
        for d in docs:
            print(json.dumps(d, sort_keys=True))
        return 0
    try:
        report = run_load(args.url.rstrip("/"), docs,
                          out_dir=args.out_dir, timeout_s=args.timeout)
    except (urllib.error.URLError, TimeoutError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    print(json.dumps(report, sort_keys=True))
    return 0 if report["errors"] == 0 else 1


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
