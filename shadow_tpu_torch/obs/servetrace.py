"""Request-scoped tracing for the serving plane (docs/18-Serve-Tracing.md):
the counterpart of `shadow_tpu.obs.servetrace`, with the same records
and the same JSONL ledger.

`ServeTracer` records structured spans keyed by request id and launch
id as the service moves a request through its lifecycle: submit /
validate, queue-wait, pack, cache-hit-vs-compile, each beat (windows
dispatched, harvest fetch, per-lane sim-time progress from the
single-fetch bundle), snapshot writes, retry/resume, bisection rounds,
deadline/timeout, and result delivery. It is the serve-plane analog of
the device tier's `obs.trace` ring: always structurally bounded, fed
from the launch worker and the HTTP handler threads (never from device
code), and strictly zero behavior change when absent — `SimService`
guards every call site with `if self._tracer is not None`.

The span record is one flat JSON-safe dict:

    {"kind": "span"|"event", "name": ..., "t_s": start, "dur_s": dur,
     "rid": ..., "launch": ..., "cls": ..., <attrs>}

`t_s` is seconds on the tracer's (injectable) monotonic clock relative
to tracer start; `dur_s` is 0.0 for point events. Wall-derived keys end
in `_s`/`_ms` on purpose — `tools.diff_runs` compares them tolerantly
while sim-side attrs (`now_ns`) stay exact.

Three exposures share this one record stream:

- `trace(rid)` assembles the span tree `GET /trace/<rid>` serves, and
  `recent()` rides the launch watchdog's diagnostic bundle;
- the append-only JSONL flight ledger (`--ledger-file`): a header line
  (`{"ledger_version": 1, ...}`) then one record per line, flushed per
  write, so post-hoc tooling (`tools.serve_report`, the merged
  `tools.export_trace` view) works on dead servers;
- wait/beat spans feed the per-class `ServeMetrics` histograms
  (`observe_class`), whose OpenMetrics exemplars point at the worst
  request id per bucket.

Memory is bounded the same way the service bounds terminal results:
per-rid entries live in an LRU ring (`max_requests`, and the service
forwards its own result evictions via `forget`), per-launch span lists
in a smaller FIFO ring (`max_launches`).
"""

from __future__ import annotations

import json
import threading
import time
from collections import OrderedDict, deque

# span name -> ServeMetrics per-class histogram family fed with its dur
_HIST_SPANS = {"queue_wait": "queue_wait", "pack_wait": "pack_wait",
               "beat": "beat_wall"}


class ServeTracer:
    """Bounded recorder of serve-plane spans + the JSONL flight ledger.

    Thread-safe: `span`/`event` are called from the launch worker and
    HTTP handler threads; the internal lock is a leaf (no tracer call
    takes another lock), so it composes with the service's condition
    variable in either order.
    """

    def __init__(self, *, clock=time.monotonic, max_requests: int = 4096,
                 max_launches: int = 512, ledger_file: str | None = None,
                 ledger_meta: dict | None = None, metrics=None,
                 recent_capacity: int = 64):
        self._clock = clock
        self._t0 = clock()
        self.max_requests = max(int(max_requests), 1)
        self.max_launches = max(int(max_launches), 1)
        self.metrics = metrics
        self._lock = threading.Lock()
        # rid -> {"cls": str|None, "launches": [int], "spans": [rec]}
        self._req: "OrderedDict[str, dict]" = OrderedDict()
        # launch id -> [rec]
        self._launch: "OrderedDict[int, list]" = OrderedDict()
        self._recent: deque = deque(maxlen=int(recent_capacity))
        self._dropped = 0
        self.ledger_path = ledger_file
        self._ledger = None
        if ledger_file:
            self._ledger = open(ledger_file, "a", encoding="utf-8")
            header = {"ledger_version": 1, "plane": "serve"}
            header.update(ledger_meta or {})
            self._ledger.write(
                json.dumps(header, sort_keys=True) + "\n")
            self._ledger.flush()

    # -- recording -------------------------------------------------------

    def now(self) -> float:
        return self._clock()

    def span(self, name: str, *, t0: float, t1: float,
             rid: str | None = None, rids=None,
             launch: int | None = None, cls: str | None = None,
             **attrs) -> dict:
        """One completed span [t0, t1] on the tracer clock. `rid` files
        it under a request, `launch` under a launch, `rids` under every
        request of a batch-scoped record (retry/bisect)."""
        rec = {"kind": "span", "name": name,
               "t_s": round(t0 - self._t0, 6),
               "dur_s": round(max(t1 - t0, 0.0), 6)}
        self._file(rec, rid=rid, rids=rids, launch=launch, cls=cls,
                   attrs=attrs)
        fam = _HIST_SPANS.get(name)
        if fam is not None and self.metrics is not None \
                and cls is not None:
            ex_rid = rid if rid is not None else (
                attrs.get("lanes", [{}])[0].get("rid")
                if attrs.get("lanes") else (rids[0] if rids else None))
            self.metrics.observe_class(
                fam, cls, int(max(t1 - t0, 0.0) * 1e9),
                rid=ex_rid, t_s=rec["t_s"])
        return rec

    def event(self, name: str, *, t: float | None = None,
              rid: str | None = None, rids=None,
              launch: int | None = None, cls: str | None = None,
              **attrs) -> dict:
        """One point event (dur_s = 0)."""
        t = self._clock() if t is None else t
        rec = {"kind": "event", "name": name,
               "t_s": round(t - self._t0, 6), "dur_s": 0.0}
        self._file(rec, rid=rid, rids=rids, launch=launch, cls=cls,
                   attrs=attrs)
        return rec

    def associate(self, rid: str, launch: int) -> None:
        """Tie a request to a launch so `trace(rid)` includes the
        launch's spans (a retried/bisected rid accumulates several)."""
        with self._lock:
            ent = self._req_entry_locked(rid)
            if launch not in ent["launches"]:
                ent["launches"].append(launch)

    def _file(self, rec: dict, *, rid, rids, launch, cls, attrs) -> None:
        if rid is not None:
            rec["rid"] = rid
        if rids:
            rec["rids"] = list(rids)
        if launch is not None:
            rec["launch"] = int(launch)
        if cls is not None:
            rec["cls"] = cls
        for k, v in attrs.items():
            if v is not None:
                rec[k] = v
        with self._lock:
            for r in ([rid] if rid is not None else list(rids or ())):
                ent = self._req_entry_locked(r)
                if cls is not None and ent["cls"] is None:
                    ent["cls"] = cls
                ent["spans"].append(rec)
            if launch is not None:
                self._launch.setdefault(int(launch), [])
                self._launch[int(launch)].append(rec)
                while len(self._launch) > self.max_launches:
                    self._launch.popitem(last=False)
                    self._dropped += 1
            self._recent.append(rec)
            if self._ledger is not None:
                self._ledger.write(
                    json.dumps(rec, sort_keys=True) + "\n")
                self._ledger.flush()

    def _req_entry_locked(self, rid: str) -> dict:
        ent = self._req.get(rid)
        if ent is None:
            ent = {"cls": None, "launches": [], "spans": []}
            self._req[rid] = ent
            while len(self._req) > self.max_requests:
                self._req.popitem(last=False)
                self._dropped += 1
        else:
            self._req.move_to_end(rid)
        return ent

    # -- exposure --------------------------------------------------------

    def trace(self, rid: str) -> dict | None:
        """The span tree `GET /trace/<rid>` serves: the request's own
        spans plus one node per launch it rode (pack/cache/beat/
        snapshot/confirm spans), or None for an unknown/evicted rid."""
        with self._lock:
            ent = self._req.get(rid)
            if ent is None:
                return None
            return {
                "request_id": rid,
                "class": ent["cls"],
                "spans": [dict(r) for r in ent["spans"]],
                "launches": [
                    {"launch": n,
                     "spans": [dict(r) for r in self._launch.get(n, ())]}
                    for n in ent["launches"]
                ],
            }

    def recent(self) -> list[dict]:
        """The most recent records (any scope) — rides the launch
        watchdog's diagnostic bundle, mirroring `FlightRecorder`."""
        with self._lock:
            return [dict(r) for r in self._recent]

    def forget(self, rid: str) -> None:
        """Drop a request's spans (the service forwards its terminal-
        record evictions here so /trace retention tracks /result)."""
        with self._lock:
            self._req.pop(rid, None)

    def snapshot(self) -> dict:
        with self._lock:
            return {"requests": len(self._req),
                    "launches": len(self._launch),
                    "dropped": self._dropped,
                    "ledger": self.ledger_path}

    def close(self) -> None:
        with self._lock:
            if self._ledger is not None:
                self._ledger.close()
                self._ledger = None


def load_ledger(path: str) -> tuple[dict, list[dict]]:
    """Read a flight ledger back: (header, records). Tolerates a
    truncated final line (the process may have died mid-write — that is
    the ledger's whole point)."""
    header: dict = {}
    records: list[dict] = []
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                doc = json.loads(line)
            except json.JSONDecodeError:
                break  # torn tail write of a dying process
            if i == 0 and "ledger_version" in doc:
                header = doc
            else:
                records.append(doc)
    return header, records


def decompose(tree: dict) -> dict:
    """Reduce one `trace(rid)` span tree to its latency decomposition
    (milliseconds): queue wait, pack wait (all attempts), run (beats +
    confirm across every launch the rid rode), retry backoff, and the
    end-to-end total when the result event carries `wall_ms`. Shared by
    `tools.serve_client` and `tools.serve_report`."""
    rid = tree.get("request_id")
    out = {"queue_wait_ms": 0.0, "pack_wait_ms": 0.0, "run_ms": 0.0,
           "retry_ms": 0.0, "beats": 0, "total_ms": None,
           "status": None}
    for s in tree.get("spans", ()):
        if s["name"] == "queue_wait":
            out["queue_wait_ms"] += s["dur_s"] * 1e3
        elif s["name"] == "pack_wait":
            out["pack_wait_ms"] += s["dur_s"] * 1e3
        elif s["name"] == "retry":
            out["retry_ms"] += s["dur_s"] * 1e3
        elif s["name"] == "result":
            out["status"] = s.get("status")
            if s.get("wall_ms") is not None:
                out["total_ms"] = s["wall_ms"]
    for launch in tree.get("launches", ()):
        for s in launch.get("spans", ()):
            if s["name"] == "beat":
                lanes = s.get("lanes", ())
                if any(e.get("rid") == rid for e in lanes):
                    out["run_ms"] += s["dur_s"] * 1e3
                    out["beats"] += 1
            elif s["name"] == "confirm":
                if rid in s.get("rids", ()):
                    out["run_ms"] += s["dur_s"] * 1e3
    for k in ("queue_wait_ms", "pack_wait_ms", "run_ms", "retry_ms"):
        out[k] = round(out[k], 3)
    return out
