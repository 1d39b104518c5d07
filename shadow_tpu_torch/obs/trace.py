"""Device-side event trace: a fixed-capacity per-host ring buffer.

The counterpart of `shadow_tpu.obs.trace`. The engine appends one record
per executed event and one per routed non-local emit into an [H]-leading
struct-of-arrays ring inside the drain, and the host drains it to numpy
records (`TraceDrain`) for the Chrome-trace exporter
(`shadow_tpu_torch.tools.export_trace`) and per-op interval counts.

- Stop at full, never wrap: records land at column `min(wr, cap)`, and
  the arrays carry `slack` scratch columns past `cap` (the widest single
  append, `Engine._trace_slack`), so a full row's writes fall into a zone
  the drain never reads. `wr` counts every record offered, so `wr - cap`
  is the loss.
- Whole-row writes, as the reference: an append compacts its masked
  [H, M] batch to a per-row prefix (lane order kept) and writes the whole
  width-M row, zeros past the row's new records, at `min(wr, cap)`. The
  reference compacts with a rank one-hot and lands the row with a vmapped
  `dynamic_update_slice`; here a rank `cumsum` and two scatters along the
  slot axis compute the same leaves.
- Zero cost when off: `EngineState.trace` is None unless
  `EngineConfig.trace > 0`, and the engine then runs no trace op.

Record schema (all [H, cap + slack], int32 unless noted): time (i64: the
execution time for EXEC, the emission time otherwise), src, dst, kind,
plen (the payload-length argument word), seq, op (OP_*).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

import numpy as np
import torch

# record classes
OP_EXEC = 0   # event executed (row = executing host)
OP_SEND = 1   # non-local emit routed onto the wire (row = source host)
OP_DROP = 2   # non-local emit lost to a reliability roll
OP_FDROP = 3  # non-local emit lost to the fault overlay
# pressure path (host-side records, TraceDrain.inject)
OP_SPILL = 4   # evicted to the spill ring (row = owning host)
OP_REFILL = 5  # re-seated from the reservoir (row = owning host)

OP_NAMES = {OP_EXEC: "exec", OP_SEND: "send", OP_DROP: "drop",
            OP_FDROP: "fault_drop", OP_SPILL: "spill",
            OP_REFILL: "refill"}

_FIELDS = ("time", "src", "dst", "kind", "plen", "seq", "op")


@dataclasses.dataclass(frozen=True)
class TraceRing:
    """Per-host event-trace ring ([H]-leading struct-of-arrays)."""

    time: torch.Tensor  # i64[H, cap + slack]
    src: torch.Tensor   # i32[H, cap + slack]
    dst: torch.Tensor   # i32[H, cap + slack]
    kind: torch.Tensor  # i32[H, cap + slack]
    plen: torch.Tensor  # i32[H, cap + slack]
    seq: torch.Tensor   # i32[H, cap + slack]
    op: torch.Tensor    # i32[H, cap + slack]
    wr: torch.Tensor    # i32[H] records offered (lost ones included)

    @staticmethod
    def create(n_hosts: int, cap: int, slack: int, *, device) -> "TraceRing":
        w = cap + slack
        z32 = lambda: torch.zeros((n_hosts, w), dtype=torch.int32,
                                  device=device)
        return TraceRing(
            time=torch.zeros((n_hosts, w), dtype=torch.int64, device=device),
            src=z32(), dst=z32(), kind=z32(), plen=z32(), seq=z32(),
            op=z32(),
            wr=torch.zeros((n_hosts,), dtype=torch.int32, device=device))


def trace_append(ring: TraceRing, cap: int, *, time, src, dst, kind, plen,
                 seq, op, mask) -> TraceRing:
    """Append a masked [H, M] record batch into each host's ring: the
    valid records, in lane order, then zeros to width M, written at
    column min(wr, cap); `wr` advances by the valid count."""
    h, m = mask.shape
    slack = ring.time.shape[1] - cap
    if m > slack:
        raise ValueError(f"trace append width {m} exceeds ring slack "
                         f"{slack}; Engine._trace_slack must cover it")
    inc = mask.to(torch.int32)
    rank = torch.cumsum(inc, dim=1, dtype=torch.int32) - inc
    # masked lanes go to a discard column m
    dest = torch.where(mask, rank, m).to(torch.int64)
    starts = torch.clamp(ring.wr, max=cap).to(torch.int64)
    cols = starts[:, None] + torch.arange(m, device=mask.device)[None, :]

    def put(buf, val, dtype):
        val = val.to(dtype).expand(h, m)
        row = torch.zeros((h, m + 1), dtype=dtype, device=mask.device)
        row = row.scatter(1, dest, val)[:, :m]
        return buf.scatter(1, cols, row)

    vals = {"time": (time, torch.int64), "src": (src, torch.int32),
            "dst": (dst, torch.int32), "kind": (kind, torch.int32),
            "plen": (plen, torch.int32), "seq": (seq, torch.int32),
            "op": (op, torch.int32)}
    new = {name: put(getattr(ring, name), v, dt)
           for name, (v, dt) in vals.items()}
    n_new = torch.sum(inc, dim=1, dtype=torch.int32)
    return TraceRing(wr=ring.wr + n_new, **new)


def reset_ring(ring: TraceRing) -> TraceRing:
    """Rewind the write counters; record slots are overwritten lazily."""
    return dataclasses.replace(ring, wr=torch.zeros_like(ring.wr))


class TraceDrain:
    """Drains a TraceRing to host-side numpy records.

    Per drain: one copy of the ring to the host, each row's valid prefix
    (`min(wr, cap)` slots) kept, overflow counted in `lost` and flagged in
    `truncated`. Accumulates record segments for the export and per-host
    per-op interval counts.
    """

    def __init__(self, cap: int, *, names=(), kind_names=()):
        self.cap = int(cap)
        self.names = list(names)
        self.kind_names = list(kind_names)
        self.lost = 0
        self.truncated = False
        self.n_records = 0
        self._segs: list[dict[str, np.ndarray]] = []
        self._interval: dict[str, np.ndarray] | None = None

    @staticmethod
    def gather(ring: TraceRing) -> dict:
        """The ring's record columns and write cursor (no copy)."""
        refs = {f: getattr(ring, f) for f in _FIELDS}
        refs["wr"] = ring.wr
        return refs

    def drain(self, ring: TraceRing) -> int:
        """Harvest every record written since the last reset; returns the
        number drained. Reset the ring after (`drain_state` does both)."""
        fetched = {k: v.detach().cpu().numpy()
                   for k, v in self.gather(ring).items()}
        return self.ingest(fetched)

    def ingest(self, fetched: dict) -> int:
        """Fold a fetched (numpy) `gather` dict into the records."""
        cols = {f: np.asarray(fetched[f]) for f in _FIELDS}
        wr = np.asarray(fetched["wr"]).astype(np.int64)
        h, w = cols["time"].shape
        n = np.minimum(wr, self.cap)
        lost = np.maximum(wr - self.cap, 0)
        if lost.any():
            self.truncated = True
            self.lost += int(lost.sum())
        sel = np.arange(w)[None, :] < n[:, None]
        owner = np.broadcast_to(np.arange(h, dtype=np.int32)[:, None],
                                (h, w))
        seg = {f: cols[f][sel] for f in _FIELDS}
        seg["owner"] = owner[sel].astype(np.int32)
        drained = int(seg["time"].shape[0])
        if drained:
            self._segs.append(seg)
            self.n_records += drained
        self._acc_interval(seg, lost, h)
        return drained

    def inject(self, *, time, src, dst, kind, plen, seq, op, owner,
               n_hosts: int) -> int:
        """Append host-side records (the pressure layer's OP_SPILL /
        OP_REFILL rows). `op` may be a scalar; array fields share one
        length."""
        time = np.asarray(time, np.int64).reshape(-1)
        n = int(time.shape[0])
        if n == 0:
            return 0
        as32 = lambda a: np.broadcast_to(
            np.asarray(a, np.int32).reshape(-1), (n,)).copy()
        seg = {"time": time, "src": as32(src), "dst": as32(dst),
               "kind": as32(kind), "plen": as32(plen), "seq": as32(seq),
               "op": as32(op), "owner": as32(owner)}
        self._segs.append(seg)
        self.n_records += n
        self._acc_interval(seg, np.zeros((n_hosts,), np.int64), n_hosts)
        return n

    def drain_state(self, state: Any) -> Any:
        """Drain `state.trace` and return the state with the ring reset."""
        if state.trace is None:
            return state
        self.drain(state.trace)
        return dataclasses.replace(state, trace=reset_ring(state.trace))

    def _acc_interval(self, seg, lost, h):
        ops, own = seg["op"], seg["owner"]
        cur = {name: np.bincount(own[ops == code],
                                 minlength=h).astype(np.int64)
               for code, name in OP_NAMES.items()}
        cur["lost"] = lost.astype(np.int64)
        if self._interval is None:
            self._interval = cur
        else:
            for key, v in cur.items():
                self._interval[key] = self._interval[key] + v

    def take_interval(self) -> dict[str, np.ndarray] | None:
        """Per-host per-op record counts since the previous take; None
        before the first drain."""
        out = self._interval
        self._interval = None
        return out

    def records(self) -> dict[str, np.ndarray]:
        """All records, sorted by (time, src, seq, op, dst): byte-stable
        across runs."""
        keys = _FIELDS + ("owner",)
        if not self._segs:
            return {k: np.zeros(0, np.int64 if k == "time" else np.int32)
                    for k in keys}
        cat = {k: np.concatenate([s[k] for s in self._segs]) for k in keys}
        order = np.lexsort((cat["dst"], cat["op"], cat["seq"], cat["src"],
                            cat["time"]))
        return {k: v[order] for k, v in cat.items()}

    def save(self, path: str, *, profile: dict | None = None,
             extra_meta: dict | None = None) -> dict:
        """Write the records as an .npz (record arrays + one JSON meta
        string) for `tools/export_trace.py`. Returns the meta dict."""
        recs = self.records()
        meta = {
            "names": self.names,
            "kind_names": self.kind_names,
            "op_names": [OP_NAMES[i] for i in sorted(OP_NAMES)],
            "cap": self.cap,
            "n_records": int(recs["time"].shape[0]),
            "lost": self.lost,
            "truncated": self.truncated,
            "profile": profile or {},
        }
        if extra_meta:
            meta.update(extra_meta)
        np.savez_compressed(
            path, meta=np.asarray(json.dumps(meta, sort_keys=True)), **recs)
        return meta


def load_trace(path: str) -> tuple[dict[str, np.ndarray], dict]:
    """Read a TraceDrain.save() file back as (records, meta)."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["meta"]))
        recs = {k: data[k] for k in data.files if k != "meta"}
    return recs, meta
