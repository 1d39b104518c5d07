"""Lossless queue-pressure handling: a host reservoir over the device
spill ring.

The counterpart of `shadow_tpu.runtime.pressure`. The overflow modes:

  spill   evictions land in a per-host device ring (core.events.SpillRing,
          written inside `queue_push`); at every window boundary the
          host-side `PressureController` harvests the ring into per-host
          min-heaps (the reservoir) and re-inserts events so that the
          device queue always holds each host's smallest keys. Lossless
          while a host's demand per window fits its queue; `n_overdue`
          counts the rest.
  strict  no ring; the first would-be drop raises QueuePressureError.
  grow    spill, plus: the first fresh eviction after a boundary sets
          `grow_wanted`, and the CLI's run loop rebuilds the engine at
          doubled capacity and carries the state across through
          `utils.checkpoint.transfer_state`, keeping this controller.
  drop    overflow is counted in `queues.drops` and the run goes on.

Window boundaries are safe harvest points: during a drain the engine
only pushes events at or past the window's end, so an evicted event
carries a key >= the window end and is not needed before the boundary
where it is re-inserted. A refill pushes reservoir minima through the
ordinary `queue_push` (through the merge kernel on the card), which
evicts any displaced larger keys back into the ring for immediate
re-harvest, so a capacity-C run with spill ends in the same state as a
capacity-2C run without it.

With a `TraceDrain` attached (`attach_trace`), every harvested record
becomes an OP_SPILL row and every refilled one an OP_REFILL row of the
trace, injected on the host (the moments happen there); rows are local
host ids, since the controller works on one unsharded queue.

The reservoir rides a checkpoint's extra arrays (`serialize`/`restore`),
so `--resume` is exact with events parked on the host; `gather` and
`snapshot_from` split the telemetry snapshot into device refs and host
arithmetic, so the heartbeat harvest carries it in its one copy; and
`pressure_bundle` is the strict mode's diagnostic bundle (exit 76).
"""

from __future__ import annotations

import dataclasses
import heapq
import sys
import time as _time
from typing import Callable

import numpy as np
import torch

from shadow_tpu_torch.core.events import Events, pack_srcseq, queue_push
from shadow_tpu_torch.core.timebase import TIME_INVALID
from shadow_tpu_torch.obs.trace import OP_REFILL, OP_SPILL
from shadow_tpu_torch.runtime.supervisor import (
    EXIT_PRESSURE,
    write_diagnostic_bundle,
)

OVERFLOW_MODES = ("spill", "strict", "grow", "drop")

# refill iterations per boundary before a host counts as pathologically
# oversubscribed (each one raises the device fill or lowers the device
# max key, so real workloads converge in one or two)
_MAX_REFILL_ROUNDS = 8

# the fill a refill tops each host's device queue up to, as a share of
# its capacity
_WATERMARK = 0.75

_I64MIN = -(1 << 63)

# the per-host ring counters `gather` returns, in `snapshot`'s copy order
_GATHER_KEYS = ("n_spilled", "n_lost", "fill_hwm", "wr")


class QueuePressureError(RuntimeError):
    """Raised under overflow="strict" at the first would-be drop, with
    the accounting a diagnostic needs."""

    def __init__(self, drops: int, capacity: int, summary: dict):
        self.drops = int(drops)
        self.capacity = int(capacity)
        self.summary = dict(summary)
        super().__init__(
            f"queue pressure: {drops} events would overflow the per-host "
            f"event queues (capacity {capacity}); rerun with a larger "
            "--capacity, or a lossless mode (--overflow spill/grow)"
        )


def pressure_bundle(exc: QueuePressureError, *, diag_dir: str,
                    label: str, extra: dict | None = None) -> str:
    """Write the strict mode's diagnostic bundle (exit code 76); returns
    its path. `extra` adds context beyond the exception, such as the
    flight recorder's ring of recent heartbeats."""
    payload = {
        "reason": "queue pressure under --overflow strict",
        "would_drop": exc.drops,
        "capacity": exc.capacity,
        "progress": exc.summary,
        "remedy": (
            "rerun with a larger --capacity, or --overflow spill "
            "(lossless) / grow (auto-resize) / drop (lossy, counted)"
        ),
        "exit_code": EXIT_PRESSURE,
    }
    if extra:
        payload.update(extra)
    return write_diagnostic_bundle(diag_dir, label, "pressure", payload)


def _unpack_words(packed: np.ndarray, n: int) -> list[np.ndarray]:
    """numpy mirror of queue_push's word unpacking: [N, NW] i64 -> n i32."""
    words: list[np.ndarray] = []
    for i in range(packed.shape[-1]):
        p = packed[..., i]
        words.append((p >> 32).astype(np.int32))
        if 2 * i + 1 < n:
            words.append((p & 0xFFFFFFFF).astype(np.uint32).astype(np.int32))
    return words[:n]


def _pack_words_np(words: list[np.ndarray]) -> np.ndarray:
    """numpy mirror of queue_push's word packing: n i32[N] -> [N, NW] i64."""
    out = []
    for i in range(0, len(words), 2):
        hi = words[i].astype(np.int64) << 32
        lo = (words[i + 1].astype(np.int64) & 0xFFFFFFFF
              if i + 1 < len(words) else 0)
        out.append(hi | lo)
    return np.stack(out, axis=-1)


class PressureController:
    """Host side of the spill path: the reservoir and the refill at
    window boundaries.

    The reservoir is a per-host list of binary min-heaps of (time,
    packed srcseq, packed payload words) tuples, the ring's record
    content, so harvest and refill never unpack a payload in between.
    The counters are cumulative. `host_syncs` counts this controller's
    device-to-host reads; the pushes' own flag reads go through the
    `read` a caller passes to `boundary` (an engine's `_read`).

    In "grow" mode a boundary that harvests fresh evictions sets
    `grow_wanted`; the CLI re-templates and clears it.
    """

    def __init__(self, n_hosts: int, capacity: int, lookahead: int, *,
                 n_args: int, mode: str = "spill"):
        if mode not in ("spill", "grow"):
            raise ValueError(f"controller modes are spill/grow, got {mode}")
        self.mode = mode
        self.grow_wanted = False
        self.n_hosts = int(n_hosts)
        self.capacity = int(capacity)
        self.lookahead = int(lookahead)
        self._heaps: list[list] = [[] for _ in range(self.n_hosts)]
        self.n_harvested = np.zeros((self.n_hosts,), np.int64)
        self.n_refilled = np.zeros((self.n_hosts,), np.int64)
        self.n_overdue = 0
        self.harvest_seconds = 0.0
        self.boundaries = 0
        self.host_syncs = 0
        self._warned_overdue = False
        self._ring_slots = 0  # ring width, refreshed by gather
        self._n_args = int(n_args)
        # an obs.trace.TraceDrain that OP_SPILL / OP_REFILL rows go to
        self.trace_drain = None
        self._trace_len_arg = 0

    def attach_trace(self, drain, len_arg: int = 0) -> None:
        """Emit OP_SPILL / OP_REFILL records into an obs.trace.TraceDrain
        (len_arg = EngineConfig.trace_len_arg, for the plen column)."""
        self.trace_drain = drain
        self._trace_len_arg = int(len_arg)

    def _inject(self, op: int, t, ss, pay, owner) -> None:
        """Trace rows for a batch of (time, srcseq, payload) records
        owned by rows `owner`."""
        pay = np.asarray(pay, np.int64).reshape(len(t), -1)
        words = _unpack_words(pay, 1 + self._n_args)
        la = 1 + self._trace_len_arg
        ss = np.asarray(ss, np.int64)
        self.trace_drain.inject(
            time=t, src=(ss >> 32).astype(np.int32),
            dst=np.asarray(owner, np.int32), kind=words[0],
            plen=words[la] if la < len(words) else np.zeros(len(t),
                                                            np.int32),
            seq=(ss & 0xFFFFFFFF).astype(np.uint32).astype(np.int32),
            op=op, owner=owner, n_hosts=self.n_hosts)

    def serialize(self) -> dict[str, np.ndarray]:
        """The reservoir and counters as flat arrays for a checkpoint's
        extra section, so `--resume` is exact mid-pressure. Each heap is
        stored sorted: a heap rebuilt from sorted input pops in the same
        order, which is all determinism needs."""
        counts = self.resident()
        offsets = np.zeros((self.n_hosts + 1,), np.int64)
        np.cumsum(counts, out=offsets[1:])
        total = int(offsets[-1])
        nw = 1  # placeholder width when empty
        for hp in self._heaps:
            if hp:
                nw = len(hp[0][2])
                break
        t = np.zeros((total,), np.int64)
        ss = np.zeros((total,), np.int64)
        pay = np.zeros((total, nw), np.int64)
        for h, hp in enumerate(self._heaps):
            for i, rec in enumerate(sorted(hp)):
                j = int(offsets[h]) + i
                t[j], ss[j] = rec[0], rec[1]
                pay[j] = rec[2]
        return {
            "reservoir_offsets": offsets,
            "reservoir_time": t,
            "reservoir_srcseq": ss,
            "reservoir_pay": pay,
            "n_harvested": self.n_harvested.copy(),
            "n_refilled": self.n_refilled.copy(),
            "n_overdue": np.asarray(self.n_overdue, np.int64),
        }

    def restore(self, extra: dict) -> None:
        """Reload the reservoir and counters from `serialize`'s arrays
        (a checkpoint's extras, either package's)."""
        offsets = np.asarray(extra["reservoir_offsets"])
        t = np.asarray(extra["reservoir_time"])
        ss = np.asarray(extra["reservoir_srcseq"])
        pay = np.asarray(extra["reservoir_pay"])
        self._heaps = []
        for h in range(self.n_hosts):
            lo, hi = int(offsets[h]), int(offsets[h + 1])
            heap = [(int(t[j]), int(ss[j]), tuple(int(w) for w in pay[j]))
                    for j in range(lo, hi)]
            heapq.heapify(heap)
            self._heaps.append(heap)
        self.n_harvested = np.asarray(extra["n_harvested"]).copy()
        self.n_refilled = np.asarray(extra["n_refilled"]).copy()
        self.n_overdue = int(extra["n_overdue"])

    def _fetch(self, t: torch.Tensor) -> np.ndarray:
        """One counted device-to-host copy."""
        self.host_syncs += 1
        return t.cpu().numpy()

    # ------------------------------------------------------------ device
    @staticmethod
    def _reset(state):
        ring = state.queues.spill
        q = dataclasses.replace(state.queues, spill=dataclasses.replace(
            ring, wr=torch.zeros_like(ring.wr)))
        return dataclasses.replace(state, queues=q)

    def _probe(self, state):
        """(fill, max time, max srcseq at that time, now) per host, the
        refill loop's view of the device queue, in one copy."""
        q = state.queues
        valid = q.time != TIME_INVALID
        fill = torch.sum(valid, dim=1, dtype=torch.int64)
        maxt = torch.max(torch.where(valid, q.time, _I64MIN), dim=1).values
        ss = pack_srcseq(q.src, q.seq)
        maxss = torch.max(torch.where(valid & (q.time == maxt[:, None]), ss,
                                      _I64MIN), dim=1).values
        out = self._fetch(torch.cat([fill, maxt, maxss, state.now[None]]))
        h = self.n_hosts
        return out[:h], out[h:2 * h], out[2 * h:3 * h], int(out[-1])

    # ----------------------------------------------------------- harvest
    def _harvest(self, state, wr: np.ndarray):
        """Move every ring record into the reservoir heaps; reset wr.
        Only the columns some host filled are copied, in one copy."""
        ring = state.queues.spill
        scap = ring.time.shape[1] - self.capacity  # slack == capacity
        kept = np.minimum(wr, scap)
        k = int(kept.max())
        h, nw = self.n_hosts, ring.pay.shape[-1]
        flat = self._fetch(torch.cat([
            ring.time[:, :k].reshape(-1), ring.srcseq[:, :k].reshape(-1),
            ring.pay[:, :k].reshape(-1)]))
        t = flat[:h * k].reshape(h, k)
        ss = flat[h * k:2 * h * k].reshape(h, k)
        pay = flat[2 * h * k:].reshape(h, k, nw)
        for g in np.nonzero(kept > 0)[0]:
            n = int(kept[g])
            heap = self._heaps[g]
            for tt, sv, pv in zip(t[g, :n].tolist(), ss[g, :n].tolist(),
                                  pay[g, :n].tolist()):
                heapq.heappush(heap, (tt, sv, tuple(pv)))
            self.n_harvested[g] += n
        if self.trace_drain is not None:
            hs = np.nonzero(kept > 0)[0]
            sel = lambda a: np.concatenate([a[g, :kept[g]] for g in hs])
            owner = np.concatenate([np.full((int(kept[g]),), g, np.int32)
                                    for g in hs])
            self._inject(OP_SPILL, sel(t), sel(ss), sel(pay), owner)
        return self._reset(state)

    # ------------------------------------------------------------ refill
    def _collect(self, fill, maxt, maxss, horizon):
        """Pop the refill candidates: every key the total order demands
        (below the device max), everything due before the horizon, then
        a top-up to the watermark fill. Returns ([(host, record)],
        per-host counts)."""
        target = max(1, int(_WATERMARK * self.capacity))
        picked = []
        per_host = np.zeros((self.n_hosts,), np.int64)
        for h in range(self.n_hosts):
            heap = self._heaps[h]
            cnt = 0
            while heap and cnt < self.capacity:
                t, ss, _pay = heap[0]
                demand = fill[h] > 0 and (t, ss) < (int(maxt[h]),
                                                   int(maxss[h]))
                due = t < horizon
                topup = int(fill[h]) + cnt < target
                if not (demand or due or topup):
                    break
                picked.append((h, heapq.heappop(heap)))
                cnt += 1
            per_host[h] += cnt
        return picked, per_host

    def _push(self, state, picked, read):
        """Push the picked records through `queue_push` as one batch,
        bucketed to a power of two >= 64 rows (the reference's bucketing,
        which fixes the merge's round widths)."""
        n = len(picked)
        m = 64
        while m < n:
            m *= 2
        tt = np.full((m,), TIME_INVALID, np.int64)
        dst = np.zeros((m,), np.int32)
        ss = np.zeros((m,), np.int64)
        pay = np.zeros((m, len(picked[0][1][2])), np.int64)
        tt[:n] = [rec[0] for _, rec in picked]
        dst[:n] = [h for h, _ in picked]
        ss[:n] = [rec[1] for _, rec in picked]
        pay[:n] = [rec[2] for _, rec in picked]
        # the pad rows' zero keys and payloads unpack to zero fields
        words = _unpack_words(pay, 1 + self._n_args)
        src = (ss >> 32).astype(np.int32)
        seq = (ss & 0xFFFFFFFF).astype(np.uint32).astype(np.int32)
        kind, args = words[0], np.stack(words[1:], axis=-1)
        dev = state.queues.time.device
        on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        ev = Events(time=on(tt), dst=on(dst), src=on(src), seq=on(seq),
                    kind=on(kind), args=on(args))
        q = queue_push(state.queues, ev, ev.time != TIME_INVALID, 0, read)
        return dataclasses.replace(state, queues=q)

    def boundary(self, state, wr=None, read: Callable = bool):
        """Harvest and refill at a window boundary; returns the new state.

        Cheap when idle: one copy of the [H] write cursor, none when the
        caller passes `wr` it already fetched. Under pressure it pushes
        and harvests until the device holds each host's smallest keys
        and the fill watermark is met (or the round bound trips, which
        is counted and warned, never silent). `read` is the flag read
        the refill pushes use.
        """
        ring = state.queues.spill
        if ring is None:
            return state
        self.boundaries += 1
        if wr is None:
            wr = self._fetch(ring.wr)
        wr = np.asarray(wr)
        resident = sum(len(hp) for hp in self._heaps)
        if not wr.any() and resident == 0:
            return state
        if self.mode == "grow" and wr.any():
            # fresh evictions since the last boundary (not a cumulative
            # counter, not the reservoir draining): the flag re-arms
            # only if the queue overflows again after a grow, so the
            # capacity converges instead of doubling forever
            self.grow_wanted = True
        t0 = _time.perf_counter()
        if wr.any():
            state = self._harvest(state, wr)
        for _ in range(_MAX_REFILL_ROUNDS):
            if not any(self._heaps):
                break
            fill, maxt, maxss, now = self._probe(state)
            picked, per_host = self._collect(fill, maxt, maxss,
                                             now + self.lookahead)
            if not picked:
                break
            if self.trace_drain is not None:
                owner = np.array([g for g, _ in picked], np.int32)
                self._inject(OP_REFILL, [rec[0] for _, rec in picked],
                             [rec[1] for _, rec in picked],
                             [rec[2] for _, rec in picked], owner)
            state = self._push(state, picked, read)
            self.n_refilled += per_host
            # a refill may evict displaced larger keys back into the
            # ring: harvest them at once so the reservoir invariant holds
            wr = self._fetch(state.queues.spill.wr)
            if wr.any():
                state = self._harvest(state, wr)
            else:
                break
        self._check_overdue(state)
        self.harvest_seconds += _time.perf_counter() - t0
        return state

    def _check_overdue(self, state) -> None:
        """Count reservoir events whose time is already behind the
        frontier (`t < now`): they missed their window, the one regime
        spill cannot make lossless."""
        now = int(self._fetch(state.now))
        overdue = sum(1 for hp in self._heaps for rec in hp if rec[0] < now)
        if overdue and not self._warned_overdue:
            self._warned_overdue = True
            print(
                f"shadow_tpu_torch pressure: {overdue} reservoir events are "
                "behind the simulation frontier and could not be seated "
                "on device: per-host demand exceeds --capacity; results "
                "may diverge from an unbounded run (use a larger "
                "--capacity)",
                file=sys.stderr, flush=True,
            )
        self.n_overdue += overdue

    # ----------------------------------------------------------- queries
    def resident(self) -> np.ndarray:
        return np.asarray([len(hp) for hp in self._heaps], np.int64)

    def reservoir_min_keys(self) -> np.ndarray:
        """[H] smallest reservoir time per host (i64 max when empty)."""
        out = np.full((self.n_hosts,), np.iinfo(np.int64).max, np.int64)
        for h, hp in enumerate(self._heaps):
            if hp:
                out[h] = hp[0][0]
        return out

    def gather(self, state) -> dict:
        """Device refs (nothing copied) for one telemetry snapshot: the
        ring's per-host counters. The heartbeat harvest carries them in
        its one copy; `snapshot_from` does the rest on the host."""
        ring = state.queues.spill
        self._ring_slots = int(ring.time.shape[1])
        return {"n_spilled": ring.n_spilled, "n_lost": ring.n_lost,
                "fill_hwm": ring.fill_hwm, "wr": ring.wr}

    def snapshot_from(self, fetched: dict) -> dict:
        """The telemetry dict from a fetched (numpy) `gather`."""
        spilled = np.asarray(fetched["n_spilled"])
        lost = np.asarray(fetched["n_lost"])
        hwm = np.asarray(fetched["fill_hwm"])
        wr = np.asarray(fetched["wr"])
        return {
            "spilled": int(np.sum(spilled)),
            "spill_lost": int(np.sum(lost)),
            "fill_hwm": int(np.max(hwm)) if hwm.size else 0,
            "pending": int(np.sum(np.minimum(
                wr, self._ring_slots - self.capacity))),
            "refilled": int(np.sum(self.n_refilled)),
            "resident": int(np.sum(self.resident())),
            "overdue": int(self.n_overdue),
            "harvest_seconds": float(self.harvest_seconds),
        }

    def snapshot(self, state) -> dict:
        """Cumulative pressure counters, device and host, in one copy."""
        if state.queues.spill is None:
            return {}
        refs = self.gather(state)
        flat = self._fetch(torch.cat([refs[k].reshape(-1).to(torch.int64)
                                      for k in _GATHER_KEYS]))
        h = self.n_hosts
        return self.snapshot_from(
            {k: flat[i * h:(i + 1) * h] for i, k in enumerate(_GATHER_KEYS)})


def run_with_spill(engine, state, stop, controller: PressureController):
    """Window-stepped run with a harvest and refill at every boundary:
    the raw engine's counterpart of Simulation.run in spill mode."""
    stop = int(stop)
    while engine._read(state.now < stop):
        state = engine.step_window(state, stop)
        state = controller.boundary(state, read=engine._read)
    return state
