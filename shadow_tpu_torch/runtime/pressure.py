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
  grow    spill plus a re-template at doubled capacity: not ported (it
          needs utils/checkpoint.py's `transfer_state`); build_simulation
          refuses it.
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

Not ported, each raising NotImplementedError: `pressure_bundle` (it
needs runtime/supervisor.py) and the reservoir's checkpoint extras
(`serialize`/`restore`, which ride utils/checkpoint.py).
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

OVERFLOW_MODES = ("spill", "strict", "grow", "drop")

# refill iterations per boundary before a host counts as pathologically
# oversubscribed (each one raises the device fill or lowers the device
# max key, so real workloads converge in one or two)
_MAX_REFILL_ROUNDS = 8

# the fill a refill tops each host's device queue up to, as a share of
# its capacity
_WATERMARK = 0.75

_I64MIN = -(1 << 63)


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
    """The strict mode's diagnostic bundle: not ported."""
    raise NotImplementedError(
        "pressure_bundle needs runtime/supervisor.py, which is not ported")


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
    """

    def __init__(self, n_hosts: int, capacity: int, lookahead: int, *,
                 n_args: int):
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

    def serialize(self) -> dict:
        raise NotImplementedError(
            "the reservoir's checkpoint extras need utils/checkpoint.py, "
            "which is not ported")

    def restore(self, extra: dict) -> None:
        raise NotImplementedError(
            "the reservoir's checkpoint extras need utils/checkpoint.py, "
            "which is not ported")

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

    def snapshot(self, state) -> dict:
        """Cumulative pressure counters, device and host, in one copy."""
        ring = state.queues.spill
        if ring is None:
            return {}
        scap = ring.time.shape[1] - self.capacity
        vals = self._fetch(torch.stack([
            ring.n_spilled.sum(), ring.n_lost.sum(),
            ring.fill_hwm.max().to(torch.int64),
            torch.clamp(ring.wr, max=scap).sum().to(torch.int64)]))
        return {
            "spilled": int(vals[0]),
            "spill_lost": int(vals[1]),
            "fill_hwm": int(vals[2]),
            "pending": int(vals[3]),
            "refilled": int(np.sum(self.n_refilled)),
            "resident": int(np.sum(self.resident())),
            "overdue": int(self.n_overdue),
            "harvest_seconds": float(self.harvest_seconds),
        }


def run_with_spill(engine, state, stop, controller: PressureController):
    """Window-stepped run with a harvest and refill at every boundary:
    the raw engine's counterpart of Simulation.run in spill mode."""
    stop_t = engine._stop(stop)
    while engine._read(state.now < stop_t):
        state = engine.step_window(state, stop)
        state = controller.boundary(state, read=engine._read)
    return state
