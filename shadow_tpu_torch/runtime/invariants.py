"""EngineState invariant guard, off the hot path.

The counterpart of `shadow_tpu.runtime.invariants`: host-side numpy over
the port's state copied to the host (`convert.engine_state_to_numpy`),
re-checking the structural contracts the drains assume but never verify:

- the clock is non-negative and monotonic across validations;
- every host's queue row is sorted by (time, src, seq-as-u32) with empty
  slots (time == TIME_INVALID) last;
- counters that only increment are non-negative (stats, queue drops,
  per-source sequence numbers, executed-event counts);
- no float leaf holds NaN or Inf;
- under queue pressure (spill): drops never decrease between
  validations, every reservoir key is >= the device queue's max key per
  host, and the spill ring's accounting reconciles (every evicted event
  is harvested, lost to ring overflow or pending in the ring).

A violation names the leaf path as the reference's `jax.tree_util.keystr`
does (".stats.n_executed", ".hosts.app.subs[0].gid") and the host row.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from shadow_tpu_torch.convert import engine_state_to_numpy, keystr
from shadow_tpu_torch.core.timebase import TIME_INVALID


class InvariantViolation(RuntimeError):
    """EngineState violated a structural contract; state is corrupt."""


def check_state(state: Any, *, prev_now: int | None = None,
                prev_drops: Any | None = None,
                pressure: Any | None = None,
                max_violations: int = 10) -> list[str]:
    """Return a list of violation strings (empty: the state is sound).

    `prev_now` is the clock at the previous validation, `prev_drops` the
    per-host drop counter then; `pressure` the run's PressureController,
    if any (enables the reservoir and ring checks). One copy of the state
    to the host; everything after is numpy.
    """
    leaves = engine_state_to_numpy(state)
    viols: list[str] = []

    def add(msg: str) -> bool:
        viols.append(msg)
        return len(viols) >= max_violations

    now = int(leaves["now"])
    q_time, q_src, q_seq = (leaves[f"queues.{f}"]
                            for f in ("time", "src", "seq"))

    # 1. clock
    if now < 0:
        add(f".now: negative clock {now}")
    if prev_now is not None and now < int(prev_now):
        add(f".now: clock ran backwards {int(prev_now)} -> {now}")

    # 2. queue rows: empties last, the valid prefix sorted
    valid = q_time != TIME_INVALID
    bad_prefix = np.nonzero((~valid[:, :-1] & valid[:, 1:]).any(axis=1))[0]
    for h in bad_prefix[:3]:
        if add(f".queues.time[host {int(h)}]: empty slot ahead of a live "
               "event (empties-last invariant broken)"):
            return viols
    seq_u32 = q_seq.astype(np.int64) & 0xFFFFFFFF
    src_k = np.where(valid, q_src, 0)
    seq_k = np.where(valid, seq_u32, 0)
    both = valid[:, :-1] & valid[:, 1:]
    dt = q_time[:, 1:] - q_time[:, :-1]
    ds = src_k[:, 1:] - src_k[:, :-1]
    dq = seq_k[:, 1:] - seq_k[:, :-1]
    unsorted = both & ((dt < 0) | ((dt == 0) & (ds < 0))
                       | ((dt == 0) & (ds == 0) & (dq < 0)))
    for h in np.nonzero(unsorted.any(axis=1))[0][:3]:
        c = int(np.nonzero(unsorted[h])[0][0])
        if add(
            f".queues[host {int(h)}]: rows {c},{c + 1} out of "
            f"(time,src,seq) order: "
            f"({int(q_time[h, c])},{int(q_src[h, c])},{int(q_seq[h, c])})"
            f" > ({int(q_time[h, c + 1])},{int(q_src[h, c + 1])},"
            f"{int(q_seq[h, c + 1])})"
        ):
            return viols

    # 3. monotone counters must be non-negative
    for base in ("stats.", "queues.drops", "src_seq", "exec_cnt"):
        for key, arr in leaves.items():
            if not (key.startswith(base) if base.endswith(".")
                    else key == base):
                continue
            if not np.issubdtype(arr.dtype, np.integer):
                continue
            if (arr < 0).any():
                idx = np.unravel_index(int(np.argmin(arr)), arr.shape)
                if add(f"{keystr(key)}{list(idx)}: negative counter "
                       f"{int(arr[idx])}"):
                    return viols

    # 3b. drops only ever increase
    if prev_drops is not None:
        drops = leaves["queues.drops"]
        prev = np.asarray(prev_drops)
        for h in np.nonzero(drops < prev)[0][:3]:
            if add(f".queues.drops[host {int(h)}]: ran backwards "
                   f"{int(prev[h])} -> {int(drops[h])}"):
                return viols

    # 5. pressure: the reservoir's order and the ring's accounting
    if pressure is not None and "queues.spill.time" in leaves:
        res_min = np.asarray(pressure.reservoir_min_keys())
        neg = np.iinfo(np.int64).min
        dev_max = np.max(np.where(valid, q_time, neg), axis=1)
        bad = (res_min < dev_max) & valid.any(axis=1)
        for h in np.nonzero(bad)[0][:3]:
            if add(f"pressure[host {int(h)}]: reservoir min key "
                   f"{int(res_min[h])} < device queue max "
                   f"{int(dev_max[h])} (total order broken)"):
                return viols
        n_spilled, n_lost, wr = (leaves[f"queues.spill.{f}"]
                                 for f in ("n_spilled", "n_lost", "wr"))
        scap = leaves["queues.spill.time"].shape[1] - q_time.shape[1]
        pending = np.minimum(wr, scap).astype(np.int64)
        expect = np.asarray(pressure.n_harvested) + n_lost + pending
        for h in np.nonzero(n_spilled != expect)[0][:3]:
            if add(f"pressure[host {int(h)}]: ring accounting broken: "
                   f"spilled {int(n_spilled[h])} != harvested "
                   f"{int(pressure.n_harvested[h])} + lost "
                   f"{int(n_lost[h])} + pending {int(pending[h])}"):
                return viols

    # 4. NaN/Inf over every float leaf
    for key, arr in leaves.items():
        if not np.issubdtype(arr.dtype, np.floating):
            continue
        finite = np.isfinite(arr)
        if not finite.all():
            idx = np.unravel_index(int(np.argmin(finite)), arr.shape)
            if add(f"{keystr(key)}{list(idx)}: non-finite value "
                   f"{arr[idx]!r}"):
                return viols

    return viols


def validate(state: Any, *, prev_now: int | None = None,
             prev_drops: Any | None = None,
             pressure: Any | None = None) -> int:
    """Raise InvariantViolation listing every violation found; return the
    state's clock (the next call's prev_now)."""
    viols = check_state(state, prev_now=prev_now, prev_drops=prev_drops,
                        pressure=pressure)
    if viols:
        raise InvariantViolation(
            "EngineState invariant violation"
            + ("s" if len(viols) > 1 else "")
            + " (state is corrupt; do not resume from checkpoints written "
            "after the previous clean validation):\n  "
            + "\n  ".join(viols))
    return int(state.now)
