"""Adaptive conservative-window widths (`--window auto`): the
counterpart of `shadow_tpu.runtime.adaptive`.

The conservative window defaults to the topology's minimum path
latency, the narrowest width that is always safe. For sparse workloads
that width is wasteful: every window pays the drain's fixed costs and
the barrier for a handful of events. A wider window stays causally
safe (cross-host arrivals clamp up to its end, `Engine._route`) and
coarsens cross-host packet timing by up to its width, the `--runahead`
tradeoff, except that the width is passed per window
(`Simulation.dispatch(..., window_ns=)`), so retuning it rebuilds
nothing.

The controller picks the multiplier, on the host, between windows, from
fetched scalars (executed-event and drop deltas, the queue fill):

- the width is always `base_ns * 2**k`, so the sequence of widths is a
  pure function of the run (same simulation, same widths);
- it widens only when windows run nearly empty (fewer events than
  hosts) and the queues are slack, and halves at once on any new drop
  or a fill past the shrink threshold, since a wider window admits more
  events per barrier into queues of fixed capacity.

A fixed `--window N`, or no flag, bypasses this class.
"""

from __future__ import annotations


class WindowController:
    """Deterministic between-window width controller.

    `update` takes cumulative counters (executed, queue_drops) and the
    queue-fill fraction, and returns the width of the next window.
    """

    def __init__(self, base_ns: int, *, n_hosts: int, max_mult: int = 64,
                 fill_grow: float = 0.25, fill_shrink: float = 0.5):
        if base_ns < 1:
            raise ValueError(f"base window must be >= 1 ns, got {base_ns}")
        self.base_ns = int(base_ns)
        self.mult = 1
        self.max_mult = int(max_mult)
        # widen below one event per host per window
        self.ev_target = max(int(n_hosts), 1)
        self.fill_grow = float(fill_grow)
        self.fill_shrink = float(fill_shrink)
        self._prev_executed = 0
        self._prev_drops = 0
        # (mult, events_in_window, fill) per decision
        self.history: list[tuple[int, int, float]] = []

    @property
    def window_ns(self) -> int:
        return self.base_ns * self.mult

    def update(self, executed: int, queue_drops: int, fill: float) -> int:
        """One decision from the finished window's probe; returns the
        next window's width in ns."""
        ev = int(executed) - self._prev_executed
        new_drops = int(queue_drops) - self._prev_drops
        self._prev_executed = int(executed)
        self._prev_drops = int(queue_drops)
        if new_drops > 0 or fill > self.fill_shrink:
            # pressure: halve at once (a drop means capacity was already
            # exceeded)
            self.mult = max(1, self.mult // 2)
        elif (
            ev < self.ev_target
            and fill < self.fill_grow
            and self.mult < self.max_mult
        ):
            self.mult *= 2
        self.history.append((self.mult, ev, float(fill)))
        return self.window_ns
