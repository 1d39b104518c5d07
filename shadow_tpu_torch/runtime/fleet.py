"""Scenario fleets: one engine over L scenario lanes.

The counterpart of `shadow_tpu.runtime.fleet`. The reference vmaps its
whole window loop over the lanes; here a `Fleet` binds the lanes into
one engine (`Engine.bind_lanes`) whose per-host leaves hold the L x H
rows of every lane and whose scalars are [L], so every op of a window,
a sweep or an inner step runs once for the whole fleet and the merge
kernel merges every lane's rows in one launch per round. Chained,
batched and frontier drains all run this way.

Lane semantics, as in the reference:

- MAY vary per lane: RNG seed, fault schedule, a global latency scale
  (integer per-mille, applied before the window-barrier clamp), a NIC
  bandwidth scale (state-side, NIC-modelled hosts only), and arbitrary
  tensor-valued initial-state overrides (`state_override`).
- MUST be uniform: every static knob of the build (drain, frontier,
  window policy, capacity, host count, drain batch, trace/stats/spill
  depth). Violations raise with the knob named.

Termination: the window loop runs while any lane's window opens; a lane
whose window does not open takes the barrier below every time, so its
state stops changing while the fleet runs on to the last lane's stop.

Per-lane bit-identity rests on the reference's three facts: a lane's
root key is `rng.root_key` of its seed; a padded fault schedule is
values-neutral (`_T_INF` epoch starts are never reached, `lat * LAT_UNIT
// LAT_UNIT` is exact, a pass probability of 1.0 never drops); and the
per-event RNG is keyed on the lane's key and the host's lane-local gid.

A fleet state is an `EngineState` whose per-host leaves are [L * H,
...] (lane-major) and whose scalar leaves (`now`, `fault_epoch`, the
window, sweep and inner-step counters) are [L]. `lane_view` shows it as
the reference's [L, ...] leaves; `convert.fleet_state_to_numpy` gives
those as numpy.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Callable

import numpy as np
import torch

from shadow_tpu_torch.core import rng as srng
from shadow_tpu_torch.core.engine import EngineState
from shadow_tpu_torch.core.timebase import TIME_INVALID
from shadow_tpu_torch.faults.schedule import (
    LAT_UNIT,
    _T_INF,
    CompiledFaults,
    compile_faults,
)

# knobs fixed by the build; named so the refusal can say WHY a per-lane
# value cannot exist
STATIC_KNOBS = (
    "kernel", "frontier", "window", "capacity", "lookahead", "drain_batch",
    "n_hosts", "max_emit", "n_args", "trace", "stats", "spill", "batched",
    "overflow", "mesh", "n_shards", "stage_width", "route_bucket",
    "hot_hosts", "hot_weight", "msgs_per_host", "latency_ns",
    "mean_delay_ns",
)

LANE_KNOBS = ("seeds", "faults", "latency_scale", "bandwidth_scale",
              "state_override")

# EngineState leaves that are scalars in a solo state and [L] in a fleet
# state; every other leaf is per host
LANE_LEAVES = ("now", "fault_epoch", "stats.n_windows", "stats.n_sweeps",
               "stats.n_inner_steps", "stats.n_xchg_rounds",
               "stats.n_cross_shard")


def check_lane_knobs(overrides: dict) -> None:
    """Reject overrides that are not per-lane-capable, loudly."""
    for k in overrides:
        if k in LANE_KNOBS:
            continue
        if k in STATIC_KNOBS:
            raise ValueError(
                f"per-lane {k!r} is a static compile-time knob: a fleet "
                "shares ONE lowered program, so it must be uniform "
                "across lanes — set it on the base scenario and build "
                "separate fleets to sweep it"
            )
        raise ValueError(
            f"unknown fleet override {k!r}; per-lane knobs are "
            f"{LANE_KNOBS}"
        )


@dataclasses.dataclass(frozen=True)
class FleetPlan:
    """Per-lane overrides for a scenario fleet.

    Every sequence field has exactly `lanes` entries (validated);
    `None` means "no override": all lanes inherit the base scenario.

    seeds           per-lane RNG seeds (default: base cfg.seed for all).
    faults          per-lane fault-spec tuples (entry None/() = no
                    faults for that lane). Replaces, never merges with,
                    a base-scenario schedule.
    latency_scale   per-lane multiplier on every path latency, applied
                    as integer per-mille BEFORE the window-barrier
                    clamp (`scaled_network` is the solo equivalent).
    bandwidth_scale per-lane multiplier on NIC rates (state-side;
                    requires a NIC-modelled host tier).
    state_override  fn(lane, state0) -> state0 for arbitrary per-lane
                    tensor-valued model parameters.
    """

    lanes: int
    seeds: tuple | None = None
    faults: tuple | None = None
    latency_scale: tuple | None = None
    bandwidth_scale: tuple | None = None
    state_override: Callable[[int, Any], Any] | None = None

    def __post_init__(self):
        if self.lanes < 1:
            raise ValueError(f"a fleet needs >= 1 lane, got {self.lanes}")
        for nm in ("seeds", "faults", "latency_scale", "bandwidth_scale"):
            v = getattr(self, nm)
            if v is None:
                continue
            v = tuple(v)
            object.__setattr__(self, nm, v)
            if len(v) != self.lanes:
                raise ValueError(
                    f"plan.{nm} has {len(v)} entries for {self.lanes} "
                    "lanes"
                )
        if self.latency_scale is not None:
            for s in self.latency_scale:
                if s < 0:
                    raise ValueError(f"latency_scale {s} < 0")
        if self.bandwidth_scale is not None:
            for s in self.bandwidth_scale:
                if s <= 0:
                    raise ValueError(f"bandwidth_scale {s} <= 0")


class ScaledLatencyNetwork:
    """A base topology with its path latency scaled by an integer
    per-mille: `lat * lat_milli // LAT_UNIT`, exact for the identity
    scale. A solo run over it reproduces a fleet lane's latency scale
    bit for bit."""

    def __init__(self, base, lat_milli: int):
        self._base = base
        self._lat_milli = int(lat_milli)
        self.has_jitter = bool(getattr(base, "has_jitter", False))

    def route(self, src, dst):
        lat, rel, jit = self._base.route(src, dst)
        return lat * self._lat_milli // LAT_UNIT, rel, jit


def scaled_network(base, scale: float) -> ScaledLatencyNetwork:
    """The solo-run equivalent of a fleet lane's latency_scale."""
    return ScaledLatencyNetwork(base, int(round(scale * LAT_UNIT)))


def _pad_faults(comp: list[CompiledFaults], tmax: int | None = None,
                gmax: int | None = None, *, device=None):
    """Pad per-lane CompiledFaults to one shape and stack them.

    Values-neutral by construction: epoch-time pads are `_T_INF` (never
    reached), alive pads are True, latency pads are LAT_UNIT (1.0x),
    pass pads are 1.0 and bandwidth pads are 1.0. Returns ({bind tensors
    [L, ...], "f_np_times": the host copy of the times}, flags).
    `tmax`/`gmax` optionally force minimum epoch/group padding targets
    (one bind shape for a family of schedules)."""
    t_need = max(f.np_times.shape[0] for f in comp)
    g_need = max(int(f.lat_milli.shape[1]) for f in comp)
    tmax = t_need if tmax is None else max(int(tmax), t_need)
    gmax = g_need if gmax is None else max(int(gmax), g_need)
    hg = int(comp[0].alive.shape[1])
    if device is None:
        device = comp[0].times.device
    times, alive, fgrp, lat, passp, bw = [], [], [], [], [], []
    for f in comp:
        t = int(f.np_times.shape[0])
        g = int(f.lat_milli.shape[1])
        times.append(np.concatenate(
            [np.asarray(f.np_times),
             np.full((tmax - t,), _T_INF, np.int64)]))
        alive.append(np.concatenate(
            [np.asarray(f.np_alive), np.ones((tmax - t, hg), bool)],
            axis=0))
        fgrp.append(f.fgrp.cpu().numpy())
        la = np.full((tmax, gmax, gmax), LAT_UNIT, np.int64)
        la[:t, :g, :g] = f.lat_milli.cpu().numpy()
        lat.append(la)
        pp = np.ones((tmax, gmax, gmax), np.float32)
        pp[:t, :g, :g] = f.passp.cpu().numpy()
        passp.append(pp)
        bw.append(np.concatenate(
            [f.bw_scale.cpu().numpy(), np.ones((tmax - t, hg), np.float32)],
            axis=0))
    on = lambda xs: torch.from_numpy(np.ascontiguousarray(
        np.stack(xs))).to(device)
    binds = {
        "f_times": on(times),
        "f_alive": on(alive),
        "f_fgrp": on(fgrp),
        "f_lat": on(lat),
        "f_passp": on(passp),
        "f_bw": on(bw),
        "f_np_times": np.stack(times),
    }
    flags = (
        any(f.has_crash for f in comp),
        any(f.has_link for f in comp),
        any(f.has_bw for f in comp),
    )
    return binds, flags


def _lane_sum(x: torch.Tensor, lanes: int) -> torch.Tensor:
    return x.reshape(lanes, -1).sum(dim=1)


def lane_summary_refs(state) -> dict:
    """Per-lane device reductions over a fleet state, with
    `core.engine.state_summary`'s keys: each value an [L] tensor. The
    harvest's fleet bundle carries these."""
    lanes = int(state.now.shape[0])
    out = {
        "now_ns": state.now,
        "windows": state.stats.n_windows,
        "executed": _lane_sum(state.stats.n_executed, lanes),
        "sweeps": state.stats.n_sweeps,
        "queue_drops": _lane_sum(state.queues.drops, lanes),
    }
    ring = state.queues.spill
    if ring is not None:
        out["spilled"] = _lane_sum(ring.n_spilled, lanes)
        out["spill_lost"] = _lane_sum(ring.n_lost, lanes)
        out["fill_hwm"] = ring.fill_hwm.reshape(lanes, -1).max(dim=1).values
    return out


def lane_fill_refs(q, lanes: int) -> torch.Tensor:
    """Each lane's mean queue slot occupancy as f32 [L], as the
    reference's `jnp.mean` over a lane's slots: the lane's valid count
    (exact in f32 below 2^24) times the f32 reciprocal of its slot count."""
    n = torch.sum((q.time != TIME_INVALID).reshape(lanes, -1), dim=1,
                  dtype=torch.int64)
    recip = np.float32(1.0) / np.float32(q.time.numel() // lanes)
    return n.to(torch.float32) * torch.full(
        (), float(recip), dtype=torch.float32, device=q.time.device)


def lane_summaries_from(fetched: dict) -> list[dict]:
    """Split fetched [L]-valued summary arrays into per-lane dicts, each
    equal to the solo run's `state_summary`; keys in sorted order, as
    the reference's fetched dicts have them."""
    lanes = int(np.asarray(fetched["now_ns"]).shape[0])
    return [
        {k: int(np.asarray(fetched[k])[i]) for k in sorted(fetched)}
        for i in range(lanes)
    ]


def aggregate_summary(fetched: dict) -> dict:
    """One fleet-level progress dict from [L] summary arrays: the clock
    is the SLOWEST lane (the fleet runs until the last lane stops),
    event totals sum, loop counters take the deepest lane."""
    out = {}
    for k in sorted(fetched):
        a = np.asarray(fetched[k])
        if k == "now_ns":
            out[k] = int(a.min())
        elif k in ("windows", "sweeps", "fill_hwm"):
            out[k] = int(a.max())
        else:
            out[k] = int(a.sum())
    return out


# -- the lane layout ---------------------------------------------------------

def _tree_map(fn, *trees, prefix: str = ""):
    """fn(key, *leaves) over the leaves of trees of one structure
    (dataclass, dict, tuple, list; None kept), rebuilt in that structure.
    A leaf's key is its path joined by dots, as `convert` keys leaves."""
    t0 = trees[0]
    if t0 is None:
        return None
    if dataclasses.is_dataclass(t0):
        return dataclasses.replace(t0, **{
            f.name: _tree_map(fn, *[getattr(t, f.name) for t in trees],
                              prefix=f"{prefix}{f.name}.")
            for f in dataclasses.fields(t0)})
    if isinstance(t0, dict):
        return {k: _tree_map(fn, *[t[k] for t in trees],
                             prefix=f"{prefix}{k}.") for k in t0}
    if isinstance(t0, (tuple, list)):
        return type(t0)(_tree_map(fn, *xs, prefix=f"{prefix}{i}.")
                        for i, xs in enumerate(zip(*trees)))
    return fn(prefix[:-1], *trees)


def _tree_leaves(tree) -> list:
    """(key, leaf) of every leaf of a tree, in `_tree_map`'s order."""
    out = []
    _tree_map(lambda k, t: out.append((k, t)), tree)
    return out


def stack_lanes(states: list) -> EngineState:
    """One fleet state from L solo states of one build: per-host leaves
    concatenated lane-major, scalar leaves stacked to [L]."""
    return _tree_map(
        lambda k, *ts: (torch.stack(ts) if ts[0].dim() == 0
                        else torch.cat(ts)), *states)


def lane_view(state: EngineState) -> EngineState:
    """A fleet state with every leaf led by the lane axis, as the
    reference's [L, ...] leaves: per-host [L * H, ...] leaves viewed as
    [L, H, ...], the [L] scalars as they are."""
    lanes = int(state.now.shape[0])
    return _tree_map(
        lambda k, t: t if k in LANE_LEAVES
        else t.reshape((lanes, t.shape[0] // lanes) + tuple(t.shape[1:])),
        state)


def row_view(state: EngineState) -> EngineState:
    """The inverse of `lane_view`: [L, H, ...] leaves back to [L * H,
    ...] rows, the [L] scalars as they are."""
    return _tree_map(
        lambda k, t: t if k in LANE_LEAVES
        else t.reshape((-1,) + tuple(t.shape[2:])), state)


class Fleet:
    """L scenario lanes run as one engine.

    Has the part of `Simulation` the harvest and the CLI use (`state0`,
    `mesh`, `spmd_path`, `pressure`, `profiler`, `engine`,
    `_fresh_state`, `_note_owned`, `dispatch`, `check_drops`), so
    `HeartbeatHarvest` drives a fleet as it drives a solo run.
    """

    mesh = None
    spmd_path = None
    pressure = None
    profiler = None

    def __init__(self, engine, state0, plan: FleetPlan, *, names=None,
                 stop_ns: int = 0, strict_overflow: bool = True,
                 per_lane_stop: bool = False, fault_pad=None):
        if engine.cfg.axis_name is not None:
            raise ValueError(
                "fleets vmap the single-device engine; a sharded base "
                "scenario is not supported (shard across fleets instead)"
            )
        self.base = engine
        self.plan = plan
        self.lanes = plan.lanes
        self.stop_ns = stop_ns
        self.names = list(names) if names is not None else None
        self.strict_overflow = strict_overflow
        # per_lane_stop: the stop becomes one per lane, so every lane
        # ends its last window at its own stop, as its solo run does
        self.per_lane_stop = bool(per_lane_stop)
        # fault_pad: (tmax, gmax) minimum fault-array padding targets
        self._fault_pad = fault_pad
        self._base_state0 = state0
        self.seeds, self.state0, binds, self._fault_flags = \
            self._plan_inputs(plan)
        self.binds = binds
        self.engine = self._bind(binds)
        self._owned = None

    def _plan_inputs(self, plan: FleetPlan):
        """A plan's launch inputs: per-lane seeds, the stacked initial
        state, the bind dict and the fault flags (host-side work and one
        copy of each input to the device)."""
        engine, state0 = self.base, self._base_state0
        lanes = plan.lanes
        seeds = plan.seeds
        if seeds is None:
            seeds = tuple(engine.cfg.seed for _ in range(lanes))
        seeds = tuple(int(s) for s in seeds)

        lane_states = []
        for i in range(lanes):
            st = state0
            if plan.state_override is not None:
                st = plan.state_override(i, st)
            if plan.bandwidth_scale is not None:
                st = _scale_nic(st, plan.bandwidth_scale[i])
            lane_states.append(st)
        stacked = stack_lanes(lane_states)

        dev = engine.device
        binds: dict[str, Any] = {
            "key": torch.stack([srng.root_key(s, dev) for s in seeds]),
        }
        fault_flags = None
        if plan.faults is not None and any(plan.faults):
            if engine.faults is not None:
                raise ValueError(
                    "the base scenario already compiles a fault "
                    "schedule; per-lane fault overrides REPLACE the "
                    "schedule — build the base without faults and give "
                    "every lane its own spec list"
                )
            hg = engine.cfg.n_hosts * engine.cfg.n_shards
            nm = self.names or [f"host{i}" for i in range(hg)]
            comp = [
                compile_faults(tuple(sp or ()), nm, hg, seeds[i],
                               device=dev)
                for i, sp in enumerate(plan.faults)
            ]
            pad = self._fault_pad or (None, None)
            fb, flags = _pad_faults(comp, pad[0], pad[1], device=dev)
            if any(flags):
                binds.update(fb)
                fault_flags = flags
                if flags[0] or flags[2]:
                    # crash/bw epochs re-template host rows: each lane's
                    # own initial hosts are its restart template
                    binds["fault_reset"] = stacked.hosts
        if plan.latency_scale is not None:
            binds["lat_milli"] = torch.tensor(
                [int(round(s * LAT_UNIT)) for s in plan.latency_scale],
                dtype=torch.int64, device=dev)
        return seeds, stacked, binds, fault_flags

    def make_inputs(self, plan: FleetPlan):
        """Launch inputs `(state0, binds)` for a NEW plan of the same
        shape: same lane count, same fault flags, binds of the same
        shapes (the fault pad targets pinned at build time make
        schedules of differing length land on one shape). Violations
        raise. Pass the binds to `run`/`dispatch`/`step_window`."""
        if plan.lanes != self.lanes:
            raise ValueError(
                f"plan has {plan.lanes} lanes; this fleet compiled "
                f"{self.lanes} — pad short batches with inert lanes "
                "(inert_lane_state) instead of rebuilding"
            )
        _, state0, binds, flags = self._plan_inputs(plan)
        if flags != self._fault_flags:
            raise ValueError(
                f"fault flags {flags} do not match the compiled "
                f"template's {self._fault_flags}; fault-kind mix is a "
                "static knob of the lowered program — route this batch "
                "to its own equivalence class"
            )
        # the restart template is a hosts state: its type stands for it
        shape = lambda b: {k: tuple(v.shape) if hasattr(v, "shape")
                           else type(v) for k, v in b.items()}
        if shape(binds) != shape(self.binds):
            raise ValueError(
                "bind structure/shape mismatch vs the compiled "
                "template; the batch needs its own equivalence class"
            )
        return self._note_owned(state0), binds

    # -- lane binding -----------------------------------------------------

    def _bind(self, b: dict):
        """The lane engine for a bind dict (`Engine.bind_lanes`)."""
        flags = self._fault_flags
        faults = None
        if "f_times" in b:
            faults = CompiledFaults(
                times=b["f_times"], alive=b["f_alive"], fgrp=b["f_fgrp"],
                lat_milli=b["f_lat"], passp=b["f_passp"],
                bw_scale=b["f_bw"], has_crash=flags[0], has_link=flags[1],
                has_bw=flags[2], np_times=b["f_np_times"],
                np_alive=b["f_alive"].cpu().numpy())
        return self.base.bind_lanes(
            b["key"], faults=faults, fault_reset=b.get("fault_reset"),
            lat_milli=b.get("lat_milli"))

    def _engine_for(self, binds):
        return self.engine if binds is None else self._bind(binds)

    # -- run / dispatch ---------------------------------------------------

    def _stop_arg(self, stop_ns):
        """The stop of a call: one for all lanes, or with per_lane_stop
        one per lane (the engine takes a scalar or an [L] stop)."""
        if self.per_lane_stop:
            return stop_ns
        if np.ndim(stop_ns) != 0:
            raise ValueError("a per-lane stop needs a fleet built with "
                             "per_lane_stop=True")
        return int(stop_ns)

    def run(self, stop_ns: int | None = None, state=None, *, binds=None):
        """Run every lane to its stop (finished lanes idle); returns the
        fleet's final state. `binds` optionally swaps in another plan's
        lane knobs from `make_inputs`."""
        st = self._fresh_state(state)
        stop = self._stop_arg(stop_ns if stop_ns is not None
                              else self.stop_ns)
        eng = self._engine_for(binds)
        out = self._note_owned(eng.run(st, stop))
        if self.strict_overflow:
            drops = int(eng._fetch(out.queues.drops.sum()))
            if drops > 0:
                self.check_drops(drops, self.summary(out))
        return out

    def dispatch(self, stop_ns, state, window_ns: int | None = None,
                 *, binds=None):
        """The next segment with no overflow probe (the CLI reads drops
        from the harvest): to the stop, or with `window_ns` one window of
        that width."""
        st = self._fresh_state(state)
        stop = self._stop_arg(stop_ns)
        eng = self._engine_for(binds)
        if window_ns is None:
            return self._note_owned(eng.run(st, stop))
        return self._note_owned(eng.step_window(st, stop,
                                                window=int(window_ns)))

    def step_window(self, state, stop_ns=None,
                    window_ns: int | None = None, *, binds=None):
        """Advance every live lane one conservative window."""
        st = self._fresh_state(state)
        stop = self._stop_arg(stop_ns if stop_ns is not None
                              else self.stop_ns)
        return self._note_owned(self._engine_for(binds).step_window(
            st, stop, window=None if window_ns is None else int(window_ns)))

    # -- summaries --------------------------------------------------------

    def lane_summaries(self, state) -> list[dict]:
        """Per-lane summary dicts, each equal to the lane's solo
        `state_summary`."""
        from shadow_tpu_torch.runtime.harvest import fetch_tree

        return lane_summaries_from(fetch_tree(lane_summary_refs(state)))

    def summary(self, state) -> dict:
        """Fleet-aggregate progress dict (see `aggregate_summary`)."""
        from shadow_tpu_torch.runtime.harvest import fetch_tree

        return aggregate_summary(fetch_tree(lane_summary_refs(state)))

    def check_drops(self, drops: int, summary: dict | None = None):
        if int(drops) <= 0:
            return
        if self.strict_overflow:
            raise RuntimeError(
                f"event queue overflow: {int(drops)} events dropped "
                "across the fleet (per-host capacity "
                f"{self.base.cfg.capacity}); rerun with a larger "
                "--capacity, or set strict_overflow=False to accept "
                "counted drops"
            )

    # -- state ownership (as Simulation) ----------------------------------

    def _fresh_state(self, state):
        """The state a call starts from: `state0` when None. States are
        never updated in place, so no copy is needed."""
        return self.state0 if state is None else state

    def _note_owned(self, state):
        if self._owned is None:
            self._owned = weakref.WeakValueDictionary()
        self._owned[id(state)] = state
        return state

    def adopt_state(self, state):
        """Take an externally built fleet state (numpy or tensor leaves,
        e.g. a loaded checkpoint's) as this fleet's: every leaf is
        copied onto the engine's device, so the caller's buffers are
        never shared."""
        dev = self.base.device
        state = _tree_map(
            lambda k, t: torch.as_tensor(np.asarray(t) if not isinstance(
                t, torch.Tensor) else t).to(dev, copy=True), state)
        return self._note_owned(state)


def inert_lane_state(state):
    """A zero-event lane state: every queue slot emptied (time ==
    TIME_INVALID), everything else untouched.

    The window loop's test is `next_event < stop`, so an inert lane runs
    no window: its counters, drop counts and queues stay as they were and
    only `now` lands on its stop. A partial batch rides a fleet of more
    lanes this way, its pad lanes provably idle."""
    q = state.queues
    q = dataclasses.replace(q, time=torch.full_like(q.time, TIME_INVALID))
    return dataclasses.replace(state, queues=q)


def lane_reshard(state, new_lanes: int) -> list:
    """Split a lane-stacked state into parts of `new_lanes` lanes each.

    `state` is a fleet `EngineState` (its parts are fleet states) or any
    tree whose leaves all lead with the lane axis, such as the raw
    {leaf path: array} of a loaded checkpoint. Refuses loudly (leaf
    named) on scalar leaves, leaves that disagree about L, and lane
    counts that do not divide evenly: a silent truncation would drop
    in-flight lanes."""
    is_state = isinstance(state, EngineState)
    tree = lane_view(state) if is_state else state
    leaves = _tree_leaves(tree)
    if not leaves:
        raise ValueError("lane_reshard: empty state tree")
    lanes = -1
    for path, leaf in leaves:
        shape = tuple(np.shape(leaf))
        if not shape:
            raise ValueError(
                f"lane_reshard: leaf {path!r} is a scalar — every "
                "leaf of a lane-stacked tree must lead with the LANE "
                "axis"
            )
        if lanes < 0:
            lanes = int(shape[0])
        elif int(shape[0]) != lanes:
            raise ValueError(
                f"lane_reshard: leaf {path!r} has leading dim "
                f"{int(shape[0])} but earlier leaves have {lanes} — "
                "this tree is not lane-stacked along a shared axis"
            )
    if new_lanes <= 0 or lanes % new_lanes != 0:
        raise ValueError(
            f"lane_reshard: cannot split {lanes} lanes into parts of "
            f"{new_lanes} — the part size must divide the lane count "
            "evenly (a remainder would strand in-flight lanes)"
        )
    parts = []
    for j in range(lanes // new_lanes):
        lo, hi = j * new_lanes, (j + 1) * new_lanes
        part = _tree_map(lambda k, x: x[lo:hi], tree)
        parts.append(row_view(part) if is_state else part)
    return parts


def lane_merge(states: list):
    """Concatenate lane-stacked states along the lane axis: the inverse
    of `lane_reshard`. Fleet `EngineState`s merge into one (tensors);
    other trees come back with numpy leaves (adopt them through
    `Fleet.adopt_state`)."""
    if not states:
        raise ValueError("lane_merge: no states to merge")
    if len(states) == 1:
        return states[0]
    if isinstance(states[0], EngineState):
        return row_view(_tree_map(lambda k, *xs: torch.cat(xs),
                                  *[lane_view(s) for s in states]))
    return _tree_map(
        lambda k, *xs: np.concatenate([np.asarray(x) for x in xs], axis=0),
        *states)


def _scale_nic(state, scale: float):
    """Scale a lane's NIC rates in its initial state (bandwidth knob)."""
    hosts = state.hosts
    net = getattr(hosts, "net", None)
    if net is None or getattr(net, "nic_tx", None) is None:
        raise ValueError(
            "per-lane bandwidth_scale needs a NIC-modelled host tier "
            "(hosts.net.nic_tx); this scenario's hosts carry none — "
            "use latency_scale or a fault schedule instead"
        )

    def _scaled(nic):
        return dataclasses.replace(
            nic, rate=(nic.rate * scale).to(nic.rate.dtype))

    net = dataclasses.replace(
        net, nic_tx=_scaled(net.nic_tx), nic_rx=_scaled(net.nic_rx))
    return dataclasses.replace(
        state, hosts=dataclasses.replace(hosts, net=net))


def build_fleet_from_engine(engine, state0, lanes: int, *, names=None,
                            stop_ns: int = 0, **overrides) -> Fleet:
    """Build a Fleet over a raw (engine, initial state) pair, the model
    tier's entry point (`phold.build_fleet`). Per-lane knob names are
    checked against `LANE_KNOBS`; static knobs are refused with the
    reason."""
    check_lane_knobs(overrides)
    plan = FleetPlan(lanes=lanes, **overrides)
    return Fleet(engine, state0, plan, names=names, stop_ns=stop_ns)
