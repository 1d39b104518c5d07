"""The conservative-window simulation engine, batched (commutative) drain.

The counterpart of `shadow_tpu.core.engine` for engines built with a
`batch_handler`: every host executes its whole below-barrier frontier
in one [H, B]-shaped handler call per sweep, the sweep's routed emits
are pushed into the queues, and sweeps repeat until no host has an
event below the window barrier. Windows open at the global earliest
event time and are `lookahead` wide.

JAX's `lax.while_loop`/`lax.cond` become Python loops and branches on a
flag read from the device; `Engine.host_syncs` counts those reads. The
per-window reads are the loop test in `run`/`step_window` and the drain's
first flag; each sweep adds its drain flag and the push's fallback-round
decision.

Not ported (each raises NotImplementedError): the chained and frontier
drains (an engine without `batch_handler`), tracing, the stats plane,
the spill ring, burst folding, sharding, faults and the CPU model.
`ConstantNetwork` has no jitter yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import torch

from shadow_tpu_torch.core import rng as srng
from shadow_tpu_torch.core.events import (
    N_ARGS,
    EventQueue,
    Events,
    queue_push,
)
from shadow_tpu_torch.core.timebase import TIME_INVALID


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: `None` means "cuda", and a CUDA
    device must exist. There is no fallback to the CPU; pass "cpu" to
    run there."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "shadow_tpu_torch runs on CUDA by default and no CUDA device "
            "is available; pass device='cpu' to run on the CPU"
        )
    return dev


@dataclasses.dataclass(frozen=True)
class Emit:
    """Events emitted by handler invocations: [..., K] fields.

    dst is a global host id, dt a non-negative delay relative to the
    executing event's time. local=True is a same-host task (no routing);
    local=False a network send that the engine routes: path latency,
    reliability roll, barrier clamp.
    """

    dst: torch.Tensor  # i32[..., K]
    dt: torch.Tensor  # i64[..., K]
    kind: torch.Tensor  # i32[..., K]
    args: torch.Tensor  # i32[..., K, N_ARGS]
    mask: torch.Tensor  # bool[..., K]
    local: torch.Tensor  # bool[..., K]


@dataclasses.dataclass(frozen=True)
class Stats:
    """Per-host accounting, with the reference's dtypes."""

    n_executed: torch.Tensor  # i64[H]
    n_emitted: torch.Tensor  # i64[H]
    n_net_dropped: torch.Tensor  # i64[H] packets lost to reliability rolls
    n_windows: torch.Tensor  # i64[]
    n_by_kind: torch.Tensor  # i64[H, NK] executed events per handler kind
    n_sweeps: torch.Tensor  # i64[] drain sweeps (queue merges)
    n_inner_steps: torch.Tensor  # i64[] (chained drain only; stays 0)
    n_xchg_rounds: torch.Tensor  # i64[] (sharded only; stays 0)
    n_cross_shard: torch.Tensor  # i64[] (sharded only; stays 0)
    n_fault_dropped: torch.Tensor  # i64[H] (faults only; stays 0)
    n_quarantined: torch.Tensor  # i64[H] (faults only; stays 0)

    @staticmethod
    def create(n_hosts: int, n_kinds: int, *, device) -> "Stats":
        i64 = torch.int64
        z = lambda: torch.zeros((n_hosts,), dtype=i64, device=device)
        s = lambda: torch.zeros((), dtype=i64, device=device)
        return Stats(
            z(), z(), z(), s(),
            torch.zeros((n_hosts, n_kinds), dtype=i64, device=device),
            s(), s(), s(), s(), z(), z(),
        )


@dataclasses.dataclass(frozen=True)
class EngineState:
    """Complete simulation state: tensors only, the leaves of the
    reference's EngineState with no trace, exchange or stats plane."""

    now: torch.Tensor  # i64[] current window start
    queues: EventQueue
    hosts: Any  # model dataclass, every tensor [H, ...]
    src_seq: torch.Tensor  # i32[H] per-source sequence counters
    exec_cnt: torch.Tensor  # i32[H] per-host executed-event counters (RNG)
    stats: Stats
    cpu_free: torch.Tensor  # i64[H] (CPU model only; stays 0)
    fault_epoch: torch.Tensor  # i32[] (faults only; stays 0)


def state_summary(state: EngineState) -> dict:
    """Host-side progress snapshot: one device-to-host copy of a handful
    of scalars."""
    vals = torch.stack([
        state.now, state.stats.n_windows, state.stats.n_executed.sum(),
        state.stats.n_sweeps, state.queues.drops.sum(),
    ]).tolist()
    return dict(zip(
        ("now_ns", "windows", "executed", "sweeps", "queue_drops"), vals
    ))


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    n_hosts: int  # hosts
    capacity: int  # event queue slots per host
    lookahead: int  # conservative window width, ns
    max_emit: int = 2  # K: max events emitted per handler invocation
    n_args: int = N_ARGS
    seed: int = 0
    drain_batch: int = 32  # B: frontier events executed per host per sweep
    # knobs of paths this package does not port; any other value raises
    axis_name: str | None = None
    n_shards: int = 1
    trace: int = 0
    spill: int = 0
    burst: tuple | None = None
    frontier: int = 0
    stats: int = 0

    def __post_init__(self):
        if self.lookahead < 1:
            raise ValueError(
                f"lookahead must be >= 1 ns, got {self.lookahead}")
        unported = {
            "axis_name": self.axis_name is not None,
            "n_shards": self.n_shards != 1,
            "trace": self.trace != 0,
            "spill": self.spill != 0,
            "burst": self.burst is not None,
            "frontier": self.frontier != 0,
            "stats": self.stats != 0,
        }
        for name, set_ in unported.items():
            if set_:
                raise NotImplementedError(f"EngineConfig.{name} is not ported")

    @property
    def eff_drain_batch(self) -> int:
        return max(1, min(self.drain_batch, self.capacity))


class ConstantNetwork:
    """Uniform complete-graph network: fixed latency and reliability."""

    def __init__(self, latency_ns: int, reliability: float = 1.0):
        self.latency_ns = latency_ns
        self.reliability = reliability


def _select_rows(mask: torch.Tensor, new: Any, old: Any) -> Any:
    """Per-host select across two model dataclasses of [H, ...] tensors."""
    def sel(n, o):
        return torch.where(mask.reshape(mask.shape + (1,) * (n.dim() - 1)),
                           n, o)

    return dataclasses.replace(old, **{
        f.name: sel(getattr(new, f.name), getattr(old, f.name))
        for f in dataclasses.fields(old)
    })


class Engine:
    """Window-step / run functions over a batched handler.

    `batch_handler(hosts, evs, keys) -> (hosts', Emit)` takes the model's
    host dataclass, Events with [H, B] fields and handler keys
    [H, B, 2], and returns Emit with [H, B, K] fields. It must fold state
    commutatively across a frontier and never emit local events below
    the barrier (the reference's batch_handler contract). `handlers`
    only sets the number of event kinds (the width of `n_by_kind`).
    """

    def __init__(self, cfg: EngineConfig, handlers: Sequence[Callable],
                 network: ConstantNetwork, cpu_cost=None,
                 batch_handler: Callable | None = None, faults=None,
                 device=None):
        if batch_handler is None:
            raise NotImplementedError(
                "the chained drain is not ported: pass batch_handler")
        if cpu_cost is not None:
            raise NotImplementedError("the CPU model is not ported")
        if faults is not None:
            raise NotImplementedError("fault schedules are not ported")
        self.cfg = cfg
        self.n_kinds = len(handlers)
        self.network = network
        self.batch_handler = batch_handler
        self.device = resolve_device(device)
        self._base_key = srng.root_key(cfg.seed, self.device)
        self._rel = torch.tensor(network.reliability, dtype=torch.float32,
                                 device=self.device)
        self.host_syncs = 0

    def _read(self, flag: torch.Tensor) -> bool:
        """A device-to-host read of a 0-d bool: the loop and branch tests
        that `lax.while_loop`/`lax.cond` kept on the device."""
        self.host_syncs += 1
        return bool(flag)

    def init_state(self, hosts: Any, initial: Events,
                   host0: int = 0) -> EngineState:
        cfg, dev = self.cfg, self.device
        h = cfg.n_hosts
        q = EventQueue.create(h, cfg.capacity, cfg.n_args, device=dev)
        flat = initial.flatten()
        valid = flat.time != TIME_INVALID
        q = queue_push(q, flat, valid, host0, self._read)
        # each source's sequence counter starts past any seq its initial
        # events consumed: a scatter-max over in-range rows (row H is the
        # discard row for the rest)
        local_src = flat.src - host0
        rows = torch.where(valid & (local_src >= 0) & (local_src < h),
                           local_src, h).long()
        seq0 = torch.zeros((h + 1,), dtype=torch.int32, device=dev)
        seq0 = seq0.scatter_reduce(0, rows, flat.seq + 1, reduce="amax")[:h]
        return EngineState(
            now=torch.zeros((), dtype=torch.int64, device=dev),
            queues=q,
            hosts=hosts,
            src_seq=seq0,
            exec_cnt=torch.zeros((h,), dtype=torch.int32, device=dev),
            stats=Stats.create(h, self.n_kinds, device=dev),
            cpu_free=torch.zeros((h,), dtype=torch.int64, device=dev),
            fault_epoch=torch.zeros((), dtype=torch.int32, device=dev),
        )

    # -- emit routing --------------------------------------------------------
    def _route(self, emit: Emit, base_time, gids, window_end, rkeys, emask,
               seq):
        """Route an [N, K] emit batch: local tasks keep their time; network
        sends add path latency, roll reliability and clamp to the window
        barrier. Returns (Events[N, K], final_mask, dropped)."""
        n, k = emit.dst.shape
        self_gid = gids[:, None]
        is_local = emit.local
        dst = torch.where(is_local, self_gid, emit.dst)
        dt = torch.clamp(emit.dt, min=0)
        t = base_time[:, None] + dt
        t_remote = torch.clamp(t + self.network.latency_ns, min=window_end)
        u = srng.uniform_lanes(rkeys, k, 0)
        dropped = ~is_local & (u >= self._rel) & emask
        t = torch.where(is_local, t, t_remote)
        final_mask = emask & ~dropped
        out = Events(
            time=torch.where(final_mask, t, TIME_INVALID),
            dst=dst,
            src=self_gid.expand(n, k).to(torch.int32),
            seq=seq,
            kind=emit.kind,
            args=emit.args,
        )
        return out, final_mask, dropped

    # -- the batched drain ---------------------------------------------------
    def _drain_flag(self, q: EventQueue, window_end) -> torch.Tensor:
        """True while any host still has an event below the barrier."""
        return torch.any(q.min_time() < window_end)

    def _sweep(self, st: EngineState, window_end, host0: int) -> EngineState:
        """One sweep: execute every host's below-barrier frontier in one
        handler call, route the emits, clear the frontier, push."""
        cfg, dev = self.cfg, self.device
        h, k, c = cfg.n_hosts, cfg.max_emit, cfg.capacity
        b = cfg.eff_drain_batch
        q = st.queues
        gids = host0 + torch.arange(h, dtype=torch.int32, device=dev)
        gids_hb = gids[:, None].expand(h, b)
        bt = q.time[:, :b]
        run = bt < window_end  # a prefix: rows are key-sorted
        evs = Events(
            time=torch.where(run, bt, TIME_INVALID),
            dst=gids_hb,
            src=q.src[:, :b],
            seq=q.seq[:, :b],
            kind=q.kind[:, :b],
            args=q.args[:, :b],
        )
        cnts = st.exec_cnt[:, None] + torch.arange(b, dtype=torch.int32,
                                                   device=dev)[None, :]
        hk, rk = srng.event_keys(self._base_key, gids_hb.reshape(-1),
                                 cnts.reshape(-1))
        hosts2, emit = self.batch_handler(st.hosts, evs,
                                          hk.reshape(h, b, 2))
        n_run = torch.sum(run, dim=1, dtype=torch.int32)
        hosts = _select_rows(n_run > 0, hosts2, st.hosts)
        emask = emit.mask & run[:, :, None]

        # dense per-source sequence numbers across the [B, K] lanes
        inc = emask.to(torch.int32).reshape(h, b * k)
        within = torch.cumsum(inc, dim=1, dtype=torch.int32) - inc
        seq = (st.src_seq[:, None] + within).reshape(h, b, k)
        src_seq = st.src_seq + torch.sum(inc, dim=1, dtype=torch.int32)

        flat = lambda a: a.reshape((h * b,) + tuple(a.shape[2:]))
        out, final_mask, dropped = self._route(
            Emit(**{f.name: flat(getattr(emit, f.name))
                    for f in dataclasses.fields(emit)}),
            evs.time.reshape(-1),
            gids_hb.reshape(-1),
            window_end,
            rk,
            flat(emask),
            flat(seq),
        )
        s = st.stats
        # one-hot by compare (torch's one_hot validates its input with a
        # device-to-host read)
        kind_hot = (
            torch.clamp(evs.kind, 0, self.n_kinds - 1)[:, :, None]
            == torch.arange(self.n_kinds, dtype=torch.int32, device=dev)
        ).to(torch.int64)
        stats = dataclasses.replace(
            s,
            n_executed=s.n_executed + n_run,
            n_emitted=s.n_emitted + torch.sum(inc, dim=1, dtype=torch.int64),
            n_net_dropped=s.n_net_dropped + torch.sum(
                dropped.reshape(h, b * k), dim=1, dtype=torch.int64),
            n_by_kind=s.n_by_kind + torch.sum(
                kind_hot * run[:, :, None], dim=1),
            n_sweeps=s.n_sweeps + 1,
        )
        cleared = (torch.arange(c, dtype=torch.int32, device=dev)[None, :]
                   < n_run[:, None])
        q = dataclasses.replace(
            q, time=torch.where(cleared, TIME_INVALID, q.time))
        q = queue_push(q, out.flatten(), final_mask.reshape(-1), host0,
                       self._read)
        return dataclasses.replace(
            st, queues=q, hosts=hosts, src_seq=src_seq,
            exec_cnt=st.exec_cnt + n_run, stats=stats,
        )

    def _drain_window_batched(self, st: EngineState, window_end,
                              host0: int) -> EngineState:
        """Sweep until no host has an event below `window_end`."""
        while self._read(self._drain_flag(st.queues, window_end)):
            st = self._sweep(st, window_end, host0)
        return dataclasses.replace(st, stats=dataclasses.replace(
            st.stats, n_windows=st.stats.n_windows + 1))

    # -- windows -------------------------------------------------------------
    def _next_time(self, st: EngineState) -> torch.Tensor:
        """Global earliest pending event time (TIME_INVALID when empty)."""
        return torch.min(st.queues.min_time())

    def _advance(self, st: EngineState, nxt, stop, host0: int
                 ) -> EngineState:
        """Open the window [nxt, min(nxt + lookahead, stop)) and drain it."""
        window_end = torch.clamp(nxt + self.cfg.lookahead, max=stop)
        st = self._drain_window_batched(st, window_end, host0)
        return dataclasses.replace(st, now=window_end)

    def _stop(self, stop) -> torch.Tensor:
        return torch.as_tensor(stop, dtype=torch.int64, device=self.device)

    def step_window(self, st: EngineState, stop, host0: int = 0
                    ) -> EngineState:
        """Advance one conservative window; when no event below `stop`
        remains, land on `stop`."""
        stop = self._stop(stop)
        nxt = self._next_time(st)
        if self._read(nxt < stop):
            return self._advance(st, nxt, stop, host0)
        return dataclasses.replace(st, now=stop.clone())

    def run(self, st: EngineState, stop, host0: int = 0) -> EngineState:
        """Run until no pending event is earlier than `stop`."""
        stop = self._stop(stop)
        nxt = self._next_time(st)
        while self._read(nxt < stop):
            st = self._advance(st, nxt, stop, host0)
            nxt = self._next_time(st)
        return dataclasses.replace(st, now=stop.clone())
