"""The conservative-window simulation engine: chained and batched drains.

The counterpart of `shadow_tpu.core.engine`. Windows open at the global
earliest executable time and are `lookahead` wide; a window drains in
sweeps until no host has an event below its barrier.

- The chained drain (`_drain_window`, every engine without a
  `batch_handler`): each sweep dumps every host's earliest `drain_batch`
  below-barrier events into an [H, SW] staging buffer; an inner loop
  then runs, per step, each host's minimum-key staged event through the
  handler table (`_execute_step`) and appends the routed emits back into
  staging (`_stage_min`, `_stage_append`), so local follow-up chains run
  inside one sweep in exact (time, src, seq) order. Leftovers flush to
  the queues in one push per sweep. With `EngineConfig.burst` set,
  contiguous same-flow packet arrivals fold into one event at the dump
  (`_burst_fold`).
- The frontier drain (`_drain_window_frontier`, `EngineConfig.frontier`
  > 0): the chained drain's sweeps, but per round each host's staging is
  key-sorted once and a run of equal-time, same-kind staged events
  executes one position at a time; the staging bookkeeping happens once
  per round. Bit-identical to the chained drain.
- The batched drain (`_drain_window_batched`, engines built with a
  `batch_handler`): each sweep executes every host's whole below-barrier
  frontier in one [H, B]-shaped handler call.

Both drains carry the CPU model (`cpu_cost`): a host's next executable
instant is its earliest event or, if later, when its virtual CPU frees.

JAX's `lax.while_loop`/`lax.cond` become Python loops and branches on a
0-d flag read from the device; `Engine.host_syncs` counts those reads.
Per window: the loop test in `run`/`step_window` and the drain's first
flag; per sweep: the sweep's drain flag and the push's fallback-round
decision, plus, on the chained drain, one read per inner step, the
inner loop's last test and the flush's narrow-or-full decision; on the
frontier drain one read per round and one per position. A queue with a
spill ring adds one read per full-width admission round.

A fault schedule (`faults`, a `shadow_tpu_torch.faults.CompiledFaults`)
overlays all three drains: a dead host consumes its due events without
running them (`n_quarantined`), `_route` scales latency and rolls an
extra pass probability per link group and drops packets to hosts dead
at arrival (`n_fault_dropped`), and `_apply_fault_epoch` wipes and
re-templates crashed hosts and rescales NIC rates when a window opens in
a new epoch. The epoch test costs no read of its own: with faults on,
the window loop's `nxt < stop` read becomes one fetch of (nxt, the
epoch watermark, stop), and the epoch is looked up on the host.

Observability (`EngineConfig.trace`, `EngineConfig.stats`), on all
three drains: a per-host trace ring (`obs.trace`) takes one record per
executed event and one per routed non-local emit (SEND, or DROP/FDROP
with the loss attributed), appended once per inner step on the chained
drain, once per sweep on the batched one and once per round, in chained
record order, on the frontier one; a stats plane (`obs.stats`) takes
log2 histograms of event wait, network latency, per-window occupancy,
queue fill at the dump and frontier run length. With both knobs at 0
`EngineState.trace` and `splane` are None and the drains run exactly the
operations and reads they run without them.

Sharding (`EngineConfig.axis_name`, `n_shards`): the engine is then one
shard of a block partition, one rank of a `torch.distributed` group
(`parallel.mesh`), whose `Comm` carries the collectives. Hosts
[host0, host0 + H) are this shard's, host0 = rank * H. Loops and
branches whose flag differs between shards (the sweep loop, the flush's
narrow-or-full choice, the exchange's rounds) read a flag made global
by a collective first, so every rank issues the same collectives in the
same order; the chained drain's inner steps and the frontier's rounds
are shard-local, their count summed once per window. Cross-shard events
travel in the reference's bucketed exchange (`_exchange_push`): grouped
by destination shard into an [S, R] bucket and exchanged by all_to_all,
round after round until none remain, each round's received bucket
delivered at the next point the queue is read (`ExchangeBuf`). The
window barrier is a global min that folds in the minimum time sent in
the undelivered round. A fault schedule stays global; each shard slices
its rows.

Lanes (`Engine.bind_lanes`, the scenario fleet of `runtime.fleet`): one
engine runs L independent scenarios of the same build. Every per-host
leaf holds the L x H rows of all lanes, lane-major (row l * H + g is
host g of lane l), and the scalar leaves (`now`, `fault_epoch`, the
window, sweep and inner-step counters) become [L]. Each op runs once
for every row of every lane; the merge kernel merges all L x H rows in
one launch per round. Per lane there is a root key, a padded fault
schedule, a restart template and a latency per-mille; hosts keep their
lane-local gids, so each event's RNG stream, routing and handler see
exactly what a solo run of that lane sees. The termination semantics
are those of the reference's vmapped loops: a loop runs while any lane
still has work, and a lane without work in a window, sweep, inner step
or round takes no part in it (its barrier is below every time, its
counters do not move, its trace rows are not written), so each lane's
state equals its solo run's. One read per window serves the fleet.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch

from shadow_tpu_torch.core import rng as srng
from shadow_tpu_torch.core.device import resolve_device
from shadow_tpu_torch.core.events import (
    N_ARGS,
    EventQueue,
    Events,
    _select_rows,
    group_run_starts,
    pack_srcseq,
    queue_push,
)
from shadow_tpu_torch.core.timebase import TIME_INVALID
from shadow_tpu_torch.obs.stats import StatPlane
from shadow_tpu_torch.obs.trace import (
    OP_DROP,
    OP_EXEC,
    OP_FDROP,
    OP_SEND,
    TraceRing,
    trace_append,
)

_I64MAX = (1 << 63) - 1
# a lane's barrier while it takes no part in a window or sweep: no time
# is below it
_LOW = -(1 << 63)
# a lane's latency scale is per-mille, as the fault overlay's
LAT_UNIT = 1000

# Burst-fold length-word layout (the values of `shadow_tpu.core.engine`):
# low bits the payload total, high bits the folded run's segment count.
BURST_NSEG_SHIFT = 24
BURST_LEN_MASK = (1 << BURST_NSEG_SHIFT) - 1
BURST_NSEG_MAX = 127  # bits 24..30; bit 31 is the i32 sign

# Staging columns the chained flush pushes when no host holds more.
FLUSH_W = 16


@dataclasses.dataclass(frozen=True)
class Emit:
    """Events emitted by handler invocations: [..., K] fields.

    dst is a global host id, dt a non-negative delay relative to the
    executing event's time. local=True is a same-host task (no routing);
    local=False a network send that the engine routes: path latency,
    jitter, reliability roll, barrier clamp.
    """

    dst: torch.Tensor  # i32[..., K]
    dt: torch.Tensor  # i64[..., K]
    kind: torch.Tensor  # i32[..., K]
    args: torch.Tensor  # i32[..., K, N_ARGS]
    mask: torch.Tensor  # bool[..., K]
    local: torch.Tensor  # bool[..., K]

    @staticmethod
    def none(h: int, k: int, n_args: int = N_ARGS, *, device) -> "Emit":
        """No events from any of h rows: [h, k] fields, all masked."""
        z = lambda *s, dtype: torch.zeros(s, dtype=dtype, device=device)
        return Emit(
            dst=z(h, k, dtype=torch.int32), dt=z(h, k, dtype=torch.int64),
            kind=z(h, k, dtype=torch.int32),
            args=z(h, k, n_args, dtype=torch.int32),
            mask=z(h, k, dtype=torch.bool), local=z(h, k, dtype=torch.bool),
        )

    @staticmethod
    def single(dst, dt, kind, args=None, mask=True, local=False,
               n_args: int = N_ARGS) -> "Emit":
        """One event per row: `dst` is an [H] tensor; `dt`, `kind`,
        `mask` and `local` are [H] tensors or scalars; `args` is None or
        [H, n] with n <= n_args (the rest are zero). Fields are [H, 1]."""
        dst = torch.as_tensor(dst)
        h, dev = dst.shape[0], dst.device

        def col(v, dtype):
            # a scalar is filled on the device, not copied from the host
            if isinstance(v, torch.Tensor):
                return v.to(dtype).expand(h).reshape(h, 1)
            return torch.full((h, 1), v, dtype=dtype, device=dev)
        a = torch.zeros((h, 1, n_args), dtype=torch.int32, device=dev)
        if args is not None:
            args = torch.as_tensor(args, dtype=torch.int32, device=dev)
            a[:, 0, :args.shape[1]] = args
        return Emit(
            dst=col(dst, torch.int32), dt=col(dt, torch.int64),
            kind=col(kind, torch.int32), args=a,
            mask=col(mask, torch.bool), local=col(local, torch.bool),
        )

    def pad_to(self, k: int) -> "Emit":
        """Pad the K axis with masked zeros to width k."""
        ax = self.mask.dim() - 1
        cur = self.mask.shape[ax]
        if cur == k:
            return self
        if cur > k:
            raise ValueError(f"handler emitted {cur} > max_emit {k}")

        def pad(a):
            shape = list(a.shape)
            shape[ax] = k - cur
            return torch.cat([a, a.new_zeros(shape)], dim=ax)

        return Emit(**{f.name: pad(getattr(self, f.name))
                       for f in dataclasses.fields(self)})


@dataclasses.dataclass(frozen=True)
class Stats:
    """Per-host accounting, with the reference's dtypes."""

    n_executed: torch.Tensor  # i64[H]
    n_emitted: torch.Tensor  # i64[H]
    n_net_dropped: torch.Tensor  # i64[H] packets lost to reliability rolls
    n_windows: torch.Tensor  # i64[]
    n_by_kind: torch.Tensor  # i64[H, NK] executed events per handler kind
    n_sweeps: torch.Tensor  # i64[] drain sweeps (queue merges)
    n_inner_steps: torch.Tensor  # i64[] chained-drain inner steps
    n_xchg_rounds: torch.Tensor  # i64[] cross-shard all_to_all rounds
    n_cross_shard: torch.Tensor  # i64[] packets delivered across shards
    n_fault_dropped: torch.Tensor  # i64[H] packets lost to fault overlays
    n_quarantined: torch.Tensor  # i64[H] events voided by host crashes

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
class ExchangeBuf:
    """In-flight cross-shard events: the exchange's double buffer.

    `bucket` holds the [S, R] result of the last all_to_all round of the
    previous push: events for this shard, exchanged but not yet merged
    into its queue. They are merged at the next point the queue is read
    (the next sweep's top, the next window's open, the end of a run),
    which is exact: no queue operation runs in between, and `queue_push`
    does not depend on push order. `sent_min` (i64[1]) is the minimum
    time this shard sent in that round; the global min over shards of it
    equals the global min of what was received, so the window barrier
    folds in-flight events in without waiting on the exchange.

    A buffer made by `create` is known to be empty: its delivery is
    skipped without a read.
    """

    bucket: Events  # [S, R] received, undelivered cross-shard events
    sent_min: torch.Tensor  # i64[1] min time sent in the deferred round

    @staticmethod
    def create(n_shards: int, r: int, n_args: int = N_ARGS, *,
               device) -> "ExchangeBuf":
        z = lambda *s: torch.zeros(s, dtype=torch.int32, device=device)
        buf = ExchangeBuf(
            bucket=Events(
                time=torch.full((n_shards, r), TIME_INVALID,
                                dtype=torch.int64, device=device),
                dst=z(n_shards, r), src=z(n_shards, r), seq=z(n_shards, r),
                kind=z(n_shards, r), args=z(n_shards, r, n_args)),
            sent_min=torch.full((1,), TIME_INVALID, dtype=torch.int64,
                                device=device))
        object.__setattr__(buf, "known_empty", True)
        return buf


@dataclasses.dataclass(frozen=True)
class EngineState:
    """Complete simulation state: the leaves of the reference's
    EngineState, one shard's when sharded."""

    now: torch.Tensor  # i64[] current window start
    queues: EventQueue
    hosts: Any  # model dataclass, every tensor [H, ...]
    src_seq: torch.Tensor  # i32[H] per-source sequence counters
    exec_cnt: torch.Tensor  # i32[H] per-host executed-event counters (RNG)
    stats: Stats
    cpu_free: torch.Tensor  # i64[H] virtual-CPU available-from time
    fault_epoch: torch.Tensor  # i32[] last fault epoch applied (0 without)
    trace: Any = None  # obs.trace.TraceRing, or None (EngineConfig.trace 0)
    xchg: Any = None  # ExchangeBuf when sharded, else None
    splane: Any = None  # obs.stats.StatPlane, or None (EngineConfig.stats 0)


def state_summary(state: EngineState) -> dict:
    """Host-side progress snapshot: one device-to-host copy of a handful
    of scalars."""
    vals = torch.stack([
        state.now, state.stats.n_windows, state.stats.n_executed.sum(),
        state.stats.n_sweeps, state.queues.drops.sum(),
    ]).tolist()
    out = dict(zip(
        ("now_ns", "windows", "executed", "sweeps", "queue_drops"), vals
    ))
    ring = state.queues.spill
    if ring is not None:
        vals = torch.stack([ring.n_spilled.sum(), ring.n_lost.sum(),
                            ring.fill_hwm.max().to(torch.int64)]).tolist()
        out.update(zip(("spilled", "spill_lost", "fill_hwm"), vals))
    return out


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    n_hosts: int  # hosts on this shard
    capacity: int  # event queue slots per host
    lookahead: int  # conservative window width, ns
    max_emit: int = 2  # K: max events emitted per handler invocation
    n_args: int = N_ARGS
    seed: int = 0
    drain_batch: int = 32  # B: frontier events extracted per host per sweep
    stage_width: int = 0  # chained-drain staging slots per host (0: B + 4K)
    # Burst folding (chained drain): contiguous same-flow packet arrivals
    # staged in one sweep fold into one multi-segment event. None
    # disables; else the reference's static descriptor
    #   (kind, seq_arg, len_arg, sport_arg, dport_arg, meta_arg,
    #    proto, flags_excl_mask, mss, ctl_cols)
    burst: tuple | None = None
    # Overflow-spill ring slots per host (runtime.pressure); 0 leaves the
    # queue without a ring (EventQueue.spill is None)
    spill: int = 0
    # Frontier run batching (`_drain_window_frontier`): the most positions
    # of a run per round; 0 keeps the chained drain
    frontier: int = 0
    # Event tracing (obs.trace): records per host the ring holds between
    # drains; 0 leaves EngineState.trace None and runs no trace op
    trace: int = 0
    # args column holding the payload-length word of trace records
    trace_len_arg: int = 0
    # Sim-time histograms (obs.stats): > 0 keeps a StatPlane in
    # EngineState.splane; 0 leaves it None and runs no stats op
    stats: int = 0
    # mesh axis (or axis tuple) hosts are sharded over; None unsharded.
    # Set, the engine runs one shard of n_shards over `parallel.mesh`
    axis_name: Any = None
    n_shards: int = 1  # shards of the mesh (1 when unsharded)
    route_bucket: int = 0  # per-peer exchange bucket slots (0: auto)

    def __post_init__(self):
        if self.lookahead < 1:
            raise ValueError(
                f"lookahead must be >= 1 ns, got {self.lookahead}")
        if self.spill < 0:
            raise ValueError(f"spill must be >= 0, got {self.spill}")
        if self.frontier < 0:
            raise ValueError(f"frontier must be >= 0, got {self.frontier}")
        if self.trace < 0:
            raise ValueError(f"trace must be >= 0, got {self.trace}")
        if self.stats < 0:
            raise ValueError(f"stats must be >= 0, got {self.stats}")
        if not 0 <= self.trace_len_arg < self.n_args:
            raise ValueError(f"trace_len_arg {self.trace_len_arg} outside "
                             f"[0, {self.n_args})")
        if self.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {self.n_shards}")
        if self.n_shards > 1 and self.axis_name is None:
            raise ValueError("n_shards > 1 needs an axis_name")
        if self.burst is not None and self.eff_stage_width > BURST_NSEG_MAX:
            # the fold packs its run count into bits 24..30 of the length
            # word; a wider staging buffer could overflow into the sign bit
            raise ValueError(
                f"burst folding requires stage_width <= {BURST_NSEG_MAX} "
                f"(got {self.eff_stage_width})")
        if (self.stage_width
                and self.stage_width < self.eff_drain_batch + self.max_emit):
            # staging must hold a full dump plus one handler's emits
            raise ValueError(
                f"stage_width {self.stage_width} < drain_batch "
                f"{self.eff_drain_batch} + max_emit {self.max_emit}")

    @property
    def eff_drain_batch(self) -> int:
        return max(1, min(self.drain_batch, self.capacity))

    @property
    def eff_stage_width(self) -> int:
        return self.stage_width or (self.eff_drain_batch + 4 * self.max_emit)


class ConstantNetwork:
    """Uniform complete-graph network: fixed latency, reliability and
    jitter amplitude."""

    def __init__(self, latency_ns: int, reliability: float = 1.0,
                 jitter_ns: int = 0):
        self.latency_ns = latency_ns
        self.reliability = reliability
        self.jitter_ns = jitter_ns
        self.has_jitter = jitter_ns > 0

    def route(self, src: torch.Tensor, dst: torch.Tensor):
        """(latency i64, reliability f32, jitter i64), each shaped like
        the broadcast of src and dst."""
        shape = torch.broadcast_shapes(src.shape, dst.shape)
        full = lambda v, dtype: torch.full(shape, v, dtype=dtype,
                                           device=src.device)
        return (full(self.latency_ns, torch.int64),
                full(self.reliability, torch.float32),
                full(self.jitter_ns, torch.int64))


def _kind_cost(cpu_cost: torch.Tensor, kind: torch.Tensor) -> torch.Tensor:
    """Per-event cost from an [H, NK] table by event kind ([H] or
    [H, ...] kinds), as a one-hot select."""
    nk = cpu_cost.shape[-1]
    kidx = torch.clamp(kind, 0, nk - 1)
    onehot = kidx[..., None] == torch.arange(nk, dtype=kind.dtype,
                                             device=kind.device)
    extra = kidx.dim() - (cpu_cost.dim() - 1)
    table = cpu_cost.reshape(
        cpu_cost.shape[:1] + (1,) * extra + cpu_cost.shape[1:])
    return torch.sum(torch.where(onehot, table, 0), dim=-1)


def _slice_rows(tree: Any, host0: int, h: int, clone: bool = False) -> Any:
    """Rows [host0, host0 + h) of every [H, ...] tensor of a dataclass
    tree (nested dataclasses and tuples followed, None kept); copies
    with `clone`, else views."""
    def sl(v):
        if v is None:
            return None
        if dataclasses.is_dataclass(v):
            return _slice_rows(v, host0, h, clone)
        if isinstance(v, tuple):
            return tuple(sl(x) for x in v)
        return v[host0:host0 + h].clone() if clone else v[host0:host0 + h]

    return dataclasses.replace(tree, **{
        f.name: sl(getattr(tree, f.name)) for f in dataclasses.fields(tree)})


def _take_slots(ev: Events, idx: torch.Tensor) -> Events:
    """Reorder each row of [H, S] events by the [H, S] index `idx`."""
    def take(a):
        if a.dim() == 2:
            return torch.gather(a, 1, idx)
        return torch.gather(a, 1, idx[:, :, None].expand(a.shape))

    return Events(**{f.name: take(getattr(ev, f.name))
                     for f in dataclasses.fields(ev)})


def _pad_slots(a: torch.Tensor, n: int, fill) -> torch.Tensor:
    """Append n columns of `fill` to the slot axis (dim 1)."""
    return torch.cat([a, a.new_full((a.shape[0], n) + a.shape[2:], fill)],
                     dim=1)


def _precedes(t, ss, qh_t, qh_ss) -> torch.Tensor:
    """Whether the key (t, ss) orders strictly before (qh_t, qh_ss)."""
    return (t < qh_t) | ((t == qh_t) & (ss < qh_ss))


def jitter_offset(u: torch.Tensor, jit: torch.Tensor) -> torch.Tensor:
    """Symmetric latency noise in ns from an f32 uniform u and an i64
    jitter amplitude: (2u - 1) * jit in f32, truncated toward zero as
    the reference casts. 2u is exact, so no fused multiply-add can
    change the f32 product."""
    return ((u * 2.0 - 1.0) * jit.to(torch.float32)).to(torch.int64)


def _one_hot_kind(kind: torch.Tensor, n_kinds: int) -> torch.Tensor:
    """i64 one-hot of clip(kind) over n_kinds, by compare (torch's
    one_hot validates its input with a device-to-host read)."""
    return (torch.clamp(kind, 0, n_kinds - 1)[..., None]
            == torch.arange(n_kinds, dtype=kind.dtype, device=kind.device)
            ).to(torch.int64)


class Engine:
    """Window-step / run functions over a handler table.

    `handlers[i](hosts, ev, keys) -> (hosts', Emit)` runs event kind i
    for every host at once: `hosts` is the model's host dataclass of
    [H, ...] tensors, `ev` an Events with [H] fields (one event per
    host; rows with nothing to run carry time = TIME_INVALID and are
    discarded), `keys` the handler keys [H, 2], and the Emit has [H, K_i]
    fields with K_i <= max_emit. Each handler runs over all rows and each
    row keeps the result of its own kind, clipped to the table: the
    batched form of the reference's vmapped `lax.switch`, which also
    evaluates every branch. Rows must be independent.

    `batch_handler(hosts, evs, keys) -> (hosts', Emit)`, when given,
    selects the batched drain: `evs` has [H, B] fields, keys are
    [H, B, 2] and the Emit has [H, B, K] fields. It must fold state
    commutatively across a frontier and never emit local events below
    the barrier (the reference's batch_handler contract); `handlers`
    then only sets the number of event kinds.

    `network.route(src_gid, dst_gid) -> (latency i64, reliability f32,
    jitter i64)` is the topology; a truthy `network.has_jitter` enables
    the per-packet jitter roll.

    `cpu_cost`: per-event virtual-CPU nanoseconds by global host id,
    i64[H] (one cost per event) or i64[H, n_kinds] (per kind); None or
    all zeros disables the CPU model.

    `frontier_kinds`: the event kinds allowed to form multi-position
    runs on the frontier drain (cfg.frontier > 0); other kinds still run,
    one position per round. None allows every kind.

    `faults`: a CompiledFaults on this engine's device, or None. Crashes
    and bandwidth changes need `fault_reset`, the initial hosts state: a
    restarted host's rows are re-templated from it, and NIC rates scale
    from its `net.nic_tx`/`net.nic_rx` rates. Both stay global when
    sharded (every host of every shard); each shard reads its rows.

    `comm`: the `parallel.mesh.Comm` of a sharded engine (cfg.axis_name
    set); None takes the one of the mesh `parallel.mesh.make_mesh` made
    in this process. The shard's first host is `host0` = rank * H, the
    default of every `host0` argument.
    """

    def __init__(self, cfg: EngineConfig, handlers: Sequence[Callable],
                 network, cpu_cost=None,
                 batch_handler: Callable | None = None, faults=None,
                 fault_reset=None, frontier_kinds=None, device=None,
                 comm=None):
        self.cfg = cfg
        self.handlers = tuple(handlers)
        self.n_kinds = len(self.handlers)
        self.network = network
        self.batch_handler = batch_handler
        self.device = resolve_device(device)
        self._base_key = srng.root_key(cfg.seed, self.device)
        self._frontier_kinds = (
            tuple(sorted({int(x) for x in frontier_kinds}))
            if frontier_kinds is not None else None)
        self._fk = (torch.tensor(self._frontier_kinds, dtype=torch.int32,
                                 device=self.device)
                    if frontier_kinds is not None else None)
        hg, nk = cfg.n_hosts * cfg.n_shards, self.n_kinds
        if cpu_cost is None:
            cpu_cost = torch.zeros((hg, nk), dtype=torch.int64)
        cpu_cost = torch.as_tensor(cpu_cost).to(device=self.device,
                                                dtype=torch.int64)
        if tuple(cpu_cost.shape) not in ((hg,), (hg, nk)):
            raise ValueError(
                f"cpu_cost must be [H_global]={hg} or [H_global, "
                f"n_kinds]=({hg}, {nk}), got shape {tuple(cpu_cost.shape)}")
        if cpu_cost.dim() == 1:
            cpu_cost = cpu_cost[:, None].expand(hg, nk)
        self.cpu_cost = cpu_cost
        self.comm, self.host0, self._xchg_r = None, 0, 0
        if cfg.axis_name is not None:
            if comm is None:
                from shadow_tpu_torch.parallel.mesh import current

                mesh = current()
                comm = mesh.comm if mesh is not None else None
            if comm is None:
                raise RuntimeError(
                    "a sharded engine (axis_name set) needs a mesh: call "
                    "parallel.mesh.make_mesh in a rank started by "
                    "parallel.mesh.spawn")
            if comm.size != cfg.n_shards:
                raise ValueError(f"n_shards {cfg.n_shards} != the mesh's "
                                 f"{comm.size} ranks")
            self.comm = comm
            self.host0 = comm.rank * cfg.n_hosts
            # one bucket width for every exchange of the run (the
            # deferred bucket is carried state): a quarter of the widest
            # flat batch spread uniformly over the shards, at least 16
            if batch_handler is not None:
                m_ref = cfg.n_hosts * cfg.eff_drain_batch * cfg.max_emit
            else:
                m_ref = cfg.n_hosts * max(cfg.eff_stage_width,
                                          cfg.eff_drain_batch + cfg.max_emit)
            self._xchg_r = cfg.route_bucket or max(
                16, -(-m_ref // cfg.n_shards) // 4)
        # build-time flags, as in the reference: one host read each
        self._cpu_enabled = bool(torch.any(cpu_cost != 0))
        self._use_jitter = bool(getattr(network, "has_jitter", False))
        # fault schedule: build-time sub-flags keep fault-free (and
        # partly faulted) runs free of the overlays they do not need
        self.faults = faults
        self.fault_reset = fault_reset
        self._f_crash = bool(faults is not None and faults.has_crash)
        self._f_link = bool(faults is not None and faults.has_link)
        self._f_bw = bool(faults is not None and faults.has_bw)
        self._f_any = self._f_crash or self._f_link or self._f_bw
        if (self._f_crash or self._f_bw) and fault_reset is None:
            raise ValueError(
                "faults with crashes or bandwidth changes need a "
                "fault_reset template (the initial hosts state)")
        if faults is not None and faults.alive.shape[1] != hg:
            raise ValueError(
                f"fault schedule compiled for {faults.alive.shape[1]} "
                f"hosts, engine has {hg}")
        # [H, T] liveness per epoch of this shard's hosts, the
        # quarantine's lookup table, and the shard's restart template
        h0, h = self.host0, cfg.n_hosts
        self._alive_ht = (faults.alive[:, h0:h0 + h].T.contiguous()
                          if self._f_crash else None)
        self._tmpl = (_slice_rows(fault_reset, h0, h)
                      if fault_reset is not None and self.comm is not None
                      else fault_reset)
        self._fgrp = faults.fgrp.long() if self._f_link else None
        self._trace = cfg.trace > 0
        self._stats = cfg.stats > 0
        self.host_syncs = 0
        self.lanes = 0  # 0: one scenario; L > 0 after `bind_lanes`
        self._n_rows = cfg.n_hosts
        self._lat_milli = None

    def bind_lanes(self, keys: torch.Tensor, *, faults=None,
                   fault_reset=None, lat_milli=None) -> "Engine":
        """A copy of this engine that runs L = keys.shape[0] lanes: the
        counterpart of the reference's `Engine.bind_lane` under its
        fleet's vmap. This engine is left as it was.

        `keys`: i64[L, 2], each lane's root key (`rng.root_key` of its
        seed). `faults`: a CompiledFaults whose tensors are stacked per
        lane and padded to one shape (`runtime.fleet._pad_faults`):
        times [L, T], alive [L, T, H], fgrp [L, H], lat_milli and passp
        [L, T, G, G], bw_scale [L, T, H], np_times [L, T] on the host.
        `fault_reset`: the lanes' restart templates, their hosts states
        concatenated lane-major ([L * H, ...] rows). `lat_milli`: i64[L],
        each lane's latency scale in per-mille, applied to the path
        latency before the fault overlay and the barrier clamp (None:
        every lane unscaled).

        The copy runs states whose per-host leaves hold L x H rows and
        whose scalars are [L] (`runtime.fleet` stacks them); `run` and
        `step_window` take a stop per lane or one for all."""
        if self.cfg.axis_name is not None:
            raise ValueError("lanes run the single-device engine; a "
                             "sharded engine cannot bind lanes")
        eng = copy.copy(self)
        dev, h = self.device, self.cfg.n_hosts
        lanes = int(keys.shape[0])
        eng.lanes = lanes
        eng._n_rows = lanes * h
        eng.host_syncs = 0
        eng._row_lane = torch.arange(lanes, device=dev).repeat_interleave(h)
        eng._lane_gids = torch.arange(h, dtype=torch.int32,
                                      device=dev).repeat(lanes)
        eng._base_key = keys.to(dev)[eng._row_lane]  # [L * H, 2]
        eng._lat_milli = (None if lat_milli is None
                          else lat_milli.to(device=dev, dtype=torch.int64))
        eng.faults = faults
        eng.fault_reset = fault_reset
        eng._f_crash = bool(faults is not None and faults.has_crash)
        eng._f_link = bool(faults is not None and faults.has_link)
        eng._f_bw = bool(faults is not None and faults.has_bw)
        eng._f_any = eng._f_crash or eng._f_link or eng._f_bw
        if (eng._f_crash or eng._f_bw) and fault_reset is None:
            raise ValueError(
                "faults with crashes or bandwidth changes need a "
                "fault_reset template (the initial hosts state)")
        if faults is not None and tuple(faults.alive.shape[::2]) != (
                lanes, h):
            raise ValueError(
                f"lane fault schedules must be [L={lanes}, T, H={h}], got "
                f"alive {tuple(faults.alive.shape)}")
        # [L * H, T] liveness per epoch of each row, the quarantine's
        # lookup table, and each row's restart template
        eng._alive_ht = (faults.alive.transpose(1, 2).reshape(
            lanes * h, -1).contiguous() if eng._f_crash else None)
        eng._tmpl = fault_reset
        eng._fgrp = faults.fgrp.long() if eng._f_link else None
        eng._np_times = (np.asarray(faults.np_times) if eng._f_any
                         else None)
        return eng

    # -- lanes ----------------------------------------------------------------
    def _per_row(self, v: torch.Tensor) -> torch.Tensor:
        """A per-lane [L] tensor broadcast to the L x H rows."""
        return v[:, None].expand(self.lanes,
                                 self.cfg.n_hosts).reshape(-1)

    def _lane_any(self, x: torch.Tensor) -> torch.Tensor:
        """[L * H] flags -> [L]: whether any row of each lane is set."""
        return torch.any(x.reshape(self.lanes, -1), dim=1)

    def _bars(self, window_end, flags=None):
        """The barrier of one sweep as (per row, per row as a column):
        the scalar itself when solo; for lanes, [L * H] and [L * H, 1]
        from the [L] barriers, lanes whose `flags` is false (no work in
        this sweep) taking the `_LOW` barrier below every time."""
        if not self.lanes:
            return window_end, window_end
        if flags is not None:
            window_end = torch.where(flags, window_end, _LOW)
        wr = self._per_row(window_end)
        return wr, wr[:, None]

    def _count(self, counter: torch.Tensor, lanes, n=1) -> torch.Tensor:
        """Add `n` to a loop counter: for lanes, only in the lanes whose
        flag in `lanes` is set (or `lanes` itself, a per-lane count)."""
        if not self.lanes:
            return counter + n
        return counter + lanes

    def _trace_put(self, trace, rec: dict, lanes=None):
        """Append a step's records to the trace ring; for lanes, only the
        rows of the lanes whose flag in `lanes` is set (a lane outside
        the step writes nothing, not even the zeros of an empty row)."""
        new = trace_append(trace, self.cfg.trace, **rec)
        if lanes is None or not self.lanes:
            return new
        return _select_rows(self._per_row(lanes), new, trace)

    def _epoch(self, t: torch.Tensor, lane=None) -> torch.Tensor:
        """The fault epoch of time(s) t; for lanes, `lane` gives the lane
        of each leading row of t (or t is per row of the L x H rows)."""
        if not self.lanes:
            return self.faults.epoch_of(t)
        if lane is None:
            lane = self._row_lane
        n = t.shape[0]
        e = torch.searchsorted(self.faults.times[lane],
                               t.reshape(n, -1).contiguous(), right=True)
        return (e - 1).to(torch.int32).reshape(t.shape)

    def _to_rows(self, ev: Events, lane: torch.Tensor) -> Events:
        """A flat batch's lane-local destinations as rows of the L x H
        rows (`lane` per event); a destination outside its lane's hosts
        becomes -1, which no push accepts."""
        h = self.cfg.n_hosts
        ok = (ev.dst >= 0) & (ev.dst < h)
        return dataclasses.replace(ev, dst=torch.where(
            ok, ev.dst + (lane * h).to(torch.int32), -1))

    def _read(self, flag: torch.Tensor) -> bool:
        """A device-to-host read of a 0-d bool: the loop and branch tests
        that `lax.while_loop`/`lax.cond` kept on the device."""
        self.host_syncs += 1
        return bool(flag)

    def _fetch(self, t: torch.Tensor):
        """A counted device-to-host copy of a tensor, as numpy."""
        self.host_syncs += 1
        return t.cpu().numpy()

    # -- collectives (identity when unsharded) --------------------------------
    def _gmin(self, x: torch.Tensor) -> torch.Tensor:
        return self.comm.gmin(x) if self.comm is not None else x

    def _gany(self, x: torch.Tensor) -> torch.Tensor:
        return self.comm.gany(x) if self.comm is not None else x

    def _gsum(self, x: torch.Tensor) -> torch.Tensor:
        return self.comm.gsum(x) if self.comm is not None else x

    def _fresh_xchg(self) -> ExchangeBuf:
        return ExchangeBuf.create(self.cfg.n_shards, self._xchg_r,
                                  self.cfg.n_args, device=self.device)

    def _xchg_deliver(self, q: EventQueue, xchg, host0: int):
        """Merge the in-flight exchange buffer into the local queue and
        return it emptied; a buffer known to be empty costs nothing, and
        one that holds no event costs one read (shard-local, no
        collective)."""
        if xchg is None or getattr(xchg, "known_empty", False):
            return q, xchg
        flat = xchg.bucket.flatten()
        valid = flat.time != TIME_INVALID
        if self._read(torch.any(valid)):
            q = queue_push(q, flat, valid, host0, self._read)
        return q, self._fresh_xchg()

    def _exchange_push(self, q: EventQueue, xchg, ev: Events,
                       mask: torch.Tensor, host0: int, lane=None,
                       part=None):
        """Push a flat routed batch, delivering cross-shard events by the
        bucketed all_to_all. Returns (queue', xchg', rounds, n_cross).

        Hosts are block-partitioned (dst // H is the owning shard), so
        same-shard events push at once. The rest are grouped by
        destination shard into an [S, R] bucket, R slots per peer, and
        exchanged; while any shard still holds more, another round runs
        with the remainder (lossless). A round's received bucket is not
        pushed in that round: it lands in `xchg`, merged at the top of
        the next round, and the last round's rides out to the next sweep
        or window. The loop flag is global (a sum over shards), so every
        rank runs the same rounds; n_cross is the global count.

        For lanes, `lane` gives each event's lane and `part` the lanes
        that push: a lane-local destination becomes a row of its lane,
        and each lane's rows take the push of its solo run
        (`queue_push`'s lanes)."""
        if self.comm is None:
            if lane is not None:
                return (queue_push(q, self._to_rows(ev, lane), mask, 0,
                                   self._read,
                                   width=ev.time.shape[0] // self.lanes,
                                   lanes=self.lanes, part=part),
                        xchg, 0, None)
            return (queue_push(q, ev, mask, host0, self._read), xchg, 0,
                    None)
        cfg, dev = self.cfg, self.device
        h, s, r = cfg.n_hosts, cfg.n_shards, self._xchg_r
        m = ev.time.shape[0]
        dshard = torch.div(ev.dst, h, rounding_mode="floor")
        in_range = (dshard >= 0) & (dshard < s)
        is_local = mask & (dshard == self.comm.rank)
        q = queue_push(q, ev, is_local, host0, self._read)
        rem = mask & in_range & ~is_local
        # the global count, and the loop's first flag from the same sum
        n_cross = self._gsum(torch.sum(rem, dtype=torch.int64))
        more = self._read(n_cross > 0)
        pos = torch.arange(m, dtype=torch.int32, device=dev)
        rounds = 0
        while more:
            q, xchg = self._xchg_deliver(q, xchg, host0)
            dkey = torch.where(rem, dshard, s).to(torch.int32)
            order = torch.sort(dkey, stable=True).indices
            sd = dkey[order]
            rank = pos - group_run_starts(sd)
            sel = (sd < s) & (rank < r)
            brow = torch.where(sel, sd, s).long()
            bcol = torch.clamp(rank, max=r - 1).long()
            # one [S + 1, R, 5 + A] i64 block: time, dst, src, seq, kind,
            # args; unsent rows land in the discard row S
            cols = [ev.time, ev.dst.to(torch.int64), ev.src.to(torch.int64),
                    ev.seq.to(torch.int64), ev.kind.to(torch.int64)]
            words = torch.cat([torch.stack(cols, dim=1),
                               ev.args.to(torch.int64)], dim=1)[order]
            fill = torch.zeros((1, words.shape[1]), dtype=torch.int64,
                               device=dev)
            fill[0, 0] = TIME_INVALID
            block = fill.expand(s + 1, r, words.shape[1]).clone()
            block[brow, bcol] = words
            block = block[:s]
            recv = self.comm.all_to_all(block)
            i32 = lambda j: recv[:, :, j].to(torch.int32)
            xchg = ExchangeBuf(
                bucket=Events(time=recv[:, :, 0].contiguous(), dst=i32(1),
                              src=i32(2), seq=i32(3), kind=i32(4),
                              args=recv[:, :, 5:].to(torch.int32)),
                # the minimum this shard sent: globally the same as the
                # minimum received, with no dependence on the exchange
                sent_min=torch.min(block[:, :, 0]).reshape(1))
            sent = torch.zeros((m,), dtype=torch.bool, device=dev)
            sent[order] = sel
            rem = rem & ~sent
            more = self._read(self._gany(torch.any(rem)))
            rounds += 1
        return q, xchg, rounds, n_cross

    def _trace_slack(self) -> int:
        """Scratch columns past the trace ring's capacity: the widest
        single append of this engine's drain, so a full row's writes
        land in the never-read zone."""
        k = self.cfg.max_emit
        if self.batch_handler is not None:
            return self.cfg.eff_drain_batch * (1 + k)
        if self.cfg.frontier > 0:
            # one append per round: up to u positions of 1 + K records
            return max(1, min(self.cfg.frontier,
                              self.cfg.eff_stage_width)) * (1 + k)
        return 1 + k

    def init_state(self, hosts: Any, initial: Events,
                   host0: int | None = None) -> EngineState:
        """The initial state of this shard (`host0` defaults to its
        first host): `hosts` its rows of the host state, `initial` any
        batch of initial events (those for other shards are ignored)."""
        cfg, dev = self.cfg, self.device
        host0 = self.host0 if host0 is None else host0
        h = cfg.n_hosts
        q = EventQueue.create(h, cfg.capacity, cfg.n_args,
                              spill=cfg.spill, device=dev)
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
        trace = (TraceRing.create(h, cfg.trace, self._trace_slack(),
                                  device=dev) if self._trace else None)
        splane = StatPlane.create(h, device=dev) if self._stats else None
        return EngineState(
            now=torch.zeros((), dtype=torch.int64, device=dev),
            queues=q,
            hosts=hosts,
            src_seq=seq0,
            exec_cnt=torch.zeros((h,), dtype=torch.int32, device=dev),
            stats=Stats.create(h, self.n_kinds, device=dev),
            cpu_free=torch.zeros((h,), dtype=torch.int64, device=dev),
            fault_epoch=torch.zeros((), dtype=torch.int32, device=dev),
            trace=trace,
            xchg=self._fresh_xchg() if self.comm is not None else None,
            splane=splane,
        )

    # -- fault-schedule helpers ---------------------------------------------
    def _alive_at(self, al_sh, t) -> torch.Tensor:
        """Liveness per host at time(s) t ([H] or [H, B]); `al_sh` is the
        [H, T] liveness table per epoch. A time before the first epoch
        reads as dead, as the reference's one-hot select over the epochs
        does."""
        e = self._epoch(t).to(torch.int64)
        idx = torch.clamp(e, min=0)
        if t.dim() == 1:
            idx = idx[:, None]
        return torch.gather(al_sh, 1, idx).reshape(t.shape) & (e >= 0)

    def _quarantine(self, al_sh, active, eff_t, stats):
        """The rows of `active` that run: a host dead at its event's
        effective time consumes the event without running it (its slot
        still clears), counted in `n_quarantined`. Returns (runm,
        stats')."""
        if al_sh is None:
            return active, stats
        alv = self._alive_at(al_sh, eff_t)
        return active & alv, dataclasses.replace(
            stats, n_quarantined=stats.n_quarantined + (active & ~alv))

    # -- emit routing --------------------------------------------------------
    def _route(self, emit: Emit, base_time, gids, window_end, rkeys, emask,
               seq, lane=None):
        """Route an [N, K] emit batch: local tasks keep their time; network
        sends add path latency (+ jitter, rolled on lane offset K), roll
        reliability (lane offset 0) and clamp to the window barrier.

        The fault schedule, when compiled in, overlays the lookup: path
        latency scales by the send epoch's [G, G] factor before the jitter
        and the barrier clamp; an extra pass-probability roll (lane offset
        2K) and a destination-liveness check at the arrival epoch drop
        packets with their own attribution.
        Returns (Events[N, K], final_mask, dropped, fdropped, routed time
        t, is_local), fdropped None when no overlay is compiled in.

        For lanes, `lane` gives each of the N rows' lane: the lane's
        latency scale applies to the path latency first, as the
        reference's `ScaledLatencyNetwork` wraps the topology, and the
        fault overlay reads the lane's schedule."""
        n, k = emit.dst.shape
        self_gid = gids[:, None]
        is_local = emit.local
        dst = torch.where(is_local, self_gid, emit.dst)
        dt = torch.clamp(emit.dt, min=0)
        lat, rel, jit = self.network.route(self_gid.expand(n, k), dst)
        if lane is not None and self._lat_milli is not None:
            lat = lat * self._lat_milli[lane][:, None] // LAT_UNIT
        t = base_time[:, None] + dt
        f = self.faults
        # the fault tables' leading index: a lane's schedule for lanes
        ln = () if lane is None else (lane[:, None],)
        if self._f_link or self._f_crash:
            hg = f.fgrp.shape[-1]
            dstc = torch.clamp(dst, 0, hg - 1).long()
        if self._f_link:
            gs = self._fgrp[ln + (torch.clamp(self_gid, 0, hg - 1).long(),)]
            gd = self._fgrp[ln + (dstc,)]
            # link state is read at SEND time; an index of -1 (a time
            # before 0, only on masked lanes) wraps as in the reference
            e_s = self._epoch(t, lane).long()
            lat = lat * f.lat_milli[ln + (e_s, gs, gd)] // 1000
        if self._use_jitter:
            uj = srng.uniform_lanes(rkeys, k, k)
            lat = torch.clamp(lat + jitter_offset(uj, jit), min=0)
        t_remote = torch.maximum(t + lat, window_end)
        u = srng.uniform_lanes(rkeys, k, 0)
        dropped = ~is_local & (u >= rel) & emask
        final_mask = emask & ~dropped
        fdropped = None  # no overlay compiled in: nothing to attribute
        if self._f_link:
            u2 = srng.uniform_lanes(rkeys, k, 2 * k)
            fdropped = u2 >= f.passp[ln + (e_s, gs, gd)]
        if self._f_crash:
            # a packet to a host dead when it ARRIVES is lost
            e_a = self._epoch(t_remote, lane).long()
            dead = ~f.alive[ln + (e_a, dstc)]
            fdropped = dead if fdropped is None else fdropped | dead
        if fdropped is not None:
            fdropped = fdropped & ~is_local & final_mask
            final_mask = final_mask & ~fdropped
        t = torch.where(is_local, t, t_remote)
        out = Events(
            time=torch.where(final_mask, t, TIME_INVALID),
            dst=dst,
            src=self_gid.expand(n, k).to(torch.int32),
            seq=seq,
            kind=emit.kind,
            args=emit.args,
        )
        return out, final_mask, dropped, fdropped, t, is_local

    def _drain_flag(self, q: EventQueue, cpu_free, window_end
                    ) -> torch.Tensor:
        """True while any host still has an executable event below the
        barrier (CPU permitting)."""
        nxt = q.min_time()
        if self._cpu_enabled:
            nxt = torch.maximum(nxt, cpu_free)
        if self.lanes:
            return self._lane_any(nxt < self._per_row(window_end))  # [L]
        return self._gany(torch.any(nxt < window_end))

    def _any(self, flags: torch.Tensor) -> torch.Tensor:
        """A loop flag from `_drain_flag`'s: itself when solo, whether
        any lane's is set for lanes."""
        return torch.any(flags) if self.lanes else flags

    # -- the chained drain: one event per host per inner step ----------------
    def _trace_rec(self, ev: Events, out: Events, run, emask, dropped,
                   fdropped, is_local) -> dict:
        """Trace records of E executed lanes per host (ev fields [H, E],
        `run` their mask) and their routed emits ([H*E, K] or [H, K]
        batches): E EXEC records, then E*K SEND/DROP/FDROP records of the
        non-local emits, as `trace_append` keywords of width E + E*K."""
        h, e = run.shape
        k, la = self.cfg.max_emit, self.cfg.trace_len_arg
        wide = lambda a: a.reshape(h, e * k)
        op = OP_SEND if fdropped is None else torch.where(
            fdropped, OP_FDROP, OP_SEND)
        op = torch.where(dropped, OP_DROP, op).to(torch.int32)
        cat = lambda a, b: torch.cat([a, b], dim=1)
        return dict(
            time=cat(ev.time, wide(ev.time[:, :, None].expand(h, e, k))),
            src=cat(ev.src, wide(out.src)),
            dst=cat(ev.dst, wide(out.dst)),
            kind=cat(ev.kind, wide(out.kind)),
            plen=cat(ev.args[:, :, la], wide(out.args[..., la])),
            seq=cat(ev.seq, wide(out.seq)),
            op=cat(torch.full((h, e), OP_EXEC, dtype=torch.int32,
                              device=run.device), wide(op)),
            mask=cat(run, wide(emask & ~is_local)))

    def _execute_step(self, hosts, src_seq, exec_cnt, stats, ev: Events,
                      active: torch.Tensor, window_end, gids, splane=None):
        """Run the handler table for one event per host (rows masked by
        `active`) and route the emits. Returns (hosts', src_seq',
        exec_cnt', stats', routed Events[H, K], final_mask[H, K],
        splane', rec): the stats plane takes the wait and network-latency
        samples when it is on, and `rec` is the step's width-(1+K) trace
        batch when tracing is on (else None)."""
        k = self.cfg.max_emit
        hkeys, rkeys = srng.event_keys(self._base_key, gids, exec_cnt)
        idx = torch.clamp(ev.kind, 0, self.n_kinds - 1)
        # each row keeps its own kind's result; a leaf that a handler
        # returns untouched needs no select for that handler's rows
        hosts2, emit = hosts, None
        for i, fn in enumerate(self.handlers):
            hs_i, em_i = fn(hosts, ev, hkeys)
            em_i = em_i.pad_to(k)
            sel = idx == i
            hosts2 = _select_rows(sel, hs_i, hosts2)
            emit = em_i if emit is None else _select_rows(sel, em_i, emit)
        hosts = _select_rows(active, hosts2, hosts)
        emask = emit.mask & active[:, None]

        # per-source sequence numbers, dense over the masked emits
        inc = emask.to(torch.int32)
        within = torch.cumsum(inc, dim=1, dtype=torch.int32) - inc
        seq = src_seq[:, None] + within
        src_seq = src_seq + torch.sum(inc, dim=1, dtype=torch.int32)

        out, final_mask, dropped, fdropped, t_r, is_local = self._route(
            emit, ev.time, gids, window_end, rkeys, emask, seq,
            self._row_lane if self.lanes else None)
        if splane is not None:
            # a delivered emit runs at its routed time: t_r - now is its
            # wait, and on the non-local lanes its network latency
            delta = t_r - ev.time[:, None]
            splane = splane.observe("wait", delta, final_mask)
            splane = splane.observe("net", delta, final_mask & ~is_local)
        rec = None
        if self._trace:
            one = Events(**{f.name: getattr(ev, f.name)[:, None]
                            for f in dataclasses.fields(Events)})
            rec = self._trace_rec(one, out, active[:, None], emask, dropped,
                                  fdropped, is_local)
        exec_cnt = exec_cnt + active.to(torch.int32)
        stats = dataclasses.replace(
            stats,
            n_executed=stats.n_executed + active,
            n_emitted=stats.n_emitted + torch.sum(inc, dim=1,
                                                  dtype=torch.int64),
            n_net_dropped=stats.n_net_dropped + torch.sum(
                dropped, dim=1, dtype=torch.int64),
            n_by_kind=stats.n_by_kind + _one_hot_kind(
                ev.kind, self.n_kinds) * active[:, None],
        )
        if fdropped is not None:
            stats = dataclasses.replace(
                stats, n_fault_dropped=stats.n_fault_dropped + torch.sum(
                    fdropped, dim=1, dtype=torch.int64))
        return hosts, src_seq, exec_cnt, stats, out, final_mask, splane, rec

    def _burst_fold(self, stage: Events) -> Events:
        """Collapse contiguous same-flow arrival runs in [H, SW] staging.

        Each host's staged events are sorted by (flow key, tcp seq); a
        run of eligible events whose seqs chain by +1 (every segment
        before the last full-MSS) folds into its head: length word =
        total | (count << 24), time = run min, control words from the
        run's last member. Absorbed slots clear. Slot order afterwards is
        arbitrary, which staging permits.
        """
        (kind, seq_a, len_a, sport_a, dport_a, meta_a, proto, flags_x,
         mss, ctl_cols) = self.cfg.burst
        t = stage.time
        h, sw = t.shape
        dev = t.device
        meta = stage.args[:, :, meta_a]
        ln = stage.args[:, :, len_a]
        elig = (
            (t != TIME_INVALID)
            & (stage.kind == kind)
            & ((meta & 0x3) == proto)
            & ((meta & flags_x) == 0)
            & (ln > 0) & (ln <= mss)
        )
        slot = torch.arange(sw, dtype=torch.int64, device=dev)[None, :]
        flow = (
            (stage.src.to(torch.int64) << 32)
            | (stage.args[:, :, sport_a].to(torch.int64) << 16)
            | stage.args[:, :, dport_a].to(torch.int64)
        )
        tail = _I64MAX - sw  # ineligible slots key past every flow, stably
        k1 = torch.where(elig, flow, tail + slot)
        k2 = torch.where(elig, stage.args[:, :, seq_a].to(torch.int64), 0)
        # lax.sort(num_keys=2) as two stable sorts, minor key first
        o = torch.sort(k2, dim=1, stable=True).indices
        o = torch.gather(o, 1, torch.sort(torch.gather(k1, 1, o), dim=1,
                                          stable=True).indices)
        k1, k2 = torch.gather(k1, 1, o), torch.gather(k2, 1, o)
        srt = _take_slots(stage, o)
        t2 = srt.time
        acols = [srt.args[:, :, i] for i in range(srt.args.shape[2])]
        ln2 = acols[len_a]
        elig2 = k1 < tail  # eligibility survives the sort via k1

        def prev(a, fill):
            return torch.cat([torch.full_like(a[:, :1], fill), a[:, :-1]], 1)

        # column 0 never continues a run (prev(elig2) is False there), so
        # the k2 fill only has to keep `+ 1` from overflowing
        contig = (
            elig2
            & prev(elig2, False)
            & (k1 == prev(k1, -1))
            & (k2 == prev(k2, 0) + 1)
            & (prev(ln2, 0) == mss)  # only a run's LAST segment may be short
        )
        start = elig2 & ~contig
        run = torch.cumsum(start.to(torch.int32), dim=1, dtype=torch.int32)
        same = (
            (run[:, :, None] == run[:, None, :])
            & elig2[:, :, None] & elig2[:, None, :]
        )  # [H, SW, SW]
        count = torch.sum(same, dim=2, dtype=torch.int32)
        total = torch.sum(torch.where(same, ln2[:, None, :], 0), dim=2,
                          dtype=ln2.dtype)
        tmin = torch.min(torch.where(same, t2[:, None, :], _I64MAX),
                         dim=2).values
        folded_head = start & (count > 1)
        absorbed = elig2 & contig & (count > 1)
        acols[len_a] = torch.where(
            folded_head, total | (count << BURST_NSEG_SHIFT), ln2)
        # the head takes the run's last member's control words as one
        # consistent snapshot
        idx2 = torch.arange(sw, dtype=torch.int32, device=dev)[None, None, :]
        endpos = torch.max(torch.where(same, idx2, -1), dim=2).values
        at_end = (idx2 == endpos[:, :, None]) & same
        for col in ctl_cols:
            v = acols[col]
            vend = torch.sum(torch.where(at_end, v[:, None, :], 0), dim=2,
                             dtype=v.dtype)
            acols[col] = torch.where(folded_head, vend, v)
        return dataclasses.replace(
            srt,
            time=torch.where(absorbed, TIME_INVALID,
                             torch.where(folded_head, tmin, t2)),
            args=torch.stack(acols, dim=-1),
        )

    @staticmethod
    def _stage_min(stage: Events):
        """Per host, the minimum-(time, src, seq) staged event.

        Returns (ev: Events with [H] fields, mss i64[H] the packed
        (src, seq) key of that event, onehot bool[H, S] selecting its
        slot, valid_cnt i32[H]). Empty rows yield time = TIME_INVALID.
        """
        t = stage.time
        s = t.shape[1]
        mt = torch.min(t, dim=1).values
        cand = t == mt[:, None]
        ss = pack_srcseq(stage.src, stage.seq)
        ssm = torch.where(cand, ss, _I64MAX)
        mss = torch.min(ssm, dim=1).values
        sel = cand & (ssm == mss[:, None])
        # first selected slot; (time, src, seq) is unique among events
        first = torch.argmax(sel.to(torch.int32), dim=1)
        onehot = (torch.arange(s, device=t.device)[None, :]
                  == first[:, None])

        def pick(a):
            m = onehot.reshape(onehot.shape + (1,) * (a.dim() - 2))
            return torch.sum(torch.where(m, a, 0), dim=1, dtype=a.dtype)

        ev = Events(time=mt, dst=pick(stage.dst), src=pick(stage.src),
                    seq=pick(stage.seq), kind=pick(stage.kind),
                    args=pick(stage.args))
        valid_cnt = torch.sum(t != TIME_INVALID, dim=1, dtype=torch.int32)
        return ev, mss, onehot, valid_cnt

    @staticmethod
    def _stage_append(stage: Events, out: Events) -> Events:
        """Append a routed [H, K] emit batch into each host's free staging
        slots by rank matching: the j-th valid emit lands in the j-th
        free slot (two cumsum rank scans + one [H, S, K] compare). The
        caller's high-water gate guarantees K free slots per row."""
        i32 = torch.int32
        free = stage.time == TIME_INVALID  # [H, S]
        fr = torch.cumsum(free.to(i32), dim=1, dtype=i32) - free.to(i32)
        valid = out.time != TIME_INVALID  # [H, K]
        er = torch.cumsum(valid.to(i32), dim=1, dtype=i32) - valid.to(i32)
        match = (
            (fr[:, :, None] == er[:, None, :])
            & free[:, :, None]
            & valid[:, None, :]
        )  # [H, S, K]; at most one True per (row, slot) and per emit
        hit = torch.any(match, dim=2)

        def put(cur, new):  # [H, S](, A) <- [H, K](, A)
            if cur.dim() == 2:
                sel = torch.sum(torch.where(match, new[:, None, :], 0),
                                dim=2, dtype=new.dtype)
                return torch.where(hit, sel, cur)
            sel = torch.sum(
                torch.where(match[..., None], new[:, None, :, :], 0),
                dim=2, dtype=new.dtype)
            return torch.where(hit[..., None], sel, cur)

        return Events(**{f.name: put(getattr(stage, f.name),
                                     getattr(out, f.name))
                         for f in dataclasses.fields(stage)})

    def _dump(self, q: EventQueue, window_end, gids, b: int, sw: int):
        """A sweep's start: dump each host's earliest-b below-barrier
        prefix into [H, sw] staging (burst-folded when configured) and
        clear it from the queue. Returns (queue', staging, qh_t, qh_ss):
        the key of each host's first un-dumped event, the queue-head
        guard a staged event must order before to run this sweep."""
        h, c = q.time.shape
        cols = torch.arange(c, dtype=torch.int32, device=q.time.device)[None]
        bvalid = q.time[:, :b] < window_end
        ndump = torch.sum(bvalid, dim=1, dtype=torch.int32)
        pad = sw - b
        stage = Events(
            time=_pad_slots(torch.where(bvalid, q.time[:, :b],
                                        TIME_INVALID), pad, TIME_INVALID),
            dst=_pad_slots(gids[:, None].expand(h, b), pad, 0),
            src=_pad_slots(q.src[:, :b], pad, 0),
            seq=_pad_slots(q.seq[:, :b], pad, 0),
            kind=_pad_slots(q.kind[:, :b], pad, 0),
            args=_pad_slots(q.args[:, :b], pad, 0),
        )
        q = dataclasses.replace(q, time=torch.where(
            cols < ndump[:, None], TIME_INVALID, q.time))
        if self.cfg.burst is not None:
            # the dump precedes the queue head, so folding inside it
            # cannot violate the head guard
            stage = self._burst_fold(stage)
        headsel = cols == ndump[:, None]
        qh_t = torch.min(torch.where(headsel, q.time, _I64MAX), dim=1).values
        qh_ss = torch.min(torch.where(
            headsel & (q.time != TIME_INVALID),
            pack_srcseq(q.src, q.seq), _I64MAX), dim=1).values
        return q, stage, qh_t, qh_ss

    def _runnable(self, sm, cpu_free, window_end, qh_t, qh_ss, sw: int):
        """Rows whose minimum staged event runs next: below the barrier
        (CPU permitting), before the queue head, and with append headroom
        (the high-water gate). Returns (rows, effective times)."""
        ev, mss, _oh, cnt = sm
        eff_t = (torch.maximum(ev.time, cpu_free) if self._cpu_enabled
                 else ev.time)
        active = ((ev.time != TIME_INVALID) & (eff_t < window_end)
                  & _precedes(ev.time, mss, qh_t, qh_ss)
                  & (cnt + self.cfg.max_emit <= sw))
        return active, eff_t

    def _charge_cpu(self, cpu_cost, ev: Events, active, eff_t, cpu_free):
        """Advance each active host's virtual CPU past its event."""
        ev_cost = _kind_cost(cpu_cost, ev.kind)
        if self.cfg.burst is not None:
            # a folded arrival pays per segment; zero-payload count
            # carriers are one packet
            bkind, _sq, blen = self.cfg.burst[:3]
            lw = ev.args[:, blen]
            nseg = torch.where((lw & BURST_LEN_MASK) > 0,
                               torch.clamp(lw >> BURST_NSEG_SHIFT, min=1), 1)
            ev_cost = ev_cost * torch.where(
                ev.kind == bkind, nseg.to(ev_cost.dtype), 1)
        return torch.where(active & (ev_cost > 0), eff_t + ev_cost, cpu_free)

    @staticmethod
    def _sort_stage(stage: Events) -> Events:
        """Each host's staging in (time, src, seq) order: the valid
        entries become a prefix (two stable sorts, minor key first)."""
        skey = pack_srcseq(stage.src, stage.seq)
        o = torch.sort(skey, dim=1, stable=True).indices
        o = torch.gather(o, 1, torch.sort(
            torch.gather(stage.time, 1, o), dim=1, stable=True).indices)
        return _take_slots(stage, o)

    def _flush(self, q: EventQueue, xchg, stage: Events, host0: int,
               stats: Stats, part=None):
        """A sweep's end: push the staging leftovers, compacted to a
        prefix; FLUSH_W columns unless a row holds more (on any shard,
        when sharded). Returns (queue', xchg', stats')."""
        stage = self._sort_stage(stage)
        sw = stage.time.shape[1]
        w1 = min(sw, FLUSH_W)
        if w1 < sw and not self._read(self._gany(torch.max(torch.sum(
                stage.time != TIME_INVALID, dim=1, dtype=torch.int32)) > w1)):
            stage = Events(**{f.name: getattr(stage, f.name)[:, :w1]
                              for f in dataclasses.fields(stage)})
        flat = stage.flatten()
        lane = (self._row_lane[:, None].expand(stage.time.shape).reshape(-1)
                if self.lanes else None)
        q, xchg, rounds, nc = self._exchange_push(
            q, xchg, flat, flat.time != TIME_INVALID, host0, lane, part)
        return q, xchg, self._count_xchg(stats, rounds, nc)

    def _count_xchg(self, stats: Stats, rounds: int, nc) -> Stats:
        """Add a push's exchange rounds and cross-shard packets."""
        if self.comm is None:
            return stats
        return dataclasses.replace(
            stats, n_xchg_rounds=stats.n_xchg_rounds + rounds,
            n_cross_shard=stats.n_cross_shard + nc)

    def _gids(self, host0: int) -> torch.Tensor:
        """The global ids of this engine's rows: the shard's hosts, or
        for lanes every lane's hosts by their lane-local ids."""
        if self.lanes:
            return self._lane_gids
        return host0 + torch.arange(self.cfg.n_hosts, dtype=torch.int32,
                                    device=self.device)

    def _drain_window(self, st: EngineState, window_end, host0: int
                      ) -> EngineState:
        """Drain every event below `window_end`: the chained drain, or
        the frontier one (cfg.frontier > 0), or the batched one for
        engines with a batch_handler."""
        if self.batch_handler is not None:
            return self._drain_window_batched(st, window_end, host0)
        if self.cfg.frontier > 0:
            return self._drain_window_frontier(st, window_end, host0)
        cfg = self.cfg
        b = cfg.eff_drain_batch
        sw = max(cfg.eff_stage_width, b + cfg.max_emit)
        gids = self._gids(host0)
        cpu_cost = self.cpu_cost[gids.long()]  # [H, NK]
        al_sh = self._alive_ht
        q, hosts, stats = st.queues, st.hosts, st.stats
        src_seq, exec_cnt, cpu_free = st.src_seq, st.exec_cnt, st.cpu_free
        trace, splane, xchg = st.trace, st.splane, st.xchg

        fl = self._drain_flag(q, cpu_free, window_end)
        while self._read(self._any(fl)):
            # the previous sweep's in-flight exchange lands first
            q, xchg = self._xchg_deliver(q, xchg, host0)
            wr, wc = self._bars(window_end, fl)
            # 1. dump each host's earliest-b below-barrier prefix
            splane = self._observe_qfill(splane, q, wc, b)
            q, stage, qh_t, qh_ss = self._dump(q, wc, gids, b, sw)

            # 2. chained execution, one staged event per host per step
            sm = self._stage_min(stage)
            active, eff_t = self._runnable(sm, cpu_free, wr, qh_t, qh_ss,
                                           sw)
            la = self._lane_any(active) if self.lanes else None
            while self._read(torch.any(active)):
                ev, _mss, onehot, _cnt = sm
                runm, stats = self._quarantine(al_sh, active, eff_t, stats)
                stage = dataclasses.replace(stage, time=torch.where(
                    onehot & active[:, None], TIME_INVALID, stage.time))
                ev = dataclasses.replace(
                    ev, time=torch.where(runm, eff_t, TIME_INVALID),
                    dst=gids)
                hosts, src_seq, exec_cnt, stats, out, _, splane, rec = \
                    self._execute_step(hosts, src_seq, exec_cnt, stats, ev,
                                       runm, wc, gids, splane)
                if rec is not None:
                    trace = self._trace_put(trace, rec, la)
                if self._cpu_enabled:
                    cpu_free = self._charge_cpu(cpu_cost, ev, runm, eff_t,
                                                cpu_free)
                stage = self._stage_append(stage, out)
                stats = dataclasses.replace(stats, n_inner_steps=self._count(
                    stats.n_inner_steps, la))
                sm = self._stage_min(stage)
                active, eff_t = self._runnable(sm, cpu_free, wr, qh_t,
                                               qh_ss, sw)
                if self.lanes:
                    la = self._lane_any(active)

            # 3. flush the leftovers
            q, xchg, stats = self._flush(q, xchg, stage, host0, stats, fl)
            stats = dataclasses.replace(
                stats, n_sweeps=self._count(stats.n_sweeps, fl))
            fl = self._drain_flag(q, cpu_free, window_end)

        return self._end_window(st, q, hosts, src_seq, exec_cnt, stats,
                                cpu_free, trace, splane, xchg, host0,
                                window_end)

    def _observe_qfill(self, splane, q: EventQueue, window_end, b: int):
        """Queue fill at the dump (before the prefix clears), over the
        hosts that dump at least one event."""
        if splane is None:
            return None
        return splane.observe(
            "qfill", torch.sum(q.time != TIME_INVALID, dim=1,
                               dtype=torch.int64),
            torch.any(q.time[:, :b] < window_end, dim=1))

    def _end_window(self, st: EngineState, q, hosts, src_seq, exec_cnt,
                    stats, cpu_free, trace, splane, xchg,
                    host0: int, window_end=None) -> EngineState:
        """The drained window's state: n_windows counted, and the
        per-window occupancy sampled (hosts that ran something). When
        sharded, the shard-local inner steps are summed over the shards,
        and with a CPU model the in-flight exchange lands first (the
        barrier's sent minimum cannot see a destination's busy CPU)."""
        if self.comm is not None:
            if self._cpu_enabled:
                q, xchg = self._xchg_deliver(q, xchg, host0)
        if self.comm is not None and self.batch_handler is None:
            stats = dataclasses.replace(
                stats, n_inner_steps=st.stats.n_inner_steps + self._gsum(
                    stats.n_inner_steps - st.stats.n_inner_steps))
        if splane is not None:
            occ = stats.n_executed - st.stats.n_executed
            splane = splane.observe("occ", occ, occ > 0)
        return dataclasses.replace(
            st, queues=q, hosts=hosts, src_seq=src_seq, exec_cnt=exec_cnt,
            stats=dataclasses.replace(stats, n_windows=self._count(
                stats.n_windows,
                window_end != _LOW if self.lanes else None)),
            cpu_free=cpu_free, trace=trace, xchg=xchg, splane=splane,
        )

    # -- the frontier drain: runs of equal-time, same-kind events -----------
    def _drain_window_frontier(self, st: EngineState, window_end,
                               host0: int) -> EngineState:
        """The chained drain's sweeps with the staging bookkeeping done
        once per round, bit-identical to the chained drain.

        Per round each host's staging is key-sorted once, so column j is
        the host's j-th smallest staged event. Positions then execute in
        order, each running the handler table once for every host whose
        column j continues the run of column 0's time and kind (kinds
        outside `frontier_kinds` run alone), with the chained drain's
        per-event stall tests (CPU, queue head, headroom). The run rule
        is exact because every local emit lands at dt >= 1 (the model
        declares it; build_simulation refuses configs that cannot) and
        remote emits at >= the window end, so no emit can order before a
        remaining run member. A round ends when a position runs no host
        (that probe counts as a position in `n_inner_steps`, as in the
        reference) or after `cfg.frontier` positions; then the executed
        columns clear as a prefix and every position's emits append in
        one `_stage_append`. A dead host's members clear without running
        (quarantine), as on the chained drain. Tracing appends once per
        round: every position's 1 + K records in position order (the
        chained drain's record order), padded with masked lanes to
        `cfg.frontier` positions as the reference's round buffer is; the
        stats plane samples each round's run length per host.
        """
        cfg, dev = self.cfg, self.device
        h, k = self._n_rows, cfg.max_emit
        b = cfg.eff_drain_batch
        sw = max(cfg.eff_stage_width, b + k)
        u = max(1, min(cfg.frontier, sw))
        gids = self._gids(host0)
        cpu_cost = self.cpu_cost[gids.long()]  # [H, NK]
        al_sh = self._alive_ht
        slot = torch.arange(sw, dtype=torch.int32, device=dev)[None, :]
        q, hosts, stats = st.queues, st.hosts, st.stats
        src_seq, exec_cnt, cpu_free = st.src_seq, st.exec_cnt, st.cpu_free
        trace, splane, xchg = st.trace, st.splane, st.xchg

        fl = self._drain_flag(q, cpu_free, window_end)
        while self._read(self._any(fl)):
            q, xchg = self._xchg_deliver(q, xchg, host0)
            wr, wc = self._bars(window_end, fl)
            # 1. the frontier dump, as on the chained drain
            splane = self._observe_qfill(splane, q, wc, b)
            q, stage, qh_t, qh_ss = self._dump(q, wc, gids, b, sw)

            # 2. rounds: sort once, execute a run, bookkeep once; for
            # lanes, `rl` holds the lanes with a round to run, `lin` those
            # whose round has not ended and `jl` each lane's positions
            sm = self._stage_min(stage)
            rn = self._runnable(sm, cpu_free, wr, qh_t, qh_ss, sw)[0]
            rl = self._lane_any(rn) if self.lanes else None
            while self._read(torch.any(rn)):
                lin = rl
                jl = (torch.zeros((self.lanes,), dtype=torch.int64,
                                  device=dev) if self.lanes else None)
                stage = self._sort_stage(stage)
                ss = pack_srcseq(stage.src, stage.seq)
                cnt = torch.sum(stage.time != TIME_INVALID, dim=1,
                                dtype=torch.int32)
                t0, kind0 = stage.time[:, 0], stage.kind[:, 0]
                allowed0 = (torch.isin(kind0, self._fk)
                            if self._fk is not None else None)
                still = torch.ones((h,), dtype=torch.bool, device=dev)
                nact = torch.zeros((h,), dtype=torch.int32, device=dev)
                outs, recs = [], []
                j = 0
                while j < u:
                    ev_t = stage.time[:, j]
                    eff_t = (torch.maximum(ev_t, cpu_free)
                             if self._cpu_enabled else ev_t)
                    member = (ev_t == t0) & (stage.kind[:, j] == kind0)
                    if allowed0 is not None and j > 0:
                        member = member & allowed0
                    active = (still & member & (ev_t != TIME_INVALID)
                              & (eff_t < wr)
                              & _precedes(ev_t, ss[:, j], qh_t, qh_ss)
                              & (cnt + k <= sw))
                    j += 1
                    if self.lanes:
                        # a lane counts every position up to its own
                        # terminating probe
                        jl = jl + lin
                        lin = lin & self._lane_any(active)
                    if not self._read(torch.any(active)):
                        break  # the terminating probe: nothing ran
                    # a dead host's member is consumed, not run
                    runm, stats = self._quarantine(al_sh, active, eff_t,
                                                   stats)
                    ev = Events(time=torch.where(runm, eff_t, TIME_INVALID),
                                dst=gids, src=stage.src[:, j - 1],
                                seq=stage.seq[:, j - 1],
                                kind=stage.kind[:, j - 1],
                                args=stage.args[:, j - 1])
                    hosts, src_seq, exec_cnt, stats, out, fmask, splane, \
                        rec = self._execute_step(hosts, src_seq, exec_cnt,
                                                 stats, ev, runm, wc,
                                                 gids, splane)
                    if rec is not None:
                        recs.append(rec)
                    if self._cpu_enabled:
                        cpu_free = self._charge_cpu(cpu_cost, ev, runm,
                                                    eff_t, cpu_free)
                    cnt = (cnt - active.to(torch.int32)
                           + torch.sum(fmask, dim=1, dtype=torch.int32))
                    nact = nact + active.to(torch.int32)
                    outs.append(out)
                    still = active

                if splane is not None:
                    splane = splane.observe("runlen", nact, nact > 0)

                # 3. the round's bookkeeping: clear the executed prefix,
                # append every position's routed emits (headroom held by
                # the per-position gate), in position order
                stage = dataclasses.replace(stage, time=torch.where(
                    slot < nact[:, None], TIME_INVALID, stage.time))
                if outs:
                    stage = self._stage_append(stage, Events(**{
                        f.name: torch.cat([getattr(o, f.name) for o in outs],
                                          dim=1)
                        for f in dataclasses.fields(Events)}))
                if self._trace:
                    # positions that did not run are masked lanes
                    pad = (u - len(recs)) * (1 + k)
                    if pad:
                        recs.append({key: v.new_zeros((h, pad))
                                     for key, v in recs[0].items()})
                    trace = self._trace_put(trace, {
                        key: torch.cat([r[key] for r in recs], dim=1)
                        for key in recs[0]}, rl)
                stats = dataclasses.replace(stats, n_inner_steps=self._count(
                    stats.n_inner_steps, jl, j))
                sm = self._stage_min(stage)
                rn = self._runnable(sm, cpu_free, wr, qh_t, qh_ss, sw)[0]
                if self.lanes:
                    rl = self._lane_any(rn)

            # 4. flush the leftovers, as on the chained drain
            q, xchg, stats = self._flush(q, xchg, stage, host0, stats, fl)
            stats = dataclasses.replace(
                stats, n_sweeps=self._count(stats.n_sweeps, fl))
            fl = self._drain_flag(q, cpu_free, window_end)

        return self._end_window(st, q, hosts, src_seq, exec_cnt, stats,
                                cpu_free, trace, splane, xchg, host0,
                                window_end)

    # -- the batched drain ---------------------------------------------------
    def _sweep(self, st: EngineState, window_end, host0: int,
               fl=None) -> EngineState:
        """One sweep: execute every host's below-barrier frontier in one
        handler call, route the emits, clear the frontier, push. A host
        dead at an event's time consumes it without running it
        (quarantine): the prefix still clears and the event's RNG
        position is still spent. For lanes, `window_end` holds the [L]
        barriers and `fl` the lanes that sweep."""
        cfg, dev = self.cfg, self.device
        h, k, c = self._n_rows, cfg.max_emit, cfg.capacity
        b = cfg.eff_drain_batch
        # the previous sweep's in-flight exchange lands first
        q, xchg = self._xchg_deliver(st.queues, st.xchg, host0)
        cpu_free = st.cpu_free
        gids = self._gids(host0)
        gids_hb = gids[:, None].expand(h, b)
        wr, wc = self._bars(window_end, fl)
        bt = q.time[:, :b]
        bvalid = bt < wc  # a prefix: rows are key-sorted
        if self._cpu_enabled:
            # a host whose virtual CPU is busy past the barrier runs
            # nothing this window
            bvalid = bvalid & (cpu_free[:, None] < wc)
        splane = st.splane
        if splane is not None:
            # queue fill at the pop, before the prefix clears
            splane = splane.observe(
                "qfill", torch.sum(q.time != TIME_INVALID, dim=1,
                                   dtype=torch.int64),
                torch.any(bvalid, dim=1))
        run = bvalid
        if self._f_crash:
            run = bvalid & self._alive_at(self._alive_ht,
                                          torch.where(bvalid, bt, 0))
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
        base_key, lane_hb, we_hb = self._base_key, None, wc
        if self.lanes:
            base_key = base_key[:, None].expand(h, b, 2).reshape(-1, 2)
            lane_hb = self._row_lane[:, None].expand(h, b).reshape(-1)
            we_hb = wr[:, None].expand(h, b).reshape(-1, 1)
        hk, rk = srng.event_keys(base_key, gids_hb.reshape(-1),
                                 cnts.reshape(-1))
        hosts2, emit = self.batch_handler(st.hosts, evs,
                                          hk.reshape(h, b, 2))
        # n_exec counts the cleared prefix and the RNG positions, which
        # quarantined events consume too; n_run counts executions
        n_exec = torch.sum(bvalid, dim=1, dtype=torch.int32)
        n_run = (torch.sum(run, dim=1, dtype=torch.int32) if self._f_crash
                 else n_exec)
        hosts = _select_rows(n_run > 0, hosts2, st.hosts)
        emask = emit.mask & run[:, :, None]

        # dense per-source sequence numbers across the [B, K] lanes
        inc = emask.to(torch.int32).reshape(h, b * k)
        within = torch.cumsum(inc, dim=1, dtype=torch.int32) - inc
        seq = (st.src_seq[:, None] + within).reshape(h, b, k)
        src_seq = st.src_seq + torch.sum(inc, dim=1, dtype=torch.int32)

        flat = lambda a: a.reshape((h * b,) + tuple(a.shape[2:]))
        out, final_mask, dropped, fdropped, t_r, is_local = self._route(
            Emit(**{f.name: flat(getattr(emit, f.name))
                    for f in dataclasses.fields(emit)}),
            evs.time.reshape(-1),
            gids_hb.reshape(-1),
            we_hb,
            rk,
            flat(emask),
            flat(seq),
            lane_hb,
        )
        if splane is not None:
            delta = (t_r - evs.time.reshape(-1)[:, None]).reshape(h, b * k)
            fm = final_mask.reshape(h, b * k)
            splane = splane.observe("wait", delta, fm)
            splane = splane.observe("net", delta,
                                    fm & ~is_local.reshape(h, b * k))
        trace = st.trace
        if self._trace:
            # one width-(B + B*K) append per sweep
            trace = self._trace_put(trace, self._trace_rec(
                evs, out, run, flat(emask), dropped, fdropped, is_local), fl)
        s = st.stats
        stats = dataclasses.replace(
            s,
            n_executed=s.n_executed + n_run,
            n_emitted=s.n_emitted + torch.sum(inc, dim=1, dtype=torch.int64),
            n_net_dropped=s.n_net_dropped + torch.sum(
                dropped.reshape(h, b * k), dim=1, dtype=torch.int64),
            n_by_kind=s.n_by_kind + torch.sum(
                _one_hot_kind(evs.kind, self.n_kinds) * run[:, :, None],
                dim=1),
            n_sweeps=self._count(s.n_sweeps, fl),
        )
        if fdropped is not None:
            stats = dataclasses.replace(
                stats, n_fault_dropped=stats.n_fault_dropped + torch.sum(
                    fdropped.reshape(h, b * k), dim=1, dtype=torch.int64))
        if self._f_crash:
            stats = dataclasses.replace(
                stats, n_quarantined=stats.n_quarantined + torch.sum(
                    bvalid & ~run, dim=1, dtype=torch.int64))
        if self._cpu_enabled:
            # the frontier's summed per-kind costs advance cpu_free past
            # its last executed event
            cpu_cost = self.cpu_cost[gids.long()]
            total = torch.sum(
                torch.where(run, _kind_cost(cpu_cost, evs.kind), 0), dim=1)
            t_last = torch.max(torch.where(run, bt, 0), dim=1).values
            cpu_free = torch.where(total > 0,
                                   torch.maximum(cpu_free, t_last) + total,
                                   cpu_free)
        cleared = (torch.arange(c, dtype=torch.int32, device=dev)[None, :]
                   < n_exec[:, None])
        q = dataclasses.replace(
            q, time=torch.where(cleared, TIME_INVALID, q.time))
        q, xchg, rounds, nc = self._exchange_push(
            q, xchg, out.flatten(), final_mask.reshape(-1), host0,
            None if lane_hb is None
            else lane_hb[:, None].expand(h * b, k).reshape(-1), fl)
        return dataclasses.replace(
            st, queues=q, hosts=hosts, src_seq=src_seq,
            exec_cnt=st.exec_cnt + n_exec,
            stats=self._count_xchg(stats, rounds, nc), cpu_free=cpu_free,
            trace=trace, xchg=xchg, splane=splane,
        )

    def _drain_window_batched(self, st: EngineState, window_end,
                              host0: int) -> EngineState:
        """Sweep until no host has an executable event below
        `window_end`."""
        st0 = st
        fl = self._drain_flag(st.queues, st.cpu_free, window_end)
        while self._read(self._any(fl)):
            st = self._sweep(st, window_end, host0,
                             fl if self.lanes else None)
            fl = self._drain_flag(st.queues, st.cpu_free, window_end)
        return self._end_window(st0, st.queues, st.hosts, st.src_seq,
                                st.exec_cnt, st.stats, st.cpu_free,
                                st.trace, st.splane, st.xchg, host0,
                                window_end)

    # -- windows -------------------------------------------------------------
    def _next_time(self, st: EngineState) -> torch.Tensor:
        """Global earliest executable time: per host the earliest pending
        event, deferred to when its virtual CPU frees (TIME_INVALID when
        every queue is empty). Sharded, the in-flight exchange's sent
        minimum folds in, then the min is taken over the shards."""
        nxt = st.queues.min_time()
        if self._cpu_enabled:
            nxt = torch.maximum(nxt, st.cpu_free)
        if self.lanes:
            return torch.min(nxt.reshape(self.lanes, -1), dim=1).values
        m = torch.min(nxt)
        if st.xchg is not None:
            m = torch.minimum(m, st.xchg.sent_min[0])
        return self._gmin(m)

    def _opens(self, st: EngineState, nxt, stop):
        """Whether a window opens at `nxt` (nxt < stop), in one counted
        read. With a fault schedule that read fetches (nxt, the epoch
        watermark, stop) instead of the flag, and the epoch of nxt is
        looked up on the host: returns (opens, (epoch, watermark) or
        None)."""
        if not self._f_any:
            return self._read(nxt < stop), None
        t, mark = (int(v) for v in self._fetch(torch.stack(
            [nxt, st.fault_epoch.to(torch.int64)])))
        return t < stop, (self.faults.epoch_at_host(t), mark)

    def _apply_fault_epoch(self, st: EngineState, e: int, mark: int
                           ) -> EngineState:
        """Apply the fault-schedule transitions entered since epoch
        `mark` (the watermark) up to `e`, the epoch the window opens in.

        Hosts dead at any newly entered epoch lose their queues (counted
        as quarantined: a crash voids pending work) and take their state
        rows from `fault_reset`, which is what a restart is: fresh
        listening sockets, zeroed app state, while `src_seq`/`exec_cnt`
        stay monotone so (src, seq) uniqueness and the RNG streams
        survive the reboot. Bandwidth epochs rescale NIC rates from the
        template's."""
        f = self.faults
        hosts, q, stats = st.hosts, st.queues, st.stats
        tmpl = self._tmpl
        h0, h = self.host0, self.cfg.n_hosts
        if self._f_crash:
            reset = torch.any(~f.alive[mark + 1:e + 1, h0:h0 + h],
                              dim=0)  # [H]
            wiped = torch.sum(reset[:, None] & (q.time != TIME_INVALID),
                              dim=1, dtype=torch.int64)
            q = dataclasses.replace(q, time=torch.where(
                reset[:, None], TIME_INVALID, q.time))
            hosts = _select_rows(reset, tmpl, hosts)
            stats = dataclasses.replace(
                stats, n_quarantined=stats.n_quarantined + wiped)
        if self._f_bw:
            bw_e = f.bw_scale[e, h0:h0 + h]
            net = hosts.net
            hosts = dataclasses.replace(hosts, net=dataclasses.replace(
                net,
                nic_tx=dataclasses.replace(
                    net.nic_tx, rate=tmpl.net.nic_tx.rate * bw_e),
                nic_rx=dataclasses.replace(
                    net.nic_rx, rate=tmpl.net.nic_rx.rate * bw_e)))
        return dataclasses.replace(
            st, queues=q, hosts=hosts, stats=stats,
            fault_epoch=torch.full((), e, dtype=torch.int32,
                                   device=self.device))

    def _advance(self, st: EngineState, nxt, stop: int, host0: int,
                 epochs=None, window: int | None = None) -> EngineState:
        """Open the window [nxt, min(nxt + window, stop)) and drain it,
        after applying the fault epoch it opens in if the watermark is
        behind (`epochs` from `_opens`). `window` defaults to the
        lookahead; another width stays causal (`_route` clamps cross-host
        arrivals up to the window's end) but is not bit-identical to it:
        a farther end defers those arrivals with it, as `--runahead`
        does."""
        if window is None:
            window = self.cfg.lookahead
        window_end = torch.clamp(nxt + window, max=stop)
        if st.xchg is not None:
            # the previous window's in-flight exchange lands before the
            # fault epoch's wipe and the drain's first flag
            q, xchg = self._xchg_deliver(st.queues, st.xchg, host0)
            st = dataclasses.replace(st, queues=q, xchg=xchg)
        if epochs is not None and epochs[0] != epochs[1]:
            st = self._apply_fault_epoch(st, *epochs)
        st = self._drain_window(st, window_end, host0)
        return dataclasses.replace(st, now=window_end)

    def _land(self, st: EngineState, stop: int, host0: int
              ) -> EngineState:
        """`st` with its clock on `stop`, filled on the device (a Python
        int is passed to the ops, never copied to the device). The
        in-flight exchange lands first, so the final queues are those
        of an unsharded run."""
        if st.xchg is not None:
            q, xchg = self._xchg_deliver(st.queues, st.xchg, host0)
            st = dataclasses.replace(st, queues=q, xchg=xchg)
        return dataclasses.replace(st, now=torch.full(
            (), stop, dtype=torch.int64, device=self.device))

    # -- windows of lanes ----------------------------------------------------
    def _lane_stop(self, stop):
        """A stop for every lane, from one stop or one per lane: (i64[L]
        on the device, the same on the host)."""
        if isinstance(stop, torch.Tensor):
            stop = stop.cpu().numpy()
        arr = np.asarray(stop, dtype=np.int64)
        if arr.ndim == 0:
            return (torch.full((self.lanes,), int(arr), dtype=torch.int64,
                               device=self.device),
                    np.full((self.lanes,), int(arr), np.int64))
        if arr.shape != (self.lanes,):
            raise ValueError(f"per-lane stop must be scalar or "
                             f"[{self.lanes}], got shape {arr.shape}")
        return torch.from_numpy(arr.copy()).to(self.device), arr

    def _opens_lanes(self, st: EngineState, nxt, stop_t, stop_np):
        """The lanes whose window opens (nxt < stop), in one counted read
        for the fleet: (any lane opens, the [L] flags on the device,
        whether a lane that opens enters a new fault epoch). With a fault
        schedule the read fetches every lane's (nxt, watermark), and the
        epochs are looked up on the host in each lane's schedule."""
        opens = nxt < stop_t
        if not self._f_any:
            return self._read(torch.any(opens)), opens, False
        got = self._fetch(torch.cat([nxt, st.fault_epoch.to(torch.int64)]))
        t, mark = got[:self.lanes], got[self.lanes:]
        op = t < stop_np
        e = np.sum(self._np_times <= t[:, None], axis=1) - 1
        return bool(op.any()), opens, bool(np.any(op & (e != mark)))

    def _apply_fault_epoch_lanes(self, st: EngineState, nxt, opens
                                 ) -> EngineState:
        """`_apply_fault_epoch` for every lane at once: each lane whose
        window opens in an epoch past its watermark applies the
        transitions it entered (a per-lane mask over the padded epochs),
        the others are left as they are."""
        f = self.faults
        lanes, h = self.lanes, self.cfg.n_hosts
        tt = f.times.shape[1]
        hosts, q, stats, tmpl = st.hosts, st.queues, st.stats, self._tmpl
        lane = torch.arange(lanes, device=self.device)
        e = self._epoch(nxt, lane)
        mark = st.fault_epoch
        chg = opens & (e != mark)
        if self._f_crash:
            idx = torch.arange(tt, dtype=torch.int32, device=self.device)
            gap = ((idx[None, :] > mark[:, None])
                   & (idx[None, :] <= e[:, None]) & chg[:, None])  # [L, T]
            reset = torch.any(gap[:, :, None] & ~f.alive, dim=1).reshape(-1)
            wiped = torch.sum(reset[:, None] & (q.time != TIME_INVALID),
                              dim=1, dtype=torch.int64)
            q = dataclasses.replace(q, time=torch.where(
                reset[:, None], TIME_INVALID, q.time))
            hosts = _select_rows(reset, tmpl, hosts)
            stats = dataclasses.replace(
                stats, n_quarantined=stats.n_quarantined + wiped)
        if self._f_bw:
            ec = torch.clamp(e, min=0).long()
            bw_e = torch.gather(f.bw_scale, 1, ec[:, None, None].expand(
                lanes, 1, h)).reshape(-1)  # [L * H]
            chg_r = self._per_row(chg)
            net = hosts.net

            def scaled(cur, base):
                return dataclasses.replace(cur, rate=torch.where(
                    chg_r, base.rate * bw_e, cur.rate))

            hosts = dataclasses.replace(hosts, net=dataclasses.replace(
                net, nic_tx=scaled(net.nic_tx, tmpl.net.nic_tx),
                nic_rx=scaled(net.nic_rx, tmpl.net.nic_rx)))
        return dataclasses.replace(
            st, queues=q, hosts=hosts, stats=stats,
            fault_epoch=torch.where(chg, e, mark))

    def _advance_lanes(self, st: EngineState, nxt, stop_t, opens,
                       epoch_change: bool, window: int | None = None
                       ) -> EngineState:
        """`_advance` for every lane whose window opens: the others take
        the `_LOW` barrier, so the drain leaves them as they are, and
        keep their clock."""
        if window is None:
            window = self.cfg.lookahead
        window_end = torch.clamp(nxt + window, max=stop_t)
        if epoch_change:
            st = self._apply_fault_epoch_lanes(st, nxt, opens)
        st = self._drain_window(st, torch.where(opens, window_end, _LOW), 0)
        return dataclasses.replace(st, now=torch.where(opens, window_end,
                                                       st.now))

    # no autograd bookkeeping per op (23% of a run's host time on the
    # CPU); the results are inference tensors, which callers update out
    # of place, as every state here is
    @torch.inference_mode()
    def step_window(self, st: EngineState, stop: int,
                    host0: int | None = None,
                    window: int | None = None) -> EngineState:
        """Advance one conservative window (`window` wide, the lookahead
        by default: see `_advance`); when no event below `stop` remains,
        land on `stop`. `host0` defaults to this shard's. For lanes,
        `stop` is one stop or one per lane, and each lane advances one
        window or, if none of its events is below its stop, lands."""
        if self.lanes:
            stop_t, stop_np = self._lane_stop(stop)
            nxt = self._next_time(st)
            opens_any, opens, ech = self._opens_lanes(st, nxt, stop_t,
                                                      stop_np)
            if not opens_any:
                return dataclasses.replace(st, now=stop_t)
            st = self._advance_lanes(st, nxt, stop_t, opens, ech, window)
            return dataclasses.replace(st, now=torch.where(opens, st.now,
                                                           stop_t))
        stop = int(stop)
        host0 = self.host0 if host0 is None else host0
        nxt = self._next_time(st)
        opens, epochs = self._opens(st, nxt, stop)
        if opens:
            return self._advance(st, nxt, stop, host0, epochs, window)
        return self._land(st, stop, host0)

    @torch.inference_mode()
    def run(self, st: EngineState, stop: int,
            host0: int | None = None) -> EngineState:
        """Run until no pending event is earlier than `stop`. `host0`
        defaults to this shard's. For lanes, `stop` is one stop or one
        per lane; the loop runs while any lane's window opens."""
        if self.lanes:
            stop_t, stop_np = self._lane_stop(stop)
            nxt = self._next_time(st)
            opens_any, opens, ech = self._opens_lanes(st, nxt, stop_t,
                                                      stop_np)
            while opens_any:
                st = self._advance_lanes(st, nxt, stop_t, opens, ech)
                nxt = self._next_time(st)
                opens_any, opens, ech = self._opens_lanes(st, nxt, stop_t,
                                                          stop_np)
            return dataclasses.replace(st, now=stop_t)
        stop = int(stop)
        host0 = self.host0 if host0 is None else host0
        nxt = self._next_time(st)
        opens, epochs = self._opens(st, nxt, stop)
        while opens:
            st = self._advance(st, nxt, stop, host0, epochs)
            nxt = self._next_time(st)
            opens, epochs = self._opens(st, nxt, stop)
        return self._land(st, stop, host0)
