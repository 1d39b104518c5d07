"""Simulation assembly: parsed config -> engine + device state + run loop.

The counterpart of `shadow_tpu.sim`. `build_simulation` loads the
topology, expands and attaches the hosts, registers their DNS names,
sizes their NICs, lets the app model bind its sockets and schedule its
process starts, and compiles everything into one chained-drain Engine
whose handler table is [stack pipeline | TCP timer and tx | app kinds].

Ported: `phold` over UDP, `tgen` and `tor` over TCP (NewReno, AIMD or
CUBIC, `tcp_cc`), `bitcoin` over both, several app models in one simulation
(`FusedModel`), a model's per-kind CPU charges, shape bucketing,
per-host bandwidth, `cpufrequency`, `interfacebuffer`,
`socketsendbuffer`, `socketrecvbuffer`, `bootstraptime`, process
`stoptime`, the three rx queue managers, both `fuse_rx` modes, both
qdiscs, the TCP knobs (`tcp_in_order`, `tcp_wnd_words`,
`tcp_child_slot_limit`), burst folding of TCP arrivals (`burst_rx`), the
frontier drain (`frontier`), every overflow mode (`overflow="spill"`
with `spill_len`, "grow", "strict", "drop") and fault schedules
(<fault>: crash, churn, bandwidth, loss, latency, partition;
`Simulation.faults`), the event trace ring (`trace`, records per host
between drains), the sim-time histograms (`stats`) and a wall-clock
phase profiler (`profiler`, an `obs.profiler.WindowProfiler`: `run` and
`step_window` time their "step" phase, `summary` gains a "profile"
key), packet capture (`logpcap`/`pcapdir`: a capture ring per host,
`Simulation.pcap_gids` and `pcap_dir`) and per-window widths
(`dispatch`/`step_window` with `window_ns`, one window per call).
`Simulation.dispatch` runs a segment with no overflow probe (the CLI's
run loop, `cli.py`, which re-templates a "grow" run itself).

Sharding (`mesh`, a `parallel.mesh.Mesh` made in a rank started by
`parallel.mesh.spawn`): the host count pads to a multiple of the shard
count, the whole build runs on every rank, and each rank keeps its block
of host rows, runs its shard (`run`, `step_window`, `dispatch`) and
meets the others in the engine's collectives; `Simulation.gather_state`
gives the global view on rank 0. `locality=True` reorders hosts so that
config-visible traffic partners share a shard (`parallel.partition`);
`host_order` forces a stored order (a checkpoint's). `spmd="constraint"`
(the reference's GSPMD-partitioned global engine) is not ported:
ROADMAP.md Queue 1 item 7b. Spill and grow modes are refused on a mesh
of more than one shard, as in the reference.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Any, Callable, Protocol

import numpy as np
import torch

from shadow_tpu_torch.config import HostInstance, ShadowConfig, expand_hosts
from shadow_tpu_torch.core.device import resolve_device
from shadow_tpu_torch.core.engine import (
    Emit,
    Engine,
    EngineConfig,
    _select_rows,
    _slice_rows,
    state_summary,
)
from shadow_tpu_torch.core.events import Events
from shadow_tpu_torch.core.timebase import MILLISECOND, SECOND, TIME_INVALID
from shadow_tpu_torch.faults import compile_faults
from shadow_tpu_torch.net.dns import DNS
from shadow_tpu_torch.net.topology import Topology, jax_index
from shadow_tpu_torch.runtime.pressure import (
    OVERFLOW_MODES,
    PressureController,
    QueuePressureError,
)
from shadow_tpu_torch.host.sockets import PROTO_TCP
from shadow_tpu_torch.transport import tcp as tcpm
from shadow_tpu_torch.transport.stack import (
    A_ACK,
    A_AUX,
    A_DPORT,
    A_LEN,
    A_META,
    A_SACK0,
    A_SACK1,
    A_SEQ,
    A_SPORT,
    A_WND,
    F_FIN,
    F_RST,
    F_SYN,
    KIND_PKT_ARRIVE,
    KIND_PKT_RX,
    N_PKT_ARGS,
    HostNet,
    SimHost,
    Stack,
)

DEFAULT_BANDWIDTH_KIB = 10240  # when neither host attr nor vertex attr set

# Virtual-CPU model: every executed event costs this many cycles on the
# host's configured CPU.
CPU_CYCLES_PER_EVENT = 10_000

@dataclasses.dataclass
class SimBuild:
    """Mutable build context handed to the app model.

    The app reads per-host process specs and arguments, resolves peer
    names through `dns`, binds sockets into `sockets` (and listeners into
    `tcb`), and appends process start events. `hosts` is the subset of
    hosts the current model owns (all of them with one model); per-host
    arrays are sized `n_hosts` (the bucketed host count) and indexed by
    `HostInstance.gid`.
    """

    cfg: ShadowConfig
    hosts: list[HostInstance]
    n_hosts: int
    sockets: Any  # SocketTable [H, S]
    device: torch.device
    dns: DNS
    n_sockets: int
    tcb: Any = None  # transport.tcp.TCB [H, S], with a TCP stack
    start_events: list[tuple[int, int, int, list[int]]] = dataclasses.field(
        default_factory=list
    )  # (time_ns, gid, kind_rel, args words)
    kind_offset: int = 0  # current model's kind base relative to the apps'

    def resolve_gid(self, name: str) -> int:
        addr = self.dns.resolve_name(name)
        if addr is None:
            raise ValueError(f"unknown hostname in config: {name!r}")
        return addr.host_id

    def add_start_event(self, gid: int, time_s: float, kind_rel: int,
                        args: list[int] | None = None) -> None:
        self.start_events.append(
            (int(time_s * SECOND), gid, self.kind_offset + kind_rel,
             list(args or [])))


class AppModel(Protocol):
    """An application as a handler table plus per-host state."""

    name: str
    needs_tcp: bool
    n_kinds: int

    def app_rows(self) -> int:
        """Emit rows the on_recv callback returns (for max_emit sizing)."""
        ...

    def handler_rows(self) -> int:
        """Max Emit rows any of the app's own kind handlers returns."""
        ...

    def build(self, b: SimBuild) -> tuple[Any, Callable, Callable | None]:
        """-> (app_state [H, ...], make_handlers(stack, kind_base) ->
        [handlers], on_recv or None)."""
        ...


@dataclasses.dataclass
class Simulation:
    """A built, runnable simulation on one device."""

    engine: Engine
    state0: Any  # EngineState
    stop_ns: int
    dns: DNS
    topo: Topology
    names: list[str]
    app: Any  # the AppModel instance
    stack: Stack
    kind_names: tuple = ()  # handler-kind names
    overflow: str = "drop"
    pressure: Any = None  # PressureController in spill mode
    faults: Any = None  # CompiledFaults when the config schedules any
    profiler: Any = None  # obs.profiler.WindowProfiler, timing "step"
    pcap_gids: tuple = ()  # hosts with logpcap set
    pcap_dir: str = "shadow.pcap.d"  # from the pcapdir host attr
    # queue overflow is loud by default: the reference's event heaps are
    # unbounded, so a counted drop would silently change the run
    strict_overflow: bool = True
    mesh: Any = None  # parallel.mesh.Mesh when sharded
    spmd: str = "auto"
    # the host permutation applied at build time (position i holds the
    # config host formerly gid host_order[i]): the locality layout, a
    # checkpoint's stored order, or None for config order
    host_order: tuple | None = None

    @property
    def spmd_path(self) -> str | None:
        """The sharding path: None unsharded, else `select_spmd(spmd)`
        ("shard_map" for "auto"). "shard_map" and "pmap" run the same
        per-rank program; the pmap path keeps the reference's refusals
        (a 2-D mesh, per-window widths)."""
        if self.mesh is None:
            return None
        from shadow_tpu_torch.parallel.mesh import select_spmd

        return select_spmd(self.spmd)

    def mesh_info(self) -> dict:
        """The checkpoint header's mesh identity: what a resume on
        another shard count needs to force this build's host layout."""
        return {
            "n_shards": self.mesh.size if self.mesh is not None else 1,
            "dcn_slices": (self.mesh.dcn_slices if self.mesh is not None
                           else 1),
            "host_order": (list(self.host_order)
                           if self.host_order is not None else None),
        }

    def gather_state(self, state=None):
        """The global view of `state` (state0 by default): numpy leaves
        keyed by field path in the reference's flatten order, as
        `convert.engine_state_to_numpy` gives them. Sharded, every rank
        must call it and rank 0 gets the view (None elsewhere)."""
        from shadow_tpu_torch import convert

        st = self.state0 if state is None else state
        if self.mesh is None:
            return convert.engine_state_to_numpy(st)
        from shadow_tpu_torch.parallel.mesh import gather_state

        return gather_state(st, self.mesh)

    def _global_sum(self, t: torch.Tensor) -> int:
        """A sum over every shard's hosts, on the host."""
        eng = self.engine
        return int(eng._gsum(t) if eng.comm is not None else t)

    def run(self, stop_ns: int | None = None, state=None):
        """Run to the stop time (the config's by default) from `state`
        (state0 by default); returns the final EngineState. The input
        state is not modified. Raises on queue overflow unless
        strict_overflow is False and overflow is "drop".

        In spill mode the run steps window by window, so that the
        pressure controller sees every boundary: one copy of (now, the
        ring's write cursor) per window, then the harvest and refill."""
        st = self.state0 if state is None else state
        stop = self.stop_ns if stop_ns is None else stop_ns
        if self.pressure is not None:
            eng = self.engine
            now = int(eng._fetch(st.now))
            while now < stop:
                st = self.step_window(st, stop)
                got = eng._fetch(torch.cat([
                    st.now[None], st.queues.spill.wr.to(torch.int64)]))
                now = int(got[0])
                st = self.pressure.boundary(st, wr=got[1:], read=eng._read)
            return st
        with self._phase():
            out = self.engine.run(st, stop)
        if self.overflow == "strict" or self.strict_overflow:
            drops = self._global_sum(out.queues.drops.sum())
            if drops > 0:
                self.check_drops(drops, self.summary(out))
        return out

    def check_drops(self, drops: int, summary: dict | None = None):
        """Apply the loud-overflow contract to a fetched drop count."""
        if int(drops) <= 0:
            return
        if self.overflow == "strict":
            raise QueuePressureError(
                int(drops), self.engine.cfg.capacity, summary or {})
        if self.strict_overflow:
            raise RuntimeError(
                f"event queue overflow: {int(drops)} events dropped "
                f"(per-host capacity {self.engine.cfg.capacity}); rerun "
                "with a larger --capacity, or set strict_overflow=False "
                "to accept counted drops"
            )

    def dispatch(self, stop_ns: int, state, window_ns: int | None = None):
        """Run from `state` to `stop_ns` with no overflow probe: the CLI
        reads the drop count from its heartbeat harvest instead. Pressure
        modes need `run`'s window-boundary refills and are refused.
        With `window_ns` (`--window`) it runs exactly one window of that
        width, the adaptive controller choosing the next between calls;
        None runs to the stop at the lookahead's width."""
        if self.pressure is not None:
            raise ValueError(
                "dispatch() cannot run spill/grow pressure modes; their "
                "reservoir refills are host-side window-boundary work — "
                "use run()")
        if window_ns is not None:
            self._check_window()
            return self.engine.step_window(state, stop_ns,
                                           window=int(window_ns))
        with self._phase():
            return self.engine.run(state, stop_ns)

    def step_window(self, state, stop_ns: int | None = None,
                    window_ns: int | None = None):
        """Advance one window from `state`. `window_ns` widens (or
        narrows) it past the lookahead: cross-host arrivals clamp up to
        the window's end, so the run stays causal but coarsens packet
        timing by up to the width; None keeps the lookahead."""
        st = self.state0 if state is None else state
        if window_ns is not None:
            self._check_window()
        with self._phase():
            return self.engine.step_window(
                st, self.stop_ns if stop_ns is None else stop_ns,
                window=None if window_ns is None else int(window_ns))

    def _check_window(self):
        """Per-window widths are refused on the pmap path, as the
        reference refuses them there."""
        if self.spmd_path == "pmap":
            raise ValueError(
                "adaptive windows (--window auto) need the shard_map or "
                "constraint SPMD path; the pmap fallback runs fixed "
                "windows only (selected spmd='pmap')")

    @contextlib.contextmanager
    def _phase(self):
        """The profiler's "step" phase around one engine call, ended when
        the device has finished its work; nothing without a profiler."""
        if self.profiler is None:
            yield
            return
        with self.profiler.phase("step"):
            yield
            if self.engine.device.type == "cuda":
                torch.cuda.synchronize(self.engine.device)

    def summary(self, state) -> dict:
        """Host-side progress snapshot (frontier time, window count,
        executed events, sweeps, queue drops; the reservoir's counters
        in spill mode; the profiler's wall-clock aggregates under
        "profile" when one is attached)."""
        out = state_summary(state)
        if self.engine.comm is not None:
            # the summed counters over every shard (the rest replicate)
            for key, t in (("executed", state.stats.n_executed.sum()),
                           ("queue_drops", state.queues.drops.sum())):
                out[key] = self._global_sum(t)
        if self.profiler is not None:
            out["profile"] = self.profiler.summary()
        if self.pressure is not None:
            snap = self.pressure.snapshot(state)
            out["refilled"] = snap["refilled"]
            out["reservoir"] = snap["resident"]
            out["overdue"] = snap["overdue"]
        return out

    def build_fleet(self, lanes: int, **overrides):
        """Batch `lanes` scenario variants of this simulation into one
        Fleet: see the module-level `build_fleet`."""
        return build_fleet(self, lanes, **overrides)

    def metrics_refs(self, state) -> dict:
        """Device refs of the live-telemetry extras (net drops, fault
        drops, cross-shard traffic, socket byte totals) that the heartbeat
        harvest carries under `--metrics`; the CLI reads them once more
        after a "grow" re-template."""
        from shadow_tpu_torch.obs.metrics import metrics_device_refs

        return metrics_device_refs(state)


def _plugin_tokens(cfg: ShadowConfig, plugin_id: str) -> set[str]:
    """Registry-matchable name tokens for a plugin: its id plus its path
    basename, split on separators, so 'shadow-plugin-test-phold' matches
    'phold' and 'tor' does not match inside 'monitor'."""
    spec = cfg.plugin_by_id(plugin_id)
    names = [plugin_id] + ([spec.path.rsplit("/", 1)[-1]] if spec else [])
    toks: set[str] = set()
    for n in names:
        toks.update(t for t in re.split(r"[^a-z0-9]+", n.lower()) if t)
    return toks


def resolve_app_models(
    cfg: ShadowConfig, registry: dict[str, Callable], hosts: list[HostInstance]
):
    """Map every host's processes to registered app models.

    Returns [(name, model_instance, owned_host_list)] in first-appearance
    order. A host whose processes span two models is rejected.
    """
    owner: dict[int, str] = {}
    order: list[str] = []
    for h in hosts:
        for p in h.spec.processes:
            toks = _plugin_tokens(cfg, p.plugin)
            for regname in registry:
                if regname in toks:
                    break
            else:
                raise ValueError(
                    f"no app model registered for plugin {p.plugin!r} "
                    f"(known: {sorted(registry)})"
                )
            if owner.setdefault(h.gid, regname) != regname:
                raise ValueError(
                    f"host {h.name!r} mixes app models "
                    f"{owner[h.gid]!r} and {regname!r}"
                )
            if regname not in order:
                order.append(regname)
    return [
        (name, registry[name](),
         [h for h in hosts if owner.get(h.gid) == name])
        for name in order
    ]


@dataclasses.dataclass(frozen=True)
class MultiApp:
    """Fused app state: every sub-model's [H]-leading state side by side,
    and the per-host owning model's index for receive dispatch."""

    model_id: torch.Tensor  # i32[H]
    subs: tuple


class FusedModel:
    """Several app models in one handler table.

    Kinds lay out as [stack | model0 kinds | model1 kinds | ...]; each
    sub-model's handlers run on its own state slice (the rest of the
    MultiApp rides along), and packet deliveries go to the receiving
    host's owning model. Where the reference switches per host on
    `model_id`, every sub-model's receive runs over all [H] rows and
    each row keeps the result of its own model, every leaf of the host
    state included, so a model leaves no trace on rows it does not own.
    """

    def __init__(self, parts):  # [(name, model, owned_hosts)]
        self.parts = parts
        self.name = "+".join(name for name, _, _ in parts)
        self.needs_tcp = any(m.needs_tcp for _, m, _ in parts)
        self.n_kinds = sum(m.n_kinds for _, m, _ in parts)

    def app_rows(self) -> int:
        return max(m.app_rows() for _, m, _ in self.parts)

    def handler_rows(self) -> int:
        return max(m.handler_rows() for _, m, _ in self.parts)

    def cpu_kind_cycles(self, n_kinds: int):
        """The sum of the parts' per-(host, kind) cycle tables: each is
        zero on rows its model does not own, so the sum composes them."""
        total = None
        for _, m, _ in self.parts:
            cy = (m.cpu_kind_cycles(n_kinds)
                  if hasattr(m, "cpu_kind_cycles") else None)
            if cy is not None:
                total = cy if total is None else total + cy
        return total

    def build(self, b: SimBuild):
        model_id = np.zeros((b.n_hosts,), np.int32)
        subs, makers, recvs = [], [], []
        offset = 0
        all_hosts = b.hosts
        for i, (_name, model, owned) in enumerate(self.parts):
            for h in owned:
                model_id[h.gid] = i
            b.hosts, b.kind_offset = owned, offset
            state_i, make_i, recv_i = model.build(b)
            subs.append(state_i)
            makers.append(make_i)
            recvs.append(recv_i)
            offset += model.n_kinds
        b.hosts, b.kind_offset = all_hosts, 0
        self._makers, self._recvs = makers, recvs
        state = MultiApp(model_id=torch.from_numpy(model_id).to(b.device),
                         subs=tuple(subs))
        return state, self._make_handlers, self._on_recv

    @staticmethod
    def _sub_call(hs, i, fn, *args):
        """Run a sub-model callable on its own app-state slice."""
        hs2, em = fn(dataclasses.replace(hs, app=hs.app.subs[i]), *args)
        subs = tuple(hs2.app if j == i else sub
                     for j, sub in enumerate(hs.app.subs))
        return dataclasses.replace(
            hs2, app=MultiApp(model_id=hs.app.model_id, subs=subs)), em

    def _make_handlers(self, stack, kind_base):
        rows = self.handler_rows()
        handlers = []
        offset = kind_base
        for i, ((_name, model, _), make) in enumerate(
                zip(self.parts, self._makers)):
            for fn in make(stack, offset):
                def wrapped(hs, ev, key, _i=i, _fn=fn):
                    hs2, em = self._sub_call(hs, _i, _fn, ev, key)
                    return hs2, em.pad_to(rows)
                handlers.append(wrapped)
            offset += model.n_kinds
        return handlers

    def _on_recv(self, hs, slot, pkt, now, key):
        rows = self.app_rows()
        idx = torch.clamp(hs.app.model_id, 0, len(self._recvs) - 1)
        hs_out = em_out = None
        for i, recv in enumerate(self._recvs):
            if recv is None:
                hs_i, em_i = hs, Emit.none(now.shape[0], rows, N_PKT_ARGS,
                                           device=now.device)
            else:
                hs_i, em_i = self._sub_call(hs, i, recv, slot, pkt, now, key)
                em_i = em_i.pad_to(rows)
            if hs_out is None:
                hs_out, em_out = hs_i, em_i
            else:
                sel = idx == i
                hs_out = _select_rows(sel, hs_i, hs_out)
                em_out = _select_rows(sel, em_i, em_out)
        return hs_out, em_out


def build_fleet(sim: Simulation, lanes: int, **overrides):
    """Batch `lanes` variants of a built scenario into one Fleet.

    Per-lane knobs (`seeds`, `faults`, `latency_scale`,
    `bandwidth_scale`, `state_override`: see runtime.fleet.FleetPlan)
    become per-lane inputs of ONE engine over every lane's rows; static
    knobs (drain, frontier, window, capacity, ...) must stay uniform
    and are refused with the reason. `HeartbeatHarvest` drives the fleet
    through the same single-read path as a solo run.
    """
    from shadow_tpu_torch.runtime.fleet import build_fleet_from_engine

    if sim.mesh is not None:
        raise ValueError(
            "fleets vmap the single-device engine; a sharded base "
            "scenario is not supported — shard across fleet replicas "
            "instead (one fleet per device group)"
        )
    if sim.pressure is not None:
        raise ValueError(
            "fleets cannot run spill/grow pressure modes; their "
            "reservoir refills are host-side per-window work that "
            "cannot ride one fused vmapped program — use --overflow "
            "drop/strict for fleet runs"
        )
    fleet = build_fleet_from_engine(
        sim.engine, sim.state0, lanes, names=sim.names,
        stop_ns=sim.stop_ns, **overrides,
    )
    fleet.strict_overflow = sim.strict_overflow or sim.overflow == "strict"
    return fleet


def default_registry() -> dict[str, Callable]:
    """The app models by plugin name."""
    from shadow_tpu_torch.models.bitcoin import BitcoinModel
    from shadow_tpu_torch.models.phold_net import PholdNetModel
    from shadow_tpu_torch.models.tgen import TGenModel
    from shadow_tpu_torch.models.tor import TorModel

    return {
        "tgen": TGenModel,
        "phold": PholdNetModel,
        "tor": TorModel,
        "bitcoin": BitcoinModel,
    }


def _check_mesh_knobs(*, mesh, spmd, overflow):
    if overflow not in OVERFLOW_MODES:
        raise ValueError(
            f"overflow must be one of {OVERFLOW_MODES}, got {overflow!r}")
    from shadow_tpu_torch.parallel.mesh import select_spmd

    path = select_spmd(spmd)
    if path == "constraint":
        raise NotImplementedError(
            "spmd='constraint' (a global engine partitioned by the "
            "compiler) is not ported (ROADMAP.md Queue 1 item 7b); "
            "spmd='auto' runs one rank per shard")
    if path == "pmap" and mesh is not None and len(mesh.axis_names) == 2:
        raise NotImplementedError(
            "the pmap fallback is single-axis only: a multi-slice "
            "(dcn x hosts) mesh must run through the SPMD paths — build "
            "with spmd='auto' or spmd='shard_map' instead of spmd='pmap'")
    if overflow in ("spill", "grow") and mesh is not None and mesh.size > 1:
        # the reservoir's window-boundary harvest would need a cross-
        # shard protocol the controller does not speak
        raise ValueError(
            f"--overflow {overflow} is not supported on sharded meshes "
            "yet; use strict or drop (or run unsharded)")


def _bucket(n_hosts: int) -> int:
    """Pad the host count up the ladder 16, 32, ..., 1024, 2048, 3072,
    ...: nearby sizes share one shape, padded rows stay inert."""
    b = 16
    while b < n_hosts:
        b = b * 2 if b < 1024 else b + 1024
    return max(b, n_hosts)


def build_simulation(
    cfg: ShadowConfig,
    registry: dict[str, Callable] | None = None,
    *,
    seed: int = 0,
    n_sockets: int = 8,
    capacity: int | None = None,
    mesh: Any = None,
    tcp_cc: str = "reno",
    tcp_in_order: bool = True,
    tcp_wnd_words: int | None = None,
    rx_queue: str = "codel",
    qdisc: str = "fifo",
    interface_buffer: int = 1_024_000,
    tcp_child_slot_limit: int | None = None,
    locality: bool = False,
    runahead_ns: int | None = None,
    frontier: int = 0,
    fuse_rx: bool = True,
    burst_rx: bool = True,
    shape_bucket: bool = True,
    trace: int = 0,
    stats: int = 0,
    profiler: Any = None,
    overflow: str = "drop",
    spill_len: int = 0,
    host_order: Any = None,
    spmd: str = "auto",
    device=None,
    app_model: Any = None,
) -> Simulation:
    """Config -> Simulation on `device` (None: CUDA, which must exist;
    pass "cpu" to run on the CPU).

    The keywords are the reference's. `app_model` replaces the models
    the config's plugins resolve to (the process tier's
    `ProcTierModel`); a model with `owns_process_lifecycle` stops its
    processes itself, so hosts get no per-host stop and may give their
    processes differing stoptimes. `mesh` (a
    `parallel.mesh.Mesh`) shards the hosts: the Simulation then runs
    this rank's shard on the mesh's device. `locality=True` (a mesh of
    more than one shard) reorders hosts so config-visible traffic
    partners share a shard; gids and `names` follow that layout.
    `host_order` forces a stored permutation (a checkpoint's), on any
    mesh. `spmd` is the reference's execution path: "auto", "shard_map"
    and "pmap" run the one per-rank program, "constraint" is refused.

    `overflow="spill"` gives every queue an overflow ring of `spill_len`
    slots (4 x capacity by default) and a PressureController, and `run`
    then steps window by window; `overflow="grow"` does the same with a
    controller in grow mode, whose `grow_wanted` asks the CLI to
    rebuild at doubled capacity. `frontier=N` selects the frontier drain
    (runs of up to N positions per round), bit-identical to the chained
    drain; it requires a TCP stack with fuse_rx=True and a model that
    declares `frontier_safe` (every local emit at dt >= 1).
    """
    _check_mesh_knobs(mesh=mesh, spmd=spmd, overflow=overflow)
    if qdisc not in ("fifo", "rr"):
        raise ValueError(f"unknown qdisc {qdisc!r}")
    if mesh is not None:
        if device is not None and torch.device(device).type != \
                mesh.device.type:
            raise ValueError(f"device {device!r} differs from the mesh's "
                             f"{mesh.device}")
        dev = mesh.device
    else:
        dev = resolve_device(device)
    if registry is None:
        registry = default_registry()
    topo = Topology.from_graphml(cfg.topology_source())
    hosts = expand_hosts(cfg)
    n_shards = mesh.size if mesh is not None else 1
    applied_order: tuple | None = None
    if host_order is not None:
        from shadow_tpu_torch.parallel.partition import apply_order

        perm = [int(g) for g in host_order]
        if sorted(perm) != list(range(len(hosts))):
            raise ValueError(
                f"host_order must be a permutation of range({len(hosts)}) "
                "— was the checkpoint written from the same config?")
        hosts = apply_order(hosts, perm)
        applied_order = tuple(perm)
    elif locality and n_shards <= 1:
        # an option that would silently change nothing fails instead
        raise ValueError("locality=True requires a multi-device mesh")
    elif locality:
        from shadow_tpu_torch.parallel.partition import (
            apply_order,
            locality_order,
            traffic_edges_from_config,
        )

        perm = locality_order(len(hosts), traffic_edges_from_config(hosts),
                              n_shards, dcn_slices=mesh.dcn_slices)
        hosts = apply_order(hosts, perm)
        applied_order = tuple(perm)
    n_hosts = len(hosts)
    if shape_bucket:
        # the ladder, then up to a multiple of the shard count
        n_hosts = _bucket(n_hosts)
        if n_hosts % n_shards:
            n_hosts = (n_hosts // n_shards + 1) * n_shards
    elif n_hosts % n_shards:
        raise ValueError(
            f"{len(hosts)} hosts not divisible by mesh size {n_shards} "
            "(enable shape_bucket to auto-pad)")
    per_shard = n_hosts // n_shards

    # -- attachment + DNS
    dns = DNS()
    host_vertex = []
    for h in hosts:
        s = h.spec
        v = topo.attach(
            ip_hint=s.iphint, citycode_hint=s.citycodehint,
            countrycode_hint=s.countrycodehint, geocode_hint=s.geocodehint,
            type_hint=s.typehint,
        )
        host_vertex.append(v)
        dns.register(h.gid, h.name, s.iphint or None)
    # bucket-padded rows attach to vertex 0; they originate no traffic
    host_vertex += [0] * (n_hosts - len(hosts))

    # -- NIC sizing: a host attr overrides the vertex attr; defaults also
    # give bucket-padded rows NICs that never run
    bw_up = np.full((n_hosts,), float(DEFAULT_BANDWIDTH_KIB), np.float64)
    bw_down = np.full((n_hosts,), float(DEFAULT_BANDWIDTH_KIB), np.float64)
    cpu_cost = np.zeros((n_hosts,), np.int64)
    cpu_khz = np.zeros((n_hosts,), np.int64)  # for per-kind model charges
    rcv_wnd_bytes = np.zeros((n_hosts,), np.int64)
    snd_buf_bytes = np.zeros((n_hosts,), np.int64)  # 0 = unlimited
    # NIC receive buffer bound (interfacebuffer; the reference's default
    # is 1024000 bytes)
    rx_buf = np.full((n_hosts,), interface_buffer, np.int64)
    pcap_mask = np.zeros((n_hosts,), bool)
    pcap_dirs: set[str] = set()
    proc_stop = np.full((n_hosts,), np.iinfo(np.int64).max, np.int64)
    for h, v in zip(hosts, host_vertex):
        vx = topo.vertices[v]
        s = h.spec
        bw_up[h.gid] = (s.bandwidthup or vx.bandwidth_up_kib
                        or DEFAULT_BANDWIDTH_KIB)
        bw_down[h.gid] = (s.bandwidthdown or vx.bandwidth_down_kib
                          or DEFAULT_BANDWIDTH_KIB)
        if s.cpufrequency:
            cpu_cost[h.gid] = CPU_CYCLES_PER_EVENT * 1_000_000 // s.cpufrequency
            cpu_khz[h.gid] = s.cpufrequency
        if s.socketrecvbuffer:
            rcv_wnd_bytes[h.gid] = s.socketrecvbuffer
        if s.socketsendbuffer:
            # bytes beyond the cap wait in the TCB's app_pending and
            # drain on ACK progress
            snd_buf_bytes[h.gid] = s.socketsendbuffer
        if s.interfacebuffer:
            rx_buf[h.gid] = s.interfacebuffer
        if s.logpcap or s.pcapdir:
            pcap_mask[h.gid] = True
            if s.pcapdir:
                pcap_dirs.add(s.pcapdir)
        stops = {p.stoptime for p in s.processes if p.stoptime}
        if stops and not getattr(app_model, "owns_process_lifecycle",
                                 False):
            if len(s.processes) > 1 and (
                len(stops) > 1 or len(stops) < len(s.processes)
            ):
                # one state row per host: a partial stop would silently
                # stop the host's other processes too
                raise ValueError(
                    f"host {h.name!r}: all processes on a host must share "
                    "one stoptime (per-process stop needs the real-binary "
                    "tier, whose processes are individual green threads)"
                )
            proc_stop[h.gid] = int(stops.pop() * SECOND)

    if app_model is not None:
        model = app_model
    else:
        parts = resolve_app_models(cfg, registry, hosts)
        model = parts[0][1] if len(parts) == 1 else FusedModel(parts)
    if snd_buf_bytes.any() and not model.needs_tcp:
        # without a TCP stack there is no send buffer for the cap to bound
        # (socketrecvbuffer sizes TCP's receive window; ignored without)
        raise ValueError(
            "socketsendbuffer is set but the app model "
            f"{model.name!r} runs no TCP stack; remove the attribute")
    if capacity is None:
        # a TCP host must queue a full receive window (64 * WND_WORDS
        # segments) twice over, plus timers and app events
        capacity = 64 * tcpm.WND_WORDS * 2 + 64 if model.needs_tcp else 256
    net = HostNet.create(
        n_hosts, n_sockets, bw_up, bw_down, with_tcp=model.needs_tcp,
        rcv_wnd_bytes=rcv_wnd_bytes if rcv_wnd_bytes.any() else None,
        wnd_words=tcp_wnd_words, rx_buf_bytes=rx_buf,
        snd_buf_bytes=snd_buf_bytes if snd_buf_bytes.any() else None,
        device=dev)
    if pcap_mask.any():
        from shadow_tpu_torch.utils.pcap import CaptureRing

        net = dataclasses.replace(
            net, cap=CaptureRing.create(pcap_mask, device=dev))

    b = SimBuild(cfg=cfg, hosts=hosts, n_hosts=n_hosts,
                 sockets=net.sockets, device=dev, dns=dns,
                 n_sockets=n_sockets, tcb=net.tcb)
    app_state, make_handlers, on_recv = model.build(b)
    net = dataclasses.replace(net, sockets=b.sockets, tcb=b.tcb)

    # config-driven runs get strict byte-stream delivery order; qdisc
    # "rr" sends one segment per tx kick, so contending connections
    # alternate through the NIC's virtual clock
    tcp = None
    if model.needs_tcp:
        tcp_kw = dict(tx_burst=1, inline_budget=1) if qdisc == "rr" else {}
        # a restarted host has lost all connection state, so survivors'
        # segments to it must draw an RST rather than blackhole until
        # the RTO gives up
        if any(f.type in ("crash", "churn") for f in cfg.faults):
            tcp_kw["rst_on_unmatched"] = True
        tcp = tcpm.TCP(auto_close=False, cc=tcp_cc, in_order=tcp_in_order,
                       child_slot_limit=tcp_child_slot_limit, **tcp_kw)
    # fuse_rx folds each packet's ARRIVE -> RX event pair into one
    stack = Stack(bootstrap_end=int(cfg.bootstraptime * SECOND), tcp=tcp,
                  rx_queue=rx_queue, fuse_rx=fuse_rx)

    if on_recv is None:
        def on_recv(hs, slot, pkt, now, key):  # noqa: F811
            return hs, Emit.none(now.shape[0], 1, N_PKT_ARGS,
                                 device=now.device)

    # <process stoptime>: a stopped process's callbacks never run again;
    # the stack's handlers go on
    if (proc_stop < np.iinfo(np.int64).max).any():
        make_handlers, on_recv = _mute_stopped(
            model, app_state, make_handlers, on_recv,
            torch.from_numpy(proc_stop).to(dev))

    base_handlers = stack.make_handlers(on_recv)
    kind_base = len(base_handlers)
    handlers = base_handlers + make_handlers(stack, kind_base)
    kind_names = ["pkt_arrive", "pkt_rx"]
    if tcp is not None:
        kind_names += ["tcp_timer", "tcp_tx"]
    for name, sub, _ in (model.parts if isinstance(model, FusedModel)
                         else [(model.name, model, None)]):
        kind_names += [f"{name}.{i}" for i in range(sub.n_kinds)]
    if len(kind_names) != len(handlers):
        raise AssertionError(
            f"kind label table ({len(kind_names)}) out of sync with the "
            f"handler table ({len(handlers)})"
        )
    need = (tcp.min_max_emit(model.app_rows()) if tcp is not None
            else model.app_rows() + 1)
    max_emit = max(need, model.handler_rows())

    # conservative window width: the topology's minimum path latency,
    # unless the user widens it (cross-host arrivals clamp up to the
    # window barrier, so any width is causally safe)
    if runahead_ns is not None:
        if runahead_ns < 1:
            raise ValueError(f"runahead must be >= 1 ns, got {runahead_ns}")
        lookahead = runahead_ns
    else:
        lookahead = max(int(topo.min_latency_ms * MILLISECOND), 1)
    # burst delivery: contiguous same-flow TCP arrivals staged in one
    # sweep fold into multi-segment events (the delivery runs inside the
    # fused arrival)
    burst = None
    if burst_rx and fuse_rx and tcp is not None and pcap_mask.any():
        # a folded run would be one captured record where the reference
        # writes one per segment: capture fidelity wins over drain depth
        import warnings

        warnings.warn(
            "burst_rx disabled: pcap capture is enabled and burst "
            "folding would merge captured segments (pass burst_rx=False "
            "to silence)",
            stacklevel=2,
        )
        burst_rx = False
    if burst_rx and fuse_rx and tcp is not None:
        burst = (KIND_PKT_ARRIVE, A_SEQ, A_LEN, A_SPORT, A_DPORT, A_META,
                 PROTO_TCP, F_SYN | F_FIN | F_RST, tcpm.MSS,
                 (A_ACK, A_WND, A_AUX, A_SACK0, A_SACK1))
    # spill ring: 4 x capacity record slots by default; an undersized
    # ring reports its overflow in n_lost
    spill = 0
    if overflow in ("spill", "grow"):
        spill = int(spill_len) if spill_len > 0 else 4 * capacity
    # the frontier drain's run rule is exact only when every local emit
    # lands at dt >= 1: the unfused ARRIVE -> RX re-emit can land at dt 0,
    # and a model must declare its own delays safe
    frontier_kinds = None
    if frontier:
        if tcp is None or not fuse_rx:
            raise ValueError(
                "frontier batching requires the TCP stack with "
                "fuse_rx=True (the unfused ARRIVE->RX re-emit can land "
                "at dt=0, breaking the run rule's dt >= 1 invariant)")
        if not getattr(model, "frontier_safe", False):
            raise ValueError(
                f"model {model.name!r} does not declare frontier_safe "
                "(its local emit delays are not provably >= 1 ns for "
                "this config); run with frontier=0")
        frontier_kinds = stack.frontier_kinds() + tuple(
            kind_base + int(i) for i in model.frontier_kinds())
    ecfg = EngineConfig(
        n_hosts=per_shard, capacity=capacity, lookahead=lookahead,
        max_emit=max_emit, n_args=N_PKT_ARGS, seed=seed, burst=burst,
        axis_name=(None if mesh is None else
                   (mesh.axis_names[0] if len(mesh.axis_names) == 1
                    else tuple(mesh.axis_names))),
        n_shards=n_shards,
        spill=spill, frontier=int(frontier), trace=int(trace),
        trace_len_arg=A_LEN, stats=int(stats),
    )
    network = topo.build_network(host_vertex, device=dev)
    cost_arg = cpu_cost
    if fuse_rx and cpu_cost.any():
        # the fused KIND_PKT_ARRIVE event runs the delivery too, so it
        # pays both halves of the per-event charge, as the unfused
        # two-event pipeline would
        cost_arg = np.broadcast_to(
            cpu_cost[:, None], (n_hosts, len(handlers))
        ).copy()
        cost_arg[:, KIND_PKT_ARRIVE] += cpu_cost
    # per-kind charges: a model may declare cycles for some event kinds
    # (Tor's relay crypto per delivered segment); on hosts with a
    # cpufrequency they become virtual-CPU ns on top of the per-event cost
    if hasattr(model, "cpu_kind_cycles"):
        cycles = model.cpu_kind_cycles(len(handlers))
        if cycles is not None and cpu_khz.any():
            if fuse_rx:
                # deliveries run inside KIND_PKT_ARRIVE when fused, so a
                # per-delivery charge moves onto the kind that runs
                cycles = np.array(cycles, copy=True)
                cycles[:, KIND_PKT_ARRIVE] += cycles[:, KIND_PKT_RX]
                cycles[:, KIND_PKT_RX] = 0
            extra_ns = np.where(
                cpu_khz[:, None] > 0,
                cycles * 1_000_000 // np.maximum(cpu_khz[:, None], 1), 0)
            base = cost_arg if cost_arg.ndim == 2 else cpu_cost[:, None]
            cost_arg = base + extra_ns
    hosts_state = SimHost(net=net, app=app_state)
    faults = None
    if cfg.faults:
        name_by_gid = [""] * n_hosts
        for h in hosts:
            name_by_gid[h.gid] = h.name
        faults = compile_faults(cfg.faults, name_by_gid, n_hosts, seed,
                                device=dev)
    eng = Engine(
        ecfg, handlers, network,
        cpu_cost=torch.from_numpy(cost_arg) if cost_arg.any() else None,
        faults=faults,
        # the initial hosts state doubles as the restart template: a
        # crashed-and-restarted host comes back with boot-fresh state
        fault_reset=hosts_state if faults is not None else None,
        frontier_kinds=frontier_kinds, device=dev,
        comm=mesh.comm if mesh is not None else None,
    )

    # -- initial events: process starts at their starttime, with a
    # per-source sequence number
    evs = b.start_events
    m = max(len(evs), 1)
    times = np.full((m,), TIME_INVALID, np.int64)
    dsts = np.zeros((m,), np.int32)
    seqs = np.zeros((m,), np.int32)
    kinds = np.zeros((m,), np.int32)
    argw = np.zeros((m, N_PKT_ARGS), np.int32)
    per_src_seq: dict[int, int] = {}
    for i, (t_ns, gid, kind_rel, args) in enumerate(evs):
        times[i] = t_ns
        dsts[i] = gid
        seqs[i] = per_src_seq.get(gid, 0)
        per_src_seq[gid] = seqs[i] + 1
        kinds[i] = kind_base + kind_rel
        argw[i, :len(args)] = args
    on = lambda a: torch.from_numpy(a).to(dev)
    init = Events(time=on(times), dst=on(dsts), src=on(dsts), seq=on(seqs),
                  kind=on(kinds), args=on(argw))
    if mesh is not None:
        # this rank's rows of the global build; initial events for other
        # shards are ignored by the push
        st0 = eng.init_state(
            _slice_rows(hosts_state, eng.host0, per_shard, clone=True),
            init)
    else:
        st0 = eng.init_state(hosts_state, init)
    if len(pcap_dirs) > 1:
        raise ValueError(
            f"hosts disagree on pcapdir ({sorted(pcap_dirs)}); captures "
            "share one directory per run"
        )
    return Simulation(
        engine=eng, state0=st0, stop_ns=int(cfg.stoptime * SECOND),
        dns=dns, topo=topo, names=[h.name for h in hosts], app=model,
        stack=stack, kind_names=tuple(kind_names), overflow=overflow,
        pressure=(PressureController(n_hosts, capacity, lookahead,
                                     n_args=N_PKT_ARGS, mode=overflow)
                  if overflow in ("spill", "grow") else None),
        faults=faults, profiler=profiler,
        pcap_gids=tuple(int(g) for g in np.nonzero(pcap_mask)[0]),
        pcap_dir=(pcap_dirs.pop() if pcap_dirs else "shadow.pcap.d"),
        mesh=mesh, spmd=spmd, host_order=applied_order,
    )


def _mute_stopped(model, app_state, make_handlers, on_recv,
                  stop_at: torch.Tensor):
    """Wrap the app's handlers and receive callback so that a host whose
    process stoptime has passed keeps its state and emits nothing. The
    receive callback finds the row's host id in the app state's `gid`,
    or in the first sub-state of a MultiApp that has one."""
    def lane_gid(app):
        for sub in (app, *getattr(app, "subs", ())):
            if hasattr(sub, "gid"):
                return sub.gid
        return None

    if lane_gid(app_state) is None:
        raise ValueError(
            "process stoptime needs the app state to carry a gid field "
            f"(model {model.name!r} has none)")
    n = stop_at.shape[0]

    def dead_select(hs, hs2, em, dead):
        return (_select_rows(dead, hs, hs2),
                dataclasses.replace(em, mask=em.mask & ~dead[:, None]))

    def mute_handler(fn):
        def wrapped(hs, ev, key):
            hs2, em = fn(hs, ev, key)
            dead = ev.time >= stop_at[jax_index(ev.dst, n)]
            return dead_select(hs, hs2, em, dead)

        return wrapped

    def mute_recv(hs, slot, pkt, now, key):
        hs2, em = on_recv(hs, slot, pkt, now, key)
        dead = now >= stop_at[jax_index(lane_gid(hs.app), n)]
        return dead_select(hs, hs2, em, dead)

    def make_muted(stack, kind_base):
        return [mute_handler(fn) for fn in make_handlers(stack, kind_base)]

    return make_muted, mute_recv
