"""SimService: the resident multi-tenant scenario executor, the
counterpart of `shadow_tpu.serve.service`: the same request and result
records, class strings, metrics, snapshots and ledger, with a fleet of
this package (`runtime.fleet.Fleet`, one engine over the lanes) on an
explicit `device` in place of the reference's compiled, vmapped one.

The serving dataflow, request to result:

    submit(doc)          parse + validate; compute the ClassKey; queue
      |                  on the LanePacker; notify the launch worker
    _worker_loop         wait until a class is full or its oldest
      |                  request ages past --pack-deadline-ms
    _run_batch(key,reqs) supervised launch: retry with backoff from the
      |                  newest beat snapshot; after --launch-retries
      |                  failures bisect the batch to isolate poison
    _launch(key, reqs)   ProgramCache.get -> warm Fleet (built at
      |                  --max-lanes, per-lane stops, pinned fault pad)
      |                  make_inputs(plan): live lanes = requests,
      |                  pad lanes = inert (zero events, counters 0)
      |                  beat loop: N x step_window, then ONE harvest
      |                  extract/fetch -> per-lane progress streamed
      |                  into the result records; every --snapshot-beats
      |                  harvests the [L,...] state tree + batch
      |                  manifest persist through utils.checkpoint (v7)
    result(rid)          summary bit-identical to the solo run

Bit-identity rests on the fleet tier's per-lane guarantees plus two
serving-specific facts, both pinned in tests/test_serve.py:

- per-lane stops: each lane's LAST window truncates at ITS OWN stop
  (`Fleet(per_lane_stop=True)` takes one stop per lane), so packing mixed stop
  times never changes any lane's window sequence vs its solo run;
- the stepped drive is the fused drive: `step_window` partitions time
  at exactly the windows `run`'s window loop takes, and a finished
  lane's step is the idempotent done-branch (flush exchange, clamp
  `now` to stop, NO counter increments) — so after the final
  confirming step the lane state equals the fused run's output.

Resuming from a snapshot preserves it too: a snapshot is taken at a
beat boundary (a window boundary by construction), so re-entering the
beat loop at `beats_done` replays exactly the windows the failed
attempt had not completed — the window sequence is identical, just
split across two processes.

The launch worker is a `threading.Thread`. `Engine.run` and
`Engine.step_window` enter `torch.inference_mode` themselves (it is
thread-local), and the worker runs each batch under it as well; on CUDA
the kernels' first-use build may happen on the worker. HTTP handler
threads only read records under the condition variable, so they stay
light beside a dispatch-bound beat loop that shares their GIL.

Failure-domain isolation (docs/17-Serving.md "Failure semantics"):
an exception or watchdog-stalled launch retries with exponential
backoff from the newest snapshot; once retries are exhausted a
multi-request batch is BISECTED — halves relaunched as fresh batches —
so one poison request ends as a single error record while every rider
completes. Requests carry an optional wall `deadline_ms`: lanes past
deadline are masked out of the progress predicate and returned as
`status: "timeout"` with their last harvested partial summary.
Repeated terminal failures flip `/healthz` to degraded and `/submit`
to 503 (the queue persists as in a drain).

Drain (SIGTERM): the worker finishes the launch in flight, stops
pulling; pending requests persist to --queue-file as re-submittable
JSON docs; the process exits 0 (`Supervisor.mark_drained`). A crash
(SIGKILL, watchdog `os._exit`) persists nothing — but the in-flight
batch's snapshot file survives, and `resume_pending_batch()` on the
next start re-registers its requests (original rids) and completes
them from the last beat boundary.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import threading
import time
from collections import OrderedDict
from typing import Any, Callable

import torch

from shadow_tpu_torch.serve.cache import ProgramCache
from shadow_tpu_torch.serve.chaos import DeviceLost, ResizeRequested
from shadow_tpu_torch.serve.packer import (
    ClassKey,
    LanePacker,
    ScenarioRequest,
    equivalence_class,
    parse_request,
)


class ServiceUnavailable(Exception):
    """Submit refused; the HTTP plane maps any subclass to 503."""


class ServiceDraining(ServiceUnavailable):
    """Submit refused: the service is draining (HTTP 503)."""


class ServiceDegraded(ServiceUnavailable):
    """Submit refused: repeated launch failures; resubmit later (503)."""


# ------------------------------------------------------------ scenarios
#
# The registry maps a request's `model` to its engine-level build.
# `build` constructs with a given base seed on a given device (the solo
# path builds with the request seed; the fleet template builds with 0
# and binds per-lane seeds — bit-identical, pinned by the fleet tier).
# `hosts_of` answers (names, host_count) WITHOUT building, so
# submit-time fault signatures stay cheap.


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    param_names: frozenset
    build: Callable  # (params, seed, device) -> (engine, state0, names)
    hosts_of: Callable  # (params: dict) -> (names, n_hosts_global)
    nic: bool = False  # has a NIC-modelled host tier (bandwidth_scale)


def _phold_hosts(params: dict):
    n = int(params.get("hosts", 8))
    return [f"host{i}" for i in range(n)], n


def _phold_build(params: dict, seed: int, device):
    from shadow_tpu_torch.models import phold

    p = dict(params)
    n = int(p.pop("hosts", 8))
    eng, init = phold.build(n, seed=seed, device=device, **p)
    return eng, init(), [f"host{i}" for i in range(n)]


# Config-driven scenarios (tgen / tor / bitcoin) build through the
# example-config generators + `build_simulation`. Host-id orderings in
# `hosts_of` mirror the generators' declaration order EXACTLY (locality
# reordering is off on this path), because fault-glob signatures are
# computed against these names at submit time without building.
# Parameter defaults mirror the generators' own defaults verbatim —
# `hosts_of` and `build` must agree on them or the fault signature and
# the built fleet's pad would disagree about the host set.


def _config_sim(xml: str, seed: int, capacity, device):
    from shadow_tpu_torch.config import parse_config
    from shadow_tpu_torch.sim import build_simulation

    sim = build_simulation(
        parse_config(xml), seed=seed,
        capacity=int(capacity) if capacity is not None else None,
        device=device,
    )
    return sim.engine, sim.state0, sim.names


def _tgen_hosts(params: dict):
    n = int(params.get("n_pairs", 64))
    return ([f"srv{i}" for i in range(n)]
            + [f"cli{i}" for i in range(n)], 2 * n)


def _tgen_build(params: dict, seed: int, device):
    from shadow_tpu_torch.examples import tgen_example

    p = dict(params)
    cap = p.pop("capacity", None)
    xml = tgen_example(
        n_pairs=int(p.pop("n_pairs", 64)),
        sendsize=str(p.pop("sendsize", "16KiB")),
        recvsize=str(p.pop("recvsize", "64KiB")),
        count=int(p.pop("count", 4)),
    )
    return _config_sim(xml, seed, cap, device)


def _tor_hosts(params: dict):
    k = int(params.get("n_relays_per_class", 10))
    s = int(params.get("n_servers", 10))
    c = int(params.get("n_clients", 950))
    names = ([f"{kl}{i}" for kl in ("guard", "middle", "exit")
              for i in range(k)]
             + [f"web{i}" for i in range(s)]
             + [f"torclient{i}" for i in range(c)])
    return names, len(names)


def _tor_build(params: dict, seed: int, device):
    from shadow_tpu_torch.examples import tor_example

    p = dict(params)
    cap = p.pop("capacity", None)
    xml = tor_example(
        n_relays_per_class=int(p.pop("n_relays_per_class", 10)),
        n_clients=int(p.pop("n_clients", 950)),
        n_servers=int(p.pop("n_servers", 10)),
        filesize=str(p.pop("filesize", "320KiB")),
        count=int(p.pop("count", 5)),
        relay_cpu_ghz=float(p.pop("relay_cpu_ghz", 0.0)),
    )
    return _config_sim(xml, seed, cap, device)


def _bitcoin_hosts(params: dict):
    n = int(params.get("n_nodes", 5000))
    return ["miner0"] + [f"btc{i}" for i in range(1, n)], n


def _bitcoin_build(params: dict, seed: int, device):
    from shadow_tpu_torch.examples import bitcoin_example

    p = dict(params)
    cap = p.pop("capacity", None)
    xml = bitcoin_example(
        n_nodes=int(p.pop("n_nodes", 5000)),
        blocks=int(p.pop("blocks", 3)),
        blocksize=str(p.pop("blocksize", "512KiB")),
        interval=int(p.pop("interval", 60)),
    )
    return _config_sim(xml, seed, cap, device)


SCENARIOS: dict[str, Scenario] = {
    "phold": Scenario(
        name="phold",
        param_names=frozenset({
            "hosts", "capacity", "msgs_per_host", "latency_ns",
            "mean_delay_ns", "hot_hosts", "hot_weight", "drain_batch",
            "batched",
        }),
        build=_phold_build,
        hosts_of=_phold_hosts,
    ),
    "tgen": Scenario(
        name="tgen",
        param_names=frozenset({
            "n_pairs", "sendsize", "recvsize", "count", "capacity",
        }),
        build=_tgen_build,
        hosts_of=_tgen_hosts,
    ),
    "tor": Scenario(
        name="tor",
        param_names=frozenset({
            "n_relays_per_class", "n_clients", "n_servers", "filesize",
            "count", "relay_cpu_ghz", "capacity",
        }),
        build=_tor_build,
        hosts_of=_tor_hosts,
    ),
    "bitcoin": Scenario(
        name="bitcoin",
        param_names=frozenset({
            "n_nodes", "blocks", "blocksize", "interval", "capacity",
        }),
        build=_bitcoin_build,
        hosts_of=_bitcoin_hosts,
    ),
}


def scenario_for(model: str) -> Scenario:
    scen = SCENARIOS.get(model)
    if scen is None:
        raise ValueError(
            f"unknown model {model!r}; served models are "
            f"{sorted(SCENARIOS)}"
        )
    return scen


def validate_request(req: ScenarioRequest) -> Scenario:
    """Model-aware validation on top of `parse_request`'s generic one."""
    scen = scenario_for(req.model)
    for k, _ in req.params:
        if k not in scen.param_names:
            raise ValueError(
                f"unknown {req.model} param {k!r}; static knobs are "
                f"{sorted(scen.param_names)}"
            )
    if req.bandwidth_scale != 1.0 and not scen.nic:
        raise ValueError(
            f"bandwidth_scale needs a NIC-modelled host tier; "
            f"{req.model} has none — use latency_scale or a bandwidth "
            "fault instead"
        )
    return scen


def request_class(req: ScenarioRequest) -> ClassKey:
    names, hg = scenario_for(req.model).hosts_of(dict(req.params))
    return equivalence_class(req, names, hg)


def solo_reference(doc: dict, *, device=None) -> dict:
    """The solo-run summary a served result must match bit-for-bit:
    the scenario built the NATIVE way on `device` (None: CUDA) — request
    seed in the engine config, faults compiled into the constructor,
    latency via `scaled_network` — and run through `Engine.run`. This is
    the port's own serving oracle, deliberately a different code path
    from the fleet's `bind_lanes`. The engine is rebuilt from the same
    arguments as the reference's oracle rebuilds it (no CPU model, no
    frontier kinds), so the two oracles agree."""
    from shadow_tpu_torch.core.device import resolve_device
    from shadow_tpu_torch.core.engine import Engine, state_summary
    from shadow_tpu_torch.faults.schedule import compile_faults
    from shadow_tpu_torch.runtime.fleet import scaled_network

    dev = resolve_device(device)
    req = parse_request(doc, rid="solo", seq=0)
    scen = validate_request(req)
    eng, state0, names = scen.build(dict(req.params), req.seed, dev)
    if req.fault_specs or req.latency_scale != 1.0:
        net = (scaled_network(eng.network, req.latency_scale)
               if req.latency_scale != 1.0 else eng.network)
        comp = None
        reset = None
        if req.fault_specs:
            hg = len(names)
            comp = compile_faults(req.fault_specs, names, hg, req.seed,
                                  device=dev)
            if comp.has_crash or comp.has_bw:
                reset = state0.hosts
        eng = Engine(eng.cfg, eng.handlers, net,
                     batch_handler=eng.batch_handler,
                     faults=comp, fault_reset=reset, device=dev)
    return state_summary(eng.run(state0, int(req.stop_ns)))


# -------------------------------------------------------------- service


def _lane_tree(st):
    """A snapshot's tree: a fleet state in the reference's [L, ...] lane
    layout (`lane_view`), so either package resumes the other's file; an
    injected fleet's state (a dict of arrays) as it is."""
    from shadow_tpu_torch.core.engine import EngineState
    from shadow_tpu_torch.runtime.fleet import lane_view

    return lane_view(st) if isinstance(st, EngineState) else st


def _row_tree(st):
    """The inverse of `_lane_tree`."""
    from shadow_tpu_torch.core.engine import EngineState
    from shadow_tpu_torch.runtime.fleet import row_view

    return row_view(st) if isinstance(st, EngineState) else st


def _lane_slice(tree, lo, hi):
    """Lanes [lo, hi) of a lane-layout tree."""
    from shadow_tpu_torch.runtime.fleet import _tree_map

    return _tree_map(lambda k, x: x[lo:hi], tree)


@dataclasses.dataclass
class CacheEntry:
    """One warm program: the built fleet (its template state and binds
    on the device), its harvest, and the scenario's host names."""

    key: ClassKey
    fleet: Any
    harvest: Any
    names: list


class SimService:
    """The resident executor: packer + cache + one launch worker.

    `device` (None: CUDA, which must exist; "cpu" for the tests) is
    where every fleet is built and run; without a card the default
    raises, it never falls back to the CPU. `fleet_factory` is
    injectable for pure-python tests of the submit/pack/drain machinery
    (it replaces `_build_entry`).

    Every robustness knob defaults OFF (snapshot_beats=0 — no snapshot
    I/O; launch_deadline_s=0 — no watchdog thread; result_ttl_s=0 and a
    large max_results — no eviction in any test-sized run; chaos only
    from SHADOW_TPU_SERVE_CHAOS), so the default-configured hot path is
    the bare beat loop.
    """

    def __init__(self, *, max_lanes: int = 8,
                 pack_deadline_ms: float = 50.0,
                 max_cached_programs: int = 4, beat_windows: int = 32,
                 metrics=None, queue_file: str | None = None,
                 fleet_factory=None, clock=time.monotonic,
                 snapshot_beats: int = 0,
                 snapshot_path: str | None = None,
                 launch_retries: int = 1,
                 launch_backoff_s: float = 0.05,
                 launch_deadline_s: float = 0.0,
                 result_ttl_s: float = 0.0,
                 max_results: int = 65536,
                 degraded_after: int = 3,
                 diag_dir: str = ".",
                 chaos=None,
                 tracer=None,
                 watchdog_exit=None,
                 generation: int = 0,
                 peer_lost_exit=None,
                 device=None):
        if max_lanes < 1:
            raise ValueError(f"max_lanes must be >= 1, got {max_lanes}")
        from shadow_tpu_torch.core.device import resolve_device
        from shadow_tpu_torch.obs.metrics import ServeMetrics

        self.device = resolve_device(device)
        self.max_lanes = int(max_lanes)
        self.beat_windows = max(int(beat_windows), 1)
        self.queue_file = queue_file
        self.metrics = metrics if metrics is not None else ServeMetrics()
        self.cache = ProgramCache(max_cached_programs,
                                  metrics=self.metrics)
        self.packer = LanePacker(self.max_lanes,
                                 pack_deadline_ms / 1000.0, clock=clock)
        self._fleet_factory = fleet_factory
        self._clock = clock
        # request-scoped tracing (docs/18-Serve-Tracing.md): every call
        # site is guarded on `self._tracer is not None`, so tracer-off
        # keeps the hot path — and the HTTP surface — byte-identical
        self._tracer = tracer
        if tracer is not None and tracer.metrics is None:
            tracer.metrics = self.metrics
        self._cond = threading.Condition()
        self._results: dict[str, dict] = {}
        self._submit_t: dict[str, float] = {}
        self._seq = 0
        self._launches = 0
        self._stopping = False
        self._thread: threading.Thread | None = None

        # -- failure-domain isolation knobs (docs/17 "Failure semantics")
        self.snapshot_beats = max(int(snapshot_beats), 0)
        self.snapshot_path = snapshot_path
        self.launch_retries = max(int(launch_retries), 0)
        self.launch_backoff_s = max(float(launch_backoff_s), 0.0)
        self.result_ttl_s = max(float(result_ttl_s), 0.0)
        self.max_results = max(int(max_results), 1)
        self.degraded_after = max(int(degraded_after), 1)
        self.diag_dir = diag_dir
        self._done_order: "OrderedDict[str, float]" = OrderedDict()
        self._fail_streak = 0
        self._degraded = False
        self._degraded_cause: str | None = None
        # batches handed to the worker ahead of packer traffic:
        # (key, reqs, snapshot_path) — resume_pending_batch and the
        # in-flight migrator both append here
        self._resume: list[tuple] = []

        # -- elastic serving (docs/17-Serving.md "Elasticity"): the mesh
        # generation starts at 0 (as launched) and bumps on every
        # migration or resize; a relaunched process seeds it from the
        # retry attempt so /healthz reports the churn. `peer_lost_exit`
        # is injectable for tests (default: os._exit with
        # EXIT_PEER_LOST, the real device-loss escape hatch).
        self._generation = max(int(generation), 0)
        self._peak_lanes = self.max_lanes
        self._resize_to: int | None = None
        self._peer_lost_exit = (peer_lost_exit if peer_lost_exit
                                is not None else os._exit)
        if self._generation:
            self.metrics.set("serve_mesh_generation", self._generation)

        if chaos is None:
            from shadow_tpu_torch.serve import chaos as chaos_mod

            marker_dir = (os.path.dirname(os.path.abspath(snapshot_path))
                          if snapshot_path else None)
            chaos = chaos_mod.from_env(marker_dir=marker_dir)
        if chaos is not None and chaos._on_inject is None:
            # explicitly-passed injectors count the same as env ones;
            # injections also land in the trace ledger when tracing
            def _note_chaos(kind):
                self.metrics.inc("serve_chaos_injected")
                if self._tracer is not None:
                    self._tracer.event("chaos", chaos_kind=kind)

            chaos._on_inject = _note_chaos
        self._chaos = chaos

        self._watchdog = None
        if float(launch_deadline_s) > 0:
            from shadow_tpu_torch.runtime.supervisor import Watchdog

            self._watchdog = Watchdog(
                float(launch_deadline_s), diag_dir=diag_dir,
                label="shadow_tpu.serve", kind="launchstall",
                compile_grace=True,  # a first-use kernel build
                info=lambda: {"plane": "serve",
                              "launches": self._launches,
                              **({"trace_recent": self._tracer.recent()}
                                 if self._tracer is not None else {})},
                **({"_exit": watchdog_exit} if watchdog_exit else {}),
            )
            # the watchdog covers a BEAT, not the process: idle time
            # between launches must never fire
            self._watchdog.disarm()

    # -- request plane ---------------------------------------------------

    def submit(self, doc: dict) -> dict:
        """Validate, classify, queue. Raises ValueError (HTTP 400) on a
        bad request, ServiceDraining/ServiceDegraded (503) otherwise."""
        t_in = self._tracer.now() if self._tracer is not None else 0.0
        with self._cond:
            if self._stopping:
                raise ServiceDraining("service is draining; resubmit "
                                      "to the next instance")
            if self._degraded:
                raise ServiceDegraded(
                    "service is degraded after repeated launch failures"
                    f" ({self._degraded_cause}); resubmit later")
            seq = self._seq
            self._seq += 1
        rid = f"r{seq:06d}"
        req = parse_request(doc, rid=rid, seq=seq)
        validate_request(req)
        key = request_class(req)
        self.metrics.inc("serve_requests")
        with self._cond:
            self._results[rid] = {
                "request_id": rid, "status": "queued", "class": str(key),
            }
            self._submit_t[rid] = self._clock()
            self.packer.push(key, req)
            self.metrics.set("serve_queue_depth", self.packer.depth())
            self._evict_results_locked()
            if self._tracer is not None:
                self._tracer.span("submit", t0=t_in,
                                  t1=self._submit_t[rid], rid=rid,
                                  cls=str(key), seq=seq)
            self._cond.notify()
        return {"request_id": rid, "class": str(key)}

    def result(self, rid: str) -> dict | None:
        with self._cond:
            rec = self._results.get(rid)
            if rec is not None and rid in self._done_order:
                # a record still being polled stays resident: reading
                # refreshes both its LRU position and its TTL clock
                self._done_order[rid] = self._clock()
                self._done_order.move_to_end(rid)
            return dict(rec) if rec is not None else None

    def queue_snapshot(self) -> dict:
        with self._cond:
            launches = self._launches
            draining = self._stopping
        return {
            "packer": self.packer.snapshot(),
            "cache": self.cache.snapshot(),
            "launches": launches,
            "draining": draining,
        }

    @property
    def tracer(self):
        return self._tracer

    def trace(self, rid: str) -> dict | None:
        """The request's span tree (GET /trace/<rid>), or None when
        tracing is off or the rid is unknown/evicted."""
        if self._tracer is None:
            return None
        return self._tracer.trace(rid)

    def health(self) -> dict:
        """/healthz body: {"status": "ok"|"draining"|"degraded"} plus
        the failure cause while degraded. Only "ok" maps to HTTP 200.

        After an elastic event the "ok" body additionally carries the
        mesh generation and current capacity — and, while the lane
        count sits below the peak this process has served at,
        `degraded_capacity` so an orchestrator knows to restore the
        mesh. Generation 0 keeps the body byte-identical to the
        pre-elastic one (zero-cost discipline, pinned in tests)."""
        with self._cond:
            if self._stopping:
                return {"status": "draining"}
            if self._degraded:
                return {"status": "degraded",
                        "cause": self._degraded_cause,
                        "fail_streak": self._fail_streak}
            if self._generation or self.max_lanes < self._peak_lanes:
                out = {"status": "ok",
                       "mesh_generation": self._generation,
                       "max_lanes": self.max_lanes}
                if self.max_lanes < self._peak_lanes:
                    out["degraded_capacity"] = True
                    out["peak_lanes"] = self._peak_lanes
                return out
        return {"status": "ok"}

    # -- elastic resize --------------------------------------------------

    def resize(self, lanes: int) -> None:
        """Operator mesh resize (the SIGHUP path): applied between
        batches when the worker is idle, or converted into a
        beat-boundary snapshot + migration when a launch is in flight —
        requests keep their original rids either way."""
        if int(lanes) < 1:
            raise ValueError(f"resize: lanes must be >= 1, got {lanes}")
        with self._cond:
            self._resize_to = int(lanes)
            self._cond.notify()

    def _bump_generation_locked(self, why: str) -> None:
        self._generation += 1
        self.metrics.set("serve_mesh_generation", self._generation)
        print(f"serve: mesh generation -> {self._generation} ({why})",
              file=sys.stderr, flush=True)

    def _apply_resize_locked(self, lanes: int) -> None:
        """Change the lane count (caller holds `_cond`): the packer
        fills to the new width, the next cache get builds at it (the
        generation bump keys the cache entry), and the peak-capacity
        watermark feeds `degraded_capacity` in /healthz."""
        lanes = int(lanes)
        self._resize_to = None
        if lanes < 1 or lanes == self.max_lanes:
            return
        old = self.max_lanes
        self.max_lanes = lanes
        self.packer.max_lanes = lanes
        self._peak_lanes = max(self._peak_lanes, lanes)
        self._bump_generation_locked(f"resize {old} -> {lanes} lanes")

    # -- result retention ------------------------------------------------

    def _note_terminal_locked(self, rid: str) -> None:
        self._done_order[rid] = self._clock()
        self._done_order.move_to_end(rid)

    def _evict_results_locked(self) -> None:
        """Drop the oldest terminal (done/error/timeout) records past
        `max_results` or `result_ttl_s`. Queued/running records are
        pinned — they are never in `_done_order`."""
        now = self._clock()
        evicted = 0
        while self._done_order:
            rid, t = next(iter(self._done_order.items()))
            over = len(self._done_order) > self.max_results
            stale = self.result_ttl_s > 0 and now - t >= self.result_ttl_s
            if not (over or stale):
                break
            self._done_order.popitem(last=False)
            self._results.pop(rid, None)
            if self._tracer is not None:
                # /trace retention tracks /result retention exactly
                self._tracer.forget(rid)
            evicted += 1
        if evicted:
            self.metrics.inc("serve_results_evicted", evicted)

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "SimService":
        if self._watchdog is not None:
            self._watchdog.start()
        self._thread = threading.Thread(
            target=self._worker_loop, name="shadow-tpu-serve-worker",
            daemon=True)
        self._thread.start()
        return self

    def drain(self) -> dict:
        """Graceful stop: finish the launch in flight, persist the
        pending queue, report. Idempotent. An in-flight batch's snapshot
        is cleared by its own completion; a snapshot left on disk here
        belongs to a batch that never finished and will be resumed by
        the next start's `resume_pending_batch`."""
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._watchdog is not None:
            self._watchdog.stop()
        pending = self.packer.drain_all()
        self.metrics.set("serve_queue_depth", 0)
        if self.queue_file is not None:
            doc = {"version": 1, "pending": [r.doc() for r in pending]}
            tmp = self.queue_file + ".tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f, sort_keys=True, indent=1)
                f.write("\n")
            os.replace(tmp, self.queue_file)
        return {"persisted": len(pending), "queue_file": self.queue_file}

    def load_queue(self) -> int:
        """Re-submit requests persisted by a previous drain.

        A doc the current version refuses (schema drift, a renamed
        param) must not vanish: failures are collected, logged, and
        written to `<queue-file>.rejected` for operator triage."""
        if self.queue_file is None or not os.path.exists(self.queue_file):
            return 0
        with open(self.queue_file) as f:
            doc = json.load(f)
        n = 0
        rejects = []
        for d in doc.get("pending", []):
            try:
                self.submit(d)
                n += 1
            except Exception as e:  # noqa: BLE001 - one bad doc must not drop the rest
                rejects.append({"doc": d,
                                "error": f"{type(e).__name__}: {e}"})
        if rejects:
            rej_path = self.queue_file + ".rejected"
            with open(rej_path, "w") as f:
                json.dump({"version": 1, "rejected": rejects}, f,
                          sort_keys=True, indent=1)
                f.write("\n")
            print(
                f"serve: {len(rejects)} persisted request(s) no longer "
                f"parse; kept in {rej_path}",
                file=sys.stderr, flush=True,
            )
        os.remove(self.queue_file)
        return n

    def _entries_from_manifest(self, serve: dict, path: str):
        """(key, reqs, snapshot_path) for the worker, or None when the
        manifest no longer parses under the current schema."""
        try:
            reqs = []
            for rid, seq, d in zip(serve["rids"], serve["seqs"],
                                   serve["docs"]):
                req = parse_request(d, rid=str(rid), seq=int(seq))
                validate_request(req)
                reqs.append(req)
            if not reqs:
                return None
            key = request_class(reqs[0])
        except Exception:  # noqa: BLE001 - a stale manifest must not kill startup
            return None
        return (key, reqs, path)

    def resume_pending_batch(self) -> int:
        """Crash recovery: scan the snapshot path AND any `.part*`
        migration outputs next to it; every file carrying a v7 batch
        manifest re-registers its requests under their ORIGINAL rids
        and hands the batch to the worker ahead of packer traffic —
        `_launch` then reloads the state tree and continues from the
        snapshotted beat. A snapshot written at a DIFFERENT lane count
        (the writer died and the retry loop halved --max-lanes) is
        migrated first: its `[L, ...]` state tree is resharded along
        the lane axis into per-batch part files that fit the current
        mesh (docs/17-Serving.md "Elasticity"). Returns the number of
        resumed requests (0 if none)."""
        base = self.snapshot_path
        if not base:
            return 0
        import glob as _glob

        from shadow_tpu_torch.utils.checkpoint import read_header_info

        cands = ([base] if os.path.exists(base) else []) + sorted(
            p for p in _glob.glob(base + ".part*")
            if not p.endswith(".tmp"))
        entries: list[tuple] = []
        migrated = False
        for path in cands:
            try:
                serve = read_header_info(path).get("serve")
            except ValueError as e:
                print(
                    f"serve: ignoring unreadable snapshot {path!r}: {e}",
                    file=sys.stderr, flush=True)
                continue
            if not serve:
                continue
            writer_lanes = int(serve.get("max_lanes") or 0)
            if writer_lanes != self.max_lanes:
                self._peak_lanes = max(self._peak_lanes, writer_lanes)
                got = self._migrate_snapshot(path)
                if got:
                    migrated = True
                    entries.extend(got)
                continue
            ent = self._entries_from_manifest(serve, path)
            if ent is None:
                print(
                    f"serve: snapshot {path!r} manifest no longer "
                    "parses; leaving it for triage",
                    file=sys.stderr, flush=True)
                continue
            entries.append(ent)
        if not entries:
            return 0
        n = 0
        now = self._clock()
        with self._cond:
            top = max(r.seq for _k, rs, _p in entries for r in rs)
            self._seq = max(self._seq, top + 1)
            for key, rs, _p in entries:
                for r in rs:
                    self._results[r.rid] = {
                        "request_id": r.rid, "status": "queued",
                        "class": str(key),
                    }
                    self._submit_t[r.rid] = now
                    n += 1
            self._resume.extend(entries)
            if migrated:
                self._bump_generation_locked(
                    "snapshot migrated to the relaunched mesh")
            self._cond.notify()
        self.metrics.inc("serve_requests", n)
        print(
            f"serve: resuming {n} request(s) across {len(entries)} "
            f"batch(es) from {base!r}",
            file=sys.stderr, flush=True,
        )
        return n

    def _migrate_snapshot(self, path: str) -> list[tuple]:
        """Reshard one snapshot file to the current lane count, at the
        FILE level — no fleet of the old shape exists anymore, so the
        raw `[L, ...]` leaves are sliced along the lane axis
        (`runtime.fleet.lane_reshard`) and written back under the SAME
        leaf-path keys (`save_checkpoint_raw`), one part file per
        sub-batch, each with its own chunked manifest. Growing writes a
        single part that records `state_lanes` so the loader pads it up
        with inert template lanes. Returns the worker entries; refuses
        loudly — file left for triage — on a lane count that does not
        divide or a manifest that no longer parses."""
        import numpy as np

        from shadow_tpu_torch.runtime.fleet import lane_reshard
        from shadow_tpu_torch.utils.checkpoint import (
            load_checkpoint_raw,
            save_checkpoint_raw,
        )

        new_L = self.max_lanes
        try:
            header, by_path = load_checkpoint_raw(path)
            serve = dict(header.get("serve") or {})
            paths = header["paths"]
            arrs = [by_path[p] for p in paths]
            old_L = int(np.shape(arrs[0])[0])
            rids = list(serve["rids"])
            chunks: list[tuple[dict, dict]] = []
            if old_L <= new_L:
                # grow (or same size under a changed max_lanes): one
                # part, state stays at old_L lanes; the loader merges
                # inert template lanes on top (requests <= old_L
                # always, so the pad lanes never step)
                manifest = dict(serve)
                manifest["max_lanes"] = new_L
                if old_L != new_L:
                    manifest["state_lanes"] = old_L
                else:
                    manifest.pop("state_lanes", None)
                chunks.append((dict(zip(paths, arrs)), manifest))
            else:
                parts = lane_reshard(arrs, new_L)
                for j, part in enumerate(parts):
                    lo, hi = j * new_L, (j + 1) * new_L
                    if not rids[lo:hi]:
                        continue  # trailing all-pad lanes
                    manifest = dict(serve)
                    manifest["max_lanes"] = new_L
                    manifest.pop("state_lanes", None)
                    for k in ("rids", "seqs", "docs"):
                        manifest[k] = list(serve[k])[lo:hi]
                    if "stops" in serve:
                        manifest["stops"] = list(serve["stops"])[lo:hi]
                    chunks.append((dict(zip(paths, part)), manifest))
        except (ValueError, KeyError) as e:
            print(
                f"serve: cannot migrate snapshot {path!r} to {new_L} "
                f"lane(s) ({type(e).__name__}: {e}); leaving it for "
                "triage", file=sys.stderr, flush=True)
            return []
        staged = []
        for j, (leaves, manifest) in enumerate(chunks):
            part_path = f"{path}.part{j}"
            k = 0
            while os.path.exists(part_path):  # never clobber a pending part
                k += 1
                part_path = f"{path}.part{j}.m{k}"
            ent = self._entries_from_manifest(manifest, part_path)
            if ent is None:
                print(
                    f"serve: snapshot {path!r} manifest no longer "
                    "parses; leaving it for triage",
                    file=sys.stderr, flush=True)
                return []
            staged.append((ent, leaves, manifest, part_path))
        out = []
        for ent, leaves, manifest, part_path in staged:
            save_checkpoint_raw(part_path, leaves,
                                meta={"plane": "serve"},
                                serve_manifest=manifest)
            out.append(ent)
        os.remove(path)
        self.metrics.inc("serve_migrations")
        print(
            f"serve: migrated snapshot {path!r}: {old_L} -> {new_L} "
            f"lane(s), {len(out)} batch(es), resuming at beat "
            f"{serve.get('beats_done', '?')}",
            file=sys.stderr, flush=True,
        )
        return out

    def _migrate_inflight(self, key: ClassKey, reqs: list,
                          new_lanes: int, snap_path: str | None) -> None:
        """An in-flight launch hit a resize request at a beat boundary
        (the boundary snapshot was just written): apply the new lane
        count, reshard the snapshot, and queue the migrated sub-batches
        ahead of packer traffic. Requests keep their rids and their
        submit clocks — a migration is invisible in the result records
        except for `resumed_from_beat`. Without a usable snapshot the
        requests requeue from beat 0 in chunks of the new width
        (deterministic replay keeps the results exact, it just repays
        the completed beats)."""
        with self._cond:
            self._apply_resize_locked(new_lanes)
        entries: list[tuple] = []
        if snap_path and os.path.exists(snap_path):
            entries = self._migrate_snapshot(snap_path)
        if not entries:
            L = self.max_lanes
            base = snap_path or self.snapshot_path
            entries = [
                (key, reqs[i:i + L],
                 f"{base}.part{i // L}" if base else None)
                for i in range(0, len(reqs), L)
            ]
            print(
                "serve: no usable snapshot for the in-flight resize; "
                f"requeuing {len(reqs)} request(s) from beat 0 in "
                f"{len(entries)} batch(es)",
                file=sys.stderr, flush=True)
        with self._cond:
            self._resume.extend(entries)
            self._cond.notify()

    # -- launch worker ---------------------------------------------------

    def _worker_loop(self) -> None:
        while True:
            with self._cond:
                key = None
                reqs = None
                snap = self.snapshot_path
                while not self._stopping:
                    if self._resume:
                        key, reqs, snap = self._resume.pop(0)
                        break
                    if self._resize_to is not None:
                        # idle resize: no batch in flight, nothing to
                        # migrate — just change width
                        self._apply_resize_locked(self._resize_to)
                        continue
                    key = self.packer.ready()
                    if key is not None:
                        break
                    self._cond.wait(timeout=self.packer.next_timeout())
                if self._stopping:
                    return
                if reqs is None:
                    reqs = self.packer.pop(key)
                    self.metrics.set("serve_queue_depth",
                                     self.packer.depth())
                if self._tracer is not None and reqs:
                    # queue_wait: submit (or resume registration) to the
                    # moment the worker claims the batch
                    t_pop = self._tracer.now()
                    for r in reqs:
                        self._tracer.span(
                            "queue_wait",
                            t0=self._submit_t.get(r.rid, t_pop),
                            t1=t_pop, rid=r.rid, cls=str(key))
            if not reqs:
                continue
            try:
                # inference mode is thread-local: enter it on the worker
                with torch.inference_mode():
                    self._run_batch(key, reqs, snap_path=snap)
            except Exception as e:  # noqa: BLE001 - one bad batch must not kill the worker
                self._fail_requests(key, reqs, e)
            finally:
                self.metrics.set("serve_inflight", 0)

    def _run_batch(self, key: ClassKey, reqs: list,
                   depth: int = 0, snap_path: str | None = None) -> None:
        """One supervised batch: retry `_launch` with exponential
        backoff (each retry resumes from the newest snapshot when
        enabled), then bisect to isolate poison. Terminal failures land
        on `_fail_requests`; the worker thread always survives — except
        for device loss, which exits EXIT_PEER_LOST so the outer retry
        loop relaunches the process at a smaller mesh (the snapshot
        stays on disk for `resume_pending_batch`). A resize request is
        not a failure at all: the batch migrates in process."""
        if snap_path is None:
            snap_path = self.snapshot_path
        attempt = 0
        while True:
            try:
                self._launch(key, reqs, snap_path=snap_path)
            except ResizeRequested as e:
                self._migrate_inflight(key, reqs, e.lanes, snap_path)
                return
            except Exception as e:  # noqa: BLE001 - classified below, never propagated
                if self._is_device_loss(e):
                    self._on_device_loss(key, reqs, e, snap_path)
                    return  # reached only with an injectable exit hook
                if attempt < self.launch_retries:
                    attempt += 1
                    self.metrics.inc("serve_launch_retries")
                    backoff = self.launch_backoff_s * (2 ** (attempt - 1))
                    print(
                        f"serve: launch retry {attempt}/"
                        f"{self.launch_retries} for class {key} after "
                        f"{type(e).__name__}: {e} "
                        f"(backoff {backoff:.2f}s)",
                        file=sys.stderr, flush=True,
                    )
                    tr = self._tracer
                    t_r0 = tr.now() if tr is not None else 0.0
                    if backoff > 0:
                        time.sleep(backoff)
                    if tr is not None:
                        # the retry span covers the backoff sleep, so a
                        # retried request's spans still tile its wall
                        tr.span("retry", t0=t_r0, t1=tr.now(),
                                rids=[r.rid for r in reqs],
                                cls=str(key), attempt=attempt,
                                backoff_s=backoff,
                                error=f"{type(e).__name__}: {e}")
                    continue
                if len(reqs) > 1:
                    # retries exhausted on a multi-request batch: split
                    # to isolate the poison request; riders complete on
                    # their halves. The halves are fresh batches — the
                    # dead attempt's snapshot no longer matches them.
                    self.metrics.inc("serve_bisections")
                    self._clear_snapshot(snap_path)
                    if self._tracer is not None:
                        self._tracer.event(
                            "bisect", rids=[r.rid for r in reqs],
                            cls=str(key), depth=depth, size=len(reqs),
                            error=f"{type(e).__name__}: {e}")
                    mid = len(reqs) // 2
                    print(
                        f"serve: bisecting {len(reqs)}-request batch of "
                        f"class {key} ({type(e).__name__}: {e})",
                        file=sys.stderr, flush=True,
                    )
                    self._run_batch(key, reqs[:mid], depth + 1,
                                    snap_path)
                    self._run_batch(key, reqs[mid:], depth + 1,
                                    snap_path)
                else:
                    self._clear_snapshot(snap_path)
                    self._fail_requests(key, reqs, e)
                return
            else:
                with self._cond:
                    self._fail_streak = 0
                    if self._degraded:
                        self._degraded = False
                        self._degraded_cause = None
                        self.metrics.set("serve_degraded", 0)
                return

    def _fail_requests(self, key: ClassKey, reqs: list,
                       e: Exception) -> None:
        """Terminal failure: per-rid error records, metrics, and the
        degraded-mode failure streak."""
        self.metrics.inc("serve_errors", len(reqs))
        if self._tracer is not None:
            for r in reqs:
                self._tracer.event(
                    "result", rid=r.rid, cls=str(key), status="error",
                    error=f"{type(e).__name__}: {e}")
        with self._cond:
            for r in reqs:
                self._results[r.rid] = {
                    "request_id": r.rid, "status": "error",
                    "error": f"{type(e).__name__}: {e}",
                    "class": str(key),
                }
                self._submit_t.pop(r.rid, None)
                self._note_terminal_locked(r.rid)
            self._evict_results_locked()
            self._fail_streak += 1
            if (self._fail_streak >= self.degraded_after
                    and not self._degraded):
                self._degraded = True
                self._degraded_cause = f"{type(e).__name__}: {e}"
                self.metrics.set("serve_degraded", 1)
                print(
                    f"serve: DEGRADED after {self._fail_streak} "
                    f"consecutive terminal failures "
                    f"({self._degraded_cause}); /submit -> 503",
                    file=sys.stderr, flush=True,
                )

    # -- device loss -----------------------------------------------------

    _DEVLOSS_MARKERS = ("device lost", "peer lost", "data loss")

    def _is_device_loss(self, e: Exception) -> bool:
        """The chaos injector's DeviceLost, or a backend failure whose
        message reads like a vanished device — either way the fleet's
        device is gone and an in-process retry would just re-trip it."""
        if isinstance(e, DeviceLost):
            return True
        msg = str(e).lower()
        return any(m in msg for m in self._DEVLOSS_MARKERS)

    def _on_device_loss(self, key: ClassKey, reqs: list, e: Exception,
                        snap_path: str | None) -> None:
        from shadow_tpu_torch.runtime.supervisor import EXIT_PEER_LOST

        print(
            f"serve: DEVICE LOST mid-batch (class {key}, {len(reqs)} "
            f"request(s)): {type(e).__name__}: {e}; snapshot "
            f"{snap_path!r} kept for the relaunch — exiting "
            f"{EXIT_PEER_LOST} so an outer --retry loop relaunches at "
            "a smaller mesh and resume_pending_batch migrates the "
            "batch", file=sys.stderr, flush=True)
        self._peer_lost_exit(EXIT_PEER_LOST)

    # -- snapshots -------------------------------------------------------

    def _snapshot_enabled(self) -> bool:
        return self.snapshot_beats > 0 and bool(self.snapshot_path)

    def _write_snapshot(self, key: ClassKey, reqs: list, st,
                        beats_done: int, stops,
                        path: str | None = None) -> None:
        from shadow_tpu_torch.utils.checkpoint import save_checkpoint

        manifest = {
            "version": 1,
            "class": str(key),
            "rids": [r.rid for r in reqs],
            "seqs": [r.seq for r in reqs],
            "docs": [r.doc() for r in reqs],
            "beats_done": int(beats_done),
            "beat_windows": self.beat_windows,
            "max_lanes": self.max_lanes,
            "stops": [int(s) for s in stops.tolist()],
        }
        save_checkpoint(path or self.snapshot_path, _lane_tree(st),
                        meta={"plane": "serve"},
                        serve_manifest=manifest)
        self.metrics.inc("serve_snapshots")

    def _load_snapshot(self, key: ClassKey, reqs: list, template,
                       path: str | None = None):
        """(state, beats_done) from a verified snapshot matching this
        exact batch, or None. A mismatched or damaged snapshot is
        ignored (and removed — it can never be resumed by anyone). A
        migrated part whose state has fewer lanes than the built
        width (`state_lanes`, the grow path) loads against a lane-slice
        of the template and pads back up with the template's own inert
        lanes — those lanes carry no requests and never step."""
        path = path or self.snapshot_path
        if not path or not os.path.exists(path):
            return None
        from shadow_tpu_torch.utils.checkpoint import (
            load_checkpoint,
            read_header_info,
            verify_checkpoint,
        )

        try:
            serve = read_header_info(path).get("serve")
            if (not serve
                    or serve.get("class") != str(key)
                    or serve.get("rids") != [r.rid for r in reqs]
                    or serve.get("beat_windows") != self.beat_windows
                    or serve.get("max_lanes") != self.max_lanes):
                return None
            P = int(serve.get("state_lanes") or serve.get("max_lanes"))
            if not (0 < P <= self.max_lanes) or P < len(reqs):
                return None
            verify_checkpoint(path)
            tree = _lane_tree(template)
            if P != self.max_lanes:
                from shadow_tpu_torch.runtime.fleet import lane_merge

                part, _ = load_checkpoint(path, _lane_slice(tree, 0, P))
                state = lane_merge([_row_tree(part),
                                    _row_tree(_lane_slice(tree, P, None))])
            else:
                state, _ = load_checkpoint(path, tree)
                state = _row_tree(state)
        except ValueError as e:
            print(
                f"serve: discarding unusable snapshot {path!r}: {e}",
                file=sys.stderr, flush=True,
            )
            self._clear_snapshot(path)
            return None
        return state, int(serve["beats_done"])

    def _clear_snapshot(self, path: str | None = None) -> None:
        path = path or self.snapshot_path
        if path:
            try:
                os.remove(path)
            except FileNotFoundError:
                pass

    # -- launch ----------------------------------------------------------

    def _build_entry(self, key: ClassKey, probe: ScenarioRequest):
        """Cold path: build the class's fleet template at max_lanes on
        the service's device. The probe request donates its fault specs
        so the template binds the class's fault flags; the pinned fault
        pad makes every batch in the class bind identically-shaped
        arrays."""
        from shadow_tpu_torch.runtime.fleet import Fleet, FleetPlan
        from shadow_tpu_torch.runtime.harvest import HeartbeatHarvest

        scen = scenario_for(key.model)
        eng, state0, names = scen.build(dict(key.params), 0, self.device)
        L = self.max_lanes
        faults = None
        pad = None
        if key.fault_sig is not None:
            pad = (key.fault_sig[0], key.fault_sig[1])
            faults = (probe.fault_specs,) + ((),) * (L - 1)
        plan = FleetPlan(lanes=L, seeds=tuple(range(L)), faults=faults,
                         latency_scale=(1.0,) * L)
        fleet = Fleet(eng, state0, plan, names=names,
                      per_lane_stop=True, fault_pad=pad,
                      strict_overflow=False)
        return CacheEntry(key=key, fleet=fleet,
                          harvest=HeartbeatHarvest(fleet), names=names)

    def _batch_plan(self, key: ClassKey, reqs: list, lanes: int):
        """The packed FleetPlan: live lanes carry the requests' knobs,
        pad lanes are inert (zero events — counters pinned at zero)."""
        from shadow_tpu_torch.runtime.fleet import FleetPlan, inert_lane_state

        R = len(reqs)
        pads = lanes - R
        faults = None
        if key.fault_sig is not None:
            faults = tuple(r.fault_specs for r in reqs) + ((),) * pads
        bw = None
        if any(r.bandwidth_scale != 1.0 for r in reqs):
            bw = (tuple(r.bandwidth_scale for r in reqs)
                  + (1.0,) * pads)

        def override(i, st):
            return st if i < R else inert_lane_state(st)

        return FleetPlan(
            lanes=lanes,
            seeds=tuple(r.seed for r in reqs) + (0,) * pads,
            faults=faults,
            latency_scale=(tuple(r.latency_scale for r in reqs)
                           + (1.0,) * pads),
            bandwidth_scale=bw,
            state_override=override,
        )

    def _launch(self, key: ClassKey, reqs: list,
                snap_path: str | None = None) -> None:
        import numpy as np

        if snap_path is None:
            snap_path = self.snapshot_path
        snap_on = self.snapshot_beats > 0 and bool(snap_path)
        tr = self._tracer
        t_entry = tr.now() if tr is not None else 0.0
        hits_before = self.cache.hits
        factory = (self._fleet_factory or self._build_entry)
        # the device-generation key: generation 0 (no elastic event
        # ever) keys by ClassKey alone — byte-identical cache behavior
        # to the pre-elastic plane; after a migration/resize the bumped
        # generation invalidates every old-shape program (stale entries
        # age out through the LRU)
        ck = key if self._generation == 0 else (key, self._generation)
        entry = self.cache.get(ck, lambda: factory(key, reqs[0]))
        cache_hit = self.cache.hits > hits_before
        t_cache = tr.now() if tr is not None else 0.0
        fleet = entry.fleet
        L = fleet.lanes
        R = len(reqs)
        with self._cond:
            self._launches += 1
            launch_no = self._launches
            for i, r in enumerate(reqs):
                self._results[r.rid] = {
                    "request_id": r.rid, "status": "running",
                    "class": str(key), "lane": i, "launch": launch_no,
                }
        if tr is not None:
            # cache hit vs build: a cold get's duration IS the build
            tr.span("cache", t0=t_entry, t1=t_cache, launch=launch_no,
                    cls=str(key), hit=cache_hit)
            for r in reqs:
                tr.associate(r.rid, launch_no)
        self.metrics.inc("serve_launches")
        self.metrics.inc("serve_lanes", R)
        self.metrics.set("serve_last_lanes_packed", R)
        self.metrics.set("serve_inflight", R)
        if R >= 2:
            self.metrics.inc("serve_packed_launches")

        st, binds = fleet.make_inputs(self._batch_plan(key, reqs, L))
        stops = np.asarray([r.stop_ns for r in reqs] + [0] * (L - R),
                           np.int64)
        beats_done = 0
        resumed_from = None
        if snap_on:
            loaded = self._load_snapshot(key, reqs, st, snap_path)
            if loaded is not None:
                st = fleet.adopt_state(loaded[0])
                beats_done = resumed_from = loaded[1]
                self.metrics.inc("serve_resumes")
                if tr is not None:
                    tr.event("resume", launch=launch_no, cls=str(key),
                             from_beat=resumed_from,
                             rids=[r.rid for r in reqs])
        # wall deadlines: per-request (deadline_ms from submit time) and
        # per-beat (the launch watchdog) — both off by default
        deadline_at = {}
        with self._cond:
            for i, r in enumerate(reqs):
                if r.deadline_ms > 0:
                    deadline_at[i] = (
                        self._submit_t.get(r.rid, self._clock())
                        + r.deadline_ms / 1e3)
        timed_out: set[int] = set()
        if self._watchdog is not None:
            self._watchdog.arm()
        if tr is not None:
            t_run0 = tr.now()
            # pack = launch entry -> first dispatch: cache get/build,
            # result-record setup, make_inputs, snapshot load
            tr.span("pack", t0=t_entry, t1=t_run0, launch=launch_no,
                    cls=str(key), lanes_packed=R, max_lanes=L,
                    rids=[r.rid for r in reqs],
                    resumed_from_beat=resumed_from)
            for r in reqs:
                tr.span("pack_wait", t0=t_entry, t1=t_run0, rid=r.rid,
                        launch=launch_no, cls=str(key))
        try:
            # beat loop: beat_windows fixed-window steps per harvest —
            # the single-fetch heartbeat that streams per-lane progress
            while True:
                beat = beats_done + 1
                t_b0 = tr.now() if tr is not None else 0.0
                # operator resize (SIGHUP) lands here, at the beat
                # boundary `st` already sits on: persist the boundary
                # and let _run_batch migrate. The chaos `resize`
                # injector raises the same exception from fire() — give
                # it the same boundary snapshot on the way out.
                rz = self._resize_to
                if rz is not None and rz != self.max_lanes:
                    if snap_on:
                        self._write_snapshot(key, reqs, st, beats_done,
                                             stops, path=snap_path)
                    raise ResizeRequested(rz)
                if self._chaos:
                    try:
                        self._chaos.fire(
                            "beat", beat=beat,
                            seeds=tuple(r.seed for r in reqs))
                    except ResizeRequested:
                        if snap_on:
                            self._write_snapshot(key, reqs, st,
                                                 beats_done, stops,
                                                 path=snap_path)
                        raise
                for _ in range(self.beat_windows):
                    st = fleet.step_window(st, stops, binds=binds)
                st, bundle = entry.harvest.extract(st, full=False)
                if self._chaos:
                    self._chaos.fire("fetch", beat=beat)
                t_f0 = tr.now() if tr is not None else 0.0
                fetched = entry.harvest.fetch(bundle)
                sums = entry.harvest.lane_summaries_from(fetched)
                beats_done = beat
                if tr is not None:
                    t_b1 = tr.now()
                    tr.span(
                        "beat", t0=t_b0, t1=t_b1, launch=launch_no,
                        cls=str(key), beat=beat,
                        windows=self.beat_windows,
                        fetch_s=round(t_b1 - t_f0, 6),
                        lanes=[{"lane": i, "rid": r.rid,
                                "now_ns": int(sums[i]["now_ns"])}
                               for i, r in enumerate(reqs)])
                if self._watchdog is not None:
                    self._watchdog.pet(beat=beats_done,
                                       launch=launch_no)
                with self._cond:
                    for i, r in enumerate(reqs):
                        rec = self._results[r.rid]
                        rec["progress"] = sums[i]
                if deadline_at:
                    now = self._clock()
                    for i, r in enumerate(reqs):
                        if (i not in timed_out
                                and sums[i]["now_ns"] < r.stop_ns
                                and i in deadline_at
                                and now >= deadline_at[i]):
                            timed_out.add(i)
                            if tr is not None:
                                tr.event("deadline_exceeded", t=now,
                                         rid=r.rid, cls=str(key),
                                         launch=launch_no,
                                         beat=beats_done,
                                         deadline_ms=r.deadline_ms)
                if all(i in timed_out or sums[i]["now_ns"] >= r.stop_ns
                       for i, r in enumerate(reqs)):
                    break
                if snap_on and beats_done % self.snapshot_beats == 0:
                    t_s0 = tr.now() if tr is not None else 0.0
                    self._write_snapshot(key, reqs, st, beats_done,
                                         stops, path=snap_path)
                    if tr is not None:
                        tr.span("snapshot", t0=t_s0, t1=tr.now(),
                                launch=launch_no, cls=str(key),
                                beats_done=beats_done)
            # one confirming step: a lane whose last REAL window landed
            # exactly on its stop has not yet run the done-branch
            # exchange flush (the fused run's epilogue); this step fires
            # it for every lane (idempotent for lanes already done) so
            # the harvested summaries equal the fused solo run's
            # state_summary bit-for-bit
            t_c0 = tr.now() if tr is not None else 0.0
            st = fleet.step_window(st, stops, binds=binds)
            _, bundle = entry.harvest.extract(st, full=False)
            sums = entry.harvest.lane_summaries_from(
                entry.harvest.fetch(bundle))
        finally:
            if self._watchdog is not None:
                self._watchdog.disarm()
        done_t = self._clock()
        if tr is not None:
            # confirm: the epilogue step + final harvest through result
            # delivery — the last tile of every rider's wall timeline
            tr.span("confirm", t0=t_c0, t1=done_t, launch=launch_no,
                    cls=str(key), rids=[r.rid for r in reqs])
        n_done = 0
        with self._cond:
            for i, r in enumerate(reqs):
                wall_s = done_t - self._submit_t.pop(r.rid, done_t)
                if i in timed_out:
                    self._results[r.rid] = {
                        "request_id": r.rid, "status": "timeout",
                        "partial_summary": sums[i],
                        "deadline_ms": r.deadline_ms,
                        "model": r.model, "seed": r.seed,
                        "stop_ns": r.stop_ns, "class": str(key),
                        "lane": i, "lanes_packed": R,
                        "launch": launch_no,
                        "wall_ms": round(wall_s * 1e3, 3),
                    }
                    self._note_terminal_locked(r.rid)
                    if tr is not None:
                        tr.event("result", t=done_t, rid=r.rid,
                                 cls=str(key), status="timeout",
                                 launch=launch_no, lane=i,
                                 wall_ms=round(wall_s * 1e3, 3))
                    continue
                n_done += 1
                rec = {
                    "request_id": r.rid, "status": "done",
                    "summary": sums[i],
                    "model": r.model, "seed": r.seed,
                    "stop_ns": r.stop_ns, "class": str(key), "lane": i,
                    "lanes_packed": R, "launch": launch_no,
                    "cache_hit": cache_hit,
                    "wall_ms": round(wall_s * 1e3, 3),
                }
                if resumed_from is not None:
                    rec["resumed_from_beat"] = resumed_from
                    rec["beats"] = beats_done
                self._results[r.rid] = rec
                self._note_terminal_locked(r.rid)
                if tr is not None:
                    tr.event("result", t=done_t, rid=r.rid,
                             cls=str(key), status="done",
                             launch=launch_no, lane=i,
                             cache_hit=cache_hit,
                             wall_ms=rec["wall_ms"])
                self.metrics.observe_latency_ns(int(wall_s * 1e9))
            self._evict_results_locked()
        if timed_out:
            self.metrics.inc("serve_timeouts", len(timed_out))
        self.metrics.inc("serve_results", n_done)
        if snap_on:
            self._clear_snapshot(snap_path)
