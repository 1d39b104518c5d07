"""Request schema, equivalence classes, and the fleet-lane packer: the
counterpart of `shadow_tpu.serve.packer`, with the same request fields,
class strings and packing order.

A scenario request is everything the fleet tier can vary per lane —
seed, fault schedule, latency/bandwidth scaling, stop time — plus the
static scenario shape (model + params) that picks its warm fleet.
`equivalence_class` maps a request to its `ClassKey`: requests with the
same key can share one built fleet; requests with different keys
cannot (that is the `check_lane_knobs` static-knob rule, plus the
fault-bind SHAPES, which a built fleet fixes: pow2-rounded so schedules
of similar size land in one class).

`LanePacker` is the RackSched-flavored batcher: per-class FIFO queues,
dispatch when a class fills `max_lanes` or its oldest request ages past
the pack deadline. Ordering is deterministic (submit sequence numbers,
not wall-clock ties): full classes first, then deadline-expired ones,
oldest head wins — so a replayed request stream packs identically.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict, deque
from typing import Any

from shadow_tpu_torch.core.timebase import SECOND
from shadow_tpu_torch.faults import FaultSpec, parse_fault_dsl


@dataclasses.dataclass(frozen=True)
class ScenarioRequest:
    """One validated scenario request (see `parse_request`)."""

    rid: str
    seq: int  # submit sequence number — the packer's deterministic order
    model: str
    params: tuple  # sorted (name, value) static scenario knobs
    seed: int
    stop_ns: int
    fault_dsl: tuple  # the DSL strings as submitted (for persist/replay)
    fault_specs: tuple  # parsed FaultSpec tuple
    latency_scale: float = 1.0
    bandwidth_scale: float = 1.0
    deadline_ms: float = 0.0  # 0 = no deadline (wall, from submit time)

    def doc(self) -> dict:
        """The re-submittable JSON form (drain persistence / replay)."""
        out = {
            "model": self.model,
            "params": dict(self.params),
            "seed": self.seed,
            "stop_ns": self.stop_ns,
            "faults": list(self.fault_dsl),
            "latency_scale": self.latency_scale,
            "bandwidth_scale": self.bandwidth_scale,
        }
        if self.deadline_ms:
            out["deadline_ms"] = self.deadline_ms
        return out


def parse_request(doc: dict, *, rid: str, seq: int) -> ScenarioRequest:
    """Validate a submit body into a ScenarioRequest; ValueError (with
    the field named) becomes the HTTP 400 body."""
    if not isinstance(doc, dict):
        raise ValueError("request body must be a JSON object")
    known = {"model", "params", "seed", "stop_s", "stop_ns", "faults",
             "latency_scale", "bandwidth_scale", "deadline_ms"}
    for k in doc:
        if k not in known:
            raise ValueError(
                f"unknown request field {k!r}; known fields are "
                f"{sorted(known)}"
            )
    model = doc.get("model", "phold")
    if not isinstance(model, str):
        raise ValueError("model must be a string")
    params = doc.get("params", {})
    if not isinstance(params, dict):
        raise ValueError("params must be an object of static knobs")
    for k, v in params.items():
        if not isinstance(v, (int, float, bool, str)):
            raise ValueError(
                f"params[{k!r}] must be a scalar, got {type(v).__name__}"
            )
    if "stop_ns" in doc:
        stop_ns = int(doc["stop_ns"])
    elif "stop_s" in doc:
        stop_ns = int(round(float(doc["stop_s"]) * SECOND))
    else:
        raise ValueError("request needs stop_s (seconds) or stop_ns")
    if stop_ns <= 0:
        raise ValueError(f"stop must be > 0, got {stop_ns} ns")
    fault_dsl = doc.get("faults", [])
    if isinstance(fault_dsl, str):
        fault_dsl = [fault_dsl]
    specs = []
    for f in fault_dsl:
        if isinstance(f, FaultSpec):
            raise ValueError("faults must be DSL strings, not specs")
        specs.append(parse_fault_dsl(str(f)))
    lat = float(doc.get("latency_scale", 1.0))
    if lat < 0:
        raise ValueError(f"latency_scale {lat} < 0")
    bw = float(doc.get("bandwidth_scale", 1.0))
    if bw <= 0:
        raise ValueError(f"bandwidth_scale {bw} <= 0")
    ddl = float(doc.get("deadline_ms", 0.0))
    if ddl < 0:
        raise ValueError(f"deadline_ms {ddl} < 0 (0 disables)")
    return ScenarioRequest(
        rid=rid, seq=seq, model=model,
        params=tuple(sorted(params.items())),
        seed=int(doc.get("seed", 0)), stop_ns=stop_ns,
        fault_dsl=tuple(str(f) for f in fault_dsl),
        fault_specs=tuple(specs),
        latency_scale=lat, bandwidth_scale=bw, deadline_ms=ddl,
    )


@dataclasses.dataclass(frozen=True)
class ClassKey:
    """Static-knob equivalence class of a request — the program-cache
    key. `fault_sig` is None for fault-free requests, else
    (epoch_pad, group_pad, (has_crash, has_link, has_bw)): the
    pow2-rounded fault-bind shape plus the fault-kind flags, both fixed
    when a class's fleet is built."""

    model: str
    params: tuple
    fault_sig: tuple | None = None

    def __str__(self):
        ps = ",".join(f"{k}={v}" for k, v in self.params)
        fs = ("none" if self.fault_sig is None else
              f"t{self.fault_sig[0]}g{self.fault_sig[1]}"
              + "".join("clb"[i] for i, f in enumerate(self.fault_sig[2])
                        if f))
        return f"{self.model}({ps})/faults:{fs}"


def _pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def fault_signature(specs: tuple, names: list, hg: int) -> tuple | None:
    """Compile a host-side probe of the fault schedule (on the CPU) to
    read the shapes/flags a built fleet fixes. Seed 0 on purpose: the
    signature must not depend on the per-lane seed (shapes never do —
    seeds only perturb churn phases, which are values)."""
    if not specs:
        return None
    from shadow_tpu_torch.faults.schedule import compile_faults

    comp = compile_faults(tuple(specs), names, hg, 0, device="cpu")
    flags = (comp.has_crash, comp.has_link, comp.has_bw)
    if not any(flags):
        # values-neutral schedule (e.g. globs matching no host): the
        # fleet binds no fault arrays, same as a fault-free request
        return None
    return (_pow2(comp.np_times.shape[0]),
            _pow2(int(comp.lat_milli.shape[1])), flags)


def equivalence_class(req: ScenarioRequest, names: list,
                      hg: int) -> ClassKey:
    """The request's program-cache key. Seeds, stop times, fault VALUES,
    and latency scale are launch inputs — never part of the key. The
    latency scale binds on every lane (scale 1.0 is integer-exact
    identity, pinned by the fleet tier), so it does not split classes;
    bandwidth scale is state-side and splits nothing either."""
    return ClassKey(
        model=req.model, params=req.params,
        fault_sig=fault_signature(req.fault_specs, names, hg),
    )


class LanePacker:
    """Deadline-or-full batcher of requests into fleet lanes.

    Thread-safe; `push` happens on HTTP handler threads, `ready`/`pop`
    on the launch worker. The condition variable lives in the service —
    this class only answers "what should launch now" and "how long may
    the worker sleep".
    """

    def __init__(self, max_lanes: int, deadline_s: float, *,
                 clock=time.monotonic):
        if max_lanes < 1:
            raise ValueError(f"max_lanes must be >= 1, got {max_lanes}")
        self.max_lanes = int(max_lanes)
        self.deadline_s = float(deadline_s)
        self._clock = clock
        self._q: "OrderedDict[Any, deque]" = OrderedDict()
        self._lock = threading.Lock()

    def push(self, key, req: ScenarioRequest) -> None:
        with self._lock:
            self._q.setdefault(key, deque()).append((req, self._clock()))

    def depth(self) -> int:
        with self._lock:
            return sum(len(d) for d in self._q.values())

    def _head_seq(self, key) -> int:
        return self._q[key][0][0].seq

    def ready(self, now: float | None = None):
        """The ClassKey that should launch now, or None. Full classes
        beat deadline-expired ones; ties break to the oldest head
        request (lowest submit seq) — fully deterministic."""
        now = self._clock() if now is None else now
        with self._lock:
            full = [k for k, d in self._q.items()
                    if len(d) >= self.max_lanes]
            if full:
                return min(full, key=self._head_seq)
            due = [k for k, d in self._q.items()
                   if now - d[0][1] >= self.deadline_s]
            if due:
                return min(due, key=self._head_seq)
            return None

    def next_timeout(self, now: float | None = None) -> float | None:
        """Seconds until the earliest pending deadline (>= 0), or None
        when the queue is empty — the worker's cond-wait bound."""
        now = self._clock() if now is None else now
        with self._lock:
            if not self._q:
                return None
            head = min(d[0][1] for d in self._q.values())
            return max(head + self.deadline_s - now, 0.0)

    def pop(self, key) -> list:
        """Up to max_lanes oldest requests of the class, FIFO."""
        with self._lock:
            d = self._q.get(key)
            if not d:
                return []
            out = [d.popleft()[0] for _ in range(min(len(d),
                                                     self.max_lanes))]
            if not d:
                del self._q[key]
            return out

    def drain_all(self) -> list:
        """Every pending request in submit order; empties the queue
        (the SIGTERM persist path)."""
        with self._lock:
            out = [r for d in self._q.values() for r, _ in d]
            self._q.clear()
        return sorted(out, key=lambda r: r.seq)

    def snapshot(self) -> dict:
        """GET /queue's packer view: per-class depth AND oldest-waiting
        age (head enqueue timestamp vs now) — degraded-mode triage
        reads which class is starving without needing the trace
        ledger."""
        now = self._clock()
        with self._lock:
            return {
                "depth": sum(len(d) for d in self._q.values()),
                "classes": {
                    str(k): {
                        "depth": len(d),
                        "oldest_wait_s": round(max(now - d[0][1], 0.0),
                                               3),
                    }
                    for k, d in self._q.items()
                },
                "max_lanes": self.max_lanes,
                "deadline_s": self.deadline_s,
            }
