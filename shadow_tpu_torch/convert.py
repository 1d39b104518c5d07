"""Carry an EngineState between this package and numpy leaves.

Leaves are keyed by field path ("now", "queues.time",
"hosts.n_received", "stats.n_by_kind", "hosts.app.subs.0.gid", ...),
the same paths the reference's EngineState pytree has (a tuple element
is keyed by its index), with no exchange subtree; a queue's spill ring
appears as "queues.spill.*", the trace ring as "trace.*" and the stats
plane as "splane.*" when they are on. So a state can move between the
reference and this package leaf for leaf, and `leaves_digest` gives both
the same fingerprint. A reference GraphNetwork's routing tables come over
as numpy arrays through `GraphNetwork.from_numpy`.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from shadow_tpu_torch.core.engine import EngineState, Stats
from shadow_tpu_torch.core.events import EventQueue, SpillRing
from shadow_tpu_torch.models.phold import PholdHost
from shadow_tpu_torch.obs.stats import StatPlane
from shadow_tpu_torch.obs.trace import TraceRing


def _leaves(obj, prefix: str, out: dict) -> dict:
    for f in dataclasses.fields(obj):
        _leaf(getattr(obj, f.name), f"{prefix}{f.name}",
              f.metadata.get("u64"), out)
    return out


def _leaf(v, key: str, u64, out: dict) -> None:
    if v is None:
        return  # an absent subtree (HostNet.tcb), as in a pytree
    if dataclasses.is_dataclass(v):
        _leaves(v, key + ".", out)
    elif isinstance(v, tuple):
        for i, item in enumerate(v):
            _leaf(item, f"{key}.{i}", u64, out)
    else:
        a = v.detach().cpu().numpy()
        out[key] = a.view(np.uint64) if u64 else a


def engine_state_to_numpy(state: EngineState) -> dict[str, np.ndarray]:
    """Every tensor of `state` as a numpy array, keyed by field path."""
    return _leaves(state, "", {})


def engine_state_from_numpy(leaves: dict[str, np.ndarray], device,
                            hosts=PholdHost) -> EngineState:
    """Build an EngineState on `device` from leaves keyed by field path.

    `hosts` gives the shape of the host state: a dataclass whose fields
    are all tensors (PHOLD's `PholdHost`, the default), or a template
    instance, whose nested dataclasses and tuples are followed and whose
    None fields stay None (a `SimHost`, for instance). The queues carry
    a spill ring iff the leaves hold one.
    """
    used = set()

    def tensor(key):
        used.add(key)
        a = np.array(leaves[key], order="C")
        if a.dtype == np.uint64:
            a = a.view(np.int64)
        return torch.from_numpy(a).to(device)

    def build(template, prefix):
        if isinstance(template, type):  # a flat dataclass of tensors
            return template(**{f.name: tensor(prefix + f.name)
                               for f in dataclasses.fields(template)})
        return type(template)(**{
            f.name: value(getattr(template, f.name), prefix + f.name)
            for f in dataclasses.fields(template)})

    def value(sub, key):
        if sub is None:
            return None
        if dataclasses.is_dataclass(sub):
            return build(sub, key + ".")
        if isinstance(sub, tuple):
            return tuple(value(x, f"{key}.{i}") for i, x in enumerate(sub))
        return tensor(key)

    spill = (build(SpillRing, "queues.spill.")
             if "queues.spill.time" in leaves else None)
    queues = EventQueue(spill=spill, **{
        f.name: tensor("queues." + f.name)
        for f in dataclasses.fields(EventQueue) if f.name != "spill"})
    nested = {"hosts": hosts, "stats": Stats}
    # subtrees present only when the state has them
    optional = {"trace": (TraceRing, "trace.time"),
                "splane": (StatPlane, "splane.wait_n")}

    def field(name):
        if name == "queues":
            return queues
        if name in optional:
            cls, probe = optional[name]
            return build(cls, f"{name}.") if probe in leaves else None
        if name in nested:
            return build(nested[name], f"{name}.")
        return tensor(name)

    state = EngineState(**{f.name: field(f.name)
                           for f in dataclasses.fields(EngineState)})
    extra = set(leaves) - used
    if extra:
        raise ValueError(f"leaves this package has no field for: "
                         f"{sorted(extra)}")
    return state


def leaves_digest(leaves: dict[str, np.ndarray],
                  exclude: tuple[str, ...] = ()) -> str:
    """sha256 over every leaf in path order: name, dtype, shape, bytes.
    Leaves whose path is in `exclude` are left out (for instance the
    scheduler counters, which differ between the two drains)."""
    unknown = set(exclude) - set(leaves)
    if unknown:
        raise KeyError(f"no such leaves to exclude: {sorted(unknown)}")
    h = hashlib.sha256()
    for key in sorted(set(leaves) - set(exclude)):
        a = np.ascontiguousarray(leaves[key])
        h.update(f"{key}|{a.dtype.str}|{a.shape}|".encode())
        h.update(a.tobytes())
    return h.hexdigest()
