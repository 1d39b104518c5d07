"""Carry an EngineState between this package and numpy leaves.

Leaves are keyed by field path ("now", "queues.time",
"hosts.n_received", "stats.n_by_kind", "hosts.app.subs.0.gid", ...),
the same paths the reference's EngineState pytree has (a tuple element
is keyed by its index); a queue's spill ring appears as
"queues.spill.*", the trace ring as "trace.*", a sharded state's
exchange buffer as "xchg.bucket.*" and "xchg.sent_min" and the stats
plane as "splane.*" when they are on. So a state can move between the
reference and this package leaf for leaf, and `leaves_digest` gives both
the same fingerprint. A fleet state (`runtime.fleet`) moves the same
way with every leaf led by the lane axis (`fleet_state_to_numpy`,
`fleet_state_from_numpy`), as the reference's vmapped fleet holds it.
A reference GraphNetwork's routing tables come over as numpy arrays
through `GraphNetwork.from_numpy`.

The leaves come in the reference's pytree flatten order (the dataclass
fields in declaration order, depth first, a None field contributing
none), and `keystr` turns a key into the reference's
`jax.tree_util.keystr` of that path (".hosts.app.subs[0].gid" for
"hosts.app.subs.0.gid"): the leaf table of a checkpoint
(`utils/checkpoint.py`) is written in that order under those names, as
the reference writes it.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from shadow_tpu_torch.core.engine import EngineState, ExchangeBuf, Stats
from shadow_tpu_torch.core.events import EventQueue, Events, SpillRing
from shadow_tpu_torch.models.phold import PholdHost
from shadow_tpu_torch.obs.stats import StatPlane
from shadow_tpu_torch.obs.trace import TraceRing


def _walk(obj, prefix: str, out: list) -> list:
    for f in dataclasses.fields(obj):
        _walk_leaf(getattr(obj, f.name), f"{prefix}{f.name}",
                   bool(f.metadata.get("u64")), out)
    return out


def _walk_leaf(v, key: str, u64: bool, out: list) -> None:
    if v is None:
        return  # an absent subtree (HostNet.tcb), as in a pytree
    if dataclasses.is_dataclass(v):
        _walk(v, key + ".", out)
    elif isinstance(v, tuple):
        for i, item in enumerate(v):
            _walk_leaf(item, f"{key}.{i}", u64, out)
    else:
        out.append((key, v, u64))


def state_tensors(state) -> list[tuple[str, torch.Tensor, bool]]:
    """(key, tensor, holds u64 bits) for every leaf of `state`, in the
    reference's flatten order."""
    return _walk(state, "", [])


def numpy_dtype(t: torch.Tensor, u64: bool = False) -> np.dtype:
    """The numpy dtype of a leaf as `engine_state_to_numpy` gives it."""
    if u64:
        return np.dtype(np.uint64)
    return torch.empty((), dtype=t.dtype).numpy().dtype


def _leaves(obj, prefix: str, out: dict) -> dict:
    """Every tensor under the dataclass `obj` into `out` as numpy, keyed
    by field path after `prefix`, in the reference's flatten order."""
    for key, t, u64 in _walk(obj, prefix, []):
        a = t.detach().cpu().numpy()
        out[key] = a.view(np.uint64) if u64 else a
    return out


def engine_state_to_numpy(state: EngineState) -> dict[str, np.ndarray]:
    """Every tensor of `state` as a numpy array, keyed by field path, in
    the reference's flatten order."""
    return _leaves(state, "", {})


def keystr(key: str) -> str:
    """A leaf key as the reference's `jax.tree_util.keystr` of that
    path: a field is ".name", a tuple index "[i]"."""
    return "".join(f"[{p}]" if p.isdigit() else f".{p}"
                   for p in key.split("."))


def key_of(path: str) -> str:
    """The inverse of `keystr`: ".hosts.app.subs[0].gid" ->
    "hosts.app.subs.0.gid"."""
    return path.replace("[", ".").replace("]", "").lstrip(".")


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
        if name == "xchg":
            if "xchg.sent_min" not in leaves:
                return None
            return ExchangeBuf(bucket=build(Events, "xchg.bucket."),
                               sent_min=tensor("xchg.sent_min"))
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


def fleet_state_to_numpy(state: EngineState) -> dict[str, np.ndarray]:
    """A fleet state's leaves (`runtime.fleet`) as the reference's fleet
    pytree has them: every leaf led by the lane axis, per-host leaves
    [L, H, ...] and the solo scalars [L]. `lane_of` takes one lane."""
    from shadow_tpu_torch.runtime.fleet import lane_view

    return engine_state_to_numpy(lane_view(state))


def fleet_state_from_numpy(leaves: dict[str, np.ndarray], device,
                           hosts=PholdHost) -> EngineState:
    """The inverse of `fleet_state_to_numpy`: a fleet state on `device`
    from [L, ...] leaves (a reference fleet's, for instance)."""
    from shadow_tpu_torch.runtime.fleet import LANE_LEAVES

    rows = {k: (a if k in LANE_LEAVES
                else np.asarray(a).reshape((-1,) + np.shape(a)[2:]))
            for k, a in leaves.items()}
    return engine_state_from_numpy(rows, device, hosts)


def lane_of(leaves: dict[str, np.ndarray], lane: int
            ) -> dict[str, np.ndarray]:
    """Lane `lane` of [L, ...] fleet leaves: a solo state's leaves."""
    return {k: np.asarray(a)[lane] for k, a in leaves.items()}


def shard_leaves(leaves: dict[str, np.ndarray], rank: int,
                 n_shards: int) -> dict[str, np.ndarray]:
    """Rank `rank`'s shard of a global state's leaves (a reference run's
    state on an n_shards mesh, as `engine_state_to_numpy` keys them):
    the block of rows of every per-host leaf and of the exchange
    buffer's leaves, the replicated scalars whole. Per-host leaves are
    those whose leading dim is the queues' host count, as the
    reference's `state_specs` shards them."""
    hg = leaves["queues.time"].shape[0]
    per = hg // n_shards
    out = {}
    for key, a in leaves.items():
        if key.startswith("xchg."):
            n = a.shape[0] // n_shards
            a = a[rank * n:(rank + 1) * n]
        elif a.ndim >= 1 and a.shape[0] == hg:
            a = a[rank * per:(rank + 1) * per]
        out[key] = a
    return out


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
