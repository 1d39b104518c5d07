"""Carry an EngineState between this package and numpy leaves.

Leaves are keyed by field path ("now", "queues.time",
"hosts.n_received", "stats.n_by_kind", ...), the same paths the
reference's EngineState pytree has with its optional subtrees (trace,
exchange, stats plane, spill ring) off. So a state can move between the
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
from shadow_tpu_torch.core.events import EventQueue
from shadow_tpu_torch.models.phold import PholdHost


def _leaves(obj, prefix: str, out: dict) -> dict:
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        key = f"{prefix}{f.name}"
        if v is None:
            continue  # an absent subtree (HostNet.tcb), as in a pytree
        if dataclasses.is_dataclass(v):
            _leaves(v, key + ".", out)
        else:
            a = v.detach().cpu().numpy()
            out[key] = a.view(np.uint64) if f.metadata.get("u64") else a
    return out


def engine_state_to_numpy(state: EngineState) -> dict[str, np.ndarray]:
    """Every tensor of `state` as a numpy array, keyed by field path."""
    return _leaves(state, "", {})


def engine_state_from_numpy(leaves: dict[str, np.ndarray], device,
                            hosts=PholdHost) -> EngineState:
    """Build an EngineState on `device` from leaves keyed by field path.

    `hosts` gives the shape of the host state: a dataclass whose fields
    are all tensors (PHOLD's `PholdHost`, the default), or a template
    instance, whose nested dataclasses are followed and whose None
    fields stay None (a `SimHost`, for instance).
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
        kw = {}
        for f in dataclasses.fields(template):
            sub = getattr(template, f.name)
            if sub is None:
                kw[f.name] = None
            elif dataclasses.is_dataclass(sub):
                kw[f.name] = build(sub, f"{prefix}{f.name}.")
            else:
                kw[f.name] = tensor(prefix + f.name)
        return type(template)(**kw)

    nested = {"queues": EventQueue, "hosts": hosts, "stats": Stats}
    state = EngineState(**{
        f.name: (build(nested[f.name], f"{f.name}.") if f.name in nested
                 else tensor(f.name))
        for f in dataclasses.fields(EngineState)
    })
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
