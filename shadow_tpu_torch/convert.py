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
        if dataclasses.is_dataclass(v):
            _leaves(v, key + ".", out)
        else:
            out[key] = v.detach().cpu().numpy()
    return out


def engine_state_to_numpy(state: EngineState) -> dict[str, np.ndarray]:
    """Every tensor of `state` as a numpy array, keyed by field path."""
    return _leaves(state, "", {})


def engine_state_from_numpy(leaves: dict[str, np.ndarray],
                            device) -> EngineState:
    """Build an EngineState on `device` from leaves keyed by field path
    (hosts are PHOLD's, the one model ported)."""
    nested = {"queues": EventQueue, "hosts": PholdHost, "stats": Stats}
    used = set()

    def tensor(key):
        used.add(key)
        return torch.from_numpy(np.array(leaves[key], order="C")).to(device)

    def build(cls, prefix):
        return cls(**{
            f.name: (build(nested[f.name], f"{f.name}.")
                     if cls is EngineState and f.name in nested
                     else tensor(prefix + f.name))
            for f in dataclasses.fields(cls)
        })

    state = build(EngineState, "")
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
