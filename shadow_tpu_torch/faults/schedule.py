"""Deterministic fault-injection schedules compiled to dense tensors.

The counterpart of `shadow_tpu.faults.schedule`, with the same
compiler. A declarative schedule of `FaultSpec`s (host crash and
restart, churn cycles, link loss spikes, latency inflation, partitions,
bandwidth throttling) compiles host-side, at build time, into dense
time-indexed tensors the engine reads inside its window loop: a per-host
`alive[T, H]` mask gates event execution, and a small `[T, G, G]` group
overlay rides the routing lookup.

Determinism: random host selection and churn phases draw from the named
fault stream (`core.rng.fault_stream_uniform`), which folds only (seed,
spec index, host gid); per-packet fault drops roll lane offset 2K of the
per-event route key the reliability and jitter rolls use; epoch
boundaries are global sim times.
"""

from __future__ import annotations

import dataclasses
import math
from fnmatch import fnmatchcase

import numpy as np
import torch

from shadow_tpu_torch.core import rng as srng
from shadow_tpu_torch.core.timebase import SECOND

HOST_FAULTS = ("crash", "churn", "bandwidth")
LINK_FAULTS = ("loss", "latency", "partition")
FAULT_TYPES = HOST_FAULTS + LINK_FAULTS

# milli-fixed-point unit for latency scaling (1000 = 1.0x)
LAT_UNIT = 1000


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One declarative fault. Times are seconds of simulation time.

    type:
      crash      — hosts matching `hosts` are down in [start, end);
                   end=None means they never come back.
      churn      — each selected host cycles down for `downtime` seconds
                   every `period` seconds within [start, end), with a
                   per-host random phase from the named fault stream.
      bandwidth  — NIC rates of matching hosts scale by `factor`.
      loss       — matching (src, dst) pairs drop an extra `loss`
                   fraction of packets (on top of topology reliability).
      latency    — matching pairs' path latency scales by `factor`
                   (the window-barrier clamp keeps any value causal).
      partition  — matching pairs drop everything (loss=1).

    `hosts`/`src`/`dst` are space-separated fnmatch globs over host
    names. Link faults apply symmetrically (src<->dst). `frac`
    subsamples the matched host set deterministically (crash/churn).
    """

    type: str
    hosts: str = "*"
    src: str = "*"
    dst: str = "*"
    start: float = 0.0
    end: float | None = None
    loss: float = 0.0
    factor: float = 1.0
    frac: float = 1.0
    period: float = 0.0
    downtime: float = 0.0
    restart: bool = True

    def __post_init__(self):
        if self.type not in FAULT_TYPES:
            raise ValueError(
                f"unknown fault type {self.type!r}; one of {FAULT_TYPES}"
            )
        if self.end is not None and self.end <= self.start:
            raise ValueError(f"fault end {self.end} <= start {self.start}")
        if self.type == "churn":
            if self.end is None:
                raise ValueError("churn faults need an explicit end=")
            if self.period <= 0 or self.downtime <= 0:
                raise ValueError("churn needs period > 0 and downtime > 0")
            if self.downtime >= self.period:
                raise ValueError("churn downtime must be < period")
        if not 0.0 <= self.loss <= 1.0:
            raise ValueError(f"loss must be in [0, 1], got {self.loss}")
        if self.factor < 0:
            raise ValueError(f"factor must be >= 0, got {self.factor}")


_BOOL = {"true": True, "1": True, "yes": True,
         "false": False, "0": False, "no": False}


def parse_fault_attrs(attrs: dict) -> FaultSpec:
    """Build a FaultSpec from string attrs (XML element or CLI DSL)."""
    kw: dict = {}
    for key, val in attrs.items():
        k = key.replace("-", "_")
        if k in ("type", "hosts", "src", "dst"):
            kw[k] = val
        elif k in ("start", "end", "loss", "factor", "frac", "period",
                   "downtime"):
            kw[k] = float(val)
        elif k == "restart":
            kw[k] = _BOOL[val.strip().lower()]
        else:
            raise ValueError(f"unknown fault attribute {key!r}")
    if "type" not in kw:
        raise ValueError("fault needs a type= attribute")
    return FaultSpec(**kw)


def parse_fault_dsl(text: str) -> FaultSpec:
    """CLI form: 'TYPE key=value ...', e.g.
    'crash hosts=relay* start=30 end=45' or
    'churn hosts=guard* start=10 end=60 period=20 downtime=5 frac=0.2'."""
    parts = text.split()
    if not parts:
        raise ValueError("empty --fault")
    attrs = {"type": parts[0]}
    for tok in parts[1:]:
        if "=" not in tok:
            raise ValueError(f"--fault token {tok!r} is not key=value")
        k, v = tok.split("=", 1)
        attrs[k] = v
    return parse_fault_attrs(attrs)


def _match_mask(pattern: str, names: list[str], n_hosts: int) -> np.ndarray:
    """bool[n_hosts] of hosts whose NAME matches any glob in `pattern`.
    Padded rows (gid >= len(names)) never match — they stay inert."""
    pats = (pattern or "*").split()
    m = np.zeros((n_hosts,), bool)
    for i, nm in enumerate(names[:n_hosts]):
        m[i] = bool(nm) and any(fnmatchcase(nm, p) for p in pats)
    return m


# far-future sentinel for end=None intervals (never a real boundary)
_T_INF = np.iinfo(np.int64).max // 4


@dataclasses.dataclass(frozen=True)
class CompiledFaults:
    """The dense form of a fault schedule, on one device.

    Time is partitioned into T epochs at `times` (ns, sorted, times[0]=0;
    epoch e covers [times[e], times[e+1])). Hosts with identical link-
    fault membership share one of G fault groups, so the per-pair overlay
    is a [T, G, G] table instead of [T, H, H].

    These tensors are schedule, not state; the only state is the
    engine's `fault_epoch` watermark (an i32 scalar in EngineState).
    """

    times: torch.Tensor  # i64[T] epoch start times, ns
    alive: torch.Tensor  # bool[T, Hg] host liveness per epoch
    fgrp: torch.Tensor  # i32[Hg] link-fault group of each host
    lat_milli: torch.Tensor  # i64[T, G, G] latency scale, LAT_UNIT = 1x
    passp: torch.Tensor  # f32[T, G, G] pass probability (0 = partition)
    bw_scale: torch.Tensor  # f32[T, Hg] NIC rate scale
    has_crash: bool
    has_link: bool
    has_bw: bool
    # host-side copies: the engine's epoch test, downtime accounting
    np_times: np.ndarray
    np_alive: np.ndarray

    @property
    def n_epochs(self) -> int:
        return int(self.np_times.shape[0])

    def epoch_of(self, t: torch.Tensor) -> torch.Tensor:
        """i32 epoch index for time(s) t (any shape): the count of epoch
        starts <= t, less one (-1 below times[0])."""
        return (torch.searchsorted(self.times, t.contiguous(), right=True)
                - 1).to(torch.int32)

    def epoch_at_host(self, t_ns: int) -> int:
        """`epoch_of` for one host-side time."""
        return int(np.searchsorted(self.np_times, t_ns, side="right")) - 1

    # ---- host-side helpers (tracker / proc tier) ----
    def alive_at_host(self, t_ns: int) -> np.ndarray:
        """bool[Hg] liveness at one instant, computed host-side."""
        return self.np_alive[max(self.epoch_at_host(t_ns), 0)]

    def downtime_in(self, a_ns: int, b_ns: int) -> np.ndarray:
        """f64[Hg] seconds each host spent dead within [a_ns, b_ns)."""
        t = self.np_times
        out = np.zeros((self.np_alive.shape[1],), np.float64)
        for e in range(len(t)):
            lo = max(int(t[e]), a_ns)
            hi = min(int(t[e + 1]) if e + 1 < len(t) else b_ns, b_ns)
            if hi <= lo:
                continue
            out += np.where(self.np_alive[e], 0.0, (hi - lo) / SECOND)
        return out

    def transitions_in(self, a_ns: int, b_ns: int):
        """Host-side (t_ns, gid, up: bool) liveness flips in (a_ns, b_ns]."""
        t = self.np_times
        out = []
        for e in range(1, len(t)):
            te = int(t[e])
            if not a_ns < te <= b_ns:
                continue
            flip = self.np_alive[e] != self.np_alive[e - 1]
            for g in np.nonzero(flip)[0]:
                out.append((te, int(g), bool(self.np_alive[e][g])))
        return out


def compile_faults(specs, names, n_hosts: int, seed: int, *,
                   device) -> CompiledFaults:
    """Compile FaultSpecs into a CompiledFaults over `n_hosts` rows on
    `device` (names may be shorter when shape-bucket padding widened the
    arrays; padded rows stay alive/unscaled forever). The selection and
    phase draws run on the CPU whatever the device."""
    specs = tuple(specs)
    names = list(names)

    def s2ns(s: float | None) -> int:
        return _T_INF if s is None else max(int(round(s * SECOND)), 0)

    def draws(stream: int) -> np.ndarray:
        # f32[n_hosts], as numpy: the arithmetic below stays float32
        return srng.fault_stream_uniform(seed, stream, n_hosts,
                                         "cpu").numpy()

    # ---- per-host down intervals + selection draws --------------------
    down: list[tuple[int, int, int]] = []  # (gid, a_ns, b_ns)
    bw_specs: list[tuple[np.ndarray, int, int, float]] = []
    link_specs: list[tuple[int, FaultSpec, np.ndarray, np.ndarray]] = []
    for si, sp in enumerate(specs):
        if sp.type in LINK_FAULTS:
            link_specs.append((
                si, sp,
                _match_mask(sp.src, names, n_hosts),
                _match_mask(sp.dst, names, n_hosts),
            ))
            continue
        m = _match_mask(sp.hosts, names, n_hosts)
        if sp.type == "bandwidth":
            bw_specs.append((m, s2ns(sp.start), s2ns(sp.end), sp.factor))
            continue
        if sp.frac < 1.0:
            m = m & (draws(si << 8) < sp.frac)
        a, b = s2ns(sp.start), s2ns(sp.end)
        if sp.type == "crash":
            for g in np.nonzero(m)[0]:
                down.append((int(g), a, b if sp.restart else _T_INF))
        else:  # churn
            # f32 draws times a Python float stay f32 (NumPy 2); the
            # product then scales to ns in f64, as the reference's does
            phase = draws((si << 8) | 1) * sp.period
            p_ns = int(round(sp.period * SECOND))
            d_ns = int(round(sp.downtime * SECOND))
            for g in np.nonzero(m)[0]:
                t0 = a + int(round(float(phase[g]) * SECOND))
                while t0 < b:
                    down.append((int(g), t0, min(t0 + d_ns, b)))
                    t0 += p_ns

    # ---- epoch boundary set -------------------------------------------
    bounds = {0}
    for _g, a, b in down:
        bounds.add(a)
        if b < _T_INF:
            bounds.add(b)
    for _m, a, b, _f in bw_specs:
        bounds.add(a)
        if b < _T_INF:
            bounds.add(b)
    for _si, sp, _ms, _md in link_specs:
        bounds.add(s2ns(sp.start))
        e = s2ns(sp.end)
        if e < _T_INF:
            bounds.add(e)
    times = np.array(sorted(b for b in bounds if b < _T_INF), np.int64)
    T = len(times)

    alive = np.ones((T, n_hosts), bool)
    for g, a, b in down:
        alive[(times >= a) & (times < b), g] = False

    bw = np.ones((T, n_hosts), np.float32)
    for m, a, b, f in bw_specs:
        for e in np.nonzero((times >= a) & (times < b))[0]:
            bw[e, m] *= f

    # ---- link groups: hosts with identical fault membership share one
    # group, so the per-pair overlay stays [T, G, G]-small ---------------
    sigs = np.zeros((n_hosts,), np.int64)
    for j, (_si, _sp, ms, md) in enumerate(link_specs):
        sigs |= ms.astype(np.int64) << (2 * j)
        sigs |= md.astype(np.int64) << (2 * j + 1)
    uniq, fgrp = np.unique(sigs, return_inverse=True)
    G = len(uniq)
    lat = np.full((T, G, G), LAT_UNIT, np.int64)
    passp = np.ones((T, G, G), np.float32)
    for j, (_si, sp, _ms, _md) in enumerate(link_specs):
        in_s = (uniq >> (2 * j)) & 1
        in_d = (uniq >> (2 * j + 1)) & 1
        # symmetric: the pair is affected when either direction matches
        pair = (
            (in_s[:, None] & in_d[None, :])
            | (in_d[:, None] & in_s[None, :])
        ).astype(bool)
        active = (times >= s2ns(sp.start)) & (times < s2ns(sp.end))
        for e in np.nonzero(active)[0]:
            if sp.type == "latency":
                lat[e][pair] = np.maximum(
                    (lat[e][pair].astype(np.float64) * sp.factor), 0
                ).astype(np.int64)
            elif sp.type == "loss":
                passp[e][pair] *= np.float32(1.0 - sp.loss)
            else:  # partition
                passp[e][pair] = 0.0

    if not math.isfinite(float(passp.min())):  # pragma: no cover
        raise AssertionError("non-finite pass probability")

    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return CompiledFaults(
        times=on(times),
        alive=on(alive),
        fgrp=on(fgrp.astype(np.int32)),
        lat_milli=on(lat),
        passp=on(passp),
        bw_scale=on(bw),
        has_crash=bool((~alive).any()),
        has_link=bool(
            (lat != LAT_UNIT).any() or (passp != 1.0).any()
        ),
        has_bw=bool((bw != 1.0).any()),
        np_times=times,
        np_alive=alive,
    )
