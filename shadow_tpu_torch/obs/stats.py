"""StatPlane: device-side streaming histograms of sim-time behaviour.

The counterpart of `shadow_tpu.obs.stats`: one fixed-bucket log2
histogram per family, as [H]-leading device tensors that the engine
updates inside the window loop when `EngineConfig.stats > 0`, on all
three drains.

- wait: sim time between an event's enqueue and its execution (ns);
- net: send-to-execution latency of delivered network packets (ns);
- occ: events executed per host per window (hosts with work);
- qfill: a host's queue fill when its frontier dumps (or pops);
- runlen: positions a host executed per frontier-drain round.

Buckets (NB = 64 per family): bucket 0 holds v <= 0, bucket i (1..62)
holds 2^(i-1) <= v <= 2^i - 1, bucket 63 is the overflow (v >= 2^62).
The index is the bit length of v, `sum(v >= 2^i for i in 0..62)`: 63
compares, no gather. Accumulation is a one-hot masked sum. The host-side
helpers (`percentile`, `summarize`, `stats_row`, `parse_hist`) are plain
numpy, as in the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

NB = 64  # buckets per family
_N_POWERS = NB - 1  # compare ladder 2^0 .. 2^62

# family key -> (OpenMetrics family name, help text), in report order
FAMILIES = (
    ("wait", "event_wait_ns",
     "sim-time between event enqueue and execution (ns)"),
    ("net", "net_latency_ns",
     "send->exec network latency of delivered packets (ns)"),
    ("occ", "window_events_per_host",
     "events executed per host per window (hosts with work)"),
    ("qfill", "queue_fill_at_pop",
     "per-host event-queue fill at frontier dump"),
    ("runlen", "frontier_run_len",
     "frontier-drain run length (positions per round)"),
)
FAMILY_KEYS = tuple(k for k, _, _ in FAMILIES)

# `le` upper bound of each bucket: 0, 1, 3, 7, ..., 2^62 - 1, +Inf
BUCKET_LE = tuple((1 << i) - 1 for i in range(NB - 1)) + (float("inf"),)
BUCKET_LE_LABELS = tuple(
    "+Inf" if le == float("inf") else str(le) for le in BUCKET_LE)

# a heartbeat [stats] row's columns; `hist` is the sparse bucket spec,
# "idx:count" pairs joined by "|"
STATS_HEADER = "t_s," + ",".join(
    f"{k}_count,{k}_sum,{k}_p50,{k}_p95,{k}_hist" for k in FAMILY_KEYS)

_powers: dict = {}


def _power_ladder(device) -> torch.Tensor:
    """i64 [2^0 .. 2^62] on `device`, made there once."""
    key = str(device)
    if key not in _powers:
        _powers[key] = torch.bitwise_left_shift(
            torch.ones(_N_POWERS, dtype=torch.int64, device=device),
            torch.arange(_N_POWERS, dtype=torch.int64, device=device))
    return _powers[key]


def bucket_of(v: torch.Tensor) -> torch.Tensor:
    """Bucket index (i32) of i64 values, elementwise over any shape: the
    bit length of v, clipped into [0, NB - 1]."""
    return torch.sum(v[..., None] >= _power_ladder(v.device), dim=-1,
                     dtype=torch.int32)


@dataclasses.dataclass(frozen=True)
class StatPlane:
    """Histogram state: counts i64[H, NB] and value sum i64[H] per
    family; a family's sample count is the sum of its buckets."""

    wait_n: torch.Tensor  # i64[H, NB]
    wait_s: torch.Tensor  # i64[H]
    net_n: torch.Tensor
    net_s: torch.Tensor
    occ_n: torch.Tensor
    occ_s: torch.Tensor
    qfill_n: torch.Tensor
    qfill_s: torch.Tensor
    runlen_n: torch.Tensor
    runlen_s: torch.Tensor

    @staticmethod
    def create(n_hosts: int, *, device) -> "StatPlane":
        n = lambda: torch.zeros((n_hosts, NB), dtype=torch.int64,
                                device=device)
        s = lambda: torch.zeros((n_hosts,), dtype=torch.int64,
                                device=device)
        return StatPlane(n(), s(), n(), s(), n(), s(), n(), s(), n(), s())

    def observe(self, family: str, values: torch.Tensor,
                mask: torch.Tensor) -> "StatPlane":
        """Fold a batch of samples into one family: `values` [H] or
        [H, ...] (cast to i64), `mask` the same shape; masked-out lanes
        add nothing."""
        h = values.shape[0]
        v = values.reshape(h, -1).to(torch.int64)
        m = mask.reshape(h, -1)
        idx = bucket_of(v)  # [H, M]
        onehot = ((idx[:, :, None] == torch.arange(
            NB, dtype=torch.int32, device=v.device)) & m[:, :, None])
        cnts = getattr(self, family + "_n") + torch.sum(
            onehot, dim=1, dtype=torch.int64)
        sums = getattr(self, family + "_s") + torch.sum(
            torch.where(m, v, 0), dim=1, dtype=torch.int64)
        return dataclasses.replace(
            self, **{family + "_n": cnts, family + "_s": sums})


def stats_device_refs(splane: StatPlane) -> dict:
    """The global (host-summed) histograms, reduced on the device: per
    family a [NB] bucket vector and a 0-d value sum."""
    return {
        **{f"{k}_bucket": getattr(splane, k + "_n").sum(dim=0)
           for k in FAMILY_KEYS},
        **{f"{k}_sum": getattr(splane, k + "_s").sum()
           for k in FAMILY_KEYS},
    }


def percentile(buckets: np.ndarray, q: float) -> float:
    """Approximate q-quantile (q in [0, 1]) from a [NB] count vector: the
    `le` bound of the bucket where the cumulative count first reaches
    q * total; 0.0 when empty, 2^63 for the overflow bucket."""
    b = np.asarray(buckets, np.int64)
    total = int(b.sum())
    if total <= 0:
        return 0.0
    cum = np.cumsum(b)
    i = min(int(np.searchsorted(cum, q * total)), NB - 1)
    le = BUCKET_LE[i]
    return float(1 << 63) if le == float("inf") else float(le)


def summarize(fetched: dict) -> dict:
    """Per-family count, sum, mean, p50, p95 and sparse bucket list of a
    fetched `stats_device_refs` dict (numpy or tensors)."""
    out = {}
    for k in FAMILY_KEYS:
        b = np.asarray(fetched[f"{k}_bucket"], np.int64)
        s = int(np.asarray(fetched[f"{k}_sum"]))
        n = int(b.sum())
        nz = np.nonzero(b)[0]
        out[k] = {
            "count": n,
            "sum": s,
            "mean": (s / n) if n else 0.0,
            "p50": percentile(b, 0.50),
            "p95": percentile(b, 0.95),
            "buckets": [(int(i), int(b[i])) for i in nz],
        }
    return out


def stats_row(t_s: float, summary: dict) -> str:
    """One `[stats]` CSV row (see STATS_HEADER) from a `summarize`
    result."""
    cells = [f"{t_s:.3f}"]
    for k in FAMILY_KEYS:
        f = summary[k]
        hist = "|".join(f"{i}:{c}" for i, c in f["buckets"])
        cells += [str(f["count"]), str(f["sum"]),
                  f"{f['p50']:.0f}", f"{f['p95']:.0f}", hist]
    return ",".join(cells)


def parse_hist(cell: str) -> np.ndarray:
    """Rebuild a [NB] bucket vector from a `{fam}_hist` CSV cell."""
    b = np.zeros((NB,), np.int64)
    if cell:
        for pair in cell.split("|"):
            i, c = pair.split(":")
            b[int(i)] = int(c)
    return b
