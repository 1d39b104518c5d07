"""PHOLD: the classic parallel-DES benchmark.

The counterpart of `shadow_tpu.models.phold`, on either drain: the
chained one (`make_handler`, the default) or the batched one
(`make_batch_handler`, `batched=True`). On receiving a message a host
picks a random peer (uniform, or skewed to the first `hot_hosts` with
probability `hot_weight`) and sends it a new message after an
exponential service delay. Every draw comes from the event's threefry
key, so the run is bit-identical to the reference.
"""

from __future__ import annotations

import dataclasses

import torch

from shadow_tpu_torch.core import rng as srng
from shadow_tpu_torch.core.device import resolve_device
from shadow_tpu_torch.core.engine import (
    ConstantNetwork,
    Emit,
    Engine,
    EngineConfig,
)
from shadow_tpu_torch.core.events import Events
from shadow_tpu_torch.core.timebase import MILLISECOND, TIME_INVALID

KIND_MSG = 0

# PHOLD events carry no payload; one arg word keeps the queue sorts narrow.
N_PHOLD_ARGS = 1


@dataclasses.dataclass(frozen=True)
class PholdHost:
    n_received: torch.Tensor  # i64[H]

    @staticmethod
    def create(n_hosts: int, *, device) -> "PholdHost":
        return PholdHost(n_received=torch.zeros((n_hosts,), dtype=torch.int64,
                                                device=device))


def _make_draw(n_hosts_global, mean_delay_ns, hot_hosts, hot_weight):
    """The per-event (peer, delay) draw, elementwise over a key batch."""

    def draw(key):
        kp, kd, kh = srng.split(key, 3)
        peer = srng.randint(kp, 0, n_hosts_global)
        if hot_hosts > 0 and hot_weight > 0.0:
            hot = srng.bernoulli(kh, hot_weight)
            # folded sub-key, as the reference: reusing kp would
            # correlate the hot draw with the uniform one
            peer_hot = srng.randint(srng.fold_in(kp, 1), 0, hot_hosts)
            peer = torch.where(hot, peer_hot, peer)
        mean = torch.tensor(mean_delay_ns, dtype=torch.float32,
                            device=key.device)
        delay = (srng.exponential(kd) * mean).to(torch.int64)
        return peer, delay

    return draw


def make_handler(
    n_hosts_global: int,
    mean_delay_ns: int,
    hot_hosts: int = 0,
    hot_weight: float = 0.0,
):
    """PHOLD message handler for the chained drain: one event per host,
    on [H] tensors; the engine keeps the rows it ran."""

    draw = _make_draw(n_hosts_global, mean_delay_ns, hot_hosts, hot_weight)

    def on_msg(hs: PholdHost, ev: Events, keys: torch.Tensor):
        peer, delay = draw(keys)
        hs = PholdHost(n_received=hs.n_received + 1)
        return hs, Emit.single(dst=peer, dt=delay, kind=KIND_MSG,
                               n_args=N_PHOLD_ARGS)

    return on_msg


def make_batch_handler(
    n_hosts_global: int,
    mean_delay_ns: int,
    hot_hosts: int = 0,
    hot_weight: float = 0.0,
):
    """Whole-frontier PHOLD handler for the batched drain: executes every
    host's [B] below-barrier events in one call on [H, B] tensors."""

    draw = _make_draw(n_hosts_global, mean_delay_ns, hot_hosts, hot_weight)

    def on_msgs(hs: PholdHost, evs: Events, keys: torch.Tensor):
        valid = evs.time != TIME_INVALID  # [H, B]
        peers, delays = draw(keys)
        hs = PholdHost(n_received=hs.n_received
                       + torch.sum(valid, dim=1, dtype=torch.int64))
        h, b = valid.shape
        z = lambda *s, dtype: torch.zeros(s, dtype=dtype, device=keys.device)
        em = Emit(
            dst=peers[:, :, None],
            dt=delays[:, :, None],
            kind=torch.full((h, b, 1), KIND_MSG, dtype=torch.int32,
                            device=keys.device),
            args=z(h, b, 1, N_PHOLD_ARGS, dtype=torch.int32),
            mask=valid[:, :, None],
            local=z(h, b, 1, dtype=torch.bool),
        )
        return hs, em

    return on_msgs


def build(
    n_hosts: int,
    *,
    hot_hosts: int = 0,
    hot_weight: float = 0.0,
    capacity: int = 64,
    latency_ns: int = 50 * MILLISECOND,
    mean_delay_ns: int = 10 * MILLISECOND,
    msgs_per_host: int = 1,
    seed: int = 0,
    axis_name=None,
    n_shards: int = 1,
    drain_batch: int = 24,
    batched: bool = False,
    trace: int = 0,
    stats: int = 0,
    spill: int = 0,
    device=None,
):
    """Build (engine, init) for an n_hosts PHOLD network; `init(host0=0)`
    returns the initial EngineState.

    The 50 ms single-PoI topology matches the reference's stock config.
    `batched` selects the batched drain (whole frontiers per handler
    call); the state is bit-identical either way, apart from the
    scheduler counters. `spill` gives every queue an overflow ring of
    that many slots (runtime.pressure); `trace` a trace ring of that many
    records per host (obs.trace), `stats` the sim-time histograms
    (obs.stats). `device=None` runs on CUDA.

    With `axis_name` set, `n_hosts` is the per-shard host count of an
    `n_shards` mesh (`parallel.mesh.make_mesh`, in a rank started by
    `parallel.mesh.spawn`), and `init()` builds this rank's shard.
    """
    dev = resolve_device(device)
    cfg = EngineConfig(
        n_hosts=n_hosts,
        capacity=capacity,
        lookahead=latency_ns,
        max_emit=1,
        n_args=N_PHOLD_ARGS,
        seed=seed,
        axis_name=axis_name,
        n_shards=n_shards,
        drain_batch=drain_batch,
        trace=trace,
        stats=stats,
        spill=spill,
    )
    eng = Engine(
        cfg,
        [make_handler(n_hosts * n_shards, mean_delay_ns, hot_hosts,
                      hot_weight)],
        ConstantNetwork(latency_ns),
        batch_handler=(make_batch_handler(
            n_hosts * n_shards, mean_delay_ns, hot_hosts, hot_weight)
            if batched else None),
        device=dev,
    )

    def init(host0: int | None = None):
        host0 = eng.host0 if host0 is None else host0
        shape = (n_hosts, msgs_per_host)
        gids = host0 + torch.arange(n_hosts, dtype=torch.int32, device=dev)
        ev = Events(
            # stagger start times so the first window isn't one burst
            time=((gids[:, None].to(torch.int64) % 16 + 1)
                  * MILLISECOND).expand(shape),
            dst=gids[:, None].expand(shape),
            src=gids[:, None].expand(shape),
            seq=torch.arange(msgs_per_host, dtype=torch.int32,
                             device=dev)[None, :].expand(shape),
            kind=torch.full(shape, KIND_MSG, dtype=torch.int32, device=dev),
            args=torch.zeros(shape + (N_PHOLD_ARGS,), dtype=torch.int32,
                             device=dev),
        )
        return eng.init_state(PholdHost.create(n_hosts, device=dev), ev,
                              host0)

    return eng, init


def build_fleet(n_hosts: int, lanes: int, *, seeds=None, stop_ns: int = 0,
                **build_kw):
    """Seed-sweep fleet over one PHOLD shape: `lanes` copies of the
    `build(n_hosts, **build_kw)` scenario run as one engine
    (`runtime.fleet`). `seeds` defaults to `seed .. seed+L-1` off the
    base build's seed; every other knob is uniform across lanes by
    construction, as the fleet's static-knob rule asks."""
    from shadow_tpu_torch.runtime.fleet import build_fleet_from_engine

    eng, init = build(n_hosts, **build_kw)
    if seeds is None:
        base = build_kw.get("seed", 0)
        seeds = tuple(base + i for i in range(lanes))
    return build_fleet_from_engine(
        eng, init(), lanes, seeds=tuple(seeds), stop_ns=stop_ns
    )
