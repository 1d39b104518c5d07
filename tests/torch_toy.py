"""A two-kind toy model for shadow_tpu_torch's chained drain, JAX-free.

A PING counts, starts a local TICK chain a few ms later and sends a PING
to a random peer among the first n_peers; a TICK folds its event into an
order-sensitive accumulator and, two times in three, schedules another
TICK up to 2 ms later. Local follow-ups land below the window barrier,
so they chain inside a sweep. tests/test_torch_chained.py holds it
against the same model written for shadow_tpu; tests/test_torch_cuda.py
runs it on the card against the CPU.
"""

import dataclasses

import numpy as np
import torch

from shadow_tpu_torch import convert
from shadow_tpu_torch.core import engine as tengine
from shadow_tpu_torch.core import rng as trng
from shadow_tpu_torch.core.events import Events

MS = 1_000_000
PING, TICK = 0, 1
TOY_ARGS = 2
LAT = 10 * MS
TOY_STOP = 30 * MS

# name: (n_hosts, msgs, n_peers, capacity, drain_batch, stage_width, seed)
TOY = {
    # three hot peers hold more than B events below the barrier (the
    # queue-head guard) and flush more than FLUSH_W leftovers (the
    # full-width push); staging of exactly B + K slots makes the
    # high-water gate hold hosts back
    "hot-peers": (16, 8, 3, 48, 16, 18, 22),
}


@dataclasses.dataclass(frozen=True)
class TToy:
    n_ping: torch.Tensor
    n_tick: torch.Tensor
    acc: torch.Tensor


def torch_toy(n_peers):
    """The handlers, batched over [H]."""

    def ping(hs, ev, keys):
        k1, k2, k3 = trng.split(keys, 3)
        peer = trng.randint(k1, 0, n_peers)
        h, dev = ev.dst.shape[0], ev.dst.device
        pair = lambda a, b: torch.tensor([a, b], device=dev).expand(h, 2)
        em = tengine.Emit(
            dst=torch.stack([ev.dst, peer], 1).to(torch.int32),
            dt=torch.stack([trng.randint(k2, 0, 3 * MS),
                            trng.randint(k3, 0, 20 * MS)], 1).to(torch.int64),
            kind=pair(TICK, PING).to(torch.int32),
            args=torch.stack([torch.stack([ev.seq, ev.src], 1),
                              torch.stack([ev.args[:, 0] + 1, ev.dst], 1)],
                             1).to(torch.int32),
            mask=pair(True, True),
            local=pair(True, False),
        )
        return dataclasses.replace(
            hs, n_ping=hs.n_ping + 1,
            acc=(hs.acc * 3 + ev.args[:, 0]) % 1_000_003), em

    def tick(hs, ev, keys):
        k1, k2 = trng.split(keys, 2)
        em = tengine.Emit.single(
            dst=ev.dst, dt=trng.randint(k2, 0, 2 * MS), kind=TICK,
            args=torch.stack([ev.args[:, 0] + 1,
                              (ev.time % 1000).to(torch.int32)], 1),
            mask=trng.randint(k1, 0, 3) > 0, local=True, n_args=TOY_ARGS)
        return dataclasses.replace(
            hs, n_tick=hs.n_tick + 1,
            acc=(hs.acc * 5 + ev.time % 7 + ev.args[:, 1]) % 1_000_003), em

    return [ping, tick]


def toy_initial(n_hosts, msgs):
    """Initial PINGs as numpy fields [H, msgs], staggered in time."""
    g = np.arange(n_hosts, dtype=np.int32)[:, None]
    j = np.arange(msgs, dtype=np.int32)[None, :]
    shape = (n_hosts, msgs)
    return dict(
        time=((g % 5 + 1) * MS + j * 700_000).astype(np.int64),
        dst=np.broadcast_to(g, shape).astype(np.int32),
        src=np.broadcast_to(g, shape).astype(np.int32),
        seq=np.broadcast_to(j, shape).astype(np.int32),
        kind=np.full(shape, PING, np.int32),
        args=np.zeros(shape + (TOY_ARGS,), np.int32),
    )


def toy_config(name) -> dict:
    """EngineConfig keywords of a TOY entry (the same in both packages)."""
    n, _msgs, _peers, cap, b, sw, seed = TOY[name]
    return dict(n_hosts=n, capacity=cap, lookahead=LAT, max_emit=2,
                n_args=TOY_ARGS, seed=seed, drain_batch=b, stage_width=sw)


def run_torch_toy(name, stop=TOY_STOP, device="cpu"):
    """(engine, numpy leaves of the final state) of the toy on `device`."""
    n, msgs, peers = TOY[name][:3]
    et = tengine.Engine(tengine.EngineConfig(**toy_config(name)),
                        torch_toy(peers), tengine.ConstantNetwork(LAT),
                        device=device)
    z = torch.zeros((n,), dtype=torch.int64, device=et.device)
    init = et.init_state(TToy(z, z, z), Events(**{
        k: torch.from_numpy(v).to(et.device)
        for k, v in toy_initial(n, msgs).items()}))
    return et, convert.engine_state_to_numpy(et.run(init, stop))
