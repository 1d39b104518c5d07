"""Rank entry points of the sharded port tests, in a module that needs
no JAX: `parallel.mesh.spawn` starts each rank in a fresh interpreter,
which imports the module of the function it runs.

Every entry point runs one rank on the CPU with one torch thread, makes
the mesh over the group `spawn` started, and returns (on rank 0) the
global view of the final state (`parallel.mesh.gather_state`) with what
the run counted.
"""

from __future__ import annotations

import os
import signal

import torch

from shadow_tpu_torch.parallel import mesh as pmesh

# The collective timeout of every rank group the tests start
# (`pmesh.spawn(..., timeout_s=SPAWN_TIMEOUT_S)`): a rank stuck in its
# rendezvous or a collective fails its test within this, plus spawn's
# grace, instead of holding a test worker for the library default.
SPAWN_TIMEOUT_S = 120.0


def _mesh(n_shards: int, dcn_slices: int = 1, device: str = "cpu"):
    torch.set_num_threads(1)
    return pmesh.make_mesh(n_shards, dcn_slices=dcn_slices, device=device)


def phold_rank(n_shards: int, per: int, stop_ns: int, kw: dict,
               dcn_slices: int = 1):
    """PHOLD over `n_shards` ranks of `per` hosts each, run to stop_ns;
    returns (global leaves, engine reads, collectives, rank 0's own
    leaves)."""
    from shadow_tpu_torch import convert
    from shadow_tpu_torch.models import phold

    m = _mesh(n_shards, dcn_slices)
    eng, init = phold.build(per, axis_name=pmesh.hosts_axes(m),
                            n_shards=n_shards, device="cpu", **kw)
    st = eng.run(init(), stop_ns)
    return (pmesh.gather_state(st, m), eng.host_syncs, m.comm.calls,
            convert.engine_state_to_numpy(st))


def phold_steps_rank(n_shards: int, per: int, stops: tuple, kw: dict):
    """PHOLD over `n_shards` ranks, one `Engine.step_window` per stop in
    `stops`; returns the global leaves after each step."""
    from shadow_tpu_torch.models import phold

    m = _mesh(n_shards)
    eng, init = phold.build(per, axis_name=pmesh.HOSTS_AXIS,
                            n_shards=n_shards, device="cpu", **kw)
    st, out = init(), []
    for stop in stops:
        st = eng.step_window(st, stop)
        out.append(pmesh.gather_state(st, m))
    return out


def roundtrip_rank(n_shards: int, per: int, stop_ns: int):
    """gather_state then scatter_state of a PHOLD shard: the rank's
    shard back (every rank checks its own; rank 0 reports)."""
    from shadow_tpu_torch import convert
    from shadow_tpu_torch.models import phold

    m = _mesh(n_shards)
    eng, init = phold.build(per, axis_name=pmesh.HOSTS_AXIS,
                            n_shards=n_shards, device="cpu", seed=2)
    st = eng.run(init(), stop_ns)
    g = pmesh.gather_state(st, m)
    # rank 0 holds the view; every rank reads it back from a broadcast
    import torch.distributed as dist

    box = [g]
    dist.broadcast_object_list(box, src=0)
    back = pmesh.scatter_state(box[0], st, m)
    a = convert.engine_state_to_numpy(st)
    b = convert.engine_state_to_numpy(back)
    return all(k in b and (a[k] == b[k]).all() and a[k].dtype == b[k].dtype
               for k in a)


def modules_rank(forbidden: tuple):
    """The forbidden top-level modules this rank has imported, after
    importing the sharded port and running a tiny sharded PHOLD."""
    import sys

    phold_rank(pmesh.current().size if pmesh.current() else 2, 4,
               10 ** 8, {})
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in forbidden})


def failing_rank():
    """A rank that raises: `spawn` must report it."""
    raise RuntimeError("deliberate failure")


def sim_rank(n_shards: int, config_text: str, build_kw: dict,
             steps: tuple = (), dcn_slices: int = 1, stop_ns=None,
             device: str = "cpu"):
    """`build_simulation(config_text, mesh=...)`; run to the config's
    stop (or stop_ns), or, when `steps` is given, through
    `Simulation.step_window` / `dispatch(window_ns=)` calls, each
    (kind, stop_ns, window_ns). Returns (global leaves, names,
    host_order, the summary's cross-shard count)."""
    from shadow_tpu_torch.config import parse_config
    from shadow_tpu_torch.sim import build_simulation

    m = _mesh(n_shards, dcn_slices, device)
    sim = build_simulation(parse_config(config_text), mesh=m, **build_kw)
    st = sim.state0
    if steps:
        for kind, stop, width in steps:
            if kind == "step":
                st = sim.step_window(st, stop, window_ns=width)
            else:
                st = sim.dispatch(stop, st, window_ns=width)
    else:
        st = sim.run(stop_ns, state=st)
    return (sim.gather_state(st), list(sim.names), sim.host_order,
            int(st.stats.n_cross_shard))


def resume_rank(n_shards: int, config_text: str, build_kw: dict,
                ckpt, stops: tuple, save=None, save_at: int = -1,
                device: str = "cpu"):
    """Build at n_shards (0: unsharded), load the
    checkpoint `ckpt` (None: start fresh; a path; or a list of shard-set
    member paths) with reshard=True, run to each stop of `stops` in turn
    and, with `save=(path, shard_set)`, write the state at stop
    `stops[save_at]`: a global checkpoint from rank 0, or one shard-set
    member per rank. Returns the final global leaves."""
    from shadow_tpu_torch.config import parse_config
    from shadow_tpu_torch.sim import build_simulation
    from shadow_tpu_torch.utils import checkpoint as ck

    # n_shards 0: unsharded, in a group of one or in the caller's process;
    # a rank runs on one torch thread either way, as `_mesh` sets
    if torch.distributed.is_initialized():
        torch.set_num_threads(1)
    m = _mesh(n_shards, device=device) if n_shards else None
    sim = build_simulation(parse_config(config_text), mesh=m,
                           device=None if m else device, **build_kw)
    if ckpt is None:
        st = sim.state0
    elif isinstance(ckpt, list):
        st, _ = ck.load_shard_set(ckpt, sim.state0, mesh=m)
    else:
        st, _ = ck.load_checkpoint(ckpt, sim.state0, reshard=True, mesh=m)
    for i, stop in enumerate(stops):
        st = sim.run(stop, state=st)
        if save is not None and i == save_at % len(stops):
            path, shard_set = save
            if shard_set:
                ck.save_checkpoint(path, st, shard=(m.rank, m.size),
                                   mesh_info=sim.mesh_info())
            else:
                ck.save_checkpoint(path, st, mesh=m,
                                   mesh_info=sim.mesh_info())
    return sim.gather_state(st)


def inflight_rank(config_text: str, build_kw: dict, path: str):
    """Two ranks step windows until the exchange buffer holds events in
    flight, then write that state as a global checkpoint; returns the
    number of windows stepped."""
    import torch.distributed as dist

    from shadow_tpu_torch.config import parse_config
    from shadow_tpu_torch.sim import build_simulation
    from shadow_tpu_torch.utils import checkpoint as ck

    m = _mesh(2)
    sim = build_simulation(parse_config(config_text), mesh=m, device="cpu",
                           **build_kw)
    st, n = sim.state0, 0
    while True:
        st = sim.step_window(st, sim.stop_ns)
        n += 1
        busy = torch.tensor(int(bool(
            (st.xchg.bucket.time != (1 << 63) - 1).any())))
        dist.all_reduce(busy)
        if int(busy):
            break
    ck.save_checkpoint(path, st, mesh=m, mesh_info=sim.mesh_info())
    return n


def refusals_rank(config_text: str):
    """What meshes of two refuse: spill and grow modes, the
    compiler-partitioned global engine and the pmap path on a (dcn,
    hosts) mesh, and per-window widths on the pmap path of a 1-D mesh;
    returns the messages."""
    from shadow_tpu_torch.config import parse_config
    from shadow_tpu_torch.sim import build_simulation

    m2 = _mesh(2, dcn_slices=2)
    out = []

    def refused(call):
        try:
            call()
        except (ValueError, NotImplementedError) as e:
            out.append(str(e))

    cfg = parse_config(config_text)
    for kw in (dict(overflow="spill"), dict(overflow="grow"),
               dict(spmd="constraint"), dict(spmd="pmap")):
        refused(lambda: build_simulation(cfg, mesh=m2, **kw))
    sim = build_simulation(cfg, mesh=_mesh(2), spmd="pmap")
    refused(lambda: sim.step_window(sim.state0, sim.stop_ns,
                                    window_ns=10 ** 8))
    refused(lambda: sim.dispatch(sim.stop_ns, sim.state0,
                                 window_ns=10 ** 8))
    return out


def cli_rank(argv: list, kill_rank: int | None = None,
             kill_after: str | None = None):
    """`cli.main(argv)` on the CPU in one rank of an already started
    group (the CLI's own `--mesh` launcher is `cli.main` itself). With
    `kill_rank`, that rank kills itself by SIGKILL at its first
    collective after the file `kill_after` exists (the first
    checkpoint, say): a peer lost mid-run."""
    from shadow_tpu_torch import cli

    torch.set_num_threads(1)
    if kill_rank is not None:
        orig = pmesh.Comm._run

        def run(self, op, *t):
            if self.rank == kill_rank and os.path.exists(kill_after):
                os.kill(os.getpid(), signal.SIGKILL)
            return orig(self, op, *t)

        pmesh.Comm._run = run
    return cli.main(argv, device="cpu")
