"""`Simulation.step_window` and `dispatch(window_ns=)` on a mesh: the
port's sharded simulation, window by window, against the reference's on
JAX's virtual CPU mesh, on PHOLD over UDP at 16 hosts and S = 2.

A lookahead-wide window, then windows of 120 and 250 ms
(`step_window(window_ns=)` and `dispatch(window_ns=)`, one window each:
cross-host arrivals clamp up to the wider ends), then one more
lookahead-wide window: the global view equals the reference's leaf for
leaf, the exchange buffer included (between windows its buckets hold the
deferred round).
"""

import torch_shard_harness as harness
from shadow_tpu.config import parse_config as jparse
from shadow_tpu.parallel import mesh as jmesh
from shadow_tpu.sim import build_simulation as jbuild
from shadow_tpu_torch import examples as texamples
from shadow_tpu_torch.core.timebase import MILLISECOND, SECOND
from shadow_tpu_torch.parallel import mesh as pmesh
from test_torch_phold import assert_leaves_equal, jax_leaves

CFG = texamples.phold_example(16, 4, stoptime=2)
BUILD = dict(seed=4)
STOP = 3 * SECOND // 2
# the first and last windows at the lookahead's width (50 ms), given as
# a width: the reference then runs one compiled program for all four
LOOKAHEAD = 50 * MILLISECOND
STEPS = (("step", STOP, LOOKAHEAD), ("step", STOP, 120 * MILLISECOND),
         ("dispatch", STOP, 250 * MILLISECOND), ("step", STOP, LOOKAHEAD))


def test_step_window_and_dispatch_match_reference():
    n_shards = 2
    sim = jbuild(jparse(CFG), mesh=jmesh.make_mesh(n_shards), **BUILD)
    st = sim.state0
    for kind, stop, width in STEPS:
        if kind == "step":
            st = sim.step_window(st, stop, window_ns=width)
        else:
            st = sim.dispatch(stop, st, window_ns=width)
    lj = jax_leaves(st)
    lt, *_ = pmesh.spawn(harness.sim_rank, n_shards, backend="gloo",
                         device="cpu", args=(n_shards, CFG, BUILD, STEPS),
                         timeout_s=harness.SPAWN_TIMEOUT_S)
    assert_leaves_equal(lj, lt)
    assert lt["stats.n_windows"] == 4 and lt["stats.n_cross_shard"] > 0
