"""Scenario fleets in the port (`shadow_tpu_torch.runtime.fleet`), held
on the CPU against the reference's vmapped fleet and the port's solo
runs, leaf for leaf, dtypes included.

The cases and sizes are `tests/test_fleet.py`'s (PHOLD at 8 hosts, 3
sim-s): a seed sweep; a mixed fleet of a plain lane, a crash lane, a
loss lane and a latency-scaled lane; no fault bleeding across lanes; the
launching operations independent of the lane count (the reference pins
its op histogram); one fetch per heartbeat segment; static knobs and a
sharded base refused; `phold.build_fleet`'s defaults. Beyond them: per-
lane stops, an inert lane, lane reshard and merge, lanes on the chained,
batched and frontier drains against the reference fleet (with the trace
ring and the stats plane on, and a per-lane bandwidth scale), a warm
plan swap and an adopted state. Each reference fleet runs once per file.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from shadow_tpu import config as jconfig
from shadow_tpu import sim as jsim
from shadow_tpu.faults import parse_fault_dsl as jparse_fault
from shadow_tpu.models import phold as jphold
from shadow_tpu.runtime import fleet as jfleet
from shadow_tpu_torch import config as tconfig
from shadow_tpu_torch import convert
from shadow_tpu_torch import sim as tsim
from shadow_tpu_torch.core import events as tevents
from shadow_tpu_torch.core.engine import Engine, EngineConfig, state_summary
from shadow_tpu_torch.core.timebase import SECOND
from shadow_tpu_torch.examples import tgen_example
from shadow_tpu_torch.faults import parse_fault_dsl
from shadow_tpu_torch.faults.schedule import compile_faults
from shadow_tpu_torch.models import phold as tphold
from shadow_tpu_torch.runtime import fleet as tfleet
from shadow_tpu_torch.runtime.harvest import HeartbeatHarvest
from test_torch_phold import assert_leaves_equal, jax_leaves
from test_torch_tcp import one_torch_thread  # noqa: F401 (autouse)
from test_torch_tgen import LaunchCount

N = 8  # hosts
STOP = 3 * SECOND
NAMES = [f"host{i}" for i in range(N)]
KW = dict(capacity=64, msgs_per_host=2)

CRASH = "crash hosts=host3 start=1 end=2"
LOSSY = "loss src=host1 dst=host5 loss=0.5 start=1 end=2"
MIXED = dict(seeds=(11, 12, 13, 14),
             faults=(None, (CRASH,), (LOSSY,), None),
             latency_scale=(1.0, 1.0, 1.0, 1.7))


def _specs(faults, parse):
    """A fleet plan's faults as spec objects of one package."""
    return tuple(None if f is None else tuple(parse(s) for s in f)
                 for f in faults)


def port_solo(seed, faults=(), scale=None, stop=STOP, batched=False):
    """The port's native solo build of one lane's scenario: faults
    compiled into the Engine, latency scaling by `scaled_network`; once
    per scenario for the whole file."""
    return _port_solo(seed, faults, scale, stop, batched)


@functools.lru_cache(maxsize=None)
def _port_solo(seed, faults, scale, stop, batched):
    eng, init = tphold.build(N, seed=seed, device="cpu", batched=batched,
                             **KW)
    st0 = init()
    if faults or scale is not None:
        net = (tfleet.scaled_network(eng.network, scale)
               if scale is not None else eng.network)
        comp = reset = None
        if faults:
            comp = compile_faults(tuple(parse_fault_dsl(s) for s in faults),
                                  NAMES, N, seed, device="cpu")
            if comp.has_crash or comp.has_bw:
                reset = st0.hosts
        eng = Engine(eng.cfg, eng.handlers, net,
                     batch_handler=eng.batch_handler, faults=comp,
                     fault_reset=reset, device="cpu")
    return eng.run(st0, stop)


def port_fleet(lanes, batched=False, **plan):
    eng, init = tphold.build(N, seed=0, device="cpu", batched=batched,
                             **KW)
    return tfleet.build_fleet_from_engine(eng, init(), lanes, **plan)


@functools.lru_cache(maxsize=None)
def jax_fleet(lanes, batched, plan_key):
    """The reference fleet's final [L, ...] leaves and per-lane
    summaries, once per plan for the whole file."""
    plan = dict(plan_key)
    if "faults" in plan:
        plan["faults"] = _specs(plan["faults"], jparse_fault)
    eng, init = jphold.build(N, seed=0, batched=batched, **KW)
    fleet = jfleet.build_fleet_from_engine(eng, init(), lanes, **plan)
    final = jax.device_get(fleet.run(STOP))
    return jax_leaves(final), fleet.lane_summaries(final)


def plan_key(plan):
    return tuple(sorted(plan.items()))


def port_plan(plan):
    plan = dict(plan)
    if "faults" in plan:
        plan["faults"] = _specs(plan["faults"], parse_fault_dsl)
    return plan


def lane(leaves, k):
    return convert.lane_of(leaves, k)


@pytest.fixture(scope="module")
def mixed():
    """4 lanes exercising every per-lane knob class at once, in both
    packages: ((JAX leaves, JAX summaries), (port fleet, final state))."""
    fleet = port_fleet(4, **port_plan(MIXED))
    return jax_fleet(4, False, plan_key(MIXED)), (fleet, fleet.run(STOP))


def test_mixed_fault_fleet_lanes_match_reference_and_solo(mixed):
    (lj, sj), (fleet, final) = mixed
    lt = convert.fleet_state_to_numpy(final)
    assert_leaves_equal(lj, lt)
    sums = fleet.lane_summaries(final)
    assert sums == sj
    cases = [(11, (), None), (12, (CRASH,), None), (13, (LOSSY,), None),
             (14, (), 1.7)]
    for k, (seed, faults, scale) in enumerate(cases):
        solo = port_solo(seed, faults, scale)
        assert_leaves_equal(lane(lt, k), convert.engine_state_to_numpy(solo))
        assert sums[k] == state_summary(solo), k


def test_fault_schedules_do_not_bleed_across_lanes(mixed):
    # lane 0 rides a fleet whose siblings compiled crash and loss
    # overlays: its state equals the NO-fault solo run exactly
    _, (fleet, final) = mixed
    lt = convert.fleet_state_to_numpy(final)
    assert_leaves_equal(lane(lt, 0),
                        convert.engine_state_to_numpy(port_solo(11)))
    # and the crash lane visibly diverges from its fault-free twin
    assert fleet.lane_summaries(final)[1] != state_summary(port_solo(12))
    assert final.fault_epoch.tolist() == [0, 2, 2, 0]


SWEEP = (5, 6, 7)


@functools.lru_cache(maxsize=None)
def jax_sweep_fleet():
    """The reference's SWEEP fleet with a stop per lane, built once for
    the file: the seed sweep runs it with one stop for every lane, the
    per-lane-stop test with three (one compile, the stops are inputs)."""
    jeng, jinit = jphold.build(N, seed=0, **KW)
    return jfleet.Fleet(jeng, jinit(), jfleet.FleetPlan(3, seeds=SWEEP),
                        per_lane_stop=True)


def test_seed_sweep_lanes_match_reference_and_solo():
    plan = dict(seeds=SWEEP)
    jf = jax_sweep_fleet()
    jfinal = jax.device_get(jf.run(np.array((STOP,) * 3)))
    lj, sj = jax_leaves(jfinal), jf.lane_summaries(jfinal)
    fleet = port_fleet(3, **plan)
    final = fleet.run(STOP)
    lt = convert.fleet_state_to_numpy(final)
    assert_leaves_equal(lj, lt)
    sums = fleet.lane_summaries(final)
    assert sums == sj
    for k, seed in enumerate(SWEEP):
        solo = port_solo(seed)
        assert_leaves_equal(lane(lt, k), convert.engine_state_to_numpy(solo))
        assert sums[k] == state_summary(solo)
    # the sweep varied: different seeds, different trajectories
    assert len({s["executed"] for s in sums}) > 1


def _measure(eng, st, stop):
    """(op histogram, merge calls, host syncs, final state) of a run."""
    calls = [0]
    fused = tevents.merge.fused_merge

    def count(*args):
        calls[0] += 1
        return fused(*args)

    tevents.merge.fused_merge = count
    try:
        s0 = eng.host_syncs
        with LaunchCount() as lc:
            out = eng.run(st, stop)
        return dict(lc.ops), calls[0], eng.host_syncs - s0, out
    finally:
        tevents.merge.fused_merge = fused


@pytest.mark.parametrize("batched", [False, True], ids=["chained",
                                                         "batched"])
def test_launches_lane_count_independent_and_solo_untouched(batched):
    """Every op runs once for all lanes: fleets of 1, 2 and 4 lanes of one
    seed launch the same operations, merge calls and reads as the solo
    run, and building them leaves the solo engine's run as it was."""
    stop = SECOND // 2
    eng, init = tphold.build(N, seed=3, device="cpu", batched=batched, **KW)
    ops0, merges0, syncs0, solo0 = _measure(eng, init(), stop)
    runs = {}
    for lanes in (1, 2, 4):
        fleet = tfleet.build_fleet_from_engine(eng, init(), lanes,
                                               seeds=(3,) * lanes)
        runs[lanes] = _measure(fleet.engine, fleet.state0, stop)
    ops1, merges1, syncs1, _ = _measure(eng, init(), stop)
    assert (ops1, merges1, syncs1) == (ops0, merges0, syncs0)
    # L = 1 makes a few broadcasts views where L > 1 copies them: it is
    # compared outside those copies, L = 2 and 4 exactly
    assert runs[2][0] == runs[4][0]
    heavy = lambda ops: {k: v for k, v in ops.items() if k != "aten.clone"}
    assert heavy(runs[1][0]) == heavy(runs[2][0])
    for lanes, (_, merges, syncs, out) in runs.items():
        assert (merges, syncs) == (merges0, syncs0), lanes
        lt = convert.fleet_state_to_numpy(out)
        for k in range(lanes):
            assert_leaves_equal(lane(lt, k),
                                convert.engine_state_to_numpy(solo0))


def test_fleet_heartbeat_segment_fetches_exactly_once(monkeypatch):
    from shadow_tpu_torch.runtime import harvest as tharvest

    fleet = port_fleet(2, seeds=(1, 2))
    harvest = HeartbeatHarvest(fleet)
    st = fleet.dispatch(STOP, None)
    st, bundle = harvest.extract(st, full=True)
    calls = []
    real = tharvest.fetch_tree
    monkeypatch.setattr(tharvest, "fetch_tree",
                        lambda *a: calls.append(1) or real(*a))
    fetched = harvest.fetch(bundle)
    assert len(calls) == 1 and harvest.host_syncs == 1
    rows = harvest.lane_summaries_from(fetched)
    agg = harvest.summary_from(fetched)
    assert len(rows) == 2
    assert agg["executed"] == sum(r["executed"] for r in rows)
    assert agg["now_ns"] == min(r["now_ns"] for r in rows)
    for k, seed in enumerate((1, 2)):
        assert rows[k] == state_summary(port_solo(seed))
    assert fetched["fill"].dtype == np.float32
    assert fetched["fill"].shape == (2,)


def test_fleet_harvest_rejects_per_scenario_consumers():
    fleet = port_fleet(2, seeds=(1, 2))
    with pytest.raises(ValueError, match="per-scenario"):
        HeartbeatHarvest(fleet, tracker=object())


def test_static_knobs_rejected_with_reason():
    with pytest.raises(ValueError, match="static compile-time knob"):
        tfleet.check_lane_knobs({"capacity": (32, 64)})
    with pytest.raises(ValueError, match="unknown fleet override"):
        tfleet.check_lane_knobs({"sseeds": (1, 2)})
    with pytest.raises(ValueError, match="entries for 3 lanes"):
        tfleet.FleetPlan(lanes=3, seeds=(1, 2))
    with pytest.raises(ValueError, match="static compile-time knob"):
        tfleet.build_fleet_from_engine(None, None, 2, frontier=(0, 8))


def test_sharded_base_rejected():
    # a sharded port engine needs a rank group to exist at all; the
    # refusal reads only its config, as the reference's does
    cfg = EngineConfig(n_hosts=2, capacity=16, lookahead=SECOND,
                       axis_name="hosts", n_shards=2)
    eng = type("ShardedEngine", (), {"cfg": cfg})()
    with pytest.raises(ValueError, match="single-device engine"):
        tfleet.build_fleet_from_engine(eng, None, 2)
    sim = type("ShardedSim", (), {"mesh": object(), "pressure": None})()
    with pytest.raises(ValueError, match="single-device engine"):
        tsim.build_fleet(sim, 2)
    # and the spill/grow pressure modes, whose refills are per scenario
    sim = type("SpillSim", (), {"mesh": None, "pressure": object()})()
    with pytest.raises(ValueError, match="spill/grow pressure"):
        tsim.build_fleet(sim, 2)


def test_per_lane_stop_matches_each_lanes_solo_run():
    """With per_lane_stop every lane ends its last window at its own
    stop, exactly like its solo run to that stop and the reference
    fleet's lane."""
    eng, init = tphold.build(N, seed=0, device="cpu", **KW)
    fleet = tfleet.Fleet(eng, init(), tfleet.FleetPlan(3, seeds=SWEEP),
                         per_lane_stop=True)
    stops = (SECOND, 2 * SECOND + 7_000_000, STOP)
    final = fleet.run(np.array(stops))
    lt = convert.fleet_state_to_numpy(final)
    jf = jax_sweep_fleet()
    assert_leaves_equal(jax_leaves(jax.device_get(jf.run(np.array(stops)))),
                        lt)
    for k, (seed, stop) in enumerate(zip(SWEEP, stops)):
        solo = port_solo(seed, stop=stop)
        assert_leaves_equal(lane(lt, k), convert.engine_state_to_numpy(solo))
    assert final.now.tolist() == list(stops)
    # window by window: each lane advances or lands on its own stop
    st = None
    while st is None or (st.now < torch.tensor(stops)).any():
        st = fleet.step_window(st, np.array(stops))
    assert_leaves_equal(convert.fleet_state_to_numpy(st), lt)
    with pytest.raises(ValueError, match="per-lane stop"):
        fleet.run(np.array(stops[:2]))


def test_inert_lane_stays_inert():
    """A pad lane with every queue slot empty runs no window: its
    counters stay zero and only its clock lands on the stop, while its
    sibling equals its solo run."""
    fleet = port_fleet(
        2, seeds=(9, 9),
        state_override=lambda i, st: (tfleet.inert_lane_state(st) if i == 1
                                      else st))
    final = fleet.run(STOP)
    lt = convert.fleet_state_to_numpy(final)
    inert = lane(lt, 1)
    l0 = lane(convert.fleet_state_to_numpy(fleet.state0), 1)
    for key, a in inert.items():
        if key != "now":
            np.testing.assert_array_equal(a, l0[key], err_msg=key)
    assert int(inert["now"]) == STOP
    assert inert["stats.n_windows"] == 0
    assert inert["stats.n_executed"].sum() == 0
    assert (inert["queues.time"] == np.iinfo(np.int64).max).all()
    assert_leaves_equal(lane(lt, 0),
                        convert.engine_state_to_numpy(port_solo(9)))


def test_lane_reshard_then_merge_gives_back_the_state(mixed):
    _, (fleet, final) = mixed
    whole = convert.fleet_state_to_numpy(final)
    parts = tfleet.lane_reshard(final, 2)
    assert len(parts) == 2
    for j, part in enumerate(parts):
        lp = convert.fleet_state_to_numpy(part)
        for k in range(2):
            assert_leaves_equal(lane(lp, k), lane(whole, 2 * j + k))
    assert_leaves_equal(convert.fleet_state_to_numpy(
        tfleet.lane_merge(parts)), whole)
    # the raw {leaf: array} tree of a checkpoint splits and merges too
    raw = tfleet.lane_reshard(whole, 1)
    assert len(raw) == 4 and raw[3]["now"].shape == (1,)
    assert_leaves_equal(tfleet.lane_merge(raw), whole)
    with pytest.raises(ValueError, match="divide the lane count"):
        tfleet.lane_reshard(final, 3)
    with pytest.raises(ValueError, match="is a scalar"):
        tfleet.lane_reshard({"a": np.zeros(4), "b": np.int64(1)}, 2)
    with pytest.raises(ValueError, match="leading dim"):
        tfleet.lane_reshard({"a": np.zeros(4), "b": np.zeros(2)}, 2)
    # a merged state adopted by the fleet runs on as the original does
    adopted = fleet.adopt_state(convert.fleet_state_from_numpy(
        whole, "cpu", final.hosts.__class__))
    assert_leaves_equal(convert.fleet_state_to_numpy(adopted), whole)


SIM_TEXT = tgen_example(n_pairs=2, sendsize="16KiB", recvsize="64KiB",
                        count=2, stoptime=5)
SIM_KW = dict(seed=3, n_sockets=4, capacity=256, overflow="drop",
              trace=48, stats=1)
SIM_BW = "bandwidth hosts=srv* start=2 end=4 factor=0.25"


def _sim_lanes(frontier):
    return tsim.build_simulation(tconfig.parse_config(SIM_TEXT),
                                 device="cpu", frontier=frontier, **SIM_KW)


def _sim_plan(parse):
    """The sim lanes' plan in one package: a bandwidth fault in lane 0,
    a halved NIC rate and a 1.25x latency in lane 1."""
    return dict(seeds=(3, 4), faults=((parse(SIM_BW),), None),
                bandwidth_scale=(1.0, 0.5), latency_scale=(1.0, 1.25))


@pytest.mark.parametrize("drain", ["chained", "batched", "frontier"])
def test_lanes_on_every_drain(drain):
    """Lanes with the trace ring and the stats plane on, on each drain,
    equal the reference fleet's lanes and their solo runs, trace scratch
    columns included. The sim lanes carry a per-lane bandwidth scale, a
    latency scale and a bandwidth fault in one lane; the batched drain
    is PHOLD's."""
    if drain == "batched":
        eng, init = tphold.build(N, seed=0, device="cpu", batched=True,
                                 trace=32, stats=1, **KW)
        fleet = tfleet.build_fleet_from_engine(
            eng, init(), 2, seeds=(21, 22),
            faults=_specs((None, (CRASH,)), parse_fault_dsl))
        final = fleet.run(STOP)
        lt = convert.fleet_state_to_numpy(final)
        jeng, jinit = jphold.build(N, seed=0, batched=True, trace=32,
                                   stats=1, **KW)
        jf = jfleet.build_fleet_from_engine(
            jeng, jinit(), 2, seeds=(21, 22),
            faults=_specs((None, (CRASH,)), jparse_fault))
        assert_leaves_equal(jax_leaves(jax.device_get(jf.run(STOP))), lt)
        for k, (seed, faults) in enumerate(((21, ()), (22, (CRASH,)))):
            e2, i2 = tphold.build(N, seed=seed, device="cpu", batched=True,
                                  trace=32, stats=1, **KW)
            comp = reset = None
            st0 = i2()
            if faults:
                comp = compile_faults(tuple(parse_fault_dsl(s)
                                            for s in faults),
                                      NAMES, N, seed, device="cpu")
                reset = st0.hosts
            solo = Engine(e2.cfg, e2.handlers, e2.network,
                          batch_handler=e2.batch_handler, faults=comp,
                          fault_reset=reset, device="cpu").run(st0, STOP)
            assert_leaves_equal(lane(lt, k),
                                convert.engine_state_to_numpy(solo))
        return
    frontier = 16 if drain == "frontier" else 0
    sim = _sim_lanes(frontier)
    fleet = sim.build_fleet(2, **_sim_plan(parse_fault_dsl))
    final = fleet.run()
    lt = convert.fleet_state_to_numpy(final)
    assert final.trace is not None and final.splane is not None
    js = jsim.build_simulation(jconfig.parse_config(SIM_TEXT),
                               frontier=frontier, **SIM_KW)
    jf = js.build_fleet(2, **_sim_plan(jparse_fault))
    assert_leaves_equal(jax_leaves(jax.device_get(jf.run())), lt)
    bw = parse_fault_dsl(SIM_BW)
    for k in range(2):
        s2 = _sim_lanes(frontier)
        eng, st0 = s2.engine, s2.state0
        if k == 1:
            st0 = tfleet._scale_nic(st0, 0.5)
        comp = (compile_faults((bw,), s2.names, eng.cfg.n_hosts, 3,
                               device="cpu") if k == 0 else None)
        solo_eng = Engine(
            eng.cfg, eng.handlers,
            tfleet.scaled_network(eng.network, (1.0, 1.25)[k]),
            cpu_cost=eng.cpu_cost, batch_handler=eng.batch_handler,
            faults=comp, fault_reset=st0.hosts if comp is not None else None,
            frontier_kinds=eng._frontier_kinds, device="cpu")
        solo = solo_eng.run(st0, s2.stop_ns)
        assert_leaves_equal(lane(lt, k), convert.engine_state_to_numpy(solo))
        assert int(solo.stats.n_executed.sum()) > 0


def test_new_plan_through_the_same_fleet():
    """`make_inputs` gives a new plan's launch inputs for the same fleet;
    its run equals a fleet built for that plan, and a plan of another
    shape is refused."""
    fleet = port_fleet(2, seeds=(1, 2))
    st, binds = fleet.make_inputs(tfleet.FleetPlan(2, seeds=(7, 8)))
    got = convert.fleet_state_to_numpy(fleet.run(STOP, st, binds=binds))
    ref = convert.fleet_state_to_numpy(port_fleet(2, seeds=(7, 8)).run(STOP))
    assert_leaves_equal(got, ref)
    with pytest.raises(ValueError, match="inert lanes"):
        fleet.make_inputs(tfleet.FleetPlan(3, seeds=(7, 8, 9)))


def test_fault_pad_shares_bind_shapes_across_plans():
    """`fault_pad` pins the padded schedule's shape, so a plan with other
    faults rides the same fleet through `make_inputs`, and the padding
    stays values-neutral: each lane equals its solo run."""
    eng, init = tphold.build(N, seed=0, device="cpu", **KW)
    plan = lambda faults: tfleet.FleetPlan(
        2, seeds=(31, 32), faults=_specs(faults, parse_fault_dsl))
    fleet = tfleet.Fleet(eng, init(), plan(((CRASH,), (LOSSY,))),
                         fault_pad=(8, 4))
    st, binds = fleet.make_inputs(plan(((LOSSY,), (CRASH,))))
    assert binds["f_times"].shape == fleet.binds["f_times"].shape == (2, 8)
    assert binds["f_lat"].shape == (2, 8, 4, 4)
    lt = convert.fleet_state_to_numpy(fleet.run(STOP, st, binds=binds))
    for k, (seed, faults) in enumerate(((31, (LOSSY,)), (32, (CRASH,)))):
        assert_leaves_equal(lane(lt, k), convert.engine_state_to_numpy(
            port_solo(seed, faults)))
    with pytest.raises(ValueError, match="fault flags"):
        fleet.make_inputs(plan((None, None)))


def test_overflow_is_loud_across_the_fleet():
    """A fleet whose queues overflow raises with the fleet's drop count,
    as a strict solo run does; with strict_overflow off the drops are
    counted per lane."""
    eng, init = tphold.build(N, seed=0, device="cpu", capacity=2,
                             msgs_per_host=4)
    fleet = tfleet.build_fleet_from_engine(eng, init(), 2, seeds=(1, 2))
    with pytest.raises(RuntimeError, match="dropped across the fleet"):
        fleet.run(SECOND // 2)
    fleet.strict_overflow = False
    sums = fleet.lane_summaries(fleet.run(SECOND // 2))
    assert all(r["queue_drops"] > 0 for r in sums)


def test_phold_build_fleet_convenience_defaults():
    # the model-level sweep entry point: seeds default to base seed ..
    # base seed + L - 1
    fleet = tphold.build_fleet(N, 3, seed=7, device="cpu", **KW)
    assert fleet.lanes == 3
    assert tuple(int(s) for s in fleet.plan.seeds) == (7, 8, 9)
    fleet = tphold.build_fleet(N, 2, seeds=(11, 4), device="cpu", **KW)
    assert tuple(int(s) for s in fleet.plan.seeds) == (11, 4)
    assert fleet.state0.now.shape == (2,)
    assert fleet.state0.queues.time.shape == (2 * N, 64)
