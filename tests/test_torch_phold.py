"""PHOLD in shadow_tpu_torch against shadow_tpu, leaf for leaf.

Both packages build the same PHOLD network (here on the batched drain;
tests/test_torch_chained.py holds the chained one), run it on the CPU,
and every final EngineState leaf must be equal, dtype included, through
`shadow_tpu_torch.convert`. The slow tests run the bench shape (4096
hosts x 8 messages) on both drains and recompute the JAX/CPU pins that
chip_smoke.py holds the card to.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from shadow_tpu.core import engine as jengine
from shadow_tpu.models import phold as jphold
from shadow_tpu_torch import convert
from shadow_tpu_torch import faults as tfaults
from shadow_tpu_torch.core import engine as tengine
from shadow_tpu_torch.core import events as tevents
from shadow_tpu_torch.models import phold as tphold

MS = 1_000_000
SECOND = 1_000_000_000


def jax_leaves(state) -> dict:
    """The reference EngineState's leaves keyed by field path (a tuple
    element by its index, as `convert` keys them)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(jax.device_get(state))
    return {".".join(str(getattr(k, "name", getattr(k, "idx", None)))
                     for k in path): np.asarray(v) for path, v in flat}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's tensors here are a few rows wide: one intra-op thread
    runs them fastest and keeps parallel test workers off each other's
    cores. Autouse in every test module that imports it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_leaves_equal(lj: dict, lt: dict):
    assert lj.keys() == lt.keys()
    for key in lj:
        assert lj[key].dtype == lt[key].dtype, key
        assert lj[key].shape == lt[key].shape, key
        np.testing.assert_array_equal(lj[key], lt[key], err_msg=key)


@functools.lru_cache(maxsize=None)
def jax_phold(n_hosts, batched=True, **kw):
    """(jitted run, initial state) of the reference, one compile per
    configuration for the whole file."""
    eng, init = jphold.build(n_hosts, batched=batched, **kw)
    return jax.jit(eng.run), init()


def run_both(n_hosts, stop_ns, batched=True, **kw):
    run, init = jax_phold(n_hosts, batched, **kw)
    lj = jax_leaves(run(init, jnp.int64(stop_ns)))
    et, it = tphold.build(n_hosts, batched=batched, device="cpu", **kw)
    lt = convert.engine_state_to_numpy(et.run(it(), stop_ns))
    return lj, lt


# the configuration the window-level tests share with the "uniform" case
BASE = dict(msgs_per_host=4, seed=3)


CASES = {
    "uniform": dict(n_hosts=64, **BASE),
    "skewed": dict(n_hosts=64, msgs_per_host=4, seed=5, hot_hosts=4,
                   hot_weight=0.5),
    "drops": dict(n_hosts=32, msgs_per_host=12, seed=7, capacity=16,
                  hot_hosts=2, hot_weight=0.6),
}


@pytest.mark.parametrize("case", list(CASES))
def test_phold_matches_reference(case):
    kw = dict(CASES[case])
    lj, lt = run_both(kw.pop("n_hosts"), 2 * SECOND, **kw)
    assert_leaves_equal(lj, lt)
    assert lj["stats.n_executed"].sum() > 0
    if case == "drops":
        assert lj["queues.drops"].sum() > 0


def test_phold_fallback_round_matches_reference(monkeypatch):
    """A hot spot pushes more than MERGE_W events to one host per sweep,
    so the push takes the full-width (w = 64) fallback round, and
    capacity 64 overflows."""
    widths = []
    merge = tevents.merge.fused_merge

    def spy(*args):
        widths.append(args[5].shape[1])
        return merge(*args)

    monkeypatch.setattr(tevents.merge, "fused_merge", spy)
    lj, lt = run_both(32, SECOND, msgs_per_host=16, seed=9,
                      capacity=64, hot_hosts=1, hot_weight=0.9)
    assert_leaves_equal(lj, lt)
    assert 64 in widths and tevents.MERGE_W in widths
    assert lj["queues.drops"].sum() > 0


def test_unreliable_network_matches_reference():
    """Reliability rolls drop packets identically (n_net_dropped)."""
    def build(pkg_engine, pkg_phold, **dev):
        cfg = pkg_engine.EngineConfig(n_hosts=16, capacity=32,
                                      lookahead=50 * MS, max_emit=1,
                                      n_args=1, seed=11, drain_batch=24)
        return pkg_engine.Engine(
            cfg, [None], pkg_engine.ConstantNetwork(50 * MS, 0.8),
            batch_handler=pkg_phold.make_batch_handler(16, 10 * MS), **dev)

    ej = build(jengine, jphold)
    et = build(tengine, tphold, device="cpu")
    # same initial events, built by each package's PHOLD init
    _, ij = jphold.build(16, capacity=32, msgs_per_host=3, seed=11)
    _, it = tphold.build(16, capacity=32, msgs_per_host=3, seed=11,
                         device="cpu")
    lj = jax_leaves(jax.jit(ej.run)(ij(), jnp.int64(2 * SECOND)))
    lt = convert.engine_state_to_numpy(et.run(it(), 2 * SECOND))
    assert_leaves_equal(lj, lt)
    assert lj["stats.n_net_dropped"].sum() > 0


def test_step_window_matches_run_and_reference():
    stop = 1 * SECOND
    run, init = jax_phold(64, **BASE)
    et, it = tphold.build(64, batched=True, device="cpu", **BASE)
    st = it()
    steps = 0
    while int(st.now) < stop:
        st = et.step_window(st, stop)
        steps += 1
    stepped = convert.engine_state_to_numpy(st)
    assert_leaves_equal(convert.engine_state_to_numpy(et.run(it(), stop)),
                        stepped)
    assert_leaves_equal(jax_leaves(run(init, jnp.int64(stop))), stepped)
    assert steps == int(stepped["stats.n_windows"])
    # past the last event below stop, a step lands on stop and is a no-op
    again = convert.engine_state_to_numpy(et.step_window(st, stop))
    assert_leaves_equal(again, stepped)


def test_state_carries_across_packages():
    """A reference state converted mid-run continues bit-identically."""
    run, init = jax_phold(64, **BASE)
    et, _ = tphold.build(64, batched=True, device="cpu", **BASE)
    mid = run(init, jnp.int64(SECOND))
    st = convert.engine_state_from_numpy(jax_leaves(mid), "cpu")
    assert_leaves_equal(jax_leaves(mid), convert.engine_state_to_numpy(st))
    lt = convert.engine_state_to_numpy(et.run(st, 2 * SECOND))
    assert_leaves_equal(jax_leaves(run(mid, jnp.int64(2 * SECOND))), lt)


def test_state_summary_matches_reference():
    run, init = jax_phold(64, **BASE)
    et, it = tphold.build(64, batched=True, device="cpu", **BASE)
    want = jengine.state_summary(run(init, jnp.int64(SECOND)))
    assert tengine.state_summary(et.run(it(), SECOND)) == want


def test_unported_knobs_raise():
    # sharding is ported (tests/test_torch_shard.py): a shard count needs
    # an axis, and a sharded engine needs a mesh to run its collectives on
    with pytest.raises(ValueError, match="axis_name"):
        tengine.EngineConfig(n_hosts=4, capacity=8, lookahead=1, n_shards=2)
    with pytest.raises(RuntimeError, match="needs a mesh"):
        tengine.Engine(tengine.EngineConfig(n_hosts=4, capacity=8,
                                            lookahead=1, axis_name="x"),
                       [None], tengine.ConstantNetwork(1), device="cpu")
    # tracing and the stats plane are ported (tests/test_torch_trace.py,
    # tests/test_torch_stats.py); their knobs are range-checked as in the
    # reference
    for knob in (dict(trace=-1), dict(stats=-1), dict(trace_len_arg=9)):
        with pytest.raises(ValueError):
            tengine.EngineConfig(n_hosts=4, capacity=8, lookahead=1, **knob)
    eng, init = tphold.build(4, trace=4, stats=1, device="cpu")
    st = init()
    assert st.trace.time.shape == (4, 4 + 2) and st.splane is not None
    cfg = tengine.EngineConfig(n_hosts=4, capacity=8, lookahead=1)
    net = tengine.ConstantNetwork(1)
    # fault schedules are ported (tests/test_torch_faults.py); a crash
    # schedule without its restart template is refused
    crash = tfaults.compile_faults([tfaults.FaultSpec(type="crash",
                                                      start=1.0)],
                                   ["a", "b", "c", "d"], 4, 0, device="cpu")
    with pytest.raises(ValueError, match="fault_reset"):
        tengine.Engine(cfg, [None], net, faults=crash, device="cpu")
    # the chained drain, the CPU model, burst folding, the spill ring and
    # the frontier drain are ported (tests/test_torch_pressure.py and
    # tests/test_torch_frontier.py)
    tengine.Engine(cfg, [None], net, cpu_cost=[1, 1, 1, 1], device="cpu")
    for knob in (dict(spill=8), dict(frontier=2)):
        tengine.EngineConfig(n_hosts=4, capacity=8, lookahead=1, **knob)
    tengine.Engine(cfg, [None], net, frontier_kinds=(0,), device="cpu")
    assert tphold.build(8, spill=16, device="cpu")[1]().queues.spill.wr \
        .shape == (8,)
    tengine.EngineConfig(n_hosts=4, capacity=8, lookahead=1, burst=(0,))
    tphold.build(8, batched=False, device="cpu")


@functools.lru_cache(maxsize=None)
def bench_run(n_hosts, batched):
    """The bench shape for 20 sim-s in both packages (cached for the
    slow tests)."""
    return run_both(n_hosts, chip_smoke.BENCH_STOP_NS, batched,
                    **chip_smoke.BENCH)


@pytest.mark.slow
@pytest.mark.parametrize("n_hosts,pin", [
    (4096, chip_smoke.PIN_4096),
    (16384, chip_smoke.PIN_16384),
], ids=["4096", "16384"])
def test_bench_shape_parity_and_pins(n_hosts, pin):
    """bench.py's PHOLD (8 messages per host, capacity 64, seed 1234,
    20 sim-s) in both packages, at the `tpu_rate` shape (4096 hosts) and
    the `phold_big_worker` shape (16384): equal leaves, and the JAX/CPU
    pins chip_smoke.py holds the card to."""
    lj, lt = bench_run(n_hosts, True)
    assert_leaves_equal(lj, lt)
    events, digest = pin
    assert int(lj["stats.n_executed"].sum()) == events
    assert convert.leaves_digest(lj) == digest


@pytest.mark.slow
def test_chained_bench_shape_parity_and_pins():
    """The 4096-host bench shape on the chained drain (phold.build's
    default) to chip_smoke.CHAINED_STOP_NS in both packages: equal
    leaves, the batched run's state to the same stop less the scheduler
    counters, and the (events, inner steps, sweeps, digest) pin
    chip_smoke.py holds the card to."""
    stop = chip_smoke.CHAINED_STOP_NS
    lj, lt = run_both(4096, stop, False, **chip_smoke.BENCH)
    assert_leaves_equal(lj, lt)
    assert (int(lj["stats.n_executed"].sum()), int(lj["stats.n_inner_steps"]),
            int(lj["stats.n_sweeps"]), convert.leaves_digest(lj)) \
        == chip_smoke.PIN_CHAINED_4096
    batched, _ = run_both(4096, stop, True, **chip_smoke.BENCH)
    assert convert.leaves_digest(lj, chip_smoke.SCHEDULER) == \
        convert.leaves_digest(batched, chip_smoke.SCHEDULER)


@pytest.mark.slow
@pytest.mark.parametrize("which", ["cpu", "jitter"])
def test_variant_parity_and_pins(which):
    """chip_smoke's CPU-model and jittered-graph runs of PHOLD 4096 in
    both packages: equal leaves and the (events, digest) pins."""
    from shadow_tpu.net import topology as jtop
    from shadow_tpu_torch.net import topology as ttop

    stop = chip_smoke.VARIANT_STOP_NS
    ej, ij = chip_smoke.phold_variant(jphold, jengine, jtop, which, None)
    lj = jax_leaves(jax.jit(ej.run)(ij(), jnp.int64(stop)))
    et, it = chip_smoke.phold_variant(tphold, tengine, ttop, which, "cpu")
    lt = convert.engine_state_to_numpy(et.run(it(), stop))
    assert_leaves_equal(lj, lt)
    pin = {"cpu": chip_smoke.PIN_CPU_MODEL,
           "jitter": chip_smoke.PIN_JITTER}[which]
    assert (int(lj["stats.n_executed"].sum()),
            convert.leaves_digest(lj)) == pin


def test_leaves_digest_covers_names_and_dtypes():
    a = {"x": np.zeros(3, np.int32)}
    assert convert.leaves_digest(a) != convert.leaves_digest(
        {"x": np.zeros(3, np.int64)})
    assert convert.leaves_digest(a) != convert.leaves_digest(
        {"y": np.zeros(3, np.int32)})
    with pytest.raises(ValueError):
        convert.engine_state_from_numpy(
            dict(a, **{k: v for k, v in convert.engine_state_to_numpy(
                tphold.build(4, device="cpu")[1]()).items()}), "cpu")
