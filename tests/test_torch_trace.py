"""The event trace of shadow_tpu_torch (`obs.trace`, the engine's trace
branches) against shadow_tpu, leaf for leaf and record for record.

- PHOLD on the batched and chained drains with `trace` and `stats` on,
  drained into a TraceDrain at each segment: every state leaf (the ring
  whole, its scratch columns included), the drained records, `lost` and
  `truncated`;
- a ring too small for its records: truncation, the records lost, and
  the scratch bytes that overflowing appends write past the capacity;
- DROP records through topology loss (chip_smoke.py's jittered, lossy
  graph at 64 hosts on the chained drain);
- the frontier drain's deferred per-round append on a raw engine whose
  runs hold several positions, and FDROP records through a fault (TGen
  under a loss spike), whose records equal the chained drain's;
- OP_SPILL and OP_REFILL records through `PressureController.
  attach_trace` on a spilling PHOLD run;
- `tools/export_trace` writes the reference exporter's bytes for the
  same records, and `tools/critical_path` gives its report;
- slow: chip_smoke.py's phase 18 pins (PHOLD 4096 on the chained drain
  over the lossy graph, the skew shape with a spill ring, TGen 4096 on
  the frontier drain).

Every comparison is exact, dtypes included.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from shadow_tpu import config as jconfig
from shadow_tpu import sim as jsim
from shadow_tpu.core import engine as jengine
from shadow_tpu.core.events import Events as JEvents
from shadow_tpu.models import phold as jphold
from shadow_tpu.net import topology as jtopology
from shadow_tpu.obs import trace as jtrace
from shadow_tpu.runtime import pressure as jp
from shadow_tpu.tools import critical_path as jcritical
from shadow_tpu.tools import export_trace as jexport
from shadow_tpu_torch import config as tconfig
from shadow_tpu_torch import convert
from shadow_tpu_torch import sim as tsim
from shadow_tpu_torch.core import engine as tengine
from shadow_tpu_torch.core.events import Events
from shadow_tpu_torch.models import phold as tphold
from shadow_tpu_torch.net import topology as ttopology
from shadow_tpu_torch.obs import trace as ttrace
from shadow_tpu_torch.obs.profiler import WindowProfiler
from shadow_tpu_torch.runtime import pressure as tp
from shadow_tpu_torch.tools import critical_path as tcritical
from shadow_tpu_torch.tools import export_trace as texport
from test_faults import echo_config
from test_torch_chained import JToy, jax_toy
from test_torch_phold import assert_leaves_equal, jax_leaves
from test_torch_tcp import one_torch_thread  # noqa: F401 (autouse)
from torch_toy import LAT, PING, TOY, TToy, toy_config, toy_initial, torch_toy

SECOND = 1_000_000_000
PHOLD = dict(msgs_per_host=4, seed=5, capacity=32)


def assert_records_equal(dj, dt):
    rj, rt = dj.records(), dt.records()
    assert rj.keys() == rt.keys()
    for key in rj:
        assert rj[key].dtype == rt[key].dtype, key
        np.testing.assert_array_equal(rj[key], rt[key], err_msg=key)
    assert (dj.lost, dj.truncated, dj.n_records) == (
        dt.lost, dt.truncated, dt.n_records)


def segments(jrun, jst, trun, tst, stops, jd, td):
    """Run both packages through `stops`, draining each ring after each
    stop, holding every leaf equal at each; returns the final states."""
    for stop in stops:
        jst, tst = jrun(jst, stop), trun(tst, stop)
        assert_leaves_equal(jax_leaves(jst), convert.engine_state_to_numpy(tst))
        jst, tst = jd.drain_state(jst), td.drain_state(tst)
    return jst, tst


@functools.lru_cache(maxsize=None)
def phold_traced(batched, cap, stats=1):
    """PHOLD at 32 hosts with a `cap`-record ring, run to 0.5 and 1 s in
    both packages: (reference drain, port drain, port leaves)."""
    kw = dict(PHOLD, trace=cap, stats=stats, batched=batched)
    eng, init = jphold.build(32, **kw)
    teng, tinit = tphold.build(32, device="cpu", **kw)
    jd, td = jtrace.TraceDrain(cap), ttrace.TraceDrain(cap)
    run = jax.jit(eng.run)
    _, tst = segments(lambda s, t: run(s, jnp.int64(t)), init(),
                      teng.run, tinit(), (SECOND // 2, SECOND), jd, td)
    return jd, td, convert.engine_state_to_numpy(tst)


@pytest.mark.parametrize("batched", [True, False], ids=["batched", "chained"])
def test_phold_trace_matches_reference(batched):
    jd, td, lt = phold_traced(batched, 256)
    assert_records_equal(jd, td)
    recs = td.records()
    ops = np.bincount(recs["op"], minlength=6)
    assert ops[ttrace.OP_EXEC] == lt["stats.n_executed"].sum()
    assert ops[ttrace.OP_SEND] > 0 and td.lost == 0
    # the slack is the drain's widest append: a sweep's B = 24 executed
    # events and their emits (K = 1), or one inner step's 1 + K records
    slack = lt["trace.time"].shape[1] - 256
    assert slack == (24 * 2 if batched else 2)


@pytest.mark.parametrize("batched", [True, False], ids=["batched", "chained"])
def test_trace_overflow_truncates_as_reference(batched):
    """A 3-record ring: rows stop at their capacity, `wr` keeps counting,
    and the overflowing appends write their rows into the scratch zone
    (compared whole as ring leaves at each segment)."""
    jd, td, lt = phold_traced(batched, 3, stats=0)
    assert_records_equal(jd, td)
    assert td.truncated and td.lost > 0
    assert td.n_records <= 3 * 32 * 2
    assert lt["trace.wr"].max() == 0  # drained and reset
    assert (lt["trace.op"][:, 3:] != 0).any() or (
        lt["trace.time"][:, 3:] != 0).any()


def test_drop_records_on_a_lossy_graph():
    """The jittered, lossy graph of chip_smoke.py's phase 8 at 64 hosts
    on the chained drain: reliability rolls drop sends, traced as DROP
    on the source row."""
    cap = 128
    on = dict(trace=cap, stats=1)
    ej, ij = chip_smoke.phold_variant(jphold, jengine, jtopology, "jitter",
                                      None, n_hosts=64, **on)
    et, it = chip_smoke.phold_variant(tphold, tengine, ttopology, "jitter",
                                      "cpu", n_hosts=64, **on)
    jd, td = jtrace.TraceDrain(cap), ttrace.TraceDrain(cap)
    run = jax.jit(ej.run)
    segments(lambda s, t: run(s, jnp.int64(t)), ij(), et.run, it(),
             (SECOND // 2, SECOND), jd, td)
    assert_records_equal(jd, td)
    recs = td.records()
    drops = recs["op"] == ttrace.OP_DROP
    assert drops.sum() > 0
    # a drop sits on the sender's row at its emission time
    np.testing.assert_array_equal(recs["owner"][drops], recs["src"][drops])


def toy_frontier(**kw):
    """(reference engine, its initial state, port engine, its initial
    state) of torch_toy's hot-peers toy on the frontier drain at
    frontier=4, frontier_kinds = PING (TICK chains run one position per
    round), with `kw` (trace, stats) in both configs."""
    name = "hot-peers"
    n, msgs, peers = TOY[name][:3]
    cfg = dict(toy_config(name), frontier=4, **kw)
    et = tengine.Engine(tengine.EngineConfig(**cfg), torch_toy(peers),
                        tengine.ConstantNetwork(LAT), frontier_kinds=(PING,),
                        device="cpu")
    z = torch.zeros((n,), dtype=torch.int64)
    tinit = et.init_state(TToy(z, z, z), Events(**{
        k: torch.from_numpy(v) for k, v in toy_initial(n, msgs).items()}))
    ej = jengine.Engine(jengine.EngineConfig(**cfg), jax_toy(peers),
                        jengine.ConstantNetwork(LAT), frontier_kinds=(PING,))
    zj = jnp.zeros((n,), jnp.int64)
    jinit = ej.init_state(JToy(zj, zj, zj), JEvents(**{
        k: jnp.asarray(v) for k, v in toy_initial(n, msgs).items()}))
    return ej, jinit, et, tinit


def test_frontier_trace_matches_reference():
    """The frontier drain's per-round append of 4 x (1 + K) lanes, padded
    past the positions that ran, leaves the reference's ring."""
    ej, jinit, et, tinit = toy_frontier(trace=64, stats=1)
    jd, td = jtrace.TraceDrain(64), ttrace.TraceDrain(64)
    run = jax.jit(ej.run)
    _, tst = segments(lambda s, t: run(s, jnp.int64(t)), jinit, et.run,
                      tinit, (15_000_000, 30_000_000), jd, td)
    assert_records_equal(jd, td)
    assert et._trace_slack() == 4 * (1 + 2)
    lt = convert.engine_state_to_numpy(tst)
    assert lt["splane.runlen_n"].sum() > 0


def test_fault_drops_on_the_frontier_drain_match_reference():
    """TGen under a loss spike (tests/test_faults.py's echo) on the
    frontier drain: FDROP records on the sender's row, equal to the
    reference's frontier run, and the same records as the port's
    chained run."""
    text = echo_config('<fault type="loss" src="*" dst="*" loss="0.6" '
                       'start="4" end="8"/>', count=3, stoptime=9)
    kw = dict(seed=11, trace=512, stats=1)
    js = jsim.build_simulation(jconfig.parse_config(text), frontier=16, **kw)
    jd = jtrace.TraceDrain(512)
    lj = jax_leaves(jd.drain_state(js.run()))
    drains = {}
    for frontier in (16, 0):
        ts = tsim.build_simulation(tconfig.parse_config(text), device="cpu",
                                   frontier=frontier, **kw)
        drains[frontier] = ttrace.TraceDrain(512)
        lt = convert.engine_state_to_numpy(
            drains[frontier].drain_state(ts.run()))
        if frontier:
            assert_leaves_equal(lj, lt)
    assert_records_equal(jd, drains[16])
    assert_records_equal(drains[16], drains[0])
    recs = drains[16].records()
    assert (recs["op"] == ttrace.OP_FDROP).sum() > 0
    # rounds that ran several positions: their lanes, padded to 16
    # positions, went in as one append
    assert lj["splane.runlen_n"][:, 2:].sum() > 0
    assert ts.engine.cfg.trace_len_arg == 5


def spill_traced(pkg):
    """tests/test_torch_pressure.py's spilling PHOLD (16 hosts, capacity
    8, a 32-slot ring) with trace and stats on and the controller's
    records attached: (drain, leaves)."""
    kw = dict(capacity=8, spill=32, batched=True, hot_hosts=4,
              hot_weight=0.6, msgs_per_host=2, trace=256, stats=1)
    if pkg == "jax":
        eng, init = jphold.build(16, **kw)
        ctrl = jp.PressureController(16, 8, eng.cfg.lookahead,
                                     n_args=jphold.N_PHOLD_ARGS)
        drain = jtrace.TraceDrain(256)
        ctrl.attach_trace(drain, len_arg=eng.cfg.trace_len_arg)
        st = jp.run_with_spill(eng, init(), 400_000_000, ctrl)
        return drain, jax_leaves(drain.drain_state(st))
    eng, init = tphold.build(16, device="cpu", **kw)
    ctrl = tp.PressureController(16, 8, eng.cfg.lookahead,
                                 n_args=tphold.N_PHOLD_ARGS)
    drain = ttrace.TraceDrain(256)
    ctrl.attach_trace(drain, len_arg=eng.cfg.trace_len_arg)
    st = tp.run_with_spill(eng, init(), 400_000_000, ctrl)
    return drain, convert.engine_state_to_numpy(drain.drain_state(st))


def test_spill_and_refill_records_match_reference():
    (jd, lj), (td, lt) = spill_traced("jax"), spill_traced("torch")
    assert_leaves_equal(lj, lt)
    assert_records_equal(jd, td)
    ops = np.bincount(td.records()["op"], minlength=6)
    assert ops[ttrace.OP_SPILL] > 0 and ops[ttrace.OP_REFILL] > 0
    # every harvested event was traced once as spilled
    assert ops[ttrace.OP_SPILL] == lt["queues.spill.n_spilled"].sum()
    interval = td.take_interval()
    assert interval["spill"].sum() == ops[ttrace.OP_SPILL]
    assert td.take_interval() is None


def test_export_and_critical_path_match_reference(tmp_path):
    """The same drained records saved by each package's TraceDrain (with a
    profiler's wall-time spans) export to the same bytes and analyze to
    the same critical path."""
    jd, td, _ = phold_traced(False, 256)
    prof = WindowProfiler()
    for name in ("build", "step", "step"):
        with prof.phase(name):
            pass
    names = [f"peer{i}" for i in range(32)]
    meta = {}
    for pkg, d in (("jax", jd), ("torch", td)):
        d.names, d.kind_names = names, ["phold"]
        meta[pkg] = d.save(str(tmp_path / f"{pkg}.npz"),
                           profile=prof.export(), extra_meta={"seed": 5})
    assert meta["jax"] == meta["torch"]
    out = {}
    for pkg, mod in (("jax", jexport), ("torch", texport)):
        path = str(tmp_path / f"{pkg}.json")
        mod.export(str(tmp_path / "torch.npz"), path)
        out[pkg] = open(path, "rb").read()
    assert out["jax"] == out["torch"]
    doc = json.loads(out["torch"])
    assert any(e.get("ph") == "s" for e in doc["traceEvents"])
    recs, m = ttrace.load_trace(str(tmp_path / "torch.npz"))
    rj, mj = jtrace.load_trace(str(tmp_path / "jax.npz"))
    assert tcritical.analyze(recs, m) == jcritical.analyze(rj, mj)
    # with a serve flight ledger beside the device trace: one merged
    # file, the reference's byte for byte
    ledger = tmp_path / "serve.jsonl"
    ledger.write_text(
        '{"ledger_version": 1, "plane": "serve"}\n'
        '{"kind": "span", "name": "beat", "t_s": 0.5, "dur_s": 0.25, '
        '"launch": 1, "cls": "c", "beat": 1, "lanes": [{"lane": 0, '
        '"rid": "r000000", "now_ns": 400000}]}\n'
        '{"kind": "event", "name": "result", "t_s": 0.9, "dur_s": 0.0, '
        '"rid": "r000000", "status": "done"}\n')
    for pkg, mod in (("jax", jexport), ("torch", texport)):
        path = str(tmp_path / f"{pkg}.merged.json")
        mod.export(str(tmp_path / "torch.npz"), path,
                   ledger_path=str(ledger))
        out[pkg] = open(path, "rb").read()
    assert out["jax"] == out["torch"]
    assert {e["pid"] for e in json.loads(out["torch"])["traceEvents"]} \
        >= {0, 2, 3}


# -- the slow pins: chip_smoke.py's phase 18 ---------------------------------
@pytest.mark.slow
def test_phase18_chained_pin():
    torch.set_num_threads(4)
    cap = chip_smoke.TRACE_CHAINED_CAP
    ej, ij = chip_smoke.phold_variant(jphold, jengine, jtopology, "jitter",
                                      None, trace=cap, stats=1)
    et, it = chip_smoke.phold_variant(tphold, tengine, ttopology, "jitter",
                                      "cpu", trace=cap, stats=1)
    jd, td = jtrace.TraceDrain(cap), ttrace.TraceDrain(cap)
    run = jax.jit(ej.run)
    jst, tst = segments(lambda s, t: run(s, jnp.int64(t)), ij(), et.run,
                        it(), [s * SECOND for s in chip_smoke.TRACE_SEGMENTS_S],
                        jd, td)
    assert_records_equal(jd, td)
    lj = jax_leaves(jst)
    assert chip_smoke.trace_pin(lj, jd) == chip_smoke.PIN_TRACE_CHAINED


@pytest.mark.slow
def test_phase18_spill_pin():
    torch.set_num_threads(4)
    cap = chip_smoke.TRACE_SPILL_CAP
    kw = dict(batched=True, spill=chip_smoke.SKEW_SPILL, trace=cap, stats=1,
              **dict(chip_smoke.SKEW, capacity=chip_smoke.SKEW_CAPACITY))
    out = {}
    for pkg, phold, pressure, trace, on in (
            ("jax", jphold, jp, jtrace, {}),
            ("torch", tphold, tp, ttrace, {"device": "cpu"})):
        eng, init = phold.build(4096, **on, **kw)
        ctrl = pressure.PressureController(4096, chip_smoke.SKEW_CAPACITY,
                                           eng.cfg.lookahead,
                                           n_args=phold.N_PHOLD_ARGS)
        drain = trace.TraceDrain(cap)
        ctrl.attach_trace(drain, len_arg=eng.cfg.trace_len_arg)
        st = drain.drain_state(pressure.run_with_spill(
            eng, init(), chip_smoke.SKEW_STOP_NS, ctrl))
        leaves = (jax_leaves(st) if pkg == "jax"
                  else convert.engine_state_to_numpy(st))
        out[pkg] = (leaves, drain)
    assert_leaves_equal(out["jax"][0], out["torch"][0])
    assert_records_equal(out["jax"][1], out["torch"][1])
    assert chip_smoke.trace_pin(*out["jax"]) == chip_smoke.PIN_TRACE_SPILL


@pytest.mark.slow
def test_phase18_frontier_pin():
    torch.set_num_threads(4)
    cap = chip_smoke.TRACE_FRONTIER_CAP
    text = chip_smoke.tgen_config(chip_smoke.TGEN_PAIRS)
    kw = dict(seed=chip_smoke.TGEN_SEED, n_sockets=chip_smoke.TGEN_SOCKETS,
              capacity=chip_smoke.TGEN_CAPACITY,
              frontier=chip_smoke.TGEN_FRONTIER, trace=cap, stats=1)
    stop = chip_smoke.TRACE_FRONTIER_STOP_S * SECOND
    js = jsim.build_simulation(jconfig.parse_config(text), **kw)
    ts = tsim.build_simulation(tconfig.parse_config(text), device="cpu",
                               **kw)
    jd, td = jtrace.TraceDrain(cap), ttrace.TraceDrain(cap)
    lj = jax_leaves(jd.drain_state(js.run(stop)))
    lt = convert.engine_state_to_numpy(td.drain_state(ts.run(stop)))
    assert_leaves_equal(lj, lt)
    assert_records_equal(jd, td)
    assert chip_smoke.trace_pin(lj, jd) == chip_smoke.PIN_TRACE_FRONTIER
