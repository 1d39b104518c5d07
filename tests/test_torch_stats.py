"""The stats plane, the invariant guard and the profiler of
shadow_tpu_torch against shadow_tpu, and the cost of observability off.

- `bucket_of` at 0, negatives, 2^i - 1, 2^i, 2^62 and I64MAX;
- the plane's leaves on the batched and chained drains (PHOLD) and the
  frontier drain (a raw engine whose runs span positions), with stats on
  and trace off;
- `stats_device_refs`, `summarize`, `percentile`, `stats_row` and
  `parse_hist` on those planes, against the reference's;
- trace=0 and stats=0 keep today's launching operations, host syncs and
  merge calls exactly (pinned from the tree before observability was
  ported) and the reference's leaf list; a traced, stats-on run's
  launching operations per inner step beside the same run without;
- `validate` passes on sound states, and each corruption (an unsorted
  row, an empty slot ahead of a live one, NaN, a negative counter, a
  clock that runs backwards, broken spill accounting) gives the
  reference's violations, leaf paths included;
- `WindowProfiler`'s summary and export keys, and `Simulation.summary`'s
  "profile".

Every comparison is exact, dtypes included.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from shadow_tpu import config as jconfig
from shadow_tpu import sim as jsim
from shadow_tpu.models import phold as jphold
from shadow_tpu.obs import profiler as jprofiler
from shadow_tpu.obs import stats as jstats
from shadow_tpu.runtime import invariants as jinv
from shadow_tpu.runtime import pressure as jp
from shadow_tpu_torch import config as tconfig
from shadow_tpu_torch import convert
from shadow_tpu_torch import examples as texamples
from shadow_tpu_torch import sim as tsim
from shadow_tpu_torch.core import events as tevents
from shadow_tpu_torch.models import phold as tphold
from shadow_tpu_torch.obs import profiler as tprofiler
from shadow_tpu_torch.obs import stats as tstats
from shadow_tpu_torch.runtime import invariants as tinv
from shadow_tpu_torch.runtime import pressure as tp
from test_torch_phold import assert_leaves_equal, jax_leaves
from test_torch_tcp import one_torch_thread  # noqa: F401 (autouse)
from test_torch_tgen import LaunchCount
from test_torch_trace import toy_frontier

SECOND = 1_000_000_000
I64MAX = (1 << 63) - 1
PHOLD = dict(msgs_per_host=4, seed=5, capacity=32)


def test_bucket_of_matches_reference():
    edges = [0, -1, -(1 << 40), 1 << 62, I64MAX, (1 << 62) - 1]
    for i in range(63):
        edges += [(1 << i) - 1, 1 << i]
    v = np.array(edges, np.int64)
    want = np.asarray(jstats.bucket_of(jnp.asarray(v)))
    got = tstats.bucket_of(torch.from_numpy(v)).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert got[0] == 0 and got[3] == 63 and got[4] == 63 and got[5] == 62


@functools.lru_cache(maxsize=None)
def phold_planes(batched):
    """(reference leaves, port leaves) of PHOLD at 32 hosts to 1 s with
    the stats plane on."""
    kw = dict(PHOLD, stats=1, batched=batched)
    eng, init = jphold.build(32, **kw)
    lj = jax_leaves(jax.jit(eng.run)(init(), jnp.int64(SECOND)))
    teng, tinit = tphold.build(32, device="cpu", **kw)
    return lj, convert.engine_state_to_numpy(teng.run(tinit(), SECOND))


@functools.lru_cache(maxsize=None)
def toy_planes():
    """The same for a raw engine on the frontier drain (frontier=4)."""
    ej, jinit, et, tinit = toy_frontier(stats=1)
    stop = 30_000_000
    lj = jax_leaves(jax.jit(ej.run)(jinit, jnp.int64(stop)))
    return lj, convert.engine_state_to_numpy(et.run(tinit, stop))


PLANES = {"batched": lambda: phold_planes(True),
          "chained": lambda: phold_planes(False),
          "frontier": toy_planes}


@pytest.mark.parametrize("drain", list(PLANES))
def test_plane_matches_reference(drain):
    lj, lt = PLANES[drain]()
    assert_leaves_equal(lj, lt)
    for fam in ("wait", "net", "occ", "qfill"):
        assert lt[f"splane.{fam}_n"].sum() > 0, fam
    assert (lt["splane.runlen_n"].sum() > 0) == (drain == "frontier")
    assert not any(k.startswith("trace.") for k in lt)


def plane_of(leaves, mod):
    """A StatPlane of `mod` (either package) from numpy leaves."""
    fields = {f.name: leaves[f"splane.{f.name}"]
              for f in dataclasses.fields(mod.StatPlane)}
    if mod is tstats:
        return mod.StatPlane(**{k: torch.from_numpy(v)
                                for k, v in fields.items()})
    return mod.StatPlane(**{k: jnp.asarray(v) for k, v in fields.items()})


@pytest.mark.parametrize("drain", list(PLANES))
def test_summaries_match_reference(drain):
    lj, lt = PLANES[drain]()
    fj = jax.device_get(jstats.stats_device_refs(plane_of(lj, jstats)))
    ft = {k: v.numpy() for k, v in
          tstats.stats_device_refs(plane_of(lt, tstats)).items()}
    assert fj.keys() == ft.keys()
    for key in fj:
        np.testing.assert_array_equal(np.asarray(fj[key]), ft[key])
    sj, st = jstats.summarize(fj), tstats.summarize(ft)
    assert sj == st
    assert jstats.stats_row(2.5, sj) == tstats.stats_row(2.5, st)
    for fam in tstats.FAMILY_KEYS:
        b = np.asarray(ft[f"{fam}_bucket"])
        for q in (0.0, 0.5, 0.95, 1.0):
            assert tstats.percentile(b, q) == jstats.percentile(b, q)
        cell = "|".join(f"{i}:{c}" for i, c in st[fam]["buckets"])
        np.testing.assert_array_equal(tstats.parse_hist(cell),
                                      jstats.parse_hist(cell))
        np.testing.assert_array_equal(tstats.parse_hist(cell), b)
    assert tstats.STATS_HEADER == jstats.STATS_HEADER
    assert tstats.BUCKET_LE_LABELS == jstats.BUCKET_LE_LABELS
    assert tstats.FAMILIES == jstats.FAMILIES


# -- observability off ---------------------------------------------------------
# (launching torch operations, host syncs, merge calls) of each run with
# trace=0 and stats=0, measured on the tree before tracing and the stats
# plane were ported: PHOLD at 32 hosts (PHOLD) to 0.5 s on each drain,
# and chip_smoke.py's phase-16 config at 2 pairs from 4.6 to 5.0 s on the
# chained and frontier drains. The CPU runs count the merge's plain
# version too: since it compares only the incoming columns that hold an
# event and counts each slot's incoming by a scatter and a running sum,
# a merge call launches 8 operations more than the pins first counted
# (13,915, 92,649, 120,073 and 122,083 operations)
OFF_PINS = {
    "phold_batched": (13_995, 41, 10),
    "phold_chained": (92_729, 130, 10),
    "tgen_faults_chained": (120_137, 85, 8),
    "tgen_faults_frontier": (122_147, 139, 8),
}


def off_runs(trace=0, stats=0):
    """{name: (engine, state, stop)} of the OFF_PINS runs at `trace` and
    `stats`, each state at the start of its measured span."""
    out = {}
    for batched in (True, False):
        eng, init = tphold.build(32, batched=batched, device="cpu",
                                 trace=trace, stats=stats, **PHOLD)
        out["phold_batched" if batched else "phold_chained"] = (
            eng, init(), SECOND // 2)
    text = chip_smoke.tgen_faults_config(2)
    for frontier, name in ((0, "chained"), (16, "frontier")):
        sim = tsim.build_simulation(
            tconfig.parse_config(text), seed=1, n_sockets=8, capacity=768,
            device="cpu", frontier=frontier, trace=trace, stats=stats)
        st = sim.engine.run(sim.state0, int(4.6 * SECOND))
        out[f"tgen_faults_{name}"] = (sim.engine, st, int(5.0 * SECOND))
    return out


def measure(eng, st, stop):
    """(launching ops, host syncs, merge calls, inner steps or, on the
    batched drain, sweeps, final state) of one run."""
    calls = [0]
    fused = tevents.merge.fused_merge

    def count(*args):
        calls[0] += 1
        return fused(*args)

    tevents.merge.fused_merge = count
    try:
        steps = lambda s: int(s.stats.n_inner_steps if
                              eng.batch_handler is None else s.stats.n_sweeps)
        s0, i0 = eng.host_syncs, steps(st)
        with LaunchCount() as lc:
            st = eng.run(st, stop)
        return (sum(lc.ops.values()), eng.host_syncs - s0, calls[0],
                steps(st) - i0, st)
    finally:
        tevents.merge.fused_merge = fused


def test_observability_off_costs_nothing():
    """With trace=0 and stats=0 each run launches the operations, reads
    the flags and calls the merge exactly as before the port of
    observability, and its state has the reference's leaves (no trace or
    splane subtree)."""
    for name, (eng, st, stop) in off_runs().items():
        ops, syncs, merges, _, st = measure(eng, st, stop)
        assert (ops, syncs, merges) == OFF_PINS[name], name
        assert st.trace is None and st.splane is None
        keys = convert.engine_state_to_numpy(st).keys()
        assert not any(k.startswith(("trace.", "splane.")) for k in keys)
    eng, init = jphold.build(32, batched=True, **PHOLD)
    lj = jax_leaves(jax.jit(eng.run)(init(), jnp.int64(SECOND // 2)))
    teng, tinit = tphold.build(32, batched=True, device="cpu", **PHOLD)
    assert lj.keys() == convert.engine_state_to_numpy(
        teng.run(tinit(), SECOND // 2)).keys()


def test_traced_launches_per_inner_step():
    """Tracing and the stats plane add launching operations per inner
    step (per sweep on the batched drain, per position on the frontier
    drain) but no host sync and no merge call; printed beside the
    untraced runs."""
    on = off_runs(trace=64, stats=1)
    rows = {}
    for name, (eng, st, stop) in on.items():
        ops, syncs, merges, steps, _ = measure(eng, st, stop)
        off_ops, off_syncs, off_merges = OFF_PINS[name]
        assert (syncs, merges) == (off_syncs, off_merges), name
        assert ops > off_ops, name
        rows[name] = (round(off_ops / steps), round(ops / steps), steps)
    print(f"launching operations per inner step, (off, on, steps): {rows}")


# -- invariants ----------------------------------------------------------------
def spill_pair():
    """tests/test_torch_pressure.py's spilling PHOLD run in both packages
    (16 hosts, capacity 8, a 32-slot ring): (reference state and
    controller, port state and controller)."""
    kw = dict(capacity=8, spill=32, batched=True, hot_hosts=4,
              hot_weight=0.6, msgs_per_host=2)
    eng, init = jphold.build(16, **kw)
    cj = jp.PressureController(16, 8, eng.cfg.lookahead,
                               n_args=jphold.N_PHOLD_ARGS)
    sj = jp.run_with_spill(eng, init(), 200_000_000, cj)
    teng, tinit = tphold.build(16, device="cpu", **kw)
    ct = tp.PressureController(16, 8, teng.cfg.lookahead,
                               n_args=tphold.N_PHOLD_ARGS)
    st = tp.run_with_spill(teng, tinit(), 200_000_000, ct)
    return sj, cj, st, ct


def _set(state, path, fn, pkg):
    """`state` with the leaf at dotted `path` replaced by fn(numpy copy)."""
    head, _, rest = path.partition(".")
    sub = getattr(state, head)
    if rest:
        return dataclasses.replace(state, **{head: _set(sub, rest, fn, pkg)})
    a = fn(np.array(sub))
    new = jnp.asarray(a) if pkg == "jax" else torch.from_numpy(a)
    return dataclasses.replace(state, **{head: new})


def _unsort(a):
    a[3, 0], a[3, 1] = a[3, 1], a[3, 0]
    return a


def _hole(a):
    a[2, 0] = I64MAX
    return a


def _nan(a):
    a[1] = np.nan
    return a


def _negative(a):
    a[5] = -7
    return a


CORRUPTIONS = {
    "unsorted-row": ("queues.time", _unsort),
    "empty-ahead": ("queues.time", _hole),
    "negative-counter": ("stats.n_executed", _negative),
    "negative-seq": ("src_seq", _negative),
    "spill-accounting": ("queues.spill.n_spilled", _negative),
}


def test_validate_passes_sound_states():
    sj, cj, st, ct = spill_pair()
    assert jinv.check_state(sj, pressure=cj) == []
    assert tinv.check_state(st, pressure=ct) == []
    now = tinv.validate(st, pressure=ct)
    assert now == jinv.validate(sj, pressure=cj) == int(st.now)
    # the clock may not run backwards between validations
    assert tinv.check_state(st, prev_now=now + 1) == jinv.check_state(
        sj, prev_now=now + 1) != []
    drops = np.full((16,), 10**6, np.int64)
    assert tinv.check_state(st, prev_drops=drops) == jinv.check_state(
        sj, prev_drops=drops) != []


@pytest.mark.parametrize("name", list(CORRUPTIONS))
def test_violations_match_reference(name):
    path, fn = CORRUPTIONS[name]
    sj, cj, st, ct = spill_pair()
    bj = _set(sj, path, fn, "jax")
    bt = _set(st, path, fn, "torch")
    want = jinv.check_state(bj, pressure=cj)
    got = tinv.check_state(bt, pressure=ct)
    assert got == want and got
    with pytest.raises(tinv.InvariantViolation) as err:
        tinv.validate(bt, pressure=ct)
    assert got[0] in str(err.value)


def test_nan_names_the_reference_leaf():
    """A NaN in a float leaf of a TCP build's hosts: the violation names
    the reference's keystr of that leaf and its index."""
    text = texamples.tgen_example(2, stoptime=3)
    nan = lambda a: np.where(np.arange(a.size).reshape(a.shape) == 1,
                             np.nan, a).astype(a.dtype)
    ts = tsim.build_simulation(tconfig.parse_config(text), device="cpu",
                               n_sockets=4)
    js = jsim.build_simulation(jconfig.parse_config(text), n_sockets=4)
    got = tinv.check_state(_set(ts.state0, "hosts.net.tcb.cwnd", nan,
                                "torch"))
    want = jinv.check_state(_set(js.state0, "hosts.net.tcb.cwnd", nan,
                                 "jax"))
    assert got == want and got[0].startswith(".hosts.net.tcb.cwnd[")
    assert tinv.keystr("hosts.app.subs.0.gid") == ".hosts.app.subs[0].gid"


# -- the profiler --------------------------------------------------------------
def test_profiler_keys_match_reference():
    out = {}
    for pkg, mod in (("jax", jprofiler), ("torch", tprofiler)):
        prof = mod.WindowProfiler()
        with prof.phase("step"):
            pass
        prof.observe({"now_ns": 5, "windows": 2, "executed": 10,
                      "sweeps": 4}, queue_fill=0.5)
        out[pkg] = (prof.summary(), prof.export())
    (sj, ej), (st, et) = out["jax"], out["torch"]
    assert st.keys() == sj.keys()
    assert st["phases"].keys() == sj["phases"].keys() == {"step"}
    assert st["phases"]["step"].keys() == sj["phases"]["step"].keys()
    assert st["occupancy"] == sj["occupancy"]
    assert et.keys() == ej.keys() and et["occupancy"] == ej["occupancy"]
    assert tprofiler.PHASES == jprofiler.PHASES
    cfg = tconfig.parse_config(texamples.phold_example(8, 1, 2))
    prof = tprofiler.WindowProfiler()
    ts = tsim.build_simulation(cfg, device="cpu", profiler=prof)
    summary = ts.summary(ts.run(SECOND))
    assert summary["profile"]["phases"]["step"]["count"] == 1
    assert tprofiler.queue_fill(ts.state0) == pytest.approx(
        float(np.mean(convert.engine_state_to_numpy(ts.state0)[
            "queues.time"] != I64MAX)))
