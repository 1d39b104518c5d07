"""Fault injection in shadow_tpu_torch against shadow_tpu, leaf for leaf.

- `compile_faults`: all six fault types, `frac < 1`, churn phases,
  symmetric link groups, `end=None`, `restart=False`, padded rows and
  the `has_*` flags; every tensor and the three host-side helpers equal
  the reference's;
- `parse_fault_attrs`, `parse_fault_dsl` and the `<fault>` element agree
  with the reference's, with the same ValueErrors;
- the engine's overlays, one parametrised test: crash with restart (and
  churn) on the batched, chained and frontier drains, loss, latency and
  partition through `_route` on each drain, and a fault-free build whose
  host syncs and merge calls are those of the build before faults were
  ported; with faults on, the epoch test costs no read of its own;
- bandwidth faults through `build_simulation` over UDP, including one
  starting at 0 s, which the epoch watermark applies only once the epoch
  first changes.

Every comparison is exact, dtypes included.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_tpu import config as jconfig
from shadow_tpu import examples as jexamples
from shadow_tpu import sim as jsim
from shadow_tpu.core import engine as jengine
from shadow_tpu.core.events import Events as JEvents
from shadow_tpu.faults import schedule as jsched
from shadow_tpu.models import phold as jphold
from shadow_tpu_torch import config as tconfig
from shadow_tpu_torch import convert
from shadow_tpu_torch import examples as texamples
from shadow_tpu_torch import sim as tsim
from shadow_tpu_torch.core import engine as tengine
from shadow_tpu_torch.core import events as tevents
from shadow_tpu_torch.core.events import Events
from shadow_tpu_torch.faults import schedule as tsched
from shadow_tpu_torch.models import phold as tphold
from test_torch_chained import JToy, jax_toy
from test_torch_phold import (  # noqa: F401 (one_torch_thread: autouse)
    assert_leaves_equal, jax_leaves, one_torch_thread)
from torch_toy import (
    LAT, PING, TOY, TOY_STOP, TToy, toy_config, toy_initial, torch_toy,
)

SECOND = 1_000_000_000

# -- the schedule compiler ----------------------------------------------------
SPECS = [
    dict(type="churn", hosts="s*", start=1.0, end=9.0, period=2.0,
         downtime=0.5, frac=0.5),
    dict(type="crash", hosts="c1 c2", start=3.0),
    dict(type="crash", hosts="c3", start=2.0, end=4.0, restart=False),
    dict(type="crash", hosts="s1*", start=6.5, end=7.0, frac=0.7),
    dict(type="partition", src="c*3", dst="s*", start=5, end=7),
    dict(type="loss", src="c*", dst="*", loss=0.3, start=4, end=8),
    dict(type="loss", src="s2", dst="c4", loss=0.5, start=6),
    dict(type="latency", src="c*", dst="s*", factor=3, start=4, end=9),
    dict(type="latency", src="c5", dst="c6", factor=0.4, start=0),
    dict(type="bandwidth", hosts="s*9", factor=0.25, start=0, end=8.5),
    dict(type="bandwidth", hosts="s9", factor=0.5, start=3),
]
NAMES = [f"s{i}" for i in range(12)] + [f"c{i}" for i in range(10)]
FIELDS = ("times", "alive", "fgrp", "lat_milli", "passp", "bw_scale")


def both_compiled(specs, names, n_hosts, seed):
    j = jsched.compile_faults([jsched.FaultSpec(**s) for s in specs], names,
                              n_hosts, seed)
    t = tsched.compile_faults([tsched.FaultSpec(**s) for s in specs], names,
                              n_hosts, seed, device="cpu")
    return j, t


@pytest.mark.parametrize("specs, seed", [
    pytest.param(SPECS, 3, id="all-types"),
    pytest.param(SPECS[:1], 9, id="churn"),
    pytest.param(SPECS[4:9], 1, id="links-only"),
    pytest.param(SPECS[9:], 2, id="bandwidth-only"),
    pytest.param([dict(type="crash", hosts="nobody", start=1)], 0,
                 id="matches-nothing"),
])
def test_compile_faults_matches_reference(specs, seed):
    # 32 rows for 22 names: the padded rows never match any glob
    j, t = both_compiled(specs, NAMES, 32, seed)
    for name in FIELDS:
        a, b = np.asarray(getattr(j, name)), getattr(t, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for flag in ("has_crash", "has_link", "has_bw", "n_epochs"):
        assert getattr(j, flag) == getattr(t, flag), flag
    np.testing.assert_array_equal(j.np_times, t.np_times)
    np.testing.assert_array_equal(j.np_alive, t.np_alive)
    assert t.alive[:, len(NAMES):].all()
    assert (t.bw_scale[:, len(NAMES):] == 1.0).all()
    ts = [int(x) for x in t.np_times] + [10 * SECOND, 3 * SECOND // 2]
    for x in ts:
        np.testing.assert_array_equal(j.alive_at_host(x), t.alive_at_host(x))
        assert t.epoch_at_host(x) == int(j.epoch_of(jnp.int64(x)))
    for a, b in ((0, 20 * SECOND), (SECOND, 5 * SECOND), (7 * SECOND, 0)):
        np.testing.assert_array_equal(j.downtime_in(a, b), t.downtime_in(a, b))
        assert j.transitions_in(a, b) == t.transitions_in(a, b)
    grid = torch.tensor([[-1, 0, 1], [SECOND, 4 * SECOND, (1 << 62)]])
    np.testing.assert_array_equal(
        np.asarray(j.epoch_of(jnp.asarray(grid.numpy()))),
        t.epoch_of(grid).numpy())


def test_compile_faults_fires_every_type():
    """The all-types schedule exercises what it names: a churned host
    with several cycles, a crash that never ends, symmetric link groups
    and a bandwidth product of two specs."""
    _, t = both_compiled(SPECS, NAMES, 32, 3)
    assert t.has_crash and t.has_link and t.has_bw
    down = (~t.np_alive).sum(axis=0)
    c1 = NAMES.index("c1")
    assert down[c1] > 0 and not t.np_alive[-1, c1]
    assert not t.np_alive[-1, NAMES.index("c3")]  # restart=False
    churned = [i for i in range(12) if down[i] > 1]
    assert 1 <= len(churned) < 12  # frac=0.5 of the servers
    g = t.fgrp.numpy()
    lat = t.lat_milli.numpy()
    e = t.epoch_at_host(5 * SECOND)
    c, s = g[NAMES.index("c1")], g[NAMES.index("s1")]
    assert lat[e, c, s] == lat[e, s, c] == 3000  # symmetric
    assert t.passp.numpy()[e, g[NAMES.index("c3")], s] == 0.0
    assert t.bw_scale.numpy()[t.epoch_at_host(4 * SECOND),
                              NAMES.index("s9")] == np.float32(0.125)


def test_fault_parsing_matches_reference():
    dsl = "churn hosts=guard* start=10 end=60 period=20 downtime=5 frac=0.2"
    attrs = {"type": "crash", "hosts": "a b", "start": "5", "end": "8",
             "restart": "No"}
    assert (dataclasses.asdict(tsched.parse_fault_dsl(dsl))
            == dataclasses.asdict(jsched.parse_fault_dsl(dsl)))
    assert (dataclasses.asdict(tsched.parse_fault_attrs(attrs))
            == dataclasses.asdict(jsched.parse_fault_attrs(attrs)))
    bad_dsl = ["meteor hosts=*", "churn hosts=* start=10 end=5", "",
               "crash hosts", "churn start=1 end=5 period=1 downtime=2",
               "churn start=1 period=1 downtime=0.5", "loss loss=2",
               "latency factor=-1"]
    for text in bad_dsl:
        with pytest.raises(ValueError) as want:
            jsched.parse_fault_dsl(text)
        with pytest.raises(ValueError) as got:
            tsched.parse_fault_dsl(text)
        assert str(got.value) == str(want.value), text
    for attrs in ({"hosts": "*"}, {"type": "crash", "color": "red"}):
        with pytest.raises(ValueError) as want:
            jsched.parse_fault_attrs(attrs)
        with pytest.raises(ValueError) as got:
            tsched.parse_fault_attrs(attrs)
        assert str(got.value) == str(want.value)


def test_fault_element_parses_as_reference():
    text = jexamples.tgen_example(2, stoptime=5).replace(
        "</shadow>",
        '<fault type="crash" hosts="srv0" start="2" end="3"/>'
        '<fault type="loss" src="cli*" dst="*" loss="0.25" start="1"/>'
        "</shadow>")
    ft = tconfig.parse_config(text).faults
    fj = jconfig.parse_config(text).faults
    assert [dataclasses.asdict(f) for f in ft] == \
        [dataclasses.asdict(f) for f in fj]
    assert [f.type for f in ft] == ["crash", "loss"]
    with pytest.raises(ValueError, match="unknown fault type"):
        tconfig.parse_config(text.replace('"loss"', '"meteor"', 1))


# -- the engine's overlays ----------------------------------------------------
TOY_NAME = "hot-peers"
TOY_HOSTS = [f"h{i}" for i in range(TOY[TOY_NAME][0])]
PHOLD_HOSTS, PHOLD_STOP = 32, SECOND
# toy times are in its 30 ms run, PHOLD's in its 1 s run, both in seconds
CRASH = [dict(type="crash", hosts="h1 h2", start=0.005, end=0.016),
         dict(type="churn", hosts="h1*", start=0.002, end=0.028,
              period=0.008, downtime=0.003, frac=0.5),
         dict(type="crash", hosts="h7", start=0.02)]
LINKS = [dict(type="loss", src="h1*", dst="*", loss=0.5, start=0.004,
              end=0.02),
         dict(type="latency", src="h2 h3", dst="*", factor=2.5),
         dict(type="latency", src="h4", dst="h0", factor=0.25, start=0.01),
         dict(type="partition", src="h5", dst="h0 h6", start=0.008,
              end=0.024)]


def scaled(specs, k):
    out = []
    for s in specs:
        s = dict(s)
        for key in ("start", "end", "period", "downtime"):
            if s.get(key) is not None:
                s[key] = s[key] * k
        out.append(s)
    return out


# name: (model, drain frontier, specs); None specs is the fault-free build
ENGINE_CASES = {
    "crash-chained": ("toy", 0, CRASH),
    "crash-frontier": ("toy", 4, CRASH),
    "crash-batched": ("phold", 0, scaled(CRASH, 30)),
    "links-chained": ("toy", 0, LINKS),
    "links-frontier": ("toy", 4, LINKS),
    "links-batched": ("phold", 0, scaled(LINKS, 30)),
    "none-chained": ("toy", 0, None),
    "none-frontier": ("toy", 4, None),
    "none-batched": ("phold", 0, None),
}
# (host syncs, merge calls) of the fault-free runs, as the engine before
# the fault overlays counted them
FAULT_FREE_COUNTS = {"none-chained": (394, 21), "none-frontier": (1008, 21),
                     "none-batched": (81, 20)}


def _faults(specs, names, seed):
    if specs is None:
        return None, None
    return both_compiled(specs, names, len(names), seed)


def run_engine_case(name):
    """(reference leaves, port leaves, port engine, merge calls, the
    host-sync cost of every window-open test) of one ENGINE_CASES run."""
    model, frontier, specs = ENGINE_CASES[name]
    if model == "toy":
        n, msgs, peers = TOY[TOY_NAME][:3]
        jf, tf = _faults(specs, TOY_HOSTS, toy_config(TOY_NAME)["seed"])
        kw = dict(toy_config(TOY_NAME), frontier=frontier)
        fk = (PING,) if frontier else None
        z = torch.zeros((n,), dtype=torch.int64)
        zj = jnp.zeros((n,), jnp.int64)
        et = tengine.Engine(tengine.EngineConfig(**kw), torch_toy(peers),
                            tengine.ConstantNetwork(LAT), faults=tf,
                            fault_reset=TToy(z, z, z), frontier_kinds=fk,
                            device="cpu")
        init = et.init_state(TToy(z, z, z), Events(**{
            k: torch.from_numpy(v) for k, v in toy_initial(n, msgs).items()}))
        ej = jengine.Engine(jengine.EngineConfig(**kw), jax_toy(peers),
                            jengine.ConstantNetwork(LAT), faults=jf,
                            fault_reset=JToy(zj, zj, zj), frontier_kinds=fk)
        initj = ej.init_state(JToy(zj, zj, zj), JEvents(**{
            k: jnp.asarray(v) for k, v in toy_initial(n, msgs).items()}))
        stop = TOY_STOP
    else:
        kw = dict(batched=True, msgs_per_host=4, seed=3)
        names = [f"h{i}" for i in range(PHOLD_HOSTS)]
        jf, tf = _faults(specs, names, kw["seed"])
        e0, i0 = tphold.build(PHOLD_HOSTS, device="cpu", **kw)
        init = i0()
        et = tengine.Engine(e0.cfg, e0.handlers, e0.network,
                            batch_handler=e0.batch_handler, faults=tf,
                            fault_reset=init.hosts, device="cpu")
        ej0, ij0 = jphold.build(PHOLD_HOSTS, **kw)
        initj = ij0()
        ej = jengine.Engine(ej0.cfg, ej0.handlers, ej0.network,
                            batch_handler=ej0.batch_handler, faults=jf,
                            fault_reset=initj.hosts)
        stop = PHOLD_STOP
    calls, open_costs = [0], []
    fused, opens = tevents.merge.fused_merge, et._opens

    def count_merge(*args):
        calls[0] += 1
        return fused(*args)

    def count_open(*args):
        before = et.host_syncs
        out = opens(*args)
        open_costs.append(et.host_syncs - before)
        return out

    et._opens = count_open
    tevents.merge.fused_merge = count_merge
    try:
        s0 = et.host_syncs
        lt = convert.engine_state_to_numpy(et.run(init, stop))
        syncs = et.host_syncs - s0
    finally:
        tevents.merge.fused_merge = fused
    lj = jax_leaves(jax.jit(ej.run)(initj, jnp.int64(stop)))
    return lj, lt, et, (syncs, calls[0]), open_costs


@pytest.mark.parametrize("name", list(ENGINE_CASES))
def test_engine_faults_match_reference(name):
    lj, lt, et, counts, open_costs = run_engine_case(name)
    assert_leaves_equal(lj, lt)
    assert lt["stats.n_executed"].sum() > 0
    windows = int(lt["stats.n_windows"])
    # every window-open test, faults on or off, is one counted read
    assert open_costs == [1] * (windows + 1)
    drops, quarantined = (int(lt["stats.n_fault_dropped"].sum()),
                          int(lt["stats.n_quarantined"].sum()))
    if name.startswith("none"):
        assert et.faults is None and not et._f_any
        assert counts == FAULT_FREE_COUNTS[name]
        assert drops == quarantined == int(lt["fault_epoch"]) == 0
    elif name.startswith("crash"):
        assert et._f_crash and not et._f_link
        assert quarantined > 0 and drops > 0  # packets to dead hosts
        assert int(lt["fault_epoch"]) > 2
    else:
        assert et._f_link and not et._f_crash
        assert drops > 0 and quarantined == 0


def test_restart_retemplates_and_keeps_counters():
    """A toy host that crashes and restarts comes back from the template:
    its counters restart from 0 (the port's run to just after the restart
    shows fewer PINGs on h1 than a fault-free run), while exec_cnt and
    src_seq stay monotone."""
    n, msgs, peers = TOY[TOY_NAME][:3]
    specs = [dict(type="crash", hosts="h1", start=0.005, end=0.016)]
    _, tf = both_compiled(specs, TOY_HOSTS, n, 0)
    z = torch.zeros((n,), dtype=torch.int64)
    out = {}
    for key, faults in (("fault", tf), ("free", None)):
        et = tengine.Engine(tengine.EngineConfig(**toy_config(TOY_NAME)),
                            torch_toy(peers), tengine.ConstantNetwork(LAT),
                            faults=faults, fault_reset=TToy(z, z, z),
                            device="cpu")
        init = et.init_state(TToy(z, z, z), Events(**{
            k: torch.from_numpy(v) for k, v in toy_initial(n, msgs).items()}))
        mid = et.run(init, 12_000_000)
        out[key] = (mid, et.run(mid, TOY_STOP))
    (mid, fin), (mid0, _) = out["fault"], out["free"]
    assert int(mid.hosts.n_ping[1]) == 0 < int(mid0.hosts.n_ping[1])
    assert int(mid.exec_cnt[1]) > 0  # monotone through the wipe
    assert int(fin.hosts.n_ping[1]) > 0  # it runs again after 16 ms
    assert int(fin.stats.n_quarantined[1]) > 0
    assert int(fin.fault_epoch) == 2


def test_engine_refuses_faults_without_template():
    _, tf = both_compiled(CRASH, TOY_HOSTS, len(TOY_HOSTS), 0)
    with pytest.raises(ValueError, match="fault_reset"):
        tengine.Engine(tengine.EngineConfig(**toy_config(TOY_NAME)),
                       torch_toy(3), tengine.ConstantNetwork(LAT), faults=tf,
                       device="cpu")
    _, wide = both_compiled(LINKS, TOY_HOSTS + ["x"], 17, 0)
    with pytest.raises(ValueError, match="17 hosts"):
        tengine.Engine(tengine.EngineConfig(**toy_config(TOY_NAME)),
                       torch_toy(3), tengine.ConstantNetwork(LAT),
                       faults=wide, device="cpu")


# -- bandwidth, through build_simulation over UDP -----------------------------
BW_FAULTS = (
    # from 0 s: the watermark starts at epoch 0, so this applies only when
    # the epoch first changes (at 1.5 s), not from the start
    '<fault type="bandwidth" hosts="*1.peer *2.peer" factor="0.5" '
    'start="0"/>'
    '<fault type="bandwidth" hosts="*3.peer" factor="0.25" start="1.5"/>')


def bw_config(faults=BW_FAULTS):
    return texamples.phold_example(16, 2, 3).replace(
        "</shadow>", faults + "</shadow>")


def test_bandwidth_faults_match_reference():
    text = bw_config()
    assert text == jexamples.phold_example(16, 2, 3).replace(
        "</shadow>", BW_FAULTS + "</shadow>")
    ts = tsim.build_simulation(tconfig.parse_config(text), seed=5,
                               device="cpu")
    js = jsim.build_simulation(jconfig.parse_config(text), seed=5)
    assert ts.faults.has_bw and not ts.faults.has_crash
    assert ts.faults.n_epochs == js.faults.n_epochs == 2
    lt = convert.engine_state_to_numpy(ts.run())
    assert_leaves_equal(jax_leaves(js.run()), lt)
    tmpl = convert.engine_state_to_numpy(ts.state0)
    rate, rate0 = lt["hosts.net.nic_tx.rate"], tmpl["hosts.net.nic_tx.rate"]
    names = ts.names
    for i, nm in enumerate(names):
        f = np.float32(0.5 if nm.endswith(("1.peer", "2.peer")) else
                       0.25 if nm.endswith("3.peer") else 1.0)
        assert rate[i] == rate0[i] * f, nm
        assert lt["hosts.net.nic_rx.rate"][i] == \
            tmpl["hosts.net.nic_rx.rate"][i] * f, nm
    # before the first epoch change the start-at-0 throttle has not
    # applied: an apply in every window would already have halved it
    early = convert.engine_state_to_numpy(ts.run(int(1.4 * SECOND)))
    np.testing.assert_array_equal(early["hosts.net.nic_tx.rate"], rate0)
    assert int(early["fault_epoch"]) == 0 and int(lt["fault_epoch"]) == 1
    assert_leaves_equal(jax_leaves(js.run(int(1.4 * SECOND))), early)
