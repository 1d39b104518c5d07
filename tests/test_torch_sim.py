"""Config-driven simulations in shadow_tpu_torch against shadow_tpu.

- `parse_config` and `expand_hosts` give equal results in both packages
  on the config strings of tests/test_config_sim.py, the legacy
  <node>/<application>/<kill> form included; `DNS` assigns the same
  addresses;
- `build_simulation` gives the same initial state, leaf for leaf, and
  the same final state after `run`, for PHOLD over the UDP stack:
  phold_example(64, 4, stoptime=3) in tier 1; a weighted run, a
  `cpufrequency` + `interfacebuffer` + `stoptime` config, the unfused
  pipeline and the legacy-form config with the slow tests (each pays a
  reference compile);
- the slow pins: chip_smoke.py's PHOLD-net runs at 4096 hosts (the main
  run and both variants) in both packages, against its constants;
- the knob the port does not have (`spmd="constraint"`) raises
  NotImplementedError.

Every comparison is exact, dtypes included.
"""

import dataclasses
import functools

import numpy as np
import pytest

import chip_smoke
from shadow_tpu import config as jconfig
from shadow_tpu import examples as jexamples
from shadow_tpu import sim as jsim
from shadow_tpu.net import dns as jdns
from shadow_tpu_torch import config as tconfig
from shadow_tpu_torch import convert
from shadow_tpu_torch import examples as texamples
from shadow_tpu_torch import sim as tsim
from shadow_tpu_torch.net import dns as tdns
from shadow_tpu_torch.obs.profiler import WindowProfiler
from shadow_tpu_torch.transport import stack as tstack
from shadow_tpu_torch.transport import tcp as ttcp
from shadow_tpu_torch.transport.stack import A_LEN
from test_config_sim import PHOLD_CONFIG, TOPO_1POI, tgen_config
from test_torch_phold import (  # noqa: F401 (one_torch_thread: autouse)
    assert_leaves_equal, jax_leaves, one_torch_thread)
from test_torch_udp_stack import REFERENCE_AVX512

SECOND = 1_000_000_000


# -- configuration -----------------------------------------------------------
CONFIGS = {
    "tgen": tgen_config(),
    "legacy": PHOLD_CONFIG,
    "phold": jexamples.phold_example(24, 3, stoptime=5),
    "attrs": (
        '<shadow stoptime="9" bootstraptime="2.5" preload="p.so" '
        'environment="A=1">'
        f"<topology><![CDATA[{TOPO_1POI}]]></topology>"
        '<plugin id="phold" path="shadow-plugin-test-phold"/>'
        '<host id="a" quantity="3" bandwidthup="100" bandwidthdown="200" '
        'iphint="11.0.0.5" cpufrequency="2500000" interfacebuffer="4096" '
        'socketrecvbuffer="8192" logpcap="true" pcapdir="p" '
        'heartbeatfrequency="7" loglevel="debug">'
        '<process plugin="phold" starttime="1.5" stoptime="4" '
        'arguments="load=2"/></host>'
        '<node id="b"><application plugin="phold" time="2" '
        'arguments="x y=z"/></node></shadow>'
    ),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_parse_and_expand_match_reference(name):
    text = CONFIGS[name]
    cj, ct = jconfig.parse_config(text), tconfig.parse_config(text)
    assert dataclasses.asdict(cj) == dataclasses.asdict(ct)
    hj, ht = jconfig.expand_hosts(cj), tconfig.expand_hosts(ct)
    assert [dataclasses.asdict(h) for h in hj] == \
        [dataclasses.asdict(h) for h in ht]


def test_config_helpers_match_reference():
    for s in ("1 MiB", "512 kb", "4096", "2.5GiB", "7 bytes", 12):
        assert tconfig.parse_size(s) == jconfig.parse_size(s)
    for bad in ("1 parsec", "x"):
        with pytest.raises(ValueError):
            tconfig.parse_size(bad)
    args = "basename=peer quantity=10 load=25 flag weightsfilepath=w.txt"
    assert tconfig.parse_kv_arguments(args) == \
        jconfig.parse_kv_arguments(args)
    assert texamples.phold_example(7, 2, 9) == \
        jexamples.phold_example(7, 2, 9)
    assert texamples.EXAMPLE_TOPOLOGY == jexamples.EXAMPLE_TOPOLOGY


def test_faults_are_not_ported():
    """Fault schedules are ported now (tests/test_torch_faults*.py): a
    malformed <fault> element is refused with the reference's error, and
    a well-formed one parses as the reference's does."""
    text = tgen_config().replace(
        "</shadow>", '<fault type="crash" host="server" time="5"/></shadow>')
    for cfg_mod in (jconfig, tconfig):
        with pytest.raises(ValueError, match="unknown fault attribute"):
            cfg_mod.parse_config(text)
    text = tgen_config().replace(
        "</shadow>",
        '<fault type="crash" hosts="server" start="5"/></shadow>')
    got, want = tconfig.parse_config(text), jconfig.parse_config(text)
    assert [dataclasses.asdict(f) for f in got.faults] == \
        [dataclasses.asdict(f) for f in want.faults]


def test_dns_assigns_the_same_addresses():
    rng = np.random.default_rng(3)
    hints = [None, "11.0.0.1", "10.0.0.1", None, "11.0.0.1", "1.2.3.4",
             "192.168.1.1", None] + [None] * 300
    dj, dt = jdns.DNS(), tdns.DNS()
    for i, hint in enumerate(hints):
        name = f"h{i}-{rng.integers(1000)}"
        aj, at = dj.register(i, name, hint), dt.register(i, name, hint)
        assert dataclasses.asdict(aj) == dataclasses.asdict(at)
    assert [a.ip_str for a in dj.entries()] == \
        [a.ip_str for a in dt.entries()]
    assert dt.resolve_ip("11.0.0.1").host_id == 1
    with pytest.raises(ValueError):
        dt.register(99, "h0-" + dt.entries()[0].name.split("-")[1])


# -- build_simulation --------------------------------------------------------
def weights_config(tmp):
    """PHOLD over 40 peers (bucketed to 64) with a weights file: five
    hot peers draw most messages."""
    path = tmp / "weights.txt"
    path.write_text("\n".join(["9.5"] * 5 + ["0.25"] * 35))
    text = jexamples.phold_example(40, 3, stoptime=3).replace(
        'arguments="load=3"',
        f'arguments="load=3 weightsfilepath={path}"')
    return text, {}


def attrs_config(_tmp):
    """cpufrequency (the fused [H, n_kinds] cost table), interfacebuffer
    (tail drops), per-host bandwidths and a process stoptime."""
    topo = jexamples.EXAMPLE_TOPOLOGY
    text = (
        '<shadow stoptime="3">'
        f"<topology><![CDATA[{topo}]]></topology>"
        '<plugin id="phold" path="shadow-plugin-test-phold"/>'
        '<host id="fast" quantity="20" cpufrequency="3000000">'
        '<process plugin="phold" starttime="1" arguments="load=4"/></host>'
        '<host id="thin" quantity="12" bandwidthdown="8" '
        'interfacebuffer="300">'
        '<process plugin="phold" starttime="1" arguments="load=4"/></host>'
        '<host id="quit" quantity="16" bandwidthup="64">'
        '<process plugin="phold" starttime="1.2" stoptime="1.7" '
        'arguments="load=4"/></host>'
        "</shadow>")
    return text, {}


def unfused_config(_tmp):
    text = jexamples.phold_example(64, 4, stoptime=3).replace(
        '<shadow stoptime="3">', '<shadow stoptime="3" bootstraptime="1.2">')
    return text, dict(fuse_rx=False, rx_queue="static")


SIMS = {
    "phold": (lambda _tmp: (jexamples.phold_example(64, 4, stoptime=3), {})),
    "weights": weights_config,
    "attrs": attrs_config,
    "unfused": unfused_config,
    # the reference's own phold test config: <node>/<application>/<kill>
    "legacy": (lambda _tmp: (PHOLD_CONFIG, {})),
}


@functools.lru_cache(maxsize=None)
def sims_of(name, tmp):
    """(state0 leaves, final leaves, simulation) per package: one
    reference build and run per config for the whole file."""
    text, kw = SIMS[name](tmp)
    js = jsim.build_simulation(jconfig.parse_config(text), seed=7, **kw)
    ts = tsim.build_simulation(tconfig.parse_config(text), seed=7,
                               device="cpu", **kw)
    return ((jax_leaves(js.state0), jax_leaves(js.run()), js),
            (convert.engine_state_to_numpy(ts.state0),
             convert.engine_state_to_numpy(ts.run()), ts))


@pytest.fixture(scope="module")
def sim_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("sims")


SIM_CASES = [pytest.param(n, marks=() if n == "phold" else pytest.mark.slow)
             for n in SIMS]


@pytest.mark.parametrize("name", SIM_CASES)
def test_build_simulation_state0_matches_reference(name, sim_dir):
    (j0, _, js), (t0, _, ts) = sims_of(name, sim_dir)
    assert_leaves_equal(j0, t0)
    assert ts.kind_names == js.kind_names
    assert ts.names == js.names
    assert ts.stop_ns == js.stop_ns
    assert ts.engine.cfg.max_emit == js.engine.cfg.max_emit
    assert ts.engine.cfg.lookahead == js.engine.cfg.lookahead
    assert ts.engine.cfg.capacity == js.engine.cfg.capacity
    assert [dataclasses.asdict(a) for a in ts.dns.entries()] == \
        [dataclasses.asdict(a) for a in js.dns.entries()]


@pytest.mark.parametrize("name", SIM_CASES)
def test_simulation_run_matches_reference(name, sim_dir):
    (_, jf, js), (_, tf, ts) = sims_of(name, sim_dir)
    assert_leaves_equal(jf, tf)
    assert ts.summary(ts.state0) == js.summary(js.state0)
    recv = tf["hosts.app.n_recv"]
    assert recv.sum() > 0
    if name == "weights":
        assert recv[:5].mean() > 10 * recv[5:40].mean()
    if name == "attrs":
        cost = ts.engine.cpu_cost.numpy()
        assert cost.shape == (64, 3)  # the fused [H, n_kinds] table
        assert (cost[:20, tstack.KIND_PKT_ARRIVE] == 2 * cost[:20, 2]).all()
        assert tf["hosts.net.nic_rx.drops"][20:32].sum() > 0
        # stopped processes send nothing after their stoptime
        assert tf["hosts.app.n_sent"][32:48].sum() < \
            tf["hosts.app.n_sent"][:16].sum()
    if name == "unfused":
        assert tf["stats.n_by_kind"][:, tstack.KIND_PKT_RX].sum() > 0


def test_step_window_and_state_carry(sim_dir):
    """Stepping window by window reaches run()'s state, and a reference
    state carried over mid-run through `convert` runs on to the
    reference's final state."""
    (_, jf, js), (_, _, ts) = sims_of("phold", sim_dir)
    stop = int(1.2 * SECOND)
    st = ts.state0
    while int(st.now) < stop:
        st = ts.step_window(st, stop)
    assert_leaves_equal(convert.engine_state_to_numpy(ts.run(stop)),
                        convert.engine_state_to_numpy(st))
    mid = js.run(stop)
    carried = convert.engine_state_from_numpy(jax_leaves(mid), "cpu",
                                              hosts=ts.state0.hosts)
    assert carried.hosts.net.tcb is None
    assert_leaves_equal(jf, convert.engine_state_to_numpy(
        ts.run(state=carried)))


def test_unported_knobs_raise():
    cfg = tconfig.parse_config(texamples.phold_example(8, 1, 2))
    # sharding is ported (tests/test_torch_shard.py): the global engine
    # partitioned by the compiler is not, and the sharding knobs are
    # checked as the reference checks them
    with pytest.raises(NotImplementedError, match="item 7b"):
        tsim.build_simulation(cfg, device="cpu", spmd="constraint")
    for kw, err in ((dict(locality=True), "requires a multi-device mesh"),
                    (dict(host_order=[0]), "permutation")):
        with pytest.raises(ValueError, match=err):
            tsim.build_simulation(cfg, device="cpu", **kw)
    # overflow="grow" is ported (the CLI re-templates it,
    # tests/test_torch_cli.py): a spill ring and a grow-mode controller
    grown = tsim.build_simulation(cfg, device="cpu", overflow="grow")
    assert grown.engine.cfg.spill == 1024
    assert grown.pressure.mode == "grow" and not grown.pressure.grow_wanted
    # tracing, the stats plane and the profiler are ported
    # (tests/test_torch_trace.py, tests/test_torch_stats.py)
    prof = WindowProfiler()
    ts = tsim.build_simulation(cfg, device="cpu", trace=8, stats=1,
                               profiler=prof)
    assert ts.engine.cfg.trace == 8 and ts.engine.cfg.stats == 1
    assert ts.engine.cfg.trace_len_arg == A_LEN
    assert "profile" in ts.summary(ts.run(1))
    # spill and the frontier drain are ported (tests/test_torch_pressure.py,
    # tests/test_torch_frontier.py); PHOLD over UDP is not frontier-safe,
    # in both packages
    assert tsim.build_simulation(cfg, device="cpu",
                                 overflow="spill").engine.cfg.spill == 1024
    for sim_mod, cfg_mod, extra in ((jsim, jconfig, {}),
                                    (tsim, tconfig, {"device": "cpu"})):
        with pytest.raises(ValueError, match="TCP stack"):
            sim_mod.build_simulation(
                cfg_mod.parse_config(texamples.phold_example(8, 1, 2)),
                frontier=4, **extra)
    with pytest.raises(ValueError):
        tsim.build_simulation(cfg, device="cpu", overflow="lossy")
    with pytest.raises(ValueError):
        tsim.build_simulation(cfg, device="cpu", rx_queue="red")
    # window widths and packet capture are ported
    # (tests/test_torch_window.py, tests/test_torch_pcap.py)
    ts = tsim.build_simulation(cfg, device="cpu")
    assert int(ts.step_window(None, window_ns=5).now) > 0
    pcap = texamples.phold_example(8, 1, 2).replace(
        '<host id="peer"', '<host id="peer" logpcap="true"')
    ts = tsim.build_simulation(tconfig.parse_config(pcap), device="cpu")
    assert ts.pcap_gids == tuple(range(8))
    assert ts.state0.hosts.net.cap.t.shape == (16, 1024)
    # tor and bitcoin are ported (tests/test_torch_tor_bitcoin.py): PHOLD's
    # arguments under their plugins fail as in the reference
    for plugin, why in (("tor", "needs a role"),
                        ("bitcoin", "must include 'node'")):
        text = texamples.phold_example(8, 1, 2).replace("phold", plugin)
        with pytest.raises(ValueError, match=why):
            jsim.build_simulation(jconfig.parse_config(text))
        with pytest.raises(ValueError, match=why):
            tsim.build_simulation(tconfig.parse_config(text), device="cpu")
    # tgen is ported (tests/test_torch_tgen.py), CUBIC too
    # (tests/test_torch_cubic.py)
    ts = tsim.build_simulation(tconfig.parse_config(tgen_config()),
                               tcp_cc="cubic", device="cpu")
    assert ts.stack.tcp.cc is ttcp.CubicCC


def test_strict_overflow_raises():
    """Queue overflow is loud: a capacity too small for the load raises,
    as in the reference, unless counted drops are accepted."""
    cfg = tconfig.parse_config(texamples.phold_example(16, 12, 2))
    sim = tsim.build_simulation(cfg, device="cpu", capacity=8)
    sim.stop_ns = int(1.01 * SECOND)
    with pytest.raises(RuntimeError, match="overflow"):
        sim.run()
    sim.overflow = "strict"
    with pytest.raises(tsim.QueuePressureError):
        sim.run()
    sim.overflow, sim.strict_overflow = "drop", False
    assert int(sim.run().queues.drops.sum()) > 0


@pytest.mark.slow
@REFERENCE_AVX512
@pytest.mark.parametrize("n_hosts,wide_rows", [(24, 0), (200, 192)])
def test_codel_estimate_at_unbucketed_host_counts(n_hosts, wide_rows,
                                                  tmp_path):
    """Without shape bucketing the host count need not be a multiple of
    16, and the reference's CoDel loop mixes x86 rsqrt estimates
    (`nic.engine_wide_rows`). Hot peers at both ends of the host range
    drop past count 19, where the estimates part: equal leaves."""
    hot = [0, 1, n_hosts - 2, n_hosts - 1]
    w = np.ones(n_hosts)
    w[hot] = 40.0
    path = tmp_path / "weights.txt"
    path.write_text("\n".join(str(float(x)) for x in w))
    thin = ' bandwidthdown="4"'
    hosts = "".join(
        f'<host id="h{i}"{thin if i in hot else ""}>'
        '<process plugin="phold" starttime="1" '
        f'arguments="load=6 weightsfilepath={path}"/></host>'
        for i in range(n_hosts))
    text = ('<shadow stoptime="4"><topology><![CDATA['
            f"{jexamples.EXAMPLE_TOPOLOGY}]]></topology>"
            '<plugin id="phold" path="phold"/>' + hosts + "</shadow>")
    lj = jax_leaves(jsim.build_simulation(
        jconfig.parse_config(text), seed=3, shape_bucket=False).run())
    lt = convert.engine_state_to_numpy(tsim.build_simulation(
        tconfig.parse_config(text), seed=3, shape_bucket=False,
        device="cpu").run())
    assert_leaves_equal(lj, lt)
    count = lj["hosts.net.codel.count"]
    wide = [r for r in hot if r < wide_rows]
    narrow = [r for r in hot if r >= wide_rows]
    for rows in (wide, narrow):
        assert not rows or count[rows].max() >= 19


# -- the slow pins: chip_smoke.py's PHOLD-net runs at 4096 hosts -------------
NET_PINS = {"main": "PIN_NET", "codel": "PIN_NET_CODEL",
            "unfused": "PIN_NET_UNFUSED"}


def net_pin(leaves) -> tuple:
    return (int(leaves["stats.n_executed"].sum()),
            convert.leaves_digest(leaves),
            int(leaves["hosts.app.n_sent"].sum()),
            int(leaves["hosts.app.n_recv"].sum()))


@pytest.mark.slow
@pytest.mark.parametrize("which", [
    pytest.param(w, marks=(REFERENCE_AVX512,) if w == "codel" else ())
    for w in NET_PINS])
def test_phold_net_4096_parity_and_pins(which, tmp_path):
    """chip_smoke's PHOLD-net runs in both packages on the CPU: equal
    leaves, and the (events, digest, sent, received) pins the card is
    held to; the CoDel variant drops past count 19, sends most traffic
    to its hot peers and charges the fused CPU-cost table."""
    text, kw = chip_smoke.phold_net_config(which, tmp_path)
    js = jsim.build_simulation(jconfig.parse_config(text),
                               seed=chip_smoke.NET_SEED, **kw)
    lj = jax_leaves(js.run())
    ts = tsim.build_simulation(tconfig.parse_config(text),
                               seed=chip_smoke.NET_SEED, device="cpu", **kw)
    lt = convert.engine_state_to_numpy(ts.run())
    assert_leaves_equal(lj, lt)
    assert net_pin(lj) == getattr(chip_smoke, NET_PINS[which])
    if which == "codel":
        recv = lj["hosts.app.n_recv"]
        assert recv[:chip_smoke.NET_HOT].sum() > recv.sum() / 2
        assert lj["hosts.net.codel.count"].max() >= 19
        assert ts.engine.cpu_cost.shape == (chip_smoke.NET_HOSTS, 3)
    if which == "unfused":
        assert lj["hosts.net.nic_rx.drops"].sum() > 0
