"""Packet capture (`utils/pcap.py`, the stack's two append sites, the
build's `logpcap`/`pcapdir` handling) in shadow_tpu_torch against
shadow_tpu, on the CPU.

The three scenarios of tests/test_pcap.py (a TGen server capturing its
ingress; the same over a 20% lossy path, whose captures carry
retransmissions) run in both packages, each once per file, and so does
an unfused build (`fuse_rx=False`) whose rings hold 8 records, so that
they wrap and lose records before the drain. For each: the capture
ring's leaves (and every other leaf) equal, the pcap files byte for
byte, and the drain's stage counts and lost records. Also: only flagged
hosts record, the `burst_rx` warning, a conflicting `pcapdir` refused
in both, and UDP tx records from PHOLD over the stack.

The command line's capture, its checkpoints across packages and the
bench-shape pin of chip_smoke.py's phase 20 are in
tests/test_torch_pcap_cli.py.
"""

import dataclasses
import functools
import warnings

import numpy as np
import pytest

from shadow_tpu import config as jconfig
from shadow_tpu import examples as jexamples
from shadow_tpu import sim as jsim
from shadow_tpu.utils import pcap as jpcap
from shadow_tpu_torch import config as tconfig
from shadow_tpu_torch import convert
from shadow_tpu_torch import sim as tsim
from shadow_tpu_torch.utils import pcap as tpcap
from test_pcap import _cfg
from test_torch_phold import assert_leaves_equal, jax_leaves
from test_torch_tcp import one_torch_thread  # noqa: F401 (autouse)


def lossy_cfg(tmp) -> str:
    """tests/test_pcap.py's lossy scenario: 20% loss on the path and a
    64 KiB request."""
    return _cfg(tmp).replace(
        '<edge source="p" target="p"><data key="d3">20.0</data></edge>',
        '<edge source="p" target="p"><data key="d3">20.0</data>'
        '<data key="d4">0.2</data></edge>',
    ).replace(
        '<key attr.name="latency"',
        '<key attr.name="packetloss" attr.type="double" for="edge" '
        'id="d4" /><key attr.name="latency"',
    ).replace("sendsize=8KiB", "sendsize=64KiB")


# name -> (config maker, seed, build keywords, ring records)
SCENARIOS = {
    # tests/test_pcap.py:60, per-segment capture (burst folding off)
    "plain": (_cfg, 4, dict(burst_rx=False), 1024),
    # tests/test_pcap.py:100, the lifecycle stages on a lossy path
    "lossy": (lossy_cfg, 11, {}, 1024),
    # the unfused rx path, with rings that wrap before the drain
    "unfused_wrap": (_cfg, 4, dict(burst_rx=False, fuse_rx=False), 8),
}


def with_ring(pkg, sim, ring: int):
    """sim.state0 with capture rings of `ring` records."""
    st = sim.state0
    net = st.hosts.net
    if pkg == "jax":
        cap = jpcap.CaptureRing.create(net.cap.enabled, ring=ring)
    else:
        cap = tpcap.CaptureRing.create(net.cap.enabled, ring=ring)
    return dataclasses.replace(st, hosts=dataclasses.replace(
        st.hosts, net=dataclasses.replace(net, cap=cap)))


@functools.lru_cache(maxsize=None)
def run_scenario(name: str, pkg: str, tmp):
    """(final leaves, pcap bytes by file, stage_counts, lost, pcap_gids)
    of one package's run of a scenario, drained once at the end."""
    make, seed, kw, ring = SCENARIOS[name]
    out = tmp / name / pkg
    text = make(out)
    if pkg == "jax":
        sim = jsim.build_simulation(jconfig.parse_config(text), seed=seed,
                                    **kw)
        drain_cls = jpcap.CaptureDrain
    else:
        sim = tsim.build_simulation(tconfig.parse_config(text), seed=seed,
                                    device="cpu", **kw)
        drain_cls = tpcap.CaptureDrain
    st = with_ring(pkg, sim, ring) if ring != 1024 else None
    st = sim.run(state=st)
    drain = drain_cls([sim.names[g] for g in sim.pcap_gids], sim.pcap_gids,
                      str(out), dns=sim.dns)
    drain.drain(st.hosts.net.cap)
    drain.close()
    leaves = (jax_leaves(st) if pkg == "jax"
              else convert.engine_state_to_numpy(st))
    files = {p.name: p.read_bytes() for p in sorted(out.glob("*.pcap"))}
    return leaves, files, dict(drain.stage_counts), drain.lost, \
        tuple(sim.pcap_gids)


@pytest.fixture(scope="module")
def scen_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("pcap")


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_capture_ring_leaves_match_reference(name, scen_dir):
    lj, *_ = run_scenario(name, "jax", scen_dir)
    lt, *_ = run_scenario(name, "torch", scen_dir)
    assert_leaves_equal(lj, lt)
    assert lt["hosts.net.cap.t"].shape == (16, SCENARIOS[name][3])
    assert lt["hosts.net.cap.wr"].sum() > 0


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_pcap_files_match_reference(name, scen_dir):
    _, fj, *_ = run_scenario(name, "jax", scen_dir)
    _, ft, *_ = run_scenario(name, "torch", scen_dir)
    assert list(ft) == ["server.pcap"]
    assert ft == fj


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_stage_counts_and_lost_match_reference(name, scen_dir):
    _, _, sj, lost_j, gj = run_scenario(name, "jax", scen_dir)
    lt, _, st, lost_t, gt = run_scenario(name, "torch", scen_dir)
    assert (st, lost_t, gt) == (sj, lost_j, gj)
    assert st["arrived"] > 0 and st["delivered"] > 0
    if name == "lossy":
        # the sender-stamped retransmission survives into the capture
        assert st["retransmitted"] > 0
    if name == "unfused_wrap":
        wr = int(lt["hosts.net.cap.wr"].max())
        assert lost_t == wr - 8 > 0


def test_capture_sees_only_flagged_hosts(scen_dir):
    lt, *_, gids = run_scenario("plain", "torch", scen_dir)
    wr = lt["hosts.net.cap.wr"]
    assert gids == (0,) and wr[0] > 0 and wr[1:].sum() == 0
    assert lt["hosts.net.cap.enabled"].tolist() == [True] + [False] * 15


def test_burst_rx_warning_and_default_run(scen_dir, tmp_path):
    """tests/test_pcap.py:140 builds with burst folding on: both
    packages warn and turn it off, so the run is the per-segment one."""
    text = _cfg(tmp_path)
    with pytest.warns(UserWarning, match="burst_rx disabled"):
        ts = tsim.build_simulation(tconfig.parse_config(text), seed=4,
                                   device="cpu")
    with pytest.warns(UserWarning, match="burst_rx disabled"):
        js = jsim.build_simulation(jconfig.parse_config(text), seed=4)
    assert ts.engine.cfg.burst is None and js.engine.cfg.burst is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tsim.build_simulation(tconfig.parse_config(text), seed=4,
                              device="cpu", burst_rx=False)
    lt, *_ = run_scenario("plain", "torch", scen_dir)
    assert_leaves_equal(convert.engine_state_to_numpy(ts.run()), lt)


def test_pcapdir_conflict_refused(tmp_path):
    text = _cfg(tmp_path).replace(
        '<host id="client">', '<host id="client" pcapdir="elsewhere">')
    for build, parse, kw in ((jsim.build_simulation, jconfig.parse_config,
                              {}),
                             (tsim.build_simulation, tconfig.parse_config,
                              {"device": "cpu"})):
        with pytest.raises(ValueError, match="disagree on pcapdir"):
            build(parse(text), seed=4, burst_rx=False, **kw)


def test_udp_tx_and_rx_records_match_reference(tmp_path):
    """PHOLD over the UDP stack with every peer capturing: each send
    leaves a tx record (src -1, the sent stage) on the sender's ring and
    each arrival an rx record on the receiver's, both packages alike."""
    text = jexamples.phold_example(8, 2, stoptime=2).replace(
        '<host id="peer"', f'<host id="peer" pcapdir="{tmp_path}"')
    js = jsim.build_simulation(jconfig.parse_config(text), seed=3)
    jst = js.run()
    lj = jax_leaves(jst)
    ts = tsim.build_simulation(tconfig.parse_config(text), seed=3,
                               device="cpu")
    st = ts.run()
    assert_leaves_equal(lj, convert.engine_state_to_numpy(st))
    drain = tpcap.CaptureDrain([ts.names[g] for g in ts.pcap_gids],
                               ts.pcap_gids, str(tmp_path), dns=ts.dns)
    drain.drain(st.hosts.net.cap)
    drain.close()
    jdrain = jpcap.CaptureDrain(
        [js.names[g] for g in js.pcap_gids], js.pcap_gids,
        str(tmp_path / "jax"), dns=js.dns)
    jdrain.drain(jst.hosts.net.cap)
    jdrain.close()
    assert drain.stage_counts == jdrain.stage_counts
    assert drain.stage_counts["sent"] > 0
    for name in (f"{n}.pcap" for n in ts.names[:8]):
        assert (tmp_path / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes()
    meta = np.asarray(lj["hosts.net.cap.meta"])
    sent = (meta[..., tpcap.M_META] >> 16) & tpcap.STG_SENT
    assert (meta[..., tpcap.M_SRC][sent > 0] == -1).all()
