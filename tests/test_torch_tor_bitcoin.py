"""The Tor and Bitcoin models through `build_simulation` in
shadow_tpu_torch against shadow_tpu, leaf for leaf.

- the example configs and the JAX-free copies of tests/test_tor_bitcoin.py's
  configs are the reference's text;
- the build-time tables equal the reference's: Tor's per-host circuit
  tables (`tc_*`, drawn from the same Python stream) and Bitcoin's peer
  graph (`peers`, `dials`, `n_peers`, `n_dials`);
- the per-kind CPU table of `tor_example(..., relay_cpu_ghz=3.0)` (relay
  crypto per delivered segment) equals the reference's engine table in
  both `fuse_rx` modes;
- `_tc_lookup`, the last free socket slot and Bitcoin's `link_slot` equal
  the reference's expressions on hand-built rows (no match, one match,
  duplicates, all free, none free);
- a UDP datagram delivered to a host whose stack runs TCP (Bitcoin's
  control plane) reaches the same socket with the same packet, in both
  `fuse_rx` modes;
- tests/test_tor_bitcoin.py's Tor scenarios end in equal states (seed
  11, and seed 4 twice), and so does the overflow case (strict raises in
  both packages; counted drops agree);
- a JAX Tor state taken after the first client second continues in the
  port to the reference's final state;
- the work of one Tor inner step, counted as the torch operations that
  launch a kernel on a device;
- the slow pin: chip_smoke.py's phase 11 (Tor at bench.py's 1,020-host
  tier to 4 s in one call) in both packages, against chip_smoke's
  constants.

The Bitcoin scenarios (block 3 everywhere, runs in one call and in 1 s
chunks, one inner step's work, phase 12's pin) are in
tests/test_torch_bitcoin.py, which shares this file's helpers.

Every comparison is exact, dtypes included.
"""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import torch_tcp_harness as harness
import test_tor_bitcoin as jscenarios
from shadow_tpu import config as jconfig
from shadow_tpu import examples as jexamples
from shadow_tpu import sim as jsim
from shadow_tpu.core import engine as jengine
from shadow_tpu.core.events import Events as JEvents
from shadow_tpu.host import sockets as jsock
from shadow_tpu.models import tor as jtor
from shadow_tpu.transport import stack as jstack
from shadow_tpu.transport import tcp as jtcp
from shadow_tpu_torch import config as tconfig
from shadow_tpu_torch import convert
from shadow_tpu_torch import examples as texamples
from shadow_tpu_torch import sim as tsim
from shadow_tpu_torch.core import engine as tengine
from shadow_tpu_torch.core.events import Events as TEvents
from shadow_tpu_torch.host import sockets as tsock
from shadow_tpu_torch.models import bitcoin as tbtc
from shadow_tpu_torch.models import tor as ttor
from shadow_tpu_torch.transport import stack as tstack
from shadow_tpu_torch.transport import tcp as ttcp
from test_torch_phold import assert_leaves_equal, jax_leaves
from test_torch_tcp import one_torch_thread  # noqa: F401 (autouse)
from test_torch_tgen import LaunchCount

SECOND = 1_000_000_000
MS = 1_000_000


def build_both(text, **kw):
    """(reference simulation, port simulation on the CPU) of one config."""
    return (jsim.build_simulation(jconfig.parse_config(text), **kw),
            tsim.build_simulation(tconfig.parse_config(text), device="cpu",
                                  **kw))


def test_configs_match_reference():
    for args in ((3, 10, 2), (2, 40, 3, "64KiB", 2, 10, 3.0)):
        assert texamples.tor_example(*args) == jexamples.tor_example(*args)
    assert texamples.bitcoin_example(10, 2, "256KiB", 30) == \
        jexamples.bitcoin_example(10, 2, "256KiB", 30)
    assert texamples.bitcoin_example(7, stoptime=9) == \
        jexamples.bitcoin_example(7, stoptime=9)
    assert harness.tor_config(3) == jscenarios.tor_config(3)
    assert harness.tor_config(2, count=1) == jscenarios.tor_config(
        2, count=1)
    assert harness.btc_config(8, blocks=3) == jscenarios.btc_config(
        8, blocks=3)
    assert harness.btc_config(5, 1, "64KiB", 5) == jscenarios.btc_config(
        5, 1, "64KiB", 5)


# -- build-time tables ------------------------------------------------------
TOR_TABLES = ("tc_cid", "tc_nxt", "tc_port", "tc_file", "circ_id",
              "cl_guard", "cl_file", "cl_count", "cl_pause", "cl_npause",
              "role")


@pytest.mark.parametrize("text", [
    texamples.tor_example(2, 9, 2, stoptime=5),  # duplicate-relay pools
    texamples.tor_example(4, 60, 3, "64KiB", 2, 10, 3.0),
    harness.tor_config(3),
], ids=["small-pools", "tier-like", "scenario"])
def test_tor_tables_match_reference(text):
    js, ts = build_both(text, seed=1, n_sockets=8)
    lj, lt = jax_leaves(js.state0), convert.engine_state_to_numpy(ts.state0)
    assert_leaves_equal(lj, lt)
    for name in TOR_TABLES:
        assert lt[f"hosts.app.{name}"].dtype == lj[f"hosts.app.{name}"].dtype
    cid = lt["hosts.app.tc_cid"]
    assert (cid >= 0).sum() == 4 * (lt["hosts.app.circ_id"] >= 0).sum()
    assert ts.app.frontier_safe == js.app.frontier_safe is True
    assert ts.app.frontier_kinds() == js.app.frontier_kinds() == (0,)


@pytest.mark.parametrize("text", [
    texamples.bitcoin_example(40, 2, "256KiB", 30),
    harness.btc_config(8, blocks=3),
    texamples.bitcoin_example(1),  # a single node dials nothing
], ids=["40-nodes", "scenario", "one-node"])
def test_bitcoin_tables_match_reference(text):
    js, ts = build_both(text, seed=1, n_sockets=16)
    assert_leaves_equal(jax_leaves(js.state0),
                        convert.engine_state_to_numpy(ts.state0))
    for name in ("peers", "dials", "n_peers", "n_dials", "miner",
                 "blocksize", "interval_ns", "n_blocks"):
        want = np.asarray(js.app._g[name])
        got = ts.app._g[name].numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert ts.app.frontier_safe == js.app.frontier_safe is True
    assert ts.app.frontier_kinds() == js.app.frontier_kinds() == (0, 1)


@pytest.mark.parametrize("fuse_rx", [True, False], ids=["fused", "unfused"])
def test_relay_cpu_table_matches_reference(fuse_rx):
    """tor_example's relays on a 3 GHz virtual CPU: the fused [H, kinds]
    table holds the per-event cost and the relay crypto charge."""
    text = texamples.tor_example(3, 12, 2, "64KiB", 2, 10, 3.0)
    js, ts = build_both(text, seed=1, n_sockets=8, fuse_rx=fuse_rx)
    want = np.asarray(js.engine.cpu_cost)
    got = ts.engine.cpu_cost.numpy()
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    crypto = ttor.RELAY_CYCLES_PER_BYTE * ttcp.MSS * 1_000_000 // 3_000_000
    per_event = tsim.CPU_CYCLES_PER_EVENT * 1_000_000 // 3_000_000
    relay = got[0]
    if fuse_rx:
        assert relay[tstack.KIND_PKT_ARRIVE] == 2 * per_event + crypto
        assert relay[tstack.KIND_PKT_RX] == per_event
    else:
        assert relay[tstack.KIND_PKT_RX] == per_event + crypto
    assert got[9:].sum() == 0  # servers and clients have no cpufrequency


# -- the one-hot helpers on hand-built rows ---------------------------------
def test_tc_lookup_matches_reference():
    """Rows with no match, one match, duplicates (first wins), matches at
    the last lane and negative ids."""
    cm = 8
    tc_cid = np.full((6, cm), -1, np.int32)
    tc_cid[1, 3] = 7
    tc_cid[2, [1, 4, 6]] = 5
    tc_cid[3, cm - 1] = 9
    tc_cid[4, :] = np.arange(cm)
    rng = np.random.default_rng(3)
    tables = dict(
        tc_cid=tc_cid,
        tc_nxt=rng.integers(-1, 1000, (6, cm)).astype(np.int32),
        tc_port=rng.integers(0, 65536, (6, cm)).astype(np.int32),
        tc_file=rng.integers(0, 1 << 40, (6, cm)).astype(np.int64))
    cid = np.array([7, 7, 5, 9, 0, -1], np.int32)

    def ref(tc_cid, tc_nxt, tc_port, tc_file, c):
        return jtor._tc_lookup(types.SimpleNamespace(
            tc_cid=tc_cid, tc_nxt=tc_nxt, tc_port=tc_port,
            tc_file=tc_file), c)

    want = jax.vmap(ref)(*(jnp.asarray(tables[k]) for k in tables),
                         jnp.asarray(cid))
    got = ttor._tc_lookup(types.SimpleNamespace(
        **{k: torch.from_numpy(v) for k, v in tables.items()}),
        torch.from_numpy(cid))
    for w, g in zip(want, got):
        w, g = np.asarray(w), g.numpy()
        assert w.dtype == g.dtype
        np.testing.assert_array_equal(g, w)
    assert got[0].tolist() == [False, True, True, True, True, True]
    assert got[1][2] == tables["tc_nxt"][2, 1]  # the first of three


def test_last_free_slot_matches_reference():
    """Several free slots, one, all and none."""
    proto = np.array([[2, 0, 1, 0, 2], [2, 2, 2, 2, 0], [0, 0, 0, 0, 0],
                      [1, 2, 2, 1, 2], [0, 2, 2, 2, 2]], np.int32)

    def ref(p):  # models/tor.py `_on_recv`'s out_slot pick
        free = p == jsock.PROTO_NONE
        return ((free.shape[0] - 1 - jnp.argmax(free[::-1])).astype(
            jnp.int32), jnp.any(free))

    want = jax.vmap(ref)(jnp.asarray(proto))
    got = ttor._last_free_slot(torch.from_numpy(proto))
    for w, g in zip(want, got):
        assert np.asarray(w).dtype == g.numpy().dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].tolist() == [3, 4, 4, 4, 0]
    assert got[1].tolist() == [True, True, True, False, True]


def test_link_slot_matches_reference():
    """The first established TCP slot to a peer: none, one, several,
    a half-open one and a UDP socket to the same peer."""
    proto = np.array([[1, 2, 2, 2], [1, 2, 2, 2], [1, 2, 2, 2],
                      [1, 2, 0, 2], [1, 2, 2, 2]], np.int32)
    peer_host = np.array([[5, -1, 3, 4], [5, -1, 5, 5], [5, -1, 5, 7],
                          [5, -1, 5, 5], [5, -1, 9, 9]], np.int32)
    state = np.array([[0, 1, 4, 4], [0, 1, 4, 7], [0, 1, 2, 4],
                      [0, 1, 4, 10], [0, 1, 4, 4]], np.int32)
    peer = np.array([5, 5, 5, 5, 8], np.int32)

    def ref(pr, ph, stt, p):  # models/bitcoin.py `_on_recv`'s link_slot
        match = (pr == jsock.PROTO_TCP) & (ph == p) & (stt >= jtcp.ESTABLISHED)
        return jnp.where(jnp.any(match), jnp.argmax(match).astype(jnp.int32),
                         -1)

    want = np.asarray(jax.vmap(ref)(*(jnp.asarray(a) for a in (
        proto, peer_host, state, peer))))
    t = lambda a: torch.from_numpy(a)
    got = tbtc.link_slot(types.SimpleNamespace(proto=t(proto),
                                               peer_host=t(peer_host)),
                         types.SimpleNamespace(state=t(state)),
                         t(peer)).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert got.tolist() == [-1, 2, -1, 3, -1]


# -- UDP on a TCP-enabled stack ---------------------------------------------
@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class JRecv:
    n: jax.Array
    slot: jax.Array
    proto: jax.Array
    length: jax.Array
    aux: jax.Array
    src: jax.Array


@dataclasses.dataclass(frozen=True)
class TRecv:
    n: torch.Tensor
    slot: torch.Tensor
    proto: torch.Tensor
    length: torch.Tensor
    aux: torch.Tensor
    src: torch.Tensor


UDP_PORT, LISTEN_PORT = 8333, 8334
KIND_SEND = ttcp.N_TCP_KINDS  # the first app kind behind TCP's two


def udp_on_tcp(pkg, fuse_rx):
    """Host 0 sends three datagrams (aux words 0x1000005, 0x2000006,
    0x7FFFFF) to host 1, whose slot 0 is a UDP socket and slot 1 a TCP
    listener, as Bitcoin binds them; a fourth goes to the listener's
    port. Host 1's receive callback records what it is handed."""
    jx = pkg == "jax"
    E, st_mod, sock, tcpm = ((jengine, jstack, jsock, jtcp) if jx else
                             (tengine, tstack, tsock, ttcp))
    xp = jnp if jx else torch
    Recv = JRecv if jx else TRecv
    tcp = tcpm.TCP(auto_close=False, in_order=True)
    stack = st_mod.Stack(tcp=tcp, fuse_rx=fuse_rx)
    auxes = (0x1000005, 0x2000006, 0x7FFFFF, 3)
    dev = {} if jx else {"device": "cpu"}

    def on_recv(hs, slot, pkt, now, key):
        app = hs.app
        got = slot >= 0
        sel = lambda v, old: xp.where(got, v, old)
        return dataclasses.replace(hs, app=Recv(
            n=app.n + (got.astype(jnp.int32) if jx else got.to(torch.int32)),
            slot=sel(slot, app.slot), proto=sel(pkt.proto, app.proto),
            length=sel(pkt.length, app.length), aux=sel(pkt.aux, app.aux),
            src=sel(pkt.src_host, app.src))), (
            E.Emit.single(dst=0, dt=0, kind=0, mask=False,
                          n_args=st_mod.N_PKT_ARGS) if jx else
            E.Emit.none(now.shape[0], 1, st_mod.N_PKT_ARGS, device="cpu"))

    def on_send(hs, ev, key):
        i = ev.args[0] if jx else ev.args[:, 0]
        pick = lambda vals: sum(xp.where(i == k, v, 0)
                                for k, v in enumerate(vals))
        port = xp.where(i == 3, LISTEN_PORT, UDP_PORT)
        hs, em = stack.send_udp(hs, ev.time, 0, 1 if jx else torch.ones_like(
            i), port, 61 + i * 7, aux=pick(auxes), mask=i < 4)
        nxt = E.Emit.single(dst=ev.dst, dt=3 * MS, kind=KIND_SEND,
                            args=[i + 1] if jx else (i + 1)[:, None],
                            mask=i + 1 < 4, local=True,
                            n_args=st_mod.N_PKT_ARGS)
        cat = (lambda a, b: jnp.concatenate([a, b])) if jx else (
            lambda a, b: torch.cat([a, b], dim=1))
        return hs, E.Emit(**{f: cat(getattr(em, f), getattr(nxt, f))
                             for f in ("dst", "dt", "kind", "args", "mask",
                                       "local")})

    cfg = E.EngineConfig(n_hosts=2, capacity=64, lookahead=10 * MS,
                         max_emit=tcp.min_max_emit(1), n_args=st_mod.N_PKT_ARGS,
                         seed=5)
    eng = E.Engine(cfg, stack.make_handlers(on_recv) + [on_send],
                   E.ConstantNetwork(10 * MS), **dev)
    if jx:
        net = st_mod.HostNet.create(2, 4, jnp.asarray([1024.0, 1024.0]),
                                    jnp.asarray([1024.0, 1024.0]),
                                    with_tcp=True)
    else:
        net = st_mod.HostNet.create(2, 4, 1024.0, 1024.0, with_tcp=True,
                                    device="cpu")
    tab = net.sockets.bind(1, 0, sock.PROTO_UDP, UDP_PORT).bind(
        1, 1, sock.PROTO_TCP, LISTEN_PORT).bind(0, 0, sock.PROTO_UDP, 999)
    net = dataclasses.replace(net, sockets=tab, tcb=net.tcb.listen(1, 1))
    z = lambda dt: (jnp.zeros((2,), dt) if jx
                    else torch.zeros((2,), dtype=dt))
    i32 = jnp.int32 if jx else torch.int32
    app = Recv(n=z(i32), slot=z(i32), proto=z(i32), length=z(i32),
               aux=z(i32), src=z(i32))
    init = dict(time=np.array([MS], np.int64), dst=np.zeros(1, np.int32),
                src=np.zeros(1, np.int32), seq=np.zeros(1, np.int32),
                kind=np.array([KIND_SEND], np.int32),
                args=np.zeros((1, st_mod.N_PKT_ARGS), np.int32))
    ev = (JEvents(**{k: jnp.asarray(v) for k, v in init.items()}) if jx
          else TEvents(**{k: torch.from_numpy(v) for k, v in init.items()}))
    st = eng.init_state(st_mod.SimHost(net=net, app=app), ev)
    if jx:
        return jax_leaves(jax.jit(eng.run)(st, jnp.int64(SECOND)))
    return convert.engine_state_to_numpy(eng.run(st, SECOND))


@pytest.mark.parametrize("fuse_rx", [True, False], ids=["fused", "unfused"])
def test_udp_datagram_reaches_a_tcp_host(fuse_rx):
    """The demux picks the UDP socket over the TCP listener by protocol,
    and the receive callback sees a UDP packet with its aux word; the
    datagram to the listener's port is dropped by the demux."""
    lt = udp_on_tcp("torch", fuse_rx)
    assert_leaves_equal(udp_on_tcp("jax", fuse_rx), lt)
    app = {k.split(".")[-1]: v for k, v in lt.items()
           if k.startswith("hosts.app.")}
    assert app["n"].tolist() == [0, 3]
    assert (app["slot"][1], app["proto"][1], app["aux"][1]) == (
        0, tsock.PROTO_UDP, 0x7FFFFF)
    assert app["length"][1] == 61 + 2 * 7 and app["src"][1] == 0
    assert lt["hosts.net.sockets.rx_bytes"][1].tolist() == [
        61 + 68 + 75, 0, 0, 0]
    assert lt["hosts.net.tcb.state"][1, 1] == ttcp.LISTEN


# -- the scenarios of tests/test_tor_bitcoin.py -----------------------------
SCENARIOS = {
    "tor-seed11": (lambda: harness.tor_config(), dict(seed=11, n_sockets=16)),
    "tor-seed4": (lambda: harness.tor_config(n_clients=2, count=1),
                  dict(seed=4, n_sockets=16)),
    "btc-seed9": (lambda: harness.btc_config(blocks=3),
                  dict(seed=9, n_sockets=16, capacity=512)),
}


@functools.lru_cache(maxsize=None)
def built(name):
    """(reference simulation, port simulation) of a scenario, built once
    per file: the reference compiles its run once per simulation."""
    make, kw = SCENARIOS[name]
    return build_both(make(), **kw)


@functools.lru_cache(maxsize=None)
def scenario(name):
    """(reference final leaves, port final leaves, port simulation)."""
    js, ts = built(name)
    assert_leaves_equal(jax_leaves(js.state0),
                        convert.engine_state_to_numpy(ts.state0))
    assert ts.kind_names == js.kind_names
    for knob in ("max_emit", "capacity", "lookahead", "burst"):
        assert getattr(ts.engine.cfg, knob) == getattr(js.engine.cfg, knob)
    return jax_leaves(js.run()), convert.engine_state_to_numpy(ts.run()), ts


def test_tor_circuits_match_reference():
    """tests/test_tor_bitcoin.py's three-hop fetches: every client pulls
    count x filesize through its circuit, relays move the replies."""
    lj, lt, ts = scenario("tor-seed11")
    assert_leaves_equal(lj, lt)
    done = lt["hosts.app.streams_done"][7:10]
    assert done.tolist() == [2, 2, 2]
    assert (lt["hosts.app.conn_rx"][7:10] >= 2 * 64 * 1024).all()
    assert lt["hosts.app.relayed_bytes"].sum() >= 3 * 3 * 2 * 64 * 1024
    assert (lt["hosts.app.fwd"][:6] >= 0).any()


@pytest.mark.slow
def test_tor_seed4_runs_twice_as_reference():
    """The determinism scenario: two port runs and the reference's."""
    lj, lt, ts = scenario("tor-seed4")
    assert_leaves_equal(lj, lt)
    assert_leaves_equal(lt, convert.engine_state_to_numpy(ts.run()))
    assert lt["hosts.app.streams_done"][7:9].tolist() == [1, 1]


@pytest.mark.slow
def test_overflow_is_loud_in_both_packages():
    """Capacity 64: strict overflow raises in both packages; with
    strict_overflow off both count the same drops and end equal."""
    text = harness.btc_config(blocks=3)
    js, ts = build_both(text, seed=9, n_sockets=16, capacity=64)
    with pytest.raises(RuntimeError, match="queue overflow"):
        js.run()
    with pytest.raises(RuntimeError, match="queue overflow"):
        ts.run()
    js.strict_overflow = ts.strict_overflow = False
    lj = jax_leaves(js.run())
    lt = convert.engine_state_to_numpy(ts.run())
    assert_leaves_equal(lj, lt)
    assert lt["queues.drops"].sum() > 0


def test_jax_tor_state_continues_in_the_port():
    """The reference's Tor state after the first client second (4 s),
    carried into the port, ends where the reference ends from it."""
    js, ts = built("tor-seed11")
    mid = js.run(4 * SECOND)
    carried_leaves = jax_leaves(mid)
    assert carried_leaves["stats.n_executed"].sum() > 0
    assert carried_leaves["hosts.app.streams_started"].sum() > 0
    want = jax_leaves(js.run(8 * SECOND, state=mid))
    carried = convert.engine_state_from_numpy(carried_leaves, "cpu",
                                              hosts=ts.state0.hosts)
    got = convert.engine_state_to_numpy(ts.run(8 * SECOND, state=carried))
    assert_leaves_equal(want, got)
    assert got["hosts.app.streams_done"].sum() > 0


# -- launches per inner step ------------------------------------------------
# the launching operations of one inner step (build_simulation's
# defaults: fused rx, burst folding), with a margin for the window and
# sweep work shared out over the steps
TOR_LAUNCHES_PER_STEP = 4800
BTC_LAUNCHES_PER_STEP = 4900


def launches_per_step(text, kw, t0_s, t1_s):
    sim = tsim.build_simulation(tconfig.parse_config(text), device="cpu",
                                **kw)
    st = sim.engine.run(sim.state0, int(t0_s * SECOND))
    steps0 = int(st.stats.n_inner_steps)
    with LaunchCount() as count:
        st = sim.engine.run(st, int(t1_s * SECOND))
    steps = int(st.stats.n_inner_steps) - steps0
    return steps, sum(count.ops.values()) / max(steps, 1), count


def test_tor_launches_per_inner_step():
    """One Tor inner step (chip_smoke's Tor knobs at 2 relays per class,
    10 clients, 2 servers), its window and sweep share included, stays
    under TOR_LAUNCHES_PER_STEP kernel-launching operations: 300 ms of
    circuit traffic after the first clients start."""
    steps, per_step, count = launches_per_step(
        chip_smoke.tor_config((2, 10, 2)), chip_smoke.TOR_KW, 3.2, 3.5)
    print(f"Tor: {steps} inner steps, {per_step:.0f} launching torch "
          f"operations per step; top: {count.ops.most_common(8)}")
    assert steps >= 10
    assert per_step < TOR_LAUNCHES_PER_STEP


# -- the slow pins: chip_smoke.py's phases 11 and 12 ------------------------
@pytest.mark.slow
def test_tor_parity_and_pins():
    """Tor at bench.py's 1,020-host tier to TOR_STOP_S in one call, in
    both packages on the CPU: equal leaves and the pins the card is held
    to."""
    js, ts = build_both(chip_smoke.tor_config(), **chip_smoke.TOR_KW)
    stop = int(chip_smoke.TOR_STOP_S * SECOND)
    lj = jax_leaves(js.run(stop))
    lt = convert.engine_state_to_numpy(ts.run(stop))
    assert_leaves_equal(lj, lt)
    assert chip_smoke.tor_pin(lj) == chip_smoke.PIN_TOR


