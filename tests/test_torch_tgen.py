"""TGen over TCP through `build_simulation` in shadow_tpu_torch against
shadow_tpu, leaf for leaf.

- `parse_arguments` (inline k=v and a GraphML action graph) gives the
  reference's profiles; `example_config` and `tgen_example` are the
  reference's text;
- built from the same config, both packages start from equal states
  (and equal handler tables, max_emit, capacity) and end in equal ones:
  `tgen_example(3)` with chip_smoke.py's TGen knobs (burst folding on
  the chained drain, in-order delivery), and a config with
  `socketsendbuffer` and `socketrecvbuffer` under qdisc "rr" and AIMD,
  and `tgen_example(1)` with burst folding off (`burst_rx=False`);
  with the slow tests also the reference's --test config and an unfused
  build with out-of-order delivery, a two-word window and a child-slot
  limit;
- the build takes CUBIC (F2 solved; tests/test_torch_cubic.py runs it);
- the work of one TGen inner step, counted as the torch operations that
  launch a kernel on a device (views and host scalars left out): the
  chained drain is bound by their dispatch, so the count predicts its
  time on the card;
- the slow pins: chip_smoke.py's phase 10 run (TGen at 2048 pairs, 4096
  hosts, 10 sim-s; select it with `-k 4096`) and the bench's 256-pair
  shape, in both packages, against chip_smoke's constants.

Every comparison is exact, dtypes included.
"""

import collections
import dataclasses
import functools

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import chip_smoke
from shadow_tpu import config as jconfig
from shadow_tpu import examples as jexamples
from shadow_tpu import sim as jsim
from shadow_tpu.models import tgen as jtgen
from shadow_tpu_torch import config as tconfig
from shadow_tpu_torch import convert
from shadow_tpu_torch import examples as texamples
from shadow_tpu_torch import sim as tsim
from shadow_tpu_torch.models import tgen as ttgen
from shadow_tpu_torch.transport import tcp as ttcp
from test_config_sim import TOPO_1POI
from test_torch_phold import assert_leaves_equal, jax_leaves
from test_torch_tcp import one_torch_thread  # noqa: F401 (autouse)

SECOND = 1_000_000_000

GRAPH = """<graphml xmlns="http://graphml.graphdrawing.org/xmlns">
  <key attr.name="peers" attr.type="string" for="node" id="d0"/>
  <key attr.name="time" attr.type="string" for="node" id="d1"/>
  <key attr.name="sendsize" attr.type="string" for="node" id="d2"/>
  <key attr.name="recvsize" attr.type="string" for="node" id="d3"/>
  <key attr.name="count" attr.type="string" for="node" id="d4"/>
  <key attr.name="type" attr.type="string" for="node" id="d5"/>
  <key attr.name="filesize" attr.type="string" for="node" id="d6"/>
  <graph edgedefault="directed">
    <node id="start"><data key="d0">a:80,b.example:8888</data>
      <data key="d1">2.5,9</data></node>
    <node id="stream"><data key="d2">1 MiB</data>
      <data key="d3">300KiB</data></node>
    <node id="transfer"><data key="d5">put</data>
      <data key="d6">5 KiB</data></node>
    <node id="pause"><data key="d1">1,0.5,3</data></node>
    <node id="end"><data key="d4">7</data></node>
    <edge source="start" target="stream"/>
  </graph>
</graphml>"""


def test_parse_arguments_match_reference(tmp_path):
    (tmp_path / "client.graphml").write_text(GRAPH)
    for args in ("server port=8888", "serverport=9000", "server",
                 "peers=srv0:8888,b:80 sendsize=16KiB recvsize=64KiB "
                 "count=4 pause=1,2,3 time=0.5", "peers=x:1 sendsize=0",
                 "client.graphml", "  "):
        got = ttgen.parse_arguments(args, str(tmp_path))
        want = jtgen.parse_arguments(args, str(tmp_path))
        assert dataclasses.asdict(got) == dataclasses.asdict(want), args
    prof = ttgen.parse_arguments("client.graphml", str(tmp_path))
    assert prof.peers == [("a", 80), ("b.example", 8888)]
    assert (prof.sendsize, prof.count, prof.pause_s) == (5 * 1024, 7,
                                                          [1.0, 0.5, 3.0])
    with pytest.raises(FileNotFoundError):
        ttgen.parse_arguments("missing.xml", str(tmp_path))
    assert texamples.example_config() == jexamples.example_config()
    assert texamples.tgen_example(5, "1KiB", "3KiB", 2, 9) == \
        jexamples.tgen_example(5, "1KiB", "3KiB", 2, 9)


def knobs_config():
    """A server behind an 8-segment socketrecvbuffer, clients behind a
    16 KiB socketsendbuffer, two streams each."""
    def client(i, extra=""):
        return (f'<host id="c{i}"{extra}><process plugin="tgen" '
                f'starttime="{2 + i}" arguments="peers=server:8888 '
                'sendsize=40KiB recvsize=60KiB count=2 pause=1,2"/></host>')

    return (
        '<shadow stoptime="10">'
        f"<topology><![CDATA[{TOPO_1POI}]]></topology>"
        '<plugin id="tgen" path="tgen"/>'
        f'<host id="server" socketrecvbuffer="{8 * ttcp.MSS}">'
        '<process plugin="tgen" starttime="1" arguments="server port=8888"/>'
        "</host>" + client(0, ' socketsendbuffer="16384"') + client(1)
        + "</shadow>")


# chip_smoke's phase-10 knobs (bench.py's TCP measurement)
BENCH_KW = dict(seed=chip_smoke.TGEN_SEED, n_sockets=chip_smoke.TGEN_SOCKETS,
                capacity=chip_smoke.TGEN_CAPACITY)

RUNS = {
    "pairs": (lambda: texamples.tgen_example(3, stoptime=8), BENCH_KW),
    "knobs": (knobs_config, dict(seed=5, qdisc="rr", tcp_cc="aimd")),
    "example": (lambda: texamples.example_config().replace(
        'stoptime="120"', 'stoptime="12"'), dict(seed=2)),
    "burst_off": (lambda: texamples.tgen_example(1, stoptime=5),
                  dict(seed=4, burst_rx=False)),
    "unfused": (lambda: texamples.tgen_example(2, "20KiB", "30KiB", 3, 9),
                dict(seed=3, fuse_rx=False, tcp_in_order=False,
                     tcp_wnd_words=2, tcp_child_slot_limit=4, n_sockets=6)),
}


@functools.lru_cache(maxsize=None)
def runs_of(name):
    """(state0 leaves, final leaves, simulation) per package."""
    make, kw = RUNS[name]
    text = make()
    js = jsim.build_simulation(jconfig.parse_config(text), **kw)
    ts = tsim.build_simulation(tconfig.parse_config(text), device="cpu",
                               **kw)
    return ((jax_leaves(js.state0), jax_leaves(js.run()), js),
            (convert.engine_state_to_numpy(ts.state0),
             convert.engine_state_to_numpy(ts.run()), ts))


@pytest.mark.parametrize("name", [
    n if n in ("pairs", "knobs", "burst_off") else pytest.param(n, marks=pytest.mark.slow)
    for n in RUNS])
def test_tgen_run_matches_reference(name):
    (j0, jf, js), (t0, tf, ts) = runs_of(name)
    assert_leaves_equal(j0, t0)
    assert ts.kind_names == js.kind_names
    for knob in ("max_emit", "capacity", "lookahead", "burst"):
        assert getattr(ts.engine.cfg, knob) == getattr(js.engine.cfg, knob)
    assert_leaves_equal(jf, tf)
    done = tf["hosts.app.streams_done"]
    assert done.sum() > 0
    if name == "pairs":
        assert tf["stats.n_by_kind"][:, 2:4].sum() > 0  # tcp_timer, tcp_tx
        assert ts.engine.cfg.burst is not None
    if name == "knobs":
        assert tf["hosts.net.tcb.snd_cap"].max() == 16384
        assert tf["hosts.net.tcb.rwnd_cap"][0].max() == 8
        assert done[1:3].tolist() == [2, 2]
    if name == "example":
        # 64 KiB up and 1 MiB down per stream, exactly once
        assert tf["hosts.net.sockets.rx_bytes"][1].sum() == \
            done[1] * 1024 * 1024
    if name == "burst_off":
        assert ts.engine.cfg.burst is None
        assert tf["stats.n_by_kind"][:, 1].sum() == 0  # rx stays fused
    if name == "unfused":
        assert ts.engine.cfg.burst is None
        assert tf["stats.n_by_kind"][:, 1].sum() > 0  # KIND_PKT_RX ran


def test_cubic_is_refused():
    # CUBIC is ported (F2 solved): the build takes it
    cfg = tconfig.parse_config(texamples.tgen_example(2, stoptime=4))
    ts = tsim.build_simulation(cfg, tcp_cc="cubic", device="cpu")
    assert ts.stack.tcp.cc.name == "cubic"
    with pytest.raises(ValueError, match="qdisc"):
        tsim.build_simulation(cfg, qdisc="prio", device="cpu")


# operations that launch no kernel: views, and host-side scalar wrapping
NO_LAUNCH = {"aten.view", "aten.unsqueeze", "aten.select", "aten.expand",
             "aten.slice", "aten._unsafe_view", "aten.alias", "aten.detach",
             "aten.squeeze", "aten.lift_fresh", "aten.scalar_tensor",
             "aten._reshape_alias", "aten.t", "aten.permute",
             "aten.as_strided", "aten.detach_"}
# the launches of one TGen inner step (build_simulation's defaults: fused
# rx, burst folding), with a margin for the window and sweep work shared
# out over the steps
TGEN_LAUNCHES_PER_STEP = 4600


_COMPOSITE: dict = {}  # op overload -> whether it is composite


def _composite(func) -> bool:
    c = _COMPOSITE.get(func)
    if c is None:
        c = _COMPOSITE[func] = func.has_kernel_for_dispatch_key(
            torch._C.DispatchKey.CompositeImplicitAutograd)
    return c


class LaunchCount(TorchDispatchMode):
    """Counts the torch operations that would launch a device kernel."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _composite(func) and torch.is_inference_mode_enabled():
            # the engine runs under inference mode, where a composite op
            # (reshape, to, __and__) reaches this mode whole: count the
            # operations it runs as, as outside inference mode
            with self:
                return func.decompose(*args, **kwargs)
        name = str(func.overloadpacket)
        if name not in NO_LAUNCH:
            self.ops[name] += 1
        return func(*args, **kwargs)


def test_tgen_launches_per_inner_step():
    """One TGen inner step, its window and sweep share included, stays
    under TGEN_LAUNCHES_PER_STEP kernel-launching operations: 300 ms of
    steady traffic after the first clients start (3 s)."""
    sim = tsim.build_simulation(
        tconfig.parse_config(chip_smoke.tgen_config(2)), device="cpu",
        **BENCH_KW)
    st = sim.engine.run(sim.state0, int(3.2 * SECOND))
    steps0 = int(st.stats.n_inner_steps)
    with LaunchCount() as count:
        st = sim.engine.run(st, int(3.5 * SECOND))
    steps = int(st.stats.n_inner_steps) - steps0
    per_step = sum(count.ops.values()) / steps
    print(f"TGen: {steps} inner steps, {per_step:.0f} launching torch "
          f"operations per step; top: {count.ops.most_common(8)}")
    assert steps >= 10
    assert per_step < TGEN_LAUNCHES_PER_STEP


# -- the slow pins: chip_smoke.py's phase 10 and the bench shape -------------
@pytest.mark.slow
@pytest.mark.parametrize("n_pairs", [
    pytest.param(chip_smoke.TGEN_BENCH_PAIRS, id="512-hosts"),
    pytest.param(chip_smoke.TGEN_PAIRS, id="4096-hosts")])
def test_tgen_parity_and_pins(n_pairs):
    """TGen at bench.py's TCP knobs in both packages on the CPU: equal
    leaves, and the (events, windows, sweeps, inner steps, streams done,
    digest) pins the card is held to."""
    text = chip_smoke.tgen_config(n_pairs)
    js = jsim.build_simulation(jconfig.parse_config(text), **BENCH_KW)
    ts = tsim.build_simulation(tconfig.parse_config(text), device="cpu",
                               **BENCH_KW)
    ts.strict_overflow = js.strict_overflow = False
    lj = jax_leaves(js.run())
    lt = convert.engine_state_to_numpy(ts.run())
    assert_leaves_equal(lj, lt)
    pins = {chip_smoke.TGEN_BENCH_PAIRS: chip_smoke.PIN_TGEN_BENCH,
            chip_smoke.TGEN_PAIRS: chip_smoke.PIN_TGEN}
    assert chip_smoke.tgen_pin(lj) == pins[n_pairs]
