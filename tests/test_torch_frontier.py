"""The frontier drain of shadow_tpu_torch (`Engine._drain_window_frontier`)
against shadow_tpu, leaf for leaf.

- tests/test_model_batching.py's 3-pair TGen identity: the port's
  frontier run equals the reference's frontier run in every leaf,
  `n_inner_steps` included, and the port's own chained run in every
  leaf but `n_inner_steps`;
- Tor with relays on the virtual CPU (the burst CPU charge inside a
  run) and a Bitcoin gossip, each small, against the reference;
- a raw engine whose `frontier_kinds` leaves a kind out (it runs one
  position per round), with the queue-head guard and the headroom gate
  deciding, against the reference;
- the models' and the stack's frontier kinds equal the reference's;
- the three refusals: an unfused stack, a model that is not
  `frontier_safe`, and a FusedModel (which declares nothing).

With the slow tests also chip_smoke.py's phase 15 (TGen at 2048 pairs,
4096 hosts, 10 sim-s, frontier=16) in both packages, against its pins.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import torch_tcp_harness as tcp_harness
from shadow_tpu import config as jconfig
from shadow_tpu import examples as jexamples
from shadow_tpu import sim as jsim
from shadow_tpu.core import engine as jengine
from shadow_tpu.core.events import Events as JEvents
from shadow_tpu_torch import config as tconfig
from shadow_tpu_torch import convert
from shadow_tpu_torch import sim as tsim
from shadow_tpu_torch.core import engine as tengine
from shadow_tpu_torch.core.events import Events
from test_torch_chained import JToy, jax_toy
from test_torch_phold import assert_leaves_equal, jax_leaves
from test_torch_tcp import one_torch_thread  # noqa: F401 (autouse)
from torch_toy import (
    LAT, PING, TOY, TOY_STOP, TToy, toy_config, toy_initial, torch_toy,
)

INNER = "stats.n_inner_steps"


@functools.lru_cache(maxsize=None)
def runs(text, frontier, **kw):
    """{(package, frontier): final leaves} of one config."""
    out = {}
    for f in (frontier, 0):
        ts = tsim.build_simulation(tconfig.parse_config(text), device="cpu",
                                   frontier=f, **kw)
        ts.strict_overflow = False
        out["torch", f] = convert.engine_state_to_numpy(ts.run())
    js = jsim.build_simulation(jconfig.parse_config(text), frontier=frontier,
                               **kw)
    js.strict_overflow = False
    out["jax", frontier] = jax_leaves(js.run())
    return out


def _check(out, frontier):
    ft, fj, ct = (out["torch", frontier], out["jax", frontier],
                  out["torch", 0])
    assert_leaves_equal(fj, ft)
    less = lambda lv: {k: v for k, v in lv.items() if k != INNER}
    assert_leaves_equal(less(ct), less(ft))
    assert ft["stats.n_executed"].sum() > 0
    # the terminating probes count: more positions than chained steps
    assert ft[INNER] > ct[INNER]
    return ft


TGEN3 = jexamples.tgen_example(n_pairs=3, sendsize="8KiB", recvsize="24KiB",
                               count=3, stoptime=15)


def test_tgen_frontier_matches_chained_and_reference():
    ft = _check(runs(TGEN3, 8, seed=1, n_sockets=4), 8)
    assert ft["hosts.app.streams_done"].sum() == 9


def test_tor_relay_cpu_frontier_matches_reference():
    """Relays on a virtual CPU: the per-segment charge of burst-folded
    arrivals runs inside the position fold."""
    text = chip_smoke.tor_config((2, 4, 2)).replace(
        'stoptime="10"', 'stoptime="5"')
    ft = _check(runs(text, 8, **chip_smoke.TOR_KW), 8)
    assert ft["hosts.app.relayed_bytes"].sum() > 0


def test_bitcoin_frontier_matches_reference():
    """UDP control and TCP block bodies under the frontier drain."""
    ft = _check(runs(tcp_harness.btc_config(6, blocks=1, interval=10), 16,
                     seed=7, n_sockets=16, capacity=512), 16)
    assert ft["hosts.app.best"][:6].tolist() == [1] * 6


def test_raw_engine_frontier_kinds_match_reference():
    """A raw engine at frontier=4 whose frontier_kinds holds PING only:
    TICK chains run one position per round; the toy's hot peers make
    the queue-head guard and the exact headroom gate decide."""
    name = "hot-peers"
    n, msgs, peers = TOY[name][:3]
    kw = dict(toy_config(name), frontier=4)
    et = tengine.Engine(tengine.EngineConfig(**kw), torch_toy(peers),
                        tengine.ConstantNetwork(LAT), frontier_kinds=(PING,),
                        device="cpu")
    z = torch.zeros((n,), dtype=torch.int64)
    init = et.init_state(TToy(z, z, z), Events(**{
        k: torch.from_numpy(v) for k, v in toy_initial(n, msgs).items()}))
    lt = convert.engine_state_to_numpy(et.run(init, TOY_STOP))
    ej = jengine.Engine(jengine.EngineConfig(**kw), jax_toy(peers),
                        jengine.ConstantNetwork(LAT), frontier_kinds=(PING,))
    zj = jnp.zeros((n,), jnp.int64)
    initj = ej.init_state(JToy(zj, zj, zj), JEvents(**{
        k: jnp.asarray(v) for k, v in toy_initial(n, msgs).items()}))
    assert_leaves_equal(jax_leaves(jax.jit(ej.run)(initj,
                                                   jnp.int64(TOY_STOP))), lt)
    assert et._frontier_kinds == ej._frontier_kinds == (PING,)
    assert lt["stats.n_executed"].sum() > 0


@pytest.mark.parametrize("make", [
    lambda: jexamples.tgen_example(2, stoptime=5),
    lambda: chip_smoke.tor_config((2, 4, 2)),
    lambda: tcp_harness.btc_config(4, blocks=1),
], ids=["tgen", "tor", "bitcoin"])
def test_frontier_kinds_match_reference(make):
    text = make()
    ts = tsim.build_simulation(tconfig.parse_config(text), frontier=4,
                               device="cpu")
    js = jsim.build_simulation(jconfig.parse_config(text), frontier=4)
    assert ts.engine._frontier_kinds == js.engine._frontier_kinds
    assert ts.stack.frontier_kinds() == js.stack.frontier_kinds()
    assert ts.app.frontier_safe and js.app.frontier_safe
    assert ts.engine.cfg.frontier == js.engine.cfg.frontier == 4


def test_frontier_refusals():
    """The reference's eligibility checks, with its messages: an unfused
    stack, a model whose pause table holds 0 (not frontier_safe), a UDP
    model and a fused multi-model config (FusedModel declares nothing)."""
    tgen = jexamples.tgen_example(2, stoptime=5)
    cases = [
        (tgen, dict(fuse_rx=False), "fuse_rx"),
        (tgen.replace("pause=1,2,3", "pause=0,1"), {}, "frontier_safe"),
        (jexamples.phold_example(8, 1, 2), {}, "TCP stack"),
        (chip_smoke.mixed_config(2, 4, 5), {}, "frontier_safe"),
    ]
    for text, kw, why in cases:
        for sim_mod, cfg_mod, extra in ((jsim, jconfig, {}),
                                        (tsim, tconfig, {"device": "cpu"})):
            with pytest.raises(ValueError, match=why):
                sim_mod.build_simulation(cfg_mod.parse_config(text),
                                         frontier=8, **kw, **extra)
    with pytest.raises(ValueError):
        tengine.EngineConfig(n_hosts=4, capacity=8, lookahead=1,
                             frontier=-1)


def test_frontier_zero_is_the_chained_drain():
    """frontier=0 spelled out builds the chained drain: equal leaves to a
    build without the knob."""
    text = jexamples.tgen_example(2, stoptime=5)
    out = []
    for kw in ({}, {"frontier": 0}):
        ts = tsim.build_simulation(tconfig.parse_config(text), seed=1,
                                   device="cpu", **kw)
        assert ts.engine._frontier_kinds is None
        out.append(convert.engine_state_to_numpy(ts.run()))
    assert_leaves_equal(*out)


# -- the slow pins: chip_smoke.py's phase 15 ---------------------------------
@pytest.mark.slow
def test_tgen_frontier_bench_shape_parity_and_pins():
    """Phase 15 in both packages on the CPU: equal leaves, the pin, and
    the state less n_inner_steps equal to phase 10's."""
    torch.set_num_threads(4)
    text = chip_smoke.tgen_config(chip_smoke.TGEN_PAIRS)
    kw = dict(seed=chip_smoke.TGEN_SEED, n_sockets=chip_smoke.TGEN_SOCKETS,
              capacity=chip_smoke.TGEN_CAPACITY,
              frontier=chip_smoke.TGEN_FRONTIER)
    js = jsim.build_simulation(jconfig.parse_config(text), **kw)
    ts = tsim.build_simulation(tconfig.parse_config(text), device="cpu",
                               **kw)
    ts.strict_overflow = js.strict_overflow = False
    lj = jax_leaves(js.run())
    lt = convert.engine_state_to_numpy(ts.run())
    assert_leaves_equal(lj, lt)
    assert chip_smoke.tgen_frontier_pin(lj) == chip_smoke.PIN_TGEN_FRONTIER
    assert convert.leaves_digest(lj, (INNER,)) == chip_smoke.TGEN_LESS_INNER
    # with phase 10's count of inner steps it is phase 10's state
    with_chained_count = dict(lj, **{INNER: np.asarray(
        chip_smoke.PIN_TGEN[3], lj[INNER].dtype)})
    assert convert.leaves_digest(with_chained_count) == chip_smoke.PIN_TGEN[-1]
