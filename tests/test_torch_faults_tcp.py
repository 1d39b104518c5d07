"""Faults under TCP in shadow_tpu_torch against shadow_tpu, leaf for leaf.

- tests/test_faults.py's matrix on its 2-host TGen echo, each case run
  through both packages' `Simulation.run` with every final-state leaf
  compared: a crash during a transfer (no restart), a crash with a
  restart, a partition that heals and a loss spike; stops are shortened
  from the reference tests' 40-50 s to keep the file short, and each
  case still shows its fault firing (fault drops, quarantined events,
  retransmits) as the reference tests assert;
- chip_smoke.py's phase 16 schedule (TGen under server churn, a
  partition, a loss spike, latency inflation and throttled server NICs)
  at 32 pairs on the chained drain, and the port's frontier drain on it,
  whose state is the chained one less `n_inner_steps`;
- the kernel-launching torch operations the overlays add to a TGen inner
  step;
- with the slow tests also chip_smoke.py's phase 16 (TGen at 2048 pairs,
  4096 hosts, 10 sim-s, under all five fault types) in both packages,
  against its pin.

Every comparison is exact, dtypes included.
"""

import functools

import pytest
import torch

import chip_smoke
from shadow_tpu import config as jconfig
from shadow_tpu import sim as jsim
from shadow_tpu_torch import config as tconfig
from shadow_tpu_torch import convert
from shadow_tpu_torch import sim as tsim
from test_faults import echo_config
from test_torch_tgen import LaunchCount
from test_torch_phold import assert_leaves_equal, jax_leaves
from test_torch_tcp import one_torch_thread  # noqa: F401 (autouse)

SECOND = 1_000_000_000

# name: (<fault> element, streams, stop in sim-s, seed), seeds as in
# tests/test_faults.py
MATRIX = {
    "crash-during-transfer": (
        '<fault type="crash" hosts="server" start="5"/>', 4, 15, 42),
    "restart": (
        '<fault type="crash" hosts="server" start="5" end="8"/>', 4, 15, 3),
    "partition-heals": (
        '<fault type="partition" src="client" dst="server" start="4" '
        'end="10"/>', 3, 20, 7),
    "loss-spike": (
        '<fault type="loss" src="*" dst="*" loss="0.6" start="4" end="8"/>',
        3, 15, 11),
}


@functools.lru_cache(maxsize=None)
def matrix_run(name):
    """(reference leaves, port leaves, port simulation) of a MATRIX case."""
    fault, count, stop, seed = MATRIX[name]
    text = echo_config(fault, count=count, stoptime=stop)
    js = jsim.build_simulation(jconfig.parse_config(text), seed=seed)
    ts = tsim.build_simulation(tconfig.parse_config(text), seed=seed,
                               device="cpu")
    return jax_leaves(js.run()), convert.engine_state_to_numpy(ts.run()), ts


@pytest.mark.parametrize("name", list(MATRIX))
def test_fault_matrix_matches_reference(name):
    lj, lt, ts = matrix_run(name)
    assert_leaves_equal(lj, lt)
    ci, si = ts.names.index("client"), ts.names.index("server")
    fd = int(lt["stats.n_fault_dropped"].sum())
    q = int(lt["stats.n_quarantined"].sum())
    done = int(lt["hosts.app.streams_done"][ci])
    retx = int(lt["hosts.net.tcb.n_retx"].sum())
    assert ts.faults is not None and fd > 0
    crash = name in ("crash-during-transfer", "restart")
    # a crash or churn fault makes unmatched segments draw an RST
    assert ts.stack.tcp.rst_on_unmatched == crash
    assert ts.faults.has_crash == crash and ts.faults.has_link != crash
    if name == "crash-during-transfer":
        # the server never returns: the client cannot finish, although a
        # fault-free run finishes all four streams by the same stop
        assert q > 0 and done < 4
        free = tsim.build_simulation(
            tconfig.parse_config(echo_config(count=4, stoptime=15)),
            seed=42, device="cpu").run()
        assert int(free.hosts.app.streams_done[ci]) == 4
        assert not ts.faults.alive_at_host(14 * SECOND)[si]
    elif name == "restart":
        assert q > 0 and done == 4 and int(lt["fault_epoch"]) == 2
        assert ts.faults.alive_at_host(9 * SECOND)[si]
        assert not ts.faults.alive_at_host(6 * SECOND)[si]
    else:
        # streams finish after the heal: retransmission recovered them
        assert q == 0 and done == 3 and retx > 0
        heal = 10 if name == "partition-heals" else 8
        assert int(lt["hosts.app.t_last_done"][ci]) > heal * SECOND


TGEN_KW = dict(seed=chip_smoke.TGEN_SEED, n_sockets=chip_smoke.TGEN_SOCKETS,
               capacity=chip_smoke.TGEN_CAPACITY)


def test_phase16_schedule_at_32_pairs_matches_reference():
    """Every overlay fires by 7.5 s: fault drops, quarantined events, a
    restart, retransmits, and streams that finish after the partition
    heals (7 s)."""
    text = chip_smoke.tgen_faults_config(32)
    stop = int(7.5 * SECOND)
    js = jsim.build_simulation(jconfig.parse_config(text), **TGEN_KW)
    lj = jax_leaves(js.run(stop))
    out = {}
    for frontier in (0, chip_smoke.TGEN_FRONTIER):
        ts = tsim.build_simulation(tconfig.parse_config(text), device="cpu",
                                   frontier=frontier, **TGEN_KW)
        out[frontier] = convert.engine_state_to_numpy(ts.run(stop))
    lt = out[0]
    assert_leaves_equal(lj, lt)
    f = ts.faults
    assert f.has_crash and f.has_link and f.has_bw
    assert any(up for *_, up in f.transitions_in(0, 10 * SECOND))
    assert lt["stats.n_fault_dropped"].sum() > 0
    assert lt["stats.n_quarantined"].sum() > 0
    assert lt["hosts.net.tcb.n_retx"].sum() > 0
    assert (lt["hosts.app.t_last_done"] > 7 * SECOND).sum() > 0
    less = lambda lv: {k: v for k, v in lv.items()
                       if k != "stats.n_inner_steps"}
    assert_leaves_equal(less(lt), less(out[chip_smoke.TGEN_FRONTIER]))
    assert (out[chip_smoke.TGEN_FRONTIER]["stats.n_inner_steps"]
            > lt["stats.n_inner_steps"])


# the launching torch operations a fault schedule may add to a TGen inner
# step, its window share (the epoch wipes and rescales) included
FAULT_LAUNCHES_PER_STEP = 400


def test_tgen_faults_launches_per_inner_step():
    """Phase 16's schedule at 32 pairs against the same config without
    it, over one sim-second of faulted traffic (4.6-5.6 s): the overlays
    add fewer than FAULT_LAUNCHES_PER_STEP kernel-launching operations
    per inner step, on a chained drain bound by their dispatch."""
    per_step = {}
    for name, text in (("free", chip_smoke.tgen_config(32)),
                       ("faults", chip_smoke.tgen_faults_config(32))):
        sim = tsim.build_simulation(tconfig.parse_config(text),
                                    device="cpu", **TGEN_KW)
        st = sim.engine.run(sim.state0, int(4.6 * SECOND))
        steps0 = int(st.stats.n_inner_steps)
        with LaunchCount() as count:
            st = sim.engine.run(st, int(5.6 * SECOND))
        steps = int(st.stats.n_inner_steps) - steps0
        assert steps >= 30
        per_step[name] = sum(count.ops.values()) / steps
    print(f"TGen 32 pairs, launching operations per inner step: {per_step}")
    assert 0 < per_step["faults"] - per_step["free"] < FAULT_LAUNCHES_PER_STEP


# -- the slow pin: chip_smoke.py's phase 16 -----------------------------------
@pytest.mark.slow
def test_tgen_faults_bench_shape_parity_and_pin():
    """Phase 16 in both packages on the CPU: equal leaves, the pin, and
    every overlay firing."""
    torch.set_num_threads(4)
    text = chip_smoke.tgen_faults_config(chip_smoke.TGEN_PAIRS)
    kw = dict(seed=chip_smoke.TGEN_SEED, n_sockets=chip_smoke.TGEN_SOCKETS,
              capacity=chip_smoke.TGEN_CAPACITY)
    js = jsim.build_simulation(jconfig.parse_config(text), **kw)
    ts = tsim.build_simulation(tconfig.parse_config(text), device="cpu",
                               **kw)
    ts.strict_overflow = js.strict_overflow = False
    stop = chip_smoke.FAULTS_STOP_S * SECOND
    lj = jax_leaves(js.run(stop))
    lt = convert.engine_state_to_numpy(ts.run(stop))
    assert_leaves_equal(lj, lt)
    pin = chip_smoke.tgen_faults_pin(lj)
    assert pin == chip_smoke.PIN_TGEN_FAULTS
    streams, fault_drops, quarantined, retx = pin[5:9]
    assert fault_drops > 0 and quarantined > 0 and retx > 0
    f = ts.faults
    assert f.has_crash and f.has_link and f.has_bw
    assert any(up for t, _g, up in f.transitions_in(0, 10 * SECOND))
    # streams finish after the partition heals (7 s)
    assert (lj["hosts.app.t_last_done"] > 7 * SECOND).sum() > 0
