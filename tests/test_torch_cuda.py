"""shadow_tpu_torch on a CUDA card: the kernel against its plain version,
and each path against the same run on the CPU.

Every test here needs a CUDA device and skips without one. The file
imports no JAX, so it runs where JAX is not installed; from the
repository root, on the card's machine:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(`--noconftest` skips tests/conftest.py, which configures JAX.)
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
import torch_tcp_harness as tcp_harness
import torch_toy
from shadow_tpu_torch import convert, examples
from shadow_tpu_torch.core import merge
from shadow_tpu_torch.models import phold

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.parametrize(
    "h,hc,w,nw,regime",
    chip_smoke.SWEEP + chip_smoke.TIMING + chip_smoke.RAGGED)
def test_kernel_matches_plain(h, hc, w, nw, regime):
    _need_card()
    rng = np.random.default_rng(h + hc + w + nw)
    args = [torch.from_numpy(a).cuda()
            for a in chip_smoke.merge_inputs(rng, h, hc, w, nw, regime)]
    before = merge.launches
    got = merge.fused_merge(*args)
    want = merge.merge_body(*args)
    torch.cuda.synchronize()
    assert merge.launches == before + 1
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("kw", [
    dict(msgs_per_host=4, seed=3),
    dict(msgs_per_host=16, seed=9, hot_hosts=1, hot_weight=0.9),
], ids=["uniform", "fallback-round"])
def test_phold_on_cuda_matches_cpu(kw):
    """The whole slice on the card equals the CPU run (which the CPU
    tests hold against the JAX reference), through the kernel."""
    _need_card()
    states = {}
    for dev in ("cuda", "cpu"):
        eng, init = phold.build(32, device=dev, batched=True, **kw)
        before = merge.launches
        st = eng.run(init(), 2 * chip_smoke.SECOND)
        states[dev] = convert.engine_state_to_numpy(st)
        if dev == "cuda":
            assert merge.launches > before
    assert states["cuda"].keys() == states["cpu"].keys()
    for key, a in states["cpu"].items():
        np.testing.assert_array_equal(states["cuda"][key], a, err_msg=key)


def test_chained_phold_on_cuda_matches_cpu():
    """PHOLD on the chained drain (the default build) on the card equals
    the CPU run, through the kernel."""
    _need_card()
    states = {}
    for dev in ("cuda", "cpu"):
        eng, init = phold.build(32, device=dev, msgs_per_host=4, seed=3)
        before = merge.launches
        states[dev] = convert.engine_state_to_numpy(
            eng.run(init(), 2 * chip_smoke.SECOND))
        if dev == "cuda":
            assert merge.launches - before >= int(
                states[dev]["stats.n_sweeps"]) > 0
    for key, a in states["cpu"].items():
        np.testing.assert_array_equal(states["cuda"][key], a, err_msg=key)


def test_chained_toy_on_cuda_matches_cpu():
    """The two-kind toy (local chains, queue-head guard, high-water gate,
    full-width flush) on the card equals the CPU run, which
    tests/test_torch_chained.py holds against the JAX reference."""
    _need_card()
    _, on_card = torch_toy.run_torch_toy("hot-peers", device="cuda")
    _, on_cpu = torch_toy.run_torch_toy("hot-peers", device="cpu")
    assert on_card.keys() == on_cpu.keys()
    for key, a in on_cpu.items():
        np.testing.assert_array_equal(on_card[key], a, err_msg=key)
    assert on_cpu["stats.n_inner_steps"] > on_cpu["stats.n_windows"]


def test_phold_net_on_cuda_matches_cpu():
    """PHOLD over the UDP stack, built from a config by build_simulation
    (64 hosts, CoDel, fused rx), on the card equals the CPU run, which
    tests/test_torch_sim.py holds against the JAX reference."""
    _need_card()
    from shadow_tpu_torch import config, examples, sim

    cfg = config.parse_config(examples.phold_example(64, 4, stoptime=3))
    states = {}
    for dev in ("cuda", "cpu"):
        s = sim.build_simulation(cfg, seed=7, device=dev)
        before = merge.launches
        states[dev] = convert.engine_state_to_numpy(s.run())
        if dev == "cuda":
            assert merge.launches - before >= int(
                states[dev]["stats.n_sweeps"]) > 0
    assert states["cuda"].keys() == states["cpu"].keys()
    for key, a in states["cpu"].items():
        np.testing.assert_array_equal(states["cuda"][key], a, err_msg=key)
    assert states["cpu"]["hosts.app.n_recv"].sum() > 0


def test_tgen_on_cuda_matches_cpu():
    """TGen over TCP (NewReno, burst folding), built from a config by
    build_simulation (3 pairs, bucketed to 16 hosts), on the card equals
    the CPU run, which tests/test_torch_tgen.py holds against the JAX
    reference."""
    _need_card()
    from shadow_tpu_torch import config, sim

    cfg = config.parse_config(chip_smoke.tgen_config(3).replace(
        f'stoptime="{chip_smoke.TGEN_STOP_S}"', 'stoptime="6"'))
    states = {}
    for dev in ("cuda", "cpu"):
        s = sim.build_simulation(
            cfg, seed=chip_smoke.TGEN_SEED, n_sockets=chip_smoke.TGEN_SOCKETS,
            capacity=chip_smoke.TGEN_CAPACITY, device=dev)
        before = merge.launches
        states[dev] = convert.engine_state_to_numpy(s.run())
        if dev == "cuda":
            assert merge.launches - before >= int(
                states[dev]["stats.n_sweeps"]) > 0
    assert states["cuda"].keys() == states["cpu"].keys()
    for key, a in states["cpu"].items():
        np.testing.assert_array_equal(states["cuda"][key], a, err_msg=key)
    assert states["cpu"]["hosts.app.streams_done"].sum() > 0
    assert states["cpu"]["hosts.net.tcb.ooo"].dtype == np.uint64


def _config_on_both(text, kw, stop_s=None):
    """{device: final leaves} of one config built by build_simulation on
    the card and on the CPU; the card run must launch the merge at least
    once per sweep."""
    from shadow_tpu_torch import config, sim

    states = {}
    for dev in ("cuda", "cpu"):
        s = sim.build_simulation(config.parse_config(text), device=dev, **kw)
        before = merge.launches
        st = s.run(None if stop_s is None else stop_s * chip_smoke.SECOND)
        states[dev] = convert.engine_state_to_numpy(st)
        if dev == "cuda":
            assert merge.launches - before >= int(
                states[dev]["stats.n_sweeps"]) > 0
    assert states["cuda"].keys() == states["cpu"].keys()
    for key, a in states["cpu"].items():
        np.testing.assert_array_equal(states["cuda"][key], a, err_msg=key)
    return states["cpu"]


def test_tor_on_cuda_matches_cpu():
    """Tor (tests/test_tor_bitcoin.py's three-hop scenario, seed 11) on
    the card equals the CPU run, which tests/test_torch_tor_bitcoin.py
    holds against the JAX reference."""
    _need_card()
    cpu = _config_on_both(tcp_harness.tor_config(),
                          dict(seed=11, n_sockets=16))
    assert cpu["hosts.app.streams_done"][7:10].tolist() == [2, 2, 2]


def test_tor_relay_cpu_on_cuda_matches_cpu():
    """Tor at chip_smoke's knobs, relays on the virtual CPU (the fused
    per-kind table), on the card equals the CPU run."""
    _need_card()
    cpu = _config_on_both(chip_smoke.tor_config((2, 10, 2)),
                          chip_smoke.TOR_KW, stop_s=5)
    assert cpu["hosts.app.relayed_bytes"].sum() > 0


def test_bitcoin_on_cuda_matches_cpu():
    """Bitcoin (tests/test_tor_bitcoin.py's 8 nodes, 3 blocks, seed 9,
    capacity 512) on the card equals the CPU run; every node ends at
    block 3."""
    _need_card()
    cpu = _config_on_both(tcp_harness.btc_config(blocks=3),
                          dict(seed=9, n_sockets=16, capacity=512))
    assert cpu["hosts.app.best"][:8].tolist() == [3] * 8


def test_mixed_on_cuda_matches_cpu():
    """TGen beside PHOLD through FusedModel (chip_smoke's mixed config at
    2 pairs and 8 peers, bucketed to 16 hosts) on the card equals the
    CPU run, which tests/test_torch_multimodel.py holds against the JAX
    reference."""
    _need_card()
    cpu = _config_on_both(chip_smoke.mixed_config(2, 8, 5), dict(
        seed=chip_smoke.TGEN_SEED, n_sockets=chip_smoke.TGEN_SOCKETS,
        capacity=chip_smoke.TGEN_CAPACITY))
    assert cpu["hosts.app.subs.0.streams_done"].sum() > 0
    assert cpu["hosts.app.subs.1.n_recv"].sum() > 0


def test_frontier_on_cuda_matches_cpu():
    """TGen on the frontier drain (3 pairs, frontier=16) on the card
    equals the CPU run, which tests/test_torch_frontier.py holds against
    the JAX reference."""
    _need_card()
    cpu = _config_on_both(
        chip_smoke.tgen_config(3).replace(
            f'stoptime="{chip_smoke.TGEN_STOP_S}"', 'stoptime="6"'),
        dict(seed=chip_smoke.TGEN_SEED, n_sockets=chip_smoke.TGEN_SOCKETS,
             capacity=chip_smoke.TGEN_CAPACITY,
             frontier=chip_smoke.TGEN_FRONTIER))
    assert cpu["hosts.app.streams_done"].sum() > 0


def _spill_run(dev, record=None):
    """tests/test_torch_pressure.py's skewed PHOLD (16 hosts, capacity 8,
    a 32-slot ring) through run_with_spill on `dev`: (leaves, controller).
    `record(args, in_refill)` sees every merge call's inputs."""
    from shadow_tpu_torch.core import events
    from shadow_tpu_torch.runtime import pressure

    eng, init = phold.build(16, capacity=8, spill=32, batched=True,
                            device=dev, hot_hosts=4, hot_weight=0.6,
                            msgs_per_host=2)
    ctrl = pressure.PressureController(16, 8, eng.cfg.lookahead,
                                       n_args=phold.N_PHOLD_ARGS)
    kernel, push, in_refill = events.merge.fused_merge, ctrl._push, []

    def fused(*args):
        record(args, bool(in_refill))
        return kernel(*args)

    def refill(*a, **k):
        in_refill.append(True)
        try:
            return push(*a, **k)
        finally:
            in_refill.pop()

    if record is not None:
        events.merge.fused_merge, ctrl._push = fused, refill
    try:
        st = pressure.run_with_spill(eng, init(), 400 * chip_smoke.MS, ctrl)
    finally:
        events.merge.fused_merge, ctrl._push = kernel, push
    return convert.engine_state_to_numpy(st), ctrl


def test_spill_on_cuda_matches_cpu():
    """The spill ring and the reservoir on the card equal the CPU run
    (held against the JAX reference on the CPU), ring leaves whole; the
    kernel equals its plain version on the run's full-width admission
    rounds and refill pushes."""
    _need_card()
    seen = {"loop": [], "refill": []}

    def record(args, in_refill):
        w = args[5].shape[1]
        label = "refill" if in_refill else "loop" if w == 8 else None
        if label:
            seen[label].append(tuple(a.clone() for a in args))

    before = merge.launches
    cuda, cc = _spill_run("cuda", record)
    assert merge.launches - before >= int(cuda["stats.n_sweeps"]) > 0
    cpu, ck = _spill_run("cpu")
    assert cuda.keys() == cpu.keys()
    for key, a in cpu.items():
        np.testing.assert_array_equal(cuda[key], a, err_msg=key)
    assert [sorted(h) for h in cc._heaps] == [sorted(h) for h in ck._heaps]
    assert cpu["queues.spill.n_spilled"].sum() > 0 and ck.n_refilled.sum()
    for label, calls in seen.items():
        assert calls, f"no {label} merge call captured"
        for args in calls:
            got = merge.fused_merge(*args)
            want = merge.merge_body(*args)
            assert all(torch.equal(a, b) for a, b in zip(got, want)), label


# name: (config, build_simulation keywords): tests/test_torch_pressure.py's
# build_simulation spill runs, whose queues overflow into the ring
SPILL_CONFIGS = {
    "phold_udp": (examples.phold_example(16, 12, stoptime=2),
                  dict(seed=4, capacity=12, overflow="spill")),
    "tgen_tcp": (chip_smoke.tgen_config(3).replace(
        f'stoptime="{chip_smoke.TGEN_STOP_S}"', 'stoptime="6"'),
        dict(seed=chip_smoke.TGEN_SEED, n_sockets=chip_smoke.TGEN_SOCKETS,
             capacity=16, overflow="spill")),
}


@pytest.mark.parametrize("name", list(SPILL_CONFIGS))
def test_simulation_spill_on_cuda_matches_cpu(name):
    """overflow="spill" through build_simulation and Simulation.run's
    window-stepped loop, the ring holding packet payloads, on the card
    equals the CPU run, reservoir included, and loses nothing."""
    _need_card()
    from shadow_tpu_torch import config, sim

    text, kw = SPILL_CONFIGS[name]
    states, heaps = {}, {}
    for dev in ("cuda", "cpu"):
        s = sim.build_simulation(config.parse_config(text), device=dev, **kw)
        before = merge.launches
        states[dev] = convert.engine_state_to_numpy(s.run())
        heaps[dev] = [sorted(h) for h in s.pressure._heaps]
        if dev == "cuda":
            assert merge.launches - before >= int(
                states[dev]["stats.n_sweeps"]) > 0
        assert s.pressure.n_overdue == 0 and s.pressure.n_refilled.sum() > 0
    assert states["cuda"].keys() == states["cpu"].keys()
    for key, a in states["cpu"].items():
        np.testing.assert_array_equal(states["cuda"][key], a, err_msg=key)
    assert heaps["cuda"] == heaps["cpu"]
    cpu = states["cpu"]
    assert cpu["queues.spill.pay"].shape[-1] > 1
    assert cpu["queues.spill.n_spilled"].sum() > 0
    assert cpu["queues.spill.n_lost"].sum() == 0
    assert cpu["queues.drops"].sum() == 0


# name: (harness, keywords, stop s): tests/test_torch_tcp.py's lossy
# scenarios and tests/test_torch_tcp_matrix.py's lossy cells and SACK run
TCP_LOSS = {
    "bulk_lossy": (tcp_harness.build_pair,
                   dict(total=50_000, reliability=0.85, seed=11), 20),
    "heavy_loss": (tcp_harness.build_pair,
                   dict(total=100, reply=5000, reliability=0.7,
                        close_after_send=False, seed=1), 120),
    "lossy_reno": (tcp_harness.build_stream,
                   dict(total=60_000, reliability=0.85, cc="reno", seed=3),
                   60),
    "lossy_aimd": (tcp_harness.build_stream,
                   dict(total=60_000, reliability=0.85, cc="aimd", seed=3),
                   60),
    "sack": (tcp_harness.build_stream,
             dict(total=120_000, reliability=0.85, seed=5), 60),
}
# the states compared on the way, while segments are out of order
TCP_STOPS_S = (0.25, 1, 2, 4)


def _tcp_runs(build, kw, stops_ns, edit=None):
    """{device: [leaves at each stop]}, through the kernel on the card;
    `edit(state, put)` changes the state after the first stop."""
    runs = {}
    for dev in ("cuda", "cpu"):
        eng, st = build(device=dev, **kw)
        before = merge.launches
        runs[dev] = []
        for i, stop in enumerate(stops_ns):
            st = eng.run(st, stop)
            runs[dev].append(convert.engine_state_to_numpy(st))
            if i == 0 and edit is not None:
                st = edit(st)
        if dev == "cuda":
            assert merge.launches - before >= int(
                runs[dev][-1]["stats.n_sweeps"]) > 0
    for got, want in zip(runs["cuda"], runs["cpu"]):
        assert got.keys() == want.keys()
        for key, a in want.items():
            np.testing.assert_array_equal(got[key], a, err_msg=key)
    return runs["cpu"]


@pytest.mark.parametrize("name", list(TCP_LOSS))
def test_tcp_loss_paths_on_cuda_match_cpu(name):
    """TCP's loss paths on the card (fast retransmit, RTO, SACK, and the
    out-of-order bitmaps held as u64 bits in int64) equal the CPU run,
    which tests/test_torch_tcp.py and tests/test_torch_tcp_matrix.py hold
    against the JAX reference: every leaf, at stops taken while segments
    are out of order and at the end."""
    _need_card()
    build, kw, stop_s = TCP_LOSS[name]
    stops = [int(s * chip_smoke.SECOND) for s in TCP_STOPS_S + (stop_s,)]
    cpu = _tcp_runs(build, kw, stops)
    assert cpu[-1]["hosts.net.tcb.n_retx"].sum() > 0
    assert any(r["hosts.net.tcb.ooo"].any() for r in cpu)


def test_tcp_rst_on_cuda_matches_cpu():
    """TCP(rst_on_unmatched=True) on the card equals the CPU run: the
    server loses its connection with data in flight, and the RST the
    client draws closes it."""
    _need_card()
    ms = chip_smoke.SECOND // 1000
    cpu = _tcp_runs(
        tcp_harness.build_pair, dict(rst_on_unmatched=True),
        [50 * ms, 2 * chip_smoke.SECOND],
        edit=lambda st: tcp_harness.forget_socket(
            st, 1, 1, tcp_harness.put_torch))
    assert cpu[-1]["hosts.net.tcb.state"][0, 0] == tcp_harness.ttcp.CLOSED


def test_plan_layout_agrees_with_the_kernel():
    """The Python plan sizes shared memory with the kernel's own formula,
    and the launcher refuses a plan that gives it less."""
    _need_card()
    lib = merge._load()
    for h, hc, w, _, _ in chip_smoke.SWEEP + chip_smoke.TIMING:
        assert lib.shadow_merge_row_smem_bytes(hc, w) == \
            merge.row_smem_bytes(hc, w)
    rng = np.random.default_rng(7)
    args = [torch.from_numpy(a).cuda()
            for a in chip_smoke.merge_inputs(rng, 64, 64, 24, 1, "cleared")]
    plan = merge.launch_plan(64, 64, 24)
    short = dataclasses.replace(plan, smem_bytes=plan.smem_bytes - 16)
    with pytest.raises(RuntimeError, match="launch failed"):
        merge.launch(args, short)


@pytest.mark.parametrize("warps", chip_smoke.WARPS_PER_BLOCK_SWEEP)
@pytest.mark.parametrize("h,hc,w,nw,regime", chip_smoke.RAGGED)
def test_kernel_matches_plain_on_every_grid(h, hc, w, nw, regime, warps):
    """Every grid chip_smoke times gives the plain version's output,
    ragged last blocks included."""
    _need_card()
    rng = np.random.default_rng(h + hc + w + nw + 1)
    args = [torch.from_numpy(a).cuda()
            for a in chip_smoke.merge_inputs(rng, h, hc, w, nw, regime)]
    plan = merge.launch_plan(h, hc, w, warps_per_block=warps)
    got = merge.launch(args, plan)
    want = merge.merge_body(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# name: (config text, build_simulation keywords): phase 16's schedule at a
# small width on both TGen drains, and Tor under relay churn
FAULT_CONFIGS = {
    "tgen_chained": (chip_smoke.tgen_faults_config(32), dict(
        seed=chip_smoke.TGEN_SEED, n_sockets=chip_smoke.TGEN_SOCKETS,
        capacity=chip_smoke.TGEN_CAPACITY)),
    "tgen_frontier": (chip_smoke.tgen_faults_config(32), dict(
        seed=chip_smoke.TGEN_SEED, n_sockets=chip_smoke.TGEN_SOCKETS,
        capacity=chip_smoke.TGEN_CAPACITY,
        frontier=chip_smoke.TGEN_FRONTIER)),
    "tor_churn": (examples.tor_churn_example(**tcp_harness.TOR_CHURN),
                  tcp_harness.TOR_CHURN_KW),
}


@pytest.mark.parametrize("name", list(FAULT_CONFIGS))
def test_faults_on_cuda_match_cpu(name):
    """A fault schedule on the card (quarantine in the drain, the link
    overlay and the arrival-liveness check in the routing, the epoch
    wipes and NIC rescales between windows) equals the CPU run, which
    tests/test_torch_faults_tcp.py and tests/test_torch_faults_churn.py
    hold against the JAX reference."""
    _need_card()
    cpu = _config_on_both(*FAULT_CONFIGS[name])
    assert cpu["stats.n_fault_dropped"].sum() > 0
    assert cpu["stats.n_quarantined"].sum() > 0
    assert cpu["hosts.app.streams_done"].sum() > 0
    assert int(cpu["fault_epoch"]) > 0


def test_phold_crash_on_cuda_matches_cpu():
    """The batched drain's quarantine (and the epoch wipe) on the card:
    PHOLD at 32 hosts with tests/test_torch_faults.py's crash schedule
    equals the CPU run."""
    _need_card()
    from shadow_tpu_torch.core import engine
    from shadow_tpu_torch.faults import FaultSpec, compile_faults

    specs = [FaultSpec(type="crash", hosts="h1 h2", start=0.15, end=0.48),
             FaultSpec(type="churn", hosts="h1*", start=0.06, end=0.84,
                       period=0.24, downtime=0.09, frac=0.5),
             FaultSpec(type="loss", src="h2*", dst="*", loss=0.5,
                       start=0.1, end=0.6)]
    states = {}
    for dev in ("cuda", "cpu"):
        e0, init = phold.build(32, batched=True, msgs_per_host=4, seed=3,
                               device=dev)
        st = init()
        f = compile_faults(specs, [f"h{i}" for i in range(32)], 32, 3,
                           device=dev)
        eng = engine.Engine(e0.cfg, e0.handlers, e0.network,
                            batch_handler=e0.batch_handler, faults=f,
                            fault_reset=st.hosts, device=dev)
        before = merge.launches
        states[dev] = convert.engine_state_to_numpy(
            eng.run(st, chip_smoke.SECOND))
        if dev == "cuda":
            assert merge.launches - before >= int(
                states[dev]["stats.n_sweeps"]) > 0
    for key, a in states["cpu"].items():
        np.testing.assert_array_equal(states["cuda"][key], a, err_msg=key)
    assert states["cpu"]["stats.n_quarantined"].sum() > 0
    assert states["cpu"]["stats.n_fault_dropped"].sum() > 0


def test_cbrt_kernel_matches_plain():
    """The cube-root kernel equals its plain version bit for bit on three
    spans of CUBIC's domain (the subnormals, around 1.0, up to 2560), on
    edge inputs outside it, on the CPU's plain version too, and counts
    one launch per call."""
    _need_card()
    from shadow_tpu_torch.transport import cbrt

    i32 = torch.int32
    end = chip_smoke.CBRT_DOMAIN_END
    for start in (0, 0x3F800000 - (1 << 19), end - (1 << 20) + 1):
        x = torch.arange(start, start + (1 << 20), dtype=i32,
                         device="cuda").view(torch.float32)
        before = cbrt.launches
        got = cbrt.cbrt(x)
        want = cbrt.cbrt_plain(x)
        torch.cuda.synchronize()
        assert cbrt.launches == before + 1
        assert torch.equal(got.view(i32), want.view(i32))
        assert torch.equal(got.cpu().view(i32),
                           cbrt.cbrt(x.cpu()).view(i32))
    pos = torch.tensor(chip_smoke.CBRT_EDGES, dtype=torch.int64)
    bits = torch.cat([pos, pos | 0x80000000])
    x = (bits - ((bits >> 31) << 32)).to(i32).view(torch.float32)
    got = cbrt.cbrt(x.cuda()).cpu().view(i32)
    assert torch.equal(got, cbrt.cbrt(x).view(i32))
    with pytest.raises(TypeError):
        cbrt.cbrt(torch.zeros(4, dtype=torch.float64, device="cuda"))


def test_tgen_cubic_faults_on_cuda_matches_cpu():
    """Phase 17(c)'s config at 32 pairs (TGen under every fault type with
    CUBIC) on the card equals the CPU run, which
    tests/test_torch_cubic.py holds against the JAX reference, and takes
    the cube root through the kernel."""
    _need_card()
    from shadow_tpu_torch.transport import cbrt

    before = cbrt.launches
    cpu = _config_on_both(chip_smoke.tgen_faults_config(32), dict(
        seed=chip_smoke.TGEN_SEED, n_sockets=chip_smoke.TGEN_SOCKETS,
        capacity=chip_smoke.TGEN_CAPACITY, tcp_cc="cubic"))
    assert cbrt.launches > before
    assert (cpu["hosts.net.tcb.cc_wmax"] > cpu["hosts.net.tcb.cwnd"]).any()
    assert cpu["hosts.net.tcb.n_retx"].sum() > 0


def _traced_run(name, dev):
    """(leaves, TraceDrain) of a traced, stats-on run on `dev`, drained at
    each of its stops: PHOLD on the batched drain, the jittered lossy
    graph on the chained drain, TGen under faults on the frontier drain,
    and the spilling PHOLD with the controller's records."""
    from shadow_tpu_torch import config, sim
    from shadow_tpu_torch.core import engine
    from shadow_tpu_torch.net import topology
    from shadow_tpu_torch.obs.trace import TraceDrain
    from shadow_tpu_torch.runtime import pressure

    sec = chip_smoke.SECOND
    if name == "frontier":
        s = sim.build_simulation(
            config.parse_config(chip_smoke.tgen_faults_config(4)),
            device=dev, seed=chip_smoke.TGEN_SEED,
            n_sockets=chip_smoke.TGEN_SOCKETS,
            capacity=chip_smoke.TGEN_CAPACITY, frontier=16, trace=256,
            stats=1)
        drain = TraceDrain(256)
        st = s.state0
        for stop in (5, 8):
            st = drain.drain_state(s.run(stop * sec, state=st))
        return convert.engine_state_to_numpy(st), drain
    if name == "spill":
        eng, init = phold.build(16, capacity=8, spill=32, batched=True,
                                device=dev, hot_hosts=4, hot_weight=0.6,
                                msgs_per_host=2, trace=64, stats=1)
        ctrl = pressure.PressureController(16, 8, eng.cfg.lookahead,
                                           n_args=phold.N_PHOLD_ARGS)
        drain = TraceDrain(64)
        ctrl.attach_trace(drain, len_arg=eng.cfg.trace_len_arg)
        st = pressure.run_with_spill(eng, init(), 400 * chip_smoke.MS, ctrl)
        return convert.engine_state_to_numpy(drain.drain_state(st)), drain
    if name == "batched":
        eng, init = phold.build(32, batched=True, device=dev,
                                msgs_per_host=4, seed=3, trace=64, stats=1)
        cap = 64
    else:
        eng, init = chip_smoke.phold_variant(
            phold, engine, topology, "jitter", dev, n_hosts=64, trace=128,
            stats=1)
        cap = 128
    drain = TraceDrain(cap)
    st = init()
    for stop in (sec // 2, sec):
        st = drain.drain_state(eng.run(st, stop))
    return convert.engine_state_to_numpy(st), drain


@pytest.mark.parametrize("name", ["batched", "chained", "frontier", "spill"])
def test_traced_on_cuda_matches_cpu(name):
    """Tracing and the stats plane on the card (the ring appends, the
    histogram updates, the frontier's per-round append, the
    controller's spill and refill rows) equal the CPU run, which
    tests/test_torch_trace.py and tests/test_torch_stats.py hold against
    the JAX reference: every leaf, the ring and the plane included, and
    every drained record."""
    _need_card()
    before = merge.launches
    (lc, dc), (lp, dp) = _traced_run(name, "cuda"), _traced_run(name, "cpu")
    assert merge.launches > before
    assert lc.keys() == lp.keys()
    for key, a in lp.items():
        np.testing.assert_array_equal(lc[key], a, err_msg=key)
    rc, rp = dc.records(), dp.records()
    for key, a in rp.items():
        np.testing.assert_array_equal(rc[key], a, err_msg=key)
    assert (dc.lost, dc.n_records) == (dp.lost, dp.n_records)
    assert dp.n_records > 0 and lp["splane.wait_n"].sum() > 0


# -- the command line on the card ---------------------------------------------
# name: (config text, flags): PHOLD over UDP under spill pressure; the
# same with a checkpoint each 0.5 sim-s, whose 1.5 s generation (the one
# resumed) holds 18 events parked in the reservoir; a smaller one under
# --overflow grow, which re-templates at doubled capacity twice and whose
# 1.25 s checkpoint parks 2 events; and TGen at 32 pairs with phase 19's
# flags. Each run's stop is a checkpoint time, so its newest generation is
# the end state
_PHOLD_FLAGS = ["--seed", "4", "--capacity", "12", "--heartbeat-frequency",
                "0.5", "--metrics", "--stats", "--checkpoint-interval", "1"]
CLI_CASES = {
    "phold": (examples.phold_example(16, 12, stoptime=2), _PHOLD_FLAGS),
    "phold_parked": (examples.phold_example(16, 12, stoptime=2),
                     _PHOLD_FLAGS[:-1] + ["0.5"]),
    "phold_grow": (examples.phold_example(16, 8, stoptime=1.5),
                   ["--seed", "4", "--capacity", "6", "--heartbeat-frequency",
                    "0.5", "--metrics", "--stats", "--overflow", "grow",
                    "--checkpoint-interval", "0.25"]),
    "tgen32": (chip_smoke.tgen_config(32), chip_smoke.CLI_ARGV[1:]),
}


def _cli_run(dev, text, flags, workdir, extra=()):
    """`cli.main` on `dev` in `workdir`: phase 19's pin fields."""
    import contextlib
    import io
    import os

    from shadow_tpu_torch import cli

    workdir.mkdir(exist_ok=True)
    (workdir / "cfg.xml").write_text(text)
    out, cwd = io.StringIO(), os.getcwd()
    os.chdir(workdir)
    try:
        with contextlib.redirect_stdout(out):
            rc = cli.main(["cfg.xml", *flags, "--checkpoint-keep", "2",
                           "--checkpoint-path", chip_smoke.CLI_CKPT,
                           *extra], device=dev)
    finally:
        os.chdir(cwd)
    assert rc == 0
    return chip_smoke.cli_pin_fields(out.getvalue(), workdir)


@pytest.mark.parametrize("name", list(CLI_CASES))
def test_cli_on_cuda_matches_cpu(name, tmp_path):
    """The command line on the card prints the CPU run's heartbeat log
    and summary and writes its checkpoints, through the kernel; the card
    resumes the CPU's mid-run checkpoint to the same final state."""
    import shutil

    _need_card()
    text, flags = CLI_CASES[name]
    before = merge.launches
    card = _cli_run("cuda", text, flags, tmp_path / "cuda")
    assert merge.launches > before
    cpu = _cli_run("cpu", text, flags, tmp_path / "cpu")
    assert card == cpu
    (tmp_path / "resume").mkdir()
    shutil.copy(tmp_path / "cpu" / chip_smoke.CLI_MID_CKPT,
                tmp_path / "resume" / chip_smoke.CLI_CKPT)
    if name in ("phold_parked", "phold_grow"):
        # the mid-run checkpoint carries events parked in the reservoir
        from shadow_tpu_torch.utils.checkpoint import read_extra

        extras = read_extra(str(tmp_path / "resume" / chip_smoke.CLI_CKPT))
        assert extras["reservoir_time"].size > 0
    if name == "phold_grow":
        # its checkpoints come after a re-template: their queues are wider
        # than the --capacity template a resume builds, which either
        # package refuses, so the card is held to the CPU's run alone
        assert cpu["summary"]["capacity"] == 24
        return
    resumed = _cli_run("cuda", text, flags, tmp_path / "resume",
                       ["--resume", "auto"])
    assert resumed["final_digest"] == cpu["final_digest"]
    assert resumed["summary"] == cpu["summary"]


# name: (config text, flags) of phase 20's pin fields: TGen at 32 pairs
# with phase 20's flags (capture on every host, --window auto, --xprof),
# and PHOLD over UDP capturing tx and rx records under a fixed --window
PCAP_CASES = {
    "tgen32": (chip_smoke.pcap_config(32), chip_smoke.PCAP_ARGV[1:]),
    "phold": (examples.phold_example(16, 2, stoptime=2).replace(
        '<host id="peer"',
        f'<host id="peer" logpcap="true" pcapdir="{chip_smoke.PCAP_DIR}"'),
        ["--seed", "6", "--heartbeat-frequency", "0.5", "--overflow",
         "strict", "--window", "100", "--xprof", "0.5:1", "--xprof-dir",
         chip_smoke.XPROF_DIR, "--checkpoint-interval", "2",
         "--checkpoint-path", chip_smoke.PCAP_CKPT]),
}


def _pcap_run(dev, text, flags, workdir):
    """`cli.main` on `dev` in `workdir`: phase 20's pin fields."""
    import contextlib
    import io
    import os

    from shadow_tpu_torch import cli

    workdir.mkdir(exist_ok=True)
    (workdir / "cfg.xml").write_text(text)
    out, err, cwd = io.StringIO(), io.StringIO(), os.getcwd()
    os.chdir(workdir)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main(["cfg.xml", *flags], device=dev)
    finally:
        os.chdir(cwd)
    assert rc == 0, err.getvalue()[-2000:]
    return chip_smoke.pcap_pin_fields(out.getvalue(), err.getvalue(),
                                      workdir)


@pytest.mark.parametrize("name", list(PCAP_CASES))
def test_cli_capture_and_windows_on_cuda_match_cpu(name, tmp_path):
    """Packet capture, per-window widths and the device profile through
    the command line: the card prints the CPU's log and summary (windows
    included), writes its pcap files byte for byte and ends in its
    state; the card's xprof trace holds CUDA kernels."""
    import json

    _need_card()
    text, flags = PCAP_CASES[name]
    before = merge.launches
    card = _pcap_run("cuda", text, flags, tmp_path / "cuda")
    assert merge.launches > before
    cpu = _pcap_run("cpu", text, flags, tmp_path / "cpu")
    assert card == cpu
    assert card["pcap_files"] > 0 and card["summary"]["packet_stages"]
    doc = json.loads((tmp_path / "cuda" / chip_smoke.XPROF_DIR
                      / "trace.json").read_text())
    assert any(e.get("cat") == "kernel" for e in doc["traceEvents"])


def test_retry_on_cuda_resumes_to_the_uninterrupted_state(tmp_path,
                                                          monkeypatch):
    """`--retry` on the card: the first child dies by SIGKILL after its
    first checkpoint, the relaunch resumes from it and ends in the state
    of an uninterrupted card run."""
    import contextlib
    import functools
    import io
    import os

    from shadow_tpu_torch import cli
    from shadow_tpu_torch.runtime import supervisor
    from torch_retry_harness import child_popen

    _need_card()
    text = examples.phold_example(16, 3, stoptime=3)
    argv = ["cfg.xml", "--seed", "2", "--heartbeat-frequency", "0.5",
            "--checkpoint-interval", "1", "--checkpoint-path", "r.ckpt.npz"]
    monkeypatch.setattr(supervisor, "run_with_retry", functools.partial(
        supervisor.run_with_retry, _popen=child_popen("cuda"),
        _sleep=lambda s: None))
    cwd, logs = os.getcwd(), {}
    for label, extra in (("straight", []), ("retry", ["--retry", "2"])):
        d = tmp_path / label
        d.mkdir()
        (d / "cfg.xml").write_text(text)
        err = io.TextIOWrapper(io.BytesIO(), encoding="utf-8",
                               write_through=True)
        os.chdir(d)
        try:
            with contextlib.redirect_stdout(io.StringIO()), \
                    contextlib.redirect_stderr(err):
                assert cli.main(argv + extra, device="cuda") == 0
        finally:
            os.chdir(cwd)
        logs[label] = err.buffer.getvalue().decode()
    assert '"exit_history": [-9, 0]' in logs["retry"]
    assert "resumed from r.ckpt.npz at sim time 1.000s" in logs["retry"]
    assert chip_smoke.checkpoint_digest(tmp_path / "retry" / "r.ckpt.npz") \
        == chip_smoke.checkpoint_digest(tmp_path / "straight" / "r.ckpt.npz")


# -- sharding (parallel.mesh): ranks on the card -----------------------------
SHARD_TEXT = chip_smoke.tgen_config(16).replace(
    f'stoptime="{chip_smoke.TGEN_STOP_S}"', 'stoptime="6"')
SHARD_KW = dict(seed=chip_smoke.TGEN_SEED, n_sockets=chip_smoke.TGEN_SOCKETS,
                capacity=chip_smoke.TGEN_CAPACITY)
MESH_SHAPED = ("xchg.bucket.time", "xchg.bucket.dst", "xchg.bucket.src",
               "xchg.bucket.seq", "xchg.bucket.kind", "xchg.bucket.args",
               "xchg.sent_min", "stats.n_inner_steps",
               "stats.n_xchg_rounds", "stats.n_cross_shard")


def _spawn(fn, n, backend, device, *args):
    import torch_shard_harness as harness

    from shadow_tpu_torch.parallel import mesh as pmesh

    return pmesh.spawn(fn, n, backend=backend, device=device, args=args,
                       timeout_s=harness.SPAWN_TIMEOUT_S)


def _equal(a: dict, b: dict, skip=()):
    assert {k for k in a if k not in skip} == {k for k in b if k not in skip}
    for key in a:
        if key not in skip:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_two_ranks_on_one_card_over_gloo_match_cpu():
    """Two ranks sharing the card (gloo, host-staged collectives) end in
    the CPU's two-rank state, leaf for leaf; every pair crosses shards."""
    import torch_shard_harness as harness

    _need_card()
    got = {dev: _spawn(harness.sim_rank, 2, "gloo", dev, 2, SHARD_TEXT,
                       SHARD_KW, (), 1, 4 * chip_smoke.SECOND, dev)[0]
           for dev in ("cuda", "cpu")}
    _equal(got["cuda"], got["cpu"])
    assert got["cpu"]["stats.n_cross_shard"] > 0


def test_mesh1_over_nccl_matches_unsharded():
    """One rank over NCCL equals the unsharded run on the card outside
    the mesh-shaped leaves."""
    import torch_shard_harness as harness
    from shadow_tpu_torch import config, sim

    _need_card()
    stop = 4 * chip_smoke.SECOND
    mesh1 = _spawn(harness.sim_rank, 1, "nccl", "cuda", 1, SHARD_TEXT,
                   SHARD_KW, (), 1, stop, "cuda")[0]
    s = sim.build_simulation(config.parse_config(SHARD_TEXT), device="cuda",
                             **SHARD_KW)
    plain = convert.engine_state_to_numpy(s.run(stop))
    _equal(mesh1, plain, skip=MESH_SHAPED)
    assert mesh1["xchg.sent_min"].shape == (1,)


def test_shard_set_written_on_card_resumes_on_cpu(tmp_path):
    """A shard set written by two ranks on the card resumes unsharded on
    the CPU to the state of an unsharded CPU run with the same stops."""
    import torch_shard_harness as harness
    from shadow_tpu_torch import config, sim
    from shadow_tpu_torch.utils import checkpoint

    _need_card()
    t1, t2 = 4 * chip_smoke.SECOND, 5 * chip_smoke.SECOND
    path = str(tmp_path / "set.ckpt.npz")
    _spawn(harness.resume_rank, 2, "gloo", "cuda", 2, SHARD_TEXT, SHARD_KW,
           None, (t1,), (path, True), -1, "cuda")
    found, _, skipped = checkpoint.find_resume_checkpoint(path)
    assert len(found) == 2 and not skipped
    s = sim.build_simulation(config.parse_config(SHARD_TEXT), device="cpu",
                             **SHARD_KW)
    st, _ = checkpoint.load_shard_set(found, s.state0)
    resumed = convert.engine_state_to_numpy(s.run(t2, state=st))
    straight = convert.engine_state_to_numpy(
        s.run(t2, state=s.run(t1)))
    _equal(resumed, straight, skip=MESH_SHAPED)


def test_fleet_on_cuda_matches_cpu():
    """A 3-lane TGen fleet under phase 22's faults and latency scales on
    the card equals the same fleet on the CPU, lane by lane; the merge
    launches once per merge round for the whole fleet, as often per
    round as lane 0's solo run does (one launch per round)."""
    _need_card()
    from shadow_tpu_torch import config as tconfig
    from shadow_tpu_torch import sim as tsim
    from shadow_tpu_torch.core import events as tevents
    from shadow_tpu_torch.faults import parse_fault_dsl

    text = chip_smoke.tgen_config(6)
    specs = tuple(parse_fault_dsl(s)
                  for s in chip_smoke.FLEET_FAULTS.split(";"))
    faults = (None, specs, specs)
    plan = dict(seeds=(1, 2, 3), faults=faults,
                latency_scale=(1.0, 1.5, 2.0))
    leaves, counts = {}, {}
    for dev in ("cuda", "cpu"):
        sim = tsim.build_simulation(tconfig.parse_config(text), device=dev,
                                    **chip_smoke.FLEET_BUILD_KW)
        fleet = sim.build_fleet(3, **plan)
        for label, run in (("fleet", fleet.run), ("solo", sim.run)):
            calls = [0]
            fused = tevents.merge.fused_merge

            def count(*args):
                calls[0] += 1
                return fused(*args)

            tevents.merge.fused_merge = count
            before = merge.launches
            try:
                st = run(chip_smoke.FLEET_STOP_NS)
                torch.cuda.synchronize()
            finally:
                tevents.merge.fused_merge = fused
            counts[dev, label] = (calls[0], merge.launches - before)
            if label == "fleet":
                leaves[dev] = convert.fleet_state_to_numpy(st)
    for key in leaves["cpu"]:
        np.testing.assert_array_equal(leaves["cuda"][key], leaves["cpu"][key],
                                      err_msg=key)
    for label in ("fleet", "solo"):
        rounds, launches = counts["cuda", label]
        assert launches == rounds > 0, label
        assert counts["cpu", label] == (rounds, 0), label


def test_served_on_cuda_matches_cpu():
    """Two TGen requests (6 pairs) served by `SimService` on the card
    equal the same requests served on the CPU, record for record (wall
    time aside)."""
    _need_card()
    import time

    from shadow_tpu_torch.serve import SimService

    docs = [{"model": "tgen", "params": {"n_pairs": 6, "capacity": 128},
             "seed": s, "stop_s": 4.0, "latency_scale": lat}
            for s, lat in ((1, 1.0), (2, 1.5))]
    got = {}
    for dev in ("cuda", "cpu"):
        svc = SimService(max_lanes=2, pack_deadline_ms=100.0,
                         beat_windows=8, device=dev).start()
        try:
            rids = [svc.submit(d)["request_id"] for d in docs]
            deadline = time.monotonic() + 600
            while not all(svc.result(r)["status"] in ("done", "error")
                          for r in rids):
                assert time.monotonic() < deadline, "requests pending"
                time.sleep(0.05)
            recs = [svc.result(r) for r in rids]
        finally:
            svc.drain()
        got[dev] = [{k: v for k, v in r.items() if k != "wall_ms"}
                    for r in recs]
    assert got["cuda"] == got["cpu"]
    assert all(r["status"] == "done" for r in got["cuda"])


def test_proc_tier_on_cuda_matches_cpu():
    """The real-binary tier on the card (two echo pairs, two clock
    hosts, one of them with a second clock stopped at 2 s) equals its
    CPU run, which the CPU tests hold against the reference: exit codes,
    log triples, the plugins' stdout and every final-state leaf, with
    the merge launched inside the tier's injections."""
    _need_card()
    import shutil

    from shadow_tpu_torch.config import parse_config
    from shadow_tpu_torch.proc import ProcessTier

    if shutil.which("gcc") is None:
        pytest.skip("no C toolchain")
    plugins = chip_smoke.proc_plugins()

    def host(name, procs):
        return f'<host id="{name}">' + "".join(
            f'<process plugin="{p}" starttime="{start}"{stop} '
            f'arguments="{args}"/>' for p, start, stop, args in procs
        ) + "</host>"

    hosts = [host("clock0", [("clock", 1, "", "200 10")]),
             host("clock1", [("clock", 1, "", "200 10"),
                             ("clock", 1, ' stoptime="2"', "200 10")])]
    for i, n in enumerate((20_000, 9_000)):
        hosts += [host(f"esrv{i}", [("echo", 1, "", f"server 8888 {n}")]),
                  host(f"ecli{i}", [("echo", 2, "",
                                     f"client esrv{i} 8888 {n}")])]
    text = (f'<shadow stoptime="10"><topology><![CDATA['
            f'{chip_smoke.PROC_TOPO}]]></topology>'
            + "".join(f'<plugin id="{k}" path="{plugins[k]}"/>'
                      for k in ("echo", "clock"))
            + "".join(hosts) + "</shadow>")
    runs = {}
    for dev in ("cuda", "cpu"):
        before = merge.launches

        def run():
            tier = ProcessTier(parse_config(text), device=dev, seed=4)
            try:
                with torch.inference_mode():
                    st = tier.run()
                    leaves = convert.engine_state_to_numpy(st)
            finally:
                tier.close()
            return tier, leaves

        (tier, leaves), stdout = chip_smoke._fd_capture(run, decode=False)
        runs[dev] = (dict(tier.exit_codes), list(tier.logs), stdout,
                     tier.lost_stream_bytes, tier.windows, leaves)
        if dev == "cuda":
            assert merge.launches - before >= tier.injections > 0
    card, cpu = runs["cuda"], runs["cpu"]
    assert set(card[0].values()) == {0}
    assert card[:5] == cpu[:5]
    assert card[5].keys() == cpu[5].keys()
    for key, a in cpu[5].items():
        np.testing.assert_array_equal(card[5][key], a, err_msg=key)
