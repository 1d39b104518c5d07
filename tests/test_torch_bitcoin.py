"""The Bitcoin scenarios of tests/test_torch_tor_bitcoin.py (which keeps
Tor, the tables and the helpers these share), in a file of their own so
that the two run on separate test workers: tests/test_tor_bitcoin.py's
Bitcoin scenario (seed 9, every node at block 3), a state round trip,
runs to the stop in one call and in 1 s chunks, the launching operations
of one inner step, and the slow pin of chip_smoke.py's phase 12.

Every comparison is exact, dtypes included.
"""

import pytest
import torch

import chip_smoke
import torch_tcp_harness as harness
from shadow_tpu_torch import convert
from test_torch_phold import assert_leaves_equal, jax_leaves
from test_torch_tcp import one_torch_thread  # noqa: F401 (autouse)
from test_torch_tor_bitcoin import (
    BTC_LAUNCHES_PER_STEP,
    SCENARIOS,
    SECOND,
    build_both,
    built,
    launches_per_step,
    scenario,
)


def test_bitcoin_blocks_match_reference():
    """Every real node ends at block 3, the pad rows at 0; the block
    bodies crossed the TCP links; non-miners adopt after the miner."""
    lj, lt, ts = scenario("btc-seed9")
    assert_leaves_equal(lj, lt)
    n = len(ts.names)
    best = lt["hosts.app.best"]
    assert best[:n].tolist() == [3] * 8 and not best[n:].any()
    assert lt["hosts.app.dl_rx"][:n].sum() >= 7 * 3 * 256 * 1024
    t_best = lt["hosts.app.t_best"]
    assert (t_best[1:n] > t_best[0]).all()
    assert lt["hosts.net.sockets.rx_bytes"][:n, 0].sum() > 0  # UDP control


def test_bitcoin_state_round_trips():
    """BtcApp's leaves, the bool `is_node` among them, go JAX -> numpy ->
    port -> numpy with their dtypes."""
    js, ts = built("btc-seed9")
    lj = jax_leaves(js.state0)
    st = convert.engine_state_from_numpy(lj, "cpu", hosts=ts.state0.hosts)
    assert st.hosts.app.is_node.dtype == torch.bool
    assert_leaves_equal(lj, convert.engine_state_to_numpy(st))


# Bitcoin at one block every 5 s, to 20 s: in one call, and in 1 s chunks
SCENARIOS["btc-chunked"] = (lambda: harness.btc_config(6, 2, "64KiB", 5),
                            dict(seed=9, n_sockets=16, capacity=512))


@pytest.mark.parametrize("chunk_s", [None, 1], ids=["one-call", "1s-chunks"])
def test_bitcoin_chunked_runs_match_reference(chunk_s):
    """Where a run stops moves the reference's trajectory (window
    boundaries land at the stops); the port follows it either way."""
    js, ts = built("btc-chunked")
    stop = js.stop_ns
    if chunk_s is None:
        lj, lt = jax_leaves(js.run()), convert.engine_state_to_numpy(ts.run())
    else:
        sj, st = None, None
        for k in range(chunk_s, stop // SECOND + 1, chunk_s):
            sj = js.run(k * SECOND, state=sj)
            st = ts.run(k * SECOND, state=st)
        lj, lt = jax_leaves(sj), convert.engine_state_to_numpy(st)
    assert_leaves_equal(lj, lt)
    n = len(ts.names)
    assert lt["hosts.app.best"][:n].tolist() == [2] * n



def test_bitcoin_launches_per_inner_step():
    """One Bitcoin inner step (chip_smoke's Bitcoin knobs at 16 nodes)
    stays under BTC_LAUNCHES_PER_STEP: 250 ms of block traffic after
    the first block is mined."""
    steps, per_step, count = launches_per_step(
        chip_smoke.btc_config(16), chip_smoke.BTC_KW, 31.0, 31.25)
    print(f"Bitcoin: {steps} inner steps, {per_step:.0f} launching torch "
          f"operations per step; top: {count.ops.most_common(8)}")
    assert steps >= 10
    assert per_step < BTC_LAUNCHES_PER_STEP



@pytest.mark.slow
def test_bitcoin_parity_and_pins():
    """Bitcoin at bench.py's 1,000 nodes to BTC_STOP_S in one call, in
    both packages on the CPU: equal leaves and the pins the card is held
    to."""
    js, ts = build_both(chip_smoke.btc_config(), **chip_smoke.BTC_KW)
    stop = int(chip_smoke.BTC_STOP_S * SECOND)
    lj = jax_leaves(js.run(stop))
    lt = convert.engine_state_to_numpy(ts.run(stop))
    assert_leaves_equal(lj, lt)
    assert chip_smoke.btc_pin(lj, len(ts.names)) == chip_smoke.PIN_BTC
