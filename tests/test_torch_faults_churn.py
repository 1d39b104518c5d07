"""Churn and mixed fault schedules at width in shadow_tpu_torch against
shadow_tpu, leaf for leaf.

- `churn_scenario` (bench.py's `tor_churn_worker` shape) at a small tier,
  4 relays per class, 20 clients and 4 servers, with the churn moved to
  3.5 s on a 3 s cycle so that a relay crashes and restarts inside a 6 s
  run; `tor_churn_example` is the reference's text;
- chip_smoke.py's phase 16 schedule (TGen under churn, a partition, a
  loss spike, latency inflation and throttled NICs) at 10 pairs with a
  spill ring (`overflow="spill"`, capacity 16, so that the ring fills),
  whose refill pushes run after the epoch wipes as in the reference;
- the schedule under a fused multi-model table (TGen beside PHOLD
  through `FusedModel`, whose host state is a tuple).

Every comparison is exact, dtypes included.
"""

import functools

import pytest

import chip_smoke
import torch_tcp_harness as tcp_harness
from shadow_tpu import config as jconfig
from shadow_tpu import examples as jexamples
from shadow_tpu import sim as jsim
from shadow_tpu.models import tor as jtor
from shadow_tpu_torch import config as tconfig
from shadow_tpu_torch import convert
from shadow_tpu_torch import examples as texamples
from shadow_tpu_torch import sim as tsim
from shadow_tpu_torch.models import tor as ttor
from test_torch_phold import assert_leaves_equal, jax_leaves
from test_torch_tcp import one_torch_thread  # noqa: F401 (autouse)

SECOND = 1_000_000_000

CHURN, CHURN_KW = tcp_harness.TOR_CHURN, tcp_harness.TOR_CHURN_KW


def test_tor_churn_matches_reference():
    assert texamples.tor_churn_example(**CHURN) == \
        jexamples.tor_churn_example(**CHURN)
    ts = tsim.build_simulation(ttor.churn_scenario(**CHURN), device="cpu",
                               **CHURN_KW)
    js = jsim.build_simulation(jtor.churn_scenario(**CHURN), **CHURN_KW)
    ts.strict_overflow = js.strict_overflow = False
    f = ts.faults
    assert f.has_crash and not f.has_link and not f.has_bw
    assert ts.stack.tcp.rst_on_unmatched
    # a relay goes down and comes back up inside the run
    flips = f.transitions_in(0, 6 * SECOND)
    assert any(not up for *_, up in flips) and any(up for *_, up in flips)
    relays = [i for i, nm in enumerate(ts.names)
              if nm.startswith(("guard", "middle", "exit"))]
    assert set(g for _t, g, _up in flips) <= set(relays)
    lt = convert.engine_state_to_numpy(ts.run())
    assert_leaves_equal(jax_leaves(js.run()), lt)
    assert lt["stats.n_fault_dropped"].sum() > 0
    assert lt["stats.n_quarantined"].sum() > 0
    assert lt["hosts.app.streams_done"].sum() > 0


TGEN_KW = dict(seed=chip_smoke.TGEN_SEED, n_sockets=chip_smoke.TGEN_SOCKETS,
               capacity=chip_smoke.TGEN_CAPACITY)
# name: (config text, build keywords)
WIDTH = {
    "spill": (chip_smoke.tgen_faults_config(10),
              dict(TGEN_KW, capacity=16, overflow="spill", spill_len=256)),
    "fused": (chip_smoke.mixed_config(10, 12, 6).replace(
        "</shadow>", chip_smoke.TGEN_FAULTS + "</shadow>"), TGEN_KW),
}


@functools.lru_cache(maxsize=None)
def width_run(name):
    text, kw = WIDTH[name]
    ts = tsim.build_simulation(tconfig.parse_config(text), device="cpu",
                               **kw)
    js = jsim.build_simulation(jconfig.parse_config(text), **kw)
    ts.strict_overflow = js.strict_overflow = False
    return jax_leaves(js.run()), convert.engine_state_to_numpy(ts.run()), ts


@pytest.mark.parametrize("name", list(WIDTH))
def test_fault_schedule_spill_and_fused_match_reference(name):
    lj, lt, ts = width_run(name)
    assert_leaves_equal(lj, lt)
    f = ts.faults
    assert f.has_crash and f.has_link and f.has_bw
    assert lt["stats.n_fault_dropped"].sum() > 0
    assert lt["stats.n_quarantined"].sum() > 0
    assert lt["hosts.net.tcb.n_retx"].sum() > 0
    if name == "spill":
        assert lt["queues.spill.n_spilled"].sum() > 0
        assert lt["queues.spill.n_lost"].sum() == 0
    else:
        assert isinstance(ts.state0.hosts.app.subs, tuple)
        assert lt["hosts.app.subs.1.n_recv"].sum() > 0  # PHOLD ran
