"""Several app models in one simulation (`sim.FusedModel`) in
shadow_tpu_torch against shadow_tpu, leaf for leaf.

- tests/test_multimodel.py's mixed config (a TGen pair beside four PHOLD
  peers, 6 hosts bucketed to 16): equal initial and final states, the
  handler table's kind names, max_emit and capacity, and the reference
  test's own assertions (both models ran, neither bled into the other's
  hosts); the same with a process stoptime on the PHOLD peers;
- its rejection of a host that mixes models, in both packages;
- `cpu_kind_cycles` of a fused Tor + PHOLD config equals the reference's
  and the sum of its parts', and so do the engines' CPU tables;
- a sub-model's receive leaves the rows it does not own untouched: every
  leaf of those rows, and their emits, are the owning model's.

With the slow tests also chip_smoke.py's phase 13 (TGen at 1,024 pairs
beside 2,048 PHOLD peers, 4096 hosts, 5 sim-s) in both packages,
against its pins.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import chip_smoke
from shadow_tpu import config as jconfig
from shadow_tpu import sim as jsim
from shadow_tpu_torch import config as tconfig
from shadow_tpu_torch import convert
from shadow_tpu_torch import sim as tsim
from shadow_tpu_torch.core import rng as trng
from shadow_tpu_torch.core.engine import _select_rows
from shadow_tpu_torch.host.sockets import PROTO_UDP
from shadow_tpu_torch.models.phold_net import PHOLD_PORT
from shadow_tpu_torch.transport import stack as tstack
from test_multimodel import MIXED
from test_torch_phold import assert_leaves_equal, jax_leaves
from test_torch_tcp import one_torch_thread  # noqa: F401 (autouse)

SECOND = 1_000_000_000
# the reference test runs to 30 s; the TGen pair is done by 5 s
STOP_S = 6
STOPTIME = MIXED.replace('arguments="load=3"/>',
                         'arguments="load=3" stoptime="4"/>')


@functools.lru_cache(maxsize=None)
def mixed_runs(text, seed=5):
    """(reference sim, its state0 and final leaves, port sim, its state0
    and final leaves) of one config run to STOP_S."""
    js = jsim.build_simulation(jconfig.parse_config(text), seed=seed)
    ts = tsim.build_simulation(tconfig.parse_config(text), seed=seed,
                               device="cpu")
    return (js, jax_leaves(js.state0), jax_leaves(js.run(STOP_S * SECOND)),
            ts, convert.engine_state_to_numpy(ts.state0),
            convert.engine_state_to_numpy(ts.run(STOP_S * SECOND)))


@pytest.mark.parametrize("text", [MIXED, STOPTIME], ids=["mixed",
                                                         "stoptime"])
def test_mixed_tgen_phold_matches_reference(text):
    js, j0, jf, ts, t0, tf = mixed_runs(text)
    assert ts.app.name == js.app.name == "tgen+phold"
    assert ts.kind_names == js.kind_names == (
        "pkt_arrive", "pkt_rx", "tcp_timer", "tcp_tx", "tgen.0", "phold.0")
    for knob in ("max_emit", "capacity", "lookahead", "burst"):
        assert getattr(ts.engine.cfg, knob) == getattr(js.engine.cfg, knob)
    assert_leaves_equal(j0, t0)
    assert_leaves_equal(jf, tf)
    # the reference test's own assertions, on the port's leaves
    n = len(ts.names)
    done = tf["hosts.app.subs.0.streams_done"]
    recv = tf["hosts.app.subs.1.n_recv"]
    assert done[1] == 2 and tf["hosts.app.subs.0.conn_rx"][1] >= 4096
    assert recv[2:].sum() > 50
    assert tf["hosts.app.model_id"][:n].tolist() == [0, 0, 1, 1, 1, 1]
    assert recv[:2].sum() == 0 and done[2:].sum() == 0
    if text is STOPTIME:
        # the stopped peers' handlers are muted past 4 s
        tf8 = mixed_runs(MIXED)[-1]
        assert recv[2:].sum() < tf8["hosts.app.subs.1.n_recv"][2:].sum()


def test_host_mixing_models_rejected():
    bad = MIXED.replace(
        '<process plugin="phold" starttime="1" arguments="load=3"/>',
        '<process plugin="phold" starttime="1" arguments="load=3"/>'
        '<process plugin="tgen" starttime="2" arguments="server port=1"/>',
        1,
    )
    with pytest.raises(ValueError, match="mixes app models"):
        jsim.build_simulation(jconfig.parse_config(bad), seed=0)
    with pytest.raises(ValueError, match="mixes app models"):
        tsim.build_simulation(tconfig.parse_config(bad), seed=0,
                              device="cpu")


def tor_phold_config() -> str:
    """A small Tor network (relays on a 3 GHz virtual CPU) beside four
    PHOLD peers, which also run on a virtual CPU."""
    peers = ('<plugin id="phold" path="shadow-plugin-test-phold"/>'
             '<host id="peer" quantity="4" cpufrequency="2000000">'
             '<process plugin="phold" starttime="1" arguments="load=2"/>'
             '</host>')
    return chip_smoke.tor_config((2, 3, 1)).replace(
        "</shadow>", peers + "</shadow>")


def test_cpu_kind_cycles_sum_the_parts():
    text = tor_phold_config()
    js = jsim.build_simulation(jconfig.parse_config(text), seed=1,
                               n_sockets=16)
    ts = tsim.build_simulation(tconfig.parse_config(text), seed=1,
                               n_sockets=16, device="cpu")
    assert isinstance(ts.app, tsim.FusedModel)
    nk = len(ts.kind_names)
    got = ts.app.cpu_kind_cycles(nk)
    np.testing.assert_array_equal(got, js.app.cpu_kind_cycles(nk))
    parts = [m.cpu_kind_cycles(nk) for _, m, _ in ts.app.parts
             if hasattr(m, "cpu_kind_cycles")]
    assert len(parts) == 1 and got.any()
    np.testing.assert_array_equal(got, sum(parts))
    np.testing.assert_array_equal(ts.engine.cpu_cost.numpy(),
                                  np.asarray(js.engine.cpu_cost))


def test_recv_leaves_unowned_rows_untouched():
    """A UDP datagram to the PHOLD port on every row: the fused receive
    gives each row its own model's result, every leaf of the host state
    and the emits included, and the PHOLD branch alone would have
    changed the TGen rows."""
    _, _, _, ts, _, _ = mixed_runs(MIXED)
    model = ts.app
    hs = ts.state0.hosts
    h = hs.app.model_id.shape[0]
    z32 = torch.zeros((h,), dtype=torch.int32)
    now = torch.full((h,), 2 * SECOND, dtype=torch.int64)
    udp = torch.full((h,), PROTO_UDP, dtype=torch.int32)
    pkt = tstack.Pkt(proto=udp, flags=udp, src_host=z32 + 2,
                     src_port=z32 + PHOLD_PORT, dst_port=z32 + PHOLD_PORT,
                     seq=z32, ack=z32, length=z32 + 1, wnd=z32, aux=z32,
                     sack=torch.zeros((h,), dtype=torch.int64), nseg=z32 + 1)
    slot = torch.zeros((h,), dtype=torch.int32)  # every row's socket 0
    keys = trng.event_keys(trng.root_key(3, "cpu"),
                           torch.arange(h, dtype=torch.int32), z32)[0]
    hs_f, em_f = model._on_recv(hs, slot, pkt, now, keys)
    branches = [model._sub_call(hs, i, recv, slot, pkt, now, keys)
                for i, recv in enumerate(model._recvs)]
    mine = hs.app.model_id
    for i, (hs_i, em_i) in enumerate(branches):
        em_i = em_i.pad_to(model.app_rows())
        rows = mine == i
        for a, b in ((convert._leaves(hs_f, "", {}),
                      convert._leaves(hs_i, "", {})),
                     (convert._leaves(em_f, "", {}),
                      convert._leaves(em_i, "", {}))):
            for key in a:
                np.testing.assert_array_equal(a[key][rows.numpy()],
                                              b[key][rows.numpy()],
                                              err_msg=f"model {i}: {key}")
    # the PHOLD branch run alone touches the TGen rows; the fused one not
    hs_p, _ = branches[1]
    tgen_rows = (mine == 0).numpy()
    alone = convert._leaves(hs_p, "", {})
    fused = convert._leaves(hs_f, "", {})
    base = convert._leaves(hs, "", {})
    changed = [k for k in base
               if not np.array_equal(alone[k][tgen_rows],
                                     base[k][tgen_rows])]
    assert changed, "the PHOLD branch changed nothing on the TGen rows"
    for key in changed:
        np.testing.assert_array_equal(fused[key][tgen_rows],
                                      base[key][tgen_rows], err_msg=key)
    # _select_rows walks the MultiApp's tuple of sub-states
    sel = _select_rows(torch.zeros((h,), dtype=torch.bool), hs_p, hs)
    assert isinstance(sel.app.subs, tuple) and len(sel.app.subs) == 2
    assert dataclasses.is_dataclass(sel.app)


# -- the slow pins: chip_smoke.py's phase 13 ---------------------------------
@pytest.mark.slow
def test_mixed_bench_shape_parity_and_pins():
    """Phase 13 in both packages on the CPU: equal leaves and the pin."""
    torch.set_num_threads(4)
    text = chip_smoke.mixed_config()
    kw = dict(seed=chip_smoke.TGEN_SEED, n_sockets=chip_smoke.TGEN_SOCKETS,
              capacity=chip_smoke.TGEN_CAPACITY)
    js = jsim.build_simulation(jconfig.parse_config(text), **kw)
    ts = tsim.build_simulation(tconfig.parse_config(text), device="cpu",
                               **kw)
    stop = chip_smoke.MIXED_STOP_S * SECOND
    lj = jax_leaves(js.run(stop))
    lt = convert.engine_state_to_numpy(ts.run(stop))
    assert_leaves_equal(lj, lt)
    assert chip_smoke.mixed_pin(lj) == chip_smoke.PIN_MIXED
