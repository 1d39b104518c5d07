"""Lossless overflow in shadow_tpu_torch (the spill ring in
`core/events.py`, the host reservoir in `runtime/pressure.py`) against
shadow_tpu, leaf for leaf.

At tests/test_pressure.py's size (H = 16, capacity 8, a skewed PHOLD):

- the spill run equals the reference's spill run in every leaf, the
  ring's whole [H, cap + slack] leaves included, and in the reservoir
  and its counters, on both drains;
- it ends bit-identical to a run at twice the capacity without spill in
  the behaviour leaves, and its device queue and reservoir partition that
  run's queue, with every reservoir key above every device key;
- largest-key eviction and the ring's capture commute with batch splits,
  and queue pushes with a ring (rank overflow past MERGE_W, a ring that
  overflows, the HOT_C hot region) equal the reference's;
- build_simulation's spill mode equals the reference's, summary
  included, on PHOLD over UDP and on TGen over TCP; the strict mode
  raises with the same accounting;
- spill=0 leaves no ring; "grow" builds a grow-mode controller, the
  strict mode's diagnostic bundle is written as the reference writes it,
  and the reservoir's checkpoint extras round-trip; a TraceDrain
  attaches (its records: tests/test_torch_trace.py).

With the slow tests also chip_smoke.py's phase 14 (bench.py's skew
shape, 4096 hosts to 2 sim-s) in both packages, against its pins.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from shadow_tpu import config as jconfig
from shadow_tpu import examples as jexamples
from shadow_tpu import sim as jsim
from shadow_tpu.core import events as je
from shadow_tpu.models import phold as jphold
from shadow_tpu.runtime import pressure as jp
from shadow_tpu_torch import config as tconfig
from shadow_tpu_torch import convert
from shadow_tpu_torch import sim as tsim
from shadow_tpu_torch.core import events as te
from shadow_tpu_torch.models import phold as tphold
from shadow_tpu_torch.obs.trace import TraceDrain
from shadow_tpu_torch.runtime import pressure as tp
from test_torch_phold import assert_leaves_equal, jax_leaves
from test_torch_tcp import one_torch_thread  # noqa: F401 (autouse)

H = 16
CAP = 8
STOP = 400_000_000
HOT = dict(hot_hosts=4, hot_weight=0.6, msgs_per_host=2)


def _heaps(ctrl):
    """A controller's reservoir as sorted plain-int records per host."""
    return [sorted((int(t), int(ss), tuple(int(w) for w in pay))
                   for t, ss, pay in hp) for hp in ctrl._heaps]


def _spill_run_jax(batched, **kw):
    eng, init = jphold.build(H, capacity=CAP, spill=4 * CAP,
                             batched=batched, **kw)
    ctrl = jp.PressureController(H, CAP, eng.cfg.lookahead,
                                 n_args=jphold.N_PHOLD_ARGS)
    return jp.run_with_spill(eng, init(), STOP, ctrl), ctrl


def _spill_run_torch(batched, **kw):
    eng, init = tphold.build(H, capacity=CAP, spill=4 * CAP,
                             batched=batched, device="cpu", **kw)
    ctrl = tp.PressureController(H, CAP, eng.cfg.lookahead,
                                 n_args=tphold.N_PHOLD_ARGS)
    return tp.run_with_spill(eng, init(), STOP, ctrl), ctrl


@functools.lru_cache(maxsize=None)
def spill_vs_2c(batched):
    """The port's runs at 2C and C without spill and at C with spill,
    and the reference's spill run with its controller."""
    eng2, init2 = tphold.build(H, capacity=2 * CAP, batched=batched,
                               device="cpu", **HOT)
    st2 = eng2.run(init2(), STOP)
    eng1, init1 = tphold.build(H, capacity=CAP, batched=batched,
                               device="cpu", **HOT)
    st1 = eng1.run(init1(), STOP)
    sts, ctrl = _spill_run_torch(batched, **HOT)
    sj, cj = _spill_run_jax(batched, **HOT)
    return st2, st1, sts, ctrl, sj, cj


def _remaining(q):
    """Per-host sorted (time, src, seq) of the events still queued."""
    t, s, k = (getattr(q, f).numpy() for f in ("time", "src", "seq"))
    return [sorted((int(t[h, i]), int(s[h, i]), int(k[h, i]))
                   for i in range(t.shape[1]) if t[h, i] != te.TIME_INVALID)
            for h in range(t.shape[0])]


@pytest.mark.parametrize("batched", [True, False],
                         ids=["batched", "chained"])
def test_spill_matches_reference(batched):
    """Every leaf of the spill run, the ring's whole width included (its
    slots past the cursor hold what the merge wrote there), and the
    reservoir with its counters equal the reference's."""
    _, _, sts, ctrl, sj, cj = spill_vs_2c(batched)
    lt = convert.engine_state_to_numpy(sts)
    assert_leaves_equal(jax_leaves(sj), lt)
    assert lt["queues.spill.n_spilled"].sum() > 0
    assert _heaps(ctrl) == _heaps(cj)
    np.testing.assert_array_equal(ctrl.n_harvested, cj.n_harvested)
    np.testing.assert_array_equal(ctrl.n_refilled, cj.n_refilled)
    assert (ctrl.n_overdue, ctrl.boundaries) == (cj.n_overdue, cj.boundaries)
    assert ctrl.n_refilled.sum() > 0


@pytest.mark.parametrize("batched", [True, False],
                         ids=["batched", "chained"])
def test_spill_is_bit_identical_to_double_capacity(batched):
    st2, st1, sts, _, _, _ = spill_vs_2c(batched)
    assert int(st2.queues.drops.sum()) == 0
    assert int(st1.queues.drops.sum()) > 0
    assert int(sts.queues.drops.sum()) == 0
    assert int(sts.queues.spill.n_spilled.sum()) > 0
    a, b = (convert.engine_state_to_numpy(s) for s in (sts, st2))
    for key in chip_smoke.BEHAVIOUR:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_device_and_reservoir_partition_the_2c_queue():
    st2, _, sts, ctrl, _, _ = spill_vs_2c(True)
    res = [sorted((r[0], r[1] >> 32, int(np.int64(r[1]) & 0xFFFFFFFF))
                  for r in hp) for hp in ctrl._heaps]
    dev, ref = _remaining(sts.queues), _remaining(st2.queues)
    for h in range(H):
        assert sorted(dev[h] + res[h]) == ref[h], f"host {h}"
    # chip_smoke's vectorised form of the same check
    assert np.array_equal(
        chip_smoke.queue_keys(convert.engine_state_to_numpy(sts), ctrl),
        chip_smoke.queue_keys(convert.engine_state_to_numpy(st2)))


def test_reservoir_keys_dominate_device_keys():
    _, _, sts, ctrl, _, _ = spill_vs_2c(False)
    t = sts.queues.time.numpy()
    res_min = ctrl.reservoir_min_keys()
    for h in range(H):
        valid = t[h][t[h] != te.TIME_INVALID]
        if valid.size:
            assert res_min[h] >= valid.max(), f"host {h}"


def _push_both(qj, qt, rows, host0=0):
    """Push the same (time, dst, src, seq, kind) rows in both packages."""
    n = len(rows)
    cols = [np.asarray([r[i] for r in rows]) for i in range(5)]
    args = np.arange(n * 6, dtype=np.int32).reshape(n, 6)
    names = ("time", "dst", "src", "seq", "kind")
    dt = (np.int64, np.int32, np.int32, np.int32, np.int32)
    ev = {k: c.astype(d) for k, c, d in zip(names, cols, dt)}
    ev["args"] = args
    ej = je.Events(**{k: jnp.asarray(v) for k, v in ev.items()})
    et = te.Events(**{k: torch.from_numpy(v) for k, v in ev.items()})
    qj = je.queue_push(qj, ej, jnp.ones(n, bool), host0)
    qt = te.queue_push(qt, et, torch.ones(n, dtype=torch.bool), host0)
    return qj, qt


def _assert_queues_equal(qj, qt):
    lj = {}
    flat, _ = jax.tree_util.tree_flatten_with_path(jax.device_get(qj))
    for path, v in flat:
        lj[".".join(str(k.name) for k in path)] = np.asarray(v)
    lt = convert.engine_state_to_numpy(qt)
    assert_leaves_equal(lj, lt)


def test_eviction_commutes_with_batch_splits():
    """One batch or any chained split keeps the same survivors (the
    capacity smallest keys) and the same drops, in both packages."""
    rows = [(t, 0, 0, t, 0) for t in (5, 9, 1, 7, 3, 8, 2)]
    qj, qt = _push_both(je.EventQueue.create(1, 3),
                        te.EventQueue.create(1, 3, device="cpu"), rows)
    _assert_queues_equal(qj, qt)
    for cut in range(1, len(rows) - 1):
        sj, st = _push_both(je.EventQueue.create(1, 3),
                            te.EventQueue.create(1, 3, device="cpu"),
                            rows[:cut])
        sj, st = _push_both(sj, st, rows[cut:])
        _assert_queues_equal(sj, st)
        assert _remaining(st) == _remaining(qt), f"cut={cut}"
        assert st.drops.tolist() == qt.drops.tolist() == [4]
    assert _remaining(qt)[0] == [(1, 0, 1), (2, 0, 2), (3, 0, 3)]


def test_spill_ring_capture_commutes_with_batch_splits():
    """With a ring the splits capture the same evicted set (its order in
    the ring may differ), and every ring leaf equals the reference's."""
    def spilled_set(q):
        ring = q.spill
        k = min(int(ring.wr[0]), ring.time.shape[1])
        return sorted((int(ring.time[0, i]), int(ring.srcseq[0, i]))
                      for i in range(k))

    rows = [(t, 0, 0, t, 0) for t in (5, 9, 1, 7, 3, 8, 2)]
    qj, qt = _push_both(je.EventQueue.create(1, 3, spill=8),
                        te.EventQueue.create(1, 3, spill=8, device="cpu"),
                        rows)
    _assert_queues_equal(qj, qt)
    assert qt.drops.tolist() == [0]
    want = spilled_set(qt)
    assert len(want) == 4
    for cut in range(1, len(rows) - 1):
        sj, st = _push_both(je.EventQueue.create(1, 3, spill=8),
                            te.EventQueue.create(1, 3, spill=8, device="cpu"),
                            rows[:cut])
        sj, st = _push_both(sj, st, rows[cut:])
        _assert_queues_equal(sj, st)
        assert _remaining(st) == _remaining(qt), f"cut={cut}"
        assert spilled_set(st) == want, f"cut={cut}"


# (n_hosts, capacity, spill slots, batch, t_max, pushes)
RING_REGIMES = {
    "rank-overflow": (4, 32, 256, 300, 40, 2),  # counts past MERGE_W
    "ring-overflow": (3, 4, 6, 60, 30, 3),  # n_lost > 0
    "hot-region": (4, 256, 512, 400, 1000, 4),  # c >= 2 * HOT_C
    "many-rounds": (2, 24, 512, 400, 9, 2),  # several full-width rounds
}


@pytest.mark.parametrize("regime", list(RING_REGIMES))
def test_spill_push_matches_reference(regime):
    """Queue pushes with a ring attached: every queue and ring leaf, the
    ring's scratch columns included, equals the reference's after each
    push."""
    n_hosts, cap, spill, m, t_max, pushes = RING_REGIMES[regime]
    rng = np.random.default_rng(sum(map(ord, regime)))
    qj = je.EventQueue.create(n_hosts, cap, spill=spill)
    qt = te.EventQueue.create(n_hosts, cap, spill=spill, device="cpu")
    for _ in range(pushes):
        rows = list(zip(rng.integers(0, t_max, m).tolist(),
                        rng.integers(0, n_hosts, m).tolist(),
                        rng.integers(0, 50, m).tolist(),
                        rng.permutation(1 << 20)[:m].tolist(),
                        rng.integers(0, 9, m).tolist()))
        qj, qt = _push_both(qj, qt, rows)
        _assert_queues_equal(qj, qt)
    ring = qt.spill
    assert ring.n_spilled.sum() > 0
    if regime == "ring-overflow":
        assert ring.n_lost.sum() > 0 and qt.drops.sum() == ring.n_lost.sum()
    else:
        assert qt.drops.sum() == 0


def test_spill_zero_leaves_no_ring():
    """spill=0 keeps today's queue exactly: no ring and no ring leaves,
    and a build without the knob gives the same leaves."""
    assert te.EventQueue.create(4, 8, spill=0, device="cpu").spill is None
    e0, i0 = tphold.build(8, seed=3, capacity=32, msgs_per_host=2,
                          device="cpu")
    ez, iz = tphold.build(8, seed=3, capacity=32, msgs_per_host=2, spill=0,
                          device="cpu")
    l0 = convert.engine_state_to_numpy(e0.run(i0(), STOP))
    lz = convert.engine_state_to_numpy(ez.run(iz(), STOP))
    assert not any("spill" in k for k in lz)
    assert_leaves_equal(l0, lz)
    es, is_ = tphold.build(8, seed=3, capacity=32, msgs_per_host=2,
                           spill=64, device="cpu")
    ls = convert.engine_state_to_numpy(is_())
    assert ls["queues.spill.time"].shape == (8, 64 + 32)
    # a state carried in from numpy keeps (or lacks) its ring
    back = convert.engine_state_from_numpy(ls, "cpu")
    assert_leaves_equal(ls, convert.engine_state_to_numpy(back))
    assert convert.engine_state_from_numpy(lz, "cpu").queues.spill is None


def test_word_helpers_match_reference():
    rng = np.random.default_rng(7)
    words = [rng.integers(-(2**31), 2**31 - 1, 50).astype(np.int32)
             for _ in range(7)]
    packed = tp._pack_words_np(words)
    np.testing.assert_array_equal(packed, jp._pack_words_np(words))
    for n in (1, 2, 7):
        for a, b in zip(tp._unpack_words(packed, n),
                        jp._unpack_words(packed, n)):
            np.testing.assert_array_equal(a, b)


SPILL_CONFIG = jexamples.phold_example(16, 12, stoptime=2)


# name: (config, build_simulation keywords). PHOLD over UDP with the
# default ring of 4 x capacity and with a given spill_len, and TGen over
# TCP at 3 pairs with 16 queue slots per host, where the ring takes
# packet payloads evicted on the chained drain
BUILD_SPILL_CASES = {
    "0": (SPILL_CONFIG, dict(seed=4, capacity=12, spill_len=0)),
    "24": (SPILL_CONFIG, dict(seed=4, capacity=12, spill_len=24)),
    "tgen_tcp": (chip_smoke.tgen_config(3).replace(
        f'stoptime="{chip_smoke.TGEN_STOP_S}"', 'stoptime="6"'),
        dict(seed=chip_smoke.TGEN_SEED, n_sockets=chip_smoke.TGEN_SOCKETS,
             capacity=16)),
}


@pytest.mark.parametrize("name", list(BUILD_SPILL_CASES))
def test_build_simulation_spill_matches_reference(name):
    """overflow="spill" through build_simulation: the window-stepped run
    equals the reference's, summary included, and loses nothing."""
    text, kw = BUILD_SPILL_CASES[name]
    kw = dict(kw, overflow="spill")
    js = jsim.build_simulation(jconfig.parse_config(text), **kw)
    ts = tsim.build_simulation(tconfig.parse_config(text), device="cpu",
                               **kw)
    assert ts.engine.cfg.spill == js.engine.cfg.spill == (
        kw.get("spill_len") or 4 * kw["capacity"])
    jst, tst = js.run(), ts.run()
    lt = convert.engine_state_to_numpy(tst)
    assert_leaves_equal(jax_leaves(jst), lt)
    assert ts.summary(tst) == js.summary(jst)
    assert lt["queues.spill.pay"].shape[-1] > 1
    assert lt["queues.spill.n_spilled"].sum() > 0
    assert lt["queues.spill.n_lost"].sum() == 0
    assert ts.pressure.n_refilled.sum() > 0 and lt["queues.drops"].sum() == 0
    assert ts.pressure.n_overdue == 0


def test_strict_error_accounting():
    """overflow="strict" raises QueuePressureError at the first would-be
    drop, with the same accounting as the reference's."""
    kw = dict(seed=4, capacity=12, overflow="strict")
    errs = []
    for sim_mod, cfg_mod, extra in ((jsim, jconfig, {}),
                                    (tsim, tconfig, {"device": "cpu"})):
        sim = sim_mod.build_simulation(cfg_mod.parse_config(SPILL_CONFIG),
                                       **kw, **extra)
        with pytest.raises(Exception) as info:
            sim.run()
        errs.append(info.value)
    je_, te_ = errs
    assert type(te_) is tp.QueuePressureError is tsim.QueuePressureError
    assert type(je_).__name__ == "QueuePressureError"
    assert (te_.drops, te_.capacity) == (je_.drops, je_.capacity)
    assert te_.drops > 0 and te_.capacity == 12
    assert te_.summary == je_.summary
    assert str(te_) == str(je_)
    e = tp.QueuePressureError(17, 64, {"now_ns": 5})
    assert (e.drops, e.capacity, e.summary) == (17, 64, {"now_ns": 5})
    assert "--overflow spill" in str(e)


def test_grow_and_unported_extras_raise(tmp_path):
    """Once refused, now ported: "grow" builds a grow-mode controller,
    `pressure_bundle` writes the reference's bundle, and the reservoir's
    checkpoint extras round-trip (with a checkpoint:
    tests/test_torch_checkpoint.py); only an unknown mode raises."""
    cfg = tconfig.parse_config(SPILL_CONFIG)
    sim = tsim.build_simulation(cfg, overflow="grow", device="cpu")
    assert sim.pressure.mode == "grow"
    with pytest.raises(ValueError, match="spill/grow"):
        tp.PressureController(4, 8, 1, n_args=1, mode="strict")
    ctrl = tp.PressureController(4, 8, 1, n_args=tphold.N_PHOLD_ARGS)
    err = tp.QueuePressureError(1, 8, {"now_ns": 3})
    paths = [mod.pressure_bundle(err, diag_dir=str(tmp_path / name),
                                 label="x")
             for mod, name in ((tp, "t"), (jp, "j"))]
    docs = [json.loads(open(p).read()) for p in paths]
    assert docs[0] == docs[1] and docs[0]["exit_code"] == 76
    ctrl._heaps[2] = [(5, 7, (1, 2)), (9, 3, (4, 5))]
    ctrl.n_refilled[1] = 4
    extra = ctrl.serialize()
    back = tp.PressureController(4, 8, 1, n_args=tphold.N_PHOLD_ARGS)
    back.restore(extra)
    assert back._heaps == ctrl._heaps and back.n_refilled.tolist() == [
        0, 4, 0, 0]
    # spill/refill trace records are ported (tests/test_torch_trace.py)
    drain = TraceDrain(8)
    ctrl.attach_trace(drain, len_arg=1)
    assert ctrl.trace_drain is drain and ctrl._trace_len_arg == 1
    assert tp.OVERFLOW_MODES == jp.OVERFLOW_MODES


# -- the slow pins: chip_smoke.py's phase 14 ---------------------------------
@pytest.mark.slow
def test_skew_bench_shape_parity_and_pins():
    """bench.py's skew shape at 4096 hosts to 2 sim-s in both packages:
    equal leaves in all three runs, equal reservoirs, and the pins the
    card is held to."""
    def run(pkg, cap, spill):
        kw = dict(chip_smoke.SKEW, capacity=cap)
        if pkg == "jax":
            eng, init = jphold.build(4096, batched=True, spill=spill, **kw)
            if not spill:
                return jax_leaves(jax.jit(eng.run)(
                    init(), jnp.int64(chip_smoke.SKEW_STOP_NS))), None
            ctrl = jp.PressureController(4096, cap, eng.cfg.lookahead,
                                         n_args=jphold.N_PHOLD_ARGS)
            return jax_leaves(jp.run_with_spill(
                eng, init(), chip_smoke.SKEW_STOP_NS, ctrl)), ctrl
        torch.set_num_threads(4)
        eng, init = tphold.build(4096, batched=True, spill=spill,
                                 device="cpu", **kw)
        if not spill:
            return convert.engine_state_to_numpy(
                eng.run(init(), chip_smoke.SKEW_STOP_NS)), None
        ctrl = tp.PressureController(4096, cap, eng.cfg.lookahead,
                                     n_args=tphold.N_PHOLD_ARGS)
        return convert.engine_state_to_numpy(tp.run_with_spill(
            eng, init(), chip_smoke.SKEW_STOP_NS, ctrl)), ctrl

    cap = chip_smoke.SKEW_CAPACITY
    out = {}
    for label, c, spill, pin in (
            ("drop", cap, 0, chip_smoke.PIN_SKEW_DROP),
            ("spill", cap, chip_smoke.SKEW_SPILL, chip_smoke.PIN_SKEW_SPILL),
            ("2c", 2 * cap, 0, chip_smoke.PIN_SKEW_2C)):
        (lj, cj), (lt, ct) = run("jax", c, spill), run("torch", c, spill)
        assert_leaves_equal(lj, lt)
        assert chip_smoke.skew_pin(lj, cj) == pin
        assert chip_smoke.skew_pin(lt, ct) == pin
        if ct is not None:
            assert _heaps(ct) == _heaps(cj)
            assert ct.n_overdue == 0 and lt["queues.spill.n_lost"].sum() == 0
        out[label] = (lt, ct)
    for key in chip_smoke.BEHAVIOUR:
        np.testing.assert_array_equal(out["spill"][0][key],
                                      out["2c"][0][key], err_msg=key)
    assert np.array_equal(chip_smoke.queue_keys(*out["spill"]),
                          chip_smoke.queue_keys(out["2c"][0]))
