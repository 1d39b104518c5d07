"""shadow_tpu_torch.core.events against shadow_tpu.core.events.

The no-spill regimes of tests/test_kernel_equivalence.py (sparse,
overflow, multi-round, a non-zero shard base) plus the two-level round's
full-width fallback (rank overflow past MERGE_W) and the HOT_C hot
region: each push and pop runs in both packages on the same
numpy-seeded batch, and every queue leaf must be equal, dtype included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_tpu.core import events as je
from shadow_tpu.core.timebase import TIME_INVALID
from shadow_tpu_torch.core import events as te

N_ARGS = 6
FIELDS = ("time", "src", "seq", "kind", "args", "drops")
_jpush = jax.jit(je.queue_push, static_argnums=3)
_jpop = jax.jit(je.queue_pop)


def _rand_events(rng, m, n_hosts, t_max):
    """Random batch with ties, rejects and invalid rows mixed in, as
    numpy arrays (the generator of test_kernel_equivalence.py)."""
    t = rng.integers(0, t_max, size=m).astype(np.int64)
    bad = rng.random(m) < 0.05
    t[bad] = rng.choice([-5, int(TIME_INVALID)], size=int(bad.sum()))
    return dict(
        time=t,
        dst=rng.integers(-1, n_hosts + 2, size=m).astype(np.int32),
        src=rng.integers(0, 8, size=m).astype(np.int32),
        seq=rng.integers(0, 4, size=m).astype(np.int32),
        kind=rng.integers(0, 100, size=m).astype(np.int32),
        args=rng.integers(-(2**31), 2**31 - 1, size=(m, N_ARGS)).astype(
            np.int32),
    )


def _both(ev):
    return (je.Events(**{k: jnp.asarray(v) for k, v in ev.items()}),
            te.Events(**{k: torch.from_numpy(v) for k, v in ev.items()}))


def _assert_queues_equal(qj, qt):
    for f in FIELDS:
        a = np.asarray(getattr(qj, f))
        b = getattr(qt, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


# (n_hosts, capacity, batch, t_max)
REGIMES = {
    "sparse": (4, 16, 12, 1000),
    "overflow": (4, 8, 64, 50),
    "multi-round": (5, 8, 80, 5),
    "rank-overflow-past-W1": (3, 40, 150, 20),
    "hot-region": (3, 256, 60, 100),
    "hot-region-overflow": (2, 256, 400, 30),
}


@pytest.mark.parametrize("regime", list(REGIMES))
def test_push_pop_regimes(regime):
    n_hosts, cap, m, t_max = REGIMES[regime]
    for seed in (0, 1, 2):
        rng = np.random.default_rng(seed * 7 + 1)
        qj = je.EventQueue.create(n_hosts, cap)
        qt = te.EventQueue.create(n_hosts, cap, device="cpu")
        gids = np.arange(n_hosts, dtype=np.int32)
        for _ in range(3):
            ejx, etx = _both(_rand_events(rng, m, n_hosts, t_max))
            mask = rng.random(m) < 0.9
            qj = _jpush(qj, ejx, jnp.asarray(mask), 0)
            qt = te.queue_push(qt, etx, torch.from_numpy(mask), 0)
            _assert_queues_equal(qj, qt)
            # pop a frontier so later rounds see a cleared-empty prefix
            qj, evj, actj = _jpop(qj, jnp.int64(t_max // 2),
                                  jnp.asarray(gids))
            qt, evt, actt = te.queue_pop(qt, t_max // 2,
                                         torch.from_numpy(gids))
            _assert_queues_equal(qj, qt)
            np.testing.assert_array_equal(np.asarray(actj), actt.numpy())
            for f in ("time", "dst", "src", "seq", "kind", "args"):
                np.testing.assert_array_equal(
                    np.asarray(getattr(evj, f)), getattr(evt, f).numpy())


def test_fallback_round_is_read_once():
    """Counts past W1 take the full-width round, decided by one read."""
    n_hosts, cap, m, t_max = REGIMES["rank-overflow-past-W1"]
    rng = np.random.default_rng(5)
    ev = _rand_events(rng, m, n_hosts, t_max)
    reads = []

    def read(flag):
        reads.append(bool(flag))
        return reads[-1]

    te.queue_push(te.EventQueue.create(n_hosts, cap, device="cpu"),
                  _both(ev)[1], torch.ones(m, dtype=torch.bool), 0, read)
    assert reads == [True]


def test_sharded_host0():
    rng = np.random.default_rng(11)
    ejx, etx = _both(_rand_events(rng, 32, 8, 100))  # dst over two shards
    qj = _jpush(je.EventQueue.create(4, 8), ejx, jnp.ones(32, bool), 4)
    qt = te.queue_push(te.EventQueue.create(4, 8, device="cpu"), etx,
                       torch.ones(32, dtype=torch.bool), 4)
    _assert_queues_equal(qj, qt)


def test_pack_srcseq_and_group_run_starts():
    rng = np.random.default_rng(12)
    src = rng.integers(-5, 1 << 20, size=200).astype(np.int32)
    seq = rng.integers(-(2**31), 2**31 - 1, size=200).astype(np.int32)
    pj = np.asarray(je.pack_srcseq(jnp.asarray(src), jnp.asarray(seq)))
    pt = te.pack_srcseq(torch.from_numpy(src), torch.from_numpy(seq))
    np.testing.assert_array_equal(pj, pt.numpy())
    for a, b in zip(je.unpack_srcseq(jnp.asarray(pj)), te.unpack_srcseq(pt)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    groups = np.sort(rng.integers(0, 9, size=100)).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(je.group_run_starts(jnp.asarray(groups))),
        te.group_run_starts(torch.from_numpy(groups)).numpy())


def test_spill_is_not_ported():
    """The spill ring is ported now (tests/test_torch_pressure.py holds
    its pushes against the reference): a queue created with spill slots
    carries a ring shaped as the reference's, and spill=0 none."""
    qj = je.EventQueue.create(4, 8, spill=16)
    qt = te.EventQueue.create(4, 8, spill=16, device="cpu")
    for f in ("time", "srcseq", "pay", "wr", "n_spilled", "n_lost",
              "fill_hwm"):
        a, b = np.asarray(getattr(qj.spill, f)), getattr(qt.spill, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert te.EventQueue.create(4, 8, device="cpu").spill is None
