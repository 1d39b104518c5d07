"""The chained drain in shadow_tpu_torch against shadow_tpu, leaf for leaf.

- PHOLD with `batched=False` (the default build) in both packages on the
  CASES of tests/test_torch_phold.py (all but "uniform" marked slow);
- in the port, the chained drain against the batched one, with the
  scheduler counters stripped (tests/test_engine_phold.py holds the
  same for the reference);
- the two-kind toy model of tests/torch_toy.py, written again per host
  for the reference, whose local follow-ups chain below the
  barrier, with a small staging buffer, so that inner-loop chaining, the
  queue-head guard, the high-water gate and the full-width flush all
  fire;
- `_stage_min` and `_stage_append` on random staging with tied times.

Every comparison is exact, dtypes included.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from shadow_tpu.core import engine as jengine
from shadow_tpu.core import rng as jrng
from shadow_tpu.core.events import Events as JEvents
from shadow_tpu_torch import convert
from shadow_tpu_torch.core import engine as tengine
from shadow_tpu_torch.core.events import Events as TEvents
from shadow_tpu_torch.core.timebase import TIME_INVALID
from shadow_tpu_torch.models import phold as tphold
from test_torch_phold import (  # noqa: F401 (one_torch_thread: autouse)
    CASES, assert_leaves_equal, jax_leaves, run_both, one_torch_thread)
from torch_toy import (
    LAT, PING, TICK, TOY, TOY_ARGS, TOY_STOP, run_torch_toy, toy_config,
    toy_initial,
)

MS = 1_000_000
SECOND = 1_000_000_000
# Each chained PHOLD case pays a reference compile and a few hundred
# inner steps of small torch ops on the CPU: "uniform" runs in tier 1,
# the other cases with the slow tests.
CHAINED_CASES = [pytest.param(c, marks=() if c == "uniform"
                              else pytest.mark.slow) for c in CASES]


@functools.lru_cache(maxsize=None)
def chained_phold(case):
    kw = dict(CASES[case])
    return run_both(kw.pop("n_hosts"), 2 * SECOND, False, **kw)


@pytest.mark.parametrize("case", CHAINED_CASES)
def test_chained_phold_matches_reference(case):
    lj, lt = chained_phold(case)
    assert_leaves_equal(lj, lt)
    assert lj["stats.n_inner_steps"] > lj["stats.n_windows"] > 0
    if case == "drops":
        assert lj["queues.drops"].sum() > 0


@pytest.mark.parametrize("case", CHAINED_CASES)
def test_chained_equals_batched_in_the_port(case):
    """Both drains of the port reach the same simulation state."""
    _, chained = chained_phold(case)
    kw = dict(CASES[case])
    eng, init = tphold.build(kw.pop("n_hosts"), batched=True, device="cpu",
                             **kw)
    batched = convert.engine_state_to_numpy(eng.run(init(), 2 * SECOND))
    assert convert.leaves_digest(chained, chip_smoke.SCHEDULER) == \
        convert.leaves_digest(batched, chip_smoke.SCHEDULER)
    assert chained["stats.n_inner_steps"] > 0 == batched[
        "stats.n_inner_steps"]


# -- a two-kind model with local chains (tests/torch_toy.py) -----------------
@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class JToy:
    n_ping: jax.Array
    n_tick: jax.Array
    acc: jax.Array


def jax_toy(n_peers):
    """torch_toy's handlers, per host for the reference."""

    def ping(hs, ev, key):
        k1, k2, k3 = jrng.split(key, 3)
        peer = jrng.randint(k1, 0, n_peers)
        em = jengine.Emit(
            dst=jnp.stack([ev.dst, peer]).astype(jnp.int32),
            dt=jnp.stack([jrng.randint(k2, 0, 3 * MS),
                          jrng.randint(k3, 0, 20 * MS)]).astype(jnp.int64),
            kind=jnp.array([TICK, PING], jnp.int32),
            args=jnp.stack([jnp.stack([ev.seq, ev.src]),
                            jnp.stack([ev.args[0] + 1, ev.dst])]
                           ).astype(jnp.int32),
            mask=jnp.array([True, True]),
            local=jnp.array([True, False]),
        )
        return dataclasses.replace(
            hs, n_ping=hs.n_ping + 1,
            acc=(hs.acc * 3 + ev.args[0]) % 1_000_003), em

    def tick(hs, ev, key):
        k1, k2 = jrng.split(key, 2)
        em = jengine.Emit.single(
            dst=ev.dst, dt=jrng.randint(k2, 0, 2 * MS), kind=TICK,
            args=jnp.stack([ev.args[0] + 1, (ev.time % 1000).astype(
                jnp.int32)]),
            mask=jrng.randint(k1, 0, 3) > 0, local=True, n_args=TOY_ARGS)
        return dataclasses.replace(
            hs, n_tick=hs.n_tick + 1,
            acc=(hs.acc * 5 + ev.time % 7 + ev.args[1]) % 1_000_003), em

    return [ping, tick]


@functools.lru_cache(maxsize=None)
def toy_reference(name):
    n, msgs, peers = TOY[name][:3]
    ej = jengine.Engine(jengine.EngineConfig(**toy_config(name)),
                        jax_toy(peers), jengine.ConstantNetwork(LAT))
    z = jnp.zeros((n,), jnp.int64)
    init = ej.init_state(JToy(z, z, z), JEvents(**{
        k: jnp.asarray(v) for k, v in toy_initial(n, msgs).items()}))
    return jax_leaves(jax.jit(ej.run)(init, jnp.int64(TOY_STOP)))


@pytest.mark.parametrize("name", list(TOY))
def test_toy_chains_match_reference(name, monkeypatch):
    """Equal leaves, and every mechanism of the inner loop fired: local
    chains (more inner steps than windows, and more sweeps), the
    high-water gate (a below-barrier event held back for want of
    staging room), and the flush's full-width push."""
    n, _, _, _, b, sw, _ = TOY[name]
    seen = {"window_end": None, "held": 0, "flush_m": set()}
    drain = tengine.Engine._drain_window
    stage_min = tengine.Engine._stage_min
    push = tengine.queue_push

    def spy_drain(self, st, window_end, host0):
        seen["window_end"] = window_end
        return drain(self, st, window_end, host0)

    def spy_stage_min(stage):
        out = stage_min(stage)
        ev, _mss, _oh, cnt = out
        seen["held"] += int(((ev.time < seen["window_end"])
                             & (cnt + 2 > sw)).sum())
        return out

    def spy_push(q, ev, mask, host0, read=bool):
        seen["flush_m"].add(ev.time.shape[0])
        return push(q, ev, mask, host0, read)

    monkeypatch.setattr(tengine.Engine, "_drain_window", spy_drain)
    monkeypatch.setattr(tengine.Engine, "_stage_min",
                        staticmethod(spy_stage_min))
    monkeypatch.setattr(tengine, "queue_push", spy_push)
    _, lt = run_torch_toy(name)
    lj = toy_reference(name)
    assert_leaves_equal(lj, lt)
    windows = int(lj["stats.n_windows"])
    assert int(lj["stats.n_inner_steps"]) > windows
    assert int(lj["stats.n_sweeps"]) > windows
    assert lj["stats.n_by_kind"][:, TICK].sum() > 0
    assert seen["held"] > 0
    assert n * sw in seen["flush_m"]  # the full-width flush
    assert n * tengine.FLUSH_W in seen["flush_m"]  # and the narrow one


def test_queue_head_guard_decides_the_toy(monkeypatch):
    """Without the queue-head guard a staged event would run ahead of an
    earlier un-dumped queue event, and the run would no longer be the
    reference's: the guard is what keeps it exact here."""
    monkeypatch.setattr(tengine, "_precedes",
                        lambda t, *_: torch.ones_like(t, dtype=torch.bool))
    _, lt = run_torch_toy("hot-peers")
    lj = toy_reference("hot-peers")
    assert any(not np.array_equal(lj[k], lt[k]) for k in lj)


# -- staging helpers against the reference --------------------------------
def random_stage(rng, h, s, n_args, fill):
    """[H, S] staging with a share `fill` of valid slots, times drawn
    from a few values (ties), and (src, seq) distinct within a row."""
    time = rng.integers(0, 4, size=(h, s)).astype(np.int64) * 1000
    time[rng.random((h, s)) >= fill] = TIME_INVALID
    pairs = np.stack([rng.permutation(64)[:s] for _ in range(h)])
    return dict(
        time=time,
        dst=rng.integers(0, 100, size=(h, s)).astype(np.int32),
        src=(pairs // 8).astype(np.int32),
        seq=(pairs % 8).astype(np.int32),
        kind=rng.integers(0, 3, size=(h, s)).astype(np.int32),
        args=rng.integers(-99, 99, size=(h, s, n_args)).astype(np.int32),
    )


def _both(fields):
    return (JEvents(**{k: jnp.asarray(v) for k, v in fields.items()}),
            TEvents(**{k: torch.from_numpy(v) for k, v in fields.items()}))


def _assert_events_equal(ej, et):
    for f in dataclasses.fields(ej):
        a, b = np.asarray(getattr(ej, f.name)), getattr(et, f.name).numpy()
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)


@pytest.mark.parametrize("fill", [0.0, 0.3, 1.0])
def test_stage_min_matches_reference(fill):
    rng = np.random.default_rng(int(fill * 10) + 5)
    sj, st = _both(random_stage(rng, 64, 12, 3, fill))
    ej, mj, oj, cj = jax.jit(jengine.Engine._stage_min)(sj)
    et, mt, ot, ct = tengine.Engine._stage_min(st)
    _assert_events_equal(ej, et)
    for a, b in ((mj, mt), (oj, ot), (cj, ct)):
        assert np.asarray(a).dtype == b.numpy().dtype
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("fill", [0.2, 0.7])
def test_stage_append_matches_reference(fill):
    rng = np.random.default_rng(int(fill * 10) + 9)
    h, s, k = 64, 12, 3
    stage = random_stage(rng, h, s, 3, fill)
    # leave at least k free slots per row, as the high-water gate does
    for row in range(h):
        free = np.flatnonzero(stage["time"][row] == TIME_INVALID)
        need = k - free.size
        if need > 0:
            taken = np.flatnonzero(stage["time"][row] != TIME_INVALID)
            stage["time"][row, taken[:need]] = TIME_INVALID
    out = random_stage(rng, h, k, 3, 0.6)
    sj, st = _both(stage)
    oj, ot = _both(out)
    _assert_events_equal(jax.jit(jengine.Engine._stage_append)(sj, oj),
                         tengine.Engine._stage_append(st, ot))


def test_emit_helpers():
    em = tengine.Emit.single(dst=torch.tensor([3, 4], dtype=torch.int32),
                             dt=5, kind=1, args=torch.tensor([[7], [8]]),
                             n_args=2)
    padded = em.pad_to(3)
    assert padded.dst.tolist() == [[3, 0, 0], [4, 0, 0]]
    assert padded.args.tolist() == [[[7, 0], [0, 0], [0, 0]],
                                    [[8, 0], [0, 0], [0, 0]]]
    assert padded.mask.tolist() == [[True, False, False]] * 2
    assert padded.dt.dtype == torch.int64
    none = tengine.Emit.none(2, 3, 2, device="cpu")
    assert not none.mask.any() and none.args.shape == (2, 3, 2)
    with pytest.raises(ValueError, match="max_emit"):
        padded.pad_to(2)
