"""The CPU model and burst folding in shadow_tpu_torch against shadow_tpu.

- the cases of tests/test_cpu_model.py ([H] and [H, n_kinds] cost
  tables; a zero table is the same as no CPU model) on both drains,
  leaf for leaf;
- `_burst_fold` on random staged packets (N_PKT_ARGS = 11 words) with
  contiguous runs, short tails, ineligible kinds and excluded flags;
- an engine run with burst folding and a per-kind CPU cost, so that a
  folded arrival pays per segment.

Every comparison is exact, dtypes included.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_tpu.core import engine as jengine
from shadow_tpu.core import rng as jrng
from shadow_tpu.core.events import Events as JEvents
from shadow_tpu.host.sockets import PROTO_TCP
from shadow_tpu.models import phold as jphold
from shadow_tpu.transport.stack import (
    A_ACK, A_AUX, A_DPORT, A_LEN, A_META, A_SACK0, A_SACK1, A_SEQ, A_SPORT,
    A_WND, F_FIN, F_RST, F_SYN, KIND_PKT_ARRIVE, N_PKT_ARGS,
)
from shadow_tpu.transport.tcp import MSS
from shadow_tpu_torch import convert
from shadow_tpu_torch.core import engine as tengine
from shadow_tpu_torch.core import rng as trng
from shadow_tpu_torch.core.events import Events as TEvents
from shadow_tpu_torch.core.timebase import TIME_INVALID
from shadow_tpu_torch.models import phold as tphold
from test_torch_phold import (  # noqa: F401 (one_torch_thread: autouse)
    assert_leaves_equal, jax_leaves, one_torch_thread)

MS = 1_000_000
SECOND = 1_000_000_000

# the stack's descriptor, as sim.py builds it for TCP
BURST = (KIND_PKT_ARRIVE, A_SEQ, A_LEN, A_SPORT, A_DPORT, A_META,
         int(PROTO_TCP), int(F_SYN | F_FIN | F_RST), int(MSS),
         (A_ACK, A_WND, A_AUX, A_SACK0, A_SACK1))


# -- the CPU model on PHOLD ---------------------------------------------------
def cost_table(kind, n_hosts):
    """The tables of tests/test_cpu_model.py: host 0 costs 1 s per event,
    as [H] ("host") or [H, n_kinds] ("kind"); or all zeros ("zero")."""
    if kind == "host":
        tab = np.zeros((n_hosts,), np.int64)
    else:
        tab = np.zeros((n_hosts, 1), np.int64)
    if kind != "zero":
        tab[0] = SECOND
    return tab


def run_phold_cpu(pkg, table, batched, n_hosts=8, seed=2, stop=2 * SECOND):
    """PHOLD with a cost table in one package; numpy leaves."""
    kw = dict(capacity=64, seed=seed, batched=batched)
    if pkg == "jax":
        eng, init = jphold.build(n_hosts, **kw)
        eng2 = jengine.Engine(eng.cfg, eng.handlers, eng.network,
                              cpu_cost=None if table is None
                              else jnp.asarray(table),
                              batch_handler=eng.batch_handler)
        return jax_leaves(jax.jit(eng2.run)(init(), jnp.int64(stop)))
    eng, init = tphold.build(n_hosts, device="cpu", **kw)
    eng2 = tengine.Engine(eng.cfg, eng.handlers, eng.network,
                          cpu_cost=table, batch_handler=eng.batch_handler,
                          device="cpu")
    return convert.engine_state_to_numpy(eng2.run(init(), stop))


@pytest.mark.parametrize("batched", [False, True], ids=["chained", "batched"])
@pytest.mark.parametrize("table", ["host", "kind"])
def test_cpu_model_matches_reference(table, batched):
    tab = cost_table(table, 8)
    lj = run_phold_cpu("jax", tab, batched)
    lt = run_phold_cpu("torch", tab, batched)
    assert_leaves_equal(lj, lt)
    ex = lj["stats.n_executed"]
    # the busy host lags its peers and still makes progress
    assert 1 <= ex[0] < 0.6 * ex[1:].mean()
    assert lj["cpu_free"][0] > 0


@pytest.mark.parametrize("batched", [False, True], ids=["chained", "batched"])
def test_zero_cost_table_is_no_cpu_model(batched):
    zero = run_phold_cpu("torch", cost_table("zero", 8), batched)
    assert_leaves_equal(run_phold_cpu("torch", None, batched), zero)
    eng, _ = tphold.build(8, device="cpu")
    assert not tengine.Engine(eng.cfg, eng.handlers, eng.network,
                              cpu_cost=cost_table("zero", 8),
                              device="cpu")._cpu_enabled


def test_cpu_cost_shape_validation():
    eng, _ = tphold.build(4, capacity=16, device="cpu")
    with pytest.raises(ValueError, match="cpu_cost"):
        tengine.Engine(eng.cfg, eng.handlers, eng.network,
                       cpu_cost=np.zeros((3,), np.int64), device="cpu")


# -- _burst_fold on random staging --------------------------------------------
def random_packets(rng, h, sw):
    """[H, SW] staged events: per row a few flows whose arrivals chain by
    tcp seq (full-MSS segments, some short tails, some gaps), mixed with
    other kinds, excluded flags, zero-length carriers and empty slots."""
    t = rng.integers(0, 50, size=(h, sw)).astype(np.int64) * 1000
    t[rng.random((h, sw)) < 0.15] = TIME_INVALID
    src = rng.integers(0, 3, size=(h, sw)).astype(np.int32)
    args = rng.integers(0, 1 << 20, size=(h, sw, N_PKT_ARGS)).astype(np.int32)
    flags = rng.choice([0, 0, 0, 0, F_SYN, F_FIN, 1 << 3], size=(h, sw))
    args[:, :, A_META] = (PROTO_TCP | flags).astype(np.int32)
    args[:, :, A_SPORT] = src + 1000
    args[:, :, A_DPORT] = 80
    args[:, :, A_SEQ] = (np.arange(sw)[None, :] // 2
                         + rng.integers(0, 2, size=(h, sw)) * 3)
    ln = np.where(rng.random((h, sw)) < 0.8, MSS,
                  rng.integers(0, MSS + 2, size=(h, sw)))
    args[:, :, A_LEN] = ln.astype(np.int32)
    kind = np.where(rng.random((h, sw)) < 0.85, KIND_PKT_ARRIVE,
                    1).astype(np.int32)
    return dict(
        time=t, dst=rng.integers(0, 8, size=(h, sw)).astype(np.int32),
        src=src, seq=np.arange(h * sw, dtype=np.int32).reshape(h, sw),
        kind=kind, args=args,
    )


def test_burst_fold_matches_reference():
    rng = np.random.default_rng(31)
    h, sw = 128, 24
    fields = random_packets(rng, h, sw)
    cfg = dict(n_hosts=h, capacity=32, lookahead=MS, max_emit=2,
               n_args=N_PKT_ARGS, drain_batch=16, burst=BURST)
    ej = jengine.Engine(jengine.EngineConfig(**cfg), [None],
                        jengine.ConstantNetwork(MS))
    et = tengine.Engine(tengine.EngineConfig(**cfg), [None],
                        tengine.ConstantNetwork(MS), device="cpu")
    fj = jax.jit(ej._burst_fold)(
        JEvents(**{k: jnp.asarray(v) for k, v in fields.items()}))
    ft = et._burst_fold(
        TEvents(**{k: torch.from_numpy(v) for k, v in fields.items()}))
    for f in dataclasses.fields(fj):
        a, b = np.asarray(getattr(fj, f.name)), getattr(ft, f.name).numpy()
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    # runs folded: some heads carry a segment count, some slots cleared
    nseg = np.asarray(fj.args)[:, :, A_LEN] >> tengine.BURST_NSEG_SHIFT
    assert (nseg > 1).sum() > 20
    assert (np.asarray(fj.time) == TIME_INVALID).sum() > (
        fields["time"] == TIME_INVALID).sum()


def test_burst_needs_narrow_staging():
    with pytest.raises(ValueError, match="burst"):
        tengine.EngineConfig(n_hosts=4, capacity=256, lookahead=1,
                             drain_batch=128, burst=BURST)


# -- an engine run with burst folding and the CPU model -----------------------
ARRIVE, TIMER = KIND_PKT_ARRIVE, 1
N_HOSTS, LAT = 8, 5 * MS


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class JFlow:
    rx_bytes: jax.Array
    rx_segs: jax.Array
    n_folded: jax.Array
    next_seq: jax.Array
    acc: jax.Array


@dataclasses.dataclass(frozen=True)
class TFlow:
    rx_bytes: torch.Tensor
    rx_segs: torch.Tensor
    n_folded: torch.Tensor
    next_seq: torch.Tensor
    acc: torch.Tensor


def _segments(xp, gid, peer, seq0, r):
    """Three segments' [3, N_PKT_ARGS] args, elementwise in numpy-like
    `xp` over leading dims: full, full, then a short tail; the first may
    carry SYN and the third may skip a seq (r: four random words)."""
    lead = gid.shape
    z = lambda: xp.zeros(lead, dtype=xp.int32)
    segs = []
    for j in range(3):
        seq = seq0 + j + (r[2] % 2) * (j == 2)
        ln = MSS if j < 2 else r[3] % MSS + 1
        meta = PROTO_TCP | (F_SYN * ((r[0] % 8 == 0) & (j == 0)))
        words = [z() for _ in range(N_PKT_ARGS)]
        words[A_META] = z() + meta
        words[A_SPORT] = gid % 3 + 1000
        words[A_DPORT] = z() + 80
        words[A_SEQ] = seq
        words[A_ACK] = r[1] % 1000 + j
        words[A_LEN] = z() + ln
        words[A_WND] = z() + 64 + j
        words[A_AUX] = r[0] % 77 + j
        words[A_SACK0] = r[1] % 13 + 5 * j
        segs.append(words)
    return segs


def jax_flow():
    """Per host: a TIMER every 5 ms sends a three-segment burst to a
    random peer and reschedules itself; an ARRIVE counts bytes and
    segments (nseg from the length word) and folds its control words."""

    def arrive(hs, ev, key):
        lw = ev.args[A_LEN]
        paid = lw & tengine.BURST_LEN_MASK
        nseg = jnp.where(paid > 0,
                         jnp.maximum(lw >> tengine.BURST_NSEG_SHIFT, 1), 1)
        hs = dataclasses.replace(
            hs, rx_bytes=hs.rx_bytes + paid, rx_segs=hs.rx_segs + nseg,
            n_folded=hs.n_folded + (nseg > 1),
            acc=(hs.acc * 7 + ev.args[A_ACK] + ev.args[A_SACK0]
                 + ev.args[A_WND]) % 1_000_003)
        return hs, jengine.Emit.none(4, N_PKT_ARGS)

    def timer(hs, ev, key):
        k1, k2, k3 = jrng.split(key, 3)
        peer = jrng.randint(k1, 0, N_HOSTS)
        r = [jrng.randint(k, 0, 1 << 20)
             for k in jrng.split(k2, 4)]
        segs = _segments(jnp, ev.dst, peer, hs.next_seq.astype(jnp.int32), r)
        args = jnp.stack([jnp.stack(w) for w in segs]
                         + [jnp.zeros((N_PKT_ARGS,), jnp.int32)])
        em = jengine.Emit(
            dst=jnp.stack([peer, peer, peer, ev.dst]).astype(jnp.int32),
            dt=jnp.stack([jnp.int64(0)] * 3
                         + [jrng.randint(k3, 4 * MS, 6 * MS).astype(
                             jnp.int64)]),
            kind=jnp.array([ARRIVE] * 3 + [TIMER], jnp.int32),
            args=args.astype(jnp.int32),
            mask=jnp.ones((4,), bool),
            local=jnp.array([False] * 3 + [True]),
        )
        return dataclasses.replace(hs, next_seq=hs.next_seq + 4), em

    return [arrive, timer]


def torch_flow():
    """The same handlers, batched over [H]."""

    def arrive(hs, ev, keys):
        lw = ev.args[:, A_LEN]
        paid = lw & tengine.BURST_LEN_MASK
        nseg = torch.where(paid > 0, torch.clamp(
            lw >> tengine.BURST_NSEG_SHIFT, min=1), 1)
        hs = dataclasses.replace(
            hs, rx_bytes=hs.rx_bytes + paid, rx_segs=hs.rx_segs + nseg,
            n_folded=hs.n_folded + (nseg > 1),
            acc=(hs.acc * 7 + ev.args[:, A_ACK] + ev.args[:, A_SACK0]
                 + ev.args[:, A_WND]) % 1_000_003)
        return hs, tengine.Emit.none(ev.dst.shape[0], 4, N_PKT_ARGS,
                                     device=ev.dst.device)

    def timer(hs, ev, keys):
        k1, k2, k3 = trng.split(keys, 3)
        peer = trng.randint(k1, 0, N_HOSTS)
        r = [trng.randint(k, 0, 1 << 20) for k in trng.split(k2, 4)]
        segs = _segments(torch, ev.dst, peer, hs.next_seq.to(torch.int32), r)
        h, dev = ev.dst.shape[0], ev.dst.device
        args = torch.stack(
            [torch.stack(w, 1) for w in segs]
            + [torch.zeros((h, N_PKT_ARGS), dtype=torch.int32, device=dev)],
            1)
        row = lambda *v: torch.tensor(v, device=dev).expand(h, len(v))
        em = tengine.Emit(
            dst=torch.stack([peer, peer, peer, ev.dst], 1).to(torch.int32),
            dt=torch.cat([torch.zeros((h, 3), dtype=torch.int64, device=dev),
                          trng.randint(k3, 4 * MS, 6 * MS)[:, None].to(
                              torch.int64)], 1),
            kind=row(ARRIVE, ARRIVE, ARRIVE, TIMER).to(torch.int32),
            args=args.to(torch.int32),
            mask=torch.ones((h, 4), dtype=torch.bool, device=dev),
            local=row(False, False, False, True),
        )
        return dataclasses.replace(hs, next_seq=hs.next_seq + 4), em

    return [arrive, timer]


def flow_run(pkg, stop=100 * MS):
    cfg = dict(n_hosts=N_HOSTS, capacity=64, lookahead=LAT, max_emit=4,
               n_args=N_PKT_ARGS, seed=17, drain_batch=16, burst=BURST)
    # per-kind costs: an arrival 300 us per segment, a timer 100 us
    cost = np.tile(np.array([[300_000, 100_000]], np.int64), (N_HOSTS, 1))
    g = np.arange(N_HOSTS, dtype=np.int32)[:, None]
    init = dict(time=(g % 4 + 1).astype(np.int64) * MS, dst=g, src=g,
                seq=np.zeros_like(g), kind=np.full_like(g, TIMER),
                args=np.zeros((N_HOSTS, 1, N_PKT_ARGS), np.int32))
    if pkg == "jax":
        eng = jengine.Engine(jengine.EngineConfig(**cfg), jax_flow(),
                             jengine.ConstantNetwork(LAT),
                             cpu_cost=jnp.asarray(cost))
        z = jnp.zeros((N_HOSTS,), jnp.int64)
        st = eng.init_state(JFlow(z, z, z, z, z), JEvents(**{
            k: jnp.asarray(v) for k, v in init.items()}))
        return jax_leaves(jax.jit(eng.run)(st, jnp.int64(stop)))
    eng = tengine.Engine(tengine.EngineConfig(**cfg), torch_flow(),
                         tengine.ConstantNetwork(LAT), cpu_cost=cost,
                         device="cpu")
    z = torch.zeros((N_HOSTS,), dtype=torch.int64)
    st = eng.init_state(TFlow(z, z, z, z, z), TEvents(**{
        k: torch.from_numpy(np.ascontiguousarray(v))
        for k, v in init.items()}))
    return convert.engine_state_to_numpy(eng.run(st, stop))


def test_burst_run_with_cpu_cost_matches_reference():
    lj, lt = flow_run("jax"), flow_run("torch")
    assert_leaves_equal(lj, lt)
    # bursts folded, and the folded arrivals were paid per segment
    assert lj["hosts.n_folded"].sum() > 0
    assert lj["hosts.rx_segs"].sum() > lj["stats.n_by_kind"][:, ARRIVE].sum()
    assert (lj["cpu_free"] > 0).all()
