"""TCP in shadow_tpu_torch against shadow_tpu, leaf for leaf.

- the u64 bitmap helpers (held in int64 by the port) and the population
  count against the reference on seeded words with the corner cases:
  zero, all ones, bit 63 set, shifts of 0, 63 and 64 or more;
- the one-hot row helpers with slots out of range, which clamp;
- the TCB table, `HostNet.create(with_tcp=True)` with receive-window and
  send-buffer caps, and its leaves carried through `convert`;
- the scenarios of tests/test_tcp.py through tests/torch_tcp_harness.py's
  port of its `build` harness (the reference side is that harness
  itself): lossless bulk with a full close, lossy bulk,
  request/response, a partial segment refilled, heavy loss, and two
  runs giving one state;
- `rst_on_unmatched`: a SYN that no socket claims, and data that lands
  on the bare listener after the server lost its connection, each draw
  an RST that closes the client;
- `TCP(cc="cubic")` takes CUBIC (F2 solved; tests/test_torch_cubic.py
  runs it).

Every comparison is exact, dtypes included.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_tcp as jtcp_tests
from shadow_tpu.transport import stack as jstack
from shadow_tpu.transport import tcp as jtcp
from shadow_tpu_torch import convert
from shadow_tpu_torch.transport import stack as tstack
from shadow_tpu_torch.transport import tcp as ttcp
from test_torch_phold import (  # noqa: F401 (one_torch_thread: autouse)
    assert_leaves_equal, jax_leaves, one_torch_thread)
from torch_tcp_harness import (
    MS, SECOND, build_pair, forget_socket, put_torch)

I32 = torch.int32
U64_ALL = (1 << 64) - 1


# -- bitmaps -----------------------------------------------------------------
def u64_words(n, seed=5):
    """Seeded u64 words with the corners: zero, all ones, bit 63 alone,
    bit 63 over a run of low ones, runs of low ones of every length."""
    rng = np.random.default_rng(seed)
    corner = [0, U64_ALL, 1 << 63, (1 << 63) | 0xFF, (1 << 63) - 1,
              (1 << 62) - 1, 0xFFFFFFFF, 1 << 32]
    corner += [(1 << k) - 1 for k in range(65)]
    rand = rng.integers(0, 1 << 63, size=n, dtype=np.int64).astype(np.uint64)
    rand = rand * np.uint64(2) + (rng.random(n) < 0.5).astype(np.uint64)
    rand[::3] |= np.uint64(1 << 63)
    rand[1::4] |= np.uint64(0xFFFF)
    return np.concatenate([np.array(corner, dtype=np.uint64), rand])


def t64(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int64))


def u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def test_popcount_trailing_ones_and_shifts():
    x = u64_words(4000)
    jx = jnp.asarray(x)
    tx = t64(x)
    np.testing.assert_array_equal(
        np.asarray(jax.lax.population_count(jx)).astype(np.int32),
        ttcp._popcount(tx).numpy())
    assert ttcp._popcount(tx).dtype == I32
    jt = np.asarray(jax.vmap(jtcp._trailing_ones)(jx))
    tt = ttcp._trailing_ones(tx)
    assert tt.dtype == I32 and jt.dtype == np.int32
    np.testing.assert_array_equal(jt, tt.numpy())
    assert tt[1] == 64 and tt[0] == 0 and tt[4] == 63
    n = np.arange(x.size) % 64
    np.testing.assert_array_equal(
        np.asarray(jx >> jnp.asarray(n, jnp.uint64)),
        u64(ttcp._shr(tx, torch.from_numpy(n))))


@pytest.mark.parametrize("w", [1, 2, 4])
def test_bitmap_vectors_match_reference(w):
    rng = np.random.default_rng(11 + w)
    h = 600
    ooo = u64_words(h * w, seed=w).reshape(-1)[:h * w]
    ooo = rng.permutation(ooo).reshape(h, w)
    ooo[:5] = np.uint64(U64_ALL)  # saturated rows: runs across words
    ooo[5, :] = np.uint64(0)
    jo, to = jnp.asarray(ooo), t64(ooo)
    top = 64 * w
    # shifts of 0, 63, 64, the whole bitmap, and anything in between
    adv = rng.integers(0, top + 1, size=h).astype(np.int32)
    adv[:8] = [0, 63, 64, top, 65 % (top + 1), 1, top - 1, 0]
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(jtcp._shift_right_vec)(jo, jnp.asarray(adv))),
        u64(ttcp._shift_right_vec(to, torch.from_numpy(adv))))
    jtv = np.asarray(jax.vmap(jtcp._trailing_ones_vec)(jo))
    np.testing.assert_array_equal(jtv, ttcp._trailing_ones_vec(to).numpy())
    assert jtv[0] == top
    # ranges, clamped to the bitmap, empty, reversed and whole
    lo = rng.integers(-70, top + 70, size=h).astype(np.int32)
    hi = lo + rng.integers(-3, 140, size=h).astype(np.int32)
    lo[:4], hi[:4] = [0, 0, 5, -9], [top, 64, 5, top + 9]
    jr = jax.vmap(lambda a, b: jtcp._range_vec(a, b, w))(
        jnp.asarray(lo), jnp.asarray(hi))
    np.testing.assert_array_equal(
        np.asarray(jr), u64(ttcp._range_vec(torch.from_numpy(lo),
                                            torch.from_numpy(hi), w)))
    off = rng.integers(0, top, size=h).astype(np.int32)
    off[:3] = [0, 63, top - 1]
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(lambda o: jtcp._bit_vec(o, w))(jnp.asarray(off))),
        u64(ttcp._bit_vec(torch.from_numpy(off), w)))
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(jtcp._bit_test)(jo, jnp.asarray(off))),
        ttcp._bit_test(to, torch.from_numpy(off)).numpy())


# -- rows of the [H, S] table ------------------------------------------------
def random_tcb(h, s, w, rng):
    """The same random [H, S] TCB in both packages."""
    tcb = ttcp.TCB.create(h, s, wnd_words=w, device="cpu")
    leaves = {}
    for f in dataclasses.fields(ttcp.TCB):
        a = getattr(tcb, f.name).numpy()
        if f.metadata.get("u64"):
            v = u64_words(a.size, seed=a.size)[:a.size].reshape(a.shape)
        elif a.dtype == np.bool_:
            v = rng.random(a.shape) < 0.5
        elif a.dtype == np.float32:
            v = rng.uniform(0, 100, a.shape).astype(np.float32)
        else:
            v = rng.integers(-50, 5000, a.shape).astype(a.dtype)
        leaves[f.name] = v
    j = jtcp.TCB(**{k: jnp.asarray(v) for k, v in leaves.items()})
    t = ttcp.TCB(**{k: (t64(v) if v.dtype == np.uint64
                        else torch.from_numpy(v)) for k, v in leaves.items()})
    return j, t


def tcb_leaves(tcb) -> dict:
    out = {}
    for f in dataclasses.fields(tcb):
        v = getattr(tcb, f.name)
        if isinstance(v, torch.Tensor):
            a = v.numpy()
            out[f.name] = a.view(np.uint64) if f.metadata.get("u64") else a
        else:
            out[f.name] = np.asarray(v)
    return out


def test_row_helpers_clamp_like_reference():
    rng = np.random.default_rng(3)
    h, s, w = 40, 5, 2
    jt, tt = random_tcb(h, s, w, rng)
    c = rng.integers(-3, s + 3, size=h).astype(np.int32)
    mask = rng.random(h) < 0.7
    jc, tc = jnp.asarray(c), torch.from_numpy(c)
    jrow = jax.vmap(jtcp._row)(jt, jc)
    trow = ttcp._row(tt, tc)
    assert_leaves_equal(tcb_leaves(jrow), tcb_leaves(trow))
    # write another host's row back, masked
    perm = rng.permutation(h)
    jnew = jax.tree.map(lambda a: a[perm], jrow)
    tnew = ttcp.TCB(**{f.name: getattr(trow, f.name)[torch.from_numpy(perm)]
                       for f in dataclasses.fields(ttcp.TCB)})
    jw = jax.vmap(jtcp._write_row)(jt, jc, jnew, jnp.asarray(mask))
    tw = ttcp._write_row(tt, tc, tnew, torch.from_numpy(mask))
    assert_leaves_equal(tcb_leaves(jw), tcb_leaves(tw))
    a = rng.integers(0, 99, size=(h, s)).astype(np.int32)
    v = rng.integers(0, 99, size=h).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(jtcp._sel)(jnp.asarray(a), jc)),
        ttcp._sel(torch.from_numpy(a), tc).numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(jtcp._put)(jnp.asarray(a), jc, jnp.asarray(v),
                                       jnp.asarray(mask))),
        ttcp._put(torch.from_numpy(a), tc, torch.from_numpy(v),
                  torch.from_numpy(mask)).numpy())


def test_tcb_create_and_convert():
    rcv = np.array([0, 1000, 1434 * 3, 10**9, 5, 0], np.int64)
    snd = np.array([0, 4096, 0, 70000, 1, 0], np.int64)
    jn = jstack.HostNet.create(6, 3, 1024.0, 1024.0, with_tcp=True,
                               rcv_wnd_bytes=rcv, wnd_words=2,
                               snd_buf_bytes=snd)
    tn = tstack.HostNet.create(6, 3, 1024.0, 1024.0, with_tcp=True,
                               rcv_wnd_bytes=rcv, wnd_words=2,
                               snd_buf_bytes=snd, device="cpu")
    assert_leaves_equal(tcb_leaves(jn.tcb), tcb_leaves(tn.tcb))
    jd = jtcp.TCB.create(4, 2).listen(1, 0)
    td = ttcp.TCB.create(4, 2, device="cpu").listen(1, 0)
    assert_leaves_equal(tcb_leaves(jd), tcb_leaves(td))
    assert tcb_leaves(td)["ooo"].dtype == np.uint64


def test_cubic_is_refused():
    # CUBIC is ported (F2 solved, tests/test_torch_cubic.py)
    assert ttcp.TCP(cc="cubic").cc is ttcp.CubicCC
    with pytest.raises(KeyError):
        ttcp.TCP(cc="vegas")
    assert ttcp.TCP(cc="aimd").cc is ttcp.AimdCC
    assert ttcp.TCP().min_max_emit(3) == jtcp.TCP().min_max_emit(3)


# -- the tests/test_tcp.py scenarios -----------------------------------------
def run_both(jbuild, tbuild, stop_ns, **kw):
    """(JAX leaves, port leaves, port engine) of one scenario."""
    eng, st = jbuild(**kw)
    lj = jax_leaves(jax.jit(eng.run)(st, jnp.int64(stop_ns)))
    teng, tst = tbuild(**kw)
    lt = convert.engine_state_to_numpy(teng.run(tst, stop_ns))
    assert_leaves_equal(lj, lt)
    return lj, lt, teng


SCENARIOS = {
    # name: (keywords, stop seconds)
    "bulk_lossless_full_close": ({}, 70),
    "bulk_lossy": (dict(total=50_000, reliability=0.85, seed=11), 20),
    "request_response": (dict(total=100, reply=200, close_after_send=False),
                         70),
    "partial_refill": (dict(total=100, second_send=2000,
                            close_after_send=False), 30),
}


@functools.lru_cache(maxsize=None)
def scenario_run(name):
    """run_both of a SCENARIOS entry, once per file."""
    kw, stop_s = SCENARIOS[name]
    return run_both(jtcp_tests.build, build_pair, stop_s * SECOND, **kw)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_matches_reference(name):
    lj, _, _ = scenario_run(name)
    rx = lj["hosts.app.rx"]
    state = lj["hosts.net.tcb.state"]
    retx = lj["hosts.net.tcb.n_retx"]
    if name == "bulk_lossless_full_close":
        assert rx[1] == 100_000 and retx.sum() == 0
        assert state[0, 0] == state[1, 1] == ttcp.CLOSED
        assert state[1, 0] == ttcp.LISTEN
    elif name == "bulk_lossy":
        assert rx[1] == 50_000 and retx[0, 0] > 0
        assert lj["hosts.net.tcb.ssthresh"][0, 0] < ttcp.INIT_SSTHRESH
    elif name == "request_response":
        assert (rx[0], rx[1]) == (200, 100)
        assert state[0, 0] == state[1, 1] == ttcp.CLOSED
    else:
        assert rx[1] == 2100


@pytest.mark.parametrize("seed", [
    1, pytest.param(2, marks=pytest.mark.slow),
    pytest.param(4, marks=pytest.mark.slow)])
def test_heavy_loss_request_response(seed):
    """30% loss: the passive-open child's own RTO timer retransmits the
    reply and FIN (tests/test_tcp.py's heavy-loss regression)."""
    lj, _, _ = run_both(jtcp_tests.build, build_pair, 120 * SECOND,
                        total=100, reply=5000, reliability=0.7,
                        close_after_send=False, seed=seed)
    assert lj["hosts.app.rx"].tolist() == [5000, 100]


def test_two_runs_one_state():
    """A second port build of the lossy bulk scenario runs to the state
    of the first (and of the reference, shared with its scenario test),
    with a plausible smoothed RTT."""
    kw, stop_s = SCENARIOS["bulk_lossy"]
    lj, lt, _ = scenario_run("bulk_lossy")
    eng, st = build_pair(**kw)
    assert_leaves_equal(lt, convert.engine_state_to_numpy(
        eng.run(st, stop_s * SECOND)))
    srtt = lj["hosts.net.tcb.srtt"][0, 0]
    assert 15 * MS < srtt < 200 * MS


# (drop time ms, server slot lost): the listener before the SYN, or the
# connection's child slot with data in flight
RST_CASES = {"refused": (0, 0), "reset": (50, 1)}


@functools.lru_cache(maxsize=None)
def jax_rst_pair():
    """The reference's two-host pair with TCP(rst_on_unmatched=True) and
    its jitted run, built and compiled once for both RST cases."""
    make_tcp = jtcp_tests.TCP
    jtcp_tests.TCP = functools.partial(jtcp.TCP, rst_on_unmatched=True)
    try:
        eng, st = jtcp_tests.build()
    finally:
        jtcp_tests.TCP = make_tcp
    return st, jax.jit(eng.run)


@pytest.mark.parametrize("case", list(RST_CASES))
def test_rst_on_unmatched_matches_reference(case):
    """TCP(rst_on_unmatched=True), the knob the reference turns on for
    crash faults: the server loses a socket slot (`forget_socket`) and
    the client's next segment draws an RST, so the client closes at
    once, with no retransmission, where without the knob it would
    retransmit into the void."""
    drop_ms, slot = RST_CASES[case]
    jput = lambda a, h, s, v: a.at[h, s].set(v)
    stop = 2 * SECOND
    st, run = jax_rst_pair()
    if drop_ms:
        st = run(st, jnp.int64(drop_ms * MS))
    lj = jax_leaves(run(forget_socket(st, 1, slot, jput), jnp.int64(stop)))
    teng, tst = build_pair(rst_on_unmatched=True)
    if drop_ms:
        tst = teng.run(tst, drop_ms * MS)
    lt = convert.engine_state_to_numpy(
        teng.run(forget_socket(tst, 1, slot, put_torch), stop))
    assert_leaves_equal(lj, lt)
    assert lj["hosts.net.tcb.state"][0, 0] == ttcp.CLOSED
    assert lj["hosts.net.tcb.n_retx"][0, 0] == 0
    rx = lj["hosts.app.rx"][1]
    assert (0 < rx < 100_000) if drop_ms else rx == 0
