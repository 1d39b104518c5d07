"""The UDP tier of shadow_tpu_torch against shadow_tpu, leaf for leaf.

- NIC and CoDel over [H] rows: the build-time f64 rate and burst, the
  virtual clock's admit and backlog casts over sweeps of rates and
  sizes, and the CoDel cases of tests/test_udp_stack.py;
- F3, CoDel's control law: the port's `_control_law` against the
  compiled reference on every count 1..2^24, on a sample above and at
  the int32 extremes, with the sha256 of the reference's bytes pinned;
- socket demux precedence with ties and all-zero scores, and packet
  encode/decode round trips;
- the echo model of tests/test_udp_stack.py, written once per package
  (per host for the reference, batched over [H] here): the echo end to
  end, bandwidth slowing delivery, bootstrap mode and an overload flood
  that drives CoDel to drop with count >= 6, in both `fuse_rx` modes and
  all three rx queue managers.

Every comparison is exact, dtypes included.
"""

import dataclasses
import functools
import hashlib
import platform
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_tpu.core import engine as jengine
from shadow_tpu.core.events import Events as JEvents
from shadow_tpu.host import nic as jnic
from shadow_tpu.host import sockets as jsock
from shadow_tpu.transport import stack as jstack
from shadow_tpu_torch import convert
from shadow_tpu_torch.core import engine as tengine
from shadow_tpu_torch.core.events import Events as TEvents
from shadow_tpu_torch.host import nic as tnic
from shadow_tpu_torch.host import sockets as tsock
from shadow_tpu_torch.transport import stack as tstack
from shadow_tpu_torch.transport import tcp as ttcp
from test_torch_phold import (  # noqa: F401 (one_torch_thread: autouse)
    assert_leaves_equal, jax_leaves, one_torch_thread)

MS = 1_000_000
SECOND = 1_000_000_000

# sha256 of the reference's int64 `_control_law(0, count)` bytes for
# count = 1 .. 2^24 (jax 0.9.0, CPU, x86: XLA's rsqrt from `rsqrtps`)
F3_SHA256 = "dd9b4d4ce611d3010d439259ec66f42c7787a01a9f2260bbd04a140089b3c805"


def cpu_has_avx512() -> bool:
    cpu = Path("/proc/cpuinfo")
    return (platform.machine() in ("x86_64", "AMD64") and cpu.exists()
            and "avx512f" in cpu.read_text().split())


# F3: the port's CoDel replays the x86 rsqrt estimates that XLA emits for
# the control law on an AVX-512 CPU (`nic.xla_rsqrt_f32`,
# `nic.engine_wide_rows`). On another CPU the compiled reference computes
# other drop times, so the tests that hold the two against each other
# where the law runs need that CPU.
REFERENCE_AVX512 = pytest.mark.skipif(
    not cpu_has_avx512(),
    reason="CoDel's control law is pinned to XLA's rsqrt on an x86 CPU "
           "with AVX-512 (F3); the reference here compiles it otherwise")


def leaves_of(obj) -> dict:
    """A dataclass tree of tensors or JAX arrays as numpy leaves by path."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if v is None:
            continue
        if dataclasses.is_dataclass(v):
            out.update({f"{f.name}.{k}": a for k, a in leaves_of(v).items()})
        else:
            out[f.name] = (v.numpy() if isinstance(v, torch.Tensor)
                           else np.asarray(v))
    return out


def assert_same(j, t):
    """Equal values and dtypes: dataclass trees, tuples or arrays."""
    if dataclasses.is_dataclass(t):
        assert_leaves_equal(leaves_of(j), leaves_of(t))
    elif isinstance(t, tuple):
        assert len(j) == len(t)
        for a, b in zip(j, t):
            assert_same(a, b)
    else:
        a, b = np.asarray(j), t.numpy()
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# -- NIC ---------------------------------------------------------------------
def bandwidths(n=4096, seed=1):
    """KiB/s values a config can give: round ones and random floats."""
    rng = np.random.default_rng(seed)
    fixed = [1.0, 16.0, 64.0, 1024.0, 10240.0, 102400.0, 1e6, 3.0, 7.5]
    rand = np.exp(rng.uniform(0, np.log(1e7), n - len(fixed)))
    return np.concatenate([fixed, rand]).astype(np.float64)


def test_nic_create_matches_reference():
    """The f64 rate and burst built at build time, eagerly in both."""
    bw = bandwidths()
    buf = np.arange(bw.size, dtype=np.int64) * 97
    assert_same(jnic.NIC.create(jnp.asarray(bw), buf_bytes=jnp.asarray(buf)),
                tnic.NIC.create(torch.from_numpy(bw),
                                buf_bytes=torch.from_numpy(buf)))
    assert_same(jnic.NIC.create(jnp.asarray(bw), burst_bytes=1500),
                tnic.NIC.create(torch.from_numpy(bw), burst_bytes=1500))


def test_nic_virtual_clock_over_rows():
    """tests/test_udp_stack.py's admit sequence, over [H] rows of
    different bandwidths, each step's NIC and times equal."""
    bw = bandwidths(64)
    seq = [(0, 1049, False), (0, 1049, False), (10 * SECOND, 1049, False),
           (10 * SECOND, 999999, True), (10 * SECOND + 7, 43, False)]

    @jax.jit
    def jrun(nic):
        outs = []
        for t, nb, unl in seq:
            nic, s, f = nic.admit(jnp.int64(t), jnp.int32(nb), unl)
            outs.append((nic, s, f))
        return outs

    jouts = jrun(jnic.NIC.create(jnp.asarray(bw)))
    nic = tnic.NIC.create(torch.from_numpy(bw))
    h = bw.size
    for (t, nb, unl), jout in zip(seq, jouts):
        nic, s, f = nic.admit(torch.full((h,), t, dtype=torch.int64),
                              torch.full((h,), nb, dtype=torch.int32),
                              torch.full((h,), unl))
        assert_same(jout, (nic, s, f))
    assert int(jouts[1][1][4]) == int(jouts[0][2][4])  # back to back


def test_admit_and_backlog_casts_over_a_sweep():
    """admit's f32(bytes) / rate -> i64 and backlog's f32(lag) * rate ->
    i64, compiled in the reference, over random rates, sizes and lags."""
    rng = np.random.default_rng(7)
    n = 1 << 14
    bw = bandwidths(n, seed=3)
    nbytes = rng.integers(1, 1 << 24, size=n).astype(np.int32)
    t = rng.integers(0, 1 << 40, size=n).astype(np.int64)
    free = t + rng.integers(-(1 << 30), 1 << 36, size=n)

    @jax.jit
    def jcasts(nic, t, nb):
        nic = dataclasses.replace(nic, free_at=free)
        return nic.admit(t, nb), nic.backlog_bytes(t)

    jout = jcasts(jnic.NIC.create(jnp.asarray(bw)), jnp.asarray(t),
                  jnp.asarray(nbytes))
    nic = dataclasses.replace(tnic.NIC.create(torch.from_numpy(bw)),
                              free_at=torch.from_numpy(free))
    tt = torch.from_numpy(t)
    tout = (nic.admit(tt, torch.from_numpy(nbytes),
                      torch.zeros(n, dtype=torch.bool)),
            nic.backlog_bytes(tt))
    assert_same(jout, tout)


# -- CoDel -------------------------------------------------------------------
CODEL_T, CODEL_I = jnic.CODEL_TARGET, jnic.CODEL_INTERVAL


def codel_sequence(h):
    """tests/test_udp_stack.py's CoDel case, then a long above-target run
    (drops re-scheduled by the control law past count 19, where the two
    x86 rsqrt estimates part) and a resume; row r is shifted by r ms and
    sees its own sojourns."""
    base = SECOND
    steps = [(i * MS, CODEL_T // 2) for i in range(5)]
    steps += [(base, 2 * CODEL_T), (base + CODEL_I // 2, 2 * CODEL_T),
              (base + CODEL_I + 1, 2 * CODEL_T),
              (base + CODEL_I + 2, CODEL_T // 2)]
    steps += [(base + 2 * CODEL_I + i * 9 * MS, 3 * CODEL_T)
              for i in range(150)]
    steps += [(base + 17 * CODEL_I, CODEL_T // 3),
              (base + 17 * CODEL_I + 1, 2 * CODEL_T)]
    steps += [(base + 17 * CODEL_I + i * 7 * MS, 2 * CODEL_T)
              for i in range(2, 60)]
    shift = np.arange(h, dtype=np.int64) * MS
    soj_scale = 1 + (np.arange(h) % 3)
    return [(t + shift, np.int64(s) * soj_scale // 2 + CODEL_T // 4)
            for t, s in steps]


@functools.lru_cache(maxsize=None)
def codel_step():
    """One compiled CoDel dequeue of the reference."""
    return jax.jit(lambda cd, now, soj: cd.on_dequeue(now, soj))


@REFERENCE_AVX512
@pytest.mark.parametrize("h", [2, 16, 48])
def test_codel_over_rows_matches_reference(h):
    """Each dequeue of the sequence, compiled in the reference, against
    the port: at 2 rows (scalar code), 16 and 48 (16-lane vectors)."""
    step = codel_step()
    jcd = jnic.CoDel.create(h)
    cd = tnic.CoDel.create(h, device="cpu")
    drops, top = [], 0
    for now, soj in codel_sequence(h):
        jcd, jdrop = step(jcd, jnp.asarray(now), jnp.asarray(soj))
        cd, drop = cd.on_dequeue(torch.from_numpy(now),
                                 torch.from_numpy(soj))
        assert_same((jcd, jdrop), (cd, drop))
        drops.append(bool(drop[0]))
        top = max(top, int(cd.count.max()))
    assert top >= 25  # the law ran past count 19
    # the reference's own single-row case: no drop inside the interval,
    # then a drop, and a below-target packet ends the episode
    assert drops[:9] == [False] * 7 + [True, False]


@REFERENCE_AVX512
@pytest.mark.parametrize("h", [1, 2, 8, 15, 16, 17, 23, 24, 31, 32, 40, 48,
                               63, 64, 72, 127, 168, 175, 183, 184, 200,
                               1000, 4100])
def test_codel_rsqrt_estimate_follows_the_reference_loop(h):
    """Whether a row's control law ran in a 16-lane loop (the 14-bit
    estimate) or not shows at count 19: the port's `engine_wide_rows`
    picks what the reference's compiled dequeue did, row by row."""
    cnt = np.full(h, 18, np.int32)  # the in-drop step computes count 19
    kw = dict(dropping=np.ones(h, bool), count=cnt,
              first_above=np.full(h, 5, np.int64),
              drop_next=np.full(h, 100, np.int64))
    now, soj = np.full(h, SECOND, np.int64), np.full(h, CODEL_I, np.int64)
    jcd, _ = codel_step()(jnic.CoDel(**{k: jnp.asarray(v)
                                        for k, v in kw.items()}),
                          jnp.asarray(now), jnp.asarray(soj))
    tcd, _ = tnic.CoDel(**{k: torch.from_numpy(v) for k, v in kw.items()}
                        ).on_dequeue(torch.from_numpy(now),
                                     torch.from_numpy(soj))
    assert_same(jcd.drop_next, tcd.drop_next)


# -- F3: the control law's rsqrt ---------------------------------------------
@REFERENCE_AVX512
def test_control_law_matches_compiled_reference_exhaustively():
    """Every count 1..2^24 (f32 is exact there), a sample above, and the
    int32 extremes: the port's law equals `jax.jit(_control_law)`, which
    runs 8-lane vectors and scalar code (the 12-bit estimate)."""
    law = jax.jit(jnic._control_law)
    counts = np.arange(1, (1 << 24) + 1, dtype=np.int32)
    want = np.asarray(law(jnp.zeros(counts.size, jnp.int64),
                          jnp.asarray(counts)))
    assert hashlib.sha256(want.tobytes()).hexdigest() == F3_SHA256
    got = tnic._control_law(torch.zeros(counts.size, dtype=torch.int64),
                            torch.from_numpy(counts)).numpy()
    np.testing.assert_array_equal(got, want)
    # count 6: torch's correctly rounded 1e8 / sqrt(6) gives 40,824,828
    assert got[5] == 40_824_832

    rng = np.random.default_rng(11)
    above = np.concatenate([
        rng.integers(1 << 24, (1 << 31) - 1, size=1 << 16),
        [(1 << 31) - 1, 0, -1, -(1 << 31)]]).astype(np.int32)
    t = rng.integers(0, 1 << 50, size=above.size).astype(np.int64)
    np.testing.assert_array_equal(
        tnic._control_law(torch.from_numpy(t), torch.from_numpy(above)),
        np.asarray(law(jnp.asarray(t), jnp.asarray(above))))


RSQRT14_PROBE = r"""
#include <immintrin.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>
/* vrsqrt14ps of every f32 in [1, 4), as raw bits, to argv[1] */
int main(int argc, char **argv) {
  static uint32_t out[1 << 24];
  for (uint32_t i = 0; i < (1u << 24); i += 16) {
    uint32_t b[16];
    float x[16];
    for (int j = 0; j < 16; j++) b[j] = 0x3F800000u + i + j;
    memcpy(x, b, sizeof x);
    _mm512_storeu_ps((float *)(out + i), _mm512_rsqrt14_ps(_mm512_loadu_ps(x)));
  }
  FILE *f = fopen(argv[1], "wb");
  fwrite(out, 4, 1 << 24, f);
  return fclose(f);
}
"""


@REFERENCE_AVX512
def test_rsqrt14_table_matches_the_instruction(tmp_path):
    """The port's `vrsqrt14ps` table against the instruction itself on
    every f32 in [1, 4) (the estimate scales by 2^-k for x * 4^k), where
    a C compiler is at hand."""
    cc = shutil.which("gcc") or shutil.which("cc")
    if cc is None:
        pytest.skip("needs a C compiler")
    src, exe, out = (tmp_path / "probe.c", tmp_path / "probe",
                     tmp_path / "rsqrt14.bin")
    src.write_text(RSQRT14_PROBE)
    subprocess.run([cc, "-O2", "-mavx512f", str(src), "-o", str(exe)],
                   check=True, timeout=120)
    subprocess.run([str(exe), str(out)], check=True, timeout=120)
    want = np.fromfile(out, np.uint32)
    bits = (torch.arange(1 << 24, dtype=torch.int64) + 0x3F800000).to(
        torch.int32)
    got = tnic._rsqrt14_estimate(bits.view(torch.float32))
    np.testing.assert_array_equal(
        got.view(torch.int32).numpy().view(np.uint32), want)


# -- sockets and packets -----------------------------------------------------
def socket_table(pkg, dev):
    """Slots with ties: two wildcard :80 binds, two connected :80 binds
    to the same peer, a TCP :80 and a wildcard :81."""
    kw = {} if dev is None else {"device": dev}
    tab = pkg.SocketTable.create(3, 6, **kw)
    udp = pkg.PROTO_UDP
    for row in range(3):
        tab = tab.bind(row, 1, udp, 80)
        tab = tab.bind(row, 4, udp, 80)  # tie with slot 1
        tab = tab.bind(row, 2, udp, 80, peer_host=7, peer_port=555)
        tab = tab.bind(row, 5, udp, 80, peer_host=7, peer_port=555)  # tie
        tab = tab.bind(row, 0, pkg.PROTO_TCP, 80)
        tab = tab.bind(row, 3, udp, 81 + row)
    return tab


def test_socket_demux_precedence_with_ties():
    jt, tt = socket_table(jsock, None), socket_table(tsock, "cpu")
    assert_same(jt, tt)
    cases = np.array([
        # proto, dport, src_host, src_port
        (1, 80, 7, 555),  # connected beats wildcard; first of the tie: 2
        (1, 80, 3, 555),  # wildcard; first of the tie: 1
        (1, 80, 7, 556),  # peer port differs: wildcard
        (2, 80, 7, 555),  # the TCP slot: 0
        (1, 81, 0, 0),  # row 0 binds :81 at slot 3, the others do not
        (1, 99, 7, 555),  # no socket: all-zero scores give -1
        (0, 0, -1, 0),  # a closed slot's key never matches
    ], np.int32)
    rows = np.repeat(np.arange(3), len(cases))
    c = np.tile(cases, (3, 1))
    jrow = jax.tree.map(lambda a: a[rows], jt)
    want = jax.vmap(lambda tab, *k: tab.demux(*k))(
        jrow, *[jnp.asarray(c[:, i]) for i in range(4)])
    trow = tsock.SocketTable(**{k: v[torch.from_numpy(rows)]
                                for k, v in dataclasses.asdict(tt).items()})
    got = trow.demux(*[torch.from_numpy(c[:, i]) for i in range(4)])
    assert_same(want, got)
    assert got[:7].tolist() == [2, 1, 1, 0, 3, -1, -1]
    assert got[11].item() == -1  # row 1 has no :81 bind


def test_socket_counters_match_reference():
    jt, tt = socket_table(jsock, None), socket_table(tsock, "cpu")
    slots = np.array([2, -1, 5], np.int32)
    nb = np.array([100, 7, 1 << 20], np.int32)
    jrx = jax.vmap(lambda t, s, n: t.add_rx(s, n).add_tx(s, 2 * n))(
        jt, jnp.asarray(slots), jnp.asarray(nb))
    trx = tt.add_rx(torch.from_numpy(slots), torch.from_numpy(nb)).add_tx(
        torch.from_numpy(slots), 2 * torch.from_numpy(nb))
    assert_same(jrx, trx)


def test_pkt_encode_decode_round_trip():
    rng = np.random.default_rng(5)
    n = 512
    f = {k: rng.integers(-(1 << 31), 1 << 31, size=n).astype(np.int32)
         for k in ("sport", "dport", "seq", "ack", "wnd", "aux")}
    f["length"] = (rng.integers(0, 1 << 24, size=n)
                   | (rng.integers(0, 128, size=n) << 24)).astype(np.int32)
    proto = rng.integers(0, 3, size=n).astype(np.int32)
    flags = (rng.integers(0, 32, size=n) << 2).astype(np.int32)
    sack = rng.integers(0, 1 << 63, size=n, dtype=np.uint64) * 2 + 1
    jargs = jax.vmap(lambda p, fl, sk, kw: jstack.Pkt.encode_args(
        p, flags=fl, sack=sk, **kw))(
        jnp.asarray(proto), jnp.asarray(flags), jnp.asarray(sack),
        {k: jnp.asarray(v) for k, v in f.items()})
    targs = tstack.Pkt.encode_args(
        torch.from_numpy(proto), flags=torch.from_numpy(flags),
        sack=torch.from_numpy(sack.view(np.int64)),
        **{k: torch.from_numpy(v) for k, v in f.items()})
    assert_same(jargs, targs)
    src = rng.integers(0, 4096, size=n).astype(np.int32)
    ev = dict(time=np.zeros(n, np.int64), dst=src, src=src,
              seq=np.zeros(n, np.int32), kind=np.ones(n, np.int32))
    args = np.asarray(jargs).copy()
    args[:, jstack.A_SRC] = src
    jp = jax.vmap(jstack.Pkt.decode)(JEvents(
        **{k: jnp.asarray(v) for k, v in ev.items()}, args=jnp.asarray(args)))
    tp = tstack.Pkt.decode(TEvents(
        **{k: torch.from_numpy(v) for k, v in ev.items()},
        args=torch.from_numpy(args)))
    lj, lt = leaves_of(jp), leaves_of(tp)
    # the SACK bitmap is the reference's u64, held here as int64 bits
    assert lj.pop("sack").view(np.int64).tolist() == lt.pop("sack").tolist()
    assert_leaves_equal(lj, lt)
    assert lt["length"].tolist() == (f["length"] & 0xFFFFFF).tolist()


# -- the echo model ----------------------------------------------------------
KIND_APP_SEND = jstack.N_STACK_KINDS
ECHO_PORT, CLIENT_PORT = 80, 10_000
# name: (datagrams, payload B, interval, (up KiB/s per host),
#        (down KiB/s per host), echo, bootstrap_end, latency, capacity,
#        sockets, seed, stop)
SCENARIOS = {
    "echo": (5, 1000, 20 * MS, (1024.0, 1024.0), (1024.0, 1024.0), True,
             0, 10 * MS, 64, 4, 3, 2 * SECOND),
    "bandwidth": (1, 1000, 20 * MS, (16.0, 16.0), (16.0, 16.0), True, 0,
                  10 * MS, 64, 4, 3, 2 * SECOND),
    "bootstrap": (1, 1000, 20 * MS, (16.0, 16.0), (16.0, 16.0), True,
                  5 * SECOND, 10 * MS, 64, 4, 3, 2 * SECOND),
    # tests/test_udp_stack.py's flood, 600 datagrams instead of 400: a
    # thin server downlink builds sojourn until CoDel drops
    "flood": (600, 1400, MS // 2, (10_000.0, 10_000.0), (10_000.0, 64.0),
              False, 0, 10 * MS, 1024, 2, 5, 3 * SECOND),
}


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class JEcho:
    sent: jax.Array
    echoed: jax.Array
    acked: jax.Array
    last_rx_time: jax.Array


@dataclasses.dataclass(frozen=True)
class TEcho:
    sent: torch.Tensor
    echoed: torch.Tensor
    acked: torch.Tensor
    last_rx_time: torch.Tensor


def jax_echo(name, fuse_rx, rx_queue):
    """The reference's echo: host 0 sends to host 1:80 every interval,
    host 1 echoes back (or only counts, in the flood)."""
    (n_dg, payload, every, up, down, echo, boot, lat, cap, socks, seed,
     _) = SCENARIOS[name]
    stack = jstack.Stack(bootstrap_end=boot, rx_queue=rx_queue,
                         fuse_rx=fuse_rx)

    def on_recv(hs, slot, pkt, now, key):
        app = hs.app
        got = slot >= 0
        hs2, em = stack.send_udp(
            hs, now, slot, pkt.src_host, pkt.src_port, pkt.length,
            mask=got & (slot == 0) & (pkt.dst_port == ECHO_PORT) & echo)
        app = JEcho(
            sent=app.sent,
            echoed=app.echoed + jnp.where(
                got & (pkt.dst_port == ECHO_PORT), 1, 0),
            acked=app.acked + jnp.where(
                got & (pkt.dst_port != ECHO_PORT), 1, 0),
            last_rx_time=jnp.maximum(app.last_rx_time, now))
        return dataclasses.replace(hs2, app=app), em

    def on_app_send(hs, ev, key):
        app = hs.app
        hs, em_pkt = stack.send_udp(hs, ev.time, 0, jnp.int32(1),
                                    ECHO_PORT, payload)
        em_next = jengine.Emit.single(
            dst=ev.dst, dt=every, kind=KIND_APP_SEND,
            mask=app.sent + 1 < n_dg, local=True,
            n_args=jstack.N_PKT_ARGS)
        app = dataclasses.replace(app, sent=app.sent + 1)
        em = jax.tree.map(lambda a, b: jnp.concatenate([a, b]), em_pkt,
                          em_next)
        return dataclasses.replace(hs, app=app), em

    cfg = jengine.EngineConfig(n_hosts=2, capacity=cap, lookahead=lat,
                               max_emit=2, n_args=jstack.N_PKT_ARGS,
                               seed=seed)
    eng = jengine.Engine(cfg, stack.make_handlers(on_recv) + [on_app_send],
                         jengine.ConstantNetwork(lat))
    net = jstack.HostNet.create(2, socks, jnp.asarray(up), jnp.asarray(down))
    tab = net.sockets.bind(1, 0, jsock.PROTO_UDP, ECHO_PORT).bind(
        0, 0, jsock.PROTO_UDP, CLIENT_PORT)
    z = jnp.zeros((2,), jnp.int64)
    hosts = jstack.SimHost(net=dataclasses.replace(net, sockets=tab),
                           app=JEcho(z, z, z, z))
    init = jax.tree.map(jnp.asarray, JEvents(**echo_initial()))
    return eng, eng.init_state(hosts, init)


def torch_echo(name, fuse_rx, rx_queue):
    """The same echo, batched over the two hosts."""
    (n_dg, payload, every, up, down, echo, boot, lat, cap, socks, seed,
     _) = SCENARIOS[name]
    stack = tstack.Stack(bootstrap_end=boot, rx_queue=rx_queue,
                         fuse_rx=fuse_rx)
    i64 = torch.int64

    def on_recv(hs, slot, pkt, now, key):
        app = hs.app
        got = slot >= 0
        hs2, em = stack.send_udp(
            hs, now, slot, pkt.src_host, pkt.src_port, pkt.length,
            mask=got & (slot == 0) & (pkt.dst_port == ECHO_PORT) & echo)
        app = TEcho(
            sent=app.sent,
            echoed=app.echoed + (got & (pkt.dst_port == ECHO_PORT)).to(i64),
            acked=app.acked + (got & (pkt.dst_port != ECHO_PORT)).to(i64),
            last_rx_time=torch.maximum(app.last_rx_time, now))
        return dataclasses.replace(hs2, app=app), em

    def on_app_send(hs, ev, key):
        app = hs.app
        hs, em_pkt = stack.send_udp(hs, ev.time, 0, 1, ECHO_PORT, payload)
        em_next = tengine.Emit.single(
            dst=ev.dst, dt=every, kind=KIND_APP_SEND,
            mask=app.sent + 1 < n_dg, local=True,
            n_args=tstack.N_PKT_ARGS)
        app = dataclasses.replace(app, sent=app.sent + 1)
        em = tengine.Emit(**{
            f.name: torch.cat([getattr(em_pkt, f.name),
                               getattr(em_next, f.name)], dim=1)
            for f in dataclasses.fields(tengine.Emit)})
        return dataclasses.replace(hs, app=app), em

    cfg = tengine.EngineConfig(n_hosts=2, capacity=cap, lookahead=lat,
                               max_emit=2, n_args=tstack.N_PKT_ARGS,
                               seed=seed)
    eng = tengine.Engine(cfg, stack.make_handlers(on_recv) + [on_app_send],
                         tengine.ConstantNetwork(lat), device="cpu")
    net = tstack.HostNet.create(2, socks, up, down, device="cpu")
    tab = net.sockets.bind(1, 0, tsock.PROTO_UDP, ECHO_PORT).bind(
        0, 0, tsock.PROTO_UDP, CLIENT_PORT)
    z = torch.zeros((2,), dtype=i64)
    hosts = tstack.SimHost(net=dataclasses.replace(net, sockets=tab),
                           app=TEcho(z, z, z, z))
    init = TEvents(**{k: torch.from_numpy(v)
                      for k, v in echo_initial().items()})
    return eng, eng.init_state(hosts, init)


def echo_initial() -> dict:
    """One KIND_APP_SEND at 1 ms on host 0."""
    return dict(time=np.array([MS], np.int64), dst=np.zeros(1, np.int32),
                src=np.zeros(1, np.int32), seq=np.zeros(1, np.int32),
                kind=np.array([KIND_APP_SEND], np.int32),
                args=np.zeros((1, jstack.N_PKT_ARGS), np.int32))


@functools.lru_cache(maxsize=None)
def echo_both(name, fuse_rx, rx_queue):
    stop = SCENARIOS[name][-1]
    ej, sj = jax_echo(name, fuse_rx, rx_queue)
    lj = jax_leaves(jax.jit(ej.run)(sj, jnp.int64(stop)))
    et, st = torch_echo(name, fuse_rx, rx_queue)
    lt = convert.engine_state_to_numpy(et.run(st, stop))
    return lj, lt


MODES = [(f, q) for f in (True, False) for q in ("codel", "static",
                                                  "single")]
# Each case pays a reference compile: tier 1 runs the
# echo and the flood on the default stack (fused, CoDel), the rest run
# with the slow tests. The floods under CoDel run its control law.
TIER1_ECHO = {("echo", True, "codel"), ("flood", True, "codel")}
ECHO_CASES = [
    pytest.param(name, f, q,
                 marks=(() if (name, f, q) in TIER1_ECHO
                        else (pytest.mark.slow,))
                 + ((REFERENCE_AVX512,) if (name, q) == ("flood", "codel")
                    else ()),
                 id=f"{name}-{'fused' if f else 'unfused'}-{q}")
    for name in SCENARIOS for f, q in MODES
]


@pytest.mark.parametrize("name,fuse_rx,rx_queue", ECHO_CASES)
def test_echo_matches_reference(name, fuse_rx, rx_queue):
    lj, lt = echo_both(name, fuse_rx, rx_queue)
    assert_leaves_equal(lj, lt)
    n_dg = SCENARIOS[name][0]
    sent, echoed, acked, last = (lt[f"hosts.app.{k}"] for k in (
        "sent", "echoed", "acked", "last_rx_time"))
    assert sent[0] == n_dg
    if name == "echo":
        assert echoed[1] == acked[0] == n_dg
        assert lt["hosts.net.sockets.rx_bytes"][1, 0] == 5 * 1000
        assert lt["hosts.net.sockets.tx_bytes"][1, 0] == 5 * 1000
        assert last[0] > 21 * MS
    elif name == "bandwidth":
        # 1042 wire bytes at 16 KiB/s take ~62 ms each way
        assert acked[0] == 1
        assert last[0] > MS + 2 * 10 * MS + 100 * MS
    elif name == "bootstrap":
        assert acked[0] == 1
        assert last[0] <= MS + 2 * 10 * MS + 10  # no serialization
    else:  # the flood
        codel = lt["hosts.net.codel.count"][1]
        drops = lt["hosts.net.nic_rx.drops"][1]
        if rx_queue == "static":  # an unbounded buffer and no AQM
            assert codel == drops == 0 < echoed[1] <= n_dg
        else:
            assert 0 < echoed[1] < n_dg
        if rx_queue == "codel":
            assert codel >= 6, "CoDel must reach count 6 (F3's range)"
        if rx_queue == "single":
            assert lt["hosts.net.nic_rx.drops"][1] > 0


def test_stack_unported_parts_raise():
    # packet capture is ported (tests/test_torch_pcap.py): a send appends
    # its tx record on the capturing sender's ring only, where it sends
    from shadow_tpu_torch.utils.pcap import CaptureRing, STG_SENT

    net = tstack.HostNet.create(2, 2, 1.0, 1.0, device="cpu")
    hs = tstack.SimHost(net=dataclasses.replace(
        net, cap=CaptureRing.create([True, False], ring=4)), app=None)
    hs2, _ = tstack.Stack().send_udp(
        hs, torch.zeros(2, dtype=torch.int64), 0, 1, 80, 100,
        mask=torch.tensor([True, True]))
    assert hs2.net.cap.wr.tolist() == [1, 0]
    assert hs2.net.cap.meta[0, 0, 4].item() >> 16 == STG_SENT
    hs3, _ = tstack.Stack().send_udp(
        hs2, torch.zeros(2, dtype=torch.int64), 0, 1, 80, 100,
        mask=torch.tensor([False, True]))
    assert hs3.net.cap.wr.tolist() == [1, 0]
    # the TCP stack is ported, CUBIC too (F2 solved)
    assert ttcp.TCP(cc="cubic").cc is ttcp.CubicCC
    with pytest.raises(ValueError):
        tstack.Stack(rx_queue="red")
