"""TCP as a connection-state table over [H, S] tensors.

The counterpart of `shadow_tpu.transport.tcp`, with NewReno, AIMD and
CUBIC congestion control. Sequence space is MSS-sized segments; the receive
reassembly buffer is a bitmap of W 64-bit words per connection, and the
in-order advance is the bitmap's run of trailing ones. Timers are events
carrying (slot, generation, kind); a timer whose generation no longer
matches the connection's is stale and ignored. Transmission is
ACK-clocked and self-kicked through KIND_TCP_TX continuations paced at
the tx NIC's free time. Delayed ACKs, receive-window autotuning, a SACK
scoreboard, a bounded send buffer and in-order app delivery follow the
reference line for line.

Every operation runs over all hosts at once: a "row" is one slot's
connection state on every host, a TCB of [H] tensors (`ooo` [H, W]),
read from and written to the [H, S] table by a per-host slot index.
Out-of-range slots clamp to the table, as JAX indexing does.

The reference's u64 bitmaps (`ooo`, `sacked`, a packet's SACK word) are
int64 tensors holding the same bits. Right shifts that the reference
does on u64 are logical here (`_shr`), the population count is a SWAR
sum, and every shift amount is kept inside [0, 63].

CUBIC's cube root is XLA's CPU `cbrt`, glibc's `powf(|x|, f32(1/3))`,
replayed bit for bit by `transport/cbrt.py` (a CUDA kernel on the card).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from shadow_tpu_torch.core.engine import BURST_NSEG_SHIFT, Emit, _select_rows
from shadow_tpu_torch.core.timebase import MILLISECOND, SECOND
from shadow_tpu_torch.host.nic import HEADER_TCP, MTU
from shadow_tpu_torch.host.sockets import PROTO_NONE, PROTO_TCP, PROTO_UDP
from shadow_tpu_torch.transport.cbrt import cbrt, fma_f32
from shadow_tpu_torch.transport.stack import (
    F_ACK,
    F_FIN,
    F_RETX,
    F_RST,
    F_SYN,
    KIND_PKT_ARRIVE,
    N_PKT_ARGS,
    N_STACK_KINDS,
    Pkt,
    _rows,
    _sel,
)

# App bytes per full segment (MTU less the TCP/IP/Ethernet headers).
MSS = MTU - HEADER_TCP  # 1434

# Connection states.
CLOSED = 0
LISTEN = 1
SYN_SENT = 2
SYN_RCVD = 3
ESTABLISHED = 4
FIN_WAIT_1 = 5
FIN_WAIT_2 = 6
CLOSE_WAIT = 7
CLOSING = 8
LAST_ACK = 9
TIME_WAIT = 10

# Timing constants.
RTO_INIT = SECOND
RTO_MIN = SECOND // 5
RTO_MAX = 120 * SECOND
TIME_WAIT_DELAY = 60 * SECOND
DELACK_DELAY = 40 * MILLISECOND
INIT_CWND = 10.0
# slow start runs until the first loss; the f32 value dwarfs CWND_MAX
INIT_SSTHRESH = float(1 << 30)
CWND_MAX = 1024.0
RCV_WND = 64  # segments: the initial advertised window
WND_WORDS = 4  # 64-bit words in the reassembly bitmap

# Event kinds of this module (after the stack's).
KIND_TCP_TIMER = N_STACK_KINDS  # 2
KIND_TCP_TX = N_STACK_KINDS + 1  # 3
N_TCP_KINDS = N_STACK_KINDS + 2

# Timer/kick event arg words.
T_SLOT = 0
T_GEN = 1
T_KIND = 2
TK_RTO = 0
TK_TIMEWAIT = 1
TK_DELACK = 2

_I32 = torch.int32
_I64 = torch.int64
_F32 = torch.float32
_MAX = (1 << 63) - 1  # u64 bits 0..62
# field metadata of the int64 tensors that hold a reference u64 leaf
U64 = {"u64": True}


@dataclasses.dataclass(frozen=True)
class TCB:
    """Connection state: [H, S] tensors at rest, [H] rows in handlers."""

    state: torch.Tensor  # i32
    snd_una: torch.Tensor  # i32 first unacked segment
    snd_nxt: torch.Tensor  # i32 next segment to send
    snd_buf: torch.Tensor  # i64 total bytes written by the app
    fin_pending: torch.Tensor  # bool app closed; FIN occupies seq n_segs
    rcv_nxt: torch.Tensor  # i32 next expected segment
    # [..., W] reassembly bitmap: bit i = segment rcv_nxt + i received
    ooo: torch.Tensor = dataclasses.field(metadata=U64)
    rfin_seq: torch.Tensor  # i32 peer FIN's seq (-1 none)
    partial_seq: torch.Tensor  # i32 last partial segment delivered
    partial_len: torch.Tensor  # i32 bytes delivered for it
    cwnd: torch.Tensor  # f32 congestion window (segments)
    ssthresh: torch.Tensor  # f32
    dup_acks: torch.Tensor  # i32
    recover: torch.Tensor  # i32 NewReno recovery point (-1 open)
    srtt: torch.Tensor  # i64 ns (0 = no sample yet)
    rttvar: torch.Tensor  # i64 ns
    rto: torch.Tensor  # i64 ns
    rto_deadline: torch.Tensor  # i64 current retransmit deadline
    timer_live: torch.Tensor  # bool a timer event is in flight
    timer_gen: torch.Tensor  # i32 generation for stale timers
    peer_wnd: torch.Tensor  # i32 advertised window (segments)
    n_retx: torch.Tensor  # i32 retransmitted segments
    rwnd: torch.Tensor  # i32 window we advertise (autotuned)
    rwnd_cap: torch.Tensor  # i32 autotune ceiling
    delack_segs: torch.Tensor  # i32 segments with an ACK owed
    delack_live: torch.Tensor  # bool a delack timer is in flight
    pend_echo: torch.Tensor  # i32 ts to echo in the next ACK
    rcv_ep_start: torch.Tensor  # i64 autotune epoch start (0 unset)
    rcv_ep_segs: torch.Tensor  # i32 segments delivered this epoch
    cc_wmax: torch.Tensor  # f32 cubic W_max
    cc_epoch: torch.Tensor  # i64 cubic epoch start (0 unset)
    conn_gen: torch.Tensor  # i32 slot incarnation
    # SACK scoreboard: bit i = segment snd_una + i received
    sacked: torch.Tensor = dataclasses.field(metadata=U64)
    snd_cap: torch.Tensor  # i64 send-buffer bytes (0 = unlimited)
    app_pending: torch.Tensor  # i64 app bytes waiting for room

    @staticmethod
    def create(n_hosts: int, n_sockets: int, rcv_wnd=None,
               wnd_words: int = WND_WORDS, snd_cap=None, *,
               device) -> "TCB":
        """The [H, S] table, every slot CLOSED. `rcv_wnd` ([H] segments,
        clipped to [1, 64 * wnd_words]) caps the autotuned window;
        `snd_cap` ([H] bytes) bounds the send buffer."""
        s = (n_hosts, n_sockets)
        full = lambda v, dtype: torch.full(s, v, dtype=dtype, device=device)
        per_host = lambda v, dtype: torch.as_tensor(v, dtype=dtype).to(
            device)[:, None].expand(s).contiguous()
        cap_max = 64 * wnd_words
        cap = (full(cap_max, _I32) if rcv_wnd is None else
               torch.clamp(per_host(rcv_wnd, _I32), 1, cap_max))
        zi, zl, zb = full(0, _I32), full(0, _I64), full(False, torch.bool)
        return TCB(
            state=zi, snd_una=zi, snd_nxt=zi, snd_buf=zl, fin_pending=zb,
            rcv_nxt=zi,
            ooo=torch.zeros(s + (wnd_words,), dtype=_I64, device=device),
            rfin_seq=full(-1, _I32), partial_seq=full(-1, _I32),
            partial_len=zi, cwnd=full(INIT_CWND, _F32),
            ssthresh=full(INIT_SSTHRESH, _F32), dup_acks=zi,
            recover=full(-1, _I32), srtt=zl, rttvar=zl,
            rto=full(RTO_INIT, _I64), rto_deadline=zl, timer_live=zb,
            timer_gen=zi, peer_wnd=full(RCV_WND, _I32), n_retx=zi,
            rwnd=torch.clamp(cap, max=RCV_WND), rwnd_cap=cap,
            delack_segs=zi, delack_live=zb, pend_echo=zi, rcv_ep_start=zl,
            rcv_ep_segs=zi, cc_wmax=full(0.0, _F32), cc_epoch=zl,
            conn_gen=zi, sacked=zl,
            snd_cap=zl if snd_cap is None else per_host(snd_cap, _I64),
            app_pending=zl,
        )

    def listen(self, host: int, slot: int) -> "TCB":
        """Build-time step: mark a listening socket (pair it with
        SocketTable.bind(host, slot, PROTO_TCP, port))."""
        state = self.state.clone()
        state[host, slot] = LISTEN
        return dataclasses.replace(self, state=state)


_FIELDS = tuple(f.name for f in dataclasses.fields(TCB))


def _row(tcb: TCB, c: torch.Tensor) -> TCB:
    """Slot c[h]'s row of host h, for every host: [H] fields (c clamps
    to the table, as JAX indexing does)."""
    idx = torch.clamp(c, 0, tcb.state.shape[1] - 1).long()[:, None]

    def pick(a):
        if a.dim() == 2:
            return torch.gather(a, 1, idx)[:, 0]
        return torch.gather(a, 1, idx[:, :, None].expand(
            -1, 1, a.shape[2]))[:, 0]

    return TCB(**{n: pick(getattr(tcb, n)) for n in _FIELDS})


def _slot_mask(c: torch.Tensor, s: int, mask) -> torch.Tensor:
    """bool[H, S]: slot c[h] of host h where mask[h]."""
    oh = (torch.arange(s, dtype=_I32, device=c.device)[None, :]
          == torch.clamp(c, 0, s - 1)[:, None])
    return oh & _rows(mask, c, torch.bool)[:, None]


def _write_row(tcb: TCB, c: torch.Tensor, new: TCB, mask,
               base: TCB | None = None) -> TCB:
    """Write row `new` into slot c[h] of every host h where mask[h].
    `base`, when given, is `_row(tcb, c)`: a field of `new` that is still
    base's tensor holds what the slot holds, so it is not written."""
    oh = _slot_mask(c, tcb.state.shape[1], mask)

    def put(name):
        a, n = getattr(tcb, name), getattr(new, name)
        if base is not None and n is getattr(base, name):
            return a
        n = n.to(a.dtype)
        if a.dim() == 2:
            return torch.where(oh, n[:, None], a)
        return torch.where(oh[:, :, None], n[:, None, :], a)

    return TCB(**{name: put(name) for name in _FIELDS})


def _put(a: torch.Tensor, c: torch.Tensor, v, mask) -> torch.Tensor:
    """a[h, c[h]] = v[h] where mask[h], on an [H, S] tensor; v is an
    [H] tensor or a Python scalar."""
    if isinstance(v, torch.Tensor):
        v = v.to(a.dtype)[:, None]
    return torch.where(_slot_mask(c, a.shape[1], mask), v, a)


def _fresh_row_like(old: TCB) -> TCB:
    """Default-valued row keeping timer_gen (so stale timers of a
    previous connection on the slot never match), the retransmit count
    and the per-host buffer caps; conn_gen moves on."""
    z32 = torch.zeros_like(old.state)
    z64 = torch.zeros_like(old.snd_buf)
    no = torch.zeros_like(old.fin_pending)
    neg = torch.full_like(old.state, -1)
    return TCB(
        state=z32, snd_una=z32, snd_nxt=z32, snd_buf=z64, fin_pending=no,
        rcv_nxt=z32, ooo=torch.zeros_like(old.ooo), rfin_seq=neg,
        partial_seq=neg, partial_len=z32,
        cwnd=torch.full_like(old.cwnd, INIT_CWND),
        ssthresh=torch.full_like(old.ssthresh, INIT_SSTHRESH),
        dup_acks=z32, recover=neg, srtt=z64, rttvar=z64,
        rto=torch.full_like(old.rto, RTO_INIT), rto_deadline=z64,
        timer_live=no, timer_gen=old.timer_gen,
        peer_wnd=torch.full_like(old.state, RCV_WND), n_retx=old.n_retx,
        rwnd=torch.clamp(old.rwnd_cap, max=RCV_WND), rwnd_cap=old.rwnd_cap,
        delack_segs=z32, delack_live=no, pend_echo=z32, rcv_ep_start=z64,
        rcv_ep_segs=z32, cc_wmax=torch.zeros_like(old.cc_wmax),
        cc_epoch=z64, conn_gen=old.conn_gen + 1, sacked=z64,
        snd_cap=old.snd_cap, app_pending=z64,
    )


def _n_segs(snd_buf):
    return ((snd_buf + MSS - 1) // MSS).to(_I32)


def _send_room(row: TCB, unlimited_default):
    """Free send-buffer bytes under snd_cap (0 = unlimited, giving the
    caller's default); only unacked bytes occupy the buffer."""
    acked = torch.minimum(row.snd_una.to(_I64) * MSS, row.snd_buf)
    return torch.where(
        row.snd_cap > 0,
        torch.clamp(row.snd_cap - (row.snd_buf - acked), min=0),
        unlimited_default,
    )


def _admit_bytes(row: TCB, add) -> TCB:
    """Admit `add` app bytes into snd_buf; a transmitted partial tail
    segment rewinds to go out again with its grown payload."""
    boundary = (row.snd_buf // MSS).to(_I32)
    rewind = (add > 0) & ((row.snd_buf % MSS) != 0) & (row.snd_nxt > boundary)
    nxt = torch.where(rewind, boundary, row.snd_nxt)
    return dataclasses.replace(
        row, snd_buf=row.snd_buf + add, snd_nxt=nxt,
        snd_una=torch.minimum(row.snd_una, nxt))


def _fin_ready(row: TCB):
    """The FIN takes its sequence slot only once every app byte, those
    waiting behind the send-buffer cap included, is in snd_buf."""
    return row.fin_pending & (row.app_pending == 0)


def _outstanding(row: TCB):
    """Whether the connection still needs timer coverage: unacked
    flight, unsent data or FIN, or a handshake in progress."""
    lim = _n_segs(row.snd_buf) + _fin_ready(row).to(_I32)
    return (
        (row.snd_nxt > row.snd_una)
        | ((row.snd_una < lim) & (row.state >= ESTABLISHED))
        | (row.app_pending > 0)
        | (row.state == SYN_SENT)
        | (row.state == SYN_RCVD)
    )


def _seg_len(snd_buf, s):
    return torch.clamp(snd_buf - s.to(_I64) * MSS, 0, MSS).to(_I32)


# -- u64 bitmaps in int64 ----------------------------------------------------
def _shr(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Logical right shift of u64 bits held in int64, n in [0, 63]."""
    return torch.where(n > 0, ((x >> 1) & _MAX) >> torch.clamp(n - 1, min=0),
                       x)


def _popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each u64 word held in int64, as i32 (SWAR; every
    arithmetic shift is masked, so bit 63 never smears)."""
    x = x - ((x >> 1) & 0x5555555555555555)
    x = (x & 0x3333333333333333) + ((x >> 2) & 0x3333333333333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F0F0F0F0F  # bytes <= 8: bit 63 clear
    x = x + (x >> 8)
    x = x + (x >> 16)
    x = x + (x >> 32)
    return (x & 0x7F).to(_I32)


def _trailing_ones(x: torch.Tensor) -> torch.Tensor:
    """Consecutive set bits from bit 0 of each u64 word (all ones: 64),
    the in-order advance of a reassembly word."""
    y = x + 1
    return _popcount((y & (~y + 1)) - 1)


def _trailing_ones_vec(ooo: torch.Tensor) -> torch.Tensor:
    """Trailing ones across an [H, W]-word bitmap (word 0 lowest): i32[H]."""
    t = _trailing_ones(ooo)
    full = (t == 64).to(_I32)
    # word i counts only if every lower word is saturated
    pre = torch.cat([torch.ones_like(full[:, :1]),
                     torch.cumprod(full[:, :-1], dim=1, dtype=_I32)], dim=1)
    return torch.sum(t * pre, dim=1).to(_I32)


def _bit_vec(off: torch.Tensor, w: int) -> torch.Tensor:
    """[H, W]-word one-hot bitmap of bit off[h] (off in [0, 64 w))."""
    wi = off // 64
    bi = torch.clamp(off - wi * 64, 0, 63).to(_I64)
    sel = (torch.arange(w, dtype=_I32, device=off.device)[None, :]
           == wi[:, None])
    return torch.where(sel, torch.ones_like(bi)[:, None] << bi[:, None], 0)


def _range_vec(lo: torch.Tensor, hi: torch.Tensor, w: int) -> torch.Tensor:
    """[H, W]-word mask of bits [lo, hi), clamped to [0, 64 w)."""
    lo = torch.clamp(lo, 0, 64 * w)
    hi = torch.clamp(hi, 0, 64 * w)
    idx = torch.arange(w, dtype=_I32, device=lo.device)[None, :] * 64
    a = torch.clamp(lo[:, None] - idx, 0, 64)
    b = torch.clamp(hi[:, None] - idx, 0, 64)
    n = torch.clamp(b - a, min=0).to(_I64)
    # (1 << n) - 1 for n < 64, without the signed overflow at n = 63
    low = torch.full_like(n, _MAX) >> (63 - torch.clamp(n, max=63))
    ones = torch.where(n >= 64, -1, low)
    return torch.where(n > 0, ones << torch.clamp(a, max=63).to(_I64), 0)


def _bit_test(ooo: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """Whether bit off[h] (>= 0) is set in row h's [W]-word bitmap."""
    w = ooo.shape[1]
    q = off // 64
    wi = torch.clamp(q, 0, w - 1).long()
    bi = torch.clamp(off - q * 64, 0, 63).to(_I64)
    word = torch.gather(ooo, 1, wi[:, None])[:, 0]
    return ((word >> bi) & 1) != 0


def _shift_right_vec(ooo: torch.Tensor, adv: torch.Tensor) -> torch.Tensor:
    """Shift each row's [W]-word bitmap right by adv[h] bits (adv in
    [0, 64 W])."""
    h, w = ooo.shape
    ws = adv // 64
    bs = torch.clamp(adv - ws * 64, 0, 63).to(_I64)[:, None]
    padded = torch.cat([ooo, ooo.new_zeros((h, w + 1))], dim=1)
    base = torch.arange(w, dtype=_I32, device=ooo.device)[None, :] \
        + ws[:, None]
    lo = torch.gather(padded, 1, torch.clamp(base, 0, 2 * w).long())
    hi = torch.gather(padded, 1, torch.clamp(base + 1, 0, 2 * w).long())
    return _shr(lo, bs) | torch.where(
        bs > 0, hi << torch.clamp(64 - bs, max=63), 0)


# ---------------------------------------------------------------------------
# Congestion-control hook tables. Each hook works on [H] rows; the
# algorithm is chosen per run, so dispatch is plain Python.
#
#   on_ack(row, n_acked, now) -> (cwnd', cc_wmax', cc_epoch')
#       growth on an advancing ACK outside recovery.
#   on_loss(row, flight, now) -> (cwnd', ssthresh', cc_wmax', cc_epoch')
#       fast-retransmit entry (3 dup acks).
#   on_timeout(row, flight, now) -> (ssthresh', cc_wmax', cc_epoch')
#       RTO collapse (the caller forces cwnd to 1).


class RenoCC:
    """NewReno: slow start, congestion avoidance, fast recovery."""

    name = "reno"

    @staticmethod
    def on_ack(row, n_acked, now):
        n = n_acked.to(_F32)
        cwnd = torch.where(row.cwnd < row.ssthresh, row.cwnd + n,
                           row.cwnd + n / torch.clamp(row.cwnd, min=1.0))
        return cwnd, row.cc_wmax, row.cc_epoch

    @staticmethod
    def on_loss(row, flight, now):
        ss = torch.clamp(flight / 2, min=2.0)
        return ss + 3, ss, row.cc_wmax, row.cc_epoch

    @staticmethod
    def on_timeout(row, flight, now):
        return torch.clamp(flight / 2, min=2.0), row.cc_wmax, row.cc_epoch


class AimdCC:
    """Classic AIMD: Reno's growth, halving on loss without the fast
    recovery inflation."""

    name = "aimd"

    on_ack = RenoCC.on_ack

    @staticmethod
    def on_loss(row, flight, now):
        ss = torch.clamp(flight / 2, min=2.0)
        return ss, ss, row.cc_wmax, row.cc_epoch

    on_timeout = RenoCC.on_timeout


class CubicCC:
    """CUBIC (RFC 8312, the Linux bictcp shape): window growth
    W(t) = C*(t-K)^3 + origin with K = cbrt((origin - cwnd0)/C), cwnd0
    the cwnd when the epoch starts; a no-loss epoch (cwnd0 >= W_max) has
    K = 0 and origin = cwnd0. A TCP-friendly floor tracks what Reno
    would have reached since the epoch. cc_wmax doubles as the epoch
    origin; cc_epoch == 0 means "epoch not started".

    The f32 arithmetic is the reference's as XLA compiles it on the CPU:
    `/ C` is folded into `* 2.5` (the one multiply where the reference's
    source divides); `(t-K)**3` is `(t-K) * ((t-K)*(t-K))`; the backend
    fuses three multiply-adds into FMAs (t, the cubic target and the
    friendly window; `cbrt.fma_f32`); and the cube root is `cbrt.cbrt`,
    the replay of glibc's powf(|x|, f32(1/3)) (F2)."""

    name = "cubic"
    C = 0.4
    BETA = 0.7
    # 1 / C as XLA folds it
    INV_C = 2.5
    # the f32 constants the FMAs take: ns to s, C, and Reno's additive
    # increase per RTT for BETA (a weak f32 in the reference)
    NS_F32 = float(np.float32(1e-9))
    C_F32 = float(np.float32(C))
    FRIENDLY_F32 = float(np.float32(3.0 * (1.0 - BETA) / (1.0 + BETA)))

    @classmethod
    def on_ack(cls, row, n_acked, now):
        n = n_acked.to(_F32)
        in_ss = row.cwnd < row.ssthresh
        fresh_epoch = row.cc_epoch == 0
        epoch = torch.where(fresh_epoch, now, row.cc_epoch)
        origin = torch.where(fresh_epoch,
                             torch.maximum(row.cc_wmax, row.cwnd),
                             row.cc_wmax)
        cwnd0 = torch.minimum(row.cwnd, origin)
        k = cbrt(torch.clamp(origin - cwnd0, min=0.0) * cls.INV_C)
        srtt_s = torch.clamp(row.srtt, min=MILLISECOND).to(_F32) * 1e-9
        t = fma_f32((now - epoch).to(_F32), cls.NS_F32, srtt_s)
        d = t - k
        target = fma_f32(d * (d * d), cls.C_F32, origin)
        friendly = fma_f32(t / srtt_s, cls.FRIENDLY_F32, cwnd0)
        target = torch.maximum(target, friendly)
        inc = torch.minimum(
            torch.clamp(target - row.cwnd, min=0.0)
            / torch.clamp(row.cwnd, min=1.0) * n, n)
        cwnd = torch.where(in_ss, row.cwnd + n, row.cwnd + inc)
        return (cwnd, torch.where(in_ss, row.cc_wmax, origin),
                torch.where(in_ss, row.cc_epoch, epoch))

    @classmethod
    def on_loss(cls, row, flight, now):
        # fast convergence: below the previous W_max, remember less
        wmax = torch.where(row.cwnd < row.cc_wmax,
                           row.cwnd * (2.0 - cls.BETA) / 2.0, row.cwnd)
        ss = torch.clamp(row.cwnd * cls.BETA, min=2.0)
        return ss + 3, ss, wmax, torch.zeros_like(row.cc_epoch)

    @classmethod
    def on_timeout(cls, row, flight, now):
        ss = torch.clamp(row.cwnd * cls.BETA, min=2.0)
        return ss, row.cwnd, torch.zeros_like(row.cc_epoch)


CC_ALGOS = {c.name: c for c in (RenoCC, AimdCC, CubicCC)}


def _ts_us(now):
    """Nonzero i32 microsecond timestamp for the header ts/echo word."""
    return torch.clamp((now // 1000) & 0x7FFFFFFF, min=1).to(_I32)


def _pkt_args(sport, dport, seq=0, ack=0, length=0, wnd=RCV_WND, aux=0,
              flags=0, sack=0):
    return Pkt.encode_args(PROTO_TCP, sport, dport, seq=seq, ack=ack,
                           length=length, wnd=wnd, aux=aux, flags=flags,
                           sack=sack)


def _ctl_args(slot, gen_or_zero, tk=0):
    """i32[H, N_PKT_ARGS] timer/kick args: (slot, generation, kind)."""
    ref = slot if isinstance(slot, torch.Tensor) else gen_or_zero
    words = [_rows(v, ref, _I32) for v in (slot, gen_or_zero, tk)]
    words += [torch.zeros_like(words[0])] * (N_PKT_ARGS - 3)
    return torch.stack(words, dim=-1)


def _emit_from_rows(rows, like: torch.Tensor) -> Emit:
    """An Emit of [H, len(rows)] fields from emit-row dicts whose values
    are scalars or [H] tensors (args [H, N_PKT_ARGS])."""
    stk = lambda key, dt: torch.stack([_rows(r[key], like, dt)
                                       for r in rows], dim=1)
    return Emit(
        dst=stk("dst", _I32), dt=stk("dt", _I64), kind=stk("kind", _I32),
        args=torch.stack([r["args"] for r in rows], dim=1),
        mask=stk("mask", torch.bool), local=stk("local", torch.bool),
    )


def emit_concat(*ems: Emit) -> Emit:
    """Concatenate [H, K_i] Emits along K."""
    return Emit(**{f.name: torch.cat([getattr(e, f.name) for e in ems], dim=1)
                   for f in dataclasses.fields(Emit)})


def _replace_net(hs, **kw):
    return dataclasses.replace(hs, net=dataclasses.replace(hs.net, **kw))


class TCP:
    """The TCP protocol hook installed into `transport.stack.Stack`.

    tx_burst: segments sent per KIND_TCP_TX kick.
    inline_budget: segments sent inline from the ACK-processing path.
    auto_close: a connection reaching CLOSE_WAIT closes itself.
    cc: 'reno', 'aimd' or 'cubic' (or a hook class).
    delack: delayed ACKs. in_order: app deliveries surface bytes only as
      rcv_nxt advances. autotune: receive-window autotuning.
    child_slot_limit: passive-open children take only slots below it.
    rst_on_unmatched: a TCP segment no socket claims (or a non-SYN at a
      bare listener) draws an RST.

    Engine `max_emit` must be >= `min_max_emit(app_rows)`, app_rows being
    the Emit rows the installed on_recv callback returns.
    """

    def __init__(self, tx_burst: int = 4, inline_budget: int = 2,
                 auto_close: bool = True, cc="reno", delack: bool = True,
                 in_order: bool = False, autotune: bool = True,
                 child_slot_limit: int | None = None,
                 rst_on_unmatched: bool = False):
        self.cc = CC_ALGOS[cc] if isinstance(cc, str) else cc
        self.tx_burst = tx_burst
        self.inline_budget = inline_budget
        self.auto_close = auto_close
        self.delack = delack
        self.in_order = in_order
        self.autotune = autotune
        self.rst_on_unmatched = rst_on_unmatched
        self.child_slot_limit = child_slot_limit

    def min_max_emit(self, app_rows: int = 1) -> int:
        """Smallest EngineConfig.max_emit that fits these handlers:
        process_segment emits [ctl, retx] + inline_budget data rows +
        [kick, timer, delack] + the on_recv rows; _on_timer emits 4."""
        return max(self.tx_burst + 2, self.inline_budget + 5 + app_rows, 4)

    # ------------------------------------------------------------ helpers
    def _seg_row(self, nic_tx, row, now, dst_host, sport, dport, s, is_fin,
                 ok, unlimited, is_retx=False):
        """One data/FIN segment per row through the tx NIC; returns
        (nic_tx', emit row). `is_retx` stamps F_RETX into the header."""
        length = torch.where(is_fin, 0, _seg_len(row.snd_buf, s))
        nic2, _start, fin_t = nic_tx.admit(now, length + HEADER_TCP,
                                           unlimited)
        nic_tx = _select_rows(ok, nic2, nic_tx)
        flags = F_ACK | is_fin.to(_I32) * F_FIN | (F_RETX if is_retx else 0)
        args = _pkt_args(sport, dport, seq=s, ack=row.rcv_nxt, length=length,
                         wnd=row.rwnd, aux=_ts_us(now), flags=flags,
                         sack=row.ooo[:, 0])
        em = dict(dst=dst_host, dt=torch.where(ok, fin_t - now, 0),
                  kind=KIND_PKT_ARRIVE, args=args, mask=ok, local=False)
        return nic_tx, em

    def _tx_segments(self, nic_tx, row, now, dst_host, sport, dport, budget,
                     enabled, unlimited):
        """Send up to `budget` new segments from snd_nxt, window-limited.
        Returns (nic_tx', row', emit rows, more). The state moves to
        FIN_WAIT_1 / LAST_ACK when the FIN goes out."""
        n_segs = _n_segs(row.snd_buf)
        fin_rdy = _fin_ready(row)
        lim = n_segs + fin_rdy.to(_I32)
        st = row.state
        # closing states stay sendable so a go-back-N window after a
        # timeout refills with a full cwnd
        can = enabled & (
            (st == ESTABLISHED) | (st == CLOSE_WAIT) | (st == FIN_WAIT_1)
            | (st == CLOSING) | (st == LAST_ACK))
        win_end = row.snd_una + torch.minimum(row.cwnd.to(_I32), row.peer_wnd)
        nxt = row.snd_nxt
        sent_fin = torch.zeros_like(can)
        rows = []
        for _ in range(budget):
            s = nxt
            is_data = s < n_segs
            is_fin = fin_rdy & ~is_data & (s == n_segs)
            inwin = (s < win_end) & (s < lim)
            # a segment the receiver already holds (SACK) is skipped
            s_rel = s - row.snd_una
            is_sacked = is_data & (s_rel >= 0) & (s_rel < 64) & (
                ((row.sacked >> torch.clamp(s_rel, 0, 63).to(_I64)) & 1) != 0)
            ok = can & (is_data | is_fin) & inwin & ~is_sacked
            nic_tx, em = self._seg_row(nic_tx, row, now, dst_host, sport,
                                       dport, s, is_fin, ok, unlimited)
            rows.append(em)
            nxt = nxt + (ok | (can & is_sacked & inwin)).to(_I32)
            sent_fin = sent_fin | (ok & is_fin)
        state = torch.where(
            sent_fin & (st == ESTABLISHED), FIN_WAIT_1,
            torch.where(sent_fin & (st == CLOSE_WAIT), LAST_ACK, st))
        row = dataclasses.replace(row, snd_nxt=nxt, state=state)
        more = can & (nxt < lim) & (nxt < win_end)
        return nic_tx, row, rows, more

    def _kick_row(self, slot, now, free_at, mask):
        return dict(dst=0, dt=torch.clamp(free_at - now, min=1),
                    kind=KIND_TCP_TX, args=_ctl_args(slot, 0), mask=mask,
                    local=True)

    def _arm_row(self, row, slot, now, enter_tw):
        """The RTO arm (outstanding data, no live timer) or the TIME_WAIT
        timer (on entering TIME_WAIT); at most one fires per event."""
        arm = _outstanding(row) & ~row.timer_live & ~enter_tw
        fire = arm | enter_tw
        gen = row.timer_gen + fire.to(_I32)
        tk = torch.where(enter_tw, TK_TIMEWAIT, TK_RTO).to(_I32)
        dt = torch.where(enter_tw, TIME_WAIT_DELAY, row.rto)
        row = dataclasses.replace(
            row, timer_live=row.timer_live | fire, timer_gen=gen,
            rto_deadline=torch.where(arm, now + row.rto, row.rto_deadline))
        em = dict(dst=0, dt=dt, kind=KIND_TCP_TIMER,
                  args=_ctl_args(slot, gen, tk), mask=fire, local=True)
        return row, em

    # --------------------------------------------------------- public API
    def connect(self, stack, hs, slot, now, mask=True):
        """Active open on each row's `slot` (bound TCP with a local port
        and a peer). Returns (hs', Emit[H, 2]) = SYN + RTO timer."""
        net = hs.net
        slot = _rows(slot, now, _I32)
        c = torch.clamp(slot, min=0)
        mask = _rows(mask, now, torch.bool) & (slot >= 0)
        old = _row(net.tcb, c)
        row = dataclasses.replace(
            _fresh_row_like(old),
            state=torch.full_like(old.state, SYN_SENT),
            timer_live=torch.ones_like(old.timer_live),
            timer_gen=old.timer_gen + 1, rto_deadline=now + RTO_INIT)
        unlimited = now < stack.bootstrap_end
        nic2, _s, fin_t = net.nic_tx.admit(
            now, torch.full_like(slot, HEADER_TCP), unlimited)
        nic_tx = _select_rows(mask, nic2, net.nic_tx)
        sk = net.sockets
        syn = dict(
            dst=_sel(sk.peer_host, c), dt=torch.where(mask, fin_t - now, 0),
            kind=KIND_PKT_ARRIVE,
            args=_pkt_args(_sel(sk.local_port, c), _sel(sk.peer_port, c),
                           wnd=row.rwnd, aux=_ts_us(now), flags=F_SYN),
            mask=mask, local=False)
        timer = dict(dst=0, dt=RTO_INIT, kind=KIND_TCP_TIMER,
                     args=_ctl_args(c, row.timer_gen, TK_RTO), mask=mask,
                     local=True)
        hs = _replace_net(hs, tcb=_write_row(net.tcb, c, row, mask, old),
                          nic_tx=nic_tx)
        return hs, _emit_from_rows([syn, timer], now)

    def send(self, hs, slot, nbytes, now, mask=True):
        """Queue bytes on each row's connection. Returns (hs', Emit[H, 1])
        = a tx kick. Bytes beyond the send buffer's room wait in
        app_pending; a transmitted partial tail segment rewinds."""
        net = hs.net
        slot = _rows(slot, now, _I32)
        c = torch.clamp(slot, min=0)
        mask = _rows(mask, now, torch.bool) & (slot >= 0)
        row = row0 = _row(net.tcb, c)
        nb = _rows(nbytes, now, _I64)
        accept = torch.minimum(nb, _send_room(row, nb))
        row = _admit_bytes(row, accept)
        row = dataclasses.replace(row,
                                  app_pending=row.app_pending + (nb - accept))
        hs = _replace_net(
            hs, tcb=_write_row(net.tcb, c, row, mask, row0),
            sockets=net.sockets.add_tx(torch.where(mask, c, -1), nb))
        return hs, _emit_from_rows([self._kick_row(c, now, now, mask)], now)

    def close(self, hs, slot, now, mask=True):
        """Half-close once pending data has gone out (the FIN follows
        it). Closing a LISTEN socket resets the slot at once, its demux
        row included. Returns (hs', Emit[H, 1]) = a tx kick."""
        net = hs.net
        slot = _rows(slot, now, _I32)
        c = torch.clamp(slot, min=0)
        mask = _rows(mask, now, torch.bool) & (slot >= 0)
        row = _row(net.tcb, c)
        lst = mask & (row.state == LISTEN)
        tcb = _write_row(net.tcb, c, _fresh_row_like(row), lst, row)
        tcb = dataclasses.replace(
            tcb, fin_pending=_put(tcb.fin_pending, c, True, mask & ~lst))
        sk = net.sockets
        sk = dataclasses.replace(sk, proto=_put(sk.proto, c, 0, lst),
                                 local_port=_put(sk.local_port, c, 0, lst))
        hs = _replace_net(hs, tcb=tcb, sockets=sk)
        return hs, _emit_from_rows([self._kick_row(c, now, now, mask & ~lst)],
                                   now)

    # ------------------------------------------------- segment processing
    def process_segment(self, stack, hs, slot, pkt: Pkt, ev, key, on_recv):
        """tcp_processPacket over every row: handshake, ACKs with NewReno
        recovery, RTT and SACK, reassembly, FIN and close transitions,
        inline tx, ACK generation. UDP packets go straight to `on_recv`
        (the stack sends every demuxed packet here when TCP is on)."""
        if hs.net.tcb is None:
            raise ValueError(
                "Stack(tcp=...) requires HostNet.create(..., with_tcp=True) "
                "so the host state carries a TCB table")
        net = hs.net
        now = ev.time
        unlimited = now < stack.bootstrap_end
        have = slot >= 0
        c = torch.clamp(slot, min=0)
        is_udp = (pkt.proto == PROTO_UDP) & have
        is_tcp = (pkt.proto == PROTO_TCP) & have
        row = row0 = _row(net.tcb, c)
        sockets = net.sockets

        f = pkt.flags
        f_syn = (f & F_SYN) != 0
        f_ackf = (f & F_ACK) != 0
        f_fin = (f & F_FIN) != 0
        f_rst = (f & F_RST) != 0
        syn_only = is_tcp & f_syn & ~f_ackf
        synack = is_tcp & f_syn & f_ackf
        plain_ack = is_tcp & f_ackf & ~f_syn

        # -- passive open: SYN at LISTEN -> child slot; SYN at SYN_RCVD is
        # a duplicate -> SYN-ACK again
        at_listen = syn_only & (row.state == LISTEN)
        dup_syn = syn_only & (row.state == SYN_RCVD)
        child_free = sockets.proto == PROTO_NONE
        n_slots = child_free.shape[1]
        if self.child_slot_limit is not None:
            child_free = child_free & (
                torch.arange(n_slots, device=c.device)[None, :]
                < self.child_slot_limit)
        free_slot = torch.argmax(child_free.to(_I32), dim=1).to(_I32)
        do_open = at_listen & _sel(child_free, free_slot)
        child = torch.where(do_open, free_slot, c)
        child_old = _row(net.tcb, child)
        child_row = dataclasses.replace(
            _fresh_row_like(child_old),
            state=torch.full_like(child_old.state, SYN_RCVD),
            peer_wnd=torch.clamp(pkt.wnd, min=1),
            timer_live=torch.ones_like(child_old.timer_live),
            timer_gen=child_old.timer_gen + 1, rto_deadline=now + RTO_INIT)
        wr = lambda a, v: _put(a, child, v, do_open)
        sockets = dataclasses.replace(
            sockets, proto=wr(sockets.proto, PROTO_TCP),
            local_port=wr(sockets.local_port, pkt.dst_port),
            peer_host=wr(sockets.peer_host, pkt.src_host),
            peer_port=wr(sockets.peer_port, pkt.src_port))

        # -- handshake completions and RST
        est_active = synack & (row.state == SYN_SENT)
        est_passive = plain_ack & (row.state == SYN_RCVD)
        got_rst = (is_tcp & f_rst & (row.state != LISTEN)
                   & (row.state != CLOSED))
        row = dataclasses.replace(
            row,
            state=torch.where(est_active | est_passive, ESTABLISHED,
                              row.state),
            peer_wnd=torch.where(est_active | plain_ack,
                                 torch.clamp(pkt.wnd, min=1), row.peer_wnd))
        # the handshake RTT seeds srtt on the client (SYN ts echoed)
        ts_now = _ts_us(now)
        rtt = torch.clamp(
            ((ts_now - pkt.aux) & 0x7FFFFFFF).to(_I64) * 1000, min=1)
        sample_hs = est_active & (pkt.aux != 0)
        row = dataclasses.replace(
            row,
            srtt=torch.where(sample_hs, rtt, row.srtt),
            rttvar=torch.where(sample_hs, rtt // 2, row.rttvar),
            rto=torch.where(sample_hs,
                            torch.clamp(rtt + 4 * (rtt // 2), RTO_MIN,
                                        RTO_MAX), row.rto))

        # -- ACK processing: NewReno recovery, RTT, SACK
        ack_ok = plain_ack & (row.state >= ESTABLISHED) & (
            row.state <= LAST_ACK)
        # the valid ack range is bounded by ever-sent data, not snd_nxt:
        # after a go-back-N rewind, acks beyond it still heal the window
        ack = torch.clamp(pkt.ack, min=0)
        ack = torch.minimum(ack, _n_segs(row.snd_buf)
                            + _fin_ready(row).to(_I32))
        advanced = ack_ok & (ack > row.snd_una)
        n_acked = torch.where(advanced, ack - row.snd_una, 0)
        sample = advanced & (pkt.aux != 0)
        first = row.srtt == 0
        srtt_prev = row.srtt
        srtt = torch.where(
            sample, torch.where(first, rtt, (7 * row.srtt + rtt) // 8),
            row.srtt)
        rttvar = torch.where(
            sample,
            torch.where(first, rtt // 2,
                        (3 * row.rttvar + torch.abs(srtt_prev - rtt)) // 4),
            row.rttvar)
        rto = torch.where(
            sample,
            torch.clamp(srtt + torch.clamp(4 * rttvar, min=MILLISECOND),
                        RTO_MIN, RTO_MAX),
            row.rto)

        in_rec = row.recover >= 0
        pure = plain_ack & (pkt.length == 0) & ~f_fin
        is_dup = (ack_ok & pure & ~advanced & (row.snd_nxt > row.snd_una)
                  & (ack == row.snd_una))
        # a pure dup ACK answering a burst-folded delivery stands for
        # pkt.nseg dup ACKs; fast retransmit fires on crossing 3
        dup_acks = torch.where(
            advanced, 0, row.dup_acks + torch.where(is_dup, pkt.nseg, 0))
        fr = is_dup & (dup_acks >= 3) & (row.dup_acks < 3) & ~in_rec
        flight = (row.snd_nxt - row.snd_una).to(_F32)
        exit_rec = advanced & in_rec & (ack >= row.recover)
        partial_ack = advanced & in_rec & ~exit_rec
        cw_ack, wmax_ack, epoch_ack = self.cc.on_ack(row, n_acked, now)
        # congestion-window validation: growth capped at 2x the flight
        cw_ack = torch.minimum(
            cw_ack, torch.clamp(torch.maximum(flight * 2, row.cwnd),
                                min=INIT_CWND))
        cw_loss, ss_loss, wmax_loss, epoch_loss = self.cc.on_loss(
            row, flight, now)
        # a carrier crossing the threshold spends its extra dups on
        # recovery inflation, as the unfolded dup stream would
        fr_extra = torch.clamp(dup_acks - 3, min=0).to(_F32)
        cwnd = torch.where(
            fr, cw_loss + fr_extra,
            torch.where(
                is_dup & in_rec, row.cwnd + pkt.nseg,
                torch.where(exit_rec, row.ssthresh,
                            torch.where(advanced & ~in_rec, cw_ack,
                                        row.cwnd))))
        cwnd = torch.clamp(cwnd, max=CWND_MAX)
        grow_ack = advanced & ~in_rec
        cc_wmax = torch.where(fr, wmax_loss,
                              torch.where(grow_ack, wmax_ack, row.cc_wmax))
        cc_epoch = torch.where(fr, epoch_loss,
                               torch.where(grow_ack, epoch_ack, row.cc_epoch))
        retx = fr | partial_ack
        snd_una = torch.where(advanced, ack, row.snd_una)
        # SACK scoreboard: realign to the new snd_una, then absorb the
        # ACK's bitmap (relative to its ack field)
        moved = snd_una - row.snd_una
        sacked = torch.where(
            moved >= 64, 0,
            _shr(row.sacked, torch.clamp(moved, 0, 63).to(_I64)))
        sacked = torch.where(ack_ok & (ack == snd_una), sacked | pkt.sack,
                             sacked)
        row = dataclasses.replace(row, sacked=sacked)
        n_segs = _n_segs(row.snd_buf)
        fin_acked = _fin_ready(row) & (snd_una >= n_segs + 1)
        st = row.state
        state2 = torch.where(
            (st == FIN_WAIT_1) & fin_acked, FIN_WAIT_2,
            torch.where((st == CLOSING) & fin_acked, TIME_WAIT,
                        torch.where((st == LAST_ACK) & fin_acked, CLOSED,
                                    st)))
        enter_tw_ack = (st == CLOSING) & fin_acked
        freed_ack = (st == LAST_ACK) & fin_acked
        row = dataclasses.replace(
            row, state=state2, snd_una=snd_una,
            snd_nxt=torch.maximum(row.snd_nxt, snd_una), cwnd=cwnd,
            ssthresh=torch.where(fr, ss_loss, row.ssthresh),
            cc_wmax=cc_wmax, cc_epoch=cc_epoch, dup_acks=dup_acks,
            recover=torch.where(fr, row.snd_nxt,
                                torch.where(exit_rec, -1, row.recover)),
            srtt=srtt, rttvar=rttvar, rto=rto,
            rto_deadline=torch.where(advanced, now + rto, row.rto_deadline),
            n_retx=row.n_retx + retx.to(_I32))
        # send-buffer drain: ACK progress freed room for waiting app bytes
        take = torch.where(
            advanced & (row.app_pending > 0),
            torch.minimum(row.app_pending,
                          _send_room(row, row.app_pending)), 0)
        row = _admit_bytes(row, take)
        row = dataclasses.replace(row, app_pending=row.app_pending - take)

        # -- data / FIN receive: bitmap reassembly, cumulative advance
        has_seg = (is_tcp & ~f_syn & ((pkt.length > 0) | f_fin)
                   & (row.state >= ESTABLISHED))
        wnd_words = row.ooo.shape[1]
        wnd_cap = 64 * wnd_words
        # a burst-folded packet stands for pkt.nseg contiguous segments
        # [seq, seq + nseg); freshness is per bit
        off = pkt.seq - row.rcv_nxt
        end = off + pkt.nseg
        new_bits = _range_vec(off, end, wnd_words) & ~row.ooo
        any_new = torch.any(new_bits != 0, dim=1)
        in_win = (end > 0) & (off < wnd_cap)
        fresh = has_seg & in_win & any_new
        # only a burst's last segment may be partial
        last_seq = pkt.seq + pkt.nseg - 1
        last_len = pkt.length - (pkt.nseg - 1) * MSS
        # refill of the tracked partial: any member of the run, counted
        # iff that slot's bit is already held
        p_seq = row.partial_seq
        p_in_run = (has_seg & (pkt.length > 0) & (p_seq >= 0)
                    & (p_seq >= pkt.seq) & (p_seq <= last_seq))
        p_off = p_seq - row.rcv_nxt
        p_already = (p_off < 0) | (
            (p_off < wnd_cap) & _bit_test(row.ooo, torch.clamp(p_off, min=0)))
        p_member_len = torch.where(p_seq == last_seq, last_len, MSS)
        refill = p_in_run & p_already & (p_member_len > row.partial_len)
        refill_delta = torch.where(refill, p_member_len - row.partial_len, 0)
        ooo1 = torch.where(fresh[:, None], row.ooo | new_bits, row.ooo)
        adv = torch.where(fresh, _trailing_ones_vec(ooo1), 0)
        rcv_nxt = row.rcv_nxt + adv
        ooo2 = _shift_right_vec(ooo1, adv)
        is_partial = (has_seg & (pkt.length > 0) & (last_len < MSS)
                      & (fresh | refill))
        if self.in_order:
            # bytes surface as rcv_nxt advances: adv full segments, less
            # the partial segments and the FIN's slot inside the advance
            new_bytes = adv * MSS
            fin_seq = torch.where(has_seg & f_fin & (row.rfin_seq < 0),
                                  pkt.seq, row.rfin_seq)
            new_bytes = new_bytes - torch.where(
                (fin_seq >= 0) & (fin_seq >= row.rcv_nxt)
                & (fin_seq < rcv_nxt), MSS, 0)
            new_bytes = new_bytes - torch.where(
                fresh & is_partial & (last_seq < rcv_nxt), MSS - last_len, 0)
            prev_partial_adv = (
                (row.partial_seq >= row.rcv_nxt)
                & (row.partial_seq < rcv_nxt) & (row.partial_seq != last_seq))
            new_bytes = new_bytes - torch.where(
                prev_partial_adv, MSS - row.partial_len, 0)
            # a refill of an already-advanced partial delivers its delta
            # now; otherwise it surfaces with the advance
            new_bytes = new_bytes + torch.where(
                refill & (row.partial_seq < row.rcv_nxt), refill_delta, 0)
            new_bytes = new_bytes.to(_I32)
        else:
            # per-bit freshness: the partial tail counts its own length,
            # every other fresh bit a full MSS
            n_fresh = torch.sum(_popcount(new_bits), dim=1, dtype=_I64)
            last_bit_fresh = _bit_test(
                new_bits, torch.clamp(last_seq - row.rcv_nxt, 0, wnd_cap - 1)
            ) & (last_seq >= row.rcv_nxt)
            burst_bytes = n_fresh * MSS - torch.where(
                (last_len < MSS) & last_bit_fresh, MSS - last_len, 0)
            new_bytes = (torch.where(fresh, burst_bytes, 0)
                         + refill_delta).to(_I32)
        clear_partial = p_in_run & (p_member_len >= MSS)
        rfin = torch.where(has_seg & f_fin, pkt.seq, row.rfin_seq)
        consumed_before = (row.rfin_seq >= 0) & (row.rcv_nxt > row.rfin_seq)
        consumed_after = (rfin >= 0) & (rcv_nxt > rfin)
        fin_new = consumed_after & ~consumed_before
        st = row.state
        state3 = torch.where(
            fin_new & (st == ESTABLISHED), CLOSE_WAIT,
            torch.where(fin_new & (st == FIN_WAIT_1), CLOSING,
                        torch.where(fin_new & (st == FIN_WAIT_2), TIME_WAIT,
                                    st)))
        enter_tw = enter_tw_ack | (fin_new & (st == FIN_WAIT_2))
        # -- receive-window autotuning: grow the advertised window when a
        # round trip's deliveries fill half of it (RTT from the packet
        # timestamp's one-way delay)
        if self.autotune:
            owd = torch.clamp(
                ((ts_now - pkt.aux) & 0x7FFFFFFF).to(_I64) * 1000,
                min=MILLISECOND)
            ep_start = torch.where(row.rcv_ep_start > 0, row.rcv_ep_start,
                                   now)
            ep_segs = row.rcv_ep_segs + adv
            ep_done = has_seg & (now - ep_start >= 2 * owd)
            row = dataclasses.replace(
                row,
                rwnd=torch.where(
                    ep_done,
                    torch.minimum(torch.maximum(2 * ep_segs, row.rwnd),
                                  row.rwnd_cap),
                    row.rwnd),
                rcv_ep_segs=torch.where(
                    has_seg, torch.where(ep_done, 0, ep_segs),
                    row.rcv_ep_segs),
                rcv_ep_start=torch.where(
                    has_seg, torch.where(ep_done, now, ep_start),
                    row.rcv_ep_start))
        row = dataclasses.replace(
            row, state=state3, rcv_nxt=rcv_nxt, ooo=ooo2, rfin_seq=rfin,
            partial_seq=torch.where(
                is_partial, last_seq,
                torch.where(clear_partial, -1, row.partial_seq)),
            partial_len=torch.where(
                is_partial, last_len,
                torch.where(clear_partial, 0, row.partial_len)))
        # auto-close: the server side closes when the peer closes
        if self.auto_close:
            row = dataclasses.replace(
                row, fin_pending=row.fin_pending | (row.state == CLOSE_WAIT))
        # -- delayed ACK: an in-order segment with no ACK owed waits for a
        # second segment or the delack timer; anything else ACKs now
        in_order_fresh = fresh & (off == 0)
        delay_ok = (has_seg & in_order_fresh & ~f_fin & ~fin_new
                    & (row.delack_segs == 0) & (pkt.nseg == 1))
        if not self.delack:
            delay_ok = torch.zeros_like(delay_ok)
        send_ack = (has_seg & ~delay_ok) | dup_syn
        arm_delack = delay_ok & ~row.delack_live
        row = dataclasses.replace(
            row,
            delack_segs=torch.where(has_seg, delay_ok.to(_I32),
                                    row.delack_segs),
            delack_live=row.delack_live | arm_delack,
            pend_echo=torch.where(has_seg, pkt.aux, row.pend_echo))

        # -- retransmit row (fast retransmit / NewReno partial ack)
        nic_tx = net.nic_tx
        peer_h = _sel(sockets.peer_host, c)
        peer_p = _sel(sockets.peer_port, c)
        sport = _sel(sockets.local_port, c)
        retx_fin = _fin_ready(row) & (row.snd_una == n_segs)
        nic_tx, retx_row = self._seg_row(
            nic_tx, row, now, peer_h, sport, peer_p, row.snd_una, retx_fin,
            retx & (row.snd_una < row.snd_nxt), unlimited, is_retx=True)

        # -- inline new-data tx (ACK-clocked)
        nic_tx, row, data_rows, more = self._tx_segments(
            nic_tx, row, now, peer_h, sport, peer_p, self.inline_budget,
            is_tcp & ~do_open, unlimited)
        kick = self._kick_row(c, now, nic_tx.free_at, more)
        # outbound segments carry ack = rcv_nxt: the delayed ACK is paid
        sent_data = retx_row["mask"]
        for r in data_rows:
            sent_data = sent_data | r["mask"]
        row = dataclasses.replace(
            row, delack_segs=torch.where(sent_data, 0, row.delack_segs))

        # -- control/ACK row: SYN-ACK, the handshake's pure ACK, a data or
        # dup ACK, or an RST for a segment no socket claims
        if self.rst_on_unmatched:
            need_rst = ((pkt.proto == PROTO_TCP) & ((pkt.flags & F_RST) == 0)
                        & (~have | (is_tcp & ~f_syn & (row.state == LISTEN))))
        else:
            need_rst = torch.zeros_like(have)
        need_synack = do_open | dup_syn
        need_ctl = need_synack | est_active | send_ack | need_rst
        ctl_flags = torch.where(need_synack, F_SYN | F_ACK,
                                torch.where(need_rst, F_RST | F_ACK, F_ACK))
        ctl_ack = torch.where(need_synack | need_rst, 0, row.rcv_nxt)
        nic2, _s2, fin_t2 = nic_tx.admit(
            now, torch.full_like(slot, HEADER_TCP), unlimited)
        nic_tx = _select_rows(need_ctl, nic2, nic_tx)
        ctl = dict(
            dst=pkt.src_host, dt=torch.where(need_ctl, fin_t2 - now, 0),
            kind=KIND_PKT_ARRIVE,
            args=_pkt_args(
                pkt.dst_port, pkt.src_port, seq=0, ack=ctl_ack,
                # an ACK answering an nseg-fold stands for nseg ACKs: the
                # count rides the length word's high bits
                length=torch.where(need_synack | (pkt.nseg <= 1), 0,
                                   pkt.nseg << BURST_NSEG_SHIFT),
                wnd=row.rwnd, aux=pkt.aux, flags=ctl_flags,
                sack=row.ooo[:, 0]),
            mask=need_ctl, local=False)

        # -- timer row (RTO arm or TIME_WAIT); a passive open arms the
        # child's RTO timer on the same row (the listener's is idle)
        row, timer_row = self._arm_row(row, c, now, enter_tw)
        timer_row = dict(
            dst=0,
            dt=torch.where(do_open, RTO_INIT, timer_row["dt"]),
            kind=KIND_TCP_TIMER,
            args=torch.where(do_open[:, None],
                             _ctl_args(child, child_row.timer_gen, TK_RTO),
                             timer_row["args"]),
            mask=timer_row["mask"] | do_open, local=True)
        freed = freed_ack | got_rst
        fresh_row = dataclasses.replace(_fresh_row_like(row),
                                        timer_gen=row.timer_gen + 1)
        row = _select_rows(freed, fresh_row, row)
        sockets = dataclasses.replace(
            sockets,
            proto=_put(sockets.proto, c, PROTO_NONE, freed & is_tcp))

        # -- write back: the main row at c, the child row at its slot
        tcb = _write_row(net.tcb, c, row, is_tcp & ~at_listen, row0)
        tcb = _write_row(tcb, child, child_row, do_open)
        # UDP counts arrivals, TCP newly delivered bytes
        deliver_len = torch.where(is_tcp, new_bytes, pkt.length)
        # the app sees data and stream EOF (the consumed FIN)
        deliver = is_udp | (is_tcp & ((new_bytes > 0) | fin_new))
        sockets = sockets.add_rx(torch.where(deliver, c, -1), deliver_len)
        hs = _replace_net(hs, tcb=tcb, sockets=sockets, nic_tx=nic_tx)

        # -- app delivery, once, after every state update: F_FIN in the
        # delivered flags means "the peer finished sending"
        eof_flags = torch.where(
            is_tcp, (pkt.flags & ~F_FIN) | fin_new.to(_I32) * F_FIN,
            pkt.flags)
        pkt2 = dataclasses.replace(pkt, length=deliver_len, flags=eof_flags)
        hs, app_em = on_recv(hs, torch.where(deliver, slot, -1), pkt2, now,
                             key)
        da_row = dict(dst=0, dt=DELACK_DELAY, kind=KIND_TCP_TIMER,
                      args=_ctl_args(c, row.conn_gen, TK_DELACK),
                      mask=arm_delack, local=True)
        ours = _emit_from_rows(
            [ctl, retx_row] + data_rows + [kick, timer_row, da_row], now)
        return hs, emit_concat(ours, app_em)

    # ------------------------------------------------------ event handlers
    def _on_tx(self, stack, hs, ev, key):
        """KIND_TCP_TX: a paced, window-limited transmission kick."""
        net = hs.net
        now = ev.time
        c = torch.clamp(ev.args[:, T_SLOT], min=0)
        row = row0 = _row(net.tcb, c)
        sk = net.sockets
        enabled = _sel(sk.proto, c) == PROTO_TCP
        unlimited = now < stack.bootstrap_end
        nic_tx, row, rows, more = self._tx_segments(
            net.nic_tx, row, now, _sel(sk.peer_host, c),
            _sel(sk.local_port, c), _sel(sk.peer_port, c), self.tx_burst,
            enabled, unlimited)
        rows.append(self._kick_row(c, now, nic_tx.free_at, more))
        row, timer_row = self._arm_row(row, c, now,
                                       torch.zeros_like(enabled))
        rows.append(timer_row)
        hs = _replace_net(hs, tcb=_write_row(net.tcb, c, row, enabled, row0),
                          nic_tx=nic_tx)
        return hs, _emit_from_rows(rows, now)

    def _on_timer(self, stack, hs, ev, key):
        """KIND_TCP_TIMER: RTO expiry (rescheduled lazily when the
        deadline moved), TIME_WAIT expiry or a delayed-ACK flush."""
        net = hs.net
        now = ev.time
        c = torch.clamp(ev.args[:, T_SLOT], min=0)
        gen = ev.args[:, T_GEN]
        tk = ev.args[:, T_KIND]
        row = row0 = _row(net.tcb, c)
        sk = net.sockets
        slot_ok = _sel(sk.proto, c) == PROTO_TCP
        live = (gen == row.timer_gen) & slot_ok
        unlimited = now < stack.bootstrap_end

        # delayed-ACK expiry: flush the owed ACK; the gen word carries the
        # slot's incarnation, so a previous connection's timer is inert
        is_da = slot_ok & (tk == TK_DELACK) & (gen == row.conn_gen)
        da_fire = is_da & (row.delack_segs > 0)
        row = dataclasses.replace(
            row, delack_live=row.delack_live & ~is_da,
            delack_segs=torch.where(is_da, 0, row.delack_segs))

        # TIME_WAIT expiry frees the slot
        tw_done = live & (tk == TK_TIMEWAIT) & (row.state == TIME_WAIT)

        rto_ev = live & (tk == TK_RTO)
        early = rto_ev & (now < row.rto_deadline)
        fire = rto_ev & ~early
        outstanding = _outstanding(row)
        timeout = fire & outstanding
        # timeout: the cc timeout hook, then go-back-N
        flight = (row.snd_nxt - row.snd_una).to(_F32)
        ss_to, wmax_to, epoch_to = self.cc.on_timeout(row, flight, now)
        rto2 = torch.clamp(row.rto * 2, max=RTO_MAX)
        row = dataclasses.replace(
            row,
            ssthresh=torch.where(timeout, ss_to, row.ssthresh),
            cc_wmax=torch.where(timeout, wmax_to, row.cc_wmax),
            cc_epoch=torch.where(timeout, epoch_to, row.cc_epoch),
            cwnd=torch.where(timeout, 1.0, row.cwnd),
            dup_acks=torch.where(timeout, 0, row.dup_acks),
            recover=torch.where(timeout, -1, row.recover),
            rto=torch.where(timeout, rto2, row.rto),
            snd_nxt=torch.where(timeout & (row.state >= ESTABLISHED),
                                row.snd_una, row.snd_nxt),
            timer_live=row.timer_live & ~(fire & ~outstanding),
            rto_deadline=torch.where(timeout, now + rto2, row.rto_deadline),
            n_retx=row.n_retx + timeout.to(_I32))

        # retransmission: SYN, SYN-ACK, or data/FIN at snd_una
        peer_h = _sel(sk.peer_host, c)
        peer_p = _sel(sk.peer_port, c)
        sport = _sel(sk.local_port, c)
        is_syn_rtx = timeout & (row.state == SYN_SENT)
        is_synack_rtx = timeout & (row.state == SYN_RCVD)
        is_data_rtx = timeout & (row.state >= ESTABLISHED)
        retx_fin = _fin_ready(row) & (row.snd_una == _n_segs(row.snd_buf))
        nic_tx, data_row = self._seg_row(
            net.nic_tx, row, now, peer_h, sport, peer_p, row.snd_una,
            retx_fin, is_data_rtx, unlimited, is_retx=True)
        hs_flags = torch.where(is_syn_rtx, F_SYN, F_SYN | F_ACK)
        header = torch.full_like(gen, HEADER_TCP)
        nic2, _s, fin_t = nic_tx.admit(now, header, unlimited)
        hs_mask = is_syn_rtx | is_synack_rtx
        nic_tx = _select_rows(hs_mask, nic2, nic_tx)
        hs_row = dict(
            dst=peer_h, dt=torch.where(hs_mask, fin_t - now, 0),
            kind=KIND_PKT_ARRIVE,
            args=_pkt_args(sport, peer_p, wnd=row.rwnd, aux=_ts_us(now),
                           flags=hs_flags),
            mask=hs_mask, local=False)
        # re-arm: early -> at the deadline (same gen); timeout -> + rto'
        timer_row = dict(
            dst=0,
            dt=torch.clamp(torch.where(early, row.rto_deadline - now,
                                       row.rto), min=1),
            kind=KIND_TCP_TIMER, args=_ctl_args(c, row.timer_gen, TK_RTO),
            mask=early | timeout, local=True)
        # the flushed delayed ACK echoes the delayed segment's timestamp
        nic3, _s3, fin_t3 = nic_tx.admit(now, header, unlimited)
        nic_tx = _select_rows(da_fire, nic3, nic_tx)
        da_ack_row = dict(
            dst=peer_h, dt=torch.where(da_fire, fin_t3 - now, 0),
            kind=KIND_PKT_ARRIVE,
            args=_pkt_args(sport, peer_p, seq=0, ack=row.rcv_nxt, length=0,
                           wnd=row.rwnd, aux=row.pend_echo, flags=F_ACK,
                           sack=row.ooo[:, 0]),
            mask=da_fire, local=False)

        # free on TIME_WAIT expiry
        fresh_row = dataclasses.replace(_fresh_row_like(row),
                                        timer_gen=row.timer_gen + 1)
        row = _select_rows(tw_done, fresh_row, row)
        sockets = dataclasses.replace(
            sk, proto=_put(sk.proto, c, PROTO_NONE, tw_done))
        hs = _replace_net(hs, tcb=_write_row(net.tcb, c, row, live | is_da,
                                                 row0),
                          nic_tx=nic_tx, sockets=sockets)
        return hs, _emit_from_rows([data_row, hs_row, timer_row, da_ack_row],
                                   now)

    def make_handlers(self, stack):
        """[KIND_TCP_TIMER, KIND_TCP_TX] handlers (after the stack's
        arrive/rx pair)."""
        return [
            lambda hs, ev, key: self._on_timer(stack, hs, ev, key),
            lambda hs, ev, key: self._on_tx(stack, hs, ev, key),
        ]
