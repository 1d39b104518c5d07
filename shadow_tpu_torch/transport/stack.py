"""The host network stack: packet events, delivery pipeline, send path.

The counterpart of `shadow_tpu.transport.stack`. A packet takes two
event hops:

  sender handler:  tx-NIC virtual clock -> Emit(dst, dt = serialization)
  [the engine routes it: + path latency, reliability roll, barrier clamp]
  KIND_PKT_ARRIVE at dst: rx-NIC virtual clock gives (start, finish);
      sojourn = start - arrival feeds CoDel, which may drop; otherwise
      a local Emit at dt = finish - now of kind KIND_PKT_RX
  KIND_PKT_RX at dst: socket demux, then the app's on_recv callback
      (UDP: byte count first; TCP: segment processing through the
      installed `transport.tcp.TCP`, which counts delivered bytes)

With `fuse_rx` the delivery runs inside KIND_PKT_ARRIVE at the NIC's
finish instant: its emits shift by finish - now, so every output time
matches the two-event pipeline.

Packet metadata rides the event's i32 args; payload bytes never exist,
only lengths. The arrival stashes the true source id in the A_SRC word,
since the local ARRIVE -> RX re-emit carries the host itself as source.

Every handler runs over all hosts at once: `hs` is a SimHost of
[H, ...] tensors, `ev` an Events of [H] fields, `key` [H, 2], and the
Emit has [H, K] fields.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from shadow_tpu_torch.core import rng as srng
from shadow_tpu_torch.core.engine import (
    BURST_LEN_MASK,
    BURST_NSEG_SHIFT,
    Emit,
    _select_rows,
)
from shadow_tpu_torch.core.events import Events
from shadow_tpu_torch.host.nic import HEADER_TCP, HEADER_UDP, MTU, NIC, CoDel
from shadow_tpu_torch.host.sockets import PROTO_TCP, PROTO_UDP, SocketTable

# ---------------------------------------------------------------------------
# Packet arg layout: 11 i32 words.
N_PKT_ARGS = 11
A_META = 0  # proto | tcp flags (bit-packed)
A_SPORT = 1
A_DPORT = 2
A_SEQ = 3  # TCP: segment sequence number (in segments)
A_ACK = 4  # TCP: cumulative ack (in segments)
A_LEN = 5  # payload bytes
A_WND = 6  # TCP: advertised receive window (segments)
A_AUX = 7  # timestamp echo (ms) / app payload word
A_SRC = 8  # original source host id (stashed across the local rx re-emit)
A_SACK0 = 9  # TCP: SACK bitmap rel. to ack, bits 0-31
A_SACK1 = 10  # TCP: SACK bitmap bits 32-63

F_SYN = 1 << 2
F_ACK = 1 << 3
F_FIN = 1 << 4
F_RST = 1 << 5
F_RETX = 1 << 6  # sender-stamped retransmission

KIND_PKT_ARRIVE = 0
KIND_PKT_RX = 1
N_STACK_KINDS = 2

_I32 = torch.int32
_I64 = torch.int64


def _rows(v, like: torch.Tensor, dtype) -> torch.Tensor:
    """A scalar or [H] value as an [H] tensor of `dtype` beside `like`
    (a scalar is filled on the device, never copied from the host)."""
    if isinstance(v, torch.Tensor):
        return v.to(dtype).expand(like.shape[:1])
    return torch.full(like.shape[:1], v, dtype=dtype, device=like.device)


def _sel(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a[h, c[h]] from an [H, S] tensor; out-of-range c clamps, as JAX
    indexing does."""
    idx = torch.clamp(c, 0, a.shape[1] - 1).long()
    return torch.gather(a, 1, idx[:, None])[:, 0]


@dataclasses.dataclass(frozen=True)
class Pkt:
    """Decoded packet metadata, [H] tensors.

    `sack` is the 64-bit SACK bitmap held as int64 (the reference's u64
    with the same bits).
    """

    proto: torch.Tensor
    flags: torch.Tensor
    src_host: torch.Tensor
    src_port: torch.Tensor
    dst_port: torch.Tensor
    seq: torch.Tensor
    ack: torch.Tensor
    length: torch.Tensor
    wnd: torch.Tensor
    aux: torch.Tensor
    sack: torch.Tensor
    # a burst-folded packet stands for `nseg` contiguous segments
    # totalling `length` bytes; 1 for every packet the fold never touched
    nseg: torch.Tensor

    @staticmethod
    def decode(ev: Events) -> "Pkt":
        """Decode KIND_PKT_RX events (src from the stashed arg word)."""
        a = ev.args
        w = lambda i: a[:, i]
        lo = w(A_SACK0).to(_I64) & 0xFFFFFFFF
        return Pkt(
            proto=w(A_META) & 0x3,
            flags=w(A_META),
            src_host=w(A_SRC),
            src_port=w(A_SPORT),
            dst_port=w(A_DPORT),
            seq=w(A_SEQ),
            ack=w(A_ACK),
            length=w(A_LEN) & BURST_LEN_MASK,
            wnd=w(A_WND),
            aux=w(A_AUX),
            nseg=torch.clamp(w(A_LEN) >> BURST_NSEG_SHIFT, min=1),
            sack=lo | (w(A_SACK1).to(_I64) << 32),
        )

    @staticmethod
    def encode_args(proto, sport, dport, seq=0, ack=0, length=0, wnd=0,
                    aux=0, flags=0, sack=0) -> torch.Tensor:
        """i32[H, N_PKT_ARGS] args for an Emit; each field a scalar or an
        [H] tensor, at least one a tensor. `sack` is int64 bits."""
        fields = (proto, sport, dport, seq, ack, length, wnd, aux, flags,
                  sack)
        ref = next(f for f in fields if isinstance(f, torch.Tensor))
        shapes = {f.shape for f in fields if isinstance(f, torch.Tensor)}
        # one shape, the common case, needs no broadcast (whose Python
        # reference implementation costs a fifth of a millisecond a call)
        shape = (shapes.pop() if len(shapes) == 1
                 else torch.broadcast_shapes(*shapes))
        out = torch.zeros(shape + (N_PKT_ARGS,), dtype=_I32,
                          device=ref.device)
        # each word is written cast to i32 (wrapping, as .to would)
        words = ((A_META, proto | flags), (A_SPORT, sport), (A_DPORT, dport),
                 (A_SEQ, seq), (A_ACK, ack), (A_LEN, length), (A_WND, wnd),
                 (A_AUX, aux))
        if isinstance(sack, torch.Tensor):
            words += ((A_SACK0, sack & 0xFFFFFFFF), (A_SACK1, sack >> 32))
        elif sack:
            raise ValueError("a SACK word must be an int64 tensor")
        for i, v in words:
            if isinstance(v, torch.Tensor):
                out[..., i] = v
            elif v != 0:
                out[..., i].fill_(v)  # on the device, not from the host
        return out


@dataclasses.dataclass(frozen=True)
class HostNet:
    """Per-host network state, [H]-leading: NIC both ways, the upstream
    router's AQM, the socket table and, when TCP is installed, the
    connection table `tcb` ([H, S] `transport.tcp.TCB`), and the packet
    capture rings `cap` (`utils.pcap.CaptureRing`) when a host captures."""

    nic_tx: NIC
    nic_rx: NIC
    codel: CoDel
    sockets: SocketTable
    tcb: Any = None
    cap: Any = None

    @staticmethod
    def create(n_hosts: int, n_sockets: int, bw_up_kib, bw_down_kib,
               with_tcp: bool = False, rcv_wnd_bytes=None,
               wnd_words: int | None = None, rx_buf_bytes=0,
               snd_buf_bytes=None, *, device) -> "HostNet":
        """Idle NICs at the given KiB/s bandwidths (scalars or [H]) with
        an rx drop-tail bound (0 = none), closed sockets and, with
        `with_tcp`, a closed connection table: `rcv_wnd_bytes` ([H], 0 =
        none) caps each host's autotuned receive window at its segment
        count, `wnd_words` sizes the reassembly bitmap, `snd_buf_bytes`
        ([H]) bounds the send buffer."""
        tcb = None
        if with_tcp:
            from shadow_tpu_torch.transport.tcp import MSS, TCB, WND_WORDS

            ww = wnd_words or WND_WORDS
            cap_max = 64 * ww
            rcv_wnd = None
            if rcv_wnd_bytes is not None:
                rb = torch.as_tensor(rcv_wnd_bytes, dtype=torch.int64)
                rcv_wnd = torch.where(rb > 0,
                                      torch.clamp(rb // MSS, 1, cap_max),
                                      cap_max).to(torch.int32)
            tcb = TCB.create(n_hosts, n_sockets, rcv_wnd=rcv_wnd,
                             wnd_words=ww, snd_cap=snd_buf_bytes,
                             device=device)
        f64 = torch.float64
        up = torch.as_tensor(bw_up_kib, dtype=f64).to(device).expand(n_hosts)
        down = torch.as_tensor(bw_down_kib, dtype=f64).to(device).expand(
            n_hosts)
        return HostNet(
            nic_tx=NIC.create(up),
            nic_rx=NIC.create(down, buf_bytes=rx_buf_bytes),
            codel=CoDel.create(n_hosts, device=device),
            sockets=SocketTable.create(n_hosts, n_sockets, device=device),
            tcb=tcb,
        )


@dataclasses.dataclass(frozen=True)
class SimHost:
    """Default host-state shape: network stack + app state."""

    net: HostNet
    app: Any


# App receive callback: (hs, slot i32[H], Pkt, now i64[H], key [H, 2]) ->
# (hs', Emit[H, K]). It sees the whole host state, so replies can go
# straight through Stack.send_udp.
OnRecvHost = Callable[[Any, torch.Tensor, Pkt, torch.Tensor, torch.Tensor],
                      tuple[Any, Emit]]


class Stack:
    """Builds the packet-pipeline handlers and the send path.

    Host state seen by handlers must have `.net: HostNet` and `.app`
    (SimHost or any such dataclass).
    """

    def __init__(self, *, bootstrap_end: int = 0, tcp=None,
                 rx_queue: str = "codel", fuse_rx: bool = False):
        """`tcp` is the TCP hook (a `transport.tcp.TCP`) or None.
        rx_queue selects the upstream router's queue manager: 'codel'
        (AQM, the default), 'static' (drop-tail against the NIC buffer
        bound) or 'single' (one packet queued at a time). fuse_rx folds
        the KIND_PKT_RX delivery into KIND_PKT_ARRIVE (one event per
        packet hop); output times stay exact, while socket and app state
        are read at arrival rather than at the NIC's finish time."""
        if rx_queue not in ("codel", "static", "single"):
            raise ValueError(f"unknown rx_queue {rx_queue!r}")
        self.bootstrap_end = bootstrap_end  # unlimited-bandwidth phase end
        self.tcp = tcp
        self.rx_queue = rx_queue
        self.fuse_rx = fuse_rx

    # ---------------------------------------------------------------- send
    def send_udp(self, hs, now, slot, dst_host, dst_port, nbytes, aux=0,
                 mask=True):
        """One UDP datagram per row through the tx NIC; returns
        (hs', Emit[H, 1]). Rows where `mask` is False send nothing and
        leave the NIC and socket untouched."""
        net: HostNet = hs.net
        mask = _rows(mask, now, torch.bool)
        slot = _rows(slot, now, _I32)
        nbytes = _rows(nbytes, now, _I32)
        unlimited = now < self.bootstrap_end
        wire = nbytes + HEADER_UDP
        nic_tx, _start, finish = net.nic_tx.admit(now, wire, unlimited)
        # only advance the NIC clock if this send actually happens
        nic_tx = _select_rows(mask, nic_tx, net.nic_tx)
        sport = _sel(net.sockets.local_port, slot)
        # socket counters count app payload; the NIC counts the wire
        sockets = net.sockets.add_tx(torch.where(mask, slot, -1), nbytes)
        cap = net.cap
        if cap is not None:
            # the tx-side record on the sender's ring
            from shadow_tpu_torch.utils.pcap import STG_SENT

            cap = _select_rows(mask, cap.append(
                now, -1, _rows(dst_host, now, _I32), sport,
                _rows(dst_port, now, _I32), PROTO_UDP, nbytes, 0, 0,
                STG_SENT), cap)
        hs = dataclasses.replace(hs, net=dataclasses.replace(
            net, nic_tx=nic_tx, sockets=sockets, cap=cap))
        args = Pkt.encode_args(PROTO_UDP, sport, dst_port, length=nbytes,
                               aux=aux)
        em = Emit.single(dst=_rows(dst_host, now, _I32), dt=finish - now,
                         kind=KIND_PKT_ARRIVE, args=args, mask=mask,
                         n_args=N_PKT_ARGS)
        return hs, em

    # ------------------------------------------------------------ handlers
    def make_handlers(self, on_recv: OnRecvHost):
        """[KIND_PKT_ARRIVE, KIND_PKT_RX] handlers, then TCP's
        [KIND_TCP_TIMER, KIND_TCP_TX] when a TCP hook is installed;
        `on_recv` runs for every demuxed UDP delivery and every TCP app
        delivery."""

        def on_arrive(hs, ev: Events, key):
            # router enqueue, rx-NIC scheduling and the CoDel verdict: the
            # packet reached the host edge at ev.time, its rx start is the
            # NIC's virtual clock, and start - arrival is the standing
            # queue delay CoDel controls on
            net: HostNet = hs.net
            now = ev.time
            a = ev.args
            # rate-limit on wire bytes (payload + header), as the tx side
            proto = a[:, A_META] & 0x3
            header = torch.where(proto == PROTO_TCP, HEADER_TCP,
                                 HEADER_UDP).to(_I32)
            # a burst-folded arrival stands for nseg wire packets
            nseg = torch.clamp(a[:, A_LEN] >> BURST_NSEG_SHIFT, min=1)
            paylen = a[:, A_LEN] & BURST_LEN_MASK
            wire = paylen + torch.where(paylen > 0, nseg, 1) * header
            unlimited = now < self.bootstrap_end
            # drop-tail against the NIC receive buffer (0 = unbounded);
            # 'single' holds one in-service packet
            backlog = net.nic_rx.backlog_bytes(now)
            if self.rx_queue == "single":
                tail_drop = backlog > MTU
            else:
                tail_drop = (net.nic_rx.buf_bytes > 0) & (
                    backlog + wire > net.nic_rx.buf_bytes)
            tail_drop = tail_drop & ~unlimited
            nic_rx, start, finish = net.nic_rx.admit(now, wire, unlimited)
            sojourn = start - now
            if self.rx_queue == "codel":
                codel, aqm_drop = net.codel.on_dequeue(start, sojourn)
                codel = _select_rows(unlimited | tail_drop, net.codel, codel)
            else:
                codel, aqm_drop = net.codel, torch.zeros_like(tail_drop)
            drop = (aqm_drop & ~unlimited) | tail_drop
            # a dropped packet never occupies the link
            nic_rx = _select_rows(drop, net.nic_rx, nic_rx)
            nic_rx = dataclasses.replace(
                nic_rx, drops=nic_rx.drops + tail_drop.to(_I64))
            cap = net.cap
            if cap is not None:
                # the arrival record, its stage bitmask the packet's path
                from shadow_tpu_torch.utils import pcap

                bit = lambda c, v: torch.where(c, v, 0)
                stages = (pcap.STG_ARRIVED
                          | bit(sojourn > 0, pcap.STG_QUEUED)
                          | bit(tail_drop, pcap.STG_TAIL_DROP)
                          | bit(drop & ~tail_drop, pcap.STG_AQM_DROP)
                          | bit(~drop, pcap.STG_DELIVERED)
                          | bit((a[:, A_META] & F_RETX) != 0, pcap.STG_RETX))
                cap = cap.append(now, ev.src, ev.dst, a[:, A_SPORT],
                                 a[:, A_DPORT], a[:, A_META],
                                 a[:, A_LEN] & BURST_LEN_MASK, a[:, A_SEQ],
                                 a[:, A_ACK], stages)
            hs = dataclasses.replace(hs, net=dataclasses.replace(
                net, nic_rx=nic_rx, codel=codel, cap=cap))
            args = a.clone()
            args[:, A_SRC] = ev.src  # stash the true source
            if not self.fuse_rx:
                em = Emit.single(dst=ev.dst, dt=finish - now,
                                 kind=KIND_PKT_RX, args=args, mask=~drop,
                                 local=True, n_args=N_PKT_ARGS)
                return hs, em
            # fused delivery at the NIC-finish instant; a dropped packet
            # delivers nothing and leaves delivery state untouched. The
            # delivery draws from its own key stream.
            rx_ev = dataclasses.replace(
                ev, time=finish, args=args,
                kind=torch.full_like(ev.kind, KIND_PKT_RX))
            hs2, em = deliver(hs, rx_ev, srng.fold_in(key, 0x52580001))
            hs = _select_rows(drop, hs, hs2)
            em = dataclasses.replace(
                em, dt=em.dt + (finish - now)[:, None],
                mask=em.mask & ~drop[:, None])
            return hs, em

        def deliver(hs, ev: Events, key):
            # socket demux, byte count, app callback
            net: HostNet = hs.net
            pkt = Pkt.decode(ev)
            slot = net.sockets.demux(pkt.proto, pkt.dst_port, pkt.src_host,
                                     pkt.src_port)
            if self.tcp is not None:
                # TCP counts delivered bytes itself and routes UDP on
                return self.tcp.process_segment(self, hs, slot, pkt, ev, key,
                                                on_recv)
            sockets = net.sockets.add_rx(slot, pkt.length)
            hs = dataclasses.replace(
                hs, net=dataclasses.replace(net, sockets=sockets))
            return on_recv(hs, slot, pkt, ev.time, key)

        def on_rx(hs, ev: Events, key):
            if self.fuse_rx:
                # deliveries ride inside on_arrive; nothing emits
                # KIND_PKT_RX, but the handler still runs over every row,
                # so it is a stub, not a second copy of the delivery
                return hs, Emit.none(ev.time.shape[0], 1, N_PKT_ARGS,
                                     device=ev.time.device)
            return deliver(hs, ev, key)

        handlers = [on_arrive, on_rx]
        if self.tcp is not None:
            handlers += self.tcp.make_handlers(self)
        return handlers

    def frontier_kinds(self) -> tuple:
        """Stack kinds that may form multi-position runs on the frontier
        drain, whose run rule needs every local emit at dt >= 1: the
        fused arrival (its follow-ups go through helpers that floor the
        delay at 1 ns) and TCP's timer and tx kinds. KIND_PKT_RX is
        absent: fused it never runs, and unfused mode is refused, since
        the bootstrap-phase ARRIVE -> RX re-emit can land at dt = 0."""
        fk = (KIND_PKT_ARRIVE,)
        if self.tcp is not None:
            fk += (N_STACK_KINDS, N_STACK_KINDS + 1)  # tcp_timer, tcp_tx
        return fk
