"""The device side of the real-binary process tier.

The counterpart of `shadow_tpu.proc.model`. The native runtime's syscall
requests become injected command events, which this model's handler
executes against the device stack (bind, listen, connect, send and close
on TCP; bind, sendto and close on UDP). The tier (`proc/tier.py`)
observes the outcomes each window by diffing the device socket and TCB
tables. Only metadata runs on the device: the payload bytes stay in the
native runtime's per-fd streams.
"""

from __future__ import annotations

import dataclasses

import torch

from shadow_tpu_torch.core.engine import Emit
from shadow_tpu_torch.core.events import Events
from shadow_tpu_torch.host.sockets import PROTO_NONE, PROTO_TCP, PROTO_UDP
from shadow_tpu_torch.transport.stack import F_FIN, N_PKT_ARGS, _sel
from shadow_tpu_torch.transport.tcp import LISTEN as TCP_LISTEN
from shadow_tpu_torch.transport.tcp import _put, emit_concat

_I32 = torch.int32

# command words (args[0] of an injected command event)
CMD_LISTEN = 1    # args: [cmd, slot, port]
CMD_CONNECT = 2   # args: [cmd, slot, sport, peer_gid, peer_port]
CMD_SEND = 3      # args: [cmd, slot, nbytes]
CMD_CLOSE = 4     # args: [cmd, slot]
CMD_UDP_BIND = 5  # args: [cmd, slot, port]
CMD_SENDTO = 6    # args: [cmd, slot, dst_gid, dst_port, nbytes, seq]
CMD_UDP_CLOSE = 7  # args: [cmd, slot]

# per-host UDP delivery ring depth: the datagrams one host may receive
# between two observes (one window); the tier raises on overflow
UDP_RING = 64


@dataclasses.dataclass(frozen=True)
class ProcApp:
    """Per-host observation state ([H] / [H, S] / [H, R])."""

    gid: torch.Tensor  # i32[H]
    fin_seen: torch.Tensor  # bool[H, S]: stream EOF consumed per socket
    # i32[H, S]: the connection incarnation fin_seen belongs to (a child
    # slot reused on the device bumps tcb.conn_gen with no bind from the
    # host, so a sticky fin_seen of the previous connection is reset
    # lazily at the new incarnation's first delivery)
    fin_gen: torch.Tensor
    # the UDP delivery ring: each delivered datagram appends (src gid,
    # src port, dst port, length, sender seq) for the tier to drain
    udp_cnt: torch.Tensor  # i32[H]: datagrams ever delivered
    udp_src: torch.Tensor  # i32[H, R]
    udp_sport: torch.Tensor  # i32[H, R]
    udp_dport: torch.Tensor  # i32[H, R]
    udp_len: torch.Tensor  # i32[H, R]
    udp_seq: torch.Tensor  # i32[H, R]


class ProcTierModel:
    """The app model that executes native-process commands on the
    device stack (see `shadow_tpu_torch.sim.AppModel`)."""

    name = "shim"
    needs_tcp = True
    n_kinds = 1
    # the tier stops individual green threads at their stoptime; the
    # per-host muting of modeled apps would freeze the whole host's TCP
    owns_process_lifecycle = True

    def __init__(self):
        self._stack = None
        self.kind_cmd = None  # absolute kind index, set by make_handlers

    def app_rows(self) -> int:
        return 1

    def handler_rows(self) -> int:
        return 5  # connect (2) + send kick (1) + close kick (1) + udp (1)

    def build(self, b):
        n, dev = b.n_hosts, b.device
        zr = torch.zeros((n, UDP_RING), dtype=_I32, device=dev)
        state = ProcApp(
            gid=torch.arange(n, dtype=_I32, device=dev),
            fin_seen=torch.zeros((n, b.n_sockets), dtype=torch.bool,
                                 device=dev),
            fin_gen=torch.zeros((n, b.n_sockets), dtype=_I32, device=dev),
            udp_cnt=torch.zeros((n,), dtype=_I32, device=dev),
            udp_src=zr, udp_sport=zr, udp_dport=zr, udp_len=zr, udp_seq=zr,
        )
        return state, self._make_handlers, self._on_recv

    def _make_handlers(self, stack, kind_base):
        self._stack = stack
        self.kind_cmd = kind_base
        return [self._on_cmd]

    def _on_cmd(self, hs, ev: Events, key):
        stack, tcp = self._stack, self._stack.tcp
        args = ev.args
        cmd = args[:, 0]
        slot = torch.clamp(args[:, 1], min=0)
        is_listen = cmd == CMD_LISTEN
        is_conn = cmd == CMD_CONNECT
        is_ubind = cmd == CMD_UDP_BIND
        is_uclose = cmd == CMD_UDP_CLOSE

        # bind the socket row in place: bind installs the demux row, a
        # UDP close clears it
        sk = hs.net.sockets
        do_bind = is_listen | is_conn | is_ubind | is_uclose
        port = torch.where(is_uclose, 0, args[:, 2])
        proto = torch.where(is_ubind, PROTO_UDP,
                            torch.where(is_uclose, PROTO_NONE, PROTO_TCP))
        w = lambda a, v: _put(a, slot, v, do_bind)
        sk = dataclasses.replace(
            sk,
            proto=w(sk.proto, proto),
            local_port=w(sk.local_port, port),
            peer_host=w(sk.peer_host, torch.where(is_conn, args[:, 3], -1)),
            peer_port=w(sk.peer_port, torch.where(is_conn, args[:, 4], 0)),
        )
        tcb = hs.net.tcb
        tcb = dataclasses.replace(
            tcb, state=_put(tcb.state, slot, TCP_LISTEN, is_listen))
        fin_clear = _put(hs.app.fin_seen, slot, False, do_bind)
        hs = dataclasses.replace(
            hs,
            app=dataclasses.replace(hs.app, fin_seen=fin_clear),
            net=dataclasses.replace(hs.net, sockets=sk, tcb=tcb),
        )

        hs, em_conn = tcp.connect(stack, hs, slot, ev.time, mask=is_conn)
        hs, em_send = tcp.send(hs, slot, args[:, 2], ev.time,
                               mask=cmd == CMD_SEND)
        hs, em_close = tcp.close(hs, slot, ev.time, mask=cmd == CMD_CLOSE)
        hs, em_udp = stack.send_udp(
            hs, ev.time, slot, args[:, 2], args[:, 3], args[:, 4],
            aux=args[:, 5], mask=cmd == CMD_SENDTO)
        return hs, emit_concat(em_conn, em_send, em_close, em_udp)

    def _on_recv(self, hs, slot, pkt, now, key):
        got = slot >= 0
        app = hs.app

        # a UDP datagram appends a delivery record to the ring the tier
        # drains each window (its payload moves on the host by seq)
        is_udp = got & (pkt.proto == PROTO_UDP)
        idx = torch.where(is_udp, app.udp_cnt % UDP_RING, 0)
        wr = lambda a, v: _put(a, idx, v, is_udp)
        app = dataclasses.replace(
            app,
            udp_cnt=app.udp_cnt + is_udp.to(_I32),
            udp_src=wr(app.udp_src, pkt.src_host),
            udp_sport=wr(app.udp_sport, pkt.src_port),
            udp_dport=wr(app.udp_dport, pkt.dst_port),
            udp_len=wr(app.udp_len, pkt.length),
            udp_seq=wr(app.udp_seq, pkt.aux),
        )

        eof = got & ~is_udp & ((pkt.flags & F_FIN) != 0)
        s = torch.clamp(slot, min=0)
        # lazy per-incarnation reset: a slot whose TCB was reused since
        # fin_seen was written holds the previous connection's EOF
        cur_gen = _sel(hs.net.tcb.conn_gen, s)
        stale = got & (_sel(app.fin_gen, s) != cur_gen)
        fin0 = torch.where(stale, False, _sel(app.fin_seen, s))
        fin = _put(app.fin_seen, s, torch.where(eof, True, fin0), got)
        fgen = _put(app.fin_gen, s, cur_gen, got)
        hs = dataclasses.replace(
            hs, app=dataclasses.replace(app, fin_seen=fin, fin_gen=fgen))
        return hs, Emit.none(now.shape[0], 1, N_PKT_ARGS, device=now.device)
