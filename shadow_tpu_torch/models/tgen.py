"""A TGen-like traffic generator over TCP.

The counterpart of `shadow_tpu.models.tgen`. A *server* host binds a TCP
listener on `serverport` at process start. A *client* host runs `count`
sequential streams against its peers, round-robin: each stream opens a
fresh connection on a fresh ephemeral port, sends `sendsize` bytes and
half-closes. The server answers the stream's EOF with the client's
configured `recvsize` bytes (read from the build-time table by the
client's id, since packets carry no app bytes) and closes. The client
counts reply bytes; on completion it waits `pause` (cycling through the
choices) and starts the next stream.

As in the reference: a zero sendsize goes out as 1 byte, a host runs
one outbound stream at a time, and pauses cycle instead of being drawn.

Arguments per <process>: a path to a tgen GraphML file, or an inline
'k=v' string such as `server port=8888` or `peers=server:8888,b:80
sendsize=1MiB recvsize=1MiB count=10 pause=1,2,3 time=0`.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from shadow_tpu_torch.config import (
    parse_kv_arguments,
    parse_size,
    resolve_path,
)
from shadow_tpu_torch.core.engine import Emit
from shadow_tpu_torch.core.events import Events
from shadow_tpu_torch.core.timebase import SECOND
from shadow_tpu_torch.host.sockets import EPHEMERAL_BASE, PROTO_TCP
from shadow_tpu_torch.net.topology import jax_index
from shadow_tpu_torch.transport.stack import F_FIN, N_PKT_ARGS
from shadow_tpu_torch.transport.tcp import emit_concat

_I32 = torch.int32
_I64 = torch.int64


@dataclasses.dataclass
class TGenProfile:
    """One host's parsed tgen behavior."""

    server_port: int = -1  # >= 0: listen
    peers: list[tuple[str, int]] = dataclasses.field(default_factory=list)
    sendsize: int = 0
    recvsize: int = 0
    count: int = 1
    pause_s: list[float] = dataclasses.field(default_factory=lambda: [1.0])
    start_delay_s: float = 0.0


def _peer_list(text: str) -> list[tuple[str, int]]:
    return [(p.rsplit(":", 1)[0], int(p.rsplit(":", 1)[1]))
            for p in text.split(",") if p.strip()]


def parse_tgen_graphml(text: str) -> TGenProfile:
    """The subset of the tgen action-graph format the model reads: start
    (serverport, peers, time), stream or legacy transfer (sendsize,
    recvsize; type + filesize), pause (time list) and end (count)."""
    import networkx as nx

    g = nx.parse_graphml(text)
    prof = TGenProfile()
    for nid, a in g.nodes(data=True):
        nid_l = str(nid).lower()
        if nid_l.startswith("start"):
            if "serverport" in a:
                prof.server_port = int(a["serverport"])
            if "peers" in a:
                prof.peers = _peer_list(str(a["peers"]))
            if "time" in a:
                prof.start_delay_s = float(str(a["time"]).split(",")[0])
        elif nid_l.startswith("stream") or nid_l.startswith("transfer"):
            if "sendsize" in a:
                prof.sendsize = parse_size(a["sendsize"])
            if "recvsize" in a:
                prof.recvsize = parse_size(a["recvsize"])
            if "filesize" in a:
                size = parse_size(a["filesize"])
                if str(a.get("type", "get")).lower() == "get":
                    prof.recvsize = size
                else:
                    prof.sendsize = size
        elif nid_l.startswith("pause"):
            if "time" in a:
                prof.pause_s = [float(t) for t in str(a["time"]).split(",")
                                if t.strip()]
        elif nid_l.startswith("end"):
            if "count" in a:
                prof.count = int(a["count"])
    return prof


def parse_arguments(args: str, base_dir: str) -> TGenProfile:
    """A process's arguments: a GraphML path or inline k=v pairs."""
    args = args.strip()
    if args and " " not in args and (
        args.endswith(".xml") or args.endswith(".graphml")
    ):
        path = resolve_path(args, base_dir)
        if os.path.exists(path):
            with open(path) as f:
                return parse_tgen_graphml(f.read())
        raise FileNotFoundError(f"tgen graph file not found: {args!r}")
    kv = parse_kv_arguments(args)
    prof = TGenProfile()
    if "server" in kv or "serverport" in kv:
        prof.server_port = int(kv.get("serverport") or kv.get("port", 8888))
    if "peers" in kv:
        prof.peers = _peer_list(kv["peers"])
    if "sendsize" in kv:
        prof.sendsize = parse_size(kv["sendsize"])
    if "recvsize" in kv:
        prof.recvsize = parse_size(kv["recvsize"])
    if "count" in kv:
        prof.count = int(kv["count"])
    if "pause" in kv:
        prof.pause_s = [float(t) for t in kv["pause"].split(",") if t.strip()]
    if "time" in kv:
        prof.start_delay_s = float(kv["time"])
    return prof


@dataclasses.dataclass(frozen=True)
class TGenState:
    """Per-host app state, [H] tensors. `gid` is the host's own id, by
    which the handlers read the build-time tables."""

    gid: torch.Tensor  # i32
    streams_started: torch.Tensor  # i32
    streams_done: torch.Tensor  # i32
    conn_rx: torch.Tensor  # i64 bytes received on the current stream
    t_last_done: torch.Tensor  # i64 sim time the last stream completed


class TGenModel:
    """The `tgen` app model (see `shadow_tpu_torch.sim.AppModel`)."""

    name = "tgen"
    needs_tcp = True
    n_kinds = 1  # KIND_STREAM: start or continue the client stream loop

    def __init__(self):
        self._stack = None
        self._kind_stream = None

    def app_rows(self) -> int:
        return 3  # server: reply send + close; client: next-stream event

    def handler_rows(self) -> int:
        return 4  # connect (2) + send (1) + close (1)

    def build(self, b):
        """Parse every host's profile, bind the servers' listeners in
        slot 0, schedule the process starts and build the tables."""
        n = b.n_hosts
        server_port = np.full((n,), -1, np.int32)
        sendsize = np.zeros((n,), np.int64)
        recvsize = np.zeros((n,), np.int64)
        count = np.zeros((n,), np.int32)
        profiles: list[TGenProfile | None] = [None] * n

        for h in b.hosts:
            if len(h.spec.processes) > 1:
                # profiles are per host and a client owns one stream slot
                raise ValueError(
                    f"host {h.name!r} declares {len(h.spec.processes)} tgen "
                    "processes; the tgen model supports one per host")
            for proc in h.spec.processes:
                prof = parse_arguments(proc.arguments, b.cfg.base_dir)
                profiles[h.gid] = prof
                server_port[h.gid] = prof.server_port
                sendsize[h.gid] = max(prof.sendsize, 1)
                recvsize[h.gid] = prof.recvsize
                count[h.gid] = prof.count if prof.peers else 0
                b.add_start_event(h.gid, proc.starttime + prof.start_delay_s,
                                  0)

        max_peers = max((len(p.peers) for p in profiles if p), default=0) or 1
        peer_gid = np.zeros((n, max_peers), np.int32)
        peer_port = np.zeros((n, max_peers), np.int32)
        n_peers = np.zeros((n,), np.int32)
        max_pause = max((len(p.pause_s) for p in profiles if p),
                        default=0) or 1
        pause_ns = np.full((n, max_pause), SECOND, np.int64)
        n_pause = np.ones((n,), np.int32)
        for h in b.hosts:
            prof = profiles[h.gid]
            if prof is None:
                continue
            for j, (pname, pport) in enumerate(prof.peers):
                peer_gid[h.gid, j] = b.resolve_gid(pname)
                peer_port[h.gid, j] = pport
            n_peers[h.gid] = len(prof.peers)
            for j, t in enumerate(prof.pause_s):
                pause_ns[h.gid, j] = int(t * SECOND)
            n_pause[h.gid] = max(len(prof.pause_s), 1)

        # listeners bind in slot 0 at build time
        for gid in range(n):
            if server_port[gid] >= 0:
                b.sockets = b.sockets.bind(gid, 0, PROTO_TCP,
                                           int(server_port[gid]))
                b.tcb = b.tcb.listen(gid, 0)

        dev = b.device
        on = lambda a: torch.from_numpy(a).to(dev)
        self._g = dict(peer_gid=on(peer_gid), peer_port=on(peer_port),
                       n_peers=on(n_peers), sendsize=on(sendsize),
                       recvsize=on(recvsize), count=on(count),
                       pause_ns=on(pause_ns), n_pause=on(n_pause))
        # the client-stream slot is the last one; passive-open children
        # take the first free slots from 0, so the two never meet
        self._cs = b.n_sockets - 1
        # frontier-drain eligibility: inter-stream pauses are this model's
        # only local emit delays; unused table rows keep the SECOND
        # default, so the check covers exactly the configured clients
        self._frontier_safe = bool((pause_ns >= 1).all())
        z32 = torch.zeros((n,), dtype=_I32, device=dev)
        state = TGenState(
            gid=torch.arange(n, dtype=_I32, device=dev),
            streams_started=z32, streams_done=z32,
            conn_rx=torch.zeros((n,), dtype=_I64, device=dev),
            t_last_done=torch.zeros((n,), dtype=_I64, device=dev),
        )
        return state, self._make_handlers, self._on_recv

    @property
    def frontier_safe(self) -> bool:
        """True when every local emit delay this build can schedule is
        >= 1 ns: the frontier drain's run-rule invariant."""
        return getattr(self, "_frontier_safe", False)

    def frontier_kinds(self) -> tuple:
        """Model kinds eligible for multi-position frontier runs (all of
        them: KIND_STREAM's emits are pause-delayed or TCP-floored)."""
        return tuple(range(self.n_kinds))

    # ---------------------------------------------------------- handlers
    def _make_handlers(self, stack, kind_base):
        self._stack = stack
        self._kind_stream = kind_base
        return [self._on_stream]

    def _on_stream(self, hs, ev: Events, key):
        """KIND_STREAM: open the next outbound stream (clients only)."""
        stack, tcp, g, cs = self._stack, self._stack.tcp, self._g, self._cs
        app: TGenState = hs.app
        me = app.gid.long()
        n_peers = g["n_peers"][me]
        ok = (n_peers > 0) & (app.streams_started < g["count"][me])
        idx = app.streams_started
        pidx = (idx % torch.clamp(n_peers, min=1)).long()
        peer = g["peer_gid"][me, pidx]
        pport = g["peer_port"][me, pidx]
        sport = EPHEMERAL_BASE + idx

        # rebind the client slot for a fresh connection on a fresh
        # ephemeral port per stream
        sk = hs.net.sockets

        def w(a, v):
            a = a.clone()
            a[:, cs] = torch.where(ok, v, a[:, cs])
            return a

        sk = dataclasses.replace(
            sk, proto=w(sk.proto, PROTO_TCP),
            local_port=w(sk.local_port, sport),
            peer_host=w(sk.peer_host, peer), peer_port=w(sk.peer_port, pport))
        app = dataclasses.replace(
            app, streams_started=app.streams_started + ok.to(_I32),
            conn_rx=torch.where(ok, 0, app.conn_rx))
        hs = dataclasses.replace(
            hs, app=app, net=dataclasses.replace(hs.net, sockets=sk))
        hs, em1 = tcp.connect(stack, hs, cs, ev.time, mask=ok)
        hs, em2 = tcp.send(hs, cs, g["sendsize"][me], ev.time, mask=ok)
        hs, em3 = tcp.close(hs, cs, ev.time, mask=ok)
        return hs, emit_concat(em1, em2, em3)

    def _on_recv(self, hs, slot, pkt, now, key):
        """A demuxed delivery: client reply accounting, server EOF reply."""
        tcp, g, cs = self._stack.tcp, self._g, self._cs
        app: TGenState = hs.app
        me = app.gid.long()
        got = slot >= 0
        eof = got & ((pkt.flags & F_FIN) != 0)
        is_client_sock = got & (slot == cs)

        # ---- client: count reply bytes, detect the stream's completion
        before = app.conn_rx
        after = before + torch.where(is_client_sock, pkt.length.to(_I64), 0)
        need = g["recvsize"][me]
        bytes_done = is_client_sock & (before < need) & (after >= need)
        eof_done = is_client_sock & eof & (after >= need)
        newly = (bytes_done | eof_done) & (
            app.streams_done < app.streams_started)
        done_idx = app.streams_done
        app = dataclasses.replace(
            app, conn_rx=after,
            streams_done=app.streams_done + newly.to(_I32),
            t_last_done=torch.where(newly, now, app.t_last_done))
        hs = dataclasses.replace(hs, app=app)

        # the next stream after the cycling pause choice
        more = newly & (app.streams_done < g["count"][me])
        pick = (done_idx % torch.clamp(g["n_pause"][me], min=1)).long()
        em_next = Emit.single(
            dst=torch.zeros_like(slot), dt=g["pause_ns"][me, pick],
            kind=self._kind_stream, mask=more, local=True, n_args=N_PKT_ARGS)

        # ---- server: answer the stream's EOF with the client's recvsize
        # (its row of the build-time table), then close
        do_reply = eof & ~is_client_sock
        reply_sz = g["recvsize"][jax_index(pkt.src_host,
                                             g["recvsize"].shape[0])]
        hs, em_s = tcp.send(hs, slot, reply_sz, now,
                            mask=do_reply & (reply_sz > 0))
        hs, em_c = tcp.close(hs, slot, now, mask=do_reply)
        return hs, emit_concat(em_s, em_c, em_next)
