"""A Tor-like onion-circuit model: multi-hop relayed TCP streams.

The counterpart of `shadow_tpu.models.tor`. It reproduces the traffic
shape of a Tor network (BASELINE.md configs 3-4): telescoped
client -> guard -> middle -> exit -> server TCP circuits, hop-by-hop
relaying with per-hop queueing, CoDel and congestion control, and
torperf-style fixed-size fetches, without Tor's cryptography:

- circuits are chosen at build time (client i's circuit id is i), and a
  relay learns a connection's circuit from its source port
  (CIRC_PORT_BASE + circuit id), in place of the onion-layer EXTEND
  handshake; hop positions come from a per-host circuit table;
- a client opens one circuit connection, sends a REQ_BYTES request cell
  per fetch, and the server answers each with `filesize` bytes that flow
  back through all three hops; `count` fetches per client with cycling
  `pause` gaps;
- relays move bytes: data arriving on one side of a circuit is re-sent
  on the other, and EOF propagates as a close.

Arguments per <process>:
  relay    [port=9001]                     onion relay (any position)
  server   [port=80]                       destination web server
  client   server=<name>[:port] filesize=5MiB count=10 pause=1,2
           relay pools come from hosts named guard*/middle*/exit*/relay*
"""

from __future__ import annotations

import dataclasses
import random as pyrandom

import numpy as np
import torch

from shadow_tpu_torch.config import parse_kv_arguments, parse_size
from shadow_tpu_torch.core.engine import Emit, _select_rows
from shadow_tpu_torch.core.events import Events
from shadow_tpu_torch.core.timebase import SECOND
from shadow_tpu_torch.host.sockets import PROTO_NONE, PROTO_TCP
from shadow_tpu_torch.transport.stack import (
    F_FIN,
    KIND_PKT_RX,
    N_PKT_ARGS,
    _sel,
)
from shadow_tpu_torch.transport.tcp import MSS, _put, emit_concat

_I32 = torch.int32
_I64 = torch.int64

OR_PORT = 9001  # default relay listen port
WEB_PORT = 80  # default server listen port
CIRC_PORT_BASE = 20_000  # sport CIRC_PORT_BASE + cid identifies the circuit
REQ_BYTES = 512  # one request "cell" (Tor's cell size)

# Relay crypto cost: cycles a relay core spends per forwarded byte (AES-CTR
# and a digest over ~2 onion layers). Charged per delivered segment at
# KIND_PKT_RX through the per-kind CPU table on hosts with a cpufrequency.
RELAY_CYCLES_PER_BYTE = 20

ROLE_NONE, ROLE_RELAY, ROLE_CLIENT, ROLE_SERVER = 0, 1, 2, 3


@dataclasses.dataclass(frozen=True)
class TorApp:
    """Per-host state, [H] / [H, S] / [H, CM] tensors.

    The circuit configuration is per host: a relay or server row carries
    its own [CM] list of (circuit id -> next hop / served filesize), and
    a client row its own fetch parameters, so every lookup is a one-hot
    match over CM lanes.
    """

    gid: torch.Tensor  # i32
    role: torch.Tensor  # i32
    fwd: torch.Tensor  # i32[S] circuit peer slot (-1 = none)
    req_rx: torch.Tensor  # i64[S] server: request bytes seen per conn
    streams_started: torch.Tensor  # i32 client
    streams_done: torch.Tensor  # i32 client
    conn_rx: torch.Tensor  # i64 client: reply bytes on the circuit conn
    t_last_done: torch.Tensor  # i64
    relayed_bytes: torch.Tensor  # i64 relay
    # client parameters (own row; -1 / 0 on non-clients)
    circ_id: torch.Tensor  # i32 this client's circuit id
    cl_guard: torch.Tensor  # i32 entry relay gid
    cl_file: torch.Tensor  # i64 fetch size (bytes)
    cl_count: torch.Tensor  # i32 fetches to run
    cl_pause: torch.Tensor  # i64[4] think-time cycle
    cl_npause: torch.Tensor  # i32 live entries in cl_pause
    # relay/server circuit table (first match wins, -1 = empty slot)
    tc_cid: torch.Tensor  # i32[CM]
    tc_nxt: torch.Tensor  # i32[CM] next-hop gid (relay rows)
    tc_port: torch.Tensor  # i32[CM] next-hop port
    tc_file: torch.Tensor  # i64[CM] served filesize (server rows)


def _tc_lookup(app: TorApp, cid: torch.Tensor):
    """(found, nxt_gid, nxt_port, filesize) of each row's `cid` in its own
    circuit table: a one-hot match over [H, CM], first match wins."""
    match = app.tc_cid == cid[:, None]
    first = torch.cumsum(match.to(_I32), dim=-1, dtype=_I32) == 1
    m = match & first

    def pick(a):
        return torch.sum(torch.where(m, a, 0), dim=-1, dtype=a.dtype)

    return m.any(dim=-1), pick(app.tc_nxt), pick(app.tc_port), \
        pick(app.tc_file)


def _last_free_slot(proto: torch.Tensor):
    """(slot, any free) per row of an [H, S] socket table: the highest
    free slot (passive-open children fill from 0 up), S - 1 when none."""
    free = proto == PROTO_NONE
    ns = free.shape[1]
    last = ns - 1 - torch.argmax(free.flip(1).to(_I32), dim=1)
    return last.to(_I32), free.any(dim=1)


class TorModel:
    """The `tor` app model (see `shadow_tpu_torch.sim.AppModel`)."""

    name = "tor"
    needs_tcp = True
    n_kinds = 1  # KIND_FETCH: open the circuit / issue the next fetch

    def __init__(self):
        self._stack = None
        self._kind_fetch = None

    def app_rows(self) -> int:
        # relay new circuit: connect (2) + forward send + forward close;
        # client: next-fetch event; server: reply send; the union is 4
        return 4

    def handler_rows(self) -> int:
        return 4  # client fetch: connect (2) + request send + spare

    # ------------------------------------------------------------- build
    def build(self, b):
        """Parse the roles, bind relay and server listeners in slot 0,
        draw the circuits and flatten them into per-host tables."""
        n = b.n_hosts
        role = np.zeros((n,), np.int32)
        pools: dict[str, list[int]] = {
            "guard": [], "middle": [], "exit": [], "relay": []}
        clients: list[tuple[int, dict]] = []

        for h in b.hosts:
            for proc in h.spec.processes:
                kv = parse_kv_arguments(proc.arguments)
                # a client line carries `server=<name>` as a key, so
                # "client" is checked first
                if "client" in kv:
                    role[h.gid] = ROLE_CLIENT
                    clients.append((h.gid, kv))
                    b.add_start_event(h.gid, proc.starttime, 0)
                elif "relay" in kv:
                    role[h.gid] = ROLE_RELAY
                    name = h.name.lower()
                    for p in ("guard", "middle", "exit"):
                        if name.startswith(p):
                            pools[p].append(h.gid)
                            break
                    else:
                        pools["relay"].append(h.gid)
                    port = int(kv.get("port", OR_PORT))
                    b.sockets = b.sockets.bind(h.gid, 0, PROTO_TCP, port)
                    b.tcb = b.tcb.listen(h.gid, 0)
                elif "server" in kv:
                    role[h.gid] = ROLE_SERVER
                    port = int(kv.get("port", WEB_PORT))
                    b.sockets = b.sockets.bind(h.gid, 0, PROTO_TCP, port)
                    b.tcb = b.tcb.listen(h.gid, 0)
                else:
                    raise ValueError(
                        f"tor process on {h.name!r} needs a role "
                        "(relay/server/client)")

        # circuit table: client i = circuit i, drawn from a fixed stream
        # (the role the directory consensus plays in real Tor)
        nc = max(len(clients), 1)
        hops = np.zeros((nc, 3), np.int32)
        srv_gid = np.zeros((nc,), np.int32)
        srv_port = np.full((nc,), WEB_PORT, np.int32)
        filesize = np.full((nc,), 1 << 20, np.int64)
        count = np.zeros((nc,), np.int32)
        pause_ns = np.full((nc, 4), SECOND, np.int64)
        n_pause = np.ones((nc,), np.int32)
        client_circ = np.full((n,), -1, np.int32)

        rng = pyrandom.Random(0xC1BC)
        guards = pools["guard"] or pools["relay"]
        middles = pools["middle"] or pools["relay"]
        exits = pools["exit"] or pools["relay"]
        if clients and not (guards and middles and exits):
            raise ValueError("tor config has clients but no relays")

        for ci, (gid, kv) in enumerate(clients):
            client_circ[gid] = ci
            # distinct relays per circuit (a relay takes one position)
            path = None
            for _ in range(64):
                cand = (rng.choice(guards), rng.choice(middles),
                        rng.choice(exits))
                if len(set(cand)) == 3 or (
                        len(guards) * len(middles) * len(exits) < 8):
                    path = cand
                    break
            hops[ci] = path
            srv = kv.get("server", "")
            sname, _, sport = srv.partition(":")
            addr = b.dns.resolve_name(sname) if sname else None
            if addr is None:
                raise ValueError(
                    f"tor client on gid {gid} has unknown server {srv!r}")
            srv_gid[ci] = addr.host_id
            srv_port[ci] = int(sport) if sport else WEB_PORT
            filesize[ci] = parse_size(kv.get("filesize", "1MiB"))
            count[ci] = int(kv.get("count", 1))
            pauses = [float(t) for t in str(kv.get("pause", "1")).split(",")
                      if t]
            for j, t in enumerate(pauses[:4]):
                pause_ns[ci, j] = int(t * SECOND)
            n_pause[ci] = max(min(len(pauses), 4), 1)

        # per-host rows: each circuit gives one entry to each of its three
        # relays (the next hop) and one to its server (the filesize to
        # serve); the first entry per (host, cid) wins
        per_host: dict[int, list[tuple[int, int, int, int]]] = {}
        for ci in range(len(clients)):
            g0, g1, g2 = int(hops[ci, 0]), int(hops[ci, 1]), int(hops[ci, 2])
            chain = [
                (g0, g1, OR_PORT, 0),
                (g1, g2, OR_PORT, 0),
                (g2, int(srv_gid[ci]), int(srv_port[ci]), 0),
                (int(srv_gid[ci]), -1, 0, int(filesize[ci])),
            ]
            for gid_e, nxt, prt, fsz in chain:
                per_host.setdefault(gid_e, []).append((ci, nxt, prt, fsz))
        cm = 4
        longest = max((len(v) for v in per_host.values()), default=1)
        while cm < longest:
            cm *= 2
        if cm > 4096:
            raise ValueError(
                f"a relay/server participates in {longest} circuits; "
                "per-host circuit tables cap at 4096: add relays/servers")
        tc_cid = np.full((n, cm), -1, np.int32)
        tc_nxt = np.full((n, cm), -1, np.int32)
        tc_port = np.zeros((n, cm), np.int32)
        tc_file = np.zeros((n, cm), np.int64)
        for gid_e, rowlist in per_host.items():
            for j, (ci, nxt, prt, fsz) in enumerate(rowlist):
                tc_cid[gid_e, j] = ci
                tc_nxt[gid_e, j] = nxt
                tc_port[gid_e, j] = prt
                tc_file[gid_e, j] = fsz

        cl_guard = np.full((n,), -1, np.int32)
        cl_file = np.zeros((n,), np.int64)
        cl_count = np.zeros((n,), np.int32)
        cl_pause = np.full((n, 4), SECOND, np.int64)
        cl_npause = np.ones((n,), np.int32)
        for ci, (gid_c, _kv) in enumerate(clients):
            cl_guard[gid_c] = hops[ci, 0]
            cl_file[gid_c] = filesize[ci]
            cl_count[gid_c] = count[ci]
            cl_pause[gid_c] = pause_ns[ci]
            cl_npause[gid_c] = n_pause[ci]

        self._role = role  # for the per-kind CPU table
        # frontier-drain eligibility: the client pause is this model's only
        # local emit delay (TCP floors its own at 1 ns)
        self._frontier_safe = bool((cl_pause >= 1).all())
        # the circuit slot: the last one (children fill from 0 up)
        self._cs = b.n_sockets - 1

        dev = b.device
        on = lambda a: torch.from_numpy(a).to(dev)
        s = b.n_sockets
        state = TorApp(
            gid=torch.arange(n, dtype=_I32, device=dev),
            role=on(role),
            fwd=torch.full((n, s), -1, dtype=_I32, device=dev),
            req_rx=torch.zeros((n, s), dtype=_I64, device=dev),
            streams_started=torch.zeros((n,), dtype=_I32, device=dev),
            streams_done=torch.zeros((n,), dtype=_I32, device=dev),
            conn_rx=torch.zeros((n,), dtype=_I64, device=dev),
            t_last_done=torch.zeros((n,), dtype=_I64, device=dev),
            relayed_bytes=torch.zeros((n,), dtype=_I64, device=dev),
            circ_id=on(client_circ), cl_guard=on(cl_guard),
            cl_file=on(cl_file), cl_count=on(cl_count),
            cl_pause=on(cl_pause), cl_npause=on(cl_npause),
            tc_cid=on(tc_cid), tc_nxt=on(tc_nxt), tc_port=on(tc_port),
            tc_file=on(tc_file),
        )
        return state, self._make_handlers, self._on_recv

    def _make_handlers(self, stack, kind_base):
        self._stack = stack
        self._kind_fetch = kind_base
        return [self._on_fetch]

    @property
    def frontier_safe(self) -> bool:
        """True when every local emit delay this build can schedule is
        >= 1 ns: the frontier drain's run-rule invariant."""
        return getattr(self, "_frontier_safe", False)

    def frontier_kinds(self) -> tuple:
        """Model kinds eligible for multi-position frontier runs (all of
        them: KIND_FETCH's emits are pause-delayed or TCP-floored)."""
        return tuple(range(self.n_kinds))

    def cpu_kind_cycles(self, n_kinds: int) -> np.ndarray:
        """Per-(host, kind) cycle charges: relays pay onion-crypto work
        for every delivered segment (KIND_PKT_RX). They take effect only
        on hosts whose config sets cpufrequency."""
        cy = np.zeros((self._role.shape[0], n_kinds), np.int64)
        cy[self._role == ROLE_RELAY, KIND_PKT_RX] = RELAY_CYCLES_PER_BYTE * MSS
        return cy

    # ------------------------------------------------- client fetch kind
    def _on_fetch(self, hs, ev: Events, key):
        """Open the circuit connection (first fetch), issue a request."""
        stack, tcp, cs = self._stack, self._stack.tcp, self._cs
        app: TorApp = hs.app
        cid = app.circ_id
        is_client = (app.role == ROLE_CLIENT) & (cid >= 0)
        ok = is_client & (app.streams_started < app.cl_count)
        first = ok & (app.streams_started == 0)

        sk = hs.net.sockets

        def w(a, v):
            a = a.clone()
            a[:, cs] = torch.where(first, v, a[:, cs])
            return a

        sk = dataclasses.replace(
            sk, proto=w(sk.proto, PROTO_TCP),
            local_port=w(sk.local_port,
                         CIRC_PORT_BASE + torch.clamp(cid, min=0)),
            peer_host=w(sk.peer_host, app.cl_guard),
            peer_port=w(sk.peer_port, OR_PORT))
        app = dataclasses.replace(
            app, streams_started=app.streams_started + ok.to(_I32))
        hs = dataclasses.replace(
            hs, app=app, net=dataclasses.replace(hs.net, sockets=sk))
        hs, em_conn = tcp.connect(stack, hs, cs, ev.time, mask=first)
        hs, em_req = tcp.send(hs, cs, REQ_BYTES, ev.time, mask=ok)
        return hs, emit_concat(em_conn, em_req)

    # -------------------------------------------------------- deliveries
    def _on_recv(self, hs, slot, pkt, now, key):
        """Role dispatch on every delivered chunk or EOF."""
        stack, tcp = self._stack, self._stack.tcp
        app: TorApp = hs.app
        got = slot >= 0
        s = torch.clamp(slot, min=0)
        eof = got & ((pkt.flags & F_FIN) != 0)
        dlen = torch.where(got, pkt.length.to(_I64), 0)

        # ---------------- relay: forward bytes along the circuit
        is_relay = got & (app.role == ROLE_RELAY)
        have_fwd = _sel(app.fwd, s) >= 0
        # a new inbound circuit connection: the source port encodes the
        # circuit, the next hop comes from this host's own table; one
        # lookup serves relays (next hop) and servers (filesize)
        cid = pkt.src_port - CIRC_PORT_BASE
        tc_found, nxt_gid, nxt_port, tc_fsz = _tc_lookup(app, cid)
        new_circ = is_relay & ~have_fwd & (cid >= 0) & tc_found
        cidc = torch.clamp(cid, min=0)

        # the outbound slot: the last free one
        out_slot, any_free = _last_free_slot(hs.net.sockets.proto)
        can_open = new_circ & any_free

        sk = hs.net.sockets
        w = lambda a, v: _put(a, out_slot, v, can_open)
        sk = dataclasses.replace(
            sk, proto=w(sk.proto, PROTO_TCP),
            local_port=w(sk.local_port, CIRC_PORT_BASE + cidc),
            peer_host=w(sk.peer_host, nxt_gid),
            peer_port=w(sk.peer_port, nxt_port))
        fwd = _put(app.fwd, s, out_slot, can_open)
        fwd = _put(fwd, out_slot, s, can_open)
        app = dataclasses.replace(
            app, fwd=fwd,
            relayed_bytes=app.relayed_bytes + torch.where(is_relay, dlen, 0))
        hs = dataclasses.replace(
            hs, app=app, net=dataclasses.replace(hs.net, sockets=sk))
        hs, em_open = tcp.connect(stack, hs, out_slot, now, mask=can_open)

        fwd_to = _sel(hs.app.fwd, s)
        do_fwd = is_relay & (fwd_to >= 0) & (dlen > 0)
        hs, em_fwd = tcp.send(hs, fwd_to, dlen, now, mask=do_fwd)
        do_close = is_relay & (fwd_to >= 0) & eof
        hs, em_fc = tcp.close(hs, fwd_to, now, mask=do_close)

        # ---------------- server: answer each request cell with filesize
        app = hs.app
        is_server = got & (app.role == ROLE_SERVER)
        prev = _sel(app.req_rx, s)
        newr = prev + torch.where(is_server, dlen, 0)
        n_req = newr // REQ_BYTES - prev // REQ_BYTES
        app = dataclasses.replace(app, req_rx=_put(app.req_rx, s, newr, got))
        hs = dataclasses.replace(hs, app=app)
        reply = n_req * tc_fsz
        hs, em_srv = tcp.send(hs, s, reply, now,
                              mask=is_server & tc_found & (reply > 0))

        # ---------------- client: count reply bytes, schedule next fetch
        app = hs.app
        is_client = got & (app.role == ROLE_CLIENT) & (app.circ_id >= 0)
        rx2 = app.conn_rx + torch.where(is_client, dlen, 0)
        done_now = torch.minimum(
            (rx2 // torch.clamp(app.cl_file, min=1)).to(_I32),
            app.streams_started)
        newly = is_client & (done_now > app.streams_done)
        app = dataclasses.replace(
            app, conn_rx=rx2,
            streams_done=torch.where(newly, done_now, app.streams_done),
            t_last_done=torch.where(newly, now, app.t_last_done))
        hs = dataclasses.replace(hs, app=app)
        more = newly & (app.streams_done < app.cl_count)
        pk_ = app.streams_done % torch.clamp(app.cl_npause, min=1)
        lanes = torch.arange(4, dtype=_I32, device=now.device)
        pause = torch.sum(
            torch.where(lanes == pk_[:, None], app.cl_pause, 0), dim=-1,
            dtype=_I64)
        em_next = Emit.single(
            dst=torch.zeros_like(slot), dt=pause, kind=self._kind_fetch,
            mask=more, local=True, n_args=N_PKT_ARGS)

        # rows: open (2) | forward send + close | server reply | next; the
        # relay rows never coexist with server or client rows on a host,
        # so the two groups share rows
        em_a = emit_concat(em_fwd, em_fc)
        em_b = emit_concat(em_srv, em_next)
        return hs, emit_concat(em_open, _select_rows(is_relay, em_a, em_b))


def churn_scenario(
    n_relays_per_class: int = 10,
    n_clients: int = 100,
    churn_frac: float = 0.2,
    churn_period: float = 20.0,
    churn_downtime: float = 5.0,
    churn_start: float = 10.0,
    stoptime: int = 60,
    **kw,
):
    """Parsed relay-churn config: the Tor example with `churn_frac` of the
    guard/middle/exit relays crashing and restarting on a cycle. Build
    with `build_simulation(cfg)`; relay selection and cycle phases draw
    from the named fault stream, so the same seed gives the same churn
    timeline."""
    from shadow_tpu_torch.config import parse_config
    from shadow_tpu_torch.examples import tor_churn_example

    return parse_config(tor_churn_example(
        n_relays_per_class=n_relays_per_class, n_clients=n_clients,
        churn_frac=churn_frac, churn_period=churn_period,
        churn_downtime=churn_downtime, churn_start=churn_start,
        stoptime=stoptime, **kw,
    ))
