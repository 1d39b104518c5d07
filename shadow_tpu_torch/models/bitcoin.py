"""Bitcoin-like block gossip: INV / GETDATA / BLOCK over a random peer graph.

The counterpart of `shadow_tpu.models.bitcoin`. It reproduces the traffic
pattern of a Bitcoin P2P network (BASELINE.md config 5): a static random
peer graph of persistent TCP links, miners announcing sequentially
numbered blocks at an interval, and the three-step relay (INV announce,
GETDATA request, block body) with duplicate suppression by each node's
best-known block.

INV and GETDATA ride small UDP datagrams whose aux word carries
(type << 24 | block id), since TCP here moves byte counts, not payloads;
the block bodies flow through the persistent TCP links. Each peer pair
shares one TCP link (dialed by the lower gid), and a node downloads one
block at a time.

Arguments per <process>:
  node [miner] [peers=4] [blocksize=1MiB] [interval=600] [blocks=10]
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
from shadow_tpu_torch.host.sockets import PROTO_TCP, PROTO_UDP
from shadow_tpu_torch.transport.stack import N_PKT_ARGS, _sel
from shadow_tpu_torch.transport.tcp import ESTABLISHED, _put, emit_concat

_I32 = torch.int32
_I64 = torch.int64

GOSSIP_PORT = 8333  # UDP control plane
LINK_PORT = 8334  # TCP block-body links
INV_BYTES = 61  # wire sizes of the real messages (approximately)
GETDATA_BYTES = 61

T_INV = 1
T_GETDATA = 2


@dataclasses.dataclass(frozen=True)
class BtcApp:
    """Per-host state, [H] / [H, S] tensors."""

    gid: torch.Tensor  # i32
    is_node: torch.Tensor  # bool
    best: torch.Tensor  # i32 highest fully received block (0 = genesis)
    curr_dl: torch.Tensor  # i32 block id being downloaded (-1)
    pending: torch.Tensor  # i32[S] block id expected on this TCP slot (-1)
    target: torch.Tensor  # i64[S] dl_rx threshold that completes it
    dl_rx: torch.Tensor  # i64[S] cumulative TCP bytes delivered per slot
    t_best: torch.Tensor  # i64 sim time `best` was reached


def link_slot(sockets, tcb, peer: torch.Tensor) -> torch.Tensor:
    """i32[H]: each row's first established TCP slot to `peer`, -1 when
    it has none."""
    match = ((sockets.proto == PROTO_TCP) & (sockets.peer_host == peer[:, None])
             & (tcb.state >= ESTABLISHED))
    return torch.where(match.any(dim=1),
                       torch.argmax(match.to(_I32), dim=1).to(_I32), -1)


class BitcoinModel:
    """The `bitcoin` app model (see `shadow_tpu_torch.sim.AppModel`)."""

    name = "bitcoin"
    needs_tcp = True
    n_kinds = 2  # KIND_DIAL (link setup), KIND_MINE (miner tick)

    MAX_PEERS = 6

    def __init__(self):
        self._stack = None
        self._kind_dial = None
        self._kind_mine = None

    def app_rows(self) -> int:
        # completion: INV to every peer; or a GETDATA reply; the union
        return self.MAX_PEERS

    def handler_rows(self) -> int:
        # dial: connect (2), one link per event; mine: INV fanout + tick
        return self.MAX_PEERS + 1

    # ------------------------------------------------------------- build
    def build(self, b):
        """Bind each node's UDP socket (slot 0) and TCP listener (slot 1),
        schedule the dials and mining ticks, and draw the peer graph."""
        n = b.n_hosts
        is_node = np.zeros((n,), bool)
        miner = np.zeros((n,), bool)
        kpeers = np.full((n,), 4, np.int32)
        blocksize = 1 << 20
        interval_s = 600.0
        n_blocks = 10

        for h in b.hosts:
            for proc in h.spec.processes:
                kv = parse_kv_arguments(proc.arguments)
                if "node" not in kv:
                    raise ValueError(
                        f"bitcoin process on {h.name!r}: arguments must "
                        "include 'node'")
                is_node[h.gid] = True
                miner[h.gid] = "miner" in kv
                kpeers[h.gid] = min(int(kv.get("peers", 4)), self.MAX_PEERS)
                if "blocksize" in kv:
                    blocksize = parse_size(kv["blocksize"])
                if "interval" in kv:
                    interval_s = float(kv["interval"])
                if "blocks" in kv:
                    n_blocks = int(kv["blocks"])
                b.sockets = b.sockets.bind(h.gid, 0, PROTO_UDP, GOSSIP_PORT)
                b.sockets = b.sockets.bind(h.gid, 1, PROTO_TCP, LINK_PORT)
                b.tcb = b.tcb.listen(h.gid, 1)
                b.add_start_event(h.gid, proc.starttime, 0)  # dial links
                if miner[h.gid]:
                    b.add_start_event(h.gid, proc.starttime + interval_s, 1)

        # a random peer graph from a fixed stream; each undirected edge is
        # dialed by its lower-gid end, so every pair shares one link
        nodes = np.nonzero(is_node)[0]
        rng = pyrandom.Random(0xB17C)
        edges: set[tuple[int, int]] = set()
        for g in nodes:
            want = int(kpeers[g])
            tries = 0
            while (sum(1 for e in edges if g in e) < want
                   and tries < 10 * want and len(nodes) > 1):
                p = int(rng.choice(nodes))
                tries += 1
                if p != g:
                    edges.add((min(g, p), max(g, p)))

        peers = np.full((n, self.MAX_PEERS), -1, np.int32)
        dials = np.full((n, self.MAX_PEERS), -1, np.int32)
        deg = np.zeros((n,), np.int32)
        ndial = np.zeros((n,), np.int32)
        for a, c in sorted(edges):
            # an edge is kept only if both ends have room, so the peer
            # lists and the dialed links describe the same graph
            if deg[a] >= self.MAX_PEERS or deg[c] >= self.MAX_PEERS:
                continue
            peers[a, deg[a]] = c
            peers[c, deg[c]] = a
            deg[a] += 1
            deg[c] += 1
            dials[a, ndial[a]] = c
            ndial[a] += 1

        dev = b.device
        on = lambda a: torch.from_numpy(a).to(dev)
        # every handler reads these rows by the host's own row index (the
        # state's gid is that index)
        self._g = dict(
            peers=on(peers), n_peers=on(deg), dials=on(dials),
            n_dials=on(ndial),
            blocksize=torch.full((), blocksize, dtype=_I64, device=dev),
            interval_ns=torch.full((), int(interval_s * SECOND), dtype=_I64,
                                   device=dev),
            n_blocks=torch.full((), n_blocks, dtype=_I32, device=dev),
            miner=on(miner),
        )

        s = b.n_sockets
        state = BtcApp(
            gid=torch.arange(n, dtype=_I32, device=dev),
            is_node=on(is_node),
            best=torch.zeros((n,), dtype=_I32, device=dev),
            curr_dl=torch.full((n,), -1, dtype=_I32, device=dev),
            pending=torch.full((n, s), -1, dtype=_I32, device=dev),
            target=torch.zeros((n, s), dtype=_I64, device=dev),
            dl_rx=torch.zeros((n, s), dtype=_I64, device=dev),
            t_best=torch.zeros((n,), dtype=_I64, device=dev),
        )
        # frontier-drain eligibility: the dial chain re-arms at 10 ms and
        # the miner tick at interval_ns, both >= 1 ns
        self._frontier_safe = int(interval_s * SECOND) >= 1
        return state, self._make_handlers, self._on_recv

    @property
    def frontier_safe(self) -> bool:
        """True when every local emit delay this build can schedule is
        >= 1 ns: the frontier drain's run-rule invariant."""
        return getattr(self, "_frontier_safe", False)

    def frontier_kinds(self) -> tuple:
        """Model kinds eligible for multi-position frontier runs (all of
        them: dial and mine re-arms are interval-delayed, announces are
        TCP-floored)."""
        return tuple(range(self.n_kinds))

    def _make_handlers(self, stack, kind_base):
        self._stack = stack
        self._kind_dial = kind_base
        self._kind_mine = kind_base + 1
        return [self._on_dial, self._on_mine]

    # ---------------------------------------------------------- link setup
    def _on_dial(self, hs, ev: Events, key):
        """Dial one outbound link per event, chaining until all are up.

        args[0] is the dial index; dial i uses slot S-1-i (children fill
        from the low slots; slots 0 and 1 are the UDP socket and the
        listener)."""
        stack, tcp, g = self._stack, self._stack.tcp, self._g
        app: BtcApp = hs.app
        i = ev.args[:, 0]
        nd = g["n_dials"]
        ok = app.is_node & (i < nd)
        ic = torch.clamp(i, 0, self.MAX_PEERS - 1)
        peer = torch.gather(g["dials"], 1, ic.long()[:, None])[:, 0]

        out_slot = app.pending.shape[1] - 1 - ic
        sk = hs.net.sockets
        w = lambda a, v: _put(a, out_slot, v, ok)
        sk = dataclasses.replace(
            sk, proto=w(sk.proto, PROTO_TCP),
            local_port=w(sk.local_port, LINK_PORT + 1 + i),
            peer_host=w(sk.peer_host, torch.clamp(peer, min=0)),
            peer_port=w(sk.peer_port, LINK_PORT))
        hs = dataclasses.replace(hs, net=dataclasses.replace(hs.net,
                                                             sockets=sk))
        hs, em_conn = tcp.connect(stack, hs, out_slot, ev.time, mask=ok)
        em_next = Emit.single(
            dst=torch.zeros_like(i), dt=10_000_000, kind=self._kind_dial,
            args=(i + 1)[:, None], mask=ok & (i + 1 < nd), local=True,
            n_args=N_PKT_ARGS)
        return hs, emit_concat(em_conn, em_next)

    # ------------------------------------------------------------- mining
    def _on_mine(self, hs, ev: Events, key):
        """Miner tick: adopt a new block, announce INV to all peers."""
        g = self._g
        app: BtcApp = hs.app
        mine = g["miner"] & (app.best < g["n_blocks"])
        new_best = app.best + mine.to(_I32)
        app = dataclasses.replace(
            app, best=new_best, t_best=torch.where(mine, ev.time, app.t_best))
        hs = dataclasses.replace(hs, app=app)
        hs, em_inv = self._announce(hs, new_best, ev.time, mine)
        em_next = Emit.single(
            dst=torch.zeros_like(new_best), dt=g["interval_ns"],
            kind=self._kind_mine, mask=mine & (new_best < g["n_blocks"]),
            local=True, n_args=N_PKT_ARGS)
        return hs, emit_concat(em_inv, em_next)

    def _announce(self, hs, block_id, now, mask):
        """INV(block_id) to every peer (a UDP fanout), peer by peer."""
        peers = self._g["peers"]
        aux = (T_INV << 24) | block_id
        ems = []
        for j in range(self.MAX_PEERS):
            peer = peers[:, j]
            hs, em = self._stack.send_udp(
                hs, now, 0, torch.clamp(peer, min=0), GOSSIP_PORT, INV_BYTES,
                aux=aux, mask=mask & (peer >= 0))
            ems.append(em)
        return hs, emit_concat(*ems)

    # ---------------------------------------------------------- deliveries
    def _on_recv(self, hs, slot, pkt, now, key):
        stack, tcp, g = self._stack, self._stack.tcp, self._g
        app: BtcApp = hs.app
        got = (slot >= 0) & app.is_node
        s = torch.clamp(slot, min=0)
        is_udp = got & (pkt.proto == PROTO_UDP)
        mtype = pkt.aux >> 24
        mblock = pkt.aux & 0xFFFFFF
        # the one TCP link shared with the sender; the INV and GETDATA
        # steps below change no socket or connection state
        lslot = link_slot(hs.net.sockets, hs.net.tcb, pkt.src_host)
        ls = torch.clamp(lslot, min=0)

        # -- INV: request the block if it is news and we are idle; with
        # the link not up yet, a later INV retries
        want = (is_udp & (mtype == T_INV) & (mblock > app.best)
                & (app.curr_dl < 0) & (lslot >= 0))
        hs, em_get = stack.send_udp(
            hs, now, 0, pkt.src_host, GOSSIP_PORT, GETDATA_BYTES,
            aux=(T_GETDATA << 24) | mblock, mask=want)
        app = hs.app
        app = dataclasses.replace(
            app, curr_dl=torch.where(want, mblock, app.curr_dl),
            pending=_put(app.pending, ls, mblock, want),
            target=_put(app.target, ls, _sel(app.dl_rx, ls) + g["blocksize"],
                        want))
        hs = dataclasses.replace(hs, app=app)

        # -- GETDATA: push the block body down the shared TCP link
        serve = (is_udp & (mtype == T_GETDATA) & (mblock <= app.best)
                 & (lslot >= 0))
        hs, em_body = tcp.send(hs, ls, g["blocksize"], now, mask=serve)

        # -- TCP bytes: accumulate; completion adopts and re-announces
        is_tcp_data = got & (pkt.proto == PROTO_TCP) & (pkt.length > 0)
        app = hs.app
        lanes = torch.arange(app.dl_rx.shape[1], dtype=_I32,
                             device=now.device)
        dl2 = app.dl_rx + torch.where(
            (lanes == s[:, None]) & is_tcp_data[:, None],
            pkt.length.to(_I64)[:, None], 0)
        pend = _sel(app.pending, s)
        complete = is_tcp_data & (pend >= 0) & (
            _sel(dl2, s) >= _sel(app.target, s))
        new_best = torch.where(complete, torch.maximum(app.best, pend),
                               app.best)
        app = dataclasses.replace(
            app, dl_rx=dl2, best=new_best,
            t_best=torch.where(complete, now, app.t_best),
            curr_dl=torch.where(complete, -1, app.curr_dl),
            pending=_put(app.pending, s, -1, complete))
        hs = dataclasses.replace(hs, app=app)
        hs, em_inv = self._announce(hs, new_best, now, complete)

        # a UDP control delivery and a TCP data delivery never happen in
        # one event, so the two row groups share rows
        em_ctl = emit_concat(em_get, em_body).pad_to(self.MAX_PEERS)
        return hs, _select_rows(is_udp, em_ctl,
                                em_inv.pad_to(self.MAX_PEERS))
