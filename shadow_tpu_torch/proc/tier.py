"""ProcessTier: the window-batched syscall exchange between the native
green-thread runtime and the simulation on the device.

The counterpart of `shadow_tpu.proc.tier`. Once per conservative window
the tier

  1. feeds completions (established connects, accepted children, timer
     wakes) into `shim_pump`, which runs every runnable green thread
     until all block again and returns their syscall requests;
  2. translates the requests into command events and pushes them into
     the device queues (`ProcTierModel` runs them at the window open);
  3. steps the simulation one window;
  4. diffs the device socket and TCB tables: newly established
     connections become completions for the next pump, the growth of a
     socket's delivered bytes moves real bytes between the runtime's
     endpoint streams (`shim_wire_deliver`), consumed FINs become EOFs.

Process reactions land at window boundaries (one lookahead of added
latency per blocking round trip), as in the reference. Config-built
simulations run the device TCP in strict in-order delivery, so the
delivered-byte counters the tier diffs advance in stream order, on
lossy paths too.

The tier reads the device once per window: one copy holds the
frontier time, the spill ring's write cursor (spill mode), the eight
[H, S] tables the observe diffs, the UDP delivery ring once a datagram
socket exists, and the per-source sequence counters the next injection
continues from. `queue_push` runs the merge kernel on CUDA.
"""

from __future__ import annotations

import heapq
import os
import shlex
from typing import Any

import dataclasses
import numpy as np
import torch

from shadow_tpu_torch.config import ShadowConfig, expand_hosts, resolve_path
from shadow_tpu_torch.convert import numpy_dtype
from shadow_tpu_torch.core.events import Events, queue_push
from shadow_tpu_torch.core.timebase import SECOND
from shadow_tpu_torch.host.sockets import EPHEMERAL_BASE
from shadow_tpu_torch.proc.model import (
    CMD_CLOSE,
    CMD_CONNECT,
    CMD_LISTEN,
    CMD_SEND,
    CMD_SENDTO,
    CMD_UDP_BIND,
    CMD_UDP_CLOSE,
    UDP_RING,
    ProcTierModel,
)
from shadow_tpu_torch.proc.native import (
    COMP_ACCEPT,
    COMP_CONNECT_FAIL,
    COMP_CONNECT_OK,
    COMP_TIMER,
    COMP_WAKE,
    REQ_CLOSE,
    REQ_CONNECT,
    REQ_EXIT,
    REQ_LISTEN,
    REQ_LOG,
    REQ_SEND,
    REQ_SENDTO,
    REQ_SLEEP,
    REQ_TIMER,
    REQ_UDP_BIND,
    ShimRuntime,
)
from shadow_tpu_torch.sim import build_simulation
from shadow_tpu_torch.transport.stack import N_PKT_ARGS
from shadow_tpu_torch.transport.tcp import CLOSED, ESTABLISHED

# how long a closed UDP endpoint's source-attribution zombie may outlive
# its last unaccounted datagram: covers datagrams the network dropped
# (they never reach a ring), far beyond any path latency
_UDP_ZOMBIE_TTL_NS = 30 * SECOND

# the [H, S] tables the observe diffs, in the order of one window's copy
_OBSERVED = ("state", "rx", "fin", "fgen", "lport", "phost", "pport",
             "cgen")
_UDP_OBSERVED = ("ucnt", "usrc", "usport", "udport", "ulen", "useq")


class ProcessTier:
    """Drives native plugin processes against a config-built simulation
    on `device` (None: CUDA, which must exist; "cpu" for the tests).

    Every <process> whose plugin path is an existing .so runs as a green
    thread in the native runtime; argv is [basename, *arguments]. The
    keywords are the reference's; `mesh` takes one shard only (the tier
    on a mesh of several shards is ROADMAP.md Queue 1 item 9b)."""

    def __init__(self, cfg: ShadowConfig, *, device=None, seed: int = 0,
                 n_sockets: int = 8, capacity: int | None = None,
                 strict_overflow: bool = True, tcp_cc: str = "reno",
                 rx_queue: str = "codel", qdisc: str = "fifo",
                 interface_buffer: int = 1_024_000, mesh=None,
                 driver_slots: int | None = None, locality: bool = False,
                 trace: int = 0, profiler=None, overflow: str = "drop"):
        if mesh is not None and mesh.size > 1:
            raise NotImplementedError(
                "the process tier on a mesh of more than one shard is not "
                "ported (ROADMAP.md Queue 1 item 9b): one native runtime "
                "would have to serve every rank")
        self.strict_overflow = strict_overflow
        self.overflow = overflow
        self.model = ProcTierModel()
        # the slot space is split: device-created children live in
        # [0, child_limit), driver-owned sockets in [child_limit, S), so
        # an inbound SYN never claims a slot on the tier's free list
        if driver_slots is None:
            driver_slots = min(max(1, n_sockets // 2), n_sockets - 1)
        if not 0 < driver_slots < n_sockets:
            raise ValueError(
                f"driver_slots must be in (0, {n_sockets}), got {driver_slots}"
            )
        self._child_limit = n_sockets - driver_slots
        self.sim = build_simulation(
            cfg, seed=seed, n_sockets=n_sockets, capacity=capacity,
            app_model=self.model, tcp_cc=tcp_cc, rx_queue=rx_queue,
            qdisc=qdisc, interface_buffer=interface_buffer, mesh=mesh,
            tcp_child_slot_limit=self._child_limit, locality=locality,
            trace=trace, profiler=profiler, overflow=overflow,
            device=device,
        )
        self.rt = ShimRuntime()
        self.rt.set_seed(seed)  # roots the plugins' rand()/urandom
        self.lost_stream_bytes = 0  # bytes unflushable at endpoint drop
        self.n_sockets = n_sockets
        # the interposer's getaddrinfo resolves against the runtime's DNS
        # table: push the whole (static) registry up front
        for addr in self.sim.dns.entries():
            self.rt.dns_add(addr.name, addr.ip)
        self.logs: list[tuple[int, int, str]] = []  # (sim_ns, pid, msg)
        self.exit_codes: dict[int, int] = {}
        # what a run measured: windows stepped, windows that pushed
        # commands, and the tier's own device reads
        self.windows = 0
        self.injections = 0
        self.reads = 0

        # (pid, fd) <-> (gid, slot) endpoint maps
        self.slot_of: dict[tuple[int, int], tuple[int, int]] = {}
        self.ep_of: dict[tuple[int, int], tuple[int, int]] = {}
        self.listen_ep: dict[tuple[int, int], tuple[int, int]] = {}
        self._listen_of_ep: dict[tuple[int, int], tuple[int, int]] = {}
        self.pending_conn: dict[tuple[int, int], tuple[int, int]] = {}
        self.wire: dict[tuple[int, int], tuple[int, int]] = {}  # slot<->slot
        # the connection 4-tuple index, (gid, lport, peer_gid, pport) ->
        # (gid, slot): parallel same-port connects between one host pair
        # pair unambiguously on it
        self._four: dict[tuple[int, int, int, int], tuple[int, int]] = {}
        self._four_key: dict[tuple[int, int], tuple] = {}  # ep -> its key
        self._driver_owned: set[tuple[int, int]] = set()
        self._free_slots: dict[int, list[int]] = {}
        self.pid_host: dict[int, int] = {}
        self._next_slot: dict[int, int] = {}
        self._next_sport: dict[int, int] = {}
        self._next_fd: dict[int, int] = {}
        self._starts: list[tuple[int, int]] = []  # (t_ns, pid) heap
        self._wakes: list[tuple[int, int, int]] = []  # (t_ns, pid, gen)
        # timerfd arms: a (deadline_ns, pid, fd, interval_ns, gen) heap;
        # _timer_gen holds each fd's current arm generation, so entries
        # of re-armed or closed timers retire when popped
        self._timers: list[tuple[int, int, int, int, int]] = []
        self._timer_gen: dict[tuple[int, int], int] = {}
        self._pending_comps: list[tuple] = []

        # the per-process stoptime heap (stop_ns, pid)
        self._stops: list[tuple[int, int]] = []
        # per-host process specs, kept for fault restarts: a host coming
        # back up respawns them with fresh state (new pids, empty fds)
        self._proc_spec: dict[int, list[tuple]] = {}
        # locality may have renumbered gids: map hosts by name
        gid_of = {name: g for g, name in enumerate(self.sim.names)}
        for h in expand_hosts(cfg):
            gid = gid_of.get(h.name, h.gid)
            for p in h.spec.processes:
                spec = cfg.plugin_by_id(p.plugin)
                path = (resolve_path(spec.path, cfg.base_dir) if spec
                        else p.plugin)
                if not (path.endswith(".so") and os.path.exists(path)):
                    raise ValueError(
                        "the process tier runs native plugins only: "
                        f"plugin {p.plugin!r} resolves to {path!r}, which "
                        "is not an existing .so — configs cannot mix "
                        "native plugins with modeled ones yet"
                    )
                argv = [os.path.basename(path)] + shlex.split(p.arguments)
                pid = self.rt.spawn(gid, path, argv)
                self.rt.set_host_name(pid, h.name)
                self.pid_host[pid] = gid
                heapq.heappush(self._starts, (int(p.starttime * SECOND), pid))
                if p.stoptime:
                    heapq.heappush(
                        self._stops, (int(p.stoptime * SECOND), pid))
                self._proc_spec.setdefault(gid, []).append((
                    path, argv, h.name, int(p.starttime * SECOND),
                    int(p.stoptime * SECOND) if p.stoptime else None,
                ))

        # UDP endpoints: (pid, fd) -> (gid, slot, port), the (gid, port)
        # demux index that routes delivery records to senders and
        # receivers, and each host's virtual IP for recvfrom
        self.udp_eps: dict[tuple[int, int], tuple[int, int, int]] = {}
        self.udp_port: dict[tuple[int, int], tuple[int, int]] = {}
        self._udp_used = False
        self._gid_ip: dict[int, int] = {
            a.host_id: a.ip for a in self.sim.dns.entries()
        }

        # the observe mirrors match the device's rows, which shape
        # bucketing may pad past the real host count
        h_n = self.sim.engine.cfg.n_hosts * self.sim.engine.cfg.n_shards
        self._prev_udp_cnt = np.zeros((h_n,), np.int32)
        # (gid, port) -> (pid, fd) of exited senders whose in-flight
        # datagrams still need payload attribution at the ring drain;
        # _udp_outstanding holds each source's sent-but-undrained seqs: a
        # zombie goes when its set empties, or at its TTL deadline
        self._udp_src_zombies: dict[tuple[int, int], tuple[int, int]] = {}
        self._udp_outstanding: dict[tuple[int, int], set[int]] = {}
        self._udp_zombie_deadline: dict[tuple[int, int], int] = {}
        self._prev_rx = np.zeros((h_n, n_sockets), np.int64)
        self._prev_fin = np.zeros((h_n, n_sockets), bool)
        # endpoint membership, per-slot owed bytes, and the TCB's slot
        # incarnation counter (conn_gen) for reuse detection
        self._known = np.zeros((h_n, n_sockets), bool)
        self._undeliv = np.zeros((h_n, n_sockets), np.int64)
        self._prev_gen = np.zeros((h_n, n_sockets), np.int32)
        # the host's view of the device's per-source sequence counters,
        # taken from each window's copy and advanced by every injection
        self._src_seq: np.ndarray | None = None

    # ------------------------------------------------------------- reads
    def _fetch(self, t: torch.Tensor) -> np.ndarray:
        """A counted device-to-host copy (the engine's count too)."""
        self.reads += 1
        return self.sim.engine._fetch(t)

    def _window_copy(self, st) -> dict[str, np.ndarray]:
        """Everything the tier reads after a window, in one copy: now,
        the spill ring's cursor, the observed tables and src_seq."""
        net, app = st.hosts.net, st.hosts.app
        parts = {"now": st.now.reshape(1)}
        if self.sim.pressure is not None:
            parts["wr"] = st.queues.spill.wr
        parts.update(zip(_OBSERVED, (
            net.tcb.state, net.sockets.rx_bytes, app.fin_seen, app.fin_gen,
            net.sockets.local_port, net.sockets.peer_host,
            net.sockets.peer_port, net.tcb.conn_gen)))
        if self._udp_used:
            parts.update(zip(_UDP_OBSERVED, (
                app.udp_cnt, app.udp_src, app.udp_sport, app.udp_dport,
                app.udp_len, app.udp_seq)))
        parts["src_seq"] = st.src_seq
        flat = self._fetch(torch.cat(
            [t.reshape(-1).to(torch.int64) for t in parts.values()]))
        out, at = {}, 0
        for k, t in parts.items():
            a = flat[at:at + t.numel()].reshape(t.shape)
            at += t.numel()
            out[k] = a.astype(numpy_dtype(t))
        return out

    # ------------------------------------------------------------- helpers
    def _alloc_slot(self, gid: int) -> int:
        # driver-owned slots grow downward from the top (TCP children
        # take the first free slot from 0 upward, so the ends never
        # meet); slots freed by completed close handshakes recycle first
        free = self._free_slots.get(gid)
        if free:
            return free.pop()
        s = self._next_slot.get(gid, self.n_sockets - 1)
        self._next_slot[gid] = s - 1
        if s < self._child_limit:
            raise RuntimeError(
                f"host {gid}: out of driver socket slots (reserved "
                f"[{self._child_limit}, {self.n_sockets}); raise "
                "n_sockets or driver_slots)"
            )
        return s

    def _close_udp_ep(self, key, rows, now: int) -> None:
        """Tear down one UDP endpoint (exit, close, stoptime kill and
        crash share this): free the driver slot and clear the
        destination demux row (arrivals addressed to it now drop), but
        keep source attribution for datagrams already sent, which the
        ring drain needs to find the payload stash. A zombie exists only
        while datagrams are outstanding."""
        gid, slot, port = self.udp_eps.pop(key)
        self.udp_port.pop((gid, port), None)
        src_key = (gid, port)
        if self._udp_outstanding.get(src_key):
            self._udp_src_zombies[src_key] = key
            self._udp_zombie_deadline[src_key] = now + _UDP_ZOMBIE_TTL_NS
        else:
            self._udp_outstanding.pop(src_key, None)
        self._free_slots.setdefault(gid, []).append(slot)
        rows.append((gid, [CMD_UDP_CLOSE, slot]))

    def _register_ep(self, gid: int, slot: int, pid: int, fd: int,
                     driver_owned: bool) -> None:
        self.ep_of[(gid, slot)] = (pid, fd)
        self.slot_of[(pid, fd)] = (gid, slot)
        self._known[gid, slot] = True
        self._undeliv[gid, slot] = 0
        self._prev_fin[gid, slot] = False  # fresh incarnation baseline
        if driver_owned:
            self._driver_owned.add((gid, slot))

    def _drop_ep(self, gid: int, slot: int, *, recycle: bool,
                 surface_eof: bool = False) -> None:
        """Forget one endpoint's mappings, first flushing owed bytes in
        both wire directions (the runtime's byte streams outlive the
        slot mapping, so a final flush keeps a peer from being stranded
        mid-stream). Optionally recycles a driver-owned slot and
        surfaces EOF to the dropped side."""
        key = (gid, slot)
        ep = self.ep_of.pop(key, None)
        peer = self.wire.pop(key, None)
        if peer is not None:
            self.wire.pop(peer, None)
        if ep is not None:
            pid, fd = ep
            if peer is not None and peer in self.ep_of:
                ppid, pfd = self.ep_of[peer]
                # 1. bytes this reader is still owed from its peer
                owed = int(self._undeliv[key])
                if owed:
                    moved = self.rt.wire_deliver(ppid, pfd, pid, fd, owed)
                    self._undeliv[key] -= max(moved, 0)
                # 2. bytes the peer is still owed from this endpoint
                powed = int(self._undeliv[peer])
                if powed:
                    moved = self.rt.wire_deliver(pid, fd, ppid, pfd, powed)
                    self._undeliv[peer] -= max(moved, 0)
            if self._undeliv[key]:
                self.lost_stream_bytes += int(self._undeliv[key])
            if surface_eof:
                self.rt.wire_fin(pid, fd)
            self.slot_of.pop(ep, None)
        fk = self._four_key.pop(key, None)
        if fk is not None:
            self._four.pop(fk, None)
        self.pending_conn.pop(key, None)
        self._known[gid, slot] = False
        self._undeliv[gid, slot] = 0
        if key in self._driver_owned:
            self._driver_owned.discard(key)
            if recycle:
                self._free_slots.setdefault(gid, []).append(slot)

    # ------------------------------------------------------------- faults
    def _fault_down(self, gid: int, rows, now: int) -> None:
        """A scheduled crash took the host down: kill its processes and
        drop the tier's endpoints outright. The device wipes the
        host's queue and re-templates its rows at the fault epoch, so no
        close handshake runs; surviving peers tear down through the real
        retransmit and RST paths."""
        for pid, g in list(self.pid_host.items()):
            if g != gid or pid in self.exit_codes:
                continue
            self.rt.kill(pid, 0)
            self.exit_codes[pid] = 0
            for key in [k for k in self._timer_gen if k[0] == pid]:
                self._timer_gen[key] += 1
            self._wakes = [w for w in self._wakes if w[1] != pid]
            heapq.heapify(self._wakes)
            # a process the crash beat to its starttime never boots in
            # this incarnation (it comes back with the host)
            self._starts = [s for s in self._starts if s[1] != pid]
            heapq.heapify(self._starts)
        for key in [k for k in list(self.ep_of) if k[0] == gid]:
            self._drop_ep(*key, recycle=True)
        for gp in [k for k in self.listen_ep if k[0] == gid]:
            ep = self.listen_ep.pop(gp)
            self._listen_of_ep.pop(ep, None)
        for key in [k for k, v in self.udp_eps.items() if v[0] == gid]:
            self._close_udp_ep(key, rows, now)

    def _fault_up(self, gid: int, now: int) -> None:
        """The host rebooted: respawn its configured processes with
        fresh state (new pids, empty fd tables), the starttime applied
        from boot."""
        for path, argv, name, start_ns, stop_ns in self._proc_spec.get(
                gid, ()):
            if stop_ns is not None and stop_ns <= now:
                continue  # its configured lifetime already ended
            pid = self.rt.spawn(gid, path, argv)
            self.rt.set_host_name(pid, name)
            self.pid_host[pid] = gid
            heapq.heappush(self._starts, (max(start_ns, now), pid))
            if stop_ns is not None:
                heapq.heappush(self._stops, (stop_ns, pid))

    def _wire_try_pair(self, gid: int, slot: int, lport: int,
                       peer_gid: int, pport: int) -> None:
        """Index an endpoint by its connection 4-tuple and pair it with
        the reverse tuple's endpoint when that side exists."""
        key = (gid, slot)
        fk = (gid, lport, peer_gid, pport)
        self._four[fk] = key
        self._four_key[key] = fk
        other = self._four.get((peer_gid, pport, gid, lport))
        if other is not None and other != key:
            self.wire[key] = other
            self.wire[other] = key

    def _alloc_sport(self, gid: int) -> int:
        p = self._next_sport.get(gid, EPHEMERAL_BASE + 4096)
        self._next_sport[gid] = p + 1
        return p

    def _alloc_fd(self, pid: int) -> int:
        # tier-assigned child fds live in the 2'000'000+ band, apart
        # from the runtime's own 1'000'000+ ones (shim_runtime.cpp
        # kFirstFd), so fd numbers stay unique
        f = self._next_fd.get(pid, 2_000_000)
        self._next_fd[pid] = f + 1
        return f

    # ---------------------------------------------------------- translate
    def _translate(self, reqs, now: int) -> list[tuple[int, list[int]]]:
        rows: list[tuple[int, list[int]]] = []
        for r in reqs:
            pid, fd = int(r.pid), int(r.fd)
            gid = self.pid_host[pid]
            if r.op == REQ_LISTEN:
                slot = self._alloc_slot(gid)
                self._register_ep(gid, slot, pid, fd, driver_owned=True)
                self.listen_ep[(gid, int(r.port))] = (pid, fd)
                self._listen_of_ep[(pid, fd)] = (gid, int(r.port))
                rows.append((gid, [CMD_LISTEN, slot, int(r.port)]))
            elif r.op == REQ_CONNECT:
                name = r.name.decode()
                if name:
                    addr = self.sim.dns.resolve_name(name)
                elif int(r.a1) in (0, 0x7F000001):
                    # wildcard or loopback: this host, over the
                    # topology's self-loop
                    addr = self.sim.dns.resolve_name(self.sim.names[gid])
                else:
                    # the interposer's form: a1 carries the virtual IPv4
                    # of connect(sockaddr_in), host order
                    addr = self.sim.dns.resolve_ip(int(r.a1))
                if addr is None:
                    self._pending_comps.append(
                        (pid, COMP_CONNECT_FAIL, fd, 0))
                    continue
                slot = self._alloc_slot(gid)
                sport = self._alloc_sport(gid)
                self._register_ep(gid, slot, pid, fd, driver_owned=True)
                self.pending_conn[(gid, slot)] = (pid, fd)
                self._wire_try_pair(gid, slot, sport, addr.host_id,
                                    int(r.port))
                rows.append((gid, [CMD_CONNECT, slot, sport, addr.host_id,
                                   int(r.port)]))
            elif r.op == REQ_SEND:
                key = (pid, fd)
                if key in self.slot_of:
                    gid, slot = self.slot_of[key]
                    rows.append((gid, [CMD_SEND, slot, int(r.a0)]))
            elif r.op == REQ_UDP_BIND:
                self._udp_used = True
                slot = self._alloc_slot(gid)
                self.udp_eps[(pid, fd)] = (gid, slot, int(r.port))
                self.udp_port[(gid, int(r.port))] = (pid, fd)
                # a re-bound port supersedes an exited sender's zombie,
                # which would otherwise take the new process's datagrams
                self._udp_src_zombies.pop((gid, int(r.port)), None)
                self._udp_outstanding.pop((gid, int(r.port)), None)
                self._udp_zombie_deadline.pop((gid, int(r.port)), None)
                rows.append((gid, [CMD_UDP_BIND, slot, int(r.port)]))
            elif r.op == REQ_SENDTO:
                ep = self.udp_eps.get((pid, fd))
                if ep is None:
                    continue  # closed underneath the sender
                seq = int(r.a0) >> 32
                nbytes = int(r.a0) & 0xFFFFFFFF
                ip = int(r.a1)
                # wildcard or loopback: the sending host itself
                if ip in (0, 0x7F000001):
                    dst_gid = gid
                else:
                    addr = self.sim.dns.resolve_ip(ip)
                    if addr is None:
                        continue  # unroutable: the datagram drops
                    dst_gid = addr.host_id
                rows.append((gid, [CMD_SENDTO, ep[1], dst_gid,
                                   int(r.port), nbytes, seq]))
                self._udp_outstanding.setdefault(
                    (gid, ep[2]), set()).add(seq)
            elif r.op == REQ_CLOSE:
                key = (pid, fd)
                if key in self._listen_of_ep:
                    # a closed listener has no handshake to run down:
                    # recycle its slot now, so a close-then-listen pair
                    # in one pump never exhausts the band; the device
                    # resets the row at the window open
                    gp = self._listen_of_ep.pop(key)
                    self.listen_ep.pop(gp, None)
                    if key in self.slot_of:
                        gid, slot = self.slot_of[key]
                        rows.append((gid, [CMD_CLOSE, slot]))
                        self._drop_ep(gid, slot, recycle=True)
                        # acknowledge the conn_gen bump the listener
                        # reset will apply, or a re-listen on the slot
                        # in this pump would read it as its own turnover
                        self._prev_gen[gid, slot] += 1
                elif key in self.udp_eps:
                    self._close_udp_ep(key, rows, now)
                elif key in self.slot_of:
                    gid, slot = self.slot_of[key]
                    rows.append((gid, [CMD_CLOSE, slot]))
            elif r.op == REQ_SLEEP:
                heapq.heappush(self._wakes, (int(r.a0), pid, int(r.port)))
            elif r.op == REQ_TIMER:
                gen = int(r.port)
                self._timer_gen[(pid, fd)] = gen
                if int(r.a0) >= 0:  # a0 = -1 disarms
                    heapq.heappush(
                        self._timers, (int(r.a0), pid, fd, int(r.a1), gen))
            elif r.op == REQ_LOG:
                self.logs.append((now, pid, r.name.decode()))
            elif r.op == REQ_EXIT:
                self.exit_codes[pid] = int(r.a0)
                # returning from main() with sockets open closes them as
                # a kernel would: FIN every endpoint the process
                # holds and free its datagram slots, or its peers never
                # see EOF
                for (p_pid, p_fd), (gid, slot) in list(self.slot_of.items()):
                    if p_pid == pid:
                        rows.append((gid, [CMD_CLOSE, slot]))
                for key in [k for k in self.udp_eps if k[0] == pid]:
                    self._close_udp_ep(key, rows, now)
        return rows

    # ------------------------------------------------------------- inject
    def _inject(self, st, rows, now: int):
        if not rows:
            return st
        self.injections += 1
        m = len(rows)
        # the batch pads to a power of two, as the reference's: its width
        # sets queue_push's merge rounds
        cap = 1 << max(m - 1, 0).bit_length()
        times = np.full((cap,), np.iinfo(np.int64).max, np.int64)
        dst = np.zeros((cap,), np.int32)
        seq = np.zeros((cap,), np.int32)
        kind = np.zeros((cap,), np.int32)
        argw = np.zeros((cap, N_PKT_ARGS), np.int32)
        if self._src_seq is None:
            self._src_seq = self._fetch(st.src_seq).copy()
        src_seq = self._src_seq
        for i, (gid, args) in enumerate(rows):
            times[i] = now
            dst[i] = gid
            seq[i] = src_seq[gid]
            src_seq[gid] += 1
            kind[i] = self.model.kind_cmd
            argw[i, :len(args)] = args
        eng = self.sim.engine
        on = lambda a: torch.from_numpy(a).to(eng.device)
        ev = Events(time=on(times), dst=on(dst), src=on(dst), seq=on(seq),
                    kind=on(kind), args=on(argw))
        mask = on(np.arange(cap) < m)
        q2 = queue_push(st.queues, ev, mask, 0, read=eng._read)
        return dataclasses.replace(st, queues=q2,
                                   src_seq=on(src_seq.copy()))

    # ------------------------------------------------------------ observe
    def _observe(self, got: dict[str, np.ndarray]) -> None:
        """Diff the window's copy of the device tables into completions
        and byte and FIN wire operations. Every scan walks the changed
        entries numpy selects, never the whole [H, S] table in Python."""
        tstate, rx, fin_raw, fgen, lport, phost, pport, cgen = (
            got[k] for k in _OBSERVED)
        # a fin_seen flag counts only for the slot incarnation it was
        # recorded against: a reused slot's sticky flag is not this
        # stream's EOF
        fin = fin_raw & (fgen == cgen)

        # the UDP delivery ring: move each new datagram's payload from
        # its sender's in-flight pool to the receiver's queue (read only
        # once a datagram socket exists)
        if self._udp_used:
            ucnt, usrc, usport, udport, _ulen, useq = (
                got[k] for k in _UDP_OBSERVED)
            for g in np.nonzero(ucnt != self._prev_udp_cnt)[0]:
                g = int(g)
                lo, hi = int(self._prev_udp_cnt[g]), int(ucnt[g])
                if hi - lo > UDP_RING:
                    raise RuntimeError(
                        f"host {g}: {hi - lo} UDP datagrams delivered in "
                        f"one window overran the {UDP_RING}-slot ring; "
                        "deliveries were lost"
                    )
                for i in range(lo, hi):
                    k = i % UDP_RING
                    dst_ep = self.udp_port.get((g, int(udport[g, k])))
                    src_key = (int(usrc[g, k]), int(usport[g, k]))
                    src_ep = (self.udp_port.get(src_key)
                              or self._udp_src_zombies.get(src_key))
                    out = self._udp_outstanding.get(src_key)
                    if out is not None:
                        out.discard(int(useq[g, k]))
                        if not out and src_key in self._udp_src_zombies:
                            # the drain passed the zombie's last in-flight
                            # datagram: nothing can attribute to it now
                            del self._udp_src_zombies[src_key]
                            del self._udp_outstanding[src_key]
                            self._udp_zombie_deadline.pop(src_key, None)
                    if dst_ep is None or src_ep is None:
                        continue  # an endpoint closed while in flight
                    self.rt.udp_deliver(
                        src_ep[0], src_ep[1], int(useq[g, k]),
                        dst_ep[0], dst_ep[1],
                        self._gid_ip.get(int(usrc[g, k]), 0),
                        int(usport[g, k]),
                    )
            self._prev_udp_cnt = ucnt.copy()

        # this window's delivered-byte deltas first (against the pre-drop
        # _known mask): bytes that land in the window an endpoint's slot
        # turns over must reach the drop-time flush
        self._undeliv += np.where(self._known,
                                  np.maximum(rx - self._prev_rx, 0), 0)
        prev_rx = self._prev_rx  # the pre-update snapshot for step 2
        self._prev_rx = rx

        # 0. the slot's incarnation changed under a live endpoint: the
        # device TCP closed and reset the slot (every path back to CLOSED
        # bumps conn_gen). The old stream is over: flush owed bytes,
        # surface EOF, recycle driver slots.
        for gid, slot in zip(*np.nonzero((cgen != self._prev_gen)
                                         & self._known)):
            key = (int(gid), int(slot))
            if key in self.pending_conn:
                continue  # a refused connect: handled below as CLOSED
            self._drop_ep(*key, recycle=True, surface_eof=True)

        # 1. pending active opens resolve
        for key, (pid, fd) in list(self.pending_conn.items()):
            s = tstate[key]
            if s >= ESTABLISHED:
                self._pending_comps.append((pid, COMP_CONNECT_OK, fd, 0))
                del self.pending_conn[key]
            elif s == CLOSED:
                self._pending_comps.append((pid, COMP_CONNECT_FAIL, fd, 0))
                self._drop_ep(*key, recycle=True)

        # 2. new established connections the tier does not know are
        # accepted children (their local port is a listen port)
        for gid, slot in zip(*np.nonzero((tstate >= ESTABLISHED)
                                         & ~self._known)):
            gid, slot = int(gid), int(slot)
            lp = self.listen_ep.get((gid, int(lport[gid, slot])))
            if lp is None:
                continue
            lpid, lfd = lp
            nfd = self._alloc_fd(lpid)
            self._register_ep(gid, slot, lpid, nfd, driver_owned=False)
            # under loss the handshake's final ACK can arrive in the
            # window of the first data burst, after the delta pass above:
            # everything delivered since the last window is owed, counted
            # from the previous incarnation's final count (rx_bytes is a
            # lifetime counter, never reset on slot reuse)
            self._undeliv[gid, slot] = max(
                int(rx[gid, slot]) - int(prev_rx[gid, slot]), 0)
            self._wire_try_pair(gid, slot, int(lport[gid, slot]),
                                int(phost[gid, slot]),
                                int(pport[gid, slot]))
            self._pending_comps.append((lpid, COMP_ACCEPT, lfd, nfd))

        # 3. delivered bytes and FIN propagation, changed endpoints only
        fresh_fin = fin & ~self._prev_fin
        for gid, slot in zip(*np.nonzero(
            self._known & ((self._undeliv > 0) | fresh_fin)
        )):
            key = (int(gid), int(slot))
            pid, fd = self.ep_of[key]
            owed = int(self._undeliv[key])
            if owed and key in self.wire:
                src = self.wire[key]
                if src in self.ep_of:
                    spid, sfd = self.ep_of[src]
                    moved = self.rt.wire_deliver(spid, sfd, pid, fd, owed)
                    if moved > 0:
                        self._undeliv[key] -= moved
            if fresh_fin[key]:
                if not self._undeliv[key]:
                    self.rt.wire_fin(pid, fd)
                else:
                    # bytes still owed: the FIN is checked again next
                    # window
                    fin[key] = False

        self._prev_fin = fin
        self._prev_gen = cgen.copy()

    def live_pids(self) -> list[int]:
        """Virtual pids still running, by the runtime's own account
        (the tier's own can lag a window behind on kills), recorded in the
        watchdog's stall bundle."""
        alive = set(self.rt.live_pids())
        return sorted(p for p in self.pid_host if p in alive)

    # ---------------------------------------------------------------- run
    @torch.inference_mode()
    def run(self, stop_s: float | None = None, supervisor=None):
        """Drive the window loop to the stop time; returns the final
        EngineState.

        `supervisor` (runtime.supervisor.Supervisor, optional) is petted
        once per window with the frontier time, which covers both
        blocking sites (the step and the native `shim_pump`: a plugin
        that spins without yielding hangs the pump, and the watchdog
        turns that into a stall abort), and its stop requests (SIGINT,
        SIGTERM) end the run at the next window boundary.
        """
        sim = self.sim
        stop_ns = int(stop_s * SECOND) if stop_s is not None else sim.stop_ns
        st = sim.state0
        now = 0
        # the host side of the fault schedule's liveness flips: a down
        # flip kills the host's processes, an up flip reboots them (the
        # device wipes and re-templates the host at the same epoch)
        flips = (sim.faults.transitions_in(-1, stop_ns)
                 if sim.faults is not None else [])
        fcur = 0
        while True:
            comps = self._pending_comps
            self._pending_comps = []
            stop_rows = []
            while fcur < len(flips) and flips[fcur][0] <= now:
                _, fgid, up = flips[fcur]
                fcur += 1
                if up:
                    self._fault_up(fgid, now)
                else:
                    self._fault_down(fgid, stop_rows, now)
            while self._starts and self._starts[0][0] <= now:
                _, pid = heapq.heappop(self._starts)
                self.rt.start(pid)
            while self._stops and self._stops[0][0] <= now:
                _, pid = heapq.heappop(self._stops)
                if pid in self.exit_codes:
                    continue  # already exited on its own
                self.rt.kill(pid, 0)
                self.exit_codes[pid] = 0
                # retire the dead process's timer arms and sleeps, so
                # they stop bounding windows and pumping completions at
                # nobody (stale heap entries retire lazily)
                for key in [k for k in self._timer_gen if k[0] == pid]:
                    self._timer_gen[key] += 1
                self._wakes = [w for w in self._wakes if w[1] != pid]
                heapq.heapify(self._wakes)
                # the kernel's teardown goes on for the dead process's
                # sockets: FIN every endpoint it still holds
                for (pfd_pid, fd), (gid, slot) in list(self.slot_of.items()):
                    if pfd_pid == pid:
                        stop_rows.append((gid, [CMD_CLOSE, slot]))
                # and its datagram sockets (no handshake: free the slot
                # and clear the demux row at once)
                for key in [k for k in self.udp_eps if k[0] == pid]:
                    self._close_udp_ep(key, stop_rows, now)
            if stop_rows:
                st = self._inject(st, stop_rows, now)
            while self._wakes and self._wakes[0][0] <= now:
                _, pid, gen = heapq.heappop(self._wakes)
                comps.append((pid, COMP_WAKE, -1, gen))
            while self._timers and self._timers[0][0] <= now:
                t, pid, fd, interval, gen = heapq.heappop(self._timers)
                if self._timer_gen.get((pid, fd)) != gen:
                    continue  # re-armed or closed since: stale
                if interval > 0:
                    # credit every expiration the window skipped and
                    # re-arm on the absolute grid (no drift)
                    n_exp = (now - t) // interval + 1
                    heapq.heappush(
                        self._timers, (t + n_exp * interval, pid, fd,
                                       interval, gen))
                comps.append((pid, COMP_TIMER, fd,
                              int(n_exp if interval > 0 else 1), gen))

            if sim.profiler is not None:
                with sim.profiler.phase("pump"):
                    reqs = self.rt.pump(now, comps)
            else:
                reqs = self.rt.pump(now, comps)
            st = self._inject(st, self._translate(reqs, now), now)
            if supervisor is not None:
                supervisor.pet(
                    now_ns=now, n_live_processes=len(self.live_pids()),
                    n_exited=len(self.exit_codes),
                )
                if supervisor.stop_requested:
                    # the tier has no checkpoint (the endpoint streams
                    # live on the host): stop cleanly, keeping the logs
                    # and exit codes so far
                    break

            if now >= stop_ns:
                break
            # every process has exited and no endpoint owes a
            # teardown handshake: the rest of the horizon is dead time
            if (
                self.exit_codes
                and len(self.exit_codes) >= len(self.pid_host)
                and not self._starts
                and not self.slot_of
                and not self.udp_eps
                and fcur >= len(flips)  # a restart could revive hosts
            ):
                break
            # never step past the next host-side interest point
            bound = stop_ns
            if self._starts:
                bound = min(bound, max(self._starts[0][0], now + 1))
            if self._stops:
                bound = min(bound, max(self._stops[0][0], now + 1))
            if self._wakes:
                bound = min(bound, max(self._wakes[0][0], now + 1))
            # retire re-armed or disarmed timer entries, so a dead arm
            # stops bounding windows
            while self._timers and self._timer_gen.get(
                (self._timers[0][1], self._timers[0][2])
            ) != self._timers[0][4]:
                heapq.heappop(self._timers)
            if self._timers:
                bound = min(bound, max(self._timers[0][0], now + 1))
            # land the window edge on the next liveness flip, so the
            # device's epoch switch and the tier's kill or respawn
            # agree on when the crash happened
            if fcur < len(flips):
                bound = min(bound, max(flips[fcur][0], now + 1))
            st = sim.step_window(st, bound)
            self.windows += 1
            got = self._window_copy(st)
            if sim.pressure is not None:
                # the tier steps window by window already, so the spill
                # reservoir's harvest and refill run at every boundary,
                # on the cursor the window's copy carries
                st = sim.pressure.boundary(st, wr=got["wr"],
                                           read=sim.engine._read)
            now = int(got["now"][0])
            self._src_seq = got["src_seq"].copy()
            self._observe(got)
            if self._udp_zombie_deadline:
                for zk in [k for k, d in self._udp_zombie_deadline.items()
                           if d <= now]:
                    del self._udp_zombie_deadline[zk]
                    self._udp_src_zombies.pop(zk, None)
                    self._udp_outstanding.pop(zk, None)
        drops = int(self._fetch(st.queues.drops.sum()))
        if drops and self.overflow == "strict":
            from shadow_tpu_torch.runtime.pressure import QueuePressureError

            raise QueuePressureError(
                drops, sim.engine.cfg.capacity, sim.summary(st))
        if drops and self.strict_overflow and self.overflow == "drop":
            raise RuntimeError(
                f"event queue overflow: {drops} events dropped (capacity "
                f"{sim.engine.cfg.capacity}); native processes may "
                "have observed a corrupted simulation — rerun with a "
                "larger capacity"
            )
        if self.lost_stream_bytes and self.strict_overflow:
            raise RuntimeError(
                f"{self.lost_stream_bytes} delivered bytes could not be "
                "flushed to their endpoint before its slot turned over — "
                "a native process observed a truncated stream"
            )
        return st

    def close(self):
        self.rt.close()


def tier_summary(tier: ProcessTier, st: Any) -> dict:
    """A run's totals the summary line reports: delivered bytes and
    queue drops, from one copy."""
    got = tier._fetch(torch.stack([
        st.hosts.net.sockets.rx_bytes.sum(),
        st.queues.drops.sum().to(torch.int64)]))
    return {"rx_bytes": int(got[0]), "queue_drops": int(got[1])}
