"""Packet capture: a device-side ring per host, drained into libpcap
files. The counterpart of `shadow_tpu.utils.pcap`.

A host that sets `logpcap` (or `pcapdir`) gets a capture ring in its
network state (`HostNet.cap`, [H]-leading). Every packet arrival appends
one record (time, source and destination host, ports, protocol and TCP
flags, length, sequence and ack numbers, and a bitmask of the stages the
packet went through: arrived, queued, delivered, dropped by CoDel or the
tail, retransmitted), and every UDP send one tx-side record on the
sender's ring. `CaptureDrain` copies the rings at heartbeats (through the
CLI's one-copy harvest) and writes each host's new records, sorted by
time, as Ethernet/IPv4/TCP-or-UDP header frames with no payload bytes,
the files `shadow_tpu.utils.pcap` writes byte for byte. Sequence numbers
are in MSS-sized segments on the device and written as byte offsets.
"""

from __future__ import annotations

import dataclasses
import os
import struct
import time

import numpy as np
import torch

# record meta word layout ([H, R, 8] i32)
M_SRC = 0
M_DST = 1
M_SPORT = 2
M_DPORT = 3
M_META = 4  # proto | tcp flag bits | stage bits << 16
M_LEN = 5
M_SEQ = 6
M_ACK = 7
N_META = 8

# the packet-lifecycle stage bits a record carries (in the IP TOS byte of
# its frame)
STG_ARRIVED = 1 << 0     # reached the destination host's edge
STG_QUEUED = 1 << 1      # waited in the rx queue (sojourn > 0)
STG_DELIVERED = 1 << 2   # handed to the socket demux
STG_AQM_DROP = 1 << 3    # CoDel drop
STG_TAIL_DROP = 1 << 4   # rx-buffer tail drop
STG_RETX = 1 << 5        # the sender marked it a retransmission
STG_SENT = 1 << 6        # tx-side record (the source host's own ring)

STAGE_NAMES = {
    STG_ARRIVED: "arrived", STG_QUEUED: "queued",
    STG_DELIVERED: "delivered", STG_AQM_DROP: "dropped_aqm",
    STG_TAIL_DROP: "dropped_tail", STG_RETX: "retransmitted",
    STG_SENT: "sent",
}

# single-verdict aliases, as the reference names them
V_DELIVERED = STG_DELIVERED
V_AQM_DROP = STG_AQM_DROP
V_TAIL_DROP = STG_TAIL_DROP

_I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class CaptureRing:
    """Per-host packet capture rings, [H]-leading: R records per host,
    written at the monotone counter `wr` modulo R by the hosts that
    capture (`enabled`)."""

    t: torch.Tensor  # i64[H, R] arrival (or send) sim time
    meta: torch.Tensor  # i32[H, R, N_META]
    wr: torch.Tensor  # i32[H]
    enabled: torch.Tensor  # bool[H]

    @staticmethod
    def create(enabled, ring: int = 1024, *, device=None) -> "CaptureRing":
        """Empty rings of `ring` records for the hosts where `enabled`
        (a bool [H] array or tensor) is set."""
        if not isinstance(enabled, torch.Tensor):
            enabled = torch.from_numpy(np.asarray(enabled, bool))
        enabled = enabled.to(device=device, dtype=torch.bool)
        h, dev = enabled.shape[0], enabled.device
        return CaptureRing(
            t=torch.zeros((h, ring), dtype=torch.int64, device=dev),
            meta=torch.zeros((h, ring, N_META), dtype=_I32, device=dev),
            wr=torch.zeros((h,), dtype=_I32, device=dev),
            enabled=enabled,
        )

    def append(self, now, src, dst, sport, dport, meta_word, length, seq,
               ack, verdict) -> "CaptureRing":
        """Append one record to every enabled row, at its slot `wr % R`;
        the other rows keep their ring and counter. Each value is an [H]
        tensor or a scalar."""
        h, r = self.t.shape
        on = self.enabled
        dev = on.device

        def row(v, dtype=_I32):
            if isinstance(v, torch.Tensor):
                return v.to(dtype).expand(h)
            return torch.full((h,), v, dtype=dtype, device=dev)

        rec = torch.stack([
            row(src), row(dst), row(sport), row(dport),
            row(meta_word) | (row(verdict) << 16),
            row(length), row(seq), row(ack)], dim=1)
        slot = (self.wr % r).long()
        it = slot[:, None]
        t_new = torch.where(on, row(now, torch.int64),
                            torch.gather(self.t, 1, it)[:, 0])
        im = it[:, :, None].expand(h, 1, N_META)
        m_new = torch.where(on[:, None], rec,
                            torch.gather(self.meta, 1, im)[:, 0])
        return CaptureRing(
            t=self.t.scatter(1, it, t_new[:, None]),
            meta=self.meta.scatter(1, im, m_new[:, None]),
            wr=self.wr + on.to(_I32),
            enabled=self.enabled,
        )


def _ip_of(host_id: int) -> bytes:
    """Deterministic fallback 10.x.y.z from the host id."""
    return bytes([10, (host_id >> 16) & 0xFF, (host_id >> 8) & 0xFF,
                  host_id & 0xFF])


class PcapWriter:
    """One host's capture file (libpcap format, LINKTYPE_ETHERNET)."""

    # our flag bits (transport/stack.py) -> wire TCP flag bits
    _FLAGMAP = ((1 << 2, 0x02), (1 << 3, 0x10), (1 << 4, 0x01),
                (1 << 5, 0x04))  # SYN, ACK, FIN, RST

    def __init__(self, path: str, ip_lookup=None, mss: int = 1434):
        self.f = open(path, "wb")
        self.ip_lookup = ip_lookup or _ip_of
        self.mss = mss
        # magic, version 2.4, tz 0, sigfigs 0, snaplen, LINKTYPE_ETHERNET
        self.f.write(struct.pack("<IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0,
                                 65535, 1))

    def record(self, t_ns: int, src: int, dst: int, sport: int, dport: int,
               meta: int, length: int, seq: int, ack: int,
               verdict: int = 0) -> None:
        proto = meta & 0x3
        is_tcp = proto == 2  # sockets.PROTO_TCP
        wire_flags = 0
        for ours, theirs in self._FLAGMAP:
            if meta & ours:
                wire_flags |= theirs
        l4 = (
            struct.pack(
                ">HHIIBBHHH", sport & 0xFFFF, dport & 0xFFFF,
                (seq * self.mss) & 0xFFFFFFFF, (ack * self.mss) & 0xFFFFFFFF,
                5 << 4, wire_flags, 65535, 0, 0,
            )
            if is_tcp
            else struct.pack(">HHHH", sport & 0xFFFF, dport & 0xFFFF,
                             8 + length, 0)
        )
        ip_len = 20 + len(l4) + length
        # the stage bitmask rides the IP TOS byte
        ip = struct.pack(
            ">BBHHHBBH4s4s", 0x45, verdict & 0xFF, ip_len & 0xFFFF, 0, 0,
            64, 6 if is_tcp else 17, 0, self.ip_lookup(src),
            self.ip_lookup(dst),
        )
        eth = (
            dst.to_bytes(6, "big", signed=False)
            + src.to_bytes(6, "big", signed=False)
        ) + b"\x08\x00"
        frame = eth + ip + l4  # headers only; the payload is metadata
        orig = len(eth) + ip_len
        self.f.write(struct.pack("<IIII", t_ns // 10**9,
                                 (t_ns % 10**9) // 1000, len(frame), orig))
        self.f.write(frame)

    def close(self) -> None:
        self.f.close()


class CaptureDrain:
    """Drains a CaptureRing into per-host pcap files, a little at a time.

    Keeps each host's last-seen write counter; records overwritten before
    a drain (the ring wrapped) are counted in `lost`."""

    def __init__(self, names, host_ids, pcap_dir: str, dns=None):
        os.makedirs(pcap_dir, exist_ok=True)
        self.lost = 0

        def lookup(gid: int) -> bytes:
            if dns is not None:
                addr = dns.address_of(gid)
                if addr is not None:
                    return addr.ip.to_bytes(4, "big")
            return _ip_of(gid)

        self.writers = {
            gid: PcapWriter(
                os.path.join(pcap_dir, f"{name}.pcap"), ip_lookup=lookup
            )
            for gid, name in zip(host_ids, names)
        }
        self.last_wr = {gid: 0 for gid in host_ids}
        # records per lifecycle stage over everything drained
        self.stage_counts = {name: 0 for name in STAGE_NAMES.values()}
        self.host_s = 0.0  # wall seconds spent in `ingest`

    @staticmethod
    def gather(cap: CaptureRing) -> dict:
        """Device tensors for one drain (no copy): the heartbeat harvest
        carries them in its one copy; hand the fetched dict to
        `ingest`."""
        return {"t": cap.t, "meta": cap.meta, "wr": cap.wr}

    def drain(self, cap: CaptureRing) -> None:
        """Copy the rings to the host (one copy) and ingest them."""
        from shadow_tpu_torch.runtime.harvest import fetch_tree

        self.ingest(fetch_tree(self.gather(cap)))

    def ingest(self, fetched: dict) -> None:
        """Write a fetched (numpy) `gather` dict's new records into the
        per-host pcap files. The ring is never reset on the device, so
        ingesting the same snapshot twice writes nothing."""
        t0 = time.perf_counter()
        t = np.asarray(fetched["t"])
        meta = np.asarray(fetched["meta"])
        wr = np.asarray(fetched["wr"])
        r = t.shape[1]
        for gid, w in self.writers.items():
            new = int(wr[gid])
            start = self.last_wr[gid]
            if new - start > r:
                self.lost += new - start - r
                start = new - r
            idx = [(i % r) for i in range(start, new)]
            order = sorted(idx, key=lambda i: int(t[gid, i]))
            for i in order:
                m = meta[gid, i]
                stages = (int(m[M_META]) >> 16) & 0xFF
                for bit, name in STAGE_NAMES.items():
                    if stages & bit:
                        self.stage_counts[name] += 1
                src = int(m[M_SRC])
                if src < 0:
                    src = gid  # tx-side record: the ring's own host
                w.record(
                    int(t[gid, i]), src, int(m[M_DST]),
                    int(m[M_SPORT]), int(m[M_DPORT]),
                    int(m[M_META]) & 0xFFFF, int(m[M_LEN]),
                    int(m[M_SEQ]), int(m[M_ACK]),
                    verdict=stages,
                )
            self.last_wr[gid] = new
        self.host_s += time.perf_counter() - t0

    def close(self) -> None:
        for w in self.writers.values():
            w.close()
