"""Per-host socket tables: fixed-width [H, S] slot tensors and their demux.

The counterpart of `shadow_tpu.host.sockets`. Every host owns S socket
slots. Demux scores each slot against the packet's key per row, and a
connection-specific slot (peer matches) beats a wildcard bind.
"""

from __future__ import annotations

import dataclasses

import torch

PROTO_NONE = 0
PROTO_UDP = 1
PROTO_TCP = 2

# First auto-assigned port.
EPHEMERAL_BASE = 10_000


def _col(v, like: torch.Tensor, dtype) -> torch.Tensor:
    """An [H] value (tensor or scalar) as an [H, 1] column of `dtype`."""
    return torch.as_tensor(v, dtype=dtype, device=like.device).expand(
        like.shape[:1]).reshape(-1, 1)


@dataclasses.dataclass(frozen=True)
class SocketTable:
    """Socket slots, [H, S] tensors.

    peer_host == -1 means unconnected (a wildcard receive on local_port).
    rx_bytes / tx_bytes count payload bytes per socket.
    """

    proto: torch.Tensor  # i32[H, S]
    local_port: torch.Tensor  # i32[H, S]
    peer_host: torch.Tensor  # i32[H, S]
    peer_port: torch.Tensor  # i32[H, S]
    rx_bytes: torch.Tensor  # i64[H, S]
    tx_bytes: torch.Tensor  # i64[H, S]

    @staticmethod
    def create(n_hosts: int, n_sockets: int, *, device) -> "SocketTable":
        """[H, S] table, all slots closed."""
        shape = (n_hosts, n_sockets)
        z = lambda dtype: torch.zeros(shape, dtype=dtype, device=device)
        return SocketTable(
            proto=z(torch.int32), local_port=z(torch.int32),
            peer_host=torch.full(shape, -1, dtype=torch.int32, device=device),
            peer_port=z(torch.int32), rx_bytes=z(torch.int64),
            tx_bytes=z(torch.int64),
        )

    def bind(self, host_row: int, slot: int, proto: int, port: int,
             peer_host: int = -1, peer_port: int = 0) -> "SocketTable":
        """Open a socket in (host_row, slot): a build-time setup step."""
        def put(a, v):
            a = a.clone()
            a[host_row, slot] = v
            return a

        return dataclasses.replace(
            self,
            proto=put(self.proto, proto),
            local_port=put(self.local_port, port),
            peer_host=put(self.peer_host, peer_host),
            peer_port=put(self.peer_port, peer_port),
        )

    # -- per-row ops: one packet per host --------------------------------------
    def demux(self, proto, dst_port, src_host, src_port) -> torch.Tensor:
        """i32[H]: the slot receiving each row's packet, or -1.

        Connection-specific (peer matches) beats wildcard-bound; among
        equal scores the first slot wins, as `argmax` picks it.
        """
        i32 = torch.int32
        base = ((self.proto == _col(proto, self.proto, i32))
                & (self.local_port == _col(dst_port, self.proto, i32)))
        exact = (base & (self.peer_host == _col(src_host, self.proto, i32))
                 & (self.peer_port == _col(src_port, self.proto, i32)))
        wild = base & (self.peer_host == -1)
        score = exact.to(i32) * 2 + wild.to(i32)
        first = torch.argmax(score, dim=1).to(i32)
        return torch.where(torch.amax(score, dim=1) > 0, first, -1)

    def _add(self, field: str, slot, nbytes) -> "SocketTable":
        cur = getattr(self, field)
        s = cur.shape[1]
        slot = _col(slot, cur, torch.int32)
        oh = (torch.arange(s, dtype=torch.int32, device=cur.device)[None, :]
              == slot) & (slot >= 0)
        add = torch.where(oh, _col(nbytes, cur, torch.int64), 0)
        return dataclasses.replace(self, **{field: cur + add})

    def add_rx(self, slot, nbytes) -> "SocketTable":
        """Count nbytes received on each row's slot (none where -1)."""
        return self._add("rx_bytes", slot, nbytes)

    def add_tx(self, slot, nbytes) -> "SocketTable":
        """Count nbytes sent on each row's slot (none where -1)."""
        return self._add("tx_bytes", slot, nbytes)
