"""DNS: virtual IP and hostname registry (host side, plain Python).

A copy of `shadow_tpu.net.dns`, kept here because importing the reference
package would import JAX: sequential IP assignment that skips every
reserved IPv4 range, unique names, and the name <-> IP <-> host-id maps,
keyed by the dense global host id the engine uses.
"""

from __future__ import annotations

import dataclasses
import ipaddress

_RESERVED = [
    ipaddress.ip_network(c)
    for c in (
        "0.0.0.0/8", "10.0.0.0/8", "100.64.0.0/10", "127.0.0.0/8",
        "169.254.0.0/16", "172.16.0.0/12", "192.0.0.0/29", "192.0.2.0/24",
        "192.88.99.0/24", "192.168.0.0/16", "198.18.0.0/15",
        "198.51.100.0/24", "203.0.113.0/24", "224.0.0.0/4", "240.0.0.0/4",
        "255.255.255.255/32",
    )
]


def _is_restricted(ip: int) -> bool:
    a = ipaddress.ip_address(ip)
    return any(a in n for n in _RESERVED)


@dataclasses.dataclass(frozen=True)
class Address:
    """{host id, ip, name} — the reference's Address record
    (src/main/routing/address.h) minus refcounting (value type)."""

    host_id: int
    ip: int  # host-order u32
    name: str

    @property
    def ip_str(self) -> str:
        return str(ipaddress.ip_address(self.ip))


class DNS:
    def __init__(self):
        self._counter = 0
        self._by_ip: dict[int, Address] = {}
        self._by_name: dict[str, Address] = {}
        self._by_id: dict[int, Address] = {}

    def _generate_ip(self) -> int:
        self._counter += 1
        while True:
            a = ipaddress.ip_address(self._counter)
            hit = next((n for n in _RESERVED if a in n), None)
            if hit is not None:
                # leap the whole reserved block instead of walking it
                self._counter = int(hit.broadcast_address) + 1
                continue
            if self._counter in self._by_ip:
                self._counter += 1
                continue
            return self._counter

    def register(self, host_id: int, name: str, requested_ip: str | None = None) -> Address:
        """Register a host; honors a requested IP if it is usable, else
        auto-assigns (dns.c:117-165)."""
        if name in self._by_name:
            raise ValueError(f"hostname already registered: {name}")
        ip = None
        if requested_ip:
            cand = int(ipaddress.ip_address(requested_ip))
            if not _is_restricted(cand) and cand not in self._by_ip:
                ip = cand
        if ip is None:
            ip = self._generate_ip()
        addr = Address(host_id=host_id, ip=ip, name=name)
        self._by_ip[ip] = addr
        self._by_name[name] = addr
        self._by_id[host_id] = addr
        return addr

    def resolve_name(self, name: str) -> Address | None:
        return self._by_name.get(name)

    def resolve_ip(self, ip) -> Address | None:
        if isinstance(ip, str):
            ip = int(ipaddress.ip_address(ip))
        return self._by_ip.get(ip)

    def address_of(self, host_id: int) -> Address | None:
        return self._by_id.get(host_id)

    def entries(self) -> list[Address]:
        """All registered addresses (registration order)."""
        return list(self._by_name.values())

    def __len__(self) -> int:
        return len(self._by_id)
