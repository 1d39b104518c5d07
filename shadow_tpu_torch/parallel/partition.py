"""Locality-aware host partitioning for sharded meshes: the counterpart
of `shadow_tpu.parallel.partition`, kept as this package's own copy.

The reference assigns hosts to worker threads by random shuffle
(reference: src/main/core/scheduler/scheduler.c:440-534) and corrects
imbalance at runtime with work stealing
(scheduler_policy_host_steal.c:28-58). On a device mesh neither applies:
assignment is static and the cost that matters is CROSS-SHARD packets,
each of which rides the bucketed all_to_all exchange instead of a local
queue push. This module reorders hosts at build time so that hosts that
talk to each other land on the same shard.

Traffic edges come from the config itself: any process argument token
that names another host (tgen's `server=web3`, the process tier's
`client srv0 ...`, tor's `server=web1:80`) is an edge. Models whose
traffic topology is internal (tor circuit selection, bitcoin peer
graphs) can widen this by naming peers in arguments; unnamed traffic
simply keeps the config order.

The partition is a greedy capacity-bounded cluster merge (heaviest edge
first, union while the merged cluster still fits one shard), packed
first-fit-decreasing into shards. Deterministic: ties break on (weight,
gid) order, never on hash order.
"""

from __future__ import annotations

import re
from collections import defaultdict


def traffic_edges_from_config(hosts) -> list[tuple[int, int, int]]:
    """[(gid_a, gid_b, weight)] from process-argument name references.

    A token matches a host if it equals the host's name exactly or up to
    a ':port' suffix. Weight counts references (a client naming its
    server twice talks to it more).
    """
    by_name = {h.name: h.gid for h in hosts}
    weights: dict[tuple[int, int], int] = defaultdict(int)
    for h in hosts:
        for proc in h.spec.processes:
            for tok in re.split(r"[\s,=]+", proc.arguments or ""):
                tok = tok.split(":", 1)[0]
                peer = by_name.get(tok)
                if peer is None or peer == h.gid:
                    continue
                a, b = sorted((h.gid, peer))
                weights[(a, b)] += 1
    return [(a, b, w) for (a, b), w in sorted(weights.items())]


def locality_order(
    n_hosts: int, edges: list[tuple[int, int, int]], n_shards: int,
    dcn_slices: int = 1,
) -> list[int]:
    """Permutation `perm` such that placing host perm[i] at position i
    block-partitions chatty clusters onto common shards.

    Every shard receives exactly n_hosts // n_shards hosts (the engine's
    block partition requires equal shards).

    `dcn_slices` (multi-slice meshes): shards group dcn-major into
    slices of n_shards // dcn_slices — the same layout the mesh's
    block partition uses — and a cluster too large for one shard
    splits across the shards of ONE slice when any slice has the room,
    so its internal traffic rides ICI instead of DCN.
    """
    if n_hosts % n_shards:
        raise ValueError(f"{n_hosts} hosts not divisible by {n_shards}")
    if dcn_slices > 1 and n_shards % dcn_slices:
        raise ValueError(
            f"{n_shards} shards not divisible by {dcn_slices} DCN slices"
        )
    cap = n_hosts // n_shards

    parent = list(range(n_hosts))
    size = [1] * n_hosts

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    # heaviest edges first; merge while the union still fits one shard
    for a, b, _w in sorted(edges, key=lambda e: (-e[2], e[0], e[1])):
        ra, rb = find(a), find(b)
        if ra == rb or size[ra] + size[rb] > cap:
            continue
        if size[ra] < size[rb]:
            ra, rb = rb, ra
        parent[rb] = ra
        size[ra] += size[rb]

    clusters: dict[int, list[int]] = defaultdict(list)
    for g in range(n_hosts):
        clusters[find(g)].append(g)

    # first-fit-decreasing packing into shards of exactly `cap` hosts
    shards: list[list[int]] = [[] for _ in range(n_shards)]
    for members in sorted(
        clusters.values(), key=lambda m: (-len(m), m[0])
    ):
        placed = False
        for s in shards:
            if len(s) + len(members) <= cap:
                s.extend(members)
                placed = True
                break
        if not placed:
            # split the cluster across shards (only happens when the
            # remaining free space is fragmented). On a multi-slice
            # mesh the WHOLE cluster prefers the roomiest single slice
            # before spilling to the next, so its internal traffic
            # rides ICI rather than DCN; slice order is fixed per
            # cluster, not re-chosen per chunk.
            rest = list(members)
            if dcn_slices > 1:
                per_slice = n_shards // dcn_slices

                def _free(sl: int) -> int:
                    return sum(cap - len(s) for s in
                               shards[sl * per_slice:(sl + 1) * per_slice])

                order = [
                    sl * per_slice + k
                    for sl in sorted(range(dcn_slices),
                                     key=lambda i: (-_free(i), i))
                    for k in range(per_slice)
                ]
                for idx in order:
                    if not rest:
                        break
                    take = min(cap - len(shards[idx]), len(rest))
                    shards[idx].extend(rest[:take])
                    rest = rest[take:]
            while rest:
                s = min(shards, key=len)
                take = min(cap - len(s), len(rest))
                s.extend(rest[:take])
                rest = rest[take:]

    perm = [g for s in shards for g in s]
    assert sorted(perm) == list(range(n_hosts))
    return perm


def apply_order(hosts, perm: list[int]):
    """Reorder HostInstances by `perm` and renumber gids densely.

    Returns the new list; position i holds the host formerly known as
    gid perm[i], now with gid i. Must run before DNS registration,
    attachment, or model build — every downstream gid then reflects the
    locality layout automatically.
    """
    import dataclasses

    return [
        dataclasses.replace(hosts[g], gid=i) for i, g in enumerate(perm)
    ]
