"""Network topology: GraphML graph -> dense routing tables on the device.

The counterpart of `shadow_tpu.net.topology`. The GraphML parse, the
attachment hints and the all-pairs path computation run on the host in
numpy, copied from the reference so that the tables come out
bit-identical; `GraphNetwork.route` is then a gather from torch tensors
on the engine's device, O(1) per packet, no cache, no lock.

Semantics, as in the reference:
- vertex attrs: bandwidthup/down (KiB/s), ip, citycode, countrycode,
  type, packetloss; edge attrs: latency (ms), packetloss, jitter (ms);
- complete graphs use the direct edge as the path; otherwise Dijkstra by
  edge latency, with path reliability the product of (1 - src vertex
  loss), (1 - edge loss) per hop and (1 - dst vertex loss);
- a path from a vertex to itself with no self-loop uses the
  minimum-latency incident edge twice;
- hosts attach to a vertex by hint matching, preferring ip > city+type >
  city > country+type > country > geo+type > geo > type > any;
- the graph-wide minimum latency, less jitter, is the conservative
  lookahead.

`from_graphml` needs networkx and the Dijkstra path needs scipy; both
are imported where they are used.
"""

from __future__ import annotations

import dataclasses
import lzma
import os
from typing import Sequence

import numpy as np
import torch

from shadow_tpu_torch.core.device import resolve_device
from shadow_tpu_torch.core.timebase import MILLISECOND


@dataclasses.dataclass
class Vertex:
    vid: str
    index: int
    bandwidth_up_kib: int = 0  # KiB/s
    bandwidth_down_kib: int = 0
    ip: str = ""
    citycode: str = ""
    countrycode: str = ""
    geocode: str = ""
    vtype: str = ""
    packetloss: float = 0.0


class Topology:
    """Parsed GraphML topology + all-pairs path computation (host side)."""

    def __init__(self, vertices: Sequence[Vertex], edges, *, directed=False,
                 prefer_direct_paths=False):
        self.vertices = list(vertices)
        # edges: list of (u_index, v_index, latency_ms, packetloss, jitter_ms)
        self.edges = list(edges)
        self.directed = directed
        self.prefer_direct_paths = prefer_direct_paths
        self._index = {v.vid: v.index for v in self.vertices}
        self._attach_rr: dict[tuple, int] = {}  # round-robin cursor per hint class
        self._lat_ms: np.ndarray | None = None
        self._jit_ms: np.ndarray | None = None
        self._rel: np.ndarray | None = None

    # ---------------------------------------------------------------- load
    @staticmethod
    def from_graphml(text_or_path) -> "Topology":
        """Load from a GraphML string, file path, or .xz file path."""
        import networkx as nx

        data = text_or_path
        if not isinstance(data, str):
            data = os.fspath(data)
        if "\n" not in data and "<" not in data:
            with open(data, "rb") as f:
                raw = f.read()
            if data.endswith(".xz"):
                raw = lzma.decompress(raw)
            data = raw.decode()
        g = nx.parse_graphml(data)
        directed = g.is_directed()

        verts = []
        for i, (nid, attrs) in enumerate(g.nodes(data=True)):
            verts.append(
                Vertex(
                    vid=str(nid),
                    index=i,
                    bandwidth_up_kib=int(attrs.get("bandwidthup", 0)),
                    bandwidth_down_kib=int(attrs.get("bandwidthdown", 0)),
                    ip=str(attrs.get("ip", "")),
                    citycode=str(attrs.get("citycode", "")),
                    countrycode=str(attrs.get("countrycode", "")),
                    geocode=str(attrs.get("geocode", "")),
                    vtype=str(attrs.get("type", "")),
                    packetloss=float(attrs.get("packetloss", 0.0)),
                )
            )
        idx = {v.vid: v.index for v in verts}
        edges = []
        for u, v, attrs in g.edges(data=True):
            edges.append(
                (
                    idx[str(u)],
                    idx[str(v)],
                    float(attrs["latency"]),
                    float(attrs.get("packetloss", 0.0)),
                    float(attrs.get("jitter", 0.0)),
                )
            )
        prefer = bool(g.graph.get("preferdirectpaths", False))
        return Topology(verts, edges, directed=directed, prefer_direct_paths=prefer)

    @property
    def n_vertices(self) -> int:
        return len(self.vertices)

    # ------------------------------------------------------------- attach
    def attach(self, *, ip_hint: str = "", citycode_hint: str = "",
               countrycode_hint: str = "", geocode_hint: str = "",
               type_hint: str = "") -> int:
        """Pick the vertex a host attaches to, by hint preference classes.

        Classes, most-specific first (mirrors AttachHelper's queue ordering,
        topology.c:107-138): exact-ip, city+type, city, country+type,
        country, geo+type, geo, type, all. Within the winning class,
        assignment is deterministic round-robin (the reference draws
        randomly from its seeded RNG; round-robin keeps the same balancing
        property bit-reproducibly).
        """
        vs = self.vertices
        if ip_hint:
            exact = [v for v in vs if v.ip == ip_hint]
            if exact:
                return self._rr(("ip", ip_hint), exact)

        def match(city=None, country=None, geo=None, typ=None):
            out = []
            for v in vs:
                if city is not None and v.citycode != city:
                    continue
                if country is not None and v.countrycode != country:
                    continue
                if geo is not None and v.geocode != geo:
                    continue
                if typ is not None and v.vtype != typ:
                    continue
                out.append(v)
            return out

        classes = []
        if citycode_hint and type_hint:
            classes.append((("ct", citycode_hint, type_hint),
                            match(city=citycode_hint, typ=type_hint)))
        if citycode_hint:
            classes.append((("c", citycode_hint), match(city=citycode_hint)))
        if countrycode_hint and type_hint:
            classes.append((("nt", countrycode_hint, type_hint),
                            match(country=countrycode_hint, typ=type_hint)))
        if countrycode_hint:
            classes.append((("n", countrycode_hint), match(country=countrycode_hint)))
        if geocode_hint and type_hint:
            classes.append((("gt", geocode_hint, type_hint),
                            match(geo=geocode_hint, typ=type_hint)))
        if geocode_hint:
            classes.append((("g", geocode_hint), match(geo=geocode_hint)))
        if type_hint:
            classes.append((("t", type_hint), match(typ=type_hint)))
        classes.append((("all",), vs))
        for key, cand in classes:
            if cand:
                return self._rr(key, cand)
        raise ValueError("topology has no vertices")

    def _rr(self, key, cand):
        i = self._attach_rr.get(key, 0)
        self._attach_rr[key] = i + 1
        return cand[i % len(cand)].index

    # ------------------------------------------------- all-pairs matrices
    def _edge_matrices(self):
        """Dense [V,V] direct-edge latency (ms; inf if absent), -log
        reliability, and jitter (ms) matrices. Parallel edges keep the
        lowest latency."""
        v = self.n_vertices
        lat = np.full((v, v), np.inf)
        neglog = np.zeros((v, v))
        jit = np.zeros((v, v))
        for u, w, l, loss, j in self.edges:
            pairs = [(u, w)] if self.directed else [(u, w), (w, u)]
            for a, b in pairs:
                if l < lat[a, b]:
                    lat[a, b] = l
                    neglog[a, b] = -np.log(max(1.0 - loss, 1e-30))
                    jit[a, b] = j
        return lat, neglog, jit

    def _is_complete(self, lat: np.ndarray) -> bool:
        # every vertex must have an edge to every vertex *including itself*
        # (reference: topology.c:450-530 "_topology_isComplete")
        return bool(np.all(np.isfinite(lat)))

    def compute_all_pairs(self):
        """(latency_ms f64[V,V], reliability f32[V,V], jitter_ms f64[V,V])
        over path semantics; jitter accumulates along paths like latency
        (edge attrs, topology.c:101-105)."""
        if self._lat_ms is not None:
            return self._lat_ms, self._rel, self._jit_ms
        v = self.n_vertices
        w_lat, w_neglog, w_jit = self._edge_matrices()
        vloss = np.array([vx.packetloss for vx in self.vertices])
        v_neglog = -np.log(np.maximum(1.0 - vloss, 1e-30))

        if self._is_complete(w_lat):
            lat = w_lat.copy()
            neglog = w_neglog.copy()
            jit = w_jit.copy()
        else:
            from scipy.sparse import csr_matrix
            from scipy.sparse.csgraph import dijkstra

            finite = np.isfinite(w_lat)
            graph = csr_matrix((w_lat[finite], np.nonzero(finite)), shape=(v, v))
            dist, pred = dijkstra(
                graph, directed=True, return_predecessors=True
            )
            neglog = self._path_cost_along_tree(pred, w_neglog)
            jit = self._path_cost_along_tree(pred, w_jit)
            lat = dist
            # diagonal: dijkstra gives 0; apply the self-path rule
            np.fill_diagonal(lat, np.inf)
            np.fill_diagonal(neglog, 0.0)
            np.fill_diagonal(jit, 0.0)
            self._fill_self_paths(lat, neglog, jit, w_lat, w_neglog, w_jit)
            if self.prefer_direct_paths:
                # adjacent pairs use the direct edge even if a multi-hop
                # path is shorter (topology.c:1321-1336 shouldStorePath)
                use = np.isfinite(w_lat)
                lat[use] = w_lat[use]
                neglog[use] = w_neglog[use]
                jit[use] = w_jit[use]

        # endpoint vertex loss applies for src != dst paths
        # (topology.c:1441-1463; self paths use edge loss only :1641)
        off = ~np.eye(v, dtype=bool)
        neglog = neglog + off * (v_neglog[:, None] + v_neglog[None, :])
        rel = np.exp(-neglog).astype(np.float32)
        rel[~np.isfinite(lat)] = 0.0
        self._lat_ms, self._rel, self._jit_ms = lat, rel, jit
        return lat, rel, jit

    @staticmethod
    def _path_cost_along_tree(pred: np.ndarray, w: np.ndarray) -> np.ndarray:
        """Accumulate per-edge cost `w` along the shortest-path trees.

        `pred[s, d]` is d's predecessor on the s->d shortest path. Pointer
        jumping: each round, every entry adds its predecessor's accumulated
        cost and jumps its pointer, so costs converge in O(log diameter)
        fully-vectorized rounds (the TPU-era answer to walking igraph path
        vectors one pair at a time, topology.c:1476-1510).
        """
        v = pred.shape[0]
        no_pred = pred < 0
        p = np.where(no_pred, np.arange(v)[None, :], pred)
        cost = np.where(no_pred, 0.0, w[p, np.arange(v)[None, :]])
        src = np.arange(v)[:, None]
        for _ in range(max(1, int(np.ceil(np.log2(v + 1))) + 1)):
            done = p == src
            add = np.take_along_axis(cost, p, axis=1)
            cost = cost + np.where(done, 0.0, add)
            p = np.take_along_axis(p, p, axis=1)
            if np.all(p == src):
                break
        return cost

    @staticmethod
    def _fill_self_paths(lat, neglog, jit, w_lat, w_neglog, w_jit):
        """Self paths: min-latency incident edge used twice
        (topology.c:1545-1652). A direct self-loop edge, if present, is its
        own incident edge — giving 2x its latency like the reference."""
        v = lat.shape[0]
        inc = w_lat.copy()
        best = np.argmin(inc, axis=1)
        rows = np.arange(v)
        m = inc[rows, best]
        lat[rows, rows] = 2.0 * m
        neglog[rows, rows] = 2.0 * w_neglog[rows, best]
        jit[rows, rows] = 2.0 * w_jit[rows, best]

    @property
    def min_latency_ms(self) -> float:
        """Graph-wide minimum edge latency — the conservative lookahead
        (topology.c:1374-1385, master.c:133-159). Jitter can shrink an
        edge's effective latency, so it tightens the bound."""
        if not self.edges:
            return 1.0
        return max(min(e[2] - e[4] for e in self.edges), 0.001)

    # -------------------------------------------------------- device side
    def build_network(self, host_vertex: Sequence[int],
                      device=None) -> "GraphNetwork":
        """Routing tables for hosts attached at `host_vertex` (one vertex
        index per global host id), on `device` (None: CUDA)."""
        lat_ms, rel, jit_ms = self.compute_all_pairs()
        lat_ns = np.where(
            np.isfinite(lat_ms), lat_ms * MILLISECOND, np.int64(2**62)
        ).astype(np.int64)
        jit_ns = np.where(
            np.isfinite(lat_ms), jit_ms * MILLISECOND, 0
        ).astype(np.int64)
        return GraphNetwork.from_numpy(
            np.asarray(host_vertex, np.int32), lat_ns, rel, jit_ns, device)


def jax_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Index `idx` into an axis of length n the way a JAX gather reads
    it: a negative index counts from the end once, then anything out of
    range clamps to the nearest end."""
    idx = idx.long()
    return torch.clamp(torch.where(idx < 0, idx + n, idx), 0, n - 1)


@dataclasses.dataclass(frozen=True)
class GraphNetwork:
    """Device routing tables; `route` is a gather.

    `has_jitter` and `min_latency_ns` are host-side values, read from the
    tables once when the network is built.
    """

    host2v: torch.Tensor  # i32[H_global] host -> attached vertex
    lat: torch.Tensor  # i64[V, V] path latency ns
    rel: torch.Tensor  # f32[V, V] path reliability
    jit: torch.Tensor  # i64[V, V] path jitter amplitude ns
    has_jitter: bool
    min_latency_ns: int

    @staticmethod
    def from_numpy(host2v, lat, rel, jit, device=None) -> "GraphNetwork":
        """Tables from numpy arrays (i32 host2v, i64 lat and jit, f32 rel)
        onto `device` (None: CUDA)."""
        dev = resolve_device(device)
        on = lambda a, dtype: torch.from_numpy(
            np.array(a, dtype=dtype, order="C")).to(dev)
        return GraphNetwork(
            host2v=on(host2v, np.int32), lat=on(lat, np.int64),
            rel=on(rel, np.float32), jit=on(jit, np.int64),
            has_jitter=bool(np.any(np.asarray(jit) > 0)),
            min_latency_ns=int(np.min(lat)),
        )

    def route(self, src_gid: torch.Tensor, dst_gid: torch.Tensor):
        """(latency i64, reliability f32, jitter i64) per (src, dst) pair,
        with the reference's gather semantics for ids out of range."""
        n, v = self.host2v.shape[0], self.lat.shape[0]
        sv = jax_index(self.host2v[jax_index(src_gid, n)], v)
        dv = jax_index(self.host2v[jax_index(dst_gid, n)], v)
        return self.lat[sv, dv], self.rel[sv, dv], self.jit[sv, dv]
