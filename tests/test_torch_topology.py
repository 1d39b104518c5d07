"""The graph topology and jittered routing in shadow_tpu_torch against
shadow_tpu.

- the GraphML fixtures of tests/test_topology.py, and a graph with
  jitter, parsed by both packages: equal latency, reliability and jitter
  tables, and equal attachment;
- `Engine._route` with jitter and reliability below 1 on a GraphNetwork,
  and a PHOLD run over such a network;
- the jitter cast, over every 24-bit uniform and a sweep of amplitudes.

Every comparison is exact, dtypes included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_tpu.core import engine as jengine
from shadow_tpu.core import rng as jrng
from shadow_tpu.models import phold as jphold
from shadow_tpu.net import topology as jtop
from shadow_tpu_torch import convert
from shadow_tpu_torch.core import engine as tengine
from shadow_tpu_torch.core import rng as trng
from shadow_tpu_torch.models import phold as tphold
from shadow_tpu_torch.net import topology as ttop
from test_topology import GRAPHML_1POI, GRAPHML_LINE
from test_torch_phold import (  # noqa: F401 (one_torch_thread: autouse)
    assert_leaves_equal, jax_leaves, one_torch_thread)

MS = 1_000_000
SECOND = 1_000_000_000

# four vertices, not complete, with edge jitter and vertex loss
GRAPHML_JITTER = """<?xml version="1.0" encoding="utf-8"?>
<graphml xmlns="http://graphml.graphdrawing.org/xmlns">
  <key attr.name="jitter" attr.type="double" for="edge" id="d8" />
  <key attr.name="packetloss" attr.type="double" for="edge" id="d6" />
  <key attr.name="latency" attr.type="double" for="edge" id="d5" />
  <key attr.name="packetloss" attr.type="double" for="node" id="d4" />
  <key attr.name="citycode" attr.type="string" for="node" id="d3" />
  <graph edgedefault="undirected">
    <node id="w"><data key="d4">0.01</data><data key="d3">AAA</data></node>
    <node id="x"><data key="d4">0.0</data><data key="d3">BBB</data></node>
    <node id="y"><data key="d4">0.05</data><data key="d3">AAA</data></node>
    <node id="z"><data key="d4">0.02</data><data key="d3">CCC</data></node>
    <edge source="w" target="x"><data key="d5">12.5</data>
      <data key="d6">0.1</data><data key="d8">3.25</data></edge>
    <edge source="x" target="y"><data key="d5">20.0</data>
      <data key="d6">0.05</data><data key="d8">1.5</data></edge>
    <edge source="y" target="z"><data key="d5">7.0</data>
      <data key="d6">0.2</data><data key="d8">0.75</data></edge>
    <edge source="w" target="z"><data key="d5">40.0</data>
      <data key="d6">0.0</data><data key="d8">5.0</data></edge>
  </graph>
</graphml>"""

GRAPHS = {"1poi": GRAPHML_1POI, "line": GRAPHML_LINE,
          "jitter": GRAPHML_JITTER}


def assert_tables_equal(a, b):
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", list(GRAPHS))
def test_graphml_tables_match_reference(name):
    tj = jtop.Topology.from_graphml(GRAPHS[name])
    tt = ttop.Topology.from_graphml(GRAPHS[name])
    assert_tables_equal(tj.compute_all_pairs(), tt.compute_all_pairs())
    assert tj.min_latency_ms == tt.min_latency_ms
    hints = [dict(), dict(countrycode_hint="US"), dict(citycode_hint="AAA"),
             dict(countrycode_hint="US", type_hint="relay"),
             dict(type_hint="client"), dict(citycode_hint="ZZZ")]
    assert ([tj.attach(**h) for h in hints * 3]
            == [tt.attach(**h) for h in hints * 3])
    hv = [tj.attach() for _ in range(5)]
    nj = tj.build_network(hv)
    nt = tt.build_network(hv, device="cpu")
    assert_tables_equal((nj.host2v, nj.lat, nj.rel, nj.jit),
                        (nt.host2v, nt.lat, nt.rel, nt.jit))
    assert (nj.has_jitter, nj.min_latency_ns) == (nt.has_jitter,
                                                 nt.min_latency_ns)
    nc = ttop.GraphNetwork.from_numpy(
        *(np.asarray(getattr(nj, k)) for k in ("host2v", "lat", "rel", "jit")),
        device="cpu")
    assert_tables_equal((nc.lat, nc.rel), (nt.lat, nt.rel))


def test_random_graph_paths_match_reference():
    """The Dijkstra + pointer-jumping path on random sparse graphs."""
    rng = np.random.default_rng(7)
    v = 14
    verts = [(str(i), i) for i in range(v)]
    edges = [(i, (i + 1) % v, 60.0, 0.05, 1.0) for i in range(v)]
    for i in range(v):
        for j in range(i + 1, v):
            if rng.random() < 0.3:
                edges.append((i, j, float(rng.integers(1, 50)),
                              float(rng.random() * 0.3),
                              float(rng.random() * 4)))
    tj = jtop.Topology([jtop.Vertex(vid=a, index=b) for a, b in verts], edges)
    tt = ttop.Topology([ttop.Vertex(vid=a, index=b) for a, b in verts], edges)
    assert_tables_equal(tj.compute_all_pairs(), tt.compute_all_pairs())


def test_route_gathers_with_reference_index_semantics():
    tt = ttop.Topology.from_graphml(GRAPHML_LINE)
    tj = jtop.Topology.from_graphml(GRAPHML_LINE)
    nt = tt.build_network([0, 0, 2], device="cpu")
    nj = tj.build_network([0, 0, 2])
    src = np.array([0, 0, 1, -1, 7, -5], np.int32)
    dst = np.array([2, 1, 0, 0, 1, 2], np.int32)
    assert_tables_equal(nj.route(jnp.asarray(src), jnp.asarray(dst)),
                        nt.route(torch.from_numpy(src), torch.from_numpy(dst)))


def jitter_network(pkg, n_hosts):
    top = (jtop if pkg == "jax" else ttop).Topology.from_graphml(
        GRAPHML_JITTER)
    hv = [top.attach() for _ in range(n_hosts)]
    if pkg == "jax":
        return top, top.build_network(hv)
    return top, top.build_network(hv, device="cpu")


def test_route_with_jitter_matches_reference():
    """One routed [N, K] batch through each package's `_route`, on a
    GraphNetwork with jitter and reliability below 1."""
    rng = np.random.default_rng(3)
    n, k, hosts = 256, 3, 12
    emit = dict(
        dst=rng.integers(0, hosts, size=(n, k)).astype(np.int32),
        dt=rng.integers(-5, 30 * MS, size=(n, k)).astype(np.int64),
        kind=rng.integers(0, 2, size=(n, k)).astype(np.int32),
        args=rng.integers(-9, 9, size=(n, k, 2)).astype(np.int32),
        mask=rng.random((n, k)) < 0.8,
        local=rng.random((n, k)) < 0.2,
    )
    base = rng.integers(0, SECOND, size=n).astype(np.int64)
    gids = rng.integers(0, hosts, size=n).astype(np.int32)
    cnt = rng.integers(0, 1000, size=n).astype(np.int32)
    seq = rng.integers(0, 100, size=(n, k)).astype(np.int32)
    window_end = 400 * MS
    cfg = dict(n_hosts=hosts, capacity=8, lookahead=MS, max_emit=k,
               n_args=2)
    _, netj = jitter_network("jax", hosts)
    _, nett = jitter_network("torch", hosts)
    assert netj.has_jitter and nett.has_jitter
    ej = jengine.Engine(jengine.EngineConfig(**cfg), [None], netj)
    et = tengine.Engine(tengine.EngineConfig(**cfg), [None], nett,
                        device="cpu")
    _, rkj = jrng.event_keys(ej._base_key, jnp.asarray(gids),
                             jnp.asarray(cnt))
    _, rkt = trng.event_keys(et._base_key, torch.from_numpy(gids),
                             torch.from_numpy(cnt))
    outj, fmj, drj, _fdj, tj, locj = jax.jit(ej._route)(
        jengine.Emit(**{f: jnp.asarray(v) for f, v in emit.items()}),
        jnp.asarray(base), jnp.asarray(gids), jnp.int64(window_end), rkj,
        jnp.asarray(emit["mask"]), jnp.asarray(seq))
    outt, fmt, drt, fdt, tt, loct = et._route(
        tengine.Emit(**{f: torch.from_numpy(v) for f, v in emit.items()}),
        torch.from_numpy(base), torch.from_numpy(gids),
        torch.tensor(window_end), rkt, torch.from_numpy(emit["mask"]),
        torch.from_numpy(seq))
    for f in ("time", "dst", "src", "seq", "kind", "args"):
        a, b = np.asarray(getattr(outj, f)), getattr(outt, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    np.testing.assert_array_equal(np.asarray(fmj), fmt.numpy())
    np.testing.assert_array_equal(np.asarray(drj), drt.numpy())
    # the routed times and locality the trace and stats branches read
    np.testing.assert_array_equal(np.asarray(tj), tt.numpy())
    np.testing.assert_array_equal(np.asarray(locj), loct.numpy())
    assert fdt is None  # no fault overlay compiled in
    assert drt.any() and fmt.any()


@pytest.mark.parametrize("batched", [False, True], ids=["chained", "batched"])
def test_phold_over_jittered_graph_matches_reference(batched):
    """PHOLD over the jittered four-vertex graph (loss on every path)."""
    hosts, stop = 12, SECOND
    out = {}
    for pkg, eng_mod, ph in (("jax", jengine, jphold),
                             ("torch", tengine, tphold)):
        top, net = jitter_network(pkg, hosts)
        cfg = eng_mod.EngineConfig(
            n_hosts=hosts, capacity=32, max_emit=1, n_args=1, seed=13,
            drain_batch=24, lookahead=int(top.min_latency_ms * MS))
        dev = {} if pkg == "jax" else {"device": "cpu"}
        eng = eng_mod.Engine(
            cfg, [ph.make_handler(hosts, 10 * MS)], net,
            batch_handler=(ph.make_batch_handler(hosts, 10 * MS)
                           if batched else None), **dev)
        init = ph.build(hosts, capacity=32, msgs_per_host=3, seed=13,
                        **dev)[1]
        if pkg == "jax":
            out[pkg] = jax_leaves(jax.jit(eng.run)(init(), jnp.int64(stop)))
        else:
            out[pkg] = convert.engine_state_to_numpy(eng.run(init(), stop))
    assert_leaves_equal(out["jax"], out["torch"])
    assert out["jax"]["stats.n_net_dropped"].sum() > 0
    assert out["jax"]["stats.n_executed"].sum() > 100


@pytest.mark.parametrize("jit", [1, 750_000, 3_250_000, 50_000_000,
                                 (1 << 31) + 12345, 1 << 40])
def test_jitter_cast_matches_reference(jit):
    """(2u - 1) * jit in f32, cast to i64, for every 24-bit uniform u."""
    u = np.arange(1 << 24, dtype=np.float32) * np.float32(1.0 / (1 << 24))
    want = jax.jit(lambda u, j: ((u * 2.0 - 1.0) * j.astype(jnp.float32)
                                 ).astype(jnp.int64))(
        jnp.asarray(u), jnp.full(u.shape, jit, jnp.int64))
    got = tengine.jitter_offset(torch.from_numpy(u),
                                torch.full(u.shape, jit, dtype=torch.int64))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
