"""The port's host partitioning (`parallel.partition`) and its sharded
TGen over TCP against the reference, on the CPU.

- `traffic_edges_from_config`, `locality_order` (with `dcn_slices`) and
  `apply_order` give the reference's outputs on the same inputs;
- TGen over TCP on the frontier drain at S = 4 (tests/test_partition.py's
  pair config: servers first, so every pair crosses shards) equals the
  reference's sharded run leaf for leaf, the exchange buffer included;
- `locality=True` applies the reference's order (`Simulation.host_order`),
  cuts the cross-shard packets by more than half and leaves every host's
  results, matched by name, as they were.
"""

import functools
import random

import numpy as np
import pytest

import torch_shard_harness as harness
from shadow_tpu.config import expand_hosts as jexpand
from shadow_tpu.config import parse_config as jparse
from shadow_tpu.parallel import mesh as jmesh
from shadow_tpu.parallel import partition as jpart
from shadow_tpu.sim import build_simulation as jbuild
from shadow_tpu_torch.config import expand_hosts as texpand
from shadow_tpu_torch.config import parse_config as tparse
from shadow_tpu_torch.parallel import mesh as pmesh
from shadow_tpu_torch.parallel import partition as tpart
from test_partition import pair_config
from test_torch_phold import assert_leaves_equal, jax_leaves

CFG = pair_config(8)  # 16 hosts: server0..7, then client0..7
BUILD = dict(seed=5, frontier=8)


def _edges(rng, n, k):
    return [(a, b, w) for a, b, w in
            ((rng.randrange(n), rng.randrange(n), rng.randrange(1, 5))
             for _ in range(k)) if a != b]


@pytest.mark.parametrize("n,n_shards,dcn,k", [
    (16, 4, 1, 8), (16, 4, 2, 12), (12, 4, 2, 6), (32, 8, 1, 40),
    (32, 8, 4, 40), (24, 3, 1, 30), (64, 16, 2, 90), (8, 2, 1, 0),
])
def test_locality_order_matches_reference(n, n_shards, dcn, k):
    rng = random.Random(n * 1000 + n_shards * 10 + dcn)
    edges = _edges(rng, n, k)
    want = jpart.locality_order(n, edges, n_shards, dcn_slices=dcn)
    assert tpart.locality_order(n, edges, n_shards, dcn_slices=dcn) == want


def test_edges_and_apply_order_match_reference():
    jh, th = jexpand(jparse(CFG)), texpand(tparse(CFG))
    edges = tpart.traffic_edges_from_config(th)
    assert edges == jpart.traffic_edges_from_config(jh) and len(edges) == 8
    perm = tpart.locality_order(16, edges, 4)
    assert [(h.name, h.gid) for h in tpart.apply_order(th, perm)] == [
        (h.name, h.gid) for h in jpart.apply_order(jh, perm)]
    with pytest.raises(ValueError, match="divisible"):
        tpart.locality_order(10, edges, 4)


@functools.lru_cache(maxsize=None)
def torch_run(locality: bool):
    return pmesh.spawn(harness.sim_rank, 4, backend="gloo", device="cpu",
                       args=(4, CFG, dict(BUILD, locality=locality)),
                       timeout_s=harness.SPAWN_TIMEOUT_S)


def test_tgen_frontier_matches_reference_at_4_shards():
    sim = jbuild(jparse(CFG), mesh=jmesh.make_mesh(4), **BUILD)
    lj = jax_leaves(sim.run())
    lt, names, order, _ = torch_run(False)
    assert_leaves_equal(lj, lt)
    assert names == list(sim.names) and order is None
    assert lt["stats.n_cross_shard"] > 0
    assert lt["hosts.app.streams_done"].sum() > 0


def test_locality_cuts_cross_shard_packets():
    naive, names0, _, _ = torch_run(False)
    local, names1, order, _ = torch_run(True)
    edges = jpart.traffic_edges_from_config(jexpand(jparse(CFG)))
    assert list(order) == jpart.locality_order(16, edges, 4)
    assert names1 == [names0[g] for g in order]
    assert local["stats.n_cross_shard"] * 2 < naive["stats.n_cross_shard"]
    # the same run, host by host (matched by name)
    for key in ("stats.n_executed", "hosts.app.streams_done",
                "hosts.net.sockets.rx_bytes", "hosts.net.sockets.tx_bytes"):
        a = dict(zip(names0, naive[key][:16].tolist()))
        b = dict(zip(names1, local[key][:16].tolist()))
        assert a == b, key
    np.testing.assert_array_equal(naive["stats.n_by_kind"].sum(0),
                                  local["stats.n_by_kind"].sum(0))
