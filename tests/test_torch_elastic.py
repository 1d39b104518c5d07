"""Faults across shards and checkpoints across meshes and packages: the
port's sharded runs against the reference's on JAX's virtual CPU mesh.

The scenario is tests/test_faults.py's churn config
(`test_fault_totals_identical_across_shard_counts`: 8 TGen pairs, servers
churning 4-20 s), servers first so every pair crosses shards.

- at S = 4 the port's run (stops at 10, 14 and 18 s, inside the churn)
  equals the reference's leaf for leaf, the exchange buffer and the
  fault counters included;
- the reference's S = 4 checkpoint at 10 s, resumed by the port at
  S = 2, ends as the reference's run does; the port's S = 2 checkpoint at
  14 s, resumed by the reference at S = 4, ends as the reference's run
  does (the leaves outside the exchange buffer, whose shape is the shard
  count's, and the scheduler counters summed over shards), and each
  checkpoint's header names the mesh that wrote it.
"""

import textwrap

import jax
import numpy as np
import pytest

import torch_shard_harness as harness
from shadow_tpu.config import parse_config as jparse
from shadow_tpu.parallel import mesh as jmesh
from shadow_tpu.sim import build_simulation as jbuild
from shadow_tpu.utils import checkpoint as jckpt
from shadow_tpu_torch.core.timebase import SECOND
from shadow_tpu_torch.parallel import mesh as pmesh
from shadow_tpu_torch.utils import checkpoint as tckpt
from test_faults import TOPO
from test_torch_phold import assert_leaves_equal, jax_leaves

_HOSTS = "".join(
    f'<host id="server{i}"><process plugin="tgen" starttime="1" '
    'arguments="server port=8888"/></host>' for i in range(8)) + "".join(
    f'<host id="client{i}"><process plugin="tgen" starttime="2" '
    f'arguments="peers=server{i}:8888 sendsize=2KiB '
    'recvsize=60KiB count=5 pause=1"/></host>' for i in range(8))
CHURN = textwrap.dedent(f"""\
<shadow stoptime="40">
  <topology><![CDATA[{TOPO}]]></topology>
  <plugin id="tgen" path="tgen"/>
  {_HOSTS}
  <fault type="churn" hosts="server*" start="4" end="20"
         period="8" downtime="2" frac="0.5"/>
</shadow>""")
BUILD = dict(seed=13)
MID, LATE, END = 10 * SECOND, 14 * SECOND, 18 * SECOND
# leaves whose shape or count depends on the shard count: the exchange
# buffer, and the scheduler counters summed over shards
MESH_SHAPED = ("xchg.bucket.time", "xchg.bucket.dst", "xchg.bucket.src",
               "xchg.bucket.seq", "xchg.bucket.kind", "xchg.bucket.args",
               "xchg.sent_min", "stats.n_inner_steps",
               "stats.n_xchg_rounds", "stats.n_cross_shard")


def _outside_mesh(leaves: dict) -> dict:
    return {k: v for k, v in leaves.items() if k not in MESH_SHAPED}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One reference build at S = 4 (one compile), run 0 -> 10 -> 14 ->
    18 s with a checkpoint at 10 s; the port at S = 4 over the same
    stops; the port at S = 2 from the reference's 10 s checkpoint to 18 s
    with a checkpoint at 14 s; and the reference from that one to 18 s."""
    tmp = tmp_path_factory.mktemp("elastic")
    sim = jbuild(jparse(CHURN), mesh=jmesh.make_mesh(4), **BUILD)
    mid = sim.run(MID)
    jpath = str(tmp / "jax.ckpt.npz")
    jckpt.save_checkpoint(jpath, mid, meta={"seed": 13}, mesh_info={
        "n_shards": 4, "dcn_slices": 1, "host_order": None})
    end = jax_leaves(sim.run(END, state=sim.run(LATE, state=mid)))
    port4 = pmesh.spawn(harness.resume_rank, 4, backend="gloo",
                        device="cpu",
                        args=(4, CHURN, BUILD, None, (MID, LATE, END)),
                        timeout_s=harness.SPAWN_TIMEOUT_S)
    tpath = str(tmp / "torch.ckpt.npz")
    port2 = pmesh.spawn(harness.resume_rank, 2, backend="gloo",
                        device="cpu",
                        args=(2, CHURN, BUILD, jpath, (LATE, END),
                              (tpath, False), 0),
                        timeout_s=harness.SPAWN_TIMEOUT_S)
    got, _ = jckpt.load_checkpoint(tpath, sim.state0, reshard=True)
    # on state0's shardings, so that the run reuses its compiled program
    got = jax.device_put(got, jax.tree.map(lambda x: x.sharding,
                                           sim.state0))
    return {"end": end, "port4": port4, "port2": port2, "jpath": jpath,
            "tpath": tpath,
            "resumed": jax_leaves(sim.run(END, state=got))}


def test_churn_matches_reference_at_4_shards(runs):
    lt = runs["port4"]
    assert_leaves_equal(runs["end"], lt)
    assert lt["stats.n_fault_dropped"].sum() > 0
    assert lt["stats.n_quarantined"].sum() > 0
    assert lt["stats.n_cross_shard"] > 0


def test_reference_checkpoint_resumes_in_the_port(runs):
    assert tckpt.read_header_info(runs["jpath"])["mesh"]["n_shards"] == 4
    lt = runs["port2"]
    assert_leaves_equal(_outside_mesh(runs["end"]), _outside_mesh(lt))
    assert lt["xchg.bucket.time"].shape[0] == 4


def test_port_checkpoint_resumes_in_the_reference(runs):
    info = tckpt.read_header_info(runs["tpath"])
    assert info["mesh"] == {"n_shards": 2, "dcn_slices": 1,
                            "host_order": None}
    assert info["xchg_empty"] and info["format_version"] == 7
    assert_leaves_equal(_outside_mesh(runs["end"]),
                        _outside_mesh(runs["resumed"]))
    np.testing.assert_array_equal(runs["end"]["xchg.bucket.time"].shape,
                                  runs["resumed"]["xchg.bucket.time"].shape)
