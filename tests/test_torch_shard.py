"""The port's sharded engine (`parallel.mesh`, `Engine` with
`axis_name`) against the reference's on JAX's 8-device virtual CPU mesh.

Each shard of the port is a rank of a gloo process group on the CPU,
started by `parallel.mesh.spawn` (rank entry points in the JAX-free
`tests/torch_shard_harness.py`); each reference run is `build_sharded`
over the same shard count. The port's global view (`gather_state`) is
compared with the reference's state leaf for leaf, dtypes and the
exchange buffer included:

- PHOLD on the batched and chained drains at S = 2 and 4, with
  cross-shard traffic and several exchange rounds;
- a 2x2 (dcn, hosts) mesh, equal to the 1-D run at S = 4;
- `step_window` at S = 2, window by window;
- rank 0's own shard equals `convert.shard_leaves` of the reference's
  global state, and `scatter_state` inverts `gather_state`;
- the launcher reports a failed rank, refuses NCCL on the CPU, and
  `make_mesh` refuses to run outside a group.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_shard_harness as harness
from shadow_tpu.models import phold as jphold
from shadow_tpu.parallel import mesh as jmesh
from shadow_tpu_torch import convert
from shadow_tpu_torch.core.timebase import SECOND
from shadow_tpu_torch.parallel import mesh as pmesh
from test_torch_phold import assert_leaves_equal, jax_leaves

PER = 8
STOP = 2 * SECOND
KW = dict(seed=3, capacity=32)


@functools.lru_cache(maxsize=None)
def jax_sharded(n_shards: int, batched: bool):
    """The reference's final leaves at n_shards (one compile each)."""
    eng, init = jphold.build(PER, axis_name=jmesh.HOSTS_AXIS,
                             n_shards=n_shards, batched=batched, **KW)
    i, run, _ = jmesh.build_sharded(eng, init, jmesh.make_mesh(n_shards),
                                    PER)
    return jax_leaves(run(i(), jnp.int64(STOP)))


@functools.lru_cache(maxsize=None)
def torch_sharded(n_shards: int, batched: bool, dcn_slices: int = 1):
    return pmesh.spawn(harness.phold_rank, n_shards, backend="gloo",
                       device="cpu", args=(n_shards, PER, STOP,
                                           dict(KW, batched=batched),
                                           dcn_slices),
                       timeout_s=harness.SPAWN_TIMEOUT_S)


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("batched", [True, False],
                         ids=["batched", "chained"])
def test_phold_matches_reference_sharded(n_shards, batched):
    lj = jax_sharded(n_shards, batched)
    lt, syncs, calls, _ = torch_sharded(n_shards, batched)
    assert_leaves_equal(lj, lt)
    assert lt["xchg.bucket.time"].shape[0] == n_shards * n_shards
    assert lt["xchg.sent_min"].shape == (n_shards,)
    # the run crossed shards, in more than one exchange round
    assert lt["stats.n_cross_shard"] > 0 and lt["stats.n_xchg_rounds"] > 1
    assert syncs > 0 and calls > lt["stats.n_windows"]


def test_2x2_mesh_equals_1d():
    lt, *_ = torch_sharded(4, True, dcn_slices=2)
    assert_leaves_equal(jax_sharded(4, True), lt)


def test_step_window_matches_reference():
    n = 2
    eng, init = jphold.build(PER, axis_name=jmesh.HOSTS_AXIS, n_shards=n,
                             **KW)
    i, _, step = jmesh.build_sharded(eng, init, jmesh.make_mesh(n), PER)
    stops = (SECOND, SECOND, 3 * SECOND // 2)
    got = pmesh.spawn(harness.phold_steps_rank, n, backend="gloo",
                      device="cpu", args=(n, PER, stops, KW),
                      timeout_s=harness.SPAWN_TIMEOUT_S)
    st = i()
    for stop, lt in zip(stops, got):
        st = step(st, jnp.int64(stop))
        assert_leaves_equal(jax_leaves(st), lt)
    assert got[-1]["stats.n_windows"] == 3


def test_rank_shard_and_roundtrip():
    lj = jax_sharded(2, True)
    _, _, _, local0 = torch_sharded(2, True)
    mine = convert.shard_leaves(lj, 0, 2)
    assert mine.keys() == local0.keys()
    for k in mine:
        np.testing.assert_array_equal(mine[k], local0[k], err_msg=k)
        assert mine[k].dtype == local0[k].dtype, k
    assert pmesh.spawn(harness.roundtrip_rank, 2, backend="gloo",
                       device="cpu", args=(2, PER, SECOND),
                       timeout_s=harness.SPAWN_TIMEOUT_S)


def test_launcher_and_mesh_refusals():
    with pytest.raises(pmesh.SpawnError) as e:
        pmesh.spawn(harness.failing_rank, 2, backend="gloo", device="cpu",
                    timeout_s=harness.SPAWN_TIMEOUT_S)
    assert e.value.exit_codes == [1, 1]
    with pytest.raises(ValueError, match="NCCL"):
        pmesh.spawn(harness.failing_rank, 1, backend="nccl", device="cpu",
                    timeout_s=harness.SPAWN_TIMEOUT_S)
    with pytest.raises(RuntimeError, match="process group"):
        pmesh.make_mesh(1, device="cpu")
    assert pmesh.select_spmd("auto") == "shard_map"
    assert pmesh.select_spmd("pmap") == "pmap"
    with pytest.raises(ValueError):
        pmesh.select_spmd("bogus")
    assert jax.devices()  # the reference's virtual mesh is up
