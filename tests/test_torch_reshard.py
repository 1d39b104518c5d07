"""Elastic restore in the port: checkpoints written at one shard count
resume at another, bit for bit outside the mesh-shaped leaves (the
exchange buffer, whose shape is the shard count's, and the scheduler
counters summed over shards), on PHOLD over UDP at 16 hosts.

- 4 -> 2 -> 1: a global checkpoint at S = 4, resumed at S = 2, which
  writes a shard set, resumed unsharded from the set;
- 1 -> 4: an unsharded checkpoint resumed at S = 4;
- both end as the uninterrupted S = 4 run with the same stops does;
- a checkpoint holding events in flight in the exchange buffer resumes
  at its own shard count and is refused at another, as the reference
  refuses it;
- a shard set is resumed whole or not at all;
- a mesh of two refuses spill and grow modes, `spmd="constraint"`,
  `spmd="pmap"` on a (dcn, hosts) mesh and per-window widths on the
  pmap path, as the reference does.
"""

import os

import pytest

import torch_shard_harness as harness
from shadow_tpu_torch import config as tconfig
from shadow_tpu_torch import examples as texamples
from shadow_tpu_torch import sim as tsim
from shadow_tpu_torch.core.timebase import SECOND
from shadow_tpu_torch.parallel import mesh as pmesh
from shadow_tpu_torch.utils import checkpoint as tckpt
from test_torch_elastic import _outside_mesh
from test_torch_phold import assert_leaves_equal

CFG = texamples.phold_example(16, 4, stoptime=3)
BUILD = dict(seed=4)
T1, T2, T3 = SECOND, 2 * SECOND, 3 * SECOND


def run(n, ckpt, stops, save=None, save_at=-1):
    """`resume_rank` in a group of n ranks, or in this process (n = 0:
    unsharded)."""
    args = (n, CFG, BUILD, ckpt, stops, save, save_at)
    if n == 0:
        return harness.resume_rank(*args)
    return pmesh.spawn(harness.resume_rank, n, backend="gloo",
                       device="cpu", args=args,
                       timeout_s=harness.SPAWN_TIMEOUT_S)


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("reshard")
    p4, p2, p1 = (str(tmp / f"s{n}.ckpt.npz") for n in (4, 2, 1))
    want = run(4, None, (T1, T2, T3), (p4, False), 0)
    via2 = run(2, p4, (T2,), (p2, True))
    set2 = [tckpt.shard_member_path(p2, i, 2) for i in range(2)]
    down = run(0, set2, (T3,))
    run(0, None, (T1,), (p1, False))
    up = run(4, p1, (T2, T3))
    return dict(want=want, via2=via2, down=down, up=up, p2=p2, p4=p4,
                set2=set2, tmp=tmp)


def test_reshard_4_to_2_to_1(chain):
    assert "xchg.sent_min" not in chain["down"]
    assert_leaves_equal(_outside_mesh(chain["want"]),
                        _outside_mesh(chain["down"]))
    assert chain["want"]["stats.n_cross_shard"] > 0
    assert tckpt.read_header_info(chain["p4"])["mesh"]["n_shards"] == 4
    assert tckpt.read_header_info(chain["set2"][1])["shard"] == [1, 2]


def test_reshard_1_to_4(chain):
    assert_leaves_equal(_outside_mesh(chain["want"]),
                        _outside_mesh(chain["up"]))
    assert chain["up"]["xchg.bucket.time"].shape == \
        chain["want"]["xchg.bucket.time"].shape


def test_shard_set_all_or_none(chain, tmp_path):
    base = str(tmp_path / "set.ckpt.npz")
    for src in chain["set2"]:
        dst = base + src[len(chain["p2"]):]
        with open(src, "rb") as f, open(dst, "wb") as g:
            g.write(f.read())
    chosen, meta, skipped = tckpt.find_resume_checkpoint(base)
    assert chosen == [tckpt.shard_member_path(base, i, 2) for i in (0, 1)]
    assert not skipped
    os.remove(tckpt.shard_member_path(base, 1, 2))
    with pytest.raises(ValueError, match="incomplete shard set: 1 of 2"):
        tckpt.find_resume_checkpoint(base)
    sim1 = tsim.build_simulation(tconfig.parse_config(CFG), device="cpu",
                                 **BUILD)
    with pytest.raises(ValueError, match="belongs to a set of 2, got 3"):
        tckpt.load_shard_set(chain["set2"][:1] * 3, sim1.state0)


def test_inflight_exchange_refused_at_another_mesh(tmp_path):
    path = str(tmp_path / "inflight.ckpt.npz")
    n = pmesh.spawn(harness.inflight_rank, 2, backend="gloo", device="cpu",
                    args=(CFG, BUILD, path),
                    timeout_s=harness.SPAWN_TIMEOUT_S)
    assert n >= 1 and not tckpt.read_header_info(path)["xchg_empty"]
    sim1 = tsim.build_simulation(tconfig.parse_config(CFG), device="cpu",
                                 **BUILD)
    with pytest.raises(ValueError, match="in-flight cross-shard events"):
        tckpt.load_checkpoint(path, sim1.state0, reshard=True)
    # at its own shard count it resumes: the buffer lands in the queues
    got = run(2, path, (T3,))
    assert got["stats.n_executed"].sum() > 0


def test_mesh_refusals():
    msgs = pmesh.spawn(harness.refusals_rank, 2, backend="gloo",
                       device="cpu", args=(CFG,),
                       timeout_s=harness.SPAWN_TIMEOUT_S)
    assert len(msgs) == 6
    assert "--overflow spill is not supported on sharded meshes" in msgs[0]
    assert "--overflow grow" in msgs[1]
    assert "item 7b" in msgs[2]
    assert "pmap fallback is single-axis only" in msgs[3]
    assert all("pmap fallback runs fixed windows" in m for m in msgs[4:])
