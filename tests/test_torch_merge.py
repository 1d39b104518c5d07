"""The port's fused merge against shadow_tpu's, bit for bit.

`shadow_tpu_torch.core.merge.merge_body` (the plain version, which the
wrapper runs for CPU tensors) is held against the reference's
`merge_body` and against its Pallas kernel `fused_merge` in interpret
mode, on the same numpy-seeded inputs: exact equality. The CUDA kernel
itself is held against the plain version by tests/test_torch_cuda.py,
which needs a card, and by chip_smoke.py; its launch plan, which is
Python, is checked here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from shadow_tpu.core import merge_pallas as jmerge
from shadow_tpu_torch.core import merge as tmerge

SHAPES = [(hc, w, nw) for nw in (1, 6) for hc in (64, 128) for w in (24, 64)]
REGIMES = ["cleared", "overflow", "ties", "unsorted"]


def _run_both(args, fn_jax):
    j = jax.device_get(fn_jax(*(jnp.asarray(a) for a in args)))
    t = tmerge.fused_merge(*(torch.from_numpy(a) for a in args))
    for a, b in zip(j, t):
        assert np.asarray(a).dtype == b.numpy().dtype
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("hc,w,nw", SHAPES)
def test_merge_body_matches_reference(hc, w, nw):
    rng = np.random.default_rng(hc * 1000 + w * 10 + nw)
    for regime in REGIMES:
        args = chip_smoke.merge_inputs(rng, 8, hc, w, nw, regime)
        _run_both(args, jmerge.merge_body)


@pytest.mark.parametrize("hc,w,nw", SHAPES)
def test_merge_body_matches_pallas_interpret(hc, w, nw):
    rng = np.random.default_rng(hc * 1000 + w * 10 + nw + 1)
    for regime in ("cleared", "unsorted"):
        args = chip_smoke.merge_inputs(rng, 4, hc, w, nw, regime)
        _run_both(args, jmerge.fused_merge)


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.default_rng(3)
    args = [torch.from_numpy(a)
            for a in chip_smoke.merge_inputs(rng, 4, 64, 24, 1, "cleared")]
    before = tmerge.launches
    got = tmerge.fused_merge(*args)
    want = tmerge.merge_body(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert tmerge.launches == before


def test_wrapper_rejects_other_devices():
    rng = np.random.default_rng(4)
    args = [torch.from_numpy(a).to("meta")
            for a in chip_smoke.merge_inputs(rng, 2, 64, 24, 1, "sparse")]
    with pytest.raises(ValueError, match="cuda or cpu"):
        tmerge.fused_merge(*args)


def test_bound_counts_only_the_bytes_the_merge_needs():
    """chip_smoke's byte count for the bound skips the flat keys past
    each row's admitted run and the residents behind a cleared prefix."""
    mx = chip_smoke.I64MAX
    qt = torch.tensor([[mx, mx, 5, 6], [1, 2, 3, 4]])
    args = (qt, torch.zeros(2, 4, dtype=torch.int64),
            torch.zeros(2, 4, 1, dtype=torch.int64),
            torch.arange(10), torch.arange(10),
            torch.zeros(2, 3, 1, dtype=torch.int64),
            torch.tensor([0, 1], dtype=torch.int32),
            torch.tensor([1, 5], dtype=torch.int32))
    outs = tmerge.merge_body(*args)
    # qt 64 + bpay 48 + starts 8 + cnt 8 + outputs 3 * 112,
    # st/sss: 1 + 3 admitted entries, qss/qpay: 2 + 4 resident slots
    assert chip_smoke.merge_bytes(args, outs) == 64 + 48 + 16 + 336 + 64 + 96


PLAN_SHAPES = sorted({(h, hc, w) for h, hc, w, _, _ in
                      chip_smoke.SWEEP + chip_smoke.TIMING
                      + chip_smoke.RAGGED})


@pytest.mark.parametrize("warps_per_block", [1, 2, 4, 8])
@pytest.mark.parametrize("h,hc,w", PLAN_SHAPES)
def test_launch_plan_covers_every_row_once(h, hc, w, warps_per_block):
    plan = tmerge.launch_plan(h, hc, w, warps_per_block=warps_per_block)
    rows = [b * plan.warps_per_block + r for b in range(plan.blocks)
            for r in range(plan.warps_per_block)]
    assert sorted(x for x in rows if x < h) == list(range(h))
    # no block is without rows, no warp takes two
    assert (plan.blocks - 1) * plan.warps_per_block < h
    assert len(rows) == len(set(rows))
    assert plan.warps_per_block <= warps_per_block
    assert plan.smem_bytes == (plan.warps_per_block
                               * tmerge.row_smem_bytes(hc, w))
    assert plan.smem_bytes <= 232_448
    assert plan.smem_bytes % 16 == 0


def test_launch_plan_shrinks_to_fit_and_raises_past_the_limit():
    # 576 x 576 rows take 25,344 B each: eight still fit in one block
    assert tmerge.row_smem_bytes(576, 576) == 25_344
    assert tmerge.launch_plan(4096, 576, 576).warps_per_block == 8
    # 2048 x 2048 rows (90,112 B) fit two to a block, 5000 x 5000 one
    assert tmerge.launch_plan(4096, 2048, 2048).warps_per_block == 2
    assert tmerge.launch_plan(4096, 5000, 5000).warps_per_block == 1
    # fewer rows than a block holds: one block of h warps
    assert tmerge.launch_plan(3, 64, 24) == tmerge.LaunchPlan(
        warps_per_block=3, smem_bytes=3 * tmerge.row_smem_bytes(64, 24),
        blocks=1)
    with pytest.raises(ValueError, match="shared memory"):
        tmerge.launch_plan(4096, 6000, 6000)
