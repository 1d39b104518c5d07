"""shadow_tpu_torch on a CUDA card: the kernel against its plain version.

Every test here needs a CUDA device and skips without one. The file
imports no JAX, so it runs where JAX is not installed; from the
repository root, on the card's machine:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(`--noconftest` skips tests/conftest.py, which configures JAX.)
"""

import numpy as np
import pytest
import torch

import chip_smoke
from shadow_tpu_torch import convert
from shadow_tpu_torch.core import merge
from shadow_tpu_torch.models import phold

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.parametrize("h,hc,w,nw,regime", chip_smoke.SWEEP)
def test_kernel_matches_plain(h, hc, w, nw, regime):
    _need_card()
    rng = np.random.default_rng(h + hc + w + nw)
    args = [torch.from_numpy(a).cuda()
            for a in chip_smoke.merge_inputs(rng, h, hc, w, nw, regime)]
    before = merge.launches
    got = merge.fused_merge(*args)
    want = merge.merge_body(*args)
    torch.cuda.synchronize()
    assert merge.launches == before + 1
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("kw", [
    dict(msgs_per_host=4, seed=3),
    dict(msgs_per_host=16, seed=9, hot_hosts=1, hot_weight=0.9),
], ids=["uniform", "fallback-round"])
def test_phold_on_cuda_matches_cpu(kw):
    """The whole slice on the card equals the CPU run (which the CPU
    tests hold against the JAX reference), through the kernel."""
    _need_card()
    states = {}
    for dev in ("cuda", "cpu"):
        eng, init = phold.build(32, device=dev, **kw)
        before = merge.launches
        st = eng.run(init(), 2 * chip_smoke.SECOND)
        states[dev] = convert.engine_state_to_numpy(st)
        if dev == "cuda":
            assert merge.launches > before
    assert states["cuda"].keys() == states["cpu"].keys()
    for key, a in states["cpu"].items():
        np.testing.assert_array_equal(states["cuda"][key], a, err_msg=key)
