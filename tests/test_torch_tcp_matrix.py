"""The TCP matrix of tests/test_tcp_matrix.py in shadow_tpu_torch against
shadow_tpu, leaf for leaf.

{loopback, lossless, lossy} x {reno, aimd} (CUBIC's cells are in
tests/test_torch_cubic.py; the fidelity features, delayed ACK, receive-
window autotuning, SACK and in-order delivery, in
tests/test_torch_tcp_fidelity.py). The reference side is
tests/test_tcp_matrix.py's `build` itself, its engine run jitted once
for the cells that differ only in the path's reliability; the port side
is the same harness over [H] rows (tests/torch_tcp_harness.py's
`build_stream`).

Every comparison is exact, dtypes included.
"""

import functools

import jax
import jax.numpy as jnp
import pytest

import test_tcp_matrix as jmatrix
from shadow_tpu.core.engine import ConstantNetwork
from shadow_tpu_torch import convert
from shadow_tpu_torch.transport import tcp as ttcp
from test_torch_phold import assert_leaves_equal, jax_leaves
from test_torch_tcp import one_torch_thread  # noqa: F401 (autouse)
from torch_tcp_harness import SECOND, build_stream


@functools.lru_cache(maxsize=None)
def _reference_program(key: tuple):
    """One compiled reference run for every configuration that differs
    from `key` only in the path's reliability: the reliability is the
    program's input, the constant network bound to the engine as the
    reference's fleet binds a lane's network."""
    eng, _ = jmatrix.build(**dict(key))
    latency = eng.network.latency_ns

    def run(st, stop, reliability):
        return eng.bind_lane(
            network=ConstantNetwork(latency, reliability)).run(st, stop)

    return jax.jit(run)


def run_both(stop_s, **kw):
    """(JAX leaves, port leaves) of one configuration, held equal."""
    _, st = jmatrix.build(**kw)
    stop = int(stop_s * SECOND)
    static = tuple(sorted((k, v) for k, v in kw.items()
                          if k != "reliability"))
    lj = jax_leaves(_reference_program(static)(
        st, jnp.int64(stop), jnp.float32(kw.get("reliability", 1.0))))
    teng, tst = build_stream(**kw)
    lt = convert.engine_state_to_numpy(teng.run(tst, stop))
    assert_leaves_equal(lj, lt)
    return lj


@pytest.mark.parametrize("cc", ["reno", "aimd"])
@pytest.mark.parametrize("path", list(jmatrix.PATHS))
def test_matrix_cell_matches_reference(path, cc):
    lj = run_both(60, total=60_000, cc=cc, seed=3, **jmatrix.PATHS[path])
    assert lj["hosts.app.rx"].sum() == 60_000
    retx = lj["hosts.net.tcb.n_retx"].sum()
    assert retx > 0 if path == "lossy" else retx == 0
    client = lj["hosts.net.tcb.state"][0, 1 if path == "loopback" else 0]
    assert client in (ttcp.CLOSED, ttcp.TIME_WAIT)
