"""The TCP matrix of tests/test_tcp_matrix.py in shadow_tpu_torch against
shadow_tpu, leaf for leaf.

{loopback, lossless, lossy} x {reno, aimd} (CUBIC's cells are in
tests/test_torch_cubic.py; the fidelity features, delayed ACK, receive-
window autotuning, SACK and in-order delivery, in
tests/test_torch_tcp_fidelity.py). The reference side is
tests/test_tcp_matrix.py's `build` itself; the port side is the same
harness over [H] rows (tests/torch_tcp_harness.py's `build_stream`).

Every comparison is exact, dtypes included.
"""

import jax
import jax.numpy as jnp
import pytest

import test_tcp_matrix as jmatrix
from shadow_tpu_torch import convert
from shadow_tpu_torch.transport import tcp as ttcp
from test_torch_phold import assert_leaves_equal, jax_leaves
from test_torch_tcp import one_torch_thread  # noqa: F401 (autouse)
from torch_tcp_harness import SECOND, build_stream


def run_both(stop_s, **kw):
    """(JAX leaves, port leaves) of one configuration, held equal."""
    eng, st = jmatrix.build(**kw)
    stop = int(stop_s * SECOND)
    lj = jax_leaves(jax.jit(eng.run)(st, jnp.int64(stop)))
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
