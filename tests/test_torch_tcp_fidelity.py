"""The fidelity features of tests/test_tcp_matrix.py in shadow_tpu_torch
against shadow_tpu, leaf for leaf: delayed ACK against none, receive-
window autotuning on a high-BDP path, SACK under loss, and in-order
delivery under loss, through tests/test_torch_tcp_matrix.py's `run_both`
(the matrix cells are there; the two files run on separate test
workers).

Every comparison is exact, dtypes included.
"""

import pytest

from shadow_tpu_torch.transport import tcp as ttcp
from test_torch_tcp import one_torch_thread  # noqa: F401 (autouse)
from test_torch_tcp_matrix import run_both
from torch_tcp_harness import MS, SECOND


@pytest.mark.parametrize("delack", [True, False])
def test_delack_matches_reference(delack):
    lj = run_both(30, total=200_000, delack=delack, seed=5)
    assert lj["hosts.app.rx"][1] == 200_000
    # the receiver sends only ACKs: with delack about half as many
    assert lj["hosts.net.nic_tx.pkts"][1] < (90 if delack else 200)


AUTOTUNE = dict(bw=8192.0, latency=50 * MS, seed=9)


def test_autotune_matches_reference():
    """A high-BDP path (8 MiB/s, 50 ms each way): half a second in, the
    receiver advertises more than the initial RCV_WND segments."""
    lj = run_both(0.5, total=600_000, **AUTOTUNE)
    assert lj["hosts.net.tcb.rwnd"].max() > ttcp.RCV_WND
    assert 0 < lj["hosts.app.rx"][1] < 600_000


@pytest.mark.slow
def test_autotune_transfer_completes():
    """3 MB over the autotuned window: done within 1.5 s, where a static
    64-segment window (~0.9 MB/s at a 100 ms RTT) would need 3 s."""
    lj = run_both(3, total=3_000_000, **AUTOTUNE)
    assert lj["hosts.app.rx"][1] == 3_000_000
    assert lj["hosts.app.last_rx"][1] < 1.5 * SECOND


def test_sack_matches_reference():
    lj = run_both(60, total=120_000, reliability=0.85, seed=5)
    assert lj["hosts.app.rx"].sum() == 120_000
    n_segs = -(-120_000 // ttcp.MSS)
    assert 0 < lj["hosts.net.tcb.n_retx"].sum() < n_segs


@pytest.mark.slow  # config-driven runs (tests/test_torch_tgen.py) are in order
@pytest.mark.parametrize("in_order", [False, True])
def test_lossy_in_order_matches_reference(in_order):
    lj = run_both(120, total=80_000, reliability=0.8, in_order=in_order,
                  seed=21)
    assert lj["hosts.app.rx"][1] == 80_000
