"""`--retry` on a mesh in the port, on the CPU: after a lost peer (a
rank wedged by the chaos injector, `SHADOW_TPU_CHAOS_HANG_S`, under
`--collective-timeout`: exit 77), the relaunch runs at the halved mesh
from the last checkpoint, with the reference's `resharding:` line, to
the uninterrupted `--mesh 2` run's final state outside the mesh-shaped
leaves (and the trace ring, whose scratch columns the shard count
sets).
"""

import contextlib
import functools
import io
import json
import os

import numpy as np

from shadow_tpu_torch.convert import key_of
from shadow_tpu_torch.runtime import supervisor as tsup
from test_torch_cli import PHOLD, in_dir
from test_torch_elastic import MESH_SHAPED
from test_torch_shard_cli import MESH2, port_cli
from torch_retry_harness import child_popen


def _leaves(path) -> dict:
    with np.load(path) as data:
        h = json.loads(bytes(data["__header__"]).decode("utf-8"))
        return {key_of(p): data[f"leaf_{i}"]
                for i, p in enumerate(h["paths"])}


def test_retry_relaunches_at_the_halved_mesh(tmp_path, monkeypatch):
    (tmp_path / "phold.xml").write_text(PHOLD)
    monkeypatch.setenv("SHADOW_TPU_CHAOS_HANG_S", "8")
    # the children and their ranks run one torch thread each
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setattr(tsup, "run_with_retry", functools.partial(
        tsup.run_with_retry, _popen=child_popen("cpu"),
        _sleep=lambda s: None))
    from shadow_tpu_torch import cli as tcli

    err = io.TextIOWrapper(io.BytesIO(), encoding="utf-8",
                           write_through=True)
    with in_dir(tmp_path), contextlib.redirect_stderr(err):
        rc = tcli.main(MESH2 + ["--checkpoint-interval", "0.5",
                                "--collective-timeout", "2", "--retry", "1",
                                "--retry-backoff", "0.01"], device="cpu")
    text = err.buffer.getvalue().decode()
    assert rc == 0, text[-3000:]
    line = [ln for ln in text.splitlines()
            if ln.startswith("shadow_tpu_torch: retry report ")][-1]
    report = json.loads(line.split("retry report ", 1)[1])
    assert report["exit_history"] == [77, 0] and report["recoveries"] == 1
    # one rank took the one-shot marker and wedged (its stderr is rank
    # 0's only when it is rank 0)
    assert os.path.exists(tmp_path / "run.ckpt.npz.chaos")
    assert ("resharding: checkpoint written at 2 shard(s), resuming at 1"
            in text and "at sim time 0.500s" in text)
    want = _leaves(port_cli(tmp_path / "straight", MESH2)["dir"]
                   / "run.ckpt.npz")
    got = _leaves(tmp_path / "run.ckpt.npz")
    for key in want:
        # the trace ring's scratch columns past each host's cursor hold
        # what the last masked appends left, which the shard count sets
        if key not in MESH_SHAPED and not key.startswith("trace."):
            np.testing.assert_array_equal(want[key], got[key], err_msg=key)
    assert got["xchg.sent_min"].shape == (1,)
