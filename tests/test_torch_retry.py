"""`--retry` (`runtime/supervisor.py` `next_retry_argv`, `run_with_retry`,
`cli._strip_retry_flags`) in shadow_tpu_torch against shadow_tpu, on the
CPU.

- `next_retry_argv` and `_strip_retry_flags` give the reference's argv
  on each case;
- `run_with_retry`, driven by injected fakes through the same exit
  scripts (stall 75, peer-lost 77, a signal death, success, a
  non-retryable exit, an exhausted budget), gives the reference's
  report, the recovery times aside, and the same relaunch commands and
  backoff sleeps;
- one real relaunch through `cli.main(... "--retry", ...)`: an injected
  `_popen` runs each child as `cli.main(argv, device="cpu")`; the first
  child dies by SIGKILL right after its first checkpoint, the relaunch
  resumes from it (`--resume auto-if-any`), and the final state equals
  an uninterrupted run's.
"""

import contextlib
import functools
import io
import json
import signal
from pathlib import Path

import pytest

import chip_smoke
from shadow_tpu import cli as jcli
from shadow_tpu.runtime import supervisor as jsup
from shadow_tpu_torch import cli as tcli
from shadow_tpu_torch import examples as texamples
from shadow_tpu_torch.runtime import supervisor as tsup
from test_torch_cli import in_dir, one_thread
from torch_retry_harness import child_popen

PACKAGES = {"jax": jsup, "torch": tsup}

ARGV_CASES = {
    "stall": (["prog", "--mesh", "8"], jsup.EXIT_STALL, False),
    "keep_resume": (["prog", "--resume", "auto"], jsup.EXIT_STALL, False),
    "keep_resume_eq": (["prog", "--resume=auto"], jsup.EXIT_STALL, False),
    "shrink": (["p", "--mesh", "8"], jsup.EXIT_PEER_LOST, True),
    "shrink_eq": (["p", "--mesh=8"], jsup.EXIT_PEER_LOST, True),
    "shrink_floor": (["p", "--mesh", "1"], jsup.EXIT_PEER_LOST, True),
    "serve": (["p", "serve", "--max-lanes", "8"], jsup.EXIT_PEER_LOST, True),
    "signal": (["p"], -9, False),
}


@pytest.mark.parametrize("case", list(ARGV_CASES))
def test_next_retry_argv_matches_reference(case):
    argv, rc, shrink = ARGV_CASES[case]
    got = {pkg: mod.next_retry_argv(list(argv), rc, shrink=shrink)
           for pkg, mod in PACKAGES.items()}
    assert got["torch"] == got["jax"]
    if case == "shrink":
        assert got["torch"] == ["p", "--mesh", "4", "--resume", "auto-if-any"]


def test_strip_retry_flags_matches_reference():
    for argv in (["a.xml", "--retry", "3", "--seed", "2"],
                 ["--retry=2", "a.xml", "--retry-backoff", "0.5"],
                 ["a.xml", "--retry-backoff=1", "--retry", "1", "-s", "3"],
                 ["a.xml"]):
        assert tcli._strip_retry_flags(argv) == \
            jcli._strip_retry_flags(argv)


class _FakeProc:
    """Enough of Popen for run_with_retry: a scripted exit code and a pid
    that cannot exist, so the reaping killpg is a harmless
    ProcessLookupError."""

    def __init__(self, rc):
        self.rc = rc
        self.stderr = None
        self.pid = 2 ** 31 - 1

    def wait(self):
        return self.rc

    def poll(self):
        return self.rc


SCRIPTS = {
    "recover_and_shrink": ([75, 77, -signal.SIGKILL, 0], 5),
    "non_retryable": ([2], 5),
    "exhausted": ([75, 75], 1),
    "signal_then_success": ([128 + signal.SIGTERM, 0], 2),
}


@pytest.mark.parametrize("script", list(SCRIPTS))
def test_run_with_retry_matches_reference(script, capsys):
    rcs, retries = SCRIPTS[script]
    got = {}
    for pkg, mod in PACKAGES.items():
        it, seen, sleeps = iter(rcs), [], []

        def popen(argv, **kw):
            seen.append(list(argv))
            return _FakeProc(next(it))

        report = mod.run_with_retry(["prog", "--mesh", "8"], retries=retries,
                                    backoff_s=0.5, _sleep=sleeps.append,
                                    _popen=popen)
        assert len(report.pop("mttr_s")) == report["recoveries"]
        got[pkg] = (report, seen, sleeps)
    assert got["torch"] == got["jax"]
    report, seen, sleeps = got["torch"]
    assert report["exit_history"] == rcs[:report["attempts"]]
    if script == "recover_and_shrink":
        assert sleeps == [0.5, 1.0, 2.0]
        assert seen[2] == ["prog", "--mesh", "4", "--resume", "auto-if-any"]


CONFIG = texamples.phold_example(16, 3, stoptime=3)
ARGV = ["phold.xml", "--seed", "2", "--heartbeat-frequency", "0.5",
        "--checkpoint-interval", "1", "--checkpoint-path", "r.ckpt.npz"]


def retry_run(workdir: Path, device: str, monkeypatch) -> dict:
    """cli.main with --retry 2 in `workdir`, its children through
    `child_popen(device)`: (exit code, retry report, final digest)."""
    workdir.mkdir(parents=True, exist_ok=True)
    (workdir / "phold.xml").write_text(CONFIG)
    monkeypatch.setattr(tsup, "run_with_retry", functools.partial(
        tsup.run_with_retry, _popen=child_popen(device),
        _sleep=lambda s: None))
    err = io.TextIOWrapper(io.BytesIO(), encoding="utf-8",
                           write_through=True)
    with in_dir(workdir), contextlib.redirect_stderr(err):
        rc = tcli.main(ARGV + ["--retry", "2", "--retry-backoff", "0.01"],
                       device=device)
    text = err.buffer.getvalue().decode()
    line = [ln for ln in text.splitlines()
            if ln.startswith("shadow_tpu_torch: retry report ")][-1]
    report = json.loads(line.split("retry report ", 1)[1])
    return {"rc": rc, "report": report, "err": text,
            "digest": chip_smoke.checkpoint_digest(workdir / "r.ckpt.npz")}


def test_retry_relaunch_resumes_to_the_uninterrupted_state(tmp_path,
                                                           monkeypatch):
    want = tmp_path / "straight"
    want.mkdir()
    (want / "phold.xml").write_text(CONFIG)
    with in_dir(want), one_thread(), contextlib.redirect_stdout(io.StringIO()):
        assert tcli.main(ARGV, device="cpu") == 0
    got = retry_run(tmp_path / "retry", "cpu", monkeypatch)
    assert got["rc"] == 0
    rep = got["report"]
    assert rep["attempts"] == 2 and rep["recoveries"] == 1
    assert rep["exit_history"] == [-signal.SIGKILL, 0]
    assert "--resume auto-if-any" in got["err"]
    assert "resumed from r.ckpt.npz at sim time 1.000s" in got["err"]
    assert got["digest"] == chip_smoke.checkpoint_digest(want / "r.ckpt.npz")
