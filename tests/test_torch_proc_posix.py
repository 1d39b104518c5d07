"""The command line's `.so` path (`python -m shadow_tpu_torch` on a config
of native plugins) against the reference's CLI, on the CPU.

The config is chip_smoke.py phase 24's cut: one shim_echo pair and one
unmodified POSIX `plain_tcp` pair in the epoll io mode, built by the
port's builder (the interposer is the shared `native/interpose/`). The
port's `main` runs as a subprocess, its stdout (the plugins' own output,
the `[sim s] [pid N] msg` log lines and the summary) held byte for byte,
less `wall_seconds`, to the reference CLI's: `PIN_PROC["cli_stdout"]`,
which `test_torch_proc.py::test_phase24_pins` takes from the reference
CLI itself. The refusals run both packages' `main` in process and hold
the exit code and stderr equal. The POSIX plugins' tier scenarios are
in test_torch_proc.py, where they share a reference run.
"""

import contextlib
import io
import json
import os
import shutil

import pytest

import chip_smoke
from test_torch_phold import one_torch_thread  # noqa: F401
from test_torch_proc import build_plugins, config, host, run_cli_process

pytestmark = pytest.mark.skipif(shutil.which("gcc") is None,
                                reason="no C toolchain")

METRICS_NOTE = (b"note: --metrics/--metrics-port/--xprof are device-tier "
                b"flags (they ride the heartbeat harvest); the process tier "
                b"ignores them")


@pytest.fixture(scope="module")
def plugins():
    return chip_smoke.proc_plugins()


def cli_config(plugins, workdir) -> str:
    """Phase 24's cut, written into `workdir`."""
    path = os.path.join(workdir, "proc.xml")
    with open(path, "w") as f:
        f.write(chip_smoke.proc_config(plugins, cut=True))
    return path


@pytest.fixture(scope="module")
def cli_run(plugins, tmp_path_factory):
    """The port's command line on the cut with the phase's seed and
    `--metrics`, a device-tier flag the process tier notes and
    ignores."""
    tmp = tmp_path_factory.mktemp("cli")
    argv = [cli_config(plugins, str(tmp)), "--seed",
            str(chip_smoke.PROC_SEED), "--metrics"]
    return run_cli_process("torch", argv, tmp)


def test_cli_stdout_matches_reference_cli(cli_run):
    t = cli_run
    assert t.returncode == 0, t.stderr[-2000:]
    out = chip_smoke.without_wall_seconds(t.stdout.decode())
    assert out == chip_smoke.PIN_PROC["cli_stdout"]
    summary = json.loads(out.splitlines()[-1])
    assert summary["exit_codes"] == {str(p): 0 for p in range(4)}
    assert summary["rx_bytes"] >= 4 * 20_000 and summary["queue_drops"] == 0
    assert b"PLAIN_TCP_OK 20000" in t.stdout
    assert b"[pid 1] client verified 20000 bytes" in t.stdout


def test_cli_metrics_note(cli_run, plugins, tmp_path):
    assert METRICS_NOTE in cli_run.stderr
    assert b"metrics: serving" not in cli_run.stderr
    # the reference prints the same note, before its build
    cfg = cli_config(plugins, str(tmp_path))
    j = in_process("jax", [cfg, "--metrics", "--checkpoint-interval", "1"],
                   tmp_path)
    assert j[0] == 2 and METRICS_NOTE.decode() in j[2]


def in_process(pkg: str, argv: list, cwd) -> tuple[int, str, str]:
    from shadow_tpu import cli as jcli
    from shadow_tpu_torch import cli as tcli

    out, err = io.StringIO(), io.StringIO()
    old = os.getcwd()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = (jcli.main(list(argv)) if pkg == "jax"
                  else tcli.main(list(argv), device="cpu"))
    finally:
        os.chdir(old)
    return rc, out.getvalue(), err.getvalue()


REFUSALS = {
    "mixed": [],
    "resume": ["--resume", "x.ckpt.npz"],
    "checkpoint_interval": ["--checkpoint-interval", "5"],
    "metrics_and_resume": ["--metrics", "--resume", "x.ckpt.npz"],
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_cli_refusals_match_reference(plugins, tmp_path, case):
    cfg = cli_config(plugins, str(tmp_path))
    if case == "mixed":
        text = open(cfg).read().replace(
            '</shadow>',
            '<plugin id="tgen" path="tgen"/>'
            '<host id="x"><process plugin="tgen" starttime="1" '
            'arguments="server port=80"/></host></shadow>')
        with open(cfg, "w") as f:
            f.write(text)
    argv = [cfg] + REFUSALS[case]
    j = in_process("jax", argv, tmp_path)
    t = in_process("torch", argv, tmp_path)
    assert t[0] == j[0] == 2
    assert t[1] == j[1] == ""
    assert t[2] == j[2] and "error: " in t[2]


@pytest.mark.slow
def test_cli_watchdog_ends_a_spinning_plugin(tmp_path):
    """A plugin spinning in shim_main blocks the pump; the watchdog ends
    the run with the stall exit code 75 and leaves its bundle (the
    reference's `test_watchdog_detects_hung_plugin`)."""
    spin = build_plugins(str(tmp_path), ["spin"])
    cfg = tmp_path / "spin.xml"
    cfg.write_text(config(spin, [host("h0", "spin", "")], 30))
    diag = tmp_path / "diag"
    p = run_cli_process("torch", [str(cfg), "--watchdog", "20",
                                    "--diag-dir", str(diag)], tmp_path)
    assert p.returncode == 75, (p.stdout[-2000:], p.stderr[-2000:])
    bundles = list(diag.glob("*.stall.*.json"))
    assert bundles and list(diag.glob("*.stall.*.stacks.txt"))
    bundle = json.loads(bundles[0].read_text())
    assert bundle["exit_code"] == 75
    assert bundle["tier"] == "process" and bundle["live_pids"] == [0]
    assert b"STALL" in p.stderr
