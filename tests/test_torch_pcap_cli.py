"""Packet capture and `--xprof` through the command line
(`shadow_tpu_torch.cli.main`) against the reference's, on the CPU.

One run of each package, shared through a module-scoped fixture: PHOLD
over UDP at 16 hosts, every peer capturing into one `pcapdir` (tx and rx
records), heartbeats every 0.5 sim-s (the harvest drains the rings four
times), a checkpoint each sim-second and `--xprof` over 0.5-1 s. The
stripped stdout (the summary's `packet_stages` and `xprof` included),
the pcap files byte for byte and the checkpoints' leaf tables (the
capture rings' leaves among them) are the reference's; each package
resumes the other's 1 s checkpoint to the uninterrupted run's final
state; the port writes a Chrome trace of the span, and a malformed span
exits 2 with the reference's message.

The bench-shape pin of chip_smoke.py's phase 20 (`PIN_CLI_PCAP`) is
recomputed from the reference's CLI by the slow test at the end.
"""

import contextlib
import io
import json
import shutil
from pathlib import Path

import pytest

import chip_smoke
from shadow_tpu import cli as jcli
from shadow_tpu_torch import cli as tcli
from shadow_tpu_torch import examples as texamples
from shadow_tpu_torch.tools.strip_log import strip_line
from test_torch_cli import in_dir, leaf_table, one_thread, sim_fields

CONFIG = texamples.phold_example(16, 2, stoptime=2).replace(
    '<host id="peer"', '<host id="peer" logpcap="true" pcapdir="caps"')
BASE = ["phold.xml", "--seed", "6", "--heartbeat-frequency", "0.5",
        "--checkpoint-interval", "1", "--checkpoint-keep", "2",
        "--checkpoint-path", "run.ckpt.npz"]
MAIN = BASE + ["--xprof", "0.5:1", "--xprof-dir", "xp"]


def run_cli(pkg: str, workdir: Path, argv: list[str],
            config: str = CONFIG) -> dict:
    """One package's `main` in `workdir`, stdout and stderr captured:
    {"rc", "out", "err", "summary", "stripped", "dir"}."""
    workdir.mkdir(parents=True, exist_ok=True)
    (workdir / argv[0]).write_text(config)
    out, err = io.StringIO(), io.StringIO()
    with in_dir(workdir), one_thread(), contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(err):
        if pkg == "jax":
            rc = jcli.main(list(argv))
        else:
            rc = tcli.main(list(argv), device="cpu")
    text = out.getvalue()
    lines = [ln for ln in text.splitlines() if ln.startswith("{")]
    stripped = "".join(
        s + "\n" for s in (strip_line(ln) for ln in text.splitlines())
        if s is not None)
    return {"rc": rc, "out": text, "err": err.getvalue(),
            "summary": json.loads(lines[-1]) if lines else None,
            "stripped": stripped, "dir": workdir}


def pcaps(workdir: Path) -> dict:
    return {p.name: p.read_bytes()
            for p in sorted((workdir / "caps").glob("*.pcap"))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("pcap_cli")
    return {pkg: run_cli(pkg, base / pkg, MAIN) for pkg in ("jax", "torch")}


def test_cli_capture_matches_reference(runs):
    j, t = runs["jax"], runs["torch"]
    assert j["rc"] == t["rc"] == 0
    assert t["stripped"] == j["stripped"]
    assert sim_fields(t["summary"]) == sim_fields(j["summary"])
    stages = t["summary"]["packet_stages"]
    assert stages["sent"] > 0 and stages["delivered"] > 0
    assert "pcap capture: 16 hosts -> caps/" in t["err"]
    got, want = pcaps(t["dir"]), pcaps(j["dir"])
    assert len(got) == 16 and got == want


def test_checkpoints_with_capture_match_reference(runs):
    for name in ("run.ckpt.npz", "run.ckpt.npz.1"):
        j = leaf_table(runs["jax"]["dir"] / name)
        t = leaf_table(runs["torch"]["dir"] / name)
        assert t == j
        assert ".hosts.net.cap.meta" in t[0]


@pytest.fixture(scope="module")
def resumed(runs, tmp_path_factory):
    """Each package resumes the OTHER's 1 s checkpoint."""
    out = {}
    for pkg, src in (("torch", "jax"), ("jax", "torch")):
        d = tmp_path_factory.mktemp(f"pcap_resume_{pkg}")
        shutil.copy(runs[src]["dir"] / "run.ckpt.npz.1", d / "run.ckpt.npz")
        out[pkg] = run_cli(pkg, d, BASE + ["--resume", "auto"])
    return out


def test_capture_checkpoint_resumes_across_packages(runs, resumed):
    want = sim_fields(runs["torch"]["summary"])
    want.pop("xprof")
    digest = chip_smoke.checkpoint_digest(runs["torch"]["dir"]
                                          / "run.ckpt.npz")
    for pkg in ("torch", "jax"):
        r = resumed[pkg]
        assert r["rc"] == 0 and "resumed from" in r["err"]
        got = sim_fields(r["summary"])
        # the capture counts only what this process drained: the whole
        # ring, the records before the checkpoint included
        got.pop("packet_stages"), want.pop("packet_stages", None)
        assert got == want, pkg
        assert chip_smoke.checkpoint_digest(r["dir"] / "run.ckpt.npz") \
            == digest
    assert resumed["torch"]["stripped"] == resumed["jax"]["stripped"]
    assert pcaps(resumed["torch"]["dir"]) == pcaps(resumed["jax"]["dir"])


def test_xprof_writes_a_trace(runs):
    t = runs["torch"]
    assert t["summary"]["xprof"] == {"dir": "xp", "start": 0.5, "stop": 1.0,
                                     "completed": True}
    assert "xprof: capturing device trace from sim 0.500s -> xp" in t["err"]
    assert "xprof: capture stopped at sim 1.000s -> xp" in t["err"]
    doc = json.loads((t["dir"] / "xp" / "trace.json").read_text())
    assert any(e.get("ph") == "X" for e in doc["traceEvents"])


@pytest.mark.parametrize("span", ["2", "x:1", "3:1", "-1:2"])
def test_malformed_xprof_exits_2(span, tmp_path):
    got = {pkg: run_cli(pkg, tmp_path / pkg,
                        ["phold.xml", f"--xprof={span}"])
           for pkg in ("jax", "torch")}
    assert got["torch"]["rc"] == got["jax"]["rc"] == 2
    assert got["torch"]["err"] == got["jax"]["err"]
    assert "--xprof" in got["torch"]["err"]


# -- the slow pin: chip_smoke.py's phase 20 ---------------------------------
@pytest.mark.slow
def test_cli_pcap_bench_shape_pin(tmp_path):
    """chip_smoke.PIN_CLI_PCAP from the reference's CLI: TGen 2,048 pairs
    with every host capturing, --window auto, --xprof and a checkpoint at
    the stop."""
    (tmp_path / "tgen.xml").write_text(
        chip_smoke.pcap_config(chip_smoke.TGEN_PAIRS))
    out, err = io.StringIO(), io.StringIO()
    with in_dir(tmp_path), contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(err):
        rc = jcli.main(chip_smoke.PCAP_ARGV)
    assert rc == 0
    got = chip_smoke.pcap_pin_fields(out.getvalue(), err.getvalue(),
                                     tmp_path)
    assert json.loads(json.dumps(got)) == chip_smoke.PIN_CLI_PCAP
