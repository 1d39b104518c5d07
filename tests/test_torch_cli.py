"""The port's command line (`shadow_tpu_torch.cli.main`) against the
reference's (`shadow_tpu.cli.main`), on the CPU.

One run of each package per scenario, shared through module-scoped
fixtures (the reference compiles its programs once per scenario):

- the main scenario, PHOLD over UDP at 16 hosts with a 12-slot queue
  under `--overflow grow` (spill until the queue overflows at 1-1.5
  sim-s, then a re-template at doubled capacity), with heartbeats every
  0.5 sim-s, `--metrics`, `--stats`, `--trace` and the config's
  `heartbeatloginfo="node,socket,ram"`, checkpoints each sim-second: the
  config digest, the summary line less its wall-clock fields, the
  heartbeat log after `tools/strip_log` byte for byte (node, socket,
  ram, trace, pressure, metrics, stats and supervisor rows) and the
  checkpoints' leaf tables are the reference's;
- `--resume auto` from the 1 s checkpoint generation (a reservoir in its
  extras) ends as the uninterrupted run does, the re-template included,
  and the reference resumes the port's checkpoint to the same summary;
- `--overflow strict` exits 76 with the reference's bundle;
- SIGUSR1 writes a checkpoint and SIGTERM checkpoints and exits 143,
  through `Supervisor`; a short `--watchdog` stall exits 75 with a
  bundle, and the watchdog waves a kernel build through;
- a `--metrics-port 0` scrape during the run passes
  `validate_openmetrics`;
- every flag the port refuses exits 2 naming its ROADMAP item;
- the heartbeat harvest costs exactly one host read per segment.

The bench-shape pin of chip_smoke.py's phase 19 (`PIN_CLI_TGEN`) is
recomputed from the reference's CLI by the slow test at the end.
"""

import contextlib
import io
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from shadow_tpu import cli as jcli
from shadow_tpu import config as jconfig
from shadow_tpu import examples as jexamples
from shadow_tpu_torch import cli as tcli
from shadow_tpu_torch import config as tconfig
from shadow_tpu_torch import examples as texamples
from shadow_tpu_torch import sim as tsim
from shadow_tpu_torch.obs import metrics as tmetrics
from shadow_tpu_torch.runtime.harvest import HeartbeatHarvest
from shadow_tpu_torch.tools.strip_log import strip_line
from shadow_tpu_torch.utils import checkpoint as tckpt
from shadow_tpu_torch.utils.tracker import Tracker
from shadow_tpu_torch.utils.logger import ShadowLogger

ROOT = Path(__file__).resolve().parent.parent

PHOLD = texamples.phold_example(16, 12, stoptime=2).replace(
    '<host id="peer"', '<host id="peer" heartbeatloginfo="node,socket,ram"')
BASE = ["phold.xml", "--seed", "4", "--capacity", "12",
        "--heartbeat-frequency", "0.5", "--metrics", "--stats",
        "--trace", "64", "--trace-out", "trace.npz"]
# the main scenario spills from 1 s and, under --overflow grow,
# re-templates at doubled capacity at the 1.5 s boundary: the 1 s
# checkpoint holds a reservoir, the 2 s one the grown queues
MAIN = BASE + ["--overflow", "grow", "--checkpoint-interval", "1",
               "--checkpoint-keep", "2", "--checkpoint-path",
               "run.ckpt.npz"]
# the summary keys that hold wall-clock time, and the trace file name
WALL = ("wall_seconds", "build_seconds", "events_per_sec",
        "sim_s_per_wall_s")


@contextlib.contextmanager
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@contextlib.contextmanager
def in_dir(path):
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


def run_cli(pkg: str, workdir: Path, argv: list[str]) -> dict:
    """Run one package's `main` in `workdir` with stdout and stderr
    captured: {"rc", "out", "err", "summary", "stripped", "dir"}."""
    workdir.mkdir(parents=True, exist_ok=True)
    (workdir / "phold.xml").write_text(PHOLD)
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


def sim_fields(summary: dict) -> dict:
    """The summary less its wall-clock fields (and the pressure
    controller's harvest wall time)."""
    out = {k: v for k, v in summary.items() if k not in WALL}
    if "pressure" in out:
        out["pressure"] = {k: v for k, v in out["pressure"].items()
                           if k != "harvest_seconds"}
    return out


def leaf_table(path) -> tuple:
    """(paths, shapes, dtypes, crc32, extra crcs) of a checkpoint."""
    with np.load(path) as data:
        h = json.loads(bytes(data["__header__"]).decode())
    return (h["paths"], h["shapes"], h["dtypes"], h["crc32"], h["extra"],
            h["meta"], h.get("mesh"), h["format_version"])


@pytest.fixture(scope="module")
def main_runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("cli")
    return {pkg: run_cli(pkg, base / pkg, MAIN) for pkg in ("jax", "torch")}


def test_config_digest_matches_reference(main_runs):
    """Both packages tie their checkpoints to one digest: the configs'
    reprs agree, faults included, and so do the checkpoint metas."""
    text = jexamples.tor_churn_example(2, 3, 20, churn_frac=0.3)
    for t in (PHOLD, text, jexamples.tgen_example(3, stoptime=5)):
        assert repr(tconfig.parse_config(t)) == repr(jconfig.parse_config(t))
    metas = [leaf_table(main_runs[p]["dir"] / "run.ckpt.npz")[5]
             for p in ("jax", "torch")]
    assert metas[0] == metas[1] and len(metas[0]["config_digest"]) == 16


def test_summary_matches_reference(main_runs):
    j, t = main_runs["jax"], main_runs["torch"]
    assert j["rc"] == t["rc"] == 0
    assert sim_fields(t["summary"]) == sim_fields(j["summary"])
    s = t["summary"]
    assert s["events"] > 0 and s["pressure"]["spilled"] > 0
    assert s["trace"]["records"] > 0 and s["stats"]["wait"]["count"] > 0


def test_heartbeat_log_matches_reference(main_runs):
    """The whole stdout after strip_log, byte for byte."""
    j, t = main_runs["jax"], main_runs["torch"]
    assert t["stripped"] == j["stripped"]
    for section in ("node", "socket", "ram", "trace", "pressure",
                    "metrics", "stats", "supervisor"):
        assert f"[shadow-heartbeat] [{section}] " in t["stripped"], section


def test_checkpoints_match_reference(main_runs):
    """Both generations: the leaf tables (paths, shapes, dtypes, CRC32s),
    the extras (the reservoir) and the header's meta and mesh."""
    for name in ("run.ckpt.npz", "run.ckpt.npz.1"):
        j = leaf_table(main_runs["jax"]["dir"] / name)
        t = leaf_table(main_runs["torch"]["dir"] / name)
        assert t == j
        assert t[6] == {"n_shards": 1, "dcn_slices": 1, "host_order": None}
    # the reservoir rides the extras (a resume from a non-empty one:
    # tests/test_torch_checkpoint.py)
    extras = tckpt.read_extra(str(main_runs["torch"]["dir"]
                                  / "run.ckpt.npz.1"))
    assert "reservoir_time" in extras and extras["n_refilled"].shape == (16,)


@pytest.fixture(scope="module")
def resumed(main_runs, tmp_path_factory):
    """Each package resumes the OTHER's 1 s generation through
    `--resume auto` (the generation copied alone into a fresh dir)."""
    out = {}
    for pkg, src in (("torch", "jax"), ("jax", "torch")):
        d = tmp_path_factory.mktemp(f"resume_{pkg}")
        shutil.copy(main_runs[src]["dir"] / "run.ckpt.npz.1",
                    d / "run.ckpt.npz")
        out[pkg] = run_cli(pkg, d, BASE + [
            "--overflow", "grow", "--checkpoint-path", "run.ckpt.npz",
            "--resume", "auto"])
    return out


def test_resume_auto_equals_uninterrupted(main_runs, resumed):
    want = sim_fields(main_runs["torch"]["summary"])
    for pkg in ("torch", "jax"):
        r = resumed[pkg]
        assert r["rc"] == 0 and "resumed from" in r["err"]
        got = sim_fields(r["summary"])
        # the trace counts only what this process drained
        got.pop("trace"), want.pop("trace", None)
        assert got == want, pkg
    assert resumed["torch"]["stripped"] == resumed["jax"]["stripped"]


def test_overflow_grow_matches_reference(main_runs):
    """The main scenario's re-template: both packages grow at the same
    boundary to capacity 24 (the log equality above holds through it)."""
    j, t = main_runs["jax"], main_runs["torch"]
    for r in (j, t):
        assert r["summary"]["capacity"] == 24
        assert "re-templating at --capacity 24 (sim 1.500s)" in r["err"]
    assert t["summary"]["pressure"]["spilled"] > 0
    assert t["stripped"] == j["stripped"]


def test_overflow_strict_exits_76_with_bundle(tmp_path):
    t = run_cli("torch", tmp_path, BASE[:5] + [
        "--overflow", "strict", "--diag-dir", "diag"])
    assert t["rc"] == 76 and "QUEUE PRESSURE" in t["err"]
    bundle, = (tmp_path / "diag").glob("shadow_tpu_torch.pressure.*.json")
    doc = json.loads(bundle.read_text())
    assert doc["exit_code"] == 76 and doc["capacity"] == 12
    assert doc["would_drop"] > 0 and "flight_recorder" in doc


def test_sigusr1_and_sigterm_through_supervisor(tmp_path, monkeypatch,
                                               main_runs):
    """SIGUSR1 at the first segment writes a checkpoint and the run goes
    on; SIGTERM at the second checkpoints and exits 128 + 15; the
    interrupted run then resumes to the main scenario's summary."""
    calls = []
    fetch = HeartbeatHarvest.fetch

    def signalling_fetch(self, bundle):
        calls.append(1)
        if len(calls) == 1:
            os.kill(os.getpid(), signal.SIGUSR1)
        if len(calls) == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return fetch(self, bundle)

    monkeypatch.setattr(HeartbeatHarvest, "fetch", signalling_fetch)
    argv = BASE + ["--overflow", "grow", "--checkpoint-path",
                   "sig.ckpt.npz", "--checkpoint-keep", "3"]
    t = run_cli("torch", tmp_path, argv)
    assert t["rc"] == 128 + signal.SIGTERM
    assert "checkpoint written on SIGUSR1" in t["err"]
    assert "interrupted by signal 15" in t["err"]
    metas = [tckpt.read_header_info(str(tmp_path / p))["meta"]
             for p in ("sig.ckpt.npz", "sig.ckpt.npz.1")]
    assert metas[0]["interrupted"] == 15 and metas[0]["sim_seconds"] == 1.0
    assert metas[1]["on_demand"] is True and metas[1]["sim_seconds"] == 0.5
    monkeypatch.setattr(HeartbeatHarvest, "fetch", fetch)
    done = run_cli("torch", tmp_path, argv + ["--resume", "auto"])
    assert done["rc"] == 0
    # the main scenario's run is this one uninterrupted, less its trace
    want = sim_fields(main_runs["torch"]["summary"])
    got = sim_fields(done["summary"])
    want.pop("trace"), want.pop("stats"), got.pop("trace"), got.pop("stats")
    assert got == want


STALL = """
import sys, time
sys.path.insert(0, {root!r})
from shadow_tpu_torch import cli, sim

run = sim.Simulation.run
calls = []

def slow_run(self, *a, **k):
    calls.append(1)
    if len(calls) == 2:
        time.sleep(30)
    return run(self, *a, **k)

sim.Simulation.run = slow_run
sys.exit(cli.main(sys.argv[1:], device="cpu"))
"""

GRACE = """
import sys, time, stat
from pathlib import Path
sys.path.insert(0, {root!r})
from shadow_tpu_torch.core import nvcc
from shadow_tpu_torch.runtime.supervisor import Supervisor

tmp = Path(sys.argv[1])
fake = tmp / "nvcc"
fake.write_text("#!/bin/sh\\nsleep 2\\nfor a; do out=$prev; prev=$a; done\\n"
                "touch \\"$out\\"\\n")
fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
nvcc.BUILD_DIR = tmp / "build"
src = tmp / "k.cu"
src.write_text("// a kernel source")
with Supervisor(watchdog_timeout=0.4, diag_dir=str(tmp)) as sup:
    nvcc.build(src, "k", nvcc.BASE_FLAGS)
    sup.pet()
print("built")
"""


def test_watchdog_stall_exits_75_and_waves_a_build_through(tmp_path):
    """A segment that stalls past `--watchdog` ends the process with 75
    and a stall bundle; a first-use kernel build (core/nvcc.py) longer
    than the deadline does not fire it."""
    (tmp_path / "phold.xml").write_text(PHOLD)
    env = dict(os.environ, PATH=f"{tmp_path}:{os.environ['PATH']}")
    proc = subprocess.run(
        [sys.executable, "-c", STALL.format(root=str(ROOT))]
        + BASE[:5] + ["--watchdog", "1.5", "--diag-dir", "diag"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 75, proc.stderr
    assert "STALL" in proc.stderr
    bundle, = (tmp_path / "diag").glob("shadow_tpu_torch.stall.*.json")
    assert json.loads(bundle.read_text())["exit_code"] == 75
    proc = subprocess.run(
        [sys.executable, "-c", GRACE.format(root=str(ROOT)), str(tmp_path)],
        cwd=tmp_path, capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode == 0 and "built" in proc.stdout, proc.stderr
    assert "main thread is compiling" in proc.stderr


def test_metrics_port_scrape_passes_validation(tmp_path, monkeypatch):
    """Scrape /metrics and /healthz from inside the run (at the first two
    heartbeats' consume); the exposition validates and counts events."""
    from shadow_tpu_torch.obs import server as tserver

    ports, scrapes = [], []
    start = tserver.MetricsServer.start
    consume = HeartbeatHarvest.consume

    def capture_start(self):
        ports.append(self.port)
        return start(self)

    def scraping_consume(self, fetched, sim_ns):
        consume(self, fetched, sim_ns)
        if ports and len(scrapes) < 2:
            base = f"http://127.0.0.1:{ports[0]}"
            with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
                body = r.read().decode()
            with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
                health = json.loads(r.read())
            scrapes.append((body, health))

    monkeypatch.setattr(tserver.MetricsServer, "start", capture_start)
    monkeypatch.setattr(HeartbeatHarvest, "consume", scraping_consume)
    t = run_cli("torch", tmp_path, BASE[:5] + [
        "--heartbeat-frequency", "0.5", "--stats", "--metrics-port", "0"])
    assert t["rc"] == 0 and len(scrapes) == 2
    assert f"127.0.0.1:{ports[0]}/metrics" in t["err"]
    for body, health in scrapes:
        assert tmetrics.validate_openmetrics(body) == []
        assert health["status"] in ("ok", "degraded")
    body = scrapes[-1][0]
    assert "shadow_tpu_events_total " in body
    assert 'shadow_tpu_event_wait_ns_bucket{le="+Inf"}' in body


REFUSED = {
    "mesh": ["--test", "--mesh", "2", "--spmd", "constraint"],
    "spmd": ["--test", "--spmd", "constraint"],
    "native_plugin": ["native.xml", "--mesh", "2"],
}
REFUSED_ITEM = {"mesh": "7b", "spmd": "7b", "native_plugin": "9b"}


@pytest.mark.parametrize("name", list(REFUSED))
def test_refused_flags_exit_2(name, tmp_path):
    # capture, --window, --retry and --xprof run (tests/test_torch_pcap*.py,
    # test_torch_window.py, test_torch_retry.py), and so do --mesh,
    # --dcn-slices, --locality and --collective-timeout
    # (tests/test_torch_shard_cli.py), and so do --fleet
    # (tests/test_torch_fleet_cli.py) and `serve`
    # (tests/test_torch_serve.py), and so do .so configs unsharded
    # (tests/test_torch_proc*.py): only --spmd constraint and the process
    # tier on a mesh of more than one shard are refused
    (tmp_path / "native.xml").write_text(PHOLD.replace(
        'path="shadow-plugin-test-phold"', 'path="libphold.so"'))
    (tmp_path / "libphold.so").write_bytes(b"")
    t = run_cli("torch", tmp_path, REFUSED[name])
    assert t["rc"] == 2 and t["summary"] is None
    assert re.search(rf"ROADMAP\.md Queue 1 item {REFUSED_ITEM[name]}\b",
                     t["err"])


def test_no_card_no_fallback_and_build_info(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["--test", "--stoptime", "1"])
    assert tcli.main(["--show-build-info"], device="cpu") == 0
    out = capsys.readouterr().out
    assert f"torch {torch.__version__}" in out and "device cpu" in out


def test_harvest_is_one_read_per_segment(tmp_path):
    """extract + fetch cost one counted read, heartbeat bundles (tracker,
    trace, stats, metrics, pressure) included; the reads of the segment
    itself are the engine's own."""
    cfg = tconfig.parse_config(PHOLD)
    sim = tsim.build_simulation(cfg, seed=4, capacity=12, overflow="spill",
                                trace=64, stats=1, device="cpu")
    from shadow_tpu_torch.obs.trace import TraceDrain

    drain = TraceDrain(64, names=sim.names)
    tracker = Tracker(sim.names, ShadowLogger(stream=io.StringIO()),
                      info_of={n: ("node", "socket", "ram")
                               for n in sim.names},
                      pressure=sim.pressure, trace=drain,
                      metrics=tmetrics.MetricsRegistry())
    harvest = HeartbeatHarvest(sim, tracker=tracker, tdrain=drain,
                               metrics=tracker.metrics)
    st = sim.state0
    with one_thread():
        for k, full in ((1, False), (2, True), (3, True)):
            st = sim.run(k * 500_000_000, state=st)
            syncs = (sim.engine.host_syncs, sim.pressure.host_syncs)
            st, bundle = harvest.extract(st, full=full)
            fetched = harvest.fetch(bundle)
            assert (sim.engine.host_syncs - syncs[0],
                    sim.pressure.host_syncs - syncs[1]) == (1, 0)
            assert ("tracker" in fetched) == full == ("trace" in fetched)
            harvest.consume(fetched, k * 500_000_000)
            assert harvest.summary_from(fetched) == sim.summary(st)
    assert harvest.host_syncs == 3
    assert int(st.trace.wr.sum()) == 0 and drain.n_records > 0
    # with packet capture the heartbeat bundles carry the capture rings
    # in the same one read, and the drain writes what they held
    from shadow_tpu_torch.utils.pcap import CaptureDrain

    cfg = tconfig.parse_config(PHOLD.replace(
        '<host id="peer"', '<host id="peer" logpcap="true"'))
    sim = tsim.build_simulation(cfg, seed=4, capacity=12, overflow="spill",
                                device="cpu")
    caps = CaptureDrain([sim.names[g] for g in sim.pcap_gids],
                        sim.pcap_gids, str(tmp_path), dns=sim.dns)
    harvest = HeartbeatHarvest(sim, pcap=caps)
    st = sim.state0
    with one_thread():
        for k, full in ((1, False), (2, True), (3, True)):
            st = sim.run(k * 500_000_000, state=st)
            syncs = sim.engine.host_syncs
            st, bundle = harvest.extract(st, full=full)
            fetched = harvest.fetch(bundle)
            assert sim.engine.host_syncs - syncs == 1
            assert ("pcap" in fetched) == full
            harvest.consume(fetched, k * 500_000_000)
    caps.close()
    wr = st.hosts.net.cap.wr
    assert caps.last_wr == {g: int(wr[g]) for g in sim.pcap_gids}
    assert caps.stage_counts["sent"] > 0 and caps.lost == 0


# -- the slow pin: chip_smoke.py's phase 19 ---------------------------------
def cli_pin(workdir: Path, argv: list[str], main) -> dict:
    """A phase-19 run's pin fields from one package's main in `workdir`:
    the summary's deterministic fields, the sha256 of the stripped log,
    and the mid-run checkpoint's leaf-table sha256."""
    out = io.StringIO()
    with in_dir(workdir), contextlib.redirect_stdout(out):
        rc = main(argv)
    assert rc == 0
    return chip_smoke.cli_pin_fields(out.getvalue(), workdir)


@pytest.mark.slow
def test_cli_tgen_bench_shape_pin(tmp_path):
    """chip_smoke.PIN_CLI_TGEN from the reference's CLI: TGen 2,048 pairs
    to CLI_STOP_S with a checkpoint in flight, then a resume from it."""
    pins = {}
    for label, extra in (("run", []), ("resumed", ["--resume", "auto"])):
        d = tmp_path / label
        d.mkdir()
        if label == "resumed":
            shutil.copy(tmp_path / "run" / chip_smoke.CLI_MID_CKPT,
                        d / chip_smoke.CLI_CKPT)
        (d / "tgen.xml").write_text(chip_smoke.tgen_config(
            chip_smoke.TGEN_PAIRS))
        pins[label] = cli_pin(d, chip_smoke.CLI_ARGV + extra, jcli.main)
    assert chip_smoke.cli_pin_of(pins) == chip_smoke.PIN_CLI_TGEN
