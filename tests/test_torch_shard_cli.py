"""The port's sharded command line (`--mesh`, `--collective-timeout`,
`--retry` on a mesh) against the reference's, on the CPU.

- `python -m shadow_tpu_torch --mesh 2` (here `cli.main` in a
  subprocess, on the CPU: two gloo ranks) prints the reference CLI's
  `--mesh 2` summary line (less its wall-clock fields), heartbeat log
  after `tools/strip_log` (node, socket, ram, trace, metrics and stats
  rows) and checkpoint leaf tables, mesh header included;
- its checkpoint resumes unsharded, with the reference's `resharding:`
  line, to the uninterrupted run's totals;
- a rank killed mid-run leaves the other one to exit 77 under
  `--collective-timeout` with a bundle naming every shard
  (`--retry` on a mesh: tests/test_torch_shard_retry.py).
"""

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import torch_shard_harness as harness
from shadow_tpu_torch.parallel import mesh as pmesh
from shadow_tpu_torch.tools.strip_log import strip_line
from test_torch_cli import BASE, PHOLD, in_dir, leaf_table, run_cli, \
    sim_fields

ROOT = Path(__file__).resolve().parent.parent
ARGV = ([a if a != "12" else "64" for a in BASE]
        + ["--checkpoint-interval", "1", "--checkpoint-keep", "2",
           "--checkpoint-path", "run.ckpt.npz"])
MESH2 = ARGV + ["--mesh", "2"]
CHILD = ("import sys, torch; sys.path.insert(0, {root!r}); "
         "torch.set_num_threads(1); from shadow_tpu_torch import cli; "
         "sys.exit(cli.main(sys.argv[1:], device='cpu'))")


def port_cli(workdir: Path, argv: list, env=None) -> dict:
    """The port's `cli.main(argv, device="cpu")` in a subprocess (its
    ranks print to the process's own stdout). The subprocess and the
    ranks it spawns run one torch thread each (OMP_NUM_THREADS), beside
    the other test workers."""
    workdir.mkdir(parents=True, exist_ok=True)
    (workdir / "phold.xml").write_text(PHOLD)
    env = dict(os.environ if env is None else env, OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, "-c", CHILD.format(root=str(ROOT))]
                       + argv, cwd=workdir, capture_output=True, text=True,
                       env=env, timeout=300)
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
    return {"rc": p.returncode, "out": p.stdout, "err": p.stderr,
            "summary": json.loads(lines[-1]) if lines else None,
            "stripped": "".join(s + "\n" for s in map(
                strip_line, p.stdout.splitlines()) if s is not None),
            "dir": workdir}


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("meshcli")
    return {"jax": run_cli("jax", base / "jax", MESH2),
            "torch": port_cli(base / "torch", MESH2)}


def test_mesh2_cli_matches_reference(mesh_runs):
    j, t = mesh_runs["jax"], mesh_runs["torch"]
    assert j["rc"] == 0 and t["rc"] == 0, t["err"][-2000:]
    assert sim_fields(t["summary"]) == sim_fields(j["summary"])
    assert t["summary"]["cross_shard_packets"] > 0
    assert t["stripped"] == j["stripped"]
    assert "[ram]" in t["stripped"] and "[stats]" in t["stripped"]
    assert "mesh 2 (gloo)" in t["err"]
    for name in ("run.ckpt.npz", "run.ckpt.npz.1"):
        got = leaf_table(t["dir"] / name)
        assert got == leaf_table(j["dir"] / name)
        assert got[6] == {"n_shards": 2, "dcn_slices": 1,
                          "host_order": None}


def test_mesh_checkpoint_resumes_unsharded(mesh_runs, tmp_path):
    t = mesh_runs["torch"]
    for name in ("phold.xml", "run.ckpt.npz.1"):
        (tmp_path / name).write_bytes((t["dir"] / name).read_bytes())
    r = run_cli("torch", tmp_path, ARGV + ["--resume", "run.ckpt.npz.1"])
    assert r["rc"] == 0, r["err"][-2000:]
    assert ("resharding: checkpoint written at 2 shard(s), resuming at 1"
            in r["err"])
    want = sim_fields(t["summary"])
    got = sim_fields(r["summary"])
    for k in ("events", "windows", "rx_bytes", "tx_bytes", "events_by_kind",
              "queue_drops", "net_dropped"):
        assert got[k] == want[k], k


def test_lost_peer_exits_77_with_bundle(tmp_path):
    (tmp_path / "phold.xml").write_text(PHOLD)
    argv = MESH2 + ["--collective-timeout", "3", "--diag-dir", "diag"]
    with in_dir(tmp_path), pytest.raises(pmesh.SpawnError) as e:
        pmesh.spawn(harness.cli_rank, 2, backend="gloo", device="cpu",
                    args=(argv, 1, "run.ckpt.npz"),
                    timeout_s=harness.SPAWN_TIMEOUT_S)
    assert e.value.exit_codes == [77, -9]
    (bundle,) = (tmp_path / "diag").glob("*.peerlost.*.json")
    b = json.loads(bundle.read_text())
    assert b["exit_code"] == 77 and b["mesh_shards"] == 2
    assert [s["hosts"] for s in b["shards"]] == [[0, 8], [8, 16]]
    assert b["rank"] == 0 and b["backend"] == "gloo"
    assert b["last_summary"]["now_ns"] >= 10 ** 9  # after the checkpoint


# -- the slow pin: chip_smoke.py's phase 21 -----------------------------------
def reference_shard_pins(base: Path) -> dict:
    """Phase 21 through the reference's CLI on the CPU: `--mesh 2`, then
    `--mesh 1 --resume auto` from its 3 s checkpoint (copied alone into a
    fresh directory), as chip_smoke.shard_pin_fields reads them."""
    import chip_smoke
    from shadow_tpu import cli as jcli

    pins = {}
    for label, (n_mesh, _) in chip_smoke.SHARD_MESHES.items():
        d = base / label
        d.mkdir(parents=True)
        extra = ["--mesh", str(n_mesh)]
        if label == "resumed":
            (d / chip_smoke.CLI_CKPT).write_bytes(
                (base / "run" / chip_smoke.CLI_MID_CKPT).read_bytes())
            extra += ["--resume", "auto"]
        (d / "tgen.xml").write_text(chip_smoke.tgen_config(
            chip_smoke.TGEN_PAIRS))
        out = io.StringIO()
        with in_dir(d), contextlib.redirect_stdout(out):
            assert jcli.main(chip_smoke.SHARD_ARGV + extra) == 0
        pins[label] = chip_smoke.shard_pin_fields(out.getvalue(), d)
    return json.loads(json.dumps(pins))


@pytest.mark.slow
def test_phase21_pin(tmp_path):
    import chip_smoke

    assert reference_shard_pins(tmp_path) == chip_smoke.PIN_CLI_SHARD
