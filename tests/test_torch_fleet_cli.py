"""The port's `--fleet` command line, held on the CPU against the
reference CLI byte for byte (stdout, wall-clock fields stripped).

The scenario is chip_smoke.py phase 22's at a small size: TGen over TCP
(`chip_smoke.tgen_config`, 6 pairs) to FLEET_STOP_S with heartbeats
every 2 s, four lanes (seeds 1-4, lane 0 fault-free, lanes 1-3 under the
five fault types of FLEET_FAULTS, latency scales 1 to 2). Then: the
lanes under faults differ from the fault-free lane; the reference's
tools read the port's fleet log lane by lane; `--window N` drives the
lanes one window at a time with one clock probe per window; and the
refusals (the adaptive window, the per-scenario planes, bad specs, a
spill queue) exit 2 with the reference's messages. The phase-22 pin
(`-m slow`) recomputes PIN_CLI_FLEET from the reference at 2,048 pairs.
"""

import contextlib
import io
import json

import numpy as np
import pytest

import chip_smoke
from shadow_tpu import cli as jcli
from shadow_tpu_torch import cli as tcli
from shadow_tpu_torch.tools import diff_runs, parse_shadow
from shadow_tpu_torch.tools.strip_log import strip_line
from test_torch_cli import in_dir, one_thread

PAIRS = 6
# the summary keys that hold wall-clock time
WALL = ("wall_seconds", "build_seconds", "events_per_sec",
        "sim_s_per_wall_s", "scenarios_per_sec")


def stripped(text: str) -> str:
    """stdout with the wall-clock fields of the summary removed."""
    out = []
    for ln in text.splitlines():
        if ln.startswith("{"):
            obj = {k: v for k, v in json.loads(ln).items() if k not in WALL}
            ln = json.dumps(obj)
        s = strip_line(ln)
        if s is not None:
            out.append(s + "\n")
    return "".join(out)


def run_fleet_cli(pkg: str, workdir, argv) -> dict:
    """One package's `main` on the fleet scenario in `workdir`: {"rc",
    "out", "err", "summary", "info"}."""
    workdir.mkdir(parents=True, exist_ok=True)
    (workdir / "tgen.xml").write_text(chip_smoke.tgen_config(PAIRS))
    (workdir / "faults.txt").write_text(
        "\n".join(chip_smoke.FLEET_FAULT_LINES) + "\n")
    out, err, info = io.StringIO(), io.StringIO(), {}
    with in_dir(workdir), one_thread(), contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(err):
        if pkg == "jax":
            rc = jcli.main(list(argv))
        else:
            rc = tcli.main(list(argv), device="cpu", run_info=info)
    text = out.getvalue()
    lines = [ln for ln in text.splitlines() if ln.startswith("{")]
    return {"rc": rc, "out": text, "err": err.getvalue(),
            "summary": json.loads(lines[-1]) if lines else None,
            "info": info}


@pytest.fixture(scope="module")
def fleet_runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("fleet_cli")
    argv = chip_smoke.fleet_argv("faults.txt")
    return {pkg: run_fleet_cli(pkg, base / pkg, argv)
            for pkg in ("jax", "torch")}


def test_fleet_cli_matches_reference(fleet_runs, tmp_path):
    j, t = fleet_runs["jax"], fleet_runs["torch"]
    assert j["rc"] == t["rc"] == 0, t["err"][-2000:]
    assert stripped(t["out"]) == stripped(j["out"])
    # the lane-by-lane derivation that computes PIN_CLI_FLEET gives the
    # reference CLI's own [fleet] rows and summary
    (tmp_path / "faults.txt").write_text(
        "\n".join(chip_smoke.FLEET_FAULT_LINES) + "\n")
    ref = reference_lanes(PAIRS, tmp_path / "faults.txt")
    assert chip_smoke.fleet_pin_fields(j["out"]) == {
        "summary": ref["summary"], "rows_sha256": ref["rows_sha256"]}
    s = t["summary"]
    assert s["fleet_lanes"] == chip_smoke.FLEET_LANES
    assert s["seeds"] == [1, 2, 3, 4]
    assert len(s["lanes"]) == chip_smoke.FLEET_LANES
    # the whole segment's reads: one harvest copy per heartbeat segment
    info = t["info"]
    assert info["segments"] == 2 and info["harvest_reads"] == 2


def test_faulted_lanes_differ_from_the_fault_free_lane(fleet_runs):
    lanes = fleet_runs["torch"]["summary"]["lanes"]
    assert all(lanes[k] != lanes[0] for k in (1, 2, 3))
    assert all(r["executed"] > 0 for r in lanes)


def test_tools_read_the_port_fleet_log(fleet_runs, tmp_path):
    text = fleet_runs["torch"]["out"]
    stats = parse_shadow.parse_lines(text.splitlines())
    assert set(stats["fleet"]) == {"0", "1", "2", "3"}
    lane0 = stats["fleet"]["0"]
    assert lane0["ticks"] == [2, 4]
    assert lane0["seed"] == [1, 1]
    rows = fleet_runs["torch"]["summary"]["lanes"]
    for k, row in enumerate(rows):
        assert stats["fleet"][str(k)]["events"][-1] == row["executed"]
    a = tmp_path / "a.log"
    a.write_text(text)
    assert diff_runs.main([str(a), str(a)]) == 0
    # drift in one lane's counts shows under that lane's keys only
    b = tmp_path / "b.log"
    last = [ln for ln in text.splitlines()
            if ln.startswith("[shadow-heartbeat] [fleet] 4,2,")][0]
    f = last.split(",")
    f[5], f[6] = str(int(f[5]) + 1), str(int(f[6]) + 1)
    b.write_text(text.replace(last, ",".join(f)))
    keys = {e["key"] for e in diff_runs.diff_files(str(a), str(b),
                                                   rtol=0.0)}
    assert keys == {"fleet:2.events", "fleet:2.events-delta"}


def test_fixed_window_fleet_probes_once_per_window(tmp_path):
    """`--window N` runs one window of N ms per dispatch on every lane,
    the fleet's clock read once per window on its slowest lane; every
    lane's row equals a solo run of that lane stepped window by window."""
    from shadow_tpu_torch import config as tconfig
    from shadow_tpu_torch import sim as tsim
    from shadow_tpu_torch.core.engine import state_summary
    from shadow_tpu_torch.core.timebase import SECOND

    argv = ["tgen.xml", "--seed", "3", "--stoptime", "4", "--overflow",
            "drop", "--heartbeat-frequency", "2", "--window", "200",
            "--fleet", "lanes=2 seed=3:5"]
    t = run_fleet_cli("torch", tmp_path, argv)
    assert t["rc"] == 0, t["err"][-2000:]
    steps = []  # each lane's windows per segment, solo
    for k, seed in enumerate((3, 4)):
        sim = tsim.build_simulation(
            tconfig.parse_config(chip_smoke.tgen_config(PAIRS)), seed=seed,
            device="cpu", overflow="drop")
        st, n = sim.state0, []
        for stop in (2 * SECOND, 4 * SECOND):
            n.append(0)
            while int(st.now) < stop:
                st = sim.step_window(st, stop, window_ns=200_000_000)
                n[-1] += 1
        steps.append(n)
        assert t["summary"]["lanes"][k] == state_summary(st), k
    # a segment takes as many dispatches as its slowest lane's windows
    assert t["info"]["window_probes"] == sum(map(max, zip(*steps)))


REFUSED = {
    "window_auto": (["--window", "auto"], "--window auto cannot drive a "
                    "fleet"),
    "mesh": (["--mesh", "2"], "--mesh is per-scenario"),
    "trace": (["--trace", "64"], "--trace is per-scenario"),
    "stats": (["--stats"], "--stats is per-scenario"),
    "resume": (["--resume", "x.npz"], "--resume is per-scenario"),
    "checkpoint_interval": (["--checkpoint-interval", "1"],
                            "--checkpoint-interval is per-scenario"),
    "metrics": (["--metrics"], "--metrics is per-scenario"),
    "metrics_port": (["--metrics-port", "0"],
                     "--metrics-port is per-scenario"),
    "xprof": (["--xprof", "1:2"], "--xprof is per-scenario"),
    "profile": (["--profile"], "--profile is per-scenario"),
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_per_scenario_flags_refused(name, capsys):
    extra, msg = REFUSED[name]
    rc = tcli.main(["--test", "--stoptime", "1", "--overflow", "drop",
                    "--fleet", "lanes=2 seed=0:2"] + extra, device="cpu")
    assert rc == 2
    assert msg in capsys.readouterr().err


BAD_SPECS = {
    "count": ("lanes=2 seed=0:5", "2 lanes"),
    "no_lanes": ("seed=0:2", "lanes=L is required"),
    "unknown": ("lanes=2 speed=3", "unknown key(s) ['speed']"),
    "no_range": ("lanes=2 seed=4", "seed wants a range a:b"),
    "duplicate": ("lanes=2 lanes=3", "duplicate key 'lanes'"),
    "token": ("lanes=2 fast", "expected key=value"),
    "scales": ("lanes=2 latency-scale=1", "latency-scale lists 1 values"),
    "fault_lines": ("lanes=2 fault-file=faults.txt", "has 4 lane lines"),
    "window": ("lanes=2 --window", "--window must be a width"),
}


@pytest.mark.parametrize("name", list(BAD_SPECS))
def test_bad_specs_exit_2(name, tmp_path, capsys):
    spec, msg = BAD_SPECS[name]
    (tmp_path / "faults.txt").write_text(
        "\n".join(chip_smoke.FLEET_FAULT_LINES) + "\n")
    argv = ["--test", "--stoptime", "1", "--overflow", "drop"]
    if name == "window":
        argv += ["--window", "fast", "--fleet", "lanes=2"]
    else:
        argv += ["--fleet", spec]
    with in_dir(tmp_path):
        rc = tcli.main(argv, device="cpu")
    assert rc == 2
    assert msg in capsys.readouterr().err


def test_spill_queues_refused(capsys):
    # the CLI's default overflow is spill, whose refills are per scenario
    rc = tcli.main(["--test", "--stoptime", "1", "--fleet", "lanes=2"],
                   device="cpu")
    assert rc == 2
    assert "fleets cannot run spill/grow pressure modes" in (
        capsys.readouterr().err)


# -- the slow pin: chip_smoke.py's phase 22 ---------------------------------
def reference_lanes(pairs: int, fault_file) -> dict:
    """Phase 22's pin fields from the reference, lane by lane: each lane
    of a fleet is the reference's solo run of its scenario (its seed, its
    faults compiled with that seed, its latency scale through
    `bind_lane`'s network), as tests/test_fleet.py holds. The lanes run
    one compiled program, each bound as the fleet binds it (its key, its
    fault tables padded values-neutral to the lanes' common shape, its
    restart template and latency scale as inputs). Its heartbeat
    segments give the [fleet] rows and the summary the CLI prints; a
    run to the stop in one call gives the lane's digest. (The
    reference's vmapped fleet at 4,096 hosts x 4 lanes asks XLA for a
    163 GB buffer on the CPU; the lanes alone fit.)"""
    import functools
    import hashlib

    import jax
    import jax.numpy as jnp

    from shadow_tpu import config as jconfig
    from shadow_tpu import sim as jsim
    from shadow_tpu.core.engine import state_summary as jsummary
    from shadow_tpu.faults.schedule import CompiledFaults
    from shadow_tpu.faults.schedule import compile_faults as jcompile
    from shadow_tpu.runtime.fleet import _pad_faults as jpad
    from shadow_tpu.runtime.fleet import scaled_network as jscaled
    from shadow_tpu.utils.tracker import FLEET_HEADER
    from shadow_tpu_torch import convert
    from test_torch_phold import jax_leaves

    plan = chip_smoke.fleet_plan(fault_file, jcli)
    text = chip_smoke.tgen_config(pairs)
    sims = [jsim.build_simulation(jconfig.parse_config(text),
                                  **dict(chip_smoke.FLEET_BUILD_KW,
                                         seed=seed))
            for seed in plan["seeds"]]
    base = sims[0].engine
    hosts = len(sims[0].names)
    tables = ("times", "alive", "fgrp", "lat_milli", "passp", "bw_scale")

    @functools.lru_cache(maxsize=None)
    def program(flags):
        """One compiled solo run for every lane (`flags` None: a plan
        without faults): the seed's key, the latency scale, the fault
        tables and the restart template are its inputs, bound to the
        engine as the reference's fleet binds a lane."""
        def run(st, stop, key, lat, reset, arrays):
            kw = {"base_key": key,
                  "network": type(jscaled(base.network, 1.0))(
                      base.network, lat)}
            if flags is not None:
                kw["fault_reset"] = reset
                kw["faults"] = CompiledFaults(
                    **dict(zip(tables, arrays)), has_crash=flags[0],
                    has_link=flags[1], has_bw=flags[2],
                    np_times=np.zeros((1,), np.int64),
                    np_alive=np.ones((1, base.cfg.n_hosts), bool))
            return base.bind_lane(**kw).run(st, stop)

        return jax.jit(run)

    # every lane's tables (a fault-free lane's compiled from no specs)
    # padded to one shape, values-neutral, as the reference's fleet binds
    # them (`_pad_faults`), so that all lanes share one compile
    padded, flags_all = jpad([
        jcompile(tuple(plan["faults"][i] or ()), js.names, base.cfg.n_hosts,
                 plan["seeds"][i]) for i, js in enumerate(sims)])
    segments, digests = [], []
    for i, js in enumerate(sims):
        st0 = js.state0
        flags, arrays = None, ()
        if any(flags_all):
            flags = flags_all
            arrays = tuple(padded[k][i] for k in (
                "f_times", "f_alive", "f_fgrp", "f_lat", "f_passp", "f_bw"))
        lat = jscaled(base.network, plan["latency_scale"][i])._lat_milli
        run = functools.partial(program(flags), key=js.engine._base_key,
                                lat=lat, reset=st0.hosts, arrays=arrays)
        digests.append(convert.leaves_digest(jax_leaves(jax.device_get(
            run(st0, jnp.int64(chip_smoke.FLEET_STOP_NS))))))
        st, seg = st0, []
        for t_s in (2, 4):
            st = run(st, jnp.int64(t_s * 10**9))
            q = np.asarray(st.queues.time)
            fill = (np.float32((q != np.iinfo(np.int64).max).sum())
                    * (np.float32(1.0) / np.float32(q.size)))
            seg.append((jsummary(jax.device_get(st)), float(fill)))
        segments.append(seg)
    lines, last = [FLEET_HEADER], [0] * len(segments)
    for k, t_s in enumerate((2, 4)):
        for i, seg in enumerate(segments):
            row, fill = seg[k]
            delta, last[i] = row["executed"] - last[i], row["executed"]
            lines.append(
                f"[shadow-heartbeat] [fleet] {t_s},{i},{plan['seeds'][i]},"
                f"{row['now_ns'] // 1_000_000_000},{row['windows']},"
                f"{row['executed']},{delta},{row['queue_drops']},"
                f"{fill:.4f}")
    lanes = [dict(sorted(seg[-1][0].items())) for seg in segments]
    summary = {"fleet_lanes": len(lanes), "hosts": hosts,
               "sim_seconds": float(chip_smoke.FLEET_STOP_S),
               "events": sum(r["executed"] for r in lanes),
               "windows": max(r["windows"] for r in lanes),
               "queue_drops": sum(r["queue_drops"] for r in lanes),
               "seeds": list(plan["seeds"]), "lanes": lanes}
    rows = "".join(ln + "\n" for ln in lines)
    return {"summary": summary,
            "rows_sha256": hashlib.sha256(rows.encode()).hexdigest(),
            "lane_digests": digests}


@pytest.mark.slow
def test_fleet_cli_bench_shape_pin(tmp_path):
    """PIN_CLI_FLEET from the reference at 2,048 pairs, lane by lane, and
    the port's build_fleet + Fleet.run on the CPU to the same digests."""
    from shadow_tpu_torch import config as tconfig
    from shadow_tpu_torch import convert
    from shadow_tpu_torch import sim as tsim

    (tmp_path / "faults.txt").write_text(
        "\n".join(chip_smoke.FLEET_FAULT_LINES) + "\n")
    got = reference_lanes(chip_smoke.TGEN_PAIRS, tmp_path / "faults.txt")
    assert got == chip_smoke.PIN_CLI_FLEET
    ts = tsim.build_simulation(
        tconfig.parse_config(chip_smoke.tgen_config(chip_smoke.TGEN_PAIRS)),
        device="cpu", **chip_smoke.FLEET_BUILD_KW)
    tf = ts.build_fleet(chip_smoke.FLEET_LANES,
                        **chip_smoke.fleet_plan(tmp_path / "faults.txt",
                                                tcli))
    lt = convert.fleet_state_to_numpy(tf.run(chip_smoke.FLEET_STOP_NS))
    assert [convert.leaves_digest(convert.lane_of(lt, i))
            for i in range(chip_smoke.FLEET_LANES)] == got["lane_digests"]
