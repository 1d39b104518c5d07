"""Elastic serving in the port, held on the CPU against the reference
(`tests/test_serve_elastic.py`'s cases, each run through both packages
unless it is a port-only property).

- lane-axis reshard and merge of [L, ...] trees (`runtime.fleet`);
- snapshot migration at the file level: shrink into `.part*` files whose
  manifests keep the original rids, grow through `state_lanes` with
  inert pad lanes, refusal of a lane count that does not divide, and a
  snapshot migrated by one package resumed by the other;
- device loss (exit 77 with the snapshot kept, a half-width relaunch
  that finishes the batch), in-process and idle resize, the generation
  keying the cache and riding /healthz;
- the retry wrapper's serve argv, SIGTERM forwarding, the batch resume
  refusing a serve snapshot, serve_client's bounded retry;
- the scenario registry for tgen/tor/bitcoin, and a TGen request (6
  pairs) served by the port's fleet equal to the reference's solo run.
"""

import os
import signal
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from test_torch_phold import one_torch_thread  # noqa: F401 (autouse)
from test_torch_serve import (
    BOTH,
    NAMES,
    PORT,
    REAL_DOCS,
    REF,
    FakeFleet,
    FakeHarvest,
    _doc,
    dead_writer_snapshot,
    fake_factory,
    same,
    serve_fake,
    wait_done,
)

# ------------------------------------------------------ lane-axis reshard


def _state(lanes, seeds=None):
    L = int(lanes)
    return {
        "now_ns": np.arange(L, dtype=np.int64) * 10,
        "windows": np.arange(L, dtype=np.int64),
        "seeds": np.asarray(seeds if seeds is not None else range(L),
                            np.int64),
    }


def pdir(tmp_path, P):
    """A package's own directory under tmp_path (so file names match)."""
    d = tmp_path / str(P)
    d.mkdir(exist_ok=True)
    return d


def _lists(tree):
    return {k: np.asarray(v).tolist() for k, v in tree.items()}


def test_lane_reshard_split_values_and_recurse():
    def run(P):
        parts = P.fleet.lane_reshard(_state(8), 4)
        sub = P.fleet.lane_reshard(parts[1], 2)
        return [_lists(p) for p in parts], [_lists(p) for p in sub]
    parts, sub = same(run)
    assert len(parts) == 2 and sub[1]["seeds"] == [6, 7]


def test_lane_merge_roundtrips_and_edge_cases():
    def run(P):
        st = _state(8)
        merged = P.fleet.lane_merge(P.fleet.lane_reshard(st, 2))
        assert P.fleet.lane_merge([st]) is st
        with pytest.raises(ValueError, match="no states"):
            P.fleet.lane_merge([])
        return _lists(merged)
    assert same(run) == _lists(_state(8))


@pytest.mark.parametrize("tree, lanes, match", [
    (_state(8), 3, "divide"), (_state(8), 0, "lanes"),
    ({"now_ns": np.int64(7)}, 1, "now_ns"),
    ({"a": np.zeros(8), "b": np.zeros(4)}, 2, "leading dim")],
    ids=["odd", "zero", "scalar", "disagree"])
def test_lane_reshard_refusals_are_loud(tree, lanes, match):
    for P in BOTH:
        with pytest.raises(ValueError, match=match):
            P.fleet.lane_reshard(tree, lanes)


# ----------------------------------------------------- chaos injectors


def test_chaos_devloss_and_resize_parse_and_fire(tmp_path):
    def run(P):
        C = P.chaos
        out = []
        for spec in ("devloss:lanes=2", "resize:beat=1"):
            with pytest.raises(ValueError) as e:
                C.ServeChaos(spec)
            out.append(str(e.value))
        c = C.ServeChaos("devloss:beat=2")
        c.fire("beat", beat=1)
        with pytest.raises(C.DeviceLost, match="beat 2"):
            c.fire("beat", beat=2)
        c.fire("beat", beat=2)
        r = C.ServeChaos("resize:beat=3,lanes=8")
        with pytest.raises(C.ResizeRequested) as e:
            r.fire("beat", beat=3)
        out.append(e.value.lanes)
        r.fire("beat", beat=3)
        d = tmp_path / str(P)
        with pytest.raises(C.DeviceLost):
            C.ServeChaos("devloss:beat=1", marker_dir=str(d)).fire(
                "beat", beat=1)
        out.append(sorted(x.name for x in d.glob("serve_chaos.*.fired")))
        C.ServeChaos("devloss:beat=1", marker_dir=str(d)).fire("beat",
                                                                beat=1)
        return out
    assert same(run)[2] == 8


# --------------------------------------------- snapshot migration (fake)


def _svc(P, lanes, snap, **kw):
    kw.setdefault("fleet_factory", fake_factory(P, lanes))
    return P.SimService(snapshot_path=snap, max_lanes=lanes,
                        pack_deadline_ms=30.0, beat_windows=2,
                        snapshot_beats=1, **kw)


def test_migrate_snapshot_shrink_part_manifests_preserve_rids(tmp_path):
    def run(P):
        snap = str(pdir(tmp_path, P) / "snap.npz")
        docs = [_doc(s) for s in (41, 42, 43, 44)]
        reqs = dead_writer_snapshot(P, snap, docs, lanes=4)
        svc2 = _svc(P, 2, snap)
        entries = svc2._migrate_snapshot(snap)
        out = [[os.path.basename(p) for _k, _r, p in entries],
               os.path.exists(snap), P.tot(svc2, "serve_migrations")]
        for _key, part_reqs, part_path in entries:
            header, leaves = P.checkpoint.load_checkpoint_raw(part_path)
            out.append((header["serve"], header["paths"], _lists(leaves),
                        [r.rid for r in part_reqs]))
        out.append([r.rid for r in reqs])
        return out
    out = same(run)
    assert out[1] is False and out[2] == 1
    assert out[3][0]["rids"] == ["r000000", "r000001"]
    assert out[3][0]["max_lanes"] == 2 and "state_lanes" not in out[3][0]


def test_shrink_migration_resumes_bit_identical(tmp_path):
    def run(P):
        docs = [_doc(s) for s in (51, 52, 53, 54)]
        want, _, _ = serve_fake(P, docs)
        snap = str(pdir(tmp_path, P) / "snap.npz")
        reqs = dead_writer_snapshot(P, snap, docs, lanes=4)
        svc2 = _svc(P, 2, snap)
        n = svc2.resume_pending_batch()
        health = svc2.health()
        svc2.start()
        recs = wait_done(svc2, [r.rid for r in reqs])
        out = (n, health, [recs[r.rid]["summary"] for r in reqs],
               [recs[r.rid]["resumed_from_beat"] for r in reqs],
               P.tot(svc2, "serve_migrations"), P.tot(svc2, "serve_resumes"),
               list(pdir(tmp_path, P).glob("snap.npz.part*")),
               svc2.submit(_doc(9))["request_id"])
        svc2.drain()
        assert out[2] == [w["summary"] for w in want]
        return out
    out = same(run)
    assert out[0] == 4 and out[1]["degraded_capacity"] is True
    assert out[3] == [3] * 4 and out[5] == 2 and out[6] == []


def test_grow_migration_pads_with_inert_lanes(tmp_path):
    def run(P):
        docs = [_doc(s) for s in (61, 62)]
        want, _, _ = serve_fake(P, docs, lanes=2)
        snap = str(pdir(tmp_path, P) / "snap.npz")
        reqs = dead_writer_snapshot(P, snap, docs, lanes=2)
        svc2 = _svc(P, 4, snap)
        n = svc2.resume_pending_batch()
        serve = P.checkpoint.read_header_info(snap + ".part0")["serve"]
        svc2.start()
        recs = wait_done(svc2, [r.rid for r in reqs])
        health = svc2.health()
        svc2.drain()
        got = [recs[r.rid]["summary"] for r in reqs]
        assert got == [w["summary"] for w in want]
        return n, serve, got, health
    n, serve, _, health = same(run)
    assert n == 2 and serve["state_lanes"] == 2
    assert "degraded_capacity" not in health


@pytest.mark.parametrize("writer, reader", [(REF, PORT), (PORT, REF)],
                         ids=["ref_to_port", "port_to_ref"])
def test_migrated_snapshot_crosses_packages(tmp_path, writer, reader):
    """A width-4 snapshot written by one package, migrated to width 2
    and finished by the other, equal to the unmolested run."""
    docs = [_doc(s) for s in (55, 56, 57, 58)]
    want, _, _ = serve_fake(reader, docs)
    snap = str(tmp_path / "snap.npz")
    reqs = dead_writer_snapshot(writer, snap, docs, lanes=4)
    svc2 = _svc(reader, 2, snap)
    assert svc2.resume_pending_batch() == 4
    svc2.start()
    try:
        recs = wait_done(svc2, [r.rid for r in reqs])
    finally:
        svc2.drain()
    assert [recs[r.rid]["summary"] for r in reqs] == \
        [w["summary"] for w in want]


def test_migrate_refuses_nondividing_lane_count(tmp_path, capsys):
    def run(P):
        snap = str(pdir(tmp_path, P) / "snap.npz")
        dead_writer_snapshot(P, snap, [_doc(s) for s in (71, 72, 73, 74)],
                             lanes=4)
        svc2 = _svc(P, 3, snap)
        n = svc2.resume_pending_batch()
        err = capsys.readouterr().err
        return (n, os.path.exists(snap), "cannot migrate snapshot" in err,
                P.tot(svc2, "serve_migrations"))
    assert same(run) == (0, True, True, 0)


# ------------------------------------------------ device loss (fake)


def test_devloss_exits_77_and_half_width_relaunch_finishes(tmp_path):
    def run(P):
        docs = [_doc(s) for s in (81, 82)]
        want, _, _ = serve_fake(P, docs, lanes=2)
        snap = str(pdir(tmp_path, P) / "snap.npz")
        exits = []
        svc1 = _svc(P, 2, snap, launch_retries=1,
                    chaos=P.chaos.ServeChaos("devloss:beat=2"),
                    peer_lost_exit=exits.append).start()
        try:
            rids = [svc1.submit(d)["request_id"] for d in docs]
            deadline = time.monotonic() + 30
            while not exits and time.monotonic() < deadline:
                time.sleep(0.02)
        finally:
            svc1.drain()
        out = [exits, P.tot(svc1, "serve_launch_retries"),
               os.path.exists(snap)]
        svc2 = _svc(P, 1, snap, generation=1)
        out.append(svc2.resume_pending_batch())
        svc2.start()
        recs = wait_done(svc2, rids)
        svc2.drain()
        out += [[recs[r]["summary"] for r in rids],
                [recs[r]["resumed_from_beat"] for r in rids],
                svc2._generation]
        assert out[4] == [w["summary"] for w in want]
        return out
    out = same(run)
    assert out[:4] == [[77], 0, True, 2] and out[5:] == [[1, 1], 2]


def test_is_device_loss_classifies_backend_messages():
    def run(P):
        svc = P.SimService(fleet_factory=fake_factory(P, 1), max_lanes=1)
        return [svc._is_device_loss(e) for e in (
            P.chaos.DeviceLost("gone"),
            RuntimeError("DATA LOSS: tpu burned"),
            RuntimeError("peer lost: worker 3"),
            RuntimeError("shape mismatch"))]
    assert same(run) == [True, True, True, False]


# ------------------------------------------------------- resize (fake)


def _elastic_factory(P, box):
    """A fake entry factory whose fleet width tracks the service's
    current max_lanes, as a rebuild at the new width does."""
    def factory(key, probe):
        return P.service.CacheEntry(
            key=key, fleet=FakeFleet(box["svc"].max_lanes),
            harvest=FakeHarvest(), names=NAMES)
    return factory


def test_inflight_resize_migrates_in_process(tmp_path):
    def run(P):
        docs = [_doc(s) for s in (91, 92)]
        want, _, _ = serve_fake(P, docs, lanes=2)
        snap = str(pdir(tmp_path, P) / "snap.npz")
        box = {}
        svc = _svc(P, 2, snap, fleet_factory=_elastic_factory(P, box),
                   chaos=P.chaos.ServeChaos("resize:beat=2,lanes=4"))
        box["svc"] = svc
        svc.start()
        try:
            rids = [svc.submit(d)["request_id"] for d in docs]
            recs = wait_done(svc, rids)
        finally:
            svc.drain()
        assert [recs[r]["summary"] for r in rids] == \
            [w["summary"] for w in want]
        return ([recs[r]["resumed_from_beat"] for r in rids],
                svc.max_lanes, svc.packer.max_lanes,
                P.tot(svc, "serve_migrations"), svc._generation,
                list(pdir(tmp_path, P).glob("snap.npz*")))
    assert same(run) == ([1, 1], 4, 4, 1, 1, [])


def test_idle_resize_applies_without_migration():
    def run(P):
        box = {}
        svc = P.SimService(fleet_factory=_elastic_factory(P, box),
                           max_lanes=2, pack_deadline_ms=30.0,
                           beat_windows=2)
        box["svc"] = svc
        svc.start()
        try:
            with pytest.raises(ValueError, match="lanes"):
                svc.resize(0)
            svc.resize(8)
            deadline = time.monotonic() + 10
            while svc.max_lanes != 8 and time.monotonic() < deadline:
                time.sleep(0.02)
            return (svc.max_lanes, svc.packer.max_lanes, svc._generation,
                    P.tot(svc, "serve_migrations"), svc.health())
        finally:
            svc.drain()
    assert same(run) == (8, 8, 1, 0, {"status": "ok",
                                      "mesh_generation": 1,
                                      "max_lanes": 8})


def test_generation_keys_cache_and_health_zero_cost():
    def run(P):
        reqs = [P.req(_doc(1))]
        key = P.service.request_class(reqs[0])
        out = []
        for gen in (0, 2):
            svc = P.SimService(fleet_factory=fake_factory(P, 2),
                               max_lanes=2, pack_deadline_ms=30.0,
                               beat_windows=2, generation=gen)
            svc._run_batch(key, reqs)
            out += [[str(k) for k in svc.cache.keys()], svc.health(),
                    svc.metrics.totals()["shadow_tpu_serve_mesh_generation"]]
        return out
    out = same(run)
    assert out[1] == {"status": "ok"} and out[5] == 2


# ------------------------------------------- cross-process surfaces


def test_next_retry_argv_learns_serve_flags():
    argv = ["python", "-m", "shadow_tpu_torch", "serve", "--max-lanes",
            "8", "--snapshot-path", "s.npz", "--queue-file", "q.json"]

    def run(P):
        S = P.supervisor
        return [S.next_retry_argv(argv, S.EXIT_PEER_LOST, shrink=True),
                S.next_retry_argv(["p", "serve", "--max-lanes=1"],
                                  S.EXIT_PEER_LOST, shrink=True),
                S.next_retry_argv(argv, 75),
                S.next_retry_argv(["p", "run", "--mesh", "4"], 75)]
    out = same(run)
    assert out[0][out[0].index("--max-lanes") + 1] == "4"
    assert "--resume" not in out[0] and "--max-lanes=1" in out[1]
    assert out[3][-2:] == ["--resume", "auto-if-any"]


def test_retry_wrapper_forwards_sigterm_to_child(tmp_path):
    """SIGTERM aimed at the port's --retry supervisor reaches the
    child's process group, and the old handler comes back."""
    marker = tmp_path / "drained"
    child = [sys.executable, "-c", (
        "import signal, sys, time\n"
        "def bye(*a):\n"
        f"    open({str(marker)!r}, 'w').write('ok')\n"
        "    sys.exit(0)\n"
        "signal.signal(signal.SIGTERM, bye)\n"
        "sys.stderr.write('up\\n'); sys.stderr.flush()\n"
        "for _ in range(600):\n"
        "    time.sleep(0.1)\n")]
    before = signal.getsignal(signal.SIGTERM)
    timer = threading.Timer(1.5, os.kill, (os.getpid(), signal.SIGTERM))
    timer.start()
    try:
        report = PORT.supervisor.run_with_retry(child, retries=0)
    finally:
        timer.cancel()
    assert report["exit_code"] == 0 and report["attempts"] == 1
    assert marker.read_text() == "ok"
    assert signal.getsignal(signal.SIGTERM) is before


def test_find_resume_checkpoint_refuses_serve_snapshot(tmp_path):
    st = {"a": np.arange(4, dtype=np.int64)}
    man = {"version": 1, "class": "phold(...)", "rids": ["r000000"],
           "seqs": [0], "docs": [_doc(1)], "beats_done": 2,
           "beat_windows": 2, "max_lanes": 4, "stops": [500]}

    def run(P):
        C = P.checkpoint
        path = str(pdir(tmp_path, P) / "ck.npz")
        C.save_checkpoint(path, st, meta={"plane": "serve"},
                          serve_manifest=man)
        with pytest.raises(ValueError, match="resume_pending_batch"):
            C.find_resume_checkpoint(path)
        C.save_checkpoint(path + ".1", st, meta={"gen": 0})
        os.utime(path + ".1", (1, 1))
        chosen, meta, skipped = C.find_resume_checkpoint(path)
        # the reason names the package's own `serve` command
        return (os.path.basename(chosen), meta,
                [(os.path.basename(p), r.replace(f"`{P} serve`", "`serve`"))
                 for p, r in skipped])
    out = same(run)
    assert out[1] == {"gen": 0} and "serve" in out[2][0][1]


def test_serve_client_bounded_connection_retry(monkeypatch):
    class _Resp:
        status = 200

        def read(self):
            return b'{"ok": true}'

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    calls = []

    def flaky(req, timeout=0):
        calls.append(1)
        if len(calls) < 3:
            raise urllib.error.URLError(ConnectionRefusedError("down"))
        return _Resp()

    def broken(req, timeout=0):
        calls.append(1)
        raise urllib.error.URLError(OSError("no route to host"))

    SC = PORT.serve_client
    monkeypatch.setattr(urllib.request, "urlopen", flaky)
    monkeypatch.setitem(SC._RETRY, "retries", 5)
    monkeypatch.setitem(SC._RETRY, "backoff_s", 0.0)
    monkeypatch.setitem(SC._RETRY, "count", 0)
    assert SC._http("http://x/healthz") == (200, {"ok": True})
    assert len(calls) == 3 and SC._RETRY["count"] == 2
    calls.clear()
    monkeypatch.setitem(SC._RETRY, "retries", 0)
    with pytest.raises(urllib.error.URLError):
        SC._http("http://x/healthz")
    assert len(calls) == 1
    calls.clear()
    monkeypatch.setitem(SC._RETRY, "retries", 5)
    monkeypatch.setattr(urllib.request, "urlopen", broken)
    with pytest.raises(urllib.error.URLError):
        SC._http("http://x/healthz")
    assert len(calls) == 1


# ------------------------------------------------- scenario registry

_TGEN = {"model": "tgen", "params": {"n_pairs": 2, "count": 1},
         "seed": 1, "stop_s": 2.0}
_TOR = {"model": "tor",
        "params": {"n_relays_per_class": 1, "n_servers": 1,
                   "n_clients": 2, "count": 1, "filesize": "16KiB"},
        "seed": 1, "stop_s": 2.0}
_BTC = {"model": "bitcoin",
        "params": {"n_nodes": 4, "blocks": 1, "blocksize": "64KiB",
                   "interval": 5},
        "seed": 1, "stop_s": 8.0}


def test_scenario_registry_hosts_without_building():
    def run(P):
        S = P.service.SCENARIOS
        return (sorted(S), S["tgen"].hosts_of({"n_pairs": 2}),
                S["tor"].hosts_of({"n_relays_per_class": 1,
                                   "n_servers": 1, "n_clients": 2}),
                S["bitcoin"].hosts_of({"n_nodes": 3}),
                {k: sorted(s.param_names) for k, s in S.items()},
                {k: s.nic for k, s in S.items()})
    out = same(run)
    assert out[0] == ["bitcoin", "phold", "tgen", "tor"]
    assert out[1] == (["srv0", "srv1", "cli0", "cli1"], 4)


def test_config_scenarios_classify_and_validate():
    def run(P):
        out = []
        for doc in (_TGEN, _TOR, _BTC):
            req = P.req(doc)
            P.service.validate_request(req)
            key = P.service.request_class(req)
            bigger = {**doc, "params": {**doc["params"], "capacity": 256}}
            out.append((str(key),
                        P.service.request_class(P.req({**doc, "seed": 99}))
                        == key,
                        P.service.request_class(P.req(bigger)) == key))
        for doc, match in (({"model": "tgen", "params": {"warp": 1},
                             "stop_s": 1.0}, "static knobs"),
                           ({**_BTC, "bandwidth_scale": 0.5},
                            "bandwidth_scale")):
            with pytest.raises(ValueError, match=match) as e:
                P.service.validate_request(P.req(doc))
            out.append(str(e.value))
        out.append(str(P.service.request_class(P.req(
            {**_TOR, "faults": ["crash hosts=guard0 start=0.5 end=1.0"]}))))
        return out
    out = same(run)
    assert [o[1:] for o in out[:3]] == [(True, False)] * 3


# ---------------------------------- real engine: TGen (6 pairs), served

TGEN_DOC = {"model": "tgen", "params": {"n_pairs": 6, "capacity": 128},
            "seed": 3, "stop_s": 3.5, "latency_scale": 1.5}


def test_tgen_served_equals_reference_solo():
    """A TGen request (6 pairs, latency-scaled, to 3.5 sim-s, where the
    clients started at 3 s have streams in flight) served by the port's
    fleet beside an inert pad lane: its summary equals the reference's
    solo run, and the pad lane's counters stay 0."""
    want = REF.service.solo_reference(TGEN_DOC)
    svc = PORT.SimService(max_lanes=2, pack_deadline_ms=30.0,
                          beat_windows=8).start()
    try:
        rid = svc.submit(TGEN_DOC)["request_id"]
        rec = wait_done(svc, [rid])[rid]
        entry = svc.cache.get(next(iter(svc.cache.keys())), None)
    finally:
        svc.drain()
    assert rec["status"] == "done", rec
    assert rec["summary"] == want and want["executed"] > 0
    assert rec["lanes_packed"] == 1
    # the pad lane of the warm fleet's template never steps
    st, binds = entry.fleet.make_inputs(svc._batch_plan(
        PORT.service.request_class(PORT.req(TGEN_DOC)),
        [PORT.req(TGEN_DOC)], 2))
    stops = np.asarray([TGEN_DOC["stop_s"] * 10**9, 0], np.int64)
    for _ in range(4):
        st = entry.fleet.step_window(st, stops, binds=binds)
    pad = entry.fleet.lane_summaries(st)[1]
    assert {k: pad[k] for k in ("windows", "executed", "sweeps",
                                "queue_drops")} == dict.fromkeys(
        ("windows", "executed", "sweeps", "queue_drops"), 0)


SERVE_CHILD = """
import sys
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(1)
from shadow_tpu_torch import cli
sys.exit(cli.main(sys.argv[1:], device="cpu"))
"""


def test_retry_relaunch_after_device_loss_finishes_the_batch(tmp_path):
    """`serve` under the port's `--retry` loop: a device loss at beat 2
    exits 77 with the beat-1 snapshot kept; the relaunch runs at half
    the lanes (`next_retry_argv`), migrates the snapshot and finishes
    both requests under their rids, equal to the reference's solo runs;
    SIGTERM then drains it (exit 0)."""
    import socket
    import subprocess

    from test_torch_serve import ROOT

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = SERVE_CHILD.format(root=str(ROOT))
    procs = []

    def popen(argv, **kw):
        assert argv[1:3] == ["-m", "shadow_tpu_torch"]
        procs.append(subprocess.Popen(
            [sys.executable, "-c", script] + argv[3:], cwd=tmp_path,
            **kw))
        return procs[-1]

    snap = tmp_path / "snap.npz"
    argv = [sys.executable, "-m", "shadow_tpu_torch", "serve", "--port",
            str(port), "--max-lanes", "2", "--pack-deadline-ms", "5000",
            "--beat-windows", "2", "--snapshot-beats", "1",
            "--snapshot-path", str(snap), "--queue-file",
            str(tmp_path / "q.json")]
    os.environ[PORT.chaos.ENV_VAR] = "devloss:beat=2"
    report = {}
    try:
        runner = threading.Thread(target=lambda: report.update(
            PORT.supervisor.run_with_retry(argv, retries=1, backoff_s=0.1,
                                           _popen=popen)))
        runner.start()
        SC = PORT.serve_client
        SC._RETRY.update(retries=40, backoff_s=0.1, count=0)
        url = f"http://127.0.0.1:{port}"
        docs = REAL_DOCS[:2]  # test_torch_serve's programs
        rids = SC.submit_all(url, docs)
        recs = SC.poll_results(url, rids, timeout_s=300.0, poll_s=0.1)
        health = SC._http(url + "/healthz")[1]
    finally:
        del os.environ[PORT.chaos.ENV_VAR]
        SC._RETRY.update(retries=0, backoff_s=0.25, count=0)
        if procs and procs[-1].poll() is None:
            procs[-1].send_signal(signal.SIGTERM)
        runner.join(timeout=120)
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert report["exit_history"] == [77, 0], report
    assert report["recoveries"] == 1
    assert [r["status"] for r in recs.values()] == ["done", "done"]
    for rid, d in zip(rids, docs):
        assert recs[rid]["summary"] == REF.service.solo_reference(d)
        assert recs[rid]["resumed_from_beat"] == 1
    assert health["mesh_generation"] >= 1 and health["max_lanes"] == 1
    assert not snap.exists()
