"""The serving plane in the port (`shadow_tpu_torch.serve`), held on the
CPU against the reference package (`shadow_tpu.serve`).

The cases are `tests/test_serve.py`'s, each run through both packages:

- fake-fleet cases: the reference's `_FakeFleet`/`_FakeHarvest` shape
  (copied below) is injected into both packages' `SimService`, the same
  request sequence is submitted to each, and every result record
  (`wall_ms` aside), `/queue`, `/healthz`, the metric totals and the
  snapshot files are compared; nothing compiles;
- real-engine cases: tiny PHOLD requests (8 hosts) served by the port's
  fleet, each summary equal to the reference's `solo_reference(doc)`,
  through a chaos-injected retry that resumes from a beat snapshot, and
  a snapshot written by either package resumed by the other;
- the served CLI (`serve` with a SIGTERM drain) as a subprocess.

Every reference program is shared through module-scoped fixtures.
"""

import importlib
import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from test_torch_phold import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
HOSTS = 8
PARAMS = {"hosts": HOSTS, "capacity": 64, "msgs_per_host": 2}
NAMES = [f"host{i}" for i in range(HOSTS)]
CRASH = "crash hosts=host1 start=0.1 end=0.2"
_TERMINAL = ("done", "error", "timeout")


class Pkg:
    """One package's serving plane, by module: `REF` is the reference,
    `PORT` the port (its service on the CPU)."""

    def __init__(self, root: str):
        self.root = root
        self.port = root == "shadow_tpu_torch"
        imp = lambda m: importlib.import_module(f"{root}.{m}")
        self.service = imp("serve.service")
        self.packer = imp("serve.packer")
        self.cache = imp("serve.cache")
        self.chaos = imp("serve.chaos")
        self.http = imp("serve.http")
        self.metrics = imp("obs.metrics")
        self.servetrace = imp("obs.servetrace")
        self.checkpoint = imp("utils.checkpoint")
        self.supervisor = imp("runtime.supervisor")
        self.fleet = imp("runtime.fleet")
        self.serve_report = imp("tools.serve_report")
        self.serve_client = imp("tools.serve_client")
        self.export_trace = imp("tools.export_trace")
        self.diff_runs = imp("tools.diff_runs")
        self.check_openmetrics = imp("tools.check_openmetrics")

    def __repr__(self):
        return self.root

    def SimService(self, **kw):
        if self.port:
            kw.setdefault("device", "cpu")
        return self.service.SimService(**kw)

    def req(self, doc, seq=0):
        return self.packer.parse_request(doc, rid=f"r{seq:06d}", seq=seq)

    def tot(self, svc, family):
        return svc.metrics.totals()[f"shadow_tpu_{family}"]


REF = Pkg("shadow_tpu")
PORT = Pkg("shadow_tpu_torch")
BOTH = (REF, PORT)


def _doc(seed, stop_s=0.5, faults=None, lat=None):
    d = {"model": "phold", "params": dict(PARAMS), "seed": seed,
         "stop_s": stop_s}
    if faults:
        d["faults"] = list(faults)
    if lat is not None:
        d["latency_scale"] = lat
    return d


def wait_done(svc, rids, timeout_s=120.0, poll_s=0.02):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        recs = {r: svc.result(r) for r in rids}
        if all(x["status"] in _TERMINAL for x in recs.values()):
            return recs
        time.sleep(poll_s)
    raise TimeoutError(f"requests still pending: {rids}")


def strip_wall(rec):
    """A result record without its wall-clock field."""
    return {k: v for k, v in rec.items() if k != "wall_ms"}


def det_totals(svc) -> dict:
    """Metric totals without the wall-latency sum (its count stays)."""
    return {k: v for k, v in svc.metrics.totals().items()
            if k != "shadow_tpu_serve_request_latency_ns_sum"}


def same(fn, *args, **kw):
    """fn(pkg, *args) for both packages; the two results must be equal.
    Returns the port's."""
    out = [fn(p, *args, **kw) for p in BOTH]
    assert out[0] == out[1], (out[0], out[1])
    return out[1]


# ------------------------------------------------------------ fake fleet
#
# `tests/test_serve.py`'s deterministic pure-python fleet: each active
# lane advances window_ns of sim time per step_window and bumps counters
# from its seed, so two services over the same requests give the same
# summaries — what the snapshot, bisection and migration cases need.


class FakeFleet:
    def __init__(self, lanes, window_ns=50_000_000):
        self.lanes = int(lanes)
        self.window_ns = int(window_ns)

    def make_inputs(self, plan):
        L = plan.lanes
        st = {
            "now_ns": np.zeros(L, np.int64),
            "windows": np.zeros(L, np.int64),
            "executed": np.zeros(L, np.int64),
            "sweeps": np.zeros(L, np.int64),
            "queue_drops": np.zeros(L, np.int64),
            "seeds": np.asarray(plan.seeds, np.int64),
        }
        return st, np.asarray(plan.seeds, np.int64)

    def step_window(self, st, stops, binds=None):
        new = {k: np.array(v) for k, v in st.items()}
        stops = np.asarray(stops)
        for i in range(self.lanes):
            if int(stops[i]) > 0 and int(new["now_ns"][i]) < int(stops[i]):
                new["now_ns"][i] = min(
                    int(new["now_ns"][i]) + self.window_ns, int(stops[i]))
                new["windows"][i] += 1
                new["executed"][i] += int(new["seeds"][i]) % 5 + 1
        return new

    def adopt_state(self, state):
        return {k: np.array(v) for k, v in state.items()}


class FakeHarvest:
    def extract(self, st, full=False):
        return st, {k: np.array(v) for k, v in st.items()}

    def fetch(self, bundle):
        return bundle

    def lane_summaries_from(self, fetched):
        keys = ("now_ns", "windows", "executed", "sweeps", "queue_drops")
        return [{k: int(fetched[k][i]) for k in keys}
                for i in range(len(fetched["now_ns"]))]


def fake_factory(P, lanes, window_ns=50_000_000, broken=None):
    def factory(key, probe):
        if broken is not None and broken[0]:
            raise RuntimeError("injected factory failure")
        return P.service.CacheEntry(key=key,
                                    fleet=FakeFleet(lanes, window_ns),
                                    harvest=FakeHarvest(), names=NAMES)
    return factory


def quiet(P, **kw):
    """A service whose packer never fires (huge deadline and lanes)."""
    kw.setdefault("max_lanes", 64)
    kw.setdefault("pack_deadline_ms", 3_600_000.0)
    return P.SimService(**kw)


def serve_fake(P, docs, *, lanes=4, **kw):
    """Submit `docs` to a started fake-fleet service and wait: (records
    stripped of wall_ms, the service, the rids)."""
    kw.setdefault("pack_deadline_ms", 30.0)
    kw.setdefault("beat_windows", 2)
    kw.setdefault("fleet_factory", fake_factory(P, lanes))
    svc = P.SimService(max_lanes=lanes, **kw).start()
    try:
        rids = [svc.submit(d)["request_id"] for d in docs]
        recs = wait_done(svc, rids)
    finally:
        svc.drain()
    return [strip_wall(recs[r]) for r in rids], svc, rids


# --------------------------------------------------------- request schema


@pytest.mark.parametrize("doc, match", [
    ({"model": "phold", "params": PARAMS, "seed": 1}, "stop_s"),
    ({**_doc(1), "bogus": 1}, "unknown request field"),
    (_doc(1, faults=["meteor hosts=*"]), "unknown fault type"),
    ({**_doc(1), "latency_scale": -1.0}, "latency_scale"),
    ({**_doc(1), "stop_s": 0.0}, "stop"),
    ({**_doc(1), "deadline_ms": -1}, "deadline_ms"),
], ids=["no_stop", "field", "fault", "latency", "zero_stop", "deadline"])
def test_parse_request_validation_errors(doc, match):
    msgs = []
    for P in BOTH:
        with pytest.raises(ValueError, match=match) as e:
            P.req(doc)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_parse_request_docs_and_validation_match_reference():
    docs = [_doc(1), {**_doc(1), "deadline_ms": 250},
            _doc(2, faults=[CRASH], lat=1.5)]
    assert same(lambda P: [P.req(d).doc() for d in docs])
    assert "deadline_ms" not in PORT.req(_doc(1)).doc()
    for doc, match in (({**_doc(1), "model": "nosuch"}, "unknown model"),
                       ({"model": "phold", "params": {"warp": 9},
                         "stop_s": 1.0}, "static knobs"),
                       ({**_doc(1), "bandwidth_scale": 0.5},
                        "bandwidth_scale")):
        msgs = []
        for P in BOTH:
            with pytest.raises(ValueError, match=match) as e:
                P.service.validate_request(P.req(doc))
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def test_equivalence_class_keys():
    """Class strings equal the reference's character for character, and
    split as the reference's do."""
    docs = [_doc(1), _doc(99), _doc(1, stop_s=2.0), _doc(1, lat=1.7),
            {"model": "phold", "params": dict(PARAMS, capacity=128),
             "stop_s": 1.0},
            _doc(1, faults=[CRASH]),
            _doc(2, faults=["crash hosts=host2 start=0.1 end=0.2",
                            "crash hosts=host3 start=0.1 end=0.2"]),
            _doc(1, faults=["crash hosts=nomatch* start=1 end=2"]),
            _doc(1, faults=["partition src=host0 dst=host* start=0.1 "
                            "end=0.3", "loss src=host1 dst=* loss=0.3 "
                            "start=0.1 end=0.2"]),
            _doc(1, faults=["bandwidth hosts=host0 factor=0.25 "
                            "start=0.1 end=0.2"])]
    keys = same(lambda P: [str(P.packer.equivalence_class(
        P.req(d), NAMES, HOSTS)) for d in docs])
    base = keys[0]
    assert keys[1:4] == [base] * 3
    assert keys[4] != base
    assert keys[5] != base and keys[5] == keys[6]
    assert keys[7] == base
    assert base == "phold(capacity=64,hosts=8,msgs_per_host=2)/faults:none"


# ------------------------------------------------------------- the packer


def test_packer_full_beats_deadline():
    def run(P):
        t = [0.0]
        p = P.packer.LanePacker(max_lanes=2, deadline_s=10.0,
                                clock=lambda: t[0])
        a, b, c = (P.req(_doc(1), 0), P.req(_doc(2, faults=[CRASH]), 1),
                   P.req(_doc(3), 2))
        ka, kb = (P.service.request_class(a), P.service.request_class(b))
        p.push(ka, a)
        p.push(kb, b)
        out = [p.ready()]
        p.push(ka, c)
        out += [str(p.ready()), [r.rid for r in p.pop(ka)], p.ready()]
        t[0] = 10.5
        out += [str(p.ready()), p.next_timeout(), p.snapshot()]
        return out
    out = same(run)
    assert out[0] is None and out[2] == ["r000000", "r000002"]


def test_packer_deterministic_order_and_drain():
    def run(P):
        t = [0.0]
        p = P.packer.LanePacker(max_lanes=8, deadline_s=1.0,
                                clock=lambda: t[0])
        reqs = [P.req(_doc(s), s) for s in range(3)]
        reqs.append(P.req(_doc(9, faults=[CRASH]), 3))
        for r in reqs:
            p.push(P.service.request_class(r), r)
        t[0] = 2.0
        out = [str(p.ready()), p.depth(), p.snapshot()]
        out += [[r.seq for r in p.drain_all()], p.depth(), p.ready()]
        return out
    assert same(run)[3] == [0, 1, 2, 3]


# ---------------------------------------------------------- program cache


def test_program_cache_hit_miss_lru_deterministic():
    def run(P):
        built = []

        def factory(tag):
            def f():
                built.append(tag)
                return f"prog-{tag}"
            return f
        m = P.metrics.ServeMetrics()
        c = P.cache.ProgramCache(max_programs=2, metrics=m)
        out = [c.get("A", factory("A")), c.get("A", factory("A"))]
        for k in "BACB":
            c.get(k, factory(k))
        return out + [built, c.keys(), c.hits_by_key, c.snapshot(),
                      m.render()]
    out = same(run)
    assert out[2] == ["A", "B", "C", "B"] and out[3] == ["C", "B"]


def test_program_cache_eviction_drops_the_last_reference():
    import gc
    import weakref

    class Entry:
        pass

    c = PORT.cache.ProgramCache(max_programs=1)
    first = c.get("A", Entry)
    ref = weakref.ref(first)
    del first
    c.get("B", Entry)
    gc.collect()
    assert ref() is None


# -------------------------------------------------------- request plane


def test_submit_queue_result_endpoints():
    def run(P):
        svc = quiet(P).start()
        srv = P.http.ServeServer(svc, port=0,
                                 _stream=open(os.devnull, "w")).start()
        url = f"http://127.0.0.1:{srv.port}"
        out = []

        def call(path, data=None):
            req = urllib.request.Request(url + path, data=data)
            try:
                with urllib.request.urlopen(req, timeout=10) as r:
                    return r.status, r.headers["Content-Type"], r.read()
            except urllib.error.HTTPError as e:
                return e.code, e.headers["Content-Type"], e.read()
        try:
            out.append(call("/submit", json.dumps(_doc(7)).encode()))
            out.append(call("/result/r000000"))
            status, ctype, body = call("/queue")
            q = json.loads(body)
            for c in q["packer"]["classes"].values():
                c["oldest_wait_s"] = 0  # wall time
            out.append((status, ctype, q))
            out.append(call("/submit",
                            json.dumps({"model": "phold"}).encode()))
            out.append(call("/result/nope"))
            out.append(call("/healthz"))
            out.append(call("/nowhere"))
            out.append(call("/trace/r000000"))
            status, ctype, body = call("/metrics")
            out.append((status, ctype,
                        P.metrics.validate_openmetrics(body.decode())))
        finally:
            srv.close()
            svc.drain()
        return out
    out = same(run)
    assert out[1][0] == 202 and out[3][0] == 400 and out[4][0] == 404


def test_serve_metrics_render_byte_for_byte():
    def run(P):
        svc = quiet(P)
        svc.submit(_doc(1))
        m = svc.metrics
        m.observe_latency_ns(12_345)
        m.observe_latency_ns(0)
        m.inc("serve_lanes", 3)
        m.set("serve_inflight", 2.5)
        m.observe_class("queue_wait", "clsA", 1_000_000, rid="r000001",
                        t_s=0.5)
        m.observe_class("queue_wait", "clsA", 2_000_000, rid="r000007",
                        t_s=0.9)
        m.observe_class("beat_wall", 'cls"B', 5_000_000, rid="r000002",
                        t_s=1.0)
        m.observe_class("pack_wait", "clsA", 7, rid=None)
        text = m.render()
        return text, m.totals(), P.metrics.validate_openmetrics(text)
    text, totals, probs = same(run)
    assert probs == []
    assert "shadow_tpu_serve_requests_total 1" in text
    assert totals["shadow_tpu_serve_request_latency_ns_sum"] == 12_345


def test_drain_persists_and_reloads_queue(tmp_path):
    def run(P):
        qf = str(tmp_path / f"{P}.queue.json")
        svc = quiet(P, queue_file=qf).start()
        svc.submit(_doc(5))
        svc.submit(_doc(6, faults=[CRASH]))
        report = svc.drain()
        text = open(qf).read()
        with pytest.raises(P.service.ServiceDraining):
            svc.submit(_doc(7))
        svc2 = quiet(P, queue_file=qf)
        return (report["persisted"], text, svc2.load_queue(),
                svc2.packer.depth(), os.path.exists(qf), svc.health())
    out = same(run)
    assert out[0] == 2 and out[2] == 2 and not out[4]


def test_load_queue_writes_rejects_instead_of_dropping(tmp_path):
    def run(P):
        qf = str(tmp_path / f"{P}.q.json")
        bad = {"model": "phold", "params": {"warp": 1}, "stop_s": 1.0}
        with open(qf, "w") as f:
            json.dump({"version": 1, "pending": [_doc(5), bad]}, f)
        svc = quiet(P, queue_file=qf)
        n = svc.load_queue()
        return n, svc.packer.depth(), open(qf + ".rejected").read()
    n, depth, rej = same(run)
    assert n == 1 and depth == 1 and "warp" in rej


def test_supervisor_mark_drained_exit_zero():
    def run(P):
        sup = P.supervisor.Supervisor(install_signals=False)
        sup.stop_signum = signal.SIGTERM
        out = [sup.exit_code()]
        sup.mark_drained()
        out.append(sup.exit_code())
        out.append(P.supervisor.Supervisor(install_signals=False)
                   .exit_code())
        return out
    assert same(run) == [128 + signal.SIGTERM, 0, 0]


def test_diff_runs_served_vs_solo(tmp_path):
    summary = {"now_ns": 500_000_000, "windows": 10, "executed": 160,
               "sweeps": 40, "queue_drops": 0}
    served = {"request_id": "r000001", "status": "done",
              "summary": dict(summary), "lane": 2, "lanes_packed": 4,
              "wall_ms": 12.5, "cache_hit": True}
    a, b = tmp_path / "served.json", tmp_path / "solo.json"
    b.write_text(json.dumps(summary))

    def run(P, rec):
        a.write_text(json.dumps(rec))
        D = P.diff_runs
        return (D.classify(str(a), a.read_text()),
                D.classify(str(b), b.read_text()),
                D.diff_files(str(a), str(b), rtol=0.0),
                D.render_text(D.diff_files(str(a), str(b), rtol=0.0))
                if hasattr(D, "render_text") else None)
    out = same(run, served)
    assert out[2] == []
    drifted = dict(served, summary=dict(summary, executed=161))
    assert [e["key"] for e in same(run, drifted)[2]] == ["executed"]
    a.write_text(json.dumps({"request_id": "r9", "status": "running"}))
    for P in BOTH:
        with pytest.raises(ValueError, match="no summary"):
            P.diff_runs.load_artifact(str(a))


def test_checkpoint_v7_serve_manifest_roundtrip(tmp_path):
    """A manifest written by either package reads back in the other;
    the refusal of `serve_manifest=` is gone."""
    state = {"a": np.arange(4, dtype=np.int64)}
    man = {"version": 1, "rids": ["r000001"], "beats_done": 3,
           "class": "phold(...)/faults:none"}
    for W in BOTH:
        p = str(tmp_path / f"{W}.npz")
        W.checkpoint.save_checkpoint(p, state, meta={"plane": "serve"},
                                     serve_manifest=man)
        for R in BOTH:
            info = R.checkpoint.read_header_info(p)
            assert info["format_version"] == 7 and info["serve"] == man
            assert R.checkpoint.verify_checkpoint(p) == {"plane": "serve"}
            got, _ = R.checkpoint.load_checkpoint(
                p, {"a": np.zeros(4, np.int64)})
            assert list(np.asarray(got["a"])) == [0, 1, 2, 3]
        W.checkpoint.save_checkpoint(p, state)
        assert PORT.checkpoint.read_header_info(p)["serve"] is None


# ------------------------------------------- failure semantics (fake)


def test_serve_chaos_parse_and_one_shot(tmp_path):
    def run(P):
        C = P.chaos
        out = []
        for spec in ("explode:beat=1", "wedge:beat=1", "raise:beat=x"):
            with pytest.raises(ValueError) as e:
                C.ServeChaos(spec)
            out.append(str(e.value))
        out.append(bool(C.ServeChaos("")))
        fired = []
        c = C.ServeChaos("raise:beat=2", on_inject=fired.append)
        c.fire("beat", beat=1, seeds=(1,))
        with pytest.raises(C.ChaosInjected):
            c.fire("beat", beat=2, seeds=(1,))
        c.fire("beat", beat=2, seeds=(1,))
        out.append(fired)
        d = tmp_path / str(P)
        c1 = C.ServeChaos("raise:beat=1", marker_dir=str(d))
        with pytest.raises(C.ChaosInjected):
            c1.fire("beat", beat=1)
        out.append(sorted(x.name for x in d.glob("serve_chaos.*.fired")))
        C.ServeChaos("raise:beat=1", marker_dir=str(d)).fire("beat", beat=1)
        p = C.ServeChaos("poison:seed=13")
        for _ in range(2):
            with pytest.raises(C.ChaosInjected):
                p.fire("beat", beat=1, seeds=(11, 13))
        p.fire("beat", beat=1, seeds=(11, 12))
        os.environ[C.ENV_VAR] = "raise:beat=4;poison:seed=2"
        try:
            out.append(bool(C.from_env()))
        finally:
            del os.environ[C.ENV_VAR]
        out.append(C.from_env())
        return out
    assert same(run)[4] == ["raise"]


def test_error_path_records_metrics_worker_alive():
    def run(P):
        svc = P.SimService(max_lanes=2, pack_deadline_ms=30.0,
                           beat_windows=2,
                           fleet_factory=fake_factory(P, 2, broken=[True]),
                           launch_retries=0, launch_backoff_s=0.0,
                           degraded_after=99).start()
        try:
            rids = [svc.submit(_doc(s))["request_id"] for s in (1, 2)]
            recs = wait_done(svc, rids)
            rids2 = [svc.submit(_doc(s))["request_id"] for s in (3, 4)]
            recs2 = wait_done(svc, rids2)
            health = svc.health()
        finally:
            svc.drain()
        return ([strip_wall(recs[r]) for r in rids],
                [strip_wall(recs2[r]) for r in rids2], health,
                det_totals(svc), svc._submit_t)
    recs, recs2, health, totals, submit_t = same(run)
    assert all(r["status"] == "error" for r in recs + recs2)
    assert health == {"status": "ok"} and submit_t == {}
    assert totals["shadow_tpu_serve_errors"] == 4


def test_degraded_flip_blocks_submit_and_recovers():
    def run(P):
        broken = [True]
        svc = quiet(P, fleet_factory=fake_factory(P, 64, broken=broken),
                    launch_retries=0, launch_backoff_s=0.0,
                    degraded_after=2)
        reqs = [P.req(_doc(s), seq=s) for s in (1, 2, 3)]
        key = P.service.request_class(reqs[0])
        out = []
        svc._run_batch(key, [reqs[0]])
        out.append(svc.health())
        svc._run_batch(key, [reqs[1]])
        out.append(svc.health())
        with pytest.raises(P.service.ServiceDegraded) as e:
            svc.submit(_doc(9))
        out.append(str(e.value))
        broken[0] = False
        svc._run_batch(key, [reqs[2]])
        out += [svc.health(), strip_wall(svc.result(reqs[2].rid)),
                svc.submit(_doc(9)), det_totals(svc)]
        return out
    out = same(run)
    assert out[1]["status"] == "degraded" and out[3] == {"status": "ok"}


def test_retry_resumes_from_snapshot_bit_identical(tmp_path):
    docs = [_doc(s) for s in (11, 12, 13, 14)]

    def run(P):
        want, _, _ = serve_fake(P, docs, launch_backoff_s=0.0)
        snap = str(tmp_path / f"{P}.snap.npz")
        got, svc, _ = serve_fake(
            P, docs, launch_backoff_s=0.0, snapshot_beats=2,
            snapshot_path=snap, launch_retries=1,
            chaos=P.chaos.ServeChaos("raise:beat=3"))
        return want, got, det_totals(svc), os.path.exists(snap)
    want, got, totals, left = same(run)
    assert [r["summary"] for r in want] == [r["summary"] for r in got]
    assert all(r["resumed_from_beat"] == 2 < r["beats"] for r in got)
    assert totals["shadow_tpu_serve_resumes"] == 1 and not left


def test_bisection_isolates_poison_request():
    def run(P):
        recs, svc, _ = serve_fake(
            P, [_doc(s) for s in (11, 12, 13, 14)], launch_retries=0,
            launch_backoff_s=0.0,
            chaos=P.chaos.ServeChaos("poison:seed=13"))
        return recs, det_totals(svc), svc._submit_t
    recs, totals, submit_t = same(run)
    assert [r["status"] for r in recs] == ["done", "done", "error", "done"]
    assert totals["shadow_tpu_serve_bisections"] == 2 and submit_t == {}


def test_per_request_deadline_timeout_partial_summary():
    def run(P):
        t = [0.0]

        def clock():
            t[0] += 0.05
            return t[0]
        recs, svc, _ = serve_fake(
            P, [_doc(1, stop_s=0.5), {**_doc(2, stop_s=50.0),
                                      "deadline_ms": 200}],
            lanes=2, pack_deadline_ms=1.0, clock=clock)
        return recs, det_totals(svc)
    recs, totals = same(run)
    assert recs[0]["status"] == "done" and recs[1]["status"] == "timeout"
    assert 0 < recs[1]["partial_summary"]["now_ns"] < 50 * 10**9


def test_launch_watchdog_fires_with_diag_bundle(tmp_path):
    def run(P):
        d = tmp_path / str(P)
        exits = []
        recs, _, _ = serve_fake(
            P, [_doc(3)], lanes=1, launch_retries=0,
            launch_backoff_s=0.0, launch_deadline_s=0.3, diag_dir=str(d),
            chaos=P.chaos.ServeChaos("wedge:beat=2,secs=1.5"),
            watchdog_exit=exits.append)
        (bundle,) = d.glob("shadow_tpu.serve.launchstall.*.json")
        payload = json.loads(bundle.read_text())
        return (recs, exits, payload["exit_code"], payload["progress"],
                len(list(d.glob("shadow_tpu.serve.launchstall.*"
                                ".stacks.txt"))))
    recs, exits, code, progress, stacks = same(run)
    assert exits == [code] == [75] and progress["beat"] == 1
    assert stacks == 1 and recs[0]["status"] == "done"


def dead_writer_snapshot(P, path, docs, beats=3, lanes=2):
    """A snapshot as a `lanes`-wide writer's beat loop leaves it at beat
    `beats` before it dies (`tests/test_serve.py`'s restart recipe)."""
    svc = P.SimService(fleet_factory=fake_factory(P, lanes),
                       snapshot_path=path, max_lanes=lanes,
                       pack_deadline_ms=30.0, beat_windows=2,
                       snapshot_beats=1)
    reqs = [P.req(d, seq=i) for i, d in enumerate(docs)]
    key = P.service.request_class(reqs[0])
    entry = fake_factory(P, lanes)(key, reqs[0])
    st, binds = entry.fleet.make_inputs(svc._batch_plan(key, reqs, lanes))
    stops = np.asarray([r.stop_ns for r in reqs]
                       + [0] * (lanes - len(reqs)), np.int64)
    for _ in range(beats * 2):
        st = entry.fleet.step_window(st, stops, binds=binds)
    svc._write_snapshot(key, reqs, st, beats, stops)
    return reqs


@pytest.mark.parametrize("writer, reader", [(REF, PORT), (PORT, REF),
                                            (PORT, PORT)],
                         ids=["ref_to_port", "port_to_ref", "port"])
def test_restart_resumes_pending_batch_bit_identical(tmp_path, writer,
                                                     reader):
    """A dead writer's snapshot, written by one package, resumed by a
    restarted service of the other under the original rids."""
    docs = [_doc(21), _doc(22)]
    want, _, _ = serve_fake(reader, docs, lanes=2)
    snap = str(tmp_path / "snap.npz")
    dead_writer_snapshot(writer, snap, docs)
    svc2 = reader.SimService(fleet_factory=fake_factory(reader, 2),
                             snapshot_path=snap, max_lanes=2,
                             pack_deadline_ms=30.0, beat_windows=2,
                             snapshot_beats=1)
    assert svc2.resume_pending_batch() == 2
    assert svc2.result("r000000")["status"] == "queued"
    svc2.start()
    recs = wait_done(svc2, ["r000000", "r000001"])
    assert reader.tot(svc2, "serve_resumes") == 1
    for rid, w in zip(["r000000", "r000001"], want):
        assert recs[rid]["status"] == "done"
        assert recs[rid]["resumed_from_beat"] == 3
        assert recs[rid]["summary"] == w["summary"]
    assert not os.path.exists(snap)
    assert svc2.submit(_doc(9))["request_id"] == "r000002"
    svc2.drain()


def test_snapshot_files_equal_across_packages(tmp_path):
    """The same dead writer in both packages leaves the same leaf table
    and manifest."""
    def run(P):
        path = str(tmp_path / f"{P}.npz")
        dead_writer_snapshot(P, path, [_doc(31), _doc(32, lat=1.5)])
        header, leaves = P.checkpoint.load_checkpoint_raw(path)
        return ({k: header[k] for k in ("paths", "shapes", "dtypes",
                                        "crc32", "serve", "meta")},
                {k: np.asarray(v).tolist() for k, v in leaves.items()})
    same(run)


def test_result_retention_lru_cap_and_pinning():
    def run(P):
        svc = quiet(P, max_results=2)
        reqs = [P.req(_doc(s), seq=s) for s in range(4)]
        key = P.service.request_class(reqs[0])
        for r in reqs[:3]:
            svc._fail_requests(key, [r], RuntimeError("x"))
        out = [svc.result("r000000"), svc.result("r000001")]
        svc._fail_requests(key, [reqs[3]], RuntimeError("x"))
        return out + [svc.result("r000002"), svc.result("r000001"),
                      det_totals(svc)]
    out = same(run)
    assert out[0] is None and out[2] is None and out[3] is not None


def test_result_retention_ttl_spares_queued():
    def run(P):
        t = [0.0]

        def clock():
            t[0] += 1.0
            return t[0]
        svc = quiet(P, result_ttl_s=5.0, clock=clock)
        req = P.req(_doc(0), seq=999)
        svc._fail_requests(P.service.request_class(req), [req],
                           RuntimeError("x"))
        rids = [svc.submit(_doc(i + 1))["request_id"] for i in range(8)]
        return (svc.result("r000999"), [svc.result(r) for r in rids],
                det_totals(svc))
    gone, queued, _ = same(run)
    assert gone is None and all(r["status"] == "queued" for r in queued)


# -------------------------------------------- real engine (PHOLD 8 hosts)

# one packed launch of four requests: three plain lanes with two stops,
# one crash-faulted, latency-scaled lane (a class of its own)
REAL_DOCS = [_doc(901), _doc(902, stop_s=0.35), _doc(903),
             _doc(904, stop_s=0.4, faults=[CRASH], lat=1.5)]


@pytest.fixture(scope="module")
def ref_solo():
    """The reference's solo_reference of every REAL_DOCS request (four
    reference programs)."""
    return [REF.service.solo_reference(d) for d in REAL_DOCS]


def test_real_engine_served_summaries_equal_reference_solo(ref_solo):
    """The port's fleet serves the plain class packed three lanes wide
    (one inert pad lane) and the faulted class one lane wide (three pad
    lanes); every summary equals the reference's solo run, and the
    port's own oracle agrees."""
    svc = PORT.SimService(max_lanes=4, pack_deadline_ms=100.0,
                          beat_windows=4).start()
    try:
        rids = [svc.submit(d)["request_id"] for d in REAL_DOCS]
        recs = wait_done(svc, rids)
    finally:
        svc.drain()
    for rid, want in zip(rids, ref_solo):
        assert recs[rid]["status"] == "done", recs[rid]
        assert recs[rid]["summary"] == want
    assert [recs[r]["lanes_packed"] for r in rids] == [3, 3, 3, 1]
    assert len({recs[r]["class"] for r in rids}) == 2
    assert PORT.service.solo_reference(REAL_DOCS[3], device="cpu") \
        == ref_solo[3]


def test_snapshot_resume_real_engine_bit_identical(tmp_path, ref_solo):
    """A chaos-injected launch failure retries from the beat snapshot
    (the fleet state through checkpoint leaves and `adopt_state`), and
    every request still equals the reference's solo run."""
    docs = REAL_DOCS[:3]
    svc = PORT.SimService(max_lanes=4, pack_deadline_ms=30.0,
                          beat_windows=2, snapshot_beats=1,
                          snapshot_path=str(tmp_path / "snap.npz"),
                          launch_retries=1, launch_backoff_s=0.0,
                          chaos=PORT.chaos.ServeChaos("raise:beat=3")
                          ).start()
    try:
        rids = [svc.submit(d)["request_id"] for d in docs]
        recs = wait_done(svc, rids)
    finally:
        svc.drain()
    assert PORT.tot(svc, "serve_resumes") == 1
    for rid, want in zip(rids, ref_solo):
        rec = recs[rid]
        assert rec["status"] == "done", rec
        assert rec["summary"] == want
        assert 0 < rec["resumed_from_beat"] < rec["beats"]


def test_real_snapshot_resumes_across_packages(tmp_path, ref_solo):
    """A real fleet's beat snapshot written by either package resumes in
    the other to the reference's solo summaries."""
    docs = REAL_DOCS[:3]
    for W, R in ((PORT, REF), (REF, PORT)):
        snap = str(tmp_path / f"{W}.snap.npz")
        svc = W.SimService(max_lanes=4, beat_windows=2, snapshot_beats=1,
                           snapshot_path=snap)
        reqs = [W.req(d, seq=i) for i, d in enumerate(docs)]
        key = W.service.request_class(reqs[0])
        entry = svc._build_entry(key, reqs[0])
        st, binds = entry.fleet.make_inputs(svc._batch_plan(key, reqs, 4))
        stops = np.asarray([r.stop_ns for r in reqs] + [0], np.int64)
        for _ in range(2 * 2):
            st = entry.fleet.step_window(st, stops, binds=binds)
        svc._write_snapshot(key, reqs, st, 2, stops)
        svc2 = R.SimService(max_lanes=4, pack_deadline_ms=30.0,
                            beat_windows=2, snapshot_beats=1,
                            snapshot_path=snap)
        assert svc2.resume_pending_batch() == 3
        svc2.start()
        try:
            recs = wait_done(svc2, [r.rid for r in reqs])
        finally:
            svc2.drain()
        for r, want in zip(reqs, ref_solo):
            assert recs[r.rid]["status"] == "done", (W, recs[r.rid])
            assert recs[r.rid]["summary"] == want, (W, R)
            assert recs[r.rid]["resumed_from_beat"] == 2
        assert not os.path.exists(snap)


# ---------------------------------------------------------- the CLI


def test_serve_cli_drains_on_sigterm(tmp_path):
    """`serve` as a subprocess on the CPU (the CLI's `main` with the CPU
    device): one request over HTTP, SIGTERM, exit 0 with the pending
    request persisted to the queue file."""
    qf = tmp_path / "q.json"
    code = ("import sys\nfrom shadow_tpu_torch.cli import main\n"
            "sys.exit(main(sys.argv[1:], device='cpu'))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-c", code, "serve", "--port", "0",
         "--max-lanes", "2", "--pack-deadline-ms", "3600000",
         "--queue-file", str(qf)], cwd=tmp_path, env=env,
        stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stderr.readline()
        assert "serve: listening http://127.0.0.1:" in line, line
        url = line.split()[2].rsplit("/", 1)[0]
        req = urllib.request.Request(url + "/submit",
                                     data=json.dumps(_doc(3)).encode())
        with urllib.request.urlopen(req, timeout=30) as r:
            assert json.loads(r.read())["request_id"] == "r000000"
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
    err = proc.stderr.read()
    assert "drained — 1 pending request(s) persisted" in err
    pending = json.loads(qf.read_text())["pending"]
    assert pending == [REF.req(_doc(3)).doc()]


# --------------------------------------------------------- phase 23 pins


@pytest.mark.slow
def test_phase23_pins():
    """chip_smoke.py phase 23's pins: the reference's solo run of each
    served request at the bench shape (TGen 2,048 pairs), on the CPU."""
    import chip_smoke

    got = tuple(REF.service.solo_reference(d)
                for d in chip_smoke.serve_docs())
    assert got == chip_smoke.PIN_SERVE
