"""Serve-plane tracing in the port, held on the CPU against the reference
(`tests/test_serve_trace.py`'s cases, on the injected fake fleet of
`test_torch_serve`, nothing compiled).

- span trees: the happy path, a chaos-injected retry that resumes, a
  bisection and a deadline timeout leave the same records, in the same
  order, under both packages (wall times aside), and tile `wall_ms`;
- the flight ledger: both packages' ledgers of one request stream have
  the same skeleton; a torn tail is tolerated; `diff_runs` reads it;
- the tools on one ledger give the reference tools' output byte for
  byte: `serve_report`, `export_trace --serve-ledger` (pids 2-3) and
  `serve_client`'s class decomposition; `diff_runs`' report of a served
  record against a solo summary too;
- tracer off leaves /metrics and the records untouched; /trace serves a
  tree or 404s; per-class histograms render with exemplars, equal to
  the reference's exposition.
"""

import io
import json
import os
import time
import urllib.error
import urllib.request
from contextlib import redirect_stderr, redirect_stdout

import pytest

from test_torch_phold import one_torch_thread  # noqa: F401 (autouse)
from test_torch_serve import (
    BOTH,
    PORT,
    REF,
    _doc,
    fake_factory,
    quiet,
    same,
    wait_done,
)

SEEDS = (11, 12, 13, 14)


def traced(P, ledger=None, *, lanes=4, tracer_kw=None, **kw):
    tracer = P.servetrace.ServeTracer(ledger_file=ledger,
                                      **(tracer_kw or {}))
    kw.setdefault("max_lanes", lanes)
    kw.setdefault("pack_deadline_ms", 30.0)
    kw.setdefault("beat_windows", 2)
    svc = P.SimService(fleet_factory=fake_factory(P, lanes), tracer=tracer,
                       **kw)
    return svc, tracer


def run_traced(P, docs, ledger=None, **kw):
    """Serve `docs` under a tracer: (service, tracer, rids, records)."""
    svc, tracer = traced(P, ledger, **kw)
    svc.start()
    try:
        rids = [svc.submit(d)["request_id"] for d in docs]
        recs = wait_done(svc, rids)
    finally:
        svc.drain()
        tracer.close()
    return svc, tracer, rids, recs


_WALL = ("t_s", "dur_s", "fetch_s", "wall_ms", "backoff_s")


def skeleton(recs):
    """The deterministic part of span records: everything but wall time."""
    return [{k: v for k, v in r.items() if k not in _WALL} for r in recs]


def tree_skeleton(tree):
    return {"request_id": tree["request_id"], "class": tree["class"],
            "spans": skeleton(tree["spans"]),
            "launches": [{"launch": n["launch"],
                          "spans": skeleton(n["spans"])}
                         for n in tree["launches"]]}


def tiles(d):
    accounted = (d["queue_wait_ms"] + d["pack_wait_ms"] + d["run_ms"]
                 + d["retry_ms"])
    return accounted <= d["total_ms"] + 5.0 and \
        accounted >= 0.5 * d["total_ms"] - 5.0


# ------------------------------------------------- span-tree completeness


def test_span_tree_happy_path_tiles_wall_time():
    def run(P):
        svc, _, rids, _ = run_traced(P, [_doc(s) for s in SEEDS])
        trees = [svc.trace(r) for r in rids]
        for t in trees:
            assert tiles(P.servetrace.decompose(t)), t
        return [tree_skeleton(t) for t in trees]
    trees = same(run)
    names = [s["name"] for s in trees[0]["spans"]]
    for required in ("submit", "queue_wait", "pack_wait", "result"):
        assert required in names
    beats = [s for s in trees[0]["launches"][0]["spans"]
             if s["name"] == "beat"]
    assert beats[-1]["lanes"][0]["now_ns"] == 500_000_000


def test_span_tree_retry_resume_still_tiles(tmp_path):
    def run(P):
        snap = str(tmp_path / f"{P}.snap.npz")
        svc, tracer, rids, recs = run_traced(
            P, [_doc(s) for s in SEEDS], snapshot_beats=2,
            snapshot_path=snap, launch_retries=1, launch_backoff_s=0.05,
            chaos=P.chaos.ServeChaos("raise:beat=3"))
        out = []
        for rid in rids:
            tree = svc.trace(rid)
            d = P.servetrace.decompose(tree)
            assert d["retry_ms"] >= 50.0 and tiles(d), d
            out.append(tree_skeleton(tree))
        return out, [r["name"] for r in skeleton(tracer.recent())]
    trees, recent = same(run)
    spans = trees[0]["spans"]
    retry = next(s for s in spans if s["name"] == "retry")
    assert retry["attempt"] == 1 and len(trees[0]["launches"]) == 2
    assert "chaos" in recent


def test_bisection_and_error_events_in_tree():
    def run(P):
        svc, _, rids, _ = run_traced(
            P, [_doc(s) for s in SEEDS], launch_retries=0,
            launch_backoff_s=0.0,
            chaos=P.chaos.ServeChaos("poison:seed=13"))
        return [tree_skeleton(svc.trace(r)) for r in rids]
    trees = same(run)
    bisects = [s for s in trees[2]["spans"] if s["name"] == "bisect"]
    assert [b["size"] for b in bisects] == [4, 2]


def test_deadline_timeout_event_in_tree():
    def run(P):
        svc, _, rids, recs = run_traced(
            P, [_doc(1, stop_s=0.5), {**_doc(2, stop_s=600.0),
                                      "deadline_ms": 150}],
            lanes=2, pack_deadline_ms=1.0)
        tree = svc.trace(rids[1])
        ddl = [s for s in tree["spans"] if s["name"] == "deadline_exceeded"]
        result = next(s for s in tree["spans"] if s["name"] == "result")
        # how many beats ran before the wall deadline is wall time
        return (recs[rids[1]]["status"], len(ddl), ddl[0]["deadline_ms"],
                result["status"])
    assert same(run) == ("timeout", 1, 150, "timeout")


# --------------------------------------------------------- flight ledger


@pytest.fixture(scope="module")
def ledgers(tmp_path_factory):
    """One traced request stream with a retry, a resume and a snapshot,
    run by each package: {pkg: (header, records, path)}."""
    d = tmp_path_factory.mktemp("ledgers")
    out = {}
    for P in BOTH:
        path = str(d / f"{P}.jsonl")
        run_traced(P, [_doc(s) for s in SEEDS], ledger=path,
                   snapshot_beats=2, snapshot_path=str(d / f"{P}.npz"),
                   launch_retries=1, launch_backoff_s=0.05,
                   chaos=P.chaos.ServeChaos("raise:beat=3"))
        header, records = P.servetrace.load_ledger(path)
        out[P] = (header, records, path)
    return out


def test_ledger_replay_sim_keys_identical(ledgers):
    (ha, ra, pa), (hb, rb, pb) = ledgers[REF], ledgers[PORT]
    assert ha == hb and ha["ledger_version"] == 1
    assert skeleton(ra) == skeleton(rb)
    D = PORT.diff_runs
    kind, recs = D.load_artifact(pb)
    assert kind == D.LEDGER_T and len(recs) == len(rb)
    assert D.diff_files(pb, pb, rtol=0.0) == []
    drift = same(lambda P: P.diff_runs.diff_files(pa, pb, rtol=1e9))
    assert [e for e in drift if "now_ns" in e["key"]] == []


def test_ledger_tolerates_torn_tail(ledgers, tmp_path):
    src = ledgers[PORT][2]
    path = tmp_path / "torn.jsonl"
    path.write_text(open(src).read()
                    + '{"kind": "span", "name": "trunc')
    got = same(lambda P: P.servetrace.load_ledger(str(path)))
    assert len(got[1]) == len(ledgers[PORT][1])


def _main_out(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("writer", BOTH, ids=str)
def test_serve_report_reduces_ledger(ledgers, writer):
    """Both packages' serve_report on one ledger: the same report, byte
    for byte, with the reference's expectations met."""
    header, records, path = ledgers[writer]
    report = same(lambda P: P.serve_report.reduce_ledger(header, records))
    assert report["requests"] == 4 and report["launches"] == 2
    assert report["retries"] == 1 and report["chaos_injections"] == 1
    assert report["pack_efficiency"] == 1.0
    assert report["cache_hit_ratio"] == 0.5
    out = same(lambda P: _main_out(P.serve_report.main, [path]))
    assert out[0] == 0 and json.loads(out[1]) == json.loads(
        json.dumps(report, sort_keys=True))


def test_merged_export_valid_and_deterministic(ledgers, tmp_path):
    """export_trace --serve-ledger of one ledger: the reference's file
    byte for byte, pids 2 and 3 with beat->lane flows."""
    ledger = ledgers[PORT][2]
    outs = {}
    for P in BOTH:
        out = tmp_path / f"{P}.json"
        rc, _, _ = _main_out(P.export_trace.main,
                             ["--serve-ledger", ledger, "-o", str(out)])
        assert rc == 0
        outs[P] = out.read_bytes()
    assert outs[REF] == outs[PORT]
    doc = json.loads(outs[PORT])
    evs = doc["traceEvents"]
    assert {2, 3} <= {e["pid"] for e in evs}
    starts = [e for e in evs if e["ph"] == "s"]
    assert len(starts) == len([e for e in evs if e["ph"] == "f"]) > 0
    assert doc["otherData"]["serve_ledger"] == ledger
    stats = PORT.export_trace.export(None, str(tmp_path / "again.json"),
                                     ledger_path=ledger)
    assert stats["serve_records"] == len(ledgers[PORT][1])
    assert (tmp_path / "again.json").read_bytes() == outs[PORT]


def test_export_cli_requires_an_input(capsys):
    for P in BOTH:
        with pytest.raises(SystemExit):
            P.export_trace.main([])


def test_serve_client_class_decomposition_matches_reference(ledgers):
    """serve_client's per-class decomposition of the same span trees,
    and its request stream, equal the reference tool's."""
    _, records, _ = ledgers[PORT]
    trees = REF.serve_report.trees_from_ledger(records)
    assert same(lambda P: P.serve_report.trees_from_ledger(records)) \
        == trees
    assert same(lambda P: P.serve_client._class_decomposition(trees))
    assert same(lambda P: _main_out(P.serve_client.main,
                                    ["--print-docs", "--requests", "6"]))


def test_diff_runs_report_on_served_record_matches_reference(tmp_path):
    summary = {"now_ns": 500_000_000, "windows": 10, "executed": 160,
               "sweeps": 40, "queue_drops": 0}
    a, b = tmp_path / "served.json", tmp_path / "solo.json"
    a.write_text(json.dumps({"request_id": "r000001", "status": "done",
                             "summary": dict(summary, executed=161),
                             "wall_ms": 3.5}))
    b.write_text(json.dumps(summary))
    for argv in ([str(a), str(b)], [str(a), str(b), "--json"]):
        rc, out, _ = same(lambda P: _main_out(P.diff_runs.main, argv))
        assert rc == 1 and "executed" in out


# ------------------------------------------------------- zero-change off


def test_tracer_off_surface_unchanged():
    def run(P):
        svc = P.SimService(max_lanes=4, pack_deadline_ms=30.0,
                           beat_windows=2,
                           fleet_factory=fake_factory(P, 4)).start()
        try:
            rids = [svc.submit(_doc(s))["request_id"] for s in SEEDS]
            recs = wait_done(svc, rids)
        finally:
            svc.drain()
        scrape = svc.metrics.render()
        assert svc.tracer is None and svc.trace(rids[0]) is None
        assert " # {" not in scrape and "serve_queue_wait_ns" not in scrape
        return (P.metrics.validate_openmetrics(scrape),
                sorted(recs[rids[0]]))
    assert same(run)[0] == []


def test_trace_http_endpoint_on_off():
    def get(port, path):
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}{path}", timeout=5) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def run(P):
        out = []
        svc = quiet(P).start()
        srv = P.http.ServeServer(svc, _stream=open(os.devnull, "w")).start()
        try:
            out.append(get(srv.port, "/trace/r000000"))
        finally:
            srv.close()
            svc.drain()
        svc2, _ = traced(P)
        svc2.start()
        srv2 = P.http.ServeServer(svc2,
                                  _stream=open(os.devnull, "w")).start()
        try:
            rids = [svc2.submit(_doc(s))["request_id"] for s in SEEDS]
            wait_done(svc2, rids)
            code, tree = get(srv2.port, f"/trace/{rids[0]}")
            out.append((code, tree_skeleton(tree)))
            out.append(get(srv2.port, "/trace/nope"))
            out.append(get(srv2.port, "/queue"))
        finally:
            srv2.close()
            svc2.drain()
        return out
    out = same(run)
    assert out[0][0] == 404 and "--trace-requests" in out[0][1]["error"]
    assert out[1][0] == 200 and out[2][0] == 404


def test_trace_retention_tracks_result_eviction():
    def run(P):
        svc, _ = traced(P, max_results=2)
        svc.start()
        try:
            rids = [svc.submit(_doc(s))["request_id"] for s in SEEDS]
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                recs = {r: svc.result(r) for r in rids}
                if sum(x is None for x in recs.values()) == 2 and all(
                        x["status"] == "done" for x in recs.values()
                        if x is not None):
                    break
                time.sleep(0.02)
            evicted = [r for r in rids if svc.result(r) is None]
            assert all(svc.trace(r) is None for r in evicted)
            assert all(svc.trace(r) is not None
                       for r in rids if r not in evicted)
            return len(evicted)
        finally:
            svc.drain()
    assert same(run) == 2


def test_queue_snapshot_per_class_depth_and_age():
    def run(P):
        svc = quiet(P).start()
        try:
            svc.submit(_doc(1))
            svc.submit(_doc(2))
            svc.submit(_doc(3, faults=["crash hosts=host1 start=0.2 "
                                       "end=0.3"]))
            snap = svc.queue_snapshot()
        finally:
            svc.drain()
        classes = snap["packer"]["classes"]
        assert all(c["oldest_wait_s"] >= 0.0 for c in classes.values())
        return {k: c["depth"] for k, c in classes.items()}, snap["cache"]
    depths, _ = same(run)
    assert sorted(depths.values()) == [1, 2]


# ------------------------------------- per-class histograms + exemplars


def test_per_class_histograms_render_with_exemplars():
    def run(P):
        m = P.metrics.ServeMetrics()
        m.observe_class("queue_wait", "clsA", 1_000_000, rid="r000001",
                        t_s=0.5)
        m.observe_class("queue_wait", "clsA", 2_000_000, rid="r000007",
                        t_s=0.9)
        m.observe_class("beat_wall", "clsB", 5_000_000, rid="r000002",
                        t_s=1.0)
        with pytest.raises(ValueError):
            m.observe_class("nope", "clsA", 1)
        scrape = m.render()
        return scrape, m.totals(), P.metrics.validate_openmetrics(scrape)
    scrape, tot, probs = same(run)
    assert probs == []
    assert '# {trace_id="r000001"} 1000000 0.5' in scrape
    assert tot['shadow_tpu_serve_queue_wait_ns_sum{class="clsA"}'] \
        == 3_000_000


def test_traced_service_metrics_carry_class_histograms(ledgers):
    """A traced run feeds the per-class histograms; their counts (not
    their wall values) equal the reference's."""
    def run(P):
        svc, _, _, _ = run_traced(P, [_doc(s) for s in SEEDS])
        return {k: v for k, v in svc.metrics.totals().items()
                if "_count" in k}
    counts = same(run)
    assert any("serve_beat_wall_ns_count" in k for k in counts)


def test_validator_rejects_malformed_exemplars():
    bad_placement = ("# TYPE g gauge\n"
                     'g 1 # {trace_id="r1"} 5\n'
                     "# EOF\n")
    bad_syntax = ("# TYPE h histogram\n"
                  'h_bucket{le="+Inf"} 1 # trace_id=r1\n'
                  "h_count 1\nh_sum 5\n"
                  "# EOF\n")
    for text in (bad_placement, bad_syntax):
        probs = same(lambda P: P.metrics.validate_openmetrics(text))
        assert any("exemplar" in p for p in probs)


def test_check_openmetrics_cli_accepts_exemplars(tmp_path):
    m = PORT.metrics.ServeMetrics()
    m.observe_class("pack_wait", "c", 123_456, rid="r000003", t_s=0.1)
    path = tmp_path / "scrape.txt"
    path.write_text(m.render())
    rc, _, err = same(lambda P: _main_out(P.check_openmetrics.main,
                                          [str(path)]))
    assert rc == 0 and "ok:" in err


def test_decompose_unit():
    tree = {
        "request_id": "r1", "class": "c",
        "spans": [
            {"kind": "span", "name": "queue_wait", "t_s": 0.0,
             "dur_s": 0.010, "rid": "r1"},
            {"kind": "span", "name": "pack_wait", "t_s": 0.010,
             "dur_s": 0.005, "rid": "r1"},
            {"kind": "span", "name": "retry", "t_s": 0.1, "dur_s": 0.05,
             "rids": ["r1", "r2"]},
            {"kind": "event", "name": "result", "t_s": 0.2, "dur_s": 0.0,
             "rid": "r1", "status": "done", "wall_ms": 200.0},
        ],
        "launches": [{"launch": 0, "spans": [
            {"kind": "span", "name": "beat", "t_s": 0.02, "dur_s": 0.03,
             "launch": 0, "lanes": [{"lane": 0, "rid": "r1",
                                     "now_ns": 100}]},
            {"kind": "span", "name": "beat", "t_s": 0.05, "dur_s": 0.03,
             "launch": 0, "lanes": [{"lane": 0, "rid": "OTHER",
                                     "now_ns": 100}]},
            {"kind": "span", "name": "confirm", "t_s": 0.08,
             "dur_s": 0.002, "launch": 0, "rids": ["r1"]},
        ]}],
    }
    assert same(lambda P: P.servetrace.decompose(tree)) == {
        "queue_wait_ms": 10.0, "pack_wait_ms": 5.0, "run_ms": 32.0,
        "retry_ms": 50.0, "beats": 1, "total_ms": 200.0,
        "status": "done"}
