"""The host-side tools a CLI user runs on a run's output
(`shadow_tpu_torch/tools/`), each against the reference's tool on the same
input, on the CPU.

The input is one port CLI run (PHOLD over UDP at 16 hosts with
`heartbeatloginfo="node,socket,ram"`, `--metrics`, `--stats`, a scrape
of its registry): `parse_shadow` writes the reference's stats JSON from
its log, `plot_shadow` draws the reference's series from it (skipped
without matplotlib; the series are compared, not the PNG bytes),
`check_openmetrics` and `diff_runs` print the reference's verdicts and
exit codes on the scrape, the summary, the log and altered copies (the
port refuses a serve ledger, not ported), `convert_config` writes the
reference's canonical XML from a legacy config, `generate_config` the
reference's files for every kind, and `generate_topology` the
reference's GraphML byte for byte for each seed.
"""

import contextlib
import io
import json
import sys

import pytest

from shadow_tpu.tools import check_openmetrics as j_check
from shadow_tpu.tools import convert_config as j_convert
from shadow_tpu.tools import diff_runs as j_diff
from shadow_tpu.tools import generate_config as j_genconf
from shadow_tpu.tools import generate_topology as j_gentopo
from shadow_tpu.tools import parse_shadow as j_parse
from shadow_tpu.tools import plot_shadow as j_plot
from shadow_tpu_torch import cli as tcli
from shadow_tpu_torch import examples as texamples
from shadow_tpu_torch.obs import metrics as tmetrics
from shadow_tpu_torch.tools import check_openmetrics as t_check
from shadow_tpu_torch.tools import convert_config as t_convert
from shadow_tpu_torch.tools import diff_runs as t_diff
from shadow_tpu_torch.tools import generate_config as t_genconf
from shadow_tpu_torch.tools import generate_topology as t_gentopo
from shadow_tpu_torch.tools import parse_shadow as t_parse
from shadow_tpu_torch.tools import plot_shadow as t_plot
from test_torch_cli import in_dir, one_thread

CONFIG = texamples.phold_example(16, 3, stoptime=2).replace(
    '<host id="peer"', '<host id="peer" heartbeatloginfo="node,socket,ram"')


def call(main, argv, stdin: str | None = None):
    """(exit code, stdout, stderr) of a tool's main."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        if stdin is not None:
            old, sys.stdin = sys.stdin, io.StringIO(stdin)
            try:
                rc = main(argv)
            finally:
                sys.stdin = old
        else:
            rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One port CLI run: its log, summary and a scrape, as files."""
    d = tmp_path_factory.mktemp("tools")
    (d / "phold.xml").write_text(CONFIG)
    out = io.StringIO()
    scrape = {}
    finalize = tmetrics.MetricsRegistry.finalize

    def keep_scrape(self, summary):
        finalize(self, summary)
        scrape["text"] = self.render()

    tmetrics.MetricsRegistry.finalize = keep_scrape
    try:
        with in_dir(d), one_thread(), contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(io.StringIO()):
            rc = tcli.main(["phold.xml", "--seed", "3",
                            "--heartbeat-frequency", "0.5", "--metrics",
                            "--stats"], device="cpu")
    finally:
        tmetrics.MetricsRegistry.finalize = finalize
    assert rc == 0
    log = out.getvalue()
    (d / "shadow.log").write_text(log)
    summary = [ln for ln in log.splitlines() if ln.startswith("{")][-1]
    (d / "summary.json").write_text(summary + "\n")
    (d / "scrape.txt").write_text(scrape["text"])
    return d


def test_parse_shadow_matches_reference(run):
    outs = {}
    for pkg, mod in (("jax", j_parse), ("torch", t_parse)):
        o = run / f"parsed_{pkg}"
        o.mkdir()
        rc, stdout, _ = call(mod.main, [str(run / "shadow.log"), "-o",
                                        str(o)])
        outs[pkg] = (rc, stdout.replace(str(o), "OUT"),
                     (o / "stats.shadow_tpu.json").read_bytes())
    assert outs["torch"] == outs["jax"]
    stats = json.loads(outs["torch"][2])
    assert len(stats["nodes"]) == 16
    # stdin gives the same document
    (run / "stdin").mkdir()
    rc, _, _ = call(t_parse.main, ["-", "-o", str(run / "stdin")],
                    stdin=(run / "shadow.log").read_text())
    assert rc == 0
    assert (run / "stdin" / "stats.shadow_tpu.json").read_bytes() == \
        outs["torch"][2]


def drawn(monkeypatch) -> list:
    """Record, per saved figure, each axes' title, line data and bar
    rectangles (the series a plot draws)."""
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib.figure import Figure

    seen = []

    def savefig(fig, path, **kw):
        seen.append([
            (ax.get_title(),
             [line.get_xydata().tolist() for line in ax.get_lines()],
             [(p.get_x(), p.get_y(), p.get_width(), p.get_height())
              for p in ax.patches if hasattr(p, "get_width")])
            for ax in fig.axes])

    monkeypatch.setattr(Figure, "savefig", savefig)
    return seen


def test_plot_shadow_draws_the_reference_series(run, monkeypatch):
    pytest.importorskip("matplotlib")
    seen = drawn(monkeypatch)
    o = run / "parsed_plot"
    o.mkdir()
    call(t_parse.main, [str(run / "shadow.log"), "-o", str(o)])
    stats = json.loads((o / "stats.shadow_tpu.json").read_text())
    got = {}
    for pkg, mod in (("jax", j_plot), ("torch", t_plot)):
        seen.clear()
        names = mod.make_figures(stats, str(run))
        got[pkg] = ([n.rsplit("/", 1)[1] for n in names], list(seen))
    assert got["torch"] == got["jax"]
    assert len(got["torch"][0]) >= 4
    assert any(lines for fig in got["torch"][1] for _, lines, _ in fig)


def test_check_openmetrics_matches_reference(run):
    good = (run / "scrape.txt").read_text()
    bad = good.replace("# EOF", "").replace(
        "_bucket{le=\"+Inf\"}", "_bucket{le=\"inf\"}", 1)
    (run / "bad.txt").write_text(bad + "broken line here\n")
    for name, stdin in (("scrape.txt", None), ("bad.txt", None),
                        ("-", good), ("-", bad)):
        argv = [name if name == "-" else str(run / name)]
        got = {pkg: call(mod.main, argv, stdin=stdin)
               for pkg, mod in (("jax", j_check), ("torch", t_check))}
        assert got["torch"] == got["jax"], name
    assert call(t_check.main, [str(run / "scrape.txt")])[0] == 0
    assert call(t_check.main, [str(run / "bad.txt")])[0] == 1


def test_diff_runs_matches_reference(run):
    summary = json.loads((run / "summary.json").read_text())
    drift = dict(summary, events=summary["events"] + 1,
                 wall_seconds=summary["wall_seconds"] * 1.01)
    (run / "drift.json").write_text(json.dumps(drift))
    scrape = (run / "scrape.txt").read_text()
    (run / "drift.txt").write_text(scrape.replace(
        "shadow_tpu_events_total ", "shadow_tpu_events_total 1", 1))
    log = (run / "shadow.log").read_text()
    (run / "a").mkdir()
    (run / "b").mkdir()
    for d in ("a", "b"):
        (run / d / "summary.json").write_text(json.dumps(summary))
    (run / "b" / "summary.json").write_text(json.dumps(drift))
    cases = [
        [str(run / "summary.json"), str(run / "summary.json")],
        [str(run / "summary.json"), str(run / "drift.json")],
        [str(run / "summary.json"), str(run / "drift.json"), "--rtol",
         "0.5", "--json"],
        [str(run / "scrape.txt"), str(run / "drift.txt")],
        [str(run / "shadow.log"), str(run / "shadow.log")],
        [str(run / "a"), str(run / "b")],
    ]
    for argv in cases:
        got = {pkg: call(mod.main, argv)
               for pkg, mod in (("jax", j_diff), ("torch", t_diff))}
        assert got["torch"] == got["jax"], argv
    assert call(t_diff.main, cases[0])[0] == 0
    assert call(t_diff.main, cases[1])[0] == 1
    assert "[shadow-heartbeat]" in log
    # a serve flight ledger (its own kind) diffs as the reference's does
    rec = {"kind": "span", "name": "beat", "t_s": 0.5, "dur_s": 0.25,
           "launch": 1, "lanes": [{"lane": 0, "rid": "r000000",
                                   "now_ns": 400}]}
    for name, now in (("ledger.jsonl", 400), ("ledger2.jsonl", 500)):
        lanes = [dict(rec["lanes"][0], now_ns=now)]
        (run / name).write_text('{"ledger_version": 1, "plane": "serve"}\n'
                                + json.dumps(dict(rec, lanes=lanes)) + "\n")
    ledgers = [str(run / "ledger.jsonl"), str(run / "ledger2.jsonl")]
    assert t_diff.load_artifact(ledgers[0]) == \
        j_diff.load_artifact(ledgers[0])
    for argv in (ledgers, ledgers + ["--json"], ledgers[:1] * 2):
        got = {pkg: call(mod.main, argv)
               for pkg, mod in (("jax", j_diff), ("torch", t_diff))}
        assert got["torch"] == got["jax"], argv
    assert call(t_diff.main, ledgers)[0] == 1


LEGACY = """<shadow stoptime="30">
  <topology><![CDATA[<graphml xmlns="http://graphml.graphdrawing.org/xmlns">
  <key attr.name="latency" attr.type="double" for="edge" id="d0" />
  <key attr.name="bandwidthup" attr.type="int" for="node" id="d1" />
  <key attr.name="bandwidthdown" attr.type="int" for="node" id="d2" />
  <graph edgedefault="undirected">
    <node id="p"><data key="d1">1024</data><data key="d2">1024</data></node>
    <edge source="p" target="p"><data key="d0">10.0</data></edge>
  </graph></graphml>]]></topology>
  <plugin id="tgen" path="tgen"/>
  <host id="s" quantity="2" bandwidthup="2048" logpcap="true">
    <application plugin="tgen" time="1" arguments="server port=80"/>
  </host>
  <node id="c"><application plugin="tgen" time="2"
    arguments="peers=s1:80 sendsize=1KiB recvsize=1KiB count=1"/></node>
  <kill time="20"/>
</shadow>"""


def test_convert_config_matches_reference(tmp_path):
    assert t_convert.convert(LEGACY) == j_convert.convert(LEGACY)
    (tmp_path / "old.xml").write_text(LEGACY)
    outs = {}
    for pkg, mod in (("jax", j_convert), ("torch", t_convert)):
        new = tmp_path / f"new_{pkg}.xml"
        rc, stdout, _ = call(mod.main, [str(tmp_path / "old.xml"), str(new)])
        outs[pkg] = (rc, stdout.replace(pkg, "PKG"), new.read_bytes())
    assert outs["torch"] == outs["jax"]
    assert b"<process plugin" in outs["torch"][2]


@pytest.mark.parametrize("argv", [
    ["tgen"], ["tor", "--clients", "6", "--stoptime", "9"],
    ["bitcoin", "--hosts", "10"], ["phold", "--hosts", "24"]],
    ids=["tgen", "tor", "bitcoin", "phold"])
def test_generate_config_matches_reference(argv, tmp_path):
    assert call(j_genconf.main, argv + ["-o", str(tmp_path / "j")])[0] == 0
    assert call(t_genconf.main, argv + ["-o", str(tmp_path / "t")])[0] == 0
    files = {d: {p.name: p.read_bytes() for p in (tmp_path / d).iterdir()}
             for d in ("j", "t")}
    assert files["t"] == files["j"] and files["t"]


@pytest.mark.parametrize("seed,pois", [(0, 60), (7, 12), (12345, 200)])
def test_generate_topology_is_byte_equal(seed, pois, tmp_path):
    assert t_gentopo.generate(pois, seed=seed) == \
        j_gentopo.generate(pois, seed=seed)
    outs = {}
    for pkg, mod in (("jax", j_gentopo), ("torch", t_gentopo)):
        path = tmp_path / f"{pkg}.graphml.xml"
        rc, _, _ = call(mod.main, ["--pois", str(pois), "--seed", str(seed),
                                   "-o", str(path)])
        outs[pkg] = (rc, path.read_bytes())
    assert outs["torch"] == outs["jax"]
