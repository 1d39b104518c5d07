"""Run-to-run drift report over shadow_tpu_torch runtime artifacts
(the port's copy of `shadow_tpu.tools.diff_runs`).

The lint CLI's `--diff` compares two *static-analysis* reports; this
tool extends the precedent to what a run actually produced: the
end-of-run summary JSON, an OpenMetrics `/metrics` scrape, a heartbeat
log's cumulative `[stats]`/`[metrics]` rows, and the BENCH_r*.json
harness artifacts. Point it at two files — or two directories, where
every like-named artifact present in both is compared — and it prints
one drift line per diverging key, with a numeric tolerance for the
wall-clock-contaminated fields.

Exit status is the contract: 0 when nothing drifted (a run diffed
against itself MUST report zero), 1 when any key diverged, 2 on usage
errors. Determinism regressions, histogram drift after a "harmless"
refactor, and cross-machine BENCH comparisons all reduce to this one
command:

    python -m shadow_tpu_torch.tools.diff_runs a/summary.json b/summary.json
    python -m shadow_tpu_torch.tools.diff_runs runA/ runB/ --rtol 0.05
    python -m shadow_tpu_torch.tools.diff_runs a.metrics b.metrics --json
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any

# artifact type tags
JSON_T, OPENMETRICS_T, HEARTBEAT_T = "json", "openmetrics", "heartbeat"
# a served-result record (serve plane, docs/17-Serving.md): JSON with a
# request_id key wrapping the sim summary — loaded as the EMBEDDED
# summary so it diffs directly against a solo-run summary with sim keys
# exact (the serving bit-identity gate)
SERVED_T = "served"
# a serve flight ledger (docs/18-Serve-Tracing.md): JSONL whose header
# line carries ledger_version — loaded as the record list, so two
# replayed request streams diff span-for-span with sim keys (now_ns)
# exact and wall keys (t_s/dur_s/wall_ms) under --rtol
LEDGER_T = "ledger"

# numeric keys that are wall-clock (not sim) quantities: always
# compared with the tolerance, never exactly, because two bit-identical
# runs still disagree on them
_WALL_HINTS = ("wall", "seconds", "_s", "per_sec", "rate", "margin")


def classify(path: str, text: str) -> str:
    """Sniff an artifact's type from its content (extension is a hint
    only: BENCH artifacts are .json, scrapes are often .txt)."""
    stripped = text.lstrip()
    # heartbeat first: a log can OPEN with a `[shadow-heartbeat]` row
    # (e.g. a fleet run's header line), which the JSON sniff's leading
    # "[" would otherwise claim
    if "[shadow-heartbeat]" in text:
        return HEARTBEAT_T
    first = stripped.split("\n", 1)[0]
    if first.startswith("{") and '"ledger_version"' in first:
        return LEDGER_T
    if stripped.startswith("{") or stripped.startswith("["):
        if stripped.startswith("{") and '"request_id"' in text:
            return SERVED_T
        return JSON_T
    if "# EOF" in text or stripped.startswith("# TYPE"):
        return OPENMETRICS_T
    raise ValueError(f"{path}: unrecognized artifact "
                     "(not JSON / OpenMetrics / heartbeat log)")


def load_openmetrics(text: str) -> dict:
    """Flatten an exposition into {sample-left-hand-side: value}."""
    out: dict[str, float] = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        left, _, value = line.rpartition(" ")
        try:
            out[left] = float(value)
        except ValueError:
            out[left] = value
    return out


def load_heartbeat(text: str) -> dict:
    """The LAST row of every `[section]` whose header was also logged:
    cumulative sections ([stats], [metrics]) diff meaningfully on their
    final row; header columns become the keys. The `[fleet]` section is
    per-LANE cumulative — its rows key on the lane column, so a fleet
    log diffs lane by lane (`fleet:3.events`) and a run that lost or
    gained lanes shows up as only-in-one keys, not a silent overwrite."""
    headers: dict[str, list[str]] = {}
    last: dict[str, list[str]] = {}
    for line in text.splitlines():
        if "[shadow-heartbeat]" not in line:
            continue
        payload = line.split("[shadow-heartbeat]", 1)[1].strip()
        if not payload.startswith("["):
            continue
        section, _, row = payload.partition("] ")
        section = section.lstrip("[")
        if section.endswith("-header"):
            headers[section[: -len("-header")]] = row.split(",")
        elif section == "fleet":
            cells = row.split(",")
            lane = cells[1] if len(cells) > 1 else "?"
            last[f"fleet:{lane}"] = cells
        else:
            last[section] = row.split(",")
    out: dict[str, Any] = {}
    for section, row in sorted(last.items()):
        cols = headers.get(section.partition(":")[0])
        for i, cell in enumerate(row):
            key = (f"{section}.{cols[i]}" if cols and i < len(cols)
                   else f"{section}[{i}]")
            try:
                out[key] = float(cell)
            except ValueError:
                out[key] = cell
    return out


def load_artifact(path: str) -> tuple[str, Any]:
    with open(path) as f:
        text = f.read()
    kind = classify(path, text)
    if kind == JSON_T:
        return kind, json.loads(text)
    if kind == SERVED_T:
        doc = json.loads(text)
        summary = doc.get("summary")
        if not isinstance(summary, dict):
            raise ValueError(
                f"{path}: served result {doc.get('request_id')!r} has "
                f"no summary (status {doc.get('status')!r}) — only "
                "completed requests diff against a solo run"
            )
        # normalize to a plain summary: sim keys diff exactly against
        # the solo-run artifact; request metadata (lane, launch,
        # wall_ms) is serving detail, not run output
        return JSON_T, summary
    if kind == LEDGER_T:
        from shadow_tpu_torch.obs.servetrace import load_ledger

        _, records = load_ledger(path)
        # diff as a plain record list: `now_ns` attrs compare exactly
        # (replayed streams must agree on sim progress), the wall keys
        # (t_s, dur_s, fetch_s, wall_ms, backoff_s) hit _WALL_HINTS
        return kind, records
    if kind == OPENMETRICS_T:
        return kind, load_openmetrics(text)
    return kind, load_heartbeat(text)


def _is_wall(key: str) -> bool:
    low = key.lower()
    return any(h in low for h in _WALL_HINTS)


def diff_values(a, b, *, rtol: float, path: str,
                out: list[dict]) -> None:
    """Recursive structural diff; appends one entry per drifting key."""
    if isinstance(a, dict) and isinstance(b, dict):
        for k in sorted(set(a) | set(b)):
            sub = f"{path}.{k}" if path else str(k)
            if k not in a:
                out.append({"key": sub, "a": None, "b": b[k],
                            "what": "only-in-b"})
            elif k not in b:
                out.append({"key": sub, "a": a[k], "b": None,
                            "what": "only-in-a"})
            else:
                diff_values(a[k], b[k], rtol=rtol, path=sub, out=out)
        return
    if isinstance(a, list) and isinstance(b, list):
        if len(a) != len(b):
            out.append({"key": f"{path}#len", "a": len(a), "b": len(b),
                        "what": "length"})
        for i, (x, y) in enumerate(zip(a, b)):
            diff_values(x, y, rtol=rtol, path=f"{path}[{i}]", out=out)
        return
    num = (int, float)
    if isinstance(a, num) and isinstance(b, num) \
            and not isinstance(a, bool) and not isinstance(b, bool):
        fa, fb = float(a), float(b)
        tol = rtol if (rtol > 0 and _is_wall(path)) else 0.0
        if fa == fb:
            return
        denom = max(abs(fa), abs(fb), 1e-12)
        rel = abs(fa - fb) / denom
        if rel <= tol:
            return
        out.append({"key": path, "a": a, "b": b,
                    "what": f"rel={rel:.3g}"})
        return
    if a != b:
        out.append({"key": path, "a": a, "b": b, "what": "value"})


def diff_files(path_a: str, path_b: str, *, rtol: float) -> list[dict]:
    kind_a, a = load_artifact(path_a)
    kind_b, b = load_artifact(path_b)
    if kind_a != kind_b:
        return [{"key": "", "a": kind_a, "b": kind_b,
                 "what": "artifact-type"}]
    out: list[dict] = []
    diff_values(a, b, rtol=rtol, path="", out=out)
    return out


def diff_dirs(dir_a: str, dir_b: str, *, rtol: float) -> dict:
    """Compare every like-named regular file present in both
    directories (recognized artifact types only; unrecognized files
    are listed as skipped, names present on one side as unmatched)."""
    names_a = {n for n in os.listdir(dir_a)
               if os.path.isfile(os.path.join(dir_a, n))}
    names_b = {n for n in os.listdir(dir_b)
               if os.path.isfile(os.path.join(dir_b, n))}
    report: dict[str, Any] = {
        "unmatched_a": sorted(names_a - names_b),
        "unmatched_b": sorted(names_b - names_a),
        "skipped": [],
        "files": {},
    }
    for name in sorted(names_a & names_b):
        pa, pb = os.path.join(dir_a, name), os.path.join(dir_b, name)
        try:
            report["files"][name] = diff_files(pa, pb, rtol=rtol)
        except (ValueError, json.JSONDecodeError):
            report["skipped"].append(name)
    return report


def _render_entries(entries: list[dict], prefix: str = "") -> list[str]:
    return [
        f"  {prefix}{e['key'] or '<root>'}: {e['a']!r} != {e['b']!r} "
        f"({e['what']})"
        for e in entries
    ]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="diff_runs",
        description="drift report between two runs' artifacts "
                    "(summary JSON, OpenMetrics scrape, heartbeat log, "
                    "BENCH json); exit 0 = no drift",
    )
    p.add_argument("a", help="artifact file or run directory")
    p.add_argument("b", help="artifact file or run directory")
    p.add_argument("--rtol", type=float, default=0.0,
                   help="relative tolerance for wall-clock-derived "
                        "numeric fields (sim-derived fields always "
                        "compare exactly; default 0 = everything exact)")
    p.add_argument("--json", action="store_true",
                   help="emit the machine-readable report on stdout")
    args = p.parse_args(argv)

    a_dir, b_dir = os.path.isdir(args.a), os.path.isdir(args.b)
    if a_dir != b_dir:
        print("error: arguments must be two files or two directories",
              file=sys.stderr)
        return 2
    try:
        if a_dir:
            report = diff_dirs(args.a, args.b, rtol=args.rtol)
            n = sum(len(v) for v in report["files"].values())
            n += len(report["unmatched_a"]) + len(report["unmatched_b"])
        else:
            entries = diff_files(args.a, args.b, rtol=args.rtol)
            report = {"files": {os.path.basename(args.a): entries}}
            n = len(entries)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.json:
        print(json.dumps({"drift": n, **report}))
        return 0 if n == 0 else 1

    if n == 0:
        print("no drift")
        return 0
    for name, entries in report["files"].items():
        if entries:
            print(f"{name}: {len(entries)} drifting key(s)")
            print("\n".join(_render_entries(entries)))
    for side, key in (("a", "unmatched_a"), ("b", "unmatched_b")):
        for name in report.get(key, ()):
            print(f"only in {side}: {name}")
    if report.get("skipped"):
        print("skipped (unrecognized): "
              + ", ".join(report["skipped"]))
    print(f"total: {n} drifting key(s)")
    return 1


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
