"""check_openmetrics: lint an OpenMetrics exposition for syntax errors.

Thin CLI over `shadow_tpu_torch.obs.metrics.validate_openmetrics` so shell
harnesses (measure_all.sh's metrics_smoke / stats_smoke stages) can
gate on exporter output without a prometheus toolchain in the
container. Histogram families (the --stats expositions) get the full
semantic check: monotone `le` bucket ordering, the mandatory `+Inf`
bucket, and `_count`/`_sum` reconciliation against the bucket totals —
applied per label-series, so the serve plane's per-class histograms
(`class="..."` with one bucket ladder per equivalence class,
docs/18-Serve-Tracing.md) are each checked independently. OpenMetrics
exemplars (`... # {trace_id="r000001"} <value> <ts>`) are validated
for syntax and for appearing only on `_bucket`/`_total` samples.
Reads a scrape from a file or stdin; prints one violation per line and
exits 1 on any.

Usage:
    curl -s localhost:PORT/metrics | python -m \
        shadow_tpu_torch.tools.check_openmetrics -
    python -m shadow_tpu_torch.tools.check_openmetrics scrape.txt
"""

from __future__ import annotations

import argparse
import sys

from shadow_tpu_torch.obs.metrics import validate_openmetrics


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("path", help="scrape file, or - for stdin")
    args = ap.parse_args(argv)

    if args.path == "-":
        text = sys.stdin.read()
    else:
        with open(args.path) as f:
            text = f.read()

    problems = validate_openmetrics(text)
    for p in problems:
        print(p)
    if not problems:
        n = sum(
            1 for ln in text.splitlines()
            if ln and not ln.startswith("#")
        )
        n_hist = sum(
            1 for ln in text.splitlines()
            if ln.startswith("# TYPE ") and ln.endswith(" histogram")
        )
        print(f"ok: {n} samples"
              + (f", {n_hist} histogram families" if n_hist else ""),
              file=sys.stderr)
    return 1 if problems else 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
