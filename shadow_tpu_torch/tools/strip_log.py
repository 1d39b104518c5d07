"""Normalize simulation logs for determinism diffs: a copy of
`shadow_tpu.tools.strip_log`, so that a log of either package strips to
the same text.

The reference strips per-run noise (memory addresses, wall-clock run
timing) from log files so repeated experiments can be compared byte for
byte (reference: src/tools/strip_log_for_compare.py; the determinism
tests diff host stdout the same way,
src/test/determinism/determinism1_compare.cmake). shadow_tpu logs carry
different noise: wall-clock fields in summary JSON, build/compile
timings, host hex ids in tracebacks. This tool keeps the
simulation-determined content only.

    python -m shadow_tpu_torch.tools.strip_log run.log stripped.log
    diff <(... run1) <(... run2)
"""

from __future__ import annotations

import json
import re
import sys

# wall-clock-derived summary fields (everything else in the summary is
# simulation-determined and must be identical across repeat runs);
# "profile" is the --profile phase/occupancy report — wall timing
_WALL_KEYS = {
    "wall_seconds", "build_seconds", "events_per_sec", "sim_s_per_wall_s",
    "profile",
}

_HEX_ADDR = re.compile(r"0x[0-9a-fA-F]{6,}")
# [supervisor] heartbeat rows mix sim-determined fields (time, windows,
# checkpoints) with wall-clock rates and the watchdog stall margin;
# blank out only the wall-derived columns so the rest still diffs
_SUPERVISOR = re.compile(
    r"(\[shadow-heartbeat\] \[supervisor\] \d+,\d+,)"
    r"[0-9.]*,[0-9.]*,[0-9.]*(,\d+)$"
)
# [pressure] rows are sim-determined except the trailing harvest
# wall-clock column
_PRESSURE = re.compile(
    r"(\[shadow-heartbeat\] \[pressure\] (?:\d+,){7}\d+,)[0-9.]*$"
)


def strip_line(line: str) -> str | None:
    """Normalized line, or None to drop it entirely."""
    s = line.rstrip("\n")
    if s.startswith("{") and s.endswith("}"):
        try:
            obj = json.loads(s)
        except json.JSONDecodeError:
            obj = None
        if isinstance(obj, dict):
            for k in _WALL_KEYS:
                obj.pop(k, None)
            if isinstance(obj.get("pressure"), dict):
                obj["pressure"].pop("harvest_seconds", None)
            return json.dumps(obj, sort_keys=True)
    # progress/timing diagnostics are wall-clock noise
    if "compile" in s and "second" in s:
        return None
    s = _SUPERVISOR.sub(r"\g<1>W,W,W\g<2>", s)
    s = _PRESSURE.sub(r"\g<1>W", s)
    return _HEX_ADDR.sub("0xADDR", s)


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        print("usage: strip_log <logfile> <outputfile>", file=sys.stderr)
        return 2
    with open(argv[0]) as fin, open(argv[1], "w") as fout:
        for line in fin:
            out = strip_line(line)
            if out is not None:
                fout.write(out + "\n")
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
