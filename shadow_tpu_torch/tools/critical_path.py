"""Critical-path attribution over an exported event trace.

The port's copy of `shadow_tpu.tools.critical_path`, giving the same
report for the same records. Reads the .npz written by
`obs.trace.TraceDrain.save` and walks
the send->exec flow edges — the same (src, seq, dst) join
export_trace.py draws as Perfetto flow arrows — to answer the question
the events/s headline can't: *how much of the workload is a sequential
dependency chain*, and therefore how fast the simulation could ever go
however many hosts run at once.

Model: every OP_EXEC record is a node. An exec depends on
(a) the previous exec on the same host (hosts execute their queue in
    sim-time order — the in-host sequential chain), and
(b) when the event is a delivered packet, the exec that *sent* it —
    joined through the matching OP_SEND record on the source host.
Depth(e) = 1 + max(depth of its dependencies); the critical path is
the longest such chain, reconstructed via parent pointers. A send is
attributed the depth its source host had reached at the send's sim
time (records are processed in (time, op) order with execs first, so
same-time sends see their emitting exec; a send whose delivery lands
at the *same* sim time falls back to the host chain — a documented
approximation, exact whenever network latency is non-zero).

The report gives the chain length (depth), the depth-vs-width
parallelism profile (how many execs are available at each dependency
depth — the simulator's theoretical lockstep occupancy), and the
top-K host/edge hotspots on the critical path itself: where the
sequential time actually lives.

    python -m shadow_tpu_torch.tools.critical_path run.npz
    python -m shadow_tpu_torch.tools.critical_path run.npz --top 5 --json
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from shadow_tpu_torch.obs.trace import OP_EXEC, OP_SEND


def analyze(recs: dict, meta: dict, top: int = 10) -> dict:
    """Pure transform: (trace records, meta) -> critical-path report.

    Returns a dict with `execs`, `flows` (send->exec joins), `depth`
    (longest chain), `width_mean`/`width_max` (parallelism profile),
    `widths` (execs per depth level), `span_ns` (sim time covered by
    the chain), `path_hosts` / `path_edges` (top-K hotspots on the
    reconstructed path), and `path` (the chain, root first, as
    (host, time, kind) triples capped at 1000 entries).
    """
    names = meta.get("names") or []
    kind_names = meta.get("kind_names") or []
    host = lambda g: names[g] if 0 <= g < len(names) else f"host{g}"
    kind = lambda k: (
        kind_names[k] if 0 <= k < len(kind_names) else f"kind{k}"
    )

    n = int(recs["time"].shape[0])
    time = np.asarray(recs["time"][:n], np.int64)
    op = np.asarray(recs["op"][:n], np.int64)
    src = np.asarray(recs["src"][:n], np.int64)
    dst = np.asarray(recs["dst"][:n], np.int64)
    seq = np.asarray(recs["seq"][:n], np.int64)
    owner = np.asarray(recs["owner"][:n], np.int64)
    knd = np.asarray(recs["kind"][:n], np.int64)

    # (time, op) order: at equal sim time the emitting exec (OP_EXEC=0)
    # is processed before the send it produced (OP_SEND=1)
    order = np.lexsort((seq, owner, op, time))

    # per-exec chain state, keyed by record index
    depth = np.zeros(n, np.int64)
    parent = np.full(n, -1, np.int64)
    via_send = np.zeros(n, bool)
    hdepth: dict[int, int] = {}  # host -> depth of its latest exec
    hlast: dict[int, int] = {}  # host -> record index of that exec
    # in-flight sends: (src, seq, dst) -> (depth at send, sender exec)
    sends: dict[tuple[int, int, int], tuple[int, int]] = {}
    flows = 0
    n_exec = 0
    for i in order:
        o = int(op[i])
        if o == OP_SEND:
            h = int(owner[i])
            sends.setdefault(
                (int(src[i]), int(seq[i]), int(dst[i])),
                (hdepth.get(h, 0), hlast.get(h, -1)),
            )
            continue
        if o != OP_EXEC:
            continue
        n_exec += 1
        h = int(owner[i])
        d, p, vs = hdepth.get(h, 0), hlast.get(h, -1), False
        sd = sends.pop((int(src[i]), int(seq[i]), h), None)
        if sd is not None:
            flows += 1
            if sd[0] > d:
                d, p, vs = sd[0], sd[1], True
        depth[i] = d + 1
        parent[i] = p
        via_send[i] = vs
        hdepth[h] = d + 1
        hlast[h] = i

    if n_exec == 0:
        return {"execs": 0, "flows": 0, "depth": 0, "width_mean": 0.0,
                "width_max": 0, "widths": [], "span_ns": 0,
                "path_hosts": [], "path_edges": [], "path": []}

    exec_mask = op == OP_EXEC
    max_depth = int(depth[exec_mask].max())
    widths = np.bincount(depth[exec_mask], minlength=max_depth + 1)[1:]

    # reconstruct the longest chain (root first)
    tip = int(np.flatnonzero(exec_mask & (depth == max_depth))[0])
    chain: list[int] = []
    j = tip
    while j >= 0:
        chain.append(j)
        j = int(parent[j])
    chain.reverse()
    host_counts: dict[int, int] = {}
    edge_counts: dict[tuple[int, int], int] = {}
    for idx, j in enumerate(chain):
        host_counts[int(owner[j])] = host_counts.get(int(owner[j]), 0) + 1
        if via_send[j] and idx > 0:
            e = (int(owner[chain[idx - 1]]), int(owner[j]))
            edge_counts[e] = edge_counts.get(e, 0) + 1
    top_hosts = sorted(host_counts.items(), key=lambda kv: -kv[1])[:top]
    top_edges = sorted(edge_counts.items(), key=lambda kv: -kv[1])[:top]

    return {
        "execs": int(n_exec),
        "flows": int(flows),
        "depth": max_depth,
        "width_mean": round(n_exec / max(max_depth, 1), 3),
        "width_max": int(widths.max()),
        "widths": [int(w) for w in widths],
        "span_ns": int(time[chain[-1]] - time[chain[0]]),
        "path_hosts": [
            {"host": host(g), "events": c} for g, c in top_hosts
        ],
        "path_edges": [
            {"src": host(a), "dst": host(b), "hops": c}
            for (a, b), c in top_edges
        ],
        "path": [
            (host(int(owner[j])), int(time[j]), kind(int(knd[j])))
            for j in chain[:1000]
        ],
    }


def _decile_widths(widths: list[int], bins: int = 10) -> list[tuple]:
    """Compress the per-depth width profile into up-to-`bins` depth
    ranges with their mean width, for the text report."""
    d = len(widths)
    if d == 0:
        return []
    out = []
    step = max(d // bins, 1)
    for lo in range(0, d, step):
        hi = min(lo + step, d)
        seg = widths[lo:hi]
        out.append((lo + 1, hi, round(sum(seg) / len(seg), 1)))
    return out


def render(report: dict, *, decile_bins: int = 10) -> str:
    """Human-readable report text from an `analyze` result."""
    r = report
    lines = [
        f"execs: {r['execs']}  send->exec flows joined: {r['flows']}",
        f"critical-path depth: {r['depth']} events "
        f"({r['span_ns'] / 1e9:.3f} sim-s span)",
        f"parallelism: mean width {r['width_mean']} "
        f"(max {r['width_max']}) — a perfect lockstep machine needs "
        f">= depth ({r['depth']}) sweeps",
    ]
    dw = _decile_widths(r["widths"], decile_bins)
    if dw:
        lines.append("depth-vs-width profile (depth range: mean width):")
        for lo, hi, w in dw:
            lines.append(f"  {lo:>6}-{hi:<6} {w}")
    if r["path_hosts"]:
        lines.append("critical-path host hotspots:")
        for e in r["path_hosts"]:
            lines.append(f"  {e['host']:<24} {e['events']} events")
    if r["path_edges"]:
        lines.append("critical-path edge hotspots:")
        for e in r["path_edges"]:
            lines.append(f"  {e['src']} -> {e['dst']:<16} "
                         f"{e['hops']} hops")
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="critical_path",
        description="longest send->exec dependency chain and "
                    "parallelism profile of a shadow_tpu_torch trace .npz",
    )
    p.add_argument("trace", help=".npz written by TraceDrain.save")
    p.add_argument("--top", type=int, default=10, metavar="K",
                   help="host/edge hotspots to report (default 10)")
    p.add_argument("--json", action="store_true",
                   help="emit the full report as JSON on stdout")
    args = p.parse_args(argv)

    from shadow_tpu_torch.obs.trace import load_trace

    recs, meta = load_trace(args.trace)
    report = analyze(recs, meta, top=args.top)
    if args.json:
        print(json.dumps(report))
    else:
        print(render(report))
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
