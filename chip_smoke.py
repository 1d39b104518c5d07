#!/usr/bin/env python3
"""Drive shadow_tpu_torch on one CUDA card and hold it to its pins.

Run from the repository root, with one NVIDIA H100 visible:

    python3 chip_smoke.py

Phases, each of which fails the run (exit 1, no result line) on error:

1. device: the card's name and power limit from nvidia-smi;
2. build: every kernel of the port, from the sources in the checkout;
3. kernels: each kernel held against its plain PyTorch version with
   `torch.equal`, over a regime sweep and over inputs captured from the
   first sweeps of the live PHOLD run; then the merge kernel's time
   against its bound at the main path's captured shape and at the
   TIMING shapes (PHOLD's fallback round, the packet stack's rows);
4. main path: PHOLD at the bench shape (4096 hosts x 8 messages,
   capacity 64, seed 1234, batched drain, 20 sim-seconds) run twice; the
   event count and a sha256 over every final-state leaf must equal the
   JAX/CPU reference, and the merge kernel must have launched at least
   once per sweep;
5. PHOLD at 16384 hosts, count pinned the same way;
6. the exponential over all 2^24 uniforms, pinned to JAX's bytes.

It then prints one `{"kernels": [...]}` line and, last, the device line
`{"ok": true, "device": {...}}`. Without a CUDA device, or without the
package beside it, it exits 1 and prints no result. With
`--kernels-only` it also times the merge at 1, 2, 4 and 8 rows per
block, stops after phase 3 and prints the timing as one JSON line,
without the result lines.

The pins come from JAX/CPU (jax 0.9.0, x64):
`python -m pytest -m slow tests/test_torch_phold.py` runs both shapes in
both packages on the CPU and asserts the pins against the JAX leaves.
The merge-input generator below is shared with tests/test_torch_merge.py.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time

import numpy as np

I64MAX = (1 << 63) - 1
MS = 1_000_000
SECOND = 1_000_000_000

# PHOLD as bench.py `tpu_rate` runs it (bench.py:100, batched=True)
BENCH = dict(capacity=64, latency_ns=50 * MS, mean_delay_ns=10 * MS,
             msgs_per_host=8, seed=1234)
BENCH_STOP_NS = 20 * SECOND
# JAX/CPU reference of the 4096-host run: events (BENCH_r06.json agrees)
# and the digest of shadow_tpu_torch.convert.leaves_digest over its
# final EngineState leaves
PIN_4096 = (10_934_800,
            "ed198810b5740862351fb640ce1f068dc95b85980b27eaae1cc7c2770d707659")
PIN_16384 = (43_740_010,
             "10c97d9e30b341bf6c12f4ab10fe61d122cd6160e2da7d64c7c4f669e79bc5cb")
# sha256 of JAX's -log1p(-u) f32 bytes over u = (0 .. 2^24-1) / 2^24
EXP_SHA256 = "bf7c3c6d0fc775831d7614f9101d864c08051c1ee138c8aa3f6a3ef9c4a9b205"

# peak rates of one H100 SXM (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


# -- merge inputs ------------------------------------------------------------
def merge_inputs(rng: np.random.Generator, h: int, hc: int, w: int, nw: int,
                 regime: str):
    """Random operands of the fused merge as numpy arrays:
    (qt, qss, qpay, st, sss, bpay, starts, cnt).

    Regimes: "sparse" (few residents, short runs), "overflow" (full rows,
    full runs), "cleared" (a TIME_INVALID prefix before the residents,
    as the drain leaves rows), "ties" (few distinct times, so srcseq
    decides), "unsorted" (keys in no order, runs anywhere).
    """
    t_max = 8 if regime == "ties" else 1 << 40
    qt = np.full((h, hc), I64MAX, np.int64)
    qss = np.zeros((h, hc), np.int64)
    qpay = np.zeros((h, hc, nw), np.int64)
    if regime == "unsorted":
        qt = rng.integers(0, t_max, size=(h, hc))
        qt[rng.random((h, hc)) < 0.2] = I64MAX
        qss = rng.integers(0, 1 << 40, size=(h, hc))
        qpay = rng.integers(-I64MAX, I64MAX, size=(h, hc, nw))
    else:
        if regime == "overflow":
            n_res = np.full(h, hc)
        elif regime == "sparse":
            n_res = rng.integers(0, max(2, hc // 8), size=h)
        else:
            n_res = rng.integers(0, hc + 1, size=h)
        for g in range(h):
            n = int(n_res[g])
            k = int(rng.integers(0, hc - n + 1)) if regime == "cleared" else 0
            qt[g, k:k + n] = np.sort(rng.integers(0, t_max, size=n))
            qss[g, k:k + n] = rng.integers(0, 1 << 40, size=n)
            qpay[g, k:k + n] = rng.integers(-I64MAX, I64MAX, size=(n, nw))
            order = np.lexsort((qss[g, k:k + n], qt[g, k:k + n]))
            qss[g, k:k + n] = qss[g, k:k + n][order]
    cnt = rng.integers(0, w + 1, size=h)
    if regime == "overflow":
        cnt[:] = w
    elif regime == "sparse":
        cnt = rng.integers(0, 3, size=h)
    if regime == "unsorted":
        m = int(rng.integers(1, h * w + 1))
        st = rng.integers(0, t_max, size=m)
        sss = rng.integers(0, 1 << 40, size=m)
        starts = rng.integers(0, m + w, size=h)
    else:
        # destination-grouped, key-sorted runs, with rejects at the tail
        runs_t = [np.sort(rng.integers(0, t_max, size=int(c))) for c in cnt]
        starts = np.concatenate([[0], np.cumsum(cnt)[:-1]])
        n_rej = int(rng.integers(1, 16))
        st = np.concatenate(runs_t + [rng.integers(0, t_max, size=n_rej)])
        sss = rng.integers(0, 1 << 40, size=st.shape[0])
        for g in range(h):
            s, c = int(starts[g]), int(cnt[g])
            order = np.lexsort((sss[s:s + c], st[s:s + c]))
            sss[s:s + c] = sss[s:s + c][order]
    bpay = rng.integers(-I64MAX, I64MAX, size=(h, w, nw))
    i64 = lambda a: np.ascontiguousarray(a, dtype=np.int64)
    i32 = lambda a: np.ascontiguousarray(a, dtype=np.int32)
    return (i64(qt), i64(qss), i64(qpay), i64(st), i64(sss), i64(bpay),
            i32(starts), i32(cnt))


# (h, hc, w, nw, regime): PHOLD's shapes (hc 64; w 24, fallback 64, nw 1)
# and the packet stack's (nw 6; hc 128 hot, 256 and 576 full width)
SWEEP = [
    (4096, 64, 24, 1, "cleared"), (4096, 64, 24, 1, "sparse"),
    (4096, 64, 24, 1, "overflow"), (2048, 64, 24, 1, "ties"),
    (2048, 64, 24, 1, "unsorted"), (4096, 64, 64, 1, "cleared"),
    (1024, 64, 64, 1, "overflow"), (512, 128, 24, 6, "cleared"),
    (512, 128, 128, 6, "ties"), (256, 256, 24, 6, "sparse"),
    (256, 256, 256, 6, "overflow"), (128, 576, 576, 6, "cleared"),
    (256, 128, 64, 6, "unsorted"),
]

# (h, hc, w, nw, regime): where the merge is timed besides the main path's
# captured sweep input, all at 4096 rows so that the card is full: PHOLD's
# fallback round (MERGE_W exceeded), the packet stack's hot region
# (HOT_C = 128), and its full-width fallback rounds without TCP
# (capacity 256) and with it (capacity 576)
TIMING = [
    (4096, 64, 64, 1, "overflow"), (4096, 128, 24, 6, "cleared"),
    (4096, 256, 256, 6, "overflow"), (4096, 576, 576, 6, "cleared"),
]
# grids whose last block is part empty (h not a multiple of the rows per
# block), and an unsorted row at the widest shape; held in the card tests
RAGGED = [
    (1, 64, 24, 1, "cleared"), (33, 64, 24, 1, "unsorted"),
    (4095, 64, 24, 1, "cleared"), (4095, 128, 24, 6, "ties"),
    (64, 576, 576, 6, "unsorted"),
]


# -- phases ------------------------------------------------------------------
class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def device_kernels(prof) -> list:
    """The device-side events (kernels, copies) of a torch.profiler
    trace: (name, microseconds) each."""
    from torch.autograd import DeviceType

    return [(e.name, e.device_time_total) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def device_ms(fn, reps: int, attempts: int = 3) -> float:
    """Device time of one fn() call: the kernels' own time summed from a
    torch.profiler trace of `reps` calls. A trace that comes back without
    device events is taken again (said on stderr), up to `attempts`
    times; then the phase fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = device_kernels(prof)
        if kernels:
            return sum(us for _, us in kernels) / reps / 1e3
        print(f"  torch.profiler trace {attempt} held no device events",
              file=sys.stderr)
    raise PhaseError("torch.profiler recorded no device events")


def profile_phold(phold, dev, n_hosts=4096, stop_ns=250 * MS):
    """Where the time goes on the main path: a torch.profiler trace of
    the first windows of PHOLD. Returns the device's busy share, kernel
    launches per sweep, the top kernels by device time and the merge
    kernel's share of it."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    eng, init = phold.build(n_hosts, device=dev, **BENCH)
    st = init()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st = eng.run(st, stop_ns)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = device_kernels(prof)
    by_name = collections.Counter()
    for name, us in kernels:
        by_name[name[:60]] += us
    busy_us = sum(us for _, us in kernels)
    merge_us = sum(us for name, us in kernels if "merge_rows" in name)
    sweeps = int(st.stats.n_sweeps)
    return {
        "wall_s": wall,
        "device_busy_share": busy_us / 1e6 / wall if kernels else None,
        "device_events": len(kernels),
        "device_events_per_sweep": len(kernels) / max(sweeps, 1),
        "sweeps": sweeps,
        "top_device_us": by_name.most_common(6),
        "merge_kernel_us": merge_us,
        "merge_share_of_device": merge_us / busy_us if kernels else None,
    }


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    line = smi.stdout.strip().splitlines()[0]
    print(line)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}: "
          f"{torch.cuda.get_device_name(0)}")
    return line


def phase_build(merge):
    """Build the port's one kernel library, the merge, with nvcc."""
    t0 = time.perf_counter()
    path, log = merge.build()
    secs = time.perf_counter() - t0
    print(f"built {path.name} in {secs:.1f}s")
    for ln in log.splitlines():
        if "registers" in ln or "spill" in ln or "smem" in ln:
            print(f"  ptxas: {ln.strip()}")
    return secs


def _on(dev, arrays):
    import torch

    return tuple(torch.from_numpy(a).to(dev) for a in arrays)


def compare_merge(merge, args) -> int:
    """Kernel vs plain on one input set: number of differing elements."""
    import torch

    got = merge.fused_merge(*args)
    want = merge.merge_body(*args)
    torch.cuda.synchronize()
    return sum(int((g != x).sum()) for g, x in zip(got, want))


def phase_kernels_sweep(merge, dev):
    rng = np.random.default_rng(20260117)
    for h, hc, w, nw, regime in SWEEP:
        args = _on(dev, merge_inputs(rng, h, hc, w, nw, regime))
        bad = compare_merge(merge, args)
        check(bad == 0, f"merge kernel != plain at h={h} hc={hc} w={w} "
                        f"nw={nw} {regime}: {bad} elements differ")
        print(f"  merge == plain: h={h} hc={hc} w={w} nw={nw} {regime}")


def run_phold(phold, n_hosts, dev, stop_ns=BENCH_STOP_NS):
    """Build and run PHOLD; returns (engine, final state, wall seconds)."""
    import torch

    eng, init = phold.build(n_hosts, device=dev, **BENCH)
    st = init()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = eng.run(st, stop_ns)
    torch.cuda.synchronize()
    return eng, st, time.perf_counter() - t0


def capture_merge_inputs(merge, events, phold, dev, n_calls=6):
    """Inputs of the first merge calls of the live PHOLD run (init push
    and first sweeps), cloned as they went into the kernel."""
    seen = []
    kernel = merge.fused_merge

    def record(*args):
        if len(seen) < n_calls:
            seen.append(tuple(a.clone() for a in args))
        return kernel(*args)

    events.merge.fused_merge = record
    try:
        run_phold(phold, 4096, dev, stop_ns=150 * MS)
    finally:
        events.merge.fused_merge = kernel
    return seen


def merge_bytes(args, outs) -> int:
    """Bytes the merge must move on these inputs: each output written
    once and each input read once, except what no output depends on: of
    the flat keys st/sss a row needs only its admitted run (min(cnt, w)
    entries), and of its residents' srcseq and payload only the slots
    behind its leading TIME_INVALID run."""
    import torch

    qt, qss, qpay, st, sss, bpay, starts, cnt = args
    h, hc = qt.shape
    w, nw = bpay.shape[1], qpay.shape[-1]
    admitted = int(torch.clamp(cnt, 0, w).sum())
    cleared = int(torch.cumprod((qt == I64MAX).to(torch.int32), 1).sum())
    whole = (qt, bpay, starts, cnt, *outs)
    return (sum(t.numel() * t.element_size() for t in whole)
            + 8 * 2 * admitted + 8 * (1 + nw) * (h * hc - cleared))


def merge_ops(args) -> int:
    qt, bpay = args[0], args[5]
    h, hc = qt.shape
    w = bpay.shape[1]
    # merge-path compares (hc per incoming lane) and output ranks
    return h * (3 * hc * w + (hc + w) * w)


def merge_bound_ms(args, outs) -> tuple[float, str, int]:
    """(least time on the card in ms, what bounds it, bytes moved)."""
    nbytes = merge_bytes(args, outs)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    # integer compares over the f32 CUDA-core rate: the data sheet gives
    # no i64 rate, and this term is far below the bytes term either way
    ops_ms = merge_ops(args) / FP32_OPS_PER_S * 1e3
    by = "bytes" if bytes_ms >= ops_ms else "operations"
    return max(bytes_ms, ops_ms), by, nbytes


def time_merge_shape(merge, args, reps=200) -> dict:
    """The kernel's device time per launch on one input set, beside its
    bound."""
    outs = merge.fused_merge(*args)
    bound_ms, by, nbytes = merge_bound_ms(args, outs)
    del outs
    k_ms = device_ms(lambda: merge.fused_merge(*args), reps)
    qt, bpay = args[0], args[5]
    return {"h": qt.shape[0], "hc": qt.shape[1], "w": bpay.shape[1],
            "nw": bpay.shape[2], "us": k_ms * 1e3,
            "bound_us": bound_ms * 1e3, "bound_by": by, "bytes": nbytes,
            "share": bound_ms / k_ms}


WARPS_PER_BLOCK_SWEEP = (1, 2, 4, 8)


def plan_sweep(merge, args, reps=50) -> dict:
    """Device us per launch against rows (warps) per block."""
    h, hc = args[0].shape
    w = args[5].shape[1]
    out = {}
    for warps in WARPS_PER_BLOCK_SWEEP:
        plan = merge.launch_plan(h, hc, w, warps_per_block=warps)
        if plan.warps_per_block == warps:
            out[warps] = device_ms(lambda: merge.launch(args, plan),
                                   reps) * 1e3
    return out


def phase_merge_timing(merge, dev, captured, smi_line,
                       sweep_plans=False) -> dict:
    """The merge kernel's time at the main path's sweep shape, on the
    last captured sweep (the first one finds every queue empty, later
    ones hold residents as the rest of the run does), with its plain
    version and a yardstick; then at the TIMING shapes. `sweep_plans`
    also times each shape at 1, 2, 4 and 8 rows (warps) per block."""
    import torch

    args = captured[-1]
    main = time_merge_shape(merge, args)
    if sweep_plans:
        main["us_by_plan"] = plan_sweep(merge, args)
    p_ms = device_ms(lambda: merge.merge_body(*args), 20)
    # no PyTorch call computes this merge; the nearest yardstick is a
    # two-key stable sort of the concatenated [H, hc + w] rows
    qt, qss, _, st_, sss, bpay, starts, cnt = args
    lane = torch.arange(bpay.shape[1], device=dev, dtype=torch.int32)
    gidx = torch.clamp(starts[:, None] + lane, max=st_.shape[0] - 1).long()
    kt = torch.cat([qt, st_[gidx]], 1)
    kss = torch.cat([qss, sss[gidx]], 1)

    def two_sorts():
        o = torch.sort(kss, dim=1, stable=True).indices
        return torch.sort(torch.gather(kt, 1, o), dim=1, stable=True)

    sort_ms = device_ms(two_sorts, 200)
    print(f"  merge kernel {main['us']:.2f} us/launch (torch.profiler "
          f"device time), bound {main['bound_us']:.2f} us "
          f"({main['bytes']} B, {int(cnt.sum())} events admitted, "
          f"m={st_.shape[0]}), {100 * main['share']:.1f}% of it; plain "
          f"{p_ms * 1e3:.2f} us, two stable torch.sort passes "
          f"(yardstick) {sort_ms * 1e3:.2f} us, at h={qt.shape[0]} "
          f"hc={qt.shape[1]} w={bpay.shape[1]} ({smi_line}) "
          f"{main.get('us_by_plan', '')}")
    del kt, kss
    shapes = [dict(main, regime="captured third sweep")]
    rng = np.random.default_rng(20261017)
    for h, hc, w, nw, regime in TIMING:
        args = _on(dev, merge_inputs(rng, h, hc, w, nw, regime))
        bad = compare_merge(merge, args)
        check(bad == 0, f"merge kernel != plain at timing shape h={h} "
                        f"hc={hc} w={w} nw={nw} {regime}: {bad} differ")
        row = dict(time_merge_shape(merge, args, reps=50), regime=regime)
        if sweep_plans:
            row["us_by_plan"] = plan_sweep(merge, args)
        shapes.append(row)
        print(f"  merge kernel {row['us']:.2f} us/launch, bound "
              f"{row['bound_us']:.2f} us ({row['bytes']} B), "
              f"{100 * row['share']:.1f}% of it, at h={h} hc={hc} w={w} "
              f"nw={nw} {regime} (== plain) "
              f"{row.get('us_by_plan', '')}")
        del args
        torch.cuda.empty_cache()
    return {"main": main, "plain_ms": p_ms, "yardstick_ms": sort_ms,
            "shapes": shapes}


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel phases and their timing: "
                         "no PHOLD runs, no result lines")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from shadow_tpu_torch import convert
        from shadow_tpu_torch.core import events, merge, rng
        from shadow_tpu_torch.core.engine import state_summary
        from shadow_tpu_torch.models import phold
    except ImportError as e:
        print(f"chip_smoke: shadow_tpu_torch not importable here: {e}",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)

    print("== 1. device")
    smi_line = phase_device()

    print("== 2. build")
    build_s = phase_build(merge)

    print("== 3. kernels against their plain versions")
    phase_kernels_sweep(merge, dev)
    captured = capture_merge_inputs(merge, events, phold, dev)
    check(len(captured) >= 2, "no merge inputs captured from PHOLD")
    for i, args in enumerate(captured):
        bad = compare_merge(merge, args)
        check(bad == 0, f"merge kernel != plain on live input {i}: "
                        f"{bad} elements differ")
        print(f"  merge == plain on live input {i}: "
              f"h={args[0].shape[0]} hc={args[0].shape[1]} "
              f"w={args[5].shape[1]} m={args[3].shape[0]}")
    timing = phase_merge_timing(merge, dev, captured, smi_line,
                                sweep_plans=opts.kernels_only)
    if opts.kernels_only:
        print(json.dumps({"merge_timing": timing, "card": smi_line}))
        return 0

    print("== 4. main path: PHOLD 4096 hosts, 20 sim-s, batched drain")
    digests = []
    main_run = None
    for rep in range(2):
        merge.launches = 0
        eng, st, wall = run_phold(phold, 4096, dev)
        launches = merge.launches
        summ = state_summary(st)
        digest = convert.leaves_digest(convert.engine_state_to_numpy(st))
        digests.append(digest)
        ev = summ["executed"]
        print(f"  run {rep}: events {ev} windows {summ['windows']} sweeps "
              f"{summ['sweeps']} drops {summ['queue_drops']} wall "
              f"{wall:.3f}s events/s {ev / wall:.1f} host syncs "
              f"{eng.host_syncs} merge launches {launches}")
        check(ev == PIN_4096[0], f"events {ev} != JAX/CPU {PIN_4096[0]}")
        check(digest == PIN_4096[1], f"state digest {digest} != JAX/CPU "
                                     f"{PIN_4096[1]}")
        check(launches >= summ["sweeps"] > 0,
              f"merge launches {launches} < sweeps {summ['sweeps']}")
        if main_run is None:
            main_run = dict(summ, wall_s=wall, launches=launches,
                            host_syncs=eng.host_syncs)
    check(digests[0] == digests[1], "two runs gave different states")

    print(json.dumps({"phold_4096": main_run, "card": smi_line}))
    prof = profile_phold(phold, dev)
    print(f"  profile of PHOLD 4096, first 250 sim-ms: {json.dumps(prof)}")

    print("== 5. PHOLD 16384 hosts, 20 sim-s")
    eng, st, wall = run_phold(phold, 16384, dev)
    summ = state_summary(st)
    ev = summ["executed"]
    print(f"  events {ev} windows {summ['windows']} sweeps {summ['sweeps']} "
          f"wall {wall:.3f}s events/s {ev / wall:.1f} host syncs "
          f"{eng.host_syncs}")
    digest = convert.leaves_digest(convert.engine_state_to_numpy(st))
    check(ev == PIN_16384[0], f"events {ev} != JAX/CPU {PIN_16384[0]}")
    check(digest == PIN_16384[1], f"16384 state digest {digest} != "
                                  f"JAX/CPU {PIN_16384[1]}")

    print("== 6. exponential over all 2^24 uniforms")
    u = torch.arange(1 << 24, device=dev).to(torch.float32) * (1.0 / (1 << 24))
    e = (-rng.xla_log1p_f32(-u)).cpu().numpy()
    sha = hashlib.sha256(e.tobytes()).hexdigest()
    check(sha == EXP_SHA256, f"exponential sha256 {sha} != {EXP_SHA256}")
    print(f"  sha256 {sha} == JAX/CPU")

    kernels = [{
        "name": "merge",
        "route": "cuda",
        "source": "shadow_tpu_torch/csrc/merge.cu",
        "replaces": "shadow_tpu/core/merge_pallas.py:125",
        "launches": main_run["launches"],
        "max_abs_err": 0,
        "equal_to_plain": True,
        "ms": timing["main"]["us"] / 1e3,
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["main"]["bound_us"] / 1e3,
        "bound_by": timing["main"]["bound_by"],
        "library_ms": None,
        "yardstick": "two stable torch.sort passes over [H, hc + w]",
        "yardstick_ms": timing["yardstick_ms"],
        "us": timing["main"]["us"],
        "bound_us": timing["main"]["bound_us"],
        "shapes": [{key: row[key] for key in
                    ("hc", "w", "nw", "regime", "us", "bound_us", "share")}
                   for row in timing["shapes"]],
        "build_s": build_s,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
