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
6. the exponential over all 2^24 uniforms, pinned to JAX's bytes;
7. the chained drain, `phold.build`'s default: the merge kernel held to
   its plain version on the first merge inputs of a chained run and
   timed on the last of them (a flush of the staging buffer); then
   PHOLD 4096 on the chained drain to CHAINED_STOP_NS = 5 sim-s, held
   to its JAX/CPU events, inner steps, sweeps and digest
   (PIN_CHAINED_4096), to the state of a batched run to the same stop
   less the scheduler counters, and to at least one merge launch per
   sweep;
8. PHOLD 4096 on the chained drain with the CPU model, and over a
   jittered, lossy four-PoI graph (GraphNetwork), each for
   VARIANT_STOP_NS = 1 sim-s and pinned to its JAX/CPU event count and
   state digest;
9. PHOLD over the UDP stack (socket, tx NIC, route, CoDel, rx NIC,
   demux), built from a Shadow config by `sim.build_simulation` with
   its defaults: `phold_example(4096, 8)` run to NET_STOP_S = 3 sim-s
   (the peers start at 1 s), held to its JAX/CPU events, state digest,
   messages sent and received, and to a merge launch per sweep; the
   merge kernel held to its plain version on the run's first merge
   inputs (the packet width, nw = 6) and timed on the last of them;
   then, to NET_VARIANT_STOP_S = 1.5 sim-s (cut from 2 for phase 20), the
   CoDel variant (hot peers behind thin downlinks, drops past count 19, a
   virtual CPU on a quarter of the peers) and the unfused pipeline
   (rx_queue "single", a bootstrap phase, a process stoptime), each
   pinned the same way;
10. TGen over TCP (NewReno, burst folding on the chained drain), built
   from `tgen_example(2048 pairs)` by `sim.build_simulation` with
   bench.py's TCP knobs: run once to 10 sim-s, held to its JAX/CPU
   events, windows, sweeps, inner steps, streams done and state digest
   (and its digest less n_inner_steps, which phase 15 shares), and to a
   merge launch per sweep; merge launches counted by
   queue width (hc 128, the hot region, or the full capacity 768); the
   merge kernel held to its plain version on the run's captured inputs
   (at hc = 768 too where the run reaches it) and timed on the last
   captured input of each width (no profile: phase 22 profiles a
   window of the same traffic, and the script keeps to its time limit);
11. Tor (relay crypto on a virtual CPU, circuits over TCP), built from
   `tor_example` at bench.py's 1,020-host tier by `sim.build_simulation`
   with bench.py's Tor knobs and strict overflow, run once to TOR_STOP_S
   = 4 sim-s in one call (cut from 4.5 for phase 21): held to its JAX/CPU
   events, windows, sweeps, inner steps, drops, streams done, relayed
   bytes and state digest, and to a merge launch per sweep; merge launches counted by queue width,
   the kernel held to its plain version on captured inputs at every
   width reached and timed on one per width (no profile since phase 23);
12. Bitcoin (UDP control and TCP block bodies on one host), built from
   `bitcoin_example(1000 nodes)` with bench.py's knobs, run once to
   BTC_STOP_S = 31.75 sim-s in one call, while the first block (mined at
   31 s) spreads: held the same way, and to the least and largest `best`
   over the real nodes (0 and 1; 0 on the pad rows) and the last
   adoption time;
13. several app models in one config (`sim.FusedModel`): TGen at 1,024
   pairs beside 2,048 PHOLD peers (4096 hosts), with bench.py's TCP
   knobs, run once to MIXED_STOP_S = 4 sim-s: held the same way as 11,
   and to its TGen streams done, PHOLD messages sent and received and
   hosts per model (no profile since phase 23);
14. lossless overflow (`runtime.pressure`): bench.py's skew shape
   (PHOLD 4096 x 8 with 64 hot hosts, batched drain) to SKEW_STOP_NS =
   2 sim-s at capacity 256 with drops, with a 1,024-slot spill ring
   through `run_with_spill`, and at capacity 512: each held to its
   JAX/CPU pin and to a merge launch per sweep; the spill run loses
   nothing, equals the capacity-512 run in the behaviour leaves, and
   its device queue and reservoir partition that run's queue; the
   merge kernel held to its plain version on the spill run's first
   full-width admission round and first refill push, and timed on
   each; launches counted by (hc, w);
15. the frontier drain: phase 10's config with frontier = 16, run once:
   held the same way as 11 (inner steps count every position, the
   terminating probes included), and its state less n_inner_steps to
   phase 10's (no profile since phase 22: its solo window profiles the
   same TGen traffic);
16. fault injection: phase 10's config under TGEN_FAULTS (server churn
   with crash, restart, quarantine and RSTs; a partition that heals; a
   loss spike; latency inflation; throttled server NICs), run once to
   FAULTS_STOP_S = 8 sim-s (cut from 10 for phase 21): held the same way
   as 11, and to its fault drops, quarantined events and retransmits,
   each > 0; its wall time, host
   syncs and inner steps printed beside phase 10's run of this call;
17. CUBIC: (a) the cube-root kernel (`csrc/cbrt.cu`, the replay of
   glibc's powf(|x|, 1/3f) that XLA's CPU cbrt calls) held to its plain
   version on every f32 in [0, 2560], CUBIC's reachable domain, chunk by
   chunk, with a sha256 over its outputs equal to the glibc pin
   (PIN_CBRT_SHA256); (b) the same on edge inputs outside the domain
   (negatives, subnormals, zeros, infinities, nans); its time at TGen's
   width (4096 rows) and over the domain against its byte bound; (c)
   phase 16's config with tcp_cc="cubic" to FAULTS_STOP_S (cut from 10
   sim-s for phase 21), held the same way as 16 to PIN_TGEN_CUBIC, to a
   congestion-avoidance epoch on some rows, and to
   a cube-root launch per inner step; its wall time, host syncs and
   inner steps printed beside phase 16's run of this call;
18. traces and histograms (obs.trace, obs.stats) on each drain, each
   held to a JAX/CPU pin of trace_pin (records per op, records lost, a
   sha256 over the drained records, one over the stats plane, the state
   digest): (a) phase 8's jittered, lossy graph on the chained drain for
   1 sim-s, drained at 0.5 and 1 s (EXEC, SEND, DROP records); (b) phase
   14's spill run on the batched drain with the controller's SPILL and
   REFILL rows; (c) phase 15's frontier run to 4 sim-s (the deferred
   per-round append, the run-length family; (a) and (c) cut from 2 and
   5 sim-s for phase 21); each traced run's ms per inner step printed
   beside the untraced run of phases 8 and 15;
19. the command line: `shadow_tpu_torch.cli.main`, in-process, on
   phase 10's config with the CLI's default --overflow spill and
   --metrics, heartbeats every 2 sim-s and a checkpoint every 3, to
   CLI_STOP_S = 6 sim-s (cut from 8 for phase 20; the 3 s checkpoint lands
   as the first clients start), then a second `main` resuming from that
   checkpoint to the same stop: each held to PIN_CLI_TGEN (the
   summary's deterministic fields, the sha256 of the stripped stdout,
   of the mid-run checkpoint's leaf table and the final leaves' digest),
   the two final states equal, merge launches counted from zero and
   required; its host reads per segment, harvest share of the loop's
   wall time and wall time printed beside phase 10's;
20. the command line with packet capture, adaptive windows and a
   device profile: `cli.main` on phase 10's config with `logpcap` and
   one `pcapdir` on every host, --overflow strict, --window auto,
   heartbeats every sim-second (five drains of the capture rings),
   --xprof over PCAP_XPROF and a checkpoint at PCAP_STOP_S = 5 sim-s:
   held to PIN_CLI_PCAP (the summary's deterministic fields, `windows`
   among them, the stripped stdout's sha256, one sha256 over the pcap
   files in name order, the records lost and the stage counts, the
   final leaves' digest), merge launches counted from zero and
   required, and the xprof trace holding CUDA kernel events; its ms
   per inner step, window probes and widths, host reads per segment,
   harvest share, the capture drain's host seconds and the trace's
   size printed beside phase 10's;
21. sharding: `cli.main` on phase 19's call with --overflow drop over
   `--mesh 2` (two ranks on the one card over gloo, every collective
   staged through pinned host memory; every TGen pair crosses the
   exchange), then `--mesh 1` over NCCL resuming from its 3 s
   checkpoint to the same stop: each held to PIN_CLI_SHARD (the
   summary's deterministic fields with cross_shard_packets, the
   stripped stdout's sha256, the mid-run checkpoint's leaf table and
   mesh header, the final leaves' digest), the merge launches of every
   rank counted from zero and required; the merge kernel held to its
   plain version and timed on an input captured inside
   `Engine._xchg_deliver` at the delivery of a full [S, R] bucket (the
   flat [S*R] batch); its ms, collectives and host reads per inner
   step, exchange rounds per sweep and backend printed beside phase
   19's run of this call;
22. scenario fleets: `cli.main` in-process with `--fleet` on phase 19's
   config in drop mode (FLEET_LANES = 4 lanes of 4,096 hosts, seeds 1-4,
   lanes 1-3 under FLEET_FAULTS' five fault types, latency scales 1 to 2)
   to FLEET_STOP_S = 4 sim-s with heartbeats every 2 s, held to
   PIN_CLI_FLEET (the summary's deterministic fields with the per-lane
   rows, the sha256 of the [fleet] rows); then the same lanes through
   `build_fleet` + `Fleet.run`, each lane's digest held to the pin, the
   merge held to its plain version on the fleet's captured inputs
   (16,384 rows) and timed, its launches counted per merge round (one
   for the whole fleet); lane 0's solo run on the same build, whose
   digest must equal lane 0's; and one window past the stop profiled on
   each: device launches per inner step, fleet against solo;
23. the serving plane: an in-process `SimService` (SERVE_LANES = 4
   lanes) behind its HTTP server on 127.0.0.1, driven by
   tools/serve_client's `run_load`: class A, TGen at phase 10's shape
   packed four lanes wide (SERVE_A: seeds 1-4, stops 4, 2, 3 and 4
   sim-s, latency scales 1, 1, 1.5 and 2), and class B, one request
   under a partition fault beside three inert pad lanes; a flight
   ledger, a snapshot every beat of SERVE_BEAT_WINDOWS windows and the
   one-shot SERVE_CHAOS raise at beat 2, so class A retries from its
   beat-1 snapshot: every summary held to PIN_SERVE, `resumed_from_beat`
   on class A, its seed-1 lane's leaves to phase 22's lane-0 digest,
   the pad lanes' counters 0, /metrics to the OpenMetrics checker, the
   ledger through tools/serve_report, a merge launch per sweep; the ms
   per inner step served beside phase 22's fleet, the snapshots' bytes
   and write times and each launch's wall printed; then (b) `python -m
   shadow_tpu_torch serve` as a subprocess on the card: one small PHOLD
   request equal to the port's solo run, SIGTERM, exit 0, the queue
   file written;
24. the real-binary tier: PROC_HOSTS = 1,024 hosts of native plugins
   built from the checkout by the port's build functions (PROC_ECHO_PAIRS
   shim_echo pairs, PROC_TCP_PAIRS unmodified plain_tcp pairs through
   the interposer, a quarter in each io mode, PROC_UDP_PAIRS plain_udp
   pairs, PROC_CLOCKS shim_clock hosts, half of them running a second
   clock stopped at 2 s: 1,088 processes) on the one-PoI topology, (a)
   `ProcessTier(device="cuda", overflow="spill")` run to its end with
   the plugins' stdout captured, held to PIN_PROC (the exit codes, a
   sha256 over the log triples and one over the stdout, the delivered
   bytes, the queue drops, the final-state digest), the merge launched
   at least once per injecting window and held to its plain version and
   timed on inputs captured inside `ProcessTier._inject`; windows, inner
   steps, ms per window, host reads per window and the pump's and the
   step's shares of the loop printed beside phase 10's run of this
   call; then (b) `python -m shadow_tpu_torch` as a subprocess on a cut
   of one echo pair and one epoll plain_tcp pair, its stdout less
   `wall_seconds` equal to the reference CLI's (PIN_PROC["cli_stdout"]).

It then prints one `{"kernels": [...]}` line and, last, the device line
`{"ok": true, "device": {...}}`. Without a CUDA device, or without the
package beside it, it exits 1 and prints no result. With
`--kernels-only` it also times the merge at 1, 2, 4 and 8 rows per
block, stops after phase 3 and prints the timing as one JSON line,
without the result lines; `--only 17,18` runs phases 1-3 and then only
the listed phases (9-24), without the result lines.

The pins come from JAX/CPU (jax 0.9.0, x64):
`python -m pytest -m slow tests/test_torch_phold.py tests/test_torch_sim.py`
runs every pinned configuration in both packages on the CPU and asserts
the pins against the JAX leaves (`tests/test_torch_tgen.py -m slow -k
4096` for phase 10's, `tests/test_torch_tor_bitcoin.py -m slow -k pins`
for phases 11 and 12, `tests/test_torch_multimodel.py`,
`tests/test_torch_pressure.py` and `tests/test_torch_frontier.py` with
`-m slow` for phases 13, 14 and 15, `tests/test_torch_faults_tcp.py -m
slow` for phase 16, `tests/test_torch_cubic.py -m slow` for phase 17,
`tests/test_torch_trace.py -m slow` for phase 18,
`tests/test_torch_cli.py -m slow` for phase 19,
`tests/test_torch_pcap.py -m slow` for phase 20,
`tests/test_torch_shard_cli.py -m slow` for phase 21,
`tests/test_torch_fleet_cli.py -m slow` for phase 22, lane by lane from
the reference's solo runs, `tests/test_torch_serve.py -m slow` for
phase 23, the reference's `solo_reference` of each request,
`tests/test_torch_proc.py -m slow` for phase 24, the reference's
ProcessTier and CLI on the same plugin objects). The merge-input
generator below is shared with tests/test_torch_merge.py.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import os
import subprocess
import sys
import tempfile
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
# The chained drain (phold.build's default) at the bench shape, run to
# CHAINED_STOP_NS (cut from 20 sim-s, where it took 86-200 s on the card,
# to fit phases 11-12 in the time limit), on JAX/CPU: (events, inner
# steps, sweeps, digest of every leaf). Its leaves less the scheduler
# counters SCHEDULER hash as the batched run's to the same stop.
CHAINED_STOP_NS = 5 * SECOND
PIN_CHAINED_4096 = (
    2_742_812, 1_779, 100,
    "0f2bac136ee992673418e632d08933de15b0f5ec621f0bf005d184abf150b36e")
SCHEDULER = ("stats.n_sweeps", "stats.n_inner_steps", "stats.n_xchg_rounds")
# PHOLD 4096 on the chained drain with the CPU model, and over a jittered,
# lossy graph, for VARIANT_STOP_NS: (events, digest of every leaf) each,
# from JAX/CPU (1 sim-s keeps the script in its time limit; phase 18
# runs the jittered graph to 2 s)
VARIANT_STOP_NS = 1 * SECOND
PIN_CPU_MODEL = (
    557_181,
    "bf33e70016cb023d9f295e16c8464204bd3f6ed41e78bfe532365176b991a69f")
PIN_JITTER = (
    331_354,
    "fbcef5e03103b6c60cc89656f6b8dd845ed4c7063e451261b81ef8eb930144e2")
# four PoIs at the bench's latency scale: (vid, packet loss) per vertex,
# (u, v, latency ms, packet loss, jitter ms) per edge; not complete, so
# paths go through Dijkstra; hosts attach round-robin
JITTER_VERTICES = (("poi-a", 0.001), ("poi-b", 0.0), ("poi-c", 0.004),
                   ("poi-d", 0.002))
JITTER_EDGES = ((0, 1, 55.0, 0.01, 4.0), (1, 2, 60.0, 0.005, 3.0),
                (2, 3, 52.0, 0.02, 5.0), (3, 0, 70.0, 0.0, 6.0),
                (1, 1, 50.0, 0.001, 2.0))


def cpu_cost_table(n_hosts: int) -> np.ndarray:
    """Per-host virtual-CPU cost per event: 0 to 6 x 150 us."""
    return (np.arange(n_hosts) % 7 * 150_000).astype(np.int64)


def phold_variant(phold, engine, topology, which: str, dev,
                  n_hosts: int = 4096, **build_kw):
    """(engine, init) of PHOLD at the bench configuration on the chained
    drain, with the CPU model ("cpu") or over the JITTER_* graph
    ("jitter"). `phold`, `engine` and `topology` are a package's
    models.phold, core.engine and net.topology modules; `dev` is None
    for a package without devices, else the device; `build_kw` go to
    phold.build (trace, stats)."""
    on = {} if dev is None else {"device": dev}
    eng, init = phold.build(n_hosts, **on, **BENCH, **build_kw)
    if which == "cpu":
        return engine.Engine(eng.cfg, eng.handlers, eng.network,
                             cpu_cost=cpu_cost_table(n_hosts), **on), init
    top = topology.Topology(
        [topology.Vertex(vid=vid, index=i, packetloss=loss)
         for i, (vid, loss) in enumerate(JITTER_VERTICES)],
        JITTER_EDGES)
    net = top.build_network([i % len(JITTER_VERTICES)
                             for i in range(n_hosts)], **on)
    cfg = dataclasses.replace(eng.cfg,
                              lookahead=int(top.min_latency_ms * MS))
    return engine.Engine(cfg, eng.handlers, net, **on), init


# PHOLD over the UDP stack (phase 9), built from a Shadow config by
# shadow_tpu_torch.sim.build_simulation with its defaults (fused rx,
# CoDel, capacity 256, 8 sockets): phold_example(4096, 8), whose peers
# start at 1 sim-s, run to NET_STOP_S (40 windows of traffic); the two
# variants run to NET_VARIANT_STOP_S. Pins from JAX/CPU, each (events,
# digest of every leaf, sum of n_sent, sum of n_recv).
NET_HOSTS, NET_MSGS, NET_SEED = 4096, 8, 1234
NET_STOP_S = 3
NET_VARIANT_STOP_S = 1.5
PIN_NET = (
    1_310_720,
    "54e66878def9d2dd5fc8646c004eadd03bb033ab0fa7aabd270efb012e78789c",
    1_310_720, 1_277_952)
PIN_NET_CODEL = (
    14_511,
    "3a7abf51b54cc5633d5b3a927a1341b7176d94bff79f88e5fb79238fa0367487",
    14_103, 10_007)
PIN_NET_UNFUSED = (
    566_065,
    "9b0217ca88a8634f791f5c2c2d359940bad1da4d1f0a16187b6c46a015367002",
    285_463, 252_695)
# variant "codel": 16 hot peers drawn with weight 400 (the other peers 1)
# behind a 16 KiB/s downlink, and 1024 peers with a 2 GHz virtual CPU;
# every peer starts with one message
NET_HOT, NET_HOT_WEIGHT, NET_HOT_KIB, NET_CPU_HOSTS = 16, 400.0, 16, 1024
# variant "unfused": fuse_rx=False, rx_queue="single", a bootstrap to
# NET_BOOTSTRAP_S, 64 peers behind a 2 KiB/s downlink (tail drops at the
# one-packet queue) and 512 peers whose process stops at NET_QUIT_AT
NET_THIN, NET_QUIT, NET_QUIT_AT, NET_BOOTSTRAP_S = 64, 512, 1.3, 1.2


def phold_net_config(which: str, workdir) -> tuple[str, dict]:
    """(Shadow config text, build_simulation keywords) of PHOLD over the
    UDP stack: "main", "codel" or "unfused". The "codel" variant's
    weights file (one weight per peer, in host order) is written into
    `workdir`."""
    import os

    from shadow_tpu_torch.examples import EXAMPLE_TOPOLOGY, phold_example

    if which == "main":
        return phold_example(NET_HOSTS, NET_MSGS, NET_STOP_S), {}

    def host(name, quantity, args, attrs="", proc=""):
        return (f'<host id="{name}" quantity="{quantity}"{attrs}>'
                f'<process plugin="phold" starttime="1"{proc} '
                f'arguments="{args}"/></host>')

    def config(hosts, attrs=""):
        return (f'<shadow stoptime="{NET_VARIANT_STOP_S}"{attrs}>'
                f"<topology><![CDATA[{EXAMPLE_TOPOLOGY}]]></topology>"
                '<plugin id="phold" path="shadow-plugin-test-phold"/>'
                + "".join(hosts) + "</shadow>")

    if which == "codel":
        weights = os.path.join(os.fspath(workdir), "phold_weights.txt")
        w = [NET_HOT_WEIGHT] * NET_HOT + [1.0] * (NET_HOSTS - NET_HOT)
        with open(weights, "w") as f:
            f.write("\n".join(repr(x) for x in w) + "\n")
        args = f"load=1 weightsfilepath={weights}"
        return config([
            host("hot", NET_HOT, args, f' bandwidthdown="{NET_HOT_KIB}"'),
            host("cpu", NET_CPU_HOSTS, args, ' cpufrequency="2000000"'),
            host("peer", NET_HOSTS - NET_HOT - NET_CPU_HOSTS, args),
        ]), {}
    if which == "unfused":
        args = f"load={NET_MSGS}"
        return config([
            host("peer", NET_HOSTS - NET_THIN - NET_QUIT, args),
            host("thin", NET_THIN, args, ' bandwidthdown="2"'),
            host("quit", NET_QUIT, args, proc=f' stoptime="{NET_QUIT_AT}"'),
        ], f' bootstraptime="{NET_BOOTSTRAP_S}"'), dict(fuse_rx=False,
                                                        rx_queue="single")
    raise ValueError(f"unknown PHOLD-net run {which!r}")


# TGen over TCP (phase 10): bench.py's TCP measurement (`tgen_worker`,
# bench.py:505-560: seed 1, 8 sockets, capacity 768, the chained drain)
# at 2048 client/server pairs, 4096 hosts, the width of every other
# phase; TGEN_BENCH_PAIRS is the bench's own shape, pinned on the CPU.
# Pins from JAX/CPU: (events, windows, sweeps, inner steps, streams
# done, digest of every leaf).
TGEN_PAIRS, TGEN_BENCH_PAIRS = 2048, 256
TGEN_SEED, TGEN_SOCKETS, TGEN_CAPACITY, TGEN_STOP_S = 1, 8, 768, 10
PIN_TGEN = (
    203_616, 121, 121, 403, 5_326,
    "f4ead5b88063299bb5d7a6dfdf419815973b42da1811fdd902fd00b2b1c328fd")
PIN_TGEN_BENCH = (
    25_462, 121, 121, 403, 666,
    "6e69cf8dc3908aa4d8db168709ae80f2747e51b9de9216686481cfd9121b66dd")
# the merge call whose input phase 10 times: mid-run, in steady traffic
TGEN_TIMED_CALL = 61


def tgen_config(n_pairs: int) -> str:
    """Shadow config text of TGen at n_pairs pairs: 16 KiB up, 64 KiB
    down, 4 streams per client, TGEN_STOP_S sim-seconds."""
    from shadow_tpu_torch.examples import tgen_example

    return tgen_example(n_pairs, "16KiB", "64KiB", 4, TGEN_STOP_S)


def tgen_pin(leaves) -> tuple:
    """A TGen run's pin from its numpy leaves (either package's)."""
    from shadow_tpu_torch.convert import leaves_digest

    return (int(leaves["stats.n_executed"].sum()),
            int(leaves["stats.n_windows"]), int(leaves["stats.n_sweeps"]),
            int(leaves["stats.n_inner_steps"]),
            int(leaves["hosts.app.streams_done"].sum()),
            leaves_digest(leaves))


# TGen with the frontier drain (phase 15): phase 10's run with bench.py's
# BENCH_FRONTIER=16 (`tgen_worker`, bench.py:505-572). Pin from JAX/CPU:
# (events, windows, sweeps, inner steps, queue drops, streams done,
# digest); its leaves less n_inner_steps hash as phase 10's do.
TGEN_FRONTIER = 16
PIN_TGEN_FRONTIER = (
    203_616, 121, 121, 790, 0, 5_326,
    "6877eefde0cce5137d858f02389d335a1c60eba3a19dcac97120b222a962a96a")
TGEN_LESS_INNER = (
    "ae027d42a3f536e5bfa23bf00d36c3fde838a14132da569df49ca883b98fe790")
# Mixed TGen + PHOLD (phase 13): one config on the example topology with
# both plugins through FusedModel: tgen_example's hosts at MIXED_PAIRS
# pairs beside MIXED_PEERS PHOLD peers at load MIXED_LOAD starting at
# 1 s (as phold_example writes them), 4096 hosts, with bench.py's TCP
# knobs, run to MIXED_STOP_S in one call. Pin from JAX/CPU: (events,
# windows, sweeps, inner steps, queue drops, TGen streams done, PHOLD
# messages sent and received, hosts of model 0 and of model 1, digest).
MIXED_PAIRS, MIXED_PEERS, MIXED_LOAD = 1024, 2048, 2
# cut to 4 sim-s (from 5 when phase 19 came), where JAX/CPU counts 491
# inner steps (652 at 5 s, 825 at 6 s, 1,164 at 8 s); the clients
# starting at 3 s have run by then, and the PHOLD peers for 3 s
MIXED_STOP_S = 4
PIN_MIXED = (
    254_574, 60, 60, 491, 0, 205, 245_760, 241_664, 2_048, 2_048,
    "c4bc2b79937d5128b34264f78d541cd6977ae9f9e50382607402f4220ceeb42b")
MIXED_TIMED_CALL = 45
# Lossless overflow (phase 14): bench.py's `skew_worker` (bench.py:
# 689-703: PHOLD 4096 x 8, seed 1234, batched drain, 64 hot hosts taking
# 30% of the traffic), cut from 10 to SKEW_STOP_NS, at capacity
# SKEW_CAPACITY with drops, with a spill ring of SKEW_SPILL slots through
# run_with_spill, and at twice the capacity with drops (drop-free). Pins
# from JAX/CPU: (events, queue drops, digest); the spill run's (events,
# queue drops, events spilled, harvested, refilled, digest).
SKEW = dict(BENCH, hot_hosts=64, hot_weight=0.3)
SKEW_STOP_NS = 2 * SECOND
SKEW_CAPACITY = 256
SKEW_SPILL = 4 * SKEW_CAPACITY
PIN_SKEW_DROP = (
    1_083_893, 984,
    "88d1d2ad8cc9b061246c14bf2e769fcc8cf8c5d4d34aca72c1d972f541e37edd")
PIN_SKEW_SPILL = (
    1_104_201, 0, 1_915, 1_915, 1_915,
    "937f810dd3bc12abedd9c1e515b20eab674fb7e43bb70ee74989203064cafa68")
PIN_SKEW_2C = (
    1_104_201, 0,
    "265ce556f42bf06cc6612761b8e209f73338eca86c4237306ccce06dc582055a")
# the leaves a spill run must share with the drop-free run at twice the
# capacity (the queue layout and the ring legitimately differ)
BEHAVIOUR = ("now", "stats.n_executed", "stats.n_emitted",
             "hosts.n_received", "src_seq")


def mixed_config(n_pairs=MIXED_PAIRS, n_peers=MIXED_PEERS,
                 stop_s=MIXED_STOP_S) -> str:
    """Shadow config text of TGen at n_pairs pairs (as tgen_config) beside
    n_peers PHOLD peers, each starting at 1 s with MIXED_LOAD messages."""
    from shadow_tpu_torch.examples import tgen_example

    peers = ('<plugin id="phold" path="shadow-plugin-test-phold"/>'
             f'<host id="peer" quantity="{n_peers}">'
             f'<process plugin="phold" starttime="1" '
             f'arguments="load={MIXED_LOAD}"/></host>')
    return tgen_example(n_pairs, "16KiB", "64KiB", 4, stop_s).replace(
        "</shadow>", peers + "</shadow>")


def mixed_pin(leaves) -> tuple:
    """A mixed run's pin from its numpy leaves (either package's)."""
    from shadow_tpu_torch.convert import leaves_digest

    mid = leaves["hosts.app.model_id"]
    return _counts(leaves) + (
        int(leaves["hosts.app.subs.0.streams_done"].sum()),
        int(leaves["hosts.app.subs.1.n_sent"].sum()),
        int(leaves["hosts.app.subs.1.n_recv"].sum()),
        int((mid == 0).sum()), int((mid == 1).sum()), leaves_digest(leaves))


def tgen_frontier_pin(leaves) -> tuple:
    """Phase 15's pin from its numpy leaves (either package's)."""
    from shadow_tpu_torch.convert import leaves_digest

    return _counts(leaves) + (int(leaves["hosts.app.streams_done"].sum()),
                              leaves_digest(leaves))


# TGen under every fault type (phase 16): phase 10's config with
# TGEN_FAULTS added, the scenario tests/test_faults.py builds at 2 hosts,
# at 4096: server churn (crash, restart, quarantine, RSTs on unmatched
# segments), a partition that heals, a loss spike, latency inflation and
# throttled server NICs, all inside the clients' traffic (they start at
# 3-7 s). Pin from JAX/CPU: (events, windows, sweeps, inner steps, queue
# drops, streams done, fault drops, quarantined, retransmits, digest).
TGEN_FAULTS = (
    '<fault type="churn" hosts="srv*" start="4" end="9" period="2" '
    'downtime="0.5" frac="0.1"/>'
    '<fault type="partition" src="cli*3" dst="srv*" start="5" end="7"/>'
    '<fault type="loss" src="cli*5" dst="*" loss="0.3" start="4" end="8"/>'
    '<fault type="latency" src="cli*7" dst="srv*" factor="3" start="4" '
    'end="9"/>'
    '<fault type="bandwidth" hosts="srv*9" factor="0.25" start="4.5" '
    'end="8.5"/>')
# phases 16's and 17(c)'s stop (cut from 10 s to make room for phase 21)
FAULTS_STOP_S = 8
PIN_TGEN_FAULTS = (
    129_041, 92, 92, 417, 0, 2_941, 2_349, 191, 1_060,
    "cb6720028e70e202ff4165e5264ca0407eaf2f4b7fbee5430ed6fc958a5ff39c")


# CUBIC (phase 17). (a) the cube root over every f32 in [0, 2560], CUBIC's
# reachable domain: a sha256 over the u32 outputs in input order, from
# glibc 2.36's powf under FTZ/DAZ (x86-64, FMA), as XLA's CPU cbrt runs
# it. (c) phase 16's config with tcp_cc="cubic": the pin of
# tgen_faults_pin from JAX/CPU.
CBRT_DOMAIN_END = 0x45200000
PIN_CBRT_SHA256 = (
    "1a3c76c8cdf54d137017b0bf813b87ec2d9a7db0b1eba9a3c20374cdc9ee4b18")
PIN_TGEN_CUBIC = (
    128_737, 93, 93, 431, 0, 2_942, 2_415, 194, 1_070,
    "67d12b23543251c7b14f70638912f9f9b1ecc54542bc7d99b5f30a29b2525e4f")
# (a) runs the domain in chunks of CBRT_CHUNK inputs; (b) the edge inputs
# outside it, each against the plain version bit for bit: every subnormal
# kind, both zeros, both infinities, quiet and signalling nans with
# payloads, the largest finite f32, and negatives of domain values
CBRT_CHUNK = 1 << 26
CBRT_EDGES = (1, 2, 0x3FFFFF, 0x400000, 0x7FFFFF, 0x800000, 0x7F7FFFFF,
              0x7F800000, 0x7F800001, 0x7FA00000, 0x7FC00000, 0x7FC00001,
              0x7FFFFFFF, 0x3F800000, CBRT_DOMAIN_END)
# FP64 outside the tensor cores, H100 SXM (NVIDIA data sheet): the rate
# the cube root's double arithmetic runs at
FP64_OPS_PER_S = 34e12
# f64 operations per cube root: 8 FMAs (2 each), 5 multiplies, 4 adds
CBRT_OPS = 25

# Traces and histograms on each drain (phase 18), each with trace and
# stats on and held to a pin of trace_pin from JAX/CPU:
# (a) the chained drain: phase 8's jittered, lossy graph (PHOLD 4096),
#     drained into a TraceDrain at each TRACE_SEGMENTS_S stop;
# (b) the batched drain with spill: phase 14's spill run through
#     run_with_spill, with the controller's OP_SPILL/OP_REFILL rows
#     attached, drained at its stop;
# (c) the frontier drain: phase 15's config to TRACE_FRONTIER_STOP_S,
#     drained at its stop.
TRACE_SEGMENTS_S = (0.5, 1)
TRACE_CHAINED_CAP = 256
TRACE_SPILL_CAP = 512
TRACE_FRONTIER_CAP = 256
TRACE_FRONTIER_STOP_S = 4
PIN_TRACE_CHAINED = (
    331_354, 331_354, 325_300, 6_054, 0, 0, 0, 0,
    "ea8f9c4595b580b3e979c83e4f182666a82e0d2773442c358ab0d18218b9ffc0",
    "eb032de8508b12c791f231180aa8ff935a447875b9533bdbb80f73254ebb7173",
    "f07f9f66f60b1bbd3d9b36b2150960339ae0ef03cd29aab3a3639d5b4505882a")
PIN_TRACE_SPILL = (
    1_104_201, 787_175, 786_337, 0, 0, 1_915, 1_915, 634_890,
    "f71801cfe747e51f134ab3f1cb8326dc53868faf979a8cbf48dedfe95fb02a61",
    "ae439ab2354bd5bd57d6f2c6ee9224e62ab1902363324f072ecba6f7b0e67059",
    "4e70aa704dad4c8fe8e70fe0e570d7523f2b15b4acfeaf8a139b95c86bc3b23a")
PIN_TRACE_FRONTIER = (
    16_808, 16_808, 28_700, 0, 0, 0, 0, 0,
    "e9e1319ec56b6fa61411f261d5dd46ca97415986d04361c320d5fd0de577c2ad",
    "78d49c4208439c0a81b73ffdc2e831391940cb377e41859e1b746a7e204a87ed",
    "e9f228cd2513ad02f6a68ac8ff7d3f326d6bce281fed4869b872d0346f99eae4")


def trace_pin(leaves, drain) -> tuple:
    """A phase-18 run's pin from its numpy leaves and its TraceDrain
    (either package's): events, records per op (exec, send, drop,
    fault_drop, spill, refill), records lost, a sha256 over the drained
    records, one over the stats plane's leaves, and the state digest
    (ring and plane included)."""
    from shadow_tpu_torch.convert import leaves_digest

    recs = drain.records()
    ops = np.bincount(recs["op"], minlength=6)
    h = hashlib.sha256()
    for key in sorted(recs):
        a = np.ascontiguousarray(recs[key])
        h.update(f"{key}|{a.dtype.str}|{a.shape}|".encode())
        h.update(a.tobytes())
    plane = {k: v for k, v in leaves.items() if k.startswith("splane.")}
    return ((int(leaves["stats.n_executed"].sum()),)
            + tuple(int(n) for n in ops[:6])
            + (int(drain.lost), h.hexdigest(), leaves_digest(plane),
               leaves_digest(leaves)))


# The command line (phase 19): `shadow_tpu_torch.cli.main` on phase 10's
# TGen config (2,048 pairs, 4096 hosts) with the CLI's default --overflow
# spill, --metrics, heartbeats every 2 sim-s and a checkpoint every 3, to
# CLI_STOP_S: the 3 s checkpoint lands as the first clients start (they
# start at 3-7 s; cut from 8 s and a 4 s checkpoint to make room for
# phase 20). Then a second `main`
# resumes from that checkpoint (copied alone into a fresh directory) to
# the same stop. Pins from the reference's CLI on the CPU (the slow test
# of tests/test_torch_cli.py): per run the summary's deterministic fields,
# the sha256 of the stripped stdout (heartbeat rows and summary), the
# sha256 of the mid-run checkpoint's leaf table and the final state's
# leaves_digest (read from the stop's checkpoint).
CLI_STOP_S = 6
CLI_CKPT = "cli.ckpt.npz"
CLI_MID_CKPT = CLI_CKPT + ".1"
CLI_ARGV = ["tgen.xml", "--seed", str(TGEN_SEED), "--sockets",
            str(TGEN_SOCKETS), "--capacity", str(TGEN_CAPACITY),
            "--stoptime", str(CLI_STOP_S), "--heartbeat-frequency", "2",
            "--checkpoint-interval", "3", "--checkpoint-keep", "2",
            "--checkpoint-path", CLI_CKPT, "--metrics"]
CLI_SUMMARY_KEYS = ("events", "windows", "sweeps", "queue_drops",
                    "net_dropped", "rx_bytes", "tx_bytes", "events_by_kind",
                    "pressure", "capacity")
_CLI_SUMMARY = {
    "events": 76668, "windows": 52, "sweeps": 52, "queue_drops": 0,
    "net_dropped": 0, "rx_bytes": 158704440, "tx_bytes": 167936000,
    "events_by_kind": {"pkt_arrive": 33210, "pkt_rx": 0, "tcp_timer": 2460,
                       "tcp_tx": 36900, "tgen.0": 4098},
    "pressure": {"spilled": 0, "spill_lost": 0, "fill_hwm": 22,
                 "pending": 0, "refilled": 0, "resident": 0,
                 "overdue": 0},
    "capacity": 768}
PIN_CLI_TGEN = {
    "run": {
        "summary": _CLI_SUMMARY,
        "log_sha256": (
            "beb7b68996883c38776e1c16b631f0b3"
            "802848717f9cc93a1ba8574b7024ea25"),
        "mid_leaf_table_sha256": (
            "5b4182bd9c508b14f925ce5a0e15a4a1"
            "b5444824c701ed14968e715716458b81"),
        "final_digest": (
            "1cf99917de3c97a089b2acba3da0d6c4"
            "27c047edc00812e4bf777c069575c52e")},
    "resumed": {
        "summary": _CLI_SUMMARY,
        "log_sha256": (
            "e44934c9c8dfd304f1484559e6eab2ac"
            "a114e1c719bbf6c770f35c087061be8e"),
        "mid_leaf_table_sha256": (
            "5b4182bd9c508b14f925ce5a0e15a4a1"
            "b5444824c701ed14968e715716458b81"),
        "final_digest": (
            "1cf99917de3c97a089b2acba3da0d6c4"
            "27c047edc00812e4bf777c069575c52e")}}


def checkpoint_leaf_table(path) -> str:
    """sha256 over a checkpoint's leaf table: its paths, shapes, dtypes
    and CRC32s, and its extras' CRC32s, as the header records them."""
    with np.load(path) as data:
        h = json.loads(bytes(data["__header__"]).decode("utf-8"))
    table = [h["paths"], h["shapes"], h["dtypes"], h["crc32"], h["extra"]]
    return hashlib.sha256(json.dumps(table).encode()).hexdigest()


def checkpoint_digest(path) -> str:
    """leaves_digest of the state a checkpoint holds."""
    from shadow_tpu_torch.convert import key_of, leaves_digest

    with np.load(path) as data:
        h = json.loads(bytes(data["__header__"]).decode("utf-8"))
        leaves = {key_of(p): data[f"leaf_{i}"]
                  for i, p in enumerate(h["paths"])}
    return leaves_digest(leaves)


def cli_pin_fields(stdout: str, workdir) -> dict:
    """A phase-19 run's pin from its stdout and its directory (either
    package's CLI)."""
    from pathlib import Path

    from shadow_tpu_torch.tools.strip_log import strip_line

    lines = stdout.splitlines()
    summary = json.loads([ln for ln in lines if ln.startswith("{")][-1])
    fields = {k: summary[k] for k in CLI_SUMMARY_KEYS}
    fields["pressure"] = {k: v for k, v in fields["pressure"].items()
                          if k != "harvest_seconds"}
    stripped = "".join(s + "\n" for s in map(strip_line, lines)
                       if s is not None)
    d = Path(workdir)
    with np.load(d / CLI_CKPT) as data:
        meta = json.loads(bytes(data["__header__"]).decode("utf-8"))["meta"]
    if meta["sim_seconds"] != summary["sim_seconds"]:
        raise ValueError(f"{CLI_CKPT} was written at {meta['sim_seconds']} "
                         f"s, not at the stop ({summary['sim_seconds']} s)")
    return {"summary": fields,
            "log_sha256": hashlib.sha256(stripped.encode()).hexdigest(),
            "mid_leaf_table_sha256": checkpoint_leaf_table(d / CLI_MID_CKPT),
            "final_digest": checkpoint_digest(d / CLI_CKPT)}


def cli_pin_of(pins: dict) -> dict:
    """The pin as PIN_CLI_TGEN stores it: {"run": fields, "resumed":
    fields}, through JSON (so tuples and ints compare as stored)."""
    return json.loads(json.dumps({k: pins[k] for k in ("run", "resumed")}))


# The command line with packet capture, adaptive windows and a device
# profile (phase 20): `cli.main` on phase 10's TGen config with logpcap
# and one pcapdir on every host, --overflow strict (--window refuses
# spill), --window auto, heartbeats every sim-second (the capture rings
# drain five times), --xprof over PCAP_XPROF (a few windows: the trace
# holds a handful of inner steps) and a checkpoint at the stop (TGen's
# streams start at 3-7 s). Pin from the reference's CLI on the CPU (the
# slow test of tests/test_torch_pcap.py): the summary's deterministic
# fields, the sha256 of the stripped stdout, one sha256 over the pcap
# files in name order, the records lost and the stage counts, and the
# final state's leaves_digest (read from the stop's checkpoint).
PCAP_STOP_S = 5
PCAP_XPROF = "4:4.5"
PCAP_CKPT = "pcap.ckpt.npz"
PCAP_DIR = "pcap"
XPROF_DIR = "xprof"
PCAP_ARGV = ["tgen.xml", "--seed", str(TGEN_SEED), "--sockets",
             str(TGEN_SOCKETS), "--capacity", str(TGEN_CAPACITY),
             "--stoptime", str(PCAP_STOP_S), "--overflow", "strict",
             "--window", "auto", "--heartbeat-frequency", "1",
             "--xprof", PCAP_XPROF, "--xprof-dir", XPROF_DIR,
             "--checkpoint-interval", str(PCAP_STOP_S),
             "--checkpoint-path", PCAP_CKPT]
PCAP_SUMMARY_KEYS = ("events", "windows", "sweeps", "queue_drops",
                     "net_dropped", "rx_bytes", "tx_bytes", "events_by_kind",
                     "packet_stages", "xprof")
_PCAP_SUMMARY = {
    "events": 9428, "windows": 5, "sweeps": 5, "queue_drops": 0,
    "net_dropped": 0, "rx_bytes": 1175880, "tx_bytes": 13434880,
    "events_by_kind": {"pkt_arrive": 3280, "pkt_rx": 0, "tcp_timer": 1230,
                       "tcp_tx": 2050, "tgen.0": 2868},
    "packet_stages": {"arrived": 3280, "queued": 1640, "delivered": 3280,
                      "retransmitted": 410},
    "xprof": {"dir": XPROF_DIR, "start": 4.0, "stop": 4.5,
              "completed": True}}
PIN_CLI_PCAP = {
    "summary": _PCAP_SUMMARY,
    "log_sha256": (
        "b2946b960be419bf807c49231d02e7ed"
        "3f53b2d419ca2c4aca53d2f7a6351e61"),
    "pcap_files": 4096,
    "pcap_sha256": (
        "6b55067b6b56ce7f453d4805edbb2ef4"
        "9e2d8a19412863df7ad2b03f5f868d86"),
    "lost": 0,
    "final_digest": (
        "1490770f6b3469bf3e1f5c3b02090813"
        "03891c28ffbbbde953f12a35796ceb69")}


def pcap_config(n_pairs: int) -> str:
    """Phase 20's config: tgen_config(n_pairs) with every host capturing
    into PCAP_DIR."""
    return tgen_config(n_pairs).replace(
        "<host ", f'<host logpcap="true" pcapdir="{PCAP_DIR}" ')


def pcap_pin_fields(stdout: str, stderr: str, workdir) -> dict:
    """A phase-20 run's pin from its stdout, its stderr and its
    directory (either package's CLI)."""
    import re
    from pathlib import Path

    from shadow_tpu_torch.tools.strip_log import strip_line

    lines = stdout.splitlines()
    summary = json.loads([ln for ln in lines if ln.startswith("{")][-1])
    stripped = "".join(s + "\n" for s in map(strip_line, lines)
                       if s is not None)
    d = Path(workdir)
    h = hashlib.sha256()
    files = sorted((d / PCAP_DIR).glob("*.pcap"))
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    lost = re.search(r"pcap: (\d+) records lost", stderr)
    return {"summary": {k: summary[k] for k in PCAP_SUMMARY_KEYS},
            "log_sha256": hashlib.sha256(stripped.encode()).hexdigest(),
            "pcap_files": len(files),
            "pcap_sha256": h.hexdigest(),
            "lost": int(lost.group(1)) if lost else 0,
            "final_digest": checkpoint_digest(d / PCAP_CKPT)}


# The sharded command line (phase 21): phase 19's call (CLI_ARGV) with
# --overflow drop (a mesh of more than one shard refuses spill) over two
# ranks on the one card (--mesh 2: gloo with host-staged collectives,
# since NCCL gives each rank a card of its own), to CLI_STOP_S with the
# 3 s checkpoint; then --mesh 1 (NCCL) resumes from that checkpoint,
# copied alone into a fresh directory, to the same stop. The config puts
# every server on rank 0 and every client on rank 1, so all of TGen's
# traffic crosses the exchange. Pins from the reference's CLI on the CPU
# (`--mesh 2`, then `--mesh 1 --resume`; the slow test of
# tests/test_torch_shard_cli.py): per run the summary's deterministic
# fields with `cross_shard_packets`, the stripped stdout's sha256, the
# mid-run checkpoint's leaf table sha256 and mesh header, and the final
# leaves' digest.
SHARD_ARGV = CLI_ARGV + ["--overflow", "drop"]
SHARD_MESHES = {"run": (2, "gloo"), "resumed": (1, "nccl")}
SHARD_SUMMARY_KEYS = ("events", "windows", "sweeps", "queue_drops",
                      "net_dropped", "rx_bytes", "tx_bytes",
                      "events_by_kind", "cross_shard_packets")
_SHARD_SUMMARY = {
    "events": 76668, "windows": 52, "sweeps": 52, "queue_drops": 0,
    "net_dropped": 0, "rx_bytes": 158704440, "tx_bytes": 167936000,
    "events_by_kind": {"pkt_arrive": 33210, "pkt_rx": 0, "tcp_timer": 2460,
                       "tcp_tx": 36900, "tgen.0": 4098},
    "cross_shard_packets": 142680}
# resumed at one shard from the 3 s checkpoint, written before the first
# cross-shard packet (the clients start at 3 s)
_SHARD_SUMMARY_RESUMED = dict(_SHARD_SUMMARY, cross_shard_packets=0)
PIN_CLI_SHARD = {
    "run": {
        "summary": _SHARD_SUMMARY,
        "log_sha256": (
            "17776e80668c620c4c1697cba1078089"
            "ce1d5ebdbb29f749862183b54f71d68c"),
        "mid_leaf_table_sha256": (
            "7233ed69c83ef69c094310ea55515bd4"
            "b8f478b3f9f7fc5d953bf23b2c5a2ffa"),
        "mid_mesh": {"n_shards": 2, "dcn_slices": 1, "host_order": None},
        "final_digest": (
            "d27d54979b5ce0d952e2d117f9f69c0d"
            "15dd46a1f6c42b033aa5cfc913553f89")},
    "resumed": {
        "summary": _SHARD_SUMMARY_RESUMED,
        "log_sha256": (
            "572817366fc7e88fe3c783eed4c32e78"
            "4361942cd371c14fcfe19a01c7dd88da"),
        "mid_leaf_table_sha256": (
            "7233ed69c83ef69c094310ea55515bd4"
            "b8f478b3f9f7fc5d953bf23b2c5a2ffa"),
        "mid_mesh": {"n_shards": 2, "dcn_slices": 1, "host_order": None},
        "final_digest": (
            "94b7d73c11d285aafd0170584e010927"
            "8930741d854e74ebebd23b82ffb8ad8f")}}


def shard_pin_fields(stdout: str, workdir) -> dict:
    """A phase-21 run's pin from its stdout and its directory (either
    package's CLI)."""
    from pathlib import Path

    from shadow_tpu_torch.tools.strip_log import strip_line

    lines = stdout.splitlines()
    summary = json.loads([ln for ln in lines if ln.startswith("{")][-1])
    stripped = "".join(s + "\n" for s in map(strip_line, lines)
                       if s is not None)
    d = Path(workdir)
    with np.load(d / CLI_MID_CKPT) as data:
        mesh = json.loads(bytes(data["__header__"]).decode("utf-8"))["mesh"]
    return {"summary": {k: summary[k] for k in SHARD_SUMMARY_KEYS},
            "log_sha256": hashlib.sha256(stripped.encode()).hexdigest(),
            "mid_leaf_table_sha256": checkpoint_leaf_table(d / CLI_MID_CKPT),
            "mid_mesh": mesh,
            "final_digest": checkpoint_digest(d / CLI_CKPT)}


# Scenario fleets (phase 22): phase 19's TGen config through `cli.main`
# with --overflow drop and --fleet: FLEET_LANES lanes with seeds
# TGEN_SEED.., lane 0 fault-free, lanes 1-3 under FLEET_FAULTS (the five
# fault types of TGEN_FAULTS, moved inside the horizon while the first
# clients, started at 3 s, run), latency scales FLEET_SCALES, to
# FLEET_STOP_S with heartbeats every 2 s. Pin from the reference on the
# CPU (the slow test of tests/test_torch_fleet_cli.py): the summary's
# deterministic fields with the per-lane rows, the sha256 of the
# stripped [fleet] rows, and each lane's leaves_digest after a
# build_fleet + Fleet.run of the same lanes to the stop.
FLEET_LANES = 4
FLEET_STOP_S = 4
FLEET_STOP_NS = FLEET_STOP_S * SECOND
FLEET_SCALES = "1,1.25,1.5,2"
FLEET_FAULTS = (
    "churn hosts=srv* start=3 end=4 period=0.5 downtime=0.2 frac=0.1; "
    "partition src=cli*0 dst=srv* start=3.2 end=3.6; "
    "loss src=cli*5 dst=* loss=0.3 start=3.1 end=3.9; "
    "latency src=cli*5 dst=srv* factor=3 start=3 end=3.9; "
    "bandwidth hosts=srv*0 factor=0.25 start=3.3 end=3.8")
# one line per lane of the fault file (a blank line: no faults)
FLEET_FAULT_LINES = ("",) + (FLEET_FAULTS,) * (FLEET_LANES - 1)
FLEET_BUILD_KW = dict(seed=TGEN_SEED, n_sockets=TGEN_SOCKETS,
                      capacity=TGEN_CAPACITY, overflow="drop")
FLEET_SUMMARY_KEYS = ("fleet_lanes", "hosts", "sim_seconds", "events",
                      "windows", "queue_drops", "seeds", "lanes")
PIN_CLI_FLEET = {
    "summary": {
        "fleet_lanes": 4, "hosts": 4096, "sim_seconds": 4.0,
        "events": 34568, "windows": 13, "queue_drops": 0,
        "seeds": [1, 2, 3, 4],
        "lanes": [
            {"executed": 16808, "now_ns": 4000000000, "queue_drops": 0,
             "sweeps": 13, "windows": 13},
            {"executed": 6530, "now_ns": 4000000000, "queue_drops": 0,
             "sweeps": 10, "windows": 10},
            {"executed": 6055, "now_ns": 4000000000, "queue_drops": 0,
             "sweeps": 9, "windows": 9},
            {"executed": 5175, "now_ns": 4000000000, "queue_drops": 0,
             "sweeps": 7, "windows": 7}]},
    "rows_sha256": (
        "58ff6dde623b976d5a87f32dbc64fecd"
        "5b798bd3f348d85a4ad6da7fddc61aef"),
    "lane_digests": [
        "ba85cda84cba4008bc15eb2efb0786f5efbfa95e95b3cbdef2bf4bcc816246b1",
        "4bc957a14dfc6ba3cdee74abfd0bdb8a530a41f2e17ce297a9fa6299ee5e06f8",
        "df118f0053ae044fe8294a78728cb1172b302c605dcfc8f4529fbdd926d59657",
        "f89e956cfb8647e5e9717b72ad90334aecce124c2f759a825a70853e00d78c86",
    ]}


# The serving plane (phase 23): an in-process SimService at SERVE_LANES
# lanes behind its HTTP server, driven by tools/serve_client's own
# functions. Class A: TGen at phase 10's 4,096-host shape, SERVE_A's
# (seed, stop in sim-s, latency scale) packed into one launch (its
# seed-1 lane is phase 22's lane 0: the same config, seed, stop and
# scale); class B: one request under SERVE_B_FAULTS, one live lane and
# three inert pad lanes. SERVE_BEAT_WINDOWS windows per beat with a
# snapshot every beat: class A writes one snapshot at beat 1 and, on the
# one-shot SERVE_CHAOS raise at beat 2, retries from it. Pins: the
# reference's solo_reference(doc) on JAX/CPU for each request (the slow
# test of tests/test_torch_serve.py), in submit order.
SERVE_LANES = 4
SERVE_PARAMS = {"n_pairs": TGEN_PAIRS, "capacity": TGEN_CAPACITY}
SERVE_A = ((1, 4, 1.0), (2, 2, 1.0), (3, 3, 1.5), (4, 4, 2.0))
SERVE_B_FAULTS = ("partition src=cli*0 dst=srv* start=3.2 end=3.6",)
SERVE_BEAT_WINDOWS = 8
SERVE_CHAOS = "raise:beat=2"
PIN_SERVE = (
    {"executed": 16808, "now_ns": 4000000000, "queue_drops": 0,
     "sweeps": 13, "windows": 13},
    {"executed": 2048, "now_ns": 2000000000, "queue_drops": 0,
     "sweeps": 1, "windows": 1},
    {"executed": 2048, "now_ns": 3000000000, "queue_drops": 0,
     "sweeps": 1, "windows": 1},
    {"executed": 15168, "now_ns": 4000000000, "queue_drops": 0,
     "sweeps": 11, "windows": 11},
    {"executed": 11683, "now_ns": 4000000000, "queue_drops": 0,
     "sweeps": 13, "windows": 13},
)
# phase 23(b): `python -m shadow_tpu_torch serve` as a subprocess on the
# card, one small request, then SIGTERM
SERVE_SMALL_DOC = {"model": "phold",
                   "params": {"hosts": 64, "capacity": 64,
                              "msgs_per_host": 2},
                   "seed": 5, "stop_s": 0.25}


def serve_docs() -> list[dict]:
    """Phase 23's requests in submit order: class A, then class B."""
    docs = [{"model": "tgen", "params": dict(SERVE_PARAMS), "seed": seed,
             "stop_s": stop, "latency_scale": lat}
            for seed, stop, lat in SERVE_A]
    docs.append({"model": "tgen", "params": dict(SERVE_PARAMS),
                 "seed": TGEN_SEED, "stop_s": FLEET_STOP_S,
                 "faults": list(SERVE_B_FAULTS)})
    return docs


def fleet_spec(fault_file) -> str:
    """The --fleet SPEC of phase 22."""
    return (f"lanes={FLEET_LANES} seed={TGEN_SEED}:{TGEN_SEED + FLEET_LANES}"
            f" fault-file={fault_file} latency-scale={FLEET_SCALES}")


def fleet_argv(fault_file) -> list[str]:
    """Phase 22's command line, with the fault file at `fault_file`."""
    return ["tgen.xml", "--seed", str(TGEN_SEED), "--sockets",
            str(TGEN_SOCKETS), "--capacity", str(TGEN_CAPACITY),
            "--stoptime", str(FLEET_STOP_S), "--heartbeat-frequency", "2",
            "--overflow", "drop", "--fleet", fleet_spec(fault_file)]


def fleet_plan(fault_file, cli_mod) -> dict:
    """Phase 22's per-lane overrides as `cli_mod` (either package's CLI)
    parses the --fleet SPEC: build_fleet's keywords."""
    spec = cli_mod._parse_fleet_spec(fleet_spec(fault_file), TGEN_SEED)
    spec.pop("lanes")
    return spec


def fleet_pin_fields(stdout: str) -> dict:
    """A phase-22 run's pin fields from its stdout (either package's
    CLI): the summary's deterministic fields and the sha256 of the
    [fleet] header and rows."""
    lines = stdout.splitlines()
    summary = json.loads([ln for ln in lines if ln.startswith("{")][-1])
    rows = "".join(ln + "\n" for ln in lines
                   if ln.startswith("[shadow-heartbeat] [fleet"))
    return {"summary": {k: summary[k] for k in FLEET_SUMMARY_KEYS},
            "rows_sha256": hashlib.sha256(rows.encode()).hexdigest()}


def tgen_faults_config(n_pairs: int) -> str:
    """Phase 16's config: tgen_config(n_pairs) under TGEN_FAULTS."""
    return tgen_config(n_pairs).replace("</shadow>",
                                        TGEN_FAULTS + "</shadow>")


def tgen_faults_pin(leaves) -> tuple:
    """Phase 16's pin from its numpy leaves (either package's)."""
    from shadow_tpu_torch.convert import leaves_digest

    return _counts(leaves) + (
        int(leaves["hosts.app.streams_done"].sum()),
        int(leaves["stats.n_fault_dropped"].sum()),
        int(leaves["stats.n_quarantined"].sum()),
        int(leaves["hosts.net.tcb.n_retx"].sum()), leaves_digest(leaves))


def skew_pin(leaves, ctrl=None) -> tuple:
    """A phase-14 run's pin from its numpy leaves (either package's) and,
    for the spill run, its controller."""
    from shadow_tpu_torch.convert import leaves_digest

    head = (int(leaves["stats.n_executed"].sum()),
            int(leaves["queues.drops"].sum()))
    if ctrl is None:
        return head + (leaves_digest(leaves),)
    return head + (int(leaves["queues.spill.n_spilled"].sum()),
                   int(ctrl.n_harvested.sum()), int(ctrl.n_refilled.sum()),
                   leaves_digest(leaves))


def queue_keys(leaves, ctrl=None) -> np.ndarray:
    """Every pending event as a (host, time, src, seq) row, sorted: the
    device queue's, plus the reservoir's when a controller is given."""
    t = leaves["queues.time"]
    host, col = np.nonzero(t != I64MAX)
    rows = [np.stack([host, t[host, col], leaves["queues.src"][host, col],
                      leaves["queues.seq"][host, col]], axis=1)]
    if ctrl is not None:
        res = [(h, rec[0], rec[1]) for h, hp in enumerate(ctrl._heaps)
               for rec in hp]
        if res:
            r = np.asarray(res, np.int64)
            rows.append(np.stack([r[:, 0], r[:, 1], r[:, 2] >> 32,
                                  (r[:, 2] & 0xFFFFFFFF).astype(np.uint32)
                                  .astype(np.int32)], axis=1))
    keys = np.concatenate(rows).astype(np.int64)
    return keys[np.lexsort(keys.T[::-1])]


# Tor (phase 11): bench.py's Tor-circuit measurement (`tor_worker`,
# bench.py:257-330: seed 1, 32 sockets, capacity 768, relays on a 3 GHz
# virtual CPU, 64 KiB fetches, 2 per client) at its tier 2 (TOR_TIERS[2],
# bench.py:218: 110 relays per class, 660 clients, 30 servers, 1,020 hosts
# bucketed to 1,024 rows), run to TOR_STOP_S in one call. Pins from
# JAX/CPU: (events, windows, sweeps, inner steps, queue drops, streams
# done, relayed bytes, digest of every leaf).
TOR_TIER = (110, 660, 30)
TOR_SEED, TOR_SOCKETS, TOR_CAPACITY, TOR_CPU_GHZ = 1, 32, 768, 3.0
TOR_FILESIZE, TOR_COUNT, TOR_CONFIG_STOP_S = "64KiB", 2, 10
# cut from 5 sim-s (1,787 inner steps, 140.6 s on the card) to 4.5, then
# to 4 for phase 21: the first clients start at 3 s (nothing runs
# before); by 4 s the circuits relay 26 MB in 824 inner steps on JAX/CPU
# though no fetch has finished yet (946 steps and every first fetch
# done by 4.5 s)
TOR_STOP_S = 4
PIN_TOR = (
    14_293, 20, 55, 824, 0, 0, 26_155_008,
    "45453339717113212dcfd3c27ba7705ed7b2fd91ceaf0b30991e0c41cb1bc87e")
# the merge call whose input phase 11 times: mid-run, in circuit traffic
TOR_TIMED_CALL = 40
# Bitcoin (phase 12): bench.py's gossip measurement (`btc_worker`,
# bench.py:582-624: 1,000 nodes bucketed to 1,024 rows, 2 blocks of 256
# KiB at a 30 s interval, seed 1, 16 sockets, capacity 768), run to
# BTC_STOP_S in one call, while block 1 spreads.
# Pins from JAX/CPU: (events, windows, sweeps, inner steps, queue drops,
# least and largest `best` over the real nodes, largest over the pad
# rows, largest `t_best`, digest of every leaf).
BTC_NODES, BTC_BLOCKS, BTC_BLOCKSIZE, BTC_INTERVAL = 1000, 2, "256KiB", 30
BTC_SEED, BTC_SOCKETS, BTC_CAPACITY = 1, 16, 768
# cut from 36 sim-s (2,385 inner steps, 191.7 s on the card) to 32, then
# to 31.75 for phase 23: 38 inner steps before block 1 is mined at 31 s,
# 423 by 31.75 s (545 by 32 s), when the first nodes have fetched its
# body over TCP and adopted it (at 31.60 s; none had by 31.5 s, 284
# steps)
BTC_STOP_S = 31.75
PIN_BTC = (
    14_820, 23, 39, 423, 0, 0, 1, 0, 31_603_341_630,
    "e0181017ca909e719cb510c6d8372005798e489e4c26de06c3b6063a0666dc4e")
# no profile: one of 31.00-31.25 s took 19.2 s with the run to its start
# (PERF.md, PR 7)
# the merge call whose input phase 12 times: in the first block's spread
BTC_TIMED_CALL = 40


def tor_config(tier=TOR_TIER) -> str:
    """Shadow config text of bench.py's Tor measurement at a tier
    (relays per class, clients, servers)."""
    from shadow_tpu_torch.examples import tor_example

    relays, clients, servers = tier
    return tor_example(n_relays_per_class=relays, n_clients=clients,
                       n_servers=servers, filesize=TOR_FILESIZE,
                       count=TOR_COUNT, stoptime=TOR_CONFIG_STOP_S,
                       relay_cpu_ghz=TOR_CPU_GHZ)


def btc_config(n_nodes=BTC_NODES) -> str:
    """Shadow config text of bench.py's Bitcoin measurement."""
    from shadow_tpu_torch.examples import bitcoin_example

    return bitcoin_example(n_nodes=n_nodes, blocks=BTC_BLOCKS,
                           blocksize=BTC_BLOCKSIZE, interval=BTC_INTERVAL)


TOR_KW = dict(seed=TOR_SEED, n_sockets=TOR_SOCKETS, capacity=TOR_CAPACITY)
BTC_KW = dict(seed=BTC_SEED, n_sockets=BTC_SOCKETS, capacity=BTC_CAPACITY)


def _counts(leaves) -> tuple:
    return (int(leaves["stats.n_executed"].sum()),
            int(leaves["stats.n_windows"]), int(leaves["stats.n_sweeps"]),
            int(leaves["stats.n_inner_steps"]),
            int(leaves["queues.drops"].sum()))


def tor_pin(leaves) -> tuple:
    """A Tor run's pin from its numpy leaves (either package's)."""
    from shadow_tpu_torch.convert import leaves_digest

    return _counts(leaves) + (
        int(leaves["hosts.app.streams_done"].sum()),
        int(leaves["hosts.app.relayed_bytes"].sum()), leaves_digest(leaves))


def btc_pin(leaves, n_real: int) -> tuple:
    """A Bitcoin run's pin from its numpy leaves (either package's):
    `best` over the first n_real rows (the nodes) and over the rest (the
    shape bucket's pad rows)."""
    from shadow_tpu_torch.convert import leaves_digest

    best = leaves["hosts.app.best"]
    return _counts(leaves) + (
        int(best[:n_real].min()), int(best[:n_real].max()),
        int(best[n_real:].max(initial=0)),
        int(leaves["hosts.app.t_best"].max()), leaves_digest(leaves))


# sha256 of JAX's -log1p(-u) f32 bytes over u = (0 .. 2^24-1) / 2^24
EXP_SHA256 = "bf7c3c6d0fc775831d7614f9101d864c08051c1ee138c8aa3f6a3ef9c4a9b205"

# peak rates of one H100 SXM (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
# the H100 SXM5's L2 cache
L2_BYTES = 50 * 2**20
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
# (HOT_C = 128, also TGen's common width), its full-width fallback rounds
# without TCP (capacity 256) and with it (capacity 576), and TGen's full
# queue width (capacity 768) at the common block width
TIMING = [
    (4096, 64, 64, 1, "overflow"), (4096, 128, 24, 6, "cleared"),
    (4096, 256, 256, 6, "overflow"), (4096, 576, 576, 6, "cleared"),
    (4096, 768, 24, 6, "cleared"),
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
    trace: (name, microseconds) each, read from the raw kineto records:
    `prof.events()` builds the profiler's event tree first, at about
    0.1 ms per event, 20 s for a trace of 160,000 kernels."""
    from torch.autograd import DeviceType

    return [(e.name(), e.duration_ns() / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


def device_ms(fn, reps: int, attempts: int = 3,
              per_call: int | None = None) -> float:
    """Device time of one fn() call: the kernels' own time summed from a
    torch.profiler trace of `reps` calls. Where `per_call` gives the
    device events of one call, the sum is divided by the calls the trace
    recorded, since a trace may miss a few kernel records (said on
    stdout) and dividing by `reps` would then read short. A trace that
    comes back without device events is taken again (said on stderr),
    up to `attempts` times; then the phase fails."""
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
            calls = reps if per_call is None else len(kernels) / per_call
            if calls != reps:
                print(f"  torch.profiler trace held {len(kernels)} device "
                      f"events for {reps} calls of {per_call}")
            return sum(us for _, us in kernels) / calls / 1e3
        print(f"  torch.profiler trace {attempt} held no device events",
              file=sys.stderr)
    raise PhaseError("torch.profiler recorded no device events")


def profile_phold(phold, dev, batched, n_hosts=4096, stop_ns=250 * MS):
    """Where the time goes on a path: a torch.profiler trace of the
    first windows of PHOLD on one drain. Returns the device's busy share,
    device events per sweep and per inner step, the top kernels by device
    time and the merge kernel's share of it."""
    eng, init = phold.build(n_hosts, device=dev, batched=batched, **BENCH)
    return profile_run(eng.run, init(), stop_ns)


def profile_run(run, st, stop_ns):
    """A torch.profiler trace of `run(st, stop_ns)` on the card: the
    device's busy share, device events per sweep and per inner step, the
    top kernels by device time and the merge kernel's share of it."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    # device activity only: the host-side op events would multiply the
    # trace that has to be read back, and nothing here uses them
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st = run(st, stop_ns)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = device_kernels(prof)
    by_name = collections.Counter()
    for name, us in kernels:
        by_name[name[:60]] += us
    busy_us = sum(us for _, us in kernels)
    merge_us = sum(us for name, us in kernels if "merge_rows" in name)
    sweeps = int(st.stats.n_sweeps)
    inner = int(st.stats.n_inner_steps)
    return {
        "wall_s": wall,
        "device_busy_share": busy_us / 1e6 / wall if kernels else None,
        "device_events": len(kernels),
        "device_events_per_sweep": len(kernels) / max(sweeps, 1),
        "device_events_per_inner_step": len(kernels) / max(inner, 1),
        "sweeps": sweeps,
        "inner_steps": inner,
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


def phase_build(*kernels):
    """Build the port's kernel libraries (the merge, the cube root), one
    nvcc per source, all started together; returns the seconds until
    the last one was built."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels)) as pool:
        built = list(pool.map(lambda k: k.build(), kernels))
    secs = time.perf_counter() - t0
    for path, log in built:
        print(f"built {path.name}")
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln or "smem" in ln:
                print(f"  ptxas: {ln.strip()}")
    print(f"  {len(kernels)} libraries in {secs:.1f}s")
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


def run_phold(phold, n_hosts, dev, stop_ns=BENCH_STOP_NS, batched=True):
    """Build and run PHOLD; returns (engine, final state, wall seconds)."""
    import torch

    eng, init = phold.build(n_hosts, device=dev, batched=batched, **BENCH)
    return run_engine(eng, init, stop_ns)


def run_engine(eng, init, stop_ns):
    """Run an engine from init() to stop_ns on the card; returns (engine,
    final state, wall seconds)."""
    import torch

    st = init()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = eng.run(st, stop_ns)
    torch.cuda.synchronize()
    return eng, st, time.perf_counter() - t0


def capture_merge_inputs(merge, events, phold, dev, n_calls=6,
                         batched=True):
    """Inputs of the first merge calls of the live PHOLD run on one drain
    (init push and first sweeps), cloned as they went into the kernel."""
    seen = []
    kernel = merge.fused_merge

    def record(*args):
        if len(seen) < n_calls:
            seen.append(tuple(a.clone() for a in args))
        return kernel(*args)

    events.merge.fused_merge = record
    try:
        run_phold(phold, 4096, dev, stop_ns=150 * MS, batched=batched)
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
    bound. `us` is timed cold: the launches rotate through copies of the
    inputs, each output kept until its slot comes round again, so that
    at least 2 x L2_BYTES of other traffic lies between two launches on
    the same memory and the inputs come from HBM, as the byte bound
    assumes. `warm_us` repeats the one input set, which L2 may still
    hold from the launch before."""
    outs = merge.fused_merge(*args)
    bound_ms, by, nbytes = merge_bound_ms(args, outs)
    del outs
    n = max(2, -(-2 * L2_BYTES // nbytes) + 1)
    copies = [args] + [tuple(a.clone() for a in args) for _ in range(n - 1)]
    kept, turn = [None] * n, itertools.count()

    def cold():
        i = next(turn) % n
        kept[i] = merge.fused_merge(*copies[i])

    k_ms = device_ms(cold, max(reps, 2 * n), per_call=1)
    del copies, kept
    warm_ms = device_ms(lambda: merge.fused_merge(*args), reps, per_call=1)
    qt, bpay = args[0], args[5]
    h, hc, w = qt.shape[0], qt.shape[1], bpay.shape[1]
    return {"h": h, "hc": hc, "w": w, "nw": bpay.shape[2],
            "warps_per_block": merge.launch_plan(h, hc, w).warps_per_block,
            "us": k_ms * 1e3, "warm_us": warm_ms * 1e3, "copies": n,
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
                                   reps, per_call=1) * 1e3
    return out


def time_captured(merge, dev, args, smi_line, label,
                  sweep_plans=False) -> dict:
    """The merge kernel's time on one input captured from a live run,
    beside its bound, its plain version and a yardstick. `sweep_plans`
    also times it at 1, 2, 4 and 8 rows (warps) per block."""
    import torch

    row = time_merge_shape(merge, args)
    if sweep_plans:
        row["us_by_plan"] = plan_sweep(merge, args)
    row["plain_ms"] = device_ms(lambda: merge.merge_body(*args), 20)
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

    row["yardstick_ms"] = device_ms(two_sorts, 200)
    row["m"] = st_.shape[0]
    row["regime"] = label
    print(f"  merge kernel {row['us']:.2f} us/launch cold over "
          f"{row['copies']} input copies ({row['warm_us']:.2f} us warm; "
          f"torch.profiler device time), bound {row['bound_us']:.2f} us "
          f"({row['bytes']} B, {int(cnt.sum())} events admitted, "
          f"m={st_.shape[0]}), {100 * row['share']:.1f}% of it; plain "
          f"{row['plain_ms'] * 1e3:.2f} us, two stable torch.sort passes "
          f"(yardstick) {row['yardstick_ms'] * 1e3:.2f} us, at "
          f"h={qt.shape[0]} hc={qt.shape[1]} w={bpay.shape[1]}, "
          f"{row['warps_per_block']} rows per block, {label} "
          f"({smi_line}) {row.get('us_by_plan', '')}")
    return row


def phase_merge_timing(merge, dev, captured, smi_line,
                       sweep_plans=False) -> dict:
    """The merge kernel's time at the main path's sweep shape, on the
    last captured sweep (the first one finds every queue empty, later
    ones hold residents as the rest of the run does), with its plain
    version and a yardstick; then at the TIMING shapes. `sweep_plans`
    also times each shape at 1, 2, 4 and 8 rows (warps) per block."""
    import torch

    main = time_captured(merge, dev, captured[-1], smi_line,
                         "captured third sweep", sweep_plans)
    p_ms, sort_ms = main["plain_ms"], main["yardstick_ms"]
    shapes = [main]
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
        print(f"  merge kernel {row['us']:.2f} us/launch cold "
              f"({row['warm_us']:.2f} us warm), bound "
              f"{row['bound_us']:.2f} us ({row['bytes']} B), "
              f"{100 * row['share']:.1f}% of it, at h={h} hc={hc} w={w} "
              f"nw={nw} {regime} (== plain) "
              f"{row.get('us_by_plan', '')}")
        del args
        torch.cuda.empty_cache()
    return {"main": main, "plain_ms": p_ms, "yardstick_ms": sort_ms,
            "shapes": shapes}


def phase_live_inputs(merge, events, phold, dev, batched) -> list:
    """The first merge inputs of a live PHOLD 4096 run on one drain,
    each held against the plain version."""
    captured = capture_merge_inputs(merge, events, phold, dev,
                                    batched=batched)
    drain = "batched" if batched else "chained"
    check(len(captured) >= 2, f"no merge inputs captured from {drain} PHOLD")
    for i, args in enumerate(captured):
        bad = compare_merge(merge, args)
        check(bad == 0, f"merge kernel != plain on live {drain} input {i}: "
                        f"{bad} elements differ")
        print(f"  merge == plain on live {drain} input {i}: "
              f"h={args[0].shape[0]} hc={args[0].shape[1]} "
              f"w={args[5].shape[1]} m={args[3].shape[0]}")
    return captured


def phase_chained(phold, merge, convert, dev, smi_line) -> dict:
    """PHOLD 4096 on the chained drain (phold.build's default) to
    CHAINED_STOP_NS, held to PIN_CHAINED_4096 and to the state of a
    batched run to the same stop less the scheduler counters."""
    _, st, _ = run_phold(phold, 4096, dev, stop_ns=CHAINED_STOP_NS)
    batched_stripped = convert.leaves_digest(
        convert.engine_state_to_numpy(st), SCHEDULER)
    merge.launches = 0
    eng, st, wall = run_phold(phold, 4096, dev, stop_ns=CHAINED_STOP_NS,
                              batched=False)
    launches = merge.launches
    leaves = convert.engine_state_to_numpy(st)
    ev = int(leaves["stats.n_executed"].sum())
    inner = int(leaves["stats.n_inner_steps"])
    sweeps = int(leaves["stats.n_sweeps"])
    run = {"events": ev, "wall_s": wall, "events_per_s": ev / wall,
           "inner_steps": inner, "sweeps": sweeps,
           "windows": int(leaves["stats.n_windows"]),
           "host_syncs": eng.host_syncs, "launches": launches}
    print(f"  chained: events {ev} wall {wall:.3f}s events/s "
          f"{ev / wall:.1f} inner steps {inner} sweeps {sweeps} host syncs "
          f"{eng.host_syncs} merge launches {launches} ({smi_line})")
    print(json.dumps({"phold_4096_chained": run, "card": smi_line}))
    got = (ev, inner, sweeps, convert.leaves_digest(leaves))
    check(got == PIN_CHAINED_4096, f"chained (events, inner steps, sweeps, "
                                   f"digest) {got} != JAX/CPU "
                                   f"{PIN_CHAINED_4096}")
    stripped = convert.leaves_digest(leaves, SCHEDULER)
    check(stripped == batched_stripped,
          f"chained state {stripped} != the batched run's {batched_stripped}")
    check(launches >= sweeps > 0,
          f"merge launches {launches} < sweeps {sweeps}")
    return run


def phase_variant(phold, engine, topology, merge, convert, which, pin, dev,
                  smi_line) -> dict:
    """PHOLD 4096 on the chained drain with the CPU model or over the
    jittered graph, to VARIANT_STOP_NS, held to its JAX/CPU pin."""
    eng, init = phold_variant(phold, engine, topology, which, dev)
    merge.launches = 0
    eng, st, wall = run_engine(eng, init, VARIANT_STOP_NS)
    launches = merge.launches
    leaves = convert.engine_state_to_numpy(st)
    ev = int(leaves["stats.n_executed"].sum())
    digest = convert.leaves_digest(leaves)
    run = {"events": ev, "wall_s": wall, "events_per_s": ev / wall,
           "inner_steps": int(leaves["stats.n_inner_steps"]),
           "sweeps": int(leaves["stats.n_sweeps"]),
           "net_dropped": int(leaves["stats.n_net_dropped"].sum()),
           "host_syncs": eng.host_syncs, "launches": launches}
    print(f"  {which}: {json.dumps(run)} ({smi_line})")
    check((ev, digest) == pin, f"{which}: (events, digest) {(ev, digest)} "
                               f"!= JAX/CPU {pin}")
    check(launches >= run["sweeps"] > 0,
          f"{which}: merge launches {launches} < sweeps {run['sweeps']}")
    return run


def run_phold_net(sim_mod, config_mod, merge, which, dev, workdir):
    """Build a PHOLD-net run from its config with the port's
    build_simulation and run it to the config's stoptime on the card;
    returns (simulation, final state, wall seconds, merge launches)."""
    import torch

    text, kw = phold_net_config(which, workdir)
    sim = sim_mod.build_simulation(config_mod.parse_config(text),
                                   seed=NET_SEED, device=dev, **kw)
    torch.cuda.synchronize()
    merge.launches = 0
    t0 = time.perf_counter()
    st = sim.run()
    torch.cuda.synchronize()
    return sim, st, time.perf_counter() - t0, merge.launches


def check_phold_net(which, sim, st, wall, launches, convert, pin,
                    smi_line) -> dict:
    """Hold a PHOLD-net run to its JAX/CPU pin and to at least one merge
    launch per sweep; returns its record."""
    leaves = convert.engine_state_to_numpy(st)
    got = (int(leaves["stats.n_executed"].sum()),
           convert.leaves_digest(leaves),
           int(leaves["hosts.app.n_sent"].sum()),
           int(leaves["hosts.app.n_recv"].sum()))
    sweeps = int(leaves["stats.n_sweeps"])
    run = {"events": got[0], "wall_s": wall, "events_per_s": got[0] / wall,
           "inner_steps": int(leaves["stats.n_inner_steps"]),
           "sweeps": sweeps, "windows": int(leaves["stats.n_windows"]),
           "host_syncs": sim.engine.host_syncs, "launches": launches,
           "sent": got[2], "received": got[3],
           "codel_count_max": int(leaves["hosts.net.codel.count"].max()),
           "tail_drops": int(leaves["hosts.net.nic_rx.drops"].sum())}
    print(f"  phold-net {which}: {json.dumps(run)} ({smi_line})")
    check(got == pin, f"phold-net {which}: (events, digest, sent, "
                      f"received) {got} != JAX/CPU {pin}")
    check(launches >= sweeps > 0,
          f"phold-net {which}: merge launches {launches} < sweeps {sweeps}")
    return run, leaves


def phase_phold_net(sim_mod, config_mod, merge, events, convert, dev,
                    smi_line, workdir) -> dict:
    """PHOLD over the UDP stack at 4096 x 8 through build_simulation, held
    to PIN_NET; the merge kernel held to its plain version on the inputs
    of the run's first merges (nw = 6) and timed on the last of them;
    a profile of its first 150 ms of traffic; then the two variants."""
    seen = []
    kernel = merge.fused_merge

    def record(*args):
        if len(seen) < 6:
            seen.append(tuple(a.clone() for a in args))
        return kernel(*args)

    events.merge.fused_merge = record
    try:
        sim, st, wall, launches = run_phold_net(sim_mod, config_mod, merge,
                                                "main", dev, workdir)
    finally:
        events.merge.fused_merge = kernel
    main, _ = check_phold_net("main", sim, st, wall, launches, convert,
                              PIN_NET, smi_line)
    check(len(seen) >= 2, "no merge inputs captured from PHOLD-net")
    for i, args in enumerate(seen):
        nw = args[2].shape[-1]
        check(nw == 6, f"PHOLD-net merge input {i} has nw={nw}, not 6")
        bad = compare_merge(merge, args)
        check(bad == 0, f"merge kernel != plain on PHOLD-net input {i}: "
                        f"{bad} elements differ")
        print(f"  merge == plain on PHOLD-net input {i}: "
              f"h={args[0].shape[0]} hc={args[0].shape[1]} "
              f"w={args[5].shape[1]} nw={nw} m={args[3].shape[0]}")
    timing = time_captured(merge, dev, seen[-1], smi_line,
                           f"captured PHOLD-net flush (nw=6, "
                           f"m={seen[-1][3].shape[0]})")
    prof = profile_run(sim.engine.run, sim.state0, SECOND + 150 * MS)
    print(f"  profile of PHOLD-net 4096, first 150 ms of traffic: "
          f"{json.dumps(prof)}")
    out = {"main": main, "timing": timing, "profile": prof}

    sim, st, wall, launches = run_phold_net(sim_mod, config_mod, merge,
                                            "codel", dev, workdir)
    out["codel"], leaves = check_phold_net("codel", sim, st, wall, launches,
                                           convert, PIN_NET_CODEL, smi_line)
    recv = leaves["hosts.app.n_recv"]
    check(recv[:NET_HOT].sum() > recv.sum() / 2,
          "phold-net codel: the hot peers did not receive most messages")
    check(out["codel"]["codel_count_max"] >= 6,
          "phold-net codel: CoDel never reached count 6")
    check(tuple(sim.engine.cpu_cost.shape) == (NET_HOSTS, 3)
          and sim.engine._cpu_enabled,
          "phold-net codel: the fused CPU-cost table was not used")

    sim, st, wall, launches = run_phold_net(sim_mod, config_mod, merge,
                                            "unfused", dev, workdir)
    out["unfused"], leaves = check_phold_net(
        "unfused", sim, st, wall, launches, convert, PIN_NET_UNFUSED,
        smi_line)
    check(leaves["stats.n_by_kind"][:, 1].sum() > 0,
          "phold-net unfused: no KIND_PKT_RX event ran")
    print(json.dumps({"phold_net_4096": out["main"],
                      "phold_net_codel": out["codel"],
                      "phold_net_unfused": out["unfused"],
                      "card": smi_line}))
    return out


class MergeRecorder:
    """While active, counts the merge calls of a live run by queue width
    hc and keeps clones of their inputs: at each width the first three,
    the one at call `timed_call` and the last."""

    def __init__(self, merge, events, timed_call: int):
        import collections

        self.events, self.timed_call = events, timed_call
        self.by_hc = collections.Counter()
        self.kept = collections.defaultdict(list)
        self.last = {}
        self.kernel = merge.fused_merge

    def _record(self, *args):
        hc = args[0].shape[1]
        self.by_hc[hc] += 1
        copy = tuple(a.clone() for a in args)
        if len(self.kept[hc]) < 3 or self.by_hc[hc] == self.timed_call:
            self.kept[hc].append(copy)
        else:
            self.last[hc] = copy
        return self.kernel(*args)

    def __enter__(self):
        self.events.merge.fused_merge = self._record
        return self

    def __exit__(self, *exc):
        self.events.merge.fused_merge = self.kernel

    def captured(self) -> list:
        """(hc, inputs) of every kept call, by width."""
        return [(hc, a) for hc in sorted(self.kept)
                for a in self.kept[hc] + ([self.last[hc]]
                                          if hc in self.last else [])]


def check_and_time_captured(merge, dev, rec: MergeRecorder, smi_line,
                            model: str, capacity: int) -> dict:
    """Hold the kernel to its plain version on every input `rec` kept,
    then time it on the latest kept input of each width (the one at call
    `timed_call` where the run got that far), at the full queue width
    (`capacity`) also at 1, 2, 4 and 8 rows per block: {hc: row}."""
    import torch

    captured = rec.captured()
    check(len(captured) >= 4, f"{model}: only {len(captured)} merge inputs "
                              "captured")
    for i, (hc, args) in enumerate(captured):
        bad = compare_merge(merge, args)
        check(bad == 0, f"merge kernel != plain on {model} input {i} "
                        f"(hc={hc}): {bad} elements differ")
        print(f"  merge == plain on {model} input {i}: h={args[0].shape[0]} "
              f"hc={hc} w={args[5].shape[1]} nw={args[2].shape[-1]} "
              f"m={args[3].shape[0]} admitted={int(args[7].sum())}")
    timing = {}
    for hc in sorted(rec.kept):
        args = rec.kept[hc][-1]
        call = (rec.timed_call if len(rec.kept[hc]) > 3
                else len(rec.kept[hc]))
        timing[hc] = time_captured(
            merge, dev, args, smi_line,
            f"captured {model} flush (hc={hc}, merge call {call}, "
            f"m={args[3].shape[0]})", sweep_plans=hc == capacity)
    rec.kept.clear()
    rec.last.clear()
    torch.cuda.empty_cache()
    return timing


def phase_tgen(sim_mod, config_mod, merge, events, convert, dev,
               smi_line) -> dict:
    """TGen at TGEN_PAIRS through build_simulation, run once, held to
    PIN_TGEN and to a merge launch per sweep; merge launches counted by
    queue width hc; the kernel held to its plain version on captured
    inputs (at each width the first three, the one at call
    TGEN_TIMED_CALL, mid-run, and the last) and timed on the latest of
    them before the last, which flushes an empty run; a profile of the
    first sim-second of client traffic. (Phase 15 runs the same config
    on the frontier drain, where PR 6 ran it a second time here.)"""
    import torch

    t0 = time.perf_counter()
    sim = sim_mod.build_simulation(
        config_mod.parse_config(tgen_config(TGEN_PAIRS)), seed=TGEN_SEED,
        n_sockets=TGEN_SOCKETS, capacity=TGEN_CAPACITY, device=dev)
    sim.strict_overflow = False
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    print(f"  built TGen {TGEN_PAIRS} pairs in {build_s:.1f} s")
    rec = MergeRecorder(merge, events, TGEN_TIMED_CALL)
    syncs0 = sim.engine.host_syncs
    torch.cuda.synchronize()
    merge.launches = 0
    t0 = time.perf_counter()
    with rec:
        st = sim.run()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = merge.launches
    leaves = convert.engine_state_to_numpy(st)
    got = tgen_pin(leaves)
    run = {"events": got[0], "windows": got[1], "sweeps": got[2],
           "inner_steps": got[3], "streams_done": got[4],
           "wall_s": wall, "events_per_s": got[0] / wall,
           "ms_per_inner_step": 1e3 * wall / max(got[3], 1),
           "host_syncs": sim.engine.host_syncs - syncs0,
           "launches": launches,
           "launches_by_hc": dict(sorted(rec.by_hc.items())),
           "queue_drops": int(leaves["queues.drops"].sum()),
           "retransmits": int(leaves["hosts.net.tcb.n_retx"].sum())}
    print(f"  tgen run: {json.dumps(run)} ({smi_line})")
    check(sum(rec.by_hc.values()) == launches,
          f"tgen: {sum(rec.by_hc.values())} merge calls by hc != "
          f"{launches} launches")
    check(got == PIN_TGEN, f"tgen: (events, windows, sweeps, inner "
                           f"steps, streams, digest) {got} != JAX/CPU "
                           f"{PIN_TGEN}")
    check(launches >= got[2] > 0,
          f"tgen: merge launches {launches} < sweeps {got[2]}")
    less_inner = convert.leaves_digest(leaves, ("stats.n_inner_steps",))
    check(less_inner == TGEN_LESS_INNER,
          f"tgen: digest less n_inner_steps {less_inner} != "
          f"{TGEN_LESS_INNER}")
    del st, leaves

    timing = check_and_time_captured(merge, dev, rec, smi_line, "TGen",
                                     TGEN_CAPACITY)
    print(json.dumps({"tgen_4096": run, "card": smi_line}))
    return {"runs": [run], "timing": timing,
            "by_hc": run["launches_by_hc"], "build_s": build_s}


def phase_skew(phold, pressure, merge, events, convert, dev,
               smi_line) -> dict:
    """Phase 14: bench.py's skew shape three times to SKEW_STOP_NS: at
    SKEW_CAPACITY with drops, with a SKEW_SPILL-slot spill ring through
    run_with_spill, and at twice the capacity with drops. Each is held
    to its JAX/CPU pin and to a merge launch per sweep; the spill run
    loses nothing, equals the 2C run in the BEHAVIOUR leaves, and its
    device queue and reservoir partition the 2C run's queue. The merge
    kernel is held to its plain version on the spill run's first
    full-width admission round (the ring's loop) and first refill push,
    and timed on each; launches are counted by (hc, w)."""
    import collections

    import torch

    def build(cap, spill=0):
        return phold.build(4096, device=dev, batched=True, spill=spill,
                           **dict(SKEW, capacity=cap))

    out, leaves_of = {}, {}
    for label, cap, pin in (("drop", SKEW_CAPACITY, PIN_SKEW_DROP),
                            ("2c", 2 * SKEW_CAPACITY, PIN_SKEW_2C)):
        merge.launches = 0
        eng, st, wall = run_engine(*build(cap), SKEW_STOP_NS)
        leaves = convert.engine_state_to_numpy(st)
        got = skew_pin(leaves)
        run = {"capacity": cap, "events": got[0], "queue_drops": got[1],
               "sweeps": int(leaves["stats.n_sweeps"]),
               "windows": int(leaves["stats.n_windows"]), "wall_s": wall,
               "events_per_s": got[0] / wall, "host_syncs": eng.host_syncs,
               "launches": merge.launches}
        print(f"  skew {label}: {json.dumps(run)} ({smi_line})")
        check(got == pin, f"skew {label}: (events, drops, digest) {got} != "
                          f"JAX/CPU {pin}")
        check(run["launches"] >= run["sweeps"] > 0,
              f"skew {label}: merge launches {run['launches']} < sweeps")
        out[label], leaves_of[label] = run, leaves

    eng, init = build(SKEW_CAPACITY, SKEW_SPILL)
    ctrl = pressure.PressureController(4096, SKEW_CAPACITY,
                                       eng.cfg.lookahead,
                                       n_args=phold.N_PHOLD_ARGS)
    by_w = collections.Counter()
    kept = {}
    kernel, push = merge.fused_merge, ctrl._push
    in_refill = []

    def record(*args):
        hc, w = args[0].shape[1], args[5].shape[1]
        by_w[f"{hc}x{w}"] += 1
        label = ("refill" if in_refill
                 else "loop" if w == SKEW_CAPACITY else None)
        if label and label not in kept:
            kept[label] = tuple(a.clone() for a in args)
        return kernel(*args)

    def refill(*a, **k):
        in_refill.append(True)
        try:
            return push(*a, **k)
        finally:
            in_refill.pop()

    st = init()
    torch.cuda.synchronize()
    merge.launches = 0
    events.merge.fused_merge, ctrl._push = record, refill
    t0 = time.perf_counter()
    try:
        st = pressure.run_with_spill(eng, st, SKEW_STOP_NS, ctrl)
        torch.cuda.synchronize()
    finally:
        events.merge.fused_merge, ctrl._push = kernel, push
    wall = time.perf_counter() - t0
    leaves = convert.engine_state_to_numpy(st)
    got = skew_pin(leaves, ctrl)
    run = {"capacity": SKEW_CAPACITY, "spill_slots": SKEW_SPILL,
           "events": got[0], "queue_drops": got[1], "spilled": got[2],
           "harvested": got[3], "refilled": got[4],
           "lost": int(leaves["queues.spill.n_lost"].sum()),
           "overdue": ctrl.n_overdue,
           "fill_hwm": int(leaves["queues.spill.fill_hwm"].max()),
           "reservoir_left": int(ctrl.resident().sum()),
           "sweeps": int(leaves["stats.n_sweeps"]),
           "windows": int(leaves["stats.n_windows"]),
           "boundaries": ctrl.boundaries, "wall_s": wall,
           "events_per_s": got[0] / wall,
           "host_syncs": eng.host_syncs + ctrl.host_syncs,
           "engine_host_syncs": eng.host_syncs,
           "controller_host_syncs": ctrl.host_syncs,
           "harvest_s": ctrl.harvest_seconds,
           "launches": merge.launches,
           "launches_by_hc_w": dict(sorted(by_w.items()))}
    print(f"  skew spill: {json.dumps(run)} ({smi_line})")
    check(got == PIN_SKEW_SPILL, f"skew spill: (events, drops, spilled, "
                                 f"harvested, refilled, digest) {got} != "
                                 f"JAX/CPU {PIN_SKEW_SPILL}")
    check(run["lost"] == 0 and run["overdue"] == 0,
          f"skew spill lost {run['lost']}, overdue {run['overdue']}")
    check(run["launches"] >= run["sweeps"] > 0,
          f"skew spill: merge launches {run['launches']} < sweeps")
    for key in BEHAVIOUR:
        check(np.array_equal(leaves[key], leaves_of["2c"][key]),
              f"skew spill: {key} differs from the run at twice the "
              "capacity")
    check(np.array_equal(queue_keys(leaves, ctrl),
                         queue_keys(leaves_of["2c"])),
          "skew spill: device queue + reservoir != the 2C run's queue")
    out["spill"] = run
    print("  skew spill == the 2C run in the behaviour leaves; device "
          "queue + reservoir partition its queue")

    check(set(kept) == {"loop", "refill"},
          f"skew spill: captured only {sorted(kept)} merge inputs")
    timing = {}
    for label in ("loop", "refill"):
        args = kept[label]
        bad = compare_merge(merge, args)
        check(bad == 0, f"merge kernel != plain on the spill run's first "
                        f"{label} input: {bad} elements differ")
        timing[label] = time_captured(
            merge, dev, args, smi_line,
            f"captured spill {label} (m={args[3].shape[0]})")
    out["timing"] = timing
    print(json.dumps({"skew": out["drop"], "skew_spill": run,
                      "skew_2c": out["2c"], "card": smi_line}))
    return out


# the config-driven phases run once to their stop by `phase_app`: (config
# text, build keywords, stop in sim-s, merge call to time, pin function,
# pin)
def app_phases() -> dict:
    tgen_kw = dict(seed=TGEN_SEED, n_sockets=TGEN_SOCKETS,
                   capacity=TGEN_CAPACITY)
    return {
        "tor": (tor_config(), TOR_KW, TOR_STOP_S, TOR_TIMED_CALL,
                lambda lv, n: tor_pin(lv), PIN_TOR),
        "btc": (btc_config(), BTC_KW, BTC_STOP_S, BTC_TIMED_CALL,
                btc_pin, PIN_BTC),
        "mixed": (mixed_config(), tgen_kw, MIXED_STOP_S, MIXED_TIMED_CALL,
                  lambda lv, n: mixed_pin(lv), PIN_MIXED),
        "tgen_frontier": (tgen_config(TGEN_PAIRS),
                          dict(tgen_kw, frontier=TGEN_FRONTIER),
                          TGEN_STOP_S, TGEN_TIMED_CALL,
                          lambda lv, n: tgen_frontier_pin(lv),
                          PIN_TGEN_FRONTIER),
        "tgen_faults": (tgen_faults_config(TGEN_PAIRS), tgen_kw,
                        FAULTS_STOP_S, TGEN_TIMED_CALL,
                        lambda lv, n: tgen_faults_pin(lv), PIN_TGEN_FAULTS),
        "tgen_cubic": (tgen_faults_config(TGEN_PAIRS),
                       dict(tgen_kw, tcp_cc="cubic"), FAULTS_STOP_S,
                       TGEN_TIMED_CALL,
                       lambda lv, n: tgen_faults_pin(lv), PIN_TGEN_CUBIC),
    }


def phase_app(model: str, sim_mod, config_mod, merge, events, convert, dev,
              smi_line, cbrt=None) -> dict:
    """A config-driven run at its bench shape through build_simulation
    (`app_phases`: Tor, phase 11; Bitcoin, 12; mixed TGen + PHOLD, 13;
    TGen on the frontier drain, 15; TGen under faults, 16, and with
    CUBIC, 17(c), whose cube-root launches `cbrt` counts), run once to
    its stop in one call:
    held to its JAX/CPU pin and to a merge launch per sweep, merge
    launches counted by queue width; the kernel held to its plain
    version on captured inputs at every width reached and timed on the
    latest of them per width."""
    import torch

    text, kw, stop_s, timed_call, pin_fn, pin = app_phases()[model]
    t0 = time.perf_counter()
    sim = sim_mod.build_simulation(config_mod.parse_config(text), device=dev,
                                   **kw)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    print(f"  built {model} ({len(sim.names)} hosts) in {build_s:.1f} s")
    rec = MergeRecorder(merge, events, timed_call)
    syncs0 = sim.engine.host_syncs
    torch.cuda.synchronize()
    merge.launches = 0
    if cbrt is not None:
        cbrt.launches = 0
    t0 = time.perf_counter()
    with rec:
        st = sim.run(int(stop_s * SECOND))
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = merge.launches
    cbrt_launches = cbrt.launches if cbrt is not None else None
    leaves = convert.engine_state_to_numpy(st)
    got = pin_fn(leaves, len(sim.names))
    names = {"tor": ("streams_done", "relayed_bytes"),
             "btc": ("best_min", "best_max", "best_pad_max", "t_best_max"),
             "mixed": ("streams_done", "phold_sent", "phold_received",
                       "hosts_tgen", "hosts_phold"),
             "tgen_frontier": ("streams_done",),
             "tgen_faults": ("streams_done", "fault_dropped", "quarantined",
                             "retransmits"),
             "tgen_cubic": ("streams_done", "fault_dropped", "quarantined",
                            "retransmits")}[model]
    run = {"events": got[0], "windows": got[1], "sweeps": got[2],
           "inner_steps": got[3], "queue_drops": got[4],
           **dict(zip(names, got[5:-1])),
           "wall_s": wall, "events_per_s": got[0] / wall,
           "ms_per_inner_step": 1e3 * wall / max(got[3], 1),
           "host_syncs": sim.engine.host_syncs - syncs0,
           "launches": launches,
           "launches_by_hc": dict(sorted(rec.by_hc.items())),
           "retransmits": int(leaves["hosts.net.tcb.n_retx"].sum())}
    if cbrt_launches is not None:
        run["cbrt_launches"] = cbrt_launches
    print(f"  {model} run: {json.dumps(run)} ({smi_line})")
    check(sum(rec.by_hc.values()) == launches,
          f"{model}: {sum(rec.by_hc.values())} merge calls by hc != "
          f"{launches} launches")
    check(got == pin, f"{model}: pin {got} != JAX/CPU {pin}")
    check(launches >= got[2] > 0,
          f"{model}: merge launches {launches} < sweeps {got[2]}")
    if model == "tgen_frontier":
        # the reference's contract: the chained drain's state, less the
        # count of inner steps
        less_inner = convert.leaves_digest(leaves, ("stats.n_inner_steps",))
        check(less_inner == TGEN_LESS_INNER,
              f"tgen_frontier: digest less n_inner_steps {less_inner} != "
              f"phase 10's {TGEN_LESS_INNER}")
        run["state_less_inner_steps_equals_chained"] = True
    if model in ("tgen_faults", "tgen_cubic"):
        # every overlay fired: drops to faulted links and dead hosts,
        # events voided by crashes, and TCP's loss paths at width
        check(min(run["fault_dropped"], run["quarantined"],
                  run["retransmits"]) > 0,
              f"{model}: an overlay did not fire: {run}")
        run["fault_epochs"] = sim.faults.n_epochs
    if model == "tgen_cubic":
        # CUBIC ran congestion avoidance on loss epochs (W_max above
        # cwnd), and every inner step's ACK pass took the cube root
        wmax, cwnd = (leaves[f"hosts.net.tcb.{f}"] for f in ("cc_wmax",
                                                             "cwnd"))
        run["rows_wmax_above_cwnd"] = int((wmax > cwnd).sum())
        run["rows_in_epoch"] = int(
            (leaves["hosts.net.tcb.cc_epoch"] != 0).sum())
        check(run["rows_wmax_above_cwnd"] > 0 and run["rows_in_epoch"] > 0,
              f"tgen_cubic: no congestion-avoidance epoch: {run}")
        check(cbrt_launches >= got[3] > 0,
              f"tgen_cubic: cbrt launches {cbrt_launches} < inner steps "
              f"{got[3]}")
    del st, leaves
    timing = check_and_time_captured(merge, dev, rec, smi_line, model,
                                     kw["capacity"])
    print(json.dumps({f"{model}_bench": run, "card": smi_line}))
    return {"run": run, "timing": timing, "by_hc": run["launches_by_hc"],
            "build_s": build_s}


def cbrt_bound_ms(n: int) -> tuple[float, str]:
    """(least time on the card in ms, what bounds it) for n cube roots:
    4 bytes read and 4 written each, against CBRT_OPS f64 operations."""
    bytes_ms = 8 * n / HBM_BYTES_PER_S * 1e3
    ops_ms = CBRT_OPS * n / FP64_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def time_cbrt(cbrt, x, reps: int) -> dict:
    """The cube root kernel's device time per launch on x, beside its
    bound, the plain version's time and torch.pow's (a yardstick that
    computes another cube root, rounded otherwise)."""
    import torch

    bound_ms, by = cbrt_bound_ms(x.numel())
    k_ms = device_ms(lambda: cbrt.cbrt(x), reps, per_call=1)
    plain_ms = device_ms(lambda: cbrt.cbrt_plain(x), max(2, reps // 20))
    pow_ms = device_ms(lambda: torch.pow(x.abs(), 1.0 / 3.0), reps)
    return {"n": x.numel(), "ms": k_ms, "us": k_ms * 1e3,
            "bound_ms": bound_ms, "bound_us": bound_ms * 1e3,
            "bound_by": by, "share": bound_ms / k_ms,
            "plain_ms": plain_ms, "pow_yardstick_ms": pow_ms}


def phase_cbrt(cbrt, dev, smi_line) -> dict:
    """Phase 17(a)-(b): the cube-root kernel equals its plain version on
    every f32 of [0, 2560], chunk by chunk, and the sha256 over its
    outputs equals the glibc pin; the same on the edge inputs outside
    the domain; then its time at TGen's width and over the domain."""
    import torch

    i32 = torch.int32
    h = hashlib.sha256()
    t0 = time.perf_counter()
    n_done = 0
    for start in range(0, CBRT_DOMAIN_END + 1, CBRT_CHUNK):
        n = min(CBRT_CHUNK, CBRT_DOMAIN_END + 1 - start)
        x = torch.arange(start, start + n, dtype=i32, device=dev).view(
            torch.float32)
        got = cbrt.cbrt(x)
        want = cbrt.cbrt_plain(x)
        check(torch.equal(got.view(i32), want.view(i32)),
              f"cbrt kernel != plain on [{start:#x}, {start + n:#x}): "
              f"{int((got.view(i32) != want.view(i32)).sum())} differ")
        h.update(got.cpu().numpy().tobytes())
        n_done += n
    sha = h.hexdigest()
    check(n_done == CBRT_DOMAIN_END + 1, f"cbrt covered {n_done} inputs")
    check(sha == PIN_CBRT_SHA256,
          f"cbrt sha256 over [0, 2560] {sha} != glibc's {PIN_CBRT_SHA256}")
    print(f"  cbrt == plain on all {n_done:,} f32 in [0, 2560]; sha256 "
          f"{sha[:16]} == glibc 2.36 powf under DAZ "
          f"({time.perf_counter() - t0:.1f} s)")
    pos = torch.tensor(CBRT_EDGES, dtype=torch.int64)
    rng = np.random.default_rng(17)
    pos = torch.cat([pos, torch.from_numpy(
        rng.integers(0, 0x7F800000, 4096))])
    bits = torch.cat([pos, pos | 0x80000000])
    bits = (bits - ((bits >> 31) << 32)).to(i32).to(dev)
    x = bits.view(torch.float32)
    got, want = cbrt.cbrt(x).view(i32), cbrt.cbrt_plain(x).view(i32)
    check(torch.equal(got, want),
          f"cbrt kernel != plain on {int((got != want).sum())} edge inputs")
    print(f"  cbrt == plain on {x.numel()} edge inputs (negatives, "
          "subnormals, zeros, infinities, nans)")
    width = torch.arange(0x3F800000, 0x3F800000 + 4096, dtype=i32,
                         device=dev).view(torch.float32)
    check(torch.equal(cbrt.cbrt(width).view(i32),
                      cbrt.cbrt_plain(width).view(i32)),
          "cbrt kernel != plain at TGen's width (4096 rows)")
    chunk = torch.arange(0, CBRT_CHUNK, dtype=i32, device=dev).view(
        torch.float32)
    timing = {"tgen_width": time_cbrt(cbrt, width, 400),
              "domain_chunk": time_cbrt(cbrt, chunk, 20)}
    per_input = timing["domain_chunk"]["ms"] / CBRT_CHUNK
    timing["domain_ms"] = per_input * (CBRT_DOMAIN_END + 1)
    timing["domain_bound_ms"] = cbrt_bound_ms(CBRT_DOMAIN_END + 1)[0]
    print(json.dumps({"cbrt_timing": timing, "card": smi_line}))
    return timing


def phase_trace(phold, engine, topology, pressure, sim_mod, config_mod,
                trace_mod, merge, convert, dev, smi_line) -> dict:
    """Phase 18: a traced, stats-on run on each drain, held to its pin
    (trace_pin): (a) the chained drain over phase 8's jittered, lossy
    graph, drained at each TRACE_SEGMENTS_S stop; (b) the batched drain
    with phase 14's spill ring and the controller's spill/refill rows;
    (c) the frontier drain on phase 15's config to TRACE_FRONTIER_STOP_S.
    Each also holds a merge launch per sweep."""
    import torch

    out = {}

    def finish(label, st, drain, wall, pin, syncs, launches):
        leaves = convert.engine_state_to_numpy(st)
        got = trace_pin(leaves, drain)
        run = {"events": got[0],
               "records_by_op": dict(zip(trace_mod.OP_NAMES.values(),
                                         got[1:7])),
               "lost": got[7], "records": drain.n_records,
               "truncated": drain.truncated,
               "inner_steps": int(leaves["stats.n_inner_steps"]),
               "sweeps": int(leaves["stats.n_sweeps"]),
               "wall_s": wall,
               "ms_per_inner_step": (1e3 * wall / int(
                   leaves["stats.n_inner_steps"])
                   if int(leaves["stats.n_inner_steps"]) else None),
               "host_syncs": syncs, "launches": launches}
        print(f"  traced {label}: {json.dumps(run)} ({smi_line})")
        check(got == pin, f"traced {label}: pin {got} != JAX/CPU {pin}")
        check(launches >= run["sweeps"] > 0,
              f"traced {label}: merge launches {launches} < sweeps")
        out[label] = run

    # (a) the chained drain, drained per segment
    eng, init = phold_variant(phold, engine, topology, "jitter", dev,
                              trace=TRACE_CHAINED_CAP, stats=1)
    drain = trace_mod.TraceDrain(TRACE_CHAINED_CAP)
    st = init()
    torch.cuda.synchronize()
    merge.launches = 0
    t0 = time.perf_counter()
    for stop_s in TRACE_SEGMENTS_S:
        st = drain.drain_state(eng.run(st, stop_s * SECOND))
    torch.cuda.synchronize()
    finish("chained", st, drain, time.perf_counter() - t0,
           PIN_TRACE_CHAINED, eng.host_syncs, merge.launches)
    check(out["chained"]["records_by_op"]["drop"] > 0,
          "traced chained: the lossy graph dropped nothing")

    # (b) the batched drain with the spill ring
    eng, init = phold.build(4096, device=dev, batched=True, spill=SKEW_SPILL,
                            trace=TRACE_SPILL_CAP, stats=1,
                            **dict(SKEW, capacity=SKEW_CAPACITY))
    ctrl = pressure.PressureController(4096, SKEW_CAPACITY,
                                       eng.cfg.lookahead,
                                       n_args=phold.N_PHOLD_ARGS)
    drain = trace_mod.TraceDrain(TRACE_SPILL_CAP)
    ctrl.attach_trace(drain, len_arg=eng.cfg.trace_len_arg)
    st = init()
    torch.cuda.synchronize()
    merge.launches = 0
    t0 = time.perf_counter()
    st = drain.drain_state(pressure.run_with_spill(eng, st, SKEW_STOP_NS,
                                                   ctrl))
    torch.cuda.synchronize()
    finish("spill", st, drain, time.perf_counter() - t0, PIN_TRACE_SPILL,
           eng.host_syncs + ctrl.host_syncs, merge.launches)
    ops = out["spill"]["records_by_op"]
    check(ops["spill"] > 0 and ops["refill"] > 0,
          f"traced spill: no spill/refill records: {ops}")

    # (c) the frontier drain
    sim = sim_mod.build_simulation(
        config_mod.parse_config(tgen_config(TGEN_PAIRS)), device=dev,
        seed=TGEN_SEED, n_sockets=TGEN_SOCKETS, capacity=TGEN_CAPACITY,
        frontier=TGEN_FRONTIER, trace=TRACE_FRONTIER_CAP, stats=1)
    drain = trace_mod.TraceDrain(TRACE_FRONTIER_CAP)
    syncs0 = sim.engine.host_syncs
    torch.cuda.synchronize()
    merge.launches = 0
    t0 = time.perf_counter()
    st = drain.drain_state(sim.run(TRACE_FRONTIER_STOP_S * SECOND))
    torch.cuda.synchronize()
    finish("frontier", st, drain, time.perf_counter() - t0,
           PIN_TRACE_FRONTIER, sim.engine.host_syncs - syncs0,
           merge.launches)
    check(int(convert.engine_state_to_numpy(st)["splane.runlen_n"].sum())
          > 0, "traced frontier: no run-length samples")
    print(json.dumps({"traced": out, "card": smi_line}))
    return out


def phase_cli(merge, smi_line, tgen_wall_s=None) -> dict:
    """`shadow_tpu_torch.cli.main` in-process on phase 10's TGen config:
    a run to CLI_STOP_S with a checkpoint at 3 s, then a resume from
    that checkpoint, each with its stdout captured, the merge launches
    counted from zero and required, and both held to PIN_CLI_TGEN; the
    resumed run's final state must equal the uninterrupted run's."""
    import contextlib
    import io
    import os
    import shutil
    from pathlib import Path

    import torch

    from shadow_tpu_torch import cli

    pins, runs = {}, {}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        base = Path(tmp)
        # the resumed run also times its phases (--profile: the summary's
        # "profile", which strip_log drops, so the pins hold either way)
        for label, extra in (("run", []),
                             ("resumed", ["--resume", "auto", "--profile"])):
            d = base / label
            d.mkdir()
            if label == "resumed":
                shutil.copy(base / "run" / CLI_MID_CKPT, d / CLI_CKPT)
            (d / "tgen.xml").write_text(tgen_config(TGEN_PAIRS))
            out, cwd, last = io.StringIO(), os.getcwd(), {}
            torch.cuda.synchronize()
            merge.launches = 0
            t0 = time.perf_counter()
            os.chdir(d)
            try:
                with contextlib.redirect_stdout(out):
                    rc = cli.main(CLI_ARGV + extra, run_info=last)
            finally:
                os.chdir(cwd)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = merge.launches
            check(rc == 0, f"cli {label}: exit code {rc}")
            check(launches > 0, f"cli {label}: no merge launch")
            pins[label] = cli_pin_fields(out.getvalue(), d)
            summary = json.loads([ln for ln in out.getvalue().splitlines()
                                  if ln.startswith("{")][-1])
            inner = [0, 0]
            for k, name in enumerate((CLI_MID_CKPT, CLI_CKPT)):
                with np.load(d / name) as data:
                    h = json.loads(bytes(data["__header__"]).decode())
                    i = h["paths"].index(".stats.n_inner_steps")
                    inner[k] = int(data[f"leaf_{i}"])
            # the resumed run starts at the mid-run checkpoint's steps
            steps = inner[1] - (inner[0] if label == "resumed" else 0)
            runs[label] = {
                "wall_s": wall, "launches": launches,
                "inner_steps": steps,
                "ms_per_inner_step": 1e3 * last["loop_s"] / steps,
                "segments": last["segments"],
                "harvest_reads_per_segment":
                    last["harvest_reads"] / last["segments"],
                "host_syncs_per_segment":
                    last["host_syncs"] / last["segments"],
                "harvest_s": last["harvest_s"],
                "harvest_share": last["harvest_s"] / last["loop_s"],
                "loop_s": last["loop_s"],
                "events": pins[label]["summary"]["events"],
                "profile_phases": (summary.get("profile") or {}).get(
                    "phases"),
            }
            print(f"  cli {label}: {json.dumps(runs[label])} ({smi_line})")
    got = cli_pin_of(pins)
    for label in ("run", "resumed"):
        for key, val in got[label].items():
            want = (PIN_CLI_TGEN or {}).get(label, {}).get(key)
            check(val == want, f"cli {label}: {key} {val} != JAX/CPU {want}")
    check(got["run"]["final_digest"] == got["resumed"]["final_digest"],
          "cli: the resumed run's final state differs from the run's")
    phase_s = time.perf_counter() - t_phase
    print(json.dumps({"cli": runs, "phase_s": phase_s,
                      "tgen_phase10_wall_s": tgen_wall_s,
                      "card": smi_line}))
    return {"runs": runs, "phase_s": phase_s}


def profile_window(step, st, inner_steps):
    """Device kernels of one `step(st)` (one window) on the card per
    inner-step iteration, `inner_steps(before, after)` counting the
    iterations: (kernels per iteration, iterations, final state)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = step(st)
        torch.cuda.synchronize()
    n = inner_steps(st, out)
    return len(device_kernels(prof)) / max(n, 1), n, out


def phase_fleet(sim_mod, config_mod, merge, events, convert, dev, smi_line,
                cli_phase=None) -> dict:
    """Scenario fleets: (a) `cli.main` in-process with --fleet on phase
    19's config (FLEET_LANES lanes, per-lane seeds, faults and latency
    scales) to FLEET_STOP_S, its stdout held to PIN_CLI_FLEET's summary
    fields and [fleet] rows; (b) the same lanes through `build_fleet` +
    `Fleet.run` to the stop, each lane's digest held to the pin, the
    merge held to its plain version on the fleet's captured inputs (L x
    H rows) and its launches counted per merge round; (c) lane 0's solo
    run on the same build, whose digest must equal lane 0's; then one
    window of each profiled from the final states: device launches per
    inner step, fleet against solo."""
    import contextlib
    import io
    import os
    from pathlib import Path

    import torch

    from shadow_tpu_torch import cli

    t_phase = time.perf_counter()
    pin = PIN_CLI_FLEET or {}
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        (d / "tgen.xml").write_text(tgen_config(TGEN_PAIRS))
        (d / "faults.txt").write_text("\n".join(FLEET_FAULT_LINES) + "\n")
        out, cwd, last = io.StringIO(), os.getcwd(), {}
        torch.cuda.synchronize()
        merge.launches = 0
        t0 = time.perf_counter()
        os.chdir(d)
        try:
            with contextlib.redirect_stdout(out):
                rc = cli.main(fleet_argv("faults.txt"), run_info=last)
        finally:
            os.chdir(cwd)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        cli_launches = merge.launches
        plan = fleet_plan(d / "faults.txt", cli)
    check(rc == 0, f"fleet cli: exit code {rc}")
    check(cli_launches > 0, "fleet cli: no merge launch")
    got = fleet_pin_fields(out.getvalue())
    for key in ("summary", "rows_sha256"):
        check(got[key] == pin.get(key),
              f"fleet cli: {key} {got[key]} != JAX/CPU {pin.get(key)}")
    lanes = got["summary"]["lanes"]
    check(all(lanes[k] != lanes[0] for k in range(1, FLEET_LANES)),
          "fleet cli: a faulted lane equals the fault-free lane")
    cli_run = {
        "wall_s": wall, "launches": cli_launches,
        "loop_s": last["loop_s"], "segments": last["segments"],
        "harvest_reads_per_segment":
            last["harvest_reads"] / last["segments"],
        "host_syncs": last["host_syncs"],
        "events": got["summary"]["events"],
        "scenarios_per_s": FLEET_LANES / last["loop_s"],
    }
    print(f"  fleet cli: {json.dumps(cli_run)} ({smi_line})")

    # (b) the lanes in one Fleet.run, (c) lane 0 alone, on one build
    sim = sim_mod.build_simulation(
        config_mod.parse_config(tgen_config(TGEN_PAIRS)), device=dev,
        **FLEET_BUILD_KW)
    fleet = sim.build_fleet(FLEET_LANES, **plan)
    runs = {}
    rounds = {}
    states = {}
    for label in ("fleet", "solo"):
        rec = MergeRecorder(merge, events, TGEN_TIMED_CALL)
        eng = fleet.engine if label == "fleet" else sim.engine
        syncs0 = eng.host_syncs
        torch.cuda.synchronize()
        merge.launches = 0
        t0 = time.perf_counter()
        with rec:
            st = (fleet.run(FLEET_STOP_NS) if label == "fleet"
                  else sim.run(FLEET_STOP_NS))
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, merge_rounds = merge.launches, sum(rec.by_hc.values())
        steps = st.stats.n_inner_steps.max().item()
        runs[label] = {"wall_s": wall, "launches": launches,
                       "merge_rounds": merge_rounds,
                       "launches_per_round": launches / max(merge_rounds, 1),
                       "inner_steps": steps,
                       "ms_per_inner_step": 1e3 * wall / max(steps, 1),
                       "host_syncs": eng.host_syncs - syncs0,
                       "launches_by_hc": dict(sorted(rec.by_hc.items()))}
        check(launches == merge_rounds > 0,
              f"fleet {label}: {launches} merge launches for "
              f"{merge_rounds} merge rounds")
        if label == "fleet":
            timing = check_and_time_captured(merge, dev, rec, smi_line,
                                             "fleet", TGEN_CAPACITY)
        rounds[label] = rec
        states[label] = st
    leaves = convert.fleet_state_to_numpy(states["fleet"])
    digests = [convert.leaves_digest(convert.lane_of(leaves, i))
               for i in range(FLEET_LANES)]
    check(digests == pin.get("lane_digests"),
          f"fleet: lane digests {digests} != JAX/CPU "
          f"{pin.get('lane_digests')}")
    solo = convert.leaves_digest(convert.engine_state_to_numpy(
        states["solo"]))
    check(solo == digests[0],
          f"fleet: lane 0 {digests[0]} != its solo run {solo}")
    del leaves
    # one window past the stop, profiled: device launches per inner-step
    # iteration (the fleet's runs while any lane has a step to run)
    step_ns = FLEET_STOP_NS + 100 * 1_000_000
    per_step = {}
    for label, step in (("fleet", lambda s: fleet.step_window(s, step_ns)),
                        ("solo", lambda s: sim.step_window(s, step_ns))):
        per_step[label] = profile_window(
            step, states[label],
            lambda a, b: int((b.stats.n_inner_steps
                              - a.stats.n_inner_steps).max()))[:2]
    result = {
        "cli": cli_run, "runs": runs, "timing": timing,
        "device_launches_per_inner_step": {
            k: v[0] for k, v in per_step.items()},
        "profiled_inner_steps": {k: v[1] for k, v in per_step.items()},
        "fleet_vs_solo_ms_per_inner_step":
            runs["fleet"]["ms_per_inner_step"]
            / runs["solo"]["ms_per_inner_step"],
        "phase19_ms_per_inner_step":
            (cli_phase or {}).get("runs", {}).get("run", {}).get(
                "ms_per_inner_step"),
        "lane_digests_equal_pin": True, "lane0_equals_solo": True,
        "phase_s": time.perf_counter() - t_phase,
    }
    print(json.dumps({"fleet": result, "card": smi_line}))
    return result


def serve_launch_walls(records) -> dict:
    """{launch id: (class, wall seconds, beats, summed beat + confirm
    seconds, pack seconds)} from a serve flight ledger's records: a
    launch's wall runs from its first record (cache) to its last
    (confirm, or the failed attempt's last beat); its pack span covers
    the cache get or build, make_inputs and a snapshot's load."""
    spans: dict = {}
    for r in records:
        if "launch" in r:
            spans.setdefault(int(r["launch"]), []).append(r)
    out = {}
    for n, rs in sorted(spans.items()):
        t0 = min(r["t_s"] for r in rs)
        t1 = max(r["t_s"] + r["dur_s"] for r in rs)
        run = [r for r in rs if r["name"] in ("beat", "confirm")]
        out[n] = (rs[0].get("cls"), t1 - t0,
                  sum(r["name"] == "beat" for r in run),
                  sum(r["dur_s"] for r in run),
                  sum(r["dur_s"] for r in rs if r["name"] == "pack"))
    return out


def phase_serve(merge, events, convert, dev, smi_line,
                fleet_phase=None) -> dict:
    """The serving plane: (a) an in-process SimService (SERVE_LANES
    lanes, a flight ledger, a beat snapshot, the one-shot SERVE_CHAOS
    raise) behind its HTTP server on 127.0.0.1, driven by
    tools/serve_client's `run_load`: every served summary held to
    PIN_SERVE; class A resumed from its beat-1 snapshot; its seed-1
    lane's final leaves to phase 22's lane-0 digest (its solo run);
    class B's pad lanes' counters exactly 0; /metrics to the OpenMetrics
    checker; the ledger reduced by tools/serve_report; at least one
    merge launch per sweep over the served launches; (b) `python -m
    shadow_tpu_torch serve` as a subprocess on the card: one small
    request, its summary equal to the port's solo run here, then
    SIGTERM, exit 0 and the queue file written."""
    import os
    import signal
    import urllib.request
    from pathlib import Path

    import torch

    from shadow_tpu_torch.obs.metrics import validate_openmetrics
    from shadow_tpu_torch.obs.servetrace import ServeTracer, load_ledger
    from shadow_tpu_torch.runtime.fleet import lane_summary_refs
    from shadow_tpu_torch.runtime.harvest import fetch_tree
    from shadow_tpu_torch.serve import SimService, solo_reference
    from shadow_tpu_torch.serve.chaos import ServeChaos
    from shadow_tpu_torch.serve.http import ServeServer
    from shadow_tpu_torch.tools import serve_client, serve_report

    t_phase = time.perf_counter()
    docs = serve_docs()
    last, snaps = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        tracer = ServeTracer(ledger_file=str(d / "ledger.jsonl"),
                             ledger_meta={"max_lanes": SERVE_LANES,
                                          "beat_windows":
                                              SERVE_BEAT_WINDOWS})
        svc = None

        def factory(key, probe):
            # the service's own build, with each fleet's latest state
            # kept (a reference) for the checks after the run
            entry = svc._build_entry(key, probe)
            step = entry.fleet.step_window

            def stepped(*a, **k):
                out = step(*a, **k)
                last[str(key)] = out
                return out
            entry.fleet.step_window = stepped
            return entry

        svc = SimService(max_lanes=SERVE_LANES, pack_deadline_ms=2000.0,
                         beat_windows=SERVE_BEAT_WINDOWS, snapshot_beats=1,
                         snapshot_path=str(d / "snap.npz"),
                         launch_retries=1, launch_backoff_s=0.0,
                         chaos=ServeChaos(SERVE_CHAOS), tracer=tracer,
                         fleet_factory=factory, device=dev)
        write = svc._write_snapshot

        def timed_write(*a, **k):
            t0 = time.perf_counter()
            write(*a, **k)
            snaps.append({"bytes": os.path.getsize(k.get("path")
                                                   or svc.snapshot_path),
                          "write_s": time.perf_counter() - t0})
        svc._write_snapshot = timed_write
        srv = ServeServer(svc, port=0, _stream=sys.stdout).start()
        url = f"http://127.0.0.1:{srv.port}"
        rec = MergeRecorder(merge, events, TGEN_TIMED_CALL)
        try:
            svc.start()
            torch.cuda.synchronize()
            merge.launches = 0
            t0 = time.perf_counter()
            with rec:
                report = serve_client.run_load(url, docs,
                                               out_dir=str(d / "out"),
                                               timeout_s=900.0)
            wall = time.perf_counter() - t0
            launches = merge.launches
            with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
                scrape = r.read().decode("utf-8")
        finally:
            srv.close()
            svc.drain()
            tracer.close()
        recs = [json.loads((d / "out" / f"r{i:06d}.json").read_text())
                for i in range(len(docs))]
        header, ledger = load_ledger(tracer.ledger_path)
    check(report["errors"] == 0, f"serve: {report['errors']} errors")
    for i, (r, pin) in enumerate(zip(recs, PIN_SERVE)):
        check(r["status"] == "done" and r["summary"] == pin,
              f"serve: request {i} {r.get('summary')} != JAX/CPU {pin}")
    n_a = len(SERVE_A)
    check(all(r.get("resumed_from_beat") == 1 for r in recs[:n_a]),
          f"serve: class A not resumed from its beat-1 snapshot: "
          f"{[r.get('resumed_from_beat') for r in recs[:n_a]]}")
    check([r["lanes_packed"] for r in recs] == [n_a] * n_a + [1],
          f"serve: lanes packed {[r['lanes_packed'] for r in recs]}")
    key_a, key_b = recs[0]["class"], recs[n_a]["class"]
    lanes_b = fetch_tree(lane_summary_refs(last[key_b]))
    for k in ("windows", "executed", "sweeps", "queue_drops"):
        check(not lanes_b[k][1:].any(),
              f"serve: class B pad lanes' {k} {lanes_b[k][1:]} != 0")
    lane0 = convert.leaves_digest(convert.lane_of(
        convert.fleet_state_to_numpy(last[key_a]), 0))
    check(lane0 == PIN_CLI_FLEET["lane_digests"][0],
          f"serve: class A seed-1 lane {lane0} != its solo run's "
          f"{PIN_CLI_FLEET['lane_digests'][0]} (phase 22's lane 0)")
    probs = validate_openmetrics(scrape)
    check(probs == [], f"serve: /metrics fails the checker: {probs[:3]}")
    reduced = serve_report.reduce_ledger(header, ledger)
    check(reduced["requests"] == len(docs) and reduced["retries"] == 1
          and reduced["launches"] == 3,
          f"serve: ledger reduced to {reduced}")
    steps = {k: int(last[k].stats.n_inner_steps.max()) for k in last}
    sweeps = sum(max(r["summary"]["sweeps"] for r in recs
                     if r["class"] == k) for k in (key_a, key_b))
    check(launches >= sweeps > 0,
          f"serve: {launches} merge launches < {sweeps} sweeps")
    check(sum(rec.by_hc.values()) == launches,
          f"serve: {sum(rec.by_hc.values())} merge calls by hc != "
          f"{launches} launches")
    walls = serve_launch_walls(ledger)
    per_step = {}
    for k in (key_a, key_b):
        run_s = sum(w[3] for w in walls.values() if w[0] == k)
        per_step[k] = 1e3 * run_s / max(steps[k], 1)
    state_bytes = sum(t.numel() * t.element_size() for _, t, _ in
                      convert.state_tensors(last[key_a]))
    result = {
        "wall_s": wall, "launches": launches,
        "launches_by_hc": dict(sorted(rec.by_hc.items())),
        "merge_rounds": sum(rec.by_hc.values()),
        "sweeps": sweeps, "inner_steps": steps,
        "launch_walls_s": {n: {"class": w[0], "wall_s": w[1],
                               "beats": w[2], "beats_confirm_s": w[3],
                               "pack_s": w[4]}
                           for n, w in walls.items()},
        "ms_per_inner_step": per_step,
        "fleet_ms_per_inner_step": ((fleet_phase or {}).get("runs", {})
                                    .get("fleet", {})
                                    .get("ms_per_inner_step")),
        "snapshots": snaps, "state_bytes": state_bytes,
        "requests_per_s": report["requests_per_sec"],
        "p50_ms": report["p50_ms"], "p95_ms": report["p95_ms"],
        "report": {k: reduced[k] for k in (
            "requests", "launches", "retries", "snapshots",
            "pack_efficiency", "cache_hit_ratio")},
    }
    print(f"  served: {json.dumps(result)} ({smi_line})")

    # (b) the served command line as a subprocess on the card
    t0 = time.perf_counter()
    want = solo_reference(SERVE_SMALL_DOC, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        qf = Path(tmp) / "queue.json"
        env = dict(os.environ,
                   PYTHONPATH=os.pathsep.join(
                       [os.path.dirname(os.path.abspath(__file__))]
                       + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        proc = subprocess.Popen(
            [sys.executable, "-m", "shadow_tpu_torch", "serve", "--port",
             "0", "--max-lanes", "1", "--queue-file", str(qf),
             "--snapshot-path", str(Path(tmp) / "snap.npz")],
            cwd=tmp, env=env, stderr=subprocess.PIPE, text=True)
        try:
            line = proc.stderr.readline()
            check("serve: listening http://127.0.0.1:" in line,
                  f"serve cli: no listening line: {line!r}")
            cli_url = line.split()[2].rsplit("/", 1)[0]
            rid = serve_client.submit_all(cli_url, [SERVE_SMALL_DOC])[0]
            got = serve_client.poll_results(cli_url, [rid],
                                             timeout_s=300.0)[rid]
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        err = proc.stderr.read()
        pending = (json.loads(qf.read_text())["pending"]
                   if qf.exists() else None)
    check(rc == 0, f"serve cli: exit code {rc}: {err[-2000:]}")
    check(got["status"] == "done" and got["summary"] == want,
          f"serve cli: {got} != the solo run's {want}")
    check(pending == [], f"serve cli: queue file {pending}")
    result["cli_s"] = time.perf_counter() - t0
    result["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({"serve": result, "card": smi_line}))
    return result


def phase_pcap(merge, smi_line, tgen=None) -> dict:
    """`cli.main` in-process on phase 20's capturing config (PCAP_ARGV),
    its stdout and stderr captured, the merge launches counted from zero
    and required, held to PIN_CLI_PCAP, and its xprof trace required to
    hold CUDA kernel events; prints its ms per inner step, window probes
    and widths, host reads per segment, harvest share, the capture
    drain's host seconds and the trace's size beside phase 10's run
    (`tgen`, its first run's dict) when given."""
    import contextlib
    import io
    import os
    from pathlib import Path

    import torch

    from shadow_tpu_torch import cli

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        (d / "tgen.xml").write_text(pcap_config(TGEN_PAIRS))
        out, err, cwd, last = io.StringIO(), io.StringIO(), os.getcwd(), {}
        torch.cuda.synchronize()
        merge.launches = 0
        t0 = time.perf_counter()
        os.chdir(d)
        try:
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                rc = cli.main(PCAP_ARGV, run_info=last)
        finally:
            os.chdir(cwd)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = merge.launches
        tail = err.getvalue().splitlines()[-6:]
        check(rc == 0, f"cli pcap: exit code {rc}: {tail}")
        check(launches > 0, "cli pcap: no merge launch")
        got = pcap_pin_fields(out.getvalue(), err.getvalue(), d)
        with np.load(d / PCAP_CKPT) as data:
            h = json.loads(bytes(data["__header__"]).decode())
            i = h["paths"].index(".stats.n_inner_steps")
            steps = int(data[f"leaf_{i}"])
        trace = d / XPROF_DIR / "trace.json"
        check(trace.exists(), "cli pcap: no xprof trace")
        doc = json.loads(trace.read_text())
        kernels = sum(1 for e in doc.get("traceEvents", ())
                      if e.get("cat") == "kernel")
        check(kernels > 0, "cli pcap: the xprof trace holds no CUDA kernel")
        run = {
            "wall_s": wall, "launches": launches, "inner_steps": steps,
            "ms_per_inner_step": 1e3 * last["loop_s"] / max(steps, 1),
            "loop_s": last["loop_s"], "segments": last["segments"],
            "window_probes": last["windows_run"],
            "widths_ms": [w / MS for w in last["widths"]],
            "host_syncs_per_segment": last["host_syncs"] / last["segments"],
            "harvest_reads_per_segment":
                last["harvest_reads"] / last["segments"],
            "harvest_share": last["harvest_s"] / last["loop_s"],
            "drain_host_s": last["drain_s"],
            "xprof_trace_bytes": trace.stat().st_size,
            "xprof_kernel_events": kernels,
            "pcap_files": got["pcap_files"],
            "events": got["summary"]["events"],
        }
    for key, val in json.loads(json.dumps(got)).items():
        want = (PIN_CLI_PCAP or {}).get(key)
        check(val == want, f"cli pcap: {key} {val} != JAX/CPU {want}")
    phase_s = time.perf_counter() - t_phase
    print(json.dumps({"cli_pcap": run, "phase_s": phase_s,
                      "tgen_phase10": None if tgen is None else {
                          k: tgen[k] for k in ("wall_s", "inner_steps",
                                               "ms_per_inner_step")},
                      "card": smi_line}))
    return {"run": run, "phase_s": phase_s}


def _fd_capture(fn, decode: bool = True):
    """(fn(), what the process and its children wrote to file
    descriptor 1 meanwhile, as text or, without `decode`, bytes): a
    --mesh run's ranks print there, and so do native plugins."""
    import os

    sys.stdout.flush()
    saved = os.dup(1)
    with tempfile.TemporaryFile() as f:
        os.dup2(f.fileno(), 1)
        try:
            out = fn()
        finally:
            sys.stdout.flush()
            os.dup2(saved, 1)
            os.close(saved)
        f.seek(0)
        got = f.read()
        return out, got.decode() if decode else got


def xchg_deliver_input(merge, events, dev, ckpt_path):
    """One merge input captured inside `Engine._xchg_deliver`, at the
    delivery of a full [S, R] exchange bucket (the flat [S * R] batch):
    the queues of the shard of phase 21's checkpoint `ckpt_path` that
    holds the most events, each host's last queued event taken out into
    the bucket's row of another shard, delivered back. The delivered
    queues must equal the checkpoint's."""
    import torch

    from shadow_tpu_torch.convert import key_of
    from shadow_tpu_torch.core.engine import (
        ConstantNetwork,
        Engine,
        EngineConfig,
        ExchangeBuf,
    )
    from shadow_tpu_torch.core.events import EventQueue, Events
    from shadow_tpu_torch.core.timebase import TIME_INVALID
    from shadow_tpu_torch.parallel.mesh import Comm

    with np.load(ckpt_path) as data:
        h = json.loads(bytes(data["__header__"]).decode("utf-8"))
        lv = {key_of(p): data[f"leaf_{i}"] for i, p in enumerate(h["paths"])}
    s, r = lv["xchg.sent_min"].shape[0], lv["xchg.bucket.time"].shape[1]
    per = lv["queues.time"].shape[0] // s
    busy = (lv["queues.time"] != TIME_INVALID).reshape(s, -1).sum(1)
    rank = int(np.argmax(busy))
    h0 = rank * per
    on = lambda a: torch.from_numpy(np.ascontiguousarray(
        a[h0:h0 + per])).to(dev)
    q = EventQueue(time=on(lv["queues.time"]), src=on(lv["queues.src"]),
                   seq=on(lv["queues.seq"]), kind=on(lv["queues.kind"]),
                   args=on(lv["queues.args"]), drops=on(lv["queues.drops"]))
    n_args = q.args.shape[-1]
    eng = Engine(EngineConfig(n_hosts=per, capacity=q.time.shape[1],
                              lookahead=1, n_args=n_args, axis_name="hosts",
                              n_shards=s, route_bucket=r),
                 [None], ConstantNetwork(1), device=dev,
                 comm=Comm(rank=rank, size=s, staged=False))
    cnt = (q.time != TIME_INVALID).sum(1)
    rows = torch.nonzero(cnt > 0).flatten()[:r]
    col = cnt[rows] - 1
    bucket = ExchangeBuf.create(s, r, n_args, device=dev).bucket
    take = lambda a: a[rows, col]
    n, peer = rows.numel(), (rank + 1) % s
    bucket.time[peer, :n] = take(q.time)
    bucket.dst[peer, :n] = (h0 + rows).to(torch.int32)
    bucket.src[peer, :n] = take(q.src)
    bucket.seq[peer, :n] = take(q.seq)
    bucket.kind[peer, :n] = take(q.kind)
    bucket.args[peer, :n] = take(q.args)
    full = q
    t = q.time.clone()
    t[rows, col] = TIME_INVALID
    q = dataclasses.replace(q, time=t)
    xchg = ExchangeBuf(bucket=bucket, sent_min=bucket.time.min().reshape(1))
    with MergeRecorder(merge, events, timed_call=1) as rec:
        got, _ = eng._xchg_deliver(q, xchg, h0)
    check(n > 0 and rec.by_hc, f"exchange delivery: {n} events, no merge "
                               "call captured")
    valid = full.time != TIME_INVALID
    check(torch.equal(got.time, full.time),
          "exchange delivery: queues.time differs from the checkpoint")
    for f in ("src", "seq", "kind", "args"):
        a, b = getattr(got, f), getattr(full, f)
        m = valid if a.dim() == 2 else valid[..., None]
        check(torch.equal(torch.where(m, a, 0), torch.where(m, b, 0)),
              f"exchange delivery: queues.{f} differs from the checkpoint")
    (hc, args), = rec.captured()[:1]
    return args, n, s * r


def phase_shard(merge, events, dev, smi_line, cli_phase=None) -> dict:
    """Phase 21: `cli.main` on phase 19's call with --overflow drop over
    --mesh 2 (gloo: two ranks share the card), then --mesh 1 (NCCL)
    resuming from its 3 s checkpoint, each with the stdout its ranks
    print captured, the merge launches of every rank counted from zero
    and required, both held to PIN_CLI_SHARD; then the merge kernel held
    to its plain version, and timed, on an input captured at the
    exchange delivery's shape."""
    import shutil
    from pathlib import Path

    import torch

    from shadow_tpu_torch import cli

    pins, runs = {}, {}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        base = Path(tmp)
        for label, (n_mesh, backend) in SHARD_MESHES.items():
            d = base / label
            d.mkdir()
            extra = ["--mesh", str(n_mesh)]
            if label == "resumed":
                shutil.copy(base / "run" / CLI_MID_CKPT, d / CLI_CKPT)
                extra += ["--resume", "auto"]
            (d / "tgen.xml").write_text(tgen_config(TGEN_PAIRS))
            cwd, last = os.getcwd(), {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            os.chdir(d)
            try:
                rc, out = _fd_capture(lambda: cli.main(
                    SHARD_ARGV + extra, backend=backend, run_info=last))
            finally:
                os.chdir(cwd)
            wall = time.perf_counter() - t0
            check(rc == 0, f"shard {label}: exit code {rc}")
            launches = last.get("kernel_launches", {}).get("merge", 0)
            check(launches > 0, f"shard {label}: no merge launch")
            pins[label] = shard_pin_fields(out, d)
            leaves = {}
            for k, name in enumerate((CLI_MID_CKPT, CLI_CKPT)):
                with np.load(d / name) as data:
                    h = json.loads(bytes(data["__header__"]).decode())
                    leaves[k] = {p: int(data[f"leaf_{i}"])
                                 for i, p in enumerate(h["paths"])
                                 if p in (".stats.n_inner_steps",
                                          ".stats.n_xchg_rounds",
                                          ".stats.n_sweeps",
                                          ".stats.n_windows")}
            delta = {p.rsplit(".", 1)[1]: leaves[1][p] - (
                leaves[0][p] if label == "resumed" else 0)
                for p in leaves[1]}
            steps = delta["n_inner_steps"]
            runs[label] = {
                "mesh": n_mesh, "backend": last["backend"],
                "wall_s": wall, "loop_s": last["loop_s"],
                "launches": launches,
                "inner_steps_summed_over_shards": steps,
                "windows": delta["n_windows"], "sweeps": delta["n_sweeps"],
                "xchg_rounds": delta["n_xchg_rounds"],
                "xchg_rounds_per_sweep": (delta["n_xchg_rounds"]
                                          / max(delta["n_sweeps"], 1)),
                "ms_per_inner_step": 1e3 * last["loop_s"] / steps,
                "collectives_per_inner_step": last["collectives"] / steps,
                "host_reads_per_inner_step": last["host_syncs"] / steps,
                "collectives": last["collectives"],
                "host_syncs": last["host_syncs"],
                "segments": last["segments"],
                "harvest_reads_per_segment":
                    last["harvest_reads"] / last["segments"],
                "events": pins[label]["summary"]["events"],
                "cross_shard_packets":
                    pins[label]["summary"]["cross_shard_packets"],
            }
            print(f"  shard {label}: {json.dumps(runs[label])} "
                  f"({smi_line})")
        args, n_events, batch = xchg_deliver_input(
            merge, events, dev, base / "run" / CLI_CKPT)
    got = json.loads(json.dumps(pins))
    for label in SHARD_MESHES:
        for key, val in got[label].items():
            want = (PIN_CLI_SHARD or {}).get(label, {}).get(key)
            check(val == want,
                  f"shard {label}: {key} {val} != JAX/CPU {want}")
    bad = compare_merge(merge, args)
    check(bad == 0, f"merge kernel != plain on the exchange delivery's "
                    f"input: {bad} elements differ")
    print(f"  merge == plain on the exchange delivery's input: "
          f"h={args[0].shape[0]} hc={args[0].shape[1]} "
          f"w={args[5].shape[1]} m={args[3].shape[0]} (a flat [S*R] = "
          f"{batch} batch, {n_events} events)")
    deliver = time_captured(merge, dev, args, smi_line,
                            f"captured exchange delivery (m={batch})")
    phase_s = time.perf_counter() - t_phase
    beside = (cli_phase or {}).get("runs", {})
    print(json.dumps({"shard": runs, "phase_s": phase_s,
                      "cli_phase19_same_call": {
                          k: {key: r.get(key) for key in (
                              "wall_s", "loop_s", "ms_per_inner_step",
                              "host_syncs_per_segment", "inner_steps")}
                          for k, r in beside.items()},
                      "card": smi_line}))
    return {"runs": runs, "phase_s": phase_s, "deliver": deliver}


# -- phase 24: the real-binary tier --------------------------------------
PROC_ECHO_PAIRS = 256
PROC_TCP_PAIRS = 128  # a quarter in each io mode
PROC_UDP_PAIRS = 64
PROC_UDP_COUNT = 20
PROC_CLOCKS = 128  # half of them run a second clock, stopped at 2 s
PROC_BYTES = 20_000
PROC_SEED = 7
PROC_STOP_S = 10
PROC_HOSTS = (2 * (PROC_ECHO_PAIRS + PROC_TCP_PAIRS + PROC_UDP_PAIRS)
              + PROC_CLOCKS)
PROC_IO_MODES = ("blocking", "nonblocking-poll", "nonblocking-epoll",
                 "nonblocking-select")
PROC_TIMED_CALL = 20  # the inject merge call kept for timing
PROC_TOPO = """<graphml xmlns="http://graphml.graphdrawing.org/xmlns">
  <key attr.name="packetloss" attr.type="double" for="edge" id="d4" />
  <key attr.name="latency" attr.type="double" for="edge" id="d3" />
  <key attr.name="bandwidthup" attr.type="int" for="node" id="d2" />
  <key attr.name="bandwidthdown" attr.type="int" for="node" id="d1" />
  <graph edgedefault="undirected">
    <node id="poi-1">
      <data key="d1">10240</data>
      <data key="d2">10240</data>
    </node>
    <edge source="poi-1" target="poi-1">
      <data key="d3">25.0</data>
      <data key="d4">0.0</data>
    </edge>
  </graph>
</graphml>"""
PIN_PROC = {
    "processes": 1088,
    "exit_codes_nonzero": [],
    "exit_codes_sha256":
        "048c98e86ef85d7e4f8afdb0020045f34c09634d20a842927749f8cd1e344113",
    "logs": 640,
    "logs_sha256":
        "2f9c2fda3230a138a19b8bbc047080c1b658f338d3321580e2607610ae19bc16",
    "stdout_sha256":
        "3d430697c4ea3fb20a66e4edacb973a9365f76477eb9b3f1bb275477c501ad69",
    "rx_bytes": 17944320,
    "queue_drops": 0,
    "digest":
        "314e3fd694871128937a5f828828d60b399ae766a820294a92b812ab93e3fdb1",
    "cli_stdout": (
        "PLAIN_TCP_SERVER_DONE 20000\n"
        "PLAIN_TCP_OK 20000 225\n"
        "[2.175305] [pid 0] server echoed 20000 bytes at t=2175304986\n"
        "[2.277034] [pid 1] client verified 20000 bytes at t=2277034188\n"
        '{"hosts": 4, "sim_seconds": 10.0, "processes": 4, "exit_codes": '
        '{"0": 0, "2": 0, "3": 0, "1": 0}, "rx_bytes": 80000, '
        '"queue_drops": 0}\n'),
}


def proc_plugins() -> dict:
    """The phase's plugins, built from the checkout by the port's
    build functions: name -> .so path."""
    from shadow_tpu_torch.proc.native import (
        compile_plugin,
        compile_posix_plugin,
    )

    root = os.path.dirname(os.path.abspath(__file__))
    return {
        "echo": compile_plugin(
            os.path.join(root, "native", "plugins", "shim_echo.c")),
        "clock": compile_plugin(
            os.path.join(root, "native", "plugins", "shim_clock.c")),
        "plain_tcp": compile_posix_plugin(
            os.path.join(root, "tests", "plugins", "plain_tcp.c")),
        "plain_udp": compile_posix_plugin(
            os.path.join(root, "tests", "plugins", "plain_udp.c")),
    }


def proc_config(plugins: dict, cut: bool = False) -> str:
    """Phase 24's config, or with `cut` the CLI's: one echo pair and one
    epoll plain_tcp pair."""
    def host(name, plugin, args, start):
        return (f'<host id="{name}"><process plugin="{plugin}" '
                f'starttime="{start}" arguments="{args}"/></host>')

    n_echo, n_tcp, n_udp, n_clock = ((1, 1, 0, 0) if cut else
                                     (PROC_ECHO_PAIRS, PROC_TCP_PAIRS,
                                      PROC_UDP_PAIRS, PROC_CLOCKS))
    hosts = []
    for i in range(n_echo):
        hosts += [host(f"esrv{i}", "echo", f"server 8888 {PROC_BYTES}", 1),
                  host(f"ecli{i}", "echo",
                       f"client esrv{i} 8888 {PROC_BYTES}", 2)]
    for i in range(n_tcp):
        mode = ("nonblocking-epoll" if cut else
                PROC_IO_MODES[i * len(PROC_IO_MODES) // n_tcp])
        hosts += [host(f"tsrv{i}", "plain_tcp", f"{mode} server 8080", 1),
                  host(f"tcli{i}", "plain_tcp",
                       f"{mode} client tsrv{i} 8080 {PROC_BYTES}", 2)]
    for i in range(n_udp):
        hosts += [host(f"usrv{i}", "plain_udp",
                       f"server 8053 {PROC_UDP_COUNT}", 1),
                  host(f"ucli{i}", "plain_udp",
                       f"client usrv{i} 8053 {PROC_UDP_COUNT}", 2)]
    for i in range(n_clock):
        second = ('<process plugin="clock" starttime="1" stoptime="2" '
                  'arguments="200 10"/>' if i % 2 else "")
        hosts.append(f'<host id="clk{i}"><process plugin="clock" '
                     f'starttime="1" arguments="200 10"/>{second}</host>')
    used = ("echo", "plain_tcp") if cut else tuple(plugins)
    decl = "".join(f'<plugin id="{k}" path="{plugins[k]}"/>' for k in used)
    return (f'<shadow stoptime="{PROC_STOP_S}">'
            f"<topology><![CDATA[{PROC_TOPO}]]></topology>"
            f"{decl}{''.join(hosts)}</shadow>")


def proc_pin_fields(exit_codes: dict, logs: list, stdout: bytes, leaves,
                    convert) -> dict:
    """What PIN_PROC holds of a tier's run: the exit codes, sha256s over
    the log triples and the plugins' stdout, the delivered bytes, the
    queue drops and the final-state digest."""
    sha = lambda b: hashlib.sha256(b).hexdigest()
    codes = sorted((int(p), int(c)) for p, c in exit_codes.items())
    return {
        "processes": len(codes),
        "exit_codes_nonzero": [[p, c] for p, c in codes if c],
        "exit_codes_sha256": sha(json.dumps(codes).encode()),
        "logs": len(logs),
        "logs_sha256": sha("".join(f"{t} {p} {m}\n"
                                   for t, p, m in logs).encode()),
        "stdout_sha256": sha(stdout),
        "rx_bytes": int(leaves["hosts.net.sockets.rx_bytes"].sum()),
        "queue_drops": int(leaves["queues.drops"].sum()),
        "digest": convert.leaves_digest(leaves),
    }


def without_wall_seconds(stdout: str) -> str:
    """A process-tier CLI's stdout with the summary's wall_seconds taken
    out."""
    out = []
    for line in stdout.splitlines(keepends=True):
        if line.startswith("{"):
            d = json.loads(line)
            d.pop("wall_seconds", None)
            line = json.dumps(d) + "\n"
        out.append(line)
    return "".join(out)


def phase_proc(merge, events, convert, dev, smi_line,
               tgen_run: dict | None = None) -> dict:
    """(a) `ProcessTier` on the card at PROC_HOSTS hosts against
    PIN_PROC, the merge launched on every injecting window and held to
    its plain version on inputs captured inside `_inject`, then timed on
    one; (b) the CLI cut as a subprocess against the reference CLI's
    stdout."""
    import torch

    from shadow_tpu_torch.config import parse_config
    from shadow_tpu_torch.obs.profiler import WindowProfiler
    from shadow_tpu_torch.proc import ProcessTier

    t_phase = time.perf_counter()
    pin = PIN_PROC or {}
    plugins = proc_plugins()
    plugins_s = time.perf_counter() - t_phase
    cfg = parse_config(proc_config(plugins))
    kernel = events.merge.fused_merge
    inject = {"on": False, "calls": 0, "kept": [], "timed": None}

    def record(*args):
        if inject["on"]:
            inject["calls"] += 1
            if len(inject["kept"]) < 3:
                inject["kept"].append(tuple(a.clone() for a in args))
            if inject["calls"] == PROC_TIMED_CALL:
                inject["timed"] = tuple(a.clone() for a in args)
        return kernel(*args)

    prof = WindowProfiler()
    out: dict = {}

    def run():
        t0 = time.perf_counter()
        tier = ProcessTier(cfg, device=dev, seed=PROC_SEED,
                           overflow="spill", profiler=prof)
        plain_inject = tier._inject

        def traced_inject(st, rows, now):
            inject["on"] = True
            try:
                return plain_inject(st, rows, now)
            finally:
                inject["on"] = False

        tier._inject = traced_inject
        torch.cuda.synchronize()
        out["build_s"] = time.perf_counter() - t0
        syncs0 = tier.sim.engine.host_syncs
        merge.launches = 0
        t0 = time.perf_counter()
        try:
            st = tier.run()
            torch.cuda.synchronize()
            out["wall_s"] = time.perf_counter() - t0
            out["launches"] = merge.launches
            out["host_syncs"] = tier.sim.engine.host_syncs - syncs0
            out["leaves"] = convert.engine_state_to_numpy(st)
        finally:
            tier.close()
        return tier

    events.merge.fused_merge = record
    try:
        tier, stdout = _fd_capture(run, decode=False)
    finally:
        events.merge.fused_merge = kernel
    leaves = out.pop("leaves")
    got = proc_pin_fields(tier.exit_codes, tier.logs, stdout, leaves,
                          convert)
    phases = prof.summary()["phases"]
    wall, windows = out["wall_s"], max(tier.windows, 1)
    inner = int(leaves["stats.n_inner_steps"].sum())
    run_info = {
        "hosts": PROC_HOSTS, "processes": got["processes"],
        "windows": tier.windows, "injections": tier.injections,
        "inject_merge_calls": inject["calls"],
        "inner_steps": inner, "sweeps": int(leaves["stats.n_sweeps"].sum()),
        "events": int(leaves["stats.n_executed"].sum()),
        "wall_s": wall, "build_s": out["build_s"],
        "plugins_build_s": plugins_s,
        "ms_per_window": 1e3 * wall / windows,
        "ms_per_inner_step": 1e3 * wall / max(inner, 1),
        "host_reads_per_window": out["host_syncs"] / windows,
        "tier_reads_per_window": tier.reads / windows,
        "pump_share": phases.get("pump", {}).get("total_s", 0.0) / wall,
        "step_share": phases.get("step", {}).get("total_s", 0.0) / wall,
        "launches": out["launches"],
        "exit_codes_nonzero": got["exit_codes_nonzero"],
        "rx_bytes": got["rx_bytes"], "queue_drops": got["queue_drops"],
        "spilled": int(leaves["queues.spill.n_spilled"].sum()),
        "phase10_ms_per_inner_step": (tgen_run or {}).get(
            "ms_per_inner_step"),
    }
    print(f"  proc tier: {json.dumps(run_info)} ({smi_line})")
    for key, val in got.items():
        check(val == pin.get(key),
              f"proc tier: {key} {val} != JAX/CPU {pin.get(key)}")
    check(got["processes"] == 1_088 and not got["exit_codes_nonzero"],
          f"proc tier: exit codes {got['exit_codes_nonzero']}")
    check(tier.injections > 0 and inject["calls"] >= tier.injections
          and out["launches"] >= inject["calls"],
          f"proc tier: {out['launches']} merge launches, "
          f"{inject['calls']} inside _inject, for {tier.injections} "
          "injecting windows")
    for i, args in enumerate(inject["kept"] + [inject["timed"]]):
        check(args is not None, "proc tier: no inject merge input at call "
                                f"{PROC_TIMED_CALL}")
        bad = compare_merge(merge, args)
        check(bad == 0, f"merge kernel != plain on inject input {i}: "
                        f"{bad} elements differ")
        print(f"  merge == plain on inject input {i}: "
              f"h={args[0].shape[0]} hc={args[0].shape[1]} "
              f"w={args[5].shape[1]} m={args[3].shape[0]} "
              f"admitted={int(args[7].sum())}")
    timing = time_captured(merge, dev, inject["timed"], smi_line,
                           f"captured inject (merge call {PROC_TIMED_CALL}"
                           " inside ProcessTier._inject)")
    inject["kept"].clear()
    inject["timed"] = None
    torch.cuda.empty_cache()

    # (b) the command line on the cut, as a user runs it
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "proc.xml")
        with open(path, "w") as f:
            f.write(proc_config(plugins, cut=True))
        root = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ)
        env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
        p = subprocess.run(
            [sys.executable, "-m", "shadow_tpu_torch", path, "--seed",
             str(PROC_SEED)], cwd=tmp, env=env, capture_output=True,
            text=True, timeout=300)
    cli_s = time.perf_counter() - t0
    check(p.returncode == 0,
          f"proc cli: exit {p.returncode}: {p.stderr[-2000:]}")
    check(without_wall_seconds(p.stdout) == pin.get("cli_stdout"),
          "proc cli: stdout differs from the reference CLI's:\n"
          f"{p.stdout[-2000:]}")
    phase_s = time.perf_counter() - t_phase
    print(json.dumps({"proc": run_info, "cli_s": cli_s, "phase_s": phase_s,
                      "card": smi_line}))
    return {"run": run_info, "timing": timing, "phase_s": phase_s,
            "launches": out["launches"]}


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel phases and their timing: "
                         "no PHOLD runs, no result lines")
    ap.add_argument("--only", default="",
                    help="comma-separated phases (9-24) to run after "
                         "phases 1-3, skipping the others; prints no "
                         "result lines")
    opts = ap.parse_args(argv)
    only = {int(p) for p in opts.only.split(",") if p}
    if not only <= set(range(9, 25)):
        ap.error("--only takes phases 9 to 24")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from shadow_tpu_torch import config, convert, sim
        from shadow_tpu_torch.core import engine, events, merge, rng
        from shadow_tpu_torch.core.engine import state_summary
        from shadow_tpu_torch.models import phold
        from shadow_tpu_torch.net import topology
        from shadow_tpu_torch.obs import trace as trace_mod
        from shadow_tpu_torch.runtime import pressure
        from shadow_tpu_torch.transport import cbrt
    except ImportError as e:
        print(f"chip_smoke: shadow_tpu_torch not importable here: {e}",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    def phase(title):
        print(f"== {title} (at {time.perf_counter() - t_start:.1f} s)",
              flush=True)

    phase("1. device")
    smi_line = phase_device()

    phase("2. build")
    build_s = phase_build(merge, cbrt)

    phase("3. kernels against their plain versions")
    phase_kernels_sweep(merge, dev)
    captured = phase_live_inputs(merge, events, phold, dev, batched=True)
    timing = phase_merge_timing(merge, dev, captured, smi_line,
                                sweep_plans=opts.kernels_only)
    if opts.kernels_only:
        print(json.dumps({"merge_timing": timing, "card": smi_line}))
        return 0
    if only:
        with tempfile.TemporaryDirectory() as workdir:
            for p in sorted(only):
                phase(f"{p}. (--only)")
                if p == 9:
                    phase_phold_net(sim, config, merge, events, convert, dev,
                                    smi_line, workdir)
                elif p == 10:
                    phase_tgen(sim, config, merge, events, convert, dev,
                               smi_line)
                elif p == 14:
                    phase_skew(phold, pressure, merge, events, convert, dev,
                               smi_line)
                elif p == 17:
                    phase_cbrt(cbrt, dev, smi_line)
                    phase_app("tgen_cubic", sim, config, merge, events,
                              convert, dev, smi_line, cbrt=cbrt)
                elif p == 18:
                    phase_trace(phold, engine, topology, pressure, sim,
                                config, trace_mod, merge, convert, dev,
                                smi_line)
                elif p == 19:
                    phase_cli(merge, smi_line)
                elif p == 20:
                    phase_pcap(merge, smi_line)
                elif p == 21:
                    phase_shard(merge, events, dev, smi_line)
                elif p == 22:
                    fleet_only = phase_fleet(sim, config, merge, events,
                                             convert, dev, smi_line)
                elif p == 23:
                    phase_serve(merge, events, convert, dev, smi_line,
                                fleet_only if 22 in only else None)
                elif p == 24:
                    phase_proc(merge, events, convert, dev, smi_line)
                else:
                    phase_app({11: "tor", 12: "btc", 13: "mixed",
                               15: "tgen_frontier", 16: "tgen_faults"}[p],
                              sim, config,
                              merge, events, convert, dev, smi_line)
        return 0

    phase("4. main path: PHOLD 4096 hosts, 20 sim-s, batched drain")
    digests = []
    main_run = None
    for rep in range(2):
        merge.launches = 0
        eng, st, wall = run_phold(phold, 4096, dev)
        launches = merge.launches
        summ = state_summary(st)
        leaves = convert.engine_state_to_numpy(st)
        digest = convert.leaves_digest(leaves)
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
    prof = profile_phold(phold, dev, batched=True)
    print(f"  profile of PHOLD 4096, first 250 sim-ms: {json.dumps(prof)}")

    phase("5. PHOLD 16384 hosts, 20 sim-s")
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

    phase("6. exponential over all 2^24 uniforms")
    u = torch.arange(1 << 24, device=dev).to(torch.float32) * (1.0 / (1 << 24))
    e = (-rng.xla_log1p_f32(-u)).cpu().numpy()
    sha = hashlib.sha256(e.tobytes()).hexdigest()
    check(sha == EXP_SHA256, f"exponential sha256 {sha} != {EXP_SHA256}")
    print(f"  sha256 {sha} == JAX/CPU")

    phase("7. the chained drain: PHOLD 4096 hosts, 5 sim-s")
    captured_c = phase_live_inputs(merge, events, phold, dev, batched=False)
    chained_merge = time_captured(
        merge, dev, captured_c[-1], smi_line,
        f"captured chained flush (m={captured_c[-1][3].shape[0]})")
    chained_run = phase_chained(phold, merge, convert, dev, smi_line)
    prof = profile_phold(phold, dev, batched=False)
    print(f"  profile of chained PHOLD 4096, first 250 sim-ms: "
          f"{json.dumps(prof)}")

    phase("8. the CPU model and a jittered, lossy graph on the card")
    variants = {}
    for which, pin in (("cpu", PIN_CPU_MODEL), ("jitter", PIN_JITTER)):
        variants[which] = phase_variant(phold, engine, topology, merge,
                                        convert, which, pin, dev, smi_line)

    phase("9. PHOLD over the UDP stack: 4096 hosts from a Shadow config")
    with tempfile.TemporaryDirectory() as workdir:
        net = phase_phold_net(sim, config, merge, events, convert, dev,
                              smi_line, workdir)
    net_merge = net["timing"]

    phase("10. TGen over TCP: 4096 hosts from a Shadow config")
    tgen = phase_tgen(sim, config, merge, events, convert, dev, smi_line)
    # the width TGen's flushes mostly run at, timed on its last input
    tgen_hc = max(tgen["by_hc"], key=tgen["by_hc"].get)
    tgen_merge = tgen["timing"][tgen_hc]

    phase("11. Tor: bench.py's 1,020-host tier from a Shadow config, "
          f"{TOR_STOP_S} sim-s")
    tor = phase_app("tor", sim, config, merge, events, convert, dev,
                    smi_line)
    tor_hc = max(tor["by_hc"], key=tor["by_hc"].get)
    tor_merge = tor["timing"][tor_hc]

    phase(f"12. Bitcoin: 1,000 nodes from a Shadow config, {BTC_STOP_S} sim-s")
    btc = phase_app("btc", sim, config, merge, events, convert, dev,
                    smi_line)
    btc_hc = max(btc["by_hc"], key=btc["by_hc"].get)
    btc_merge = btc["timing"][btc_hc]

    phase("13. mixed TGen + PHOLD: 4096 hosts from one Shadow config")
    mixed = phase_app("mixed", sim, config, merge, events, convert, dev,
                      smi_line)
    mixed_hc = max(mixed["by_hc"], key=mixed["by_hc"].get)
    mixed_merge = mixed["timing"][mixed_hc]

    phase("14. lossless overflow: skewed PHOLD 4096 with a spill ring")
    skew = phase_skew(phold, pressure, merge, events, convert, dev,
                      smi_line)

    phase("15. the frontier drain: TGen 4096 hosts, frontier=16")
    front = phase_app("tgen_frontier", sim, config, merge, events, convert,
                      dev, smi_line)
    front_hc = max(front["by_hc"], key=front["by_hc"].get)
    front_merge = front["timing"][front_hc]

    phase("16. fault injection: TGen 4096 hosts under every fault type")
    faults = phase_app("tgen_faults", sim, config, merge, events, convert,
                       dev, smi_line)
    faults_hc = max(faults["by_hc"], key=faults["by_hc"].get)
    faults_merge = faults["timing"][faults_hc]
    free = tgen["runs"][0]
    print(json.dumps({"tgen_faults_vs_tgen": {
        key: [faults["run"][key], free[key]]
        for key in ("wall_s", "host_syncs", "inner_steps",
                    "ms_per_inner_step", "launches")}, "card": smi_line}))

    phase("17. CUBIC: the cube root over [0, 2560], then TGen 4096 under "
          "faults with CUBIC")
    cbrt_timing = phase_cbrt(cbrt, dev, smi_line)
    cubic = phase_app("tgen_cubic", sim, config, merge, events, convert,
                      dev, smi_line, cbrt=cbrt)
    cubic_hc = max(cubic["by_hc"], key=cubic["by_hc"].get)
    print(json.dumps({"tgen_cubic_vs_tgen_faults": {
        key: [cubic["run"][key], faults["run"][key]]
        for key in ("wall_s", "host_syncs", "inner_steps",
                    "ms_per_inner_step", "launches")}, "card": smi_line}))

    phase("18. traces and histograms on the chained, batched (spill) and "
          "frontier drains")
    traced = phase_trace(phold, engine, topology, pressure, sim, config,
                         trace_mod, merge, convert, dev, smi_line)
    print(json.dumps({"traced_vs_untraced_ms_per_inner_step": {
        "chained": [traced["chained"]["ms_per_inner_step"],
                    1e3 * variants["jitter"]["wall_s"]
                    / variants["jitter"]["inner_steps"]],
        "frontier": [traced["frontier"]["ms_per_inner_step"],
                     front["run"]["ms_per_inner_step"]]},
        "card": smi_line}))

    phase("19. the command line: TGen 4096 hosts through cli.main, "
          "checkpointed in flight and resumed")
    cli_phase = phase_cli(merge, smi_line, tgen["runs"][0]["wall_s"])

    phase("20. the command line with packet capture, adaptive windows and "
          "a device profile: TGen 4096 hosts")
    pcap_phase = phase_pcap(merge, smi_line, tgen["runs"][0])

    phase("21. sharding: TGen 4096 hosts through cli.main over --mesh 2 "
          "(gloo, one card), resumed at --mesh 1 (NCCL)")
    shard_phase = phase_shard(merge, events, dev, smi_line, cli_phase)
    deliver = shard_phase["deliver"]

    phase(f"22. scenario fleets: TGen 4096 hosts x {FLEET_LANES} lanes "
          "through cli.main --fleet, then build_fleet and lane 0 alone")
    fleet_phase = phase_fleet(sim, config, merge, events, convert, dev,
                              smi_line, cli_phase)
    fleet_hc = max(fleet_phase["runs"]["fleet"]["launches_by_hc"],
                   key=fleet_phase["runs"]["fleet"]["launches_by_hc"].get)

    phase(f"23. the serving plane: TGen 4096 hosts served {SERVE_LANES} "
          "lanes wide over HTTP, then `serve` as a subprocess")
    serve_phase = phase_serve(merge, events, convert, dev, smi_line,
                              fleet_phase)

    phase(f"24. the real-binary tier: {PROC_HOSTS} hosts of native "
          "plugins through ProcessTier on the card, then the CLI's .so "
          "path")
    proc = phase_proc(merge, events, convert, dev, smi_line,
                      tgen["runs"][0])

    kernels = [{
        "name": "merge",
        "route": "cuda",
        "source": "shadow_tpu_torch/csrc/merge.cu",
        "replaces": "shadow_tpu/core/merge_pallas.py:125",
        "launches": (main_run["launches"] + chained_run["launches"]
                     + net["main"]["launches"]
                     + tgen["runs"][0]["launches"]
                     + tor["run"]["launches"] + btc["run"]["launches"]
                     + mixed["run"]["launches"]
                     + skew["spill"]["launches"]
                     + front["run"]["launches"]
                     + faults["run"]["launches"]
                     + cubic["run"]["launches"]
                     + sum(t["launches"] for t in traced.values())
                     + sum(r["launches"]
                           for r in cli_phase["runs"].values())
                     + pcap_phase["run"]["launches"]
                     + sum(r["launches"]
                           for r in shard_phase["runs"].values())
                     + fleet_phase["cli"]["launches"]
                     + sum(r["launches"]
                           for r in fleet_phase["runs"].values())
                     + serve_phase["launches"]
                     + proc["launches"]),
        "launches_batched": main_run["launches"],
        "launches_chained": chained_run["launches"],
        "launches_net": net["main"]["launches"],
        "launches_tgen": tgen["runs"][0]["launches"],
        "launches_tgen_by_hc": tgen["by_hc"],
        "launches_tor": tor["run"]["launches"],
        "launches_tor_by_hc": tor["by_hc"],
        "launches_btc": btc["run"]["launches"],
        "launches_btc_by_hc": btc["by_hc"],
        "launches_mixed": mixed["run"]["launches"],
        "launches_mixed_by_hc": mixed["by_hc"],
        "launches_spill": skew["spill"]["launches"],
        "launches_spill_by_hc_w": skew["spill"]["launches_by_hc_w"],
        "launches_frontier": front["run"]["launches"],
        "launches_frontier_by_hc": front["by_hc"],
        "launches_tgen_faults": faults["run"]["launches"],
        "launches_tgen_faults_by_hc": faults["by_hc"],
        "launches_tgen_cubic": cubic["run"]["launches"],
        "launches_tgen_cubic_by_hc": cubic["by_hc"],
        "launches_traced": {k: t["launches"] for k, t in traced.items()},
        "launches_cli": {k: r["launches"]
                         for k, r in cli_phase["runs"].items()},
        "launches_cli_pcap": pcap_phase["run"]["launches"],
        "launches_shard": {k: r["launches"]
                           for k, r in shard_phase["runs"].items()},
        "launches_fleet_cli": fleet_phase["cli"]["launches"],
        "launches_fleet": {k: r["launches"]
                           for k, r in fleet_phase["runs"].items()},
        "launches_per_merge_round_fleet":
            fleet_phase["runs"]["fleet"]["launches_per_round"],
        "launches_serve": serve_phase["launches"],
        "launches_serve_by_hc": serve_phase["launches_by_hc"],
        "launches_proc": proc["launches"],
        "proc_injections": proc["run"]["injections"],
        "proc_inject_merge_calls": proc["run"]["inject_merge_calls"],
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
        "chained_us": chained_merge["us"],
        "chained_bound_us": chained_merge["bound_us"],
        "chained_plain_ms": chained_merge["plain_ms"],
        "net_us": net_merge["us"],
        "net_bound_us": net_merge["bound_us"],
        "net_plain_ms": net_merge["plain_ms"],
        "net_yardstick_ms": net_merge["yardstick_ms"],
        "tgen_hc": tgen_hc,
        "tgen_us": tgen_merge["us"],
        "tgen_bound_us": tgen_merge["bound_us"],
        "tgen_plain_ms": tgen_merge["plain_ms"],
        "tgen_yardstick_ms": tgen_merge["yardstick_ms"],
        "tor_hc": tor_hc,
        "tor_us": tor_merge["us"],
        "tor_bound_us": tor_merge["bound_us"],
        "tor_plain_ms": tor_merge["plain_ms"],
        "tor_yardstick_ms": tor_merge["yardstick_ms"],
        "btc_hc": btc_hc,
        "btc_us": btc_merge["us"],
        "btc_bound_us": btc_merge["bound_us"],
        "btc_plain_ms": btc_merge["plain_ms"],
        "btc_yardstick_ms": btc_merge["yardstick_ms"],
        "mixed_hc": mixed_hc,
        "mixed_us": mixed_merge["us"],
        "mixed_bound_us": mixed_merge["bound_us"],
        "mixed_plain_ms": mixed_merge["plain_ms"],
        "spill_loop_us": skew["timing"]["loop"]["us"],
        "spill_loop_bound_us": skew["timing"]["loop"]["bound_us"],
        "spill_loop_plain_ms": skew["timing"]["loop"]["plain_ms"],
        "spill_loop_yardstick_ms": skew["timing"]["loop"]["yardstick_ms"],
        "spill_refill_us": skew["timing"]["refill"]["us"],
        "spill_refill_bound_us": skew["timing"]["refill"]["bound_us"],
        "spill_refill_plain_ms": skew["timing"]["refill"]["plain_ms"],
        "frontier_hc": front_hc,
        "frontier_us": front_merge["us"],
        "frontier_bound_us": front_merge["bound_us"],
        "frontier_plain_ms": front_merge["plain_ms"],
        "tgen_faults_hc": faults_hc,
        "tgen_faults_us": faults_merge["us"],
        "tgen_faults_bound_us": faults_merge["bound_us"],
        "tgen_faults_plain_ms": faults_merge["plain_ms"],
        "tgen_faults_yardstick_ms": faults_merge["yardstick_ms"],
        "tgen_cubic_hc": cubic_hc,
        "tgen_cubic_us": cubic["timing"][cubic_hc]["us"],
        "tgen_cubic_bound_us": cubic["timing"][cubic_hc]["bound_us"],
        "xchg_deliver_hc": int(deliver["hc"]),
        "xchg_deliver_m": int(deliver["m"]),
        "xchg_deliver_us": deliver["us"],
        "xchg_deliver_bound_us": deliver["bound_us"],
        "xchg_deliver_plain_ms": deliver["plain_ms"],
        "xchg_deliver_yardstick_ms": deliver["yardstick_ms"],
        "fleet_hc": fleet_hc,
        "fleet_us": fleet_phase["timing"][fleet_hc]["us"],
        "fleet_bound_us": fleet_phase["timing"][fleet_hc]["bound_us"],
        "fleet_plain_ms": fleet_phase["timing"][fleet_hc]["plain_ms"],
        "fleet_yardstick_ms": fleet_phase["timing"][fleet_hc][
            "yardstick_ms"],
        "proc_inject_hc": int(proc["timing"]["hc"]),
        "proc_inject_w": int(proc["timing"]["w"]),
        "proc_inject_us": proc["timing"]["us"],
        "proc_inject_bound_us": proc["timing"]["bound_us"],
        "proc_inject_plain_ms": proc["timing"]["plain_ms"],
        "proc_inject_yardstick_ms": proc["timing"]["yardstick_ms"],
        "shapes": [{key: row[key] for key in
                    ("hc", "w", "nw", "regime", "us", "warm_us",
                     "bound_us", "share", "warps_per_block")}
                   for row in timing["shapes"] + [chained_merge, net_merge]
                   + [run["timing"][hc] for run in (tgen, tor, btc, mixed,
                                                    front, faults, cubic)
                      for hc in sorted(run["timing"])]
                   + [skew["timing"]["loop"], skew["timing"]["refill"],
                      deliver]
                   + [fleet_phase["timing"][hc]
                      for hc in sorted(fleet_phase["timing"])]
                   + [proc["timing"]]],
        "build_s": build_s,
    }, {
        "name": "cbrt",
        "route": "cuda",
        "source": "shadow_tpu_torch/csrc/cbrt.cu",
        "replaces": "none: XLA calls glibc's powf for jnp.cbrt "
                    "(shadow_tpu/transport/tcp.py:586)",
        "launches": cubic["run"]["cbrt_launches"],
        "max_abs_err": 0,
        "equal_to_plain": True,
        "ms": cbrt_timing["tgen_width"]["ms"],
        "plain_ms": cbrt_timing["tgen_width"]["plain_ms"],
        "bound_ms": cbrt_timing["tgen_width"]["bound_ms"],
        "bound_by": cbrt_timing["tgen_width"]["bound_by"],
        "library_ms": None,
        "yardstick": "torch.pow(|x|, 1/3), another cube root",
        "yardstick_ms": cbrt_timing["tgen_width"]["pow_yardstick_ms"],
        "domain_ms": cbrt_timing["domain_ms"],
        "domain_bound_ms": cbrt_timing["domain_bound_ms"],
        "domain_chunk": cbrt_timing["domain_chunk"],
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
