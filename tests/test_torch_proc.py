"""The real-binary tier of the port (`shadow_tpu_torch.proc`) against the
reference's (`shadow_tpu.proc`) on the CPU.

Both tiers run the same plugin .so files, built once by the port's
builder, so what is compared is the two drivers: the exit codes, the log
triples (sim ns, pid, message), the plugins' stdout, every final-state
leaf with its dtype, the delivered bytes and the tier's lost stream
bytes, all exactly.

The reference compiles and traces one program per configuration (30-90
s on the CPU), so the scenarios share two configurations of distinct
hosts, each run once per tier by a module fixture, and each test reads
its own hosts' part. Configuration A, on a 4-slot socket table in spill
mode at a capacity that spills: the echo pair, sleep and time, the
timerfd, pipe and poll surface, per-process stoptime, slot recycling
under churn, parallel same-port connects, 64 processes with isolated
globals (past the namespace budget), unmodified POSIX `plain_tcp` in all
four io modes, a `plain_udp` pair and a listener closed and reopened
three times in one pump. Configuration B, in drop mode at a capacity
that drops: the echo pair at 10% loss beside a host that a fault
schedule crashes and restarts; the strict mode's error on the same run.
The command line is in test_torch_proc_posix.py.
"""

import contextlib
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest
import torch

from test_torch_phold import assert_leaves_equal, jax_leaves, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.skipif(shutil.which("gcc") is None,
                                reason="no C toolchain")

# -- the scenarios' plugins, configs and runs ------------------------------
# Plugins are built once by the port's builder and both tiers load the
# same .so files; a test-written source goes to a temporary directory,
# never into native/plugins/.
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TOPO = """<graphml xmlns="http://graphml.graphdrawing.org/xmlns">
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


def lossy_topo(loss: float) -> str:
    return TOPO.replace('<data key="d4">0.0</data>',
                        f'<data key="d4">{loss}</data>')


SLEEP_SRC = r"""
#include "shim_api.h"
#include <stdio.h>
int shim_main(const ShimAPI* a, int argc, char** argv) {
    void* c = a->ctx;
    long long t0 = a->time_ns(c);
    a->sleep_ns(c, 3000000000LL); /* 3 virtual seconds */
    long long t1 = a->time_ns(c);
    char m[64];
    snprintf(m, sizeof m, "slept %lld", t1 - t0);
    a->log_msg(c, m);
    return (t1 - t0 >= 3000000000LL) ? 0 : 1;
}
"""

CHURN_SRC = r"""
/* N sequential connect/send/close cycles against one server: only
 * recycled driver slots make this fit a small socket table */
#include "shim_api.h"
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
int shim_main(const ShimAPI* a, int argc, char** argv) {
    void* c = a->ctx;
    const char* srv = argv[1];
    int rounds = atoi(argv[2]);
    for (int r = 0; r < rounds; r++) {
        int fd = a->sock_socket(c);
        if (a->sock_connect(c, fd, srv, 7777) != 0) return 100 + r;
        char msg[64];
        int n = snprintf(msg, sizeof msg, "round-%d", r);
        if (a->sock_send(c, fd, msg, n) != n) return 200 + r;
        char back[64];
        int64_t m = a->sock_recv(c, fd, back, sizeof back);
        if (m != n || memcmp(msg, back, (size_t)n) != 0) return 300 + r;
        a->sock_close(c, fd);
        /* past TIME_WAIT (60 s), so both sides' slots close and recycle
         * before the next round */
        a->sleep_ns(c, 61000000000LL);
    }
    a->log_msg(c, "churn done");
    return 0;
}
"""

SERVER_SRC = r"""
/* accept forever, echo one message per connection */
#include "shim_api.h"
#include <stdlib.h>
int shim_main(const ShimAPI* a, int argc, char** argv) {
    void* c = a->ctx;
    int lfd = a->sock_socket(c);
    if (a->sock_listen(c, lfd, 7777) != 0) return 1;
    for (;;) {
        int fd = a->sock_accept(c, lfd);
        if (fd < 0) return 2;
        char buf[64];
        int64_t n = a->sock_recv(c, fd, buf, sizeof buf);
        if (n > 0) a->sock_send(c, fd, buf, n);
        a->sock_close(c, fd);
    }
    return 0;
}
"""

DUAL_SRC = r"""
/* two connects from one host to the same server port in one window:
 * only 4-tuple pairing delivers each stream to its own endpoint */
#include "shim_api.h"
#include <string.h>
#include <stdio.h>
int shim_main(const ShimAPI* a, int argc, char** argv) {
    void* c = a->ctx;
    int f1 = a->sock_socket(c), f2 = a->sock_socket(c);
    if (a->sock_connect(c, f1, argv[1], 7777) != 0) return 1;
    if (a->sock_connect(c, f2, argv[1], 7777) != 0) return 2;
    const char* m1 = "alpha-stream-payload";
    const char* m2 = "beta-different-bytes";
    a->sock_send(c, f1, m1, (int64_t)strlen(m1));
    a->sock_send(c, f2, m2, (int64_t)strlen(m2));
    char b1[64], b2[64];
    int64_t n1 = a->sock_recv(c, f1, b1, sizeof b1);
    int64_t n2 = a->sock_recv(c, f2, b2, sizeof b2);
    if (n1 != (int64_t)strlen(m1) || memcmp(b1, m1, (size_t)n1)) return 3;
    if (n2 != (int64_t)strlen(m2) || memcmp(b2, m2, (size_t)n2)) return 4;
    a->log_msg(c, "dual ok");
    return 0;
}
"""

GLOBAL_SRC = r"""
/* every process mutates the same plugin global and must see only its
 * own writes, past glibc's ~16 dlmopen namespaces too */
#include "shim_api.h"
#include <stdio.h>
#include <stdlib.h>
static long counter = 0;
int shim_main(const ShimAPI* a, int argc, char** argv) {
    long mine = atol(argv[1]);
    for (long i = 0; i < mine; i++) counter++;
    a->sleep_ns(a->ctx, 2000000000LL);
    char m[64];
    snprintf(m, sizeof m, "global=%ld want=%ld", counter, mine);
    a->log_msg(a->ctx, m);
    return counter == mine ? 0 : 1;
}
"""

RELISTEN_SRC = r"""
#include <netinet/in.h>
#include <stdio.h>
#include <string.h>
#include <sys/socket.h>
#include <unistd.h>
static int mklisten(int port) {
    int s = socket(AF_INET, SOCK_STREAM, 0);
    struct sockaddr_in a = {0};
    a.sin_family = AF_INET;
    a.sin_port = htons((unsigned short)port);
    if (bind(s, (struct sockaddr*)&a, sizeof a) != 0) return -1;
    if (listen(s, 8) != 0) return -1;
    return s;
}
int main(int argc, char** argv) {
    /* three close-then-relisten cycles with no blocking call between:
     * all six requests land in one pump */
    int l = -1;
    for (int i = 0; i < 3; i++) {
        if (l >= 0) close(l);
        l = mklisten(7070);
        if (l < 0) return 10;
    }
    int c = accept(l, 0, 0);
    if (c < 0) return 11;
    char buf[8] = {0};
    if (recv(c, buf, sizeof buf, 0) != 5) return 12;
    if (strcmp(buf, "ping") != 0) return 13;
    if (send(c, "pong", 5, 0) != 5) return 14;
    printf("RELISTEN_OK\n");
    return 0;
}
"""

RELISTEN_PEER_SRC = r"""
#include <netdb.h>
#include <netinet/in.h>
#include <stdio.h>
#include <string.h>
#include <sys/socket.h>
#include <unistd.h>
int main(void) {
    struct addrinfo h = {0}, *ai = 0;
    h.ai_family = AF_INET;
    h.ai_socktype = SOCK_STREAM;
    if (getaddrinfo("relsrv", "7070", &h, &ai) != 0) return 20;
    int s = socket(AF_INET, SOCK_STREAM, 0);
    if (connect(s, ai->ai_addr, ai->ai_addrlen) != 0) return 21;
    if (send(s, "ping", 5, 0) != 5) return 22;
    char buf[8] = {0};
    if (recv(s, buf, sizeof buf, 0) != 5) return 23;
    if (strcmp(buf, "pong") != 0) return 24;
    printf("RELISTEN_PEER_OK\n");
    return 0;
}
"""

SPIN_SRC = r"""
/* never yields, never returns: the hang the watchdog exists for */
#include "shim_api.h"
int shim_main(const ShimAPI* api, int argc, char** argv) {
    (void)api; (void)argc; (void)argv;
    for (;;) { }
    return 0;
}
"""

IO_MODES = ("blocking", "nonblocking-poll", "nonblocking-epoll",
            "nonblocking-select")


def build_plugins(workdir: str, which=None) -> dict[str, str]:
    """Build the scenario plugins with the port's builder: name -> .so.
    Test-written sources are written into `workdir`; their objects are
    named with a hash of the source, so that concurrent test processes
    never replace each other's."""
    from shadow_tpu_torch.proc.native import (
        compile_plugin,
        compile_posix_plugin,
    )

    shipped = {
        "echo": (compile_plugin, "native/plugins/shim_echo.c"),
        "clock": (compile_plugin, "native/plugins/shim_clock.c"),
        "plain_tcp": (compile_posix_plugin, "tests/plugins/plain_tcp.c"),
        "plain_udp": (compile_posix_plugin, "tests/plugins/plain_udp.c"),
    }
    written = {
        "sleep": (compile_plugin, SLEEP_SRC),
        "churn": (compile_plugin, CHURN_SRC),
        "loop_server": (compile_plugin, SERVER_SRC),
        "dual": (compile_plugin, DUAL_SRC),
        "global": (compile_plugin, GLOBAL_SRC),
        "relisten": (compile_posix_plugin, RELISTEN_SRC),
        "relisten_peer": (compile_posix_plugin, RELISTEN_PEER_SRC),
        "spin": (compile_plugin, SPIN_SRC),
    }
    out = {}
    for name in which or (*shipped, *written):
        if name in shipped:
            fn, rel = shipped[name]
            out[name] = fn(os.path.join(REPO, rel))
            continue
        fn, src = written[name]
        tag = hashlib.sha256(src.encode()).hexdigest()[:12]
        path = os.path.join(workdir, f"t_{name}_{tag}.c")
        with open(path, "w") as f:
            f.write(src)
        out[name] = fn(path, name=f"t_{name}_{tag}")
    return out


def host(name: str, plugin: str, args: str, start: float = 1,
         stop: float | None = None) -> str:
    stop_attr = f' stoptime="{stop}"' if stop is not None else ""
    return (f'<host id="{name}"><process plugin="{plugin}" '
            f'starttime="{start}"{stop_attr} arguments="{args}"/></host>')


def config(plugins: dict[str, str], hosts: list[str], stoptime: float,
           topo: str = TOPO, extra: str = "") -> str:
    """A config over the one-PoI topology whose plugin ids are the
    names of `plugins`."""
    decl = "".join(f'<plugin id="{k}" path="{v}"/>'
                   for k, v in plugins.items())
    return textwrap.dedent(f"""\
    <shadow stoptime="{stoptime}">
      <topology><![CDATA[{topo}]]></topology>
      {decl}
      {''.join(hosts)}
      {extra}
    </shadow>""")


def echo_pair(i: int, nbytes: int, prefix: str = "") -> list[str]:
    return [host(f"{prefix}server{i}", "echo", f"server 8888 {nbytes}", 1),
            host(f"{prefix}client{i}", "echo",
                 f"client {prefix}server{i} 8888 {nbytes}", 2)]


def tcp_pair(i: int, mode: str, nbytes: int) -> list[str]:
    return [host(f"tsrv{i}", "plain_tcp", f"{mode} server 8080", 1),
            host(f"tcli{i}", "plain_tcp",
                 f"{mode} client tsrv{i} 8080 {nbytes}", 2)]


def udp_pair(i: int, count: int) -> list[str]:
    return [host(f"usrv{i}", "plain_udp", f"server 8053 {count}", 1),
            host(f"ucli{i}", "plain_udp", f"client usrv{i} 8053 {count}", 2)]


@contextlib.contextmanager
def captured_stdout():
    """Capture file descriptor 1 (where the plugins' libc writes) into a
    list that holds the bytes once the block ends."""
    import sys

    out: list[bytes] = []
    sys.stdout.flush()
    saved = os.dup(1)
    with tempfile.TemporaryFile() as f:
        os.dup2(f.fileno(), 1)
        try:
            yield out
        finally:
            sys.stdout.flush()
            os.dup2(saved, 1)
            os.close(saved)
            f.seek(0)
            out.append(f.read())


def run_port(cfg_text: str, *, device="cpu", **kw) -> dict:
    """Run the port's tier on a config to its end: exit codes, log
    triples, the plugins' stdout, the final state's numpy leaves, lost
    stream bytes and the driver's counters, or the error it raised."""
    from shadow_tpu_torch import convert
    from shadow_tpu_torch.config import parse_config
    from shadow_tpu_torch.proc import ProcessTier

    with captured_stdout() as out:
        tier = ProcessTier(parse_config(cfg_text), device=device, **kw)
        err = None
        try:
            st = tier.run()
            leaves = convert.engine_state_to_numpy(st)
        except Exception as e:  # the overflow contract's errors
            err, leaves = e, None
        finally:
            tier.close()
    return {"exit_codes": dict(tier.exit_codes), "logs": list(tier.logs),
            "stdout": out[0], "leaves": leaves, "error": err,
            "lost": tier.lost_stream_bytes, "windows": tier.windows,
            "injections": tier.injections, "reads": tier.reads,
            "pids": dict(tier.pid_host)}


PORT_CHILD = ("import sys; sys.path.insert(0, {root!r}); "
              "from shadow_tpu_torch.cli import main; "
              "raise SystemExit(main(sys.argv[1:], device={device!r}))")


def run_cli_process(pkg: str, argv: list, cwd,
                    device: str = "cpu") -> subprocess.CompletedProcess:
    """One package's command line as a subprocess: the port's `main` on
    `device`, or the reference's `python -m shadow_tpu` on JAX/CPU with
    the suite's compilation cache."""
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=os.path.join(REPO, ".jax_cache_cpu"),
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0",
               JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES="0",
               PYTHONPATH=REPO)
    cmd = ([sys.executable, "-c", PORT_CHILD.format(root=REPO,
                                                    device=device)]
           if pkg == "torch" else [sys.executable, "-m", "shadow_tpu"])
    return subprocess.run(cmd + argv, cwd=cwd, env=env, capture_output=True,
                          timeout=900)


N_GLOBAL = 64  # processes, on GLOBAL_HOSTS hosts
GLOBAL_HOSTS = 6
CHURN_ROUNDS = 6  # past the 2 driver slots of a 4-slot table: recycling
TCP_BYTES = 40_000
UDP_COUNT = 5


def run_ref(cfg_text: str, **kw) -> dict:
    """The reference's tier on the same config: what `run_port`
    returns."""
    from shadow_tpu.config import parse_config
    from shadow_tpu.proc import ProcessTier

    with captured_stdout() as out:
        tier = ProcessTier(parse_config(cfg_text), **kw)
        err = None
        try:
            st = tier.run()
            leaves = jax_leaves(st)
        except Exception as e:  # the overflow contract's errors
            err, leaves = e, None
        finally:
            tier.close()
    return {"exit_codes": dict(tier.exit_codes), "logs": list(tier.logs),
            "stdout": out[0], "leaves": leaves, "error": err,
            "lost": tier.lost_stream_bytes, "pids": dict(tier.pid_host)}


def both(cfg_text: str, **kw) -> tuple[dict, dict]:
    with torch.inference_mode():
        t = run_port(cfg_text, **kw)
    return run_ref(cfg_text, **kw), t


def assert_runs_equal(j: dict, t: dict):
    assert t["exit_codes"] == j["exit_codes"]
    assert t["logs"] == j["logs"]
    assert t["stdout"] == j["stdout"]
    assert t["lost"] == j["lost"]
    assert t["pids"] == j["pids"]
    assert_leaves_equal(j["leaves"], t["leaves"])


def pids_of(run: dict, names: list[str], cfg_names: list[str]) -> list[int]:
    gids = {cfg_names.index(n) for n in names}
    return sorted(p for p, g in run["pids"].items() if g in gids)


def logs_of(run: dict, pids) -> list:
    return [x for x in run["logs"] if x[1] in pids]


@pytest.fixture(scope="module")
def plugins(tmp_path_factory):
    return build_plugins(str(tmp_path_factory.mktemp("plugins")),
                           ["echo", "clock", "sleep", "churn",
                            "loop_server", "dual", "global", "plain_tcp",
                            "plain_udp", "relisten", "relisten_peer"])


# -- configuration A ------------------------------------------------------
A_NAMES = (["server0", "client0", "sleep0", "sleep1", "clock0", "clocker",
            "srv", "pounder", "srv2", "dualclient"]
           + [f"g{i}" for i in range(GLOBAL_HOSTS)]
           + [n for i in range(len(IO_MODES))
              for n in (f"tsrv{i}", f"tcli{i}")]
           + ["usrv0", "ucli0", "relsrv", "relcli"])


def global_hosts() -> list[str]:
    """N_GLOBAL processes of the isolated-globals plugin, dealt over
    GLOBAL_HOSTS hosts: each process is its own green thread and must
    see only its own writes to the plugin's global."""
    procs: list[list[str]] = [[] for _ in range(GLOBAL_HOSTS)]
    for i in range(N_GLOBAL):
        procs[i % GLOBAL_HOSTS].append(
            f'<process plugin="global" starttime="1" '
            f'arguments="{100 + i}"/>')
    return [f'<host id="g{k}">{"".join(p)}</host>'
            for k, p in enumerate(procs)]


def config_a(plugins):
    hosts = echo_pair(0, 20_000) + [
        host("sleep0", "sleep", ""), host("sleep1", "sleep", ""),
        host("clock0", "clock", "200 5"),
        '<host id="clocker">'
        '<process plugin="clock" starttime="1" stoptime="3" '
        'arguments="500 40"/>'
        '<process plugin="clock" starttime="1" arguments="500 10"/>'
        '</host>',
        host("srv", "loop_server", ""),
        host("pounder", "churn", f"srv {CHURN_ROUNDS}", 2),
        host("srv2", "loop_server", ""),
        host("dualclient", "dual", "srv2", 2),
    ] + global_hosts()
    hosts += [h for i, mode in enumerate(IO_MODES)
              for h in tcp_pair(i, mode, TCP_BYTES)]
    hosts += udp_pair(0, UDP_COUNT) + [
        host("relsrv", "relisten", ""),
        host("relcli", "relisten_peer", "", 2)]
    return config(plugins, hosts, 400)


@pytest.fixture(scope="module")
def runs_a(plugins):
    return both(config_a(plugins), seed=3, n_sockets=4, capacity=24,
                overflow="spill")


def test_echo_pair_matches_reference(runs_a):
    j, t = runs_a
    pids = pids_of(j, ["server0", "client0"], A_NAMES)
    assert [t["exit_codes"][p] for p in pids] == [0, 0]
    msgs = [m for _, _, m in logs_of(t, pids)]
    assert any("server echoed 20000" in m for m in msgs)
    assert any("client verified 20000" in m for m in msgs)
    assert logs_of(t, pids) == logs_of(j, pids)
    assert t["exit_codes"] == j["exit_codes"]


def test_sleep_and_time_match_reference(runs_a):
    j, t = runs_a
    pids = pids_of(j, ["sleep0", "sleep1"], A_NAMES)
    assert [t["exit_codes"][p] for p in pids] == [0, 0]
    assert [m for _, _, m in logs_of(t, pids)] == ["slept 3000000000"] * 2
    assert logs_of(t, pids) == logs_of(j, pids)


def test_timerfd_pipe_poll_surface_matches_reference(runs_a):
    j, t = runs_a
    pids = pids_of(j, ["clock0"], A_NAMES)
    assert t["exit_codes"][pids[0]] == 0
    assert any("clock done: 5 ticks" in m for _, _, m in logs_of(t, pids))
    assert logs_of(t, pids) == logs_of(j, pids)


def test_per_process_stoptime_matches_reference(runs_a):
    j, t = runs_a
    stopped, full = pids_of(j, ["clocker"], A_NAMES)
    assert t["exit_codes"][stopped] == t["exit_codes"][full] == 0
    msgs = logs_of(t, [stopped, full])
    assert any(p == full and "clock done: 10 ticks" in m
               for _, p, m in msgs)
    assert not any(p == stopped and ts > 3_100_000_000 for ts, p, _ in msgs)
    assert msgs == logs_of(j, [stopped, full])


def test_slot_recycling_under_churn_matches_reference(runs_a):
    j, t = runs_a
    pids = pids_of(j, ["pounder"], A_NAMES)
    assert t["exit_codes"][pids[0]] == 0
    assert [m for _, _, m in logs_of(t, pids)] == ["churn done"]
    assert logs_of(t, pids) == logs_of(j, pids)


def test_parallel_same_port_connects_match_reference(runs_a):
    j, t = runs_a
    pids = pids_of(j, ["dualclient"], A_NAMES)
    assert t["exit_codes"][pids[0]] == 0
    assert logs_of(t, pids) == logs_of(j, pids)
    assert [m for _, _, m in logs_of(t, pids)] == ["dual ok"]


def test_isolated_globals_match_reference(runs_a):
    j, t = runs_a
    pids = pids_of(j, [f"g{i}" for i in range(GLOBAL_HOSTS)], A_NAMES)
    assert len(pids) == N_GLOBAL
    assert all(t["exit_codes"][p] == 0 for p in pids)
    msgs = [m for _, _, m in logs_of(t, pids)]
    assert sorted(msgs) == sorted(f"global={100 + i} want={100 + i}"
                                  for i in range(N_GLOBAL))
    assert logs_of(t, pids) == logs_of(j, pids)


@pytest.mark.parametrize("i", range(len(IO_MODES)),
                         ids=list(IO_MODES))
def test_unmodified_posix_echo_matches_reference(runs_a, i):
    j, t = runs_a
    pids = pids_of(j, [f"tsrv{i}", f"tcli{i}"], A_NAMES)
    assert [t["exit_codes"][p] for p in pids] == [0, 0]
    assert [j["exit_codes"][p] for p in pids] == [0, 0]
    assert logs_of(t, pids) == logs_of(j, pids)


def test_plain_tcp_stdout_matches_reference(runs_a):
    j, t = runs_a
    assert t["stdout"] == j["stdout"]
    assert t["stdout"].count(f"PLAIN_TCP_OK {TCP_BYTES}".encode()) == len(
        IO_MODES)


def test_udp_pair_matches_reference(runs_a):
    j, t = runs_a
    pids = pids_of(j, ["usrv0", "ucli0"], A_NAMES)
    assert [t["exit_codes"][p] for p in pids] == [0, 0]
    assert f"PLAIN_UDP_SERVER_OK {UDP_COUNT}".encode() in t["stdout"]
    assert f"PLAIN_UDP_CLIENT_OK {UDP_COUNT}".encode() in t["stdout"]
    rx = t["leaves"]["hosts.net.sockets.rx_bytes"]
    gids = [A_NAMES.index("usrv0"), A_NAMES.index("ucli0")]
    assert rx[gids].sum() == 2 * sum(1000 + i for i in range(UDP_COUNT))
    for k in ("hosts.app.udp_cnt", "hosts.app.udp_seq", "hosts.app.udp_len"):
        np.testing.assert_array_equal(t["leaves"][k], j["leaves"][k], k)


def test_close_then_relisten_matches_reference(runs_a):
    j, t = runs_a
    pids = pids_of(j, ["relsrv", "relcli"], A_NAMES)
    assert [t["exit_codes"][p] for p in pids] == [0, 0]
    assert b"RELISTEN_OK" in t["stdout"]
    assert b"RELISTEN_PEER_OK" in t["stdout"]
    assert logs_of(t, pids) == logs_of(j, pids)


def test_spill_mode_is_lossless_like_reference(runs_a):
    j, t = runs_a
    # the ring took evictions, lost none, and the run dropped nothing
    lt = t["leaves"]
    assert int(lt["queues.spill.n_spilled"].sum()) > 0
    assert int(lt["queues.spill.n_lost"].sum()) == 0
    assert int(lt["queues.drops"].sum()) == 0
    assert t["error"] is None and j["error"] is None
    for k in ("queues.spill.n_spilled", "queues.spill.n_lost"):
        np.testing.assert_array_equal(j["leaves"][k], lt[k])


def test_state_and_streams_match_reference(runs_a):
    j, t = runs_a
    assert_runs_equal(j, t)
    rx = t["leaves"]["hosts.net.sockets.rx_bytes"]
    assert rx.sum() == j["leaves"]["hosts.net.sockets.rx_bytes"].sum()
    assert rx.sum() >= 2 * 20_000 + 2 * TCP_BYTES * len(IO_MODES)
    assert t["lost"] == 0


# -- configuration B ------------------------------------------------------
CRASH = '<fault type="crash" hosts="crashy" start="2" end="3"/>'
B_KW = dict(seed=11, capacity=6)


@pytest.fixture(scope="module")
def runs_b(plugins):
    hosts = echo_pair(0, 20_000) + [host("crashy", "clock", "200 20")]
    text = config({k: plugins[k] for k in ("echo", "clock")}, hosts, 30,
                    topo=lossy_topo(0.1), extra=CRASH)
    j, t = both(text, overflow="drop", strict_overflow=False, **B_KW)
    with torch.inference_mode():
        strict = run_port(text, overflow="strict", **B_KW)
    return j, t, strict


def test_echo_pair_over_lossy_path_matches_reference(runs_b):
    j, t, _ = runs_b
    assert t["exit_codes"][0] == t["exit_codes"][1] == 0
    assert_runs_equal(j, t)
    assert int(t["leaves"]["hosts.net.tcb.n_retx"].sum()) > 0


def test_crash_restart_kills_and_respawns_like_reference(runs_b):
    j, t, _ = runs_b
    # the crash at 2 s kills the clock (pid 2, exit 0 recorded) and the
    # reboot at 3 s respawns it as pid 3, which runs its 20 ticks
    assert t["pids"] == {0: 0, 1: 1, 2: 2, 3: 2}
    assert t["exit_codes"][2] == 0 and t["exit_codes"][3] == 0
    assert not any(p == 2 and ts >= 2_000_000_000 for ts, p, _ in t["logs"])
    assert any(p == 3 and "clock done: 20 ticks" in m
               for _, p, m in t["logs"])
    assert logs_of(t, [2, 3]) == logs_of(j, [2, 3])


def test_counted_drops_match_reference(runs_b):
    j, t, _ = runs_b
    assert_runs_equal(j, t)
    assert int(t["leaves"]["queues.drops"].sum()) > 0


def test_strict_overflow_raises_like_reference(runs_b):
    from shadow_tpu_torch.runtime.pressure import QueuePressureError

    j, _, strict = runs_b
    err = strict["error"]
    assert isinstance(err, QueuePressureError)
    # the strict run's trajectory is the drop run's: the same drops
    assert err.drops == int(j["leaves"]["queues.drops"].sum())
    assert err.capacity == B_KW["capacity"]
    assert strict["exit_codes"] == j["exit_codes"]
    assert strict["logs"] == j["logs"]


@pytest.mark.slow
def test_phase24_pins(tmp_path):
    """chip_smoke.py phase 24's pins: the reference's ProcessTier at
    1,024 hosts on the phase's plugin objects, and the reference CLI on
    its cut; the port on the CPU meets them too."""
    import chip_smoke
    from shadow_tpu_torch import convert

    plugins = chip_smoke.proc_plugins()
    text = chip_smoke.proc_config(plugins)
    kw = dict(seed=chip_smoke.PROC_SEED, overflow="spill")
    pins = {}
    for label, run in (("jax", lambda: run_ref(text, **kw)),
                       ("torch", lambda: run_port(text, **kw))):
        with torch.inference_mode():
            r = run()
        assert r["error"] is None, r["error"]
        pins[label] = chip_smoke.proc_pin_fields(
            r["exit_codes"], r["logs"], r["stdout"], r["leaves"], convert)
    cfg = tmp_path / "proc.xml"
    cfg.write_text(chip_smoke.proc_config(plugins, cut=True))
    argv = [str(cfg), "--seed", str(chip_smoke.PROC_SEED)]
    for label in pins:
        p = run_cli_process(label, argv, tmp_path)
        assert p.returncode == 0, p.stderr[-2000:]
        pins[label]["cli_stdout"] = chip_smoke.without_wall_seconds(
            p.stdout.decode())
    print(pins["jax"])
    assert pins["torch"] == pins["jax"]
    assert pins["jax"] == chip_smoke.PIN_PROC
