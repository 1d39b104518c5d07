"""Two-host TCP scenarios for shadow_tpu_torch, JAX-free.

`build_pair` is tests/test_tcp.py's `build` and `build_stream` is
tests/test_tcp_matrix.py's, each over [H] rows. tests/test_torch_tcp.py
and tests/test_torch_tcp_matrix.py hold them against those harnesses on
the CPU; tests/test_torch_cuda.py runs them on the card against the CPU.
"""

import dataclasses

import torch

from shadow_tpu_torch.core import engine as tengine
from shadow_tpu_torch.core.events import Events
from shadow_tpu_torch.host.sockets import PROTO_NONE, PROTO_TCP
from shadow_tpu_torch.transport import stack as tstack
from shadow_tpu_torch.transport import tcp as ttcp

MS = 1_000_000
SECOND = 1_000_000_000
TIME_INVALID = (1 << 63) - 1
I64, I32 = torch.int64, torch.int32


@dataclasses.dataclass(frozen=True)
class PairApp:
    role: torch.Tensor  # i32: 0 = client, 1 = server
    rx: torch.Tensor  # i64 app-delivered bytes
    replied: torch.Tensor  # bool (request/response mode)
    last_rx: torch.Tensor  # i64 time of the last delivery


def build_pair(total=100_000, reply=0, latency=10 * MS, bw=1024.0,
               reliability=1.0, second_send=0, close_after_send=True,
               seed=7, rst_on_unmatched=False, device="cpu"):
    """Host 0 connects to host 1:80 at 1 ms and sends `total` bytes; with
    `reply` the server answers that many bytes and closes; with
    `second_send` the client sends again at 500 ms."""
    n_hosts = 2
    tcp = ttcp.TCP(rst_on_unmatched=rst_on_unmatched)
    stack = tstack.Stack(tcp=tcp)

    def on_recv(hs, slot, pkt, now, key):
        app = hs.app
        got = (slot >= 0) & (pkt.length > 0)
        rx = app.rx + torch.where(got, pkt.length.to(I64), 0)
        do_reply = ((reply > 0) & (app.role == 1) & (rx >= total)
                    & ~app.replied & got)
        app = dataclasses.replace(app, rx=rx, replied=app.replied | do_reply,
                                  last_rx=torch.where(got, now, app.last_rx))
        hs = dataclasses.replace(hs, app=app)
        hs, em_s = tcp.send(hs, slot, reply, now, mask=do_reply)
        hs, em_c = tcp.close(hs, slot, now, mask=do_reply)
        return hs, ttcp.emit_concat(em_s, em_c)

    def on_app(hs, ev, key):
        hs, em1 = tcp.connect(stack, hs, 0, ev.time)
        hs, em2 = tcp.send(hs, 0, total, ev.time)
        hs, em3 = tcp.close(hs, 0, ev.time, mask=close_after_send)
        return hs, ttcp.emit_concat(em1, em2, em3)

    def on_app2(hs, ev, key):
        hs, em1 = tcp.send(hs, 0, second_send, ev.time, mask=second_send > 0)
        hs, em2 = tcp.close(hs, 0, ev.time, mask=second_send > 0)
        return hs, ttcp.emit_concat(em1, em2)

    handlers = stack.make_handlers(on_recv) + [on_app, on_app2]
    cfg = tengine.EngineConfig(
        n_hosts=n_hosts, capacity=256, lookahead=latency,
        max_emit=tcp.min_max_emit(2), n_args=tstack.N_PKT_ARGS, seed=seed)
    eng = tengine.Engine(cfg, handlers,
                         tengine.ConstantNetwork(latency, reliability),
                         device=device)
    net = tstack.HostNet.create(n_hosts, 8, bw, bw, with_tcp=True,
                                device=device)
    tab = net.sockets.bind(1, 0, PROTO_TCP, 80)
    tab = tab.bind(0, 0, PROTO_TCP, 10_000, peer_host=1, peer_port=80)
    net = dataclasses.replace(net, sockets=tab, tcb=net.tcb.listen(1, 0))
    z = torch.zeros((n_hosts,), dtype=I64, device=device)
    hosts = tstack.SimHost(net=net, app=PairApp(
        role=torch.arange(n_hosts, dtype=I32, device=device), rx=z,
        replied=torch.zeros((n_hosts,), dtype=torch.bool, device=device),
        last_rx=z))
    init = Events(
        time=torch.tensor([MS, 500 * MS if second_send else TIME_INVALID],
                          device=device),
        dst=torch.zeros(2, dtype=I32, device=device),
        src=torch.zeros(2, dtype=I32, device=device),
        seq=torch.arange(2, dtype=I32, device=device),
        kind=torch.tensor([ttcp.N_TCP_KINDS, ttcp.N_TCP_KINDS + 1],
                          dtype=I32, device=device),
        args=torch.zeros((2, tstack.N_PKT_ARGS), dtype=I32, device=device))
    return eng, eng.init_state(hosts, init)


@dataclasses.dataclass(frozen=True)
class StreamApp:
    rx: torch.Tensor  # i64 server-side app-delivered bytes
    last_rx: torch.Tensor  # i64


def build_stream(total=100_000, *, loopback=False, reliability=1.0,
                 latency=10 * MS, bw=1024.0, seed=7, device="cpu",
                 **tcp_kw):
    """The client connects to <server>:80 at 1 ms and streams `total`
    bytes; loopback puts both ends on one host."""
    n_hosts = 1 if loopback else 2
    server = 0 if loopback else 1
    cslot = 1 if loopback else 0
    tcp = ttcp.TCP(**tcp_kw)
    stack = tstack.Stack(tcp=tcp)

    def on_recv(hs, slot, pkt, now, key):
        app = hs.app
        # data lands on the server's child slot; the client's slot sees
        # only its EOF
        got = (slot >= 0) & (pkt.length > 0) & (slot != cslot)
        app = dataclasses.replace(
            app, rx=app.rx + torch.where(got, pkt.length.to(I64), 0),
            last_rx=torch.where(got, now, app.last_rx))
        return (dataclasses.replace(hs, app=app),
                tengine.Emit.none(now.shape[0], 1, tstack.N_PKT_ARGS,
                                  device=now.device))

    def on_app(hs, ev, key):
        hs, em1 = tcp.connect(stack, hs, cslot, ev.time)
        hs, em2 = tcp.send(hs, cslot, total, ev.time)
        hs, em3 = tcp.close(hs, cslot, ev.time)
        return hs, ttcp.emit_concat(em1, em2, em3)

    handlers = stack.make_handlers(on_recv) + [on_app]
    cfg = tengine.EngineConfig(
        n_hosts=n_hosts, capacity=512, lookahead=latency,
        max_emit=tcp.min_max_emit(1), n_args=tstack.N_PKT_ARGS, seed=seed)
    eng = tengine.Engine(cfg, handlers,
                         tengine.ConstantNetwork(latency, reliability),
                         device=device)
    net = tstack.HostNet.create(n_hosts, 8, bw, bw, with_tcp=True,
                                device=device)
    tab = net.sockets.bind(server, 0, PROTO_TCP, 80)
    tab = tab.bind(0, cslot, PROTO_TCP, 10_000, peer_host=server,
                   peer_port=80)
    net = dataclasses.replace(net, sockets=tab,
                              tcb=net.tcb.listen(server, 0))
    z = torch.zeros((n_hosts,), dtype=I64, device=device)
    hosts = tstack.SimHost(net=net, app=StreamApp(rx=z, last_rx=z))
    one = lambda v: torch.tensor([v], dtype=I32, device=device)
    init = Events(time=torch.tensor([MS], device=device), dst=one(0),
                  src=one(0), seq=one(0), kind=one(ttcp.N_TCP_KINDS),
                  args=torch.zeros((1, tstack.N_PKT_ARGS), dtype=I32,
                                   device=device))
    return eng, eng.init_state(hosts, init)


def forget_socket(st, host, slot, put):
    """The state with `host`'s socket `slot` closed and its connection
    gone, as a host that restarts loses them. `put(a, host, slot, v)`
    returns `a` with [host, slot] set to v (either package's arrays)."""
    net = st.hosts.net
    so = net.sockets
    so = dataclasses.replace(
        so, proto=put(so.proto, host, slot, PROTO_NONE),
        local_port=put(so.local_port, host, slot, 0),
        peer_host=put(so.peer_host, host, slot, -1),
        peer_port=put(so.peer_port, host, slot, 0))
    tcb = dataclasses.replace(
        net.tcb, state=put(net.tcb.state, host, slot, ttcp.CLOSED))
    return dataclasses.replace(st, hosts=dataclasses.replace(
        st.hosts, net=dataclasses.replace(net, sockets=so, tcb=tcb)))


def put_torch(a, host, slot, v):
    a = a.clone()
    a[host, slot] = v
    return a


# -- tests/test_tor_bitcoin.py's configs, JAX-free ----------------------------
TOR_BTC_TOPOLOGY = """<graphml xmlns="http://graphml.graphdrawing.org/xmlns">
  <key attr.name="packetloss" attr.type="double" for="edge" id="d4" />
  <key attr.name="latency" attr.type="double" for="edge" id="d3" />
  <key attr.name="bandwidthup" attr.type="int" for="node" id="d2" />
  <key attr.name="bandwidthdown" attr.type="int" for="node" id="d1" />
  <graph edgedefault="undirected">
    <node id="poi-1">
      <data key="d1">102400</data>
      <data key="d2">102400</data>
    </node>
    <edge source="poi-1" target="poi-1">
      <data key="d3">20.0</data>
      <data key="d4">0.0</data>
    </edge>
  </graph>
</graphml>"""


def tor_config(n_clients=3, filesize="64KiB", count=2):
    """Two guards, middles and exits, one web server and `n_clients`
    clients starting at 3 s, 120 sim-s."""
    hosts = []
    for kind in ("guard", "middle", "exit"):
        for i in range(2):
            hosts.append(
                f'<host id="{kind}{i}">'
                '<process plugin="tor" starttime="1" arguments="relay"/>'
                "</host>"
            )
    hosts.append(
        '<host id="web0">'
        '<process plugin="tor" starttime="1" arguments="server port=80"/>'
        "</host>"
    )
    for i in range(n_clients):
        hosts.append(
            f'<host id="torclient{i}">'
            f'<process plugin="tor" starttime="3" arguments="client '
            f'server=web0:80 filesize={filesize} count={count} pause=1"/>'
            "</host>"
        )
    return (
        '<shadow stoptime="120">'
        f"<topology><![CDATA[{TOR_BTC_TOPOLOGY}]]></topology>"
        '<plugin id="tor" path="~/.shadow/bin/shadow-plugin-tor"/>'
        + "".join(hosts)
        + "</shadow>"
    )


def btc_config(n_nodes=8, blocks=3, blocksize="256KiB", interval=30):
    """One miner and n_nodes - 1 nodes, 3 peers each, running three
    intervals past the last block."""
    hosts = [
        '<host id="miner0">'
        f'<process plugin="bitcoin" starttime="1" arguments="node miner '
        f'peers=3 blocksize={blocksize} interval={interval} blocks={blocks}"/>'
        "</host>"
    ]
    for i in range(1, n_nodes):
        hosts.append(
            f'<host id="btc{i}">'
            f'<process plugin="bitcoin" starttime="1" arguments="node '
            f'peers=3 blocksize={blocksize} interval={interval} blocks={blocks}"/>'
            "</host>"
        )
    return (
        f'<shadow stoptime="{interval * (blocks + 3)}">'
        f"<topology><![CDATA[{TOR_BTC_TOPOLOGY}]]></topology>"
        '<plugin id="bitcoin" path="~/.shadow/bin/shadow-plugin-bitcoin"/>'
        + "".join(hosts)
        + "</shadow>"
    )


# Tor under relay churn at a small tier (4 relays per class, 20 clients,
# 4 servers) with bench.py's tor_churn_worker knobs (TOR_CHURN_KW), the
# churn moved to 3.5 s on a 3 s cycle so that a relay crashes and
# restarts inside a 6 s run: keywords of `models.tor.churn_scenario`
TOR_CHURN = dict(n_relays_per_class=4, n_clients=20, n_servers=4,
                 filesize="64KiB", count=2, churn_frac=0.3, churn_period=3.0,
                 churn_downtime=1.0, churn_start=3.5, stoptime=6)
TOR_CHURN_KW = dict(seed=1, n_sockets=32, capacity=768)
