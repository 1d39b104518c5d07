"""Built-in example configurations: copies of the pieces of
`shadow_tpu.examples` that the ported models run, kept here because
importing the reference package would import JAX."""

EXAMPLE_TOPOLOGY = """<graphml xmlns="http://graphml.graphdrawing.org/xmlns">
  <key attr.name="packetloss" attr.type="double" for="edge" id="d6" />
  <key attr.name="latency" attr.type="double" for="edge" id="d5" />
  <key attr.name="packetloss" attr.type="double" for="node" id="d4" />
  <key attr.name="countrycode" attr.type="string" for="node" id="d3" />
  <key attr.name="bandwidthdown" attr.type="int" for="node" id="d2" />
  <key attr.name="bandwidthup" attr.type="int" for="node" id="d1" />
  <key attr.name="ip" attr.type="string" for="node" id="d0" />
  <graph edgedefault="undirected">
    <node id="poi-1">
      <data key="d0">0.0.0.0</data>
      <data key="d1">10240</data>
      <data key="d2">10240</data>
      <data key="d3">US</data>
      <data key="d4">0.0</data>
    </node>
    <edge source="poi-1" target="poi-1">
      <data key="d5">50.0</data>
      <data key="d6">0.0</data>
    </edge>
  </graph>
</graphml>"""


def phold_example(n_hosts: int = 64, msgs_per_host: int = 4,
                  stoptime: int = 60) -> str:
    """A PHOLD config: n_hosts peers over a single 50 ms PoI, each
    starting at 1 s with `msgs_per_host` messages in flight."""
    return (
        f'<shadow stoptime="{stoptime}">'
        f"<topology><![CDATA[{EXAMPLE_TOPOLOGY}]]></topology>"
        '<plugin id="phold" path="shadow-plugin-test-phold"/>'
        f'<host id="peer" quantity="{n_hosts}">'
        f'<process plugin="phold" starttime="1" '
        f'arguments="load={msgs_per_host}"/>'
        "</host></shadow>"
    )


def example_config() -> str:
    """A 2-host TGen exchange over a 50 ms single-PoI topology: the
    client opens 3 streams of 64 KiB up and 1 MiB down, pausing 1-3 s
    between them (the reference's --test content)."""
    return f"""<shadow stoptime="120">
  <topology><![CDATA[{EXAMPLE_TOPOLOGY}]]></topology>
  <plugin id="tgen" path="tgen"/>
  <host id="server">
    <process plugin="tgen" starttime="1" arguments="server port=8888"/>
  </host>
  <host id="client">
    <process plugin="tgen" starttime="2"
      arguments="peers=server:8888 sendsize=64KiB recvsize=1MiB count=3 pause=1,2,3"/>
  </host>
</shadow>"""


def tgen_example(n_pairs: int = 64, sendsize: str = "16KiB",
                 recvsize: str = "64KiB", count: int = 4,
                 stoptime: int = 60) -> str:
    """n_pairs TGen client/server pairs, each client running `count`
    request/response streams against its own server with a 1-3 s
    cycling pause; client starts stagger over 5 s (3 s to 7 s)."""
    hosts = []
    for i in range(n_pairs):
        hosts.append(
            f'<host id="srv{i}" bandwidthup="102400" '
            'bandwidthdown="102400">'
            '<process plugin="tgen" starttime="1" '
            'arguments="server port=8888"/>'
            "</host>"
        )
    for i in range(n_pairs):
        hosts.append(
            f'<host id="cli{i}" bandwidthup="102400" '
            'bandwidthdown="102400">'
            f'<process plugin="tgen" starttime="{3 + (i % 5)}" '
            f'arguments="peers=srv{i}:8888 sendsize={sendsize} '
            f'recvsize={recvsize} count={count} pause=1,2,3"/>'
            "</host>"
        )
    return (
        f'<shadow stoptime="{stoptime}">'
        f"<topology><![CDATA[{EXAMPLE_TOPOLOGY}]]></topology>"
        '<plugin id="tgen" path="tgen"/>'
        + "".join(hosts)
        + "</shadow>"
    )


def tor_example(
    n_relays_per_class: int = 10,
    n_clients: int = 950,
    n_servers: int = 10,
    filesize: str = "320KiB",
    count: int = 5,
    stoptime: int = 60,
    relay_cpu_ghz: float = 0.0,
) -> str:
    """A Tor-like network (BASELINE.md config 3's shape): guard, middle
    and exit relays, web servers and torperf-style clients whose starts
    stagger over 5 s (3 s to 7 s). relay_cpu_ghz > 0 gives every relay a
    cpufrequency, which turns on the virtual CPU and the model's
    per-segment relay crypto charge."""
    cpu_attr = (
        f' cpufrequency="{int(relay_cpu_ghz * 1_000_000)}"'
        if relay_cpu_ghz > 0 else ""
    )
    hosts = []
    for klass in ("guard", "middle", "exit"):
        for i in range(n_relays_per_class):
            hosts.append(
                f'<host id="{klass}{i}" bandwidthup="102400" '
                f'bandwidthdown="102400"{cpu_attr}>'
                '<process plugin="tor" starttime="1" arguments="relay"/>'
                "</host>"
            )
    for i in range(n_servers):
        hosts.append(
            f'<host id="web{i}" bandwidthup="102400" '
            'bandwidthdown="102400">'
            '<process plugin="tor" starttime="1" arguments="server port=80"/>'
            "</host>"
        )
    for i in range(n_clients):
        hosts.append(
            f'<host id="torclient{i}">'
            f'<process plugin="tor" starttime="{3 + (i % 5)}" '
            f'arguments="client server=web{i % n_servers}:80 '
            f'filesize={filesize} count={count} pause=1,2,3"/>'
            "</host>"
        )
    return (
        f'<shadow stoptime="{stoptime}">'
        f"<topology><![CDATA[{EXAMPLE_TOPOLOGY}]]></topology>"
        '<plugin id="tor" path="shadow-plugin-tor"/>'
        + "".join(hosts)
        + "</shadow>"
    )



def tor_churn_example(
    n_relays_per_class: int = 10,
    n_clients: int = 950,
    n_servers: int = 10,
    filesize: str = "320KiB",
    count: int = 5,
    stoptime: int = 60,
    relay_cpu_ghz: float = 0.0,
    churn_frac: float = 0.2,
    churn_period: float = 20.0,
    churn_downtime: float = 5.0,
    churn_start: float = 10.0,
    churn_end: float | None = None,
) -> str:
    """The Tor example under relay churn: a deterministic fraction of the
    relays crash and restart on a cycle mid-run. Surviving circuits keep
    their streams; streams through a crashed relay hit the RST and
    retransmit teardown paths."""
    base = tor_example(
        n_relays_per_class=n_relays_per_class, n_clients=n_clients,
        n_servers=n_servers, filesize=filesize, count=count,
        stoptime=stoptime, relay_cpu_ghz=relay_cpu_ghz,
    )
    end = stoptime if churn_end is None else churn_end
    fault = (
        f'<fault type="churn" hosts="guard* middle* exit*" '
        f'start="{churn_start}" end="{end}" period="{churn_period}" '
        f'downtime="{churn_downtime}" frac="{churn_frac}"/>'
    )
    return base.replace("</shadow>", fault + "</shadow>")


def bitcoin_example(
    n_nodes: int = 5000,
    blocks: int = 3,
    blocksize: str = "512KiB",
    interval: int = 60,
    stoptime: int | None = None,
) -> str:
    """A Bitcoin gossip network (BASELINE.md config 5's shape): one miner
    and n_nodes - 1 nodes, 4 peers each; the run lasts two intervals past
    the last block unless `stoptime` is given."""
    stop = stoptime if stoptime is not None else interval * (blocks + 2)
    hosts = [
        '<host id="miner0">'
        f'<process plugin="bitcoin" starttime="1" arguments="node miner '
        f'peers=4 blocksize={blocksize} interval={interval} '
        f'blocks={blocks}"/></host>'
    ]
    for i in range(1, n_nodes):
        hosts.append(
            f'<host id="btc{i}">'
            f'<process plugin="bitcoin" starttime="1" arguments="node '
            f'peers=4 blocksize={blocksize} interval={interval} '
            f'blocks={blocks}"/></host>'
        )
    return (
        f'<shadow stoptime="{stop}">'
        f"<topology><![CDATA[{EXAMPLE_TOPOLOGY}]]></topology>"
        '<plugin id="bitcoin" path="shadow-plugin-bitcoin"/>'
        + "".join(hosts)
        + "</shadow>"
    )
