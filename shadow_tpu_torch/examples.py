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
