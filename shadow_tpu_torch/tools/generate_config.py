"""Generate ready-to-run example simulation configs.

The reference ships generate_example_config.py, which writes a
shadow.config.xml plus tgen client/server graphml files
(reference: src/tools/generate_example_config.py). This generator covers
the same ground from the bundled example builders: every BASELINE.md
config shape (tgen pairs, tor circuits, bitcoin gossip, phold) plus the
tgen traffic-graph files our tgen model parses.

    python -m shadow_tpu_torch.tools.generate_config tgen -o example/
    python -m shadow_tpu_torch.tools.generate_config tor --clients 60 -o ex/
"""

from __future__ import annotations

import argparse
import os
import sys

from shadow_tpu_torch.examples import (
    bitcoin_example,
    example_config,
    phold_example,
    tor_example,
)

TGEN_SERVER_GRAPHML = """<?xml version="1.0" encoding="utf-8"?>
<graphml xmlns="http://graphml.graphdrawing.org/xmlns">
  <key attr.name="serverport" attr.type="string" for="node" id="d0"/>
  <graph edgedefault="directed">
    <node id="start"><data key="d0">8888</data></node>
  </graph>
</graphml>
"""

TGEN_CLIENT_GRAPHML = """<?xml version="1.0" encoding="utf-8"?>
<graphml xmlns="http://graphml.graphdrawing.org/xmlns">
  <key attr.name="peers" attr.type="string" for="node" id="d0"/>
  <key attr.name="sendsize" attr.type="string" for="node" id="d1"/>
  <key attr.name="recvsize" attr.type="string" for="node" id="d2"/>
  <key attr.name="count" attr.type="string" for="node" id="d3"/>
  <key attr.name="time" attr.type="string" for="node" id="d4"/>
  <graph edgedefault="directed">
    <node id="start"><data key="d0">server:8888</data></node>
    <node id="transfer">
      <data key="d1">64 KiB</data>
      <data key="d2">1 MiB</data>
      <data key="d3">3</data>
    </node>
    <node id="pause"><data key="d4">5</data></node>
    <edge source="start" target="transfer"/>
    <edge source="transfer" target="pause"/>
    <edge source="pause" target="transfer"/>
  </graph>
</graphml>
"""


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("kind", choices=["tgen", "tor", "bitcoin", "phold"])
    p.add_argument("-o", "--out", default=".",
                   help="output directory (created if missing)")
    p.add_argument("--hosts", type=int, default=None,
                   help="host/node count (model-dependent default)")
    p.add_argument("--clients", type=int, default=None,
                   help="tor: client count")
    p.add_argument("--stoptime", type=int, default=None)
    args = p.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    extras: dict[str, str] = {}
    if args.kind == "tgen":
        text = example_config()
        extras = {
            "tgen.server.graphml.xml": TGEN_SERVER_GRAPHML,
            "tgen.client.graphml.xml": TGEN_CLIENT_GRAPHML,
        }
    elif args.kind == "tor":
        kw = {}
        if args.clients:
            kw["n_clients"] = args.clients
        if args.stoptime:
            kw["stoptime"] = args.stoptime
        text = tor_example(**kw)
    elif args.kind == "bitcoin":
        kw = {}
        if args.hosts:
            kw["n_nodes"] = args.hosts
        if args.stoptime:
            kw["stoptime"] = args.stoptime
        text = bitcoin_example(**kw)
    else:
        kw = {}
        if args.hosts:
            kw["n_hosts"] = args.hosts
        if args.stoptime:
            kw["stoptime"] = args.stoptime
        text = phold_example(**kw)

    cfg_path = os.path.join(args.out, "shadow.config.xml")
    with open(cfg_path, "w") as f:
        f.write(text)
    for name, body in extras.items():
        with open(os.path.join(args.out, name), "w") as f:
            f.write(body)
    print(f"wrote {cfg_path}"
          + (f" + {', '.join(extras)}" if extras else ""))
    print(f"run it: python -m shadow_tpu_torch {cfg_path}")
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
