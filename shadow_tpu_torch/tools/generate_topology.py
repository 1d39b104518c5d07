"""Generate an internet-like multi-PoI topology GraphML.

The reference ships a measured internet topology with its release
(resource/topology.graphml.xml.xz; GraphML attribute schema in
docs/3.2-Network-Config.md) that its 100-host bulk-transfer baseline
runs over. This generator synthesizes an original topology with the
same structure and attribute schema — geographic PoI clusters with
low intra-cluster and high inter-cluster latency, per-vertex bandwidth
tiers and packet loss, full connectivity — deterministically from a
seed, so large BASELINE-shaped configs have a realistic network to run
on without shipping measured data.

    python -m shadow_tpu_torch.tools.generate_topology --pois 60 -o topo.graphml.xml
"""

from __future__ import annotations

import argparse
import random
import sys

# (citycode, countrycode, continent-position) for cluster centers; the
# latency model is distance-ish: intra-cluster ~2-15ms, cross-cluster
# 20-180ms depending on center separation
_REGIONS = [
    ("NYC", "US", 0.0), ("LAX", "US", 0.6), ("YYZ", "CA", 0.1),
    ("LHR", "GB", 1.4), ("FRA", "DE", 1.5), ("CDG", "FR", 1.45),
    ("GRU", "BR", 0.9), ("NRT", "JP", 2.6), ("SYD", "AU", 3.1),
    ("SIN", "SG", 2.3), ("BOM", "IN", 2.0), ("JNB", "ZA", 1.8),
]

_BW_TIERS_KIB = [1024, 10240, 102400, 1048576]  # 1MiB/s .. 1GiB/s


def generate(n_pois: int = 60, seed: int = 0) -> str:
    rng = random.Random(seed)
    nodes = []
    for i in range(n_pois):
        city, country, pos = _REGIONS[i % len(_REGIONS)]
        bw = rng.choice(_BW_TIERS_KIB)
        loss = rng.choice([0.0, 0.0, 0.0, 0.001, 0.005])
        nodes.append((i, city, country, pos, bw, loss))

    out = [
        '<graphml xmlns="http://graphml.graphdrawing.org/xmlns">',
        '  <key attr.name="packetloss" attr.type="double" for="edge" id="e2" />',
        '  <key attr.name="jitter" attr.type="double" for="edge" id="e1" />',
        '  <key attr.name="latency" attr.type="double" for="edge" id="e0" />',
        '  <key attr.name="packetloss" attr.type="double" for="node" id="n5" />',
        '  <key attr.name="type" attr.type="string" for="node" id="n4" />',
        '  <key attr.name="citycode" attr.type="string" for="node" id="n3" />',
        '  <key attr.name="countrycode" attr.type="string" for="node" id="n2" />',
        '  <key attr.name="bandwidthdown" attr.type="int" for="node" id="n1" />',
        '  <key attr.name="bandwidthup" attr.type="int" for="node" id="n0" />',
        '  <graph edgedefault="undirected">',
    ]
    for i, city, country, _pos, bw, loss in nodes:
        out += [
            f'    <node id="poi-{i}">',
            f'      <data key="n0">{bw}</data>',
            f'      <data key="n1">{bw}</data>',
            f'      <data key="n2">{country}</data>',
            f'      <data key="n3">{city}</data>',
            '      <data key="n4">net</data>',
            f'      <data key="n5">{loss}</data>',
            "    </node>",
        ]
    # complete graph: the engine precomputes all-pairs tables either way,
    # and completeness keeps the reference's complete-graph fast path
    # available (topology.c complete-graph check)
    for i, _c, _cc, pos_i, _b, _l in nodes:
        for j, _c2, _cc2, pos_j, _b2, _l2 in nodes:
            if j < i:
                continue
            if i == j:
                lat = round(rng.uniform(0.5, 2.0), 2)
            elif abs(pos_i - pos_j) < 1e-9:  # same region cluster
                lat = round(rng.uniform(2.0, 15.0), 2)
            else:
                base = 18.0 + 52.0 * abs(pos_i - pos_j)
                lat = round(base * rng.uniform(0.85, 1.25), 2)
            jit = round(lat * rng.uniform(0.0, 0.08), 2)
            out += [
                f'    <edge source="poi-{i}" target="poi-{j}">',
                f'      <data key="e0">{lat}</data>',
                f'      <data key="e1">{jit}</data>',
                '      <data key="e2">0.0</data>',
                "    </edge>",
            ]
    out += ["  </graph>", "</graphml>"]
    return "\n".join(out) + "\n"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--pois", type=int, default=60)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("-o", "--out", default="topology.graphml.xml")
    args = p.parse_args(argv)
    text = generate(args.pois, args.seed)
    with open(args.out, "w") as f:
        f.write(text)
    print(f"wrote {args.out} ({args.pois} PoIs, complete graph)")
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
