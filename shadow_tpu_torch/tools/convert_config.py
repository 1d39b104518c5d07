"""Migrate legacy configs to canonical shadow_tpu XML.

The reference ships convert_multi_app.py for migrating older
(scallion-era) experiment files to its current schema
(reference: src/tools/convert_multi_app.py). shadow_tpu's parser already
ACCEPTS the legacy spellings (config.py); this tool goes one step
further and re-emits a normalized file — legacy attribute names mapped
to canonical ones, quantity expansion preserved, topology inlined — so
downstream tooling only ever sees one dialect.

    python -m shadow_tpu_torch.tools.convert_config old.xml new.xml
"""

from __future__ import annotations

import sys
from xml.sax.saxutils import quoteattr

from shadow_tpu_torch.config import parse_config


def convert(text: str, base_dir: str = ".") -> str:
    cfg = parse_config(text, base_dir=base_dir)
    attrs = [f'stoptime="{cfg.stoptime:g}"']
    if cfg.bootstraptime:
        attrs.append(f'bootstraptime="{cfg.bootstraptime:g}"')
    if cfg.preload:
        attrs.append(f"preload={quoteattr(cfg.preload)}")
    if cfg.environment:
        attrs.append(f"environment={quoteattr(cfg.environment)}")
    out = [f"<shadow {' '.join(attrs)}>"]
    # inline the topology TEXT so the converted file is self-contained
    # (topology_source returns a path for path-based configs)
    topo = cfg.topology_source()
    if cfg.topology_path:
        with open(topo) as f:
            topo = f.read()
    out.append("  <topology><![CDATA[" + topo + "]]></topology>")
    for pl in cfg.plugins:
        out.append(
            f"  <plugin id={quoteattr(pl.id)} path={quoteattr(pl.path)}/>"
        )
    for h in cfg.hosts:
        attrs = [f"id={quoteattr(h.id)}"]
        if h.quantity > 1:
            attrs.append(f'quantity="{h.quantity}"')
        for name in ("bandwidthup", "bandwidthdown", "cpufrequency",
                     "socketrecvbuffer", "socketsendbuffer",
                     "interfacebuffer"):
            v = getattr(h, name, None)
            if v:
                attrs.append(f'{name}="{v:g}"')
        for name in ("iphint", "citycodehint", "countrycodehint",
                     "geocodehint", "typehint", "pcapdir", "loglevel",
                     "heartbeatloglevel", "heartbeatloginfo"):
            v = getattr(h, name, None)
            if v:
                attrs.append(f"{name}={quoteattr(str(v))}")
        if getattr(h, "heartbeatfrequency", None):
            attrs.append(f'heartbeatfrequency="{h.heartbeatfrequency}"')
        if getattr(h, "logpcap", False):
            attrs.append('logpcap="true"')
        out.append(f"  <host {' '.join(attrs)}>")
        for p in h.processes:
            pa = [f"plugin={quoteattr(p.plugin)}",
                  f'starttime="{p.starttime:g}"']
            if p.stoptime:
                pa.append(f'stoptime="{p.stoptime:g}"')
            if p.preload:
                pa.append(f"preload={quoteattr(p.preload)}")
            if p.arguments:
                pa.append(f"arguments={quoteattr(p.arguments)}")
            out.append(f"    <process {' '.join(pa)}/>")
        out.append("  </host>")
    out.append("</shadow>")
    return "\n".join(out) + "\n"


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        print("usage: convert_config <old.xml> <new.xml>", file=sys.stderr)
        return 2
    import os

    with open(argv[0]) as f:
        text = f.read()
    converted = convert(text, base_dir=os.path.dirname(
        os.path.abspath(argv[0])))
    with open(argv[1], "w") as f:
        f.write(converted)
    print(f"wrote {argv[1]}")
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
