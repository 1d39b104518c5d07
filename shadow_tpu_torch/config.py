"""Simulation configuration: the shadow.config.xml schema, parsed.

A copy of `shadow_tpu.config` (plain Python, no tensors), kept here
because importing the reference package would import JAX. It covers the
<shadow> root with stoptime / bootstraptime / preload / environment, a
<topology> holding a path or inline GraphML CDATA, <plugin id path>
entries, and <host> elements (quantity expansion, bandwidth overrides,
attachment hints, heartbeat and pcap options) holding <process plugin
starttime stoptime arguments>. Both element generations are accepted:
"node" for "host", "application" for "process", and a <kill time="T"/>
child in place of the stoptime attribute. <fault> elements become
`shadow_tpu_torch.faults.FaultSpec`s in `ShadowConfig.faults`.
"""

from __future__ import annotations

import dataclasses
import os
import re
import xml.etree.ElementTree as ET

from shadow_tpu_torch.faults import parse_fault_attrs


@dataclasses.dataclass(frozen=True)
class ProcessSpec:
    """<process plugin starttime stoptime arguments preload>
    (docs/3.1-Shadow-Config.md "The process element")."""

    plugin: str
    starttime: float  # virtual seconds
    arguments: str = ""
    stoptime: float | None = None
    preload: str | None = None


@dataclasses.dataclass(frozen=True)
class HostSpec:
    """<host ...> (docs/3.1-Shadow-Config.md "The host element")."""

    id: str
    quantity: int = 1
    bandwidthdown: int | None = None  # KiB/s, overrides topology vertex
    bandwidthup: int | None = None
    iphint: str = ""
    citycodehint: str = ""
    countrycodehint: str = ""
    geocodehint: str = ""
    typehint: str = ""
    interfacebuffer: int | None = None
    socketrecvbuffer: int | None = None
    socketsendbuffer: int | None = None
    loglevel: str = ""
    heartbeatloglevel: str = ""
    heartbeatloginfo: str = ""
    heartbeatfrequency: int | None = None
    cpufrequency: int | None = None
    logpcap: bool = False
    pcapdir: str = ""
    processes: tuple[ProcessSpec, ...] = ()


@dataclasses.dataclass(frozen=True)
class PluginSpec:
    """<plugin id path>."""

    id: str
    path: str


@dataclasses.dataclass(frozen=True)
class ShadowConfig:
    """The parsed <shadow> document."""

    stoptime: float  # virtual seconds
    bootstraptime: float = 0.0  # unlimited-bandwidth warmup window
    preload: str = ""
    environment: str = ""
    topology_path: str = ""
    topology_text: str = ""  # inline CDATA GraphML
    plugins: tuple[PluginSpec, ...] = ()
    hosts: tuple[HostSpec, ...] = ()
    base_dir: str = "."  # directory of the config file (path resolution)
    faults: tuple = ()  # FaultSpec per <fault> element, in order

    def plugin_by_id(self, pid: str) -> PluginSpec | None:
        for p in self.plugins:
            if p.id == pid:
                return p
        return None

    def topology_source(self) -> str:
        """GraphML text, or a resolved path to it."""
        if self.topology_text.strip():
            return self.topology_text
        if not self.topology_path:
            raise ValueError("config has no topology")
        return resolve_path(self.topology_path, self.base_dir)


def resolve_path(path: str, base_dir: str) -> str:
    """~/ expansion + config-relative resolution (configuration.c resolves
    plugin paths the same way; docs/3.1 'path begins with ~/')."""
    path = os.path.expanduser(path)
    if not os.path.isabs(path):
        cand = os.path.join(base_dir, path)
        if os.path.exists(cand):
            return cand
    return path


_SIZE_UNITS = {
    "b": 1,
    "kb": 10**3, "mb": 10**6, "gb": 10**9, "tb": 10**12,
    "kib": 2**10, "mib": 2**20, "gib": 2**30, "tib": 2**40,
}


def parse_size(text: str | int) -> int:
    """'1 MiB' / '512 kb' / '4096' -> bytes (tgen-style size strings)."""
    if isinstance(text, int):
        return text
    t = str(text).strip().lower()
    m = re.fullmatch(r"([0-9]*\.?[0-9]+)\s*([a-z]*)", t)
    if not m:
        raise ValueError(f"bad size: {text!r}")
    val, unit = float(m.group(1)), m.group(2)
    if unit in ("", "bytes", "byte"):
        return int(val)
    if unit not in _SIZE_UNITS:
        raise ValueError(f"bad size unit: {text!r}")
    return int(val * _SIZE_UNITS[unit])


def parse_kv_arguments(args: str) -> dict[str, str]:
    """'k=v k2=v2 flag' -> dict (the reference's plugins parse argv the
    same space-separated way, e.g. test_phold.c main arguments)."""
    out: dict[str, str] = {}
    for tok in args.split():
        if "=" in tok:
            k, v = tok.split("=", 1)
            out[k] = v
        else:
            out[tok] = ""
    return out


def _get(attrs: dict, *names: str, default=None):
    for n in names:
        if n in attrs:
            return attrs[n]
    return default


def parse_config(text_or_path: str, base_dir: str | None = None) -> ShadowConfig:
    """Parse a shadow.config.xml document (string or file path).

    `base_dir` overrides relative-path resolution for inline text (a
    path argument derives it from the file's directory)."""
    base_dir = base_dir or "."
    data = text_or_path
    if "\n" not in data and not data.lstrip().startswith("<"):
        base_dir = os.path.dirname(os.path.abspath(data)) or "."
        with open(data) as f:
            data = f.read()
    root = ET.fromstring(data)
    if root.tag != "shadow":
        raise ValueError(f"root element must be <shadow>, got <{root.tag}>")

    a = root.attrib
    stoptime = float(_get(a, "stoptime", default=0) or 0)
    bootstraptime = float(_get(a, "bootstraptime", default=0) or 0)

    plugins: list[PluginSpec] = []
    hosts: list[HostSpec] = []
    faults: list = []
    topo_path = ""
    topo_text = ""

    for el in root:
        if el.tag == "topology":
            topo_path = el.attrib.get("path", "")
            topo_text = (el.text or "").strip()
        elif el.tag == "plugin":
            plugins.append(
                PluginSpec(id=el.attrib["id"], path=el.attrib.get("path", ""))
            )
        elif el.tag == "kill":
            # legacy: <kill time="T"/> == stoptime attr
            stoptime = float(el.attrib["time"])
        elif el.tag == "fault":
            faults.append(parse_fault_attrs(el.attrib))
        elif el.tag in ("host", "node"):
            hosts.append(_parse_host(el))

    if stoptime <= 0:
        raise ValueError("config must set a positive stoptime (or <kill time>)")
    return ShadowConfig(
        stoptime=stoptime,
        bootstraptime=bootstraptime,
        preload=a.get("preload", ""),
        environment=a.get("environment", ""),
        topology_path=topo_path,
        topology_text=topo_text,
        plugins=tuple(plugins),
        hosts=tuple(hosts),
        base_dir=base_dir,
        faults=tuple(faults),
    )


def _parse_host(el: ET.Element) -> HostSpec:
    a = el.attrib
    procs = []
    for ch in el:
        if ch.tag in ("process", "application"):
            pa = ch.attrib
            procs.append(
                ProcessSpec(
                    plugin=pa["plugin"],
                    starttime=float(_get(pa, "starttime", "time", default=0)),
                    arguments=pa.get("arguments", ""),
                    stoptime=(
                        float(pa["stoptime"]) if "stoptime" in pa else None
                    ),
                    preload=pa.get("preload"),
                )
            )
    opt_int = lambda *n: (
        int(v) if (v := _get(a, *n)) is not None else None
    )
    return HostSpec(
        id=a["id"],
        quantity=int(a.get("quantity", 1) or 1),
        bandwidthdown=opt_int("bandwidthdown"),
        bandwidthup=opt_int("bandwidthup"),
        iphint=a.get("iphint", ""),
        citycodehint=a.get("citycodehint", ""),
        countrycodehint=a.get("countrycodehint", ""),
        geocodehint=a.get("geocodehint", ""),
        typehint=a.get("typehint", ""),
        interfacebuffer=opt_int("interfacebuffer"),
        socketrecvbuffer=opt_int("socketrecvbuffer"),
        socketsendbuffer=opt_int("socketsendbuffer"),
        loglevel=a.get("loglevel", ""),
        heartbeatloglevel=a.get("heartbeatloglevel", ""),
        heartbeatloginfo=a.get("heartbeatloginfo", ""),
        heartbeatfrequency=opt_int("heartbeatfrequency"),
        cpufrequency=opt_int("cpufrequency"),
        logpcap=str(a.get("logpcap", "")).lower() in ("true", "1", "yes"),
        pcapdir=a.get("pcapdir", ""),
        processes=tuple(procs),
    )


@dataclasses.dataclass(frozen=True)
class HostInstance:
    """One expanded virtual host (quantity applied): dense gid + name."""

    gid: int
    name: str
    spec: HostSpec


def expand_hosts(cfg: ShadowConfig) -> list[HostInstance]:
    """Apply quantity: id='host' quantity=2 -> '1.host', '2.host'
    (docs/3.1-Shadow-Config.md; the counter-prefix naming is the
    reference's)."""
    out: list[HostInstance] = []
    for spec in cfg.hosts:
        if spec.quantity <= 1:
            out.append(HostInstance(gid=len(out), name=spec.id, spec=spec))
        else:
            for i in range(spec.quantity):
                out.append(
                    HostInstance(
                        gid=len(out), name=f"{i + 1}.{spec.id}", spec=spec
                    )
                )
    if not out:
        raise ValueError("config defines no hosts")
    return out
