"""Simtime-ordered buffered logger with per-host log levels: a copy of
`shadow_tpu.utils.logger`.

The reference's ShadowLogger batches records per worker thread and ships
them to a helper pthread that sorts by simulated time before writing
(reference: src/main/core/logger/shadow_logger.c:23-58), with per-host
level overrides (:102-121). Here record producers are the host-side run
loop, the tracker, and native-process log calls — device code never
formats strings — so the logger is a plain buffered sorter: records
accumulate with a (sim_ns, seq) key and flush in simulated order, which
keeps interleaved multi-host output deterministic no matter what order
the host code produced it in.
"""

from __future__ import annotations

import atexit
import dataclasses
import sys
import weakref
from typing import IO

LEVELS = ("error", "critical", "warning", "message", "info", "debug")
_RANK = {name: i for i, name in enumerate(LEVELS)}


@dataclasses.dataclass(frozen=True)
class LogRecord:
    sim_ns: int
    seq: int
    host: str
    level: str
    message: str

    def format(self) -> str:
        s, ns = divmod(self.sim_ns, 1_000_000_000)
        h, rem = divmod(s, 3600)
        m, sec = divmod(rem, 60)
        return (
            f"{h:02d}:{m:02d}:{sec:02d}.{ns // 1000:06d} "
            f"[{self.level}] [{self.host}] {self.message}"
        )


class ShadowLogger:
    """Buffered, simtime-sorted log sink.

    Buffered records are flushed at interpreter exit (atexit, via a
    weakref so the hook never pins the logger alive) and on context
    exit — an uncaught exception between heartbeats must not eat the
    log lines already produced. Usable as a context manager::

        with ShadowLogger() as logger:
            logger.log(...)
        # flushed here, even on exception
    """

    def __init__(self, default_level: str = "message",
                 stream: IO | None = None):
        self._default = _RANK[default_level]
        self._host_levels: dict[str, int] = {}
        self._buf: list[LogRecord] = []
        self._seq = 0
        self._stream = stream if stream is not None else sys.stdout
        ref = weakref.ref(self)
        self._atexit = lambda: (lambda lg: lg and lg.flush())(ref())
        atexit.register(self._atexit)

    def __enter__(self) -> "ShadowLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.flush()

    def __del__(self):  # pragma: no cover - GC timing dependent
        try:
            atexit.unregister(self._atexit)
        except Exception:
            pass

    def set_default_level(self, level: str) -> None:
        self._default = _RANK[level]

    def set_host_level(self, host: str, level: str) -> None:
        """Per-host override (shadow_logger.c:102-121; host loglevel attr)."""
        if level:
            self._host_levels[host] = _RANK[level]

    def enabled(self, host: str, level: str) -> bool:
        return _RANK[level] <= self._host_levels.get(host, self._default)

    def log(self, sim_ns: int, host: str, level: str, message: str) -> None:
        if not self.enabled(host, level):
            return
        self._buf.append(
            LogRecord(int(sim_ns), self._seq, host, level, message)
        )
        self._seq += 1

    def flush(self) -> int:
        """Write buffered records in (simtime, arrival) order. Safe to
        call at interpreter exit: a closed/broken stream drops the
        batch instead of raising into the atexit machinery."""
        self._buf.sort(key=lambda r: (r.sim_ns, r.seq))
        n = len(self._buf)
        try:
            for r in self._buf:
                print(r.format(), file=self._stream)
        except ValueError:  # stream already closed (interpreter teardown)
            pass
        self._buf.clear()
        return n
