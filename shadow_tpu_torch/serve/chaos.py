"""Deterministic fault injection for the serving plane: the counterpart
of `shadow_tpu.serve.chaos`, with the same variable, token grammar and
marker files.

`SHADOW_TPU_SERVE_CHAOS` holds `;`-separated injector tokens of the
form `kind:key=value,key=value`:

    raise:beat=K          one-shot RuntimeError at the start of beat K
    poison:seed=S         persistent: raises whenever the packed batch
                          contains a request with root seed S
    wedge:beat=K,secs=S   one-shot sleep of S seconds before the
                          harvest fetch of beat K (trips the launch
                          watchdog without corrupting device state)
    kill:beat=K           one-shot SIGKILL of the serve process at the
                          start of beat K (marker written first)
    devloss:beat=K        one-shot DeviceLost at the start of beat K —
                          EXIT_PEER_LOST=77 semantics: the service
                          treats it as a vanished device, not a
                          retryable launch failure
    resize:beat=K,lanes=M one-shot ResizeRequested(M) at the start of
                          beat K — the operator-SIGHUP mesh resize,
                          injected deterministically

"One-shot" must survive a SIGKILL + relaunch — the whole point of
`kill` is to test the restart path, and the restarted process re-reads
the same environment. So when a `marker_dir` is given, each one-shot
records its firing as a marker file (`serve_chaos.<kind>.<crc>.fired`,
written *before* the fault lands, mirroring the cli chaos-hang
marker); without one, an in-process set suffices. `poison` never
marks: it fires on every attempt that packs the poisoned seed, which
is exactly what bisection needs in order to isolate it.

This module is import-cheap and completely inert unless the env var is
set — the service holds `chaos = None` and never calls in here.
"""
from __future__ import annotations

import os
import signal
import time
import zlib

ENV_VAR = "SHADOW_TPU_SERVE_CHAOS"


class ChaosInjected(RuntimeError):
    """The exception raised by the `raise` and `poison` injectors."""


class DeviceLost(RuntimeError):
    """A device vanished mid-launch (the `devloss` injector, or a real
    backend peer-lost failure classified by the service). Distinct from
    ChaosInjected because the service must NOT retry in place — the
    device holding the fleet is gone; it exits EXIT_PEER_LOST=77 so the
    outer retry loop relaunches at a smaller mesh."""


class ResizeRequested(RuntimeError):
    """An operator asked for a new lane count mid-launch (the `resize`
    injector, or SIGHUP with a `.resize` control file). Carries the
    target in `.lanes`; the beat loop converts it into an in-process
    snapshot + migration instead of a failure."""

    def __init__(self, lanes: int):
        super().__init__(f"resize to {lanes} lanes requested")
        self.lanes = int(lanes)


def _parse_token(token: str) -> dict:
    kind, _, rest = token.partition(":")
    kind = kind.strip()
    if kind not in ("raise", "poison", "wedge", "kill", "devloss", "resize"):
        raise ValueError(f"serve-chaos: unknown injector {kind!r} in {token!r}")
    inj: dict = {"kind": kind, "token": token}
    for part in filter(None, (p.strip() for p in rest.split(","))):
        k, eq, v = part.partition("=")
        if not eq:
            raise ValueError(f"serve-chaos: bad param {part!r} in {token!r}")
        try:
            inj[k.strip()] = float(v) if k.strip() == "secs" else int(v)
        except ValueError:
            raise ValueError(
                f"serve-chaos: non-numeric value {v!r} in {token!r}"
            ) from None
    need = {"raise": ("beat",), "poison": ("seed",),
            "wedge": ("beat", "secs"), "kill": ("beat",),
            "devloss": ("beat",), "resize": ("beat", "lanes")}[kind]
    for k in need:
        if k not in inj:
            raise ValueError(f"serve-chaos: {kind!r} needs {k}= in {token!r}")
    return inj


class ServeChaos:
    """Parsed injector set; `fire(site, ...)` is called from the beat
    loop ("beat": before stepping) and from the harvest path ("fetch":
    before the device fetch). `on_inject(kind)` fires once per
    injection so the service can count `serve_chaos_injected`."""

    def __init__(self, spec: str, marker_dir: str | None = None,
                 on_inject=None):
        self._injectors = [
            _parse_token(t) for t in filter(None, (s.strip() for s in spec.split(";")))
        ]
        self._marker_dir = marker_dir
        self._fired: set[str] = set()
        self._on_inject = on_inject

    def __bool__(self) -> bool:
        return bool(self._injectors)

    def _once(self, inj: dict) -> bool:
        """True exactly once per injector (across relaunches when a
        marker dir is set); marks the firing before returning."""
        name = "serve_chaos.{}.{:08x}.fired".format(
            inj["kind"], zlib.crc32(inj["token"].encode("utf-8")))
        if self._marker_dir:
            path = os.path.join(self._marker_dir, name)
            if os.path.exists(path):
                return False
            os.makedirs(self._marker_dir, exist_ok=True)
            with open(path, "w") as f:  # marker BEFORE the fault lands
                f.write(inj["token"] + "\n")
            return True
        if name in self._fired:
            return False
        self._fired.add(name)
        return True

    def _note(self, kind: str) -> None:
        if self._on_inject is not None:
            self._on_inject(kind)

    def fire(self, site: str, *, beat: int = 0,
             seeds: tuple[int, ...] = ()) -> None:
        for inj in self._injectors:
            kind = inj["kind"]
            if site == "beat":
                if kind == "poison" and inj["seed"] in seeds:
                    self._note(kind)
                    raise ChaosInjected(
                        f"serve-chaos: poison seed {inj['seed']} in batch")
                if kind == "raise" and beat == inj["beat"] and self._once(inj):
                    self._note(kind)
                    raise ChaosInjected(
                        f"serve-chaos: injected raise at beat {beat}")
                if kind == "kill" and beat == inj["beat"] and self._once(inj):
                    self._note(kind)
                    os.kill(os.getpid(), signal.SIGKILL)
                if (kind == "devloss" and beat == inj["beat"]
                        and self._once(inj)):
                    self._note(kind)
                    raise DeviceLost(
                        f"serve-chaos: injected device loss at beat {beat}")
                if (kind == "resize" and beat == inj["beat"]
                        and self._once(inj)):
                    self._note(kind)
                    raise ResizeRequested(inj["lanes"])
            elif site == "fetch":
                if kind == "wedge" and beat == inj["beat"] and self._once(inj):
                    self._note(kind)
                    time.sleep(inj["secs"])


def from_env(marker_dir: str | None = None, on_inject=None):
    """ServeChaos from `SHADOW_TPU_SERVE_CHAOS`, or None when unset —
    the zero-cost default."""
    spec = os.environ.get(ENV_VAR, "").strip()
    if not spec:
        return None
    return ServeChaos(spec, marker_dir=marker_dir, on_inject=on_inject)
