"""PHOLD over the UDP stack (the config-driven variant).

The counterpart of `shadow_tpu.models.phold_net`. Each peer sends 1-byte
UDP datagrams to weighted-random peers on port 8998: at startup it
generates `load` messages, and every received message triggers one new
message. Each message goes socket -> tx NIC -> topology route -> CoDel
-> rx NIC -> socket demux, so the model exercises the whole stack.

Arguments: `load=K [weightsfilepath=weights.txt]` (one float per line,
the weight of peer i; uniform if absent or of any other length than the
number of peers).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from shadow_tpu_torch.config import parse_kv_arguments, resolve_path
from shadow_tpu_torch.core import rng as srng
from shadow_tpu_torch.core.engine import Emit
from shadow_tpu_torch.core.events import Events
from shadow_tpu_torch.host.sockets import PROTO_UDP
from shadow_tpu_torch.transport.stack import N_PKT_ARGS

PHOLD_PORT = 8998
_I32 = torch.int32
_I64 = torch.int64


@dataclasses.dataclass(frozen=True)
class PholdNetState:
    gid: torch.Tensor  # i32[H] own global id
    n_sent: torch.Tensor  # i64[H]
    n_recv: torch.Tensor  # i64[H]


class PholdNetModel:
    name = "phold"
    needs_tcp = False
    n_kinds = 1  # KIND_LOAD: emit one startup message, chain the next

    def __init__(self):
        self._stack = None
        self._kind_load = None

    def app_rows(self) -> int:
        return 1  # one relayed message per receive

    def handler_rows(self) -> int:
        return 2  # startup message + chain event

    def build(self, b):
        """Bind every peer's socket, schedule its startup chain and build
        the target CDF; returns (state, make_handlers, on_recv)."""
        n = b.n_hosts
        load = np.zeros((n,), np.int32)
        member = np.zeros((n,), bool)
        weights = None
        for h in b.hosts:
            for proc in h.spec.processes:
                kv = parse_kv_arguments(proc.arguments)
                member[h.gid] = True
                load[h.gid] = int(kv.get("load", 1))
                wf = kv.get("weightsfilepath", "")
                if wf and weights is None:
                    path = resolve_path(wf, b.cfg.base_dir)
                    if os.path.exists(path):
                        with open(path) as f:
                            weights = np.asarray(
                                [float(x) for x in f.read().split() if x],
                                np.float64,
                            )
                b.add_start_event(h.gid, proc.starttime, 0, [load[h.gid]])
                b.sockets = b.sockets.bind(h.gid, 0, PROTO_UDP, PHOLD_PORT)

        targets = np.nonzero(member)[0].astype(np.int32)
        if weights is None or len(weights) != len(targets):
            weights = np.ones((len(targets),), np.float64)
        cdf = np.cumsum(weights / weights.sum())

        dev = b.device
        self._targets = torch.from_numpy(targets).to(dev)
        self._cdf = torch.from_numpy(cdf).to(torch.float32).to(dev)

        state = PholdNetState(
            gid=torch.arange(n, dtype=_I32, device=dev),
            n_sent=torch.zeros((n,), dtype=_I64, device=dev),
            n_recv=torch.zeros((n,), dtype=_I64, device=dev),
        )
        return state, self._make_handlers, self._on_recv

    def _pick_target(self, key):
        """Weighted choice by inverse CDF: the first CDF entry >= u."""
        u = srng.uniform(key)
        idx = torch.searchsorted(self._cdf, u)
        return self._targets[torch.clamp(idx, max=len(self._targets) - 1)]

    def _send_one(self, hs, now, key, mask):
        target = self._pick_target(key)
        hs, em = self._stack.send_udp(hs, now, 0, target, PHOLD_PORT, 1,
                                      mask=mask)
        app = hs.app
        app = dataclasses.replace(app, n_sent=app.n_sent + mask.to(_I64))
        return dataclasses.replace(hs, app=app), em

    def _make_handlers(self, stack, kind_base):
        self._stack = stack
        self._kind_load = kind_base

        def on_load(hs, ev: Events, key):
            # emit one of the `load` startup messages, then chain the next
            # (keeps max_emit at 2 instead of `load`)
            remaining = ev.args[:, 0]
            hs, em_msg = self._send_one(hs, ev.time, key, remaining > 0)
            h, dev = remaining.shape[0], remaining.device
            args = torch.zeros((h, 1, N_PKT_ARGS), dtype=_I32, device=dev)
            args[:, 0, 0] = remaining - 1
            em_next = Emit(
                dst=torch.zeros((h, 1), dtype=_I32, device=dev),
                dt=torch.ones((h, 1), dtype=_I64, device=dev),
                kind=torch.full((h, 1), self._kind_load, dtype=_I32,
                                device=dev),
                args=args,
                mask=(remaining > 1)[:, None],
                local=torch.ones((h, 1), dtype=torch.bool, device=dev),
            )
            return hs, Emit(**{
                f.name: torch.cat([getattr(em_msg, f.name),
                                   getattr(em_next, f.name)], dim=1)
                for f in dataclasses.fields(Emit)})

        return [on_load]

    def _on_recv(self, hs, slot, pkt, now, key):
        got = slot >= 0
        app = hs.app
        app = dataclasses.replace(app, n_recv=app.n_recv + got.to(_I64))
        hs = dataclasses.replace(hs, app=app)
        return self._send_one(hs, now, key, got)
