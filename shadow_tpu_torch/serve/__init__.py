"""Resident scenario serving: multi-tenant requests on one warm engine,
the counterpart of `shadow_tpu.serve` with the same exports.

A batch run builds its engine and state per process launch; a fleet
(`runtime.fleet`) runs many scenarios as one engine over their lanes.
This package keeps such fleets warm across requests: a long-lived
service that

- accepts scenario requests over a stdlib-only HTTP plane
  (`serve.http`: POST /submit, GET /result/<id>, /queue, /metrics),
- keys built fleets by their static-knob equivalence class and keeps
  them warm across requests (`serve.cache.ProgramCache` — the class
  key is exactly the knob set `check_lane_knobs` rejects per-lane,
  because those are the knobs one built fleet fixes),
- packs compatible queued requests into fleet lanes
  (`serve.packer.LanePacker`, deadline-or-full dispatch) and launches
  them through the cached fleet with inert-lane padding, per-lane
  stop times, and heartbeat progress off the single-fetch harvest
  (`serve.service.SimService`),

returning each request's summary JSON bit-identical to its solo
`Engine.run` (`solo_reference`), and to the reference's.

`SimService(device=None)` runs on CUDA and raises without a card; pass
`device="cpu"` to serve on the CPU. docs/17-Serving.md is the
narrative: request schema, equivalence-class table, packer policy,
drain semantics.
"""

from shadow_tpu_torch.serve.cache import ProgramCache
from shadow_tpu_torch.serve.packer import (
    ClassKey,
    LanePacker,
    ScenarioRequest,
    equivalence_class,
    parse_request,
)
from shadow_tpu_torch.serve.chaos import ServeChaos
from shadow_tpu_torch.serve.service import (
    ServiceDegraded,
    ServiceDraining,
    ServiceUnavailable,
    SimService,
    solo_reference,
)

__all__ = [
    "ClassKey",
    "LanePacker",
    "ProgramCache",
    "ScenarioRequest",
    "ServeChaos",
    "ServiceDegraded",
    "ServiceDraining",
    "ServiceUnavailable",
    "SimService",
    "equivalence_class",
    "parse_request",
    "solo_reference",
]
