"""Deterministic fault injection and churn: the counterpart of
`shadow_tpu.faults`. See schedule.py for the schedule compiler."""

from shadow_tpu_torch.faults.schedule import (
    FAULT_TYPES,
    CompiledFaults,
    FaultSpec,
    compile_faults,
    parse_fault_attrs,
    parse_fault_dsl,
)

__all__ = [
    "FAULT_TYPES",
    "CompiledFaults",
    "FaultSpec",
    "compile_faults",
    "parse_fault_attrs",
    "parse_fault_dsl",
]
