"""The real-binary process tier: the native green-thread runtime and its
bridge to the simulation on the device.

`proc/native.py` builds the shared runtime (`native/shim/`) and the
interposer (`native/interpose/`) and binds them with ctypes,
`proc/model.py` is the device-side command and observation model, and
`proc/tier.py` the window-batched syscall exchange loop.
"""

from shadow_tpu_torch.proc.native import (
    ShimRuntime,
    build_runtime,
    compile_plugin,
)
from shadow_tpu_torch.proc.tier import ProcessTier

__all__ = ["ShimRuntime", "build_runtime", "compile_plugin", "ProcessTier"]
