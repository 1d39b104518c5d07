"""Build a kernel library of `csrc/` with nvcc, once per source and flags.

Each kernel module (`core/merge.py`, `transport/cbrt.py`) compiles its
`.cu` file at first use into `build/shadow_tpu_torch/` beside the
package, under a name keyed by a hash of the source and the flags, and
loads it with ctypes. A library built from the same source and flags is
reused; a failed compile raises.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "shadow_tpu_torch"
# every kernel: Hopper, position-independent shared library
BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def library_path(source: Path, stem: str, flags) -> Path:
    tag = hashlib.sha256(
        source.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{stem}_{tag}.so"


def build(source: Path, stem: str, flags) -> tuple[Path, str]:
    """Compile `source` with `flags` unless a library built from the same
    source and flags exists. Returns (path, compiler output)."""
    out = library_path(source, stem, flags)
    if out.exists():
        return out, ""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([nvcc, *flags, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stderr
