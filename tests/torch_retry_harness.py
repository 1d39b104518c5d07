"""A JAX-free `_popen` for `run_with_retry` whose children run
`shadow_tpu_torch.cli.main(argv, device=...)`, the first attempt dying by
SIGKILL right after its first checkpoint; shared by
tests/test_torch_retry.py (the CPU) and tests/test_torch_cuda.py (the
card)."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

CHILD = """
import os, signal, sys
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(1)
from shadow_tpu_torch import cli
from shadow_tpu_torch.utils import checkpoint

if not os.environ.get("SHADOW_TPU_RETRY_ATTEMPT"):
    # the first attempt dies right after its first checkpoint
    save = checkpoint.save_checkpoint

    def save_then_die(*a, **k):
        save(*a, **k)
        os.kill(os.getpid(), signal.SIGKILL)

    checkpoint.save_checkpoint = save_then_die
sys.exit(cli.main(sys.argv[1:], device={device!r}))
"""


def child_popen(device: str):
    """A `_popen` whose children run `cli.main(argv, device=device)`
    instead of `python -m shadow_tpu_torch`."""
    script = CHILD.format(root=str(ROOT), device=device)

    def popen(argv, **kw):
        assert argv[1:3] == ["-m", "shadow_tpu_torch"]
        return subprocess.Popen([sys.executable, "-c", script] + argv[3:],
                                **kw)

    return popen
