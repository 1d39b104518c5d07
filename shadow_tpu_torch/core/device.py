"""The device an entry point of shadow_tpu_torch runs on."""

import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: `None` means "cuda", and a CUDA
    device must exist. There is no fallback to the CPU; pass "cpu" to
    run there."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "shadow_tpu_torch runs on CUDA by default and no CUDA device "
            "is available; pass device='cpu' to run on the CPU"
        )
    return dev
