"""shadow_tpu_torch: the simulator ported to PyTorch and CUDA (H100).

Held bit-identical to the JAX package `shadow_tpu`, which it never
imports. Entry points run on CUDA unless given `device="cpu"`.
"""
