"""shadow_tpu_torch: the simulator ported to PyTorch and CUDA (H100).

Held bit-identical to the JAX package `shadow_tpu`, which it never
imports. Entry points run on CUDA unless given `device="cpu"`.
"""

# the reference package's version: the metrics plane's build_info label
# and the CLI's banner read the same in both packages
__version__ = "0.1.0"
