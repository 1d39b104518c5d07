"""Simulation time base: int64 nanoseconds since simulation start.

Constants only, the same values as `shadow_tpu.core.timebase`.
"""

NANOSECOND = 1
MICROSECOND = 1_000
MILLISECOND = 1_000_000
SECOND = 1_000_000_000

# Sentinel meaning "no event" / "empty slot"; sorts after every real time.
TIME_INVALID = (1 << 63) - 1
