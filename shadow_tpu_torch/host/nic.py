"""NIC rate limiting and CoDel AQM as per-host tensors.

The counterpart of `shadow_tpu.host.nic`. Each NIC direction is a
virtual clock: `free_at` is when its serialization of earlier packets
ends. A packet of B bytes offered at t starts at max(t, free_at) and
finishes B / rate later; an idle NIC may lag `now` by at most `burst_ns`
(a token bucket's depth in time). The receive queue is implicit, and its
sojourn (rx start - arrival) feeds CoDel's control law.

Every tensor is [H]-leading and every method is elementwise over the
rows, so one call serves all hosts.

Bit-exact corners, each pinned by tests/test_torch_udp_stack.py:
- `NIC.create` computes the f64 rate and burst with tensor divisors:
  torch divides by a Python scalar as a multiply by its reciprocal;
- `_control_law` is what the reference's compiled program computes for
  `interval / sqrt(f32(count))`: XLA rewrites it as `interval *
  rsqrt(x)`, and its CPU backend emits an x86 estimate plus two
  Newton-Raphson steps with fused multiply-adds (`xla_rsqrt_f32`). The
  estimate is `vrsqrt14ps` in 16-lane vector loops and `rsqrtps` /
  `rsqrtss` elsewhere, and the two differ in the final bits (first at
  count 19), so CoDel picks per row what the reference's loop did
  (`engine_wide_rows`).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from shadow_tpu_torch.core.timebase import MILLISECOND, SECOND

# CoDel control-law constants (RFC 8289).
CODEL_TARGET = 10 * MILLISECOND
CODEL_INTERVAL = 100 * MILLISECOND

# Lanes of the widest loops XLA vectorizes f32 work into on the
# reference's CPU (AVX-512); see `engine_wide_rows`.
VECTOR_LANES = 16

# Wire overhead per packet.
MTU = 1500
HEADER_UDP = 42
HEADER_TCP = 66


def _full(like: torch.Tensor, value, dtype) -> torch.Tensor:
    return torch.full(like.shape, value, dtype=dtype, device=like.device)


def kib_per_sec_to_bytes_per_ns(kib: torch.Tensor) -> torch.Tensor:
    """KiB/s (GraphML bandwidths) to bytes per ns, in f64."""
    b = kib.to(torch.float64) * 1024.0
    return b / _full(b, float(SECOND), torch.float64)


@dataclasses.dataclass(frozen=True)
class NIC:
    """One direction's virtual-clock rate limiter, [H] tensors."""

    free_at: torch.Tensor  # i64 time the link is next free
    rate: torch.Tensor  # f32 bytes per ns
    burst_ns: torch.Tensor  # i64 max idle credit (bucket depth in time)
    pkts: torch.Tensor  # i64 packets admitted
    wire: torch.Tensor  # i64 wire bytes admitted (payload + headers)
    buf_bytes: torch.Tensor  # i64 drop-tail buffer bound (0 = unlimited)
    drops: torch.Tensor  # i64 packets tail-dropped at this NIC

    @staticmethod
    def create(bandwidth_kib: torch.Tensor, burst_bytes: int = 16 * 1024,
               buf_bytes=0) -> "NIC":
        """Idle NICs of the given bandwidths ([H] KiB/s, on the device
        the state lives on)."""
        rate = kib_per_sec_to_bytes_per_ns(bandwidth_kib)
        rate = torch.clamp(rate, min=1e-12).to(torch.float32)
        r64 = rate.to(torch.float64)
        burst = (_full(r64, float(burst_bytes), torch.float64) / r64).to(
            torch.int64)
        z = torch.zeros_like(burst)
        return NIC(
            free_at=z, rate=rate, burst_ns=burst, pkts=z, wire=z,
            buf_bytes=torch.as_tensor(buf_bytes, dtype=torch.int64).to(
                burst.device).expand(burst.shape).clone(),
            drops=z,
        )

    def backlog_bytes(self, t: torch.Tensor) -> torch.Tensor:
        """Bytes queued behind the virtual clock at time t (the implicit
        receive queue that `interfacebuffer` bounds)."""
        lag = torch.clamp(self.free_at - t, min=0)
        return (lag.to(torch.float32) * self.rate).to(torch.int64)

    def admit(self, t: torch.Tensor, nbytes: torch.Tensor, unlimited):
        """Serialize `nbytes` (i32) starting no earlier than t.

        Returns (nic', start_time, finish_time). Rows where `unlimited`
        (the bootstrap phase) pass instantly and leave the clock alone;
        the packet and byte counters count every row.
        """
        free = torch.maximum(self.free_at, t - self.burst_ns)
        start = torch.maximum(t, free)
        dur = (nbytes.to(torch.float32) / self.rate).to(torch.int64)
        finish = start + torch.clamp(dur, min=1)
        start = torch.where(unlimited, t, start)
        finish = torch.where(unlimited, t, finish)
        new_free = torch.where(unlimited, self.free_at, finish)
        return (
            dataclasses.replace(
                self,
                free_at=new_free,
                pkts=self.pkts + 1,
                wire=self.wire + nbytes.to(torch.int64),
            ),
            start,
            finish,
        )


@dataclasses.dataclass(frozen=True)
class CoDel:
    """RFC 8289 CoDel controller state, [H] tensors.

    A sojourn below target resets the first-above clock and ends a drop
    episode; a sojourn at or above target for a whole interval enters
    drop mode; while dropping, drops fall at drop_next += interval /
    sqrt(count).
    """

    dropping: torch.Tensor  # bool
    count: torch.Tensor  # i32 drops in the current dropping episode
    first_above: torch.Tensor  # i64 when sojourn first exceeded target (0 = not)
    drop_next: torch.Tensor  # i64 next scheduled drop time

    @staticmethod
    def create(n_hosts: int, *, device) -> "CoDel":
        z = lambda dtype: torch.zeros((n_hosts,), dtype=dtype, device=device)
        return CoDel(dropping=z(torch.bool), count=z(torch.int32),
                     first_above=z(torch.int64), drop_next=z(torch.int64))

    def on_dequeue(self, now: torch.Tensor, sojourn: torch.Tensor):
        """Process one dequeue per row; returns (codel', drop bool[H])."""
        below = sojourn < CODEL_TARGET
        # first time above target: arm the interval clock
        first_above = torch.where(
            below, 0,
            torch.where(self.first_above == 0, now + CODEL_INTERVAL,
                        self.first_above))
        ok_to_drop = ~below & (first_above != 0) & (now >= first_above)

        # a below-target packet ends any dropping episode
        dropping = self.dropping & ~below

        # entering drop state: a recent episode resumes with a higher
        # count, so the drop rate re-ramps quickly; else restart at 1
        enter = ok_to_drop & ~dropping
        resume = (enter & (now - self.drop_next < CODEL_INTERVAL)
                  & (self.count > 2))
        count_on_enter = torch.where(resume, self.count - 2,
                                     torch.ones_like(self.count))
        wide = engine_wide_rows(now.shape[0], now.device)
        drop_next_on_enter = _control_law(now, count_on_enter, wide)

        # while in drop state: drop when now >= drop_next, then reschedule
        in_drop = dropping & (now >= self.drop_next) & ok_to_drop
        count_in_drop = self.count + 1
        drop_next_in_drop = _control_law(self.drop_next, count_in_drop, wide)

        drop = enter | in_drop
        new = CoDel(
            dropping=dropping | enter,
            count=torch.where(enter, count_on_enter,
                              torch.where(in_drop, count_in_drop,
                                          self.count)),
            first_above=first_above,
            drop_next=torch.where(
                enter, drop_next_on_enter,
                torch.where(in_drop, drop_next_in_drop, self.drop_next)),
        )
        return new, drop


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c) -> torch.Tensor:
    """f32 fused multiply-add. The product of two f32 values is exact in
    f64; the one f64 add and the rounding to f32 reproduce the FMA on
    every input `xla_rsqrt_f32` feeds it (pinned exhaustively)."""
    return (a.double() * b.double() + c).float()


def _split_f32(x: torch.Tensor):
    """(exponent parity p, half exponent k, mantissa bits m) of normal
    f32 x > 0, with x = 1.m * 2^p * 4^k."""
    bits = x.view(torch.int32).to(torch.int64)
    e = (bits >> 23) - 127
    p = e & 1
    return p, (e - p) // 2, bits & 0x7FFFFF


def _scaled(r: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """f32 of the f64 r * 2^-k, with 2^-k built from its bits (no pow,
    so no library rounding)."""
    return (r * ((1023 - k) << 52).view(torch.float64)).to(torch.float32)


def _rsqrt12_estimate(x: torch.Tensor) -> torch.Tensor:
    """The x86 `rsqrtps` / `rsqrtss` estimate of 1/sqrt(x), f32 x > 0.

    It reads the exponent's parity and the top 10 mantissa bits, and
    returns 1/sqrt of that interval's midpoint rounded to 12 significant
    bits, scaled by half the exponent. Every step is exact in f64, so it
    gives the same bits on any device.
    """
    p, k, m = _split_f32(x)
    j = (m >> 13).to(torch.float64)
    mid = (1.0 + (j + 0.5) / 1024.0) * (p + 1).to(torch.float64)
    return _scaled(torch.round(8192.0 / torch.sqrt(mid)) / 8192.0, k)


# The AVX-512 `vrsqrt14ps` estimate is piecewise linear: per exponent
# parity, 32 segments of the top 5 mantissa bits, each read at the next
# 10 bits r as (C - D * r) >> 9 in units of 2^-17. Read off the
# instruction over all 2^24 inputs in [1, 4) (see
# tests/test_torch_udp_stack.py, which holds the table against it).
_RSQRT14_C = (
    (67105920, 66080896, 65102464, 64166144, 63268608, 62407552, 61580928,
     60786816, 60022016, 59285632, 58575744, 57891328, 57229568, 56589568,
     55971712, 55373184, 54793088, 54231424, 53686144, 53156864, 52643456,
     52144512, 51659776, 51188096, 50728832, 50281856, 49847040, 49422080,
     49008512, 48605952, 48211840, 47828224),
    (47450752, 46726272, 46034432, 45371904, 44738048, 44129152, 43544704,
     42982528, 42442368, 41921920, 41419392, 40935040, 40467072, 40015104,
     39577728, 39155072, 38744960, 38347136, 37961600, 37588096, 37224832,
     36871936, 36528640, 36195328, 35870976, 35554944, 35246976, 34946816,
     34654848, 34369152, 34091008, 33819392),
)
_RSQRT14_D = (
    (1001, 955, 915, 877, 841, 807, 775, 747, 719, 693, 669, 647, 625, 603,
     585, 567, 549, 533, 517, 501, 487, 473, 461, 449, 437, 425, 415, 403,
     393, 385, 375, 367),
    (707, 675, 647, 619, 595, 571, 549, 527, 509, 491, 473, 457, 441, 427,
     413, 401, 389, 377, 365, 355, 345, 335, 325, 317, 309, 301, 293, 285,
     279, 271, 265, 259),
)


@functools.lru_cache(maxsize=None)
def _rsqrt14_tables(device: torch.device):
    """The segment table as two flat i64 tensors on `device`, copied
    there once."""
    return tuple(torch.tensor(t, dtype=torch.int64, device=device).reshape(-1)
                 for t in (_RSQRT14_C, _RSQRT14_D))


def _rsqrt14_estimate(x: torch.Tensor) -> torch.Tensor:
    """The AVX-512 `vrsqrt14ps` estimate of 1/sqrt(x), f32 x > 0: the
    segment table above, and exact powers of two for x = 4^k."""
    p, k, m = _split_f32(x)
    seg = p * 32 + (m >> 18)
    c, d = _rsqrt14_tables(x.device)
    q = (c[seg] - d[seg] * ((m >> 8) & 0x3FF)) >> 9
    r = torch.where((m == 0) & (p == 0), 1 << 17, q).to(torch.float64)
    return _scaled(r / float(1 << 17), k)


def xla_rsqrt_f32(x: torch.Tensor, wide=False) -> torch.Tensor:
    """XLA's CPU `rsqrt` for f32 (jax 0.9.0), operation for operation:
    an x86 estimate and two Newton-Raphson steps
    y' = y + (-0.5 y) * (y x y - 1), whose multiply-adds the backend
    fuses. The estimate depends on how XLA vectorized the loop: 16-lane
    vectors (AVX-512) use `vrsqrt14ps`, narrower ones and scalar code
    `rsqrtps` / `rsqrtss`. `wide` (a bool, or a bool tensor shaped like
    x) selects the 16-lane estimate."""
    if isinstance(wide, bool):
        y = _rsqrt14_estimate(x) if wide else _rsqrt12_estimate(x)
    else:
        y = torch.where(wide, _rsqrt14_estimate(x), _rsqrt12_estimate(x))
    for _ in range(2):
        d = _fma_f32(y * x, y, -1.0)
        y = _fma_f32(y * -0.5, d, y)
    return y


def engine_wide_rows(n: int, device) -> bool | torch.Tensor:
    """Which of n rows the reference's compiled CoDel runs through a
    16-lane vector loop, as read off its programs: the rows before the
    last n % 16, unless that remainder is 8 or more in a loop shorter
    than 184 rows, where LLVM picks 8-lane vectors throughout. A bool
    when all rows or none are wide. Shape-bucketed simulations have
    n % 16 == 0, so every row is."""
    rem = n % VECTOR_LANES
    full = 0 if rem >= 8 and n < 184 else n - rem
    if full in (0, n):
        return full == n
    return torch.arange(n, device=device) < full


def _control_law(t: torch.Tensor, count: torch.Tensor,
                 wide=False) -> torch.Tensor:
    """drop_next = t + interval / sqrt(count), as the reference's compiled
    program computes it: interval * rsqrt(count) in f32. `wide` as in
    `xla_rsqrt_f32`; the default is what `jax.jit(_control_law)` does
    on its own."""
    x = torch.clamp(count, min=1).to(torch.float32)
    y = xla_rsqrt_f32(x, wide)
    return t + (y * _full(y, float(CODEL_INTERVAL), torch.float32)
                ).to(torch.int64)
