"""Deterministic per-host random streams: counter-based threefry2x32.

The same generator as `shadow_tpu.core.rng`, bit for bit: every executed
event gets a key derived from (root seed, global host id, per-host
execution counter), and every draw is one elementwise pass over a batch.
Keys are int64 tensors `[..., 2]` holding uint32 values: torch's uint32
type lacks `+`, `<<`, `>>` and `%`, so the cipher runs in int64 masked
to 32 bits, with logical shifts (the operands are never negative).

Stream separation: every derivation folds a distinct DOMAIN tag into the
counter word, so handler keys, route keys, split children and lane rolls
never collide however many draws a handler makes.

No torch generator is used anywhere: the simulation's randomness is this
cipher alone, so a run is reproducible on any device.
"""

from __future__ import annotations

import struct

import torch

_M32 = 0xFFFFFFFF
_KS_PARITY = 0x1BD11BDA  # threefry key-schedule parity constant
# domain tags (counter-word c1) for the derivation kinds
_DOM_EVENT = 0x45564E54  # "EVNT": (gid, cnt) -> event key
_DOM_HANDLER = 0x484E444C  # "HNDL": event key -> handler key
_DOM_ROUTE = 0x524F5554  # "ROUT": event key -> route key
_DOM_SPLIT = 0x53504C54  # "SPLT": split children
_DOM_LANE = 0x4C414E45  # "LANE": per-lane rolls
_DOM_FOLD = 0x464F4C44  # "FOLD": fold_in derivations
_DOM_UNIF = 0x554E4946  # "UNIF": uniform/bernoulli draws
_DOM_RINT = 0x52494E54  # "RINT": randint draws
_DOM_FAULT = 0x464C5453  # "FLTS": named fault-schedule streams


def _rotl(x, r: int):
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(k0, k1, c0, c1):
    """The standard 20-round threefry2x32 block cipher, elementwise over
    broadcastable int64 tensors (or Python ints) holding uint32 values."""
    ks2 = k0 ^ k1 ^ _KS_PARITY
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    x0 = (c0 + k0) & _M32
    x1 = (c1 + k1) & _M32
    ks = (k1, ks2, k0)
    for i in range(5):
        for r in rot[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r)
            x1 = x0 ^ x1
        x0 = (x0 + ks[i % 3]) & _M32
        x1 = (x1 + ks[(i + 1) % 3] + (i + 1)) & _M32
    return x0, x1


def _key(k0: torch.Tensor, k1: torch.Tensor) -> torch.Tensor:
    return torch.stack(torch.broadcast_tensors(k0, k1), dim=-1)


def root_key(seed: int, device) -> torch.Tensor:
    """int64[2] root key (uint32 values) from a Python seed."""
    s, hi = seed & _M32, (int(seed) >> 32) & _M32
    x0, x1 = threefry2x32(s, hi, 0, 0)
    return torch.tensor([x0, x1], dtype=torch.int64, device=device)


def _children(k0, k1, c0, c1) -> tuple[torch.Tensor, ...]:
    """Keys threefry(k, (c0[i], c1[i])) for the n counter pairs of the
    1-d tensors c0, c1, elementwise over k's batch shape: the n sibling
    derivations run as one cipher pass over a trailing axis of n."""
    x0, x1 = threefry2x32(k0[..., None], k1[..., None], c0, c1)
    return tuple(_key(x0[..., i], x1[..., i]) for i in range(c0.shape[0]))


def event_keys(base: torch.Tensor, host_gids: torch.Tensor,
               exec_cnt: torch.Tensor):
    """Per-event (handler_key, route_key), each int64[..., 2]."""
    g = host_gids.to(torch.int64) & _M32
    c = exec_cnt.to(torch.int64) & _M32
    a, b = threefry2x32(base[..., 0], base[..., 1], g, c ^ _DOM_EVENT)
    two = torch.arange(2, dtype=torch.int64, device=g.device)
    hk, rk = _children(a, b, two * 0,
                       _DOM_HANDLER + two * (_DOM_ROUTE - _DOM_HANDLER))
    return hk, rk


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """New key folding integer `data` (tensor or Python int) into `key`."""
    d = data & _M32 if isinstance(data, int) else data.to(torch.int64) & _M32
    return _key(*threefry2x32(key[..., 0], key[..., 1], d, _DOM_FOLD))


def split(key: torch.Tensor, n: int):
    """n child keys (tuple), elementwise over any leading batch shape."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    return _children(key[..., 0], key[..., 1], i, i * 0 + _DOM_SPLIT)


def _bits(key: torch.Tensor, c0=0, c1=0) -> torch.Tensor:
    x0, _ = threefry2x32(key[..., 0], key[..., 1], c0, c1)
    return x0


def _to_unit(bits: torch.Tensor) -> torch.Tensor:
    # 24-bit mantissa path: exact in f32, uniform in [0, 1)
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def uniform(key: torch.Tensor) -> torch.Tensor:
    """f32 uniform in [0, 1), shaped like the key's batch shape."""
    return _to_unit(_bits(key, c1=_DOM_UNIF))


def uniform_lanes(key: torch.Tensor, n_lanes: int,
                  offset: int = 0) -> torch.Tensor:
    """[..., n_lanes] uniforms from one key: lane i uses counter offset+i."""
    lanes = (torch.arange(n_lanes, dtype=torch.int64, device=key.device)
             + offset) & _M32
    x0, _ = threefry2x32(key[..., 0:1], key[..., 1:2], lanes, _DOM_LANE)
    return _to_unit(x0)


def fault_stream_uniform(seed: int, stream: int, n: int,
                         device) -> torch.Tensor:
    """f32[n] uniforms from the named fault-schedule stream, derived from
    (root seed, stream index, element index) only."""
    base = root_key(seed, device)
    k0, k1 = threefry2x32(base[0], base[1], stream & _M32, _DOM_FAULT)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    x0, _ = threefry2x32(k0, k1, idx, _DOM_FAULT)
    return _to_unit(x0)


def randint(key: torch.Tensor, minval: int, maxval: int,
            dtype=torch.int32) -> torch.Tensor:
    """Integer in [minval, maxval) by a modulo draw on the uint32 bits.
    An empty range returns minval."""
    span = max((maxval - minval) & _M32, 1)
    return (_bits(key, c1=_DOM_RINT) % span).to(dtype) + minval


def _f64(bits: str) -> float:
    return struct.unpack(">d", bytes.fromhex(bits))[0]


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """f32 fused multiply-add: the product of two f32 values is exact in
    f64, so one f64 add and one rounding to f32 reproduce the FMA on the
    inputs this module feeds it."""
    return (a.double() * b + c).float()


# XLA's f32 log1p (jax 0.9.0, CPU), read off its optimised LLVM IR. Every
# constant is an f32 value, written as the f64 bit pattern the IR uses.
_SMALL_X = _f64("3FDA8279A0000000")
_DEN = [_f64(h) for h in ("402E2035A0000000", "4054C30B60000000",
                          "406BB865A0000000", "4073519460000000",
                          "406B0DB140000000", "404E0F3040000000")]
_NUM0 = _f64("3F07BC0960000000")
_NUM = [_f64(h) for h in ("3FDFE818A0000000", "401A509F40000000",
                          "403DE97380000000", "404E798EC0000000",
                          "404C8E75A0000000", "40340A2020000000")]
_MIN_NORMAL = _f64("3810000000000000")
_SQRT_HALF = _f64("3FE6A09E60000000")
_PA = (_f64("3FB2043760000000"), _f64("BFBD7A3700000000"),
       _f64("3FBDE4A340000000"))
_PB = (_f64("BFBFCBA9E0000000"), _f64("3FC23D37E0000000"),
       _f64("BFC555CA00000000"))
_PC = (_f64("3FC999D580000000"), _f64("BFCFFFFF80000000"),
       _f64("3FD5555540000000"))
_LN2_LO = _f64("BF2BD01060000000")
_LN2_HI = _f64("3FE6300000000000")


def xla_log1p_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU `log1p` for f32, operation for operation.

    Held bit-identical to `jnp.log1p` (jax 0.9.0, CPU) on x in (-1, 0],
    the domain `exponential` feeds it: all 2^24 values -u for the
    24-bit uniforms u. Other inputs are not pinned.
    """
    # small |x|: x - x^2/2 + x^3 * P(x)/Q(x)
    den = torch.ones_like(x)
    for c in _DEN:
        den = _fma(den, x, c)
    num = torch.full_like(x, _NUM0)
    for c in _NUM:
        num = _fma(num, x, c)
    x2 = x * x
    small = x + _fma(x2, -0.5, (x * x2) * (num / den))

    # otherwise: split 1 + x into 2^e * m with m in [sqrt(1/2), sqrt(2))
    v = torch.clamp(x + 1.0, min=_MIN_NORMAL)
    bits = v.view(torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    below = m < _SQRT_HALF
    t = (m - 1.0) + torch.where(below, m, torch.zeros_like(m))
    e = e - below.to(torch.float32)
    z = t * t
    t3 = z * t
    a = _fma(_fma(t, _PA[0], _PA[1]), t, _PA[2])
    b = _fma(_fma(t, _PB[0], _PB[1]), t, _PB[2])
    c = _fma(_fma(t, _PC[0], _PC[1]), t, _PC[2])
    d = _fma(_fma(a, t3, b), t3, c)
    hpoly = _fma(d, t3, e * _LN2_LO)
    large = _fma(e, _LN2_HI, _fma(z, -0.5, t) + hpoly)
    return torch.where(x.abs() < _SMALL_X, small, large)


def exponential(key: torch.Tensor) -> torch.Tensor:
    """f32 unit-rate exponential: -log1p(-u) through XLA's own log1p."""
    return -xla_log1p_f32(-uniform(key))


def bernoulli(key: torch.Tensor, p) -> torch.Tensor:
    """Shares uniform's draw: bernoulli(key, p) and uniform(key) are the
    same sample viewed two ways."""
    return uniform(key) < torch.tensor(p, dtype=torch.float32,
                                       device=key.device)
