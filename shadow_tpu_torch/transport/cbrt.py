"""CUBIC's f32 cube root, bit for bit as XLA's CPU backend computes it.

`shadow_tpu.transport.tcp.CubicCC` takes `jnp.cbrt` of an f32. XLA's CPU
backend (jax 0.9.0) compiles that to

    cbrt(x) = copysign(powf(|x|, f32(1/3)), x)

with `powf` the host's glibc `powf@GLIBC_2.27`, run with the flush-to-
zero and denormals-are-zero bits of MXCSR set. On x86-64 with FMA,
glibc 2.36's ifunc picks the FMA build of its table-driven powf
(sysdeps/ieee754/flt-32/e_powf.c): log2(x) in double from a 16-entry
(1/c, log2 c) table and a degree-5 polynomial, a multiply by y, then
2^(y log2 x) from a 32-entry table and a cubic, rounded once to f32.
GCC contracts eight of its multiply-adds into FMAs; read from the
binary, they are the ones `_fma` marks below and no others.

This module holds that function twice:

- `cbrt_plain`, the plain PyTorch version: every FMA is emulated exactly
  in f64 (a Dekker two-product, then a three-term sum rounded once,
  through a round-to-odd addition); no fused torch op is used;
- `cbrt`, the wrapper of the CUDA kernel in `csrc/cbrt.cu`, which runs
  the same arithmetic with `__fma_rn` and unfused double operations.

`cbrt` runs the kernel for CUDA tensors and the plain version for CPU
tensors, with no fallback from one to the other. Inputs: any f32 tensor.
Subnormal inputs read as zero inside powf's scaling step (the DAZ bit),
which sends all of them to one result, 0x267fffef, as XLA's gives; zero,
inf and nan keep powf's special cases, and the sign is copied back.

Held bit for bit against glibc 2.36's powf (x86-64 with FMA) under
FTZ/DAZ on every f32 in [0, 2560] (CUBIC's reachable domain) by
tests/test_torch_cubic.py and chip_smoke.py phase 17.
"""

from __future__ import annotations

import ctypes
import struct

import torch

from shadow_tpu_torch.core import nvcc

# kernel launches so far: `cbrt` adds one per launch
launches = 0

SOURCE = nvcc.CSRC / "cbrt.cu"
# nvcc adds no contraction of its own: the kernel's FMAs are explicit
NVCC_FLAGS = nvcc.BASE_FLAGS + ("--fmad=false",)


def _f64(h: str) -> float:
    return float.fromhex(h)


# glibc 2.36 __powf_log2_data (powf_log2_data.c), read from libm.so.6:
# (1/c, log2 c) per table slot, and the log2 polynomial A[0..4]
LOG2_INVC = tuple(_f64(h) for h in (
    "0x1.661ec79f8f3bep+0", "0x1.571ed4aaf883dp+0", "0x1.49539f0f010b0p+0",
    "0x1.3c995b0b80385p+0", "0x1.30d190c8864a5p+0", "0x1.25e227b0b8ea0p+0",
    "0x1.1bb4a4a1a343fp+0", "0x1.12358f08ae5bap+0", "0x1.0953f419900a7p+0",
    "0x1.0000000000000p+0", "0x1.e608cfd9a47acp-1", "0x1.ca4b31f026aa0p-1",
    "0x1.b2036576afce6p-1", "0x1.9c2d163a1aa2dp-1", "0x1.886e6037841edp-1",
    "0x1.767dcf5534862p-1"))
LOG2_LOGC = tuple(_f64(h) for h in (
    "-0x1.efec65b963019p-2", "-0x1.b0b6832d4fca4p-2", "-0x1.7418b0a1fb77bp-2",
    "-0x1.39de91a6dcf7bp-2", "-0x1.01d9bf3f2b631p-2", "-0x1.97c1d1b3b7af0p-3",
    "-0x1.2f9e393af3c9fp-3", "-0x1.960cbbf788d5cp-4", "-0x1.a6f9db6475fcep-5",
    "0x0.0p+0", "0x1.338ca9f24f53dp-4", "0x1.476a9543891bap-3",
    "0x1.e840b4ac4e4d2p-3", "0x1.40645f0c6651cp-2", "0x1.88e9c2c1b9ff8p-2",
    "0x1.ce0a44eb17bccp-2"))
LOG2_POLY = tuple(_f64(h) for h in (
    "0x1.27616c9496e0bp-2", "-0x1.71969a075c67ap-2", "0x1.ec70a6ca7baddp-2",
    "-0x1.7154748bef6c8p-1", "0x1.71547652ab82bp+0"))
# glibc 2.36 __exp2f_data (exp2f_data.c): 2^(i/32) less i << 47 as bits,
# the rounding shift 0x1.8p52 / 32, and the exp2 polynomial C[0..2]
EXP2_TAB = (
    0x3FF0000000000000, 0x3FEFD9B0D3158574, 0x3FEFB5586CF9890F,
    0x3FEF9301D0125B51, 0x3FEF72B83C7D517B, 0x3FEF54873168B9AA,
    0x3FEF387A6E756238, 0x3FEF1E9DF51FDEE1, 0x3FEF06FE0A31B715,
    0x3FEEF1A7373AA9CB, 0x3FEEDEA64C123422, 0x3FEECE086061892D,
    0x3FEEBFDAD5362A27, 0x3FEEB42B569D4F82, 0x3FEEAB07DD485429,
    0x3FEEA47EB03A5585, 0x3FEEA09E667F3BCD, 0x3FEE9F75E8EC5F74,
    0x3FEEA11473EB0187, 0x3FEEA589994CCE13, 0x3FEEACE5422AA0DB,
    0x3FEEB737B0CDC5E5, 0x3FEEC49182A3F090, 0x3FEED503B23E255D,
    0x3FEEE89F995AD3AD, 0x3FEEFF76F2FB5E47, 0x3FEF199BDD85529C,
    0x3FEF3720DCEF9069, 0x3FEF5818DCFBA487, 0x3FEF7C97337B9B5F,
    0x3FEFA4AFA2A490DA, 0x3FEFD0765B6E4540)
EXP2_SHIFT = _f64("0x1.8p+47")
EXP2_POLY = tuple(_f64(h) for h in (
    "0x1.c6af84b912394p-5", "0x1.ebfce50fac4f3p-3", "0x1.62e42ff0c52d6p-1"))
# y: the f32 nearest 1/3, widened to double as powf widens it
THIRD = struct.unpack("<f", struct.pack("<f", 1.0 / 3.0))[0]
# powf's table offset (OFF): log2's argument is reduced around it
LOG2_OFF = 0x3F330000
# a subnormal x: powf scales it by 2^23 and, with DAZ, reads 0 there,
# so its integer image is 0 - (23 << 23) modulo 2^32
DAZ_IX = (0 - (23 << 23)) & 0xFFFFFFFF

_SPLIT = 134217729.0  # 2^27 + 1, Veltkamp's splitter for doubles


def _split(a):
    c = _SPLIT * a
    hi = c - (c - a)
    return hi, a - hi


def _two_prod(a, b):
    """a*b = p + e exactly (Dekker), for tensors or Python floats."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _two_sum(a, b):
    """a+b = s + e exactly (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _add_odd(a, b):
    """a+b rounded to odd: the nearest double toward zero or away from
    it whose last significand bit is 1, unless a+b is exact."""
    s, e = _two_sum(a, b)
    bits = s.view(torch.int64)
    step = torch.where((e > 0) == (s > 0), 1, -1)
    bits = torch.where((e != 0) & ((bits & 1) == 0), bits + step, bits)
    return bits.view(torch.float64)


def _fma(a, b, c):
    """fma(a, b, c) in f64, rounded once (Boldo and Melquiond's emulation:
    an exact product, an exact sum with c, the low parts added rounded
    to odd, one final rounding). Valid without overflow or underflow,
    which powf's operands never reach."""
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, uh)
    return th + _add_odd(tl, ul)


def fma_f32(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """f32 fma(a, b, c), rounded once: the product of two f32 values is
    exact in f64, the sum with c is rounded to odd in f64 (53 >= 24 + 2
    bits), so the one rounding to f32 is the correct one. XLA's CPU
    backend fuses CUBIC's f32 multiply-adds into `vfmadd` at instruction
    selection (the IR shows separate fmul and fadd)."""
    return _add_odd(a.double() * b, c.double()).float()


def _to_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 holding a u32 bit pattern -> the int32 of the same bits."""
    return (v - ((v >> 31) << 32)).to(torch.int32)


def powf_third_bits(ix: torch.Tensor) -> torch.Tensor:
    """glibc's powf(x, f32(1/3)) for the integer image ix (int64 holding
    u32 bits) of a positive normal x, or DAZ_IX: the f32 result's bits
    as int64."""
    dev = ix.device
    f64 = torch.float64
    tmp = (ix - LOG2_OFF) & 0xFFFFFFFF
    i = (tmp >> 19) & 15
    top = tmp & 0xFF800000
    iz = (ix - top) & 0xFFFFFFFF
    k = torch.where(top >= 1 << 31, top - (1 << 32), top) >> 23
    invc = torch.tensor(LOG2_INVC, dtype=f64, device=dev)[i]
    logc = torch.tensor(LOG2_LOGC, dtype=f64, device=dev)[i]
    z = _to_i32(iz).view(torch.float32).to(f64)
    # log2_inline: log1p(z/c - 1)/ln2 + log2 c + k
    a0, a1, a2, a3, a4 = LOG2_POLY
    r = _fma(z, invc, -1.0)
    y0 = logc + k.to(f64)
    r2 = r * r
    y = _fma(r, a0, a1)
    p = _fma(r, a2, a3)
    r4 = r2 * r2
    q = _fma(r, a4, y0)
    q = _fma(p, r2, q)
    y = _fma(y, r4, q)
    ylogx = y * THIRD
    # exp2_inline: 2^(k/32) * 2^r, k/32 the nearest multiple of 1/32
    kd = ylogx + EXP2_SHIFT
    ki = kd.view(torch.int64)
    kd = kd - EXP2_SHIFT
    r = ylogx - kd
    tab = torch.tensor(EXP2_TAB, dtype=torch.int64, device=dev)
    s = (tab[ki & 31] + ((ki & 0x1FFFF) << 47)).view(f64)
    c0, c1, c2 = EXP2_POLY
    zz = _fma(r, c0, c1)
    r2 = r * r
    yy = _fma(r, c2, 1.0)
    yy = _fma(zz, r2, yy)
    yy = yy * s
    return yy.to(torch.float32).view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def cbrt_plain(x: torch.Tensor) -> torch.Tensor:
    """copysign(powf(|x|, f32(1/3)), x) under FTZ/DAZ, elementwise over an
    f32 tensor, in plain PyTorch ops."""
    if x.dtype != torch.float32:
        raise TypeError(f"cbrt takes float32, got {x.dtype}")
    bits = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    sign = bits & 0x80000000
    ix = bits & 0x7FFFFFFF
    special = ix >= 0x7F800000  # inf, nan: powf returns |x| * |x|
    normal = (ix >= 0x00800000) & ~special
    sub = (ix > 0) & (ix < 0x00800000)
    # zero and specials take a normal stand-in, masked out below
    arg = torch.where(normal, ix, torch.where(sub, DAZ_IX, 0x3F800000))
    out = powf_third_bits(arg)
    nan_q = torch.where(ix > 0x7F800000, ix | 0x00400000, ix)
    out = torch.where(special, nan_q, torch.where(ix == 0, 0, out))
    return _to_i32(out | sign).view(torch.float32)


_lib: ctypes.CDLL | None = None


def build():
    """Compile `csrc/cbrt.cu` for sm_90a (with --fmad=false) unless a
    library built from the same source and flags exists. Returns (path,
    compiler output)."""
    return nvcc.build(SOURCE, "shadow_cbrt", NVCC_FLAGS)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        lib.shadow_cbrt_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
        lib.shadow_cbrt_launch.restype = ctypes.c_int
        lib.shadow_cbrt_error_string.argtypes = [ctypes.c_int]
        lib.shadow_cbrt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def cbrt(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU `jnp.cbrt` on an f32 tensor: the kernel of `csrc/cbrt.cu`
    for a CUDA tensor (one launch, counted in `launches`), `cbrt_plain`
    for a CPU tensor."""
    if x.device.type == "cpu":
        return cbrt_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"cbrt runs on cuda or cpu, not {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"cbrt takes float32, got {x.dtype}")
    src = x.contiguous()
    out = torch.empty_like(src)
    lib = _load()
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.shadow_cbrt_launch(src.data_ptr(), out.data_ptr(),
                                    src.numel(), stream)
    if rc != 0:
        msg = lib.shadow_cbrt_error_string(rc).decode()
        raise RuntimeError(f"cbrt kernel launch failed: {msg} ({rc})")
    global launches
    launches += 1
    return out
