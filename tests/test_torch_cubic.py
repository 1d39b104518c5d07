"""CUBIC in shadow_tpu_torch against shadow_tpu (F2), bit for bit.

- the cube root (`transport/cbrt.py`): XLA's CPU `jnp.cbrt` is glibc
  2.36's `powf(|x|, f32(1/3))` under FTZ/DAZ, which the port replays
  with its tables and its eight FMAs; held against the host's own
  powf through ctypes on a stride of CUBIC's domain [0, 2560] and on
  every input around each power of two, and against `jnp.cbrt` on edge
  inputs (negatives, subnormals, inf, nan); the slow test runs every f32
  in [0, 2560] through a C loop over glibc's powf (built with gcc) and
  the port, and recomputes the sha256 pin chip_smoke.py phase 17 holds
  the card to;
- the emulated f64 FMA against libm's `fma`, on triples with the
  product cancelling c;
- `CubicCC.on_ack`, `on_loss` and `on_timeout` against the reference's
  hooks on random rows;
- the cubic cells of tests/test_tcp_matrix.py (loopback, lossless,
  lossy), and the autotune scenario it runs with cubic;
- TGen at 32 pairs under chip_smoke.TGEN_FAULTS with CUBIC, through both
  packages' `build_simulation(tcp_cc="cubic")`;
- slow: chip_smoke.py's phase 17(c) pin (TGen 4096 under faults with
  CUBIC).

Every comparison is exact, dtypes included. The tests that hold the
replay against the machine's powf need glibc 2.36 on x86-64 with FMA and
AVX2, where its ifunc picks the build the port replays
(REFERENCE_GLIBC_236); elsewhere the reference would compute other bits.
"""

import ctypes
import hashlib
import os
import platform
import subprocess
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import test_tcp_matrix as jmatrix
from shadow_tpu import config as jconfig
from shadow_tpu import sim as jsim
from shadow_tpu.transport import tcp as jtcp
from shadow_tpu_torch import config as tconfig
from shadow_tpu_torch import convert
from shadow_tpu_torch import sim as tsim
from shadow_tpu_torch.transport import cbrt as tcbrt
from shadow_tpu_torch.transport import tcp as ttcp
from test_torch_phold import assert_leaves_equal, jax_leaves
from test_torch_tcp import one_torch_thread  # noqa: F401 (autouse)
from test_torch_tcp_matrix import run_both
from torch_tcp_harness import SECOND


def _glibc_236_fma() -> bool:
    if platform.machine() != "x86_64":
        return False
    try:
        if os.confstr("CS_GNU_LIBC_VERSION") != "glibc 2.36":
            return False
        flags = open("/proc/cpuinfo").read().split()
    except (OSError, ValueError):
        return False
    return "fma" in flags and "avx2" in flags


# F2: the replay is of glibc 2.36's FMA powf, the build its x86-64 ifunc
# picks on a CPU with FMA and AVX2
REFERENCE_GLIBC_236 = pytest.mark.skipif(
    not _glibc_236_fma(),
    reason="CUBIC's cube root is pinned to glibc 2.36's powf on x86-64 "
           "with FMA (F2); the host's libm computes other bits")

DOMAIN_END = 0x45200000  # f32 bits of 2560.0, CUBIC's largest input

_C_LOOP = r"""
#include <math.h>
#include <stdint.h>
#include <string.h>
#include <xmmintrin.h>
/* copysign(powf(|x|, 1/3f), x) for the f32 bit patterns start..start+n-1,
   with FTZ and DAZ set, as XLA's CPU runtime runs its code */
void cbrt_bits(uint32_t start, uint64_t n, uint32_t *out) {
  unsigned int csr = _mm_getcsr();
  volatile float third = 1.0f / 3.0f;
  _mm_setcsr(csr | 0x8040);
  for (uint64_t i = 0; i < n; i++) {
    uint32_t b = start + (uint32_t)i;
    float x, r;
    memcpy(&x, &b, 4);
    r = copysignf(powf(fabsf(x), third), x);
    memcpy(out + i, &r, 4);
  }
  _mm_setcsr(csr);
}
"""


@pytest.fixture(scope="module")
def glibc_loop(tmp_path_factory):
    """cbrt_bits(start, n, out) of a gcc-built C loop over glibc's powf."""
    d = tmp_path_factory.mktemp("glibc_cbrt")
    (d / "loop.c").write_text(_C_LOOP)
    subprocess.run(["gcc", "-O2", "-shared", "-fPIC", "-fno-builtin",
                    "-o", str(d / "loop.so"), str(d / "loop.c"), "-lm"],
                   check=True)
    lib = ctypes.CDLL(str(d / "loop.so"))
    lib.cbrt_bits.argtypes = [ctypes.c_uint32, ctypes.c_uint64,
                              ctypes.c_void_p]

    def run(start: int, n: int) -> np.ndarray:
        out = np.empty(n, np.uint32)
        lib.cbrt_bits(start, n, out.ctypes.data)
        return out

    return run


def port_bits(bits: np.ndarray) -> np.ndarray:
    x = torch.from_numpy(bits.astype(np.uint32).view(np.float32).copy())
    return tcbrt.cbrt(x).numpy().view(np.uint32)


def libm():
    lib = ctypes.CDLL("libm.so.6")
    lib.powf.restype = ctypes.c_float
    lib.powf.argtypes = [ctypes.c_float, ctypes.c_float]
    lib.fma.restype = ctypes.c_double
    lib.fma.argtypes = [ctypes.c_double] * 3
    return lib


# -- the replay ----------------------------------------------------------------
def test_fma_emulation_matches_libm():
    rng = np.random.default_rng(7)
    n = 4000
    a = rng.standard_normal(n) * 2.0 ** rng.integers(-30, 30, n)
    b = rng.standard_normal(n) * 2.0 ** rng.integers(-30, 30, n)
    near = -(a * b) * (1 + rng.standard_normal(n) * 2.0 ** -50)
    far = rng.standard_normal(n) * 2.0 ** rng.integers(-60, 60, n)
    c = np.where(rng.random(n) < 0.5, near, far)
    got = tcbrt._fma(torch.tensor(a), torch.tensor(b), torch.tensor(c))
    lib = libm()
    want = np.array([lib.fma(*t) for t in zip(a, b, c)])
    np.testing.assert_array_equal(got.numpy().view(np.int64),
                                  want.view(np.int64))
    # the f32 fma CUBIC's hooks take
    a32, b32, c32 = (v.astype(np.float32) for v in (a, b, near))
    got32 = tcbrt.fma_f32(torch.tensor(a32), float(b32[0]),
                          torch.tensor(c32))
    want32 = np.array([lib.fma(float(x), float(b32[0]), float(z))
                       for x, z in zip(a32, c32)]).astype(np.float32)
    np.testing.assert_array_equal(got32.numpy(), want32)


@REFERENCE_GLIBC_236
def test_replay_matches_powf_on_a_stride():
    """Every 997th normal f32 of [0, 2560] and every input within 64 ulps
    of each power of two there (the table index and the exponent turn
    over), against ctypes powf (no DAZ is needed for normal inputs)."""
    normal = np.arange(0x00800000, DOMAIN_END + 1, 997, dtype=np.int64)
    pow2 = np.arange(-126, 12)
    edges = (((pow2 + 127) << 23)[:, None]
             + np.arange(-64, 65)[None, :]).ravel()
    edges = edges[(edges >= 0x00800000) & (edges <= DOMAIN_END)]
    bits = np.concatenate([normal, edges])
    lib = libm()
    third = np.float32(1 / 3)
    want = np.array([lib.powf(float(v), third) for v in
                     bits.astype(np.uint32).view(np.float32)], np.float32)
    np.testing.assert_array_equal(port_bits(bits), want.view(np.uint32))


def test_replay_matches_jnp_cbrt_on_edges():
    """Outside the domain and at its corners: zero, negatives, every
    subnormal kind (DAZ sends them to one result), inf and nan (quieted,
    payload and sign kept), the largest finite f32 and random negatives,
    against the reference's compiled cbrt."""
    rng = np.random.default_rng(3)
    corners = [0, 1, 2, 0x3FFFFF, 0x400000, 0x7FFFFF, 0x800000, 0x3F800000,
               DOMAIN_END, DOMAIN_END + 1, 0x7F7FFFFF, 0x7F800000,
               0x7F800001, 0x7FC00000, 0x7FFFFFFF]
    pos = np.array(corners + rng.integers(0, 0x7F800000, 2000).tolist(),
                   np.int64)
    bits = np.concatenate([pos, pos | 0x80000000]).astype(np.uint32)
    want = np.asarray(jax.jit(jnp.cbrt)(bits.view(np.float32)))
    np.testing.assert_array_equal(port_bits(bits), want.view(np.uint32))
    assert port_bits(np.array([5], np.uint32))[0] == 0x267FFFEF


@REFERENCE_GLIBC_236
def test_replay_matches_glibc_loop_on_chunks(glibc_loop):
    """Four chunks of 2^16 consecutive inputs through the C loop (FTZ and
    DAZ set): the subnormals, around 1.0, around 2560 and a random one."""
    rng = np.random.default_rng(11)
    for start in (0, 0x3F800000 - (1 << 15), DOMAIN_END - (1 << 16) + 1,
                  int(rng.integers(0x00800000, DOMAIN_END - (1 << 16)))):
        n = 1 << 16
        bits = np.arange(start, start + n, dtype=np.int64)
        np.testing.assert_array_equal(port_bits(bits), glibc_loop(start, n))


def cbrt_domain_sha256(fn, chunk: int = 1 << 23) -> str:
    """sha256 over fn(start, n)'s u32 outputs for every f32 bit pattern in
    [0, DOMAIN_END], in order (1,159,725,057 values)."""
    h = hashlib.sha256()
    start = 0
    while start <= DOMAIN_END:
        n = min(chunk, DOMAIN_END + 1 - start)
        h.update(fn(start, n).tobytes())
        start += n
    return h.hexdigest()


@pytest.mark.slow
@REFERENCE_GLIBC_236
def test_replay_exhaustive_on_the_domain_and_pin(glibc_loop):
    """Every f32 in [0, 2560]: the port's plain version equals glibc's
    powf under DAZ, and both hash to chip_smoke.PIN_CBRT_SHA256."""
    torch.set_num_threads(8)

    def both(start, n):
        want = glibc_loop(start, n)
        got = port_bits(np.arange(start, start + n, dtype=np.int64))
        np.testing.assert_array_equal(got, want, err_msg=hex(start))
        return want

    assert cbrt_domain_sha256(both) == chip_smoke.PIN_CBRT_SHA256


# -- the hooks -----------------------------------------------------------------
def cubic_rows(n: int, seed: int) -> dict:
    """Random TCB rows: slow start and congestion avoidance, fresh and
    running epochs, W_max above and below cwnd, srtt unset and set."""
    rng = np.random.default_rng(seed)
    cwnd = rng.uniform(1, ttcp.CWND_MAX, n).astype(np.float32)
    cwnd[::7] = np.round(cwnd[::7])
    now = rng.integers(1, 20 * SECOND, n)
    epoch = np.where(rng.random(n) < 0.3, 0,
                     np.maximum(now - rng.integers(0, 5 * SECOND, n), 0))
    return dict(
        cwnd=cwnd,
        ssthresh=np.where(rng.random(n) < 0.3, np.float32(1 << 30),
                          rng.uniform(2, 1024, n)).astype(np.float32),
        cc_wmax=np.where(rng.random(n) < 0.2, 0,
                         rng.uniform(1, 1024, n)).astype(np.float32),
        cc_epoch=epoch.astype(np.int64),
        srtt=np.where(rng.random(n) < 0.1, 0,
                      rng.integers(0, SECOND // 2, n)).astype(np.int64),
        now=now.astype(np.int64),
        n_acked=rng.integers(0, 40, n).astype(np.int32),
        flight=rng.uniform(0, 1024, n).astype(np.float32))


@pytest.mark.parametrize("hook", ["on_ack", "on_loss", "on_timeout"])
def test_cubic_hooks_match_reference(hook):
    rows = cubic_rows(50_000, seed=3)
    fields = ("cwnd", "ssthresh", "cc_wmax", "cc_epoch", "srtt")
    arg = "n_acked" if hook == "on_ack" else "flight"

    def ref(d, a, now):
        return getattr(jtcp.CubicCC, hook)(types.SimpleNamespace(**d), a,
                                           now)

    want = jax.jit(ref)({k: rows[k] for k in fields}, rows[arg], rows["now"])
    row = types.SimpleNamespace(**{k: torch.from_numpy(rows[k])
                                   for k in fields})
    got = getattr(ttcp.CubicCC, hook)(row, torch.from_numpy(rows[arg]),
                                      torch.from_numpy(rows["now"]))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)


# -- whole runs (`run_both`: the lossless and lossy cells share one compiled
# reference program) ----------------------------------------------------------

@pytest.mark.parametrize("path", list(jmatrix.PATHS))
def test_cubic_matrix_cell_matches_reference(path):
    lj = run_both(60, total=60_000, cc="cubic", seed=3,
                  **jmatrix.PATHS[path])
    assert lj["hosts.app.rx"].sum() == 60_000
    retx = lj["hosts.net.tcb.n_retx"].sum()
    if path == "lossy":
        # loss reached the controller: W_max captured
        assert retx > 0 and lj["hosts.net.tcb.cc_wmax"].max() > 0
    else:
        assert retx == 0


def test_cubic_autotune_matches_reference():
    """tests/test_tcp_matrix.py's high-BDP autotune scenario, which it
    runs with cubic, half a second in."""
    lj = run_both(0.5, total=600_000, bw=8192.0, latency=50_000_000,
                  seed=9, cc="cubic")
    assert lj["hosts.net.tcb.rwnd"].max() > ttcp.RCV_WND


TGEN_KW = dict(seed=chip_smoke.TGEN_SEED, n_sockets=chip_smoke.TGEN_SOCKETS,
               capacity=chip_smoke.TGEN_CAPACITY, tcp_cc="cubic")


def test_tgen_faults_cubic_at_32_pairs_matches_reference():
    """Phase 17(c)'s config at 32 pairs to 6 s: by then the faults (from
    4 s) have put CUBIC into congestion avoidance with a loss epoch, so
    the cube root runs on nonzero inputs."""
    text = chip_smoke.tgen_faults_config(32)
    stop = 6 * chip_smoke.SECOND
    js = jsim.build_simulation(jconfig.parse_config(text), **TGEN_KW)
    lj = jax_leaves(js.run(stop))
    ts = tsim.build_simulation(tconfig.parse_config(text), device="cpu",
                               **TGEN_KW)
    assert ts.stack.tcp.cc is ttcp.CubicCC
    lt = convert.engine_state_to_numpy(ts.run(stop))
    assert_leaves_equal(lj, lt)
    assert lt["hosts.net.tcb.n_retx"].sum() > 0
    assert (lt["hosts.net.tcb.cc_wmax"] > lt["hosts.net.tcb.cwnd"]).any()


# -- the slow pin: chip_smoke.py's phase 17(c) ------------------------------------
@pytest.mark.slow
def test_tgen_faults_cubic_bench_shape_parity_and_pin():
    torch.set_num_threads(4)
    text = chip_smoke.tgen_faults_config(chip_smoke.TGEN_PAIRS)
    js = jsim.build_simulation(jconfig.parse_config(text), **TGEN_KW)
    ts = tsim.build_simulation(tconfig.parse_config(text), device="cpu",
                               **TGEN_KW)
    ts.strict_overflow = js.strict_overflow = False
    stop = chip_smoke.FAULTS_STOP_S * chip_smoke.SECOND
    lj = jax_leaves(js.run(stop))
    lt = convert.engine_state_to_numpy(ts.run(stop))
    assert_leaves_equal(lj, lt)
    assert chip_smoke.tgen_faults_pin(lj) == chip_smoke.PIN_TGEN_CUBIC
