"""shadow_tpu_torch.core.rng against shadow_tpu.core.rng, bit for bit.

Inputs come from numpy seeds and go through both packages on the CPU;
every comparison is exact. The exponential is also checked over all 2^24
uniforms it can receive, against `-jnp.log1p(-u)`.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_tpu.core import rng as jrng
from shadow_tpu_torch.core import rng as trng


def _u32(rng, *shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64)


def _jkey(k):
    return jnp.asarray(k.astype(np.uint32))


def _tkey(k):
    return torch.from_numpy(k.astype(np.int64))


def _same(jx, tx):
    a = np.asarray(jax.device_get(jx))
    b = tx.numpy()
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    assert a.shape == b.shape
    assert a.dtype == b.dtype or a.dtype.kind == b.dtype.kind == "i"
    np.testing.assert_array_equal(a, b)
    if a.dtype.kind == "f":
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def test_threefry2x32_both_words():
    rng = np.random.default_rng(1)
    k0, k1, c0, c1 = (_u32(rng, 4096) for _ in range(4))
    j = jrng.threefry2x32(*(jnp.asarray(x.astype(np.uint32))
                            for x in (k0, k1, c0, c1)))
    t = trng.threefry2x32(*(torch.from_numpy(x.astype(np.int64))
                            for x in (k0, k1, c0, c1)))
    _same(j[0], t[0])
    _same(j[1], t[1])


@pytest.mark.parametrize("seed", [0, 1, 1234, 2**32 + 7, 2**40 + 3])
def test_root_key(seed):
    _same(jrng.root_key(seed), trng.root_key(seed, "cpu"))


def test_event_keys():
    rng = np.random.default_rng(2)
    base = _u32(rng, 2)
    gids = rng.integers(0, 1 << 20, size=500).astype(np.int32)
    cnt = rng.integers(-(1 << 31), (1 << 31) - 1, size=500).astype(np.int32)
    jh, jr = jrng.event_keys(_jkey(base), jnp.asarray(gids), jnp.asarray(cnt))
    th, tr = trng.event_keys(_tkey(base), torch.from_numpy(gids),
                             torch.from_numpy(cnt))
    _same(jh, th)
    _same(jr, tr)


def test_fold_in_and_split():
    rng = np.random.default_rng(3)
    keys = _u32(rng, 300, 2)
    data = rng.integers(-(1 << 31), (1 << 31) - 1, size=300).astype(np.int32)
    _same(jrng.fold_in(_jkey(keys), jnp.asarray(data)),
          trng.fold_in(_tkey(keys), torch.from_numpy(data)))
    _same(jrng.fold_in(_jkey(keys), 1), trng.fold_in(_tkey(keys), 1))
    for j, t in zip(jrng.split(_jkey(keys), 3), trng.split(_tkey(keys), 3)):
        _same(j, t)


def test_uniform_bernoulli_exponential():
    rng = np.random.default_rng(4)
    keys = _u32(rng, 2000, 2)
    jk, tk = _jkey(keys), _tkey(keys)
    _same(jrng.uniform(jk), trng.uniform(tk))
    _same(jrng.exponential(jk), trng.exponential(tk))
    for p in (0.0, 0.3, 0.9, 1.0):
        _same(jrng.bernoulli(jk, p), trng.bernoulli(tk, p))


@pytest.mark.parametrize("n_lanes,offset", [(1, 0), (3, 0), (5, 7),
                                            (4, 2**32 - 2)])
def test_uniform_lanes(n_lanes, offset):
    rng = np.random.default_rng(5)
    keys = _u32(rng, 64, 2)
    _same(jrng.uniform_lanes(_jkey(keys), n_lanes, offset),
          trng.uniform_lanes(_tkey(keys), n_lanes, offset))


@pytest.mark.parametrize("lo,hi", [(0, 4096), (0, 16384), (3, 10), (5, 5),
                                   (-7, 100), (0, 3_000_000_000)])
def test_randint(lo, hi):
    rng = np.random.default_rng(6)
    keys = _u32(rng, 1000, 2)
    _same(jrng.randint(_jkey(keys), lo, hi),
          trng.randint(_tkey(keys), lo, hi))


def test_fault_stream_uniform():
    for seed, stream in ((0, 0), (7, 3), (2**33 + 1, 2**32 + 5)):
        _same(jrng.fault_stream_uniform(seed, stream, 257),
              trng.fault_stream_uniform(seed, stream, 257, "cpu"))


def test_exponential_all_uniforms():
    """Every f32 uniform the generator can produce, u = i / 2^24: the
    port's -log1p(-u) equals XLA's bit for bit (torch.log1p does not, on
    1,224,113 of them)."""
    u = np.arange(1 << 24, dtype=np.int64).astype(np.float32) * np.float32(
        1.0 / (1 << 24))
    ref = hashlib.sha256()
    got = hashlib.sha256()
    for part in np.split(u, 8):
        j = np.asarray(-jnp.log1p(-jnp.asarray(part)))
        t = (-trng.xla_log1p_f32(-torch.from_numpy(part))).numpy()
        np.testing.assert_array_equal(j.view(np.int32), t.view(np.int32))
        ref.update(j.tobytes())
        got.update(t.tobytes())
    assert got.hexdigest() == ref.hexdigest()
    assert ref.hexdigest().startswith("bf7c3c6d0fc77583")
