"""Fused queue merge: densify + rotate + merge-path in one kernel.

`events.queue_push` groups incoming events by destination with a flat
sort, then merges each row's sorted incoming run into its sorted
resident prefix. This module holds that merge twice:

- `merge_body`, the plain PyTorch version, op for op the arithmetic of
  `shadow_tpu.core.merge_pallas.merge_body`;
- `fused_merge`, the wrapper of the CUDA kernel in `csrc/merge.cu`
  (the port of the Pallas kernel `merge_pallas.py:125`), which computes
  the same function in one pass per row.

`fused_merge` runs the kernel for CUDA tensors and the plain version
for CPU tensors, and nothing else: there is no fallback from one to the
other. The kernel library is built with `nvcc` at first use, into
`build/shadow_tpu_torch/` beside the package, keyed by a hash of the
source and flags, and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from shadow_tpu_torch.core.timebase import TIME_INVALID

_I64MAX = (1 << 63) - 1

# kernel launches so far: `fused_merge` adds one per launch, callers
# read or reset it as `merge.launches`
launches = 0

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "merge.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "shadow_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# dynamic shared memory a Hopper block may use
_SMEM_LIMIT = 232_448


def merge_body(qt, qss, qpay, st, sss, bpay, starts, cnt):
    """The densify + rotate + merge arithmetic. Shapes: qt/qss i64[H, hc],
    qpay i64[H, hc, nw], st/sss i64[m] flat grouped keys, bpay
    i64[H, w, nw], starts/cnt i32[H] with starts >= 0. Returns
    (mt, mss, mpay) of width hc + w."""
    h, hc = qt.shape
    w = bpay.shape[1]
    m = st.shape[0]
    nw = qpay.shape[-1]
    dev = qt.device
    i32 = torch.int32

    # densify: group g's admitted events sit at flat positions
    # starts[g] .. starts[g]+cnt[g]-1; masked lanes become fillers
    lane = torch.arange(w, dtype=i32, device=dev)
    gidx = starts[:, None] + lane[None, :]
    okl = lane[None, :] < cnt[:, None]
    gsafe = torch.clamp(gidx, max=m - 1).long()
    bt = torch.where(okl, st[gsafe], _I64MAX)
    bss = torch.where(okl, sss[gsafe], _I64MAX)

    # rotate the cleared-empty prefix (k leading TIME_INVALIDs) to the tail
    inv = qt == TIME_INVALID
    k = torch.sum(torch.cumprod(inv.to(i32), dim=1), dim=1, dtype=i32)
    ridx = torch.arange(hc, dtype=i32, device=dev)[None, :] + k[:, None]
    rin = ridx < hc
    rsafe = torch.clamp(ridx, max=hc - 1).long()
    at = torch.where(rin, torch.gather(qt, 1, rsafe), _I64MAX)
    ass = torch.where(rin, torch.gather(qss, 1, rsafe), 0)
    apay = torch.where(
        rin[:, :, None],
        torch.gather(qpay, 1, rsafe[:, :, None].expand(h, hc, nw)),
        0,
    )

    # stable merge-path: ties place the resident (A) first
    a3, b3 = at[:, :, None], bt[:, None, :]
    le = (a3 < b3) | ((a3 == b3) & (ass[:, :, None] <= bss[:, None, :]))
    pos_b = lane[None, :] + torch.sum(le, dim=1, dtype=i32)  # [H, w]
    ncol = hc + w
    p = torch.arange(ncol, dtype=i32, device=dev)[None, :]
    jb = torch.sum(pos_b[:, None, :] <= p[:, :, None], dim=2, dtype=i32)
    ib = torch.clamp(jb - 1, 0, w - 1).long()
    isb = (jb > 0) & (torch.gather(pos_b, 1, ib) == p)
    ia = torch.clamp(p - jb, 0, hc - 1).long()
    mt = torch.where(isb, torch.gather(bt, 1, ib), torch.gather(at, 1, ia))
    mss = torch.where(isb, torch.gather(bss, 1, ib),
                      torch.gather(ass, 1, ia))
    mpay = torch.where(
        isb[:, :, None],
        torch.gather(bpay, 1, ib[:, :, None].expand(h, ncol, nw)),
        torch.gather(apay, 1, ia[:, :, None].expand(h, ncol, nw)),
    )
    return mt, mss, mpay


def _library_path() -> Path:
    tag = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"libshadow_merge_{tag}.so"


def build() -> tuple[Path, str]:
    """Compile `csrc/merge.cu` for sm_90a unless a library built from
    the same source and flags exists. Returns (path, compiler output)."""
    out = _library_path()
    if out.exists():
        return out, ""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stderr


_lib: ctypes.CDLL | None = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        ptr, i = ctypes.c_void_p, ctypes.c_int
        lib.shadow_merge_launch.argtypes = [ptr] * 11 + [i] * 5 + [ptr]
        lib.shadow_merge_launch.restype = i
        lib.shadow_merge_smem_bytes.argtypes = [i, i]
        lib.shadow_merge_smem_bytes.restype = ctypes.c_size_t
        lib.shadow_merge_error_string.argtypes = [i]
        lib.shadow_merge_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(qt, qss, qpay, st, sss, bpay, starts, cnt):
    h, hc = qt.shape
    w, nw = bpay.shape[1], qpay.shape[-1]
    m = st.shape[0]
    want = {
        "qt": (qt, torch.int64, (h, hc)),
        "qss": (qss, torch.int64, (h, hc)),
        "qpay": (qpay, torch.int64, (h, hc, nw)),
        "st": (st, torch.int64, (m,)),
        "sss": (sss, torch.int64, (m,)),
        "bpay": (bpay, torch.int64, (h, w, nw)),
        "starts": (starts, torch.int32, (h,)),
        "cnt": (cnt, torch.int32, (h,)),
    }
    for name, (t, dtype, shape) in want.items():
        if t.device != qt.device:
            raise ValueError(f"{name} is on {t.device}, qt on {qt.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if m < 1 or hc < 1 or w < 1 or nw < 1:
        raise ValueError(f"empty merge operand: m={m} hc={hc} w={w} nw={nw}")


def fused_merge(qt, qss, qpay, st, sss, bpay, starts, cnt):
    """One densify + rotate + merge pass over the hot columns.

    Returns (mt, mss, mpay) merged rows of width hc + w, equal to
    `merge_body` on the same inputs. CUDA tensors launch the kernel of
    `csrc/merge.cu` (and count the launch in `launches`);
    CPU tensors run `merge_body`.
    """
    if qt.device.type == "cpu":
        return merge_body(qt, qss, qpay, st, sss, bpay, starts, cnt)
    if qt.device.type != "cuda":
        raise ValueError(f"fused_merge runs on cuda or cpu, not {qt.device}")
    _check(qt, qss, qpay, st, sss, bpay, starts, cnt)
    h, hc = qt.shape
    w, nw = bpay.shape[1], qpay.shape[-1]
    lib = _load()
    if lib.shadow_merge_smem_bytes(hc, w) > _SMEM_LIMIT:
        raise ValueError(f"rows of hc={hc}, w={w} exceed a block's shared "
                         "memory")
    ncol = hc + w
    ot = torch.empty((h, ncol), dtype=torch.int64, device=qt.device)
    oss = torch.empty_like(ot)
    opay = torch.empty((h, ncol, nw), dtype=torch.int64, device=qt.device)
    with torch.cuda.device(qt.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.shadow_merge_launch(
            qt.data_ptr(), qss.data_ptr(), qpay.data_ptr(), st.data_ptr(),
            sss.data_ptr(), bpay.data_ptr(), starts.data_ptr(),
            cnt.data_ptr(), ot.data_ptr(), oss.data_ptr(), opay.data_ptr(),
            h, hc, w, st.shape[0], nw, stream,
        )
    if rc != 0:
        msg = lib.shadow_merge_error_string(rc).decode()
        raise RuntimeError(f"merge kernel launch failed: {msg} ({rc})")
    global launches
    launches += 1
    return ot, oss, opay
