"""Checkpoint/resume of simulation state: the counterpart of
`shadow_tpu.utils.checkpoint`, reading and writing the same files.

A checkpoint is the whole EngineState written to one .npz: the leaves
by index (`leaf_<i>`) in the reference's pytree flatten order, under
the reference's `keystr` paths (`convert.state_tensors`, `convert.keystr`),
uint64 leaves as uint64, plus a JSON header (`__header__`) recording
the leaf paths, shapes, dtypes and CRC32s, a free-form user dict (config
digest, sim time, seed), the writer's mesh (`n_shards: 1` here) and
whether the cross-shard exchange buffer was empty. So a checkpoint
either package writes loads in the other, and a resumed run continues
bit for bit.

Integrity and rotation: every leaf carries a CRC32 in the header,
verified on load; `keep=N` rotates generations (`path` newest, `path.1`
... `path.N-1` older); `find_resume_checkpoint` implements `--resume
auto`: the newest candidate that verifies wins, corrupt ones are skipped
with a reason. The write is atomic (temporary file, fsync, rename, fsync
of the directory) with a bounded retry on transient errors.

Format versions: v3 added the fault epoch, v4 the per-leaf CRC32s, v5
the named `extra_*` arrays outside the state tree (the pressure
reservoir) and i64 queue drops (a narrower integer leaf is widened on
load), v6 the mesh header, v7 the serving plane's manifest. This module
writes v7 and loads v3-v7.

Not ported, each raising NotImplementedError: shard sets (`shard=`,
`load_shard_set`, `shard_member_path`; ROADMAP item 7, sharding) and
the serving plane's manifest (`serve_manifest=`; ROADMAP item 8).
"""

from __future__ import annotations

import errno
import json
import os
import re
import time
import zipfile
import zlib
from typing import Any

import numpy as np

from shadow_tpu_torch import convert
from shadow_tpu_torch.core.timebase import TIME_INVALID

FORMAT_VERSION = 7
_LOADABLE_VERSIONS = (3, 4, 5, 6, 7)

# Bounded retry for transient IO failure during the atomic write: EINTR
# (a signal landing mid-fsync: the supervisor's SIGUSR1 checkpoint-now
# path makes that likely), ENOSPC (rotation or an external cleaner may
# free space between attempts), EAGAIN. Anything else propagates at
# once. `_io_sleep` is module-level so tests can stub the backoff.
_IO_RETRY_ERRNOS = (errno.EINTR, errno.ENOSPC, errno.EAGAIN)
_IO_ATTEMPTS = 5
_IO_BACKOFF_S = 0.05
_io_sleep = time.sleep


def _savez(f, **arrs) -> None:
    """`np.savez_compressed` at deflate level 1: the same .npz members
    (`np.load` reads either), written faster. A 4,096-host TGen state
    with its spill ring is ~1.2 GB of mostly-empty rows; level 1 writes
    it in ~60% of level 6's time, to ~5.6 MB instead of ~1.3 MB."""
    with zipfile.ZipFile(f, "w", zipfile.ZIP_DEFLATED, compresslevel=1,
                         allowZip64=True) as zf:
        for name, a in arrs.items():
            with zf.open(name + ".npy", "w", force_zip64=True) as g:
                np.lib.format.write_array(g, np.asanyarray(a),
                                          allow_pickle=False)

_NO_SHARDS = ("sharded checkpoint sets are not ported (ROADMAP.md "
              "Queue 1 item 7, sharding)")


def _crc(arr: np.ndarray) -> int:
    # the reference's CRC of the array's bytes, read in place
    return zlib.crc32(np.ascontiguousarray(arr).data) & 0xFFFFFFFF


def state_leaves(state) -> tuple[list[str], list[np.ndarray]]:
    """(keystr paths, numpy leaves) of `state` in the reference's
    flatten order: the checkpoint's leaf table."""
    leaves = convert.engine_state_to_numpy(state)
    return [convert.keystr(k) for k in leaves], list(leaves.values())


def _template_specs(template) -> tuple[list[str], list[tuple]]:
    """(keystr paths, (shape, numpy dtype)) of a template state, read
    from its tensors' metadata without copying them."""
    paths, specs = [], []
    for key, t, u64 in convert.state_tensors(template):
        paths.append(convert.keystr(key))
        specs.append((tuple(t.shape), convert.numpy_dtype(t, u64)))
    return paths, specs


def _rotate(path: str, keep: int) -> None:
    """Shift existing generations one slot older: path -> path.1 -> ...
    -> path.{keep-1}; anything at or beyond the keep horizon is removed
    (so lowering --checkpoint-keep reclaims the disk)."""
    n = 1
    while os.path.exists(f"{path}.{n}"):
        n += 1
    for i in range(n, keep - 1, -1):  # prune the tail beyond the horizon
        stale = f"{path}.{i}"
        if os.path.exists(stale):
            os.remove(stale)
    for i in range(min(n, keep - 1), 0, -1):
        src = path if i == 1 else f"{path}.{i - 1}"
        if os.path.exists(src):
            os.replace(src, f"{path}.{i}")


def checkpoint_generations(path: str) -> list[str]:
    """Existing generation files, newest first (path, path.1, ...)."""
    out = [path] if os.path.exists(path) else []
    suffixed = []
    base = os.path.basename(path)
    d = os.path.dirname(os.path.abspath(path))
    if os.path.isdir(d):
        pat = re.compile(re.escape(base) + r"\.(\d+)$")
        for name in os.listdir(d):
            m = pat.match(name)
            if m:
                suffixed.append((int(m.group(1)), os.path.join(
                    os.path.dirname(path) or ".", name)))
    out += [p for _, p in sorted(suffixed)]
    return out


def _is_xchg(path: str) -> bool:
    return path.startswith(".xchg")


def _xchg_empty(paths: list[str], leaves: list[np.ndarray]) -> bool:
    """True when the cross-shard exchange buffer holds no in-flight
    events: every occupancy-bearing xchg leaf (`.time` slots and the
    `sent_min` barrier) is all TIME_INVALID (int max). A tree without
    an exchange buffer (every state of this package) is empty."""
    empty = True
    for pth, arr in zip(paths, leaves):
        if not _is_xchg(pth):
            continue
        if pth.endswith(".time") or pth.endswith("sent_min"):
            if arr.dtype.kind == "i":
                empty &= bool(np.all(arr == np.iinfo(arr.dtype).max))
    return empty


def _is_spill(path: str) -> bool:
    return path.startswith(".queues.spill")


def _spill_empty(paths: list[str], leaves: list[np.ndarray]) -> bool:
    """True when the overflow spill ring parked nothing: every write
    cursor `.wr` is zero. Trees without a spill ring are empty."""
    empty = True
    for pth, arr in zip(paths, leaves):
        if _is_spill(pth) and pth.endswith(".wr"):
            empty &= bool(np.all(arr == 0))
    return empty


def shard_member_path(path: str, index: int, count: int) -> str:
    """File name of one member of a sharded checkpoint set: not
    ported."""
    raise NotImplementedError(_NO_SHARDS)


def _write_atomic(path: str, arrs: dict[str, np.ndarray],
                  keep: int = 1) -> None:
    """write-tmp / fsync / atomic-rename / fsync-dir, with bounded
    backoff on transient errno: a crash mid-write cannot destroy the
    previous good checkpoint, and a power loss cannot persist the
    rename without the data."""
    tmp = path + ".tmp"
    for attempt in range(_IO_ATTEMPTS):
        try:
            with open(tmp, "wb") as f:
                _savez(f, **arrs)
                f.flush()
                os.fsync(f.fileno())
            break
        except OSError as e:
            # reclaim the partial file first: on ENOSPC it is the space
            # needed back
            try:
                os.remove(tmp)
            except OSError:
                pass
            if (e.errno not in _IO_RETRY_ERRNOS
                    or attempt == _IO_ATTEMPTS - 1):
                raise
            _io_sleep(_IO_BACKOFF_S * (2 ** attempt))
    if keep > 1:
        _rotate(path, keep)
    os.replace(tmp, path)
    dfd = os.open(os.path.dirname(os.path.abspath(path)), os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


def save_checkpoint(path: str, state: Any, meta: dict | None = None,
                    keep: int = 1,
                    extra: dict[str, np.ndarray] | None = None,
                    mesh_info: dict | None = None,
                    shard: tuple[int, int] | None = None,
                    serve_manifest: dict | None = None) -> None:
    """Write the EngineState `state` to `path` as .npz.

    `keep > 1` rotates: the previous `path` becomes `path.1` (and so on
    up to `path.{keep-1}`) before the new file lands. `extra` carries
    named host-side arrays outside the state tree (the pressure
    reservoir, `PressureController.serialize()`): CRC'd like leaves,
    left out of the template match on load. `mesh_info` records the
    writer's mesh ({"n_shards", "dcn_slices", "host_order"}).
    `shard=` and `serve_manifest=` are not ported.
    """
    if shard is not None:
        raise NotImplementedError(_NO_SHARDS)
    if serve_manifest is not None:
        raise NotImplementedError(
            "the serving plane's checkpoint manifest is not ported "
            "(ROADMAP.md Queue 1 item 8, fleets and serving)")
    paths, leaves = state_leaves(state)
    extra = {k: np.asarray(v) for k, v in (extra or {}).items()}
    header = {
        "format_version": FORMAT_VERSION,
        "n_leaves": len(leaves),
        "paths": paths,
        "shapes": [list(np.shape(x)) for x in leaves],
        "dtypes": [str(x.dtype) for x in leaves],
        "crc32": [_crc(x) for x in leaves],
        "extra": {k: _crc(v) for k, v in sorted(extra.items())},
        "meta": meta or {},
        "xchg_empty": _xchg_empty(paths, leaves),
    }
    if mesh_info is not None:
        header["mesh"] = dict(mesh_info)
    arrs = {f"leaf_{i}": x for i, x in enumerate(leaves)}
    arrs.update({f"extra_{k}": v for k, v in extra.items()})
    arrs["__header__"] = np.frombuffer(
        json.dumps(header).encode("utf-8"), dtype=np.uint8
    )
    _write_atomic(path, arrs, keep=keep)


def _corrupt(path: str, e: Exception) -> ValueError:
    return ValueError(f"checkpoint {path!r} is truncated or corrupt "
                      f"({type(e).__name__}: {e})")


# container-level damage: truncation, zip corruption, missing members,
# np.load taking a non-archive for a pickle
_DAMAGE = (zipfile.BadZipFile, KeyError, EOFError, OSError, ValueError,
           json.JSONDecodeError)


def _read_raw(path: str) -> tuple[dict, list[np.ndarray]]:
    """Read header + every leaf; container damage becomes a ValueError
    that names the file."""
    try:
        with np.load(path) as data:
            header = json.loads(bytes(data["__header__"]).decode("utf-8"))
            leaves = [data[f"leaf_{i}"] for i in range(header["n_leaves"])]
    except _DAMAGE as e:
        raise _corrupt(path, e) from e
    ver = header.get("format_version")
    if ver not in _LOADABLE_VERSIONS:
        raise ValueError(
            f"checkpoint {path!r}: format {ver} not in loadable set "
            f"{_LOADABLE_VERSIONS} (current writer: {FORMAT_VERSION})"
        )
    return header, leaves


def verify_checkpoint(path: str) -> dict:
    """Fully read `path` and verify every leaf and extra against its
    header CRC32. Returns the user meta dict; raises ValueError naming
    the file and the first mismatch otherwise. v3 files (no CRCs) pass
    the container checks only."""
    header, leaves = _read_raw(path)
    crcs = header.get("crc32")
    if crcs is not None:
        for i, (arr, want) in enumerate(zip(leaves, crcs)):
            got = _crc(arr)
            if got != want:
                pth = header["paths"][i] if i < len(header["paths"]) else "?"
                raise ValueError(
                    f"checkpoint {path!r}: CRC mismatch on leaf {i} ({pth}): "
                    f"stored {want:#010x}, computed {got:#010x} — the file "
                    "was damaged after it was written"
                )
    if header.get("extra"):
        for name, arr in read_extra(path).items():
            want = header["extra"][name]
            got = _crc(arr)
            if got != want:
                raise ValueError(
                    f"checkpoint {path!r}: CRC mismatch on extra {name!r}: "
                    f"stored {want:#010x}, computed {got:#010x} — the file "
                    "was damaged after it was written"
                )
    return header.get("meta", {})


def read_extra(path: str) -> dict[str, np.ndarray]:
    """The checkpoint's named extra arrays (empty for v3/v4 files)."""
    try:
        with np.load(path) as data:
            header = json.loads(bytes(data["__header__"]).decode("utf-8"))
            return {
                k: data[f"extra_{k}"] for k in header.get("extra", {})
            }
    except _DAMAGE as e:
        raise _corrupt(path, e) from e


def read_header_info(path: str) -> dict:
    """Light header read (no leaf data): {"format_version", "meta",
    "mesh" (None before v6), "xchg_empty", "shard", "serve" (None
    before v7 and for non-serve files)}."""
    try:
        with np.load(path) as data:
            header = json.loads(bytes(data["__header__"]).decode("utf-8"))
    except _DAMAGE as e:
        raise _corrupt(path, e) from e
    return {
        "format_version": header.get("format_version"),
        "meta": header.get("meta", {}),
        "mesh": header.get("mesh"),
        "xchg_empty": header.get("xchg_empty", True),
        "shard": header.get("shard"),
        "serve": header.get("serve"),
    }


def find_resume_checkpoint(path: str):
    """`--resume auto`: the newest checkpoint of `path` that verifies.

    Candidates, newest mtime first: the rotation generations (`path`,
    `path.1`, ...) and the crash-time `path.emergency` file. Returns
    (chosen path, meta, skipped) where `skipped` lists (path, reason)
    for newer candidates that failed; None when nothing checkpoint-like
    exists; raises ValueError when candidates exist but none verifies.
    Members of a sharded set (`path.shard<i>of<n>`) are reported in
    `skipped`: sets are not ported.
    """
    skipped: list[tuple[str, str]] = []
    # (mtime, tiebreak, path): the tiebreak keeps the generation order
    # when mtimes collide
    cands: list[tuple[float, int, str]] = []
    for i, p in enumerate(checkpoint_generations(path)):
        cands.append((os.path.getmtime(p), i, p))
    emerg = path + ".emergency"
    if os.path.exists(emerg):
        # written at crash time, so usually the newest and furthest
        # along; ties with the bare path prefer the emergency file
        cands.append((os.path.getmtime(emerg), -1, emerg))
    d = os.path.dirname(os.path.abspath(path))
    if os.path.isdir(d):
        pat = re.compile(re.escape(os.path.basename(path))
                         + r"\.shard\d+of\d+$")
        for name in sorted(os.listdir(d)):
            if pat.match(name):
                skipped.append((os.path.join(os.path.dirname(path) or ".",
                                             name), _NO_SHARDS))
    if not cands:
        if skipped:
            raise ValueError(
                "no verifiable checkpoint:\n  "
                + "\n  ".join(f"{p}: {r}" for p, r in skipped)
            )
        return None
    cands.sort(key=lambda c: (-c[0], c[1]))
    for _, _, p in cands:
        try:
            meta = verify_checkpoint(p)
        except ValueError as e:
            skipped.append((p, str(e)))
            continue
        if read_header_info(p).get("serve") is not None:
            # a serving-plane lane snapshot is a lane-stacked batch
            # state, not a batch-run state: refuse it by name
            skipped.append((
                p,
                "serving-plane lane snapshot (v7 'serve' manifest) — "
                "batch-run --resume auto cannot load a lane-stacked "
                "batch state",
            ))
            continue
        return p, meta, skipped
    raise ValueError(
        "no verifiable checkpoint generation:\n  "
        + "\n  ".join(f"{p}: {r}" for p, r in skipped)
    )


def _check_leaf(arr: np.ndarray, spec: tuple, pth: str, want_crc,
                path: str, i) -> np.ndarray:
    """Shape/dtype/CRC validation of one checkpoint leaf against its
    template spec (shape, dtype), with the lossless integer widening of
    older formats: the CRC is verified against the stored bytes first,
    then the leaf is widened to the template dtype."""
    want_shape, want_dtype = spec
    widen = (
        arr.shape == want_shape
        and arr.dtype != want_dtype
        and arr.dtype.kind == want_dtype.kind == "i"
        and arr.dtype.itemsize < want_dtype.itemsize
    )
    if (arr.shape != want_shape or arr.dtype != want_dtype) and not widen:
        raise ValueError(
            f"leaf {i} ({pth}): checkpoint {arr.shape}/{arr.dtype} vs "
            f"template {want_shape}/{want_dtype}"
        )
    if want_crc is not None and _crc(arr) != want_crc:
        raise ValueError(
            f"checkpoint {path!r}: CRC mismatch on leaf {i} ({pth}) — "
            "the file was damaged after it was written"
        )
    if widen:
        arr = arr.astype(want_dtype)
    return arr


def _build(template, paths: list[str], arrays: list[np.ndarray]):
    """An EngineState shaped like `template`, on its device, from
    leaves in the template's order."""
    leaves = {convert.key_of(p): a for p, a in zip(paths, arrays)}
    return convert.engine_state_from_numpy(
        leaves, template.now.device, hosts=template.hosts)


def load_checkpoint(path: str, template: Any, *,
                    reshard: bool = False) -> tuple[Any, dict]:
    """Load a checkpoint into the structure of `template` (an
    EngineState of this package, e.g. a rebuilt Simulation's state0).

    Returns (state, meta). Raises ValueError on container corruption,
    a per-leaf CRC mismatch or a structural mismatch.

    With `reshard=True` leaves are matched by tree path, and the two
    subtrees that depend on the writer's mesh may differ: the exchange
    buffer (`.xchg`, which only a sharded reference run has) and the
    spill ring (`.queues.spill`, absent from a sharded reference run's
    default mode). Each is taken fresh from the template when the
    checkpoint's held nothing, and refused loudly when it did.
    """
    header, leaves = _read_raw(path)
    paths, specs = _template_specs(template)
    crcs = header.get("crc32") or [None] * len(leaves)
    if header["paths"] == paths and header["n_leaves"] == len(paths):
        return (_build(template, paths, [
            _check_leaf(arr, spec, pth, want_crc, path, i)
            for i, (spec, pth, arr, want_crc) in enumerate(
                zip(specs, paths, leaves, crcs))
        ]), header.get("meta", {}))
    if not reshard:
        if header["n_leaves"] != len(paths):
            raise ValueError(
                f"checkpoint has {header['n_leaves']} leaves, template has "
                f"{len(paths)} — was it built from the same config?"
            )
        diff = [
            f"  {a} (checkpoint) vs {b} (template)"
            for a, b in zip(header["paths"], paths)
            if a != b
        ]
        raise ValueError(
            "checkpoint tree structure differs from template:\n"
            + "\n".join(diff[:10])
        )
    # --- mesh-portable path: match leaves by tree path
    c_non_xchg = [p for p in header["paths"] if not _is_xchg(p)]
    t_non_xchg = list(paths)
    spill_mismatch = (
        c_non_xchg != t_non_xchg
        and [p for p in c_non_xchg if not _is_spill(p)]
        == [p for p in t_non_xchg if not _is_spill(p)]
    )
    if spill_mismatch:
        if not _spill_empty(header["paths"], leaves):
            raise ValueError(
                f"checkpoint {path!r} holds spilled events in its "
                "overflow ring — resume once with --overflow spill on "
                "the original mesh to re-seat them, then reshard."
            )
        c_non_xchg = [p for p in c_non_xchg if not _is_spill(p)]
        t_non_xchg = [p for p in t_non_xchg if not _is_spill(p)]
    if c_non_xchg != t_non_xchg:
        diff = [f"  {a} (checkpoint) vs {b} (template)"
                for a, b in zip(c_non_xchg, t_non_xchg) if a != b]
        if len(c_non_xchg) != len(t_non_xchg):
            diff.append(
                f"  {len(c_non_xchg)} non-exchange leaves (checkpoint) vs "
                f"{len(t_non_xchg)} (template)")
        raise ValueError(
            "checkpoint differs from template beyond the mesh-shaped "
            "exchange buffer — reshard needs the same config/host count:\n"
            + "\n".join(diff[:10])
        )
    if not _xchg_empty(header["paths"], leaves):
        raise ValueError(
            f"checkpoint {path!r} holds in-flight cross-shard events "
            "(non-empty exchange buffer) — it cannot restore onto a "
            "different mesh. Resume once on the original shard count to "
            "reach a window boundary, then reshard."
        )
    by_path = {p: (arr, crc)
               for p, arr, crc in zip(header["paths"], leaves, crcs)}
    fresh = None
    out = []
    for i, (spec, pth) in enumerate(zip(specs, paths)):
        mesh_shaped = spill_mismatch and _is_spill(pth)
        if pth in by_path and (not mesh_shaped
                               or by_path[pth][0].shape == spec[0]):
            arr, want_crc = by_path[pth]
            out.append(_check_leaf(arr, spec, pth, want_crc, path, i))
        elif mesh_shaped:
            # the template's own empty spill ring: the checkpoint's was
            # verified empty above, so no event is lost
            if fresh is None:
                fresh = convert.engine_state_to_numpy(template)
            out.append(fresh[convert.key_of(pth)])
        else:
            raise ValueError(f"leaf {pth} missing from checkpoint {path!r}")
    return _build(template, paths, out), header.get("meta", {})


def load_shard_set(member_paths: list[str], template: Any):
    """Load a complete sharded checkpoint set: not ported."""
    raise NotImplementedError(_NO_SHARDS)


def transfer_state(state: Any, template: Any) -> Any:
    """Carry `state` into the (larger) shapes of `template`: the
    `--overflow grow` re-template, where the engine is rebuilt at doubled
    queue capacity and the live state moves across mid-run.

    Leaves are matched by tree path (both trees must have the same
    structure). Where a template leaf is longer along some axes, the
    state leaf is padded at the end of each grown axis: right for every
    capacity-sized array, because a queue row keeps its occupied slots
    in a sorted prefix (empties last) and the spill ring's occupancy is
    a prefix below its write cursor (zero here: the CLI harvests the
    ring before growing). The pad is TIME_INVALID for int64 leaves whose
    path ends in `.time`, zero otherwise. Integer leaves are widened to
    the template dtype when needed; shrinking an axis or narrowing a
    dtype is refused.
    """
    s_leaves = convert.engine_state_to_numpy(state)
    s_paths = [convert.keystr(k) for k in s_leaves]
    t_paths, specs = _template_specs(template)
    if s_paths != t_paths:
        diff = [f"  {a} (state) vs {b} (template)"
                for a, b in zip(s_paths, t_paths) if a != b]
        raise ValueError(
            "transfer_state: tree structure differs:\n" + "\n".join(diff[:10])
        )
    out = []
    for pth, arr, (want_shape, want_dtype) in zip(
            t_paths, s_leaves.values(), specs):
        if arr.dtype != want_dtype:
            if not (arr.dtype.kind == want_dtype.kind == "i"
                    and arr.dtype.itemsize < want_dtype.itemsize):
                raise ValueError(
                    f"transfer_state: leaf {pth}: cannot convert "
                    f"{arr.dtype} -> {want_dtype}"
                )
            arr = arr.astype(want_dtype)
        if arr.shape != want_shape:
            if arr.ndim != len(want_shape) or any(
                a > w for a, w in zip(arr.shape, want_shape)
            ):
                raise ValueError(
                    f"transfer_state: leaf {pth}: cannot shrink "
                    f"{arr.shape} -> {want_shape}"
                )
            fill = (TIME_INVALID if pth.endswith(".time")
                    and want_dtype == np.int64 else 0)
            grown = np.full(want_shape, fill, want_dtype)
            grown[tuple(slice(0, a) for a in arr.shape)] = arr
            arr = grown
        out.append(arr)
    return _build(template, t_paths, out)
