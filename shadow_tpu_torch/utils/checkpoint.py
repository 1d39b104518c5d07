"""Checkpoint/resume of simulation state: the counterpart of
`shadow_tpu.utils.checkpoint`, reading and writing the same files.

A checkpoint is the whole EngineState written to one .npz: the leaves
by index (`leaf_<i>`) in the reference's pytree flatten order, under
the reference's `keystr` paths (`convert.state_tensors`, `convert.keystr`),
uint64 leaves as uint64, plus a JSON header (`__header__`) recording
the leaf paths, shapes, dtypes and CRC32s, a free-form user dict (config
digest, sim time, seed), the writer's mesh (`n_shards`, `dcn_slices`,
`host_order`) and whether the cross-shard exchange buffer was empty. So
a checkpoint either package writes loads in the other, and a resumed run
continues bit for bit.

Sharded runs (`parallel.mesh`): a state is one rank's shard. Pass the
rank's `mesh` and `save_checkpoint` gathers the global view, which rank
0 writes in the reference's layout; `load_checkpoint` then checks the
file against the global shapes and returns the rank's shard. A shard set
(`save_checkpoint(shard=(i, n))`, one member per rank, named by
`shard_member_path`) is resumed whole or not at all
(`find_resume_checkpoint`, `load_shard_set`). With `reshard=True` a
checkpoint written at S shards restores at S', the exchange buffer taken
fresh, provided it held no event in flight.

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

The serving plane (`serve/`) writes its beat snapshots here: a fleet's
state in the reference's [L, ...] lane layout (`runtime.fleet.lane_view`)
with a batch manifest in the header (`serve_manifest=`, read back by
`read_header_info`), and migrates them at the file level
(`load_checkpoint_raw`, `save_checkpoint_raw`). A state may also be a
flat dict of arrays, stored under the reference's `['key']` paths.
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


def _crc(arr: np.ndarray) -> int:
    # the reference's CRC of the array's bytes, read in place
    return zlib.crc32(np.ascontiguousarray(arr).data) & 0xFFFFFFFF


def _dict_path(key) -> str:
    # `jax.tree_util.keystr` of a dict key
    return f"[{key!r}]"


def state_leaves(state) -> tuple[list[str], list[np.ndarray]]:
    """(keystr paths, numpy leaves) of `state` in the reference's
    flatten order: the checkpoint's leaf table. A flat dict of arrays
    flattens in sorted key order, as a pytree dict does."""
    if isinstance(state, dict):
        keys = sorted(state)
        return ([_dict_path(k) for k in keys],
                [np.asarray(state[k]) for k in keys])
    leaves = convert.engine_state_to_numpy(state)
    return [convert.keystr(k) for k in leaves], list(leaves.values())


def _template_specs(template) -> tuple[list[str], list[tuple]]:
    """(keystr paths, (shape, numpy dtype)) of a template state, read
    from its tensors' metadata without copying them."""
    if isinstance(template, dict):
        paths, leaves = state_leaves(template)
        return paths, [(x.shape, x.dtype) for x in leaves]
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
    an exchange buffer (an unsharded state) is empty."""
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
    """File name of one member of a sharded checkpoint set."""
    return f"{path}.shard{index}of{count}"


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
                    serve_manifest: dict | None = None,
                    mesh: Any = None) -> None:
    """Write the EngineState `state` to `path` as .npz.

    `keep > 1` rotates: the previous `path` becomes `path.1` (and so on
    up to `path.{keep-1}`) before the new file lands. `extra` carries
    named host-side arrays outside the state tree (the pressure
    reservoir, `PressureController.serialize()`): CRC'd like leaves,
    left out of the template match on load. `mesh_info` records the
    writer's mesh ({"n_shards", "dcn_slices", "host_order"}).

    `mesh` (a sharded state's `parallel.mesh.Mesh`): every rank calls,
    the global view is gathered and rank 0 writes it. `shard=(i, n)`
    instead writes `state` as member i of a set of n, to
    `shard_member_path(path, i, n)` (no rotation: a set is resumed
    whole or not at all). `serve_manifest` (v7) records a serving-plane
    batch manifest (rids, request docs, class string, beat progress) so
    a restarted `serve` can find and resume its in-flight batch.
    """
    if mesh is not None and shard is None:
        from shadow_tpu_torch.parallel.mesh import gather_state

        got = gather_state(state, mesh)
        if got is None:
            return
        paths = [convert.keystr(k) for k in got]
        leaves = list(got.values())
    else:
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
    if serve_manifest is not None:
        header["serve"] = dict(serve_manifest)
    if shard is not None:
        i, n = shard
        if not 0 <= i < n:
            raise ValueError(f"shard index {i} out of range for set of {n}")
        header["shard"] = [i, n]
        path = shard_member_path(path, i, n)
        keep = 1
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


def load_checkpoint_raw(path: str) -> tuple[dict, dict[str, np.ndarray]]:
    """Read a checkpoint WITHOUT a template: (header, {leaf_path:
    array}) with every leaf verified against its stored CRC32.

    The file-level half of serving-plane lane migration: the migrator
    slices the raw `[L, ...]` leaves along the lane axis and writes the
    parts back through `save_checkpoint_raw` under the SAME leaf-path
    keys, so a part loads against a template of fewer lanes by the
    ordinary path matching of `load_checkpoint`."""
    header, leaves = _read_raw(path)
    crcs = header.get("crc32")
    if crcs is not None:
        for i, (arr, want) in enumerate(zip(leaves, crcs)):
            got = _crc(arr)
            if got != want:
                pth = header["paths"][i] if i < len(header["paths"]) else "?"
                raise ValueError(
                    f"checkpoint {path!r}: CRC mismatch on leaf {i} "
                    f"({pth}): stored {want:#010x}, computed {got:#010x} "
                    "— the file was damaged after it was written"
                )
    return header, dict(zip(header["paths"], leaves))


def save_checkpoint_raw(path: str, leaves_by_path: dict[str, np.ndarray],
                        *, meta: dict | None = None,
                        mesh_info: dict | None = None,
                        serve_manifest: dict | None = None) -> None:
    """Write pre-flattened `{leaf_path: array}` leaves as a checkpoint,
    keeping the path strings verbatim (insertion order is the leaf
    order). Shapes, dtypes and per-leaf CRCs are recomputed from the
    arrays, so a lane-sliced copy of a loaded file carries honest
    integrity data of its own. The same atomic write as
    `save_checkpoint`."""
    paths = list(leaves_by_path)
    leaves = [np.asarray(leaves_by_path[p]) for p in paths]
    header = {
        "format_version": FORMAT_VERSION,
        "n_leaves": len(leaves),
        "paths": paths,
        "shapes": [list(np.shape(x)) for x in leaves],
        "dtypes": [str(x.dtype) for x in leaves],
        "crc32": [_crc(x) for x in leaves],
        "extra": {},
        "meta": meta or {},
        "xchg_empty": _xchg_empty(paths, leaves),
    }
    if mesh_info is not None:
        header["mesh"] = dict(mesh_info)
    if serve_manifest is not None:
        header["serve"] = dict(serve_manifest)
    arrs = {f"leaf_{i}": x for i, x in enumerate(leaves)}
    arrs["__header__"] = np.frombuffer(
        json.dumps(header).encode("utf-8"), dtype=np.uint8
    )
    _write_atomic(path, arrs, keep=1)


def _shard_sets(path: str) -> dict[int, dict[int, str]]:
    """{set_size: {member_index: member_path}} for files named
    `<path>.shard<i>of<n>` next to `path`."""
    base = os.path.basename(path)
    d = os.path.dirname(os.path.abspath(path))
    sets: dict[int, dict[int, str]] = {}
    if os.path.isdir(d):
        pat = re.compile(re.escape(base) + r"\.shard(\d+)of(\d+)$")
        for name in os.listdir(d):
            m = pat.match(name)
            if m:
                i, n = int(m.group(1)), int(m.group(2))
                sets.setdefault(n, {})[i] = os.path.join(
                    os.path.dirname(path) or ".", name)
    return sets


def find_resume_checkpoint(path: str):
    """`--resume auto`: the newest checkpoint of `path` that verifies.

    Candidates, newest mtime first: the rotation generations (`path`,
    `path.1`, ...), the crash-time `path.emergency` file and complete
    shard sets (`path.shard<i>of<n>`, every member present and
    verifying: all or none; a torn set is reported in `skipped`).
    Returns (chosen, meta, skipped) where `chosen` is a path, or the
    list of member paths (in shard order) of a set of more than one, to
    load with `load_shard_set`; `skipped` lists (path, reason) for newer
    candidates that failed. None when nothing checkpoint-like exists;
    raises ValueError when candidates exist but none verifies.
    """
    skipped: list[tuple[str, str]] = []
    # (mtime, tiebreak, chosen, member paths): the tiebreak keeps the
    # generation order when mtimes collide
    cands: list[tuple[float, int, Any, list[str]]] = []
    for i, p in enumerate(checkpoint_generations(path)):
        cands.append((os.path.getmtime(p), i, p, [p]))
    emerg = path + ".emergency"
    if os.path.exists(emerg):
        # written at crash time, so usually the newest and furthest
        # along; ties with the bare path prefer the emergency file
        cands.append((os.path.getmtime(emerg), -1, emerg, [emerg]))
    for n, members in sorted(_shard_sets(path).items()):
        if sorted(members) != list(range(n)):
            got = ", ".join(
                os.path.basename(members[i]) for i in sorted(members))
            skipped.append((
                shard_member_path(path, 0, n).replace("0of", "*of", 1),
                f"incomplete shard set: {len(members)} of {n} members "
                f"present ({got}) — refusing to resume a torn state",
            ))
            continue
        paths_n = [members[i] for i in range(n)]
        cands.append((max(os.path.getmtime(p) for p in paths_n), 0,
                      paths_n if n > 1 else paths_n[0], paths_n))
    if not cands:
        if skipped:
            raise ValueError(
                "no verifiable checkpoint:\n  "
                + "\n  ".join(f"{p}: {r}" for p, r in skipped)
            )
        return None
    cands.sort(key=lambda c: (-c[0], c[1]))
    for _, _, chosen, member_paths in cands:
        try:
            meta = {}
            for p in member_paths:
                meta = verify_checkpoint(p)
        except ValueError as e:
            skipped.append((member_paths[0] if len(member_paths) == 1
                            else str(member_paths), str(e)))
            continue
        serve_member = next(
            (p for p in member_paths
             if read_header_info(p).get("serve") is not None), None)
        if serve_member is not None:
            # a serving-plane lane snapshot is a lane-stacked batch
            # state, not a batch-run state: refuse it by name
            skipped.append((
                serve_member,
                "serving-plane lane snapshot (v7 'serve' manifest) — "
                "batch-run --resume auto cannot load a lane-stacked "
                "batch state; restart `shadow_tpu_torch serve` with the "
                "same --snapshot-path and let resume_pending_batch pick "
                "up the in-flight batch instead",
            ))
            continue
        return chosen, meta, skipped
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
    leaves in the template's order (a dict template: a dict of numpy
    arrays)."""
    if isinstance(template, dict):
        return dict(zip(sorted(template), arrays))
    leaves = {convert.key_of(p): a for p, a in zip(paths, arrays)}
    return convert.engine_state_from_numpy(
        leaves, template.now.device, hosts=template.hosts)


def _target(template, mesh):
    """(keystr paths, (shape, dtype) specs, fresh) of the state a file
    restores into: the template's own or, with a mesh, the global view
    of the template's shards. fresh(path) gives that view's leaf of a
    fresh build (the template is one): the exchange buffer and spill
    ring a mesh-crossing restore takes new."""
    if mesh is None:
        paths, specs = _template_specs(template)
        local = None

        def fresh(pth):
            nonlocal local
            if local is None:
                local = convert.engine_state_to_numpy(template)
            return local[convert.key_of(pth)]
        return paths, specs, fresh
    from shadow_tpu_torch.parallel.mesh import global_specs

    g = global_specs(template, mesh)
    paths = [convert.keystr(k) for k, _, _ in g]
    specs = [(shape, dtype) for _, shape, dtype in g]
    local = None

    def fresh(pth):
        nonlocal local
        if local is None:
            local = convert.engine_state_to_numpy(template)
        a = local[convert.key_of(pth)]
        want = specs[paths.index(pth)][0]
        return np.concatenate([a] * (want[0] // a.shape[0])) \
            if a.shape != want else a
    return paths, specs, fresh


def _restore(template, mesh, paths: list[str], arrays: list[np.ndarray]):
    """The state of the template's shape (its shard of the global
    `arrays`, with a mesh) from leaves in the target's order."""
    if mesh is None:
        return _build(template, paths, arrays)
    from shadow_tpu_torch.parallel.mesh import scatter_state

    return scatter_state({convert.key_of(p): a
                          for p, a in zip(paths, arrays)}, template, mesh)


def load_checkpoint(path: str, template: Any, *,
                    reshard: bool = False, mesh: Any = None
                    ) -> tuple[Any, dict]:
    """Load a checkpoint into the structure of `template` (an
    EngineState of this package, e.g. a rebuilt Simulation's state0).

    Returns (state, meta). Raises ValueError on container corruption,
    a per-leaf CRC mismatch or a structural mismatch.

    With `mesh` (a sharded template, one rank's shard), the file holds
    the global state and is checked against the global shapes; every
    rank reads it and gets its own shard back.

    With `reshard=True` leaves are matched by tree path, and the two
    subtrees that depend on the writer's mesh may differ: the exchange
    buffer (`.xchg`, whose shape is the writer's shard count's, absent
    when unsharded) and the spill ring (`.queues.spill`, absent from
    sharded runs). Each is taken fresh from the template when the
    checkpoint's held nothing, and refused loudly when it did.
    """
    header, leaves = _read_raw(path)
    paths, specs, fresh = _target(template, mesh)
    crcs = header.get("crc32") or [None] * len(leaves)
    exact = header["paths"] == paths and header["n_leaves"] == len(paths)
    if exact and reshard:
        # the same tree, but maybe another shard count: an exchange
        # buffer of another shape takes the portable path below
        exact = all(arr.shape == spec[0] for pth, arr, spec
                    in zip(paths, leaves, specs) if _is_xchg(pth))
    if exact:
        return (_restore(template, mesh, paths, [
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
    t_non_xchg = [p for p in paths if not _is_xchg(p)]
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
    out = []
    for i, (spec, pth) in enumerate(zip(specs, paths)):
        mesh_shaped = _is_xchg(pth) or (spill_mismatch and _is_spill(pth))
        if pth in by_path and (not mesh_shaped
                               or by_path[pth][0].shape == spec[0]):
            arr, want_crc = by_path[pth]
            out.append(_check_leaf(arr, spec, pth, want_crc, path, i))
        elif mesh_shaped:
            # the target's own empty exchange buffer or spill ring: the
            # checkpoint's was verified empty above, so nothing is lost
            out.append(fresh(pth))
        else:
            raise ValueError(f"leaf {pth} missing from checkpoint {path!r}")
    return _restore(template, mesh, paths, out), header.get("meta", {})


def load_shard_set(member_paths: list[str], template: Any, *,
                   mesh: Any = None) -> tuple[Any, dict]:
    """Load a complete shard set (one file per rank, from
    `save_checkpoint(shard=(i, n))`) into `template` (unsharded, or one
    rank's shard with its `mesh`: the set may have been written at any
    shard count).

    Per-host leaves (leading dim = global hosts / n in every member)
    concatenate in member order; replicated leaves must agree bit for
    bit across members and come from member 0; the exchange buffer must
    be empty in every member and comes fresh from the template. Returns
    (state, meta of member 0). Extras are refused (the pressure
    reservoir never coexists with a sharded mesh).
    """
    n = len(member_paths)
    read = [_read_raw(p) for p in member_paths]
    for p, (hdr, lvs) in zip(member_paths, read):
        shard = hdr.get("shard")
        if shard is not None and shard[1] != n:
            raise ValueError(
                f"{p!r} belongs to a set of {shard[1]}, got {n} members")
        if hdr.get("extra"):
            raise ValueError(
                f"{p!r} carries extra arrays; sharded sets cannot hold "
                "a pressure reservoir")
        if hdr["paths"] != read[0][0]["paths"]:
            raise ValueError(
                f"{p!r}: leaf paths differ from {member_paths[0]!r}")
        if not _xchg_empty(hdr["paths"], lvs):
            raise ValueError(
                f"{p!r} holds in-flight cross-shard events — the set "
                "cannot restore onto a different mesh")
    c_paths = read[0][0]["paths"]
    paths, specs, fresh = _target(template, mesh)
    c_non_xchg = [p for p in c_paths if not _is_xchg(p)]
    t_non_xchg = [p for p in paths if not _is_xchg(p)]
    # members come from sharded builds, which refuse spill modes: an
    # unsharded target may still carry the (default) spill ring, which
    # starts fresh like the exchange buffer
    spill_mismatch = (
        c_non_xchg != t_non_xchg
        and c_non_xchg == [p for p in t_non_xchg if not _is_spill(p)]
    )
    if spill_mismatch:
        t_non_xchg = [p for p in t_non_xchg if not _is_spill(p)]
    if c_non_xchg != t_non_xchg:
        raise ValueError(
            "shard set differs from template beyond the exchange buffer "
            "— was it written from the same config?")
    idx = {p: i for i, p in enumerate(c_paths)}
    out = []
    for spec, pth in zip(specs, paths):
        if _is_xchg(pth) or (spill_mismatch and _is_spill(pth)):
            out.append(fresh(pth))
            continue
        i = idx[pth]
        want_shape = spec[0]
        members = []
        for p, (hdr, lvs) in zip(member_paths, read):
            crc = (hdr.get("crc32") or [None] * len(lvs))[i]
            arr = lvs[i]
            if crc is not None and _crc(arr) != crc:
                raise ValueError(
                    f"checkpoint {p!r}: CRC mismatch on leaf {i} ({pth}) "
                    "— the file was damaged after it was written")
            members.append(arr)
        shapes = {m.shape for m in members}
        if len(shapes) == 1 and members[0].shape == want_shape:
            for p, m in zip(member_paths[1:], members[1:]):
                if not np.array_equal(members[0], m):
                    raise ValueError(
                        f"replicated leaf {pth} differs between "
                        f"{member_paths[0]!r} and {p!r}")
            arr = members[0]
        elif (len(shapes) == 1 and want_shape
                and members[0].shape[1:] == want_shape[1:]
                and members[0].shape[0] * n == want_shape[0]):
            arr = np.concatenate(members, axis=0)
        else:
            raise ValueError(
                f"leaf {pth}: member shape {members[0].shape} does not "
                f"tile template {want_shape} across {n} shards")
        out.append(_check_leaf(arr, spec, pth, None, member_paths[0], pth))
    return (_restore(template, mesh, paths, out),
            read[0][0].get("meta", {}))


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
