"""Host sharding over a torch.distributed process group: the counterpart
of `shadow_tpu.parallel.mesh`.

The reference block-partitions hosts over a `jax.sharding.Mesh` and runs
one SPMD program per device under `shard_map`. Here each shard is one
rank of a `torch.distributed` process group, one process per shard, each
with its own launching thread: `spawn` starts the ranks, `make_mesh`
describes the group to the engine, and `Comm` carries the engine's
collectives (the window barrier's global min, the loop flags' global
any, the counters' global sums and the bucketed exchange's all_to_all).
Rank r owns hosts [r * per, (r + 1) * per); on a 2-D (dcn, hosts) mesh
the ranks are laid out dcn-major, as the reference's axis tuple is, so
rank r is the reference's linear shard index.

Backends are chosen, never tried: NCCL for CUDA ranks (rank r on
`cuda:r`, one card per rank), gloo for CPU ranks. `backend="gloo"` with
CUDA ranks is for ranks that share one card (NCCL refuses two ranks on
one GPU): each collective then copies its operands through pinned host
memory, and `make_mesh` says so on stderr. A failed collective raises,
unless `Comm.hold_on_failure` is set (the CLI's `--collective-timeout`):
then the rank waits, as a rank does whose peer never answers, for the
collective watchdog to write its bundle and exit 77.

`gather_state` builds the reference's global view of a sharded state on
rank 0 (per-host leaves concatenated in rank order, replicated scalars
from rank 0, the exchange buffer's leaves concatenated whatever their
shape, as `state_specs` shards them); `scatter_state` slices a global
view back into one rank's shard, for resumes.
"""

from __future__ import annotations

import atexit
import dataclasses
import datetime
import functools
import os
import pickle
import shutil
import sys
import tempfile
import threading
import time
import traceback
from typing import Callable

import numpy as np
import torch

HOSTS_AXIS = "hosts"
DCN_AXIS = "dcn"

# Collective timeout of the process group when the caller names none: a
# dead peer would otherwise hold a survivor for the backends' own 30
# minutes. The CLI passes a longer one than --collective-timeout.
GROUP_TIMEOUT_S = 600.0

_CURRENT: "Mesh | None" = None
_SPAWN_DEVICE: torch.device | None = None  # set in a rank by `spawn`


def select_spmd(spmd: str = "auto") -> str:
    """Resolve an --spmd request to the executed path. "auto",
    "shard_map" and "pmap" all run the one per-rank program (a rank per
    shard is what the reference's per-device program is); "constraint"
    names the reference's GSPMD-partitioned global engine, which is not
    ported (ROADMAP.md Queue 1 item 7b) and which `build_simulation`
    refuses."""
    if spmd not in ("auto", "shard_map", "constraint", "pmap"):
        raise ValueError(
            f"spmd must be auto|shard_map|constraint|pmap, got {spmd!r}")
    return "shard_map" if spmd == "auto" else spmd


class PeerLost(RuntimeError):
    """A collective failed: a peer rank died or the group broke."""


class Comm:
    """The collectives of one rank over the default process group, each
    on int64/int32/bool tensors of the rank's device. `calls` counts the
    collectives issued. `pet`, when set, is called after each completed
    collective (the CLI's collective watchdog). `hold_on_failure` turns a
    failed collective into a wait that only the watchdog ends."""

    def __init__(self, *, rank: int, size: int, staged: bool):
        self.rank = rank
        self.size = size
        self.staged = staged
        self.calls = 0
        self.pet: Callable[[], None] | None = None
        self.hold_on_failure = False
        self._pinned: dict = {}

    # -- plumbing ------------------------------------------------------------
    def _host(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """A pinned host copy of a CUDA tensor, the collective's i-th
        operand, reusing one buffer per (i, shape, dtype)."""
        key = (i, tuple(t.shape), t.dtype)
        buf = self._pinned.get(key)
        if buf is None:
            with torch.inference_mode(False):
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._pinned[key] = buf
        buf.copy_(t)
        return buf

    def _run(self, op, *tensors: torch.Tensor) -> list[torch.Tensor]:
        """Run the collective `op` over `tensors` (staged through host
        memory when the ranks share a card); returns the results on the
        tensors' own devices."""
        import torch.distributed as dist

        dev = tensors[0].device
        stage = self.staged and dev.type == "cuda"
        args = [self._host(i, t) if stage else t.contiguous()
                for i, t in enumerate(tensors)]
        try:
            op(dist, *args)
        except Exception as e:
            if self.hold_on_failure:
                print(f"shadow_tpu_torch: rank {self.rank}: collective "
                      f"failed ({type(e).__name__}); waiting for the "
                      "collective watchdog", file=sys.stderr, flush=True)
                threading.Event().wait()
            raise PeerLost(f"rank {self.rank}: collective failed: {e}") from e
        self.calls += 1
        if self.pet is not None:
            self.pet()
        return [a.to(dev) if stage else a for a in args]

    # -- the engine's collectives --------------------------------------------
    def _reduce(self, x: torch.Tensor, op_name: str) -> torch.Tensor:
        def op(dist, a):
            dist.all_reduce(a, op=getattr(dist.ReduceOp, op_name))
        return self._run(op, x.clone())[0]

    def gmin(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, "MIN")

    def gsum(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, "SUM")

    def gany(self, x: torch.Tensor) -> torch.Tensor:
        """Global any of a bool tensor, as the reference's psum of the
        int32 flag > 0."""
        return self.gsum(x.to(torch.int32)) > 0

    def all_to_all(self, block: torch.Tensor) -> torch.Tensor:
        """Exchange an [S, ...] block: row s goes to rank s, and row s of
        the result came from rank s (`lax.all_to_all(split_axis=0,
        concat_axis=0)`)."""
        out = torch.empty_like(block)

        def op(dist, o, i):
            dist.all_to_all_single(o, i)
        return self._run(op, out, block)[0]

    def gather(self, buf: torch.Tensor) -> list[torch.Tensor] | None:
        """Gather a 1-D byte buffer of equal length from every rank to
        rank 0: the list in rank order there, None elsewhere."""
        n = buf.numel()
        outs = ([torch.empty((n,), dtype=buf.dtype, device=buf.device)
                 for _ in range(self.size)] if self.rank == 0 else [])

        def op(dist, b, *o):
            dist.gather(b, list(o) if self.rank == 0 else None, dst=0)
        res = self._run(op, buf, *outs)
        return res[1:] if self.rank == 0 else None


@dataclasses.dataclass
class Mesh:
    """One rank's view of the mesh: its rank and device, the layout
    `shape` with axis names `axis_names` ((hosts,) or (dcn, hosts)), the
    group's backend and the `Comm` its collectives go through."""

    rank: int
    size: int
    device: torch.device
    shape: tuple
    axis_names: tuple
    backend: str
    comm: Comm

    @property
    def dcn_slices(self) -> int:
        return self.shape[0] if len(self.shape) == 2 else 1


def hosts_axes(mesh: Mesh):
    """The axis name (1-D mesh) or axis-name tuple (multi-slice mesh)
    hosts are sharded over, as the reference's `hosts_axes`."""
    names = mesh.axis_names
    return names[0] if len(names) == 1 else tuple(names)


def default_backend(device) -> str:
    """NCCL for CUDA ranks, gloo for CPU ranks."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(rank: int, device, backend: str) -> torch.device:
    """The device rank `rank` runs on: the CPU, `cuda:rank` under NCCL
    (which needs one card per rank) or, under gloo with CUDA ranks, the
    cards in turn."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device='cpu' to shard on the CPU")
    n = torch.cuda.device_count()
    if backend == "nccl":
        if rank >= n:
            raise RuntimeError(
                f"NCCL needs one CUDA device per rank: rank {rank} of a "
                f"mesh over {n} device(s); ranks that share a card need "
                "backend='gloo'")
        return torch.device("cuda", rank)
    return torch.device("cuda", rank % n)


def make_mesh(n_devices: int | None = None, dcn_slices: int = 1,
              backend: str | None = None, device=None) -> Mesh:
    """The Mesh of this rank over the current process group (started by
    `spawn`). `n_devices`, when given, must equal the group's size;
    `dcn_slices > 1` lays the ranks out as (dcn, hosts), dcn-major.
    `backend` must be the group's (None: the group's); `device` is the
    ranks' device kind (None: the one `spawn` gave this rank)."""
    global _CURRENT
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a process group: start the ranks with "
            "shadow_tpu_torch.parallel.mesh.spawn")
    size, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != size:
        raise RuntimeError(f"need {n_devices} ranks, the group has {size}")
    got = dist.get_backend()
    if backend is not None and backend != got:
        raise RuntimeError(f"backend {backend!r} asked for, the group "
                           f"runs {got!r}")
    if dcn_slices > 1:
        if size % dcn_slices:
            raise ValueError(
                f"{size} devices not divisible by {dcn_slices} DCN slices")
        shape, names = (dcn_slices, size // dcn_slices), (DCN_AXIS,
                                                           HOSTS_AXIS)
    else:
        shape, names = (size,), (HOSTS_AXIS,)
    if device is not None:
        dev = rank_device(rank, device, got)
    elif _SPAWN_DEVICE is not None:
        dev = _SPAWN_DEVICE
    else:
        dev = rank_device(rank, "cpu" if got == "gloo" else "cuda", got)
    staged = got == "gloo" and dev.type == "cuda"
    if staged and rank == 0:
        print(f"shadow_tpu_torch: mesh of {size} rank(s) over gloo on "
              f"CUDA: every collective copies through pinned host memory",
              file=sys.stderr, flush=True)
    _CURRENT = Mesh(rank=rank, size=size, device=dev, shape=shape,
                    axis_names=names, backend=got,
                    comm=Comm(rank=rank, size=size, staged=staged))
    return _CURRENT


def current() -> Mesh | None:
    """The Mesh `make_mesh` made in this process, or None."""
    return _CURRENT


# -- launching ranks ---------------------------------------------------------

class SpawnError(RuntimeError):
    """A rank did not finish: `exit_codes` holds every rank's exit code
    (negative: killed by that signal)."""

    def __init__(self, exit_codes: list[int]):
        super().__init__(f"rank exit codes {exit_codes}")
        self.exit_codes = exit_codes


def _rank_main(rank, n, backend, device, store_path, result_path,
               timeout_s, fn, args):
    global _SPAWN_DEVICE
    import torch.distributed as dist

    dev = _SPAWN_DEVICE = rank_device(rank, device, backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, store=dist.FileStore(store_path, n), rank=rank,
        world_size=n, timeout=datetime.timedelta(seconds=timeout_s))
    out = fn(*args)
    if rank == 0:
        with open(result_path + ".tmp", "wb") as f:
            pickle.dump(out, f)
        os.replace(result_path + ".tmp", result_path)
    dist.destroy_process_group()


def _rank_entry(*a):
    try:
        _rank_main(*a)
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


def spawn(fn: Callable, n: int, *, backend: str | None = None,
          device=None, args: tuple = (), timeout_s: float | None = None,
          grace_s: float = 30.0):
    """Run `fn(*args)` in n ranks of a new process group and return rank
    0's result.

    Ranks are started with the `spawn` method (CUDA cannot start in a
    forked child), so `fn` must be importable from a module that needs
    no JAX. The group meets through a FileStore in a temporary
    directory: no TCP port is picked. `backend` defaults to NCCL for
    CUDA and gloo for the CPU; `timeout_s` is the group's collective
    timeout (GROUP_TIMEOUT_S by default). When a rank fails, the others
    get `grace_s` past that timeout to end on their own (a watchdog's
    bundle) before they are killed; then SpawnError carries every
    rank's exit code."""
    import torch.multiprocessing as mp

    if n < 1:
        raise ValueError(f"need at least one rank, got {n}")
    backend = backend or default_backend(
        "cuda" if device is None else device)
    if backend == "nccl" and torch.device(
            "cuda" if device is None else device).type != "cuda":
        raise ValueError("NCCL runs CUDA ranks only; use gloo on the CPU")
    timeout_s = float(timeout_s or GROUP_TIMEOUT_S)
    tmp = tempfile.mkdtemp(prefix="shadow_tpu_torch_mesh_")
    # the store's directory goes on every way out: the `finally` below,
    # or the interpreter's exit if this process ends before it runs
    cleanup = functools.partial(shutil.rmtree, tmp, ignore_errors=True)
    atexit.register(cleanup)
    store, result = os.path.join(tmp, "store"), os.path.join(tmp, "result")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_entry, args=(
        r, n, backend, device, store, result, timeout_s, fn, args))
        for r in range(n)]
    # a child starts with this process's sys.path, which may hold
    # relative entries the caller has since changed directory under:
    # lead with this package's root and the directory of fn's module,
    # where this process found them
    lead = [os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))]
    mod = sys.modules.get(getattr(fn, "__module__", ""), None)
    if getattr(mod, "__file__", None):
        lead.append(os.path.dirname(os.path.abspath(mod.__file__)))
    saved = list(sys.path)
    sys.path[:] = lead + [os.path.abspath(p) for p in saved]
    try:
        for p in procs:
            p.start()
        sys.path[:] = saved
        deadline = None
        while any(p.is_alive() for p in procs):
            if deadline is None and any(
                    p.exitcode not in (None, 0) for p in procs):
                deadline = time.monotonic() + timeout_s + grace_s
            if deadline is not None and time.monotonic() > deadline:
                break
            for p in procs:
                p.join(timeout=0.05)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        codes = [p.exitcode for p in procs]
        if any(codes) or not os.path.exists(result):
            raise SpawnError(codes)
        with open(result, "rb") as f:
            return pickle.load(f)
    finally:
        sys.path[:] = saved
        cleanup()
        atexit.unregister(cleanup)


# -- the global view ---------------------------------------------------------

def _is_sharded(key: str, shape: tuple, per: int) -> bool:
    """The reference's `state_specs`: a leaf whose leading dim is the
    shard's host count shards on the mesh, as does every exchange-buffer
    leaf; the rest (scalars) are replicated."""
    return key.startswith("xchg.") or (len(shape) >= 1 and shape[0] == per)


def global_specs(state, mesh: Mesh) -> list[tuple[str, tuple, np.dtype]]:
    """(key, global shape, numpy dtype) of every leaf of the rank's
    state, in the reference's flatten order: the global view's layout."""
    from shadow_tpu_torch import convert

    per = state.queues.time.shape[0]
    out = []
    for key, t, u64 in convert.state_tensors(state):
        shape = tuple(t.shape)
        if _is_sharded(key, shape, per):
            shape = (shape[0] * mesh.size,) + shape[1:]
        out.append((key, shape, convert.numpy_dtype(t, u64)))
    return out


def gather_state(st, mesh: Mesh) -> dict[str, np.ndarray] | None:
    """The global view of a sharded state on rank 0: numpy leaves keyed
    by field path in the reference's flatten order (u64 leaves as
    uint64), as `convert.engine_state_to_numpy` gives an unsharded
    state's. Every rank must call it (one gather); None off rank 0."""
    from shadow_tpu_torch import convert

    per = st.queues.time.shape[0]
    items = convert.state_tensors(st)
    parts, layout = [], []
    for key, t, u64 in items:
        if _is_sharded(key, tuple(t.shape), per):
            t = t.detach().contiguous()
            layout.append((key, tuple(t.shape), convert.numpy_dtype(t, u64),
                           t.numel() * t.element_size()))
            parts.append(t.reshape(-1).view(torch.uint8))
    buf = (torch.cat(parts) if parts
           else torch.zeros((0,), dtype=torch.uint8, device=st.now.device))
    got = mesh.comm.gather(buf)
    if got is None:
        return None
    raws = [g.cpu().numpy() for g in got]
    sharded, off = {}, 0
    for key, shape, dtype, nbytes in layout:
        sharded[key] = np.concatenate(
            [r[off:off + nbytes].view(dtype).reshape(shape) for r in raws])
        off += nbytes
    out = {}
    for key, t, u64 in items:
        if key in sharded:
            out[key] = sharded[key]
        else:
            a = t.detach().cpu().numpy()
            out[key] = a.view(np.uint64) if u64 else a
    return out


def scatter_state(leaves: dict[str, np.ndarray], template, mesh: Mesh):
    """Rank `mesh.rank`'s shard of a global view (leaves keyed by field
    path, as `gather_state` gives them), shaped like `template` (the
    rank's own state, e.g. a Simulation's state0) and on its device.
    Per-host and exchange-buffer leaves take the rank's block of rows;
    replicated leaves are taken whole."""
    from shadow_tpu_torch import convert

    return convert.engine_state_from_numpy(
        convert.shard_leaves(leaves, mesh.rank, mesh.size),
        template.now.device, hosts=template.hosts)
