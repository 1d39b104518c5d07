"""Build and ctypes bindings for the native shim runtime.

The counterpart of `shadow_tpu.proc.native`, over the same sources: the
runtime (`native/shim/shim_runtime.cpp`) and the libc interposer
(`native/interpose/interpose.c`), which both packages share unchanged.
They are compiled on demand with the system toolchain into
`build/shadow_tpu_torch/native/` beside the package, never into
`native/build/`. Every build writes a temporary name and moves it into
place with `os.replace`, so processes that build the same object at once
each load a whole file. A failed build raises.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

_REPO_ROOT = Path(__file__).resolve().parents[2]
_SHIM_DIR = str(_REPO_ROOT / "native" / "shim")
_INTERPOSE_DIR = str(_REPO_ROOT / "native" / "interpose")
BUILD_DIR = str(_REPO_ROOT / "build" / "shadow_tpu_torch" / "native")

REQ_LISTEN, REQ_CONNECT, REQ_SEND, REQ_CLOSE = 1, 2, 3, 4
REQ_SLEEP, REQ_EXIT, REQ_LOG, REQ_TIMER = 5, 6, 7, 8
REQ_UDP_BIND, REQ_SENDTO = 9, 10
COMP_CONNECT_OK, COMP_CONNECT_FAIL, COMP_ACCEPT, COMP_WAKE = 1, 2, 3, 4
COMP_TIMER = 5


class ShimReq(ctypes.Structure):
    _fields_ = [
        ("pid", ctypes.c_int32),
        ("op", ctypes.c_int32),
        ("fd", ctypes.c_int32),
        ("port", ctypes.c_int32),
        ("a0", ctypes.c_int64),
        ("a1", ctypes.c_int64),
        ("name", ctypes.c_char * 64),
    ]


class ShimComp(ctypes.Structure):
    _fields_ = [
        ("pid", ctypes.c_int32),
        ("op", ctypes.c_int32),
        ("fd", ctypes.c_int32),
        ("pad", ctypes.c_int32),
        ("r0", ctypes.c_int64),
    ]


# ASan + UBSan with leak checking, failing hard on any report. Only an
# executable can carry them: a sanitized DSO cannot load in a dlmopen
# namespace (the ASan runtime must come first in the initial library
# list), so `sanitizer_smoke` links the interposer into a sanitized
# executable instead.
SANITIZE_FLAGS = [
    "-fsanitize=address,undefined",
    "-fno-sanitize-recover=all",
    "-fno-omit-frame-pointer",
    "-g", "-O1",
]


def _fresh(out: str, deps: list[str]) -> bool:
    """Whether `out` exists and is no older than every dependency."""
    return os.path.exists(out) and all(
        os.path.getmtime(out) >= os.path.getmtime(d) for d in deps)


def _run_build(cmd_before_out: list[str], out: str, cmd_after_out: list[str],
               what: str) -> str:
    """Run one compile into a temporary name beside `out`, then move it
    into place; raise with the compiler's output on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [*cmd_before_out, "-o", tmp, *cmd_after_out]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"{what} failed:\n{' '.join(cmd)}\n{res.stderr}")
    os.replace(tmp, out)
    return out


def _compile(sources: list[str], out: str, extra: list[str],
             cc: str | None = None) -> str:
    if _fresh(out, sources):
        return out
    if cc is None:
        cc = "gcc" if all(s.endswith(".c") for s in sources) else "g++"
    return _run_build([cc, "-O2", "-fPIC", "-shared"], out,
                      [*sources, "-I", _SHIM_DIR, "-ldl", *extra],
                      "native build")


def build_runtime() -> str:
    """Compile (if stale) and return the runtime .so path."""
    return _compile([os.path.join(_SHIM_DIR, "shim_runtime.cpp")],
                    os.path.join(BUILD_DIR, "libshim_runtime.so"), [])


def build_interposer() -> str:
    """Compile (if stale) and return libshadow_interpose.so: the libc
    surface unmodified POSIX plugins link against."""
    return _compile([os.path.join(_INTERPOSE_DIR, "interpose.c")],
                    os.path.join(BUILD_DIR, "libshadow_interpose.so"), [])


def build_sanitizer_smoke() -> str:
    """Compile (if stale) interpose.c + asan_smoke.c into one sanitized
    executable. Linking the interposer into it makes its libc-shadowing
    definitions bind for the executable's direct calls, the
    resolution order a dlmopen namespace gives plugins, while the
    sanitizer runtime stays first in the initial library list."""
    sources = [os.path.join(_INTERPOSE_DIR, "interpose.c"),
               os.path.join(_INTERPOSE_DIR, "asan_smoke.c")]
    out = os.path.join(BUILD_DIR, "asan_smoke")
    if _fresh(out, sources):
        return out
    return _run_build(["gcc", *SANITIZE_FLAGS, "-D_GNU_SOURCE"], out,
                      [*sources, "-I", _SHIM_DIR, "-ldl"],
                      "sanitizer smoke build")


def sanitizer_smoke(timeout: float = 120.0) -> dict:
    """Build and run the sanitized interposer harness.

    Returns {"ok", "returncode", "stdout", "stderr", "exe"}; ok needs
    exit 0 and the ASAN_SMOKE_OK stamp (a sanitizer abort gives
    neither). Leak checking is on, so the reset paths must free what
    they allocate."""
    exe = build_sanitizer_smoke()
    env = dict(os.environ)
    env["ASAN_OPTIONS"] = "detect_leaks=1:abort_on_error=0:exitcode=23"
    env["UBSAN_OPTIONS"] = "halt_on_error=1:print_stacktrace=1"
    res = subprocess.run([exe], capture_output=True, text=True,
                         timeout=timeout, env=env)
    ok = res.returncode == 0 and "ASAN_SMOKE_OK" in res.stdout
    return {"ok": ok, "returncode": res.returncode,
            "stdout": res.stdout, "stderr": res.stderr, "exe": exe}


def compile_posix_plugin(
    source: str, name: str | None = None,
    include_dirs: list[str] | None = None,
    extra_sources: list[str] | None = None,
) -> str:
    """Compile an unmodified POSIX source (an ordinary `main`, plain libc
    socket/poll/epoll/select calls) into a plugin.

    The shared object links libshadow_interpose ahead of libc, so inside
    its dlmopen namespace every libc call it makes resolves to the
    interposer and runs against the simulated stack. The compat include
    dir supplies a minimal <glib.h>."""
    interposer = build_interposer()
    base = name or os.path.splitext(os.path.basename(source))[0]
    out = os.path.join(BUILD_DIR, f"lib{base}.so")
    srcs = [source] + list(extra_sources or [])
    if _fresh(out, srcs + [interposer]):
        return out
    cc = "g++" if source.endswith(("cc", "cpp")) else "gcc"
    return _run_build(
        [cc, "-O1", "-fPIC", "-shared", "-D_GNU_SOURCE"], out,
        [*srcs, "-I", os.path.join(_INTERPOSE_DIR, "compat"),
         *sum([["-I", d] for d in (include_dirs or [])], []),
         "-L", BUILD_DIR, "-lshadow_interpose",
         f"-Wl,-rpath,{BUILD_DIR}", "-Wl,--no-as-needed"],
        "posix plugin build")


def compile_plugin(source: str, name: str | None = None) -> str:
    """Compile a plugin .c/.cpp (exporting shim_main) into BUILD_DIR."""
    base = name or os.path.splitext(os.path.basename(source))[0]
    out = os.path.join(BUILD_DIR, f"lib{base}.so")
    if _fresh(out, [source]):
        return out
    cc = "g++" if source.endswith(("cc", "cpp")) else "gcc"
    return _run_build([cc, "-O2", "-fPIC", "-shared"], out,
                      [source, "-I", _SHIM_DIR], "plugin build")


# runtime instances created in this interpreter: a harness can tell
# whether it is the first tier in the process
N_RUNTIMES_CREATED = 0


class ShimRuntime:
    """ctypes wrapper over one runtime instance (a set of virtual
    processes sharing one pump cadence)."""

    def __init__(self, max_reqs: int = 4096):
        global N_RUNTIMES_CREATED
        N_RUNTIMES_CREATED += 1
        lib = ctypes.CDLL(build_runtime())
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.shim_init.restype = vp
        lib.shim_free.argtypes = [vp]
        lib.shim_last_error.argtypes = [vp]
        lib.shim_last_error.restype = ctypes.c_char_p
        lib.shim_spawn.argtypes = [vp, i32, ctypes.c_char_p,
                                   ctypes.c_char_p, i32]
        lib.shim_start.argtypes = [vp, i32]
        lib.shim_pump.argtypes = [vp, i64, ctypes.POINTER(ShimComp), i32,
                                  ctypes.POINTER(ShimReq), i32]
        lib.shim_wire_deliver.argtypes = [vp, i32, i32, i32, i32, i64]
        lib.shim_wire_deliver.restype = i64
        lib.shim_wire_fin.argtypes = [vp, i32, i32]
        lib.shim_udp_deliver.argtypes = [vp, i32, i32, i64, i32, i32,
                                         ctypes.c_uint32, i32]
        lib.shim_udp_deliver.restype = i64
        lib.shim_proc_exit_code.argtypes = [vp, i32,
                                            ctypes.POINTER(ctypes.c_int)]
        lib.shim_dns_add.argtypes = [vp, ctypes.c_char_p, ctypes.c_uint32]
        lib.shim_kill.argtypes = [vp, i32, i32]
        lib.shim_set_host_name.argtypes = [vp, i32, ctypes.c_char_p]
        lib.shim_set_seed.argtypes = [vp, i64]
        self._lib = lib
        self._rt = lib.shim_init()
        self._req_buf = (ShimReq * max_reqs)()
        self._max_reqs = max_reqs
        self._spawned: list[int] = []

    def close(self):
        if self._rt:
            self._lib.shim_free(self._rt)
            self._rt = None

    def spawn(self, host_gid: int, so_path: str, argv: list[str]) -> int:
        packed = b"\x00".join(a.encode() for a in argv) + b"\x00"
        pid = self._lib.shim_spawn(self._rt, host_gid, so_path.encode(),
                                   packed, len(argv))
        if pid < 0:
            raise RuntimeError(self._lib.shim_last_error(self._rt).decode())
        self._spawned.append(pid)
        return pid

    def live_pids(self) -> list[int]:
        """Pids the runtime still considers running: the green threads'
        own truth, which the watchdog's stall bundle records."""
        if not self._rt:
            return []
        return [p for p in self._spawned if self.exit_code(p) is None]

    def start(self, pid: int) -> None:
        self._lib.shim_start(self._rt, pid)

    def set_host_name(self, pid: int, name: str) -> None:
        """The virtual hostname gethostname/uname report."""
        self._lib.shim_set_host_name(self._rt, pid, name.encode())

    def set_seed(self, seed: int) -> None:
        """The seed every virtual process's rand()/urandom stream is
        derived from."""
        self._lib.shim_set_seed(self._rt, seed)

    def pump(self, now_ns: int, comps: list[tuple]) -> list[ShimReq]:
        """comps: [(pid, op, fd, r0[, pad])] -> the requests emitted."""
        carr = (ShimComp * max(len(comps), 1))()
        for i, c in enumerate(comps):
            pid, op, fd, r0 = c[:4]
            carr[i].pid, carr[i].op, carr[i].fd, carr[i].r0 = pid, op, fd, r0
            carr[i].pad = c[4] if len(c) > 4 else 0
        n = self._lib.shim_pump(self._rt, now_ns, carr, len(comps),
                                self._req_buf, self._max_reqs)
        return [self._req_buf[i] for i in range(n)]

    def wire_deliver(self, src_pid, src_fd, dst_pid, dst_fd, n) -> int:
        return int(self._lib.shim_wire_deliver(
            self._rt, src_pid, src_fd, dst_pid, dst_fd, n))

    def wire_fin(self, pid, fd) -> None:
        self._lib.shim_wire_fin(self._rt, pid, fd)

    def udp_deliver(self, src_pid, src_fd, seq, dst_pid, dst_fd,
                    src_ip, src_port) -> int:
        """Move one delivered datagram's payload from the sender's
        in-flight pool to the receiver's queue, stamped with its source
        address for recvfrom."""
        return int(self._lib.shim_udp_deliver(
            self._rt, src_pid, src_fd, seq, dst_pid, dst_fd, src_ip,
            src_port))

    def dns_add(self, name: str, ip: int) -> None:
        """One name -> virtual IPv4 (host order) mapping for the
        interposer's getaddrinfo."""
        self._lib.shim_dns_add(self._rt, name.encode(), ip)

    def kill(self, pid: int, exit_code: int = 0) -> None:
        """Stop a virtual process (a per-process stoptime)."""
        self._lib.shim_kill(self._rt, pid, exit_code)

    def exit_code(self, pid: int) -> int | None:
        done = ctypes.c_int(0)
        code = self._lib.shim_proc_exit_code(self._rt, pid,
                                             ctypes.byref(done))
        return int(code) if done.value else None
