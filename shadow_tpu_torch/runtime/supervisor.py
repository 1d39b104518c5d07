"""Watchdog + graceful-shutdown supervision for the simulator's process: the
counterpart of `shadow_tpu.runtime.supervisor`.

The run loop's blocking site, the window loop on the card (a kernel that
never finishes, a device that stops answering), hangs the whole run
with no diagnosis: the outer `timeout -k` kills the process long after
the fact and the stacks are gone. The Watchdog turns that into a
bounded, diagnosable failure; the Supervisor turns SIGTERM/SIGINT from
run-killers into checkpoint-then-exit requests.

The Watchdog's compile grace waves through the one benign unbounded
wait of this package: the first-use `nvcc` build of a kernel library
(`core/nvcc.py`), which can take minutes. The supervised run's
watchdog has the grace on, so a short `--watchdog` does not fire while
a kernel compiles.

Free of torch imports: supervision must keep working when the thing it
supervises is the part that broke. `run_with_retry` (`--retry`) runs
the simulator as a child process and relaunches it from its newest
checkpoint after a transient failure.
"""

from __future__ import annotations

import faulthandler
import json
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Any, Callable

# Distinct exit codes so wrappers (sbatch scripts, k8s restart policies,
# the test harness) can tell failure classes apart without parsing logs.
# 75 = EX_TEMPFAIL (retryable: the run stalled, a resubmit may succeed),
# 70 = EX_SOFTWARE (internal state corruption; do NOT blindly resume),
# 76 = EX_PROTOCOL-adjacent (queue pressure under --overflow strict: the
#      run is healthy but its results would be lossy; rerun with a larger
#      --capacity or a lossless overflow mode),
# 77 = a collective deadline expired (a mesh peer died or wedged mid
#      collective; retryable on a smaller mesh from the newest
#      checkpoint). The port runs on one device; the code is kept so
#      that both packages name their exits alike.
EXIT_STALL = 75
EXIT_INVARIANT = 70
EXIT_PRESSURE = 76
EXIT_PEER_LOST = 77

# Exit statuses a relaunching wrapper treats as transient: the two
# deadline aborts above, plus any signal death (SIGKILL by the OOM
# killer or a preemption, SIGTERM from a scheduler — Popen reports those
# as -N).
RETRYABLE_EXITS = frozenset({EXIT_STALL, EXIT_PEER_LOST})


def exit_retryable(rc: int) -> bool:
    return rc in RETRYABLE_EXITS or rc < 0 or rc in (
        signal_exit_code(signal.SIGKILL), signal_exit_code(signal.SIGTERM))


def signal_exit_code(signum: int) -> int:
    """Shell convention: a signal-terminated process exits 128+N."""
    return 128 + int(signum)


def write_diagnostic_bundle(diag_dir: str, label: str, kind: str,
                            payload: dict) -> str:
    """Write a `<label>.<kind>.<pid>.json` diagnostic bundle — the same
    artifact shape the Watchdog leaves on a stall, reusable by any
    abnormal-exit path (the queue-pressure strict mode uses it so a
    `--overflow strict` abort is diagnosable from disk alone)."""
    pid = os.getpid()
    os.makedirs(diag_dir, exist_ok=True)
    path = os.path.join(diag_dir, f"{label}.{kind}.{pid}.json")
    with open(path, "w") as f:
        json.dump({"pid": pid, **payload}, f, indent=2, default=str)
        f.write("\n")
    return path


class Watchdog:
    """Per-window wall-clock deadline over the run loop.

    The loop calls `pet(**progress)` once per window boundary; a
    background thread fires when no pet arrives within `timeout_s`.
    Firing writes two files into `diag_dir` —

      <label>.stall.<pid>.stacks.txt   every thread's Python stack
                                       (faulthandler, so it works even
                                       while the main thread is stuck
                                       inside a device call)
      <label>.stall.<pid>.json         the diagnostic bundle: last
                                       progress the loop reported
                                       (frontier time, window number),
                                       stall duration, plus whatever
                                       the `info` callable adds

    — then aborts the process with `exit_code` via os._exit: the main
    thread is, by definition of a stall, not going to run `sys.exit`.
    """

    def __init__(self, timeout_s: float, *, diag_dir: str = ".",
                 label: str = "shadow_tpu",
                 info: Callable[[], dict] | None = None,
                 exit_code: int = EXIT_STALL,
                 kind: str = "stall",
                 compile_grace: bool = False,
                 _exit: Callable[[int], Any] = os._exit,
                 _stream=None):
        if timeout_s <= 0:
            raise ValueError(f"watchdog timeout must be > 0, got {timeout_s}")
        self.timeout_s = float(timeout_s)
        self.diag_dir = diag_dir
        self.label = label
        self.exit_code = exit_code
        # bundle-file kind: "stall" for the classic per-window deadline,
        # "peerlost" for the collective deadline — distinct names so one
        # run can leave both without clobbering
        self.kind = kind
        # a deadline must not count a kernel's first-use nvcc build: it
        # blocks the main thread for up to minutes with nothing wrong.
        # With compile_grace the expiry check inspects the main thread's
        # Python stack and re-arms instead of firing while it shows the
        # build (core/nvcc.py); a wedged window never blocks there.
        self.compile_grace = bool(compile_grace)
        self.compile_graces = 0
        self._info = info
        self._exit = _exit  # injectable so unit tests survive a firing
        self._stream = _stream  # defaults to sys.stderr at fire time
        self._lock = threading.Lock()
        self._last_pet = time.monotonic()
        self._progress: dict = {}
        self._n_pets = 0
        self._armed = True
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.fired = False

    # ------------------------------------------------------------ control
    def start(self) -> "Watchdog":
        with self._lock:
            self._last_pet = time.monotonic()
        self._thread = threading.Thread(
            target=self._loop, name=f"{self.label}-watchdog", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def pet(self, **progress) -> None:
        """Report liveness + the latest progress snapshot (kept for the
        diagnostic bundle, so a later stall names the last good window)."""
        with self._lock:
            self._last_pet = time.monotonic()
            self._n_pets += 1
            if progress:
                self._progress.update(progress)

    def arm(self) -> None:
        """(Re-)enable the deadline with a fresh clock. A resident
        process (the serving plane) keeps ONE watchdog for its lifetime
        and arms it per launch — a watchdog per launch would leak a
        thread each batch."""
        with self._lock:
            self._last_pet = time.monotonic()
            self._armed = True

    def disarm(self) -> None:
        """Suspend the deadline: idle time between launches must not
        fire. The thread keeps polling; `arm()` re-enables it with a
        fresh clock."""
        with self._lock:
            self._armed = False

    def margin_s(self) -> float:
        """Seconds of deadline left before the next firing — the
        supervisor heartbeat's stall-margin column."""
        with self._lock:
            return self.timeout_s - (time.monotonic() - self._last_pet)

    # ------------------------------------------------------------- firing
    def _main_thread_compiling(self) -> bool:
        """True when a thread's stack shows the kernel build of
        `core/nvcc.py` (the main thread's, or the serving plane's launch
        worker's): the benign unbounded-wall-time case a deadline waves
        through (see compile_grace)."""
        try:
            frames = list(sys._current_frames().values())
        except Exception:
            return False
        for frame in frames:
            while frame is not None:
                fn = frame.f_code.co_filename.replace(os.sep, "/")
                if fn.endswith("/shadow_tpu_torch/core/nvcc.py"):
                    return True
                frame = frame.f_back
        return False

    def _loop(self) -> None:
        poll = min(1.0, max(self.timeout_s / 4.0, 0.05))
        while not self._stop.wait(poll):
            with self._lock:
                if not self._armed:
                    continue
                stalled_for = time.monotonic() - self._last_pet
            if stalled_for > self.timeout_s:
                if self.compile_grace and self._main_thread_compiling():
                    with self._lock:
                        self._last_pet = time.monotonic()
                        self.compile_graces += 1
                    print(
                        f"{self.label}: {self.kind} deadline extended — "
                        f"main thread is compiling "
                        f"(grace {self.compile_graces})",
                        file=self._stream or sys.stderr, flush=True,
                    )
                    continue
                self._fire(stalled_for)
                return

    def _fire(self, stalled_for: float) -> None:
        self.fired = True
        pid = os.getpid()
        base = os.path.join(self.diag_dir, f"{self.label}.{self.kind}.{pid}")
        stream = self._stream or sys.stderr
        try:
            os.makedirs(self.diag_dir, exist_ok=True)
            with open(base + ".stacks.txt", "wb") as f:
                faulthandler.dump_traceback(file=f, all_threads=True)
            extra = {}
            if self._info is not None:
                try:
                    extra = dict(self._info())
                except Exception as e:  # the info source may be broken
                    extra = {"info_error": repr(e)}
            with self._lock:
                progress = dict(self._progress)
                n_pets = self._n_pets
            bundle = {
                "reason": (
                    "watchdog: no window progress within deadline"
                    if self.kind == "stall" else
                    f"watchdog: {self.kind} deadline expired"
                ),
                "timeout_s": self.timeout_s,
                "stalled_for_s": round(stalled_for, 3),
                "windows_reported": n_pets,
                "compile_graces": self.compile_graces,
                "progress": progress,
                "pid": pid,
                "exit_code": self.exit_code,
                **extra,
            }
            with open(base + ".json", "w") as f:
                json.dump(bundle, f, indent=2, default=str)
                f.write("\n")
            print(
                f"{self.label}: STALL — no window progress for "
                f"{stalled_for:.1f}s (deadline {self.timeout_s:.1f}s); "
                f"diagnostics at {base}.json / {base}.stacks.txt; "
                f"aborting with exit code {self.exit_code}",
                file=stream, flush=True,
            )
        except Exception:  # diagnosis must never block the abort
            pass
        self._exit(self.exit_code)


class Supervisor:
    """Signal-aware wrapper for a run loop (a context manager).

    Inside the `with` block:

    - SIGINT / SIGTERM set `stop_requested`; the loop finishes its
      current window batch, writes a checkpoint, and exits with the
      shell-conventional 128+signum. A SECOND signal of the same kind
      gets the default disposition back — two Ctrl-Cs still kill a
      wedged run immediately.
    - SIGUSR1 sets a one-shot on-demand-checkpoint request, drained
      with `take_checkpoint_request()`.
    - with `watchdog_timeout > 0`, a Watchdog enforces the per-window
      wall deadline; the loop must call `pet(**progress)` each window.
      It has the compile grace on: a first-use kernel build does not
      count against the deadline.

    Handlers are only installed from the main thread (Python's rule);
    elsewhere the supervisor degrades to a plain watchdog holder.
    """

    _STOP_SIGNALS = (signal.SIGINT, signal.SIGTERM)

    def __init__(self, *, watchdog_timeout: float = 0.0,
                 diag_dir: str = ".", label: str = "shadow_tpu",
                 info: Callable[[], dict] | None = None,
                 install_signals: bool = True):
        self.watchdog = (
            Watchdog(watchdog_timeout, diag_dir=diag_dir, label=label,
                     info=info, compile_grace=True)
            if watchdog_timeout > 0 else None
        )
        self.label = label
        self.stop_signum: int | None = None
        self._drained = False
        self._ckpt_requested = False
        self._install_signals = install_signals
        self._saved: dict[int, Any] = {}

    # ----------------------------------------------------------- lifecycle
    def __enter__(self) -> "Supervisor":
        if self._install_signals and (
            threading.current_thread() is threading.main_thread()
        ):
            for sig in self._STOP_SIGNALS:
                self._saved[sig] = signal.signal(sig, self._on_stop)
            if hasattr(signal, "SIGUSR1"):
                self._saved[signal.SIGUSR1] = signal.signal(
                    signal.SIGUSR1, self._on_usr1
                )
        if self.watchdog is not None:
            self.watchdog.start()
        return self

    def __exit__(self, *exc) -> None:
        if self.watchdog is not None:
            self.watchdog.stop()
        for sig, old in self._saved.items():
            try:
                signal.signal(sig, old)
            except (ValueError, OSError):  # not main thread / torn down
                pass
        self._saved.clear()
        return None

    # ------------------------------------------------------------- signals
    def _on_stop(self, signum, frame) -> None:
        self.stop_signum = signum
        # restore the default disposition: the next signal of this kind
        # must kill the process outright, not queue a second request —
        # graceful shutdown may itself be the thing that's stuck
        try:
            signal.signal(signum, signal.SIG_DFL)
        except (ValueError, OSError):
            pass
        print(
            f"{self.label}: received signal {signum}, will checkpoint and "
            "exit at the next window boundary (send again to kill now)",
            file=sys.stderr, flush=True,
        )

    def _on_usr1(self, signum, frame) -> None:
        self._ckpt_requested = True

    # --------------------------------------------------------------- query
    @property
    def stop_requested(self) -> bool:
        return self.stop_signum is not None

    def mark_drained(self) -> None:
        """Record that the stop signal was honored with a COMPLETE
        graceful drain (in-flight work finished, queue persisted):
        `exit_code()` then reports success (0) instead of 128+signum.
        Batch runs keep the shell convention (an interrupted run is
        interrupted, even when it checkpointed cleanly); for the
        resident service SIGTERM is the normal shutdown path, so a
        completed drain is a success its orchestrator must not retry."""
        self._drained = True

    def exit_code(self) -> int:
        """128+signum once a stop was requested (0 otherwise; also 0
        after `mark_drained`, a completed graceful drain)."""
        if not self.stop_requested or self._drained:
            return 0
        return signal_exit_code(self.stop_signum)

    def take_checkpoint_request(self) -> bool:
        """Drain the one-shot SIGUSR1 checkpoint request."""
        req, self._ckpt_requested = self._ckpt_requested, False
        return req

    def pet(self, **progress) -> None:
        if self.watchdog is not None:
            self.watchdog.pet(**progress)

    def margin_s(self) -> float | None:
        return self.watchdog.margin_s() if self.watchdog is not None else None


# --------------------------------------------------------------- retry loop
def next_retry_argv(argv: list[str], rc: int, *, mesh_flag: str = "--mesh",
                    shrink: bool = False) -> list[str]:
    """The relaunch command for a failed worker: `--resume auto-if-any`
    added (the newest valid checkpoint when there is one, a fresh start
    when the worker died before its first) and, with `shrink` (a lost
    peer), the mesh halved. A `serve` worker resumes through its own
    snapshot flags, which ride along untouched, and halves
    `--max-lanes` instead."""
    argv = list(argv)
    if "serve" in argv:
        mesh_flag = "--max-lanes"
    elif "--resume" not in argv and not any(
            a.startswith("--resume=") for a in argv):
        argv += ["--resume", "auto-if-any"]
    if shrink:
        for i, a in enumerate(argv):
            if a == mesh_flag and i + 1 < len(argv):
                argv[i + 1] = str(max(1, int(argv[i + 1]) // 2))
                break
            if a.startswith(mesh_flag + "="):
                argv[i] = (
                    f"{mesh_flag}={max(1, int(a.split('=', 1)[1]) // 2)}")
                break
    return argv


def run_with_retry(argv: list[str], *, retries: int,
                   backoff_s: float = 1.0, mesh_flag: str = "--mesh",
                   on_spawn: Callable[[Any], None] | None = None,
                   _sleep: Callable[[float], None] = time.sleep,
                   _popen: Callable[..., Any] = subprocess.Popen) -> dict:
    """Supervise `argv` as a subprocess, relaunching it from the newest
    valid checkpoint after transient failures (`--retry N`).

    Each attempt runs in its own session, so that after an abnormal exit
    one `killpg(SIGKILL)` reaps whatever it left behind. Retryable exits
    are `exit_retryable`'s: stall (75), peer-lost (77, which also halves
    `--mesh`) and signal deaths. The backoff doubles: backoff_s,
    2 * backoff_s, ... While a child lives, SIGTERM, SIGINT and SIGHUP
    are forwarded to its process group, and the supervisor waits for the
    child's own exit.

    Returns a report: attempts, recoveries, exit_code (the last
    attempt's), exit_history, and mttr_s (per recovery, seconds from the
    failure to the replacement's first stderr output, or its exit when
    it stays silent). `on_spawn(proc)` is called per attempt.
    """
    report: dict = {"attempts": 0, "recoveries": 0, "exit_code": None,
                    "exit_history": [], "mttr_s": []}
    argv = list(argv)
    current: list = [None]  # the live child, for the signal forwarders

    def _forward(signum, frame):
        proc = current[0]
        if proc is not None and proc.poll() is None:
            try:
                os.killpg(proc.pid, signum)
            except (ProcessLookupError, PermissionError, OSError):
                pass

    old_handlers: dict = {}
    for signum in (signal.SIGTERM, signal.SIGINT, signal.SIGHUP):
        try:
            old_handlers[signum] = signal.signal(signum, _forward)
        except (ValueError, OSError):  # not the main thread
            pass
    try:
        return _retry_loop(argv, report, current, retries=retries,
                           backoff_s=backoff_s, mesh_flag=mesh_flag,
                           on_spawn=on_spawn, _sleep=_sleep, _popen=_popen)
    finally:
        for signum, handler in old_handlers.items():
            try:
                signal.signal(signum, handler)
            except (ValueError, OSError):
                pass


def _retry_loop(argv: list[str], report: dict, current: list, *,
                retries: int, backoff_s: float, mesh_flag: str, on_spawn,
                _sleep, _popen) -> dict:
    fail_t: float | None = None
    for attempt in range(retries + 1):
        report["attempts"] += 1
        first_out: list = [None]
        # a relaunched child's /healthz reports degraded
        env = None
        if attempt > 0:
            env = dict(os.environ)
            env["SHADOW_TPU_RETRY_ATTEMPT"] = str(attempt)
        proc = _popen(argv, start_new_session=True, stderr=subprocess.PIPE,
                      env=env)
        current[0] = proc

        def _tee(stream, mark):
            for line in iter(stream.readline, b""):
                if mark[0] is None:
                    mark[0] = time.monotonic()
                sys.stderr.buffer.write(line)
                sys.stderr.flush()

        tee = None
        if proc.stderr is not None:
            tee = threading.Thread(
                target=_tee, args=(proc.stderr, first_out), daemon=True)
            tee.start()
        if on_spawn is not None:
            on_spawn(proc)
        rc = proc.wait()
        current[0] = None
        if tee is not None:
            tee.join(timeout=5.0)
        if fail_t is not None:
            alive_t = first_out[0] if first_out[0] is not None \
                else time.monotonic()
            report["mttr_s"].append(round(alive_t - fail_t, 3))
        report["exit_history"].append(rc)
        if rc == 0 or not exit_retryable(rc) or attempt == retries:
            report["exit_code"] = rc
            return report
        fail_t = time.monotonic()
        # reap the dead worker's whole process group before relaunching
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError, OSError):
            pass
        report["recoveries"] += 1
        argv = next_retry_argv(argv, rc, mesh_flag=mesh_flag,
                               shrink=(rc == EXIT_PEER_LOST))
        print(
            f"shadow_tpu_torch: attempt {attempt + 1} exited {rc} "
            f"(retryable); relaunching in {backoff_s * (2 ** attempt):.1f}s: "
            f"{' '.join(argv)}",
            file=sys.stderr, flush=True,
        )
        _sleep(backoff_s * (2 ** attempt))
    return report  # unreachable: the last attempt returns
