"""Container runtimes behind the shim (copied from
``kubegpu_tpu/crishim/runtime.py``).

The reference forwarded rewritten CRI calls to dockershim/containerd
(SURVEY.md §4.3); here the "real runtime" launches workload subprocesses
with the injected env — the port's programs consume the injection exactly
as a containerized workload would, on the cards the grant names.
"""

from __future__ import annotations

import os
import subprocess
import threading
from dataclasses import dataclass, field


@dataclass
class ContainerHandle:
    """One launched container.  :meth:`wait` and :meth:`kill` hold a lock
    of the handle's own, so a reaper and a killer never collect one
    process at once."""

    pod_name: str
    container_name: str
    env: dict[str, str]
    command: list[str]
    pid: int | None = None
    exit_code: int | None = None
    stdout: str = ""
    stderr: str = ""
    _proc: subprocess.Popen | None = field(default=None, repr=False)
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    def running(self) -> bool:
        """Liveness without collecting output (CRI ListContainers)."""
        if self.exit_code is not None:
            return False
        return self._proc is not None and self._proc.poll() is None

    def wait(self, timeout: float | None = None) -> int | None:
        with self._lock:
            return self._collect(timeout)

    def kill(self) -> None:
        """Kill the process first, then collect it."""
        with self._lock:
            if self._proc is not None and self._proc.poll() is None:
                self._proc.kill()
            self._collect(timeout=10)

    def _collect(self, timeout: float | None) -> int | None:
        if self._proc is None or self.exit_code is not None:
            return self.exit_code
        try:
            out, err = self._proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            return None
        except (OSError, ValueError):
            # an earlier communicate() was cut short (an exception raised
            # inside it) and left its pipes torn down: reap the process
            # without them and keep the output it had written
            try:
                self._proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                return None
            self.stdout, self.stderr = _salvage_output(self._proc)
        else:
            self.stdout, self.stderr = out, err
        self.exit_code = self._proc.returncode
        return self.exit_code


def _salvage_output(proc: subprocess.Popen) -> tuple[str, str]:
    """The output of a reaped process whose communicate() was cut short:
    the chunks that call had read (CPython's POSIX ``Popen`` keeps them in
    ``_fileobj2output`` for the next call), then what the pipes that are
    still open hold, read without blocking.  A pipe whose descriptor is
    gone gives only its chunks."""
    chunks = getattr(proc, "_fileobj2output", None) or {}
    texts = []
    for pipe in (proc.stdout, proc.stderr):
        data = b"".join(chunks.get(pipe, ())) if pipe is not None else b""
        if pipe is not None and not pipe.closed:
            try:
                fd = pipe.fileno()
                os.set_blocking(fd, False)
                while chunk := os.read(fd, 32768):
                    data += chunk
            except (OSError, ValueError):
                pass        # drained (EAGAIN) or the descriptor is gone
            try:
                pipe.close()
            except OSError:
                pass
        texts.append(data.decode(errors="replace")
                     .replace("\r\n", "\n").replace("\r", "\n"))
    return texts[0], texts[1]


class ContainerRuntime:
    """CRI RuntimeService equivalent (create/list/remove)."""

    def create_container(self, pod_name: str, container_name: str,
                         command: list[str],
                         env: dict[str, str]) -> ContainerHandle:
        raise NotImplementedError

    def containers(self) -> list[ContainerHandle]:
        raise NotImplementedError


class FakeRuntime(ContainerRuntime):
    """Records creations; never launches.  Exit code settable by tests."""

    def __init__(self) -> None:
        self.created: list[ContainerHandle] = []

    def create_container(self, pod_name, container_name, command, env):
        h = ContainerHandle(pod_name=pod_name, container_name=container_name,
                            env=dict(env), command=list(command), exit_code=0)
        self.created.append(h)
        return h

    def containers(self) -> list[ContainerHandle]:
        return list(self.created)


class SubprocessRuntime(ContainerRuntime):
    """Launches workload processes with the injected env.

    The child inherits a *minimal* base env (PATH, PYTHONPATH, HOME) plus
    the injection — mirroring a container's clean env — with optional
    ``extra_env`` for test plumbing.  A pod on an H100 node needs nothing
    more: PATH finds its python (and ``nvcc``, should it build a kernel),
    NVIDIA's libraries are on the loader's default path, and the
    kernels link the CUDA runtime statically.  The parent's
    ``CUDA_VISIBLE_DEVICES`` is never inherited: the grant's replaces it.
    """

    def __init__(self, extra_env: dict[str, str] | None = None,
                 inherit: tuple[str, ...] = ("PATH", "HOME", "PYTHONPATH",
                                             "TMPDIR", "LANG")):
        self.extra_env = extra_env or {}
        self.inherit = inherit
        self._lock = threading.Lock()
        self._containers: list[ContainerHandle] = []

    def create_container(self, pod_name, container_name, command, env):
        base = {k: os.environ[k] for k in self.inherit if k in os.environ}
        repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        base["PYTHONPATH"] = (
            repo_root + os.pathsep + base.get("PYTHONPATH", "")).rstrip(os.pathsep)
        full_env = {**base, **self.extra_env, **env}
        proc = subprocess.Popen(
            command, env=full_env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        h = ContainerHandle(pod_name=pod_name, container_name=container_name,
                            env=full_env, command=list(command),
                            pid=proc.pid, _proc=proc)
        with self._lock:
            self._containers.append(h)
        return h

    def containers(self) -> list[ContainerHandle]:
        with self._lock:
            return list(self._containers)
