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
    pod_name: str
    container_name: str
    env: dict[str, str]
    command: list[str]
    pid: int | None = None
    exit_code: int | None = None
    stdout: str = ""
    stderr: str = ""
    _proc: subprocess.Popen | None = field(default=None, repr=False)

    def running(self) -> bool:
        """Liveness without collecting output (CRI ListContainers)."""
        if self.exit_code is not None:
            return False
        return self._proc is not None and self._proc.poll() is None

    def wait(self, timeout: float | None = None) -> int | None:
        if self._proc is not None:
            try:
                out, err = self._proc.communicate(timeout=timeout)
                self.stdout, self.stderr = out, err
                self.exit_code = self._proc.returncode
            except subprocess.TimeoutExpired:
                return None
        return self.exit_code

    def kill(self) -> None:
        if self._proc is not None and self._proc.poll() is None:
            self._proc.kill()
            self.wait(timeout=10)


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
