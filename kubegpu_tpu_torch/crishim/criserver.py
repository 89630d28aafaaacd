"""CRI-shaped wire boundary for the shim — reference: SURVEY.md §4.3 (copied
from ``kubegpu_tpu/crishim/criserver.py``: the same frames and verbs; the
verbs inject through the port's shim, so a grant carries its cards by UUID).

The reference's crishim was a real gRPC server implementing the kubelet
CRI (``RuntimeService``/``ImageService``) on a unix socket; kubelet
never called the shim in-process.  This module restores that transport
seam in the simulated stack: a :class:`CriServer` listens on a unix
socket speaking length-prefixed JSON frames whose method names and
message shapes mirror the CRI RuntimeService (``Version``,
``CreateContainer``, ``StartContainer``, ``ContainerStatus``,
``StopContainer``, ``RemoveContainer``, ``ListContainers``) AND the
ImageService half (``PullImage``, ``ImageStatus``, ``ListImages``,
``RemoveImage``, ``ImageFsInfo``) on the same socket — the deployment
shape kubelet expects (one endpoint serving both services).  The image
store is per-node and passthrough-shaped: a pull registers the ref
under a deterministic digest (workload "images" here are the runtime
environment, not layer tarballs), and ``CreateContainer`` enforces
kubelet's pull-serialize contract — creating with an unpulled image is
an error, exactly as a real runtime reports ``image not found``.  A
:class:`RemoteCriShim` client gives
:class:`~kubegpu_tpu_torch.crishim.agent.NodeAgent` the same
``create_container(pod) -> handle`` seam it has with the in-process
:class:`~kubegpu_tpu_torch.crishim.shim.CriShim` — except every call
traverses the socket (pull → create → start), exactly as
kubelet→crishim did.

Wire format: 4-byte big-endian length prefix, then a UTF-8 JSON object
``{"method": str, "request": {...}}``; response frames are
``{"response": {...}}`` or ``{"error": str}``.  Connections are
persistent (many frames per connection), one server per node, mirroring
the one-crishim-per-node deployment of the reference.

Pod identity rides on the CRI container-config labels
(``io.kubernetes.pod.name`` / ``.namespace`` / ``.uid``) — the server
re-reads the Pod from the apiserver and verifies the uid, so a stale
kubelet asking for a dead incarnation gets an error instead of a
container wired to another pod's allocation (the same incarnation rule
the NodeAgent enforces in ``reconcile``).
"""

from __future__ import annotations

import hashlib
import json
import os
import socket
import socketserver
import struct
import tempfile
import threading
import time
import uuid

from kubegpu_tpu_torch.crishim.runtime import ContainerHandle, ContainerRuntime
from kubegpu_tpu_torch.crishim.shim import CriError, CriShim
from kubegpu_tpu_torch.kubemeta import FakeApiServer, NotFound, Pod
from kubegpu_tpu_torch.kubemeta.apiserver_http import POLL_S
from kubegpu_tpu_torch.obs import get_logger
from kubegpu_tpu_torch.tpuplugin.backend import DeviceBackend

log = get_logger("criserver")

RUNTIME_NAME = "kubetpu-crishim"
RUNTIME_API_VERSION = "v1"

# CRI ContainerState names (subset this runtime model can be in)
CONTAINER_RUNNING = "CONTAINER_RUNNING"
CONTAINER_EXITED = "CONTAINER_EXITED"

POD_NAME_LABEL = "io.kubernetes.pod.name"
POD_NAMESPACE_LABEL = "io.kubernetes.pod.namespace"
POD_UID_LABEL = "io.kubernetes.pod.uid"


# -- framing ------------------------------------------------------------

def send_frame(sock: socket.socket, obj: dict) -> None:
    body = json.dumps(obj).encode()
    sock.sendall(struct.pack(">I", len(body)) + body)


def recv_frame(sock: socket.socket) -> dict | None:
    """Read one frame; None on clean EOF at a frame boundary."""
    header = _recv_exact(sock, 4)
    if header is None:
        return None
    (n,) = struct.unpack(">I", header)
    body = _recv_exact(sock, n)
    if body is None:
        raise ConnectionError("socket closed mid-frame")
    return json.loads(body)


def _recv_exact(sock: socket.socket, n: int) -> bytes | None:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            if buf:
                raise ConnectionError("socket closed mid-frame")
            return None
        buf += chunk
    return buf


# -- server -------------------------------------------------------------

class CriVerbs:
    """The CRI verb core — RuntimeService + ImageService semantics for
    one node, transport-free.  :class:`CriServer` (length-prefixed JSON
    frames) and :class:`~kubegpu_tpu_torch.crishim.grpcserver.GrpcCriServer`
    (real gRPC, the reference's actual transport — SURVEY.md §2 L2)
    both dispatch into this object, so the two wire formats can never
    diverge semantically."""

    def __init__(self, api: FakeApiServer, backend: DeviceBackend,
                 node_name: str, runtime: ContainerRuntime,
                 socket_path: str | None = None):
        self.api = api
        self.node_name = node_name
        self.runtime = runtime
        self.shim = CriShim(api, backend, node_name, runtime)
        self._tmpdir: str | None = None
        if socket_path is None:
            # unix socket paths cap at ~107 bytes; mkdtemp under /tmp stays
            # far below it regardless of the test runner's cwd
            self._tmpdir = tempfile.mkdtemp(prefix="kubetpu-cri-")
            socket_path = os.path.join(self._tmpdir, "cri.sock")
        self.socket_path = socket_path
        self._handles: dict[str, ContainerHandle] = {}
        # ImageService store: ref → image record (per-node, like a
        # node's containerd image store)
        self._images: dict[str, dict] = {}
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None

    # -- verbs ----------------------------------------------------------

    def _dispatch(self, method: str, request: dict) -> dict:
        handler = getattr(self, f"_verb_{method}", None)
        if handler is None:
            raise CriError(f"unknown method {method!r}")
        return handler(request)

    def _verb_Version(self, request: dict) -> dict:
        return {
            "runtime_name": RUNTIME_NAME,
            "runtime_api_version": RUNTIME_API_VERSION,
            "node_name": self.node_name,
        }

    def _verb_CreateContainer(self, request: dict) -> dict:
        config = request.get("config") or {}
        labels = config.get("labels") or {}
        pod_name = labels.get(POD_NAME_LABEL)
        namespace = labels.get(POD_NAMESPACE_LABEL, "default")
        uid = labels.get(POD_UID_LABEL)
        if not pod_name:
            raise CriError(f"config.labels missing {POD_NAME_LABEL}")
        # The reference's crishim fetched the pod (annotation) from the
        # apiserver at CreateContainer time — same here; the wire request
        # carries identity, not the allocation.
        try:
            pod: Pod = self.api.get("Pod", pod_name, namespace=namespace)
        except NotFound:
            raise CriError(f"pod {namespace}/{pod_name} not found") from None
        if uid and pod.metadata.uid != uid:
            raise CriError(
                f"pod {namespace}/{pod_name} uid mismatch: have "
                f"{pod.metadata.uid}, caller expects {uid} (stale incarnation)")
        container_name = (config.get("metadata") or {}).get("name")
        index = 0
        if container_name:
            names = [c.name for c in pod.spec.containers]
            if container_name not in names:
                raise CriError(
                    f"pod {pod_name} has no container {container_name!r}")
            index = names.index(container_name)
        # kubelet's pull-serialize contract: the image the container
        # will actually RUN (the pod spec's — what the shim consumes)
        # must be present before create; a differing client-supplied
        # config ref is a stale-manifest error, not a loophole
        ref = pod.spec.containers[index].image
        cfg_ref = (config.get("image") or {}).get("image")
        if cfg_ref and cfg_ref != ref:
            raise CriError(
                f"config image {cfg_ref!r} != pod spec image {ref!r}")
        with self._lock:
            present = ref in self._images
        if not present:
            raise CriError(
                f"image {ref!r} not present on node (PullImage first)")
        handle = self.shim.create_container(pod, container_index=index)
        container_id = uuid.uuid4().hex[:16]
        with self._lock:
            self._handles[container_id] = handle
        # info: CRI-style verbose map — the rewritten env, so callers
        # (and tests) can observe the injection without reaching into the
        # server process
        return {"container_id": container_id,
                "info": {"env": handle.env, "pid": handle.pid}}

    def _verb_StartContainer(self, request: dict) -> dict:
        # our runtimes launch at create time; the verb exists so callers
        # can speak the kubelet's create→start sequence unchanged
        self._handle_of(request)
        return {}

    def _verb_ContainerStatus(self, request: dict) -> dict:
        handle = self._handle_of(request)
        code = handle.wait(timeout=0.05)
        if code is None:
            state, info = CONTAINER_RUNNING, {}
        else:
            # exited: ship the collected output so the caller can harvest
            # workload metric lines (info mirrors CRI's verbose-info map)
            state = CONTAINER_EXITED
            info = {"stdout": handle.stdout, "stderr": handle.stderr}
        return {
            "status": {
                "id": request.get("container_id"),
                "metadata": {"name": handle.container_name},
                "state": state,
                "exit_code": code if code is not None else 0,
            },
            "info": info,
        }

    def _verb_StopContainer(self, request: dict) -> dict:
        self._handle_of(request).kill()
        return {}

    def _verb_RemoveContainer(self, request: dict) -> dict:
        cid = str(request.get("container_id") or "")
        with self._lock:
            handle = self._handles.pop(cid, None)
        if handle is not None and handle.exit_code is None:
            handle.kill()
        return {}

    def _verb_ListContainers(self, request: dict) -> dict:
        with self._lock:
            items = list(self._handles.items())
        out = []
        for cid, h in items:
            running = h.running()
            out.append({
                "id": cid,
                "metadata": {"name": h.container_name},
                "labels": {POD_NAME_LABEL: h.pod_name},
                "state": CONTAINER_RUNNING if running else CONTAINER_EXITED,
            })
        return {"containers": out}

    # -- ImageService verbs (same socket, kubelet's expected shape) ------

    @staticmethod
    def _image_ref(request: dict) -> str:
        ref = ((request.get("image") or {}).get("image") or "").strip()
        if not ref:
            raise CriError("empty image reference")
        return ref

    def _verb_PullImage(self, request: dict) -> dict:
        """Passthrough pull: register the ref under a deterministic
        digest.  Idempotent (a re-pull refreshes nothing — refs are
        content-stable here, as with tag-pinned digests)."""
        ref = self._image_ref(request)
        digest = "sha256:" + hashlib.sha256(ref.encode()).hexdigest()
        # strip an existing digest first ('app@sha256:…' keeps ':' in its
        # last path segment, which fooled the tag check), then
        # strip only a TAG (colon after the last '/'): a plain split(':')
        # would truncate registry-port refs like registry:5000/app:v1
        base = ref.split("@", 1)[0]
        repo = (base.rsplit(":", 1)[0]
                if ":" in base.rsplit("/", 1)[-1] else base)
        with self._lock:
            self._images.setdefault(ref, {
                "id": digest,
                "repo_tags": [ref],
                "repo_digests": [f"{repo}@{digest}"],
                # deterministic pseudo-size so ImageFsInfo sums move
                "size": int.from_bytes(
                    digest.encode()[7:11], "big") % (1 << 28),
                "pulled_at": time.time(),
            })
        log.info("pull_image", image=ref, node=self.node_name)
        return {"image_ref": digest}

    def _verb_ImageStatus(self, request: dict) -> dict:
        ref = self._image_ref(request)
        with self._lock:
            img = self._images.get(ref)
        if img is None:
            return {"image": None}   # CRI: absent image → null, not error
        return {"image": {k: img[k] for k in
                          ("id", "repo_tags", "repo_digests", "size")}}

    def _verb_ListImages(self, request: dict) -> dict:
        want = ((request.get("filter") or {}).get("image") or {}).get(
            "image")
        with self._lock:
            items = list(self._images.items())
        return {"images": [
            {k: img[k] for k in ("id", "repo_tags", "repo_digests",
                                 "size")}
            for ref, img in items if not want or ref == want]}

    def _verb_RemoveImage(self, request: dict) -> dict:
        ref = self._image_ref(request)
        with self._lock:
            self._images.pop(ref, None)   # CRI: remove is idempotent
        return {}

    def _verb_ImageFsInfo(self, request: dict) -> dict:
        with self._lock:
            used = sum(img["size"] for img in self._images.values())
            count = len(self._images)
        return {"image_filesystems": [{
            "timestamp": int(time.time() * 1e9),
            "fs_id": {"mountpoint": tempfile.gettempdir()},
            "used_bytes": {"value": used},
            "inodes_used": {"value": count},
        }]}

    def _handle_of(self, request: dict) -> ContainerHandle:
        cid = str(request.get("container_id") or "")
        with self._lock:
            handle = self._handles.get(cid)
        if handle is None:
            raise CriError(f"no such container {cid!r}")
        return handle

    def _cleanup_socket(self) -> None:
        try:
            os.unlink(self.socket_path)
        except OSError:
            pass
        if self._tmpdir is not None:
            try:
                os.rmdir(self._tmpdir)
            except OSError:
                pass


class CriServer(CriVerbs):
    """RuntimeService-shaped server fronting the injection shim + the
    real runtime for one node, speaking length-prefixed JSON frames.
    ``start()`` binds the unix socket and serves in a daemon thread;
    ``close()`` shuts down and unlinks."""

    def __init__(self, api: FakeApiServer, backend: DeviceBackend,
                 node_name: str, runtime: ContainerRuntime,
                 socket_path: str | None = None):
        super().__init__(api, backend, node_name, runtime, socket_path)

        dispatch = self._dispatch

        class Handler(socketserver.BaseRequestHandler):
            def handle(self) -> None:
                while True:
                    try:
                        frame = recv_frame(self.request)
                    except (ConnectionError, OSError):
                        return
                    if frame is None:
                        return
                    try:
                        out = dispatch(str(frame.get("method", "")),
                                       frame.get("request") or {})
                        reply = {"response": out}
                    except Exception as e:  # carried in-band, conn survives
                        reply = {"error": f"{type(e).__name__}: {e}"}
                    try:
                        send_frame(self.request, reply)
                    except (ConnectionError, OSError):
                        return

        class Server(socketserver.ThreadingUnixStreamServer):
            daemon_threads = True
            allow_reuse_address = True

        self._server = Server(self.socket_path, Handler)

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "CriServer":
        self._thread = threading.Thread(
            target=self._server.serve_forever, args=(POLL_S,), daemon=True)
        self._thread.start()
        log.info("listening", socket=self.socket_path, node=self.node_name)
        return self

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._cleanup_socket()



# -- client -------------------------------------------------------------

class CriClient:
    """Thread-safe frame client: one persistent connection, calls
    serialized (the CRI is request/response; kubelet holds few conns)."""

    def __init__(self, socket_path: str, connect_timeout: float = 5.0):
        self.socket_path = socket_path
        self._lock = threading.Lock()
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        deadline = time.monotonic() + connect_timeout
        while True:
            try:
                self._sock.connect(socket_path)
                break
            except (FileNotFoundError, ConnectionRefusedError):
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.02)

    def call(self, method: str, request: dict | None = None) -> dict:
        with self._lock:
            send_frame(self._sock, {"method": method,
                                    "request": request or {}})
            reply = recv_frame(self._sock)
        if reply is None:
            raise ConnectionError("CRI server closed the connection")
        if "error" in reply:
            raise CriError(reply["error"])
        return reply.get("response") or {}

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


class RemoteContainerHandle:
    """Client-side view of a container: the same wait/kill/stdout surface
    :class:`ContainerHandle` has, implemented via ContainerStatus /
    StopContainer RPCs.  Once the exit is observed the result is cached
    locally and the server-side entry is removed."""

    def __init__(self, client: CriClient, container_id: str,
                 pod_name: str, container_name: str,
                 env: dict[str, str] | None = None, pid: int | None = None):
        self._client = client
        self.container_id = container_id
        self.pod_name = pod_name
        self.container_name = container_name
        self.exit_code: int | None = None
        self.stdout: str = ""
        self.stderr: str = ""
        self.env = dict(env or {})  # the injected env, from create info
        self.pid = pid

    def wait(self, timeout: float | None = None) -> int | None:
        if self.exit_code is not None:
            return self.exit_code
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            out = self._client.call(
                "ContainerStatus", {"container_id": self.container_id})
            if out["status"]["state"] == CONTAINER_EXITED:
                self.exit_code = int(out["status"]["exit_code"])
                info = out.get("info") or {}
                self.stdout = info.get("stdout", "")
                self.stderr = info.get("stderr", "")
                self._client.call(
                    "RemoveContainer", {"container_id": self.container_id})
                return self.exit_code
            if deadline is not None and time.monotonic() >= deadline:
                return None
            time.sleep(0.02)

    def kill(self) -> None:
        if self.exit_code is not None:
            return
        try:
            self._client.call(
                "StopContainer", {"container_id": self.container_id})
            self.wait(timeout=10)
        except (CriError, ConnectionError):
            pass  # already removed / server gone — nothing left to stop


class RemoteCriShim:
    """Drop-in for :class:`CriShim` that traverses the unix socket: what
    the NodeAgent uses when the shim runs as a separate service (the
    reference's actual deployment shape)."""

    def __init__(self, socket_path: str):
        self.client = CriClient(socket_path)
        self.runtime_name = self.client.call("Version")["runtime_name"]

    def create_container(self, pod: Pod,
                         container_index: int = 0) -> RemoteContainerHandle:
        spec = pod.spec.containers[container_index]
        # kubelet's sequence: EnsureImageExists (PullImage) → create →
        # start — the create verb refuses unpulled images
        self.client.call("PullImage", {"image": {"image": spec.image}})
        out = self.client.call("CreateContainer", {
            "config": {
                "metadata": {"name": spec.name},
                "image": {"image": spec.image},
                "labels": {
                    POD_NAME_LABEL: pod.name,
                    POD_NAMESPACE_LABEL: pod.metadata.namespace,
                    POD_UID_LABEL: pod.metadata.uid,
                },
            },
        })
        cid = out["container_id"]
        self.client.call("StartContainer", {"container_id": cid})
        info = out.get("info") or {}
        return RemoteContainerHandle(self.client, cid, pod.name, spec.name,
                                     env=info.get("env"),
                                     pid=info.get("pid"))

    def close(self) -> None:
        self.client.close()
