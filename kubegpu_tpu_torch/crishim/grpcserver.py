"""Real gRPC CRI endpoint — the reference's actual transport (copied from
``kubegpu_tpu/crishim/grpcserver.py``).

The reference's crishim was "a real gRPC server implementing the
kubelet CRI" (SURVEY.md §2 L2, §4.3); :mod:`.criserver` speaks
length-prefixed JSON frames with CRI method names.  This module puts a
genuine gRPC server (grpcio, HTTP/2 over a unix socket) in front of the
same :class:`~kubegpu_tpu_torch.crishim.criserver.CriVerbs` core, exposing
the kubelet CRI's service/method names:

    /runtime.v1.RuntimeService/{Version, CreateContainer,
        StartContainer, StopContainer, RemoveContainer, ListContainers,
        ContainerStatus}
    /runtime.v1.ImageService/{PullImage, ImageStatus, ListImages,
        RemoveImage, ImageFsInfo}

both registered on ONE endpoint, as kubelet expects
(``--container-runtime-endpoint`` + ``--image-service-endpoint`` point
at the same socket).

Message encoding defaults to the ``runtime.v1`` PROTOBUF wire format —
hand-rolled in :mod:`kubegpu_tpu_torch.crishim.protowire` (the wire
format itself is small and fully specified), with the public cri-api
field numbers, so a stock kubelet can exchange *messages* with this
endpoint, not just frames.  ``codec="json"`` carries JSON bodies instead.
Either way, both transports dispatch into one `CriVerbs`, so they cannot
diverge semantically.

``grpc`` (grpcio) is imported inside the functions that need it, never at
module import: a host without grpcio imports this module, and only
starting a server or a client raises, with an ``ImportError`` naming
grpcio (nothing falls back to the JSON frames on its own).
"""

from __future__ import annotations

import json
from concurrent import futures

from kubegpu_tpu_torch.crishim import protowire
from kubegpu_tpu_torch.crishim.criserver import (
    CriError,
    CriVerbs,
    RemoteCriShim,
)
from kubegpu_tpu_torch.obs import get_logger

log = get_logger("crigrpc")

RUNTIME_SERVICE = "runtime.v1.RuntimeService"
IMAGE_SERVICE = "runtime.v1.ImageService"

SERVICE_METHODS = {
    RUNTIME_SERVICE: (
        "Version", "CreateContainer", "StartContainer", "StopContainer",
        "RemoveContainer", "ListContainers", "ContainerStatus",
    ),
    IMAGE_SERVICE: (
        "PullImage", "ImageStatus", "ListImages", "RemoveImage",
        "ImageFsInfo",
    ),
}

_METHOD_SERVICE = {m: s for s, ms in SERVICE_METHODS.items() for m in ms}


def _grpc():
    """grpcio, or an ``ImportError`` that names it."""
    try:
        import grpc
    except ImportError as e:
        raise ImportError(
            "the gRPC CRI transport needs grpcio (the `grpc` module), which "
            "this host lacks; use the JSON-frame transport (--transport "
            "json)") from e
    return grpc


def _encode(obj: dict) -> bytes:
    return json.dumps(obj).encode()


def _decode(data: bytes) -> dict:
    return json.loads(data or b"{}")


def _codec_fns(codec: str, method: str):
    """(request_deserializer, response_serializer) server-side /
    (request_serializer, response_deserializer) client-side pairs are
    symmetric, so return all four keyed by role."""
    if codec == "proto":
        return {
            "req_ser": protowire.request_serializer(method),
            "req_des": protowire.request_deserializer(method),
            "resp_ser": protowire.response_serializer(method),
            "resp_des": protowire.response_deserializer(method),
        }
    if codec == "json":
        return {"req_ser": _encode, "req_des": _decode,
                "resp_ser": _encode, "resp_des": _decode}
    raise ValueError(f"unknown CRI gRPC codec {codec!r}")


class GrpcCriServer(CriVerbs):
    """gRPC transport over the shared CRI verb core.  Same constructor
    as :class:`CriServer` plus ``codec`` ("proto" = runtime.v1 wire
    bodies, the kubelet-compatible default; "json" = JSON bodies);
    ``start()`` binds ``unix:<socket_path>``."""

    def __init__(self, *args, codec: str = "proto", **kw):
        super().__init__(*args, **kw)
        self.codec = codec

    def start(self) -> "GrpcCriServer":
        grpc = _grpc()
        self._grpc = grpc.server(
            futures.ThreadPoolExecutor(
                max_workers=8, thread_name_prefix="cri-grpc"))

        def make_handler(method: str):
            fns = _codec_fns(self.codec, method)

            def unary(request: dict, context):
                try:
                    return self._dispatch(method, request or {})
                except CriError as e:
                    context.abort(grpc.StatusCode.FAILED_PRECONDITION,
                                  str(e))
                except Exception as e:   # noqa: BLE001 — carried as status
                    context.abort(grpc.StatusCode.INTERNAL,
                                  f"{type(e).__name__}: {e}")
            return grpc.unary_unary_rpc_method_handler(
                unary, request_deserializer=fns["req_des"],
                response_serializer=fns["resp_ser"])

        for service, methods in SERVICE_METHODS.items():
            self._grpc.add_generic_rpc_handlers((
                grpc.method_handlers_generic_handler(
                    service, {m: make_handler(m) for m in methods}),))
        self._grpc.add_insecure_port(f"unix:{self.socket_path}")
        self._grpc.start()
        log.info("grpc listening", socket=self.socket_path,
                 node=self.node_name, codec=self.codec)
        return self

    def close(self) -> None:
        srv = getattr(self, "_grpc", None)  # start() may never have run
        if srv is not None:
            srv.stop(grace=2).wait(timeout=5)
        self._cleanup_socket()


class GrpcCriClient:
    """gRPC counterpart of :class:`CriClient` — same ``call(method,
    request) -> dict`` surface, so :class:`RemoteCriShim` and the
    remote container handles work over either transport unchanged.
    Errors come back as gRPC status codes and re-raise as CriError."""

    def __init__(self, socket_path: str, connect_timeout: float = 5.0,
                 codec: str = "proto"):
        self.socket_path = socket_path
        self.codec = codec
        grpc = self._grpc = _grpc()
        self._channel = grpc.insecure_channel(f"unix:{socket_path}")
        grpc.channel_ready_future(self._channel).result(
            timeout=connect_timeout)
        self._stubs = {}
        for m, s in _METHOD_SERVICE.items():
            fns = _codec_fns(codec, m)
            self._stubs[m] = self._channel.unary_unary(
                f"/{s}/{m}", request_serializer=fns["req_ser"],
                response_deserializer=fns["resp_des"])

    def call(self, method: str, request: dict | None = None) -> dict:
        stub = self._stubs.get(method)
        if stub is None:
            raise CriError(f"unknown method {method!r}")
        try:
            return stub(request or {})
        except self._grpc.RpcError as e:
            if e.code() in (self._grpc.StatusCode.FAILED_PRECONDITION,
                            self._grpc.StatusCode.INTERNAL):
                raise CriError(e.details()) from None
            raise ConnectionError(
                f"CRI gRPC call {method} failed: {e.code().name} "
                f"{e.details()}") from None

    def close(self) -> None:
        self._channel.close()


class GrpcRemoteCriShim(RemoteCriShim):
    """RemoteCriShim over the gRPC endpoint (kubelet's seam, real
    transport).  Identical call sequence: PullImage → CreateContainer →
    StartContainer, then status polling via the shared handle class."""

    def __init__(self, socket_path: str, codec: str = "proto"):
        self.client = GrpcCriClient(socket_path, codec=codec)
        self.runtime_name = self.client.call("Version")["runtime_name"]
