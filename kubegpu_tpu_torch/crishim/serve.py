"""Standalone crishim node daemon: ``python -m kubegpu_tpu_torch.crishim.serve``
(copied from ``kubegpu_tpu/crishim/serve.py``; imports no torch).

The reference's ``crishim main()`` (SURVEY.md §4.1): parse flags → load
the device plugin → start the CRI server on a unix socket → run the
kubeadvertise loop against the apiserver.  This is that binary for an
H100 node: it connects to the HTTP apiserver façade
(``kubemeta/apiserver_http.py``), registers the node, serves the
CRI-shaped socket, and runs the kubelet-ish pod lifecycle — in its own
process, talking to the control plane over nothing but HTTP + the unix
socket, exactly like the reference deployment.

    python -m kubegpu_tpu_torch.crishim.serve \
        --apiserver http://127.0.0.1:8901 \
        --backend mock --slice v4-8 \
        --cri-socket /tmp/kubetpu-cri.sock \
        --real-processes

``--backend nvml`` advertises this host's cards through
:class:`~kubegpu_tpu_torch.tpuplugin.NvmlBackend` (where the reference
builds ``LibtpuBackend``), and raises without NVML or a card; the pods it
launches with ``--real-processes`` run on the cards their grants name.
``--slice`` (the mock's) takes the reference's slice types and the port's
``h100-sxm-N``.  ``--http-port`` (the port's, not the reference's) serves
the node's read-only surface as kubelet's does: ``GET /metrics`` (the
workload metric lines the agent harvested from its pods) and ``GET
/containerLogs/{pod}/{container}`` (a finished container's stdout).
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading
import time

from kubegpu_tpu_torch.kubemeta.controlplane import Conflict, NotFound


def build_agent(args):
    """Construct (api client, CRI server, node agent) from flags —
    split from main() so tests can drive the daemon in-process."""
    from kubegpu_tpu_torch.crishim.agent import NodeAgent
    from kubegpu_tpu_torch.crishim.criserver import CriServer, RemoteCriShim
    from kubegpu_tpu_torch.crishim.runtime import FakeRuntime, SubprocessRuntime
    from kubegpu_tpu_torch.kubemeta.apiserver_http import HttpApiClient
    from kubegpu_tpu_torch.obs import global_registry
    from kubegpu_tpu_torch.tpuplugin import MockBackend, NvmlBackend

    api = HttpApiClient(args.apiserver)
    if args.backend == "mock":
        backend = MockBackend(args.slice, host_id=args.host_id)
    elif args.backend == "nvml":
        backend = NvmlBackend()
    else:
        raise ValueError(f"unknown backend {args.backend!r}")
    if args.real_processes:
        extra = dict(kv.split("=", 1) for kv in (args.env or []))
        runtime = SubprocessRuntime(extra_env=extra)
    else:
        runtime = FakeRuntime()
    node_name = backend.discover().node_name
    transport = getattr(args, "transport", "json")
    if transport.startswith("grpc"):
        from kubegpu_tpu_torch.crishim.grpcserver import (
            GrpcCriServer,
            GrpcRemoteCriShim,
        )
        # "grpc" = runtime.v1 protobuf bodies (kubelet-compatible);
        # "grpc-json" carries JSON bodies
        codec = "json" if transport == "grpc-json" else "proto"
        server = GrpcCriServer(api, backend, node_name, runtime,
                               socket_path=args.cri_socket,
                               codec=codec).start()
        shim = GrpcRemoteCriShim(server.socket_path, codec=codec)
    else:
        server = CriServer(api, backend, node_name, runtime,
                           socket_path=args.cri_socket).start()
        shim = RemoteCriShim(server.socket_path)
    agent = NodeAgent(api, backend, runtime,
                      metrics=global_registry, shim=shim)
    return api, server, agent


def serve_node_http(runtime, registry, host: str = "127.0.0.1",
                    port: int = 0):
    """The node's read-only HTTP surface: ``GET /metrics`` (``registry``
    as Prometheus text) and ``GET /containerLogs/{pod}/{container}`` (the
    stdout of that pod's latest container of ``runtime`` once it exited;
    404 while it runs or where there is none).  Returns the started
    ``ThreadingHTTPServer``; ``shutdown()`` + ``server_close()`` stop it."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from kubegpu_tpu_torch.kubemeta.apiserver_http import POLL_S

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, code: int, text: str, kind: str) -> None:
            body = text.encode()
            self.send_response(code)
            self.send_header("Content-Type", kind)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            parts = [x for x in self.path.split("?", 1)[0].split("/") if x]
            if parts == ["metrics"]:
                self._send(200, registry.to_prometheus(),
                           "text/plain; version=0.0.4")
                return
            if len(parts) == 3 and parts[0] == "containerLogs":
                done = [h for h in runtime.containers()
                        if (h.pod_name, h.container_name) == tuple(parts[1:])
                        and h.exit_code is not None]
                if done:
                    self._send(200, done[-1].stdout, "text/plain")
                    return
            self._send(404, f"no finished container at {self.path}\n",
                       "text/plain")

    srv = ThreadingHTTPServer((host, port), Handler)
    threading.Thread(target=srv.serve_forever, args=(POLL_S,),
                     daemon=True).start()
    return srv


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="kubetpu-crishim",
        description="node daemon: CRI-shaped runtime socket + device "
        "advertiser + pod lifecycle (reference: crishim main())")
    ap.add_argument("--apiserver", required=True,
                    help="HTTP apiserver URL (kubemeta.apiserver_http)")
    ap.add_argument("--backend", default="mock",
                    choices=["mock", "nvml"])
    ap.add_argument("--slice", default="v4-8",
                    help="mock backend slice type (e.g. v4-8, h100-sxm-8)")
    ap.add_argument("--host-id", type=int, default=0,
                    help="mock backend host index within the slice")
    ap.add_argument("--transport", default="json",
                    choices=("json", "grpc", "grpc-json"),
                    help="CRI wire transport: length-prefixed JSON "
                         "frames, real gRPC with runtime.v1 protobuf "
                         "bodies, or gRPC with JSON bodies (gRPC needs "
                         "grpcio)")
    ap.add_argument("--cri-socket", default=None,
                    help="unix socket path for the CRI server "
                    "(default: a fresh temp path, printed at startup)")
    ap.add_argument("--real-processes", action="store_true",
                    help="launch real workload subprocesses")
    ap.add_argument("--env", action="append", metavar="K=V",
                    help="extra env for launched workloads, repeatable")
    ap.add_argument("--advertise-interval", type=float, default=5.0,
                    help="seconds between Node advertisement patches")
    ap.add_argument("--tick", type=float, default=0.2,
                    help="pod-lifecycle reconcile interval (seconds)")
    ap.add_argument("--http-port", type=int, default=0,
                    help="serve GET /metrics and /containerLogs/{pod}/"
                    "{container} on this port (0 = disabled)")
    ap.add_argument("--http-host", default="127.0.0.1",
                    help="bind address for --http-port")
    args = ap.parse_args(argv)
    stop = threading.Event()
    if threading.current_thread() is threading.main_thread():
        # SIGTERM asks the loop to leave at its next safe point (never
        # mid-call, as a raise from the handler would: one inside a pod's
        # communicate() left its pipes torn down), then the ``finally``
        # below stops the pods, so no pod process holds a card; ^C still
        # raises KeyboardInterrupt
        signal.signal(signal.SIGTERM, lambda signum, frame: stop.set())

    api, server, agent = build_agent(args)
    http = None
    try:
        backoff = args.tick
        while not stop.is_set():   # registration retries too: the
            try:                   # apiserver may still be coming up
                agent.register()   # when the daemon starts
                break
            except (OSError, ValueError, Conflict, NotFound) as e:
                print(f"crishim: cannot register with {args.apiserver}, "
                      f"retrying in {backoff:.1f}s: {e}", file=sys.stderr)
                stop.wait(backoff)
                backoff = min(backoff * 2, 10.0)
        else:
            return 0
        print(f"crishim: node {agent.node_name} registered; "
              f"CRI socket {server.socket_path}", file=sys.stderr)
        if args.http_port:
            http = serve_node_http(agent.runtime, agent.metrics,
                                   args.http_host, args.http_port)
            print(f"crishim: http on port {http.server_address[1]}",
                  file=sys.stderr)

        last_advertise = time.monotonic()
        backoff = args.tick
        while not stop.is_set():
            try:
                agent.run_once()
                agent.reap(timeout=0)
                now = time.monotonic()
                if now - last_advertise >= args.advertise_interval:
                    agent.advertise()
                    last_advertise = now
                backoff = args.tick
            except (OSError, ValueError, NotFound, Conflict) as e:
                # transient control-plane failure (apiserver restart,
                # connection reset, our Node object wiped): a
                # kubelet-shaped daemon backs off and retries — it must
                # NOT die and orphan its containers and registration
                print(f"crishim: control-plane error, retrying in "
                      f"{backoff:.1f}s: {e}", file=sys.stderr)
                stop.wait(backoff)
                backoff = min(backoff * 2, 10.0)
                if isinstance(e, NotFound):
                    try:   # Node object gone (apiserver state reset)
                        agent.register()
                    except Exception:
                        pass
                continue
            stop.wait(args.tick)
    except KeyboardInterrupt:
        pass
    finally:
        # the reference leaves its pods' processes running; the port stops
        # them, so a card is free once its node daemon is gone
        for handle in agent.runtime.containers():
            handle.kill()
        if http is not None:
            http.shutdown()
            http.server_close()
        server.close()
        api.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
