"""HTTP apiserver façade + client — the last transport seam (copied from
``kubegpu_tpu/kubemeta/apiserver_http.py``: the same routes and bodies).

The reference's key architectural property (SURVEY.md §2): scheduler and
node agent never talk directly — ALL coordination flows through the
apiserver over HTTPS (client-go).  In-process, that role is played by
:class:`FakeApiServer`; this module puts the same surface on a real HTTP
wire so the node agent (crishim daemon, `crishim/serve.py`) can run as a
separate process, exactly as kubelet/crishim did:

- :class:`ApiServerHTTP` — REST façade over a FakeApiServer:
    POST   /apis/{kind}                     create
    GET    /apis/{kind}?namespace=&nodeName=&phase=&labelSelector=   list
    GET    /apis/{kind}/{ns}/{name}         get
    PUT    /apis/{kind}/{ns}/{name}         update (optimistic rv)
    PATCH  /apis/{kind}/{ns}/{name}         annotation strategic-merge
    DELETE /apis/{kind}/{ns}/{name}         delete
    POST   /apis/Pod/{ns}/{name}/binding    bind to node
    POST   /apis/Pod/{ns}/{name}/status     set phase (incarnation-safe)
    POST   /apis/Node/{ns}/{name}/ready     node readiness
    GET    /watch?since=SEQ&timeout=S       long-poll watch events

- :class:`HttpApiClient` — same METHOD surface as FakeApiServer (get /
  create / list / update / patch_annotations / bind_pod / set_pod_phase /
  set_node_ready / delete / watch), so NodeAgent, CriServer, and the
  scheduler run unmodified against either; NotFound/Conflict round-trip
  as status codes 404/409.

Watch semantics: the façade numbers every event with a monotonically
increasing sequence and keeps a bounded replay buffer; clients long-poll
``/watch?since=`` and are told to reset if they lag past the buffer
(k8s "too old resource version" semantics).
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

from kubegpu_tpu_torch.kubemeta.controlplane import (
    Conflict,
    FakeApiServer,
    NotFound,
    WatchEvent,
)
from kubegpu_tpu_torch.kubemeta.objects import PodPhase
from kubegpu_tpu_torch.kubemeta.serialize import from_doc, to_doc
from kubegpu_tpu_torch.obs import get_logger

log = get_logger("apiserver")

WATCH_BUFFER = 4096
# serve_forever's shutdown poll: close() returns within it (the stdlib's
# 0.5 s default made every close half a second)
POLL_S = 0.05


class ApiServerHTTP:
    """REST façade over a FakeApiServer.  start() serves in a daemon
    thread; close() shuts down and unsubscribes the event tap."""

    def __init__(self, api: FakeApiServer, host: str = "127.0.0.1",
                 port: int = 0, metrics=None):
        self.api = api
        # /metrics scrape target: Prometheus text exposition
        # from the passed registry, defaulting to the process-global
        # one — the same convention the scheduler webhook serves
        self.metrics = metrics
        self._events: deque[tuple[int, WatchEvent]] = deque(
            maxlen=WATCH_BUFFER)
        self._seq = 0
        self._cond = threading.Condition()
        self._closed = False
        self._unsub = api.watch(self._on_event)
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            # -- plumbing ---------------------------------------------

            def _body(self) -> dict:
                n = int(self.headers.get("Content-Length", 0))
                return json.loads(self.rfile.read(n) or b"{}")

            def _send(self, code: int, doc: dict) -> None:
                body = json.dumps(doc).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _dispatch(self, method: str) -> None:
                try:
                    out = outer._route(method, self.path, self._body()
                                       if method in ("POST", "PUT", "PATCH")
                                       else {})
                    self._send(200, out)
                except NotFound as e:
                    self._send(404, {"error": str(e)})
                except Conflict as e:
                    self._send(409, {"error": str(e)})
                except (ValueError, KeyError) as e:
                    self._send(400, {"error": f"{type(e).__name__}: {e}"})
                except Exception as e:   # pragma: no cover - last resort
                    log.error("apiserver_internal", path=self.path,
                              error=str(e))
                    self._send(500, {"error": str(e)})

            def do_GET(self):
                if self.path.partition("?")[0] == "/metrics":
                    # text exposition, not the JSON dispatch path
                    body = outer._metrics_text().encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                self._dispatch("GET")

            def do_POST(self):
                self._dispatch("POST")

            def do_PUT(self):
                self._dispatch("PUT")

            def do_PATCH(self):
                self._dispatch("PATCH")

            def do_DELETE(self):
                self._dispatch("DELETE")

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread: threading.Thread | None = None

    def _metrics_text(self) -> str:
        if self.metrics is not None:
            return self.metrics.to_prometheus()
        from kubegpu_tpu_torch.obs.metrics import global_registry
        return global_registry.to_prometheus()

    # -- event tap ------------------------------------------------------

    def _on_event(self, ev: WatchEvent) -> None:
        with self._cond:
            self._seq += 1
            self._events.append((self._seq, ev))
            self._cond.notify_all()

    # -- lifecycle ------------------------------------------------------

    @property
    def address(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "ApiServerHTTP":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, args=(POLL_S,), daemon=True)
        self._thread.start()
        log.info("listening", address=self.address)
        return self

    def close(self) -> None:
        self._unsub()
        with self._cond:   # answer the pending long-polls now
            self._closed = True
            self._cond.notify_all()
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)

    # -- routing --------------------------------------------------------

    def _route(self, method: str, path: str, body: dict) -> dict:
        url = urllib.parse.urlparse(path)
        q = urllib.parse.parse_qs(url.query)
        parts = [p for p in url.path.split("/") if p]

        if parts == ["watch"] and method == "GET":
            if "tail" in q:   # new watcher: start from "now", no replay
                with self._cond:
                    return {"next": self._seq, "events": []}
            return self._watch_poll(
                since=int(q.get("since", ["0"])[0]),
                timeout=float(q.get("timeout", ["10"])[0]))

        if not parts or parts[0] != "apis":
            raise NotFound(f"no route {url.path}")
        if len(parts) == 2:  # /apis/{kind}
            kind = parts[1]
            if method == "POST":
                return to_doc(kind, self.api.create(
                    kind, from_doc(kind, body)))
            if method == "GET":
                return self._list(kind, q)
            raise ValueError(f"method {method} not allowed on collection")
        if len(parts) == 4:  # /apis/{kind}/{ns}/{name}
            kind, ns, name = parts[1], parts[2], parts[3]
            if method == "GET":
                return to_doc(kind, self.api.get(kind, name, namespace=ns))
            if method == "PUT":
                obj = from_doc(kind, body)
                return to_doc(kind, self.api.update(kind, obj))
            if method == "PATCH":
                return to_doc(kind, self.api.patch_annotations(
                    kind, name, body.get("annotations") or {},
                    namespace=ns))
            if method == "DELETE":
                self.api.delete(kind, name, namespace=ns)
                return {}
            raise ValueError(f"method {method} not allowed on object")
        if len(parts) == 5 and method == "POST":  # subresources
            kind, ns, name, sub = parts[1], parts[2], parts[3], parts[4]
            if kind == "Pod" and sub == "binding":
                self.api.bind_pod(name, body["node"], namespace=ns)
                return {}
            if kind == "Pod" and sub == "status":
                self.api.set_pod_phase(
                    name, PodPhase(body["phase"]),
                    message=body.get("message", ""),
                    exit_code=body.get("exitCode"),
                    namespace=ns,
                    expect_uid=body.get("expectUid"))
                return {}
            if kind == "Node" and sub == "ready":
                self.api.set_node_ready(name, bool(body["ready"]),
                                        namespace=ns)
                return {}
        raise NotFound(f"no route {method} {url.path}")

    def _list(self, kind: str, q: dict) -> dict:
        phase = None
        if "phase" in q:
            phase = tuple(PodPhase(v) for v in q["phase"][0].split(","))
        label_selector = None
        if "labelSelector" in q:
            label_selector = dict(
                kv.split("=", 1) for kv in q["labelSelector"][0].split(","))
        items = self.api.list(
            kind,
            label_selector,
            node_name=q.get("nodeName", [None])[0],
            phase=phase,
            namespace=q.get("namespace", [None])[0])
        return {"items": [to_doc(kind, o) for o in items]}

    def _watch_poll(self, since: int, timeout: float) -> dict:
        deadline = time.monotonic() + min(timeout, 60.0)
        with self._cond:
            while True:
                if self._events and self._events[0][0] > since + 1:
                    # events between `since` and the oldest buffered one
                    # were evicted: the client lags past the replay
                    # buffer — tell it to relist and skip ahead (k8s
                    # "resourceVersion too old" semantics)
                    return {"reset": True, "next": self._seq,
                            "events": []}
                fresh = [(s, ev) for s, ev in self._events if s > since]
                if fresh:
                    return {
                        "next": fresh[-1][0],
                        "events": [
                            {"seq": s, "kind": ev.kind, "type": ev.type,
                             "object": to_doc(ev.kind, ev.obj)}
                            for s, ev in fresh
                        ],
                    }
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self._closed:
                    return {"next": self._seq, "events": []}
                self._cond.wait(remaining)


# -- client -------------------------------------------------------------

class HttpApiClient:
    """FakeApiServer-compatible surface over the REST façade, so every
    component (NodeAgent, CriServer, scheduler) runs unmodified against
    a remote apiserver."""

    def __init__(self, base_url: str, timeout: float = 30.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self._watchers: list[Callable[[WatchEvent], None]] = []
        self._reset_hooks: list[Callable[[], None]] = []
        self._watch_lock = threading.Lock()
        self._watch_thread: threading.Thread | None = None
        self._watch_stop = threading.Event()

    # -- transport ------------------------------------------------------

    def _call(self, method: str, path: str, body: dict | None = None,
              timeout: float | None = None) -> dict:
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            self.base_url + path, data=data, method=method,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(
                    req, timeout=timeout or self.timeout) as resp:
                return json.loads(resp.read() or b"{}")
        except urllib.error.HTTPError as e:
            payload = {}
            try:
                payload = json.loads(e.read() or b"{}")
            except ValueError:
                pass
            msg = payload.get("error", str(e))
            if e.code == 404:
                raise NotFound(msg) from None
            if e.code == 409:
                raise Conflict(msg) from None
            raise ValueError(msg) from None

    # -- CRUD (FakeApiServer surface) -----------------------------------

    def create(self, kind: str, obj):
        return from_doc(kind, self._call(
            "POST", f"/apis/{kind}", to_doc(kind, obj)))

    def get(self, kind: str, name: str, namespace: str = "default"):
        return from_doc(kind, self._call(
            "GET", f"/apis/{kind}/{namespace}/{name}"))

    def list(self, kind: str, label_selector: dict[str, str] | None = None,
             *, node_name: str | None = None, phase=None,
             namespace: str | None = None):
        q = {}
        if label_selector:
            q["labelSelector"] = ",".join(
                f"{k}={v}" for k, v in label_selector.items())
        if node_name is not None:
            q["nodeName"] = node_name
        if phase is not None:
            phases = phase if isinstance(phase, tuple) else (phase,)
            q["phase"] = ",".join(p.value for p in phases)
        if namespace is not None:
            q["namespace"] = namespace
        qs = ("?" + urllib.parse.urlencode(q)) if q else ""
        out = self._call("GET", f"/apis/{kind}{qs}")
        return [from_doc(kind, d) for d in out["items"]]

    def update(self, kind: str, obj):
        ns, name = obj.metadata.namespace, obj.metadata.name
        return from_doc(kind, self._call(
            "PUT", f"/apis/{kind}/{ns}/{name}", to_doc(kind, obj)))

    def patch_annotations(self, kind: str, name: str,
                          annotations: dict[str, str | None],
                          namespace: str = "default"):
        return from_doc(kind, self._call(
            "PATCH", f"/apis/{kind}/{namespace}/{name}",
            {"annotations": annotations}))

    def bind_pod(self, name: str, node_name: str,
                 namespace: str = "default") -> None:
        self._call("POST", f"/apis/Pod/{namespace}/{name}/binding",
                   {"node": node_name})

    def set_pod_phase(self, name: str, phase, message: str = "",
                      exit_code: int | None = None,
                      namespace: str = "default",
                      expect_uid: str | None = None) -> None:
        self._call("POST", f"/apis/Pod/{namespace}/{name}/status",
                   {"phase": getattr(phase, "value", str(phase)),
                    "message": message, "exitCode": exit_code,
                    "expectUid": expect_uid})

    def set_node_ready(self, name: str, ready: bool,
                       namespace: str = "default") -> None:
        self._call("POST", f"/apis/Node/{namespace}/{name}/ready",
                   {"ready": ready})

    def delete(self, kind: str, name: str, namespace: str = "default") -> None:
        self._call("DELETE", f"/apis/{kind}/{namespace}/{name}")

    # -- watch ----------------------------------------------------------

    def watch(self, callback: Callable[[WatchEvent], None],
              on_reset: Callable[[], None] | None = None
              ) -> Callable[[], None]:
        """Subscribe via a shared background long-poll thread.  Events
        are re-materialized WatchEvents (objects deserialized), delivered
        in order.  Unsubscribe stops the thread when no watchers remain.

        ``on_reset`` fires when the server reports our position evicted
        from the replay buffer (events were LOST): cache-maintaining
        subscribers must relist, not merely continue."""
        with self._watch_lock:
            self._watchers.append(callback)
            if on_reset is not None:
                self._reset_hooks.append(on_reset)
            # (re)spawn when no thread runs OR the current one is
            # already winding down after a last-unsubscribe/stop: each
            # generation gets its OWN stop event, so a poller that is
            # still draining its final long-poll can't starve a fresh
            # subscriber of events
            if self._watch_thread is None or self._watch_stop.is_set():
                # take the position before returning, not in the thread:
                # a subscriber that lists next (the watch cache's seed)
                # must not lose an event that lands between its list and
                # a late first poll
                try:   # start from "now": no replay of history
                    since = self._call("GET", "/watch?tail=1")["next"]
                except (ValueError, NotFound, OSError):
                    since = 0
                self._watch_stop = threading.Event()
                self._watch_thread = threading.Thread(
                    target=self._watch_loop,
                    args=(self._watch_stop, since), daemon=True)
                self._watch_thread.start()

        def unsubscribe() -> None:
            with self._watch_lock:
                if callback in self._watchers:
                    self._watchers.remove(callback)
                if on_reset is not None and on_reset in self._reset_hooks:
                    self._reset_hooks.remove(on_reset)
                if not self._watchers:
                    self._watch_stop.set()
        return unsubscribe

    def _watch_loop(self, stop: threading.Event, since: int) -> None:
        while not stop.is_set():
            try:
                out = self._call(
                    "GET", f"/watch?since={since}&timeout=2",
                    timeout=self.timeout + 5)
            except (ValueError, NotFound, OSError):
                if stop.wait(0.2):
                    break
                continue
            if stop.is_set():
                # our generation was stopped while the poll was in
                # flight: a NEWER generation (with its own fresh tail)
                # may own the watcher list now — delivering this batch
                # would replay pre-subscription events to it, twice
                break
            if out.get("reset"):
                since = out["next"]   # lagged: skip ahead
                with self._watch_lock:
                    hooks = list(self._reset_hooks)
                for h in hooks:       # cache subscribers relist here
                    try:
                        h()
                    except Exception as e:   # a failing relist (e.g.
                        # transient HTTP error) must not kill the shared
                        # poll thread — the next reset retries it
                        log.error("watch_reset_hook", error=str(e))
                continue
            since = out.get("next", since)
            for e in out.get("events", []):
                try:
                    ev = WatchEvent(kind=e["kind"], type=e["type"],
                                    obj=from_doc(e["kind"], e["object"]))
                except (KeyError, ValueError, TypeError) as err:
                    log.error("watch_event_decode", error=str(err))
                    continue
                with self._watch_lock:
                    watchers = list(self._watchers)
                for w in watchers:
                    try:
                        w(ev)
                    except Exception as err:   # one bad subscriber must
                        log.error("watch_callback",  # not starve the rest
                                  error=str(err))
        with self._watch_lock:
            if self._watch_thread is threading.current_thread():
                self._watch_thread = None

    def close(self) -> None:
        with self._watch_lock:
            self._watch_stop.set()
            t = self._watch_thread
        if t is not None:
            t.join(timeout=5)
