"""Standalone scheduler daemon: ``python -m kubegpu_tpu_torch.scheduler.daemon``
(copied from ``kubegpu_tpu/scheduler/daemon.py``; imports no torch).

The reference's scheduler process (SURVEY.md §4.2): connect to the
apiserver over HTTP, maintain a watch-fed local cache (the client-go
reflector equivalent — ``kubemeta/cache.py``), and run the scheduling
loop event-driven against that cache.  Every read (``run_once``'s
pending scan, ``sync``'s full rebuild) is served locally; only
binds/patches cross the wire.  Restart recovery is the annotation-truth
path the scheduler already has: a fresh daemon's first ``sync()``
rebuilds every commitment from pod annotations (SURVEY.md §4.4).

(`scheduler/serve.py` is the kube-scheduler-facing extender WEBHOOK;
this module is the full device scheduler as its own control loop.)

    python -m kubegpu_tpu_torch.scheduler.daemon \
        --apiserver http://127.0.0.1:8901
"""

from __future__ import annotations

import argparse
import sys
import threading
import time

from kubegpu_tpu_torch.kubemeta.controlplane import Conflict, NotFound


def build_scheduler(args):
    """(api client, cache, scheduler, recovery) from flags — split from
    main() so tests can drive the daemon in-process."""
    from kubegpu_tpu_torch.kubemeta.apiserver_http import HttpApiClient
    from kubegpu_tpu_torch.kubemeta.cache import WatchCachedApiClient
    from kubegpu_tpu_torch.obs import global_registry
    from kubegpu_tpu_torch.scheduler.extender import DeviceScheduler
    from kubegpu_tpu_torch.scheduler.health import FaultRecoveryController

    api = HttpApiClient(args.apiserver)
    cache = None
    try:
        cache = WatchCachedApiClient(api)
        sched = DeviceScheduler(cache, metrics=global_registry,
                                gang_grace_s=args.gang_grace)
        recovery = FaultRecoveryController(cache, sched)
    except BaseException:
        # seeding can fail while the apiserver is still booting; the
        # retry loop builds a fresh client, so close this one or every
        # failed attempt leaks a long-poll watch thread that haunts the
        # server forever once it's up
        if cache is not None:
            cache.close()
        api.close()
        raise
    return api, cache, sched, recovery


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="kubetpu-scheduler",
        description="device scheduler daemon over the HTTP apiserver "
        "(watch-cached reads, event-driven loop)")
    ap.add_argument("--apiserver", required=True,
                    help="HTTP apiserver URL (kubemeta.apiserver_http)")
    ap.add_argument("--tick", type=float, default=1.0,
                    help="max seconds between passes when no events "
                    "arrive (events wake the loop immediately)")
    ap.add_argument("--gang-grace", type=float, default=30.0,
                    help="incomplete-gang head-of-line grace (seconds)")
    ap.add_argument("--metrics-port", type=int, default=0,
                    help="serve Prometheus text at GET /metrics on this "
                    "port (0 = disabled) — the webhook's obs surface, "
                    "for the daemon deployment shape")
    ap.add_argument("--metrics-host", default="127.0.0.1",
                    help="bind address for /metrics (use 0.0.0.0 in a "
                    "container netns so an off-host scraper can reach it)")
    args = ap.parse_args(argv)

    backoff = 0.2
    while True:   # the apiserver may still be coming up (concurrent boot)
        try:
            api, cache, sched, recovery = build_scheduler(args)
            break
        except (OSError, ValueError, Conflict, NotFound) as e:
            print(f"scheduler: cannot reach {args.apiserver}, retrying "
                  f"in {backoff:.1f}s: {e}", file=sys.stderr)
            time.sleep(backoff)
            backoff = min(backoff * 2, 10.0)
    # One-time warm-up BEFORE declaring readiness: building/dlopening
    # the native allocator core + seeding the geometry memos otherwise
    # lands on the first real decision (the reference's wire bench: 506 ms
    # max vs 4.5 ms p50).  Readiness means "first decision runs at steady
    # state".
    t_warm = time.perf_counter()
    sched.warm_start()
    print(f"scheduler: warmed in "
          f"{(time.perf_counter() - t_warm) * 1e3:.0f} ms", flush=True)

    # Event-driven wakeup: pod/node churn triggers an immediate pass
    # (the recovery controller watches through the same cache and marks
    # itself dirty on node events); completions release chips exactly
    # like SimCluster._on_event does in-process.
    wake = threading.Event()

    def on_event(ev) -> None:
        if ev.kind == "Pod":
            from kubegpu_tpu_torch.kubemeta.objects import PodPhase
            pod = ev.obj
            if ev.type == "DELETED" or (
                    ev.type == "MODIFIED" and pod.status.phase in (
                        PodPhase.SUCCEEDED, PodPhase.FAILED)):
                try:
                    sched.return_pod_resources(pod.name,
                                               pod.metadata.namespace)
                except Exception as e:   # releasing must never kill us
                    print(f"scheduler: release error for {pod.name}: "
                          f"{e}", file=sys.stderr)
        wake.set()

    # Subscribe BEFORE declaring readiness: a client that reacts to the
    # readiness line by creating a Pod must find the wakeup path live —
    # the reference's wire bench's 506 ms max was exactly this race (the first
    # event slipped in before the watcher existed, so the first
    # decision waited out one full --tick; 500 ms tick + ~6 ms pass).
    unsub = cache.watch(on_event)
    print(f"scheduler: connected to {args.apiserver}", flush=True)

    metrics_srv = None
    if args.metrics_port:
        from kubegpu_tpu_torch.obs.metrics import serve_prometheus
        metrics_srv = serve_prometheus(sched.metrics, args.metrics_host,
                                       args.metrics_port)
        print(f"scheduler: /metrics on port "
              f"{metrics_srv.server_address[1]}", flush=True)
    backoff = args.tick
    try:
        while True:
            wake.wait(timeout=args.tick)
            wake.clear()
            try:
                recovery.run_once()
                t_pass = time.perf_counter()
                res = sched.run_once()
                pass_ms = (time.perf_counter() - t_pass) * 1e3
                if pass_ms > 100.0:
                    # phase visibility for latency outliers: the pass time here is decision compute
                    # + bind POSTs; watch delivery is the client's side
                    print(f"scheduler: slow pass {pass_ms:.0f} ms "
                          f"(scheduled={len(res.scheduled)} "
                          f"unschedulable={len(res.unschedulable)})",
                          flush=True)
                backoff = args.tick
            except (OSError, ValueError, NotFound, Conflict) as e:
                # transient control-plane failure: back off, retry —
                # in-memory state re-syncs from annotation truth
                print(f"scheduler: control-plane error, retrying in "
                      f"{backoff:.1f}s: {e}", file=sys.stderr)
                time.sleep(backoff)
                backoff = min(backoff * 2, 10.0)
                try:
                    sched.sync()
                except Exception:
                    pass
    except KeyboardInterrupt:
        pass
    finally:
        unsub()
        recovery.close()
        cache.close()
        api.close()
        if metrics_srv is not None:
            metrics_srv.shutdown()
            metrics_srv.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
