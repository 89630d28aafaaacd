"""Standalone apiserver daemon: ``python -m kubegpu_tpu_torch.kubemeta.apiserver_serve``
(copied from ``kubegpu_tpu/kubemeta/apiserver_serve.py``; imports no torch).

The control-plane hub as its own process — the role kube-apiserver plays
in the reference deployment (SURVEY.md §2: scheduler and node agent
never talk directly; ALL coordination flows through here).  State is the
in-memory FakeApiServer behind the HTTP façade; scheduler daemon
(``scheduler/serve.py``) and node daemon (``crishim/serve.py``) connect
over nothing but this wire.

    python -m kubegpu_tpu_torch.kubemeta.apiserver_serve --port 8901
"""

from __future__ import annotations

import argparse
import sys
import time

from kubegpu_tpu_torch.kubemeta.apiserver_http import ApiServerHTTP
from kubegpu_tpu_torch.kubemeta.controlplane import FakeApiServer


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="kubetpu-apiserver",
        description="HTTP apiserver façade as a standalone process")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8901)
    args = ap.parse_args(argv)

    server = ApiServerHTTP(FakeApiServer(), host=args.host,
                           port=args.port).start()
    # machine-greppable readiness line (tests/scripts wait for it)
    print(f"apiserver: listening on {server.address}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
