"""A pod's gang annotation (copied from ``kubegpu_tpu/kubemeta/codec.py``
and ``objects.py``): the annotation key and its decoder, which the serving
pool's health watch reads off a deleted pod to find the replica it backed.
The pod is duck-typed: anything with ``metadata.annotations``."""

from __future__ import annotations

import json
from dataclasses import dataclass

GANG_KEY = "pod.alpha.kubetpu/gang"


@dataclass
class GangSpec:
    """Gang (co-scheduling) membership: all ``size`` pods of ``name``
    place atomically or not at all; ``index`` is this pod's rank."""

    name: str
    size: int
    index: int

    def __post_init__(self) -> None:
        if not 0 <= self.index < self.size:
            raise ValueError(f"gang index {self.index} not in [0,{self.size})")


def pod_gang_spec(pod) -> GangSpec | None:
    """The gang a pod belongs to, from its annotation; None without one."""
    payload = pod.metadata.annotations.get(GANG_KEY)
    if not payload:
        return None
    d = json.loads(payload)
    return GangSpec(name=d["name"], size=d["size"], index=d["index"])
