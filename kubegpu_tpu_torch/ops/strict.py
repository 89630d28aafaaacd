"""Strict-mode fence for silent hot-path degradation (counterpart of
``kubegpu_tpu/ops/strict.py``, the same environment variable).

``KUBETPU_REQUIRE_PALLAS=1`` in the environment turns every would-be-silent
fallback into a raised :class:`StrictFallbackError`.  In the port the
fences are the workload program's engine choices (paged to dense when the
prompt bucket does not align to a page; a kv width, speculative, fused,
eviction or tp/dp ask the chosen engine cannot take): they pick an engine
path, never a device or a kernel, and a kernel wrapper never falls back at
all.  The flag is read live at each call.
"""

from __future__ import annotations

import os

ENV_VAR = "KUBETPU_REQUIRE_PALLAS"


class StrictFallbackError(RuntimeError):
    """A hot path degraded (e.g. paged to dense) under strict mode."""


def require_pallas() -> bool:
    """True when silent fallbacks must raise (env-driven, read live)."""
    return os.environ.get(ENV_VAR, "") not in ("", "0")


def fallback(path: str, detail: str) -> None:
    """Record a hot-path fallback: raise under strict mode, else return
    so the caller can degrade.  ``path`` names the hot path (e.g.
    ``llama_serve.continuous``), ``detail`` says why it degraded."""
    if require_pallas():
        raise StrictFallbackError(
            f"{ENV_VAR}=1 but {path} fell back: {detail}")
