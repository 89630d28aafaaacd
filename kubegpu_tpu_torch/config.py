"""Unified config tree: dataclasses + file + CLI-style overrides (copied
from ``kubegpu_tpu/config.py``; the backend seam is ``mock`` ⇄ ``nvml``).

Reference parity (SURVEY.md §6 "Config / flag system"): the reference used
Go flag/pflag per binary plus the kube-scheduler JSON policy file, with
device plugins selected by ``.so`` path.  Here the whole stack reads one
dataclass tree; the backend field mirrors the reference's plugin seam
(``mock`` ⇄ ``nvml``, the port's ``nvidiagpuplugin``).

Load order (later wins): built-in defaults → config file (JSON or YAML)
→ dotted CLI overrides (``scheduler.locality_weight=0.7``).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field, fields


@dataclass
class SchedulerConfig:
    """Tuning for the gang allocator + extender service."""

    locality_weight: float = 0.6
    frag_weight: float = 0.25
    fill_weight: float = 0.15
    max_placements_per_shape: int = 64
    coordinator_port: int = 0  # 0 = auto (rotate per cluster)
    # incomplete-gang arrival grace: how long the queue head blocks
    # later-arrived units while a gang's members trickle in
    gang_grace_s: float = 30.0


@dataclass
class BackendConfig:
    """Device-backend selection — the reference's plugin seam."""

    type: str = "mock"                # "mock" | "nvml"
    slice_types: list[str] = field(default_factory=lambda: ["v4-8"])

    def __post_init__(self) -> None:
        if self.type not in ("mock", "nvml"):
            raise ValueError(f"unknown backend type {self.type!r}")


@dataclass
class RuntimeConfig:
    """Node-runtime behavior (the crishim's launch path)."""

    real_processes: bool = False
    extra_env: dict[str, str] = field(default_factory=dict)
    # route agent→shim container calls over a CRI-shaped unix socket
    # (criserver.py) instead of in-process — the reference's transport
    wire_cri: bool = False


@dataclass
class ObsConfig:
    trace_capacity: int = 4096
    # emit structured JSON log lines (obs/logging.py) to stderr
    json_logs: bool = False
    log_level: str = "info"


@dataclass
class KubeTpuConfig:
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    backend: BackendConfig = field(default_factory=BackendConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)
    obs: ObsConfig = field(default_factory=ObsConfig)

    # ------------------------------------------------------------------

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "KubeTpuConfig":
        cfg = cls()
        _merge_into(cfg, d, path="")
        return cfg

    @classmethod
    def load(cls, path: str | None = None,
             overrides: list[str] | None = None) -> "KubeTpuConfig":
        """Defaults → ``path`` (JSON/YAML by extension) → dotted overrides
        like ``scheduler.locality_weight=0.7`` or ``backend.type=mock``."""
        cfg = cls()
        if path:
            _merge_into(cfg, load_structured_file(path), path="")
        for ov in overrides or []:
            _apply_override(cfg, ov)
        return cfg


def load_structured_file(path: str) -> dict:
    """Read a JSON or YAML mapping by extension (shared by config and the
    CLI's workload-spec loader)."""
    with open(path) as f:
        text = f.read()
    if path.endswith((".yaml", ".yml")):
        try:
            import yaml
        except ImportError as e:
            raise ValueError(
                f"{path}: reading YAML requires pyyaml (pip install "
                f"pyyaml) — or use JSON") from e
        return yaml.safe_load(text) or {}
    return json.loads(text or "{}")


def _merge_into(obj, d: dict, path: str) -> None:
    if not isinstance(d, dict):
        raise ValueError(f"config section {path or '<root>'} must be a "
                         f"mapping, got {type(d).__name__}")
    valid = {f.name: f for f in fields(obj)}
    for key, val in d.items():
        if key not in valid:
            raise ValueError(f"unknown config key {path}{key}")
        cur = getattr(obj, key)
        if dataclasses.is_dataclass(cur):
            _merge_into(cur, val, path=f"{path}{key}.")
        else:
            setattr(obj, key, _coerce(cur, val, f"{path}{key}"))
    _revalidate(obj)


def _apply_override(cfg, override: str) -> None:
    if "=" not in override:
        raise ValueError(f"override {override!r} must be key.path=value")
    dotted, _, raw = override.partition("=")
    parts = dotted.strip().split(".")
    obj = cfg
    for p in parts[:-1]:
        if not hasattr(obj, p) or not dataclasses.is_dataclass(getattr(obj, p)):
            raise ValueError(f"unknown config section {p!r} in {dotted}")
        obj = getattr(obj, p)
    leaf = parts[-1]
    if leaf not in {f.name for f in fields(obj)}:
        raise ValueError(f"unknown config key {dotted}")
    cur = getattr(obj, leaf)
    if dataclasses.is_dataclass(cur):
        raise ValueError(
            f"{dotted} is a config section, not a value — set one of its "
            f"fields (e.g. {dotted}.{fields(cur)[0].name}=...)")
    # parse the raw string by the current value's type
    if isinstance(cur, bool):
        val = raw.strip().lower() in ("1", "true", "yes", "on")
    elif isinstance(cur, int):
        val = int(raw)
    elif isinstance(cur, float):
        val = float(raw)
    elif isinstance(cur, list):
        val = [x.strip() for x in raw.split(",") if x.strip()]
    elif isinstance(cur, dict):
        val = dict(kv.split(":", 1) for kv in raw.split(",") if kv)
    else:
        val = raw
    setattr(obj, leaf, val)
    _revalidate(obj)


def _coerce(cur, val, where: str):
    """Light type coercion with a clear error, so a YAML '0.7' string or a
    JSON int-for-float round-trips instead of poisoning the tree."""
    if isinstance(cur, bool):
        if isinstance(val, bool):
            return val
        raise ValueError(f"{where}: expected bool, got {val!r}")
    # bool is a subclass of int: reject it explicitly in numeric slots so
    # YAML 1.1 scalars like `on`/`yes` don't silently become 1.0
    if isinstance(cur, float) and isinstance(val, (int, float)) \
            and not isinstance(val, bool):
        return float(val)
    if isinstance(cur, int) and isinstance(val, int) \
            and not isinstance(val, bool):
        return val
    if isinstance(cur, str) and isinstance(val, str):
        return val
    if isinstance(cur, list) and isinstance(val, list):
        return list(val)
    if isinstance(cur, dict) and isinstance(val, dict):
        return {str(k): str(v) for k, v in val.items()}
    raise ValueError(f"{where}: expected {type(cur).__name__}, got {val!r}")


def _revalidate(obj) -> None:
    post = getattr(obj, "__post_init__", None)
    if post is not None:
        post()
